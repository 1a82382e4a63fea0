"""The port's engine with its cold tier in 4 shards on one device, and its
pond datapath, against the JAX engine on the (1, 4) ``mesh1d`` and (2, 4)
``mesh`` fixtures (tp = 4; dp = 1 and 2), after carrying the reference
state across (export triple + page table, hot pages placed by the
reference planner); and the DLRM serve step at 4 shards and in pond
against the reference's ``make_serve_step``.

Tolerances.
- Lookups at 0/1 weights: bitwise.  The port sums the shards' partials in
  shard order, and the reference's psum (and psum_scatter) on its CPU mesh
  sums them in that same order, so each shard's fixed-l-order partial and
  their sum agree bit for bit.  Pond sums raw rows over shards (exact: one
  shard owns each entry), then pools them over l: bitwise here too.
- General weights: |diff| <= (2 L + tp) * 2^-23 * sum_l |f_l * row_l| per
  element: one more rounding per accumulate step (XLA contracts to FMA,
  the plain version does not), and the shard sum of partials that each
  differ by that much (tp * 2^-23 * sum_s |partial_s|, and
  sum_s |partial_s| <= sum_l |f_l * row_l|).
- Interaction outputs and serve scores: 1e-5 relative / 1e-6 absolute
  (XLA and torch reduce the dots and MLP products in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.paging import PageTable as JPageTable
from repro.core.pifs import engine_for_tables as jengine_for_tables
from repro.distributed.sharding import make_mesh
from repro.models import dlrm as jdlrm
from repro.models import params as jprm

from repro_torch.configs import get_config, reduced
from repro_torch.core.paging import HOT_SHARD, PageTable
from repro_torch.core.pifs import engine_for_tables
from repro_torch.launch import serve as srv
from repro_torch.models import dlrm
from repro_torch.serving import loadgen
from repro_torch.serving.request import ArrivalConfig

VOCABS, DIM, PAGE_BYTES, HOT = [300, 200], 16, 512, 0.2
B, L, TP = 8, 5, 4
EPS = 2.0 ** -23
MESHES = ["mesh1d", "mesh"]


def _ids(rng, offs, b=B):
    """Zipf-skewed table-local ids -> global ids (b, G, L) int32."""
    cols = [np.minimum(rng.zipf(1.3, (b, L)) - 1, v - 1) + o
            for v, o in zip(VOCABS, offs)]
    return np.stack(cols, axis=1).astype(np.int32)


def _carried(storage, mesh, hot_fraction=HOT):
    """A reference engine on ``mesh`` with planner-placed hot pages, and
    the port engine at 4 shards holding the same state."""
    jeng, offs = jengine_for_tables(VOCABS, DIM, mesh,
                                    hot_fraction=hot_fraction,
                                    page_bytes=PAGE_BYTES, storage=storage)
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    if hot_fraction > 0:
        for _ in range(3):
            jstate = jeng.observe(jstate, jnp.asarray(_ids(rng, offs)))
        jstate, _ = jeng.plan_and_migrate(jstate)
    eng, poffs = engine_for_tables(VOCABS, DIM, device="cpu",
                                   hot_fraction=hot_fraction,
                                   page_bytes=PAGE_BYTES, storage=storage,
                                   n_shards=TP)
    np.testing.assert_array_equal(offs, poffs)
    state = eng.pack_state(*map(np.asarray, jeng.export_state(jstate)),
                           table=PageTable(np.asarray(jstate.page_to_shard),
                                           np.asarray(jstate.page_to_slot)))
    return jeng, jstate, eng, state, offs, rng


def _batch(rng, offs, weighting="01"):
    idx = _ids(rng, offs)
    if weighting == "01":
        w = (rng.random(idx.shape) < 0.8).astype(np.float32)
    else:
        w = rng.uniform(-2, 2, idx.shape).astype(np.float32)
    x = rng.normal(size=(B, DIM)).astype(np.float32)
    return idx, w, x


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@pytest.mark.parametrize("meshname", MESHES)
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_state_carries_across_at_four_shards(storage, meshname, request):
    """pack_state(export) at 4 shards reproduces the reference's leaves
    (every shard's slice of the cold tier), dense view and export
    triple bit for bit, with hot pages present."""
    jeng, jstate, eng, state, _, _ = _carried(
        storage, request.getfixturevalue(meshname))
    assert dataclasses.asdict(eng.cfg) == dataclasses.asdict(jeng.cfg)
    assert eng.cfg.n_shards == TP
    assert (state.page_to_shard == HOT_SHARD).sum() > 0
    assert set(np.unique(state.page_to_shard.numpy())) >= set(range(TP))
    repacked = jeng.pack_state(*jeng.export_state(jstate),
                               table=jstate.page_table)
    for f in ("cold", "hot", "page_scales", "page_to_shard", "page_to_slot"):
        np.testing.assert_array_equal(getattr(state, f).numpy(),
                                      np.asarray(getattr(repacked, f)), f)
    np.testing.assert_array_equal(eng.to_dense(state).numpy(),
                                  np.asarray(jeng.to_dense(jstate)))


@pytest.mark.parametrize("meshname", MESHES)
@pytest.mark.parametrize("mode", ["pifs", "beacon", "pond"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_lookup_matches_reference_engine(storage, mode, meshname, request):
    """Every combine (psum, psum_scatter), both tiers settings (all,
    hot_only) and dedup off and on: bitwise at 0/1 weights (see the
    module docstring); general weights within (2 L + tp) eps sum |f row|.
    psum_scatter returns the whole batch, as the reference's global
    array assembles it."""
    jeng, jstate, eng, state, offs, rng = _carried(
        storage, request.getfixturevalue(meshname))
    idx, w, _ = _batch(rng, offs)
    ti, tw = _t(idx, w)
    for combine in ("psum", "psum_scatter"):
        for tiers in ("all", "hot_only"):
            for dedup in ("off", "on"):
                got = eng.lookup(state, ti, tw, mode=mode, combine=combine,
                                 tiers=tiers, dedup=dedup)
                want = jeng.lookup(jstate, jnp.asarray(idx), jnp.asarray(w),
                                   mode=mode, combine=combine, tiers=tiers,
                                   dedup=dedup)
                assert got.shape == (B, len(VOCABS), DIM)
                np.testing.assert_array_equal(
                    got.numpy(), np.asarray(want),
                    f"{combine} {tiers} dedup={dedup}")
    idx, w, _ = _batch(rng, offs, "general")
    got = eng.lookup(state, *_t(idx, w), mode=mode)
    want = np.asarray(jeng.lookup(jstate, jnp.asarray(idx), jnp.asarray(w),
                                  mode=mode))
    dense = np.abs(eng.to_dense(state).numpy().astype(np.float64))
    a = (np.abs(w)[..., None] * dense[idx]).sum(axis=2)
    assert (np.abs(got.numpy() - want) <= (2 * L + TP) * EPS * a).all()


@pytest.mark.parametrize("mode", ["pifs", "pond"])
def test_psum_scatter_raises_as_the_reference_does(mode, mesh1d):
    """psum_scatter needs the bags (pond: the batch) to split over tp."""
    jeng, jstate, eng, state, offs, rng = _carried("fp32", mesh1d)
    idx, w, _ = _batch(rng, offs)
    # pifs: 3 samples x 2 tables = 6 bags; pond: a batch of 2
    sub = idx[:3] if mode == "pifs" else idx[:2]
    with pytest.raises(ValueError, match="must divide tp"):
        eng.lookup(state, *_t(sub), mode=mode, combine="psum_scatter")
    with pytest.raises(ValueError, match="must divide tp"):
        jeng.lookup(jstate, jnp.asarray(sub), mode=mode,
                    combine="psum_scatter")


@pytest.mark.parametrize("meshname", MESHES)
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_lookup_interact_matches_reference(storage, meshname, request):
    """lookup_interact at 4 shards, pifs and pond, split and fused (which
    resolves 'fused_tp': partial pool -> shard sum -> resume), dedup off
    and on, against the reference engine (fused through its Pallas
    kernels in interpret mode with dedup off, its jnp datapath with dedup
    on).  Inside the port pifs fused == split, and pond fused == pifs
    fused, bitwise; pond split pools after the shard sum, so it is within
    tolerance of pond fused.  The front-end records equal the reference's
    (requested, resolved, reason, tp).

    The reference's tests/test_pifs_engine.py::
    test_front_end_tp_no_retrace_and_quantized covers the same resolution
    and is one of the reference tests known to fail on this tree
    (ROADMAP.md queue 3); this test copies none of its assertions."""
    jeng, jstate, eng, state, offs, rng = _carried(
        storage, request.getfixturevalue(meshname))
    idx, w, x = _batch(rng, offs)
    ti, tw, tx = _t(idx, w, x)
    for dedup in ("off", "on"):
        out = {(mode, fe): eng.lookup_interact(state, ti, tx, tw, mode=mode,
                                               front_end=fe, dedup=dedup)
               for mode in ("pifs", "pond") for fe in ("split", "fused")}
        np.testing.assert_array_equal(out["pifs", "split"].numpy(),
                                      out["pifs", "fused"].numpy())
        np.testing.assert_array_equal(out["pond", "fused"].numpy(),
                                      out["pifs", "fused"].numpy())
        np.testing.assert_allclose(out["pond", "split"].numpy(),
                                   out["pond", "fused"].numpy(),
                                   rtol=1e-5, atol=1e-6)
        for (mode, fe), got in out.items():
            impl = "pallas" if fe == "fused" and dedup == "off" else "jnp"
            want = jeng.lookup_interact(jstate, jnp.asarray(idx),
                                        jnp.asarray(x), jnp.asarray(w),
                                        mode=mode, impl=impl, front_end=fe,
                                        dedup=dedup)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
    recs = eng.plan_stats()["front_end"]
    jrecs = jeng.plan_stats()["front_end"]
    fields = ("requested", "resolved", "reason", "tp")
    assert {tuple(r[f] for f in fields) for r in recs.values()} == \
        {tuple(r[f] for f in fields) for r in jrecs.values()}
    assert {r["resolved"] for r in recs.values()} == {"split", "fused_tp"}
    assert all(r["tp"] == TP for r in recs.values())


def test_pond_resolves_fused_tp_at_one_shard():
    """One shard: a fused request resolves 'fused' in pifs and 'fused_tp'
    in pond (the reference's pond reason), and the two are bitwise
    equal."""
    mesh11 = make_mesh((1, 1), ("data", "model"))
    jeng, offs = jengine_for_tables(VOCABS, DIM, mesh11, hot_fraction=HOT,
                                    page_bytes=PAGE_BYTES)
    eng, _ = engine_for_tables(VOCABS, DIM, device="cpu", hot_fraction=HOT,
                               page_bytes=PAGE_BYTES)
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    state = eng.pack_state(*map(np.asarray, jeng.export_state(jstate)))
    idx, w, x = _batch(np.random.default_rng(3), offs)
    got = {m: eng.lookup_interact(state, *_t(idx, x, w), mode=m,
                                  front_end="fused") for m in ("pifs", "pond")}
    np.testing.assert_array_equal(got["pifs"].numpy(), got["pond"].numpy())
    for m in ("pifs", "pond"):
        jeng.lookup_interact(jstate, jnp.asarray(idx), jnp.asarray(x),
                             jnp.asarray(w), mode=m, front_end="fused")
    recs = {r["resolved"]: r for r in eng.plan_stats()["front_end"].values()}
    jrecs = {r["resolved"]: r
             for r in jeng.plan_stats()["front_end"].values()}
    assert recs == jrecs and set(recs) == {"fused", "fused_tp"}
    assert recs["fused_tp"]["tp"] == 1


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_dedup_factor_matches_reference_per_shard(storage, mesh1d):
    """The measured duplicate factor counts unique cold rows per shard
    (and hot rows once), as the reference's does on the (1, 4) mesh."""
    jeng, jstate, eng, state, offs, rng = _carried(storage, mesh1d)
    idx, w, _ = _batch(rng, offs)
    uniform = rng.integers(0, eng.cfg.padded_rows, idx.shape).astype(np.int32)
    for ids in (idx, uniform):
        for weights in (None, w):
            got = eng.dedup_factor(state, torch.as_tensor(ids),
                                   None if weights is None
                                   else torch.as_tensor(weights))
            want = jeng.dedup_factor(jstate, ids, weights)
            assert got == want
    # every shard owns entries of the uniform batch: shard 0 alone would
    # count fewer unique cold rows
    page = uniform // eng.cfg.page_size
    shards = state.page_to_shard.numpy()[page]
    assert set(shards.ravel().tolist()) >= set(range(TP))
    local = (state.page_to_slot.numpy()[page] * eng.cfg.page_size
             + uniform % eng.cfg.page_size)
    assert eng.dedup_factor(state, torch.as_tensor(uniform))["unique_cold"] \
        > np.unique(local[shards == 0]).size


def test_address_owns_each_cold_entry_on_one_shard(mesh1d):
    """Each entry's ownership masks: shard s owns the entries of its pages,
    every cold entry exactly one shard, hot entries none."""
    _, _, eng, state, offs, rng = _carried("fp32", mesh1d)
    idx = torch.as_tensor(_ids(rng, offs))
    _, owned, is_hot, _ = eng._address(state, idx)
    assert owned.shape == (TP,) + tuple(idx.shape)
    shard = state.page_to_shard[idx.long() // eng.cfg.page_size]
    for s in range(TP):
        assert torch.equal(owned[s], shard == s)
    assert torch.equal(owned.sum(0) == 1, ~is_hot)


def _tie_free_counts(rng, n):
    return (rng.permutation(n).astype(np.float32) + 1.0)


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_plan_and_migrate_at_four_shards_matches_reference(storage, mesh1d):
    """Two re-plans from tie-free histograms: the port's page tables and
    leaves equal the reference engine's (placements equal wherever no tie
    decides; here none does), and the dense table and one-id lookups do
    not change across either move."""
    jeng, jstate, eng, state, offs, rng = _carried(storage, mesh1d)
    jstate = jeng.pack_state(*jeng.export_state(jstate),
                             table=jstate.page_table)
    for _ in range(2):
        counts = _tie_free_counts(rng, eng.cfg.num_pages)
        state = dataclasses.replace(state, counts=torch.as_tensor(counts))
        jstate = dataclasses.replace(jstate, counts=jnp.asarray(counts))
        probe = torch.as_tensor(_ids(rng, offs).reshape(-1, 1, 1))
        before = eng.lookup(state, probe)
        dense = eng.to_dense(state)
        state, stats = eng.plan_and_migrate(state)
        jstate, jstats = jeng.plan_and_migrate(jstate)
        assert stats == jstats
        for f in ("page_to_shard", "page_to_slot", "cold", "hot",
                  "page_scales", "counts"):
            np.testing.assert_array_equal(getattr(state, f).numpy(),
                                          np.asarray(getattr(jstate, f)), f)
        np.testing.assert_array_equal(eng.lookup(state, probe).numpy(),
                                      before.numpy())
        np.testing.assert_array_equal(eng.to_dense(state).numpy(),
                                      dense.numpy())
    moved = np.asarray(jstate.page_to_shard)
    assert set(np.unique(moved)) == set(range(-1, TP))


def test_migrate_random_tables_at_four_shards_matches_reference(mesh1d):
    """Placements with pages on every shard and the hot tier, moved twice:
    the int8 leaves (codes moved verbatim, promotions dequantized,
    demotions re-quantized on the carried scale) equal the reference's."""
    jeng, jstate, eng, state, _, rng = _carried("int8", mesh1d)
    jstate = jeng.pack_state(*jeng.export_state(jstate),
                             table=jstate.page_table)
    c = eng.cfg
    for _ in range(2):
        shard = np.full(c.num_pages, HOT_SHARD, np.int32)
        slot = np.zeros(c.num_pages, np.int32)
        order = rng.permutation(c.num_pages)
        hot, cold = order[:c.hot_pages], order[c.hot_pages:]
        slot[hot] = rng.permutation(c.hot_pages)[:hot.size]
        cells = rng.permutation(TP * c.pages_per_shard)[:cold.size]
        shard[cold], slot[cold] = cells % TP, cells // TP
        state = eng.migrate(state, PageTable(shard, slot))
        jstate = jeng.migrate(jstate, JPageTable(jnp.asarray(shard),
                                                 jnp.asarray(slot)))
        for f in ("cold", "hot", "page_scales", "page_to_shard",
                  "page_to_slot", "counts"):
            np.testing.assert_array_equal(getattr(state, f).numpy(),
                                          np.asarray(getattr(jstate, f)), f)


# ------------------------------------------------------------------ DLRM
DB = 8


def _dlrm_carried(storage, mesh):
    cfg = jreduced(jget_config("rmc1"))
    jeng, offs = jdlrm.build_engine(cfg, mesh, storage=storage)
    params = jprm.initialize(jdlrm.model_specs(cfg, mesh),
                             jax.random.PRNGKey(0))
    jstate = jeng.init_state(jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)

    def batch():
        ids = np.minimum(rng.zipf(1.2, (DB, cfg.n_tables, cfg.pooling)) - 1,
                         cfg.emb_num - 1)
        return {"dense": rng.normal(size=(DB, cfg.n_dense)).astype(
                    np.float32),
                "indices": (ids + offs[None, :, None]).astype(np.int32),
                "weights": (rng.random(ids.shape) < 0.8).astype(np.float32)}

    for _ in range(3):
        jstate = jeng.observe(jstate, jnp.asarray(batch()["indices"]))
    jstate, _ = jeng.plan_and_migrate(jstate)
    pcfg = reduced(get_config("rmc1"))
    model = dlrm.DLRM(pcfg, "cpu")
    model.load_state_dict(dlrm.params_from_numpy(
        jax.tree.map(np.asarray, params)))
    eng, _ = dlrm.build_engine(pcfg, "cpu", storage=storage,
                               n_shards=jeng.cfg.n_shards)
    state = eng.pack_state(
        *map(np.asarray, jeng.export_state(jstate)),
        table=PageTable(np.asarray(jstate.page_to_shard),
                        np.asarray(jstate.page_to_slot)))
    return cfg, jeng, jstate, params, model, eng, state, batch()


@pytest.mark.parametrize("front_end", ["split", "fused"])
@pytest.mark.parametrize("mode", ["pifs", "pond"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_serve_step_matches_reference_at_four_shards(storage, mode,
                                                     front_end, mesh1d):
    """The DLRM serve step at 4 shards (pifs and pond, split and fused)
    with the reference's weights and state: scores within 1e-5 of the
    reference's ``make_serve_step`` on the (1, 4) mesh."""
    cfg, jeng, jstate, params, model, eng, state, batch = _dlrm_carried(
        storage, mesh1d)
    assert eng.cfg.n_shards == TP
    with mesh1d:
        step = jax.jit(jdlrm.make_serve_step(cfg, jeng, mesh1d, mode=mode,
                                             front_end=front_end))
        want = np.asarray(step(params, jstate,
                               jax.tree.map(jnp.asarray, batch)))
    got = dlrm.make_serve_step(model, eng, mode=mode, front_end=front_end)(
        state, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert got.shape == (DB,) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("front_end", ["split", "fused"])
def test_pond_serve_step_matches_reference_at_one_shard(front_end):
    mesh11 = make_mesh((1, 1), ("data", "model"))
    cfg, jeng, jstate, params, model, eng, state, batch = _dlrm_carried(
        "int8", mesh11)
    with mesh11:
        step = jax.jit(jdlrm.make_serve_step(cfg, jeng, mesh11, mode="pond",
                                             front_end=front_end))
        want = np.asarray(step(params, jstate,
                               jax.tree.map(jnp.asarray, batch)))
    got = dlrm.make_serve_step(model, eng, mode="pond", front_end=front_end)(
        state, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_serve_loop_at_four_shards_and_in_pond():
    """The port's serve loop with the cold tier in 4 shards: fused ==
    split bitwise, dedup on == off bitwise, through the maintenance
    cadence (observe every 2 batches, a re-plan after the fourth); pond
    fused == pifs fused bitwise at one shard; scores in (0, 1) and
    within 1e-5 of one shard's."""
    cfg = reduced(get_config("rmc1"))
    reqs = loadgen.request_stream(cfg, loadgen.LoadConfig(
        48, ArrivalConfig(200.0, seed=7), seed=7))
    b4 = loadgen.bind_model(cfg, "cpu", seed=7, profile=reqs[:12],
                            n_shards=TP)
    b1 = loadgen.bind_model(cfg, "cpu", seed=7, profile=reqs[:12])
    s4, s1 = b4.state, b1.state

    def run(b, st, fe, mode="pifs", dedup="off"):
        b.state = st
        step = dlrm.make_serve_step(b.model, b.engine, front_end=fe,
                                    mode=mode, dedup=dedup)
        return srv.serve(b, step, reqs, 8,
                         observe_every=2, replan_every=4)

    out = {(fe, d): run(b4, s4, fe, dedup=d)
           for fe in ("split", "fused") for d in ("off", "on")}
    ref = out["split", "off"]["scores"]
    assert out["split", "off"]["replans"] == 1
    assert np.isfinite(ref).all() and (ref > 0).all() and (ref < 1).all()
    for k, v in out.items():
        np.testing.assert_array_equal(v["scores"], ref, str(k))
    one = run(b1, s1, "fused")["scores"]
    np.testing.assert_allclose(ref, one, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(run(b1, s1, "fused", mode="pond")["scores"],
                                  one)
    # the split serve path calls lookup, which keeps no front-end record
    recs = b4.engine.plan_stats()["front_end"]
    assert recs and all(r["resolved"] == "fused_tp" and r["tp"] == TP
                        for r in recs.values())


def test_serve_cli_pond_on_cpu(monkeypatch, capsys):
    """--mode pond serves on the CPU when asked for it and raises without
    CUDA otherwise."""
    out = srv.main(["--device", "cpu", "--mode", "pond", "--requests", "24",
                    "--batcher", "fixed", "--batch-sizes", "8",
                    "--front-end", "fused"])
    assert out["scores_finite"] and out["batches"] == 3
    (rec,) = out["front_end"].values()
    assert rec["resolved"] == "fused_tp" and rec["tp"] == 1
    assert "front_end" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        srv.main(["--mode", "pond", "--requests", "4"])
    # --mesh-faults serves pond on 4 shards and re-meshes onto 2
    out = srv.main(["--device", "cpu", "--mode", "pond", "--requests", "48",
                    "--front-end", "fused", "--mesh-faults"])
    assert out["remesh"]["to_mesh"] == {"data": 1, "model": 2}
    assert out["served"] + out["failed"] == 48 and out["scores_finite"]
