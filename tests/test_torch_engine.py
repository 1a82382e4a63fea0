"""Port engine vs the JAX engine on a 1x1 mesh (the reference's one-device
config), after carrying the reference state across: a JAX engine whose hot
tier was filled by ``observe`` + ``plan_and_migrate`` exports its
placement-free ``(codes, values, scales)`` triple and page table into the
port's ``pack_state``.

Lookups are bitwise equal at 0/1 weights (fp32 and int8); general weights
within 2 * L * 2^-23 * sum_l |f_l * row_l| per element (one extra rounding
per accumulate step: XLA contracts to FMA, the plain version does not).
Interaction outputs within 1e-5 relative / 1e-6 absolute: XLA and
torch.bmm reduce over D in different orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pifs import engine_for_tables as jengine_for_tables
from repro.distributed.sharding import make_mesh

from repro_torch.core.paging import HOT_SHARD, PageTable
from repro_torch.core.pifs import engine_for_tables

VOCABS, DIM, PAGE_BYTES, HOT = [300, 200], 16, 512, 0.2
B, L = 6, 5


@pytest.fixture(scope="module")
def mesh11():
    return make_mesh((1, 1), ("data", "model"))


def _ids(rng, offs, vocabs=VOCABS):
    """Zipf-skewed table-local ids -> global ids (B, G, L) int32."""
    cols = [np.minimum(rng.zipf(1.3, (B, L)) - 1, v - 1) + o
            for v, o in zip(vocabs, offs)]
    return np.stack(cols, axis=1).astype(np.int32)


def _carried(storage, mesh11, hot_fraction=HOT):
    """A JAX engine with planner-placed hot pages, and the port engine
    holding the same state."""
    jeng, offs = jengine_for_tables(VOCABS, DIM, mesh11,
                                    hot_fraction=hot_fraction,
                                    page_bytes=PAGE_BYTES, storage=storage)
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    if hot_fraction > 0:
        for _ in range(3):
            jstate = jeng.observe(jstate, jnp.asarray(_ids(rng, offs)))
        jstate, _ = jeng.plan_and_migrate(jstate)
    codes, values, scales = jeng.export_state(jstate)
    eng, poffs = engine_for_tables(VOCABS, DIM, device="cpu",
                                   hot_fraction=hot_fraction,
                                   page_bytes=PAGE_BYTES, storage=storage)
    np.testing.assert_array_equal(offs, poffs)
    table = PageTable(np.asarray(jstate.page_to_shard),
                      np.asarray(jstate.page_to_slot))
    state = eng.pack_state(np.asarray(codes), np.asarray(values),
                           np.asarray(scales), table)
    return jeng, jstate, eng, state, offs, rng


def _batch(rng, offs, weighting):
    idx = _ids(rng, offs)
    if weighting == "01":
        w = (rng.random(idx.shape) < 0.8).astype(np.float32)
    else:
        w = rng.uniform(-2, 2, idx.shape).astype(np.float32)
    x = rng.normal(size=(B, DIM)).astype(np.float32)
    return idx, w, x


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_state_carries_across_bitwise(storage, mesh11):
    """pack_state(export) reproduces the reference's leaves, dense view and
    export triple bit for bit, with hot pages present."""
    jeng, jstate, eng, state, _, _ = _carried(storage, mesh11)
    assert dataclasses.asdict(eng.cfg) == dataclasses.asdict(jeng.cfg)
    assert (state.page_to_shard == HOT_SHARD).sum() > 0
    # leaves equal the reference's own pack of the same triple (migration
    # leaves stale content in unmapped slots; packing zero-fills them)
    repacked = jeng.pack_state(*jeng.export_state(jstate),
                               table=jstate.page_table)
    for f in ("cold", "hot", "page_scales", "page_to_shard", "page_to_slot"):
        np.testing.assert_array_equal(getattr(state, f).numpy(),
                                      np.asarray(getattr(repacked, f)), f)
    np.testing.assert_array_equal(eng.to_dense(state).numpy(),
                                  np.asarray(jeng.to_dense(jstate)))
    for a, b in zip(eng.export_state(state), jeng.export_state(jstate)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # from_dense under the same placement packs the same leaves
    dense = np.asarray(jeng.to_dense(jstate))
    if storage == "fp32":
        again = eng.from_dense(torch.as_tensor(dense), state.page_table)
        want = jeng.from_dense(jnp.asarray(dense), jstate.page_table)
        for f in ("cold", "hot", "page_scales"):
            np.testing.assert_array_equal(getattr(again, f).numpy(),
                                          np.asarray(getattr(want, f)), f)


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_from_dense_quantizes_like_the_reference(storage, mesh11):
    jeng, _, eng, _, _, _ = _carried(storage, mesh11, hot_fraction=0.0)
    dense = np.random.default_rng(4).normal(
        size=(eng.cfg.padded_rows, DIM)).astype(np.float32) * 0.01
    got = eng.from_dense(torch.as_tensor(dense))
    want = jeng.from_dense(jnp.asarray(dense))
    for f in ("cold", "hot", "page_scales", "page_to_shard", "page_to_slot"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


@pytest.mark.parametrize("tiers", ["all", "hot_only"])
@pytest.mark.parametrize("weighting", ["01", "general"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_lookup_matches_reference_engine(storage, weighting, tiers, mesh11):
    jeng, jstate, eng, state, offs, rng = _carried(storage, mesh11)
    idx, w, _ = _batch(rng, offs, weighting)
    got = eng.lookup(state, torch.as_tensor(idx), torch.as_tensor(w),
                     tiers=tiers)
    want = np.asarray(jeng.lookup(jstate, jnp.asarray(idx), jnp.asarray(w),
                                  tiers=tiers))
    assert got.shape == (B, len(VOCABS), DIM)
    if weighting == "01":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        # bound per tier, from the dense view of every row
        dense = np.abs(eng.to_dense(state).numpy().astype(np.float64))
        a = (np.abs(w)[..., None] * dense[idx]).sum(axis=2)
        assert (np.abs(got.numpy() - want) <= 2 * L * 2.0 ** -23 * a).all()


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_lookup_matches_reference_pallas_path(storage, mesh11):
    """Against the reference engine's Pallas datapath (interpret mode) too:
    bitwise at 0/1 weights."""
    jeng, jstate, eng, state, offs, rng = _carried(storage, mesh11)
    idx, w, _ = _batch(rng, offs, "01")
    got = eng.lookup(state, torch.as_tensor(idx), torch.as_tensor(w))
    want = jeng.lookup(jstate, jnp.asarray(idx), jnp.asarray(w),
                       impl="pallas")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_lookup_interact_matches_reference_split_and_fused(storage, mesh11):
    """lookup_interact, split and fused, against the reference engine (whose
    fused request resolves to the single kernel at tp = 1, run here in
    interpret mode); fused == split bitwise inside the port."""
    jeng, jstate, eng, state, offs, rng = _carried(storage, mesh11)
    idx, w, x = _batch(rng, offs, "01")
    ti, tw, tx = map(torch.as_tensor, (idx, w, x))
    out = {fe: eng.lookup_interact(state, ti, tx, tw, front_end=fe)
           for fe in ("split", "fused")}
    np.testing.assert_array_equal(out["split"].numpy(),
                                  out["fused"].numpy())
    for fe, impl in (("split", "jnp"), ("fused", "pallas")):
        want = jeng.lookup_interact(jstate, jnp.asarray(idx), jnp.asarray(x),
                                    jnp.asarray(w), impl=impl, front_end=fe)
        np.testing.assert_allclose(out[fe].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    recs = eng.plan_stats()["front_end"]
    assert {r["resolved"] for r in recs.values()} == {"split", "fused"}
    assert all(r["tp"] == 1 for r in recs.values())
    jrecs = jeng.plan_stats()["front_end"]
    assert {(r["requested"], r["resolved"], r["reason"])
            for r in recs.values()} == {
        (r["requested"], r["resolved"], r["reason"]) for r in jrecs.values()}


def test_empty_hot_tier_beacon_placement(mesh11):
    """hot_fraction=0 and no promotion (the BEACON placement): every entry
    is cold, fused == split, and both equal the reference."""
    jeng, jstate, eng, state, offs, rng = _carried("fp32", mesh11,
                                                   hot_fraction=0.0)
    assert not bool((state.page_to_shard == HOT_SHARD).any())
    idx, w, x = _batch(rng, offs, "01")
    ti, tw, tx = map(torch.as_tensor, (idx, w, x))
    split = eng.lookup_interact(state, ti, tx, tw, mode="beacon")
    fused = eng.lookup_interact(state, ti, tx, tw, mode="beacon",
                                front_end="fused")
    np.testing.assert_array_equal(split.numpy(), fused.numpy())
    want = jeng.lookup(jstate, jnp.asarray(idx), jnp.asarray(w),
                       mode="beacon")
    np.testing.assert_array_equal(
        eng.lookup(state, ti, tw, mode="beacon").numpy(), np.asarray(want))


def test_not_ported_knobs_raise_and_name_the_roadmap(mesh11):
    """The knobs earlier slices refused (pond, psum_scatter, n_shards > 1)
    now run and agree with pifs/psum; unknown values still raise."""
    _, _, eng, state, offs, rng = _carried("fp32", mesh11)
    idx, w, x = map(torch.as_tensor, _batch(rng, offs, "01"))
    base = eng.lookup(state, idx, w)
    base_i = eng.lookup_interact(state, idx, x, w, front_end="fused")
    for kw in (dict(mode="pond"), dict(combine="psum_scatter")):
        got = eng.lookup(state, idx, w, **kw)
        # pond pools over l after the shard sum: another order than pifs
        np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_array_equal(
            eng.lookup_interact(state, idx, x, w, front_end="fused",
                                **kw).numpy(), base_i.numpy())
    with pytest.raises(ValueError):
        eng.lookup(state, idx, w, dedup="bogus")
    with pytest.raises(ValueError):
        eng.lookup(state, idx, w, mode="bogus")
    with pytest.raises(ValueError):
        eng.lookup(state, idx, w, combine="bogus")
    with pytest.raises(ValueError):
        eng.lookup_interact(state, idx, x[:, :4], w)
    two = type(eng)(dataclasses.replace(eng.cfg, n_shards=2), device="cpu")
    state2 = two.pack_state(*eng.export_state(state), table=None)
    np.testing.assert_allclose(two.lookup(state2, idx, w).numpy(),
                               eng.lookup(eng.pack_state(
                                   *eng.export_state(state)), idx, w).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_validate_ids_raises_on_out_of_range(mesh11):
    eng, offs = engine_for_tables(VOCABS, DIM, device="cpu",
                                  page_bytes=PAGE_BYTES, validate_ids=True)
    state = eng.init_state(torch.Generator().manual_seed(0))
    idx = torch.as_tensor(_ids(np.random.default_rng(0), offs))
    eng.lookup(state, idx)
    idx[0, 0, 0] = eng.cfg.padded_rows
    with pytest.raises(ValueError, match="out-of-range"):
        eng.lookup(state, idx)


def test_engine_raises_without_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine_for_tables(VOCABS, DIM)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine_for_tables(VOCABS, DIM, device="cuda")
    eng, _ = engine_for_tables(VOCABS, DIM, device="cpu")
    assert eng.device.type == "cpu"
