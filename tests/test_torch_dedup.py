"""Gather-once dedup in the port against the JAX package: ``dedup_plan``,
the plain versions of the two dedup kernels against the Pallas kernels
(interpret mode, as tests/test_kernels.py runs them) and the jnp oracles,
and the engine's dedup resolution against the reference engine on a 1x1
mesh.

Tolerances.  At 0/1 weights every product f * row is exact, so the SLS is
bitwise equal whether a step is one FMA (XLA on the CPU) or a multiply and
an add (the plain version).  With general weights each of the L steps may
round once more: |diff| <= 2 * L * 2^-23 * sum_l |f_l * row_l|.  The
interaction reduces over D in different orders in XLA and torch.bmm, so
fused outputs are compared within 1e-5 relative, 1e-6 absolute.  Inside
the port, dedup on == dedup off bitwise for every weight: the staged rows
are the per-entry rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sls as jsls
from repro.core.pifs import engine_for_tables as jengine_for_tables
from repro.distributed.sharding import make_mesh
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sls import fused_front_end_dedup_pallas

from repro_torch.core import sls
from repro_torch.core.paging import PageTable
from repro_torch.core.pifs import engine_for_tables
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import sls as ksls

EPS = 2.0 ** -23


def _t(x):
    return None if x is None else torch.as_tensor(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _bags(seed, N, L, V, D, storage, weighting, kind="random"):
    """Bags with repeats.  Scales are a function of the row (one scale per
    row, as rows of one page share their page's scale)."""
    rng = np.random.default_rng(seed)
    if kind == "all_dup":
        idx = np.full((N, L), V // 2, np.int32)
    elif kind == "all_unique":
        idx = rng.permutation(V)[: N * L].reshape(N, L).astype(np.int32)
    else:
        idx = np.minimum(rng.zipf(1.3, (N, L)) - 1, V - 1).astype(np.int32)
    owned = (np.zeros((N, L), bool) if kind == "all_masked"
             else rng.random((N, L)) < 0.7)
    if storage == "int8":
        table = rng.integers(-127, 128, (V, D)).astype(np.int8)
        row_scale = rng.uniform(1e-4, 2e-2, V).astype(np.float32)
        scales = row_scale[idx]
    else:
        table = rng.normal(size=(V, D)).astype(np.float32)
        scales = None
    w = ((rng.random((N, L)) < 0.8).astype(np.float32) if weighting == "01"
         else rng.uniform(-2, 2, (N, L)).astype(np.float32))
    return table, idx, owned, w, scales


def _sls_bound(table, idx, owned, w, scales):
    rows = np.abs(table[np.where(owned, idx, 0)].astype(np.float64))
    if scales is not None:
        rows = rows * np.abs(scales)[..., None]
    f = np.abs(owned * w).astype(np.float64)
    return 2 * idx.shape[1] * EPS * (f[..., None] * rows).sum(axis=1)


def _assert_plan_equal(plan, jplan, owned):
    np.testing.assert_array_equal(plan.unique_rows.numpy(),
                                  np.asarray(jplan.unique_rows))
    np.testing.assert_array_equal(plan.slots.numpy(), np.asarray(jplan.slots))
    assert int(plan.n_slots) == int(jplan.n_slots)
    assert int(plan.n_unique) == int(jplan.n_unique)
    if jplan.unique_scales is not None:
        live = np.unique(np.asarray(jplan.slots)[owned])
        np.testing.assert_array_equal(
            plan.unique_scales.numpy()[live],
            np.asarray(jplan.unique_scales)[live])


KINDS = ["random", "all_dup", "all_unique", "all_masked"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_dedup_plan_matches_reference(storage, kind):
    table, idx, owned, _, scales = _bags(3, 8, 9, 300, 16, storage, "01",
                                         kind)
    plan = sls.dedup_plan(_t(idx), _t(owned), _t(scales))
    jplan = jsls.dedup_plan(_j(idx), _j(owned), _j(scales))
    _assert_plan_equal(plan, jplan, owned)
    assert plan.slots.dtype == plan.unique_rows.dtype == torch.int32
    assert plan.n_slots.shape == (1,)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("weighting", ["01", "general"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_masked_sls_dedup_plain_matches_pallas_and_oracle(storage, weighting,
                                                          kind):
    """Port plain dedup SLS vs the Pallas dedup kernel (interpret, a tail
    tile: block_l=4) and the jnp oracle: bitwise at 0/1 weights, within the
    one-rounding-per-step bound otherwise; and bitwise equal to the port's
    own non-dedup SLS for every weight."""
    N, L, V, D = 8, 9, 300, 32
    table, idx, owned, w, scales = _bags(7, N, L, V, D, storage, weighting,
                                         kind)
    plan = sls.dedup_plan(_t(idx), _t(owned), _t(scales))
    got = ops.masked_sls_dedup(_t(table), plan, _t(owned), _t(w))
    assert got.shape == (N, D) and got.dtype == torch.float32
    jplan = jsls.dedup_plan(_j(idx), _j(owned), _j(scales))
    pallas = jops.masked_sls_dedup(_j(table), jplan, _j(owned), _j(w),
                                   interpret=True, block_l=4)
    oracle = jref.masked_sls_dedup_ref(_j(table), jplan.unique_rows,
                                       jplan.slots, _j(owned), _j(w),
                                       jplan.unique_scales)
    for want in (pallas, oracle):
        if weighting == "01":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            err = np.abs(got.numpy().astype(np.float64) - np.asarray(want))
            assert (err <= _sls_bound(table, idx, owned, w, scales)).all()
    per_entry = ops.masked_sls(_t(table), _t(idx), _t(owned), _t(w),
                               _t(scales))
    np.testing.assert_array_equal(got.numpy(), per_entry.numpy())
    np.testing.assert_array_equal(
        ref.masked_sls_dedup_ref(_t(table), plan.unique_rows, plan.slots,
                                 _t(owned), _t(w),
                                 plan.unique_scales).numpy(), got.numpy())


def _fe_case(seed, B, G, L, Vc, Vh, D, storage, weighting):
    rng = np.random.default_rng(seed)
    rows = np.minimum(rng.zipf(1.3, (B, G, L)) - 1,
                      min(Vc, Vh) - 1).astype(np.int32)
    owned = rng.random((B, G, L)) < 0.5
    is_hot = ~owned & (rng.random((B, G, L)) < 0.7)     # some in neither
    if storage == "int8":
        cold = rng.integers(-127, 128, (Vc, D)).astype(np.int8)
        scales = rng.uniform(1e-4, 2e-2, Vc).astype(np.float32)[rows]
    else:
        cold = rng.normal(size=(Vc, D)).astype(np.float32)
        scales = None
    hot = rng.normal(size=(Vh, D)).astype(np.float32)
    w = ((rng.random((B, G, L)) < 0.8).astype(np.float32)
         if weighting == "01"
         else rng.uniform(-2, 2, (B, G, L)).astype(np.float32))
    x = rng.normal(size=(B, D)).astype(np.float32)
    return cold, hot, x, rows, owned, is_hot, w, scales


@pytest.mark.parametrize("weighting", ["01", "general"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_fused_front_end_dedup_plain_matches_pallas(storage, weighting):
    """Port plain fused-dedup vs the fused dedup Pallas kernel (interpret;
    B not a multiple of block_b, L not of block_l) within the interaction's
    tolerance, and bitwise equal to the port's fused non-dedup path and to
    the split composition."""
    B, G, L, D = 5, 3, 7, 16
    args = _fe_case(11, B, G, L, 40, 30, D, storage, weighting)
    cold, hot, x, rows, owned, is_hot, w, scales = args
    T = [_t(a) for a in args]
    got = sls.fused_front_end_dense(*T[:6], weights=T[6], scales=T[7],
                                    dedup=True)
    assert got.shape == (B, (G + 1) * G // 2)
    nb = B * G
    cp = jsls.dedup_plan(_j(rows.reshape(nb, L)), _j(owned.reshape(nb, L)),
                         None if scales is None
                         else _j(scales.reshape(nb, L)))
    hp = jsls.dedup_plan(_j(rows.reshape(nb, L)), _j(is_hot.reshape(nb, L)))
    pallas = fused_front_end_dedup_pallas(
        _j(cold), _j(hot), _j(x), cp.unique_rows,
        cp.slots.reshape(B, G, L), cp.n_slots, hp.unique_rows,
        hp.slots.reshape(B, G, L), hp.n_slots, _j(owned), _j(is_hot), _j(w),
        cp.unique_scales, interpret=True, block_l=3, block_b=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-6)
    fused = sls.fused_front_end_dense(*T[:6], weights=T[6], scales=T[7])
    np.testing.assert_array_equal(got.numpy(), fused.numpy())
    flat = rows.reshape(nb, L)
    pooled = (ops.masked_sls(_t(cold), _t(flat), _t(owned.reshape(nb, L)),
                             _t(w.reshape(nb, L)),
                             None if scales is None
                             else _t(scales.reshape(nb, L)))
              + ops.masked_sls(_t(hot), _t(flat), _t(is_hot.reshape(nb, L)),
                               _t(w.reshape(nb, L))))
    split = ops.dot_interaction(torch.cat(
        [_t(x)[:, None], pooled.reshape(B, G, D)], 1))
    np.testing.assert_array_equal(got.numpy(), split.numpy())


def test_capacity_fallback_is_exact():
    table, idx, owned, w, _ = _bags(5, 6, 8, 300, 16, "fp32", "general")
    T = [_t(a) for a in (table, idx, owned, w)]
    want = sls.masked_partial_sls_dense(*T)
    for cap in (None, 48, 47, 1):
        got = sls.masked_partial_sls_dense(*T, dedup=True,
                                           dedup_capacity=cap)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_dedup_wrappers_check_inputs():
    table, idx, owned, w, _ = _bags(1, 4, 3, 50, 16, "fp32", "01")
    plan = sls.dedup_plan(_t(idx), _t(owned))
    with pytest.raises(ValueError):            # capacity != N * L
        ops.masked_sls_dedup(_t(table), plan._replace(
            unique_rows=plan.unique_rows[:-1]), _t(owned))
    with pytest.raises(TypeError):             # int64 slots
        ops.masked_sls_dedup(_t(table), plan._replace(
            slots=plan.slots.long()), _t(owned))
    with pytest.raises(ValueError):            # int8 table, no scales
        ops.masked_sls_dedup(_t(table).to(torch.int8), plan, _t(owned))
    with pytest.raises(ValueError):            # no ownership mask
        ops.masked_sls_dedup(_t(table), plan, None)
    build.reset_launches()
    ops.masked_sls_dedup(_t(table), plan, _t(owned), _t(w))
    assert all(k.launches == 0 for k in build.KERNELS.values())
    with pytest.raises(ValueError, match="CUDA tensors"):
        ksls.masked_sls_dedup(_t(table), plan.unique_rows, plan.slots,
                              _t(owned), plan.n_slots)
    for name, line in (("masked_sls_dedup", "sls.py:304"),
                       ("fused_front_end_dedup", "sls.py:683")):
        assert line in build.KERNELS[name].replaces
        assert build.KERNELS[name].source.endswith(".cu")


# --------------------------------------------------------------- engine
VOCABS, DIM, PAGE_BYTES, HOT = [300, 200], 16, 512, 0.2


@pytest.fixture(scope="module")
def mesh11():
    return make_mesh((1, 1), ("data", "model"))


def _engines(storage, mesh11, **kw):
    """Reference and port engines holding the same state, counts included
    (a histogram from observe, hot pages placed by the planner)."""
    jeng, offs = jengine_for_tables(VOCABS, DIM, mesh11, hot_fraction=HOT,
                                    page_bytes=PAGE_BYTES, storage=storage)
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    for _ in range(3):
        jstate = jeng.observe(jstate, jnp.asarray(_ids(rng, offs, 6, 5)))
    jstate, _ = jeng.plan_and_migrate(jstate)
    eng, _ = engine_for_tables(VOCABS, DIM, device="cpu", hot_fraction=HOT,
                               page_bytes=PAGE_BYTES, storage=storage)
    for k, v in kw.items():
        setattr(eng, k, v)
        setattr(jeng, k, v)
    state = eng.pack_state(*map(np.asarray, jeng.export_state(jstate)),
                           table=PageTable(np.asarray(jstate.page_to_shard),
                                           np.asarray(jstate.page_to_slot)),
                           counts=np.asarray(jstate.counts))
    return jeng, jstate, eng, state, offs, rng


def _ids(rng, offs, B, L):
    cols = [np.minimum(rng.zipf(1.3, (B, L)) - 1, v - 1) + o
            for v, o in zip(VOCABS, offs)]
    return np.stack(cols, axis=1).astype(np.int32)


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_engine_dedup_on_equals_off_bitwise(storage, mesh11):
    _, _, eng, state, offs, rng = _engines(storage, mesh11)
    idx = torch.as_tensor(_ids(rng, offs, 6, 5))
    w = torch.as_tensor(rng.uniform(-2, 2, tuple(idx.shape)).astype(
        np.float32))
    x = torch.as_tensor(rng.normal(size=(6, DIM)).astype(np.float32))
    off = eng.lookup(state, idx, w)
    np.testing.assert_array_equal(eng.lookup(state, idx, w,
                                             dedup="on").numpy(),
                                  off.numpy())
    for fe in ("split", "fused"):
        off = eng.lookup_interact(state, idx, x, w, front_end=fe)
        on = eng.lookup_interact(state, idx, x, w, front_end=fe, dedup="on")
        np.testing.assert_array_equal(on.numpy(), off.numpy())
    recs = eng.plan_stats()["dedup"]
    assert len(recs) == 3 and all(r["resolved"] for r in recs.values())


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_dedup_records_and_factors_match_reference(storage, mesh11):
    """Same carried state, counts and budget: the resolution records (for
    'on' and 'auto', split and fused, under and over the staging budget,
    with and without the serving hint) and dedup_factor dicts equal the
    reference engine's, and dedup'd lookups equal its lookups bitwise."""
    jeng, jstate, eng, state, offs, rng = _engines(
        storage, mesh11, dedup_staging_bytes=12 * 5 * 2 * DIM * 4)
    want, got = [], []
    for hint in (None, 9.0):
        eng.dedup_auto_hint = jeng.dedup_auto_hint = hint
        for B in (6, 12, 13):              # 12 and 13 bust the fused budget
            idx = _ids(rng, offs, B, 5)
            w = (rng.random(idx.shape) < 0.8).astype(np.float32)
            x = rng.normal(size=(B, DIM)).astype(np.float32)
            for dedup in ("on", "auto"):
                out = eng.lookup(state, _t(idx), _t(w), dedup=dedup)
                ref_out = jeng.lookup(jstate, _j(idx), _j(w), dedup=dedup)
                np.testing.assert_array_equal(out.numpy(),
                                              np.asarray(ref_out))
                eng.lookup_interact(state, _t(idx), _t(x), _t(w),
                                    dedup=dedup, front_end="fused")
                jeng.lookup_interact(jstate, _j(idx), _j(x), _j(w),
                                     dedup=dedup, front_end="fused")
            assert (eng.dedup_factor(state, _t(idx), _t(w))
                    == jeng.dedup_factor(jstate, idx, w))
            assert (eng.dedup_factor(state, _t(idx))
                    == jeng.dedup_factor(jstate, idx))
        want += list(jeng.plan_stats()["dedup"].values())
        got += list(eng.plan_stats()["dedup"].values())
        eng.reset_plan_stats(clear_plans=True)
        jeng.reset_plan_stats(clear_plans=True)
    key = lambda r: sorted((k, str(v)) for k, v in r.items())  # noqa: E731
    assert sorted(map(key, got)) == sorted(map(key, want))
    assert {r["resolved"] for r in got} == {True, False}
    assert "dedup" not in eng.plan_stats()


@pytest.mark.parametrize("dim", [64, 128])
def test_default_budget_resolves_on_at_32_and_off_at_2048(dim):
    """The reference's 4 MiB staging budget at RMC widths: one tier's
    (split) or both tiers' (fused) staging fits at batch 32 and not at
    batch 2048."""
    eng, _ = engine_for_tables([4096], dim, device="cpu", hot_fraction=0.05)
    state = eng.init_state(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    for B, on in ((32, True), (2048, False)):
        idx = torch.as_tensor(rng.integers(0, 4096, (B, 8, 8)).astype(
            np.int32))
        for fe in ("split", "fused"):
            key = ("interact", "pifs", "psum", "torch", "fp32", "on", fe,
                   (B, 8, 8), False)
            assert eng._resolve_dedup(
                key, "on", state, idx,
                fused_blocks=32 if fe == "fused" else None) is on


def _edged(table, storage, rng):
    """``table`` between two rows of +-1e30 (int8: +-127): row 0 and the
    last row, the rows a masked entry reads (per entry, or through the
    plan's sentinel slot); real rows move up by one."""
    sign = np.where(rng.random((2, table.shape[1])) < 0.5, -1, 1)
    huge = ((sign * 127).astype(np.int8) if storage == "int8"
            else (sign * 1e30).astype(np.float32))
    return np.concatenate([huge[:1], table, huge[1:]])


def _check_dedup_kernels(dev):
    """The gather-once kernels (on ``dev``) against the per-entry ones on
    the same entries, bitwise for every weight, and against their plain
    versions, bitwise at 0/1 weights: on random and all-masked batches,
    and with every masked entry reading a row of +-1e30 (int8: +-127 under
    a masked entry's scale of 1e28)."""
    rng = np.random.default_rng(17)
    T = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
        np.asarray(a), device=dev)
    for storage in ("fp32", "int8"):
        for weighting in ("01", "general"):
            for kind in ("random", "all_masked"):
                table, idx, owned, w, scales = _bags(2, 37 * 8, 7, 300, 64,
                                                     storage, weighting,
                                                     kind)
                t = [T(a) for a in (table, idx, owned, w, scales)]
                want = ops.masked_sls(*t)
                s1 = (None if scales is None else
                      np.where(owned, scales, np.float32(1e28)))
                for tb, ix in ((table, idx), (_edged(table, storage, rng),
                                              idx + 1)):
                    plan = sls.dedup_plan(T(ix), t[2], T(s1))
                    got = ops.masked_sls_dedup(T(tb), plan, t[2], t[3])
                    assert torch.equal(got, want)
                    if weighting == "01":
                        assert torch.equal(got, ops.masked_sls_dedup(
                            T(tb), plan, t[2], t[3], impl="torch"))
                cold, hot, x, rows, own3, hot3, w3, s3 = _fe_case(
                    2, 37, 8, 7, 300, 200, 64, storage, weighting)
                if kind == "all_masked":
                    own3 = np.zeros_like(own3)
                    hot3 = np.zeros_like(hot3)
                fe = [T(a) for a in (cold, hot, x, rows, own3, hot3, w3, s3)]
                want = sls.fused_front_end_dense(*fe[:6], weights=fe[6],
                                                 scales=fe[7])
                s1 = (None if s3 is None else
                      np.where(own3, s3, np.float32(1e28)))
                for c, h, r in ((cold, hot, rows),
                                (_edged(cold, storage, rng),
                                 _edged(hot, "fp32", rng), rows + 1)):
                    dd = sls.fused_front_end_dense(
                        T(c), T(h), fe[2], T(r), fe[4], fe[5], weights=fe[6],
                        scales=T(s1), dedup=True)
                    assert torch.equal(dd, want)


@pytest.mark.cuda
def test_cuda_dedup_kernels_match_plain_and_nondedup_on_the_card():
    """The dedup kernels on the card: bitwise equal to their plain versions
    at 0/1 weights and to the non-dedup kernels at every weight, on random
    and all-masked batches, with rows of +-1e30 under every masked entry
    (chip_smoke.py runs the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    _check_dedup_kernels(torch.device("cuda"))
