"""The launch shapes of the gather-once kernels that read rows through the
dedup plan, and the property they rely on.

``sls_shape`` and ``front_end_shape`` (``kernels/sls.py``) decide the
launches of ``masked_sls_dedup`` (a team of threads per bag,
blocks of whole warps) and ``fused_front_end_dedup`` (a CTA per feature
tile of BB samples, a team of threads per bag).  Their limits, and that every bag is pooled exactly once, are held
here on the CPU for every shape the RMC configurations and
``chip_smoke.py`` give them.

The kernels skip an entry that is not owned (not hot, for the hot tier)
where the staging semantics of the plain versions, and of the JAX
reference, add f * row with f = owned * w = +-0 -- through the plan's
sentinel slot (the table's last row) or, per entry, row 0.  On finite
rows the two agree: so rows of +-1e30 (int8: codes +-127 under a masked
entry's scale of 1e28) wherever a masked entry could read must leave the
gather-once plain versions bitwise equal to the per-entry ones, and the
JAX reference's plain path must agree on the same numpy inputs.

Tolerances.  At 0/1 weights every product is exact and the SLS is bitwise
equal to the reference's scan (one FMA or a multiply and an add alike);
with general weights each of the L steps may round once more:
|diff| <= 2 * L * 2^-23 * sum_l |f_l * row_l|.  Interaction outputs are
compared within 1e-5 relative and 1e-6 absolute (XLA and torch.bmm reduce
over D in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sls as jsls
from repro.kernels import ref as jref

from repro_torch.configs import get_config
from repro_torch.core import sls as core_sls
from repro_torch.kernels import sls as ksls

N_SM = 132                       # SMs of an H100 SXM
SMEM_MAX = 232448                # bytes of shared memory a block can use
EPS = 2.0 ** -23


def _used_shapes():
    """(G, D) of the RMC configurations and of chip_smoke.py's checks."""
    gd = {(get_config(a).n_tables, get_config(a).emb_dim)
          for a in ("rmc1", "rmc2", "rmc3", "rmc4")}
    gd |= {(8, d) for d in (16, 18, 64, 128)}
    gd |= {(g, d) for g in (1, 3, 5, 26) for d in (18, 64, 128)}
    return sorted(gd)


BAGS = [1, 2, 31, 32, 33, 255, 256, 257, 296, 1023, 1024, 2111, 2112,
        4096, 16383, 2048 * 8]


@pytest.mark.parametrize("N", BAGS)
@pytest.mark.parametrize("D", [16, 18, 64, 128])
@pytest.mark.parametrize("itemsize", [4, 1])
def test_sls_dedup_shape_covers_every_bag(N, D, itemsize):
    """Whole warps, at most SLS_THREADS threads, whole teams of the
    kernel's team size, a chunk width that divides D; every bag in exactly
    one team; and a batch-32 step at the RMC widths (256 bags of 64 or 128)
    spread over the SMs."""
    for aligned in ((True, False) if (D * itemsize) % 16 == 0 else (False,)):
        vec, team, inflight, threads, blocks = ksls.sls_shape(
            N, D, itemsize, aligned, N_SM)
        assert inflight == (8 if N < ksls.WALK_MIN_BAGS_PER_SM * N_SM
                            else 4)
        assert D % vec == 0 and team == ksls.team_size(D // vec)
        assert vec == ksls.pool_vec(D, itemsize, aligned, 1, N, N_SM)
        assert threads % 32 == 0 and threads % team == 0
        assert 32 <= threads <= ksls.SLS_THREADS
        per = threads // team
        bags = (np.arange(blocks)[:, None] * per
                + np.arange(per)[None, :]).ravel()
        bags = bags[bags < N]
        assert np.array_equal(np.sort(bags), np.arange(N))
        assert (blocks - 1) * per < N <= blocks * per
        # no more bags per block than a warp, or filling the SMs, needs
        warp = 32 // team
        assert per % warp == 0
        assert per == warp or (per - warp) * N_SM < N
        if N == 256 and D in (64, 128):
            assert blocks >= 128


def test_sls_dedup_shape_refuses_no_bags():
    with pytest.raises(ValueError):
        ksls.sls_shape(0, 128, 4, True, N_SM)


def _front_end_cover(B, G, BB, threads, team):
    """(sample, bag) pairs the kernel pools, in its assignment order: CTA c
    owns samples [c * BB, c * BB + BB), whose bags its threads / team teams
    walk in turn."""
    teams = threads // team
    seen = []
    for c in range(-(-B // BB)):
        b0 = c * BB
        nb = min(BB, B - b0)
        for q0 in range(0, nb * G, teams):
            for t in range(teams):
                q = q0 + t
                if q < nb * G:
                    seen.append((b0 + q // G, q % G))
    return seen


@pytest.mark.parametrize("G,D", _used_shapes())
@pytest.mark.parametrize("B", [1, 2, 31, 32, 33, 37, 131, 132, 1024, 2048,
                               2053])
def test_front_end_dedup_shape_covers_every_bag(G, D, B):
    """1 to MAX_BLOCK_B samples per CTA, whole warps (at most
    FE_THREADS threads, whole teams), a tile and the metadata within
    shared memory, every (sample, bag) pooled exactly once, no more teams
    than the tile has bags beyond a warp's rounding, and one CTA per sample
    up to a CTA per SM (batch 32 at RMC4: 32 CTAs of 256 threads)."""
    F = G + 1
    for itemsize in (4, 1):
        for aligned in ((True, False) if (D * itemsize) % 16 == 0
                        else (False,)):
            vec, team, BB, threads, _ = ksls.front_end_shape(
                B, G, D, itemsize, aligned, N_SM)
            assert D % vec == 0 and team == ksls.team_size(D // vec)
            assert vec == ksls.pool_vec(D, itemsize, aligned, 1, B * G, N_SM)
            assert 1 <= BB <= ksls.MAX_BLOCK_B
            assert threads % 32 == 0 and threads % team == 0
            assert threads <= ksls.FE_THREADS
            assert threads < BB * G * team + 32
            assert (BB * F * (D + 1) * 4 + 2 * ksls.FE_THREADS
                    * ksls.PLAN_ENTRY_BYTES) <= SMEM_MAX
            if B <= N_SM:
                assert BB == 1
            seen = _front_end_cover(B, G, BB, threads, team)
            assert len(seen) == B * G
            assert set(seen) == {(b, g) for b in range(B) for g in range(G)}
    if (G, D) == (8, 128) and B == 32:
        _, _, BB, threads, _ = ksls.front_end_shape(32, 8, 128, 4, True,
                                                    N_SM)
        assert (BB, threads) == (1, 256)


def test_front_end_dedup_shape_refuses_a_tile_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        ksls.front_end_shape(4, 100, 1024, 4, True, N_SM)
    with pytest.raises(ValueError):
        ksls.front_end_shape(4, 0, 128, 4, True, N_SM)


# ------------------------------------------------- masked-entry property
def _huge(rng, n, D, storage):
    sign = np.where(rng.random((n, D)) < 0.5, -1, 1)
    return (sign * 127).astype(np.int8) if storage == "int8" \
        else (sign * 1e30).astype(np.float32)


def _t(a):
    return None if a is None else torch.as_tensor(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _sls_bound(table, idx, owned, w, scales):
    rows = np.abs(table[np.where(owned, idx, 0)].astype(np.float64))
    if scales is not None:
        rows = rows * np.abs(scales)[..., None]
    f = np.abs(owned * w).astype(np.float64)
    return 2 * idx.shape[1] * EPS * (f[..., None] * rows).sum(axis=1)


@pytest.mark.parametrize("kind", ["random", "all_masked"])
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("weighting", ["01", "general"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_masked_sls_dedup_masked_entries_contribute_nothing(storage,
                                                            weighting, S,
                                                            kind):
    """S stacked shards (the split path's one plan over S slices): +-1e30 in
    row 0 of every slice and in the tier's last row leave the gather-once
    plain version equal to the per-entry one on the unmodified tier, and
    the JAX reference's gather-once oracle agrees per shard."""
    rng = np.random.default_rng(31 + S)
    N, L, V, D = 9, 7, 40, 16
    if storage == "int8":
        tier = rng.integers(-127, 128, (S * V, D)).astype(np.int8)
    else:
        tier = rng.normal(size=(S * V, D)).astype(np.float32)
    rows = np.minimum(rng.zipf(1.5, (N, L)), V - 2).astype(np.int32)
    owner = rng.integers(-1, S, (N, L))           # -1: nobody owns it
    if kind == "all_masked":
        owner[:] = -1
    owned = owner[None] == np.arange(S).reshape(S, 1, 1)
    w = ((rng.random((N, L)) < 0.8).astype(np.float32) if weighting == "01"
         else rng.uniform(-2, 2, (N, L)).astype(np.float32))
    scales = None
    if storage == "int8":
        row_scale = rng.uniform(1e-4, 2e-2, (S, V)).astype(np.float32)
        scales = np.where(owner >= 0, row_scale[np.maximum(owner, 0), rows],
                          np.float32(1e28)).astype(np.float32)
    big = tier.copy()
    edge = np.concatenate([np.arange(S) * V, [S * V - 1]])
    big[edge] = _huge(rng, edge.size, D, storage)

    def pool(table, dedup):
        return core_sls.masked_partial_sls_dense(
            _t(table), _t(rows), _t(owned), _t(w), impl="torch",
            scales=_t(scales), dedup=dedup)

    want = pool(tier, False)
    assert want.shape == (S, N, D)
    for table in (tier, big):
        assert torch.equal(pool(table, True), want)
        assert torch.equal(pool(table, False), want)
    # the JAX reference's gather-once oracle, one shard's plan at a time
    for s in range(S):
        sl = big[s * V:(s + 1) * V]
        jplan = jsls.dedup_plan(_j(rows), _j(owned[s]), _j(scales))
        got = np.asarray(jref.masked_sls_dedup_ref(
            _j(sl), jplan.unique_rows, jplan.slots, _j(owned[s]), _j(w),
            jplan.unique_scales))
        if weighting == "01":
            np.testing.assert_array_equal(got, want[s].numpy())
        else:
            err = np.abs(got.astype(np.float64) - want[s].numpy())
            assert (err <= _sls_bound(tier[s * V:(s + 1) * V], rows,
                                      owned[s], w, scales)).all()


@pytest.mark.parametrize("kind", ["random", "all_masked"])
@pytest.mark.parametrize("weighting", ["01", "general"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_fused_front_end_dedup_masked_entries_contribute_nothing(storage,
                                                                 weighting,
                                                                 kind):
    """+-1e30 in rows 0 and the last row of both tiers leave the gather-once
    fused plain version bitwise equal to the per-entry one on the
    unmodified tiers, and the JAX reference (its fused oracle on the same
    tiers, and its gather-once oracle per tier composed with its
    interaction) agrees within the interaction's tolerance."""
    rng = np.random.default_rng(53)
    B, G, L, D, Vc, Vh = 5, 3, 7, 16, 40, 30
    rows = np.minimum(rng.zipf(1.5, (B, G, L)), Vh - 2).astype(np.int32)
    owned = rng.random((B, G, L)) < 0.5
    is_hot = ~owned & (rng.random((B, G, L)) < 0.7)     # some in neither
    if kind == "all_masked":
        owned[:] = False
        is_hot[:] = False
    if storage == "int8":
        cold = rng.integers(-127, 128, (Vc, D)).astype(np.int8)
        row_scale = rng.uniform(1e-4, 2e-2, Vc).astype(np.float32)
        scales = np.where(owned, row_scale[rows],
                          np.float32(1e28)).astype(np.float32)
    else:
        cold = rng.normal(size=(Vc, D)).astype(np.float32)
        scales = None
    hot = rng.normal(size=(Vh, D)).astype(np.float32)
    w = ((rng.random((B, G, L)) < 0.8).astype(np.float32) if weighting == "01"
         else rng.uniform(-2, 2, (B, G, L)).astype(np.float32))
    x = rng.normal(size=(B, D)).astype(np.float32)
    big_c, big_h = cold.copy(), hot.copy()
    big_c[[0, Vc - 1]] = _huge(rng, 2, D, storage)
    big_h[[0, Vh - 1]] = _huge(rng, 2, D, "fp32")

    def fused(c, h, dedup):
        return core_sls.fused_front_end_dense(
            _t(c), _t(h), _t(x), _t(rows), _t(owned), _t(is_hot), _t(w),
            _t(scales), impl="torch", dedup=dedup)

    want = fused(cold, hot, False)
    for c, h in ((cold, hot), (big_c, big_h)):
        assert torch.equal(fused(c, h, True), want)
        assert torch.equal(fused(c, h, False), want)
    args = [_j(a) for a in (big_c, big_h, _j(x), rows, owned, is_hot, w,
                            scales)]
    ref_fused = np.asarray(jref.fused_front_end_ref(*args))
    nb = B * G
    cp = jsls.dedup_plan(_j(rows.reshape(nb, L)), _j(owned.reshape(nb, L)),
                         None if scales is None
                         else _j(scales.reshape(nb, L)))
    hp = jsls.dedup_plan(_j(rows.reshape(nb, L)), _j(is_hot.reshape(nb, L)))
    wf = _j(w.reshape(nb, L))
    pooled = (jref.masked_sls_dedup_ref(_j(big_c), cp.unique_rows, cp.slots,
                                        _j(owned.reshape(nb, L)), wf,
                                        cp.unique_scales)
              + jref.masked_sls_dedup_ref(_j(big_h), hp.unique_rows,
                                          hp.slots,
                                          _j(is_hot.reshape(nb, L)), wf))
    feats = jnp.concatenate([_j(x)[:, None], pooled.reshape(B, G, D)], 1)
    ref_dedup = np.asarray(jref.dot_interaction_ref(feats))
    for got in (ref_fused, ref_dedup):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(want.numpy(), got, rtol=1e-5, atol=1e-6)
