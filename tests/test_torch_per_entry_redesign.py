"""The launch shapes of the per-entry kernels ``masked_sls`` and
``fused_front_end``, and the property their walk relies on.

Both per-entry kernels now walk their bags as the gather-once kernels do
(``csrc/gather_once.cuh``): a team of threads per bag stages a run's
metadata in shared memory, keeps the owned (hot) entries and holds several
rows in flight.  Their launches are host code: ``sls_shape`` (blocks of
whole warps, 8 rows in flight per lane below ``WALK_MIN_BAGS_PER_SM`` bags
per SM, else 4) and ``front_end_shape`` (one CTA per feature tile; a
float32 cold tier takes 8 rows in flight below the same switch).  Their limits, and that every bag is pooled exactly once,
are held here on the CPU at the shapes the serve path gives them: every
RMC configuration at 1 and 4 shards (the split path stacks the shards'
bags) and the tiers' calls.

The kernels skip a masked entry where the plain versions, and the JAX
reference's Pallas kernels, add f * row with f = owned * w = +-0 (the
plain versions read row 0 for it, the Pallas kernels its own row).  On
finite rows the two agree: rows of +-1e30 (int8: codes +-127 under a
masked entry's scale of 1e28) at row 0 and under every masked entry of
either tier leave the plain versions bitwise equal to their results on the
unmodified tables, and the Pallas kernels (interpret mode) agree on them.

Tolerances.  At 0/1 weights every product is exact and the SLS is bitwise
equal to the Pallas kernel's; with general weights each of the L steps may
round once more: |diff| <= 2 * L * 2^-23 * sum_l |f_l * row_l|.  Fused
outputs are compared within 1e-5 relative and 1e-6 absolute (XLA and
torch.bmm reduce over D in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import sls as ksls

N_SM = 132                       # SMs of an H100 SXM
SMEM_MAX = 232448                # bytes of shared memory a block can use
STATIC_SMEM = 48 * 1024          # without the opt-in
EPS = 2.0 ** -23
WALK = ksls.WALK_MIN_BAGS_PER_SM * N_SM


def _rmc():
    """(G, D) of the RMC configurations."""
    return sorted({(get_config(a).n_tables, get_config(a).emb_dim)
                   for a in ("rmc1", "rmc2", "rmc3", "rmc4")})


BATCHES = [1, 31, 32, 33, 263, 264, 2048, 2053]


def _sls_cover(N, team, threads, blocks):
    per = threads // team
    bags = (np.arange(blocks)[:, None] * per
            + np.arange(per)[None, :]).ravel()
    return bags[bags < N]


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("G,D", _rmc())
def test_sls_shape_covers_the_serve_paths_bags(G, D, B, S):
    """The split path's calls: the cold tier over S stacked shards' bags
    (N = S * B * G) and the hot tier (N = B * G), fp32 and int8: every bag
    in exactly one team, whole warps within ``SLS_THREADS`` and the static
    shared memory, rows in flight switching at ``WALK_MIN_BAGS_PER_SM``
    bags per SM, and int8's 16-code chunks from there on."""
    for N, itemsize in ((S * B * G, 4), (S * B * G, 1), (B * G, 4)):
        vec, team, inflight, threads, blocks = ksls.sls_shape(
            N, D, itemsize, True, N_SM)
        assert inflight == (8 if N < WALK else 4)
        assert vec == (16 if itemsize == 1 and N >= WALK else 4)
        # the kernel has no 16-code chunks at 8 rows in flight
        assert not (vec == 16 and inflight == 8)
        assert D % vec == 0 and team == ksls.team_size(D // vec)
        assert threads % 32 == 0 and threads % team == 0
        assert 32 <= threads <= ksls.SLS_THREADS
        assert threads * ksls.PLAN_ENTRY_BYTES <= STATIC_SMEM
        bags = _sls_cover(N, team, threads, blocks)
        assert np.array_equal(np.sort(bags), np.arange(N))
        # batch 32 at one shard spreads over the SMs
        if N == 256:
            assert blocks >= 128


@pytest.mark.parametrize("itemsize", [4, 1])
def test_sls_shape_switches_at_walk_min(itemsize):
    """One bag below ``WALK_MIN_BAGS_PER_SM`` per SM: 8 rows in flight
    (int8 in 4-code chunks); from it on: 4 (int8 in 16-code chunks)."""
    below = ksls.sls_shape(WALK - 1, 128, itemsize, True, N_SM)
    at = ksls.sls_shape(WALK, 128, itemsize, True, N_SM)
    assert (below[2], at[2]) == (8, 4)
    assert (below[0], at[0]) == ((4, 4) if itemsize == 4 else (4, 16))
    # unaligned rows take the scalar path on both sides
    for N in (WALK - 1, WALK):
        assert ksls.sls_shape(N, 18, itemsize, False, N_SM)[0] == 1


def _front_end_cover(B, G, BB, threads, team):
    teams = threads // team
    seen = []
    for c in range(-(-B // BB)):
        b0 = c * BB
        nb = min(BB, B - b0)
        for q0 in range(0, nb * G, teams):
            for t in range(teams):
                if q0 + t < nb * G:
                    seen.append((b0 + (q0 + t) // G, (q0 + t) % G))
    return seen


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("G,D", _rmc())
def test_front_end_shape_and_inflight_at_the_serve_shapes(G, D, B):
    """The fused step's call at every RMC configuration: a tile and both
    tiers' metadata (2 * FE_THREADS entries) within shared memory, whole
    warps within ``FE_THREADS``, every (sample, bag) pooled exactly once,
    and 8 rows in flight only for a float32 cold tier below
    ``WALK_MIN_BAGS_PER_SM`` bags per SM."""
    F = G + 1
    for itemsize in (4, 1):
        vec, team, BB, threads, inflight = ksls.front_end_shape(
            B, G, D, itemsize, True, N_SM)
        assert inflight == (8 if itemsize == 4 and B * G < WALK else 4)
        assert 1 <= BB <= ksls.MAX_BLOCK_B
        assert threads % 32 == 0 and threads % team == 0
        assert threads <= ksls.FE_THREADS
        assert (BB * F * (D + 1) * 4 + 2 * ksls.FE_THREADS
                * ksls.PLAN_ENTRY_BYTES) <= SMEM_MAX
        seen = _front_end_cover(B, G, BB, threads, team)
        assert len(seen) == B * G
        assert set(seen) == {(b, g) for b in range(B) for g in range(G)}


def test_front_end_inflight_switches_at_walk_min():
    G = 8
    below, at = (WALK - 1) // G, -(-WALK // G)
    def inflight(B, itemsize):
        return ksls.front_end_shape(B, G, 128, itemsize, True, N_SM)[4]

    assert inflight(below, 4) == 8
    assert inflight(at, 4) == 4
    assert inflight(below, 1) == 4
    assert inflight(at, 1) == 4


# ------------------------------------------------- masked-entry property
A = 12                 # rows per entry kind: owned, hot, neither


def _huge(rng, shape, storage):
    sign = np.where(rng.random(shape) < 0.5, -1, 1)
    return (sign * 127).astype(np.int8) if storage == "int8" \
        else (sign * 1e30).astype(np.float32)


def _entries(rng, shape, kind):
    """Each entry's kind (0 owned, 1 hot, 2 neither) and its row: owned
    entries read rows [1, A), hot ones [A, 2A), the others [2A, 3A)."""
    k = rng.choice(3, size=shape, p=[0.55, 0.3, 0.15])
    if kind == "all_masked":
        k[:] = 2
    elif kind == "empty_hot":
        k[k == 1] = 0
    rows = (rng.integers(1, A, shape) + k * A).astype(np.int32)
    return k, rows


def _tables(rng, D, storage):
    """Cold and hot tiers of 3A rows, and their +-1e30 twins: the cold
    tier huge at row 0 and under hot and neither entries, the hot tier at
    row 0 and under owned and neither entries."""
    if storage == "int8":
        cold = rng.integers(-127, 128, (3 * A, D)).astype(np.int8)
    else:
        cold = rng.normal(size=(3 * A, D)).astype(np.float32)
    hot = rng.normal(size=(3 * A, D)).astype(np.float32)
    big_c, big_h = cold.copy(), hot.copy()
    mc = np.r_[0, A:3 * A]
    mh = np.r_[0:A, 2 * A:3 * A]
    big_c[mc] = _huge(rng, (mc.size, D), storage)
    big_h[mh] = _huge(rng, (mh.size, D), "fp32")
    return cold, hot, big_c, big_h


def _weights(rng, shape, weighting):
    if weighting == "01":
        return (rng.random(shape) < 0.8).astype(np.float32)
    return rng.uniform(-2, 2, shape).astype(np.float32)


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
@pytest.mark.parametrize("tier", ["cold", "hot"])
@pytest.mark.parametrize("weighting", ["01", "general"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_masked_sls_masked_entries_contribute_nothing(storage, weighting,
                                                      tier, kind):
    """One tier's call of the split path: +-1e30 under every masked entry
    and at row 0 leave the plain masked SLS bitwise equal to its result on
    the unmodified tier, and the Pallas kernel (interpret, a tail tile)
    agrees on the huge tier."""
    rng = np.random.default_rng(7 + (storage == "int8") + 2 * (tier == "hot"))
    N, L, D = 11, 7, 16
    k, idx = _entries(rng, (N, L), kind)
    cold, hot, big_c, big_h = _tables(rng, D, storage)
    table, big = (cold, big_c) if tier == "cold" else (hot, big_h)
    owned = k == (0 if tier == "cold" else 1)
    w = _weights(rng, (N, L), weighting)
    scales = None
    if storage == "int8" and tier == "cold":
        scales = np.where(owned, rng.uniform(1e-4, 2e-2, (N, L)),
                          1e28).astype(np.float32)
    want = ops.masked_sls(_t(table), _t(idx), _t(owned), _t(w), _t(scales))
    got = ops.masked_sls(_t(big), _t(idx), _t(owned), _t(w), _t(scales))
    assert torch.equal(got, want)
    if kind == "all_masked":
        assert not want.any()
    pallas = np.asarray(jops.masked_sls(_j(big), _j(idx), _j(owned), _j(w),
                                        scales=_j(scales), interpret=True,
                                        block_l=3))
    assert np.isfinite(pallas).all()
    if weighting == "01":
        np.testing.assert_array_equal(pallas, want.numpy())
    else:
        err = np.abs(pallas.astype(np.float64) - want.numpy())
        assert (err <= _sls_bound(table, idx, owned, w, scales)).all()


@pytest.mark.parametrize("kind", ["random", "all_masked", "empty_hot"])
@pytest.mark.parametrize("weighting", ["01", "general"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_fused_front_end_masked_entries_contribute_nothing(storage,
                                                           weighting, kind):
    """The fused step's call: +-1e30 under every masked entry of either
    tier (an owned entry's row in the hot tier, a hot entry's in the cold
    tier, a neither entry's in both) and at both rows 0 leave the plain
    fused front end bitwise equal to its result on the unmodified tiers,
    and the Pallas fused kernel (interpret; B not a multiple of block_b, L
    not a multiple of block_l) agrees on the huge tiers."""
    rng = np.random.default_rng(41 + (storage == "int8"))
    B, G, L, D = 5, 3, 7, 16
    k, rows = _entries(rng, (B, G, L), kind)
    cold, hot, big_c, big_h = _tables(rng, D, storage)
    owned, is_hot = k == 0, k == 1
    w = _weights(rng, (B, G, L), weighting)
    scales = (np.where(owned, rng.uniform(1e-4, 2e-2, (B, G, L)),
                       1e28).astype(np.float32)
              if storage == "int8" else None)
    x = rng.normal(size=(B, D)).astype(np.float32)

    def fused(c, h):
        return ops.fused_front_end(_t(c), _t(h), _t(x), _t(rows), _t(owned),
                                   _t(is_hot), _t(w), _t(scales))

    want = fused(cold, hot)
    assert torch.equal(fused(big_c, big_h), want)
    pallas = np.asarray(jops.fused_front_end(
        *map(_j, (big_c, big_h, x, rows, owned, is_hot, w, scales)),
        interpret=True, block_l=3, block_b=2))
    assert np.isfinite(pallas).all()
    np.testing.assert_allclose(want.numpy(), pallas, rtol=1e-5, atol=1e-6)
