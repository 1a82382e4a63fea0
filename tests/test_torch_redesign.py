"""The launch shapes of the redesigned partial-pool and resume kernels, and
the property the one-walk partial pool relies on.

``tile_shape`` (``kernels/interaction.py``) and ``shard_group``
(``kernels/sls.py``) decide the launches of ``fused_resume`` and
``fused_partial_pool[_dedup]``; their limits are held here on the CPU for
every shape the RMC configurations and ``chip_smoke.py`` give them.

The partial pool walks each bag's entries once for all shards, and a shard
skips an entry it does not own where the plain versions (and the JAX
reference) add f * row with f = owned * w = +-0.  On finite rows the two
agree: so pointing every entry a shard does not own at a row of +-1e30
(int8: codes +-127 under a scale of 1e28) must leave ``part_c`` bitwise
as it was, in the plain versions here and in the reference's oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.configs import get_config
from repro_torch.core import sls as core_sls
from repro_torch.kernels import interaction as kinteraction
from repro_torch.kernels import ref
from repro_torch.kernels import sls as ksls

N_SM = 132                       # SMs of an H100 SXM
SMEM_MAX = 232448                # bytes of shared memory a block can use


def _used_shapes():
    """(F, D) of the RMC configurations and of chip_smoke.py's checks."""
    fd = {(get_config(a).n_tables + 1, get_config(a).emb_dim)
          for a in ("rmc1", "rmc2", "rmc3", "rmc4")}
    fd |= {(f, d) for f in (2, 9, 27) for d in (16, 18, 64, 128)}
    return sorted(fd)


@pytest.mark.parametrize("F,D", _used_shapes())
@pytest.mark.parametrize("B", [0, 1, 31, 32, 37, 2048, 2053])
def test_resume_shape_fits_shared_memory(F, D, B):
    """The launch shape of both interaction kernels: at least one sample
    per block, 128 or 256 threads, a tile within the shared memory a block
    can use; with float4 loads a 16-byte aligned row stride of an odd
    number of float4s (distinct bank groups for 8 rows), else D + 1; one
    sample per block up to 4 blocks per SM, so batch 32 runs 32 blocks;
    and blocks that cover the batch, spread over every SM."""
    for vec4 in ((True, False) if D % 4 == 0 else (False,)):
        NS, threads, lds = kinteraction.tile_shape(B, F, D, N_SM, vec4)
        assert 1 <= NS <= kinteraction.TILE_MAX_NS
        assert threads in (128, 256) and threads % 32 == 0
        assert lds >= D and NS * F * lds * 4 <= SMEM_MAX
        if vec4:
            assert lds % 4 == 0 and (lds // 4) % 2 == 1 and lds - D <= 8
        else:
            assert lds == D + 1
        if B <= kinteraction.TILE_BLOCKS_PER_SM * N_SM:
            assert NS == 1
        assert -(-B // NS) * NS >= B and -(-B // NS) <= max(
            B, kinteraction.TILE_BLOCKS_PER_SM * N_SM)


def test_resume_shape_refuses_a_tile_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        kinteraction.tile_shape(4, 100, 1024, N_SM)
    with pytest.raises(ValueError, match="shared memory"):
        kinteraction.tile_shape(4, 41, 1442, N_SM, vec4=False)


@pytest.mark.parametrize("S", [1, 2, 3, 4, 5, 8, 9, 12, 16, 17])
@pytest.mark.parametrize("B", [1, 32, 2048, 2053])
def test_shard_group_covers_every_shard(S, B):
    """A grid row holds 1, 2, 4 or 8 shards (the kernel's template
    parameter), enough grid rows cover all S, and none is empty; a full
    card walks up to 8 shards at once, a small batch one shard per row."""
    bags = B * 8
    nsh, groups = ksls.shard_group(S, bags, N_SM)
    assert nsh in (1, 2, 4, 8)
    assert groups * nsh >= S and (groups - 1) * nsh < S
    if bags >= ksls.WALK_MIN_BAGS_PER_SM * N_SM:
        assert nsh >= min(S, ksls.SHARD_GROUP_MAX) and nsh < 2 * min(S, 8)
    else:
        assert (nsh, groups) == (1, S)


def test_shard_group_refuses_no_shards():
    with pytest.raises(ValueError):
        ksls.shard_group(0, 2048 * 8, N_SM)


@pytest.mark.parametrize("S", [1, 2, 4, 12])
@pytest.mark.parametrize("B", [32, 2048])
def test_pool_vec_chunks(S, B):
    """16-byte chunks where rows are 16-byte aligned (float32: 4 floats;
    int8: 4 codes, or 16 when a grid row walks at most 2 shards of a full
    card), the scalar path otherwise; every chunk width divides D."""
    bags = B * 8
    nsh, _ = ksls.shard_group(S, bags, N_SM)
    for D in (16, 64, 128):
        assert ksls.pool_vec(D, 4, True, nsh, bags, N_SM) == 4
        v8 = ksls.pool_vec(D, 1, True, nsh, bags, N_SM)
        full = bags >= ksls.WALK_MIN_BAGS_PER_SM * N_SM
        assert v8 == (16 if full and nsh <= 2 else 4) and D % v8 == 0
        for itemsize in (1, 4):
            assert ksls.pool_vec(D + 2, itemsize, False, nsh, bags,
                                 N_SM) == 1


def _sharded_inputs(seed, S, storage, weighting, B=6, G=3, L=5, V=24, D=8):
    """S slices of V rows; owned rows lie in [1, V - 1), so row 0 of each
    slice and the tier's last row are read only by masked entries."""
    rng = np.random.default_rng(seed)
    if storage == "int8":
        cold = rng.integers(-127, 128, (S * V, D)).astype(np.int8)
    else:
        cold = rng.normal(size=(S * V, D)).astype(np.float32)
    hot = rng.normal(size=(V, D)).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    rows = rng.integers(1, V - 1, (B, G, L)).astype(np.int32)
    owner = rng.integers(-1, S + 1, (B, G, L))      # -1 hot, S nobody
    owned = owner[None] == np.arange(S).reshape(S, 1, 1, 1)
    is_hot = owner == -1
    if weighting == "01":
        w = (rng.random((B, G, L)) < 0.8).astype(np.float32)
    else:
        w = rng.uniform(-2.0, 2.0, (B, G, L)).astype(np.float32)
    scales = None
    if storage == "int8":
        row_scale = rng.uniform(1e-4, 2e-2, (S + 1, V)).astype(np.float32)
        scales = row_scale[np.clip(owner, 0, S), rows]
    return cold, hot, x, rows, owned, is_hot, w, scales


def _huge(rng, n, D, storage):
    sign = np.where(rng.random((n, D)) < 0.5, -1, 1)
    return (sign * 127).astype(np.int8) if storage == "int8" \
        else (sign * 1e30).astype(np.float32)


@pytest.mark.parametrize("S", [1, 2, 4, 12])
@pytest.mark.parametrize("weighting", ["01", "general"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_masked_entry_contributes_nothing(S, weighting, storage):
    """``fused_partial_pool_ref``: +-1e30 in row 0 of every slice (what a
    masked entry reads) leaves ``part_c`` and ``part_h`` bitwise equal, and
    so does pointing each shard's masked entries at such a row in a
    one-shard call; the reference's oracle agrees for each shard."""
    cold, hot, x, rows, owned, is_hot, w, scales = _sharded_inputs(
        S, S, storage, weighting)
    V = cold.shape[0] // S
    rng = np.random.default_rng(100 + S)
    big = cold.copy()
    big[np.arange(S) * V] = _huge(rng, S, cold.shape[1], storage)
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    args = [t(a) for a in (cold, hot, x, rows, owned, is_hot, w, scales)]
    want_c, want_h = ref.fused_partial_pool_ref(*args)
    got_c, got_h = ref.fused_partial_pool_ref(t(big), *args[1:])
    assert torch.equal(got_c, want_c) and torch.equal(got_h, want_h)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    for s in range(S):
        # one shard: its masked cold entries point at the +-1e30 row 0
        # (hot entries keep their rows: the hot tier pools them)
        sl = slice(s * V, (s + 1) * V)
        moved = np.where(owned[s] | is_hot, rows, 0).astype(np.int32)
        c_s, h_s = ref.fused_partial_pool_ref(
            t(big[sl]), args[1], args[2], t(moved), t(owned[s]),
            *args[5:])
        assert torch.equal(c_s, want_c[s]) and torch.equal(h_s, want_h)
        jc, _ = jref.fused_partial_pool_ref(
            j(big[sl]), j(hot), j(x), j(moved), j(owned[s]), j(is_hot),
            j(w), j(scales))
        oc, _ = jref.fused_partial_pool_ref(
            j(cold[sl]), j(hot), j(x), j(rows), j(owned[s]), j(is_hot),
            j(w), j(scales))
        np.testing.assert_array_equal(np.asarray(jc), np.asarray(oc))


@pytest.mark.parametrize("S", [1, 2, 4, 12])
@pytest.mark.parametrize("weighting", ["01", "general"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_masked_entry_contributes_nothing_dedup(S, weighting, storage):
    """``fused_partial_pool_dedup_ref``: the cold plan's slots of every
    masked (shard, entry) pointed at an added slot that stages +-1e30
    (int8: +-127 * 1e28) leave the tiles bitwise equal, and equal to the
    per-entry plain version."""
    cold, hot, x, rows, owned, is_hot, w, scales = _sharded_inputs(
        7 + S, S, storage, weighting)
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    args = [t(a) for a in (cold, hot, x, rows, owned, is_hot, w, scales)]
    cp, hp = core_sls.partial_pool_plans(cold.shape[0], args[3], args[4],
                                         args[5], args[7])
    base = (args[0], args[1], args[2])
    want_c, want_h = ref.fused_partial_pool_dedup_ref(
        *base, cp.unique_rows, cp.slots, hp.unique_rows, hp.slots, args[4],
        args[5], args[6], cp.unique_scales)
    pc, ph = ref.fused_partial_pool_ref(*args)
    assert torch.equal(want_c, pc) and torch.equal(want_h, ph)
    rng = np.random.default_rng(200 + S)
    big = cold.copy()
    big[-1] = _huge(rng, 1, cold.shape[1], storage)[0]
    U = cp.unique_rows.numel()
    c_unique = torch.cat([cp.unique_rows,
                          torch.tensor([big.shape[0] - 1], dtype=torch.int32)])
    c_scales = None if cp.unique_scales is None else torch.cat(
        [cp.unique_scales, torch.tensor([1e28], dtype=torch.float32)])
    c_slots = torch.where(args[4], cp.slots, torch.full_like(cp.slots, U))
    got_c, got_h = ref.fused_partial_pool_dedup_ref(
        t(big), *base[1:], c_unique, c_slots, hp.unique_rows, hp.slots,
        args[4], args[5], args[6], c_scales)
    # the added slot stages a finite row of magnitude ~1e30
    staged = t(big)[-1].float() * (1.0 if c_scales is None else c_scales[U])
    assert torch.isfinite(staged).all() and staged.abs().min() >= 1e29
    assert torch.equal(got_c, want_c) and torch.equal(got_h, want_h)
