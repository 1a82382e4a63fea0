"""Port parity of the partial-pool and resume kernels' plain versions
(table rows 7-9: ``fused_partial_pool``, ``fused_partial_pool_dedup``,
``fused_resume``) against the JAX Pallas kernels in interpret mode (as
tests/test_kernels.py runs them) and their jnp oracles, the port's
sharded form (S cold shards in one call) against S one-shard calls, the
wrappers' input contracts, and (``cuda``-marked, skipped without a card)
the CUDA kernels against their plain versions.

Tolerances.  Weights of 0/1 make every product f * row exact, so the
fixed-l-order pools are bitwise equal whether a step is one FMA (XLA on
the CPU, the CUDA kernels) or a multiply then an add (the plain
versions).  With general weights each of the L steps may round once more:
|diff| <= 2 * L * 2^-23 * sum_l |f_l * row_l| per tile element.  The
resume's dots reduce over D in different orders (XLA dot vs torch.bmm):
|diff| <= 2 * D * 2^-23 * sum_d |x_i[d] * x_j[d]|.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sls as jcore_sls
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.core import sls as core_sls
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import interaction as kinteraction
from repro_torch.kernels import sls as ksls

EPS = 2.0 ** -23


def _inputs(seed, B, G, L, V, D, storage, weighting, H=None, S=1):
    """Numpy inputs of a partial pool over S cold shards of V rows each:
    each entry belongs to one shard, to the hot tier (H rows) or to
    nobody.  Scales are per (shard, row), as pages carry them."""
    rng = np.random.default_rng(seed)
    H = H or V
    if storage == "int8":
        cold = rng.integers(-127, 128, (S * V, D)).astype(np.int8)
    else:
        cold = rng.normal(size=(S * V, D)).astype(np.float32)
    hot = rng.normal(size=(H, D)).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    rows = rng.integers(0, min(V, H), (B, G, L)).astype(np.int32)
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


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _pool_bound(table, rows, owned, w, scales):
    """2 * L * eps * sum_l |f_l * row_l| per (B, G, D) pooled element."""
    r = np.abs(table[np.where(owned, rows, 0)].astype(np.float64))
    if scales is not None:
        r = r * np.abs(scales)[..., None]
    f = np.abs(owned * w).astype(np.float64)
    return 2 * rows.shape[-1] * EPS * (f[..., None] * r).sum(axis=-2)


def _tile_bounds(cold, hot, x, rows, owned, is_hot, w, scales):
    B, G, _ = rows.shape
    D = cold.shape[1]
    z = np.zeros((B, 1, D))
    bc = np.concatenate([z, _pool_bound(cold, rows, owned, w, scales)], 1)
    bh = np.concatenate([z, _pool_bound(hot, rows, is_hot, w, None)], 1)
    return bc, bh


def _dot_bound(feats):
    a = np.abs(feats.astype(np.float64))
    z = np.einsum("bfd,bgd->bfg", a, a)
    i, j = np.tril_indices(feats.shape[1], k=-1)
    return 2 * feats.shape[2] * EPS * z[:, i, j] + 1e-30


def _assert_within(got, want, bound):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= bound).all(), (err.max(), bound[err > bound].min())


@pytest.mark.parametrize("B,G,L,V,D,block_b", [
    (8, 2, 8, 64, 16, 4),       # exact tiling
    (6, 3, 4, 40, 24, 4),       # B not a multiple of the batch tile
    (5, 4, 7, 32, 18, 8),       # D = 18: the kernels' scalar path
    (1, 2, 1, 16, 16, 128),     # degenerate batch
])
@pytest.mark.parametrize("weighting", ["01", "general"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_partial_pool_plain_matches_pallas(B, G, L, V, D, block_b,
                                           weighting, storage):
    """Port plain partial pool (one shard) vs ``fused_partial_pool_pallas``
    (interpret) and the jnp oracle: cold row 0 zero, x in the hot tile's
    row 0; bitwise at 0/1 weights."""
    cold, hot, x, rows, owned, is_hot, w, scales = _inputs(
        B * G * L + D, B, G, L, V, D, storage, weighting)
    own = owned[0]
    pc, ph = ops.fused_partial_pool(*map(_t, (cold, hot, x, rows, own,
                                              is_hot, w, scales)))
    F = G + 1
    assert pc.shape == ph.shape == (B, F, D) and pc.dtype == torch.float32
    assert not pc[:, 0].any()
    np.testing.assert_array_equal(ph[:, 0].numpy(), x)
    pallas = jops.fused_partial_pool(*map(_j, (cold, hot, x, rows, own,
                                               is_hot, w)),
                                     scales=_j(scales), interpret=True,
                                     block_l=3, block_b=block_b)
    oracle = jref.fused_partial_pool_ref(*map(_j, (cold, hot, x, rows, own,
                                                   is_hot, w, scales)))
    bc, bh = _tile_bounds(cold, hot, x, rows, own, is_hot, w, scales)
    for wc, wh in (pallas, oracle):
        if weighting == "01":
            np.testing.assert_array_equal(pc.numpy(), np.asarray(wc))
            np.testing.assert_array_equal(ph.numpy(), np.asarray(wh))
        else:
            _assert_within(pc.numpy(), wc, bc)
            _assert_within(ph.numpy(), wh, bh)


@pytest.mark.parametrize("weighting", ["01", "general"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_partial_pool_dedup_plain_matches_pallas(weighting, storage):
    """The gather-once plain partial pool equals the per-entry one bitwise
    (every weight) and ``fused_partial_pool_dedup_pallas`` (interpret,
    through the reference's own plans) bitwise at 0/1 weights."""
    B, G, L, V, D = 6, 3, 5, 24, 16           # V small: many duplicates
    cold, hot, x, rows, owned, is_hot, w, scales = _inputs(
        11, B, G, L, V, D, storage, weighting)
    own = owned[0]
    args = tuple(map(_t, (cold, hot, x, rows, own, is_hot, w, scales)))
    dc, dh = core_sls.fused_partial_pool_dense(*args, dedup=True)
    pc, ph = core_sls.fused_partial_pool_dense(*args)
    np.testing.assert_array_equal(dc.numpy(), pc.numpy())
    np.testing.assert_array_equal(dh.numpy(), ph.numpy())
    wc, wh = jcore_sls.fused_partial_pool_dense(
        *map(_j, (cold, hot, x, rows, own, is_hot, w)), scales=_j(scales),
        impl="pallas", interpret=True, block_l=3, block_b=2, dedup=True)
    if weighting == "01":
        np.testing.assert_array_equal(dc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(dh.numpy(), np.asarray(wh))
    else:
        bc, bh = _tile_bounds(cold, hot, x, rows, own, is_hot, w, scales)
        _assert_within(dc.numpy(), wc, bc)
        _assert_within(dh.numpy(), wh, bh)


@pytest.mark.parametrize("S", [1, 4])
def test_resume_plain_matches_pallas(S):
    """Port plain resume vs ``fused_resume_pallas`` (interpret) on the same
    tiles -- S cold tiles summed in shard order first -- within the dot
    tolerance, and the oracle's ``c + h`` operand order."""
    rng = np.random.default_rng(S)
    B, F, D = 7, 5, 16
    pc = rng.normal(size=(S, B, F, D)).astype(np.float32)
    pc[:, :, 0] = 0.0
    ph = rng.normal(size=(B, F, D)).astype(np.float32)
    got = ops.fused_resume(torch.as_tensor(pc if S > 1 else pc[0]),
                           torch.as_tensor(ph))
    summed = pc[0]
    for s in range(1, S):
        summed = summed + pc[s]
    want = jops.fused_resume(jnp.asarray(summed), jnp.asarray(ph),
                             interpret=True, block_b=4)
    feats = summed + ph
    _assert_within(got.numpy(), want, _dot_bound(feats))
    np.testing.assert_array_equal(
        got.numpy(), ref.dot_interaction_ref(torch.as_tensor(feats)).numpy())
    assert got.shape == (B, F * (F - 1) // 2)


@pytest.mark.parametrize("weighting", ["01", "general"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_sharded_partial_pool_equals_per_shard_calls(weighting, storage):
    """S = 4 cold shards in one call (owned (S, B, G, L), the S slices of
    one cold tier) equal S one-shard calls on the slices bitwise, hot
    pooled once; the shard-order sum resumed equals the reference
    oracles' composition (bitwise at 0/1 weights), the split composition
    of the plain SLS inside the port (bitwise, every weight), and the
    gather-once form equals it bitwise."""
    S, B, G, L, V, D = 4, 5, 3, 6, 32, 16
    cold, hot, x, rows, owned, is_hot, w, scales = _inputs(
        3, B, G, L, V, D, storage, weighting, S=S)
    args = tuple(map(_t, (cold, hot, x, rows, owned, is_hot, w, scales)))
    pc, ph = ops.fused_partial_pool(*args)
    assert pc.shape == (S, B, G + 1, D) and ph.shape == (B, G + 1, D)
    for s in range(S):
        c1, h1 = ops.fused_partial_pool(_t(cold[s * V:(s + 1) * V]),
                                        *args[1:4], _t(owned[s]),
                                        *args[5:])
        np.testing.assert_array_equal(pc[s].numpy(), c1.numpy())
        np.testing.assert_array_equal(ph.numpy(), h1.numpy())
    dc, dh = core_sls.fused_partial_pool_dense(*args, dedup=True)
    np.testing.assert_array_equal(dc.numpy(), pc.numpy())
    np.testing.assert_array_equal(dh.numpy(), ph.numpy())
    out = core_sls.fused_resume_dense(pc, ph)
    # split composition inside the port: per-shard SLS, shard sum, + hot
    N = B * G
    flat = args[3].reshape(N, L)
    cold_p = core_sls.masked_partial_sls_dense(
        args[0], flat, args[4].reshape(S, N, L), args[6].reshape(N, L),
        scales=None if scales is None else args[7].reshape(N, L))
    hot_p = core_sls.masked_partial_sls_dense(
        args[1], flat, args[5].reshape(N, L), args[6].reshape(N, L))
    split = ref.dot_interaction_ref(torch.cat(
        [args[2][:, None], (ref.shard_sum(cold_p) + hot_p).reshape(B, G, D)],
        1))
    np.testing.assert_array_equal(out.numpy(), split.numpy())
    # the reference oracles, one shard at a time, summed in shard order
    jc = None
    for s in range(S):
        c_s, h_s = jref.fused_partial_pool_ref(
            _j(cold[s * V:(s + 1) * V]), _j(hot), _j(x), _j(rows),
            _j(owned[s]), _j(is_hot), _j(w), _j(scales))
        jc = c_s if jc is None else jc + c_s
    if weighting == "01":
        np.testing.assert_array_equal(ref.shard_sum(pc).numpy(),
                                      np.asarray(jc))
        np.testing.assert_allclose(
            out.numpy(), np.asarray(jref.fused_resume_ref(jc, h_s)),
            rtol=1e-5, atol=1e-6)


def test_empty_and_degenerate_shapes():
    """B = 0, L = 0 and G = 0 answer with zero cold tiles and x in the hot
    tile's row 0 (as the reference does); an empty hot tier (the BEACON
    placement) pools through one zero line; every entry masked gives
    zero pools."""
    cold, hot, x, rows, owned, is_hot, w, _ = map(_t, _inputs(
        5, 4, 2, 3, 16, 8, "fp32", "01", S=2))
    for sl in (slice(0, 0), slice(None)):
        b = x[sl].shape[0]
        for L in (0, 3):
            r = rows[sl][..., :L].contiguous()
            pc, ph = core_sls.fused_partial_pool_dense(
                cold, hot, x[sl], r, owned[:, sl, :, :L].contiguous(),
                is_hot[sl][..., :L].contiguous(), w[sl][..., :L].contiguous())
            assert pc.shape == (2, b, 3, 8) and ph.shape == (b, 3, 8)
            if L == 0:
                assert not pc.any() and not ph[:, 1:].any()
                np.testing.assert_array_equal(ph[:, 0].numpy(),
                                              x[sl].numpy())
    pc, ph = core_sls.fused_partial_pool_dense(
        cold, hot, x, rows[:, :0].contiguous(), owned[:, :, :0].contiguous(),
        is_hot[:, :0].contiguous())
    assert pc.shape == (2, 4, 1, 8)
    assert core_sls.fused_resume_dense(pc, ph).shape == (4, 0)
    empty = torch.zeros((0, 8))
    nobody = torch.zeros_like(is_hot)
    pc, ph = core_sls.fused_partial_pool_dense(cold, empty, x, rows, owned,
                                               nobody, w)
    assert not ph[:, 1:].any()
    want, _ = core_sls.fused_partial_pool_dense(cold, hot, x, rows, owned,
                                                nobody, w)
    np.testing.assert_array_equal(pc.numpy(), want.numpy())
    pc, ph = core_sls.fused_partial_pool_dense(
        cold, hot, x, rows, torch.zeros_like(owned), nobody, w, dedup=True)
    assert not pc.any() and not ph[:, 1:].any()


def test_masked_gather_rows_matches_reference():
    """Pond's raw-row gather: zero where not owned, in the storage dtype
    (int8 codes stay codes)."""
    rng = np.random.default_rng(2)
    for table in (rng.normal(size=(20, 8)).astype(np.float32),
                  rng.integers(-127, 128, (20, 8)).astype(np.int8)):
        rows = rng.integers(0, 20, 30).astype(np.int32)
        owned = rng.random(30) < 0.5
        got = core_sls.masked_gather_rows(*map(_t, (table, rows, owned)))
        want = jcore_sls.masked_gather_rows(*map(_j, (table, rows, owned)))
        assert got.dtype == _t(table).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_partial_pool_input_contracts():
    cold, hot, x, rows, owned, is_hot, w, scales = map(_t, _inputs(
        7, 3, 2, 4, 12, 8, "int8", "01", S=3))
    ksls.check_fused_partial_pool(cold, hot, x, rows, owned, is_hot, w,
                                  scales)
    with pytest.raises(ValueError, match="owned must be"):
        ksls.check_fused_partial_pool(cold, hot, x, rows, owned[0], is_hot,
                                      w, scales)
    with pytest.raises(ValueError, match="evenly"):
        ksls.check_fused_partial_pool(cold[:-1], hot, x, rows, owned, is_hot,
                                      w, scales)
    with pytest.raises(ValueError, match="int8"):
        ksls.check_fused_partial_pool(cold, hot, x, rows, owned, is_hot, w,
                                      None)
    with pytest.raises(TypeError):
        ksls.check_fused_partial_pool(cold, hot, x, rows, owned.int(),
                                      is_hot, w, scales)
    with pytest.raises(ValueError, match="CUDA"):
        ksls.fused_partial_pool(cold, hot, x, rows, owned, is_hot, w, scales)
    pc = torch.zeros((3, 3, 3, 8))
    ph = torch.zeros((3, 3, 8))
    kinteraction.check_fused_resume(pc, ph)
    with pytest.raises(TypeError):
        kinteraction.check_fused_resume(pc[:, :2], ph)
    with pytest.raises(ValueError, match="CUDA"):
        kinteraction.fused_resume(pc, ph)
    with pytest.raises(ValueError):
        ops.fused_resume(pc, ph, impl="bogus")


def test_registry_lists_every_tpu_kernel():
    """Eight kernels for the nine TPU kernels (row 2 is row 1 with a null
    mask) in three sources; ``ragged_sls``, the pooling of bags that
    differ in length, which the reference does not have, in the first of
    them; and ``apply_deltas`` and ``page_checksums``, which replace the
    reference's jnp update and checksum reduction (no Pallas kernel), in a
    fourth and a fifth."""
    k = build.KERNELS
    assert len(k) == 11
    assert k["ragged_sls"].stem == "masked_sls"
    assert {v.stem for v in k.values()} == {"masked_sls", "dot_interaction",
                                            "fused_front_end",
                                            "apply_deltas", "page_checksums"}
    assert sum("src/repro/kernels/" in v.replaces for v in k.values()) == 8
    assert "src/repro/core/pifs.py:1232" in k["apply_deltas"].replaces
    assert "src/repro/core/pifs.py:1394" in k["page_checksums"].replaces
    for name, line in (("fused_partial_pool", "sls.py:750"),
                       ("fused_partial_pool_dedup", "sls.py:818"),
                       ("fused_resume", "sls.py:871")):
        assert line in k[name].replaces
        assert k[name].source.startswith("src/repro_torch/kernels/csrc/")


@pytest.mark.cuda
def test_cuda_partial_pool_and_resume_match_plain_on_the_card():
    """Rows 7-9 on the card: the kernels against their plain versions
    (bitwise at 0/1 weights), the gather-once tiles against the per-entry
    tiles and the S-shard composition against split (bitwise, every
    weight), at S = 1, 2, 4, 8 and 12 (more than 8 shards: grid rows of
    8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    for storage, weighting, S in itertools.product(
            ("fp32", "int8"), ("01", "general"), (1, 2, 4, 8, 12)):
        B, G, L, V, D = 37, 8, 7, 500, 64
        args = tuple(None if a is None else torch.as_tensor(a, device=dev)
                     for a in _inputs(9, B, G, L, V, D, storage,
                                      weighting, S=S))
        launches = build.KERNELS["fused_partial_pool"].launches
        pc, ph = core_sls.fused_partial_pool_dense(*args)
        assert build.KERNELS["fused_partial_pool"].launches == \
            launches + 1
        qc, qh = core_sls.fused_partial_pool_dense(*args, impl="torch")
        dc, dh = core_sls.fused_partial_pool_dense(*args, dedup=True)
        assert torch.equal(dc, pc) and torch.equal(dh, ph)
        if weighting == "01":
            assert torch.equal(pc, qc) and torch.equal(ph, qh)
        out = core_sls.fused_resume_dense(pc, ph)
        N = B * G
        cold_p = core_sls.masked_partial_sls_dense(
            args[0], args[3].reshape(N, L), args[4].reshape(S, N, L),
            args[6].reshape(N, L),
            scales=None if args[7] is None else args[7].reshape(N, L))
        hot_p = core_sls.masked_partial_sls_dense(
            args[1], args[3].reshape(N, L), args[5].reshape(N, L),
            args[6].reshape(N, L))
        split = ops.dot_interaction(torch.cat(
            [args[2][:, None],
             (ref.shard_sum(cold_p) + hot_p).reshape(B, G, D)], 1))
        assert torch.equal(out, split)
        plain = core_sls.fused_resume_dense(pc, ph, impl="torch")
        feats = (ref.shard_sum(pc) + ph).cpu().numpy()
        _assert_within(out.cpu().numpy(), plain.cpu().numpy(),
                       _dot_bound(feats))
