"""Port parity of the kernels' plain versions against the JAX Pallas kernels
(interpret mode, as tests/test_kernels.py runs them) and their jnp oracles,
plus the wrappers' input contract.

Tolerances.  Weights of 0/1 (all serving traffic) make every product
f * row exact, so the fixed-l-order SLS is bitwise equal whether a step is
one FMA (XLA on the CPU, the CUDA kernel) or a multiply then an add (the
plain version).  With general weights each of the L steps may round once
more: |diff| <= 2 * L * 2^-23 * sum_l |f_l * row_l|.  The interaction
reduces over D in different orders (XLA dot vs torch.bmm), so
|diff| <= 2 * D * 2^-23 * sum_d |x_i[d] * x_j[d]|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sls import sls_pallas

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import interaction as kinteraction
from repro_torch.kernels import sls as ksls

EPS = 2.0 ** -23


def _sls_inputs(seed, N, L, V, D, storage, weighting):
    rng = np.random.default_rng(seed)
    if storage == "int8":
        table = rng.integers(-127, 128, (V, D)).astype(np.int8)
        scales = rng.uniform(1e-4, 2e-2, (N, L)).astype(np.float32)
    else:
        table = rng.normal(size=(V, D)).astype(np.float32)
        scales = None
    idx = rng.integers(0, V, (N, L)).astype(np.int32)
    owned = rng.random((N, L)) < 0.6
    if weighting == "01":
        w = (rng.random((N, L)) < 0.8).astype(np.float32)
    else:
        w = rng.uniform(-2.0, 2.0, (N, L)).astype(np.float32)
    return table, idx, owned, w, scales


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _sls_bound(table, idx, owned, w, scales):
    """2 * L * eps * sum_l |f_l * row_l| in float64."""
    rows = np.abs(table[np.where(owned, idx, 0)].astype(np.float64))
    if scales is not None:
        rows = rows * np.abs(scales)[..., None]
    f = np.abs(owned * w).astype(np.float64)
    return 2 * idx.shape[1] * EPS * (f[..., None] * rows).sum(axis=1)


def _dot_bound(feats, self_interaction=False):
    a = np.abs(feats.astype(np.float64))
    z = np.einsum("bfd,bgd->bfg", a, a)
    i, j = np.tril_indices(feats.shape[1], k=0 if self_interaction else -1)
    return 2 * feats.shape[2] * EPS * z[:, i, j] + 1e-30


def _assert_within(got, want, bound):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= bound).all(), (err.max(), bound[err > bound].min())


@pytest.mark.parametrize("N,L,V,D", [(12, 7, 64, 16), (5, 9, 40, 24),
                                     (4, 8, 32, 64)])
@pytest.mark.parametrize("weighting", ["01", "general"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_masked_sls_plain_matches_pallas_and_oracle(N, L, V, D, weighting,
                                                    storage):
    """Port plain masked SLS vs the Pallas kernel (interpret, a tail tile:
    block_l=3) and the fixed-order oracle: bitwise at 0/1 weights."""
    table, idx, owned, w, scales = _sls_inputs(N * L + D, N, L, V, D,
                                               storage, weighting)
    got = ops.masked_sls(_t(table), _t(idx), _t(owned), _t(w), _t(scales))
    assert got.dtype == torch.float32 and got.shape == (N, D)
    pallas = jops.masked_sls(_j(table), _j(idx), _j(owned), _j(w),
                             scales=_j(scales), interpret=True, block_l=3)
    if storage == "int8":
        oracle = jref.masked_sls_quant_ref(_j(table), _j(idx), _j(owned),
                                           _j(scales), _j(w))
    else:
        oracle = jref._fixed_order_masked_sls(_j(table), _j(idx), _j(owned),
                                              _j(w))
    for want in (pallas, oracle):
        if weighting == "01":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _assert_within(got.numpy(), want,
                           _sls_bound(table, idx, owned, w, scales))
    # the port's own oracle twins agree with the JAX ones
    if storage == "int8":
        twin = ref.masked_sls_quant_ref(_t(table), _t(idx), _t(owned),
                                        _t(scales), _t(w))
    else:
        twin = ref._fixed_order_masked_sls(_t(table), _t(idx), _t(owned),
                                           _t(w))
    np.testing.assert_array_equal(twin.numpy(), got.numpy())
    summed = ref.masked_sls_ref(_t(table), _t(idx), _t(owned), _t(w),
                                scales=_t(scales))
    _assert_within(summed.numpy(),
                   jref.masked_sls_ref(_j(table), _j(idx), _j(owned), _j(w),
                                       scales=_j(scales)),
                   _sls_bound(table, idx, owned, w, scales))


@pytest.mark.parametrize("weighting", ["01", "general"])
def test_plain_sls_null_mask_matches_sls_pallas(weighting):
    """Kernel row 2 (``sls_pallas``) is the masked kernel with a null
    mask."""
    table, idx, _, w, _ = _sls_inputs(3, 6, 11, 50, 32, "fp32", weighting)
    got = ops.masked_sls(_t(table), _t(idx), None, _t(w))
    want = sls_pallas(_j(table), _j(idx), _j(w), interpret=True, block_l=4)
    ones = np.ones(idx.shape, bool)
    if weighting == "01":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _assert_within(got.numpy(), want,
                       _sls_bound(table, idx, ones, w, None))
    _assert_within(ref.sls_ref(_t(table), _t(idx), _t(w)).numpy(),
                   jref.sls_ref(_j(table), _j(idx), _j(w)),
                   _sls_bound(table, idx, ones, w, None))


@pytest.mark.parametrize("B,F,D", [(5, 9, 16), (3, 4, 24), (8, 9, 64)])
@pytest.mark.parametrize("self_interaction", [False, True])
def test_dot_interaction_plain_matches_pallas(B, F, D, self_interaction):
    feats = np.random.default_rng(B * F + D).normal(
        size=(B, F, D)).astype(np.float32)
    got = ops.dot_interaction(_t(feats), self_interaction)
    P = F * (F + 1) // 2 if self_interaction else F * (F - 1) // 2
    assert got.shape == (B, P)
    for want in (jops.dot_interaction(_j(feats), self_interaction,
                                      impl="pallas", interpret=True),
                 jref.dot_interaction_ref(_j(feats), self_interaction)):
        _assert_within(got.numpy(), want, _dot_bound(feats, self_interaction))


def _fe_inputs(seed, B, G, L, Vc, Vh, D, storage, weighting):
    rng = np.random.default_rng(seed)
    table, _, _, _, _ = _sls_inputs(seed, 1, 1, Vc, D, storage, weighting)
    hot = rng.normal(size=(Vh, D)).astype(np.float32)
    rows = rng.integers(0, min(Vc, Vh), (B, G, L)).astype(np.int32)
    owned = rng.random((B, G, L)) < 0.5
    is_hot = ~owned & (rng.random((B, G, L)) < 0.7)   # some in neither
    w = ((rng.random((B, G, L)) < 0.8).astype(np.float32)
         if weighting == "01"
         else rng.uniform(-2, 2, (B, G, L)).astype(np.float32))
    scales = (rng.uniform(1e-4, 2e-2, (B, G, L)).astype(np.float32)
              if storage == "int8" else None)
    x = rng.normal(size=(B, D)).astype(np.float32)
    return table, hot, x, rows, owned, is_hot, w, scales


@pytest.mark.parametrize("weighting", ["01", "general"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_fused_front_end_plain_matches_pallas(weighting, storage):
    """Port plain fused front end vs the fused Pallas kernel (interpret;
    B not a multiple of block_b, L not a multiple of block_l) and the
    oracle.  The pooled features (both tiers) are bitwise equal to the
    reference's at 0/1 weights; the packed dots agree within the
    interaction tolerance."""
    B, G, L, D = 5, 3, 7, 16
    args = _fe_inputs(11, B, G, L, 40, 30, D, storage, weighting)
    table, hot, x, rows, owned, is_hot, w, scales = args
    got = ops.fused_front_end(*map(_t, args))
    assert got.shape == (B, (G + 1) * G // 2)
    pallas = jops.fused_front_end(*map(_j, args), interpret=True, block_l=3,
                                  block_b=2)
    oracle = jref.fused_front_end_ref(*map(_j, args))
    # rebuild both packages' features to check the pooled part exactly
    flat, nb = rows.reshape(B * G, L), B * G
    s2 = None if scales is None else scales.reshape(nb, L)
    pooled = (ref._fixed_order_masked_sls(
        _t(table), _t(flat), _t(owned.reshape(nb, L)), _t(w.reshape(nb, L)),
        _t(s2)) + ref._fixed_order_masked_sls(
        _t(hot), _t(flat), _t(is_hot.reshape(nb, L)), _t(w.reshape(nb, L))))
    jpooled = (jref._fixed_order_masked_sls(
        _j(table), _j(flat), _j(owned.reshape(nb, L)), _j(w.reshape(nb, L)),
        _j(s2)) + jref._fixed_order_masked_sls(
        _j(hot), _j(flat), _j(is_hot.reshape(nb, L)), _j(w.reshape(nb, L))))
    feats = np.concatenate([x[:, None], np.asarray(jpooled).reshape(B, G, D)],
                           axis=1)
    if weighting == "01":
        np.testing.assert_array_equal(pooled.numpy(), np.asarray(jpooled))
        bound = _dot_bound(feats)
    else:
        sls_b = (_sls_bound(table, flat, owned.reshape(nb, L),
                            w.reshape(nb, L), s2)
                 + _sls_bound(hot, flat, is_hot.reshape(nb, L),
                              w.reshape(nb, L), None)).reshape(B, G, D)
        a = np.concatenate([np.zeros((B, 1, D)), sls_b], axis=1)
        e = np.einsum("bfd,bgd->bfg", a, np.abs(feats))
        i, j = np.tril_indices(G + 1, k=-1)
        bound = _dot_bound(feats) + 2 * (e + e.transpose(0, 2, 1))[:, i, j]
    for want in (pallas, oracle):
        _assert_within(got.numpy(), want, bound)
    # inside the port, fused == split composition bitwise
    split = ops.dot_interaction(torch.cat(
        [_t(x)[:, None], pooled.reshape(B, G, D)], dim=1))
    np.testing.assert_array_equal(got.numpy(), split.numpy())


def test_wrappers_check_inputs():
    """The wrappers reject what the kernels do not take, on any device."""
    t = torch.zeros((8, 16))
    idx = torch.zeros((2, 3), dtype=torch.int32)
    owned = torch.ones((2, 3), dtype=torch.bool)
    with pytest.raises(TypeError):
        ops.masked_sls(t, idx.long(), owned)                 # int64 ids
    with pytest.raises(TypeError):
        ops.masked_sls(t.double(), idx, owned)               # fp64 table
    with pytest.raises(ValueError):
        ops.masked_sls(t, idx, owned[:, :2])                 # mask shape
    with pytest.raises(ValueError):
        ops.masked_sls(t.to(torch.int8), idx, owned)         # int8, no scales
    with pytest.raises(ValueError):
        ops.masked_sls(t, idx, owned, scales=torch.ones((2, 3)))
    with pytest.raises(ValueError):
        ops.masked_sls(t[:, ::2], idx, owned)                # not contiguous
    with pytest.raises(TypeError):
        ops.dot_interaction(torch.zeros((2, 3, 4), dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.masked_sls(t, idx, owned, impl="pallas")
    with pytest.raises(ValueError):
        ops.fused_front_end(t, torch.zeros((4, 8)), torch.zeros((2, 16)),
                            torch.zeros((2, 1, 3), dtype=torch.int32),
                            torch.ones((2, 1, 3), dtype=torch.bool),
                            torch.zeros((2, 1, 3), dtype=torch.bool))


def test_cpu_tensors_never_reach_a_kernel():
    """On CPU tensors the dispatch takes the plain version without touching
    the kernels (no launch is counted, nothing is built); the kernel
    wrappers themselves refuse CPU tensors instead of falling back."""
    build.reset_launches()
    t = torch.randn((8, 16))
    idx = torch.zeros((2, 3), dtype=torch.int32)
    owned = torch.ones((2, 3), dtype=torch.bool)
    ops.masked_sls(t, idx, owned)
    ops.dot_interaction(torch.randn((2, 3, 16)))
    assert all(k.launches == 0 for k in build.KERNELS.values())
    with pytest.raises(ValueError, match="CUDA tensors"):
        ksls.masked_sls(t, idx, owned)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kinteraction.dot_interaction(torch.randn((2, 3, 16)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ksls.fused_front_end(t, torch.zeros((4, 16)), torch.zeros((2, 16)),
                             torch.zeros((2, 1, 3), dtype=torch.int32),
                             owned[:, None], owned[:, None])


def test_block_sizes_spread_the_batch_and_fit_shared_memory():
    # the cap on samples per CTA (the kernel takes fewer, one bag per
    # team): batch 2053 on 132 SMs allows 16; batch 32 one, so 32 SMs work
    assert ksls.fused_block(2053, 9, 128, 132) == 16
    assert ksls.fused_block(32, 9, 64, 132) == 1
    assert kinteraction.tile_shape(2053, 9, 128, 132) == (4, 256, 132)
    # a tile is capped by the 227 KB of shared memory a block can use
    assert ksls.fused_block(10 ** 6, 41, 1024, 1) == 1
    with pytest.raises(ValueError):
        ksls.fused_block(4, 100, 1024, 132)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions_on_the_card():
    """The CUDA kernels against their plain versions on the card: bitwise
    at 0/1 weights, fused == split bitwise, the interaction within its
    tolerance (chip_smoke.py runs the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    dev = torch.device("cuda")
    for storage in ("fp32", "int8"):
        table, idx, owned, w, scales = _sls_inputs(1, 37 * 4, 7, 300, 64,
                                                   storage, "01")
        args = [None if a is None else torch.as_tensor(a, device=dev)
                for a in (table, idx, owned, w, scales)]
        assert torch.equal(ops.masked_sls(*args),
                           ops.masked_sls(*args, impl="torch"))
        fe = [None if a is None else torch.as_tensor(a, device=dev)
              for a in _fe_inputs(2, 37, 4, 7, 300, 200, 64, storage, "01")]
        fused = ops.fused_front_end(*fe)
        plain = ops.fused_front_end(*fe, impl="torch")
        torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-5)
        cold, hot, x, rows, own3, hot3, w3, s3 = fe
        flat = rows.reshape(-1, 7)
        pooled = (ops.masked_sls(cold, flat, own3.reshape(-1, 7),
                                 w3.reshape(-1, 7),
                                 None if s3 is None else s3.reshape(-1, 7))
                  + ops.masked_sls(hot, flat, hot3.reshape(-1, 7),
                                   w3.reshape(-1, 7)))
        split = ops.dot_interaction(torch.cat(
            [x[:, None], pooled.reshape(37, 4, 64)], 1))
        assert torch.equal(fused, split)
