"""The staging path of the redesigned interaction kernels, held on the
CPU, and the plain dot_interaction against the Pallas kernel at a wider F
than ``tests/test_torch_kernels.py`` takes.

``vec4_tiles`` (``kernels/interaction.py``) decides how a tile reaches
shared memory: float4 through registers, or the scalar path of the same
kernel for D % 4 != 0 and tiles that are not 16-byte aligned.  The launch
shape (``tile_shape``) is held in ``tests/test_torch_redesign.py``.  The
CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against its plain version there.

Tolerance of the plain version against the Pallas kernel (interpret mode)
and its oracle: the two reduce over D in different orders, so
|diff| <= 2 * D * 2^-23 * sum_d |x_i[d] * x_j[d]|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import interaction as kinteraction
from repro_torch.kernels import ops

EPS = 2.0 ** -23


@pytest.mark.parametrize("offset", [0, 1, 2, 4])
@pytest.mark.parametrize("D", [16, 18, 128])
def test_vec4_tiles_takes_the_scalar_path_when_not_aligned(D, offset):
    """float4 only for 16-byte aligned tiles with D % 4 == 0; a contiguous
    view offset by a float or two, or an odd D, takes the scalar path, and
    so does the resume when either of its tiles does."""
    buf = torch.zeros(3 * 9 * D + offset + 4)
    base = buf.data_ptr() % 16 // 4    # floats past a 16-byte boundary
    start = (4 - base) % 4 + offset
    feats = buf[start:start + 3 * 9 * D].view(3, 9, D)
    aligned = D % 4 == 0 and offset % 4 == 0
    assert feats.data_ptr() % 16 == (0 if offset % 4 == 0 else 4 * offset)
    assert kinteraction.vec4_tiles(feats) == aligned
    first = (4 - base) % 4                 # a 16-byte aligned view
    whole = buf[first:first + 3 * 9 * D].view(3, 9, D)
    assert kinteraction.vec4_tiles(whole, feats) == aligned


def _dot_bound(feats, self_interaction):
    a = np.abs(feats.astype(np.float64))
    z = np.einsum("bfd,bgd->bfg", a, a)
    i, j = np.tril_indices(feats.shape[1], k=0 if self_interaction else -1)
    return 2 * feats.shape[2] * EPS * z[:, i, j] + 1e-30


@pytest.mark.parametrize("B", [1, 3, 6])
@pytest.mark.parametrize("self_interaction", [False, True])
def test_plain_dot_interaction_matches_pallas_at_wide_f(B, self_interaction):
    """F = 27 (351 or 378 pairs), D = 16: the plain version against the
    Pallas kernel in interpret mode and its jnp oracle, both triangles in
    np.tril_indices order."""
    F, D = 27, 16
    feats = np.random.default_rng(100 + B).normal(
        size=(B, F, D)).astype(np.float32)
    got = ops.dot_interaction(torch.as_tensor(feats), self_interaction)
    P = F * (F + 1) // 2 if self_interaction else F * (F - 1) // 2
    assert got.shape == (B, P)
    bound = _dot_bound(feats, self_interaction)
    for want in (jops.dot_interaction(jnp.asarray(feats), self_interaction,
                                      impl="pallas", interpret=True),
                 jref.dot_interaction_ref(jnp.asarray(feats),
                                          self_interaction)):
        err = np.abs(got.numpy().astype(np.float64)
                     - np.asarray(want, np.float64))
        assert (err <= bound).all(), err.max()


@pytest.mark.cuda
def test_dot_interaction_paths_agree_on_the_card():
    """The float4 and scalar paths give the same bits on the card, both
    triangles (chip_smoke.py runs the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B in (1, 37, 2053):
        feats = torch.randn((B, 9, 128), generator=gen, device="cuda")
        buf = torch.empty(feats.numel() + 1, device="cuda")
        buf[1:] = feats.flatten()
        mis = buf[1:].view(feats.shape)
        for si in (False, True):
            k = kinteraction.dot_interaction(feats, si)
            assert torch.equal(k, kinteraction.dot_interaction(mis, si))
