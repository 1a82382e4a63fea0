"""The dense SLS API against the reference: ``kernels/ops.py: sls`` (the
entry point of the SLS kernel with no mask, the reference's ``sls`` /
``sls_pallas``) and ``core/sls.py: sls_ref, sls_dense_ref,
masked_partial_sls, bags_to_flat``.

Tolerances (the numerics contract, ``tests/test_torch_kernels.py``): with
0/1 weights every product is exact and the results are bitwise equal;
with general weights each of the L accumulate steps may round once more,
|diff| <= 2 * L * 2^-23 * sum_l |w_l * row_l|.  A flat segment sum in
index order has the same bound with L the longest segment.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.core import sls as jsls
from repro.kernels import ops as jops

from repro_torch.core import sls
from repro_torch.kernels import build, ops
from repro_torch.launch.op_stats import summarize

EPS = 2.0 ** -23


def _inputs(seed, B, L, V, D, weighting):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, L)).astype(np.int32)
    if weighting == "01":
        w = (rng.random((B, L)) < 0.8).astype(np.float32)
    else:
        w = rng.uniform(-2.0, 2.0, (B, L)).astype(np.float32)
    return table, idx, w


def _bound(table, idx, w, steps):
    rows = np.abs(table[idx].astype(np.float64))
    return 2 * steps * EPS * (np.abs(w)[..., None] * rows).sum(axis=1)


def _check(got, want, weighting, bound):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if weighting == "01":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(np.abs(got.astype(np.float64) - want) <= bound)


@pytest.mark.parametrize("weighting", ["01", "general"])
@pytest.mark.parametrize("B,L,V,D", [(6, 11, 50, 32), (9, 1, 7, 5),
                                     (4, 8, 300, 64), (7, 9, 40, 16),
                                     (3, 16, 20, 8)])
def test_ops_sls_matches_reference(B, L, V, D, weighting):
    table, idx, w = _inputs(B * L + D, B, L, V, D, weighting)
    bound = _bound(table, idx, w, L)
    for wt in (w, None):
        got = ops.sls(torch.as_tensor(table), torch.as_tensor(idx),
                      None if wt is None else torch.as_tensor(wt))
        for impl in ("jnp", "pallas"):
            want = jops.sls(jnp.asarray(table), jnp.asarray(idx),
                            None if wt is None else jnp.asarray(wt),
                            impl=impl, interpret=True)
            _check(got.numpy(), want, "01" if wt is None else weighting,
                   bound)


def test_ops_sls_is_one_masked_sls_call_on_every_route():
    table, idx, w = _inputs(0, 4, 3, 20, 8, "01")
    s, out = summarize(lambda t, i, ww: ops.sls(t, i, ww),
                       torch.as_tensor(table), torch.as_tensor(idx),
                       torch.as_tensor(w))
    assert s.kernels == {"masked_sls": 1} and out.shape == (4, 8)
    with FakeTensorMode():
        ft, fi = torch.empty(20, 8), torch.empty(4, 3, dtype=torch.int32)
        s, out = summarize(lambda t, i: ops.sls(t, i), ft, fi)
    assert s.kernels == {"masked_sls": 1}
    assert out.shape == (4, 8) and out.dtype == torch.float32
    assert build.KERNELS["masked_sls"].launches == 0


@pytest.mark.parametrize("weighting", ["01", "general"])
def test_sls_dense_ref_matches_reference(weighting):
    table, idx, w = _inputs(1, 7, 9, 40, 16, weighting)
    bound = _bound(table, idx, w, idx.shape[1])
    got = sls.sls_dense_ref(torch.as_tensor(table), torch.as_tensor(idx),
                            torch.as_tensor(w))
    want = jsls.sls_dense_ref(jnp.asarray(table), jnp.asarray(idx),
                              jnp.asarray(w))
    _check(got.numpy(), want, weighting, bound)
    _check(sls.sls_dense_ref(torch.as_tensor(table),
                             torch.as_tensor(idx)).numpy(),
           jsls.sls_dense_ref(jnp.asarray(table), jnp.asarray(idx)), "01",
           None)


def test_bags_to_flat_matches_reference():
    _, idx, w = _inputs(2, 5, 4, 30, 8, "general")
    got = sls.bags_to_flat(torch.as_tensor(idx), torch.as_tensor(w))
    want = jsls.bags_to_flat(jnp.asarray(idx), jnp.asarray(w))
    assert got[2] == want[2]
    for g, j in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
        assert g.numpy().dtype == np.asarray(j).dtype
    assert sls.bags_to_flat(torch.as_tensor(idx))[3] is None


@pytest.mark.parametrize("weighting", ["01", "general"])
def test_sls_ref_flat_matches_reference(weighting):
    """Flat bags, the segments shuffled and one id outside the segment
    range (dropped by both); ids wrapped once when negative."""
    rng = np.random.default_rng(3)
    table, idx, w = _inputs(3, 6, 5, 25, 12, weighting)
    flat, seg, nb, wf = jsls.bags_to_flat(jnp.asarray(idx), jnp.asarray(w))
    flat, seg, wf = np.asarray(flat), np.asarray(seg), np.asarray(wf)
    perm = rng.permutation(flat.size)
    flat, seg, wf = flat[perm].copy(), seg[perm].copy(), wf[perm]
    flat[0] = -3
    seg[1] = nb + 2
    got = sls.sls_ref(torch.as_tensor(table), torch.as_tensor(flat),
                      torch.as_tensor(seg), nb, torch.as_tensor(wf))
    want = jsls.sls_ref(jnp.asarray(table), jnp.asarray(flat),
                        jnp.asarray(seg), nb, jnp.asarray(wf))
    safe = np.where(flat < 0, flat + table.shape[0], flat)
    rows = np.abs(table[safe].astype(np.float64)) * np.abs(wf)[:, None]
    per = np.zeros((nb, table.shape[1]))
    np.add.at(per, np.clip(seg, 0, nb - 1), rows)
    _check(got.numpy(), want, weighting, 2 * 5 * EPS * per)


@pytest.mark.parametrize("weighting", ["01", "general"])
def test_masked_partial_sls_matches_reference(weighting):
    rng = np.random.default_rng(4)
    table, idx, w = _inputs(4, 8, 6, 30, 16, weighting)
    owned = rng.random(idx.shape) < 0.6
    flat, seg, nb, wf = jsls.bags_to_flat(jnp.asarray(idx), jnp.asarray(w))
    flat, seg, wf = np.asarray(flat), np.asarray(seg), np.asarray(wf)
    own = owned.reshape(-1)
    got = sls.masked_partial_sls(torch.as_tensor(table),
                                 torch.as_tensor(flat), torch.as_tensor(own),
                                 torch.as_tensor(seg), nb,
                                 torch.as_tensor(wf))
    want = jsls.masked_partial_sls(jnp.asarray(table), jnp.asarray(flat),
                                   jnp.asarray(own), jnp.asarray(seg), nb,
                                   jnp.asarray(wf))
    _check(got.numpy(), want, weighting,
           _bound(table, idx, w * owned, idx.shape[1]))
