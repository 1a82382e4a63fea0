"""The port's optimizers and gradient compression against the reference
(``repro.optim``), on the same numpy parameters and gradients.

Tolerances: adagrad and rowwise_adagrad use the reference's operations
in its order, elementwise, and agree within 1 ulp-scale (rtol 1e-6,
atol 1e-7) after 1 and 3 updates (the row-wise mean's reduction order is
the one difference); adam's bias corrections come from ``pow`` in float32
in both, and XLA's and torch's pow may round an ulp apart, so adam is
held within rtol 1e-5 / atol 1e-6 after 1 and 3 updates (its state too).
Compression: int8 codes, scales and the member sum of codes are exact
(array_equal); the reduced and residual floats within 1 ulp-scale; bf16
within bf16's rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.distributed.sharding import make_mesh, shard_map
from repro.optim import compression as jcomp
from repro.optim import optimizers as jopt

from repro_torch.optim import compression, optimizers as opt


def _tree(rng, scale=1.0):
    return {"w": (rng.normal(size=(6, 5)) * scale).astype(np.float32),
            "b": (rng.normal(size=(5,)) * scale).astype(np.float32),
            "emb": {"cold": (rng.normal(size=(20, 8)) * scale
                             ).astype(np.float32),
                    "hot": (rng.normal(size=(4, 8)) * scale
                            ).astype(np.float32)}}


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix, np.asarray(tree.float() if torch.is_tensor(tree)
                                 and tree.dtype == torch.bfloat16 else tree,
                                 dtype=np.float32)


def _close(got, want, rtol, atol):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                   err_msg=k)


OPTS = {
    "adam": (dict(lr=1e-3), 1e-5, 1e-6),
    "adam_wd_bf16": (dict(lr=1e-2, weight_decay=0.1,
                          state_dtype=("bfloat16",)), 1e-5, 1e-6),
    "adagrad": (dict(lr=1e-2), 1e-6, 1e-7),
    "rowwise_adagrad": (dict(lr=5e-2), 1e-6, 1e-7),
}


def _make(name, kw, pkg):
    kw = dict(kw)
    if "state_dtype" in kw:
        kw["state_dtype"] = (jnp.bfloat16 if pkg is jopt
                             else torch.bfloat16)
    base = "adam" if name.startswith("adam") else name
    return getattr(pkg, base)(**kw)


@pytest.mark.parametrize("name", list(OPTS))
@pytest.mark.parametrize("n_steps", [1, 3])
def test_optimizer_matches_reference(name, n_steps):
    kw, rtol, atol = OPTS[name]
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jo, po = _make(name, kw, jopt), _make(name, kw, opt)
    jp = jax.tree.map(jnp.asarray, params)
    pp = _t(params)
    js, ps = jo.init(jp), po.init(pp)
    for _ in range(n_steps):
        g = _tree(rng, 0.1)
        g["emb"]["cold"][3:9] = 0.0        # untouched rows keep their value
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        out_p, ps = po.update(_t(g), ps, pp)
        assert out_p is pp                  # in place
    _close(pp, jp, rtol, atol)
    if name.startswith("adam"):
        assert int(ps["step"]) == int(js["step"]) == n_steps
        _close(ps["mv"], js["mv"], rtol, atol)
    else:
        _close(ps, js, rtol, atol)
    if name == "rowwise_adagrad":
        assert tuple(ps["emb"]["cold"].shape) == (20, 1)
        assert tuple(ps["b"].shape) == (5,)
        np.testing.assert_array_equal(pp["emb"]["cold"][3:9].numpy(),
                                      params["emb"]["cold"][3:9])


def test_get_optimizer_names():
    for name in ("adam", "adagrad", "rowwise_adagrad"):
        o = opt.get_optimizer(name, lr=0.1)
        assert callable(o.init) and callable(o.update)
    with pytest.raises(NotImplementedError, match="item 17"):
        opt.get_optimizer("adafactor")
    with pytest.raises(KeyError):
        opt.get_optimizer("sgd")


@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_compress_decompress_match_reference(method):
    rng = np.random.default_rng(1)
    g = (rng.normal(size=(7, 9)) * 3).astype(np.float32)
    q, s = compression.compress(torch.as_tensor(g), method)
    jq, js = jcomp.compress(jnp.asarray(g), method)
    np.testing.assert_array_equal(
        q.float().numpy(), np.asarray(jq.astype(jnp.float32)))
    assert (s is None) == (js is None)
    if s is not None:
        assert float(s) == float(js)
        assert q.dtype == torch.int8
    np.testing.assert_array_equal(
        compression.decompress(q, s, method).float().numpy(),
        np.asarray(jcomp.decompress(jq, js, method).astype(jnp.float32)))
    with pytest.raises(ValueError):
        compression.compress(torch.as_tensor(g), "fp8")
    e = compression.init_error_feedback(_t({"a": g}))
    assert float(e["a"].abs().sum()) == 0.0


@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_compressed_psum_matches_reference_members(method):
    """Four data-parallel members: the reference's psum inside shard_map
    on a 4-device CPU mesh, the port's member-order sum on one device;
    three steps with error feedback carried (int8)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 host devices")
    M = 4
    mesh = make_mesh((M,), ("data",))
    rng = np.random.default_rng(2)

    def jstep(g, e):
        red, ne = jcomp.compressed_psum({"w": g[0]}, "data", method,
                                        None if method == "none"
                                        else {"w": e[0]})
        out_e = e if ne is None or ne["w"] is None else ne["w"][None]
        return red["w"][None], out_e

    f = jax.jit(shard_map(jstep, mesh, in_specs=(P("data"), P("data")),
                          out_specs=(P("data"), P("data"))))
    e_j = np.zeros((M, 6, 5), np.float32)
    e_p = [{"w": torch.zeros(6, 5)} for _ in range(M)]
    for _ in range(3):
        g = (rng.normal(size=(M, 6, 5))).astype(np.float32)
        red_j, e_j = f(jnp.asarray(g), jnp.asarray(e_j))
        red_j, e_j = np.asarray(red_j), np.asarray(e_j)
        red_p, new_e = compression.compressed_psum(
            [{"w": torch.as_tensor(g[m])} for m in range(M)], method,
            None if method == "none" else e_p)
        for m in range(M):                # every member holds the sum
            tol = 1e-2 if method == "bf16" else 1e-6
            np.testing.assert_allclose(red_p["w"].numpy(), red_j[m],
                                       rtol=tol, atol=tol)
        if method == "int8":
            e_p = new_e
            for m in range(M):
                np.testing.assert_allclose(e_p[m]["w"].numpy(), e_j[m],
                                           rtol=1e-6, atol=1e-6)
        elif method == "bf16":
            assert all(x["w"] is None for x in new_e)
        else:
            assert new_e is None
