"""The port's LM serve path (``repro_torch.models.transformer``) against
``repro.models.transformer`` on the CPU: ``prefill_step`` and
``decode_step`` for the five reduced LM configs, the in-place cache
against the reference's returned one, the parameter tree carried across
by ``params_from_numpy``, and the port's own draws.

The reference runs on ``make_mesh((1, 1))`` under ``jax.jit``; its weights
are drawn with its PRNG and carried across as numpy leaves.  Prompts come
from ``lm_batches`` (zipf ids with repeats).

Tolerances.
- fp32: logits and cache 1e-5 relative and 2e-5 absolute (logits are of
  order 4).  The two packages reduce the products' inner dimensions, the
  norms' means and the softmax sums in other orders, and their exp, cos
  and sin differ in the last bits; measured differences are ~3e-6.
- bf16 (one case, llama): every product and norm rounds to bf16 in both,
  at different points; logits within 2^-3 absolute (4 bf16 ulps at
  magnitude 4) plus 2^-5 relative, cache within 2^-5 absolute plus 2^-6
  relative; measured ~0.05 and ~0.02.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.distributed.sharding import make_mesh
from repro.models import params as jprm
from repro.models import transformer as jtr

from repro_torch.configs import get_config, reduced
from repro_torch.data.synth import lm_batches
from repro_torch.models import transformer as tr
from repro_torch.models.params import spec_leaves

LM_ARCHS = ["llama3.2-3b", "granite-moe-1b-a400m", "deepseek-v3-671b",
            "deepseek-67b", "nemotron-4-340b"]
MESH = make_mesh((1, 1), ("data", "model"))
TOL = {"float32": dict(logits=dict(rtol=1e-5, atol=2e-5),
                       cache=dict(rtol=1e-5, atol=2e-5)),
       "bfloat16": dict(logits=dict(rtol=2 ** -5, atol=2 ** -3),
                        cache=dict(rtol=2 ** -6, atol=2 ** -5))}
B, S = 2, 16


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _carried(arch, dtype="float32", seed=0):
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), dtype=dtype)
    pcfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
    jp = jprm.initialize(jtr.model_specs(jcfg, MESH),
                         jax.random.PRNGKey(seed))
    pp = tr.params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, "cpu")
    return jcfg, pcfg, jp, pp


def _prompt(cfg, seq=S, seed=0):
    return next(lm_batches(cfg, B, seq, 1, seed=seed))["tokens"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_step_equals_the_reference(arch):
    jcfg, pcfg, jp, pp = _carried(arch)
    toks = _prompt(pcfg, seq=32)
    want = jax.jit(lambda p, t: jtr.prefill_step(p, t, jcfg, MESH))(
        jp, jnp.asarray(toks))
    got = tr.prefill_step(pp, toks, pcfg)
    assert got.shape == (B, 1, pcfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **TOL["float32"]["logits"])


def _decode_against_reference(arch, dtype):
    """Decode at pos 0, mid-cache, S - 1, S (no write) and -1 (no write,
    no key) from a random cache; after each step the port's cache, written
    in place, equals the reference's returned cache."""
    jcfg, pcfg, jp, pp = _carried(arch, dtype)
    rng = np.random.default_rng(1)
    jcache = {k: jnp.asarray(rng.normal(size=s.shape).astype(np.float32)
                             ).astype(s.dtype)
              for k, s in jtr.cache_specs(jcfg, MESH, B, S).items()}
    pcache = {k: torch.from_numpy(np.array(_f32(v))).to(tr.cfg_dtype(pcfg))
              for k, v in jcache.items()}
    tensors = dict(pcache)
    assert {k: (tuple(v.shape), v.dtype) for k, v in pcache.items()} == \
        {k: v for k, v in tr.cache_specs(pcfg, B, S).items()}
    step = jax.jit(jtr.make_decode_step(jcfg, MESH))
    pstep = tr.make_decode_step(pcfg)
    tol = TOL[dtype]
    for pos in (0, 7, S - 1, S, -1):
        toks = rng.integers(0, pcfg.vocab, (B, 1)).astype(np.int32)
        jl, jcache = step(jp, jcache, {"tokens": jnp.asarray(toks),
                                       "pos": jnp.asarray(pos, jnp.int32)})
        before = {k: v.clone() for k, v in pcache.items()}
        pl, pcache = pstep(pp, pcache, {"tokens": toks, "pos": pos})
        assert pl.shape == (B, 1, pcfg.vocab)
        assert all(pcache[k] is tensors[k] for k in tensors)   # in place
        np.testing.assert_allclose(_f32(pl), _f32(jl), **tol["logits"])
        for k in pcache:
            np.testing.assert_allclose(_f32(pcache[k]), _f32(jcache[k]),
                                       **tol["cache"])
            if not 0 <= pos < S:
                assert torch.equal(pcache[k], before[k]), (k, pos)
            else:
                changed = (pcache[k] != before[k]).flatten(3).any(-1)
                assert not changed[:, :, [p for p in range(S)
                                          if p != pos]].any()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_step_equals_the_reference_fp32(arch):
    _decode_against_reference(arch, "float32")


def test_decode_step_equals_the_reference_bf16():
    _decode_against_reference("llama3.2-3b", "bfloat16")


def test_prefill_step_equals_the_reference_bf16():
    jcfg, pcfg, jp, pp = _carried("granite-moe-1b-a400m", "bfloat16")
    toks = _prompt(pcfg, seq=32)
    want = jax.jit(lambda p, t: jtr.prefill_step(p, t, jcfg, MESH))(
        jp, jnp.asarray(toks))
    got = tr.prefill_step(pp, toks, pcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **TOL["bfloat16"]["logits"])


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v3-671b"])
def test_decode_from_a_zero_cache_equals_prefill(arch):
    """Feeding a prompt one position at a time through decode_step from a
    zero cache ends at prefill_step's logits (fp32)."""
    _, pcfg, _, pp = _carried(arch)
    toks = _prompt(pcfg)
    cache = tr.init_cache(pcfg, B, 2 * S, device="cpu")
    for t in range(S):
        logits, cache = tr.decode_step(pp, cache, toks[:, t:t + 1], t, pcfg)
    want = tr.prefill_step(pp, toks, pcfg)
    torch.testing.assert_close(logits, want, rtol=1e-5, atol=2e-5)
    assert not cache[next(iter(cache))][:, :, S:].any()


def test_params_from_numpy_is_strict_and_forward_returns_aux():
    jcfg, pcfg, jp, pp = _carried("deepseek-v3-671b")
    tree = jax.tree.map(np.asarray, jp)
    assert "mtp" in pp                        # built, never read serving
    del tree["mtp"]
    with pytest.raises(KeyError, match="mtp"):
        tr.params_from_numpy(tree, pcfg, "cpu")
    tree = jax.tree.map(np.asarray, jp)
    tree["head"] = tree["head"][:, :-1]
    with pytest.raises(ValueError, match="head"):
        tr.params_from_numpy(tree, pcfg, "cpu")
    toks = _prompt(pcfg)
    _, jaux = jtr.forward(jp, jnp.asarray(toks), jcfg, MESH, remat="none")
    _, paux = tr.forward(pp, toks, pcfg)
    np.testing.assert_allclose(_f32(paux), _f32(jaux), rtol=1e-5, atol=1e-7)
    assert float(paux) > 0


def test_init_params_draws_by_the_specs(monkeypatch):
    """ones / zeros / normal * scale or 1/sqrt(fan_in), in the leaf dtype,
    the same from one seed, a leaf drawn in chunks as in one draw."""
    from repro_torch.models import params as prm
    cfg = reduced(get_config("deepseek-v3-671b"))
    p = tr.init_params(cfg, seed=3, device="cpu")
    specs = dict(spec_leaves(tr.model_specs(cfg)))
    flat = dict(spec_leaves_of(p))
    assert flat.keys() == specs.keys()
    for k, s in specs.items():
        t = flat[k]
        assert tuple(t.shape) == s.shape and t.dtype == s.dtype, k
        if s.init == "ones":
            assert (t == 1).all(), k
        else:
            want = s.scale or s.shape[-2] ** -0.5
            assert abs(t.float().std().item() / want - 1) < 0.15, k
    assert flat["moe_layers.moe.router"].dtype == torch.float32
    q = dict(spec_leaves_of(tr.init_params(cfg, seed=3, device="cpu")))
    assert all(torch.equal(q[k], flat[k]) for k in flat)
    monkeypatch.setattr(prm, "_DRAW_CHUNK", 1000)     # the head: 32 chunks
    head = tr.init_params(cfg, seed=3, device="cpu")["head"]
    assert abs(head.float().std().item() * cfg.d_model ** 0.5 - 1) < 0.05
    if not torch.cuda.is_available():       # the card unless asked
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tr.init_params(cfg)


def spec_leaves_of(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from spec_leaves_of(v, path)
        else:
            yield path, v


@pytest.mark.cuda
def test_prefill_and_decode_on_the_card_equal_the_cpu():
    """On the card: the reduced llama and deepseek-v3, fp32, TF32 off:
    prefill and three decode steps within 1e-5 of the port on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    for arch in ("llama3.2-3b", "deepseek-v3-671b"):
        _, pcfg, _, pp = _carried(arch)
        gp = jax.tree.map(lambda t: t.cuda(), pp)
        toks = _prompt(pcfg)
        torch.testing.assert_close(tr.prefill_step(gp, toks, pcfg).cpu(),
                                   tr.prefill_step(pp, toks, pcfg),
                                   rtol=1e-5, atol=1e-5)
        cc = tr.init_cache(pcfg, B, S, device="cpu")
        gc = tr.init_cache(pcfg, B, S, device="cuda")
        for t in range(3):
            cl, cc = tr.decode_step(pp, cc, toks[:, t:t + 1], t, pcfg)
            gl, gc = tr.decode_step(gp, gc, toks[:, t:t + 1], t, pcfg)
            torch.testing.assert_close(gl.cpu(), cl, rtol=1e-5, atol=1e-5)


def test_serve_cli_lists_and_takes_only_what_it_serves(capsys):
    """The request runtime serves DLRM and recsys ids; an LM id is refused
    with a pointer to the transformer's entry points, and ``--help`` lists
    no LM id."""
    from repro_torch.launch import serve as launch_serve
    with pytest.raises(SystemExit):
        launch_serve.main(["--help"])
    out = capsys.readouterr().out
    assert "dcn-v2" in out and not any(a in out for a in LM_ARCHS)
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "llama3.2-3b", "--device", "cpu"])
    assert "decode_step" in capsys.readouterr().err
