"""The port's LM building blocks against ``repro``'s on the CPU: configs and
shapes, parameter specs and counts, RMS norm, activations and FFN, RoPE,
the flash attention, GQA and MLA prefill and decode, the MoE block and
the token stream.

The reference runs on ``repro.distributed.sharding.make_mesh((1, 1))``;
inputs are drawn with numpy from a seed and cross as numpy arrays.

Tolerances (fp32): 1e-5 relative and 2e-5 absolute on values of order 1
to 10.  XLA and torch reduce the inner dimensions of products, means and
softmax sums in other orders, and their exp / cos / sin differ in the
last bits; nothing else may differ.  bf16 (the FFN): 2^-6 relative and
2^-5 absolute, a few bf16 roundings of the result.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data import synth as jsynth
from repro.distributed.sharding import make_mesh
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import params as jprm
from repro.models import transformer as jtr

from repro_torch.configs import (LM_SHAPES, get_config, list_archs,
                                 reduced, reduced_shape)
from repro_torch.data import synth
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe
from repro_torch.models import transformer as tr
from repro_torch.models.params import count_params, spec_leaves

LM_ARCHS = ["llama3.2-3b", "granite-moe-1b-a400m", "deepseek-v3-671b",
            "deepseek-67b", "nemotron-4-340b"]
MESH = make_mesh((1, 1), ("data", "model"))
DP, TP = ("data",), "model"
FP32 = dict(rtol=1e-5, atol=2e-5)


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jreduced(jget_config(arch)), dtype=dtype),
            dataclasses.replace(reduced(get_config(arch)), dtype=dtype))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               **(tol or FP32))


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_equal_the_reference(arch):
    j, p = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert p.head_dim == j.head_dim
    assert dataclasses.asdict(reduced(p)) == dataclasses.asdict(jreduced(j))


def test_lm_shapes_and_reduced_shapes_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in LM_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.LM_SHAPES.items()}
    for k, s in LM_SHAPES.items():
        assert dataclasses.asdict(reduced_shape(s)) == dataclasses.asdict(
            jbase.reduced_shape(jbase.LM_SHAPES[k]))
    assert set(LM_ARCHS) <= set(list_archs())
    assert get_config("graphsage-reddit").family == "gnn"


def _ref_spec_paths(cfg):
    flat = jax.tree_util.tree_flatten_with_path(
        jtr.model_specs(cfg, MESH), is_leaf=lambda x: isinstance(x, jprm.Spec))[0]
    return {".".join(str(k.key) for k in path): s for path, s in flat}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_and_counts_equal_the_reference_at_full_width(arch):
    """Every leaf by dotted path: shape, init and scale; and count_params
    (arithmetic on the specs, nothing allocated)."""
    j = _ref_spec_paths(jget_config(arch))
    p = dict(spec_leaves(tr.model_specs(get_config(arch))))
    assert list(p) == list(j)
    for k, s in p.items():
        assert (s.shape, s.init, s.scale) == (j[k].shape, j[k].init,
                                              j[k].scale), k
        assert str(s.dtype).split(".")[-1] == str(jnp.dtype(j[k].dtype)), k
    assert count_params(tr.model_specs(get_config(arch))) == \
        jprm.count_params(jtr.model_specs(jget_config(arch), MESH))


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 3, 5, 64, scale=3.0), _rand(rng, 64)
    jx, jw = jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype)
    want = jlayers.rms_norm(jx, jw, 1e-5)
    got = layers.rms_norm(_t(_np(jx)).to(getattr(torch, dtype)),
                          _t(_np(jw)).to(getattr(torch, dtype)), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    tol = FP32 if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    _close(got, want, **tol)


@pytest.mark.parametrize("name", ["silu", "relu", "relu2", "gelu"])
def test_activations(name):
    x = _rand(np.random.default_rng(1), 257, scale=4.0)
    _close(layers.activation(name)(_t(x)),
           jlayers.activation(name)(jnp.asarray(x)))
    with pytest.raises(ValueError):
        layers.activation("tanh")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu_glu", "relu2"])
def test_ffn_apply(act, dtype):
    rng = np.random.default_rng(2)
    d, f = 32, 48
    names = ("gate", "up", "down") if act == "silu_glu" else ("in", "out")
    p = {n: _rand(rng, *((f, d) if n in ("down", "out") else (d, f)),
                  scale=d ** -0.5) for n in names}
    x = _rand(rng, 2, 7, d)
    jp = {k: jnp.asarray(v).astype(dtype) for k, v in p.items()}
    tp = {k: _t(_np(v)).to(getattr(torch, dtype)) for k, v in jp.items()}
    jx = jnp.asarray(x).astype(dtype)
    got = layers.ffn_apply(tp, _t(_np(jx)).to(getattr(torch, dtype)), act)
    tol = FP32 if dtype == "float32" else dict(rtol=2 ** -6, atol=2 ** -5)
    _close(got, jlayers.ffn_apply(jp, jx, act), **tol)


@pytest.mark.parametrize("heads", [False, True])
def test_apply_rope(heads):
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 9, 3, 16) if heads else _rand(rng, 2, 9, 16)
    pos = rng.integers(0, 40000, (2, 9)).astype(np.int32)
    for theta in (10000.0, 500000.0):
        _close(attn.apply_rope(_t(x), _t(pos), theta),
               jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    _close(attn.rope_freqs(16, 10000.0), jattn.rope_freqs(16, 10000.0))


# ---------------------------------------------------------- flash attention
FLASH = [  # (sq, skv, q_chunk, kv_chunk, causal, q_offset)
    (16, 16, 4, 4, True, 0),      # tiles above the diagonal wholly masked
    (16, 16, 16, 16, True, 0),    # one tile
    (16, 16, 8, 4, False, 0),
    (8, 24, 4, 8, True, 16),      # q_offset > 0: the last 8 rows of 24
    (8, 16, 8, 4, True, 3),
    (8, 16, 4, 4, True, -6),      # rows with no valid key: zeros
    (12, 12, 512, 1024, True, 0),  # the defaults, clipped to the lengths
]


@pytest.mark.parametrize("case", FLASH)
def test_flash_attention(case, monkeypatch):
    sq, skv, qc, kc, causal, off = case
    rng = np.random.default_rng(4)
    q, k = _rand(rng, 2, sq, 3, 8, scale=2.0), _rand(rng, 2, skv, 3, 8)
    v = _rand(rng, 2, skv, 3, 6)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, q_chunk=qc,
                                 kv_chunk=kc, q_offset=off)
    for tile in (attn.TILE_BYTES, 1):     # every q chunk its own group
        monkeypatch.setattr(attn, "TILE_BYTES", tile)
        got = attn.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                   q_chunk=qc, kv_chunk=kc, q_offset=off)
        assert got.shape == (2, sq, 3, 6)
        assert torch.isfinite(got).all()
        _close(got, want)
    if off < 0:
        assert not got[:, :-off].any()
    with pytest.raises(ValueError):
        attn.flash_attention(_t(q), _t(k), _t(v), q_chunk=5, kv_chunk=kc)


def test_flash_attention_bf16_rounds_p_before_pv():
    """bf16 inputs: fp32 scores of exact products, p cast to bf16 before
    the PV product, as the reference does."""
    rng = np.random.default_rng(5)
    q, k, v = (jnp.asarray(_rand(rng, 1, 32, 2, 16)).astype(jnp.bfloat16)
               for _ in range(3))
    want = jattn.flash_attention(q, k, v, q_chunk=8, kv_chunk=16)
    got = attn.flash_attention(*(_t(_np(a)).bfloat16() for a in (q, k, v)),
                               q_chunk=8, kv_chunk=16)
    assert got.dtype == torch.bfloat16
    _close(got, want, rtol=2 ** -7, atol=2 ** -7)


# ---------------------------------------------------------------- GQA / MLA
def _layer_params(jcfg, pcfg, seed=0):
    """One dense layer's attention params of both packages."""
    jp = jprm.initialize(jtr.layer_specs(jcfg, MESH, "dense", jnp.float32),
                         jax.random.PRNGKey(seed))["attn"]
    return jp, {k: _t(_np(v)) for k, v in jp.items()}


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v3-671b"])
def test_attention_prefill(arch):
    jcfg, pcfg = _cfgs(arch)
    jp, pp = _layer_params(jcfg, pcfg)
    x = _rand(np.random.default_rng(6), 2, 16, jcfg.d_model)
    jfn, pfn = ((jattn.mla_prefill, attn.mla_prefill) if arch != "llama3.2-3b"
                else (jattn.gqa_prefill, attn.gqa_prefill))
    jout, jcache = jfn(jp, jnp.asarray(x), jcfg)
    pout, pcache = pfn(pp, _t(x), pcfg)
    _close(pout, jout)
    for a, b in zip(pcache, jcache):
        _close(a, b)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v3-671b"])
@pytest.mark.parametrize("pos", [0, 5, 11, 12, -1])
def test_attention_decode_writes_the_cache_in_place(arch, pos):
    """pos 0, mid-cache, S - 1, S (no write) and -1 (no write, zeros)."""
    jcfg, pcfg = _cfgs(arch)
    jp, pp = _layer_params(jcfg, pcfg, seed=1)
    rng = np.random.default_rng(7)
    b, S = 2, 12
    x = _rand(rng, b, 1, jcfg.d_model)
    if jcfg.attn_type == "mla":
        m = jcfg.mla
        cache = (_rand(rng, b, S, m.kv_lora_rank),
                 _rand(rng, b, S, m.qk_rope_head_dim))
        jfn, pfn = jattn.mla_decode, attn.mla_decode
    else:
        shape = (b, S, jcfg.n_kv_heads, jcfg.head_dim)
        cache = (_rand(rng, *shape), _rand(rng, *shape))
        jfn, pfn = jattn.gqa_decode, attn.gqa_decode
    jout, jcache = jfn(jp, jnp.asarray(x), tuple(map(jnp.asarray, cache)),
                       jnp.asarray(pos, jnp.int32), jcfg, MESH, DP, TP)
    pc = tuple(_t(c) for c in cache)
    pout, pcache = pfn(pp, _t(x), pc, pos, pcfg)
    assert all(a is b for a, b in zip(pcache, pc))       # in place
    _close(pout, jout)
    for a, b, c in zip(pcache, jcache, cache):
        _close(a, b)
        if not 0 <= pos < S:
            np.testing.assert_array_equal(a.numpy(), c)
    if pos < 0 and jcfg.attn_type != "mla":
        assert not pout.any()


# ---------------------------------------------------------------------- MoE
def _moe_params(jcfg, seed, tie=False):
    jp = jprm.initialize(jmoe.moe_specs(jcfg, MESH, DP, TP, jnp.float32),
                         jax.random.PRNGKey(seed))
    if tie:     # a zero router: every probability 1/E, top-k all ties
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    return jp, {k: _t(_np(v)) for k, v in jp.items()}


@pytest.mark.parametrize("arch,tie", [("granite-moe-1b-a400m", False),
                                      ("deepseek-v3-671b", False),
                                      ("deepseek-v3-671b", True)])
def test_moe_apply_with_aux_and_shared_expert(arch, tie):
    jcfg, pcfg = _cfgs(arch)
    jp, pp = _moe_params(jcfg, 2, tie)
    x = _rand(np.random.default_rng(8), 3, 5, jcfg.d_model)
    jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, MESH, DP, TP)
    stats = {}
    pout, paux = moe.moe_apply(pp, _t(x), pcfg, stats)
    _close(pout, jout)
    _close(paux, jaux)
    assert len(stats["experts_hit"]) == 1
    if tie:     # every token picks experts 0 .. k-1
        assert stats["experts_hit"] == [jcfg.moe.top_k]
    assert ("sh_gate" in pp) == bool(jcfg.moe.n_shared_experts)


def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1],
                      [0.25, 0.25, 0.25, 0.25, 0.0, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    pv, pi = moe.top_k(_t(probs), 3)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert pi.tolist() == [[1, 2, 4], [0, 1, 2]]


# -------------------------------------------------------- embedding, stream
def test_embed_tokens_gives_zero_rows_outside_the_vocab():
    jcfg, pcfg = _cfgs("llama3.2-3b")
    rng = np.random.default_rng(9)
    emb = _rand(rng, jcfg.vocab, jcfg.d_model)
    toks = np.array([[0, 5, -1, jcfg.vocab, jcfg.vocab - 1, 10 ** 6,
                      -10 ** 6]], np.int32)
    want = jtr.embed_tokens({"embed": jnp.asarray(emb)}, jnp.asarray(toks),
                            jcfg, MESH)
    got = tr.embed_tokens({"embed": _t(emb)}, _t(toks), pcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[0, [2, 3, 5, 6]].any()
    np.testing.assert_array_equal(got[0, 4].numpy(), emb[-1])


def test_lm_batches_equal_the_reference():
    for arch in ("llama3.2-3b", "granite-moe-1b-a400m"):
        cfg = get_config(arch)
        for a, b in zip(synth.lm_batches(cfg, 3, 64, 2, seed=5),
                        jsynth.lm_batches(jget_config(arch), 3, 64, 2,
                                          seed=5)):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype == np.int32
