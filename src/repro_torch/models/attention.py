"""Attention of the LM family: GQA and MLA (DeepSeek-V3), the port of
``repro.models.attention`` on one card (the reference's (1, 1) mesh).

* :func:`flash_attention` is the reference's chunked online softmax for
  prefill and training, in plain PyTorch: fp32 running max, sum and
  accumulator, the two ``isinf`` guards, ``p`` cast to ``v``'s dtype
  before the PV product, the division by ``max(l, 1e-30)``.  Each query
  row walks the kv chunks in order, as there; several q chunks share one
  tile, and a tile in which every key follows every row of the tile (a
  causal tile wholly masked) is skipped, which leaves ``m``, ``l`` and
  ``acc`` exactly as the reference's pass over it does (``p`` = 0,
  ``corr`` = 1 or 0).  Under autograd its backward walks the same tiles
  and recomputes them, where the reference differentiates its scan with
  every kv step under ``jax.checkpoint(nothing_saveable)``.
* Decode scores the new token against the whole cache, masked past
  ``pos``; the reference's per-shard partials and their ``pmax`` /
  ``psum`` are one shard's on one card.  MLA decode is the absorbed form:
  scores and the reduction in the ``kv_lora_rank``-wide latent space.
  The caches are written in place: a position outside ``[0, S)`` writes
  nothing, a negative one scores nothing and gives zeros.
* Every product the reference asks in fp32 (``preferred_element_type``,
  or ``.astype(float32)`` of the cache) upcasts its operands: exact
  products of bf16 values, fp32 sums, TF32 off (``device.resolve_device``).
  A bf16 ``torch.matmul`` would round its result to bf16, another
  function.  Plain projections (``x @ w``) stay ``torch.matmul`` in the
  weights' dtype.

The reference's ``seq_parallel_attention`` never runs on a (1, 1) mesh
(every head layout divides tp = 1) and has no port.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import Spec

F32 = torch.float32
NEG_INF = float("-inf")
# fp32 scores of one flash tile: q chunks share a tile up to this size
TILE_BYTES = 1 << 30


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A contiguous fp32 copy (``t`` itself when it already is one)."""
    return t.to(F32, memory_format=torch.contiguous_format)


def _pos(pos: int, device) -> torch.Tensor:
    return torch.full((1, 1), pos, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=F32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotate-half RoPE in fp32, cast back.  x: (..., s, heads?, dim) with
    pos (..., s) broadcastable."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = pos[..., None].to(F32) * freqs
    while angles.dim() < x.dim():
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked online-softmax attention (prefill)
# ---------------------------------------------------------------------------


def _groups(b: int, H: int, sq: int, q_chunk: int, kv_chunk: int):
    """The q row groups ``(g0, g1)`` that share one fp32 score tile."""
    rows = max(1, TILE_BYTES // (4 * b * H * q_chunk * kv_chunk)) * q_chunk
    return [(g0, min(sq, g0 + rows)) for g0 in range(0, sq, rows)]


def _tiles(g0: int, g1: int, skv: int, kv_chunk: int, causal: bool,
           q_offset: int):
    """``(k0, k1, a)`` for each kv tile the rows ``[g0, g1)`` walk, in
    order: ``a`` is the first row with a valid key in the tile (the rows
    before it, and every row in the later tiles, see only masked keys
    there, a pass that changes nothing)."""
    for k0 in range(0, skv, kv_chunk):
        a = max(g0, k0 - q_offset) if causal else g0
        if a >= g1:
            return
        yield k0, k0 + kv_chunk, a


def _scores(qf, kf, a, g1, k0, k1, scale, causal, q_offset):
    """The scaled fp32 scores of rows ``[a, g1)`` against keys ``[k0,
    k1)``, causally masked to -inf."""
    s = torch.matmul(qf[:, :, a:g1], kf[:, :, k0:k1].transpose(-1, -2))
    s.mul_(scale)
    if causal and a + q_offset < k1 - 1:            # crosses the diagonal
        dev = s.device
        qpos = q_offset + torch.arange(a, g1, device=dev)
        s.masked_fill_(qpos[:, None] < torch.arange(k0, k1, device=dev),
                       NEG_INF)
    return s


def _flash_fwd(q, k, v, causal, q_chunk, kv_chunk, scale, q_offset):
    """The online softmax: out (b, H, sq, dv) fp32 and each row's ``m +
    log l`` (b, H, sq), +inf for a row with no valid key."""
    b, sq, H, _ = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    dev = q.device
    qf = _f32(q.transpose(1, 2))                    # (b, H, sq, h)
    kf = _f32(k.transpose(1, 2))                    # (b, H, skv, h)
    vf = _f32(v.transpose(1, 2))                    # (b, H, skv, dv)
    out = torch.empty(b, H, sq, dv, dtype=F32, device=dev)
    lse = torch.empty(b, H, sq, dtype=F32, device=dev)
    for g0, g1 in _groups(b, H, sq, q_chunk, kv_chunk):
        m = torch.full((b, H, g1 - g0), NEG_INF, dtype=F32, device=dev)
        l = torch.zeros((b, H, g1 - g0), dtype=F32, device=dev)
        acc = torch.zeros((b, H, g1 - g0, dv), dtype=F32, device=dev)
        for k0, k1, a in _tiles(g0, g1, skv, kv_chunk, causal, q_offset):
            n0 = a - g0
            s = _scores(qf, kf, a, g1, k0, k1, scale, causal, q_offset)
            m_old = m[:, :, n0:]
            m_new = torch.maximum(m_old, s.amax(-1))
            dead = torch.isinf(m_new)               # guard fully-masked rows
            m_safe = m_new.masked_fill(dead, 0.0)
            p = s.sub_(m_safe[..., None]).exp_()
            p.masked_fill_(dead[..., None], 0.0)
            corr = torch.exp(m_old - m_safe).masked_fill_(
                torch.isinf(m_old), 0.0)
            l[:, :, n0:] = l[:, :, n0:] * corr + p.sum(-1)
            acc[:, :, n0:] = acc[:, :, n0:] * corr[..., None] + torch.matmul(
                p.to(v.dtype).to(F32), vf[:, :, k0:k1])
            m[:, :, n0:] = m_new
            del s, p
        out[:, :, g0:g1] = acc / l.clamp_min(1e-30)[..., None]
        lse[:, :, g0:g1] = torch.where(l > 0, m + torch.log(l),
                                       float("inf"))
    return out, lse


def _flash_bwd(q, k, v, out, lse, dout, causal, q_chunk, kv_chunk, scale,
               q_offset):
    """The gradients of :func:`_flash_fwd`'s output, walking its tiles
    and recomputing each tile's scores and probabilities ``p = exp(s -
    lse)`` (no tile is kept from the forward): ``dV += p^T dO`` with ``p``
    rounded to ``v``'s dtype as the forward's PV product is, ``dS = p (dO
    V^T - rowsum(dO O))``, ``dQ += scale dS K``, ``dK += scale dS^T Q``.
    A row with no valid key has ``lse`` +inf, so ``p`` = 0 and it takes
    no gradient.  Returns fp32 (b, H, s, .) tensors."""
    b, sq, H, _ = q.shape
    skv = k.shape[1]
    qf, kf, vf = (_f32(t.transpose(1, 2)) for t in (q, k, v))
    do = _f32(dout.transpose(1, 2))                 # (b, H, sq, dv)
    delta = (do * _f32(out.transpose(1, 2))).sum(-1)
    dq, dk, dv = (torch.zeros_like(t) for t in (qf, kf, vf))
    for g0, g1 in _groups(b, H, sq, q_chunk, kv_chunk):
        for k0, k1, a in _tiles(g0, g1, skv, kv_chunk, causal, q_offset):
            p = _scores(qf, kf, a, g1, k0, k1, scale, causal, q_offset)
            p = p.sub_(lse[:, :, a:g1, None]).exp_()
            dv[:, :, k0:k1] += torch.matmul(
                p.to(v.dtype).to(F32).transpose(-1, -2), do[:, :, a:g1])
            ds = torch.matmul(do[:, :, a:g1], vf[:, :, k0:k1].transpose(-1, -2))
            ds = ds.sub_(delta[:, :, a:g1, None]).mul_(p).mul_(scale)
            del p
            dq[:, :, a:g1] += torch.matmul(ds, kf[:, :, k0:k1])
            dk[:, :, k0:k1] += torch.matmul(ds.transpose(-1, -2),
                                            qf[:, :, a:g1])
            del ds
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with its tiled backward
    (:func:`_flash_bwd`): the forward keeps the output and each row's
    ``m + log l``, never a score tile, as the reference's chunk scan
    keeps none under ``jax.checkpoint(nothing_saveable)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, kv_chunk, scale, q_offset):
        out, lse = _flash_fwd(q, k, v, causal, q_chunk, kv_chunk, scale,
                              q_offset)
        out = out.to(q.dtype).transpose(1, 2)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_chunk, kv_chunk, scale, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.args)
        return (dq.transpose(1, 2).to(q.dtype),
                dk.transpose(1, 2).to(k.dtype),
                dv.transpose(1, 2).to(v.dtype),
                None, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 1024, scale=None, q_offset: int = 0
                    ) -> torch.Tensor:
    """q: (b, sq, H, h); k: (b, skv, H, h); v: (b, skv, H, dv) (GQA callers
    repeat kv to H heads first).  Returns (b, sq, H, dv) in q's dtype;
    differentiable through :class:`_FlashAttention`, whose backward walks
    the tiles again."""
    sq, h = q.shape[1], q.shape[3]
    skv = k.shape[1]
    scale = scale if scale is not None else h ** -0.5
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, skv)
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"chunks ({q_chunk}, {kv_chunk}) do not divide "
                         f"the lengths ({sq}, {skv})")
    return _FlashAttention.apply(q, k, v, causal, q_chunk, kv_chunk, scale,
                                 q_offset)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def gqa_specs(cfg: LMConfig, dtype) -> Dict[str, Spec]:
    d, H, K, h = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": Spec((d, H * h), dtype), "wk": Spec((d, K * h), dtype),
            "wv": Spec((d, K * h), dtype), "wo": Spec((H * h, d), dtype)}


def gqa_prefill(p: dict, x: torch.Tensor, cfg: LMConfig
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x: (b, s, d) -> (out, (k, v)), k and v (b, s, K, h) after RoPE."""
    b, s, _ = x.shape
    H, K, h = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // K
    pos = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    q = apply_rope((x @ p["wq"]).reshape(b, s, H, h), pos, cfg.rope_theta)
    k = apply_rope((x @ p["wk"]).reshape(b, s, K, h), pos, cfg.rope_theta)
    v = (x @ p["wv"]).reshape(b, s, K, h)
    out = flash_attention(q, k.repeat_interleave(G, dim=2),
                          v.repeat_interleave(G, dim=2))
    return out.reshape(b, s, H * h) @ p["wo"], (k, v)


def _masked_softmax_parts(s: torch.Tensor, pos: int):
    """The reference's decode softmax over the cache axis (last) of fp32
    scores: keys past ``pos`` masked, ``(pexp, l)``."""
    valid = torch.arange(s.shape[-1], device=s.device) <= pos
    s.masked_fill_(~valid, NEG_INF)
    m = s.amax(-1)
    m_safe = m.masked_fill(torch.isinf(m), 0.0)
    pexp = s.sub_(m_safe[..., None]).exp_().masked_fill_(~valid, 0.0)
    return pexp, pexp.sum(-1)


def gqa_decode_core(q: torch.Tensor, k_c: torch.Tensor, v_c: torch.Tensor,
                    pos: int, scale: float) -> torch.Tensor:
    """q: (b, K, G, h); k_c / v_c: (b, S, K, h); keys at positions <= pos.
    Returns (b, K, G, h) in fp32."""
    # each upcast keeps h innermost, a coalesced copy; the product takes
    # the key transposed
    kf = _f32(k_c.permute(0, 2, 1, 3))                          # (b,K,S,h)
    s = torch.matmul(q.float(), kf.transpose(-1, -2))           # (b,K,G,S)
    del kf
    pexp, l = _masked_softmax_parts(s.mul_(scale), pos)
    num = torch.matmul(pexp, _f32(v_c.permute(0, 2, 1, 3)))
    return num / l.clamp_min(1e-30)[..., None]


def gqa_decode(p: dict, x: torch.Tensor,
               cache: Tuple[torch.Tensor, torch.Tensor], pos: int,
               cfg: LMConfig
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x: (b, 1, d); cache k / v: (b, S, K, h), the new token written at
    ``pos`` in place.  Returns (out in fp32, cache)."""
    b = x.shape[0]
    H, K, h = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    k_c, v_c = cache
    pt = _pos(pos, x.device)
    q = apply_rope((x @ p["wq"]).reshape(b, 1, H, h), pt,
                   cfg.rope_theta).reshape(b, K, H // K, h)
    k_new = apply_rope((x @ p["wk"]).reshape(b, 1, K, h), pt,
                       cfg.rope_theta)[:, 0]
    v_new = (x @ p["wv"]).reshape(b, K, h)
    if 0 <= pos < k_c.shape[1]:
        k_c[:, pos] = k_new.to(k_c.dtype)
        v_c[:, pos] = v_new.to(v_c.dtype)
    out = gqa_decode_core(q, k_c, v_c, pos, h ** -0.5)
    # the reference's fp32 output times the bf16 wo promotes to fp32
    return out.reshape(b, 1, H * h) @ p["wo"].float(), (k_c, v_c)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------


def mla_specs(cfg: LMConfig, dtype) -> Dict[str, Spec]:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wdq": Spec((d, m.q_lora_rank), dtype),
        "q_norm": Spec((m.q_lora_rank,), dtype, init="ones"),
        "wuq": Spec((m.q_lora_rank, H * qd), dtype),
        "wdkv": Spec((d, m.kv_lora_rank), dtype),
        "kv_norm": Spec((m.kv_lora_rank,), dtype, init="ones"),
        "wukv": Spec((m.kv_lora_rank,
                      H * (m.qk_nope_head_dim + m.v_head_dim)), dtype),
        "wkr": Spec((d, m.qk_rope_head_dim), dtype),
        "wo": Spec((H * m.v_head_dim, d), dtype),
    }


def _mla_qkv(p: dict, x: torch.Tensor, cfg: LMConfig, pos: torch.Tensor):
    m = cfg.mla
    b, s, _ = x.shape
    cq = rms_norm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wuq"]).reshape(b, s, cfg.n_heads,
                                m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    ckv = rms_norm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)  # (b, s, r)
    k_rope = apply_rope((x @ p["wkr"])[:, :, None, :], pos,
                        cfg.rope_theta)[:, :, 0]               # (b, s, dr)
    return q_nope, q_rope, ckv, k_rope


def mla_prefill(p: dict, x: torch.Tensor, cfg: LMConfig
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (out, (ckv, k_rope)), the latent cache's two parts."""
    m = cfg.mla
    b, s, _ = x.shape
    H = cfg.n_heads
    pos = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, x, cfg, pos)
    kv = (ckv @ p["wukv"]).reshape(b, s, H, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], -1)
    # the shared rope key folded into every head (flat-head layout)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, H, m.qk_rope_head_dim)], dim=-1)
    out = flash_attention(
        q, k, v, scale=(m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5)
    return out.reshape(b, s, H * m.v_head_dim) @ p["wo"], (ckv, k_rope)


def mla_decode_core(q_abs: torch.Tensor, q_rope: torch.Tensor,
                    ckv_c: torch.Tensor, kr_c: torch.Tensor, pos: int,
                    scale: float) -> torch.Tensor:
    """q_abs: (b, H, r) fp32, q_rope: (b, H, dr); ckv_c: (b, S, r), kr_c:
    (b, S, dr).  Returns the latent output (b, H, r) in fp32."""
    ckv = _f32(ckv_c)
    s = (torch.matmul(q_abs, ckv.transpose(1, 2))
         + torch.matmul(q_rope.float(), _f32(kr_c).transpose(1, 2)))
    pexp, l = _masked_softmax_parts(s.mul_(scale), pos)
    return torch.matmul(pexp, ckv) / l.clamp_min(1e-30)[..., None]


def mla_decode(p: dict, x: torch.Tensor,
               cache: Tuple[torch.Tensor, torch.Tensor], pos: int,
               cfg: LMConfig
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Absorbed MLA decode: W_uk folds into the query, W_uv into the
    output.  cache: ckv (b, S, r) and k_rope (b, S, dr), written in
    place."""
    m = cfg.mla
    b, H = x.shape[0], cfg.n_heads
    ckv_c, kr_c = cache
    q_nope, q_rope, ckv_new, kr_new = _mla_qkv(p, x, cfg,
                                               _pos(pos, x.device))
    wukv = p["wukv"].reshape(m.kv_lora_rank, H,
                             m.qk_nope_head_dim + m.v_head_dim)
    wuk = wukv[:, :, :m.qk_nope_head_dim]               # (r, H, nope)
    wuv = wukv[:, :, m.qk_nope_head_dim:]               # (r, H, dv)
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(), wuk.float())
    if 0 <= pos < ckv_c.shape[1]:
        ckv_c[:, pos] = ckv_new[:, 0].to(ckv_c.dtype)
        kr_c[:, pos] = kr_new[:, 0].to(kr_c.dtype)
    out_lat = mla_decode_core(
        q_abs, q_rope[:, 0], ckv_c, kr_c, pos,
        (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5)
    out = torch.einsum("bhr,rhv->bhv", out_lat, wuv.float()).to(x.dtype)
    return out.reshape(b, 1, H * m.v_head_dim) @ p["wo"], (ckv_c, kr_c)
