"""Routed MoE of the LM family, the port of ``repro.models.moe`` on one card.

On the reference's (1, 1) mesh ep_size = tp_size = 1: the dispatch and
return ``all_to_all``s and the ``all_gather`` are identities, every
flat (token, expert) copy goes to destination 0, so the first stable
``argsort`` is the identity, and the capacity ``ceil(n * k * 1.25)``
drops no token.  What is left is computed here as there: fp32 router
softmax, top-k with ties to the lower expert id, gates renormalized, the
GShard aux loss, copies sorted by expert (stably), a grouped GEMM (one
``torch.matmul`` per expert over its contiguous rows, where the reference
has ``jax.lax.ragged_dot``), the gate cast to the activation dtype before
its multiply, and each token's k contributions summed in slot order.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.models.params import Spec


def moe_specs(cfg: LMConfig, dtype) -> Dict[str, Spec]:
    moe = cfg.moe
    d, f, E = cfg.d_model, moe.d_ff_expert, moe.n_experts
    specs = {
        "router": Spec((d, E), torch.float32, scale=0.02),
        "w_gate": Spec((E, d, f), dtype),
        "w_up": Spec((E, d, f), dtype),
        "w_down": Spec((E, f, d), dtype),
    }
    if moe.n_shared_experts:
        fs = f * moe.n_shared_experts
        specs.update({"sh_gate": Spec((d, fs), dtype),
                      "sh_up": Spec((d, fs), dtype),
                      "sh_down": Spec((fs, d), dtype)})
    return specs


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: equal values in ascending
    index order (a stable descending sort; ``torch.topk`` promises no
    order among ties on CUDA)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p: dict, x: torch.Tensor, cfg: LMConfig,
              stats: Optional[dict] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (out, aux loss).  ``stats``, when given, gets the
    number of experts that received rows appended to its
    ``"experts_hit"`` list."""
    out, aux = _moe_block(x, p["router"], p["w_gate"], p["w_up"],
                          p["w_down"], cfg, stats)
    if cfg.moe.n_shared_experts:
        sh = F.silu(x @ p["sh_gate"]) * (x @ p["sh_up"])
        out = out + sh @ p["sh_down"]
    return out, aux


def _moe_block(x, wr, w_gate, w_up, w_down, cfg: LMConfig,
               stats: Optional[dict]) -> Tuple[torch.Tensor, torch.Tensor]:
    moe = cfg.moe
    E, k = moe.n_experts, moe.top_k
    b, s, d = x.shape
    n = b * s
    tokens = x.reshape(n, d)

    # ---- routing ----
    probs = torch.softmax(tokens.float() @ wr, dim=-1)          # (n, E)
    gate, eids = top_k(probs, k)                                # (n, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    # aux load-balance loss (GShard): E * sum_e f_e * p_e
    fe = torch.bincount(eids.reshape(-1), minlength=E).float() / (n * k)
    aux = E * (probs.mean(0) * fe).sum() * moe.router_aux_weight

    # ---- grouped GEMM over the copies sorted by expert ----
    # slot j = t * k + i is token t's i-th choice.  The reference also
    # carries cap - n * k empty slots (zero rows through expert 0, never
    # read back); they are skipped here.
    flat = eids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=E).tolist()   # the host's loop
    if stats is not None:
        stats.setdefault("experts_hit", []).append(
            sum(c > 0 for c in counts))
    xs = tokens[order // k]
    ys = torch.empty_like(xs)
    start = 0
    for e, c in enumerate(counts):
        if c:
            xe = xs[start:start + c]
            h = F.silu(xe @ w_gate[e]) * (xe @ w_up[e])
            ys[start:start + c] = h.to(x.dtype) @ w_down[e]
        start += c
    y = torch.empty_like(ys)
    y[order] = ys                                         # slot order

    # ---- combine: gate-weight, then each token's k slots in order ----
    res = (y * gate.reshape(-1).to(y.dtype)[:, None]).view(n, k, d)
    out = res[:, 0]
    for i in range(1, k):
        out = out + res[:, i]
    return out.reshape(b, s, d).to(x.dtype), aux
