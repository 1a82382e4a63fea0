"""Gradient compression for data-parallel reduction (the port of
``repro.optim.compression``).

bf16: halves DP collective bytes.  int8: 4x, with per-tensor scale and
error feedback (residual carried to the next step) so compression error
does not accumulate [Seide et al. 2014; 1-bit SGD lineage].

Data-parallel members are emulated on one card, as tp shards are:
:func:`compressed_psum` takes one gradient dict per member and sums them
in member order (the order of the reference's psum on its CPU mesh).  The
sum of int8 codes in float32 is exact, and the reference's ``pmax`` of the
members' scales is their max.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.optim.optimizers import _leaves, _map


def init_error_feedback(params) -> Any:
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def compress(g: torch.Tensor, method: str
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    if method == "none":
        return g, None
    if method == "bf16":
        return g.to(torch.bfloat16), None
    if method == "int8":
        scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return q, scale
    raise ValueError(method)


def decompress(q: torch.Tensor, scale: Optional[torch.Tensor], method: str,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if method == "none":
        return q
    if method == "bf16":
        return q.to(dtype)
    if method == "int8":
        return q.to(dtype) * scale
    raise ValueError(method)


def _member_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def compressed_psum(member_grads: Sequence[Any], method: str = "none",
                    error_fb: Optional[Sequence[Any]] = None
                    ) -> Tuple[Any, Optional[List[Any]]]:
    """Sum one gradient dict per data-parallel member, in member order,
    with optional compression + error feedback (``error_fb``: one dict per
    member, or None).

    Returns ``(reduced_grads, new_error_fb)``: the reduced dict every
    member would hold after the reference's psum, and each member's new
    residual (the ``error_fb`` passed in for 'none', ``None`` leaves for
    'bf16', as the reference returns)."""
    M = len(member_grads)
    paths = [p for p, _ in _leaves(member_grads[0])]
    flat_g = [dict(_leaves(g)) for g in member_grads]
    if method == "none":
        red = {p: _member_sum([flat_g[m][p] for m in range(M)])
               for p in paths}
        return _unflatten(red, member_grads[0]), error_fb
    flat_e = ([dict(_leaves(e)) for e in error_fb] if error_fb is not None
              else [None] * M)
    red, new_e = {}, [{} for _ in range(M)]
    for p in paths:
        g32 = [flat_g[m][p].to(torch.float32)
               + (flat_e[m][p] if flat_e[m] is not None else 0.0)
               for m in range(M)]
        qs = [compress(g, method) for g in g32]
        if method == "int8":
            total = _member_sum([q.to(torch.float32) for q, _ in qs])
            # scales differ per member: reduce with max for a conservative
            # bound
            scale = torch.stack([s for _, s in qs]).amax()
            r = total * scale
            for m in range(M):
                new_e[m][p] = g32[m] - decompress(qs[m][0], scale, method)
        else:
            r = _member_sum([q for q, _ in qs]).to(torch.float32)
            for m in range(M):
                new_e[m][p] = None
        red[p] = r.to(flat_g[0][p].dtype)
    return (_unflatten(red, member_grads[0]),
            [_unflatten(e, member_grads[0]) for e in new_e])


def _unflatten(flat: dict, like: Any, prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(flat, v, f"{prefix}{k}/")
                for k, v in like.items()}
    return flat[prefix[:-1]]
