"""Common layers: the plain MLP tower of the recsys / DLRM models, the
low-rank cross network of DLRM-DCNv2, and the LM family's RMS norm,
activations and FFN (functions over param dicts, as in
``repro.models.layers``).  The reference's ``ffn_apply_sharded`` (the
Megatron-SP FFN in a ``shard_map``) computes :func:`ffn_apply`'s function
on one card, so it has no port."""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """In fp32, cast back to ``x``'s dtype."""
    x32 = x.float()
    x32 = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * w.float()).to(x.dtype)


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(torch.relu(x))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


_ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu, "relu": torch.relu, "relu2": _relu2, "gelu": _gelu}


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name not in _ACTIVATIONS:
        raise ValueError(name)
    return _ACTIVATIONS[name]


def ffn_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, act: str
              ) -> torch.Tensor:
    """Gated (``silu_glu``: gate / up / down) or plain (``in`` / ``out``)
    FFN, plain matmuls in the weights' dtype."""
    if act == "silu_glu":
        return (F.silu(x @ p["gate"]) * (x @ p["up"])) @ p["down"]
    return activation(act)(x @ p["in"]) @ p["out"]


class MLP(nn.Module):
    """dims = (in, h1, ..., out).  Layer i computes ``x @ w_i + b_i`` with
    ``w_i`` stored (in, out) as the reference stores it; ReLU follows every
    layer but the last, and the last too with ``final_act``.  Parameters
    are named ``layer{i}_w`` / ``layer{i}_b`` like the reference's tree
    (``repro.models.layers.mlp_specs``), so weights carry across verbatim."""

    def __init__(self, dims: Sequence[int], final_act: bool = False,
                 device=None):
        super().__init__()
        self.n_layers = len(dims) - 1
        self.final_act = final_act
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.register_parameter(
                f"layer{i}_w", nn.Parameter(torch.empty(a, b, device=device)))
            self.register_parameter(
                f"layer{i}_b", nn.Parameter(torch.zeros(b, device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = x @ getattr(self, f"layer{i}_w") + getattr(self, f"layer{i}_b")
            if i < self.n_layers - 1 or self.final_act:
                x = torch.relu(x)
        return x


class LowRankCross(nn.Module):
    """DCN-V2's low-rank cross network (arXiv:2008.13535 section 3, as
    torchrec's ``LowRankCrossNet``): ``n_layers`` layers
    ``x_{l+1} = x0 * (x_l @ v_l @ w_l + b_l) + x_l`` on a ``d``-wide x0,
    ``v_l`` (d, rank) with no bias, ``w_l`` (rank, d) and ``b_l`` (d,),
    stored (in, out) as :class:`MLP`'s weights and named ``layer{i}_v`` /
    ``layer{i}_w`` / ``layer{i}_b``."""

    def __init__(self, d: int, rank: int, n_layers: int, device=None):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.register_parameter(
                f"layer{i}_v", nn.Parameter(torch.empty(d, rank,
                                                        device=device)))
            self.register_parameter(
                f"layer{i}_w", nn.Parameter(torch.empty(rank, d,
                                                        device=device)))
            self.register_parameter(
                f"layer{i}_b", nn.Parameter(torch.zeros(d, device=device)))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for i in range(self.n_layers):
            h = x @ getattr(self, f"layer{i}_v") @ getattr(self, f"layer{i}_w")
            x = x0 * (h + getattr(self, f"layer{i}_b")) + x
        return x
