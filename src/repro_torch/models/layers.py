"""Common layers: the plain MLP tower of the recsys / DLRM models."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


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
