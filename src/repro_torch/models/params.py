"""Parameter initialization (the port of ``repro.models.params.initialize``).

Weights are normal * 1/sqrt(fan_in) and biases zero, as in the reference.
The numbers come from an explicit ``torch.Generator`` and differ from the
reference's JAX PRNG draws; tests carry the reference's weights across with
``repro_torch.models.dlrm.params_from_numpy`` instead.
"""
from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def initialize(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``module`` in place, in registration order:
    biases (``*_b``) with zeros, the rest with normal(0, 1/sqrt(fan_in))
    drawn on the generator's device."""
    for name, p in module.named_parameters():
        if name.endswith("_b"):
            p.zero_()
            continue
        fan_in = p.shape[-2] if p.dim() >= 2 else max(p.shape[-1], 1)
        draw = torch.randn(p.shape, generator=generator,
                           device=generator.device)
        p.copy_(draw / math.sqrt(fan_in))
    return module
