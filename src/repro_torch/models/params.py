"""Parameter initialization (the port of ``repro.models.params.initialize``).

The reference's ``Spec(init=, scale=)`` leaves become a rule on the
parameter's name (:func:`init_rule`): layer-norm gains ``ln*_g`` ones;
every bias (``*_b``, ``ffn_b1``/``ffn_b2``, a cross layer's ``b``) zeros;
``pos_emb`` normal * 0.02; the rest normal * 1/sqrt(fan_in).  The numbers
come from an explicit ``torch.Generator`` and differ from the reference's
JAX PRNG draws; tests carry the reference's weights across with the
models' ``params_from_numpy`` instead.
"""
from __future__ import annotations

import math
import re
from typing import Callable

import torch
from torch import nn

_BIAS = re.compile(r"(_b|_b\d+|^b)$")


def init_rule(name: str) -> str:
    """'ones', 'zeros', 'pos' (normal * 0.02) or 'normal' (1/sqrt(fan_in))
    for the dotted parameter name ``name``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf.startswith("ln") and leaf.endswith("_g"):
        return "ones"
    if _BIAS.search(leaf):
        return "zeros"
    if leaf == "pos_emb":
        return "pos"
    return "normal"


@torch.no_grad()
def initialize(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``module`` in place, in registration order,
    by :func:`init_rule`, normals drawn on the generator's device.  Ones
    and zeros draw nothing, so a DLRM's draws are those of weights alone."""
    for name, p in module.named_parameters():
        rule = init_rule(name)
        if rule == "ones":
            p.fill_(1.0)
            continue
        if rule == "zeros":
            p.zero_()
            continue
        draw = torch.randn(p.shape, generator=generator,
                           device=generator.device)
        if rule == "pos":
            p.copy_(draw * 0.02)
            continue
        fan_in = p.shape[-2] if p.dim() >= 2 else max(p.shape[-1], 1)
        p.copy_(draw / math.sqrt(fan_in))
    return module


INT8_NOT_DIFFERENTIABLE = (
    "the int8 cold tier is serving-only: the int8 store is not "
    "differentiable -- train with storage='fp32'")


def joint_train_step(model: nn.Module, engine, loss_of: Callable,
                     optimizer, emb_optimizer) -> Callable:
    """The reference's joint train step (``make_train_step`` of
    ``repro.models.dlrm`` and ``recsys``) over ``loss_of(state, batch)``:
    the loss and the gradients of the model's parameters and of
    ``state.cold`` / ``state.hot``, then ``optimizer`` on the parameters
    and ``emb_optimizer`` on ``{"cold", "hot"}``.

    ``step(state, opt_state, emb_opt_state, batch) -> (state, opt_state,
    emb_opt_state, {"loss": loss})``.  Everything is updated in place:
    the model's parameters, both tiers (as ``apply_deltas`` writes them)
    and the optimizer states.  The tiers require a gradient only inside
    the step, so the engine's in-place writes and the serve steps work
    on a trained state.  An int8 engine raises ``TypeError``, as the
    reference's gradient of an int8 leaf does."""
    if engine.quantized:
        raise TypeError(INT8_NOT_DIFFERENTIABLE)
    params = dict(model.named_parameters())

    def step(state, opt_state, emb_opt_state, batch):
        tiers = {"cold": state.cold, "hot": state.hot}
        leaves = list(params.values()) + [tiers["cold"], tiers["hot"]]
        for t in tiers.values():
            t.requires_grad_(True)
        try:
            loss = loss_of(state, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for t in tiers.values():
                t.requires_grad_(False)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, leaves)]
        optimizer.update(dict(zip(params, grads)), opt_state, params)
        emb_optimizer.update({"cold": grads[-2], "hot": grads[-1]},
                             emb_opt_state, tiers)
        return state, opt_state, emb_opt_state, {"loss": loss.detach()}
    return step
