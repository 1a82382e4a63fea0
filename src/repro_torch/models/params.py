"""Parameter initialization (the port of ``repro.models.params``).

DLRM and recsys: the reference's ``Spec(init=, scale=)`` leaves become a
rule on the parameter's name (:func:`init_rule`): layer-norm gains ``ln*_g``
ones; every bias (``*_b``, ``ffn_b1``/``ffn_b2``, a cross layer's ``b``)
zeros; ``pos_emb`` normal * 0.02; the rest normal * 1/sqrt(fan_in).

LM: the reference's declarative tree of :class:`Spec` leaves (shape,
dtype, init, scale; its ``pspec`` has no use on one card), with
:func:`count_params`, :func:`initialize_specs` and, for a dry-run,
:func:`abstract`.

The numbers come from an explicit ``torch.Generator`` and differ from the
reference's JAX PRNG draws; tests carry the reference's weights across
with the models' ``params_from_numpy`` instead.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device

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


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"           # "normal" | "zeros" | "ones" | "embed"
    scale: Optional[float] = None  # None => 1/sqrt(fan_in)


def spec_leaves(tree, prefix: str = ""):
    """``(dotted path, Spec)`` for every leaf of a nested dict, keys
    sorted at each level (the order ``jax.tree`` flattens a dict in)."""
    if isinstance(tree, Spec):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from spec_leaves(tree[k], f"{prefix}.{k}" if prefix else k)


def count_params(tree) -> int:
    return sum(math.prod(s.shape) for _, s in spec_leaves(tree))


def abstract(tree, device=None):
    """The reference's ``abstract``: an empty tensor of each Spec's shape
    and dtype on ``device`` (default: the card), in the tree's structure
    (dicts and lists).  Nothing is drawn; under the caller's
    ``FakeTensorMode`` the leaves are fake and nothing is allocated."""
    dev = resolve_device(device)

    def build(node):
        if isinstance(node, Spec):
            return torch.empty(node.shape, dtype=node.dtype, device=dev)
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return {k: build(v) for k, v in node.items()}
    return build(tree)


# elements drawn per call: a (256, 7168, 2048) expert stack is drawn in
# fp32 slices of 256 MB into its bf16 leaf, never whole (15 GB)
_DRAW_CHUNK = 1 << 26


@torch.no_grad()
def initialize_specs(tree, generator: torch.Generator) -> Dict[str, Any]:
    """Materialize a Spec tree on the generator's device, as the
    reference's ``initialize``: ``zeros``, ``ones``, else a standard
    normal drawn in fp32, times ``scale`` (or 1/sqrt(shape[-2]), the
    fan-in), cast to the leaf's dtype."""
    dev = generator.device

    def build(node):
        if not isinstance(node, Spec):
            return {k: build(v) for k, v in node.items()}
        if node.init == "zeros":
            return torch.zeros(node.shape, dtype=node.dtype, device=dev)
        if node.init == "ones":
            return torch.ones(node.shape, dtype=node.dtype, device=dev)
        fan_in = (node.shape[-2] if len(node.shape) >= 2
                  else max(node.shape[-1], 1))
        scale = node.scale if node.scale is not None else fan_in ** -0.5
        out = torch.empty(node.shape, dtype=node.dtype, device=dev)
        flat = out.view(-1)
        for i in range(0, flat.numel(), _DRAW_CHUNK):
            n = min(_DRAW_CHUNK, flat.numel() - i)
            flat[i:i + n] = torch.randn(n, generator=generator, device=dev,
                                        dtype=torch.float32) * scale
        return out
    return build(tree)


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
