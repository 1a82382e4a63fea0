"""Optimizers over dicts of tensors (the port of
``repro.optim.optimizers``).

Each is an ``Optimizer(init, update)``: ``init(params)`` builds the state
from a dict ``{name: tensor}`` (nested dicts too, such as the embedding
tiers ``{"cold", "hot"}``), and ``update(grads, state, params)`` writes
the new parameters and state into the same tensors, in place under
``torch.no_grad()``, and returns ``(params, state)``.  In place because
the embedding tiers are the engine's live tensors (RMC4's fp32 cold tier
is 5.6 GB): a functional update would hold two copies on the card.

The arithmetic is the reference's, in its order (``repro/optim/
optimizers.py:27-118``), so a step on the same gradients gives the same
values: adam's bias corrections come from a float32 ``step`` and the
update is ``(m / bc1) / (sqrt(v / bc2) + eps)``.

  * ``adam`` -- configurable state dtype and decoupled weight decay.
  * ``adagrad`` -- DLRM-convention dense/embedding optimizer.
  * ``rowwise_adagrad`` -- one accumulator per embedding *row* (the
    FBGEMM/TorchRec trick): state (rows, 1) instead of (rows, dim).
  * ``adafactor`` -- factored second moments, no first moment: the LM
    family's optimizer.

A tree is a nest of dicts and lists (the GNN's ``{"layers": [...]}``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)


def _leaves(tree: Any, prefix: str = ""):
    """(path, tensor) pairs of a nest of dicts and lists, in insertion
    order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _at(tree: Any, path: str) -> Any:
    for k in path.split("/") if path else ():
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def adam(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
         eps: float = 1e-8, weight_decay: float = 0.0,
         state_dtype: torch.dtype = torch.float32,
         rowwise_keys: tuple = ()) -> Optimizer:
    """``rowwise_keys`` is accepted and unused, as in the reference."""
    def init(params):
        def mk(p):
            return {"m": torch.zeros(p.shape, dtype=state_dtype,
                                     device=p.device),
                    "v": torch.zeros(p.shape, dtype=state_dtype,
                                     device=p.device)}
        dev = next(p for _, p in _leaves(params)).device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "mv": _map(mk, params)}

    @torch.no_grad()
    def update(grads, state, params):
        state["step"] += 1
        t = state["step"].to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                           device=t.device), t)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                           device=t.device), t)
        for path, g in _leaves(grads):
            mv, p = _at(state["mv"], path), _at(params, path)
            g32 = g.to(torch.float32)
            m = b1 * mv["m"].to(torch.float32) + (1 - b1) * g32
            v = b2 * mv["v"].to(torch.float32) + (1 - b2) * g32 * g32
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr * upd)
            mv["m"].copy_(m)
            mv["v"].copy_(v)
        return params, state

    return Optimizer(init, update)


def adagrad(lr: float = 1e-2, eps: float = 1e-10) -> Optimizer:
    def init(params):
        return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)

    @torch.no_grad()
    def update(grads, state, params):
        for path, g in _leaves(grads):
            acc, p = _at(state, path), _at(params, path)
            g32 = g.to(torch.float32)
            acc.add_(g32 * g32)
            p.copy_(p.to(torch.float32) - lr * g32 / (torch.sqrt(acc) + eps))
        return params, state

    return Optimizer(init, update)


def rowwise_adagrad(lr: float = 1e-2, eps: float = 1e-10,
                    min_dim_for_rowwise: int = 2) -> Optimizer:
    """Row-wise accumulators for >=2D params (embedding tables), scalar-wise
    adagrad otherwise.  The update is dense over the table, as the
    reference's (its gradient of a gather is a dense table): every row is
    read and written, a row with a zero gradient keeping its value."""
    def _rowwise(p):
        return p.dim() >= min_dim_for_rowwise

    def init(params):
        def mk(p):
            shape = (p.shape[:1] + (1,) * (p.dim() - 1) if _rowwise(p)
                     else p.shape)
            return torch.zeros(shape, dtype=torch.float32, device=p.device)
        return _map(mk, params)

    @torch.no_grad()
    def update(grads, state, params):
        for path, g in _leaves(grads):
            acc, p = _at(state, path), _at(params, path)
            g32 = g.to(torch.float32)
            if _rowwise(p):
                acc.add_(torch.mean(g32 * g32, dim=tuple(range(1, p.dim())),
                                    keepdim=True))
            else:
                acc.add_(g32 * g32)
            p.copy_(p.to(torch.float32) - lr * g32 / (torch.sqrt(acc) + eps))
        return params, state

    return Optimizer(init, update)


def adafactor(lr: float = 1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, min_dim_factored: int = 128
              ) -> Optimizer:
    """Adafactor (Shazeer & Stern) without first moment.  A leaf whose two
    trailing dims are both >= ``min_dim_factored`` keeps its second moment
    as the factors ``vr`` (the leaf's shape without its last dim) and
    ``vc`` (without its second to last); any other keeps a full ``v``.
    ``beta = 1 - t^-decay``; the relative update is clipped to RMS <=
    ``clip_threshold`` over the whole leaf.  The fp32 temporaries are one
    leaf's at a time."""
    def _factored(p) -> bool:
        return (p.dim() >= 2 and p.shape[-1] >= min_dim_factored
                and p.shape[-2] >= min_dim_factored)

    def init(params):
        def mk(p):
            z = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        dev = next(p for _, p in _leaves(params)).device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "v": _map(mk, params)}

    @torch.no_grad()
    def update(grads, state, params):
        state["step"] += 1
        beta = 1.0 - torch.pow(state["step"].to(torch.float32), -decay)
        for path, g in _leaves(grads):
            v, p = _at(state["v"], path), _at(params, path)
            u = g.to(torch.float32, copy=True)
            g2 = u * u + eps
            if _factored(p):
                v["vr"].copy_(beta * v["vr"] + (1 - beta) * g2.mean(-1))
                v["vc"].copy_(beta * v["vc"] + (1 - beta) * g2.mean(-2))
                del g2
                vr = v["vr"]
                denom = (vr[..., None] / vr.mean(-1, keepdim=True).clamp_min(
                    eps)[..., None]) * v["vc"][..., None, :]
                u.mul_(denom.clamp_min_(eps).rsqrt_())
            else:
                v["v"].copy_(beta * v["v"] + (1 - beta) * g2)
                del g2
                u.mul_(v["v"].clamp_min(eps).rsqrt_())
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u.div_(torch.clamp_min(rms / clip_threshold, 1.0))
            p.copy_(p.to(torch.float32) - lr * u)
        return params, state

    return Optimizer(init, update)


_OPTIMIZERS: Dict[str, Callable[..., Optimizer]] = {
    "adam": adam, "adagrad": adagrad, "adafactor": adafactor,
    "rowwise_adagrad": rowwise_adagrad}


def get_optimizer(name: str, **kw) -> Optimizer:
    """By the reference's names."""
    return _OPTIMIZERS[name](**kw)
