"""LM transformer (dense and MoE, GQA and MLA): ``repro.models.transformer``
on one card -- the train step, prefill and KV-cache decode.

The parameter tree is the reference's: nested dicts under its names, the
layers of a kind stacked on a leading axis (``dense_layers.attn.wq`` is
(n_dense, d, H * h), ``moe_layers.moe.w_gate`` (n_moe, E, d, f)), so
:func:`params_from_numpy` carries the reference's tree across leaf for
leaf.  Layers run as a Python loop over index views of the stacks, where
the reference scans.  On one card:

* the vocab-parallel embedding is a lookup in which an id outside
  ``[0, V)`` embeds to a zero row (no clamp, no device assert);
* the padded vocab is the vocab (tp = 1), so no logit column is masked;
* the sharding constraints are identities and the reference's
  ``ffn_apply_sharded`` is :func:`ffn_apply`;
* :func:`decode_step` writes the new token into the given cache tensors
  and returns them (the reference returns a new cache of equal values;
  llama's at batch 8 and 32,768 positions is 30 GB);
* the vocab-parallel cross-entropy is one shard's: fp32 logits, a max
  shift that carries no gradient, ``logsumexp - gold``;
* :func:`make_train_step` takes the gradients with ``torch.autograd.grad``
  over the tree's leaves and updates the parameters in place (the
  optimizers' rule).  The reference's remat policies are
  ``torch.utils.checkpoint`` around each layer: ``"full"`` saves nothing
  inside a layer, ``"dots"`` saves the outputs of its plain matmuls
  (``aten.mm``: the reference's dots without batch dims), ``"none"``
  checkpoints nothing.  They compute one function and differ in memory.

``prefill_step`` keeps no cache, as the reference's does not.  Entry
points run where the parameters live: the card, unless they were made
with ``device="cpu"``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import LMConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import ffn_apply, rms_norm
from repro_torch.models.params import Spec, initialize_specs, spec_leaves

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def cfg_dtype(cfg: LMConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def _ffn_act(cfg: LMConfig) -> str:
    return "relu2" if cfg.activation == "relu2" else "silu_glu"


def layer_specs(cfg: LMConfig, kind: str, dtype) -> dict:
    """One layer of a kind ("dense" or "moe").  The reference's serving
    form differs from this one only in its shardings."""
    d = cfg.d_model
    a = (attn.mla_specs(cfg, dtype) if cfg.attn_type == "mla"
         else attn.gqa_specs(cfg, dtype))
    specs: Dict[str, Any] = {
        "attn": a,
        "attn_norm": Spec((d,), dtype, init="ones"),
        "ffn_norm": Spec((d,), dtype, init="ones"),
    }
    if kind == "moe":
        specs["moe"] = moe_mod.moe_specs(cfg, dtype)
    elif _ffn_act(cfg) == "silu_glu":
        f = cfg.d_ff
        specs["ffn"] = {"gate": Spec((d, f), dtype), "up": Spec((d, f), dtype),
                        "down": Spec((f, d), dtype)}
    else:
        specs["ffn"] = {"in": Spec((d, cfg.d_ff), dtype),
                        "out": Spec((cfg.d_ff, d), dtype)}
    return specs


def _stack_specs(specs, n: int):
    """A leading (n,) layer axis on every Spec leaf."""
    if isinstance(specs, Spec):
        return Spec((n,) + specs.shape, specs.dtype, specs.init, specs.scale)
    return {k: _stack_specs(v, n) for k, v in specs.items()}


def padded_vocab(cfg: LMConfig) -> int:
    """The reference pads the vocab to a tp multiple; tp = 1 here."""
    return cfg.vocab


def _layer_split(cfg: LMConfig) -> Tuple[int, int]:
    if cfg.moe is None:
        return cfg.n_layers, 0
    nd = cfg.moe.first_dense_layers
    return nd, cfg.n_layers - nd


def model_specs(cfg: LMConfig, dtype=None) -> dict:
    """The whole tree: embed, head, final norm, the layer stacks and, for
    deepseek-v3, the MTP block (built as the reference builds it; serving
    never reads it)."""
    dtype = dtype or cfg_dtype(cfg)
    d, V = cfg.d_model, padded_vocab(cfg)
    n_dense, n_moe = _layer_split(cfg)
    specs: Dict[str, Any] = {
        "embed": Spec((V, d), dtype, init="embed", scale=0.02),
        "head": Spec((d, V), dtype),
        "final_norm": Spec((d,), dtype, init="ones"),
    }
    if n_dense:
        specs["dense_layers"] = _stack_specs(
            layer_specs(cfg, "dense", dtype), n_dense)
    if n_moe:
        specs["moe_layers"] = _stack_specs(
            layer_specs(cfg, "moe", dtype), n_moe)
    if cfg.mtp_depth:
        specs["mtp"] = _stack_specs({
            "proj": Spec((2 * d, d), dtype),
            "norm_prev": Spec((d,), dtype, init="ones"),
            "norm_emb": Spec((d,), dtype, init="ones"),
            "block": layer_specs(cfg, "moe" if cfg.moe else "dense", dtype),
        }, cfg.mtp_depth)
    return specs


def init_params(cfg: LMConfig, seed: int = 0, device: DeviceLike = None,
                dtype=None) -> dict:
    """Random weights by the specs, drawn from ``seed`` on the device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return initialize_specs(model_specs(cfg, dtype), gen)


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")           # a writable copy
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, cfg: LMConfig, device: DeviceLike = None,
                      dtype=None) -> dict:
    """The reference's parameter tree (nested dicts of numpy leaves; bf16
    leaves as ``ml_dtypes.bfloat16``) -> the port's, each leaf cast to
    its spec's dtype.  Strict: the dotted paths and the shapes must be
    :func:`model_specs`' exactly."""
    dev = resolve_device(device)
    specs = dict(spec_leaves(model_specs(cfg, dtype)))
    leaves = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
        else:
            leaves[prefix] = node
    walk(tree, "")
    if leaves.keys() != specs.keys():
        raise KeyError(f"missing {sorted(specs.keys() - leaves.keys())}, "
                       f"unexpected {sorted(leaves.keys() - specs.keys())}")
    out: Dict[str, Any] = {}
    for path, s in specs.items():
        a = np.asarray(leaves[path])
        if tuple(a.shape) != s.shape:
            raise ValueError(f"{path}: shape {a.shape} != {s.shape}")
        node = out
        *heads, last = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = _to_torch(a).to(device=dev, dtype=s.dtype)
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer(stack: dict, i: int) -> dict:
    """Layer ``i``'s parameters: index views of the stacked leaves."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stack.items()}


def _layer_fwd(p: dict, x: torch.Tensor, cfg: LMConfig, kind: str
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block, prefill form.  Returns (x, aux loss)."""
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, _ = attn.mla_prefill(p["attn"], h, cfg)
    else:
        a, _ = attn.gqa_prefill(p["attn"], h, cfg)
    x = x + a
    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if kind == "moe":
        f, aux = moe_mod.moe_apply(p["moe"], h, cfg)
    else:
        f = ffn_apply(p["ffn"], h, _ffn_act(cfg))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + f, aux


def _stacks(cfg: LMConfig):
    """(params key, kind, first layer, layer count) of each stack."""
    n_dense, n_moe = _layer_split(cfg)
    return [s for s in (("dense_layers", "dense", 0, n_dense),
                        ("moe_layers", "moe", n_dense, n_moe)) if s[3]]


def _tokens(params: dict, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params["embed"].device)


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: LMConfig
                 ) -> torch.Tensor:
    """(b, s) ids -> (b, s, d) rows; an id outside [0, V) gives zeros."""
    emb = params["embed"]
    V = emb.shape[0]
    owned = (tokens >= 0) & (tokens < V)
    # a gather whose backward sorts the ids and sums each row's in a fixed
    # order (``embedding_dense_backward``): a zipfian token stream repeats
    # bit for bit
    rows = F.embedding(tokens.clamp(0, V - 1), emb)
    return torch.where(owned[..., None], rows, torch.zeros_like(rows))


def lm_logits(params: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    return x @ params["head"]


REMAT = ("none", "dots", "full")
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _run_layer(lp: dict, x: torch.Tensor, cfg: LMConfig, kind: str,
               remat: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block under the remat policy (no checkpoint without
    gradients)."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} not in {REMAT}")
    if remat == "none" or not torch.is_grad_enabled():
        return _layer_fwd(lp, x, cfg, kind)
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)
    return checkpoint(_layer_fwd, lp, x, cfg, kind, use_reentrant=False,
                      **kw)


def _unstack(stack: dict, n: int) -> List[dict]:
    """The ``n`` layers of a stack as views (``unbind``: under autograd
    one backward node stacks the layers' gradients once)."""
    cols = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
            for k, v in stack.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def forward(params: dict, tokens, cfg: LMConfig, remat: str = "dots"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (b, s) -> hidden (b, s, d) and the summed MoE aux loss."""
    tokens = _tokens(params, tokens)
    x = embed_tokens(params, tokens, cfg).to(cfg_dtype(cfg))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for key, kind, _, n in _stacks(cfg):
        for lp in _unstack(params[key], n):
            x, a = _run_layer(lp, x, cfg, kind, remat)
            aux = aux + a
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


@torch.no_grad()
def prefill_step(params: dict, tokens, cfg: LMConfig) -> torch.Tensor:
    """The prompt's forward; the last token's logits (b, 1, V).  No cache
    is kept, as in the reference."""
    x, _ = forward(params, tokens, cfg)
    return lm_logits(params, x[:, -1:], cfg)


# ---------------------------------------------------------------------------
# Losses / steps
# ---------------------------------------------------------------------------


def _xent_vocab_parallel(logits: torch.Tensor, labels: torch.Tensor
                         ) -> torch.Tensor:
    """Mean cross-entropy in fp32 over one vocab shard (all of it): the
    max shift carries no gradient (it cancels in ``logsumexp - gold``); a
    label outside ``[0, V)`` scores ``gold`` = 0, as the reference's
    ``owned`` mask gives."""
    lg = logits.float()
    V = lg.shape[-1]
    m = lg.detach().amax(-1)
    se = torch.exp(lg - m[..., None]).sum(-1)
    labels = labels.long()
    owned = (labels >= 0) & (labels < V)
    picked = lg.gather(-1, labels.clamp(0, V - 1)[..., None])[..., 0]
    gold = torch.where(owned, picked, torch.zeros_like(picked))
    return (torch.log(se) + m - gold).mean()


def loss_fn(params: dict, tokens, labels, cfg: LMConfig,
            remat: str = "dots") -> torch.Tensor:
    """The cross-entropy, plus the MTP loss when ``cfg.mtp_depth``, plus
    the summed MoE aux loss."""
    tokens = _tokens(params, tokens)
    labels = _tokens(params, labels)
    x, aux = forward(params, tokens, cfg, remat=remat)
    loss = _xent_vocab_parallel(lm_logits(params, x, cfg), labels)
    if cfg.mtp_depth:
        loss = loss + _mtp_loss(params, x, tokens, labels, cfg)
    return loss + aux


def _mtp_step(mp: dict, hprev: torch.Tensor, emb: torch.Tensor,
              cfg: LMConfig, kind: str) -> torch.Tensor:
    comb = torch.cat([rms_norm(hprev, mp["norm_prev"], cfg.norm_eps),
                      rms_norm(emb, mp["norm_emb"], cfg.norm_eps)], dim=-1)
    hk, _ = _layer_fwd(mp["block"], comb @ mp["proj"], cfg, kind)
    return hk


def _mtp_loss(params: dict, h: torch.Tensor, tokens: torch.Tensor,
              labels: torch.Tensor, cfg: LMConfig, weight: float = 0.3
              ) -> torch.Tensor:
    """DeepSeek-V3 multi-token prediction, exactly as the reference
    computes it: every depth rolls ``tokens`` by one (not by depth + 1),
    the MTP block's aux loss is dropped, and only the last depth's hidden
    state is scored, against ``labels`` rolled (wrapping) by
    ``mtp_depth``.  Each depth is recomputed in the backward, as the
    reference's ``nothing_saveable`` body is."""
    kind = "moe" if cfg.moe is not None else "dense"
    hk = h
    for mp in _unstack(params["mtp"], cfg.mtp_depth):
        emb = embed_tokens(params, torch.roll(tokens, -1, dims=1),
                           cfg).to(hk.dtype)
        hk = checkpoint(_mtp_step, mp, hk, emb, cfg, kind,
                        use_reentrant=False)
    lab_k = torch.roll(labels, -cfg.mtp_depth, dims=1)
    return weight * _xent_vocab_parallel(lm_logits(params, hk, cfg), lab_k)


def tree_leaves(tree, prefix: str = ""):
    """``(dotted path, tensor)`` of a nested dict, in insertion order."""
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from tree_leaves(v, path)
        else:
            yield path, v


def _tree(paths, leaves) -> dict:
    out: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        *heads, last = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out


def make_train_step(cfg: LMConfig, optimizer, remat: str = "dots",
                    accum: Optional[int] = None):
    """``(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"})``, parameters and optimizer state updated in place.

    ``accum`` (default ``cfg.train_accum``) > 1 splits the batch into
    that many microbatches of consecutive rows; their gradients sum in
    the parameter dtype (bf16 for every LM config), the losses in fp32,
    and the sums are divided by ``accum`` (the gradients cast back).
    ``grad_norm`` is taken in fp32 over the final gradients."""
    accum = accum if accum is not None else cfg.train_accum
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} not in {REMAT}")

    def grad_of(paths, leaves, tokens, labels):
        alias = [p.detach().requires_grad_() for p in leaves]
        loss = loss_fn(_tree(paths, alias), tokens, labels, cfg,
                       remat=remat)
        grads = torch.autograd.grad(loss, alias, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for g, p in zip(grads, leaves)]

    def step(params, opt_state, batch):
        paths, leaves = zip(*tree_leaves(params))
        tokens = _tokens(params, batch["tokens"])
        labels = _tokens(params, batch["labels"])
        if accum <= 1:
            loss, grads = grad_of(paths, leaves, tokens, labels)
        else:
            B = tokens.shape[0]
            if B % accum:
                raise ValueError(f"batch {B} does not split into {accum} "
                                 "microbatches")
            mb = B // accum
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            grads = [torch.zeros_like(p) for p in leaves]
            for i in range(accum):
                rows = slice(i * mb, (i + 1) * mb)
                l, g = grad_of(paths, leaves, tokens[rows], labels[rows])
                loss = loss + l
                for a, gi in zip(grads, g):
                    a.add_(gi.to(a.dtype))
                del g
            loss = loss / accum
            grads = [(g / accum).to(p.dtype) for g, p in zip(grads, leaves)]
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in grads))
        optimizer.update(_tree(paths, grads), opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}
    return step


# ---------------------------------------------------------------------------
# Decode with the KV cache
# ---------------------------------------------------------------------------


def cache_specs(cfg: LMConfig, batch: int, seq: int, dtype=None
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each cache tensor, ``seq`` positions."""
    dtype = dtype or cfg_dtype(cfg)
    n = cfg.n_layers
    if cfg.attn_type == "mla":
        m = cfg.mla
        return {"ckv": ((n, batch, seq, m.kv_lora_rank), dtype),
                "kr": ((n, batch, seq, m.qk_rope_head_dim), dtype)}
    K, h = cfg.n_kv_heads, cfg.head_dim
    return {"k": ((n, batch, seq, K, h), dtype),
            "v": ((n, batch, seq, K, h), dtype)}


def init_cache(cfg: LMConfig, batch: int, seq: int,
               device: DeviceLike = None, dtype=None
               ) -> Dict[str, torch.Tensor]:
    """The zero cache, on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=dev)
            for k, (shape, dt) in cache_specs(cfg, batch, seq, dtype).items()}


def _decode_layer(lp: dict, x: torch.Tensor, layer_cache: Tuple, pos: int,
                  cfg: LMConfig, kind: str, stats: Optional[dict]
                  ) -> torch.Tensor:
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, _ = attn.mla_decode(lp["attn"], h, layer_cache, pos, cfg)
    else:
        a, _ = attn.gqa_decode(lp["attn"], h, layer_cache, pos, cfg)
    x = x + a.to(x.dtype)
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    if kind == "moe":
        f, _ = moe_mod.moe_apply(lp["moe"], h, cfg, stats)
    else:
        f = ffn_apply(lp["ffn"], h, _ffn_act(cfg))
    return x + f.to(x.dtype)


@torch.no_grad()
def decode_step(params: dict, cache: Dict[str, torch.Tensor], tokens,
                pos: int, cfg: LMConfig, stats: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: tokens (b, 1) at position ``pos`` (one scalar for
    the batch) -> (logits (b, 1, V), cache), the cache written in place.
    ``stats`` is :func:`moe.moe_apply`'s."""
    tokens = _tokens(params, tokens)
    pos = int(pos)
    x = embed_tokens(params, tokens, cfg).to(cfg_dtype(cfg))
    keys = list(cache)
    for key, kind, first, n in _stacks(cfg):
        for i in range(n):
            layer_cache = tuple(cache[c][first + i] for c in keys)
            x = _decode_layer(_layer(params[key], i), x, layer_cache, pos,
                              cfg, kind, stats)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params, x, cfg), cache


def make_decode_step(cfg: LMConfig):
    def step(params, cache, batch):
        return decode_step(params, cache, batch["tokens"], batch["pos"], cfg)
    return step
