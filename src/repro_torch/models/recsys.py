"""Recsys architectures: SASRec, AutoInt, DCN-v2, BST (serving half).

The port of ``repro.models.recsys``'s serving path.  Every sparse-feature
lookup goes through the ``PIFSEmbeddingEngine`` (tables stacked in one
address space, hot tier replicated, cold tier in ``n_shards`` shards on
one device); per-field / per-position embeddings are L = 1 bags: indices
(B, G, 1), no weights.  ``forward`` dispatches on ``cfg.interaction``:

  * "self-attn-seq"   (SASRec): causal self-attn over the item history;
                      a target scored by its dot with the last position.
  * "self-attn"       (AutoInt): multi-head attention over field embeddings,
                      residual via W_res, relu; stacked; logit from flatten.
  * "cross"           (DCN-v2): x_{l+1} = x0 * (W x_l + b) + x_l cross tower
                      in parallel with a deep MLP tower; stacked combine.
  * "transformer-seq" (BST): [history || target] through a transformer block,
                      concat with profile features, MLP tower -> CTR.

A batch holds ``seq (B, S)`` and ``target (B,)`` int32 for the sequence
models (BST also ``dense (B, n_dense)``), ``fields (B, F)`` int32 (and
``dense``) for the field models, on the model's device.  Parameters mirror
the reference's tree (``repro.models.recsys.model_specs``) by name, so
:func:`params_from_numpy` carries its weights across.

Attention is plain matmuls, the reference's -1e30 causal mask, softmax and
``/ sqrt(dh)``, as the reference computes it in jnp outside any kernel.
The reference's ``_constrain_full_batch`` (a sharding constraint for the
dense towers) has no counterpart: one card holds every shard.  Nor do its
lookup knobs ``dp_shard`` and ``block_l``: the port's lookup has neither.
Training (``sasrec_loss``, ``loss_fn``, ``make_train_step``) is not here.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import RecConfig
from repro_torch.core.pifs import PIFSEmbeddingEngine, engine_for_tables
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import MLP


# ---------------------------------------------------------------------------
# Engine construction and lookups
# ---------------------------------------------------------------------------


def build_engine(cfg: RecConfig, device: DeviceLike = None,
                 hot_fraction: float = 0.05, storage: str = "fp32",
                 dedup: str = "off", validate_ids: bool = False,
                 n_shards: int = 1
                 ) -> Tuple[PIFSEmbeddingEngine, np.ndarray]:
    """The engine over the config's tables (one per sparse field, or the
    item catalogue); ``storage='int8'`` selects the quantized cold tier.
    ``n_shards`` stands in for the reference's ``mesh``: the cold tier's
    shards, all on ``device``.  Returns the engine and the int64 table
    offsets (the engine checks that its address space fits int32)."""
    return engine_for_tables(list(cfg.vocab_sizes), cfg.embed_dim,
                             device=device, hot_fraction=hot_fraction,
                             storage=storage, dedup=dedup,
                             validate_ids=validate_ids, n_shards=n_shards)


def _seq_lookup(engine, state, ids: torch.Tensor, offset: int, mode: str,
                impl: str = "cuda", dedup: Optional[str] = None
                ) -> torch.Tensor:
    """(B, S) ids in table ``offset`` -> (B, S, D) per-position
    embeddings."""
    idx = (ids + offset)[..., None]          # (B, S, 1): one bag per position
    return engine.lookup(state, idx.to(torch.int32), mode=mode, impl=impl,
                         dedup=dedup)


def _field_lookup(engine, state, ids: torch.Tensor, offsets, mode: str,
                  impl: str = "cuda", dedup: Optional[str] = None
                  ) -> torch.Tensor:
    """(B, F) per-field ids -> (B, F, D).  ``offsets``: the tables'
    offsets, numpy or (no copy) an int32 tensor on the ids' device."""
    offs = torch.as_tensor(offsets, dtype=torch.int32, device=ids.device)
    idx = (ids + offs[None, :])[..., None]
    return engine.lookup(state, idx.to(torch.int32), mode=mode, impl=impl,
                         dedup=dedup)


# ---------------------------------------------------------------------------
# Parameters, mirroring the reference's tree
# ---------------------------------------------------------------------------


def _param(dev, *shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=dev))


class Attention(nn.Module):
    """``_mha_specs``: wq, wk, wv (d_in, d_attn), wo (d_attn, d_out)."""

    def __init__(self, d_in: int, d_attn: int, d_out: int, dev):
        super().__init__()
        self.wq = _param(dev, d_in, d_attn)
        self.wk = _param(dev, d_in, d_attn)
        self.wv = _param(dev, d_in, d_attn)
        self.wo = _param(dev, d_attn, d_out)


class Block(nn.Module):
    """A SASRec / BST transformer block: attention, two layer norms and an
    FFN of width ``d_ff``."""

    def __init__(self, d: int, d_ff: int, dev):
        super().__init__()
        self.attn = Attention(d, d, d, dev)
        self.ln1_g, self.ln1_b = _param(dev, d), _param(dev, d)
        self.ln2_g, self.ln2_b = _param(dev, d), _param(dev, d)
        self.ffn_w1, self.ffn_b1 = _param(dev, d, d_ff), _param(dev, d_ff)
        self.ffn_w2, self.ffn_b2 = _param(dev, d_ff, d), _param(dev, d)


class AutoIntLayer(nn.Module):
    def __init__(self, d: int, d_attn: int, dev):
        super().__init__()
        self.attn = Attention(d, d_attn, d, dev)
        self.w_res = _param(dev, d, d)


class Cross(nn.Module):
    def __init__(self, d: int, dev):
        super().__init__()
        self.w, self.b = _param(dev, d, d), _param(dev, d)


class RecModel(nn.Module):
    """The dense towers of one recsys arch; the embedding engine is passed
    to :meth:`forward`.  ``device`` defaults to the card (raises without
    CUDA; pass ``"cpu"`` for the CPU).  Parameters start uninitialized:
    fill them with ``models.params.initialize`` or load the reference's
    with :func:`params_from_numpy`."""

    def __init__(self, cfg: RecConfig, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d, it = cfg.embed_dim, cfg.interaction
        if it == "self-attn-seq":                     # SASRec
            self.pos_emb = _param(dev, cfg.seq_len, d)
            self.blocks = nn.ModuleList(Block(d, d, dev)
                                        for _ in range(cfg.n_blocks))
            self.ln_f_g, self.ln_f_b = _param(dev, d), _param(dev, d)
        elif it == "self-attn":                       # AutoInt
            self.layers = nn.ModuleList(
                AutoIntLayer(d, cfg.d_attn * cfg.n_heads, dev)
                for _ in range(cfg.n_attn_layers))
            self.head_w = _param(dev, cfg.n_sparse * d, 1)
            self.head_b = _param(dev, 1)
        elif it == "cross":                           # DCN-v2
            x0_dim = cfg.n_dense + cfg.n_sparse * d
            self.cross = nn.ModuleList(Cross(x0_dim, dev)
                                       for _ in range(cfg.n_cross_layers))
            self.deep = MLP((x0_dim,) + cfg.mlp_dims, final_act=True,
                            device=dev)
            self.head_w = _param(dev, x0_dim + cfg.mlp_dims[-1], 1)
            self.head_b = _param(dev, 1)
        elif it == "transformer-seq":                 # BST
            S = cfg.seq_len + 1                       # history + target
            self.pos_emb = _param(dev, S, d)
            self.blocks = nn.ModuleList(Block(d, 4 * d, dev)
                                        for _ in range(max(cfg.n_blocks, 1)))
            self.mlp = MLP((S * d + cfg.n_dense,) + cfg.mlp_dims + (1,),
                           device=dev)
        else:
            raise ValueError(f"unknown interaction {it!r}")

    def forward(self, engine: PIFSEmbeddingEngine, state,
                batch: Dict[str, torch.Tensor], offsets,
                mode: str = "pifs", impl: str = "cuda",
                dedup: Optional[str] = None) -> torch.Tensor:
        """CTR logits (B,); see :func:`forward`."""
        return forward(self, engine, state, batch, offsets, mode=mode,
                       impl=impl, dedup=dedup)


# ---------------------------------------------------------------------------
# Dense pieces
# ---------------------------------------------------------------------------


def _mha(p: Attention, x: torch.Tensor, n_heads: int, causal: bool,
         kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    b, s, _ = x.shape
    kv = x if kv is None else kv
    sk = kv.shape[1]
    dh = p.wq.shape[1] // n_heads
    q = (x @ p.wq).reshape(b, s, n_heads, dh).transpose(1, 2)
    k = (kv @ p.wk).reshape(b, sk, n_heads, dh).transpose(1, 2)
    v = (kv @ p.wv).reshape(b, sk, n_heads, dh).transpose(1, 2)
    sc = (q @ k.transpose(-1, -2)) / math.sqrt(dh)            # (b, h, s, sk)
    if causal:
        mask = torch.ones((s, sk), dtype=torch.bool,
                          device=x.device).tril_()
        sc = sc.masked_fill(~mask, -1e30)
    a = torch.softmax(sc, dim=-1)
    o = (a @ v).transpose(1, 2).reshape(b, s, n_heads * dh)
    return o @ p.wo


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
        eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _sasrec_block(bp: Block, x: torch.Tensor) -> torch.Tensor:
    h = _ln(x, bp.ln1_g, bp.ln1_b)
    x = x + _mha(bp.attn, h, n_heads=1, causal=True)
    h = _ln(x, bp.ln2_g, bp.ln2_b)
    f = torch.relu(h @ bp.ffn_w1 + bp.ffn_b1) @ bp.ffn_w2 + bp.ffn_b2
    return x + f


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def sasrec_encode(p: RecModel, engine, state, seq_ids: torch.Tensor,
                  mode: str = "pifs", impl: str = "cuda",
                  dedup: Optional[str] = None) -> torch.Tensor:
    """(B, S) history -> (B, S, D) causal representations."""
    x = _seq_lookup(engine, state, seq_ids, 0, mode, impl=impl,
                    dedup=dedup)                               # (B, S, D)
    x = x * math.sqrt(p.cfg.embed_dim) + p.pos_emb
    for bp in p.blocks:
        x = _sasrec_block(bp, x)
    return _ln(x, p.ln_f_g, p.ln_f_b)


def bst_forward(p: RecModel, engine, state, batch, mode: str = "pifs",
                impl: str = "cuda", dedup: Optional[str] = None
                ) -> torch.Tensor:
    """batch: seq (B, S), target (B,), dense (B, n_dense) -> CTR logit
    (B,)."""
    seq, target = batch["seq"], batch["target"]
    B = seq.shape[0]
    tokens = torch.cat([seq, target[:, None]], dim=1)         # (B, S+1)
    x = _seq_lookup(engine, state, tokens, 0, mode, impl=impl, dedup=dedup)
    x = x + p.pos_emb
    for bp in p.blocks:
        h = _ln(x, bp.ln1_g, bp.ln1_b)
        x = x + _mha(bp.attn, h, n_heads=p.cfg.n_heads, causal=False)
        h = _ln(x, bp.ln2_g, bp.ln2_b)
        f = (F.leaky_relu(h @ bp.ffn_w1 + bp.ffn_b1, 0.01)
             @ bp.ffn_w2 + bp.ffn_b2)
        x = x + f
    z = torch.cat([x.reshape(B, -1), batch["dense"]], dim=-1)
    return p.mlp(z)[:, 0]


def autoint_forward(p: RecModel, engine, state, batch, offsets,
                    mode: str = "pifs", impl: str = "cuda",
                    dedup: Optional[str] = None) -> torch.Tensor:
    x = _field_lookup(engine, state, batch["fields"], offsets, mode,
                      impl=impl, dedup=dedup)                  # (B, F, D)
    for lp in p.layers:
        x = torch.relu(_mha(lp.attn, x, p.cfg.n_heads, causal=False)
                       + x @ lp.w_res)
    B = x.shape[0]
    return (x.reshape(B, -1) @ p.head_w + p.head_b)[:, 0]


def dcnv2_forward(p: RecModel, engine, state, batch, offsets,
                  mode: str = "pifs", impl: str = "cuda",
                  dedup: Optional[str] = None) -> torch.Tensor:
    emb = _field_lookup(engine, state, batch["fields"], offsets, mode,
                        impl=impl, dedup=dedup)
    B = emb.shape[0]
    x0 = torch.cat([batch["dense"], emb.reshape(B, -1)], dim=-1)
    x = x0
    for cp in p.cross:
        x = x0 * (x @ cp.w + cp.b) + x
    z = torch.cat([x, p.deep(x0)], dim=-1)
    return (z @ p.head_w + p.head_b)[:, 0]


def forward(p: RecModel, engine, state, batch, offsets,
            mode: str = "pifs", impl: str = "cuda",
            dedup: Optional[str] = None) -> torch.Tensor:
    """CTR logits (B,) of ``p.cfg``'s arch.  ``mode`` is the engine's
    (pifs, pond or beacon); ``impl`` the lookup route ('cuda': the kernels
    on the card, the plain versions on CPU tensors; 'torch': the plain
    versions); ``dedup`` the gather-once knob (None = engine default)."""
    it = p.cfg.interaction
    if it == "self-attn":
        return autoint_forward(p, engine, state, batch, offsets, mode,
                               impl=impl, dedup=dedup)
    if it == "cross":
        return dcnv2_forward(p, engine, state, batch, offsets, mode,
                             impl=impl, dedup=dedup)
    if it == "transformer-seq":
        return bst_forward(p, engine, state, batch, mode, impl=impl,
                           dedup=dedup)
    if it == "self-attn-seq":
        # CTR-style scoring of a target against the sequence representation
        h = sasrec_encode(p, engine, state, batch["seq"], mode, impl=impl,
                          dedup=dedup)
        t = _seq_lookup(engine, state, batch["target"][:, None], 0, mode,
                        impl=impl, dedup=dedup)[:, 0]
        return torch.sum(h[:, -1] * t, dim=-1)
    raise ValueError(it)


# ---------------------------------------------------------------------------
# Retrieval: score a query against n_candidates explicit item ids
# ---------------------------------------------------------------------------


def retrieval_scores(p: RecModel, engine, state, batch, offsets,
                     mode: str = "pifs",
                     impl: str = "cuda") -> torch.Tensor:
    """batch: the model's query inputs (B = 1) + ``cand_ids`` (n_cand,).
    Sequential models score <user_repr, cand_emb>; CTR models tile the
    query and run a full forward per candidate (the candidate id replaces
    field 0, the item / ad field)."""
    cand = batch["cand_ids"]                                  # (n_cand,)
    n_cand = cand.shape[0]
    it = p.cfg.interaction
    if it == "self-attn-seq":
        h = sasrec_encode(p, engine, state, batch["seq"], mode, impl=impl)
        u = h[:, -1]                                          # (1, D)
        ce = _seq_lookup(engine, state, cand[:, None], 0, mode,
                         impl=impl)[:, 0]
        return ce @ u[0]
    if it == "transformer-seq":
        tiled = {"seq": batch["seq"].expand((n_cand,)
                                            + batch["seq"].shape[1:]),
                 "target": cand,
                 "dense": batch["dense"].expand((n_cand,)
                                                + batch["dense"].shape[1:])}
        return bst_forward(p, engine, state, tiled, mode, impl=impl)
    fields = batch["fields"].expand((n_cand,)
                                    + batch["fields"].shape[1:]).clone()
    fields[:, 0] = cand % p.cfg.vocab_sizes[0]
    tiled = {"fields": fields}
    if "dense" in batch:
        tiled["dense"] = batch["dense"].expand((n_cand,)
                                               + batch["dense"].shape[1:])
    return forward(p, engine, state, tiled, offsets, mode, impl=impl)


# ---------------------------------------------------------------------------
# Step factories
# ---------------------------------------------------------------------------


def _device_offsets(model: RecModel, offsets) -> torch.Tensor:
    """The table offsets as an int32 tensor on the model's device, once
    per step rather than once per lookup."""
    dev = next(model.parameters()).device
    return torch.as_tensor(np.asarray(offsets, np.int32), device=dev)


def make_serve_step(model: RecModel, engine: PIFSEmbeddingEngine,
                    offsets: np.ndarray, mode: str = "pifs",
                    impl: str = "cuda", dedup: Optional[str] = None):
    """``step(state, batch) -> (B,)`` click probabilities."""
    offsets = _device_offsets(model, offsets)

    @torch.inference_mode()
    def step(state, batch):
        return torch.sigmoid(forward(model, engine, state, batch, offsets,
                                     mode=mode, impl=impl, dedup=dedup))
    return step


def make_retrieval_step(model: RecModel, engine: PIFSEmbeddingEngine,
                        offsets: np.ndarray, mode: str = "pifs",
                        impl: str = "cuda"):
    """``step(state, batch) -> (n_cand,)`` retrieval scores."""
    offsets = _device_offsets(model, offsets)

    @torch.inference_mode()
    def step(state, batch):
        return retrieval_scores(model, engine, state, batch, offsets,
                                mode=mode, impl=impl)
    return step


def params_from_numpy(tree, device: Optional[DeviceLike] = None,
                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """The reference's param tree with numpy leaves (nested dicts, the
    ``blocks`` / ``layers`` / ``cross`` lists, the ``mlp`` / ``deep``
    towers) -> a state dict for :class:`RecModel`
    (``model.load_state_dict``): keys are the tree's paths, dotted."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple))
             else None)
    if items is None:
        return {prefix: torch.tensor(np.asarray(tree), device=device)}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(params_from_numpy(
            v, device, f"{prefix}.{k}" if prefix else str(k)))
    return out
