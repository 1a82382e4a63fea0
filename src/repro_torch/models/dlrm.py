"""DLRM (paper Fig. 1 / Table I): bottom MLP -> PIFS embedding lookup ->
pairwise-dot interaction -> top MLP -> CTR score.

The port of ``repro.models.dlrm``: the serve step and the train step
(:func:`loss_fn`, :func:`make_train_step`).  A batch is
``{"dense": (B, n_dense) f32, "indices": (B, T, L) int32, "weights":
(B, T, L) f32 (optional), "labels": (B,) int32 (training)}`` with T
tables and L lookups per bag, on the model's device.

Training differentiates through the split front end (the masked_sls and
dot_interaction kernels' autograd wrappers in ``kernels/ops.py``), as the
reference's ``make_train_step`` does; the fused routes have no backward.

A difference from the reference, kept knowingly: the reference's
``make_serve_step`` never forwards ``interaction_impl``
(``repro/models/dlrm.py:161-172``), so its split path always runs the jnp
interaction.  Here the split path runs the interaction with the same
``impl`` as the lookup: on a CUDA tensor that is the dot_interaction
kernel, the device function the fused front end shares -- which is what
makes fused == split bitwise on the card.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import DLRMConfig
from repro_torch.core.pifs import PIFSEmbeddingEngine, engine_for_tables
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import MLP
from repro_torch.models.params import joint_train_step
from repro_torch.models.recsys import _bce
from repro_torch.trace import span


def build_engine(cfg: DLRMConfig, device: DeviceLike = None,
                 hot_fraction: float = 0.05, storage: str = "fp32",
                 dedup: str = "off", validate_ids: bool = False,
                 n_shards: int = 1
                 ) -> Tuple[PIFSEmbeddingEngine, np.ndarray]:
    """The engine over the config's ``n_tables`` tables of ``emb_num``
    rows; ``storage='int8'`` selects the quantized cold tier.
    ``n_shards`` stands in for the reference's ``mesh`` argument: the
    cold tier's shards (its tp axis), all on ``device``.  The MLPs stay
    replicated, as the reference's ``mlp_specs`` keep them."""
    return engine_for_tables([cfg.emb_num] * cfg.n_tables, cfg.emb_dim,
                             device=device, hot_fraction=hot_fraction,
                             storage=storage, dedup=dedup,
                             validate_ids=validate_ids, n_shards=n_shards)


class DLRM(nn.Module):
    """The dense towers of DLRM; the embedding engine is passed to
    :meth:`forward`.  ``device`` defaults to the card (raises without
    CUDA; pass ``"cpu"`` for the CPU).  Parameters start uninitialized:
    fill them with ``models.params.initialize`` or load the reference's
    with :func:`params_from_numpy`."""

    def __init__(self, cfg: DLRMConfig, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d = cfg.emb_dim
        F = cfg.n_tables + 1                   # pooled tables + bottom out
        self.bottom = MLP((cfg.n_dense,) + cfg.bottom_mlp, final_act=True,
                          device=dev)
        self.top = MLP((F * (F - 1) // 2 + d,) + cfg.top_mlp, device=dev)
        # Table I widths don't always end at emb_dim (RMC1: 128 vs 64); a
        # linear projection aligns the dense feature with the embeddings
        self.bot_proj = (nn.Parameter(torch.empty(cfg.bottom_mlp[-1], d,
                                                  device=dev))
                         if cfg.bottom_mlp[-1] != d else None)

    def forward(self, engine: PIFSEmbeddingEngine, state,
                batch: Dict[str, torch.Tensor], mode: str = "pifs",
                impl: str = "cuda", front_end: str = "split",
                tiers: str = "all", dedup: Optional[str] = None
                ) -> torch.Tensor:
        """CTR logits (B,).  ``front_end='fused'`` routes lookup + feature
        stacking + interaction through ``engine.lookup_interact`` (one
        kernel on the card at one shard in pifs/beacon; partial pool ->
        resume at n_shards > 1 or in pond); ``mode`` is the engine's
        (pifs, pond or beacon); ``tiers='hot_only'`` reads the hot tier only
        and forces the split front end, as the reference does.  ``dedup``
        is the engine's gather-once knob (None = the engine default).
        Under a profiler the towers and the front end are the spans
        ``pifs.bottom_mlp``, ``pifs.front_end`` (either route) and
        ``pifs.top_mlp`` (``repro_torch.trace``)."""
        if front_end not in PIFSEmbeddingEngine.FRONT_END_MODES:
            raise ValueError(f"unknown front_end {front_end!r}")
        if tiers != "all":
            front_end = "split"                # fused path is all-tiers only
        idx, w = batch["indices"], batch.get("weights")
        with span("pifs.bottom_mlp"):
            x_bot = self.bottom(batch["dense"])
            if self.bot_proj is not None:
                x_bot = x_bot @ self.bot_proj                   # (B, d)
        with span("pifs.front_end"):
            if front_end == "fused":
                inter = engine.lookup_interact(
                    state, idx, x_bot, weights=w, mode=mode, impl=impl,
                    dedup=dedup, front_end="fused")             # (B, P)
            else:
                pooled = engine.lookup(state, idx, weights=w, mode=mode,
                                       impl=impl, dedup=dedup,
                                       tiers=tiers)             # (B, T, d)
                feats = torch.cat([x_bot[:, None, :], pooled], dim=1)
                inter = kernel_ops.dot_interaction(feats, impl=impl)
        z = torch.cat([x_bot, inter], dim=-1)
        with span("pifs.top_mlp"):
            return self.top(z)[:, 0]


def make_serve_step(model: DLRM, engine: PIFSEmbeddingEngine,
                    mode: str = "pifs", impl: str = "cuda",
                    front_end: str = "split", tiers: str = "all",
                    dedup: Optional[str] = None):
    """``step(state, batch) -> (B,)`` click probabilities."""
    @torch.inference_mode()
    def step(state, batch):
        logits = model(engine, state, batch, mode=mode, impl=impl,
                       front_end=front_end, tiers=tiers, dedup=dedup)
        return torch.sigmoid(logits)
    return step


def loss_fn(model: DLRM, engine: PIFSEmbeddingEngine, state,
            batch: Dict[str, torch.Tensor], mode: str = "pifs",
            impl: str = "cuda") -> torch.Tensor:
    """Mean binary cross-entropy of the logits against ``batch["labels"]``
    in the reference's stable form, ``max(z, 0) - z y + log1p(exp(-|z|))``,
    through the split front end."""
    return _bce(model(engine, state, batch, mode=mode, impl=impl),
                batch["labels"])


def make_train_step(model: DLRM, engine: PIFSEmbeddingEngine, optimizer,
                    emb_optimizer, mode: str = "pifs", impl: str = "cuda"):
    """Joint step: dense params via ``optimizer``, the embedding tiers via
    ``emb_optimizer`` (row-wise adagrad by convention), in place
    (``models.params.joint_train_step``): ``step(state, opt_state,
    emb_opt_state, batch) -> (state, opt_state, emb_opt_state,
    {"loss"})``.  The embedding gradient flows through the engine lookup
    (gather -> scatter-add), dense over each tier as the reference's is.
    pifs and pond (and beacon, pifs' datapath), any ``n_shards``; an int8
    engine raises ``TypeError``."""
    return joint_train_step(
        model, engine,
        lambda state, batch: loss_fn(model, engine, state, batch,
                                     mode=mode, impl=impl),
        optimizer, emb_optimizer)


def input_specs(cfg: DLRMConfig, batch: int, with_labels: bool,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A dry-run's batch: empty tensors with the reference's keys, shapes
    and dtypes (fake under the caller's ``FakeTensorMode``)."""
    dev = resolve_device(device)
    T, L = cfg.n_tables, cfg.pooling
    out = {"dense": torch.empty((batch, cfg.n_dense), dtype=torch.float32,
                                device=dev),
           "indices": torch.empty((batch, T, L), dtype=torch.int32,
                                  device=dev)}
    if with_labels:
        out["labels"] = torch.empty((batch,), dtype=torch.int32, device=dev)
    return out


def params_from_numpy(tree: dict, device: Optional[DeviceLike] = None
                      ) -> Dict[str, torch.Tensor]:
    """The reference's param tree with numpy leaves (``{"bottom":
    {"layer0_w", ...}, "top": {...}, "bot_proj"}``) -> a state dict for
    :class:`DLRM` (``model.load_state_dict``)."""
    out = {}
    for tower in ("bottom", "top"):
        for name, leaf in tree[tower].items():
            out[f"{tower}.{name}"] = torch.tensor(np.asarray(leaf),
                                                  device=device)
    if "bot_proj" in tree:
        out["bot_proj"] = torch.tensor(np.asarray(tree["bot_proj"]),
                                       device=device)
    return out
