"""DLRM (paper Fig. 1 / Table I): bottom MLP -> PIFS embedding lookup ->
pairwise-dot interaction -> top MLP -> CTR score.

The port of ``repro.models.dlrm``'s serving half.  A batch is
``{"dense": (B, n_dense) f32, "indices": (B, T, L) int32, "weights":
(B, T, L) f32 (optional)}`` with T tables and L lookups per bag, on the
model's device.

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
        is the engine's gather-once knob (None = the engine default)."""
        if front_end not in PIFSEmbeddingEngine.FRONT_END_MODES:
            raise ValueError(f"unknown front_end {front_end!r}")
        if tiers != "all":
            front_end = "split"                # fused path is all-tiers only
        idx, w = batch["indices"], batch.get("weights")
        x_bot = self.bottom(batch["dense"])
        if self.bot_proj is not None:
            x_bot = x_bot @ self.bot_proj                       # (B, d)
        if front_end == "fused":
            inter = engine.lookup_interact(
                state, idx, x_bot, weights=w, mode=mode, impl=impl,
                dedup=dedup, front_end="fused")                 # (B, P)
        else:
            pooled = engine.lookup(state, idx, weights=w, mode=mode,
                                   impl=impl, dedup=dedup,
                                   tiers=tiers)                 # (B, T, d)
            feats = torch.cat([x_bot[:, None, :], pooled], dim=1)
            inter = kernel_ops.dot_interaction(feats, impl=impl)
        z = torch.cat([x_bot, inter], dim=-1)
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
