"""MLPerf's DLRM-DCNv2 served by the port: ``PIFSEmbeddingEngine`` (paged
two-tier tables, the int8 cold tier; bags that differ in length pooled by
one ``ragged_sls`` launch a tier), the ``DLRM`` towers with the low-rank
cross network and the serve step, behind ``ServeBinding.execute`` (host
batch -> copy -> step -> synchronize), the entry every window drives.

The tables and weights are the benchmark's (``reference/dlrm_dcnv2.py:
make_inputs``): the engine packs the int8 codes and page scales as they
are (``from_codes``: the cold tier is the one copy it makes); the hot tier
is placed as a deployment places it, by ``observe`` over the cell's own
traffic and then ``plan_and_migrate`` (in place where the card's free
memory cannot hold a second cold tier).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from bench.systems.dlrm import reset_counters  # noqa: F401  (the harness's)


def model_config(cfg: dict):
    """The port's ``DLRMDCNConfig`` for the benchmark's configuration."""
    from repro_torch.configs.base import DLRMDCNConfig
    rows = tuple(cfg["vocab_sizes"])
    return DLRMDCNConfig(
        name=cfg["name"], emb_num=max(rows), emb_dim=cfg["emb_dim"],
        bottom_mlp=tuple(cfg["bottom_mlp"]), top_mlp=tuple(cfg["top_mlp"]),
        n_tables=len(rows), pooling=tuple(cfg["pooling"]),
        n_dense=cfg["n_dense"], vocab_sizes=rows,
        cross_layers=cfg["cross_layers"], cross_rank=cfg["cross_rank"])


def build(cfg: dict, params: Dict[str, torch.Tensor],
          tables: Dict[str, torch.Tensor],
          pool: Sequence[Dict[str, np.ndarray]], row_offsets: np.ndarray,
          device):
    """The port's ``ServeBinding`` for ``cfg``, its tables packed from the
    int8 codes and page scales and its hot tier placed from ``pool``."""
    from repro_torch.core.pifs import ServeBinding
    from repro_torch.models import dlrm

    mc = model_config(cfg)
    engine, offsets = dlrm.build_engine(
        mc, device, hot_fraction=cfg["hot_fraction"],
        storage=cfg["storage"], dedup=cfg["dedup"],
        n_shards=cfg["n_shards"])
    if engine.cfg.page_bytes != cfg["page_bytes"]:
        raise ValueError(f"the port pages {engine.cfg.page_bytes} bytes, "
                         f"the configuration {cfg['page_bytes']}")
    if not np.array_equal(np.asarray(offsets), np.asarray(row_offsets)):
        raise ValueError(f"the port's table offsets {offsets} differ from "
                         f"the benchmark's {row_offsets}")
    model = dlrm.DLRM(mc, device)
    model.load_state_dict(params, strict=True)
    state = engine.from_codes(tables["codes"], tables["scales"])
    for b in pool:
        state = engine.observe(
            state, torch.as_tensor(b["indices"], device=device),
            torch.as_tensor(b["weights"], device=device))
    state, _ = engine.plan_and_migrate(state)
    step = dlrm.make_serve_step(model, engine, mode=cfg["mode"],
                                impl="cuda", front_end=cfg["front_end"],
                                dedup=cfg["dedup"])
    return ServeBinding(engine, state, model, step)


def counters(binding) -> List[str]:
    """The port's own counters since :func:`reset_counters`, as lines."""
    from repro_torch.kernels.build import KERNELS
    launched = {k: v.launches for k, v in KERNELS.items() if v.launches}
    stats = binding.plan_stats()
    return [f"kernel launches {launched}",
            f"new signatures after warm-up {stats['traces']} "
            f"(lookups {stats.get('calls')}, ragged signatures "
            f"{stats.get('ragged')} of {stats.get('plans')})",
            f"staging {binding.staging_stats()}"]
