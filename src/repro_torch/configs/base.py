"""DLRM configs, the architecture registry and the CPU-smoke shrink.

A copy of the DLRM part of ``repro.configs.base``: ``get_config(name)``
resolves a registry id (the ``--arch`` string), ``reduced(cfg)`` shrinks a
config to something a CPU test runs in seconds.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Tuple


@dataclass(frozen=True)
class DLRMConfig:
    """Paper Table I models (RMC1-4)."""
    name: str
    emb_num: int                      # rows per table
    emb_dim: int
    bottom_mlp: Tuple[int, ...]
    top_mlp: Tuple[int, ...]
    n_tables: int = 8
    pooling: int = 8                  # paper default: 8 lookups per bag
    n_dense: int = 13
    family: str = "dlrm"
    dtype: str = "float32"
    source: str = "PIFS-Rec Table I"


_REGISTRY: Dict[str, DLRMConfig] = {}


def register(cfg: DLRMConfig) -> DLRMConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch id {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> DLRMConfig:
    from repro_torch.configs import rmc  # noqa: F401  (registers on import)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def reduced(cfg: DLRMConfig) -> DLRMConfig:
    """Shrink a config to something a CPU smoke test can run in seconds."""
    if not isinstance(cfg, DLRMConfig):
        raise TypeError(f"unknown config type {type(cfg)}")
    return replace(cfg, emb_num=256, emb_dim=16, n_tables=4, pooling=4,
                   bottom_mlp=(32, 16, 16), top_mlp=(16, 8, 1))
