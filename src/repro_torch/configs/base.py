"""Configs, the architecture registry and the CPU-smoke shrinks.

A copy of the DLRM and recsys parts of ``repro.configs.base``:
``get_config(name)`` resolves a registry id (the ``--arch`` string),
``reduced(cfg)`` shrinks a config to something a CPU test runs in seconds,
``reduced_shape`` does the same for a ``RecShape``.  The LM and GNN
families are not registered here (``ROADMAP.md`` queue 1 item 17): their
ids raise ``KeyError``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Tuple, Union


@dataclass(frozen=True)
class RecShape:
    name: str
    kind: str            # "train" | "serve" | "retrieval"
    batch: int
    n_candidates: int = 0


REC_SHAPES: Dict[str, RecShape] = {
    "train_batch": RecShape("train_batch", "train", 65536),
    "serve_p99": RecShape("serve_p99", "serve", 512),
    "serve_bulk": RecShape("serve_bulk", "serve", 262144),
    "retrieval_cand": RecShape("retrieval_cand", "retrieval", 1,
                               n_candidates=1_000_000),
}


@dataclass(frozen=True)
class RecConfig:
    name: str
    interaction: str                  # "self-attn-seq" | "self-attn" | "cross" | "transformer-seq"
    embed_dim: int
    vocab_sizes: Tuple[int, ...]      # per sparse field (or (n_items,) for seq models)
    n_dense: int = 0
    seq_len: int = 0                  # behaviour-sequence length (sasrec/bst)
    n_blocks: int = 0
    n_heads: int = 0
    d_attn: int = 0
    n_attn_layers: int = 0
    n_cross_layers: int = 0
    mlp_dims: Tuple[int, ...] = ()
    multi_hot: int = 1                # lookups per field per sample (SLS pooling factor)
    family: str = "recsys"
    dtype: str = "float32"
    source: str = ""

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    def shapes(self) -> Dict[str, RecShape]:
        return REC_SHAPES


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

    def shapes(self) -> Dict[str, RecShape]:
        return REC_SHAPES


Config = Union[DLRMConfig, RecConfig]

_REGISTRY: Dict[str, Config] = {}


def register(cfg: Config) -> Config:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch id {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def _ensure_loaded() -> None:
    # import side-effect registration
    from repro_torch.configs import (  # noqa: F401
        autoint, bst, dcn_v2, rmc, sasrec)


def get_config(name: str) -> Config:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs(assigned_only: bool = True) -> List[str]:
    """The registered ids, sorted; ``assigned_only`` leaves out the
    paper's own RMC models, as the reference does."""
    _ensure_loaded()
    names = sorted(_REGISTRY)
    if assigned_only:
        names = [n for n in names if not n.startswith("rmc")]
    return names


def reduced(cfg: Config) -> Config:
    """Shrink a config to something a CPU smoke test can run in seconds."""
    if isinstance(cfg, RecConfig):
        vocabs = tuple(min(v, 100) for v in cfg.vocab_sizes)
        kw: Dict[str, Any] = dict(vocab_sizes=vocabs, embed_dim=8)
        if cfg.mlp_dims:
            kw["mlp_dims"] = tuple(min(d, 32) for d in cfg.mlp_dims)
        if cfg.seq_len:
            kw["seq_len"] = min(cfg.seq_len, 12)
        if cfg.d_attn:
            kw["d_attn"] = 8
        return replace(cfg, **kw)
    if isinstance(cfg, DLRMConfig):
        return replace(cfg, emb_num=256, emb_dim=16, n_tables=4, pooling=4,
                       bottom_mlp=(32, 16, 16), top_mlp=(16, 8, 1))
    raise TypeError(f"unknown config type {type(cfg)}")


def reduced_shape(shape: RecShape) -> RecShape:
    """Shrink a shape descriptor for smoke tests."""
    if isinstance(shape, RecShape):
        return replace(shape, batch=min(shape.batch, 16),
                       n_candidates=(min(shape.n_candidates, 64)
                                     if shape.n_candidates else 0))
    raise TypeError(f"unknown shape type {type(shape)}")
