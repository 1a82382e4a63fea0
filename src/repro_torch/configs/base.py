"""Configs, the architecture registry and the CPU-smoke shrinks.

A copy of ``repro.configs.base``: ``get_config(name)`` resolves a registry
id (the ``--arch`` string), ``reduced(cfg)`` shrinks a config to something
a CPU test runs in seconds, ``reduced_shape`` does the same for a shape
descriptor, and ``iter_cells`` lists the dry-run's (arch, shape) cells.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Tuple, Union


@dataclass(frozen=True)
class LMShape:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    subquadratic_only: bool = False


@dataclass(frozen=True)
class GNNShape:
    name: str
    kind: str            # "full" | "minibatch" | "batched_small"
    n_nodes: int
    n_edges: int
    d_feat: int = 0
    batch_nodes: int = 0          # sampled-training root batch
    fanout: Tuple[int, ...] = ()  # neighbor-sampling fanout per hop
    graph_batch: int = 0          # batched-small-graphs batch size


LM_SHAPES: Dict[str, LMShape] = {
    "train_4k": LMShape("train_4k", "train", 4096, 256),
    "prefill_32k": LMShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": LMShape("decode_32k", "decode", 32768, 128),
    "long_500k": LMShape("long_500k", "decode", 524288, 1,
                         subquadratic_only=True),
}


GNN_SHAPES: Dict[str, GNNShape] = {
    # Cora full-batch
    "full_graph_sm": GNNShape("full_graph_sm", "full", 2708, 10556,
                              d_feat=1433),
    # Reddit sampled-training
    "minibatch_lg": GNNShape("minibatch_lg", "minibatch", 232965, 114615892,
                             d_feat=602, batch_nodes=1024, fanout=(15, 10)),
    # ogbn-products full-batch
    "ogb_products": GNNShape("ogb_products", "full", 2449029, 61859140,
                             d_feat=100),
    # batched small molecule graphs
    "molecule": GNNShape("molecule", "batched_small", 30, 64, d_feat=32,
                         graph_batch=128),
}


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


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    first_dense_layers: int = 0      # deepseek-v3: first 3 layers are dense
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    family: str = "lm"
    d_head: int = 0                  # 0 -> d_model // n_heads
    attn_type: str = "gqa"           # "gqa" | "mla"
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    activation: str = "silu_glu"     # "silu_glu" | "relu2"
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    mtp_depth: int = 0               # deepseek-v3 multi-token prediction
    # the reference's training knobs, kept so the configs compare equal
    remat: str = "full"
    train_accum: int = 1
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def shapes(self) -> Dict[str, LMShape]:
        return LM_SHAPES


@dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int
    d_hidden: int
    aggregator: str = "mean"
    sample_sizes: Tuple[int, ...] = (25, 10)
    n_classes: int = 41
    family: str = "gnn"
    dtype: str = "float32"
    source: str = ""

    def shapes(self) -> Dict[str, GNNShape]:
        return GNN_SHAPES


Config = Union[DLRMConfig, RecConfig, LMConfig, GNNConfig]

_REGISTRY: Dict[str, Config] = {}


def register(cfg: Config) -> Config:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch id {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def _ensure_loaded() -> None:
    # import side-effect registration
    from repro_torch.configs import (  # noqa: F401
        autoint, bst, dcn_v2, deepseek_67b, deepseek_v3_671b,
        granite_moe_1b_a400m, graphsage_reddit, llama3_2_3b,
        nemotron_4_340b, rmc, sasrec)


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


def iter_cells() -> List[Tuple[str, str, Optional[str]]]:
    """All 40 (arch, shape) dry-run cells with skip reasons where mandated
    (the reference's list, strings included)."""
    _ensure_loaded()
    cells: List[Tuple[str, str, Optional[str]]] = []
    for name in list_archs():
        cfg = _REGISTRY[name]
        for sname, shape in cfg.shapes().items():
            skip = None
            if getattr(shape, "subquadratic_only", False) and cfg.family == "lm":
                skip = ("full-attention arch: long_500k requires sub-quadratic "
                        "attention (see DESIGN.md section 5)")
            cells.append((name, sname, skip))
    return cells


def reduced(cfg: Config) -> Config:
    """Shrink a config to something a CPU smoke test can run in seconds."""
    if isinstance(cfg, LMConfig):
        kw: Dict[str, Any] = dict(
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=512, d_head=16, rope_theta=10000.0,
            mtp_depth=min(cfg.mtp_depth, 1), train_accum=1)
        if cfg.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_head_dim=16, qk_rope_head_dim=8,
                                  v_head_dim=16)
            kw["d_head"] = 0
        if cfg.moe is not None:
            kw["moe"] = replace(
                cfg.moe, n_experts=4, top_k=2, d_ff_expert=32,
                n_shared_experts=min(cfg.moe.n_shared_experts, 1),
                first_dense_layers=min(cfg.moe.first_dense_layers, 1))
        return replace(cfg, **kw)
    if isinstance(cfg, GNNConfig):
        return replace(cfg, d_hidden=16, sample_sizes=(4, 3), n_classes=5)
    if isinstance(cfg, RecConfig):
        vocabs = tuple(min(v, 100) for v in cfg.vocab_sizes)
        kw = dict(vocab_sizes=vocabs, embed_dim=8)
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


def reduced_shape(shape: Union[RecShape, LMShape, GNNShape]
                  ) -> Union[RecShape, LMShape, GNNShape]:
    """Shrink a shape descriptor for smoke tests."""
    if isinstance(shape, LMShape):
        return replace(shape, seq_len=min(shape.seq_len, 64),
                       global_batch=min(shape.global_batch, 4))
    if isinstance(shape, GNNShape):
        return replace(
            shape,
            n_nodes=min(shape.n_nodes, 200),
            n_edges=min(shape.n_edges, 800),
            d_feat=min(shape.d_feat, 16) if shape.d_feat else 0,
            batch_nodes=min(shape.batch_nodes, 8) if shape.batch_nodes else 0,
            fanout=tuple(min(f, 3) for f in shape.fanout),
            graph_batch=min(shape.graph_batch, 4) if shape.graph_batch else 0)
    if isinstance(shape, RecShape):
        return replace(shape, batch=min(shape.batch, 16),
                       n_candidates=(min(shape.n_candidates, 64)
                                     if shape.n_candidates else 0))
    raise TypeError(f"unknown shape type {type(shape)}")
