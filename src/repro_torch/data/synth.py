"""Synthetic click, recsys and LM token streams and graphs: copies of
``repro.data.synth``'s ``dlrm_batches``, ``_padded_rows``, ``rec_batches``,
``lm_batches``, ``_zipf_ids``, ``make_graph``, ``to_csr`` and
``molecule_batches``, so both packages draw the same batches, requests and
graphs from the same seed, bit for bit.  Host-side numpy;
``data/pipeline.py`` puts batches on a device."""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.configs.base import DLRMConfig, LMConfig, RecConfig
from repro_torch.data.traces import TraceConfig, TraceGenerator


def dlrm_batches(cfg: DLRMConfig, batch: int, n_batches: int,
                 distribution: str = "zipfian", seed: int = 0
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Criteo-like stream: dense gaussians + per-table zipfian multi-hot ids +
    a click label correlated with a random linear teacher (learnable)."""
    rng = np.random.default_rng(seed)
    gen = TraceGenerator(TraceConfig(
        n_rows=cfg.emb_num, n_tables=cfg.n_tables, pooling=cfg.pooling,
        batch=batch, distribution=distribution, seed=seed))
    w_teacher = rng.normal(size=cfg.n_dense)
    offs = (np.arange(cfg.n_tables, dtype=np.int64) * _padded_rows(cfg))
    for _ in range(n_batches):
        dense = rng.normal(size=(batch, cfg.n_dense)).astype(np.float32)
        idx = gen.next_batch() + offs[None, :, None]
        margin = dense @ w_teacher / np.sqrt(cfg.n_dense)
        labels = (margin + rng.normal(scale=0.5, size=batch) > 0)
        yield {"dense": dense, "indices": idx.astype(np.int32),
               "labels": labels.astype(np.int32)}


def _padded_rows(cfg: DLRMConfig, page_bytes: int = 4096,
                 storage: str = "fp32") -> int:
    """Per-table padded rows -- must mirror ``engine_for_tables``' page
    rounding, including the cold-tier storage format (int8 pages of the
    same ``page_bytes`` hold 4x the rows, so the padding boundary moves)."""
    itemsize = 1 if storage == "int8" else 4
    ps = max(1, page_bytes // (cfg.emb_dim * itemsize))
    return -(-cfg.emb_num // ps) * ps


def rec_batches(cfg: RecConfig, batch: int, n_batches: int, seed: int = 0,
                kind: str = "train") -> Iterator[Dict[str, np.ndarray]]:
    """Batches shaped for ``repro_torch.models.recsys.forward`` /
    ``loss_fn``."""
    rng = np.random.default_rng(seed)
    it = cfg.interaction
    for _ in range(n_batches):
        b: Dict[str, np.ndarray] = {}
        if it in ("self-attn-seq", "transformer-seq"):
            V = cfg.vocab_sizes[0]
            # zipf-ish popularity for items
            seq = _zipf_ids(rng, V, (batch, cfg.seq_len))
            b["seq"] = seq.astype(np.int32)
            if it == "transformer-seq":
                b["dense"] = rng.normal(
                    size=(batch, cfg.n_dense)).astype(np.float32)
            if kind == "train" and it == "self-attn-seq":
                b["pos"] = np.roll(seq, -1, axis=1).astype(np.int32)
                b["neg"] = _zipf_ids(rng, V, (batch, cfg.seq_len)
                                     ).astype(np.int32)
            else:
                b["target"] = _zipf_ids(rng, V, (batch,)).astype(np.int32)
                if kind == "train":
                    b["labels"] = rng.integers(0, 2, batch).astype(np.int32)
        else:
            fields = np.stack(
                [_zipf_ids(rng, v, (batch,)) for v in cfg.vocab_sizes], axis=1)
            b["fields"] = fields.astype(np.int32)
            if cfg.n_dense:
                b["dense"] = rng.normal(
                    size=(batch, cfg.n_dense)).astype(np.float32)
            if kind == "train":
                b["labels"] = rng.integers(0, 2, batch).astype(np.int32)
        yield b


def lm_batches(cfg: LMConfig, batch: int, seq: int, n_batches: int,
               seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Markov-ish token stream: unigram zipf + short-range repetition, so a
    model trained a few hundred steps shows a visibly decreasing loss."""
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        toks = _zipf_ids(rng, cfg.vocab, (batch, seq + 1), alpha=1.1)
        # inject copy structure: 25% of positions repeat t-2
        rep = rng.random((batch, seq + 1)) < 0.25
        toks[:, 2:] = np.where(rep[:, 2:], toks[:, :-2], toks[:, 2:])
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}


def make_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """Power-law-ish random graph + community-correlated features/labels."""
    rng = np.random.default_rng(seed)
    # preferential-attachment-flavoured edge sampling
    popularity = rng.zipf(1.3, n_nodes).astype(np.float64)
    popularity /= popularity.sum()
    src = rng.choice(n_nodes, n_edges, p=popularity)
    dst = rng.integers(0, n_nodes, n_edges)
    labels = rng.integers(0, n_classes, n_nodes)
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    feats = centers[labels] + rng.normal(
        scale=1.0, size=(n_nodes, d_feat)).astype(np.float32)
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    return {"feats": feats, "edges": edges,
            "labels": labels.astype(np.int32)}


def to_csr(n_nodes: int, edges: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Edge list -> CSR (indptr, indices) for the neighbor sampler."""
    src, dst = edges[:, 0], edges[:, 1]
    order = np.argsort(src, kind="stable")
    indices = dst[order].astype(np.int64)
    counts = np.bincount(src, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, indices


def molecule_batches(graph_batch: int, n_nodes: int, n_edges: int,
                     d_feat: int, n_classes: int, n_batches: int,
                     seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        feats = rng.normal(
            size=(graph_batch, n_nodes, d_feat)).astype(np.float32)
        edges = rng.integers(
            0, n_nodes, (graph_batch, n_edges, 2)).astype(np.int32)
        labels = rng.integers(0, n_classes, graph_batch).astype(np.int32)
        yield {"feats": feats, "edges": edges, "labels": labels}


def _zipf_ids(rng: np.random.Generator, vocab: int, shape: Tuple[int, ...],
              alpha: float = 1.05) -> np.ndarray:
    n = int(np.prod(shape))
    # bounded zipf via rejection-free inverse transform on a truncated tail
    u = rng.random(n)
    ids = np.floor(
        ((vocab ** (1 - alpha) - 1) * u + 1) ** (1 / (1 - alpha))) - 1
    ids = np.clip(ids.astype(np.int64), 0, vocab - 1)
    return rng.permutation(vocab)[ids].reshape(shape) if vocab <= 10_000_000 \
        else ids.reshape(shape)
