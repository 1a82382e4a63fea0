"""Synthetic click and recsys streams: copies of ``repro.data.synth``'s
``dlrm_batches``, ``_padded_rows``, ``rec_batches`` and ``_zipf_ids``, so
both packages draw the same batches and requests from the same seed, bit
for bit.  Host-side numpy; ``data/pipeline.py`` puts batches on a device.
The LM and graph generators belong to ``ROADMAP.md`` queue 1 item 17."""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.configs.base import DLRMConfig, RecConfig
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
