"""Synthetic DLRM access-trace generators (paper section VI-C2, Fig. 12b).

A numpy copy of ``repro.data.traces``: the same ``TraceConfig`` and seed
give the same row ids, so both packages serve identical request streams.
Distributions: Zipfian, Normal, Uniform and Random, as in the paper's
synthetic traces; the Zipfian skew is calibrated to Meta-trace-like
locality.

A trace is a sequence of SLS requests: for each (batch sample, table) bag,
``pooling`` row ids drawn from the table's id space under the distribution.
Every random decision is keyed ``(seed, tag, counter)``, so each stream is
deterministic under ``TraceConfig.seed`` independent of call order.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np

_INIT_TAG = 0x11A0
_BATCH_TAG = 0x11A1
_DRIFT_TAG = 0x11A2
_SERVE_TAG = 0x11A3
_SERVE_DRIFT_TAG = 0x11A4


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    n_rows: int                  # rows per table
    n_tables: int = 8
    pooling: int = 8             # lookups per bag (paper: "8 per batch")
    batch: int = 1024
    distribution: str = "zipfian"  # zipfian | normal | uniform | random
    zipf_alpha: float = 1.1      # calibrated to Meta-trace-like skew
    normal_sigma_frac: float = 0.05
    # hot-set churn per batch: each batch remaps this fraction of the
    # hottest ranks to fresh rows (production popularity drifts)
    drift_per_batch: float = 0.25
    drift_window: int = 65536    # ranks eligible to churn
    seed: int = 0


class TraceGenerator:
    """Stateful host-side generator: each call yields (batch, tables,
    pooling) int64 row ids (table-local)."""

    def __init__(self, cfg: TraceConfig):
        self.cfg = cfg
        init_rng = np.random.default_rng([cfg.seed, _INIT_TAG])
        if cfg.distribution == "zipfian":
            # fixed preference permutation per table: hot ids are scattered
            # across the address space (like hashed ids in production)
            self._perm = np.stack([
                init_rng.permutation(cfg.n_rows)
                for _ in range(cfg.n_tables)])
            ranks = np.arange(1, cfg.n_rows + 1, dtype=np.float64)
            w = ranks ** -cfg.zipf_alpha
            self._cdf = np.cumsum(w) / w.sum()
        elif cfg.distribution == "normal":
            self._centers = init_rng.integers(0, cfg.n_rows, cfg.n_tables)
        self._n_batches = 0     # drift schedule position (batch stream)
        self._n_serve = 0       # serve-request stream position
        self._serve_pos = 0     # serve-stream uniform sweep cursor (ids)

    def _draw(self, table: int, n: int, rng: np.random.Generator,
              pos: int = 0) -> np.ndarray:
        c = self.cfg
        if c.distribution == "uniform":
            # balanced round-robin sweep over the id space from the cursor
            return (pos + np.arange(n, dtype=np.int64)) % c.n_rows
        if c.distribution == "random":
            return rng.integers(0, c.n_rows, n)
        if c.distribution == "normal":
            mu = self._centers[table]
            sd = max(1.0, c.n_rows * c.normal_sigma_frac)
            ids = np.rint(rng.normal(mu, sd, n)).astype(np.int64)
            return np.mod(ids, c.n_rows)
        # zipfian via inverse-CDF on the rank distribution
        u = rng.random(n)
        ranks = np.searchsorted(self._cdf, u)
        return self._perm[table][np.minimum(ranks, c.n_rows - 1)]

    def _drift(self, rng: np.random.Generator) -> None:
        """Churn the hot set: swap a fraction of hot ranks with random ranks
        (keeps each table's rank->row map a permutation)."""
        c = self.cfg
        if c.distribution != "zipfian" or c.drift_per_batch <= 0:
            return
        window = min(c.drift_window, c.n_rows)
        m = max(1, int(window * c.drift_per_batch))
        for t in range(c.n_tables):
            hot_ranks = rng.choice(window, m, replace=False)
            other_ranks = rng.integers(0, c.n_rows, m)
            p = self._perm[t]
            p[hot_ranks], p[other_ranks] = (p[other_ranks].copy(),
                                            p[hot_ranks].copy())

    def next_batch(self) -> np.ndarray:
        """(batch, n_tables, pooling) table-local row ids."""
        c = self.cfg
        rng = np.random.default_rng([c.seed, _BATCH_TAG, self._n_batches])
        pos = self._n_batches * c.batch * c.pooling   # uniform sweep cursor
        out = np.empty((c.batch, c.n_tables, c.pooling), dtype=np.int64)
        for t in range(c.n_tables):
            out[:, t, :] = self._draw(t, c.batch * c.pooling, rng,
                                      pos=pos).reshape(c.batch, c.pooling)
        self._drift(np.random.default_rng(
            [c.seed, _DRIFT_TAG, self._n_batches]))
        self._n_batches += 1
        return out

    def serve_requests(self, n: Optional[int] = None,
                       poolings: Optional[Sequence[int]] = None,
                       drift_every: int = 0) -> Iterator[np.ndarray]:
        """Per-request iterator: ``(n_tables, L)`` table-local row ids per
        request, ``L`` drawn uniformly from ``poolings`` (default: the
        config's pooling); ``drift_every > 0`` churns the hot set every that
        many requests.  Request ``i``'s randomness is keyed ``(seed, i)``."""
        c = self.cfg
        choices = tuple(poolings) if poolings else (c.pooling,)
        produced = 0
        while n is None or produced < n:
            i = self._n_serve
            rng = np.random.default_rng([c.seed, _SERVE_TAG, i])
            L = int(choices[rng.integers(len(choices))])
            out = np.empty((c.n_tables, L), dtype=np.int64)
            for t in range(c.n_tables):
                out[t] = self._draw(t, L, rng, pos=self._serve_pos)
            self._serve_pos += L
            self._n_serve += 1
            produced += 1
            if drift_every and self._n_serve % drift_every == 0:
                self._drift(np.random.default_rng(
                    [c.seed, _SERVE_DRIFT_TAG, i]))
            yield out
