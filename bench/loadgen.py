"""The one traffic generator: host batches from a traffic file's parameters
and the run's seed.

``TraceGenerator`` is a frozen copy of the batch path of
``repro_torch/data/traces.py`` (the paper's synthetic DLRM traces, section
VI-C2): zipfian ids (alpha 1.1) over a per-table preference permutation
whose hot ranks drift after every batch, or uniformly random ids.  It is
copied so that a change to the port cannot change the benchmark's traffic.

A traffic file (``traffic/<name>.json``) holds:

  * ``items``: items (user, candidate pairs) in one batch;
  * ``distribution``: ``zipfian`` or ``random`` (uniform iid ids), with
    ``zipf_alpha``, ``drift_per_batch`` and ``drift_window``;
  * ``pool``: distinct batches drawn at set-up and cycled through by one
    caller, each sent when the last one's scores are on the host.

The pool depends on the seed; the sizes do not.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

_INIT_TAG = 0x11A0
_BATCH_TAG = 0x11A1
_DRIFT_TAG = 0x11A2
_DENSE_TAG = 0xBE0D
DISTRIBUTIONS = ("zipfian", "random")
SEARCH_THREADS = 4    # the zipfian inverse-CDF searches, a table each


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    n_rows: int                  # rows per table
    n_tables: int = 8
    pooling: int = 8             # lookups per bag
    batch: int = 1024
    distribution: str = "zipfian"  # zipfian | random
    zipf_alpha: float = 1.1
    drift_per_batch: float = 0.25  # share of the hottest ranks remapped
    drift_window: int = 65536      # ranks eligible to churn
    seed: int = 0


class TraceGenerator:
    """Each :meth:`next_batch` is (batch, tables, pooling) int64 table-local
    row ids; every random decision is keyed ``(seed, tag, counter)``."""

    def __init__(self, cfg: TraceConfig):
        if cfg.distribution not in DISTRIBUTIONS:
            raise ValueError(f"unknown distribution {cfg.distribution!r}")
        self.cfg = cfg
        init_rng = np.random.default_rng([cfg.seed, _INIT_TAG])
        if cfg.distribution == "zipfian":
            self._perm = np.stack([
                init_rng.permutation(cfg.n_rows)
                for _ in range(cfg.n_tables)])
            ranks = np.arange(1, cfg.n_rows + 1, dtype=np.float64)
            w = ranks ** -cfg.zipf_alpha
            self._cdf = np.cumsum(w) / w.sum()
        self._n_batches = 0

    def _zipf_ids(self, table: int, u: np.ndarray) -> np.ndarray:
        ranks = np.searchsorted(self._cdf, u)
        return self._perm[table][np.minimum(ranks, self.cfg.n_rows - 1)]

    def _drift(self, rng: np.random.Generator) -> None:
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
        """The next batch.  The zipfian searches run on threads; the draws
        stay in table order, so the ids do not depend on them."""
        c = self.cfg
        rng = np.random.default_rng([c.seed, _BATCH_TAG, self._n_batches])
        n = c.batch * c.pooling
        if c.distribution == "random":
            ids = [rng.integers(0, c.n_rows, n) for _ in range(c.n_tables)]
        else:
            u = [rng.random(n) for _ in range(c.n_tables)]
            with ThreadPoolExecutor(SEARCH_THREADS) as threads:
                ids = list(threads.map(self._zipf_ids, range(c.n_tables), u))
        out = np.empty((c.batch, c.n_tables, c.pooling), dtype=np.int64)
        for t in range(c.n_tables):
            out[:, t, :] = ids[t].reshape(c.batch, c.pooling)
        self._drift(np.random.default_rng(
            [c.seed, _DRIFT_TAG, self._n_batches]))
        self._n_batches += 1
        return out


def make_pool(model: dict, traffic: dict, seed: int,
              row_offsets: np.ndarray) -> List[Dict[str, np.ndarray]]:
    """``traffic["pool"]`` padded host batches, as the serving padder builds
    them: ``dense`` (items, n_dense) float32, ``indices`` (items, tables,
    pooling) int32 global row ids (table t's ids + ``row_offsets[t]``) and
    ``weights`` (items, tables, pooling) float32, all ones (every bag
    full)."""
    items, T, L = traffic["items"], model["n_tables"], model["pooling"]
    gen = TraceGenerator(TraceConfig(
        n_rows=model["emb_num"], n_tables=T, pooling=L, batch=items,
        distribution=traffic["distribution"],
        zipf_alpha=traffic.get("zipf_alpha", 1.1),
        drift_per_batch=traffic.get("drift_per_batch", 0.25),
        drift_window=traffic.get("drift_window", 65536), seed=seed))
    offs = np.asarray(row_offsets, dtype=np.int64)[None, :, None]
    pool = []
    for k in range(traffic["pool"]):
        ids = gen.next_batch() + offs
        rng = np.random.default_rng([seed, _DENSE_TAG, k])
        pool.append({
            "dense": rng.standard_normal((items, model["n_dense"]),
                                         dtype=np.float32),
            "indices": ids.astype(np.int32),
            "weights": np.ones((items, T, L), dtype=np.float32)})
    return pool


def check_traffic(traffic: dict) -> None:
    """Raise on a traffic file the generator cannot run."""
    if traffic.get("distribution") not in DISTRIBUTIONS:
        raise ValueError(f"unknown distribution in {traffic}")
    for key in ("items", "pool"):
        if not (isinstance(traffic.get(key), int) and traffic[key] > 0):
            raise ValueError(f"traffic {key} must be a positive integer")
