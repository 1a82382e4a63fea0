"""The one traffic generator: host batches from a traffic file's parameters
and the run's seed.

``TraceGenerator`` is a frozen copy of the batch path of
``repro_torch/data/traces.py`` (the paper's synthetic DLRM traces, section
VI-C2), widened to tables that differ: zipfian ids (alpha 1.1) over each
table's own rows through its own preference permutation, whose hot ranks
drift after every batch, or uniformly random ids.  It is copied so that a
change to the port cannot change the benchmark's traffic; where every
table has one row count and one bag length it draws exactly what the
port's generator draws.

A configuration gives its tables in one of two forms (``tables``):

  * ``emb_num`` rows in each of ``n_tables`` tables, or ``vocab_sizes``,
    a list of each table's rows;
  * ``pooling``: one bag length for every table, or a list of one a table.

A traffic file (``traffic/<name>.json``) holds:

  * ``items``: items (user, candidate pairs) in one batch;
  * ``distribution``: ``zipfian`` or ``random`` (uniform iid ids), with
    ``zipf_alpha``, ``drift_per_batch`` and ``drift_window``;
  * ``pool``: distinct batches drawn at set-up and cycled through by one
    caller, each sent when the last one's scores are on the host.

A batch's ``indices`` are ``(items, T, L)`` where every bag has one length
L, and ``(items, sum L_t)`` otherwise, table t's bag in the columns
``[c_t, c_{t+1})`` that ``bag_edges`` gives.  The pool depends on the seed;
the sizes do not.
"""
from __future__ import annotations

import dataclasses
import operator
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

_INIT_TAG = 0x11A0
_BATCH_TAG = 0x11A1
_DRIFT_TAG = 0x11A2
_DENSE_TAG = 0xBE0D
DISTRIBUTIONS = ("zipfian", "random")
SEARCH_THREADS = 4    # the zipfian inverse-CDF searches, a table each


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    n_rows: Union[int, Sequence[int]]   # rows: one for all tables, or each's
    n_tables: int = 8
    pooling: Union[int, Sequence[int]] = 8  # lookups per bag: one, or each's
    batch: int = 1024
    distribution: str = "zipfian"  # zipfian | random
    zipf_alpha: float = 1.1
    drift_per_batch: float = 0.25  # share of the hottest ranks remapped
    drift_window: int = 65536      # ranks eligible to churn
    seed: int = 0


def _per_table(key: str, value, n_tables: int) -> Tuple[int, ...]:
    """``value`` for each of ``n_tables`` tables: one positive whole number
    for all, or a list of one a table."""
    if isinstance(value, (list, tuple)):
        out = tuple(operator.index(v) for v in value)
    else:
        out = (operator.index(value),) * n_tables
    if len(out) != n_tables or not out or min(out) < 1:
        raise ValueError(f"{key} must be a positive whole number or a list "
                         f"of {n_tables}; got {value!r}")
    return out


def tables(model: dict) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Each table's row count and bag length in configuration ``model``."""
    if "vocab_sizes" in model:
        rows = model["vocab_sizes"]
        n_tables = model.get("n_tables", len(rows))
    else:
        rows, n_tables = model["emb_num"], model["n_tables"]
    return (_per_table("vocab_sizes", rows, n_tables),
            _per_table("pooling", model["pooling"], n_tables))


def _edges(lengths: Sequence[int]) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)


def bag_edges(model: dict) -> np.ndarray:
    """The column edges of the bags in an ``(items, sum L_t)`` batch of
    ``model``: ``c_0 = 0``, ``c_{t+1} = c_t + L_t``, table t's bag in
    ``[c_t, c_{t+1})``.  Where every bag has one length L, ``c_t = t * L``
    indexes the flattened ``(T, L)`` axes."""
    return _edges(tables(model)[1])


class TraceGenerator:
    """Each :meth:`next_batch` is int64 table-local row ids: (batch, tables,
    pooling) where every bag has one length, (batch, sum of the lengths)
    otherwise.  Every random decision is keyed ``(seed, tag, counter)``."""

    def __init__(self, cfg: TraceConfig):
        if cfg.distribution not in DISTRIBUTIONS:
            raise ValueError(f"unknown distribution {cfg.distribution!r}")
        self.cfg = cfg
        self.rows = _per_table("n_rows", cfg.n_rows, cfg.n_tables)
        self.lengths = _per_table("pooling", cfg.pooling, cfg.n_tables)
        init_rng = np.random.default_rng([cfg.seed, _INIT_TAG])
        if cfg.distribution == "zipfian":
            self._perm = [init_rng.permutation(n) for n in self.rows]
            self._cdf = {}               # one a distinct row count
            for n in set(self.rows):
                w = np.arange(1, n + 1, dtype=np.float64) ** -cfg.zipf_alpha
                self._cdf[n] = np.cumsum(w) / w.sum()
        self._n_batches = 0

    def _zipf_ids(self, table: int, u: np.ndarray) -> np.ndarray:
        n = self.rows[table]
        ranks = np.searchsorted(self._cdf[n], u)
        return self._perm[table][np.minimum(ranks, n - 1)]

    def _drift(self, rng: np.random.Generator) -> None:
        c = self.cfg
        if c.distribution != "zipfian" or c.drift_per_batch <= 0:
            return
        for t, n in enumerate(self.rows):
            window = min(c.drift_window, n)
            m = max(1, int(window * c.drift_per_batch))
            hot_ranks = rng.choice(window, m, replace=False)
            other_ranks = rng.integers(0, n, m)
            p = self._perm[t]
            p[hot_ranks], p[other_ranks] = (p[other_ranks].copy(),
                                            p[hot_ranks].copy())

    def next_batch(self) -> np.ndarray:
        """The next batch.  The zipfian searches run on threads; the draws
        stay in table order, so the ids do not depend on them."""
        c = self.cfg
        rng = np.random.default_rng([c.seed, _BATCH_TAG, self._n_batches])
        sizes = [c.batch * length for length in self.lengths]
        if c.distribution == "random":
            ids = [rng.integers(0, n, k) for n, k in zip(self.rows, sizes)]
        else:
            u = [rng.random(k) for k in sizes]
            with ThreadPoolExecutor(SEARCH_THREADS) as threads:
                ids = list(threads.map(self._zipf_ids, range(c.n_tables), u))
        edges = _edges(self.lengths)
        out = np.empty((c.batch, edges[-1]), dtype=np.int64)
        for t, length in enumerate(self.lengths):
            out[:, edges[t]:edges[t + 1]] = ids[t].reshape(c.batch, length)
        self._drift(np.random.default_rng(
            [c.seed, _DRIFT_TAG, self._n_batches]))
        self._n_batches += 1
        if len(set(self.lengths)) == 1:
            return out.reshape(c.batch, c.n_tables, self.lengths[0])
        return out


def make_pool(model: dict, traffic: dict, seed: int,
              row_offsets: np.ndarray) -> List[Dict[str, np.ndarray]]:
    """``traffic["pool"]`` padded host batches, as the serving padder builds
    them: ``dense`` (items, n_dense) float32, ``indices`` int32 global row
    ids (table t's ids + ``row_offsets[t]``), (items, tables, pooling) or
    (items, sum of the bag lengths) as the module says, and ``weights`` of
    the same shape, float32, all ones (every bag full)."""
    rows, lengths = tables(model)
    if len(row_offsets) != len(rows):
        raise ValueError(f"{len(row_offsets)} row offsets for "
                         f"{len(rows)} tables")
    items = traffic["items"]
    gen = TraceGenerator(TraceConfig(
        n_rows=rows, n_tables=len(rows), pooling=lengths, batch=items,
        distribution=traffic["distribution"],
        zipf_alpha=traffic.get("zipf_alpha", 1.1),
        drift_per_batch=traffic.get("drift_per_batch", 0.25),
        drift_window=traffic.get("drift_window", 65536), seed=seed))
    col_offsets = np.repeat(np.asarray(row_offsets, dtype=np.int64),
                            lengths)
    pool = []
    for k in range(traffic["pool"]):
        ids = gen.next_batch()
        ids = (ids.reshape(items, -1) + col_offsets).reshape(ids.shape)
        rng = np.random.default_rng([seed, _DENSE_TAG, k])
        pool.append({
            "dense": rng.standard_normal((items, model["n_dense"]),
                                         dtype=np.float32),
            "indices": ids.astype(np.int32),
            "weights": np.ones(ids.shape, dtype=np.float32)})
    return pool


def check_traffic(traffic: dict) -> None:
    """Raise on a traffic file the generator cannot run."""
    if traffic.get("distribution") not in DISTRIBUTIONS:
        raise ValueError(f"unknown distribution in {traffic}")
    for key in ("items", "pool"):
        if not (isinstance(traffic.get(key), int) and traffic[key] > 0):
            raise ValueError(f"traffic {key} must be a positive integer")
