"""Access profiling + buffer replacement policies (paper sections IV-A4, IV-B2).

A copy of ``repro.core.hot_cache``.  Two consumers:
  * the placement planner (hot-page selection = page-granular HTR), and
  * simlab's on-switch SRAM buffer model (row-granular HTR vs LRU vs FIFO,
    Fig. 15).

`AccessProfiler` is the paper's "address profiler [that] logs and ranks
frequently accessed row vectors".  Policies are plain-python simulation
objects (they model switch hardware state, not tensors); the tensor-side
counterpart is `update_counts`.  ``HTRCache._rerank`` sorts a dict filled
in access order, so ties among equal counts go to the row seen first, as
in the reference: the residents and hit sequences are the reference's.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable

import numpy as np
import torch


def update_counts(counts: torch.Tensor, pages: torch.Tensor,
                  decay: float = 1.0) -> torch.Tensor:
    """Page-access histogram update (scatter-add, optional EWMA), on the
    counts' device; returns a new tensor, as the reference's does.  Pages
    index as the reference's scatter: a negative page wraps once and what
    is still outside the histogram is dropped."""
    counts = counts * decay if decay != 1.0 else counts.clone()
    n = counts.shape[0]
    p = pages.reshape(-1).to(counts.device, torch.int64)
    p = torch.where(p < 0, p + n, p)
    ok = (p >= 0) & (p < n)
    ones = ok.to(counts.dtype)
    return counts.index_add_(0, torch.where(ok, p, 0), ones)


class AccessProfiler:
    """Host-side frequency profiler with exponential decay."""

    def __init__(self, n_items: int, decay: float = 0.9):
        self.counts = np.zeros(n_items, dtype=np.float64)
        self.decay = decay

    def observe(self, items: np.ndarray) -> None:
        self.counts *= self.decay
        np.add.at(self.counts, np.asarray(items).ravel(), 1.0)

    def hottest(self, k: int) -> np.ndarray:
        k = min(k, len(self.counts))
        part = np.argpartition(-self.counts, k - 1)[:k]
        return part[np.argsort(-self.counts[part])]


class BufferPolicy:
    """Fixed-capacity cache model; returns hit/miss per access."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.hits = 0
        self.accesses = 0

    def access(self, key: int) -> bool:
        raise NotImplementedError

    def run(self, keys: Iterable[int]) -> float:
        for k in keys:
            self.accesses += 1
            if self.access(int(k)):
                self.hits += 1
        return self.hit_rate

    @property
    def hit_rate(self) -> float:
        return self.hits / max(1, self.accesses)


class LRUCache(BufferPolicy):
    def __init__(self, capacity: int):
        super().__init__(capacity)
        self._od: "OrderedDict[int, None]" = OrderedDict()

    def access(self, key: int) -> bool:
        if key in self._od:
            self._od.move_to_end(key)
            return True
        if len(self._od) >= self.capacity:
            self._od.popitem(last=False)
        self._od[key] = None
        return False


class FIFOCache(BufferPolicy):
    def __init__(self, capacity: int):
        super().__init__(capacity)
        self._od: "OrderedDict[int, None]" = OrderedDict()

    def access(self, key: int) -> bool:
        if key in self._od:
            return True
        if len(self._od) >= self.capacity:
            self._od.popitem(last=False)
        self._od[key] = None
        return False


class HTRCache(BufferPolicy):
    """Hottest-Recording (paper section IV-A4): an address profiler ranks rows
    by access frequency; the buffer retains the current top-`capacity`
    candidates.  Re-ranking happens every `rerank_every` accesses (the paper's
    profiler is periodic hardware logic, not per-access)."""

    def __init__(self, capacity: int, rerank_every: int = 2048, decay: float = 0.98):
        super().__init__(capacity)
        self._freq: Dict[int, float] = {}
        self._resident: set = set()
        self._since_rerank = 0
        self.rerank_every = rerank_every
        self.decay = decay

    def _rerank(self) -> None:
        top = sorted(self._freq.items(), key=lambda kv: -kv[1])[: self.capacity]
        self._resident = {k for k, _ in top}
        # decay so the profile tracks drift
        self._freq = {k: v * self.decay for k, v in self._freq.items() if v > 1e-3}

    def access(self, key: int) -> bool:
        self._freq[key] = self._freq.get(key, 0.0) + 1.0
        self._since_rerank += 1
        if self._since_rerank >= self.rerank_every:
            self._since_rerank = 0
            self._rerank()
        hit = key in self._resident
        if not hit and len(self._resident) < self.capacity:
            self._resident.add(key)
        return hit


def make_policy(name: str, capacity: int) -> BufferPolicy:
    name = name.lower()
    if name == "htr":
        return HTRCache(capacity)
    if name == "lru":
        return LRUCache(capacity)
    if name == "fifo":
        return FIFOCache(capacity)
    raise ValueError(f"unknown buffer policy {name!r}")
