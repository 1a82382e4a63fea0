"""Host-side control plane for streaming embedding updates.

A copy of ``repro.core.updates`` (numpy only), on the port's
``core/paging`` and ``core/planner``:

  * :func:`coalesce_deltas` -- deterministic duplicate-row summing, so the
    device apply sees unique rows and WAL replay is bit-identical to the
    live application.
  * :func:`chunk_delta_batch` -- fixed-``capacity`` padding/chunking, so
    the engine's ``apply_deltas`` sees one signature and steady-state
    updates add none.
  * :class:`DriftTracker` -- per-page accumulated |delta| mass: which hot
    pages have drifted off the quantized grid their carried scale defines.
  * :func:`demote_table` -- a new PageTable with the chosen pages moved
    into the least-loaded cold shards' free slots, executed by the
    engine's ordinary ``migrate``.

The device half (``apply_deltas`` / ``requant_hot_pages``) lives in
``repro_torch.core.pifs``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

from repro_torch.core.paging import HOT_SHARD, PageTable, PagingConfig, host
from repro_torch.core.planner import shard_loads

PAD_ROW = -1   # pad sentinel in a fixed-capacity delta batch's row ids


@dataclasses.dataclass(frozen=True)
class UpdateConfig:
    """Knobs for the streaming-update subsystem.

    capacity        -- rows per device apply (fixed shape: one signature;
                       larger batches are chunked, smaller ones padded).
    apply_every     -- micro-batches between drains of the pending update
                       queue (1 = drain at every batch boundary).
    demote_every    -- applied batches between requant-demote scans
                       (0 = never demote).
    drift_threshold -- accumulated |delta| mass at which a hot page
                       becomes a demotion candidate.
    max_demotions   -- cap on pages demoted per scan.
    hotness_guard   -- fraction of hot-resident pages (by access count)
                       that are never demoted, whatever their drift.
    snapshot_every  -- applied batches between checkpoint snapshots
                       (each snapshot truncates the WAL; 0 = only the
                       snapshots the caller takes explicitly).
    """
    capacity: int = 256
    apply_every: int = 1
    demote_every: int = 0
    drift_threshold: float = 1.0
    max_demotions: int = 8
    hotness_guard: float = 0.5
    snapshot_every: int = 0


def coalesce_deltas(rows, deltas) -> Tuple[np.ndarray, np.ndarray]:
    """Sum duplicate-row deltas into one delta per unique row.

    Returns ``(rows (U,) int32 sorted unique, deltas (U, D) float32)``.
    Negative row ids (pads) are dropped.  Deterministic (``np.unique`` and
    the sequential ``np.add.at``), and the identity on an already
    coalesced batch, which is what makes WAL replay through the same path
    exact."""
    rows = np.asarray(rows).reshape(-1).astype(np.int64)
    deltas = np.asarray(deltas, dtype=np.float32)
    deltas = deltas.reshape(rows.size, -1)
    keep = rows >= 0
    rows, deltas = rows[keep], deltas[keep]
    uniq, inv = np.unique(rows, return_inverse=True)
    out = np.zeros((uniq.size, deltas.shape[1]), dtype=np.float32)
    np.add.at(out, inv, deltas)
    return uniq.astype(np.int32), out


def chunk_delta_batch(rows: np.ndarray, deltas: np.ndarray, capacity: int,
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Split a coalesced delta batch into fixed-``capacity`` chunks: each
    exactly ``(capacity,)`` int32 rows (``PAD_ROW`` padded) and
    ``(capacity, D)`` float32 deltas.  An empty batch yields nothing."""
    if capacity <= 0:
        raise ValueError(f"capacity must be positive; got {capacity}")
    rows = np.asarray(rows, dtype=np.int32).reshape(-1)
    deltas = np.asarray(deltas, dtype=np.float32)
    d = deltas.shape[-1]
    for lo in range(0, rows.size, capacity):
        sl_rows = rows[lo:lo + capacity]
        sl_d = deltas[lo:lo + capacity]
        pad = capacity - sl_rows.size
        out_rows = np.concatenate(
            [sl_rows, np.full(pad, PAD_ROW, dtype=np.int32)])
        out_d = np.concatenate(
            [sl_d, np.zeros((pad, d), dtype=np.float32)], axis=0)
        yield out_rows, out_d


class DriftTracker:
    """Per-page accumulated update mass, feeding requant-demote scans.

    ``drift[p]`` is the summed |delta| applied to page ``p`` since it was
    last re-quantized.  Host bookkeeping only."""

    def __init__(self, cfg: PagingConfig):
        self.cfg = cfg
        self.drift = np.zeros(cfg.num_pages, dtype=np.float64)
        self.rows_touched = np.zeros(cfg.num_pages, dtype=np.int64)

    def update(self, rows, deltas) -> None:
        rows = np.asarray(rows).reshape(-1)
        deltas = np.asarray(deltas, dtype=np.float64)
        deltas = deltas.reshape(rows.size, -1)
        keep = rows >= 0
        rows, deltas = rows[keep], deltas[keep]
        page = rows // self.cfg.page_size
        np.add.at(self.drift, page, np.abs(deltas).sum(axis=1))
        np.add.at(self.rows_touched, page, 1)

    def note_requantized(self, pages) -> None:
        """Pages put back on the quantized grid carry no drift."""
        pages = np.asarray(pages).reshape(-1)
        pages = pages[pages >= 0]
        self.drift[pages] = 0.0

    def demote_candidates(self, table: PageTable, counts: np.ndarray,
                          ucfg: UpdateConfig) -> np.ndarray:
        """Hot-resident pages drifted past the threshold, excluding the
        hottest ``hotness_guard`` fraction of the hot tier by access
        count: up to ``max_demotions`` page ids, most-drifted first (ties
        by page id)."""
        shard = host(table.page_to_shard)
        counts = np.asarray(counts, dtype=np.float64)
        hot = np.nonzero(shard == HOT_SHARD)[0]
        if hot.size == 0 or ucfg.max_demotions <= 0:
            return np.empty(0, dtype=np.int64)
        n_guard = int(np.ceil(hot.size * ucfg.hotness_guard))
        if n_guard > 0:
            # the guard protects by *traffic* rank among hot residents
            guard_order = hot[np.argsort(-counts[hot], kind="stable")]
            guarded = set(guard_order[:n_guard].tolist())
        else:
            guarded = set()
        cand = [p for p in hot.tolist()
                if p not in guarded
                and self.drift[p] >= ucfg.drift_threshold]
        cand.sort(key=lambda p: (-self.drift[p], p))
        return np.asarray(cand[: ucfg.max_demotions], dtype=np.int64)


def demote_table(cfg: PagingConfig, table: PageTable, counts: np.ndarray,
                 pages) -> PageTable:
    """New PageTable with ``pages`` (hot-resident) demoted to cold shards.

    Every other page keeps its placement.  Each demoted page goes to the
    least loaded shard with a free slot (ties by shard id) and takes its
    smallest free slot.  Raises if the cold tier has no free slot."""
    pages = np.asarray(pages).reshape(-1).astype(np.int64)
    shard = host(table.page_to_shard).copy()
    slot = host(table.page_to_slot).copy()
    counts = np.asarray(counts, dtype=np.float64)
    loads = shard_loads(cfg, table, counts)
    cap = cfg.pages_per_shard
    used = np.zeros((cfg.n_shards, cap), dtype=bool)    # slot occupancy
    cold = shard != HOT_SHARD
    used[shard[cold], slot[cold]] = True
    n_used = used.sum(axis=1)
    for p in pages:
        if shard[p] != HOT_SHARD:
            raise ValueError(f"page {int(p)} is not hot-resident "
                             f"(shard {int(shard[p])})")
        cands = [s for s in range(cfg.n_shards) if n_used[s] < cap]
        if not cands:
            raise RuntimeError("cold tier has no free slot for demotion "
                               "(headroom exhausted)")
        s = min(cands, key=lambda s: (loads[s], s))
        free = int(np.argmin(used[s]))                # first free slot
        shard[p] = s
        slot[p] = free
        used[s, free] = True
        n_used[s] += 1
        loads[s] += counts[p]
    return PageTable(page_to_shard=shard.astype(np.int32),
                     page_to_slot=slot.astype(np.int32))
