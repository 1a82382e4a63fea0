"""Placement planner: global hotness detection + embedding spreading
(paper sections IV-B2, IV-B3).  A port of ``repro.core.planner``.

Host-side control-plane logic (numpy), mirroring the paper's host daemon:
  1. *Global hotness detection*: rank pages by (decayed) access frequency;
     promote the top ``hot_pages`` into the replicated hot tier, but only
     evict a resident hot page when a challenger exceeds it by more than
     ``cold_age_threshold`` (hysteresis).
  2. *Embedding spreading*: keep cold pages in place unless a shard is warm
     (its load exceeds the mean by ``1 - migrate_threshold``); pages that
     need a place go heaviest-first to the least-loaded shard with room
     (weighted LPT).

Same placements as the reference, in O(P log P): the reference scans the
whole resident hot set for every challenger (``min`` over a set) and walks
every cold page in Python, which at RMC4's million pages takes over an
hour per re-plan.  Here the victims come off a min-heap, the sticky step
is vectorized and the challengers stop at the first one that loses (they
come in descending count order and the weakest resident only grows).

Ties: where counts are equal the reference picks the victim, and orders
the hot list, by Python set iteration order.  This planner breaks every
tie by the lowest page id.  Lookups do not depend on placement, so this
changes no score; page tables equal the reference's wherever no tie
decides.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.paging import HOT_SHARD, PageTable, PagingConfig, host


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    migrate_threshold: float = 0.35   # paper section IV-B3 (Fig 13a)
    cold_age_threshold: float = 0.16  # paper section VI-C6 (Fig 13d)
    sticky: bool = True               # keep resident placements when possible


def shard_loads(cfg: PagingConfig, table: PageTable, counts: np.ndarray
                ) -> np.ndarray:
    """Access load per cold shard."""
    shard = host(table.page_to_shard)
    loads = np.zeros(cfg.n_shards)
    cold = shard != HOT_SHARD
    np.add.at(loads, shard[cold], counts[cold])
    return loads


def needs_migration(cfg: PagingConfig, table: PageTable, counts: np.ndarray,
                    pcfg: PlannerConfig) -> bool:
    """Paper trigger: a node is 'warm' when its access count exceeds the
    mean of the others by more than (1 - migrate_threshold)."""
    loads = shard_loads(cfg, table, counts)
    mean = loads.mean()
    if mean <= 0:
        return False
    return bool(loads.max() > mean * (2.0 - pcfg.migrate_threshold))


def _hot_set(cfg: PagingConfig, counts: np.ndarray, order: np.ndarray,
             resident: np.ndarray, pcfg: PlannerConfig) -> np.ndarray:
    """The new hot pages, sorted by descending count (ties: page id)."""
    H = cfg.hot_pages
    if not (pcfg.sticky and resident.size):
        return order[:H]      # a stable argsort already breaks ties by id
    is_res = np.zeros(counts.size, bool)
    is_res[resident] = True
    heap = [(counts[p], int(p)) for p in resident]
    heapq.heapify(heap)
    margin = 1.0 + pcfg.cold_age_threshold
    top = order[: 4 * H]
    for c in top[~is_res[top]]:
        c = int(c)
        if len(heap) < H:
            heapq.heappush(heap, (counts[c], c))
            continue
        if not counts[c] > heap[0][0] * margin:
            break             # later challengers are no heavier
        heapq.heapreplace(heap, (counts[c], c))
    pages = np.fromiter((p for _, p in heap), np.int64, len(heap))
    return pages[np.lexsort((pages, -counts[pages]))][:H]


def plan(cfg: PagingConfig, table: PageTable, counts: np.ndarray,
         pcfg: Optional[PlannerConfig] = None) -> Tuple[PageTable, dict]:
    """Compute a new placement from page access counts.

    Returns (new_table, stats): the page table as numpy int32 arrays, and
    what the paper reports (moved pages, load std-dev before/after, hot
    promotions)."""
    pcfg = pcfg or PlannerConfig()
    counts = np.asarray(counts, dtype=np.float64)
    old_shard = host(table.page_to_shard)
    old_slot = host(table.page_to_slot)
    P = cfg.num_pages

    # ---- 1. hot set selection with hysteresis ------------------------------
    order = np.argsort(-counts, kind="stable")
    hot_list = _hot_set(cfg, counts, order,
                        np.nonzero(old_shard == HOT_SHARD)[0], pcfg)
    hot_mask = np.zeros(P, dtype=bool)
    hot_mask[hot_list] = True

    # ---- 2. embedding spreading over cold shards ---------------------------
    new_shard = np.full(P, HOT_SHARD, dtype=np.int32)
    new_slot = np.zeros(P, dtype=np.int32)
    new_slot[hot_list] = np.arange(len(hot_list), dtype=np.int32)

    cold_pages = np.nonzero(~hot_mask)[0]
    loads = np.zeros(cfg.n_shards)
    fill = np.zeros(cfg.n_shards, dtype=np.int64)

    sticky_kept = 0
    if pcfg.sticky and not needs_migration(cfg, table, counts, pcfg):
        # no node is warm: keep every already-cold page in place (slots stay
        # unique because assignment within a shard is unchanged)
        keep = cold_pages[old_shard[cold_pages] != HOT_SHARD]
        new_shard[keep] = old_shard[keep]
        new_slot[keep] = old_slot[keep]
        np.add.at(loads, old_shard[keep], counts[keep])
        np.maximum.at(fill, old_shard[keep], old_slot[keep].astype(np.int64)
                      + 1)
        sticky_kept = int(keep.size)
        unplaced = cold_pages[new_shard[cold_pages] == HOT_SHARD]
    else:
        unplaced = cold_pages

    # weighted LPT: heaviest page -> least-loaded shard with capacity (ties:
    # the lowest shard, as np.argmin picks)
    order_c = unplaced[np.argsort(-counts[unplaced], kind="stable")]
    cap = cfg.pages_per_shard
    room = [(loads[s], s) for s in range(cfg.n_shards) if fill[s] < cap]
    heapq.heapify(room)
    for p in order_c:
        if not room:
            raise ValueError("headroom too small: no cold shard has a free "
                             "slot")
        _, s = heapq.heappop(room)
        new_shard[p] = s
        new_slot[p] = fill[s]
        fill[s] += 1
        loads[s] += counts[p]
        if fill[s] < cap:
            heapq.heappush(room, (loads[s], s))

    moved = int(np.sum((new_shard != old_shard) | (new_slot != old_slot)))
    stats = {
        "moved_pages": moved,
        "moved_fraction": moved / max(1, P),
        "sticky_kept": sticky_kept,
        "hot_pages": len(hot_list),
        "load_std_before": float(shard_loads(cfg, table, counts).std()),
        "load_std_after": float(loads.std()),
        "load_max_over_mean": float(loads.max() / max(loads.mean(), 1e-9)),
    }
    return PageTable(page_to_shard=new_shard, page_to_slot=new_slot), stats
