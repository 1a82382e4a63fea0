"""Page-granular placement for the embedding tables (paper section IV-B1).

A copy of ``repro.core.paging``.  The logical address space (all tables
stacked) is cut into fixed-size pages; every page lives in exactly one
place: the replicated HOT tier or one shard of the COLD tier.  Lookups go
through the ``page_to_shard`` / ``page_to_slot`` indirection, so results do
not depend on the placement.

``placement_gather_indices`` (migration) waits for the planner slice
(``ROADMAP.md`` queue 1, item 6).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

HOT_SHARD = -1  # sentinel in page_to_shard

STORAGE_FORMATS = ("fp32", "int8")  # cold-tier storage format knob


@dataclasses.dataclass(frozen=True)
class PagingConfig:
    total_rows: int            # stacked rows across all tables
    dim: int
    n_shards: int              # cold-tier shards (1 on one device)
    page_bytes: int = 4096
    itemsize: int = 4          # logical (hot-tier / fp32) bytes per element
    hot_fraction: float = 0.05  # fraction of pages the hot tier can hold
    headroom: float = 1.3      # cold-shard slot over-provisioning
    storage: str = "fp32"      # cold-tier storage: fp32 passthrough or int8

    def __post_init__(self):
        if self.storage not in STORAGE_FORMATS:
            raise ValueError(f"unknown storage {self.storage!r}; "
                             f"expected one of {STORAGE_FORMATS}")

    @property
    def cold_itemsize(self) -> int:
        """*Stored* bytes per element in the cold tier."""
        return 1 if self.storage == "int8" else self.itemsize

    @property
    def page_size(self) -> int:
        """Rows per page (>=1).  ``page_bytes`` means *stored* bytes, so an
        int8 cold tier packs 4x the rows per page."""
        return max(1, self.page_bytes // (self.dim * self.cold_itemsize))

    @property
    def num_pages(self) -> int:
        return -(-self.total_rows // self.page_size)

    @property
    def hot_pages(self) -> int:
        return max(1, int(self.num_pages * self.hot_fraction))

    @property
    def pages_per_shard(self) -> int:
        base = -(-self.num_pages // self.n_shards)
        return max(1, int(np.ceil(base * self.headroom)))

    @property
    def rows_per_shard(self) -> int:
        return self.pages_per_shard * self.page_size

    @property
    def padded_rows(self) -> int:
        return self.num_pages * self.page_size

    @property
    def cold_rows_total(self) -> int:
        return self.n_shards * self.rows_per_shard

    @property
    def hot_rows(self) -> int:
        return self.hot_pages * self.page_size


@dataclasses.dataclass
class PageTable:
    """Placement state: for each page, its tier/shard and slot."""
    page_to_shard: torch.Tensor   # (num_pages,) int32; HOT_SHARD => hot tier
    page_to_slot: torch.Tensor    # (num_pages,) int32; slot in shard or hot tier


def initial_page_table(cfg: PagingConfig, device="cpu") -> PageTable:
    """Interleave cold pages round-robin across shards (paper section
    IV-B3); the hot tier starts empty."""
    pages = np.arange(cfg.num_pages)
    shard = (pages % cfg.n_shards).astype(np.int32)
    slot = (pages // cfg.n_shards).astype(np.int32)
    if slot.max(initial=0) >= cfg.pages_per_shard:
        raise ValueError("headroom too small")
    return PageTable(torch.as_tensor(shard, device=device),
                     torch.as_tensor(slot, device=device))


def locate(cfg: PagingConfig, table: PageTable, row_idx: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """row id -> (shard, local_row, is_hot); vectorized."""
    ps = cfg.page_size
    row_idx = row_idx.long()
    page = row_idx // ps
    offset = row_idx % ps
    shard = table.page_to_shard[page]
    local_row = table.page_to_slot[page].long() * ps + offset
    is_hot = shard == HOT_SHARD
    return shard, local_row, is_hot
