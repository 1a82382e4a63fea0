"""Page-granular placement for the embedding tables (paper section IV-B1).

A copy of ``repro.core.paging``.  The logical address space (all tables
stacked) is cut into fixed-size pages; every page lives in exactly one
place: the replicated HOT tier or one shard of the COLD tier.  Lookups go
through the ``page_to_shard`` / ``page_to_slot`` indirection, so results do
not depend on the placement.
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


def host(x) -> np.ndarray:
    """A host numpy view of a tensor (on any device) or an array-like."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def placement_gather_indices(cfg: PagingConfig, old: PageTable, new: PageTable
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Row-level gather maps realizing a migration (host-side, numpy).

    Returns (cold_src, hot_src): for each destination row in the new cold
    storage (resp. new hot tier), the source position in the *concatenated*
    old storage [cold_flat | hot_flat].  Unmapped destination rows point at
    source 0 (their content is unused -- no page maps to them).
    """
    ps = cfg.page_size
    o_shard, o_slot = host(old.page_to_shard), host(old.page_to_slot)
    n_shard, n_slot = host(new.page_to_shard), host(new.page_to_slot)

    def src_base(shard, slot):
        # position of a page's first row in [cold_flat | hot_flat]
        cold = shard.astype(np.int64) * cfg.rows_per_shard + slot * ps
        hot = cfg.cold_rows_total + slot.astype(np.int64) * ps
        return np.where(shard == HOT_SHARD, hot, cold)

    src = src_base(o_shard, o_slot)                      # (P,)
    cold_src = np.zeros(cfg.cold_rows_total, dtype=np.int64)
    hot_src = np.zeros(cfg.hot_rows, dtype=np.int64)

    row_offsets = np.arange(ps)
    cold_mask = n_shard != HOT_SHARD
    cold_pages = np.nonzero(cold_mask)[0]
    dst = (n_shard[cold_pages].astype(np.int64) * cfg.rows_per_shard
           + n_slot[cold_pages].astype(np.int64) * ps)
    cold_src[(dst[:, None] + row_offsets).ravel()] = (
        src[cold_pages][:, None] + row_offsets).ravel()

    hot_pages = np.nonzero(~cold_mask)[0]
    dsth = n_slot[hot_pages].astype(np.int64) * ps
    hot_src[(dsth[:, None] + row_offsets).ravel()] = (
        src[hot_pages][:, None] + row_offsets).ravel()
    return cold_src, hot_src
