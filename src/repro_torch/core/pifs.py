"""PIFSEmbeddingEngine on one device (a port of ``repro.core.pifs``).

The paged two-tier embedding store and its lookups, in the reference's
three modes:

  * ``pifs``   -- reduce near the data: each cold-tier shard runs a masked
                  partial SLS over the rows it owns, the shards' pooled
                  partials are summed, and hot-tier hits are served from
                  the replicated copy;
  * ``pond``   -- communicate then reduce (the paper's baseline): each
                  shard ships its raw rows, which are summed over shards
                  and then pooled; a fused front end pools them first;
  * ``beacon`` -- the pifs datapath; the paper's BEACON has tiering
                  disabled (an engine with ``hot_fraction=0`` that never
                  promotes a page), which is the placement's business,
                  not the mode's.  The serve CLI, as the reference's,
                  gives beacon the same hot tier as every mode.

Shards.  ``PagingConfig.n_shards`` = S is the reference's tp axis.  One
device holds every shard: the cold tier is S equal slices of one tensor,
each shard's mask is ``page_to_shard == s``, and the per-shard partials
are summed in shard order (``kernels/ref.shard_sum``), the order of the
reference's psum on its CPU mesh.  ``combine='psum_scatter'`` gives the
same values as 'psum', the whole (B, G, D) batch (one device holds every
bag slice).  There is no dp axis: the batch is one data-parallel group.

State is an ``EngineState`` of tensors; every method is functional but the
streaming updates (:meth:`apply_deltas`, :meth:`requant_hot_pages`) and
the page repair (:meth:`write_page`), which write the tiers in place.  State crosses from the reference engine as the
placement-free triple of ``export_state`` plus a page table, into
:meth:`pack_state`.

Lookups take the gather-once knob ``dedup`` (off / auto / on), resolved
once per signature (:meth:`_resolve_dedup`).  Maintenance is the
reference's: :meth:`observe` keeps the page-access histogram, and
:meth:`plan_and_migrate` places the hot tier with ``core.planner`` and
moves the pages (:meth:`migrate`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core import sls as sls_ops
from repro_torch.core import updates as upd
from repro_torch.core.paging import (HOT_SHARD, PageTable, PagingConfig,
                                     host, initial_page_table, locate,
                                     placement_gather_indices)
from repro_torch.core.planner import PlannerConfig, plan
from repro_torch.core.staging import BatchStager
from repro_torch.device import DeviceLike, is_fake, resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import clamp_rows, shard_sum
from repro_torch.trace import span

FUSED_BLOCK_B = 32   # the reference's fused batch tile (``block_b``), which
#                      its fused staging budget counts
MOVE_BLOCK_PAGES = 1 << 14  # pages packed or promoted at a time by
#                            from_codes and an in-place migrate


@dataclasses.dataclass
class EngineState:
    cold: torch.Tensor           # (n_shards * rows_per_shard, D) fp32, or
    #                              int8 codes; shard s at rows_per_shard * s
    hot: torch.Tensor            # (hot_rows, D) fp32 (never quantized)
    page_scales: torch.Tensor    # (num_pages,) f32 per-page dequant scales,
    #                              indexed by *global* page id (all ones for
    #                              fp32), so a scale travels with its page
    page_to_shard: torch.Tensor  # (num_pages,) int32; HOT_SHARD => hot tier
    page_to_slot: torch.Tensor   # (num_pages,) int32
    counts: torch.Tensor         # (num_pages,) f32 access histogram

    @property
    def page_table(self) -> PageTable:
        return PageTable(self.page_to_shard, self.page_to_slot)


class PIFSEmbeddingEngine:
    """Paged multi-table embedding with a hot tier and ``n_shards`` cold
    shards, on one device."""

    DEDUP_MODES = ("off", "auto", "on")
    FRONT_END_MODES = ("split", "fused")
    TIER_MODES = ("all", "hot_only")

    def __init__(self, paging: PagingConfig, device: DeviceLike = None,
                 planner: Optional[PlannerConfig] = None,
                 dedup: str = "off", dedup_auto_threshold: float = 1.5,
                 dedup_staging_bytes: int = 4 << 20,
                 validate_ids: bool = False):
        """``device`` defaults to the card (raises without CUDA; pass
        ``"cpu"`` for the CPU).  ``dedup`` is the engine-wide default of
        the gather-once knob; ``dedup_auto_threshold`` the expected
        duplicate factor above which 'auto' turns it on, and
        ``dedup_staging_bytes`` the staging budget above which a signature
        falls back to the per-entry gather (the reference's 4 MiB).
        ``validate_ids`` makes lookups check ids against the padded
        address space on the host and raise, instead of serving the
        clamped row that an out-of-range id addresses (:meth:`_address`)."""
        if dedup not in self.DEDUP_MODES:
            raise ValueError(f"unknown dedup {dedup!r}; "
                             f"expected one of {self.DEDUP_MODES}")
        self.cfg = paging
        self.device = resolve_device(device)
        self.planner = planner or PlannerConfig()
        self.default_dedup = dedup
        self.dedup_auto_threshold = dedup_auto_threshold
        self.dedup_staging_bytes = dedup_staging_bytes
        # a measured duplicate factor that 'auto' takes as evidence beside
        # the histogram's expectation (set by serving's prime_dedup_auto)
        self.dedup_auto_hint: Optional[float] = None
        self.validate_ids = validate_ids
        self._dedup_plans: dict = {}   # key -> dedup resolution record
        self._fe_plans: dict = {}      # key -> front-end resolution record
        self._calls = 0                # lookups since reset_plan_stats
        self._seen: set = set()        # lookup / interact signatures served
        self._traces = 0               # of them, first seen since the reset

    @property
    def quantized(self) -> bool:
        return self.cfg.storage == "int8"

    @property
    def cold_dtype(self) -> torch.dtype:
        """Cold-tier storage dtype (int8 codes for storage='int8')."""
        return torch.int8 if self.quantized else torch.float32

    def _as(self, x, dtype=None) -> torch.Tensor:
        """A tensor on this engine's device from a tensor or array-like
        (e.g. the reference engine's arrays)."""
        return torch.as_tensor(x if torch.is_tensor(x) else np.array(x),
                               dtype=dtype, device=self.device)

    def _table(self, table: Optional[PageTable]) -> PageTable:
        if table is None:
            return initial_page_table(self.cfg, self.device)
        return PageTable(self._as(table.page_to_shard, torch.int32),
                         self._as(table.page_to_slot, torch.int32))

    def _page_rows(self, table: PageTable):
        """(cold_dst, cold_src, hot_dst, hot_src) row maps of a placement:
        logical row ``src`` lives at storage row ``dst`` of its tier."""
        c = self.cfg
        ps = c.page_size
        shard = table.page_to_shard.long()
        slot = table.page_to_slot.long()
        off = torch.arange(ps, device=self.device)
        if is_fake(shard):
            # a dry-run places as initial_page_table does: every page cold
            cold_pages = torch.arange(c.num_pages, device=self.device)
            hot_pages = cold_pages[:0]
        else:
            cold_pages = torch.nonzero(shard != HOT_SHARD)[:, 0]
            hot_pages = torch.nonzero(shard == HOT_SHARD)[:, 0]
        cold_base = (shard * c.rows_per_shard + slot * ps)[cold_pages]
        hot_base = (slot * ps)[hot_pages]
        return ((cold_base[:, None] + off).reshape(-1),
                (cold_pages[:, None] * ps + off).reshape(-1),
                (hot_base[:, None] + off).reshape(-1),
                (hot_pages[:, None] * ps + off).reshape(-1))

    # ------------------------------------------------------------------ init
    def state_shapes(self, device: DeviceLike = None) -> EngineState:
        """Empty tensors shaped and typed as :meth:`init_state` builds them
        (the reference's ``state_shapes``), on ``device`` (default: the
        engine's).  Under a ``FakeTensorMode`` they are fake and nothing
        is allocated: a dry-run's engine state."""
        c = self.cfg
        dev = self.device if device is None else resolve_device(device)

        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=dev)
        return EngineState(
            cold=empty((c.cold_rows_total, c.dim), self.cold_dtype),
            hot=empty((c.hot_rows, c.dim), torch.float32),
            page_scales=empty((c.num_pages,), torch.float32),
            page_to_shard=empty((c.num_pages,), torch.int32),
            page_to_slot=empty((c.num_pages,), torch.int32),
            counts=empty((c.num_pages,), torch.float32))

    def init_state(self, generator: torch.Generator, scale: float = 0.01,
                   table: Optional[PageTable] = None) -> EngineState:
        """Random-init tables from ``generator`` (normal * ``scale``,
        drawn on the generator's device), placed by ``table`` (default:
        the initial round-robin interleave with an empty hot tier)."""
        c = self.cfg
        dense = torch.randn((c.padded_rows, c.dim), generator=generator,
                            device=generator.device) * scale
        return self.from_dense(dense, table)

    def from_dense(self, dense: torch.Tensor,
                   table: Optional[PageTable] = None) -> EngineState:
        """Pack a dense (rows, D) fp32 table into paged storage.  With
        ``storage='int8'`` every page gets a symmetric per-page scale and
        cold pages hold int8 codes; hot pages keep their fp32 values."""
        c = self.cfg
        table = self._table(table)
        dense = dense.to(self.device, torch.float32)
        if dense.shape[0] < c.padded_rows:
            dense = torch.cat([dense, dense.new_zeros(
                (c.padded_rows - dense.shape[0], c.dim))])
        if self.quantized:
            q_pages, scales = quant.quantize_pages(
                dense.reshape(c.num_pages, c.page_size, c.dim))
            cold_vals = q_pages.reshape(-1, c.dim)
        else:
            scales = torch.ones(c.num_pages, device=self.device)
            cold_vals = dense
        return self._pack(cold_vals, dense, scales, table, None)

    def from_codes(self, codes: torch.Tensor, scales: torch.Tensor,
                   table: Optional[PageTable] = None) -> EngineState:
        """Pack an int8 table given as its codes, (padded_rows, D) int8,
        and its per-page scales (num_pages,): cold slots take the codes
        verbatim and hot slots ``code * scale``, as :meth:`pack_state`
        packs ``(codes, dequantized codes, scales)``, bit for bit.  Page
        range by page range (``MOVE_BLOCK_PAGES``): the cold tier is the
        only copy of the table it makes, so a table of most of the card's
        memory packs beside its codes."""
        c = self.cfg
        if not self.quantized:
            raise TypeError("from_codes packs an int8 cold tier; use "
                            "from_dense for storage='fp32'")
        if (tuple(codes.shape) != (c.padded_rows, c.dim)
                or codes.dtype != torch.int8
                or tuple(scales.shape) != (c.num_pages,)):
            raise ValueError(
                f"codes must be ({c.padded_rows}, {c.dim}) int8 and scales "
                f"({c.num_pages},); got {tuple(codes.shape)} {codes.dtype} "
                f"and {tuple(scales.shape)}")
        table = self._table(table)
        ps, D = c.page_size, c.dim
        scales = self._as(scales, torch.float32)
        cold = torch.zeros((c.cold_rows_total, D), dtype=torch.int8,
                           device=self.device)
        hot = torch.zeros((c.hot_rows, D), dtype=torch.float32,
                          device=self.device)
        cold_pages, hot_pages = cold.view(-1, ps, D), hot.view(-1, ps, D)
        shard = table.page_to_shard.long()
        slot = table.page_to_slot.long()
        for p0 in range(0, c.num_pages, MOVE_BLOCK_PAGES):
            p1 = min(p0 + MOVE_BLOCK_PAGES, c.num_pages)
            src = codes[p0 * ps:p1 * ps].to(self.device).view(-1, ps, D)
            sh, sl = shard[p0:p1], slot[p0:p1]
            on_hot = sh == HOT_SHARD
            cold_at = torch.nonzero(~on_hot)[:, 0]
            hot_at = torch.nonzero(on_hot)[:, 0]
            cold_pages[(sh * c.pages_per_shard + sl)[cold_at]] = src[cold_at]
            hot_pages[sl[hot_at]] = quant.dequantize_pages(
                src[hot_at], scales[p0 + hot_at])
        return EngineState(
            cold=cold, hot=hot, page_scales=scales,
            page_to_shard=table.page_to_shard,
            page_to_slot=table.page_to_slot,
            counts=torch.zeros(c.num_pages, device=self.device))

    def _pack(self, codes, values, scales, table: PageTable,
              counts) -> EngineState:
        c = self.cfg
        cold_dst, cold_src, hot_dst, hot_src = self._page_rows(table)
        cold = torch.zeros((c.cold_rows_total, c.dim), dtype=self.cold_dtype,
                           device=self.device)
        hot = torch.zeros((c.hot_rows, c.dim), dtype=torch.float32,
                          device=self.device)
        cold[cold_dst] = codes[cold_src].to(self.cold_dtype)
        hot[hot_dst] = values[hot_src].to(torch.float32)
        return EngineState(
            cold=cold, hot=hot,
            page_scales=self._as(scales, torch.float32),
            page_to_shard=table.page_to_shard,
            page_to_slot=table.page_to_slot,
            counts=(torch.zeros(c.num_pages, device=self.device)
                    if counts is None else self._as(counts, torch.float32)))

    def _logical_rows(self, state: EngineState):
        """Per logical row: its cold-tier row, hot-tier row and tier."""
        c = self.cfg
        row = torch.arange(c.padded_rows, device=self.device)
        shard, local_row, is_hot = locate(c, state.page_table, row)
        cold_pos = shard.long() * c.rows_per_shard + local_row
        zero = torch.zeros_like(local_row)
        cold_rows = state.cold[torch.where(is_hot, zero, cold_pos)]
        hot_rows = state.hot[torch.where(is_hot, local_row, zero)]
        scales = state.page_scales[row // c.page_size][:, None]
        return cold_rows, hot_rows, is_hot[:, None], scales

    def to_dense(self, state: EngineState) -> torch.Tensor:
        """The effective (padded_rows, D) fp32 table every lookup computes
        against (int8 cold rows dequantized)."""
        cold_rows, hot_rows, is_hot, scales = self._logical_rows(state)
        if self.quantized:
            cold_rows = quant.dequantize_rows(cold_rows, scales)
        return torch.where(is_hot, hot_rows, cold_rows)

    def export_state(self, state: EngineState
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Placement-invariant export ``(codes, values, scales)``: codes in
        the cold-tier storage dtype (hot rows re-quantized on their page's
        carried scale), values fp32 (cold rows dequantized), scales
        untouched -- the reference's ``export_state`` triple."""
        cold_rows, hot_rows, is_hot, scales = self._logical_rows(state)
        if self.quantized:
            codes = torch.where(is_hot, quant.quantize_rows(hot_rows, scales),
                                cold_rows)
            values = torch.where(is_hot, hot_rows,
                                 quant.dequantize_rows(cold_rows, scales))
        else:
            codes = values = torch.where(is_hot, hot_rows, cold_rows)
        return codes, values, state.page_scales

    def pack_state(self, codes, values, page_scales,
                   table: Optional[PageTable] = None,
                   counts=None) -> EngineState:
        """Inverse of :meth:`export_state` under any placement: cold slots
        take ``codes`` verbatim, hot slots ``values``, scales are carried
        untouched.  Inputs may be numpy arrays (e.g. the reference
        engine's export) or tensors."""
        return self._pack(self._as(codes), self._as(values),
                          page_scales, self._table(table), counts)

    # ---------------------------------------------------------------- lookup
    def _check_ids(self, indices: torch.Tensor) -> None:
        """Strict-mode guard: raise on ids outside the padded address
        space (an out-of-range id would serve a clamped row).  Takes a
        tensor or a host array (``ServeBinding.execute`` checks the host
        batch before it reaches the card).  A dry-run's fake ids are not
        checked: they have no values."""
        if is_fake(indices):
            return
        idx = host(indices)
        bad = (idx < 0) | (idx >= self.cfg.padded_rows)
        if bad.any():
            example = int(idx[np.unravel_index(np.argmax(bad), idx.shape)])
            raise ValueError(
                f"validate_ids: {int(bad.sum())} out-of-range id(s) in lookup "
                f"batch (e.g. {example}; valid range is [0, "
                f"{self.cfg.padded_rows}))")

    def _check_knobs(self, mode: str, combine: str, dedup: Optional[str]
                     ) -> str:
        if mode not in ("pifs", "pond", "beacon"):
            raise ValueError(f"unknown mode {mode!r}")
        if combine not in ("psum", "psum_scatter"):
            raise ValueError(f"unknown combine {combine!r}")
        dedup = self.default_dedup if dedup is None else dedup
        if dedup not in self.DEDUP_MODES:
            raise ValueError(f"unknown dedup {dedup!r}; "
                             f"expected one of {self.DEDUP_MODES}")
        return dedup

    def lookup(self, state: EngineState, indices: torch.Tensor,
               weights: Optional[torch.Tensor] = None, mode: str = "pifs",
               combine: str = "psum", impl: str = "cuda",
               dedup: Optional[str] = None,
               tiers: str = "all", bag_edges=None) -> torch.Tensor:
        """Pooled lookup: indices (B, G, L) int32 global row ids, optional
        weights (B, G, L) f32 -> (B, G, D) f32.  With ``bag_edges`` the T
        bags of an item differ in length: indices and weights are (B, C),
        table t's bag in the columns [bag_edges[t], bag_edges[t + 1]), and
        the result is (B, T, D), one ``ragged_sls`` launch a tier (pifs
        and beacon, dedup off; the edges key the signature).
        ``tiers='hot_only'`` reads
        the hot tier only (cold contributions are exact zeros; the serving
        brown-out rung).  ``combine='psum_scatter'`` returns the same
        values as 'psum' and raises where the reference cannot split the
        bags (pond: the batch) over the shards.  ``impl``: see
        ``kernels/ops.py``.

        ``dedup`` ('off' | 'auto' | 'on', None = the engine default):
        gather-once coalescing, bitwise equal to 'off'.  The decision is
        frozen per signature and recorded in ``plan_stats()['dedup']``."""
        dedup = self._check_knobs(mode, combine, dedup)
        if tiers not in self.TIER_MODES:
            raise ValueError(f"unknown tiers {tiers!r}; "
                             f"expected one of {self.TIER_MODES}")
        if self.validate_ids:
            self._check_ids(indices)
        key = ("lookup", mode, combine, impl, self.cfg.storage, dedup, tiers,
               tuple(indices.shape), weights is not None)
        if bag_edges is not None:
            edges = tuple(int(c) for c in bag_edges)
            if mode == "pond" or dedup != "off":
                raise ValueError(
                    "bags that differ in length take the pifs datapath "
                    f"with dedup off; got mode {mode!r}, dedup {dedup!r}")
            self._note_signature(("lookup_ragged",) + key[1:] + (edges,))
            return self._lookup_ragged(state, indices, weights, edges,
                                       combine=combine, impl=impl,
                                       tiers=tiers)
        dedup_on = self._resolve_dedup(key, dedup, state, indices)
        self._note_signature(key)
        return self._lookup_block(state, indices, weights, mode=mode,
                                  combine=combine, impl=impl, tiers=tiers,
                                  dedup=dedup_on)

    def lookup_interact(self, state: EngineState, indices: torch.Tensor,
                        dense_feature: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        mode: str = "pifs", combine: str = "psum",
                        impl: str = "cuda",
                        dedup: Optional[str] = None,
                        front_end: str = "split") -> torch.Tensor:
        """Pooled lookup fused with the DLRM dot interaction: indices
        (B, G, L), dense_feature (B, D) the bottom-MLP output (feature row
        0) -> (B, P) packed lower triangle.  ``front_end='split'`` pools
        (:meth:`lookup`'s datapath for ``mode``) then interacts;
        ``'fused'`` resolves to the single three-phase kernel at one shard
        in pifs/beacon, and to ``'fused_tp'`` at n_shards > 1 or in pond:
        a partial pool per shard, the cold tiles summed in shard order and
        the resume kernel (:meth:`_resolve_front_end`).  The resolution is
        recorded in ``plan_stats()['front_end']``, the ``dedup`` one as in
        :meth:`lookup`.  ``combine`` only keys the record, as in the
        reference.  For pifs/beacon, split and fused, dedup on or off, are
        bitwise equal; pond's fused front end pools before the shard sum,
        so it equals pifs, not pond's split path, bitwise."""
        dedup = self._check_knobs(mode, combine, dedup)
        if front_end not in self.FRONT_END_MODES:
            raise ValueError(f"unknown front_end {front_end!r}; "
                             f"expected one of {self.FRONT_END_MODES}")
        if dense_feature.ndim != 2 or dense_feature.shape[-1] != self.cfg.dim:
            raise ValueError(
                f"dense_feature must be (B, {self.cfg.dim}); got "
                f"{tuple(dense_feature.shape)}")
        if self.validate_ids:
            self._check_ids(indices)
        key = ("interact", mode, combine, impl,
               self.cfg.storage, dedup, front_end, tuple(indices.shape),
               weights is not None)
        rec = self._fe_plans.get(key)
        if rec is None:
            rec = self._fe_plans[key] = self._resolve_front_end(front_end,
                                                                mode)
        resolved = rec["resolved"]
        dedup_on = self._resolve_dedup(
            key, dedup, state, indices,
            fused_blocks=None if resolved == "split" else FUSED_BLOCK_B)
        self._note_signature(key)
        if resolved == "fused":
            return self._interact_block_fused(state, indices, dense_feature,
                                              weights, impl=impl,
                                              dedup=dedup_on)
        if resolved == "fused_tp":
            return self._interact_block_fused_tp(
                state, indices, dense_feature, weights, impl=impl,
                dedup=dedup_on)
        pooled = self._lookup_block(state, indices, weights, mode=mode,
                                    combine="psum", impl=impl,
                                    dedup=dedup_on)
        feats = torch.cat([dense_feature[:, None, :], pooled], dim=1)
        return kernel_ops.dot_interaction(feats, impl=impl)

    def _resolve_front_end(self, front_end: str, mode: str) -> dict:
        """The reference's resolution, with tp = ``n_shards``: 'split' as
        requested; a fused request at tp > 1, or in pond, resolves
        'fused_tp' (partial pool per shard -> shard sum of the cold tiles
        -> resume); otherwise 'fused', the single three-phase kernel."""
        tp = self.cfg.n_shards
        if front_end == "split":
            resolved, reason = "split", "requested"
        elif tp > 1:
            resolved, reason = "fused_tp", (
                f"tp-sharded masked partials (tp={tp}): each shard pools "
                "its partial (B, F, D) cold tile; the cross-shard psum "
                "lands between the partial-pool and resume kernels")
        elif mode == "pond":
            resolved, reason = "fused_tp", (
                "pond requesting fusion pools cold partials before the "
                "hot/cold add (partial-pool -> psum -> resume) instead of "
                "shipping raw rows")
        else:
            resolved, reason = "fused", "replicated/dp-sharded config"
        return {"requested": front_end, "resolved": resolved,
                "reason": reason, "tp": tp}

    # ------------------------------------------------------------ dedup
    def _resolve_dedup(self, key, dedup: str, state: EngineState,
                       indices: torch.Tensor,
                       fused_blocks: Optional[int] = None) -> bool:
        """Freeze the gather-once decision for one signature (the
        reference's, at dp = 1).  'on' falls back when the worst-case
        staging of one device exceeds ``dedup_staging_bytes``: one shard's
        entries, as each of the reference's devices stages its own (here
        the S shards' stagings are live at once); 'auto' also needs the best
        duplicate-factor evidence -- the page histogram's expectation, the
        factor measured on this first batch, or the serving hint -- to
        reach ``dedup_auto_threshold``.  Runs on the host once per
        signature; the record goes to ``plan_stats()['dedup']``."""
        if dedup == "off":
            return False
        rec = self._dedup_plans.get(key)
        if rec is not None:
            return rec["resolved"]
        B, G, L = indices.shape
        n_entries = max(B, 1) * G * L
        D = self.cfg.dim
        if fused_blocks is None:
            # split: the hot and cold accumulates run one after the other,
            # so one (n_entries, D) fp32 staging is live at a time
            staging_bytes = n_entries * D * 4
        else:
            # fused: both tiers' stagings plus the two (BB*F, D) per-tier
            # feature tiles of the reference's kernel
            b_local = max(B, 1)
            BB = max(1, min(fused_blocks, b_local))
            while b_local % BB:
                BB //= 2
            staging_bytes = 2 * n_entries * D * 4 + 2 * BB * (G + 1) * D * 4
        capacity_ok = staging_bytes <= self.dedup_staging_bytes
        if is_fake(state.counts) or is_fake(indices):
            # a dry-run has no histogram and no ids: only the serving hint
            # is evidence, and without it 'auto' stays off, the step
            # builders' default
            expected = measured = None
        else:
            expected = self._expected_dup_factor(host(state.counts),
                                                 n_entries)
            measured = self.dedup_factor(state, indices)["factor"]
        if dedup == "on":
            resolved = capacity_ok
        else:
            signals = [x for x in (expected, measured, self.dedup_auto_hint)
                       if x is not None]
            resolved = capacity_ok and bool(signals) and max(signals) >= \
                self.dedup_auto_threshold
        self._dedup_plans[key] = {
            "requested": dedup, "resolved": bool(resolved),
            "capacity_ok": bool(capacity_ok),
            "expected_factor": None if expected is None else float(expected),
            "measured_factor": measured,
            "hint_factor": self.dedup_auto_hint,
        }
        return bool(resolved)

    def _expected_dup_factor(self, counts: np.ndarray, n_entries: int
                             ) -> float:
        """Expected duplicate factor of ``n_entries`` draws from the row
        distribution the page histogram implies (uniform within a page):
        ``n / E[unique]``, ``E[unique] = sum_r 1 - (1 - p_r)^n``.  An
        all-zero histogram is a uniform prior over all rows."""
        c = np.asarray(counts, np.float64)
        ps = self.cfg.page_size
        tot = c.sum()
        if tot <= 0:
            p = np.full(1, 1.0 / max(self.cfg.padded_rows, 1))
            rows_per_p = np.full(1, float(self.cfg.padded_rows))
        else:
            p = c / (tot * ps)
            rows_per_p = np.full_like(c, float(ps))
        e_unique = float((rows_per_p * -np.expm1(
            n_entries * np.log1p(-np.minimum(p, 1 - 1e-12)))).sum())
        return n_entries / max(e_unique, 1.0)

    def dedup_factor(self, state: EngineState, indices,
                     weights=None) -> dict:
        """Measured duplicate-access factor of one batch: a host replay of
        what the gather-once datapath gathers (each shard's unique owned
        cold rows plus the unique hot rows), counting weight != 0 entries
        only.  Returns entries, unique_cold / unique_hot / unique_rows and
        ``factor = entries / unique_rows``."""
        c = self.cfg
        idx = host(indices).reshape(-1)
        if weights is not None:
            idx = idx[host(weights).reshape(-1) != 0]
        ps = c.page_size
        # clamp as the device gathers do: the probe never fails on traffic
        # the engine itself would serve
        page = np.clip(idx // ps, 0, c.num_pages - 1)
        shard = host(state.page_to_shard)[page]
        local = host(state.page_to_slot)[page].astype(np.int64) * ps \
            + idx % ps
        unique_cold = sum(int(np.unique(local[shard == s]).size)
                          for s in range(c.n_shards))
        unique_hot = int(np.unique(local[shard == HOT_SHARD]).size)
        unique_rows = unique_cold + unique_hot
        return {"entries": int(idx.size), "unique_cold": unique_cold,
                "unique_hot": unique_hot, "unique_rows": unique_rows,
                "factor": idx.size / max(unique_rows, 1)}

    def _note_signature(self, key) -> None:
        self._calls += 1
        if key not in self._seen:
            self._seen.add(key)
            self._traces += 1

    def plan_stats(self) -> dict:
        """Lookups since the last reset (``calls``); the lookup and
        interact signatures served (``plans``), of them the lookups of bags
        that differ in length (``ragged``), and those first seen since
        the last reset (``traces``); one front-end resolution record per
        ``lookup_interact`` signature under ``'front_end'``; and, once a
        lookup asked for ``dedup`` 'auto' or 'on', one dedup resolution
        record per such signature under ``'dedup'``.

        ``traces`` is the port's counterpart of the reference's retrace
        count: the port compiles nothing per shape, so a signature first
        seen after serving's warmup is a bucket the warmup missed."""
        out = {"plans": len(self._seen), "traces": self._traces,
               "calls": self._calls,
               "ragged": sum(k[0] == "lookup_ragged" for k in self._seen),
               "front_end": {self._key_label(k): dict(v)
                             for k, v in self._fe_plans.items()}}
        if self._dedup_plans:
            out["dedup"] = {self._key_label(k): dict(v)
                            for k, v in self._dedup_plans.items()}
        return out

    def reset_plan_stats(self, clear_plans: bool = False) -> None:
        """Zero the call and trace counters; ``clear_plans`` also forgets
        the signatures seen and drops the dedup and front-end resolution
        records, so every signature resolves (and counts) again, against
        the histogram as it is then."""
        if clear_plans:
            self._dedup_plans.clear()
            self._fe_plans.clear()
            self._seen.clear()
        self._calls = 0
        self._traces = 0

    @staticmethod
    def _key_label(key) -> str:
        if key[0] == "interact":
            (_, mode, combine, impl, storage, dedup, front_end, shape,
             weighted) = key
            head, tail = "interact:", f"/fe={front_end}"
        else:
            (_, mode, combine, impl, storage, dedup, tiers, shape,
             weighted, *bags) = key
            head, tail = "", "" if tiers == "all" else f"/{tiers}"
            if bags:
                tail += "/bags=" + "-".join(
                    str(b - a) for a, b in zip(bags[0], bags[0][1:]))
        return (f"{head}{mode}/{combine}/{impl}/{storage}/dedup={dedup}"
                f"{tail}/idx={'x'.join(map(str, shape))}"
                + ("+w" if weighted else ""))

    # ------------------------------------------------------ maintenance
    def observe(self, state: EngineState, indices: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> EngineState:
        """Add a batch to the page-access histogram (the paper's profiler).
        An entry counts 1 iff its weight (when given) is non-zero, so bucket
        padding never skews the ranking.  Pages index as the reference's
        scatter does: a negative page wraps once (page -1 is the last), and
        what is still outside the table is dropped."""
        c = self.cfg
        page = indices.reshape(-1).long() // c.page_size
        page = torch.where(page < 0, page + c.num_pages, page)
        inc = torch.ones(page.shape, dtype=torch.float32, device=page.device)
        if weights is not None:
            inc = (weights.reshape(-1) != 0).to(torch.float32)
        ok = (page >= 0) & (page < c.num_pages)
        local = torch.zeros(c.num_pages, dtype=torch.float32,
                            device=state.counts.device).index_add_(
            0, torch.where(ok, page, 0), torch.where(ok, inc, 0.0))
        return dataclasses.replace(state, counts=state.counts + local)

    def plan_and_migrate(self, state: EngineState
                         ) -> Tuple[EngineState, dict]:
        """Host-side plan (hotness + spreading, ``core.planner``) from the
        histogram, then the move (:meth:`migrate`)."""
        new_table, stats = plan(self.cfg, state.page_table,
                                host(state.counts), self.planner)
        return self.migrate(state, new_table), stats

    def migrate(self, state: EngineState, new_table: PageTable,
                count_decay: float = 0.5) -> EngineState:
        """Execute a placement change as a row gather (cache-line-granular
        migration, paper IV-B4).  int8: cold->cold moves codes verbatim,
        promotion dequantizes into the fp32 hot tier and demotion
        re-quantizes with the page's carried scale, so lookups are
        placement-invariant in the quantized domain.  ``count_decay``
        scales the histogram after the move.

        One device holds every shard's cold tier, so no all-gather: the new
        tiers gather from the old cold and hot tiers apart, and the
        concatenation the reference gathers from is never built.

        ``state`` is consumed: where the move's new tiers and row maps do
        not fit in the device's free memory (:meth:`_move_in_place`), it
        moves only the pages whose place changes, in the tiers of
        ``state``, which the returned state then shares -- for a tier of
        most of the card's memory.  Every page's rows equal the functional
        move's; slots no page maps to keep what they held."""
        if self._move_in_place(state):
            return self._migrate_inplace(state, new_table, count_decay)
        c = self.cfg
        C = c.cold_rows_total
        cold_src, hot_src = placement_gather_indices(c, state.page_table,
                                                     new_table)
        dev = self.device

        def split(src):
            """Row sources as (from the cold tier, positions taking a hot
            row, the hot rows they take)."""
            from_hot = src >= C
            pos = np.nonzero(from_hot)[0]
            return (torch.as_tensor(np.where(from_hot, 0, src), device=dev),
                    torch.as_tensor(pos, device=dev),
                    torch.as_tensor(src[pos] - C, device=dev))

        cs_cold, cs_pos, cs_hot = split(cold_src)
        hs_cold, hs_pos, hs_hot = split(hot_src)
        new_cold = state.cold[cs_cold]
        if self.quantized:
            new_hot = quant.dequantize_rows(
                state.cold[hs_cold], self._hot_row_scales(state, new_table))
            # demotions: re-quantize the hot rows on their carried scale
            old_hot_q = quant.quantize_rows(
                state.hot, self._hot_row_scales(state, state.page_table))
            new_cold[cs_pos] = old_hot_q[cs_hot]
        else:
            new_hot = state.cold[hs_cold]
            new_cold[cs_pos] = state.hot[cs_hot]
        new_hot[hs_pos] = state.hot[hs_hot]
        return EngineState(
            cold=new_cold, hot=new_hot, page_scales=state.page_scales,
            page_to_shard=self._as(new_table.page_to_shard, torch.int32),
            page_to_slot=self._as(new_table.page_to_slot, torch.int32),
            counts=state.counts * count_decay)

    def _move_in_place(self, state: EngineState) -> bool:
        """Whether :meth:`migrate` moves pages in place: on a CUDA device
        whose free memory (``mem_get_info`` plus the allocator's cached
        blocks) cannot hold the functional move's new tiers, its dequantized hot
        rows and its row maps (int64, two per storage row)."""
        dev = state.cold.device
        if dev.type != "cuda":
            return False
        c = self.cfg
        need = (state.cold.nbytes + 2 * state.hot.nbytes
                + 16 * (c.cold_rows_total + c.hot_rows))
        free, _ = torch.cuda.mem_get_info(dev)
        free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(
            dev)
        return need > free

    def _migrate_inplace(self, state: EngineState, new_table: PageTable,
                         count_decay: float) -> EngineState:
        """:meth:`migrate` in place: every page that lands in the
        cold tier (a demotion, re-quantized on its carried scale, or a cold
        move) and every hot-to-hot move is read into a buffer before any
        write; promotions are then dequantized from the cold tier, still
        unwritten, ``MOVE_BLOCK_PAGES`` at a time, and the buffers
        written."""
        c = self.cfg
        ps, D = c.page_size, c.dim
        old_sh = host(state.page_to_shard)
        old_sl = host(state.page_to_slot).astype(np.int64)
        new_sh = host(new_table.page_to_shard).astype(np.int32)
        new_sl = host(new_table.page_to_slot).astype(np.int64)
        moved = np.nonzero((old_sh != new_sh) | (old_sl != new_sl))[0]
        was_hot = old_sh[moved] == HOT_SHARD
        is_hot = new_sh[moved] == HOT_SHARD
        cold_pages = state.cold.view(-1, ps, D)
        hot_pages = state.hot.view(-1, ps, D)

        def at(x):
            return torch.as_tensor(x, device=self.device)

        def cold_slot(sh, sl):
            return sh.astype(np.int64) * c.pages_per_shard + sl

        def read(pages):
            """The pages' rows in the cold tier's dtype, from either tier."""
            out = torch.empty((len(pages), ps, D), dtype=self.cold_dtype,
                              device=self.device)
            from_hot = old_sh[pages] == HOT_SHARD
            h, k = np.nonzero(from_hot)[0], np.nonzero(~from_hot)[0]
            rows = hot_pages[at(old_sl[pages[h]])]
            if self.quantized:
                rows = quant.quantize_rows(
                    rows, state.page_scales[at(pages[h])][:, None, None])
            out[at(h)] = rows
            out[at(k)] = cold_pages[at(cold_slot(old_sh[pages[k]],
                                                 old_sl[pages[k]]))]
            return out

        to_cold = moved[~is_hot]
        hot_moves = moved[is_hot & was_hot]
        promoted = moved[is_hot & ~was_hot]
        cold_buf = read(to_cold)
        hot_buf = hot_pages[at(old_sl[hot_moves])]
        for b0 in range(0, len(promoted), MOVE_BLOCK_PAGES):
            pg = promoted[b0:b0 + MOVE_BLOCK_PAGES]
            rows = cold_pages[at(cold_slot(old_sh[pg], old_sl[pg]))]
            if self.quantized:
                rows = quant.dequantize_pages(rows, state.page_scales[at(pg)])
            hot_pages[at(new_sl[pg])] = rows
        hot_pages[at(new_sl[hot_moves])] = hot_buf
        cold_pages[at(cold_slot(new_sh[to_cold], new_sl[to_cold]))] = \
            cold_buf
        return EngineState(
            cold=state.cold, hot=state.hot, page_scales=state.page_scales,
            page_to_shard=self._as(new_table.page_to_shard, torch.int32),
            page_to_slot=self._as(new_table.page_to_slot, torch.int32),
            counts=state.counts * count_decay)

    def _hot_row_scales(self, state: EngineState, table: PageTable
                        ) -> torch.Tensor:
        """Per hot-tier row, the carried scale of the page in that slot
        under ``table`` (page 0's for empty slots, whose content is
        unused) -> (hot_rows, 1)."""
        c = self.cfg
        shard, slot = host(table.page_to_shard), host(table.page_to_slot)
        per_slot = np.zeros(c.hot_pages, dtype=np.int64)
        hot = shard == HOT_SHARD
        per_slot[slot[hot]] = np.nonzero(hot)[0]
        page = torch.as_tensor(np.repeat(per_slot, c.page_size),
                               device=self.device)
        return state.page_scales[page][:, None]

    # ------------------------------------------------------ updates
    def apply_deltas(self, state: EngineState, rows, deltas,
                     impl: str = "cuda") -> EngineState:
        """Apply a batch of per-row additive deltas to the live tables.

        ``rows``: (U,) global row ids (host array or tensor),
        ``core.updates.PAD_ROW`` (= -1) for pad entries; rows must be
        *unique* (callers coalesce duplicates, so WAL replay is
        bit-identical).  ``deltas``: (U, D) float32.

        Tier semantics, the reference's: a hot row and an fp32 cold row
        add the delta; an int8 cold row is updated in its page's quantized
        domain under the carried scale, ``round(fma(q, scale, delta) /
        scale)`` clamped to +-127 (the reference's XLA contracts the
        dequantize-add into one fma), and keeps its codes where the scale
        is not positive.  A pad writes nothing, so a ``-0.0`` stays.  The
        values equal the reference's bit for bit.

        Unlike the reference, which returns a new state, this mutates
        ``state.cold`` and ``state.hot`` in place (one launch of the
        ``apply_deltas`` kernel on the card; ``impl`` as for lookups) and
        returns ``state``: RMC4's fp32 cold tier is 5.6 GB, and a
        functional update would move it through device memory on every
        chunk.  A row id at or past ``padded_rows`` raises, naming it.
        One signature per (storage, U), counted as lookups' are, so
        steady-state updates add no trace."""
        r = host(rows)
        if (r.ndim != 1 or len(np.shape(deltas)) != 2
                or np.shape(deltas)[0] != r.shape[0]):
            raise ValueError(
                f"rows must be (U,), deltas (U, D); got {r.shape} / "
                f"{tuple(np.shape(deltas))}")
        if np.shape(deltas)[1] != self.cfg.dim:
            raise ValueError(f"delta dim {np.shape(deltas)[1]} != table dim "
                             f"{self.cfg.dim}")
        if (r >= self.cfg.padded_rows).any():
            bad = int(r[r >= self.cfg.padded_rows][0])
            raise ValueError(
                f"apply_deltas: row id {bad} outside the padded address "
                f"space [0, {self.cfg.padded_rows})")
        rows = self._as(rows, torch.int32)
        deltas = self._as(deltas, torch.float32)
        self._note_signature(("update", self.cfg.storage, int(r.shape[0]),
                              "int32", "float32"))
        kernel_ops.apply_deltas(state.cold, state.hot, state.page_scales,
                                state.page_to_shard, state.page_to_slot,
                                rows, deltas, self.cfg.page_size,
                                self.cfg.rows_per_shard, impl=impl)
        return state

    def requant_hot_pages(self, state: EngineState, pages) -> EngineState:
        """Snap listed hot-resident pages back onto their carried-scale
        quantized grid, in place (no migration).

        ``pages``: (K,) global page ids, -1 for pads.  Each listed page's
        hot rows become ``dequantize(quantize(x, s), s)`` under its carried
        scale: the value a demote-then-promote round trip through the int8
        cold tier gives.  A no-op for fp32 storage; pages not hot-resident
        are skipped.  Elementwise with no multiply-add (a divide, a round,
        a multiply), so plain PyTorch equals the reference here and needs
        no kernel.  Mutates ``state.hot`` and returns ``state``; one
        signature per K."""
        if not self.quantized:
            return state
        pages = host(pages)
        if pages.ndim != 1:
            raise ValueError(f"pages must be (K,); got {pages.shape}")
        self._note_signature(("requant", int(pages.shape[0]), "int32"))
        ps = self.cfg.page_size
        shard = host(state.page_to_shard)
        pg = np.where(pages >= 0, pages, 0)
        sel = np.unique(pg[(pages >= 0) & (shard[pg] == HOT_SHARD)])
        if sel.size == 0:
            return state
        slot = host(state.page_to_slot)[sel].astype(np.int64)
        rows = torch.as_tensor((slot[:, None] * ps + np.arange(ps)).ravel(),
                               device=self.device)
        s = state.page_scales[torch.as_tensor(np.repeat(sel, ps),
                                              device=self.device)][:, None]
        state.hot[rows] = quant.dequantize_rows(
            quant.quantize_rows(state.hot[rows], s), s)
        return state

    # ------------------------------------------------------------ integrity
    def page_checksums(self, state: EngineState, pages,
                       impl: str = "cuda") -> torch.Tensor:
        """Per-page Fletcher-pair checksums over native-domain content
        (``core/integrity.py``).

        ``pages``: (K,) global page ids (host array or tensor), -1 for
        pads.  Returns (K, 2) ``[s1, s2]`` per page, zeros for pads: the
        reference's uint32 values, held in int64 (torch's uint32 has few
        operations).  A cold page is read from its shard's slice, a hot
        page from the hot tier, each with its scale's bits folded in.  One
        launch of the ``page_checksums`` kernel on the card for any K
        (``impl`` as for lookups), so one signature per storage, not per
        K as the reference's one plan per K."""
        pages = self._as(pages, torch.int32)
        if pages.dim() != 1:
            raise ValueError(f"pages must be (K,); got {tuple(pages.shape)}")
        self._note_signature(("checksum", self.cfg.storage, "int32"))
        return kernel_ops.page_checksums(
            state.cold, state.hot, state.page_scales, state.page_to_shard,
            state.page_to_slot, pages, self.cfg.page_size,
            self.cfg.rows_per_shard, impl=impl)

    def write_page(self, state: EngineState, page, cold_rows, hot_rows,
                   scale) -> EngineState:
        """Overwrite ONE page's resident rows and scale, in place (the
        repair path: the page's content from a snapshot and the WAL tail).

        ``page``: a global page id, or -1, which writes nothing (warmup).
        ``cold_rows``: (page_size, D) in the cold tier's dtype,
        ``hot_rows``: (page_size, D) fp32, ``scale``: the page's carried
        scale.  Only the payload of the page's *current* tier lands; pass
        zeros for the other.  The reference scatters into new arrays; like
        :meth:`apply_deltas`, this writes the live tiers and returns
        ``state``.  Plain indexing copies (the reference's scatter is jnp,
        no Pallas kernel); one signature per storage."""
        c = self.cfg
        page = int(page)
        if page >= c.num_pages:
            raise ValueError(f"write_page: page {page} outside [0, "
                             f"{c.num_pages})")
        ps, D = c.page_size, c.dim
        if tuple(np.shape(cold_rows)) != (ps, D) or \
                tuple(np.shape(hot_rows)) != (ps, D):
            raise ValueError(f"page payloads must be ({ps}, {D}); got "
                             f"{tuple(np.shape(cold_rows))} / "
                             f"{tuple(np.shape(hot_rows))}")
        self._note_signature(("page_write", c.storage))
        if page < 0:
            return state
        shard = int(state.page_to_shard[page])
        first = int(state.page_to_slot[page]) * ps
        if shard == HOT_SHARD:
            state.hot[first:first + ps] = self._as(hot_rows, torch.float32)
        else:
            first += shard * c.rows_per_shard
            state.cold[first:first + ps] = self._as(cold_rows,
                                                    self.cold_dtype)
        state.page_scales[page] = float(np.float32(scale))
        return state

    # ----------------------------------------------------------- the blocks
    def _address(self, state: EngineState, idx: torch.Tensor):
        """Each entry's storage row (local to its tier's slice), the
        per-shard ownership masks (n_shards, *idx.shape), the hot mask and
        (int8) the page scale.

        Any id is served, as the reference's gathers serve it: its page
        wraps once if negative and is then clamped into the table; the
        offset in the page is ``idx % ps``.  So an id past the end reads
        a row of the last page, and nothing indexes out of bounds (which
        on the card would be a device-side assert).  That is the kernels'
        row rule (``kernels/ref.py: clamp_rows``) applied to the page."""
        ps, n = self.cfg.page_size, self.cfg.num_pages
        idx = idx.long()
        page = clamp_rows(idx // ps, n)
        shard = state.page_to_shard[page]
        local_row = (state.page_to_slot[page].long() * ps
                     + idx % ps).to(torch.int32)
        S = self.cfg.n_shards
        if S == 1:
            owned = (shard == 0)[None]
        else:
            ids = torch.arange(S, dtype=shard.dtype, device=shard.device)
            owned = shard[None] == ids.view((-1,) + (1,) * shard.dim())
        is_hot = shard == HOT_SHARD
        scale = state.page_scales[page] if self.quantized else None
        return local_row, owned, is_hot, scale

    def _check_scatter(self, mode: str, tiers: str, b: int, nbags: int):
        """The reference's psum_scatter preconditions (per-device batch b =
        B at dp = 1)."""
        tp = self.cfg.n_shards
        if mode == "pond" and tiers == "all":
            if b % tp:
                raise ValueError(
                    f"per-device batch ({b}) must divide tp ({tp}) "
                    "for psum_scatter combine in pond mode")
        elif nbags % tp:
            raise ValueError(f"bags ({nbags}) must divide tp ({tp}) "
                             "for psum_scatter combine")

    def _lookup_block(self, state: EngineState, idx: torch.Tensor,
                      weights: Optional[torch.Tensor], *, mode: str,
                      combine: str, impl: str, tiers: str = "all",
                      dedup: bool = False) -> torch.Tensor:
        """The split datapath, every shard's block of the reference's
        ``_lookup_block`` on this device: the hot tier once; pifs/beacon
        pool each shard's cold partial (one launch for all shards) and sum
        them in shard order, then ``+ hot``; pond gathers each shard's raw
        rows, dequantizes them after the gather, weights them, sums them
        over shards and pools them over l (only the hot tier dedups)."""
        b, G, L = idx.shape
        nbags = b * G
        if combine == "psum_scatter":
            self._check_scatter(mode, tiers, b, nbags)
        local_row, owned, is_hot, scale = self._address(
            state, idx.reshape(nbags, L))
        w = None if weights is None else weights.reshape(nbags, L)
        hot_out = sls_ops.masked_partial_sls_dense(
            state.hot, local_row, is_hot, w, impl=impl, dedup=dedup)
        if tiers == "hot_only":
            return hot_out.reshape(b, G, -1)
        if mode == "pond":
            cold_out = self._pond_cold(state, local_row, owned, w, scale)
        else:
            cold_out = shard_sum(sls_ops.masked_partial_sls_dense(
                state.cold, local_row, owned, w, impl=impl, scales=scale,
                dedup=dedup))
        # the reference adds the summed cold partials and hot_out in this
        # operand order
        return (cold_out + hot_out).reshape(b, G, -1)

    def _lookup_ragged(self, state: EngineState, idx: torch.Tensor,
                       weights: Optional[torch.Tensor], edges: tuple, *,
                       combine: str, impl: str, tiers: str) -> torch.Tensor:
        """:meth:`_lookup_block`'s pifs datapath for bags that differ in
        length: (B, C) entries -> (B, T, D), the hot tier in one launch and
        every cold shard's partial in another, summed in shard order, then
        ``+ hot``."""
        b = idx.shape[0]
        if combine == "psum_scatter":
            self._check_scatter("pifs", tiers, b, b * (len(edges) - 1))
        local_row, owned, is_hot, scale = self._address(state, idx)
        hot_out = sls_ops.ragged_partial_sls_dense(
            state.hot, local_row, is_hot, edges, weights, impl=impl)
        if tiers == "hot_only":
            return hot_out
        cold_out = shard_sum(sls_ops.ragged_partial_sls_dense(
            state.cold, local_row, owned, edges, weights, impl=impl,
            scales=scale))
        return cold_out + hot_out

    def _pond_cold(self, state: EngineState, local_row: torch.Tensor,
                   owned: torch.Tensor, w: Optional[torch.Tensor],
                   scale: Optional[torch.Tensor]) -> torch.Tensor:
        """Pond's cold tier (communicate, then reduce): per shard the raw
        owned rows of its slice (zeros elsewhere), dequantized after the
        gather and weighted; the (nbags * L, D) rows summed over shards
        (exact: one shard owns each entry), then pooled over l."""
        nbags, L = local_row.shape
        R = self.cfg.rows_per_shard
        flat = local_row.reshape(-1)
        parts = []
        for s in range(self.cfg.n_shards):
            rows = sls_ops.masked_gather_rows(
                state.cold[s * R:(s + 1) * R], flat, owned[s].reshape(-1))
            if self.quantized:
                rows = quant.dequantize_rows(rows, scale.reshape(-1)[:, None])
            if w is not None:
                rows = rows * w.reshape(-1)[:, None]
            parts.append(rows)
        rows = shard_sum(parts)
        return rows.reshape(nbags, L, -1).sum(dim=1)

    def _interact_block_fused(self, state: EngineState, idx: torch.Tensor,
                              x: torch.Tensor,
                              weights: Optional[torch.Tensor], *, impl: str,
                              dedup: bool = False) -> torch.Tensor:
        """The fused datapath (one shard): the same address math as
        :meth:`_lookup_block`, then the single-kernel SLS -> interaction."""
        local_row, owned, is_hot, scale = self._address(state, idx)
        return sls_ops.fused_front_end_dense(
            state.cold, state.hot, x, local_row, owned[0], is_hot,
            weights=weights, scales=scale, impl=impl, dedup=dedup)

    def _interact_block_fused_tp(self, state: EngineState, idx: torch.Tensor,
                                 x: torch.Tensor,
                                 weights: Optional[torch.Tensor], *,
                                 impl: str, dedup: bool = False
                                 ) -> torch.Tensor:
        """The fused_tp datapath: every shard pools its owned rows into its
        (B, F, D) cold tile and the hot tier into one hot tile (one
        launch), then the resume kernel sums the cold tiles in shard order
        (the reference's psum), adds the hot tile and interacts.  Each
        shard pools in the split path's l-order, so this equals split
        bitwise."""
        local_row, owned, is_hot, scale = self._address(state, idx)
        part_c, part_h = sls_ops.fused_partial_pool_dense(
            state.cold, state.hot, x, local_row, owned, is_hot,
            weights=weights, scales=scale, impl=impl, dedup=dedup)
        return sls_ops.fused_resume_dense(part_c, part_h, impl=impl)


class ServeBinding:
    """The serving subsystem's seam onto the engine (the port of the
    reference's ``ServeBinding``).

    ``repro_torch.serving`` never touches engine internals: it drives this
    quadruple of (engine, state, model, serve step).  :meth:`execute` runs
    one bucket-shaped micro-batch and returns only after the card is done;
    :meth:`observe` / :meth:`replan` fold the paper's live page management
    (profile -> re-plan -> migration, section IV-B4) into the serving
    cadence -- lookups are placement-invariant, so a re-plan between
    micro-batches never perturbs in-flight numerics; and
    :meth:`plan_stats` exposes the signature count the batcher's bucket set
    is built around (one signature per bucket, none new once warmed).

    A step is ``step(state, batch) -> (B,) scores`` over a mapping of
    tensors on the engine's device, each copied there when the step first
    reads it (:meth:`execute`); ``model`` is the module whose
    parameters the steps close over (the reference's ``params``).  Opt-in
    seams, off by default:

      * ``steps`` -- named serve-step variants (the brown-out ladder's
        rungs: split front end, dedup off, hot-tier-only, ...);
        :meth:`set_mode` switches between them;
      * ``validate_ids`` -- a host-side check of the batch's ids *before*
        the step (the lookup would serve a clamped row);
      * ``scrub_scores`` -- NaN/Inf scores become 0, counted per batch
        (``last_poisoned``) and in total (``poisoned_rows`` /
        ``poisoned_batches``);
      * ``attach_wal`` / :meth:`apply_deltas` -- streaming updates: each
        delta batch is coalesced, logged to the write-ahead log, then
        applied in fixed-``update_capacity`` chunks (one signature);
      * ``attach_checkpointer`` / :meth:`snapshot` / :meth:`restore` --
        commit the state (the WAL truncates) and reload it between
        micro-batches, replaying the WAL's suffix, so a restore loses no
        update;
      * :meth:`attach_integrity` -- the per-page checksum ledger
        (``core/integrity.py``), kept current by every mutation path here,
        recorded in every snapshot and adopted by :meth:`restore`; with a
        WAL and a checkpointer, an int8 tier flip is fenced by a snapshot,
        so a page repair never replays the WAL across one;
      * :meth:`attach_remesher` / :meth:`remesh` -- elastic recovery from
        a lost shard: the engine is rebuilt with the survivor plan's
        shard count (``runtime/elastic.py``) and every serve-step variant
        rebuilt by the rebinder; signatures counted before the swap carry
        across it in :meth:`plan_stats`.

    ``impl`` is the route of the update and checksum kernels, as the
    steps' is of the lookups.  ``idx_key`` names the batch entry of
    engine-global row ids that feeds the profiler and the id check; a
    family whose batches hold table-local ids (the recsys models) binds
    ``None``: :meth:`observe` is then a no-op and ``validate_ids`` checks
    nothing, as in the reference."""

    def __init__(self, engine: PIFSEmbeddingEngine, state: EngineState,
                 model, step, steps: Optional[dict] = None,
                 validate_ids: bool = False, scrub_scores: bool = False,
                 impl: str = "cuda", idx_key: Optional[str] = "indices"):
        self.engine = engine
        self.state = state
        self.model = model
        self.impl = impl
        self.idx_key = idx_key             # batch entry feeding the profiler
        self.replans = 0
        # per-bucket duplicate-access accounting, fed by observe() on the
        # maintenance path (never the timed service path): bucket index
        # shape -> entries / unique rows over observed batches
        self.dedup_stats: dict = {}
        # named serve-step variants; "full" is the configured step
        self.steps = dict(steps or {})
        self.steps.setdefault("full", step)
        self.active = "full"
        self.validate_ids = validate_ids
        self.scrub_scores = scrub_scores
        self.poisoned_rows = 0
        self.poisoned_batches = 0
        self.last_poisoned = 0
        # mid-serving recovery
        self.checkpointer = None
        self.ckpt_step = 0
        self.restores = 0
        # streaming updates: write-ahead log, fixed apply capacity (one
        # signature) and the sequence number of the last applied batch
        self.wal = None
        self.update_capacity = 256
        self.update_seq = 0
        self.updates_applied = 0     # total unique rows applied
        # silent-corruption detection: the per-page checksum ledger, kept
        # current by every mutation path below; None = disarmed
        self.integrity = None
        # elastic re-mesh: the rebinder rebuilds the serve-step variants
        # for a new engine (only loadgen knows model families, so it owns
        # the callable); prefer_tp is the survivor-mesh policy's knob
        self._rebind = None          # engine -> (step, steps or None)
        self.prefer_tp = 4
        self.remeshes = 0
        self.remesh_events: list = []
        self._carried_traces = 0     # signatures first seen before a remesh
        # the batch's copies to the card, entry by entry at first read
        self._stager = BatchStager(engine.device)

    def _sync(self) -> None:
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.engine.device)

    # ------------------------------------------------------------ variants
    def modes(self) -> tuple:
        """The available serve-step variant labels ('full' first)."""
        rest = [k for k in self.steps if k != "full"]
        return ("full",) + tuple(rest)

    def set_mode(self, label: str) -> None:
        """Switch the active serve-step variant.  Unknown labels fall back
        to 'full'."""
        self.active = label if label in self.steps else "full"

    def execute(self, batch: dict) -> torch.Tensor:
        """Run the active step on a padded host batch (numpy arrays, as the
        serving padder builds it): check its ids on the host
        (``validate_ids``), run the step on the batch as a
        ``core.staging`` mapping, and wait for the card, so the caller's
        wall clock around this call is the batch's service time.  Each
        entry is copied to the engine's device when the step first reads
        it, through a pinned buffer on a copy stream: a DLRM step reads
        ``dense`` in its bottom MLP and the lookup inputs after it, so
        their copies run while the bottom MLP does.  A batch under
        ``core.staging.PINNED_MIN_BYTES`` (a serving bucket) is copied
        whole before the step, as the overlap cannot repay the pinned
        path's cost there.

        A batch large enough (``core.staging.sub_batches``: from its bytes
        and its item count; DLRM-DCNv2's 16,384 items, not an RMC's) runs
        as k sub-batches, slices along axis 0, each staged through buffers
        of its own and run on one of two compute streams in turn
        (``BatchStager.pipeline``), with no wait between them: the host
        copies and launches sub-batch j+1 while the card runs sub-batch j.
        A step's every score depends on its own item alone, so the scores
        are the step's on the same slices, joined into one (B,) tensor on
        the current stream; the ids are checked, and the scores scrubbed,
        over the whole batch, and the card is waited for once.

        Returns the (B,) scores on the device, non-finite ones zeroed
        under ``scrub_scores``.  Under a profiler the call is the span
        ``pifs.execute`` around one ``pifs.step`` a (sub-)batch and
        ``pifs.sync`` (the wait for the card); a step's first read (or a
        small batch's copy) is ``pifs.h2d`` and its later ones
        ``pifs.h2d_late`` (``repro_torch.trace``)."""
        with span("pifs.execute"):
            if self.validate_ids and self.idx_key and self.idx_key in batch:
                self.engine._check_ids(batch[self.idx_key])
            step = self.steps[self.active]
            parts = []
            with self._stager.pipeline(batch) as subs:
                for staged, lane in subs:
                    with span("pifs.step"), lane:
                        parts.append(step(self.state, staged))
            out = self._stager.join(parts)
            with span("pifs.sync"):
                self._sync()
        self.last_poisoned = 0
        if self.scrub_scores:
            finite = torch.isfinite(out)
            self.last_poisoned = int(out.numel() - int(finite.sum()))
            if self.last_poisoned:
                self.poisoned_rows += self.last_poisoned
                self.poisoned_batches += 1
                out = torch.where(finite, out, torch.zeros_like(out))
        return out

    # ---------------------------------------------------------- maintenance
    def observe(self, batch: dict) -> None:
        """Add a served batch to the page histogram (pad entries, weight 0,
        do not count) and its measured duplicate factor to the per-bucket
        record.  Waits for the card, so the update is charged to
        maintenance, not to the next batch's service time.  A no-op
        without ``idx_key`` in the batch."""
        if not (self.idx_key and self.idx_key in batch):
            return
        idx, w = batch[self.idx_key], batch.get("weights")
        self.state = self.engine.observe(
            self.state, self._on_device(idx),
            weights=None if w is None else self._on_device(w))
        self._sync()
        d = self.engine.dedup_factor(self.state, idx, weights=w)
        rec = self.dedup_stats.setdefault(
            tuple(idx.shape), {"batches": 0, "entries": 0, "unique_rows": 0})
        rec["batches"] += 1
        rec["entries"] += d["entries"]
        rec["unique_rows"] += d["unique_rows"]

    def dedup_report(self) -> dict:
        """Measured per-bucket duplicate factors from the observe cadence:
        ``{bucket_shape: {batches, entries, unique_rows, factor}}``."""
        return {"x".join(map(str, shape)): {
            **rec, "factor": rec["entries"] / max(rec["unique_rows"], 1)}
            for shape, rec in self.dedup_stats.items()}

    def replan(self) -> dict:
        """Plan from the histogram and migrate; returns the planner's
        stats.  Waits for the card, as :meth:`observe` does.  With the
        ledger armed, pages that flipped tier are re-recorded, and at int8
        with a WAL and a checkpointer a flip is fenced by a snapshot:
        quantized read-modify-writes (cold) and fp32 adds (hot) do not
        commute through a flip, so a WAL tail across one could not be
        replayed bitwise onto a snapshot page."""
        old_p2s = self._p2s() if self.integrity is not None else None
        self.state, stats = self.engine.plan_and_migrate(self.state)
        self._sync()
        self.replans += 1
        if self.integrity is not None:
            flipped = self.integrity.note_tier_changes(
                self.state, old_p2s, self.state.page_to_shard)
            if flipped.size:
                self._fence()
        return stats

    def _p2s(self) -> np.ndarray:
        """A host copy of the live page-to-shard map."""
        return np.array(host(self.state.page_to_shard), copy=True)

    def _fence(self) -> None:
        """The WAL fence of a mutation the WAL cannot represent (an int8
        tier flip, a requant snap): a snapshot, which truncates the WAL,
        so a page repair replays nothing across it."""
        if (self.engine.quantized and self.wal is not None
                and self.checkpointer is not None):
            self.snapshot()

    # ------------------------------------------------------------- updates
    def attach_wal(self, wal) -> None:
        """Wire a ``repro_torch.checkpoint.wal.WriteAheadLog``: every batch
        applied through :meth:`apply_deltas` is appended before it touches
        the card, :meth:`snapshot` truncates, :meth:`restore` replays the
        suffix past the snapshot's sequence point."""
        self.wal = wal

    def apply_deltas(self, rows, deltas, log: bool = True) -> int:
        """Apply one streaming delta batch to the live state (maintenance
        path, between micro-batches): coalesce duplicate rows, log the
        batch to the WAL if one is attached, apply it in
        ``update_capacity`` chunks, and wait for the card, so the wall time
        is charged where the runtime measures it.  Returns the number of
        unique rows applied."""
        rows, deltas = upd.coalesce_deltas(rows, deltas)
        if rows.size == 0:
            return 0
        if log:
            self.update_seq += 1
            if self.wal is not None:
                self.wal.append(self.update_seq, rows, deltas)
        for r_chunk, d_chunk in upd.chunk_delta_batch(
                rows, deltas, self.update_capacity):
            self.state = self.engine.apply_deltas(self.state, r_chunk,
                                                  d_chunk, impl=self.impl)
        self._sync()
        self.updates_applied += int(rows.size)
        if self.integrity is not None:
            # every page a delta landed in is re-recorded from the
            # post-apply state
            self.integrity.note_rows(self.state, rows)
        return int(rows.size)

    def replay_wal(self, after_seq: int = 0) -> int:
        """Re-apply the WAL's records with seq > ``after_seq`` through the
        live path (not logged again), so the replayed state equals the
        live one bit for bit.  Returns the number of batches replayed."""
        if self.wal is None:
            raise RuntimeError("no WAL attached")
        n = 0
        for seq, rows, deltas in self.wal.replay():
            if seq <= after_seq:
                continue
            self.apply_deltas(rows, deltas, log=False)
            self.update_seq = max(self.update_seq, int(seq))
            n += 1
        return n

    def requant_hot_pages(self, pages) -> int:
        """Snap listed hot pages onto their carried-scale grid (the engine
        op, then a wait for the card); with the ledger armed, re-record
        them and fence (:meth:`replan` says why).  Returns the number of
        non-pad pages listed."""
        pages = np.asarray(pages, np.int32).ravel()
        self.state = self.engine.requant_hot_pages(self.state, pages)
        self._sync()
        valid = pages[pages >= 0]
        if self.integrity is not None and valid.size:
            self.integrity.note_pages(self.state, valid)
            self._fence()
        return int(valid.size)

    # ------------------------------------------------------------ integrity
    def attach_integrity(self, ledger=None, chunk: int = 64) -> None:
        """Arm the per-page checksum ledger over the live state: build a
        fully recorded ``core.integrity.PageChecksumLedger`` (one kernel
        launch on the card), or adopt ``ledger``.  From here every
        mutation path keeps it current, so a divergence a scrub finds is
        silent corruption."""
        from repro_torch.core.integrity import PageChecksumLedger
        if ledger is None:
            ledger = PageChecksumLedger.build(self.engine, self.state,
                                              chunk=chunk, impl=self.impl)
        self.integrity = ledger

    # ------------------------------------------------------------ recovery
    def attach_checkpointer(self, checkpointer, save_now: bool = True
                            ) -> None:
        """Wire a ``repro_torch.checkpoint.checkpointer.Checkpointer``;
        ``save_now`` commits the current state, so :meth:`restore` always
        has a baseline."""
        self.checkpointer = checkpointer
        if save_now:
            self.snapshot()

    def _mesh(self) -> dict:
        """The one-card equivalent of the reference's mesh shape."""
        return {"data": 1, "model": int(self.engine.cfg.n_shards)}

    def snapshot(self) -> None:
        """Commit the current state (blocking: callers sit on the
        maintenance path).  The manifest's ``extra`` records the last
        applied update sequence number, the mesh (:meth:`_mesh`), the shard
        count, the cold-tier storage and, with the ledger armed, the
        snapshot-time checksums (``page_checksums``: page repair verifies
        the rows it reads back against them); then the WAL truncates:
        every logged delta is inside the committed state."""
        if self.checkpointer is None:
            raise RuntimeError("no checkpointer attached")
        self.ckpt_step += 1
        extra = {"update_seq": self.update_seq, "mesh": self._mesh(),
                 "n_shards": int(self.engine.cfg.n_shards),
                 "storage": self.engine.cfg.storage}
        if self.integrity is not None:
            extra["page_checksums"] = self.integrity.export()
        self.checkpointer.save(self.ckpt_step, self.state, blocking=True,
                               extra=extra)
        if self.wal is not None:
            self.wal.truncate()

    def _check_restore_extra(self, extra: dict) -> None:
        """The manifest's shard-count and storage guard: the cold tier's
        layout is a function of ``n_shards``, and int8 codes are not fp32
        rows, so a mismatched restore fails loudly.  A manifest without
        these keys passes."""
        snap_shards = extra.get("n_shards")
        if (snap_shards is not None
                and int(snap_shards) != int(self.engine.cfg.n_shards)):
            raise ValueError(
                f"checkpoint was written with n_shards={snap_shards} "
                f"(mesh {extra.get('mesh')}), but this engine has "
                f"n_shards={self.engine.cfg.n_shards} (mesh "
                f"{self._mesh()}): an in-place restore would silently "
                "mis-place shards. Route through the elastic path instead "
                "-- restore on an engine matching the snapshot's mesh, "
                "then re-mesh via ServeBinding.remesh() / "
                "repro_torch.runtime.elastic.remesh_engine().")
        snap_storage = extra.get("storage")
        if (snap_storage is not None
                and snap_storage != self.engine.cfg.storage):
            raise ValueError(
                f"checkpoint was written with storage={snap_storage!r} but "
                f"this engine uses storage={self.engine.cfg.storage!r}: "
                "int8 codes and fp32 rows are not interchangeable -- "
                "rebuild the engine with the snapshot's storage mode.")

    def restore(self) -> None:
        """Reload the state from the latest committed checkpoint, between
        micro-batches: every leaf is CRC-checked and copied into the live
        tensors (same shapes and dtypes, no second allocation), then, with
        a WAL attached, every batch logged after the snapshot's sequence
        point is replayed through the live apply path, so the state equals
        the uninterrupted one bit for bit.  No new signature.  With the
        ledger armed it adopts the snapshot-time ledger (a snapshot
        without one forces a full rebuild); the replay keeps it current."""
        if self.checkpointer is None:
            raise RuntimeError("no checkpointer attached")
        extra = self.checkpointer.extra()
        self._check_restore_extra(extra)
        self.state = self.checkpointer.restore(self.state, into=True)
        self._sync()
        self.restores += 1
        if self.integrity is not None:
            rec = extra.get("page_checksums")
            if rec is not None:
                self.integrity.load(rec)
            else:
                self.integrity.note_pages(
                    self.state,
                    np.arange(self.engine.cfg.num_pages, dtype=np.int64))
        if self.wal is not None:
            snap_seq = int(extra.get("update_seq", 0))
            self.update_seq = snap_seq
            self.replay_wal(after_seq=snap_seq)

    # ----------------------------------------------------- elastic re-mesh
    def attach_remesher(self, rebind, prefer_tp: int = 4) -> None:
        """Arm elastic recovery: ``rebind(engine) -> (step, steps or
        None)`` rebuilds the serve-step variants for a re-meshed engine
        (``serving.loadgen.bind_model(elastic=True)`` owns it);
        ``prefer_tp`` is the survivor-mesh policy's knob
        (``runtime/elastic.scale_plan``)."""
        self._rebind = rebind
        self.prefer_tp = int(prefer_tp)

    @property
    def can_remesh(self) -> bool:
        return self._rebind is not None

    def remesh(self, lost_shard=None, new_mesh=None, heal: bool = False,
               batch_granule: int = 0) -> dict:
        """Elastic recovery from a lost shard, between micro-batches (its
        wall time is recovery, never service time):

          1. quiesce: wait for the card;
          2. with ``heal``, :meth:`restore` first, on the old shard count
             the snapshot was written under;
          3. the survivor mesh: ``tp - 1`` shards survive (dp = 1 on one
             card); ``scale_plan(survivors, prefer_tp, batch_granule)``
             picks ``(dp, tp)`` unless ``new_mesh`` (``{"data": dp,
             "model": tp}``) pins it;
          4. ``runtime/elastic.remesh_engine``: export, re-plan on the
             carried histogram, pack into an engine of ``n_shards = tp``
             on the same card (int8 codes and scales move verbatim);
          5. the ledger is rebound (page geometry does not depend on the
             shard count) and the pages the new placement flipped are
             re-recorded; the rebinder rebuilds every serve-step variant,
             which the caller re-warms;
          6. with a checkpointer, a new baseline snapshot: the old one no
             longer restores in place, and it truncates the WAL.

        Signatures first seen on the old engine carry into
        :meth:`plan_stats`.  Returns the event (also in
        ``remesh_events``) with the reference's keys: ``from_mesh``,
        ``to_mesh`` (``{"data": dp, "model": tp}``), ``lost_shard``,
        ``n_shards``, ``healed``."""
        if self._rebind is None:
            raise RuntimeError(
                "no rebinder attached -- call attach_remesher() (or "
                "bind_model(elastic=True)) before remesh()")
        from repro_torch.runtime.elastic import remesh_engine, scale_plan
        old_engine = self.engine
        self._sync()
        if heal:
            self.restore()
        from_mesh = self._mesh()
        if new_mesh is None:
            old_tp = int(old_engine.cfg.n_shards)
            if old_tp < 2:
                raise RuntimeError(
                    f"cannot drop a tp shard from mesh {from_mesh}: "
                    f"tp={old_tp} has no survivor -- shard loss at tp=1 is "
                    "total loss")
            (dp, tp), _ = scale_plan(old_tp - 1, prefer_tp=self.prefer_tp,
                                     batch_granule=batch_granule)
            new_mesh = {"data": dp, "model": tp}
        new_mesh = {"data": int(new_mesh["data"]),
                    "model": int(new_mesh["model"])}
        old_p2s = self._p2s() if self.integrity is not None else None
        new_engine, new_state = remesh_engine(
            old_engine, new_mesh["model"], self.state)
        self._carried_traces += old_engine.plan_stats()["traces"]
        self.engine, self.state = new_engine, new_state
        self._sync()
        if self.integrity is not None:
            self.integrity.rebind(new_engine)
            self.integrity.note_tier_changes(self.state, old_p2s,
                                             self.state.page_to_shard)
        step, steps = self._rebind(new_engine)
        self.steps = dict(steps or {})
        self.steps.setdefault("full", step)
        if self.active not in self.steps:
            self.active = "full"
        if self.checkpointer is not None:
            self.snapshot()
        event = {"from_mesh": from_mesh, "to_mesh": new_mesh,
                 "lost_shard": lost_shard,
                 "n_shards": int(new_engine.cfg.n_shards),
                 "healed": bool(heal)}
        self.remeshes += 1
        self.remesh_events.append(event)
        return event

    def plan_stats(self) -> dict:
        """The engine's stats, with the signatures first seen on engines
        before a re-mesh added to ``traces``: the no-new-signature contract
        holds across the whole run."""
        out = self.engine.plan_stats()
        out["traces"] += self._carried_traces
        return out

    def reset_plan_stats(self) -> None:
        """Zero the engine's counters and :meth:`staging_stats`."""
        self.engine.reset_plan_stats()
        self._carried_traces = 0
        self._stager.reset_stats()

    def staging_stats(self) -> dict:
        """Since :meth:`reset_plan_stats`: ``calls`` (batches executed),
        ``bytes`` (host bytes copied to the device), ``late_bytes`` (those
        copied after a step's first read of its (sub-)batch, which the
        step's own work can hide), ``split_calls`` (batches run as more
        than one sub-batch) and ``sub_batches`` (the steps they ran)."""
        return self._stager.stats()


def engine_for_tables(vocab_sizes, dim: int, device: DeviceLike = None,
                      hot_fraction: float = 0.05, page_bytes: int = 4096,
                      storage: str = "fp32", dedup: str = "off",
                      validate_ids: bool = False, n_shards: int = 1
                      ) -> Tuple[PIFSEmbeddingEngine, np.ndarray]:
    """Stack tables into one engine address space on one device, its cold
    tier in ``n_shards`` shards (the reference's tp axis).

    Returns (engine, offsets) where offsets[t] is added to table-t ids.
    Each table starts on a page boundary, so pages never straddle tables.
    Raises if the address space exceeds int32 (row ids are int32 on the
    device)."""
    cfg0 = PagingConfig(total_rows=1, dim=dim, n_shards=n_shards,
                        page_bytes=page_bytes, itemsize=4,
                        hot_fraction=hot_fraction, storage=storage)
    ps = cfg0.page_size
    offsets = []
    total = 0
    for v in vocab_sizes:
        offsets.append(total)
        total += -(-v // ps) * ps
    cfg = dataclasses.replace(cfg0, total_rows=total)
    if max(cfg.padded_rows, cfg.cold_rows_total) > np.iinfo(np.int32).max:
        raise ValueError(
            f"table address space ({total} padded rows, "
            f"{cfg.cold_rows_total} cold-tier rows incl. headroom) exceeds "
            "int32 range; row indices are int32 on device")
    return (PIFSEmbeddingEngine(cfg, device=device, dedup=dedup,
                                validate_ids=validate_ids),
            np.asarray(offsets, dtype=np.int64))
