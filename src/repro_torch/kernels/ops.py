"""Dispatch between the CUDA kernels and their plain versions.

``impl="cuda"`` (the default) sends a CUDA tensor to the hand-written
kernel and a CPU tensor to the kernel's plain version in ``kernels/ref.py``
-- only because it lies on the CPU.  On a CUDA tensor the kernel launches
or raises; nothing falls back.  ``impl="torch"`` asks for the plain
version on any device (the counterpart of the reference's ``impl='jnp'``;
``chip_smoke.py`` uses it to hold the kernels against their plain
versions on the card).

Alignment on Hopper.  The reference pads D to the TPU's 128 lanes
(``repro/kernels/ops.py:pad_to_lanes``); nothing here pads.  A Hopper
kernel only wants 16-byte row chunks for vector loads: when D * itemsize
is a multiple of 16 (fp32 D % 4 == 0, int8 D % 16 == 0, which covers the
RMC widths 64 and 128) and the tables are 16-byte aligned (every PyTorch
allocation is), the kernels load 16 bytes per thread; any other D takes
the kernels' scalar path and stays correct.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import integrity as _integrity
from repro_torch.kernels import interaction as _interaction
from repro_torch.kernels import ref
from repro_torch.kernels import sls as _sls
from repro_torch.kernels import updates as _updates

IMPLS = ("cuda", "torch")


def _use_kernel(impl: str, t: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    return impl == "cuda" and t.device.type == "cuda"


def masked_sls(table: torch.Tensor, indices: torch.Tensor,
               owned: Optional[torch.Tensor] = None,
               weights: Optional[torch.Tensor] = None,
               scales: Optional[torch.Tensor] = None,
               impl: str = "cuda") -> torch.Tensor:
    """Masked partial SLS in fixed l-order: (N, L) -> (N, D) float32.
    ``owned=None`` is plain SLS; ``scales`` dequantize an int8 table."""
    _sls.check_masked_sls(table, indices, owned, weights, scales)
    if _use_kernel(impl, table):
        return _sls.masked_sls(table, indices, owned, weights, scales)
    return ref._fixed_order_masked_sls(table, indices, owned, weights,
                                       scales)


def dot_interaction(feats: torch.Tensor, self_interaction: bool = False,
                    impl: str = "cuda") -> torch.Tensor:
    """DLRM pairwise-dot interaction: (B, F, D) -> (B, P)."""
    _interaction.check_dot_interaction(feats)
    if _use_kernel(impl, feats):
        return _interaction.dot_interaction(feats, self_interaction)
    return ref.dot_interaction_ref(feats, self_interaction)


def fused_front_end(cold: torch.Tensor, hot: torch.Tensor, x: torch.Tensor,
                    rows: torch.Tensor, owned: torch.Tensor,
                    is_hot: torch.Tensor,
                    weights: Optional[torch.Tensor] = None,
                    scales: Optional[torch.Tensor] = None,
                    impl: str = "cuda") -> torch.Tensor:
    """Fused two-tier masked SLS -> dot interaction: (B, P)."""
    _sls.check_fused_front_end(cold, hot, x, rows, owned, is_hot, weights,
                               scales)
    if _use_kernel(impl, cold):
        return _sls.fused_front_end(cold, hot, x, rows, owned, is_hot,
                                    weights, scales)
    return ref.fused_front_end_ref(cold, hot, x, rows, owned, is_hot,
                                   weights, scales)


def masked_sls_dedup(table: torch.Tensor, plan, owned: torch.Tensor,
                     weights: Optional[torch.Tensor] = None,
                     impl: str = "cuda") -> torch.Tensor:
    """Gather-once masked partial SLS: (N, L) -> (N, D) float32, each owned
    entry's row read through its slot of ``plan`` (a ``core.sls.DedupPlan``
    of the same bags; duplicates of a row share a slot).  Bitwise equal to
    :func:`masked_sls` on the same entries."""
    _sls.check_masked_sls_dedup(table, plan.unique_rows, plan.slots, owned,
                                plan.n_slots, weights, plan.unique_scales)
    if _use_kernel(impl, table):
        return _sls.masked_sls_dedup(table, plan.unique_rows, plan.slots,
                                     owned, plan.n_slots, weights,
                                     plan.unique_scales)
    return ref.masked_sls_dedup_ref(table, plan.unique_rows, plan.slots,
                                    owned, weights, plan.unique_scales)


def fused_front_end_dedup(cold: torch.Tensor, hot: torch.Tensor,
                          x: torch.Tensor, cold_plan, hot_plan,
                          owned: torch.Tensor, is_hot: torch.Tensor,
                          weights: Optional[torch.Tensor] = None,
                          impl: str = "cuda") -> torch.Tensor:
    """Gather-once fused front end: (B, P), one ``core.sls.DedupPlan`` per
    tier (slots (B, G, L); cold with scales, hot without).  Bitwise equal
    to :func:`fused_front_end` on the same entries."""
    cp, hp = cold_plan, hot_plan
    args = (cold, hot, x, cp.unique_rows, cp.slots, cp.n_slots,
            hp.unique_rows, hp.slots, hp.n_slots, owned, is_hot, weights,
            cp.unique_scales)
    _sls.check_fused_front_end_dedup(*args)
    if _use_kernel(impl, cold):
        return _sls.fused_front_end_dedup(*args)
    return ref.fused_front_end_dedup_ref(
        cold, hot, x, cp.unique_rows, cp.slots, hp.unique_rows, hp.slots,
        owned, is_hot, weights, cp.unique_scales)


def fused_partial_pool(cold: torch.Tensor, hot: torch.Tensor,
                       x: torch.Tensor, rows: torch.Tensor,
                       owned: torch.Tensor, is_hot: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       scales: Optional[torch.Tensor] = None,
                       impl: str = "cuda"):
    """The fused front end stopped before the interaction: the partial
    feature tiles ``(part_c, part_h)``.  ``owned`` (B, G, L) pools one cold
    shard into ``part_c`` (B, F, D); (S, B, G, L) pools the S equal slices
    of ``cold`` (``rows`` local to a slice) into (S, B, F, D), in one
    launch on the card.  ``part_h`` (B, F, D) holds x and the hot pools."""
    one = owned.dim() == 3
    own4 = owned[None] if one else owned
    _sls.check_fused_partial_pool(cold, hot, x, rows, own4, is_hot, weights,
                                  scales)
    if _use_kernel(impl, cold):
        part_c, part_h = _sls.fused_partial_pool(cold, hot, x, rows, own4,
                                                 is_hot, weights, scales)
        return (part_c[0] if one else part_c), part_h
    return ref.fused_partial_pool_ref(cold, hot, x, rows, owned, is_hot,
                                      weights, scales)


def fused_partial_pool_dedup(cold: torch.Tensor, hot: torch.Tensor,
                             x: torch.Tensor, cold_plan, hot_plan,
                             owned: torch.Tensor, is_hot: torch.Tensor,
                             weights: Optional[torch.Tensor] = None,
                             impl: str = "cuda"):
    """Gather-once partial pool: one ``core.sls.DedupPlan`` for the cold
    tier (slots shaped like ``owned``: (B, G, L), or (S, B, G, L) with
    rows of the whole ``cold``) and one for the hot tier (slots
    (B, G, L)).  Bitwise equal to :func:`fused_partial_pool` on the same
    entries."""
    cp, hp = cold_plan, hot_plan
    one = owned.dim() == 3
    own4, cs4 = (owned[None], cp.slots[None]) if one else (owned, cp.slots)
    args = (cold, hot, x, cp.unique_rows, cs4, cp.n_slots, hp.unique_rows,
            hp.slots, hp.n_slots, own4, is_hot, weights, cp.unique_scales)
    _sls.check_fused_partial_pool_dedup(*args)
    if _use_kernel(impl, cold):
        part_c, part_h = _sls.fused_partial_pool_dedup(*args)
        return (part_c[0] if one else part_c), part_h
    return ref.fused_partial_pool_dedup_ref(
        cold, hot, x, cp.unique_rows, cp.slots, hp.unique_rows, hp.slots,
        owned, is_hot, weights, cp.unique_scales)


def fused_resume(part_c: torch.Tensor, part_h: torch.Tensor,
                 impl: str = "cuda") -> torch.Tensor:
    """Phase 3 on the partial tiles: ``part_c`` (B, F, D), or (S, B, F, D)
    summed in shard order, plus ``part_h``, then the interaction ->
    (B, P)."""
    c4 = part_c[None] if part_c.dim() == 3 else part_c
    _interaction.check_fused_resume(c4, part_h)
    if _use_kernel(impl, part_h):
        return _interaction.fused_resume(c4, part_h)
    return ref.fused_resume_ref(part_c, part_h)


def apply_deltas(cold: torch.Tensor, hot: torch.Tensor,
                 page_scales: torch.Tensor, page_to_shard: torch.Tensor,
                 page_to_slot: torch.Tensor, rows: torch.Tensor,
                 deltas: torch.Tensor, page_size: int, rows_per_shard: int,
                 impl: str = "cuda") -> None:
    """Fold unique-row deltas (U, D) into the rows ``rows`` (U,) of the
    cold and hot tiers, in place (an int8 cold row in its page's quantized
    domain, through one fma); a negative row is a pad."""
    _updates.check_apply_deltas(cold, hot, page_scales, page_to_shard,
                                page_to_slot, rows, deltas)
    if _use_kernel(impl, cold):
        _updates.apply_deltas(cold, hot, page_scales, page_to_shard,
                              page_to_slot, rows, deltas, page_size,
                              rows_per_shard)
    else:
        ref.apply_deltas_ref(cold, hot, page_scales, page_to_shard,
                             page_to_slot, rows, deltas, page_size,
                             rows_per_shard)


def page_checksums(cold: torch.Tensor, hot: torch.Tensor,
                   page_scales: torch.Tensor, page_to_shard: torch.Tensor,
                   page_to_slot: torch.Tensor, pages: torch.Tensor,
                   page_size: int, rows_per_shard: int,
                   impl: str = "cuda") -> torch.Tensor:
    """Per-page Fletcher pairs of the listed pages (K,) -> (K, 2) int64
    ``[s1, s2]`` in [0, 2^32) (``core/integrity.py``); a negative page is
    a pad and gets zeros."""
    _integrity.check_page_checksums(cold, hot, page_scales, page_to_shard,
                                    page_to_slot, pages)
    if _use_kernel(impl, cold):
        return _integrity.page_checksums(cold, hot, page_scales,
                                         page_to_shard, page_to_slot, pages,
                                         page_size, rows_per_shard)
    return ref.page_checksums_ref(cold, hot, page_scales, page_to_shard,
                                  page_to_slot, pages, page_size,
                                  rows_per_shard)
