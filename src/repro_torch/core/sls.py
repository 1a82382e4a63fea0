"""SparseLengthSum (SLS) building blocks of the engine -- the paper's hot
operator (a port of the dense-bag half of ``repro.core.sls``).

Dense form: ``local_rows (B, L)`` with an ownership mask and optional
weights; padding entries carry weight 0.  Every path accumulates in the
fixed order l = 0..L-1 (``kernels/ref.py:_fixed_order_masked_sls`` is the
plain version, the CUDA kernels the fast one), so lookups do not depend on
the impl: with 0/1 weights they are bitwise equal.

Gather-once dedup (``dedup=True``) gathers and dequantizes every unique
owned row once into a staging buffer and accumulates through a slot per
entry in the same l order, so it is bitwise equal to ``dedup=False``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops

# Non-owned pooling entries are remapped to this sentinel before the
# sort-based unique, so they (a) sort past every real row id and collapse
# into at most one staging slot, and (b) never pollute the dequant scale of
# a real unique row.  Gathers clamp the sentinel into range; its
# contribution is zeroed by the mask.
DEDUP_SENTINEL = torch.iinfo(torch.int32).max


class DedupPlan(NamedTuple):
    """Static-shape batch-level duplicate-coalescing plan (gather-once).

    Capacity is always ``N = B*L`` (every entry unique), so no shape
    depends on the data and nothing waits for the card: ``n_slots`` and
    ``n_unique`` stay device tensors, and the kernels read ``n_slots`` on
    the card to bound their staging loop."""
    unique_rows: torch.Tensor   # (N,) int32 row per staging slot (padded
    #                             slots and the non-owned run hold the sentinel)
    slots: torch.Tensor         # (B, L) int32 staging slot per pooling entry
    n_slots: torch.Tensor       # (1,) int32 live staging slots (incl. the one
    #                             sentinel run, when any entry is non-owned)
    n_unique: torch.Tensor      # (1,) int32 unique *owned* rows
    unique_scales: Optional[torch.Tensor]  # (N,) f32 per-slot dequant scales


def dedup_plan(local_rows: torch.Tensor, owned: torch.Tensor,
               scales: Optional[torch.Tensor] = None) -> DedupPlan:
    """Sort-based unique over the owned entries of dense (B, L) bags, on the
    device: a stable sort, the ``is_new`` mask, a prefix sum and three
    scatters.  Duplicates of a row share a staging slot.

    ``unique_scales`` is exact on owned slots (duplicates of a row share its
    page, hence its scale); the sentinel slot's is one of the non-owned
    entries' scales (arbitrary but finite: its rows are masked to zero)."""
    B, L = local_rows.shape
    N = B * L
    r = torch.where(owned, local_rows, DEDUP_SENTINEL).reshape(N)
    sr, order = torch.sort(r.to(torch.int32), stable=True)
    is_new = torch.ones(N, dtype=torch.bool, device=r.device)
    is_new[1:] = sr[1:] != sr[:-1]
    uid = (torch.cumsum(is_new, 0) - 1).to(torch.int32)   # slot per entry
    slots = torch.empty(N, dtype=torch.int32, device=r.device)
    slots[order] = uid
    unique_rows = torch.full((N,), DEDUP_SENTINEL, dtype=torch.int32,
                             device=r.device).scatter_(0, uid.long(), sr)
    n_slots = uid[-1:] + 1
    n_unique = n_slots - (sr[-1:] == DEDUP_SENTINEL).to(torch.int32)
    unique_scales = None
    if scales is not None:
        ss = scales.reshape(N)[order].to(torch.float32)
        unique_scales = torch.ones(N, dtype=torch.float32,
                                   device=r.device).scatter_(0, uid.long(),
                                                             ss)
    return DedupPlan(unique_rows, slots.reshape(B, L), n_slots, n_unique,
                     unique_scales)


def masked_partial_sls_dense(local_storage: torch.Tensor,
                             local_rows: torch.Tensor, owned: torch.Tensor,
                             weights: Optional[torch.Tensor] = None,
                             impl: str = "cuda",
                             scales: Optional[torch.Tensor] = None,
                             dedup: bool = False,
                             dedup_capacity: Optional[int] = None
                             ) -> torch.Tensor:
    """``out[b] = sum_l owned[b,l] * w[b,l] * storage[local_rows[b,l]]``
    in fixed l-order, (B, L) -> (B, D) float32.  ``scales`` (B, L)
    dequantize an int8 ``local_storage`` per gathered row before the
    weighted add.  ``impl``: see ``kernels/ops.py``.

    ``dedup=True`` gathers each unique owned row once (:func:`dedup_plan`);
    when ``B*L`` exceeds ``dedup_capacity`` staging rows it falls back to
    the per-entry gather, which is exact too."""
    B, L = local_rows.shape
    if dedup and dedup_capacity is not None and B * L > dedup_capacity:
        dedup = False                      # capacity overflow: exact fallback
    if B == 0 or L == 0:
        return torch.zeros((B, local_storage.shape[-1]), dtype=torch.float32,
                           device=local_storage.device)
    if dedup:
        return ops.masked_sls_dedup(local_storage,
                                    dedup_plan(local_rows, owned, scales),
                                    owned, weights, impl=impl)
    return ops.masked_sls(local_storage, local_rows, owned, weights,
                          scales, impl=impl)


def fused_front_end_dense(cold_storage: torch.Tensor,
                          hot_storage: torch.Tensor, x: torch.Tensor,
                          local_rows: torch.Tensor, owned: torch.Tensor,
                          is_hot: torch.Tensor,
                          weights: Optional[torch.Tensor] = None,
                          scales: Optional[torch.Tensor] = None,
                          impl: str = "cuda",
                          dedup: bool = False) -> torch.Tensor:
    """Fused DLRM front end: two-tier masked SLS -> dot interaction.

    local_rows/owned/is_hot (B, G, L); x (B, D) the bottom-MLP output,
    feature row 0.  Returns the (B, P) packed lower triangle of the
    (B, G+1, D) features' pairwise dots, bitwise equal to the split
    composition inside the port.  ``dedup=True`` builds one plan per tier
    (cold with scales, hot without) and stages each tier's unique rows
    once; the result does not change."""
    B, G, L = local_rows.shape
    D = cold_storage.shape[-1]
    F = G + 1
    P = F * (F - 1) // 2
    if B == 0 or L == 0 or G == 0:
        return torch.zeros((B, P), dtype=torch.float32, device=x.device)
    if hot_storage.shape[0] == 0:
        # tiering disabled (the BEACON placement): keep one always-resident
        # line so masked-out hot reads stay in range
        hot_storage = torch.zeros((1, D), dtype=hot_storage.dtype,
                                  device=hot_storage.device)
    if dedup:
        nb = B * G
        flat = local_rows.reshape(nb, L)
        cp = dedup_plan(flat, owned.reshape(nb, L),
                        None if scales is None else scales.reshape(nb, L))
        hp = dedup_plan(flat, is_hot.reshape(nb, L))
        return ops.fused_front_end_dedup(
            cold_storage, hot_storage, x,
            cp._replace(slots=cp.slots.reshape(B, G, L)),
            hp._replace(slots=hp.slots.reshape(B, G, L)),
            owned, is_hot, weights, impl=impl)
    return ops.fused_front_end(cold_storage, hot_storage, x, local_rows,
                               owned, is_hot, weights, scales, impl=impl)
