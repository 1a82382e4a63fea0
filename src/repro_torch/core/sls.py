"""SparseLengthSum (SLS) building blocks of the engine -- the paper's hot
operator (the port of ``repro.core.sls``).

The reference's standalone forms come first: :func:`sls_ref` (flat bags:
``indices (N,)``, ``segment_ids (N,)``), :func:`sls_dense_ref` (dense bags
``(B, L)``), the per-shard :func:`masked_partial_sls` and
:func:`bags_to_flat`, in plain PyTorch with the reference's semantics: a
row id reads as ``jnp.take`` reads it (wrapped once if negative, a NaN
row outside the table) and a segment id outside ``[0, num_bags)`` is
dropped, as ``segment_sum`` drops it.

Dense form: ``local_rows (B, L)`` with an ownership mask and optional
weights; padding entries carry weight 0.  Every path accumulates in the
fixed order l = 0..L-1 (``kernels/ref.py:_fixed_order_masked_sls`` is the
plain version, the CUDA kernels the fast one), so lookups do not depend on
the impl: with 0/1 weights they are bitwise equal.

Gather-once dedup (``dedup=True``) gives every unique owned row one slot
of a plan and accumulates through the slot per entry in the same l
order, so it is bitwise equal to ``dedup=False``.  The plain versions
stage the slots' rows as the reference does; the CUDA kernels read each
row through its slot, duplicates from the L2 (``kernels/csrc/
gather_once.cuh``), and only the partial pool's stages them.

Shards.  The cold tier of an engine with S shards is S equal slices of
one tensor, and a per-shard ownership mask (S, ...) pools each shard's
slice into its own partial, all S in one kernel launch: the SLS pools
the shards as S stacked batches of bags on the whole tier (each shard's
rows offset by its slice), the partial pool runs one grid row per shard.
Dedup plans of the S shards are one plan over those disjoint rows, so
each shard's staging holds what the reference's per-shard plan holds.
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
    ``n_unique`` stay device tensors, and the gather-once partial pool
    reads ``n_slots`` on the card to bound its staging loop."""
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


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)``: an id in ``[-V, 0)`` wraps once,
    one outside ``[-V, V)`` reads a NaN row."""
    V = table.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + V, idx)
    ok = (idx >= 0) & (idx < V)
    rows = table[idx.clamp(0, max(V - 1, 0))]
    return torch.where(ok[..., None], rows, torch.full_like(rows,
                                                            float("nan")))


def _segment_sum(rows: torch.Tensor, segment_ids: torch.Tensor,
                 num_bags: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows summed into their segments in index
    order; a segment id outside ``[0, num_bags)`` is dropped."""
    seg = segment_ids.long()
    ok = (seg >= 0) & (seg < num_bags)
    out = torch.zeros((num_bags,) + rows.shape[1:], dtype=rows.dtype,
                      device=rows.device)
    return out.index_add_(0, torch.where(ok, seg, 0),
                          torch.where(ok[:, None], rows,
                                      torch.zeros_like(rows)))


def sls_ref(table: torch.Tensor, indices: torch.Tensor,
            segment_ids: torch.Tensor, num_bags: int,
            weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference SLS, flat form: ``out[b] = sum_{i: seg[i]==b} w[i] *
    table[idx[i]]`` -> (num_bags, D) in the table's dtype."""
    rows = _take(table, indices)
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    return _segment_sum(rows, segment_ids, num_bags)


def sls_dense_ref(table: torch.Tensor, indices: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense-form SLS: indices (B, L) -> (B, D) in the table's dtype."""
    rows = _take(table, indices)                        # (B, L, D)
    if weights is not None:
        rows = rows * weights[..., None].to(rows.dtype)
    out = torch.zeros_like(rows[:, 0])
    for l in range(rows.shape[1]):     # the reference's reduce, in l order
        out = out + rows[:, l]
    return out


def masked_partial_sls(local_storage: torch.Tensor, local_rows: torch.Tensor,
                       owned: torch.Tensor, segment_ids: torch.Tensor,
                       num_bags: int,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Per-shard partial SLS, flat form: accumulate only the rows this
    shard owns (the paper's Process Core: the reduction happens where the
    rows live; only the pooled (num_bags, D) partial leaves the shard).
    A non-owned entry reads row 0 and weighs 0."""
    safe = torch.where(owned, local_rows, torch.zeros_like(local_rows))
    rows = _take(local_storage, safe)
    w = owned.to(rows.dtype)
    if weights is not None:
        w = w * weights.to(rows.dtype)
    return _segment_sum(rows * w[:, None], segment_ids, num_bags)


def bags_to_flat(indices: torch.Tensor,
                 weights: Optional[torch.Tensor] = None):
    """(B, L) dense bags -> ``(flat (N,), segment_ids (N,) int32, B,
    weights (N,) or None)``."""
    B, L = indices.shape
    seg = torch.arange(B, dtype=torch.int32,
                       device=indices.device).repeat_interleave(L)
    return (indices.reshape(-1), seg, B,
            None if weights is None else weights.reshape(-1))


def _stacked_rows(local_rows: torch.Tensor, S: int, R: int) -> torch.Tensor:
    """(..., L) rows local to a slice -> (S, ..., L) rows of the whole
    tier, shard s's offset by its slice start s * R."""
    base = torch.arange(0, S * R, R, dtype=torch.int32,
                        device=local_rows.device)
    return local_rows[None] + base.view((S,) + (1,) * local_rows.dim())


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

    ``owned`` (S, B, L) pools S shards, the S equal slices of
    ``local_storage`` (``local_rows`` local to a slice), into (S, B, D)
    per-shard partials, in one launch.

    ``dedup=True`` gathers each unique owned row once (:func:`dedup_plan`);
    when ``B*L`` exceeds ``dedup_capacity`` staging rows it falls back to
    the per-entry gather, which is exact too."""
    B, L = local_rows.shape
    if owned.dim() == 3 and owned.shape[0] == 1:     # one shard: no stacking
        return masked_partial_sls_dense(local_storage, local_rows, owned[0],
                                        weights, impl, scales, dedup,
                                        dedup_capacity)[None]
    if owned.dim() == 3:
        S = owned.shape[0]
        rows = _stacked_rows(local_rows, S, local_storage.shape[0] // S)
        rep = (lambda t: None if t is None else t.repeat(S, 1))
        out = masked_partial_sls_dense(
            local_storage, rows.reshape(S * B, L), owned.reshape(S * B, L),
            rep(weights), impl, rep(scales), dedup,
            None if dedup_capacity is None else S * dedup_capacity)
        return out.reshape(S, B, -1)
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
    (cold with scales, hot without) and reads each tier's rows through its
    plan; the result does not change."""
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


def fused_partial_pool_dense(cold_storage: torch.Tensor,
                             hot_storage: torch.Tensor, x: torch.Tensor,
                             local_rows: torch.Tensor, owned: torch.Tensor,
                             is_hot: torch.Tensor,
                             weights: Optional[torch.Tensor] = None,
                             scales: Optional[torch.Tensor] = None,
                             impl: str = "cuda", dedup: bool = False):
    """The fused front end stopped before the interaction: the per-tier
    partial feature tiles ``(part_c, part_h)``.

    ``part_c`` holds the cold-tier partial pools with an all-zero feature
    row 0 (the tile summed across shards: x must not be counted once per
    shard); ``part_h`` the hot-tier pools with ``x`` in row 0 (the hot
    tier is replicated, pooled once).  ``owned`` (B, G, L) pools one
    shard into ``part_c`` (B, F, D); (S, B, G, L) pools the S equal slices
    of ``cold_storage`` into (S, B, F, D).  Each shard pools its own rows
    in the split path's l-order, so
    ``fused_resume_dense(part_c, part_h)`` equals the split composition
    bitwise.  ``dedup=True`` builds one plan over the shards' cold rows
    (their rows are disjoint, so each shard stages what its own plan
    would) and one over the hot rows; the tiles do not change."""
    B, G, L = local_rows.shape
    D = cold_storage.shape[-1]
    F = G + 1
    if B == 0 or L == 0 or G == 0:
        part_c = torch.zeros(owned.shape[:-3] + (B, F, D),
                             dtype=torch.float32, device=x.device)
        part_h = torch.zeros((B, F, D), dtype=torch.float32, device=x.device)
        part_h[:, 0] = x
        return part_c, part_h
    if hot_storage.shape[0] == 0:
        # the BEACON placement: one always-resident line (see
        # fused_front_end_dense)
        hot_storage = torch.zeros((1, D), dtype=hot_storage.dtype,
                                  device=hot_storage.device)
    if dedup:
        cp, hp = partial_pool_plans(cold_storage.shape[0], local_rows, owned,
                                    is_hot, scales)
        return ops.fused_partial_pool_dedup(cold_storage, hot_storage, x, cp,
                                            hp, owned, is_hot, weights,
                                            impl=impl)
    return ops.fused_partial_pool(cold_storage, hot_storage, x, local_rows,
                                  owned, is_hot, weights, scales, impl=impl)


def partial_pool_plans(cold_rows: int, local_rows: torch.Tensor,
                       owned: torch.Tensor, is_hot: torch.Tensor,
                       scales: Optional[torch.Tensor] = None):
    """The gather-once plans of a partial pool: one over every shard's
    owned cold rows (rows of the whole ``cold_rows``-row tier; slots
    shaped like ``owned``) and one over the hot rows (slots (B, G, L))."""
    B, G, L = local_rows.shape
    nb = B * G
    S = owned.shape[0] if owned.dim() == 4 else 1
    flat = local_rows.reshape(nb, L)
    rows = _stacked_rows(flat, S, cold_rows // S)
    cp = dedup_plan(rows.reshape(S * nb, L), owned.reshape(S * nb, L),
                    None if scales is None
                    else scales.reshape(nb, L).repeat(S, 1))
    hp = dedup_plan(flat, is_hot.reshape(nb, L))
    return (cp._replace(slots=cp.slots.reshape(owned.shape)),
            hp._replace(slots=hp.slots.reshape(B, G, L)))


def fused_resume_dense(part_c: torch.Tensor, part_h: torch.Tensor,
                       impl: str = "cuda") -> torch.Tensor:
    """Phase 3 on the partial tiles: ``part_c`` (B, F, D), or (S, B, F, D)
    summed in shard order (the one-device psum), plus ``part_h`` -- the
    split path's ``cold + hot`` operand order -- then the interaction ->
    (B, P) packed lower triangle."""
    B, F = part_h.shape[:2]
    P = F * (F - 1) // 2
    if B == 0 or F == 1:
        return torch.zeros((B, P), dtype=torch.float32, device=part_h.device)
    return ops.fused_resume(part_c, part_h, impl=impl)


def masked_gather_rows(local_storage: torch.Tensor, local_rows: torch.Tensor,
                       owned: torch.Tensor) -> torch.Tensor:
    """Pond's per-shard step: the raw rows, zero where not owned, (N,) ->
    (N, D) in the storage's dtype (the caller dequantizes after the
    gather).  Plain PyTorch: the reference computes it outside any Pallas
    kernel."""
    safe = torch.where(owned, local_rows, torch.zeros_like(local_rows))
    rows = local_storage[safe.long()]
    return rows * owned.to(rows.dtype)[:, None]
