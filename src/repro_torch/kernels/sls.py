"""Wrappers of the CUDA SLS kernels: check inputs, launch, count launches.

* ``masked_sls`` and ``masked_sls_dedup`` -- ``csrc/masked_sls.cu``; they
  replace the Pallas TPU kernels ``repro/kernels/sls.py:_sls_call``
  (``masked_sls_pallas`` and, with no mask, ``sls_pallas``) and
  ``masked_sls_dedup_pallas``.  Bound by bytes (each distinct row once),
  in practice by each bag's chain of metadata -> row loads (through the
  dedup plan: metadata -> row id -> row).  One walk for both, the row
  source a template parameter (``csrc/gather_once.cuh``): a team of
  threads per bag stages a run's metadata in shared memory, keeps the
  owned entries and holds several rows in flight, in launches shaped by
  :func:`sls_shape`.  The gather-once kernel reads each row through the
  plan, ``unique_rows[slots[e]]``, with no staging buffer: duplicates
  share one address and the L2 serves them.
* ``ragged_sls`` -- ``csrc/masked_sls.cu``; it replaces no Pallas kernel
  (the reference pools bags of one length): the masked_sls walk over T
  tables whose bags differ in length, (N, C) entries with the T + 1 bag
  column edges -> (N, T, D), one launch a tier.  A team of threads walks
  several short bags of one table as one stream of entries, and the grid
  takes the tables longest bags first.
* ``fused_front_end`` and ``fused_front_end_dedup`` --
  ``csrc/fused_front_end.cu``; they replace
  ``repro/kernels/sls.py:fused_front_end_pallas`` and
  ``fused_front_end_dedup_pallas``.  Bound by bytes (the same gather);
  one CTA per batch tile pools both tiers with the same walk into a
  shared-memory feature tile and runs the interaction on it, so the pooled
  features never reach device memory (:func:`front_end_shape`).
* ``fused_partial_pool`` and ``fused_partial_pool_dedup`` -- the pooling
  stopped before the interaction, in a kernel of its own in
  ``csrc/fused_front_end.cu``; they replace
  ``repro/kernels/sls.py:fused_partial_pool_pallas`` and
  ``fused_partial_pool_dedup_pallas``.  They write the two (B, F, D)
  partial feature tiles ``part_c`` (per cold shard, row 0 zero) and
  ``part_h`` (row 0 = x) that ``fused_resume`` (``kernels/interaction.py``)
  finishes.  Bound by bytes (the gather plus the tiles written), in
  practice by the latency of each warp's chain of metadata -> row loads:
  so a thread team walks each bag's entries once for all S shards (up to
  8 per grid row; one shard per row at small batch, :func:`shard_group`),
  each shard accumulating the entries it owns in registers.  The
  gather-once variant stages both tiers in one launch, then accumulates:
  two launches.

Every kernel reads a row id as ``ref.clamp_rows`` does, against the rows
of the table it reads (``csrc/common.cuh: clamp_row``), so no id reads
outside its table; the wrappers pass each table's rows.

These functions take CUDA tensors only and launch the kernel or raise.
``kernels/ops.py`` picks between them and the plain versions in
``kernels/ref.py``.  Timings on the card are in ``PERF.md``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
SMEM_MAX = 232448          # bytes of shared memory a block can opt into
MAX_BLOCK_B = 16           # samples per CTA of the fused kernel, at most


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _vec16(D: int, itemsize: int, *tensors: torch.Tensor) -> int:
    """16-byte loads when each row chunk is 16-byte aligned."""
    return int((D * itemsize) % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _expect(t: Optional[torch.Tensor], name: str, dtype, shape,
            device) -> None:
    if t is None:
        return
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _expect_table(table: torch.Tensor, name: str, dtypes) -> None:
    if table.dim() != 2 or table.dtype not in dtypes:
        raise TypeError(f"{name}: expected a 2-D {dtypes} table, got "
                        f"{table.dtype} of shape {tuple(table.shape)}")
    if not table.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if table.shape[0] == 0:
        raise ValueError(f"{name} needs a row 0 (the plain versions read it "
                         "for masked-out entries)")


def check_masked_sls(table, indices, owned, weights, scales) -> None:
    """Input contract of the masked_sls kernel (and its plain version)."""
    _expect_table(table, "table", (torch.float32, torch.int8))
    if indices.dim() != 2:
        raise ValueError(f"indices must be (N, L), got {tuple(indices.shape)}")
    dev, shape = table.device, indices.shape
    _expect(indices, "indices", torch.int32, shape, dev)
    _expect(owned, "owned", torch.bool, shape, dev)
    _expect(weights, "weights", torch.float32, shape, dev)
    _expect(scales, "scales", torch.float32, shape, dev)
    if (table.dtype == torch.int8) != (scales is not None):
        raise ValueError("an int8 table needs per-entry scales, and only an "
                         "int8 table takes them")


def masked_sls(table: torch.Tensor, indices: torch.Tensor,
               owned: Optional[torch.Tensor] = None,
               weights: Optional[torch.Tensor] = None,
               scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, L) bags -> (N, D) float32 pooled rows on the card (plain
    version: ``ref._fixed_order_masked_sls``)."""
    check_masked_sls(table, indices, owned, weights, scales)
    if table.device.type != "cuda":
        raise ValueError("the masked_sls kernel takes CUDA tensors")
    N, L = indices.shape
    V, D = table.shape
    out = torch.empty((N, D), dtype=torch.float32, device=table.device)
    if N == 0:
        return out
    if L == 0:
        return out.zero_()
    vec, _, inflight, threads, _ = sls_shape(
        N, D, table.element_size(),
        bool(_vec16(D, table.element_size(), table)), _n_sm(table))
    fn = build.entry("masked_sls", [_P, _I, _I64, _I, _I, _I, _P, _P, _P, _P,
                                    _P, _I, _I, _I, _P])
    err = fn(table.data_ptr(), table.element_size(), V, D, vec, inflight,
             indices.data_ptr(), _ptr(owned), _ptr(weights), _ptr(scales),
             out.data_ptr(), N, L, threads, _stream(table))
    build.check("masked_sls", err)
    build.KERNELS["masked_sls"].launches += 1
    return out


RAGGED_MAX_TABLES = 128   # tables of one ragged_sls launch, at most


def check_ragged_sls(table, indices, edges, owned, weights, scales
                     ) -> tuple:
    """Input contract of the ragged_sls kernel (and its plain version);
    returns the edges as a tuple of ints."""
    edges = tuple(int(c) for c in edges)
    if indices.dim() != 2:
        raise ValueError(f"indices must be (N, C), got "
                         f"{tuple(indices.shape)}")
    if not 2 <= len(edges) <= RAGGED_MAX_TABLES + 1 or edges[0] != 0 \
            or edges[-1] != indices.shape[1] \
            or any(b < a for a, b in zip(edges, edges[1:])):
        raise ValueError(f"bag edges must rise from 0 to the "
                         f"{indices.shape[1]} columns, for 1 to "
                         f"{RAGGED_MAX_TABLES} tables; got {edges}")
    check_masked_sls(table, indices, owned, weights, scales)
    return edges


def ragged_sls(table: torch.Tensor, indices: torch.Tensor, edges,
               owned: Optional[torch.Tensor] = None,
               weights: Optional[torch.Tensor] = None,
               scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, C) entries of T bags a row, table t's in the columns
    [edges[t], edges[t + 1]) -> (N, T, D) float32 pooled rows on the card,
    one launch (plain version: ``ref.ragged_sls_ref``).  The launch shape
    is masked_sls's for N * T bags."""
    edges = check_ragged_sls(table, indices, edges, owned, weights, scales)
    if table.device.type != "cuda":
        raise ValueError("the ragged_sls kernel takes CUDA tensors")
    N = indices.shape[0]
    T = len(edges) - 1
    V, D = table.shape
    out = torch.empty((N, T, D), dtype=torch.float32, device=table.device)
    if N == 0:
        return out
    vec, _, inflight, threads, _ = sls_shape(
        N * T, D, table.element_size(),
        bool(_vec16(D, table.element_size(), table)), _n_sm(table))
    fn = build.entry("ragged_sls", [_P, _I, _I64, _I, _I, _I, _P, _P, _P, _P,
                                    _P, _I, _I, _P, _I, _P])
    err = fn(table.data_ptr(), table.element_size(), V, D, vec, inflight,
             indices.data_ptr(), _ptr(owned), _ptr(weights), _ptr(scales),
             out.data_ptr(), N, T, (ctypes.c_int64 * len(edges))(*edges),
             threads, _stream(table))
    build.check("ragged_sls", err)
    build.KERNELS["ragged_sls"].launches += 1
    return out


def check_fused_front_end(cold, hot, x, rows, owned, is_hot, weights,
                          scales) -> None:
    """Input contract of the fused_front_end kernel (and its plain
    version)."""
    _check_fused_operands(cold, hot, x, rows, owned, is_hot, weights)
    _expect(scales, "scales", torch.float32, rows.shape, cold.device)
    if (cold.dtype == torch.int8) != (scales is not None):
        raise ValueError("an int8 cold tier needs per-entry scales, and only "
                         "an int8 cold tier takes them")


def _check_fused_operands(cold, hot, x, rows, owned, is_hot,
                          weights) -> None:
    _expect_table(cold, "cold", (torch.float32, torch.int8))
    _expect_table(hot, "hot", (torch.float32,))
    if rows.dim() != 3:
        raise ValueError(f"rows must be (B, G, L), got {tuple(rows.shape)}")
    B, G, L = rows.shape
    D = cold.shape[1]
    dev = cold.device
    if hot.shape[1] != D:
        raise ValueError(f"hot width {hot.shape[1]} != cold width {D}")
    _expect(hot, "hot", torch.float32, hot.shape, dev)
    _expect(x, "x", torch.float32, (B, D), dev)
    _expect(rows, "rows", torch.int32, rows.shape, dev)
    _expect(owned, "owned", torch.bool, rows.shape, dev)
    _expect(is_hot, "is_hot", torch.bool, rows.shape, dev)
    _expect(weights, "weights", torch.float32, rows.shape, dev)


def fused_block(B: int, F: int, D: int, n_sm: int) -> int:
    """The cap on samples per CTA: at most ``MAX_BLOCK_B``, few enough that the
    batch spreads over every SM, and a feature tile that fits shared
    memory.  The kernel takes fewer where that leaves a team of threads
    more than one bag."""
    fit = SMEM_MAX // (F * (D + 1) * 4)
    if fit < 1:
        raise ValueError(f"a ({F}, {D}) feature tile exceeds shared memory")
    return max(1, min(MAX_BLOCK_B, -(-B // n_sm), fit))


SLS_THREADS = 64           # threads per masked_sls(_dedup) block, at most
FE_THREADS = 256           # threads per fused_front_end(_dedup) CTA, at most
PLAN_ENTRY_BYTES = 16      # shared memory per thread and tier (PlanEntry)


def _n_sm(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def team_size(chunks: int) -> int:
    """Threads per bag: the least power of two >= min(chunks, 32)
    (``csrc/common.cuh: team_size``)."""
    team = 1
    while team < chunks and team < 32:
        team *= 2
    return team


def sls_shape(N: int, D: int, itemsize: int, aligned: bool, n_sm: int):
    """Launch shape of ``masked_sls`` and ``masked_sls_dedup``: (vec, team,
    inflight, threads, blocks).

    Row elements per lane as the partial pool takes them (:func:`pool_vec`,
    one shard), a team of threads per bag, and blocks of whole warps and at
    most ``SLS_THREADS`` threads, with few enough bags per block that
    the N bags spread over every SM (batch 32 at one shard: 256 bags, 128
    blocks).  Block ``i`` holds bags ``i * threads / team`` onwards.  Rows
    in flight per lane: 8 below ``WALK_MIN_BAGS_PER_SM`` bags per SM (the
    card is mostly idle and each bag's chain of loads is the time), else 4
    (fewer registers, more warps)."""
    if N < 1:
        raise ValueError(f"masked_sls needs N >= 1 bags, got {N}")
    vec = pool_vec(D, itemsize, aligned, 1, N, n_sm)
    team = team_size(D // vec)
    warp = 32 // team                      # bags per warp
    per = min(SLS_THREADS // team, -(-N // (n_sm * warp)) * warp)
    inflight = 8 if N < WALK_MIN_BAGS_PER_SM * n_sm else 4
    return vec, team, inflight, per * team, -(-N // per)


def front_end_shape(B: int, G: int, D: int, itemsize: int, aligned: bool,
                    n_sm: int):
    """Launch shape of ``fused_front_end`` and ``fused_front_end_dedup``:
    (vec, team, BB, threads, inflight); the grid is ``ceil(B / BB)`` CTAs,
    one per feature tile of BB samples.

    Row elements per lane as :func:`pool_vec` picks them for one shard, a
    team of threads per bag, BB as :func:`fused_block` picks it with at
    most one bag per team of a full CTA (so a small batch gets one CTA per
    sample), and whole warps, at most ``FE_THREADS``, one team per
    bag of the tile where they fit (the teams walk the rest in turn).
    Rows in flight per lane: 8 below ``WALK_MIN_BAGS_PER_SM`` bags per SM
    with a float32 cold tier (few CTAs, and each bag's chain of loads is
    the time), else 4 (registers for 4 CTAs per SM); an int8 cold tier
    keeps its rows in a list of their own, 2 per tier.
    Raises where shared memory cannot hold one sample's tile beside the
    metadata."""
    if G < 1:
        raise ValueError(f"the fused front end needs G >= 1, got {G}")
    F = G + 1
    meta = 2 * FE_THREADS * PLAN_ENTRY_BYTES
    fit = (SMEM_MAX - meta) // (F * (D + 1) * 4)
    if fit < 1:
        raise ValueError(f"a ({F}, {D}) feature tile exceeds shared memory")
    vec = pool_vec(D, itemsize, aligned, 1, B * G, n_sm)
    team = team_size(D // vec)
    BB = max(1, min(fused_block(B, F, D, n_sm), fit,
                    FE_THREADS // team // G))
    threads = min(FE_THREADS, -(-BB * G * team // 32) * 32)
    inflight = (8 if itemsize == 4 and B * G < WALK_MIN_BAGS_PER_SM * n_sm
                else 4)
    return vec, team, BB, threads, inflight


def fused_front_end(cold: torch.Tensor, hot: torch.Tensor, x: torch.Tensor,
                    rows: torch.Tensor, owned: torch.Tensor,
                    is_hot: torch.Tensor,
                    weights: Optional[torch.Tensor] = None,
                    scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Two-tier masked SLS -> interaction, one kernel: (B, G, L) entries
    and x (B, D) -> (B, P) packed triangle on the card (plain version:
    ``ref.fused_front_end_ref``)."""
    check_fused_front_end(cold, hot, x, rows, owned, is_hot, weights, scales)
    if cold.device.type != "cuda":
        raise ValueError("the fused_front_end kernel takes CUDA tensors")
    B, G, L = rows.shape
    D = cold.shape[1]
    F = G + 1
    P = F * (F - 1) // 2
    out = torch.empty((B, P), dtype=torch.float32, device=cold.device)
    if B == 0 or P == 0:
        return out
    if L == 0:
        raise ValueError("fused_front_end needs L >= 1 (core/sls.py answers "
                         "empty bags with zeros, as the reference does)")
    n_sm = _n_sm(cold)
    vec, _, BB, threads, inflight = front_end_shape(
        B, G, D, cold.element_size(),
        bool(_vec16(D, cold.element_size(), cold) & _vec16(D, 4, hot)), n_sm)
    fn = build.entry("fused_front_end", [_P, _I, _I64, _I, _P, _I64, _P, _P,
                                         _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                         _I, _I, _I, _P])
    err = fn(cold.data_ptr(), cold.element_size(), cold.shape[0], vec,
             hot.data_ptr(), hot.shape[0], x.data_ptr(), rows.data_ptr(),
             owned.data_ptr(), is_hot.data_ptr(), _ptr(weights),
             _ptr(scales), out.data_ptr(), B, G, L, D, BB, threads, inflight,
             _stream(cold))
    build.check("fused_front_end", err)
    build.KERNELS["fused_front_end"].launches += 1
    return out


def _expect_plan(unique_rows, n_slots, unique_scales, U: int, dev) -> None:
    _expect(unique_rows, "unique_rows", torch.int32, (U,), dev)
    _expect(n_slots, "n_slots", torch.int32, (1,), dev)
    _expect(unique_scales, "unique_scales", torch.float32, (U,), dev)


def check_masked_sls_dedup(table, unique_rows, slots, owned, n_slots,
                           weights, unique_scales) -> None:
    """Input contract of the masked_sls_dedup kernel (and its plain
    version): a dedup plan of capacity U = N * L over (N, L) bags."""
    _expect_table(table, "table", (torch.float32, torch.int8))
    if slots.dim() != 2:
        raise ValueError(f"slots must be (N, L), got {tuple(slots.shape)}")
    if owned is None:
        raise ValueError("a dedup plan comes with its ownership mask")
    dev, shape = table.device, slots.shape
    _expect(slots, "slots", torch.int32, shape, dev)
    _expect(owned, "owned", torch.bool, shape, dev)
    _expect(weights, "weights", torch.float32, shape, dev)
    _expect_plan(unique_rows, n_slots, unique_scales, slots.numel(), dev)
    if (table.dtype == torch.int8) != (unique_scales is not None):
        raise ValueError("an int8 table needs per-slot scales, and only an "
                         "int8 table takes them")


def masked_sls_dedup(table: torch.Tensor, unique_rows: torch.Tensor,
                     slots: torch.Tensor, owned: torch.Tensor,
                     n_slots: torch.Tensor,
                     weights: Optional[torch.Tensor] = None,
                     unique_scales: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Gather-once masked SLS on the card, one launch reading each row
    through the plan: (N, L) bags -> (N, D) float32 (plain version:
    ``ref.masked_sls_dedup_ref``).  ``n_slots`` is part of the plan's
    contract; the kernel, which stages nothing, does not read it."""
    check_masked_sls_dedup(table, unique_rows, slots, owned, n_slots,
                           weights, unique_scales)
    if table.device.type != "cuda":
        raise ValueError("the masked_sls_dedup kernel takes CUDA tensors")
    N, L = slots.shape
    V, D = table.shape
    out = torch.empty((N, D), dtype=torch.float32, device=table.device)
    if N == 0:
        return out
    if L == 0:
        return out.zero_()
    vec, _, inflight, threads, _ = sls_shape(
        N, D, table.element_size(),
        bool(_vec16(D, table.element_size(), table)), _n_sm(table))
    fn = build.entry("masked_sls_dedup",
                     [_P, _I, _I64, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                      _I, _I, _P])
    err = fn(table.data_ptr(), table.element_size(), V, D, vec, inflight,
             unique_rows.data_ptr(), _ptr(unique_scales), slots.data_ptr(),
             owned.data_ptr(), _ptr(weights), out.data_ptr(), N, L, threads,
             _stream(table))
    build.check("masked_sls_dedup", err)
    build.KERNELS["masked_sls_dedup"].launches += 1
    return out


def check_fused_front_end_dedup(cold, hot, x, c_unique, c_slots, c_n,
                                h_unique, h_slots, h_n, owned, is_hot,
                                weights, c_scales) -> None:
    """Input contract of the fused_front_end_dedup kernel (and its plain
    version): one dedup plan per tier, capacity U = B * G * L each."""
    _check_fused_operands(cold, hot, x, c_slots, owned, is_hot, weights)
    dev, U = cold.device, c_slots.numel()
    _expect(h_slots, "h_slots", torch.int32, c_slots.shape, dev)
    _expect_plan(c_unique, c_n, c_scales, U, dev)
    _expect_plan(h_unique, h_n, None, U, dev)
    if (cold.dtype == torch.int8) != (c_scales is not None):
        raise ValueError("an int8 cold tier needs per-slot scales, and only "
                         "an int8 cold tier takes them")


def fused_front_end_dedup(cold: torch.Tensor, hot: torch.Tensor,
                          x: torch.Tensor, c_unique: torch.Tensor,
                          c_slots: torch.Tensor, c_n: torch.Tensor,
                          h_unique: torch.Tensor, h_slots: torch.Tensor,
                          h_n: torch.Tensor, owned: torch.Tensor,
                          is_hot: torch.Tensor,
                          weights: Optional[torch.Tensor] = None,
                          c_scales: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Gather-once fused front end on the card, one launch reading each
    tier's rows through its plan -> (B, P) (plain version:
    ``ref.fused_front_end_dedup_ref``).  ``c_n`` and ``h_n`` are part of the
    plans' contract; the kernel does not read them."""
    check_fused_front_end_dedup(cold, hot, x, c_unique, c_slots, c_n,
                                h_unique, h_slots, h_n, owned, is_hot,
                                weights, c_scales)
    if cold.device.type != "cuda":
        raise ValueError("the fused_front_end_dedup kernel takes CUDA "
                         "tensors")
    B, G, L = c_slots.shape
    D = cold.shape[1]
    F = G + 1
    P = F * (F - 1) // 2
    out = torch.empty((B, P), dtype=torch.float32, device=cold.device)
    if B == 0 or P == 0:
        return out
    if L == 0:
        raise ValueError("fused_front_end_dedup needs L >= 1 (core/sls.py "
                         "answers empty bags with zeros)")
    n_sm = _n_sm(cold)
    vec, _, BB, threads, inflight = front_end_shape(
        B, G, D, cold.element_size(),
        bool(_vec16(D, cold.element_size(), cold) & _vec16(D, 4, hot)), n_sm)
    fn = build.entry("fused_front_end_dedup",
                     [_P, _I, _I64, _I, _P, _I64, _P, _P, _P, _P, _P, _P, _P,
                      _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])
    err = fn(cold.data_ptr(), cold.element_size(), cold.shape[0], vec,
             hot.data_ptr(), hot.shape[0], x.data_ptr(), c_unique.data_ptr(),
             _ptr(c_scales), h_unique.data_ptr(), c_slots.data_ptr(),
             h_slots.data_ptr(), owned.data_ptr(), is_hot.data_ptr(),
             _ptr(weights), out.data_ptr(), B, G, L, D, BB, threads,
             inflight, _stream(cold))
    build.check("fused_front_end_dedup", err)
    build.KERNELS["fused_front_end_dedup"].launches += 1
    return out


def _check_shard_masks(cold, owned, rows) -> None:
    """``owned`` (S, B, G, L) over the S equal slices of ``cold``."""
    if owned.dim() != 4 or tuple(owned.shape[1:]) != tuple(rows.shape):
        raise ValueError(f"owned must be (S, *rows.shape) = (S, "
                         f"{', '.join(map(str, rows.shape))}), got "
                         f"{tuple(owned.shape)}")
    S = owned.shape[0]
    if S < 1 or cold.shape[0] % S:
        raise ValueError(f"{S} shards do not split the {cold.shape[0]} "
                         "cold-tier rows evenly")
    _expect(owned, "owned", torch.bool, owned.shape, cold.device)


def check_fused_partial_pool(cold, hot, x, rows, owned, is_hot, weights,
                             scales) -> None:
    """Input contract of the fused_partial_pool kernel (and its plain
    version): ``fused_front_end``'s, with ``owned`` (S, B, G, L), one mask
    per cold shard."""
    _check_shard_masks(cold, owned, rows)
    _check_fused_operands(cold, hot, x, rows, owned[0], is_hot, weights)
    _expect(scales, "scales", torch.float32, rows.shape, cold.device)
    if (cold.dtype == torch.int8) != (scales is not None):
        raise ValueError("an int8 cold tier needs per-entry scales, and only "
                         "an int8 cold tier takes them")


SHARD_GROUP_MAX = 8        # cold shards one partial-pool grid row walks
WALK_MIN_BAGS_PER_SM = 16  # bags per SM from which all shards share a walk


def shard_group(S: int, bags: int = 0, n_sm: int = 1):
    """(shards per grid row, grid rows) of the partial pool for S cold
    shards over ``bags`` bags.

    A full card (at least ``WALK_MIN_BAGS_PER_SM`` bags per SM) walks each
    bag's entries once for all shards: the least of 1, 2, 4, 8 that holds
    S (a template parameter of the kernel, so each shard's accumulator
    stays in registers), more than 8 shards in groups of 8, one grid row
    each.  With fewer bags the card is mostly idle and a warp's chain of
    loads is the time, so each shard takes a grid row of its own (the
    walk's work spread over S times the warps)."""
    if S < 1:
        raise ValueError(f"the partial pool needs S >= 1 shards, got {S}")
    if bags < WALK_MIN_BAGS_PER_SM * n_sm:
        return 1, S
    nsh = 1
    while nsh < min(S, SHARD_GROUP_MAX):
        nsh *= 2
    return nsh, -(-S // nsh)


def pool_vec(D: int, itemsize: int, aligned: bool, nsh: int,
             bags: int, n_sm: int) -> int:
    """Row elements per lane of the partial pool: 4 (a 16-byte float32
    chunk, or 4 int8 codes) when rows are 16-byte aligned, else 1.  int8
    takes 16 codes (16 bytes) when a grid row walks at most 2 shards over a
    full card: fewer lanes per bag put more bags in flight, and at most 2
    shards' 16-float accumulators fit the registers."""
    if not aligned:
        return 1
    if (itemsize == 1 and nsh <= 2
            and bags >= WALK_MIN_BAGS_PER_SM * n_sm):
        return 16
    return 4


def _tiles_out(S: int, B: int, F: int, D: int, dev):
    return (torch.empty((S, B, F, D), dtype=torch.float32, device=dev),
            torch.empty((B, F, D), dtype=torch.float32, device=dev))


def fused_partial_pool(cold: torch.Tensor, hot: torch.Tensor,
                       x: torch.Tensor, rows: torch.Tensor,
                       owned: torch.Tensor, is_hot: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       scales: Optional[torch.Tensor] = None):
    """Two-tier masked SLS into partial tiles, one launch and one walk
    over the entries for all S shards: (B, G, L) entries, ``owned`` (S, B, G, L) and x (B, D) ->
    ``part_c`` (S, B, F, D), ``part_h`` (B, F, D) on the card (plain
    version: ``ref.fused_partial_pool_ref``)."""
    check_fused_partial_pool(cold, hot, x, rows, owned, is_hot, weights,
                             scales)
    if cold.device.type != "cuda":
        raise ValueError("the fused_partial_pool kernel takes CUDA tensors")
    B, G, L = rows.shape
    S = owned.shape[0]
    D = cold.shape[1]
    F = G + 1
    part_c, part_h = _tiles_out(S, B, F, D, cold.device)
    if B == 0:
        return part_c, part_h
    if L == 0 or G == 0:
        raise ValueError("fused_partial_pool needs G, L >= 1 (core/sls.py "
                         "answers empty bags itself, as the reference does)")
    n_sm = _n_sm(cold)
    nsh, _ = shard_group(S, B * G, n_sm)
    vec = pool_vec(D, cold.element_size(),
                   bool(_vec16(D, cold.element_size(), cold)
                        & _vec16(D, 4, hot)), nsh, B * G, n_sm)
    fn = build.entry("fused_partial_pool",
                     [_P, _I, _I, _I64, _I, _I, _P, _I64, _P, _P, _P, _P,
                      _P, _P, _P, _P, _I, _I, _I, _I, _P])
    err = fn(cold.data_ptr(), cold.element_size(), vec,
             cold.shape[0] // S, S, nsh, hot.data_ptr(), hot.shape[0],
             x.data_ptr(), rows.data_ptr(), owned.data_ptr(),
             is_hot.data_ptr(), _ptr(weights), _ptr(scales),
             part_c.data_ptr(), part_h.data_ptr(), B, G, L, D, _stream(cold))
    build.check("fused_partial_pool", err)
    build.KERNELS["fused_partial_pool"].launches += 1
    return part_c, part_h


def check_fused_partial_pool_dedup(cold, hot, x, c_unique, c_slots, c_n,
                                   h_unique, h_slots, h_n, owned, is_hot,
                                   weights, c_scales) -> None:
    """Input contract of the fused_partial_pool_dedup kernel (and its plain
    version): one cold plan over all S shards (``c_slots`` and ``owned``
    (S, B, G, L), capacity S * B * G * L, rows of the whole cold tier) and
    one hot plan (``h_slots`` (B, G, L))."""
    _check_shard_masks(cold, owned, h_slots)
    _check_fused_operands(cold, hot, x, h_slots, owned[0], is_hot, weights)
    dev = cold.device
    _expect(h_slots, "h_slots", torch.int32, h_slots.shape, dev)
    _expect(c_slots, "c_slots", torch.int32, owned.shape, dev)
    _expect_plan(c_unique, c_n, c_scales, c_slots.numel(), dev)
    _expect_plan(h_unique, h_n, None, h_slots.numel(), dev)
    if (cold.dtype == torch.int8) != (c_scales is not None):
        raise ValueError("an int8 cold tier needs per-slot scales, and only "
                         "an int8 cold tier takes them")


def fused_partial_pool_dedup(cold: torch.Tensor, hot: torch.Tensor,
                             x: torch.Tensor, c_unique: torch.Tensor,
                             c_slots: torch.Tensor, c_n: torch.Tensor,
                             h_unique: torch.Tensor, h_slots: torch.Tensor,
                             h_n: torch.Tensor, owned: torch.Tensor,
                             is_hot: torch.Tensor,
                             weights: Optional[torch.Tensor] = None,
                             c_scales: Optional[torch.Tensor] = None):
    """Gather-once partial pool on the card: both tiers' staging in one
    launch, then the partial pool through the slots -> (``part_c``
    (S, B, F, D), ``part_h`` (B, F, D)) (plain version:
    ``ref.fused_partial_pool_dedup_ref``)."""
    check_fused_partial_pool_dedup(cold, hot, x, c_unique, c_slots, c_n,
                                   h_unique, h_slots, h_n, owned, is_hot,
                                   weights, c_scales)
    if cold.device.type != "cuda":
        raise ValueError("the fused_partial_pool_dedup kernel takes CUDA "
                         "tensors")
    B, G, L = h_slots.shape
    S = owned.shape[0]
    D = cold.shape[1]
    F = G + 1
    part_c, part_h = _tiles_out(S, B, F, D, cold.device)
    if B == 0:
        return part_c, part_h
    if L == 0 or G == 0:
        raise ValueError("fused_partial_pool_dedup needs G, L >= 1 "
                         "(core/sls.py answers empty bags itself)")
    Uc, Uh = c_slots.numel(), h_slots.numel()
    c_stage = torch.empty((Uc, D), dtype=torch.float32, device=cold.device)
    h_stage = torch.empty((Uh, D), dtype=torch.float32, device=cold.device)
    n_sm = _n_sm(cold)
    nsh, _ = shard_group(S, B * G, n_sm)
    fn = build.entry("fused_partial_pool_dedup",
                     [_P, _I, _I64, _I, _I, _I, _P, _I64, _P, _P, _P, _P, _P,
                      _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                      _I, _I, _P])
    err = fn(cold.data_ptr(), cold.element_size(), cold.shape[0],
             _vec16(D, cold.element_size(), cold) & _vec16(D, 4, hot), S,
             nsh, hot.data_ptr(), hot.shape[0], x.data_ptr(), c_unique.data_ptr(),
             c_n.data_ptr(), _ptr(c_scales), h_unique.data_ptr(),
             h_n.data_ptr(), c_stage.data_ptr(), h_stage.data_ptr(), Uc, Uh,
             c_slots.data_ptr(), h_slots.data_ptr(), owned.data_ptr(),
             is_hot.data_ptr(), _ptr(weights), part_c.data_ptr(),
             part_h.data_ptr(), B, G, L, D, _stream(cold))
    build.check("fused_partial_pool_dedup", err)
    build.KERNELS["fused_partial_pool_dedup"].launches += 1
    return part_c, part_h
