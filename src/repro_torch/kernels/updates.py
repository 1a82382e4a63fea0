"""Wrapper of the CUDA ``apply_deltas`` kernel: check inputs, launch, count.

``csrc/apply_deltas.cu`` folds a batch of unique-row deltas into the live
tables in place, both tiers in one launch; it replaces the reference's jnp
update (``repro/core/pifs.py:1232``, ``_build_update_plan.block``), not a
Pallas kernel.  Bound by bytes (each row read and written once, its delta
and two page-table entries); at serving's 256 rows it costs its launch.
One warp per row, 16-byte chunks where D % 4 == 0 (:func:`vec_width`).

This function takes CUDA tensors only and launches the kernel or raises;
``kernels/ops.py`` picks between it and the plain version
(``kernels/ref.apply_deltas_ref``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sls import _expect, _stream

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


def check_apply_deltas(cold, hot, page_scales, page_to_shard, page_to_slot,
                       rows, deltas) -> None:
    """Input contract of the apply_deltas kernel (and its plain version)."""
    if cold.dim() != 2 or cold.dtype not in (torch.float32, torch.int8):
        raise TypeError(f"cold: expected a 2-D float32 or int8 table, got "
                        f"{cold.dtype} of shape {tuple(cold.shape)}")
    if rows.dim() != 1:
        raise ValueError(f"rows must be (U,), got {tuple(rows.shape)}")
    dev, D = cold.device, cold.shape[1]
    P = page_to_shard.shape[0]
    _expect(cold, "cold", cold.dtype, cold.shape, dev)
    _expect(hot, "hot", torch.float32, (hot.shape[0], D), dev)
    _expect(page_scales, "page_scales", torch.float32, (P,), dev)
    _expect(page_to_shard, "page_to_shard", torch.int32, (P,), dev)
    _expect(page_to_slot, "page_to_slot", torch.int32, (P,), dev)
    _expect(rows, "rows", torch.int32, rows.shape, dev)
    _expect(deltas, "deltas", torch.float32, (rows.shape[0], D), dev)


def vec_width(D: int, *tensors: torch.Tensor) -> int:
    """4 (16-byte float chunks, 4-byte code chunks) when D % 4 == 0 and
    every row chunk is aligned so, else 1."""
    if D % 4:
        return 1
    ok = all(t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors)
    return 4 if ok else 1


def apply_deltas(cold: torch.Tensor, hot: torch.Tensor,
                 page_scales: torch.Tensor, page_to_shard: torch.Tensor,
                 page_to_slot: torch.Tensor, rows: torch.Tensor,
                 deltas: torch.Tensor, page_size: int,
                 rows_per_shard: int) -> None:
    """Fold ``deltas`` (U, D) into the rows ``rows`` (U,) of ``cold`` /
    ``hot`` in place, on the card (plain version:
    ``ref.apply_deltas_ref``)."""
    check_apply_deltas(cold, hot, page_scales, page_to_shard, page_to_slot,
                       rows, deltas)
    if cold.device.type != "cuda":
        raise ValueError("the apply_deltas kernel takes CUDA tensors")
    U, D = deltas.shape
    if U == 0:
        return
    vec = vec_width(D, cold, hot, deltas)
    fn = build.entry("apply_deltas", [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _I, _I64, _I64, _P])
    err = fn(cold.data_ptr(), cold.element_size(), hot.data_ptr(),
             page_scales.data_ptr(), page_to_shard.data_ptr(),
             page_to_slot.data_ptr(), rows.data_ptr(), deltas.data_ptr(),
             U, D, vec, page_size, rows_per_shard,
             page_to_shard.shape[0] * page_size, _stream(cold))
    build.check("apply_deltas", err)
    build.KERNELS["apply_deltas"].launches += 1
