"""Wrappers of the CUDA SLS kernels: check inputs, launch, count launches.

* ``masked_sls`` -- ``csrc/masked_sls.cu``; replaces the Pallas TPU kernel
  ``repro/kernels/sls.py:_sls_call`` (``masked_sls_pallas`` and, with no
  mask, ``sls_pallas``).  Bound by bytes: one gathered row per pooling
  entry.  Design: a team of threads per bag, 16-byte row loads, the
  accumulator in registers (see the source's header).
* ``fused_front_end`` -- ``csrc/fused_front_end.cu``; replaces
  ``repro/kernels/sls.py:fused_front_end_pallas``.  Bound by bytes (the
  same gather); one CTA per batch tile pools both tiers into a
  shared-memory feature tile and runs the interaction on it, so the pooled
  features never reach device memory.

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
        raise ValueError(f"{name} needs a row 0 (masked-out entries read it)")


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
    D = table.shape[1]
    out = torch.empty((N, D), dtype=torch.float32, device=table.device)
    if N == 0:
        return out
    if L == 0:
        return out.zero_()
    fn = build.entry("masked_sls", [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I,
                                    _I, _P])
    err = fn(table.data_ptr(), table.element_size(), D,
             _vec16(D, table.element_size(), table), indices.data_ptr(),
             _ptr(owned), _ptr(weights), _ptr(scales), out.data_ptr(), N, L,
             _stream(table))
    build.check("masked_sls", err)
    build.KERNELS["masked_sls"].launches += 1
    return out


def check_fused_front_end(cold, hot, x, rows, owned, is_hot, weights,
                          scales) -> None:
    """Input contract of the fused_front_end kernel (and its plain
    version)."""
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
    _expect(scales, "scales", torch.float32, rows.shape, dev)
    if (cold.dtype == torch.int8) != (scales is not None):
        raise ValueError("an int8 cold tier needs per-entry scales, and only "
                         "an int8 cold tier takes them")


def fused_block(B: int, F: int, D: int, n_sm: int) -> int:
    """The cap on samples per CTA: at most ``MAX_BLOCK_B``, few enough that the
    batch spreads over every SM, and a feature tile that fits shared
    memory.  The kernel takes fewer where that leaves a team of threads
    more than one bag."""
    fit = SMEM_MAX // (F * (D + 1) * 4)
    if fit < 1:
        raise ValueError(f"a ({F}, {D}) feature tile exceeds shared memory")
    return max(1, min(MAX_BLOCK_B, -(-B // n_sm), fit))


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
    n_sm = torch.cuda.get_device_properties(cold.device).multi_processor_count
    max_bb = fused_block(B, F, D, n_sm)
    fn = build.entry("fused_front_end", [_P, _I, _I, _P, _P, _P, _P, _P, _P,
                                         _P, _P, _I, _I, _I, _I, _I, _P])
    err = fn(cold.data_ptr(), cold.element_size(),
             _vec16(D, cold.element_size(), cold)
             & _vec16(D, 4, hot), hot.data_ptr(),
             x.data_ptr(), rows.data_ptr(), owned.data_ptr(),
             is_hot.data_ptr(), _ptr(weights), _ptr(scales), out.data_ptr(),
             B, G, L, D, max_bb, _stream(cold))
    build.check("fused_front_end", err)
    build.KERNELS["fused_front_end"].launches += 1
    return out
