"""Wrapper of the CUDA ``page_checksums`` kernel: check inputs, launch, count.

``csrc/page_checksums.cu`` folds each listed page of the live store into
its Fletcher pair ``[s1, s2]`` (uint32 wraparound sums over the page's
native-domain lanes plus its scale bits, ``core/integrity.py``); it
replaces the reference's jnp reduction (``repro/core/pifs.py:1394``,
``_build_checksum_plan.block``), not a Pallas kernel.  Bound by bytes
(each listed page read once); one warp per page, 16-byte loads where every
page start is aligned (:func:`vec_pages`), one launch for any number of
pages.  The sums are integers mod 2^32, so the kernel equals its plain
version (``kernels/ref.page_checksums_ref``) and the host twin bit for
bit whatever order it adds in.

This function takes CUDA tensors only and launches the kernel or raises;
``kernels/ops.py`` picks between it and the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sls import _expect, _stream

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


def check_page_checksums(cold, hot, page_scales, page_to_shard,
                         page_to_slot, pages) -> None:
    """Input contract of the page_checksums kernel (and its plain
    version)."""
    if cold.dim() != 2 or cold.dtype not in (torch.float32, torch.int8):
        raise TypeError(f"cold: expected a 2-D float32 or int8 table, got "
                        f"{cold.dtype} of shape {tuple(cold.shape)}")
    if pages.dim() != 1:
        raise ValueError(f"pages must be (K,), got {tuple(pages.shape)}")
    dev, D = cold.device, cold.shape[1]
    P = page_to_shard.shape[0]
    if P == 0:
        raise ValueError("the page table is empty")
    _expect(cold, "cold", cold.dtype, cold.shape, dev)
    _expect(hot, "hot", torch.float32, (hot.shape[0], D), dev)
    _expect(page_scales, "page_scales", torch.float32, (P,), dev)
    _expect(page_to_shard, "page_to_shard", torch.int32, (P,), dev)
    _expect(page_to_slot, "page_to_slot", torch.int32, (P,), dev)
    _expect(pages, "pages", torch.int32, pages.shape, dev)


def vec_pages(page_size: int, D: int, cold: torch.Tensor,
              hot: torch.Tensor) -> int:
    """1 (16-byte loads) when every page of both tiers starts 16-byte
    aligned and spans whole 16-byte chunks (a page is ``page_size * D``
    contiguous lanes; a shard's slice starts on a page boundary), else
    0."""
    n = page_size * D
    return int(n * cold.element_size() % 16 == 0 and n * 4 % 16 == 0
               and cold.data_ptr() % 16 == 0 and hot.data_ptr() % 16 == 0)


def page_checksums(cold: torch.Tensor, hot: torch.Tensor,
                   page_scales: torch.Tensor, page_to_shard: torch.Tensor,
                   page_to_slot: torch.Tensor, pages: torch.Tensor,
                   page_size: int, rows_per_shard: int) -> torch.Tensor:
    """(K, 2) int64 ``[s1, s2]`` of the pages ``pages`` (K,), each in
    [0, 2^32), zeros for a pad (-1), on the card (plain version:
    ``ref.page_checksums_ref``)."""
    check_page_checksums(cold, hot, page_scales, page_to_shard,
                         page_to_slot, pages)
    if cold.device.type != "cuda":
        raise ValueError("the page_checksums kernel takes CUDA tensors")
    K, D = pages.shape[0], cold.shape[1]
    out = torch.empty((K, 2), dtype=torch.int64, device=cold.device)
    if K == 0:
        return out
    fn = build.entry("page_checksums", [_P, _I, _P, _P, _P, _P, _P, _P, _I,
                                        _I, _I, _I, _I, _I64, _P])
    err = fn(cold.data_ptr(), cold.element_size(), hot.data_ptr(),
             page_scales.data_ptr(), page_to_shard.data_ptr(),
             page_to_slot.data_ptr(), pages.data_ptr(), out.data_ptr(), K,
             page_to_shard.shape[0], page_size, D,
             vec_pages(page_size, D, cold, hot), rows_per_shard,
             _stream(cold))
    build.check("page_checksums", err)
    build.KERNELS["page_checksums"].launches += 1
    return out
