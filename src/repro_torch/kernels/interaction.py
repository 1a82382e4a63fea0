"""Wrappers of the CUDA interaction kernels: check, launch, count.

``csrc/dot_interaction.cu`` holds one kernel template for two kernels.
``dot_interaction`` replaces the Pallas TPU kernel
``repro/kernels/interaction.py:dot_interaction_pallas``: Z = X X^T per
sample on (B, F, D), packed lower triangle (B, P), the (B, F, F) product
never in memory.  ``fused_resume`` replaces ``repro/kernels/sls.py:
fused_resume_pallas``: the same interaction on the partial-pool tiles'
sum, the S cold shards' tiles in shard order plus the hot tile.  Both are
bound by bytes (about 2 flops per byte at F = 9).

Both launches are sized to the bytes, not to the pairs
(:func:`tile_shape`): blocks of 128 or 256 threads own NS samples, whose
tiles are contiguous runs, staged into shared memory at a row stride that
keeps float4 alignment, as float4 through registers with several loads
per thread in flight (``dot_interaction`` one run, the resume S + 1);
each thread then reduces whole dots with the fmaf sequence the fused
front end shares, so fused == split and partial pool -> resume ==
split bit for bit.  Timings on the card are in ``PERF.md``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sls import SMEM_MAX, _stream


def check_dot_interaction(feats: torch.Tensor) -> None:
    if feats.dim() != 3 or feats.dtype != torch.float32:
        raise TypeError(f"feats: expected (B, F, D) float32, got "
                        f"{feats.dtype} of shape {tuple(feats.shape)}")
    if not feats.is_contiguous():
        raise ValueError("feats must be contiguous")


TILE_BLOCKS_PER_SM = 4     # blocks per SM the batch is spread over
TILE_MAX_NS = 8            # samples per block, at most
DOT_PAIRS = 4              # pairs per thread once a block holds 2+ samples


def tile_shape(B: int, F: int, D: int, n_sm: int, vec4: bool = True):
    """Launch shape of the interaction kernels: (NS samples per block,
    threads, shared row stride lds in floats).

    NS spreads the batch over ``TILE_BLOCKS_PER_SM`` blocks per SM (so a
    small batch still gets one block per sample), at most ``TILE_MAX_NS``
    and a tile that fits shared memory.  Threads follow the tile's bytes,
    not its pairs: 256 when the tile holds at least 256 float4 elements,
    else 128.  With ``vec4`` the row stride is
    4 * (the least odd number > D / 4), 16-byte aligned rows whose float4
    reads at one d fall in distinct bank groups; else D + 1."""
    if vec4:
        q = D // 4 + 1
        lds = 4 * (q if q % 2 else q + 1)
    else:
        lds = D + 1
    fit = SMEM_MAX // (F * lds * 4)
    if fit < 1:
        raise ValueError(f"a ({F}, {D}) feature tile exceeds shared memory")
    NS = max(1, min(TILE_MAX_NS, -(-B // (TILE_BLOCKS_PER_SM * n_sm)), fit))
    threads = 256 if NS * F * D >= 4 * 256 else 128
    return NS, threads, lds


def dot_pairs(NS: int) -> int:
    """Pairs (i, j..j+K-1) of one row per thread in the dot phase: one at
    one sample per block, where a sample's chains are all the parallelism
    there is; else ``DOT_PAIRS``, which reads x_i once for all of them."""
    return 1 if NS == 1 else DOT_PAIRS


def vec4_tiles(*tiles: torch.Tensor) -> bool:
    """Whether the kernels may stage these (..., D) tiles as float4: D % 4
    == 0 and every tile 16-byte aligned; else the scalar path of the same
    kernel."""
    return all(t.shape[-1] % 4 == 0 and t.data_ptr() % 16 == 0
               for t in tiles)


def dot_interaction(feats: torch.Tensor, self_interaction: bool = False
                    ) -> torch.Tensor:
    """(B, F, D) -> (B, P) on the card (plain version:
    ``ref.dot_interaction_ref``).  A 16-byte aligned ``feats`` with
    D % 4 == 0 reaches shared memory as float4, any other by scalar
    loads."""
    check_dot_interaction(feats)
    if feats.device.type != "cuda":
        raise ValueError("the dot_interaction kernel takes CUDA tensors")
    B, F, D = feats.shape
    P = F * (F + 1) // 2 if self_interaction else F * (F - 1) // 2
    out = torch.empty((B, P), dtype=torch.float32, device=feats.device)
    if B == 0 or P == 0:
        return out
    n_sm = torch.cuda.get_device_properties(
        feats.device).multi_processor_count
    vec4 = vec4_tiles(feats)
    NS, threads, lds = tile_shape(B, F, D, n_sm, vec4)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn = build.entry("dot_interaction", [P_, P_] + [I_] * 10 + [P_])
    err = fn(feats.data_ptr(), out.data_ptr(), B, F, D, P,
             int(self_interaction), NS, threads, lds, dot_pairs(NS),
             int(vec4), _stream(feats))
    build.check("dot_interaction", err)
    build.KERNELS["dot_interaction"].launches += 1
    return out


def check_fused_resume(part_c: torch.Tensor, part_h: torch.Tensor) -> None:
    """part_c (S, B, F, D) and part_h (B, F, D), float32, contiguous."""
    check_dot_interaction(part_h)
    if (part_c.dim() != 4 or part_c.dtype != torch.float32
            or tuple(part_c.shape[1:]) != tuple(part_h.shape)):
        raise TypeError(f"part_c: expected (S, *{tuple(part_h.shape)}) "
                        f"float32, got {part_c.dtype} of shape "
                        f"{tuple(part_c.shape)}")
    if not part_c.is_contiguous():
        raise ValueError("part_c must be contiguous")
    if part_c.device != part_h.device:
        raise ValueError(f"part_c is on {part_c.device}, part_h on "
                         f"{part_h.device}")


def fused_resume(part_c: torch.Tensor, part_h: torch.Tensor
                 ) -> torch.Tensor:
    """(S, B, F, D) cold and (B, F, D) hot tiles -> (B, P) on the card
    (plain version: ``ref.fused_resume_ref``)."""
    check_fused_resume(part_c, part_h)
    if part_h.device.type != "cuda":
        raise ValueError("the fused_resume kernel takes CUDA tensors")
    S, B, F, D = part_c.shape
    P = F * (F - 1) // 2
    out = torch.empty((B, P), dtype=torch.float32, device=part_h.device)
    if B == 0 or P == 0:
        return out
    n_sm = torch.cuda.get_device_properties(
        part_h.device).multi_processor_count
    vec4 = vec4_tiles(part_c, part_h)
    NS, threads, lds = tile_shape(B, F, D, n_sm, vec4)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn = build.entry("fused_resume", [P_, P_, P_, I_, I_, I_, I_, I_, I_, I_,
                                      I_, I_, P_])
    err = fn(part_c.data_ptr(), part_h.data_ptr(), out.data_ptr(), B, F, D,
             P, S, NS, threads, lds, int(vec4), _stream(part_h))
    build.check("fused_resume", err)
    build.KERNELS["fused_resume"].launches += 1
    return out
