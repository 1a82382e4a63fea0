"""Wrapper of the CUDA dot-interaction kernel: check, launch, count.

``csrc/dot_interaction.cu`` replaces the Pallas TPU kernel
``repro/kernels/interaction.py:dot_interaction_pallas``: Z = X X^T per
sample on (B, F, D), packed lower triangle (B, P), the (B, F, F) product
never in memory.  Bound by bytes (about 2 flops per byte at F = 9); a block
stages a few samples' tiles in shared memory and each thread reduces whole
dots in a fixed order over D, with the device function the fused front
end shares.  Timings on the card are in ``PERF.md``.

``fused_resume`` (same source) replaces ``repro/kernels/sls.py:
fused_resume_pallas``: the tile it interacts is the partial-pool tiles'
sum, the S cold shards' tiles in shard order plus the hot tile.  Bound by
bytes ((S + 1) tiles in, (B, P) out).  Its launch is sized to the bytes,
not to the pairs (:func:`resume_shape`): blocks of 128 or 256 threads read
each tile's contiguous run of NS samples as float4, all S + 1 loads of an
element in flight before the adds, into a shared tile whose row stride
keeps float4 alignment; then each thread reduces whole dots with the same
fmaf sequence as ``dot_interaction``, so partial pool -> resume equals
split bit for bit.
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


def samples_per_block(B: int, F: int, D: int, P: int, n_sm: int) -> int:
    """A few samples per block: enough pairs for 256 threads, few enough
    blocks' worth that the batch spreads over every SM, and a tile that
    fits shared memory."""
    fit = SMEM_MAX // (F * (D + 1) * 4)
    if fit < 1:
        raise ValueError(f"a ({F}, {D}) feature tile exceeds shared memory")
    return max(1, min(max(1, 256 // P), -(-B // n_sm), fit))


RESUME_BLOCKS_PER_SM = 4   # resume blocks per SM the batch is spread over
RESUME_MAX_NS = 8          # samples per resume block, at most


def resume_shape(B: int, F: int, D: int, n_sm: int, vec4: bool = True):
    """Launch shape of the resume kernel: (NS samples per block, threads,
    shared row stride lds in floats).

    NS spreads the batch over ``RESUME_BLOCKS_PER_SM`` blocks per SM (so a
    small batch still gets one block per sample), at most
    ``RESUME_MAX_NS`` and a tile that fits shared memory.  Threads follow
    the tile's bytes, not its pairs: 256 when the tile holds at least 256
    float4 elements, else 128.  With ``vec4`` the row stride is
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
    NS = max(1, min(RESUME_MAX_NS, -(-B // (RESUME_BLOCKS_PER_SM * n_sm)),
                    fit))
    threads = 256 if NS * F * D >= 4 * 256 else 128
    return NS, threads, lds


def dot_interaction(feats: torch.Tensor,
                    self_interaction: bool = False) -> torch.Tensor:
    """(B, F, D) -> (B, P) on the card (plain version:
    ``ref.dot_interaction_ref``)."""
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
    S = samples_per_block(B, F, D, P, n_sm)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn = build.entry("dot_interaction", [P_, P_, I_, I_, I_, I_, I_, I_, P_])
    err = fn(feats.data_ptr(), out.data_ptr(), B, F, D, P,
             int(self_interaction), S, _stream(feats))
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
    vec4 = D % 4 == 0 and part_c.data_ptr() % 16 == 0 \
        and part_h.data_ptr() % 16 == 0
    NS, threads, lds = resume_shape(B, F, D, n_sm, vec4)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn = build.entry("fused_resume", [P_, P_, P_, I_, I_, I_, I_, I_, I_, I_,
                                      I_, I_, P_])
    err = fn(part_c.data_ptr(), part_h.data_ptr(), out.data_ptr(), B, F, D,
             P, S, NS, threads, lds, int(vec4), _stream(part_h))
    build.check("fused_resume", err)
    build.KERNELS["fused_resume"].launches += 1
    return out
