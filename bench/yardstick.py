"""The benchmark's fixed arithmetic: the card's published peaks and the
roofline bound.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit: float32
outside the tensor cores (TF32 is off by the port's numerics contract) and
HBM3 bandwidth.  ``bound`` is ``chip_smoke.py: bound``'s arithmetic.
"""
from __future__ import annotations

FP32_FLOPS_PER_S = 67e12      # float32, no tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of bytes over the
    HBM bandwidth and operations over the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
