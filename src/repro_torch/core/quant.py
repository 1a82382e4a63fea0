"""Per-page symmetric int8 quantization for the cold embedding tier.

Bitwise the same as ``repro.core.quant``::

    scale[p] = max |x| over page p / 127        (1.0 for all-zero pages)
    q        = clip(round(x / scale[p]), -127, 127)   int8
    x_hat    = float32(q) * scale[p]

``torch.round`` rounds half to even, as ``jnp.round`` does, and the divide
is an IEEE float32 divide on both devices, so codes and scales equal the
reference's bit for bit.  Re-quantizing dequantized values with the same
scale recovers the codes, which is what keeps hot->cold demotion lossless.
"""
from __future__ import annotations

import torch

QMAX = 127  # symmetric int8 range [-127, 127]; -128 unused


def page_scales(pages: torch.Tensor) -> torch.Tensor:
    """Per-page dequant scales.  pages: (..., page_size, D) -> (...,) f32."""
    amax = pages.to(torch.float32).abs().amax(dim=(-2, -1))
    return torch.where(amax > 0, amax / QMAX,
                       torch.ones_like(amax)).to(torch.float32)


def quantize_rows(rows: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """rows (..., D) float, scales broadcastable against rows -> int8."""
    q = torch.round(rows.to(torch.float32) / scales)
    return q.clamp(-QMAX, QMAX).to(torch.int8)


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 codes (..., D), scales broadcastable -> float32 values."""
    return q.to(torch.float32) * scales


def quantize_pages(pages: torch.Tensor):
    """(P, page_size, D) float -> ((P, page_size, D) int8, (P,) f32)."""
    scales = page_scales(pages)
    return quantize_rows(pages, scales[:, None, None]), scales


def dequantize_pages(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_pages` (up to the half-scale error)."""
    return dequantize_rows(q, scales[:, None, None])
