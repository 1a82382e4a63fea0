"""SparseLengthSum (SLS) building blocks of the engine -- the paper's hot
operator (a port of the dense-bag half of ``repro.core.sls``).

Dense form: ``local_rows (B, L)`` with an ownership mask and optional
weights; padding entries carry weight 0.  Every path accumulates in the
fixed order l = 0..L-1 (``kernels/ref.py:_fixed_order_masked_sls`` is the
plain version, the CUDA kernels the fast one), so lookups do not depend on
the impl: with 0/1 weights they are bitwise equal.

Gather-once dedup (``dedup=True``) is not ported yet (``ROADMAP.md``
queue 1, item 7; queue 2, items 4-5).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops

_DEDUP_TODO = ("dedup=True is not ported yet (ROADMAP.md queue 1 item 7, "
               "queue 2 items 4-5)")


def masked_partial_sls_dense(local_storage: torch.Tensor,
                             local_rows: torch.Tensor, owned: torch.Tensor,
                             weights: Optional[torch.Tensor] = None,
                             impl: str = "cuda",
                             scales: Optional[torch.Tensor] = None,
                             dedup: bool = False) -> torch.Tensor:
    """``out[b] = sum_l owned[b,l] * w[b,l] * storage[local_rows[b,l]]``
    in fixed l-order, (B, L) -> (B, D) float32.  ``scales`` (B, L)
    dequantize an int8 ``local_storage`` per gathered row before the
    weighted add.  ``impl``: see ``kernels/ops.py``."""
    if dedup:
        raise NotImplementedError(_DEDUP_TODO)
    B, L = local_rows.shape
    if B == 0 or L == 0:
        return torch.zeros((B, local_storage.shape[-1]), dtype=torch.float32,
                           device=local_storage.device)
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
    composition inside the port."""
    if dedup:
        raise NotImplementedError(_DEDUP_TODO)
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
    return ops.fused_front_end(cold_storage, hot_storage, x, local_rows,
                               owned, is_hot, weights, scales, impl=impl)
