"""Plain PyTorch versions of the kernels (torch twins of ``repro.kernels.ref``).

Each CUDA kernel in this package has its plain version here.  The kernel
wrappers take these for CPU tensors; on the card only ``chip_smoke.py``
and an explicit ``impl="torch"`` call them, to hold the kernels against
them.

Accumulation order is the kernels' fixed l = 0..L-1 order, and partials
of several cold-tier shards are summed in shard order (:func:`shard_sum`).
The plain versions multiply then add (two roundings) where the kernels
use one ``fmaf``: with factors f = owned*w of 0 or 1 the product is exact
and the two agree bitwise (all serving traffic); with general weights
they may differ by at most 1 ulp per accumulate step.
"""
from __future__ import annotations

from typing import Optional

import torch


def sls_ref(table: torch.Tensor, indices: torch.Tensor,
            weights: Optional[torch.Tensor] = None,
            out_dtype=torch.float32) -> torch.Tensor:
    """SparseLengthSum: out[b] = sum_l w[b,l] * table[idx[b,l]], summed in
    the order l = 0..L-1 as the reference's reduce sums (the plain version
    of ``ops.sls``)."""
    rows = table[indices.long()].to(out_dtype)                  # (B, L, D)
    f = (torch.ones(indices.shape, dtype=out_dtype, device=indices.device)
         if weights is None else weights.to(out_dtype))
    return _fixed_order_accumulate(rows, f)


def masked_sls_ref(table: torch.Tensor, indices: torch.Tensor,
                   owned: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   out_dtype=torch.float32,
                   scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked partial SLS (summed in one reduce, not in fixed order):
    out[b] = sum_l owned[b,l] * w[b,l] * (scale[b,l] * table[idx[b,l]]).
    Non-owned entries are remapped to row 0 before the gather."""
    safe = torch.where(owned, indices, torch.zeros_like(indices))
    rows = table[safe.long()].to(out_dtype)
    if scales is not None:
        rows = rows * scales[..., None].to(out_dtype)
    w = owned.to(out_dtype)
    if weights is not None:
        w = w * weights.to(out_dtype)
    return (rows * w[..., None]).sum(dim=1)


def _fixed_order_masked_sls(table: torch.Tensor, indices: torch.Tensor,
                            owned: Optional[torch.Tensor],
                            weights: Optional[torch.Tensor] = None,
                            scales: Optional[torch.Tensor] = None,
                            out_dtype=torch.float32) -> torch.Tensor:
    """Masked partial SLS in the kernels' fixed l-order -- the plain version
    of the ``masked_sls`` kernel.  ``owned=None`` means every entry is
    owned (plain SLS).  Each gathered row is dequantized
    (``float(row) * scale``) before the weighted add."""
    B, L = indices.shape
    D = table.shape[-1]
    if owned is None:
        safe = indices
        f = torch.ones((B, L), dtype=out_dtype, device=indices.device)
    else:
        safe = torch.where(owned, indices, torch.zeros_like(indices))
        f = owned.to(out_dtype)
    rows = table[safe.long()].to(out_dtype)                     # (B, L, D)
    if scales is not None:
        rows = rows * scales[..., None].to(out_dtype)
    if weights is not None:
        f = f * weights.to(out_dtype)
    return _fixed_order_accumulate(rows, f)


def _fixed_order_accumulate(rows: torch.Tensor, f: torch.Tensor
                            ) -> torch.Tensor:
    """out[b] = sum_l f[b,l] * rows[b,l] in the order l = 0..L-1: the
    shared tail of every plain SLS version."""
    B, L, D = rows.shape
    out = torch.zeros((B, D), dtype=rows.dtype, device=rows.device)
    for l in range(L):
        out = out + f[:, l, None] * rows[:, l]
    return out


def masked_sls_quant_ref(table_q: torch.Tensor, indices: torch.Tensor,
                         owned: torch.Tensor, scales: torch.Tensor,
                         weights: Optional[torch.Tensor] = None,
                         out_dtype=torch.float32) -> torch.Tensor:
    """Quantized masked partial SLS in fixed l-order: int8 codes, per-entry
    dequant scales (the page scale gathered per pooling entry)."""
    return _fixed_order_masked_sls(table_q, indices, owned, weights, scales,
                                   out_dtype)


def masked_sls_dedup_ref(table: torch.Tensor, unique_rows: torch.Tensor,
                         slots: torch.Tensor, owned: torch.Tensor,
                         weights: Optional[torch.Tensor] = None,
                         unique_scales: Optional[torch.Tensor] = None,
                         out_dtype=torch.float32) -> torch.Tensor:
    """Gather-once masked partial SLS (staging semantics) -- the plain
    version of the ``masked_sls_dedup`` kernel.

    unique_rows (U,) row per staging slot (sentinel-padded, clamped into
    range at the gather); slots (B, L) staging slot per entry; optional
    unique_scales (U,) per-slot dequant scales.  Each unique row is
    gathered and dequantized once into a (U, D) staging buffer, then the
    fixed l-order accumulate reads it through ``slots``.  Given per-entry
    ``scales[b,l] == unique_scales[slots[b,l]]`` the operands equal the
    per-entry gather's, so this equals :func:`_fixed_order_masked_sls`
    bitwise."""
    V = table.shape[0]
    staging = table[unique_rows.long().clamp(max=V - 1)].to(out_dtype)
    if unique_scales is not None:
        staging = staging * unique_scales[:, None].to(out_dtype)
    f = owned.to(out_dtype)
    if weights is not None:
        f = f * weights.to(out_dtype)
    return _fixed_order_accumulate(staging[slots.long()], f)


def sls_table_grad(grad_out: torch.Tensor, indices: torch.Tensor,
                   owned: Optional[torch.Tensor],
                   weights: Optional[torch.Tensor], n_rows: int
                   ) -> torch.Tensor:
    """The table's gradient of a masked SLS (any of the plain versions
    above): ``grad[r] = sum over owned entries (b, l) naming row r of
    w[b,l] * grad_out[b]`` -> (n_rows, D) float32, dense as the
    reference's transpose of its gather is.

    The sum is PyTorch's gradient of an embedding gather
    (``embedding_dense_backward``): it sorts the entries by row and sums
    each row's in a fixed order, in parallel over a row's duplicates, so
    a run repeats bit for bit on the CPU and the card and a zipfian hot
    row does not serialize.  A masked entry names a padding row past the
    table, which that function skips."""
    N, L = indices.shape
    D = grad_out.shape[-1]
    contrib = grad_out[:, None, :].expand(N, L, D)
    if weights is not None:
        contrib = contrib * weights[..., None]
    rows = indices.long()
    if owned is not None:
        rows = torch.where(owned, rows, n_rows)
    grad = torch.ops.aten.embedding_dense_backward(
        contrib.reshape(N * L, D), rows.reshape(-1), n_rows + 1, n_rows,
        False)
    return grad[:n_rows]


def dot_interaction_grad(grad_out: torch.Tensor, feats: torch.Tensor,
                         self_interaction: bool = False) -> torch.Tensor:
    """The features' gradient of :func:`dot_interaction_ref`: the pair
    gradients scattered into a (B, F, F) matrix G (the diagonal too with
    ``self_interaction``), then ``(G + G^T) @ feats``."""
    B, F, D = feats.shape
    ij = torch.tril_indices(F, F, offset=0 if self_interaction else -1,
                            device=feats.device)
    G = torch.zeros((B, F, F), dtype=feats.dtype, device=feats.device)
    G[:, ij[0], ij[1]] = grad_out
    return torch.bmm(G + G.transpose(1, 2), feats)


def dot_interaction_ref(feats: torch.Tensor, self_interaction: bool = False
                        ) -> torch.Tensor:
    """DLRM pairwise-dot interaction: (B, F, D) -> (B, P) packed lower
    triangle of feats @ feats^T, P = F*(F-1)/2 (+F if self_interaction)."""
    B, F, D = feats.shape
    z = torch.bmm(feats, feats.transpose(1, 2))
    ij = torch.tril_indices(F, F, offset=0 if self_interaction else -1,
                            device=feats.device)
    return z[:, ij[0], ij[1]]


def fused_front_end_ref(cold: torch.Tensor, hot: torch.Tensor,
                        x: torch.Tensor, rows: torch.Tensor,
                        owned: torch.Tensor, is_hot: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        scales: Optional[torch.Tensor] = None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """Fused DLRM front end: two-tier masked SLS -> features -> interaction.

    Exactly the split pipeline: each tier's partial SLS in fixed l-order,
    ``pooled = cold_partial + hot_partial`` (the split path's operand
    order), ``x`` stacked as feature row 0, then :func:`dot_interaction_ref`.
    Returns the (B, P) packed lower triangle, P = F*(F-1)/2, F = G + 1."""
    B, G, L = rows.shape
    D = cold.shape[-1]
    flat = rows.reshape(B * G, L)
    w = None if weights is None else weights.reshape(B * G, L)
    cold_p = _fixed_order_masked_sls(
        cold, flat, owned.reshape(B * G, L), w,
        None if scales is None else scales.reshape(B * G, L), out_dtype)
    hot_p = _fixed_order_masked_sls(
        hot, flat, is_hot.reshape(B * G, L), w, None, out_dtype)
    pooled = (cold_p + hot_p).reshape(B, G, D)
    feats = torch.cat([x[:, None, :].to(out_dtype), pooled], dim=1)
    return dot_interaction_ref(feats)


def fused_front_end_dedup_ref(cold: torch.Tensor, hot: torch.Tensor,
                              x: torch.Tensor, c_unique: torch.Tensor,
                              c_slots: torch.Tensor, h_unique: torch.Tensor,
                              h_slots: torch.Tensor, owned: torch.Tensor,
                              is_hot: torch.Tensor,
                              weights: Optional[torch.Tensor] = None,
                              c_scales: Optional[torch.Tensor] = None,
                              out_dtype=torch.float32) -> torch.Tensor:
    """Gather-once fused front end -- the plain version of the
    ``fused_front_end_dedup`` kernel: each tier's staging
    (:func:`masked_sls_dedup_ref`, cold with scales, hot without), then
    ``cold + hot``, ``x`` as feature row 0 and :func:`dot_interaction_ref`,
    as :func:`fused_front_end_ref` composes them.  Slots are (B, G, L)."""
    B, G, L = c_slots.shape
    D = cold.shape[-1]
    nb = B * G
    w = None if weights is None else weights.reshape(nb, L)
    cold_p = masked_sls_dedup_ref(cold, c_unique, c_slots.reshape(nb, L),
                                  owned.reshape(nb, L), w, c_scales,
                                  out_dtype)
    hot_p = masked_sls_dedup_ref(hot, h_unique, h_slots.reshape(nb, L),
                                 is_hot.reshape(nb, L), w, None, out_dtype)
    pooled = (cold_p + hot_p).reshape(B, G, D)
    feats = torch.cat([x[:, None, :].to(out_dtype), pooled], dim=1)
    return dot_interaction_ref(feats)


def shard_sum(parts: torch.Tensor) -> torch.Tensor:
    """Sum per-shard partials (S, ...) in shard order, ((p0 + p1) + p2) +
    ..., one rounding per add: the order of the reference's psum over the
    tp axis, and of the kernels that fold it (``fused_resume``)."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def fused_partial_pool_ref(cold: torch.Tensor, hot: torch.Tensor,
                           x: torch.Tensor, rows: torch.Tensor,
                           owned: torch.Tensor, is_hot: torch.Tensor,
                           weights: Optional[torch.Tensor] = None,
                           scales: Optional[torch.Tensor] = None,
                           out_dtype=torch.float32):
    """Phases 1-2 of :func:`fused_front_end_ref`, stopped before the
    interaction -- the plain version of the ``fused_partial_pool`` kernel.

    Returns the per-tier (B, F, D) partial feature tiles: ``part_c``, the
    cold-tier pools with an all-zero feature row 0 (the tile that is
    summed across shards: x must not be counted once per shard), and
    ``part_h``, the hot-tier pools with ``x`` in row 0 (the hot tier is
    replicated and pooled once).

    ``owned`` (B, G, L) pools one shard.  ``owned`` (S, B, G, L) pools S
    shards whose cold tiers are the S equal slices of ``cold`` (``rows``
    are local to a slice) and returns ``part_c`` (S, B, F, D)."""
    B, G, L = rows.shape
    D = cold.shape[-1]
    nb = B * G
    flat = rows.reshape(nb, L)
    w = None if weights is None else weights.reshape(nb, L)
    sc = None if scales is None else scales.reshape(nb, L)

    def cold_pool(table, own):
        return _fixed_order_masked_sls(table, flat, own.reshape(nb, L), w,
                                       sc, out_dtype).reshape(B, G, D)

    if owned.dim() == 4:
        S = owned.shape[0]
        R = cold.shape[0] // S
        cold_p = torch.stack([cold_pool(cold[s * R:(s + 1) * R], owned[s])
                              for s in range(S)])
    else:
        cold_p = cold_pool(cold, owned)
    hot_p = _fixed_order_masked_sls(hot, flat, is_hot.reshape(nb, L), w,
                                    None, out_dtype).reshape(B, G, D)
    return _tiles(cold_p, hot_p, x, out_dtype)


def _tiles(cold_p: torch.Tensor, hot_p: torch.Tensor, x: torch.Tensor,
           out_dtype):
    """(..., B, G, D) cold and (B, G, D) hot pools -> the two (B, F, D)
    tiles: zeros, resp. x, in feature row 0."""
    zero = cold_p.new_zeros(cold_p.shape[:-2] + (1, cold_p.shape[-1]))
    return (torch.cat([zero, cold_p], dim=-2),
            torch.cat([x[:, None, :].to(out_dtype), hot_p], dim=1))


def fused_partial_pool_dedup_ref(cold: torch.Tensor, hot: torch.Tensor,
                                 x: torch.Tensor, c_unique: torch.Tensor,
                                 c_slots: torch.Tensor,
                                 h_unique: torch.Tensor,
                                 h_slots: torch.Tensor, owned: torch.Tensor,
                                 is_hot: torch.Tensor,
                                 weights: Optional[torch.Tensor] = None,
                                 c_scales: Optional[torch.Tensor] = None,
                                 out_dtype=torch.float32):
    """Gather-once partial pool -- the plain version of the
    ``fused_partial_pool_dedup`` kernel: each tier's staging
    (:func:`masked_sls_dedup_ref`), then the tiles of
    :func:`fused_partial_pool_ref`.  ``c_slots`` and ``owned`` are
    (B, G, L), or (S, B, G, L) with one cold plan over all S shards'
    slices of ``cold`` (``c_unique`` holds rows of the whole ``cold``)."""
    B, G, L = h_slots.shape
    D = cold.shape[-1]
    nb = B * G
    lead = owned.shape[:-3]
    n = owned.shape[0] if lead else 1
    w = None if weights is None else weights.reshape(nb, L).repeat(n, 1)
    cold_p = masked_sls_dedup_ref(cold, c_unique, c_slots.reshape(n * nb, L),
                                  owned.reshape(n * nb, L), w, c_scales,
                                  out_dtype).reshape(lead + (B, G, D))
    hot_p = masked_sls_dedup_ref(hot, h_unique, h_slots.reshape(nb, L),
                                 is_hot.reshape(nb, L),
                                 None if weights is None
                                 else weights.reshape(nb, L), None,
                                 out_dtype).reshape(B, G, D)
    return _tiles(cold_p, hot_p, x, out_dtype)


def fused_resume_ref(part_c: torch.Tensor, part_h: torch.Tensor
                     ) -> torch.Tensor:
    """Phase 3 on the partial tiles -- the plain version of the
    ``fused_resume`` kernel: ``part_c`` (B, F, D), or (S, B, F, D) summed
    in shard order (:func:`shard_sum`), plus ``part_h`` (the split path's
    ``cold + hot`` operand order), then :func:`dot_interaction_ref`."""
    if part_c.dim() == 4:
        part_c = shard_sum(part_c)
    return dot_interaction_ref(part_c + part_h)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """float32 ``fma(a, b, c)``: ``a * b + c`` rounded once, on any device,
    for float32 operands whose product ``a * b`` is exact in float64 (an
    int8 code times a float32 scale: 8 + 24 significant bits).

    The float64 sum ``p + c`` is one rounding of the exact sum; rounding
    it again to float32 is wrong only where it lands exactly on a float32
    halfway point that the exact sum is not.  So the sum is first rounded
    to odd (Boldo and Melquiond): its error term (TwoSum, exact in
    float64) says whether the sum was inexact, and an inexact sum with an
    even last bit moves one float64 ulp toward the exact value.  A sum
    rounded to odd in 53 bits rounds correctly to 24, so the result is the
    fma's, bit for bit.  Round-to-odd needs one correction where a TwoSum
    splice would need a second float32 rounding of the error, so it is the
    one chosen."""
    p = a.double() * b.double()              # exact
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)         # s + err == p + cd exactly
    bits = s.view(torch.int64)
    odd = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)   # toward the exact sum
    return torch.where(odd, bits + step, bits).view(torch.float64).float()


def apply_deltas_ref(cold: torch.Tensor, hot: torch.Tensor,
                     page_scales: torch.Tensor, page_to_shard: torch.Tensor,
                     page_to_slot: torch.Tensor, rows: torch.Tensor,
                     deltas: torch.Tensor, page_size: int,
                     rows_per_shard: int) -> None:
    """Fold unique-row deltas into both tiers in place -- the plain version
    of the ``apply_deltas`` kernel, equal to the reference's update
    (``repro/core/pifs.py:_build_update_plan``) bit for bit.

    A negative row is a pad and writes nothing.  A hot page's row and an
    fp32 cold row add the delta; an int8 cold row takes
    ``clamp(round(fma(q, scale, delta) / scale), -127, 127)`` under its
    page's carried scale (:func:`fma_f32`: the reference's XLA contracts
    the dequantize-add into one fma), or keeps its codes where the scale
    is not positive.  For finite deltas."""
    keep = torch.nonzero(rows >= 0)[:, 0]
    r = rows[keep].long()
    d = deltas[keep]
    page = r // page_size
    shard = page_to_shard[page].long()
    local = page_to_slot[page].long() * page_size + r % page_size
    is_hot = shard == -1                       # paging.HOT_SHARD
    h = torch.nonzero(is_hot)[:, 0]
    c = torch.nonzero(~is_hot)[:, 0]
    hot[local[h]] = hot[local[h]] + d[h]
    pos = shard[c] * rows_per_shard + local[c]
    if cold.dtype == torch.int8:
        q = cold[pos]
        s = page_scales[page[c]][:, None]
        v = fma_f32(q.float(), s.expand_as(d[c]), d[c])
        safe = torch.where(s > 0, s, torch.ones_like(s))
        q_new = torch.round(v / safe).clamp(-127, 127).to(torch.int8)
        cold[pos] = torch.where(s > 0, q_new, q)
    else:
        cold[pos] = cold[pos] + d[c]


_CHECKSUM_BLOCK = 4096   # pages per step of page_checksums_ref


def page_checksums_ref(cold: torch.Tensor, hot: torch.Tensor,
                       page_scales: torch.Tensor,
                       page_to_shard: torch.Tensor,
                       page_to_slot: torch.Tensor, pages: torch.Tensor,
                       page_size: int, rows_per_shard: int) -> torch.Tensor:
    """Per-page Fletcher pairs -- the plain version of the
    ``page_checksums`` kernel, equal to the reference's
    (``repro/core/pifs.py:page_checksums``) and to
    ``core/integrity.page_checksum_host`` bit for bit.

    ``pages`` (K,) global page ids, -1 for a pad (zeros); an id past the
    end reads the last page, as the reference's gather clamps it.  Each
    page's ``N = page_size * D`` lanes (its rows in its current tier,
    int8 codes as uint8, float32 values as their bits) and its scale bits
    ``sc`` give ``s1 = sum lane + sc`` and ``s2 = sum lane * (i + 1) + sc
    * (N + 1)``, mod 2^32.  torch's uint32 has few operations, so the sums
    are taken in int64 and masked: every product stays below 2^45 at 4 KiB
    pages, and int64 wraps mod 2^64, a multiple of 2^32, so the low 32 bits
    are exact anyway.  Pages go ``_CHECKSUM_BLOCK`` at a time, bounding
    the int64 lanes held at once.  Returns (K, 2) int64 in [0, 2^32)."""
    dev = cold.device
    mask = 0xFFFFFFFF
    n = page_size * cold.shape[1]
    out = torch.zeros((pages.shape[0], 2), dtype=torch.int64, device=dev)
    keep = torch.nonzero(pages >= 0)[:, 0]
    w = torch.arange(1, n + 1, dtype=torch.int64, device=dev)
    off = torch.arange(page_size, device=dev)

    def lanes(rows: torch.Tensor) -> torch.Tensor:
        if rows.dtype == torch.int8:
            return rows.view(torch.uint8).long().reshape(-1, n)
        return rows.view(torch.int32).long().reshape(-1, n) & mask

    for i in range(0, keep.numel(), _CHECKSUM_BLOCK):
        k = keep[i:i + _CHECKSUM_BLOCK]
        pg = pages[k].long().clamp(max=page_to_shard.shape[0] - 1)
        shard = page_to_shard[pg].long()
        rows = page_to_slot[pg].long()[:, None] * page_size + off
        h = torch.nonzero(shard == -1)[:, 0]         # paging.HOT_SHARD
        c = torch.nonzero(shard != -1)[:, 0]
        lane = torch.empty((k.numel(), n), dtype=torch.int64, device=dev)
        lane[h] = lanes(hot[rows[h]])
        lane[c] = lanes(cold[shard[c, None] * rows_per_shard + rows[c]])
        sc = page_scales[pg].view(torch.int32).long() & mask
        out[k, 0] = (lane.sum(1) + sc) & mask
        out[k, 1] = ((lane * w).sum(1) + sc * (n + 1)) & mask
    return out
