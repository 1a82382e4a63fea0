"""Dispatch between the CUDA kernels and their plain versions.

``impl="cuda"`` (the default) sends a CUDA tensor to the hand-written
kernel and a CPU tensor to the kernel's plain version in ``kernels/ref.py``
-- only because it lies on the CPU.  On a CUDA tensor the kernel launches
or raises; nothing falls back.  ``impl="torch"`` asks for the plain
version on any device (the counterpart of the reference's ``impl='jnp'``;
``chip_smoke.py`` uses it to hold the kernels against their plain
versions on the card).

Fake tensors.  A ``FakeTensor`` (``torch._subclasses.fake_tensor``, the
dry-run's stand-in that allocates nothing) with ``impl="cuda"`` takes the
kernel's shape function in ``kernels/fake.py``, whatever device it names:
empty outputs of the kernel's shape and layout.  Only a fake tensor does:
a real CUDA tensor launches or raises, a real CPU tensor takes the plain
version.  Every call, on any route, is one ``build.kernel_call`` event, so
a counter (``launch/op_stats.py``) counts a kernel once, as one opaque op,
whether it launched, ran its plain version or was faked.

Alignment on Hopper.  The reference pads D to the TPU's 128 lanes
(``repro/kernels/ops.py:pad_to_lanes``); nothing here pads.  A Hopper
kernel only wants 16-byte row chunks for vector loads: when D * itemsize
is a multiple of 16 (fp32 D % 4 == 0, int8 D % 16 == 0, which covers the
RMC widths 64 and 128) and the tables are 16-byte aligned (every PyTorch
allocation is), the kernels load 16 bytes per thread; any other D takes
the kernels' scalar path and stays correct.

Gradients.  ``masked_sls``, ``masked_sls_dedup`` and ``dot_interaction``
are ``torch.autograd.Function``s when a float table (or the features)
requires a gradient: the forward is the dispatch above, the backward is
plain PyTorch (``ref.sls_table_grad``, ``ref.dot_interaction_grad``), as
the reference's is XLA's transpose of a gather and of a dot (no Pallas
kernel has a ``custom_vjp``).  They give no gradient for indices, masks,
weights or scales, and refuse weights or scales that ask for one.  The
fused routes have no backward and raise on an input that requires a
gradient: the reference's train step reaches none of them.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import build
from repro_torch.kernels import fake
from repro_torch.kernels import integrity as _integrity
from repro_torch.kernels import interaction as _interaction
from repro_torch.kernels import ref
from repro_torch.kernels import sls as _sls
from repro_torch.kernels import updates as _updates

IMPLS = ("cuda", "torch")
# backward passes run, by function (plain PyTorch, counted as the kernels'
# launches are, so a caller can read how often its path differentiated)
BACKWARDS = {"masked_sls": 0, "masked_sls_dedup": 0, "dot_interaction": 0}


def reset_backwards() -> None:
    for k in BACKWARDS:
        BACKWARDS[k] = 0


def _route(impl: str, t: torch.Tensor) -> str:
    """'kernel' (a real CUDA tensor, impl 'cuda'), 'fake' (a fake tensor,
    impl 'cuda') or 'plain'."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl != "cuda":
        return "plain"
    if isinstance(t, FakeTensor):
        return "fake"
    return "kernel" if t.device.type == "cuda" else "plain"


def _wants_grad(t: Optional[torch.Tensor]) -> bool:
    return t is not None and t.requires_grad and torch.is_grad_enabled()


def _table_grad_only(what: str, *others: Optional[torch.Tensor]) -> None:
    if any(_wants_grad(t) for t in others):
        raise NotImplementedError(
            f"{what} differentiates its table only; weights and scales "
            "take no gradient")


def _no_grad_route(what: str, *tensors: Optional[torch.Tensor]) -> None:
    if any(_wants_grad(t) for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: train through the split front end "
            "(lookup, then dot_interaction), as the reference's train "
            "step does")


def _masked_sls(table, indices, owned, weights, scales, impl):
    with build.kernel_call("masked_sls"):
        route = _route(impl, table)
        if route == "kernel":
            return _sls.masked_sls(table, indices, owned, weights, scales)
        if route == "fake":
            return fake.masked_sls(table, indices, owned, weights, scales)
        return ref._fixed_order_masked_sls(table, indices, owned, weights,
                                           scales)


class _MaskedSLS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, indices, owned, weights, scales, impl):
        ctx.save_for_backward(indices, owned, weights)
        ctx.n_rows = table.shape[0]
        return _masked_sls(table, indices, owned, weights, scales, impl)

    @staticmethod
    def backward(ctx, grad_out):
        indices, owned, weights = ctx.saved_tensors
        BACKWARDS["masked_sls"] += 1
        return (ref.sls_table_grad(grad_out, indices, owned, weights,
                                   ctx.n_rows),
                None, None, None, None, None)


def masked_sls(table: torch.Tensor, indices: torch.Tensor,
               owned: Optional[torch.Tensor] = None,
               weights: Optional[torch.Tensor] = None,
               scales: Optional[torch.Tensor] = None,
               impl: str = "cuda") -> torch.Tensor:
    """Masked partial SLS in fixed l-order: (N, L) -> (N, D) float32.
    ``owned=None`` is plain SLS; ``scales`` dequantize an int8 table.
    Differentiable in a float ``table`` (module docstring)."""
    _sls.check_masked_sls(table, indices, owned, weights, scales)
    _table_grad_only("masked_sls", weights, scales)
    if _wants_grad(table):
        return _MaskedSLS.apply(table, indices, owned, weights, scales, impl)
    return _masked_sls(table, indices, owned, weights, scales, impl)


def sls(table: torch.Tensor, indices: torch.Tensor,
        weights: Optional[torch.Tensor] = None,
        impl: str = "cuda") -> torch.Tensor:
    """Plain SLS, the reference's ``sls`` (its ``sls_pallas``): (N, L)
    bags -> (N, D) float32, ``out[b] = sum_l w[b,l] * table[idx[b,l]]``.
    On the card the masked_sls kernel with no mask; the plain version is
    ``ref.sls_ref``.  No gradient (the reference's train steps reach the
    masked form only)."""
    _sls.check_masked_sls(table, indices, None, weights, None)
    _no_grad_route("sls", table, weights)
    with build.kernel_call("masked_sls"):
        route = _route(impl, table)
        if route == "kernel":
            return _sls.masked_sls(table, indices, None, weights)
        if route == "fake":
            return fake.masked_sls(table, indices, None, weights)
        return ref.sls_ref(table, indices, weights)


def _dot_interaction(feats, self_interaction, impl):
    with build.kernel_call("dot_interaction"):
        route = _route(impl, feats)
        if route == "kernel":
            return _interaction.dot_interaction(feats, self_interaction)
        if route == "fake":
            return fake.dot_interaction(feats, self_interaction)
        return ref.dot_interaction_ref(feats, self_interaction)


class _DotInteraction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, self_interaction, impl):
        ctx.save_for_backward(feats)
        ctx.self_interaction = self_interaction
        return _dot_interaction(feats, self_interaction, impl)

    @staticmethod
    def backward(ctx, grad_out):
        feats, = ctx.saved_tensors
        BACKWARDS["dot_interaction"] += 1
        return (ref.dot_interaction_grad(grad_out, feats,
                                         ctx.self_interaction),
                None, None)


def dot_interaction(feats: torch.Tensor, self_interaction: bool = False,
                    impl: str = "cuda") -> torch.Tensor:
    """DLRM pairwise-dot interaction: (B, F, D) -> (B, P).
    Differentiable in ``feats``."""
    _interaction.check_dot_interaction(feats)
    if _wants_grad(feats):
        return _DotInteraction.apply(feats, self_interaction, impl)
    return _dot_interaction(feats, self_interaction, impl)


def fused_front_end(cold: torch.Tensor, hot: torch.Tensor, x: torch.Tensor,
                    rows: torch.Tensor, owned: torch.Tensor,
                    is_hot: torch.Tensor,
                    weights: Optional[torch.Tensor] = None,
                    scales: Optional[torch.Tensor] = None,
                    impl: str = "cuda") -> torch.Tensor:
    """Fused two-tier masked SLS -> dot interaction: (B, P)."""
    _sls.check_fused_front_end(cold, hot, x, rows, owned, is_hot, weights,
                               scales)
    _no_grad_route("fused_front_end", cold, hot, x, weights)
    args = (cold, hot, x, rows, owned, is_hot, weights, scales)
    with build.kernel_call("fused_front_end"):
        route = _route(impl, cold)
        if route == "kernel":
            return _sls.fused_front_end(*args)
        if route == "fake":
            return fake.fused_front_end(*args)
        return ref.fused_front_end_ref(*args)


def masked_sls_dedup(table: torch.Tensor, plan, owned: torch.Tensor,
                     weights: Optional[torch.Tensor] = None,
                     impl: str = "cuda") -> torch.Tensor:
    """Gather-once masked partial SLS: (N, L) -> (N, D) float32, each owned
    entry's row read through its slot of ``plan`` (a ``core.sls.DedupPlan``
    of the same bags; duplicates of a row share a slot).  Bitwise equal to
    :func:`masked_sls` on the same entries."""
    _sls.check_masked_sls_dedup(table, plan.unique_rows, plan.slots, owned,
                                plan.n_slots, weights, plan.unique_scales)
    _table_grad_only("masked_sls_dedup", weights, plan.unique_scales)
    if _wants_grad(table):
        return _MaskedSLSDedup.apply(table, plan, owned, weights, impl)
    return _masked_sls_dedup(table, plan, owned, weights, impl)


def _masked_sls_dedup(table, plan, owned, weights, impl):
    args = (table, plan.unique_rows, plan.slots, owned, plan.n_slots,
            weights, plan.unique_scales)
    with build.kernel_call("masked_sls_dedup"):
        route = _route(impl, table)
        if route == "kernel":
            return _sls.masked_sls_dedup(*args)
        if route == "fake":
            return fake.masked_sls_dedup(*args)
        return ref.masked_sls_dedup_ref(table, plan.unique_rows, plan.slots,
                                        owned, weights, plan.unique_scales)


class _MaskedSLSDedup(torch.autograd.Function):
    """The gather-once SLS; its backward reaches each entry's row through
    its slot of the plan (the staging gather's clamp included)."""

    @staticmethod
    def forward(ctx, table, plan, owned, weights, impl):
        V = table.shape[0]
        rows = plan.unique_rows.long().clamp(max=V - 1)[plan.slots.long()]
        ctx.save_for_backward(rows, owned, weights)
        ctx.n_rows = V
        return _masked_sls_dedup(table, plan, owned, weights, impl)

    @staticmethod
    def backward(ctx, grad_out):
        rows, owned, weights = ctx.saved_tensors
        BACKWARDS["masked_sls_dedup"] += 1
        return (ref.sls_table_grad(grad_out, rows, owned, weights,
                                   ctx.n_rows),
                None, None, None, None)


def fused_front_end_dedup(cold: torch.Tensor, hot: torch.Tensor,
                          x: torch.Tensor, cold_plan, hot_plan,
                          owned: torch.Tensor, is_hot: torch.Tensor,
                          weights: Optional[torch.Tensor] = None,
                          impl: str = "cuda") -> torch.Tensor:
    """Gather-once fused front end: (B, P), one ``core.sls.DedupPlan`` per
    tier (slots (B, G, L); cold with scales, hot without).  Bitwise equal
    to :func:`fused_front_end` on the same entries."""
    cp, hp = cold_plan, hot_plan
    args = (cold, hot, x, cp.unique_rows, cp.slots, cp.n_slots,
            hp.unique_rows, hp.slots, hp.n_slots, owned, is_hot, weights,
            cp.unique_scales)
    _sls.check_fused_front_end_dedup(*args)
    _no_grad_route("fused_front_end_dedup", cold, hot, x, weights)
    with build.kernel_call("fused_front_end_dedup"):
        route = _route(impl, cold)
        if route == "kernel":
            return _sls.fused_front_end_dedup(*args)
        if route == "fake":
            return fake.fused_front_end_dedup(*args)
        return ref.fused_front_end_dedup_ref(
            cold, hot, x, cp.unique_rows, cp.slots, hp.unique_rows, hp.slots,
            owned, is_hot, weights, cp.unique_scales)


def fused_partial_pool(cold: torch.Tensor, hot: torch.Tensor,
                       x: torch.Tensor, rows: torch.Tensor,
                       owned: torch.Tensor, is_hot: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       scales: Optional[torch.Tensor] = None,
                       impl: str = "cuda"):
    """The fused front end stopped before the interaction: the partial
    feature tiles ``(part_c, part_h)``.  ``owned`` (B, G, L) pools one cold
    shard into ``part_c`` (B, F, D); (S, B, G, L) pools the S equal slices
    of ``cold`` (``rows`` local to a slice) into (S, B, F, D), in one
    launch on the card.  ``part_h`` (B, F, D) holds x and the hot pools."""
    one = owned.dim() == 3
    own4 = owned[None] if one else owned
    _sls.check_fused_partial_pool(cold, hot, x, rows, own4, is_hot, weights,
                                  scales)
    _no_grad_route("fused_partial_pool", cold, hot, x, weights)
    with build.kernel_call("fused_partial_pool"):
        route = _route(impl, cold)
        if route == "plain":
            return ref.fused_partial_pool_ref(cold, hot, x, rows, owned,
                                              is_hot, weights, scales)
        part_c, part_h = (_sls if route == "kernel" else fake) \
            .fused_partial_pool(cold, hot, x, rows, own4, is_hot, weights,
                                scales)
        return (part_c[0] if one else part_c), part_h


def fused_partial_pool_dedup(cold: torch.Tensor, hot: torch.Tensor,
                             x: torch.Tensor, cold_plan, hot_plan,
                             owned: torch.Tensor, is_hot: torch.Tensor,
                             weights: Optional[torch.Tensor] = None,
                             impl: str = "cuda"):
    """Gather-once partial pool: one ``core.sls.DedupPlan`` for the cold
    tier (slots shaped like ``owned``: (B, G, L), or (S, B, G, L) with
    rows of the whole ``cold``) and one for the hot tier (slots
    (B, G, L)).  Bitwise equal to :func:`fused_partial_pool` on the same
    entries."""
    cp, hp = cold_plan, hot_plan
    one = owned.dim() == 3
    own4, cs4 = (owned[None], cp.slots[None]) if one else (owned, cp.slots)
    args = (cold, hot, x, cp.unique_rows, cs4, cp.n_slots, hp.unique_rows,
            hp.slots, hp.n_slots, own4, is_hot, weights, cp.unique_scales)
    _sls.check_fused_partial_pool_dedup(*args)
    _no_grad_route("fused_partial_pool_dedup", cold, hot, x, weights)
    with build.kernel_call("fused_partial_pool_dedup"):
        route = _route(impl, cold)
        if route == "plain":
            return ref.fused_partial_pool_dedup_ref(
                cold, hot, x, cp.unique_rows, cp.slots, hp.unique_rows,
                hp.slots, owned, is_hot, weights, cp.unique_scales)
        part_c, part_h = (_sls if route == "kernel" else fake) \
            .fused_partial_pool_dedup(*args)
        return (part_c[0] if one else part_c), part_h


def fused_resume(part_c: torch.Tensor, part_h: torch.Tensor,
                 impl: str = "cuda") -> torch.Tensor:
    """Phase 3 on the partial tiles: ``part_c`` (B, F, D), or (S, B, F, D)
    summed in shard order, plus ``part_h``, then the interaction ->
    (B, P)."""
    c4 = part_c[None] if part_c.dim() == 3 else part_c
    _interaction.check_fused_resume(c4, part_h)
    _no_grad_route("fused_resume", part_c, part_h)
    with build.kernel_call("fused_resume"):
        route = _route(impl, part_h)
        if route == "kernel":
            return _interaction.fused_resume(c4, part_h)
        if route == "fake":
            return fake.fused_resume(c4, part_h)
        return ref.fused_resume_ref(part_c, part_h)


def apply_deltas(cold: torch.Tensor, hot: torch.Tensor,
                 page_scales: torch.Tensor, page_to_shard: torch.Tensor,
                 page_to_slot: torch.Tensor, rows: torch.Tensor,
                 deltas: torch.Tensor, page_size: int, rows_per_shard: int,
                 impl: str = "cuda") -> None:
    """Fold unique-row deltas (U, D) into the rows ``rows`` (U,) of the
    cold and hot tiers, in place (an int8 cold row in its page's quantized
    domain, through one fma); a negative row is a pad."""
    _updates.check_apply_deltas(cold, hot, page_scales, page_to_shard,
                                page_to_slot, rows, deltas)
    args = (cold, hot, page_scales, page_to_shard, page_to_slot, rows,
            deltas, page_size, rows_per_shard)
    with build.kernel_call("apply_deltas"):
        route = _route(impl, cold)
        if route == "kernel":
            _updates.apply_deltas(*args)
        elif route == "fake":
            fake.apply_deltas(*args)
        else:
            ref.apply_deltas_ref(*args)


def page_checksums(cold: torch.Tensor, hot: torch.Tensor,
                   page_scales: torch.Tensor, page_to_shard: torch.Tensor,
                   page_to_slot: torch.Tensor, pages: torch.Tensor,
                   page_size: int, rows_per_shard: int,
                   impl: str = "cuda") -> torch.Tensor:
    """Per-page Fletcher pairs of the listed pages (K,) -> (K, 2) int64
    ``[s1, s2]`` in [0, 2^32) (``core/integrity.py``); a negative page is
    a pad and gets zeros."""
    _integrity.check_page_checksums(cold, hot, page_scales, page_to_shard,
                                    page_to_slot, pages)
    args = (cold, hot, page_scales, page_to_shard, page_to_slot, pages,
            page_size, rows_per_shard)
    with build.kernel_call("page_checksums"):
        route = _route(impl, cold)
        if route == "kernel":
            return _integrity.page_checksums(*args)
        if route == "fake":
            return fake.page_checksums(*args)
        return ref.page_checksums_ref(*args)
