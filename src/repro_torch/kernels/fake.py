"""Shape functions of the CUDA kernels: the kernels' route for fake tensors.

A dry-run (``launch/dryrun.py``) traces a step on the fake tensors of a
``torch._subclasses.fake_tensor.FakeTensorMode``: nothing is allocated and
no kernel can launch.  ``kernels/ops.py`` sends a fake tensor, and only a
fake tensor, here when ``impl="cuda"``, whatever device it names.  Each
function takes its kernel wrapper's arguments (``kernels/sls.py``,
``interaction.py``, ``updates.py``, ``integrity.py``), checks them with the
wrapper's own input contract, and returns empty outputs of the kernel's
shape, dtype, device and layout -- allocating what the kernel allocates,
so a memory count of the trace sees the kernel's outputs and buffers.
One function per entry of ``build.KERNELS``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import integrity as _integrity
from repro_torch.kernels import interaction as _interaction
from repro_torch.kernels import ref
from repro_torch.kernels import sls as _sls
from repro_torch.kernels import updates as _updates

F32 = torch.float32


def _pairs(F: int, self_interaction: bool = False) -> int:
    return F * (F + 1) // 2 if self_interaction else F * (F - 1) // 2


def masked_sls(table: torch.Tensor, indices: torch.Tensor,
               owned: Optional[torch.Tensor] = None,
               weights: Optional[torch.Tensor] = None,
               scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    _sls.check_masked_sls(table, indices, owned, weights, scales)
    return torch.empty((indices.shape[0], table.shape[1]), dtype=F32,
                       device=table.device)


def masked_sls_dedup(table: torch.Tensor, unique_rows: torch.Tensor,
                     slots: torch.Tensor, owned: torch.Tensor,
                     n_slots: torch.Tensor,
                     weights: Optional[torch.Tensor] = None,
                     unique_scales: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    _sls.check_masked_sls_dedup(table, unique_rows, slots, owned, n_slots,
                                weights, unique_scales)
    return torch.empty((slots.shape[0], table.shape[1]), dtype=F32,
                       device=table.device)


def dot_interaction(feats: torch.Tensor, self_interaction: bool = False
                    ) -> torch.Tensor:
    _interaction.check_dot_interaction(feats)
    B, F, _ = feats.shape
    return torch.empty((B, _pairs(F, self_interaction)), dtype=F32,
                       device=feats.device)


def fused_front_end(cold, hot, x, rows, owned, is_hot, weights=None,
                    scales=None) -> torch.Tensor:
    _sls.check_fused_front_end(cold, hot, x, rows, owned, is_hot, weights,
                               scales)
    B, G, _ = rows.shape
    return torch.empty((B, _pairs(G + 1)), dtype=F32, device=cold.device)


def fused_front_end_dedup(cold, hot, x, c_unique, c_slots, c_n, h_unique,
                          h_slots, h_n, owned, is_hot, weights=None,
                          c_scales=None) -> torch.Tensor:
    _sls.check_fused_front_end_dedup(cold, hot, x, c_unique, c_slots, c_n,
                                     h_unique, h_slots, h_n, owned, is_hot,
                                     weights, c_scales)
    B, G, _ = c_slots.shape
    return torch.empty((B, _pairs(G + 1)), dtype=F32, device=cold.device)


def _tiles(cold, owned, rows):
    S = owned.shape[0]
    B, G, _ = rows.shape
    D = cold.shape[1]
    return (torch.empty((S, B, G + 1, D), dtype=F32, device=cold.device),
            torch.empty((B, G + 1, D), dtype=F32, device=cold.device))


def fused_partial_pool(cold, hot, x, rows, owned, is_hot, weights=None,
                       scales=None):
    _sls.check_fused_partial_pool(cold, hot, x, rows, owned, is_hot,
                                  weights, scales)
    return _tiles(cold, owned, rows)


def fused_partial_pool_dedup(cold, hot, x, c_unique, c_slots, c_n, h_unique,
                             h_slots, h_n, owned, is_hot, weights=None,
                             c_scales=None):
    _sls.check_fused_partial_pool_dedup(cold, hot, x, c_unique, c_slots,
                                        c_n, h_unique, h_slots, h_n, owned,
                                        is_hot, weights, c_scales)
    part_c, part_h = _tiles(cold, owned, h_slots)
    D = cold.shape[1]
    # the kernel's two staging buffers, live for its launch
    torch.empty((c_slots.numel(), D), dtype=F32, device=cold.device)
    torch.empty((h_slots.numel(), D), dtype=F32, device=cold.device)
    return part_c, part_h


def fused_resume(part_c: torch.Tensor, part_h: torch.Tensor
                 ) -> torch.Tensor:
    _interaction.check_fused_resume(part_c, part_h)
    B, F, _ = part_h.shape
    return torch.empty((B, _pairs(F)), dtype=F32, device=part_h.device)


def apply_deltas(cold, hot, page_scales, page_to_shard, page_to_slot, rows,
                 deltas, page_size: int, rows_per_shard: int) -> None:
    """In place on the card: nothing to return, nothing allocated."""
    _updates.check_apply_deltas(cold, hot, page_scales, page_to_shard,
                                page_to_slot, rows, deltas)


def page_checksums(cold, hot, page_scales, page_to_shard, page_to_slot,
                   pages, page_size: int, rows_per_shard: int
                   ) -> torch.Tensor:
    _integrity.check_page_checksums(cold, hot, page_scales, page_to_shard,
                                    page_to_slot, pages)
    return torch.empty((pages.shape[0], 2), dtype=torch.int64,
                       device=cold.device)


# ---------------------------------------------------------------------------
# The kernels beside their shape functions and plain versions, and inputs to
# hold the three against each other (the tests on the CPU, chip_smoke.py on
# the card)
# ---------------------------------------------------------------------------


def wrappers() -> dict:
    """name -> the kernel's wrapper (CUDA tensors only)."""
    return {"masked_sls": _sls.masked_sls,
            "dot_interaction": _interaction.dot_interaction,
            "fused_front_end": _sls.fused_front_end,
            "masked_sls_dedup": _sls.masked_sls_dedup,
            "fused_front_end_dedup": _sls.fused_front_end_dedup,
            "fused_partial_pool": _sls.fused_partial_pool,
            "fused_partial_pool_dedup": _sls.fused_partial_pool_dedup,
            "fused_resume": _interaction.fused_resume,
            "apply_deltas": _updates.apply_deltas,
            "page_checksums": _integrity.page_checksums}


def shape_functions() -> dict:
    """name -> the shape function of this module."""
    return {name: globals()[name] for name in wrappers()}


def plain_versions() -> dict:
    """name -> the plain version, taking the wrapper's arguments."""
    def dedup(table, ur, slots, owned, n, w=None, us=None):
        return ref.masked_sls_dedup_ref(table, ur, slots, owned, w, us)

    def fe_dedup(cold, hot, x, cu, cs, cn, hu, hs, hn, owned, is_hot,
                 w=None, cus=None):
        return ref.fused_front_end_dedup_ref(cold, hot, x, cu, cs, hu, hs,
                                             owned, is_hot, w, cus)

    def pp_dedup(cold, hot, x, cu, cs, cn, hu, hs, hn, owned, is_hot,
                 w=None, cus=None):
        return ref.fused_partial_pool_dedup_ref(cold, hot, x, cu, cs, hu, hs,
                                                owned, is_hot, w, cus)
    return {"masked_sls": ref._fixed_order_masked_sls,
            "dot_interaction": ref.dot_interaction_ref,
            "fused_front_end": ref.fused_front_end_ref,
            "masked_sls_dedup": dedup,
            "fused_front_end_dedup": fe_dedup,
            "fused_partial_pool": ref.fused_partial_pool_ref,
            "fused_partial_pool_dedup": pp_dedup,
            "fused_resume": ref.fused_resume_ref,
            "apply_deltas": ref.apply_deltas_ref,
            "page_checksums": ref.page_checksums_ref}


def kernel_cases(device, gen: torch.Generator, B: int = 8, G: int = 3,
                 L: int = 4, D: int = 16, S: int = 2, rows: int = 256,
                 storage: str = "fp32") -> dict:
    """name -> the wrapper's arguments for each kernel: an engine of G
    tables of ``rows`` rows, ``S`` cold shards and ``storage``, addressed
    by a (B, G, L) batch of ids in range with general weights (the
    engine's own address math and dedup plans)."""
    from repro_torch.core import sls as core_sls
    from repro_torch.core.pifs import engine_for_tables
    eng, _ = engine_for_tables([rows] * G, D, device=device, n_shards=S,
                               storage=storage)
    st = eng.init_state(gen)
    c = eng.cfg
    idx = torch.randint(0, c.total_rows, (B, G, L), generator=gen,
                        device=device, dtype=torch.int32)
    w = torch.rand((B, G, L), generator=gen, device=device)
    local, owned, is_hot, scale = eng._address(st, idx)
    x = torch.randn((B, D), generator=gen, device=device)
    flat, own0 = local.reshape(-1, L), owned[0].reshape(-1, L)
    w2 = w.reshape(-1, L)
    s2 = None if scale is None else scale.reshape(-1, L)
    cp = core_sls.dedup_plan(flat, own0, s2)
    hp = core_sls.dedup_plan(flat, is_hot.reshape(-1, L))
    pcp, php = core_sls.partial_pool_plans(st.cold.shape[0], local, owned,
                                           is_hot, scale)
    hot = st.hot if st.hot.shape[0] else torch.zeros((1, D), device=device)
    F = G + 1
    U = min(B * G, c.total_rows)
    upd_rows = torch.randperm(c.total_rows, generator=gen,
                              device=device)[:U].to(torch.int32)
    pages = torch.arange(c.num_pages, dtype=torch.int32, device=device)
    return {
        "masked_sls": (st.cold, flat, own0, w2, s2),
        "dot_interaction": (torch.randn((B, F, D), generator=gen,
                                        device=device),),
        "fused_front_end": (st.cold, hot, x, local, owned[0], is_hot, w,
                            scale),
        "masked_sls_dedup": (st.cold, cp.unique_rows, cp.slots, own0,
                             cp.n_slots, w2, cp.unique_scales),
        "fused_front_end_dedup": (
            st.cold, hot, x, cp.unique_rows, cp.slots.reshape(B, G, L),
            cp.n_slots, hp.unique_rows, hp.slots.reshape(B, G, L),
            hp.n_slots, owned[0], is_hot, w, cp.unique_scales),
        "fused_partial_pool": (st.cold, hot, x, local, owned, is_hot, w,
                               scale),
        "fused_partial_pool_dedup": (
            st.cold, hot, x, pcp.unique_rows, pcp.slots, pcp.n_slots,
            php.unique_rows, php.slots, php.n_slots, owned, is_hot, w,
            pcp.unique_scales),
        "fused_resume": (torch.randn((S, B, F, D), generator=gen,
                                     device=device),
                         torch.randn((B, F, D), generator=gen,
                                     device=device)),
        "apply_deltas": (st.cold, st.hot, st.page_scales, st.page_to_shard,
                         st.page_to_slot, upd_rows,
                         torch.randn((U, D), generator=gen, device=device),
                         c.page_size, c.rows_per_shard),
        "page_checksums": (st.cold, st.hot, st.page_scales,
                           st.page_to_shard, st.page_to_slot, pages,
                           c.page_size, c.rows_per_shard),
    }
