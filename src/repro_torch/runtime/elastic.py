"""Elastic scaling: re-mesh an engine state onto another shard count (a
port of ``repro.runtime.elastic``).

Checkpoints hold placement-free arrays, so scaling down after losing a
device (or up) is: pick the survivor mesh, rebuild, repack.  The one
constraint is divisibility (tables over tp, batches over dp), which
:func:`validate_mesh_for` checks before committing.

One card holds every shard of the port's engine, so a re-mesh changes the
engine's ``n_shards`` (the reference's tp axis) and nothing else: the page
table maps pages to shard ids, so it re-plans against the new shard count
(a host-side plan and one pack).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.paging import host, initial_page_table
from repro_torch.core.pifs import PIFSEmbeddingEngine
from repro_torch.core.planner import plan


def validate_mesh_for(shape: Sequence[int], names: Sequence[str],
                      divisibility: Dict[str, int]) -> None:
    """``divisibility``: axis name -> value that the axis size must divide
    (e.g. ``{"model": n_pages, "data": global_batch}``)."""
    for name, size in zip(names, shape):
        need = divisibility.get(name)
        if need is not None and need % size != 0:
            raise ValueError(
                f"axis {name}={size} does not divide workload dim {need}")


def remesh_engine(old_engine: PIFSEmbeddingEngine, n_shards: int, state,
                  counts: Optional[np.ndarray] = None
                  ) -> Tuple[PIFSEmbeddingEngine, object]:
    """Re-shard an engine state onto ``n_shards`` cold shards, on the same
    device: export through the placement-free view (``export_state``:
    cold rows as storage-native codes, hot rows as fp32 values, per-page
    scales verbatim), build an engine for the new shard count, re-plan the
    placement from the carried access histogram, and pack
    (``pack_state``).

    Page geometry (``page_size``, ``num_pages``, ``padded_rows``) depends
    on dim, page bytes and storage only, never on ``n_shards``, so an int8
    page's codes and carried scale move bit for bit to wherever the new
    plan puts it: a 4 -> 2 -> 4 round trip is the identity on (codes,
    values, scales).  The engine's serving knobs (dedup default,
    threshold, staging budget, ``validate_ids``, the measured dedup hint,
    the planner) carry over.  The old and new states are live at once
    until the caller drops the old one."""
    codes, values, page_scales = old_engine.export_state(state)
    new_cfg = dataclasses.replace(old_engine.cfg, n_shards=int(n_shards))
    new_engine = PIFSEmbeddingEngine(
        new_cfg, old_engine.device, planner=old_engine.planner,
        dedup=old_engine.default_dedup,
        dedup_auto_threshold=old_engine.dedup_auto_threshold,
        dedup_staging_bytes=old_engine.dedup_staging_bytes,
        validate_ids=old_engine.validate_ids)
    new_engine.dedup_auto_hint = old_engine.dedup_auto_hint
    counts = host(state.counts) if counts is None else np.asarray(counts)
    table, _ = plan(new_cfg, initial_page_table(new_cfg), counts,
                    new_engine.planner)
    new_state = new_engine.pack_state(codes, values, page_scales,
                                      table=table, counts=counts)
    return new_engine, new_state


def scale_plan(n_devices: int, prefer_tp: int = 16, batch_granule: int = 0
               ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Pick a (data, model) mesh for a surviving device count -- the
    re-mesh policy after a partial failure.  Keeps tp at ``prefer_tp``
    when it divides, else the largest power-of-two divisor below it.

    ``batch_granule`` > 0 adds the serving constraint: dp must divide the
    bucket batch granule (the gcd of the batcher's batch sizes).  When the
    full survivor count cannot satisfy it, the plan shrinks the *used*
    device count until it can -- an idle survivor beats a mesh the serve
    step cannot shard over."""
    if batch_granule:
        for n in range(n_devices, 0, -1):
            tp = prefer_tp
            while tp > 1 and n % tp:
                tp //= 2
            if batch_granule % (n // tp) == 0:
                return (n // tp, tp), ("data", "model")
    tp = prefer_tp
    while tp > 1 and n_devices % tp:
        tp //= 2
    return (n_devices // tp, tp), ("data", "model")
