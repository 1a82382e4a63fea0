"""Streaming embedding updates under live traffic (the serving half; a port
of ``repro.serving.updates``).

The trainer side of a recommender emits a continuous stream of
embedding-row deltas; serving folds them into the live tables between
micro-batches, never inside the timed service path, and records the wall
time as a maintenance kind of its own (``"updates"``).

  * **Apply** -- due batches (virtual ``t_gen`` <= now) are coalesced,
    write-ahead-logged and applied in fixed-capacity chunks
    (``ServeBinding.apply_deltas``; no new signature in steady state).
  * **Staleness** -- at every micro-batch boundary, *before* draining, the
    updater samples how far serving lags the stream: ``rows_behind`` and
    ``seconds_behind`` (age of the oldest due batch), p50/p99 in the
    metrics summary.
  * **Requant-demote** -- applied deltas pull hot fp32 rows off their
    carried-scale grid; on a cadence, drifted traffic-cold hot pages move
    back into the cold tier (the engine's migrate), each demote fenced by
    a WAL-truncating snapshot.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.paging import host
from repro_torch.core.updates import (PAD_ROW, DriftTracker, UpdateConfig,
                                      demote_table)


@dataclasses.dataclass(frozen=True)
class UpdateBatch:
    """One trainer-emitted delta batch on the virtual clock."""
    seq: int
    t_gen: float            # virtual generation time (seconds)
    rows: np.ndarray        # (n,) global row ids
    deltas: np.ndarray      # (n, D) float32


class StreamingUpdater:
    """Drains an update stream through a ``ServeBinding`` between
    micro-batches: ``ServingRuntime(updater=...)`` calls :meth:`on_batch`
    after each micro-batch's own maintenance and records the returned wall
    seconds like any other maintenance cost."""

    def __init__(self, binding, batches: Sequence[UpdateBatch],
                 cfg: UpdateConfig = UpdateConfig(), wal=None):
        self.binding = binding
        self.cfg = cfg
        binding.update_capacity = cfg.capacity
        if wal is not None:
            binding.attach_wal(wal)
        self.pending = deque(
            sorted(batches, key=lambda b: (b.t_gen, b.seq)))
        self.generated_batches = len(self.pending)
        self.generated_rows = int(sum(len(b.rows) for b in self.pending))
        self.tracker = DriftTracker(binding.engine.cfg)
        self.applied_batches = 0
        self.applied_rows = 0
        self.demoted_pages = 0
        self.snapshots = 0
        self._mb = 0            # micro-batches seen

    # ----------------------------------------------------------- warmup
    def warmup(self) -> None:
        """Serve the apply signature once before steady state: an all-pad
        batch writes nothing, so the state stays bitwise the same, and the
        (storage, capacity) signature lands before the caller resets the
        plan stats."""
        b = self.binding
        eng = b.engine
        rows = np.full(self.cfg.capacity, PAD_ROW, np.int32)
        deltas = np.zeros((self.cfg.capacity, eng.cfg.dim), np.float32)
        b.state = eng.apply_deltas(b.state, rows, deltas, impl=b.impl)
        b._sync()

    # ------------------------------------------------------- event hook
    def on_batch(self, now: float, metrics=None) -> float:
        """One maintenance turn at virtual time ``now``: sample staleness
        (before the drain: the lag serving exposed), then apply every due
        batch unless ``apply_every`` skips this turn.  Returns the wall
        seconds spent applying (0.0 when nothing was due)."""
        self._mb += 1
        due_rows = 0
        oldest: Optional[float] = None
        for b in self.pending:
            if b.t_gen > now:
                break
            if oldest is None:
                oldest = b.t_gen
            due_rows += len(b.rows)
        if metrics is not None:
            metrics.record_staleness(
                due_rows, (now - oldest) if oldest is not None else 0.0)
        if self.cfg.apply_every > 1 and self._mb % self.cfg.apply_every:
            return 0.0
        if due_rows == 0:
            return 0.0
        t0 = time.perf_counter()
        self._drain_due(now)
        return time.perf_counter() - t0

    def _drain_due(self, now: float) -> None:
        cfg = self.cfg
        while self.pending and self.pending[0].t_gen <= now:
            b = self.pending.popleft()
            n = self.binding.apply_deltas(b.rows, b.deltas)
            self.tracker.update(b.rows, b.deltas)
            self.applied_batches += 1
            self.applied_rows += n
            if cfg.demote_every and \
                    self.applied_batches % cfg.demote_every == 0:
                self.requant_demote()
            if cfg.snapshot_every and \
                    self.applied_batches % cfg.snapshot_every == 0:
                self.binding.snapshot()
                self.snapshots += 1

    def drain(self) -> int:
        """Apply everything still pending (end-of-run flush; not timed).
        Returns the number of batches applied."""
        n = len(self.pending)
        self._drain_due(float("inf"))
        return n

    # -------------------------------------------------- requant-demote
    def requant_demote(self) -> int:
        """One demote scan: drifted, traffic-cold hot pages (the tracker's
        drift against the access histogram) migrate into the cold tier
        (int8: re-quantized with each page's carried scale); counts are
        not decayed.  Returns the pages demoted.

        Demotions are not WAL-representable, so each one is fenced by a
        WAL-truncating snapshot; with a WAL and no checkpointer to
        snapshot into, the scan refuses."""
        binding = self.binding
        if binding.wal is not None and binding.checkpointer is None:
            raise RuntimeError(
                "requant-demote with a WAL attached requires a "
                "checkpointer: demotions are not WAL-representable, so "
                "every demote must fence with a WAL-truncating snapshot "
                "or a later restore's replay diverges from the live run")
        eng = binding.engine
        state = binding.state
        counts = host(state.counts)
        table = state.page_table
        pages = self.tracker.demote_candidates(table, counts, self.cfg)
        if pages.size == 0:
            return 0
        new_table = demote_table(eng.cfg, table, counts, pages)
        binding.state = eng.migrate(state, new_table, count_decay=1.0)
        binding._sync()
        if binding.integrity is not None:
            # demoted pages changed native-domain content (hot fp32 ->
            # re-quantized codes): re-record them
            binding.integrity.note_tier_changes(
                binding.state, host(table.page_to_shard),
                new_table.page_to_shard)
        self.tracker.note_requantized(pages)
        self.demoted_pages += int(pages.size)
        if binding.checkpointer is not None:
            binding.snapshot()
            self.snapshots += 1
        return int(pages.size)

    # ----------------------------------------------------------- report
    def report(self) -> dict:
        out = {
            "generated_batches": self.generated_batches,
            "generated_rows": self.generated_rows,
            "applied_batches": self.applied_batches,
            "applied_rows": self.applied_rows,
            "pending_batches": len(self.pending),
            "demoted_pages": self.demoted_pages,
            "snapshots": self.snapshots,
            "update_seq": self.binding.update_seq,
        }
        if self.binding.wal is not None:
            out["wal_records"] = len(self.binding.wal)
        return out
