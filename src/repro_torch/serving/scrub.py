"""Background integrity scrubbing and page-granular self-healing (a port of
``repro.serving.scrub``).

The :class:`ScrubController` rides the runtime's maintenance seam as the
``StreamingUpdater`` does: after each micro-batch's own maintenance, the
event loop calls :meth:`ScrubController.on_batch` and records the returned
wall seconds as maintenance (never service time).  Each turn audits a
rotating window of K pages against the binding's checksum ledger
(``core/integrity.py``) in one ``page_checksums`` launch -- a full sweep
every ``ceil(num_pages / K)`` turns, no new signature in steady state.

A diverged page is *quarantined* and repaired on its own:

  1. take the ledger's expected checksum (the truth before the damage:
     only legitimate mutations touch the ledger);
  2. read just that page from the last committed snapshot
     (``Checkpointer.read_page``, a memory-mapped slice) and verify it on
     the host against the snapshot-time ledger in the manifest -- a rotted
     snapshot fails loudly here instead of being written into the store;
  3. write it back with the engine's single-page ``write_page``;
  4. replay every WAL record past the snapshot's sequence point, filtered
     to this page's rows, through the live apply path (the same
     ``apply_deltas`` kernel, the same row order);
  5. re-verify: the page's recomputed checksum must equal the expected
     one -- the repaired store is bitwise the never-corrupted one, or the
     repair raises.

Repair assumes the page's tier has not flipped since the snapshot; the
binding fences every int8 tier flip with a snapshot when the ledger is
armed (``ServeBinding.replan``, ``StreamingUpdater.requant_demote``).
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from repro_torch.core.integrity import fetch_snapshot_page, page_checksum_host
from repro_torch.core.paging import HOT_SHARD
from repro_torch.core.updates import PAD_ROW


@dataclasses.dataclass(frozen=True)
class ScrubConfig:
    """``pages_per_cycle``: the rotating audit window K (clamped to the
    store's page count); ``scrub_every``: audit every Nth maintenance
    turn; ``repair``: heal detected pages from snapshot + WAL (False =
    detect and quarantine only)."""
    pages_per_cycle: int = 8
    scrub_every: int = 1
    repair: bool = True


class ScrubController:
    """Audits a ServeBinding's store against its checksum ledger and
    repairs diverged pages one at a time; ``ServingRuntime(scrubber=)``."""

    def __init__(self, binding, cfg: ScrubConfig = ScrubConfig(),
                 controller=None):
        if getattr(binding, "integrity", None) is None:
            raise RuntimeError(
                "ScrubController needs an armed integrity ledger -- call "
                "binding.attach_integrity() first")
        self.binding = binding
        self.cfg = cfg
        self.controller = controller   # DegradationController or None
        n = int(binding.engine.cfg.num_pages)
        self.window = max(1, min(int(cfg.pages_per_cycle), n))
        self.cursor = 0
        self.cycles = 0                # audit turns actually run
        self._mb = 0                   # maintenance turns seen
        self.pages_audited = 0
        self.quarantined: set = set()
        self.detected_cycle: dict = {}   # page -> cycle of first detection
        self.repairs: list = []          # [{page, mttr_s, wal_batches, cycle}]

    # ----------------------------------------------------------- warmup
    def warmup(self) -> None:
        """Serve every signature the scrub and repair paths need before
        steady state: the checksum (an all-pad window reads nothing), the
        page write (page -1 writes nothing) and, with a WAL, the apply
        chunk the replay uses (an all-pad chunk writes nothing).  The state
        stays bitwise the same."""
        binding = self.binding
        eng = binding.engine
        binding.integrity.warmup(binding.state)
        ps, d = eng.cfg.page_size, eng.cfg.dim
        binding.state = eng.write_page(
            binding.state, -1, np.zeros((ps, d), np.int8 if eng.quantized
                                        else np.float32),
            np.zeros((ps, d), np.float32), 1.0)
        if binding.wal is not None:
            cap = binding.update_capacity
            binding.state = eng.apply_deltas(
                binding.state, np.full(cap, PAD_ROW, np.int32),
                np.zeros((cap, d), np.float32), impl=binding.impl)
        binding._sync()

    # ------------------------------------------------------- event hook
    def on_batch(self, now: float, metrics=None) -> float:
        """One maintenance turn: audit the next window of pages and repair
        any divergence.  Returns the wall seconds spent."""
        self._mb += 1
        if self.cfg.scrub_every > 1 and self._mb % self.cfg.scrub_every:
            return 0.0
        t0 = time.perf_counter()
        n = int(self.binding.engine.cfg.num_pages)
        window = (self.cursor + np.arange(self.window)) % n
        self.cursor = int((self.cursor + self.window) % n)
        self.cycles += 1
        self.pages_audited += int(window.size)
        bad = self.binding.integrity.verify(self.binding.state, window)
        if metrics is not None:
            metrics.record_scrub(int(window.size))
        for page in bad:
            self._on_detect(int(page), now, metrics)
        return time.perf_counter() - t0

    def _on_detect(self, page: int, now: float, metrics=None) -> None:
        if page not in self.detected_cycle:
            self.detected_cycle[page] = self.cycles
            if metrics is not None:
                metrics.record_scrub_detection(page)
            if self.controller is not None:
                # evidence of store trouble, softer than a dead shard: the
                # half-weight pressure bump a straggler carries
                self.controller.on_corruption(now)
        self.quarantined.add(page)
        if not (self.cfg.repair and self.binding.checkpointer is not None):
            return
        t0 = time.perf_counter()
        replayed = self._repair(page)
        mttr = time.perf_counter() - t0
        self.quarantined.discard(page)
        self.repairs.append({"page": page, "mttr_s": mttr,
                             "wal_batches": replayed,
                             "cycle": self.cycles})
        if metrics is not None:
            metrics.record_scrub_repair(page, mttr)

    # ------------------------------------------------------------ repair
    def _repair(self, page: int) -> int:
        """Repair one page; returns the WAL batches replayed.  Raises
        rather than degrade: a repair that cannot prove bitwise equality
        with the never-corrupted state must not pass."""
        binding = self.binding
        eng = binding.engine
        ledger = binding.integrity
        # the expected checksum BEFORE any write-back: the replay below
        # goes through binding.apply_deltas, whose ledger hook overwrites
        # this entry with whatever the repair produced
        expected = int(ledger.checksums[page])
        snap = fetch_snapshot_page(binding.checkpointer, eng.cfg, page)
        if snap["checksum"] is not None:
            got = page_checksum_host(snap["rows"], snap["scale"])
            if got != snap["checksum"]:
                raise IOError(
                    f"page {page}: snapshot itself fails its recorded "
                    f"checksum ({got:016x} != {snap['checksum']:016x}) -- "
                    "the snapshot is corrupt, full restore() is the only "
                    "heal path")
        live_hot = int(binding.state.page_to_shard[page]) == HOT_SHARD
        snap_hot = snap["tier"] == "hot"
        if live_hot != snap_hot and eng.quantized:
            raise RuntimeError(
                f"page {page}: tier flipped since the snapshot "
                f"({snap['tier']} -> {'hot' if live_hot else 'cold'}) -- "
                "quantized-domain updates do not replay across a flip. "
                "Mutation paths WAL-fence tier flips with a snapshot "
                "when integrity is armed; a missing fence is a bug.")
        ps, d = eng.cfg.page_size, eng.cfg.dim
        rows = np.asarray(snap["rows"])
        cold_dtype = np.int8 if eng.quantized else np.float32
        # an fp32 page may have flipped tier (the quantized case raised
        # above): hot and cold content share the domain, copy verbatim
        if live_hot:
            cold_rows, hot_rows = np.zeros((ps, d), cold_dtype), rows
        else:
            cold_rows, hot_rows = rows, np.zeros((ps, d), np.float32)
        binding.state = eng.write_page(binding.state, page, cold_rows,
                                       hot_rows, snap["scale"])
        binding._sync()
        # the write-back restored the snapshot content; re-record it so the
        # replay's apply hook starts from a consistent entry
        ledger.note_pages(binding.state, [page])
        replayed = 0
        if binding.wal is not None:
            snap_seq = int(binding.checkpointer.extra().get("update_seq", 0))
            lo, hi = page * ps, (page + 1) * ps
            for seq, wrows, wdeltas in binding.wal.replay():
                if seq <= snap_seq:
                    continue
                wrows = np.asarray(wrows)
                m = (wrows >= lo) & (wrows < hi)
                if not m.any():
                    continue
                binding.apply_deltas(wrows[m], np.asarray(wdeltas)[m],
                                     log=False)
                replayed += 1
        live = int(ledger.compute(binding.state, [page])[0])
        if live != expected:
            raise RuntimeError(
                f"page {page}: repair failed re-verification "
                f"({live:016x} != expected {expected:016x}) -- repaired "
                "content is not bit-identical to the never-corrupted "
                "state")
        ledger.checksums[page] = np.uint64(expected)
        return replayed

    # ----------------------------------------------------------- report
    def report(self) -> dict:
        n = int(self.binding.engine.cfg.num_pages)
        sweep_cycles = int(math.ceil(n / self.window))
        out = {
            "cycles": self.cycles,
            "pages_per_cycle": self.window,
            "pages_audited": self.pages_audited,
            "pages_detected": len(self.detected_cycle),
            "pages_repaired": len(self.repairs),
            "sweep_cycles": sweep_cycles,
            "sweeps_completed": self.cycles // sweep_cycles,
            "coverage": min(1.0, (self.cycles * self.window) / max(n, 1)),
            "quarantined": sorted(self.quarantined),
            "detections": {int(p): int(c)
                           for p, c in self.detected_cycle.items()},
            "repairs": list(self.repairs),
        }
        if self.repairs:
            mttrs = [r["mttr_s"] for r in self.repairs]
            out["repair_mttr_mean_s"] = float(np.mean(mttrs))
            out["repair_mttr_max_s"] = float(np.max(mttrs))
        return out
