"""Serving metrics core: tail-latency histograms, queue/occupancy/QPS/SLO.

A numpy copy of ``repro.serving.metrics``, with the same ``summary()``
keys.  Latencies are kept both raw (exact percentiles) and as a log-spaced
histogram (the export format that survives aggregation across runs).
Percentiles reported: p50 / p90 / p99 / p99.9.  The staleness recorder
is fed by the streaming updater (``serving/updates.py``), the failure
recorder by the runtime's retry policy and the scrub recorders by the
scrubber (``serving/scrub.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving.batcher import Bucket
from repro_torch.serving.request import Request

PERCENTILES = (50.0, 90.0, 99.0, 99.9)


class LatencyHistogram:
    """Log-spaced latency histogram (lo_ms..hi_ms) + raw samples."""

    def __init__(self, lo_ms: float = 1e-3, hi_ms: float = 6e4,
                 n_bins: int = 128):
        self.edges_ms = np.logspace(np.log10(lo_ms), np.log10(hi_ms),
                                    n_bins + 1)
        self.counts = np.zeros(n_bins, dtype=np.int64)
        self._raw_ms: List[float] = []
        self.nonfinite = 0

    def record(self, seconds: float) -> None:
        if not np.isfinite(seconds):
            # NaN/Inf samples (a request that never started, a poisoned
            # clock) must not poison the percentiles — count, don't record
            self.nonfinite += 1
            return
        ms = seconds * 1e3
        self._raw_ms.append(ms)
        b = int(np.searchsorted(self.edges_ms, ms, side="right") - 1)
        self.counts[max(0, min(b, len(self.counts) - 1))] += 1

    def __len__(self) -> int:
        return len(self._raw_ms)

    def percentiles_ms(self) -> Dict[str, float]:
        if not self._raw_ms:
            return {f"p{str(q).rstrip('0').rstrip('.')}_ms": float("nan")
                    for q in PERCENTILES}
        raw = np.asarray(self._raw_ms)
        out = {}
        for q in PERCENTILES:
            label = f"p{str(q).rstrip('0').rstrip('.')}_ms"
            out[label] = float(np.percentile(raw, q))
        out["mean_ms"] = float(raw.mean())
        out["max_ms"] = float(raw.max())
        return out

    def export(self) -> Dict[str, list]:
        """Histogram-only export (aggregatable; no raw samples): per
        non-empty bin, its [lo, hi) edges and count — bins need not be
        contiguous, so each carries both edges."""
        nz = np.nonzero(self.counts)[0]
        return {"bin_lo_ms": [float(self.edges_ms[i]) for i in nz],
                "bin_hi_ms": [float(self.edges_ms[i + 1]) for i in nz],
                "counts": [int(self.counts[i]) for i in nz]}


@dataclasses.dataclass
class BatchRecord:
    t: float
    bucket: Bucket
    n_real: int
    service_s: float
    queue_depth: int        # depth *after* popping this batch

    @property
    def occupancy(self) -> float:
        return self.n_real / self.bucket.batch


class ServingMetrics:
    """Aggregates everything the serving runtime observes."""

    def __init__(self):
        self.latency = LatencyHistogram()
        self.queue_wait = LatencyHistogram()
        self.batches: List[BatchRecord] = []
        self.served = 0
        self.slo_violations = 0
        self.dropped = 0
        self.failed = 0            # retry budget exhausted / breaker open
        self.failed_fast = 0       # subset of failed: rejected by open breaker
        self.retries = 0           # extra run_batch attempts that succeeded
                                   # a request (set by the runtime)
        self.maintenance_s: Dict[str, float] = {}
        self.maintenance_calls: Dict[str, int] = {}
        self.first_arrival_s: Optional[float] = None
        self.last_finish_s: float = 0.0
        # streaming-update staleness samples, one per micro-batch boundary
        # (recorded by the updater *before* it drains): how far serving
        # lags the trainer's delta stream
        self.staleness_rows: List[float] = []
        self.staleness_s: List[float] = []
        # integrity-scrub counters (recorded by the ScrubController on the
        # maintenance seam): audit coverage, detections, per-page repair
        # MTTR samples
        self.scrub_cycles = 0
        self.scrub_pages_audited = 0
        self.scrub_pages_detected = 0
        self.scrub_pages_repaired = 0
        self.scrub_repair_s: List[float] = []

    # ------------------------------------------------------------ recording
    def record_request(self, req: Request) -> None:
        self.served += 1
        self.latency.record(req.latency_s)
        self.queue_wait.record(req.queued_s)
        if not req.slo_ok:
            self.slo_violations += 1
        if self.first_arrival_s is None or req.arrival_s < self.first_arrival_s:
            self.first_arrival_s = req.arrival_s
        self.last_finish_s = max(self.last_finish_s, req.finish_s)

    def record_batch(self, t: float, bucket: Bucket, n_real: int,
                     service_s: float, queue_depth: int) -> None:
        self.batches.append(BatchRecord(t, bucket, n_real, service_s,
                                        queue_depth))

    def record_drop(self, req: Request) -> None:
        self.dropped += 1

    def record_failure(self, req: Request, fast: bool = False) -> None:
        """A request whose retry budget was exhausted (or that an open
        circuit breaker failed fast).  Counted exactly once: failed
        requests never pass through ``record_request``, they contribute
        one SLO violation here, and availability/goodput treat them as
        unserved."""
        self.failed += 1
        if fast:
            self.failed_fast += 1
        self.slo_violations += 1
        if self.first_arrival_s is None or req.arrival_s < self.first_arrival_s:
            self.first_arrival_s = req.arrival_s
        if np.isfinite(req.finish_s):
            self.last_finish_s = max(self.last_finish_s, req.finish_s)

    def record_maintenance(self, kind: str, seconds: float) -> None:
        self.maintenance_s[kind] = self.maintenance_s.get(kind, 0.0) + seconds
        self.maintenance_calls[kind] = self.maintenance_calls.get(kind, 0) + 1

    def record_staleness(self, rows_behind: float, seconds_behind: float
                         ) -> None:
        """One update-lag sample: rows generated-but-unapplied at a
        micro-batch boundary, and the age of the oldest pending batch."""
        self.staleness_rows.append(float(rows_behind))
        self.staleness_s.append(float(seconds_behind))

    def record_scrub(self, pages: int) -> None:
        """One scrub cycle audited ``pages`` pages."""
        self.scrub_cycles += 1
        self.scrub_pages_audited += int(pages)

    def record_scrub_detection(self, page: int) -> None:
        """A page's live checksum diverged from the ledger (first
        detection of that page)."""
        self.scrub_pages_detected += 1

    def record_scrub_repair(self, page: int, seconds: float) -> None:
        """One page repaired; ``seconds`` is its repair MTTR (detection
        to verified write-back)."""
        self.scrub_pages_repaired += 1
        self.scrub_repair_s.append(float(seconds))

    # ------------------------------------------------------------- summary
    def summary(self) -> Dict[str, object]:
        # guard the degenerate windows the fault bench hits: an all-shed
        # regime serves nothing (no first arrival, zero duration) and a
        # fail-everything regime can finish at its only arrival instant —
        # every rate below must stay finite (0.0), never divide by zero
        makespan = self.last_finish_s - (self.first_arrival_s or 0.0)
        if not np.isfinite(makespan) or makespan <= 0.0:
            makespan = float("nan")
        completed = self.served + self.failed     # everything not shed
        good = completed - self.slo_violations    # served inside SLO
        occ = [b.occupancy for b in self.batches]
        depth = [b.queue_depth for b in self.batches]
        bucket_mix: Dict[str, int] = {}
        for b in self.batches:
            k = f"{b.bucket.batch}x{b.bucket.pooling}"
            bucket_mix[k] = bucket_mix.get(k, 0) + 1
        out: Dict[str, object] = {
            "served": self.served,
            "dropped": self.dropped,
            "failed": self.failed,
            "failed_fast": self.failed_fast,
            "retries": self.retries,
            "batches": len(self.batches),
            "qps": self.served / makespan if makespan == makespan else 0.0,
            "goodput_qps": (good / makespan if makespan == makespan else 0.0),
            "availability": (self.served / completed if completed else 1.0),
            "slo_violation_rate": (self.slo_violations / completed
                                   if completed else 0.0),
            "batch_occupancy_mean": float(np.mean(occ)) if occ else 0.0,
            "queue_depth_mean": float(np.mean(depth)) if depth else 0.0,
            "queue_depth_max": int(np.max(depth)) if depth else 0,
            "bucket_mix": bucket_mix,
            "maintenance_s": {k: round(v, 6)
                              for k, v in self.maintenance_s.items()},
            "maintenance_calls": dict(self.maintenance_calls),
        }
        out.update(self.latency.percentiles_ms())
        qw = self.queue_wait.percentiles_ms()
        out["queue_wait_p50_ms"] = qw["p50_ms"]
        out["queue_wait_p99_ms"] = qw["p99_ms"]
        # present only when an update stream ran: runs without one keep
        # the exact legacy summary shape
        if self.staleness_rows:
            rows = np.asarray(self.staleness_rows)
            secs = np.asarray(self.staleness_s)
            out["staleness"] = {
                "samples": int(rows.size),
                "rows_behind_p50": float(np.percentile(rows, 50.0)),
                "rows_behind_p99": float(np.percentile(rows, 99.0)),
                "rows_behind_max": float(rows.max()),
                "seconds_behind_p50": float(np.percentile(secs, 50.0)),
                "seconds_behind_p99": float(np.percentile(secs, 99.0)),
                "seconds_behind_max": float(secs.max()),
            }
        # present only when a scrub controller ran: runs without one keep
        # the exact legacy summary shape
        if self.scrub_cycles:
            scrub: Dict[str, object] = {
                "cycles": self.scrub_cycles,
                "pages_audited": self.scrub_pages_audited,
                "pages_detected": self.scrub_pages_detected,
                "pages_repaired": self.scrub_pages_repaired,
            }
            if self.scrub_repair_s:
                rep = np.asarray(self.scrub_repair_s)
                scrub["repair_mttr_mean_s"] = float(rep.mean())
                scrub["repair_mttr_max_s"] = float(rep.max())
            out["scrub"] = scrub
        out["latency_hist"] = self.latency.export()
        return out
