"""Deadline-aware dynamic micro-batcher over a fixed set of shape buckets.

A numpy copy of ``repro.serving.batcher``.  Serving coalesces queued
requests into a small closed set of ``(batch, pooling)`` buckets and pads
every micro-batch up to its bucket, so the whole serving lifetime touches
exactly ``len(buckets)`` lookup signatures, each warmed once at startup
(the engine's ``plan_stats()["traces"]`` counts a signature first seen
after that).

Padding is exact, not approximate:

  * pooling axis -- a bag with ``L_r < bucket.pooling`` entries repeats its
    first row id with SLS weight 0, so the padded lookup equals the
    unpadded one bit for bit and the access profiler only ever sees ids
    the request actually touched;
  * batch axis -- missing rows replicate request 0 with all-zero weights;
    their scores are discarded by the runtime.

So serve batches only ever carry weights of 0 or 1, which is what makes
the port's lookups bitwise equal to the reference (``ROADMAP.md``,
numerics contract).

The coalescing policy is deterministic (a pure function of the queue view,
the clock, and the service-time model) so decisions can be replay-tested
under a fixed seed:

  flush now  iff  the bucket is full, the stream has drained, or waiting
  any longer would push the head-of-line request past its flush-by time;
  otherwise sleep until the earliest of those times or the next arrival.

The flush-by time is load-adaptive.  The deadline bound
``head.deadline - est_service(bucket) - safety`` always applies; the
eager ``head.arrival + max_wait`` bound applies only while the arrival
rate (estimated from the arrival stamps already in the queue) says
small-batch flushing is sustainable (``rate * est_service(smallest
bucket) / smallest_batch < early_flush_util``).  Without that guard,
marginal load degenerates into permanent minimum-size flushes; with it,
low load gets the short-wait tail, and rising load shifts batches larger
until only the deadline forces a flush.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True, order=True)
class Bucket:
    """One micro-batch signature: padded batch x padded pooling."""
    batch: int
    pooling: int


@dataclasses.dataclass(frozen=True)
class Flush:
    """Serve the first ``count`` queued requests, padded to ``bucket``."""
    bucket: Bucket
    count: int


@dataclasses.dataclass(frozen=True)
class Wait:
    """Idle until ``until`` (the runtime wakes earlier on a new arrival)."""
    until: float


Decision = object  # Flush | Wait | None


class ServiceModel:
    """Per-bucket service-time estimate: EMA over measured executions,
    seeded by the warmup measurement.  The estimate feeds the batcher's
    can-we-afford-to-wait computation."""

    def __init__(self, prior_s: float = 5e-3, alpha: float = 0.25):
        self.prior_s = prior_s
        self.alpha = alpha
        self._est: Dict[Bucket, float] = {}

    def estimate(self, bucket: Bucket) -> float:
        return self._est.get(bucket, self.prior_s)

    def update(self, bucket: Bucket, measured_s: float) -> None:
        old = self._est.get(bucket)
        self._est[bucket] = (measured_s if old is None
                             else old + self.alpha * (measured_s - old))


class FixedServiceModel(ServiceModel):
    """Deterministic affine service model for replay tests and simulation:
    ``base_s + per_row_s * bucket.batch`` — never updated by measurements."""

    def __init__(self, base_s: float = 2e-3, per_row_s: float = 1e-4):
        super().__init__()
        self.base_s = base_s
        self.per_row_s = per_row_s

    def estimate(self, bucket: Bucket) -> float:
        return self.base_s + self.per_row_s * bucket.batch

    def update(self, bucket: Bucket, measured_s: float) -> None:
        pass


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    batch_sizes: Tuple[int, ...] = (8, 16, 32)   # ascending
    poolings: Tuple[int, ...] = (8,)             # ascending pooling levels
    safety_ms: float = 1.0       # slack reserved before the deadline flush
    max_wait_ms: float = 25.0    # eager cap on head-of-line coalescing wait
    # eager max_wait flushing is allowed only while
    # rate * est(smallest bucket) / smallest_batch stays below this
    early_flush_util: float = 0.5

    def __post_init__(self):
        if tuple(sorted(self.batch_sizes)) != self.batch_sizes or \
                not self.batch_sizes:
            raise ValueError("batch_sizes must be non-empty ascending")
        if tuple(sorted(self.poolings)) != self.poolings or not self.poolings:
            raise ValueError("poolings must be non-empty ascending")

    def buckets(self) -> List[Bucket]:
        return [Bucket(b, l) for b in self.batch_sizes for l in self.poolings]


class DynamicBatcher:
    """Deadline-aware coalescing over the bucket set (see module docstring)."""

    def __init__(self, cfg: BatcherConfig):
        self.cfg = cfg

    def buckets(self) -> List[Bucket]:
        return self.cfg.buckets()

    def _pooling_level(self, reqs: Sequence[Request]) -> int:
        need = max(r.pooling for r in reqs)
        for l in self.cfg.poolings:
            if l >= need:
                return l
        raise ValueError(
            f"request pooling {need} exceeds largest bucket pooling "
            f"{self.cfg.poolings[-1]}")

    def _batch_size(self, n: int) -> int:
        for b in self.cfg.batch_sizes:
            if b >= n:
                return b
        return self.cfg.batch_sizes[-1]

    def decide(self, now: float, queued: Sequence[Request],
               next_arrival: Optional[float],
               service: ServiceModel) -> Decision:
        if not queued:
            return None
        b_max = self.cfg.batch_sizes[-1]
        cand = queued[:b_max]
        bucket = Bucket(self._batch_size(len(cand)),
                        self._pooling_level(cand))
        if len(cand) >= b_max:
            return Flush(bucket, b_max)
        head = cand[0]
        flush_by = (head.deadline_s - service.estimate(bucket)
                    - self.cfg.safety_ms * 1e-3)
        b0 = self.cfg.batch_sizes[0]
        window = now - head.arrival_s
        if len(cand) >= 3 and window > 0:
            rate = (len(cand) - 1) / window
            util_small = rate * service.estimate(
                Bucket(b0, bucket.pooling)) / b0
        else:
            util_small = 0.0
        if util_small < self.cfg.early_flush_util:
            flush_by = min(flush_by,
                           head.arrival_s + self.cfg.max_wait_ms * 1e-3)
        if now >= flush_by or next_arrival is None:
            return Flush(bucket, len(cand))
        return Wait(min(flush_by, next_arrival))


class FixedBatcher:
    """The old serve-loop policy as a baseline: always wait for a full
    fixed-size batch (flushing partials only once the stream has drained).
    Same padding/bucket machinery, no deadline awareness."""

    def __init__(self, batch: int, pooling: int):
        self.bucket = Bucket(batch, pooling)

    def buckets(self) -> List[Bucket]:
        return [self.bucket]

    def decide(self, now: float, queued: Sequence[Request],
               next_arrival: Optional[float],
               service: ServiceModel) -> Decision:
        if not queued:
            return None
        if len(queued) >= self.bucket.batch:
            return Flush(self.bucket, self.bucket.batch)
        if next_arrival is not None:
            return Wait(next_arrival)
        return Flush(self.bucket, len(queued))  # end-of-stream drain


# ---------------------------------------------------------------------------
# Padding: requests -> bucket-shaped device-ready batches
# ---------------------------------------------------------------------------


def pad_pooled_indices(reqs: Sequence[Request], bucket: Bucket,
                       key: str = "indices"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack per-request ``(G, L_r)`` index bags into bucket-shaped
    ``indices (B, G, L)`` int32 + ``weights (B, G, L)`` float32.

    Pooling padding repeats each bag's first id at weight 0 (exact under
    SLS; keeps the access profiler unpolluted).  Batch padding replicates
    request 0 at weight 0."""
    B, L = bucket.batch, bucket.pooling
    if len(reqs) > B:
        raise ValueError(f"{len(reqs)} requests exceed bucket batch {B}")
    G = reqs[0].features[key].shape[0]
    idx = np.zeros((B, G, L), dtype=np.int32)
    w = np.zeros((B, G, L), dtype=np.float32)
    for i, r in enumerate(reqs):
        bags = np.asarray(r.features[key])
        if bags.shape[1] > L:
            raise ValueError(
                f"request pooling {bags.shape[1]} > bucket pooling {L}")
        lr = bags.shape[1]
        idx[i, :, :lr] = bags
        idx[i, :, lr:] = bags[:, :1]          # repeat first id, weight 0
        w[i, :, :lr] = 1.0
    for i in range(len(reqs), B):             # batch padding: replicate row 0
        idx[i] = idx[0]
    return idx, w


def stack_feature(reqs: Sequence[Request], bucket: Bucket, key: str,
                  dtype=None) -> np.ndarray:
    """Stack a fixed-shape per-request feature, replicating request 0 into
    padded batch rows."""
    first = np.asarray(reqs[0].features[key])
    out = np.empty((bucket.batch,) + first.shape, dtype=dtype or first.dtype)
    for i in range(bucket.batch):
        out[i] = np.asarray(reqs[i].features[key]) if i < len(reqs) else first
    return out
