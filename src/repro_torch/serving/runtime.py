"""The serving runtime: a discrete-event loop over arrivals, the bounded
admission queue, the deadline-aware batcher, and the engine executor.

The port of ``repro.serving.runtime``.

Time model
----------
Arrivals live on a *virtual* clock (seconds, from the arrival process or a
closed-loop source); service times come from wherever the executor gets
them -- :class:`BindingExecutor` measures the wall time of
``ServeBinding.execute`` (which returns only after the card is done),
:class:`SimulatedExecutor` evaluates a deterministic service model.
Queueing delay (the quantity that separates batching policies) is exact
virtual time either way.

Maintenance folding
-------------------
``observe`` (access-histogram update) and periodic ``plan_and_migrate``
(hot-page re-planning, paper section IV-B4) run between micro-batches at a
configurable cadence.  Lookups are placement-invariant and migration is a
pure gather, so the event loop does *not* advance the virtual clock for
maintenance (``account_maintenance=True`` charges it to the serving path
instead -- the pessimistic bound).  Wall time spent is always recorded in
metrics.

Streaming updates, scrubbing
----------------------------
An ``updater`` (``serving/updates.StreamingUpdater``) rides the same seam:
after each micro-batch's observe / re-plan it samples staleness and drains
the due delta batches, recorded as maintenance kind ``"updates"``; a
``scrubber`` (``serving/scrub.ScrubController``) then audits the next
window of store pages and repairs what diverged (kind ``"scrub"``).

Faults
------
A ``controller`` (``serving/degradation.DegradationController``) wraps
every executor call: retries with backoff on the virtual clock, the
circuit breaker's fail-fast, the brown-out ladder, a restore after
poisoned batches and, on a persistent per-shard failure, an elastic
re-mesh onto the survivors (``_remesh_recover``, maintenance kind
``"remesh"``).  A ``watchdog`` (``runtime/fault_tolerance.
StragglerWatchdog``) over service times feeds the controller's pressure.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.paging import host
from repro_torch.serving.batcher import Bucket, Flush, ServiceModel, Wait
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.request import AdmissionQueue, Request


# ---------------------------------------------------------------------------
# Load sources: open-loop (pre-scheduled) and closed-loop (completion-driven)
# ---------------------------------------------------------------------------


class OpenLoopSource:
    """Offered-load stream with pre-computed arrival times."""

    def __init__(self, requests: Sequence[Request]):
        self.requests = sorted(requests, key=lambda r: (r.arrival_s, r.rid))

    def initial(self) -> List[Request]:
        return list(self.requests)

    def on_complete(self, req: Request, now: float) -> List[Request]:
        return []


class ClosedLoopSource:
    """N virtual users, each issuing its next request ``think_time_s``
    after the previous one completes (classic closed-loop load)."""

    def __init__(self, n_users: int, n_requests: int,
                 factory: Callable[[int, int, float], Request],
                 think_time_s: float = 0.0):
        self.n_users = n_users
        self.n_requests = n_requests
        self.factory = factory          # (rid, user, arrival_s) -> Request
        self.think_time_s = think_time_s
        self._next_rid = 0

    def _make(self, user: int, arrival_s: float) -> Optional[Request]:
        if self._next_rid >= self.n_requests:
            return None
        rid = self._next_rid
        self._next_rid += 1
        req = self.factory(rid, user, arrival_s)
        req.user = user
        return req

    def initial(self) -> List[Request]:
        out = []
        for u in range(self.n_users):
            r = self._make(u, 0.0)
            if r:
                out.append(r)
        return out

    def on_complete(self, req: Request, now: float) -> List[Request]:
        r = self._make(req.user, now + self.think_time_s)
        return [r] if r else []


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------


class PaddedBatch(dict):
    """A padded host batch (``{name: array}``) that carries the ids of the
    requests in it (``rids``, pad rows excluded), so scores find their
    requests however many batches are padded before it runs (a re-warm
    after a re-mesh pads its own between a batch and its retry)."""
    rids: tuple = ()


class BindingExecutor:
    """Runs micro-batches on a real engine through the ``ServeBinding`` seam
    (``core/pifs.py``), measuring wall time: ``execute`` copies the host
    batch to the card, runs the step and waits for the card.

    Unlike the reference's, it also pads: :meth:`pad` wraps the model
    family's ``padder`` and is the runtime's padder (``ServingRuntime``
    takes it and refuses another), so the executor knows which requests
    each batch carries and keeps each served request's score by ``rid``
    (``scores``).  Given a ``service`` model, :meth:`run_batch` returns
    that model's estimate in place of the measured wall time, so the flush
    sequence is a function of the stream and the model alone and two runs
    (or the two packages) replay it exactly."""

    def __init__(self, binding,
                 padder: Callable[[Sequence[Request], Bucket], dict],
                 service: Optional[ServiceModel] = None):
        self.binding = binding
        self._pad = padder
        self.service = service
        self.scores: Dict[int, np.float32] = {}

    def pad(self, reqs: Sequence[Request], bucket: Bucket) -> PaddedBatch:
        batch = PaddedBatch(self._pad(reqs, bucket))
        batch.rids = tuple(r.rid for r in reqs)
        return batch

    def run_batch(self, bucket: Bucket, batch: Dict[str, np.ndarray]) -> float:
        rids = getattr(batch, "rids", None)
        if rids is None:
            raise TypeError(
                "BindingExecutor.run_batch takes the PaddedBatch its pad() "
                f"returns (a batch that carries its request ids), got "
                f"{type(batch).__name__}")
        t0 = time.perf_counter()
        out = self.binding.execute(batch)
        svc = time.perf_counter() - t0
        self.scores.update(zip(rids, host(out[:len(rids)])))
        return svc if self.service is None else self.service.estimate(bucket)

    def observe(self, batch: Dict[str, np.ndarray]) -> float:
        t0 = time.perf_counter()
        self.binding.observe(batch)
        return time.perf_counter() - t0

    def replan(self) -> float:
        t0 = time.perf_counter()
        self.binding.replan()
        return time.perf_counter() - t0


class SimulatedExecutor:
    """Deterministic executor for replay tests: service time comes from the
    service model, maintenance is free."""

    def __init__(self, service_model: ServiceModel):
        self.service_model = service_model

    def run_batch(self, bucket: Bucket, batch) -> float:
        return self.service_model.estimate(bucket)

    def observe(self, batch) -> float:
        return 0.0

    def replan(self) -> float:
        return 0.0


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    queue_capacity: int = 4096
    observe_every: int = 4        # micro-batches between observe() (0 = off)
    replan_every: int = 64        # micro-batches between replan()  (0 = off)
    account_maintenance: bool = False
    max_batches: int = 10_000_000  # runaway guard for ill-posed tests


class ServingRuntime:
    """Queue + batcher + executor, advanced by a discrete-event loop."""

    def __init__(self, executor, batcher,
                 padder: Optional[Callable[[Sequence[Request], Bucket],
                                           dict]] = None,
                 cfg: RuntimeConfig = RuntimeConfig(),
                 service_model: Optional[ServiceModel] = None,
                 controller=None, updater=None, watchdog=None,
                 warmup_factory=None, scrubber=None):
        # an executor that pads (BindingExecutor) is its own padder: a
        # second padder would leave its scores without their requests
        own = getattr(executor, "pad", None)
        if (own is None) == (padder is None):
            raise ValueError("pass a padder unless the executor pads its "
                             "own batches (BindingExecutor), and only then")
        self.executor = executor
        self.batcher = batcher
        self.padder = own or padder
        self.cfg = cfg
        self.service_model = service_model or ServiceModel()
        self.metrics = ServingMetrics()
        self.n_batches = 0
        # optional serving.degradation.DegradationController: retry /
        # circuit-breaker / brown-out policy around every executor call
        self.controller = controller
        self.failed_batches = 0
        self.updater = updater
        # optional serving.scrub.ScrubController on the maintenance seam
        self.scrubber = scrubber
        # optional runtime.fault_tolerance.StragglerWatchdog over service
        # times: warmup seeds its baseline, each served batch feeds it,
        # and a trip bumps the controller's pressure
        self.watchdog = watchdog
        # dummy-request factory for the re-warm after a re-mesh; warmup()
        # records the one it is given
        self.warmup_factory = warmup_factory
        self.remesh_record: Optional[dict] = None

    # ----------------------------------------------------------- warmup
    def warmup(self, request_factory: Callable[[int, int], Request],
               observe: bool = True) -> Dict[str, float]:
        """Run every bucket signature once before taking load.

        ``request_factory(rid, pooling)`` fabricates a dummy request.  Also
        runs the observe path per bucket and the replan path once, so
        their first-use costs land here, not mid-serving; seeds the service
        model with the *second* measured execution (the first pays every
        first-use cost).  Returns that measurement per bucket (seconds)."""
        times = {}
        self.warmup_factory = request_factory
        for bucket in self.batcher.buckets():
            reqs = [request_factory(i, bucket.pooling)
                    for i in range(bucket.batch)]
            batch = self.padder(reqs, bucket)
            self.executor.run_batch(bucket, batch)          # first use
            svc = self.executor.run_batch(bucket, batch)    # steady measure
            self.service_model.update(bucket, svc)
            if self.watchdog is not None:
                # seed the baseline with healthy steady measures
                self.watchdog.observe(-1, svc)
            if observe and self.cfg.observe_every:
                self.executor.observe(batch)
            times[f"{bucket.batch}x{bucket.pooling}"] = svc
        if self.cfg.replan_every:
            self.executor.replan()
        return times

    # ----------------------------------------------------- fault policy
    def _attempt(self, bucket, batch, now: float):
        """One micro-batch under the controller's retry policy: returns
        ``(service_s, backoff_delay_s)``, ``service_s`` None when the retry
        budget ran out.  Backoff consumes virtual time (it lands in the
        requests' latency, not in the service model)."""
        ctrl = self.controller
        if ctrl is None:
            return self.executor.run_batch(bucket, batch), 0.0
        delay, failures = 0.0, 0
        while True:
            try:
                return self.executor.run_batch(bucket, batch), delay
            except ctrl.retryable as e:
                failures += 1
                ctrl.on_attempt_failure(now + delay, e)
                if failures >= ctrl.retry.max_attempts:
                    return None, delay
                self.metrics.retries += 1
                delay += ctrl.retry.backoff(failures)

    def _remesh_recover(self, now: float) -> float:
        """Elastic recovery on the maintenance seam: re-mesh the binding
        onto the survivors, tell the fault layer the dead shard left,
        re-warm every rebuilt serve-step variant over every bucket and rung
        (the engine's trace counter resets after; signatures counted before
        the swap stay in the binding's carried count), and reset the
        degradation state.  Returns the wall time, recorded as maintenance
        kind ``"remesh"``."""
        ctrl = self.controller
        binding = ctrl.binding
        t0 = time.perf_counter()
        # the survivor mesh's dp must divide every bucket batch
        granule = math.gcd(*(b.batch for b in self.batcher.buckets()))
        event = binding.remesh(lost_shard=ctrl.suspect_shard,
                               batch_granule=granule)
        if hasattr(self.executor, "on_remesh"):
            self.executor.on_remesh(event)
        if self.warmup_factory is not None:
            # through the *inner* executor: fault injection must not
            # advance its schedule (or fire) on warmup traffic
            inner = getattr(self.executor, "inner", self.executor)
            active = binding.active
            for rung in binding.modes():
                binding.set_mode(rung)
                for bucket in self.batcher.buckets():
                    reqs = [self.warmup_factory(i, bucket.pooling)
                            for i in range(bucket.batch)]
                    batch = self.padder(reqs, bucket)
                    inner.run_batch(bucket, batch)
                    if rung == active and self.cfg.observe_every:
                        inner.observe(batch)
            binding.set_mode(active)
            if self.cfg.replan_every:
                inner.replan()
            binding.engine.reset_plan_stats()
        dt = time.perf_counter() - t0
        self.metrics.record_maintenance("remesh", dt)
        ctrl.note_remeshed(now, event)
        self.remesh_record = {**event, "mttr_s": dt,
                              "at_batch": self.n_batches,
                              "t_virtual": round(now, 6)}
        return dt

    def _fail_batch(self, reqs, start: float, finish: float, source, heap,
                    seq, fast: bool) -> None:
        """Mark a whole micro-batch failed (retry-exhausted or breaker
        fail-fast): each request counted once in the SLO metrics, and
        closed-loop users released so load generation goes on."""
        self.failed_batches += 1
        for r in reqs:
            r.start_s = start
            r.finish_s = finish
            r.failed = True
            self.metrics.record_failure(r, fast=fast)
        for r in reqs:
            for nr in source.on_complete(r, finish):
                heapq.heappush(heap, (nr.arrival_s, next(seq), nr))

    # -------------------------------------------------------------- run
    def run(self, source) -> Dict[str, object]:
        cfg = self.cfg
        ctrl = self.controller
        queue = AdmissionQueue(cfg.queue_capacity)
        if ctrl is not None:
            ctrl.bind_queue(queue)
        seq = itertools.count()
        heap: List = []
        for r in source.initial():
            heapq.heappush(heap, (r.arrival_s, next(seq), r))
        now = 0.0

        def admit(limit: float) -> None:
            while heap and heap[0][0] <= limit:
                _, _, r = heapq.heappop(heap)
                if not queue.offer(r):
                    self.metrics.record_drop(r)
                    # a dropped closed-loop request still releases its user
                    for nr in source.on_complete(r, r.arrival_s):
                        heapq.heappush(heap, (nr.arrival_s, next(seq), nr))

        while True:
            admit(now)
            next_arrival = heap[0][0] if heap else None
            decision = self.batcher.decide(now, queue.view(), next_arrival,
                                           self.service_model)
            if decision is None:
                if next_arrival is None:
                    break                                  # fully drained
                now = next_arrival
                continue
            if isinstance(decision, Wait):
                wake = decision.until
                if next_arrival is not None:
                    wake = min(wake, next_arrival)
                now = wake if wake > now else np.nextafter(now, np.inf)
                continue
            assert isinstance(decision, Flush)
            reqs = queue.pop_n(decision.count)
            batch = self.padder(reqs, decision.bucket)
            if ctrl is not None and not ctrl.allow_execute(now):
                # breaker open: fail fast without touching the executor
                self._fail_batch(reqs, now, now, source, heap, seq,
                                 fast=True)
                ctrl.on_batch_done(now, ok=False)
                continue
            svc, delay = self._attempt(decision.bucket, batch, now)
            if svc is None and ctrl is not None and ctrl.wants_remesh:
                # persistent per-shard failure: re-mesh onto the survivors,
                # then serve this same micro-batch on the recovered engine
                dt = self._remesh_recover(now + delay)
                if cfg.account_maintenance:
                    delay += dt
                svc, d2 = self._attempt(decision.bucket, batch, now + delay)
                delay += d2
            if svc is None:                      # retry budget exhausted
                finish = now + delay
                self._fail_batch(reqs, now, finish, source, heap, seq,
                                 fast=False)
                ctrl.on_batch_done(finish, ok=False)
                now = finish
                continue
            self.service_model.update(decision.bucket, svc)
            finish = now + delay + svc
            self.n_batches += 1
            if (self.watchdog is not None
                    and self.watchdog.observe(self.n_batches, svc)
                    and ctrl is not None):
                ctrl.on_straggler(now)
            if cfg.observe_every and self.n_batches % cfg.observe_every == 0:
                dt = self.executor.observe(batch)
                self.metrics.record_maintenance("observe", dt)
                if cfg.account_maintenance:
                    finish += dt
            if cfg.replan_every and self.n_batches % cfg.replan_every == 0:
                dt = self.executor.replan()
                self.metrics.record_maintenance("replan", dt)
                if cfg.account_maintenance:
                    finish += dt
            if self.updater is not None:
                # streaming updates: drain the due delta batches on the
                # maintenance seam; the updater samples staleness into the
                # metrics at every boundary, drained or not
                dt = self.updater.on_batch(finish, self.metrics)
                if dt:
                    self.metrics.record_maintenance("updates", dt)
                    if cfg.account_maintenance:
                        finish += dt
            if self.scrubber is not None:
                # integrity scrub: audit the next page window (and repair
                # any divergence); maintenance time, never in the service
                # estimate
                dt = self.scrubber.on_batch(finish, self.metrics)
                if dt:
                    self.metrics.record_maintenance("scrub", dt)
                    if cfg.account_maintenance:
                        finish += dt
            for r in reqs:
                r.start_s = now
                r.finish_s = finish
                self.metrics.record_request(r)
            self.metrics.record_batch(now, decision.bucket, len(reqs), svc,
                                      len(queue))
            for r in reqs:
                for nr in source.on_complete(r, finish):
                    heapq.heappush(heap, (nr.arrival_s, next(seq), nr))
            now = finish
            if ctrl is not None:
                poisoned = (ctrl.binding.last_poisoned
                            if ctrl.binding is not None else 0)
                ctrl.on_batch_done(finish, ok=True, poisoned=poisoned)
                if ctrl.wants_restore:
                    # a corrupted store: heal between micro-batches
                    # (checkpoint reload and WAL replay, no new signature)
                    t0 = time.perf_counter()
                    ctrl.binding.restore()
                    dt = time.perf_counter() - t0
                    self.metrics.record_maintenance("restore", dt)
                    ctrl.note_restored()
                    if cfg.account_maintenance:
                        now += dt
            if self.n_batches >= cfg.max_batches:
                break

        s = self.metrics.summary()
        s["queue_offered"] = queue.offered
        s["queue_dropped"] = queue.dropped
        # summary()'s depth stats are post-pop snapshots at flush time; the
        # queue itself tracks the true admission-time peak
        s["queue_depth_max"] = queue.peak_depth
        s["failed_batches"] = self.failed_batches
        if ctrl is not None:
            s["degradation"] = ctrl.report()
        if self.watchdog is not None:
            s["watchdog"] = {"trips": len(self.watchdog.events),
                             "ewma_s": self.watchdog.ewma,
                             "events": list(self.watchdog.events)}
        if self.scrubber is not None:
            s["scrub_run"] = self.scrubber.report()
        if self.remesh_record is not None:
            s["remesh"] = dict(self.remesh_record)
        return s
