"""Graceful degradation for the serving runtime: retry, circuit breaker,
and the hysteresis brown-out ladder (a port of
``repro.serving.degradation``).

Under injected (or real) faults the runtime bends instead of breaking:

  * **Retry with backoff** -- a transient executor failure
    (``serving/faults.TransientServingFailure``) is retried up to
    ``RetryPolicy.max_attempts`` times; each backoff consumes *virtual*
    time, so retrying shows in p99.  A request whose budget runs out is
    marked ``failed`` and counted once in the SLO metrics.
  * **Circuit breaker** -- ``BreakerConfig.trip_after`` consecutive failed
    attempts open it: batches fail fast (no executor call) until
    ``cooldown_s`` of virtual time passes, then one half-open probe batch
    decides between closing and re-opening.
  * **Brown-out ladder** -- a pressure EWMA (1 per failed batch, 0 per
    healthy one) steps the service down a quality ladder under sustained
    pressure and back up on recovery, with hysteresis (distinct down/up
    thresholds and a minimum dwell):

        full > split_fe > no_dedup > hot_only > shed

    Rungs are ``ServeBinding.set_mode`` variants over the same bucket
    signatures, warmed before serving, so a move adds no signature.
    ``split_fe`` and ``no_dedup`` are bitwise equal to ``full``;
    ``hot_only`` zero-fills the cold tier's contributions; ``shed`` also
    tightens the admission queue.
  * **Poison-triggered restore** -- ``poison_restore_after`` consecutive
    batches with scrubbed (non-finite) scores signal a corrupted store;
    the runtime heals it between micro-batches with
    ``ServeBinding.restore()``.
  * **Re-mesh escalation** -- attempt failures that carry a ``shard`` id
    (``ShardLossFailure``) build a same-shard streak, which any
    interleaved unattributed transient breaks; ``remesh_after`` of them
    escalate past the ladder to the ``remesh`` recovery (the runtime
    re-meshes onto the survivors, re-warms, and :meth:`note_remeshed`
    resets breaker, pressure and ladder).

All state advances on the runtime's virtual clock, so chaos runs are
deterministic and replayable.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.serving.faults import TransientServingFailure

RUNGS = ("full", "split_fe", "no_dedup", "hot_only", "shed")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3            # total attempts (first try included)
    backoff_s: float = 0.002         # virtual seconds before attempt 2
    backoff_mult: float = 2.0        # exponential growth per further attempt

    def backoff(self, failures: int) -> float:
        """Virtual-time penalty after the ``failures``-th failed attempt."""
        return self.backoff_s * self.backoff_mult ** (failures - 1)


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    trip_after: int = 5              # consecutive failed attempts to trip
    cooldown_s: float = 0.5          # open-state dwell before half-open


@dataclasses.dataclass(frozen=True)
class LadderConfig:
    alpha: float = 0.3               # pressure EWMA weight
    step_down_at: float = 0.5        # pressure >= this -> one rung down
    step_up_at: float = 0.05         # pressure <= this -> one rung up
    min_dwell_batches: int = 8       # hysteresis: batches between moves
    shed_capacity: int = 64          # admission bound while on 'shed'
    poison_restore_after: int = 2    # consecutive poisoned batches -> restore
    # consecutive attempt failures *attributed to one shard* before the
    # controller escalates to elastic re-mesh (0 disables).  The default
    # equals RetryPolicy.max_attempts: one retry-exhausted batch whose
    # every attempt blamed the same shard is already persistent-failure
    # evidence no transient produces.
    remesh_after: int = 3


class CircuitBreaker:
    """closed -> (trip_after consecutive failures) -> open -> (cooldown on
    the virtual clock) -> half-open probe -> closed | open."""

    def __init__(self, cfg: BreakerConfig):
        self.cfg = cfg
        self.state = "closed"
        self.consecutive = 0
        self.open_until = 0.0
        self.trips = 0

    def allow(self, now: float) -> bool:
        if self.state == "open":
            if now >= self.open_until:
                self.state = "half_open"     # admit one probe batch
                return True
            return False
        return True

    def record_failure(self, now: float) -> None:
        self.consecutive += 1
        if (self.state == "half_open"
                or self.consecutive >= self.cfg.trip_after):
            self.state = "open"
            self.open_until = now + self.cfg.cooldown_s
            self.trips += 1
            self.consecutive = 0

    def record_success(self) -> None:
        self.consecutive = 0
        if self.state == "half_open":
            self.state = "closed"


class DegradationController:
    """Composes retry policy, circuit breaker, and the brown-out ladder;
    the runtime consults it around every executor call.  ``binding`` is
    optional — a controller over a :class:`SimulatedExecutor` still
    retries, trips, and walks the ladder (rungs just change no datapath).
    """

    def __init__(self, binding=None,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[BreakerConfig] = None,
                 ladder: Optional[LadderConfig] = None,
                 retryable: Tuple[type, ...] = (TransientServingFailure,)):
        self.binding = binding
        self.retry = retry or RetryPolicy()
        self.breaker = CircuitBreaker(breaker or BreakerConfig())
        self.ladder = ladder or LadderConfig()
        self.retryable = tuple(retryable)
        self.rung = 0
        self.pressure = 0.0
        self.transitions: List[dict] = []
        self.queue = None
        self._base_capacity: Optional[int] = None
        self._dwell = 0
        self._poison_streak = 0
        self.restores = 0
        # per-shard failure attribution (remesh escalation)
        self._shard_streak = 0
        self.suspect_shard: Optional[int] = None
        self.remeshes = 0
        self.remesh_events: List[dict] = []
        self.straggler_trips = 0
        self.corruption_trips = 0

    # --------------------------------------------------------------- wiring
    @property
    def rung_label(self) -> str:
        return RUNGS[self.rung]

    def bind_queue(self, queue) -> None:
        """Give the shed rung an admission queue to tighten."""
        self.queue = queue
        self._base_capacity = queue.capacity

    # -------------------------------------------------------------- breaker
    def allow_execute(self, now: float) -> bool:
        return self.breaker.allow(now)

    def on_attempt_failure(self, now: float, exc=None) -> None:
        self.breaker.record_failure(now)
        # per-shard attribution: failures carrying a shard id build a
        # same-shard streak; an interleaved *non*-attributed transient
        # breaks the chain (flaky fabrics don't blame one shard
        # consistently — that inconsistency IS the transient/persistent
        # distinguisher).  exc=None (legacy callers) leaves the streak
        # untouched.
        shard = getattr(exc, "shard", None)
        if shard is not None:
            if shard == self.suspect_shard:
                self._shard_streak += 1
            else:
                self.suspect_shard = shard
                self._shard_streak = 1
        elif exc is not None:
            self.suspect_shard = None
            self._shard_streak = 0

    def on_straggler(self, now: float) -> None:
        """Watchdog trip: one micro-batch served far above the service-time
        EWMA.  A half-weight pressure bump — slow-but-correct is pressure,
        not failure — so sustained straggling walks the ladder down while
        one blip decays away."""
        l = self.ladder
        self.pressure = (1 - l.alpha) * self.pressure + l.alpha * 0.5
        self.straggler_trips += 1

    def on_corruption(self, now: float) -> None:
        """Scrub detection: a page's live checksum diverged from the
        ledger (silent store corruption).  The page is being repaired on
        the maintenance seam, so like a straggler this is evidence of
        trouble, not a failed batch — the same half-weight pressure bump:
        sustained flips walk the ladder down, one cosmic ray decays
        away."""
        l = self.ladder
        self.pressure = (1 - l.alpha) * self.pressure + l.alpha * 0.5
        self.corruption_trips += 1

    # --------------------------------------------------------------- ladder
    def on_batch_done(self, now: float, ok: bool, poisoned: int = 0) -> None:
        """Feed the ladder one resolved micro-batch (success, retry-
        exhausted failure, or fail-fast) and move rungs if warranted."""
        if ok:
            self.breaker.record_success()
            self._poison_streak = self._poison_streak + 1 if poisoned else 0
            if self.rung < RUNGS.index("hot_only"):
                # a success through the cross-shard datapath exonerates the
                # suspect; hot-only/shed successes don't touch the cold
                # shards, so they are not evidence either way
                self.suspect_shard = None
                self._shard_streak = 0
        l = self.ladder
        self.pressure = ((1 - l.alpha) * self.pressure
                         + l.alpha * (0.0 if ok else 1.0))
        self._dwell += 1
        if self._dwell < l.min_dwell_batches:
            return
        if self.pressure >= l.step_down_at and self.rung < len(RUNGS) - 1:
            self._move(now, self.rung + 1, f"pressure={self.pressure:.2f}")
        elif self.pressure <= l.step_up_at and self.rung > 0:
            self._move(now, self.rung - 1, f"pressure={self.pressure:.2f}")

    def _move(self, now: float, new_rung: int, reason: str) -> None:
        frm, to = RUNGS[self.rung], RUNGS[new_rung]
        self.rung = new_rung
        self._dwell = 0
        self.transitions.append({"t": round(now, 6), "from": frm, "to": to,
                                 "reason": reason})
        if self.binding is not None:
            self.binding.set_mode(to)
        if self.queue is not None:
            self.queue.set_capacity(self.ladder.shed_capacity
                                    if to == "shed" else self._base_capacity)

    # ------------------------------------------------------------- recovery
    @property
    def wants_restore(self) -> bool:
        return (self.binding is not None
                and self.binding.checkpointer is not None
                and self._poison_streak >= self.ladder.poison_restore_after)

    def note_restored(self) -> None:
        self._poison_streak = 0
        self.restores += 1

    @property
    def wants_remesh(self) -> bool:
        """Escalate past the ladder: enough consecutive failures blamed on
        one shard, and the binding can actually re-mesh."""
        return (self.ladder.remesh_after > 0
                and self.binding is not None
                and getattr(self.binding, "can_remesh", False)
                and self._shard_streak >= self.ladder.remesh_after)

    def note_remeshed(self, now: float, event: Optional[dict] = None
                      ) -> None:
        """The dead shard left the mesh: unlike a breaker cooldown, the
        fault is *gone* — reset breaker, pressure, and ladder so serving
        resumes at full quality on the survivor mesh."""
        self.remeshes += 1
        self.remesh_events.append(
            {"t": round(now, 6), "shard": self.suspect_shard,
             **(event or {})})
        self.suspect_shard = None
        self._shard_streak = 0
        self.breaker.state = "closed"
        self.breaker.consecutive = 0
        self.pressure = 0.0
        if self.rung != 0:
            self._move(now, 0, "remesh recovery")

    # --------------------------------------------------------------- report
    def report(self) -> dict:
        return {
            "rung": self.rung_label,
            "pressure": round(self.pressure, 4),
            "transitions": list(self.transitions),
            "n_transitions": len(self.transitions),
            "breaker_state": self.breaker.state,
            "breaker_trips": self.breaker.trips,
            "restores": self.restores,
            "remeshes": self.remeshes,
            "remesh_events": list(self.remesh_events),
            "suspect_shard": self.suspect_shard,
            "straggler_trips": self.straggler_trips,
            "corruption_trips": self.corruption_trips,
        }
