"""Fault-tolerant training runtime: checkpoint/restart loop, failure
injection, straggler watchdog (a port of
``repro.runtime.fault_tolerance``, plain Python over the port's
``Checkpointer``).

  * **Restart loop** -- :func:`run_resilient` drives (restore latest ->
    train -> checkpoint every N) and survives injected failures by
    re-entering from the last committed checkpoint; a crash mid-save
    leaves a ``.tmp`` the checkpointer ignores.
  * **Failure injection** -- :class:`FailureInjector` fires at scheduled
    steps (once each) or with a per-step probability from a seeded hash,
    reproducibly; training raises :class:`SimulatedFailure` on a firing,
    the serving fault layer (``serving/faults.py``) maps it onto its own
    fault classes.
  * **Straggler watchdog** -- a step-time EWMA; a step slower than
    ``threshold`` x EWMA is recorded (and handed to a callback) and does
    not move the baseline.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.device import DeviceLike


class SimulatedFailure(RuntimeError):
    """An injected node/step failure."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministic fault schedule shared by training and serving: fires
    at the listed steps exactly once each, plus (chaos mode) with a
    per-step probability from a hash of ``(seed, step)``, the same across
    restarts and processes (Python hashes tuples of ints
    deterministically)."""
    fail_at_steps: Tuple[int, ...] = ()
    fail_prob: float = 0.0
    seed: int = 0
    _fired: set = dataclasses.field(default_factory=set)

    @property
    def armed(self) -> bool:
        """Whether this injector can ever fire."""
        return bool(self.fail_at_steps) or self.fail_prob > 0.0

    def fires(self, step: int) -> bool:
        """Decide (and record) whether the fault fires at ``step``: at most
        once per step, so a restarted step or a retried batch does not
        loop on one scheduled fault."""
        if step in self._fired:
            return False
        if step in self.fail_at_steps:
            self._fired.add(step)
            return True
        if self.fail_prob > 0.0:
            h = hash((self.seed, step)) % 10_000
            if h < self.fail_prob * 10_000:
                self._fired.add(step)
                return True
        return False

    def maybe_fail(self, step: int) -> None:
        if self.fires(step):
            raise SimulatedFailure(f"injected failure at step {step}")


class StragglerWatchdog:
    """EWMA step-time monitor: after ``warmup`` observations a step
    slower than ``threshold`` x EWMA is a straggler (recorded in
    ``events``, passed to ``on_straggler``); stragglers do not move the
    baseline."""

    def __init__(self, alpha: float = 0.2, threshold: float = 2.5,
                 warmup: int = 3,
                 on_straggler: Optional[Callable[[int, float, float],
                                                 None]] = None):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.events: List[Dict[str, float]] = []
        self._n = 0
        self._on = on_straggler

    def observe(self, step: int, dt: float) -> bool:
        self._n += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = (self._n > self.warmup
                        and dt > self.threshold * self.ewma)
        if is_straggler:
            self.events.append({"step": step, "dt": dt, "ewma": self.ewma})
            if self._on is not None:
                self._on(step, dt, self.ewma)
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


@dataclasses.dataclass
class RunReport:
    steps_done: int
    restarts: int
    straggler_events: List[Dict[str, float]]
    final_metrics: Optional[Dict[str, Any]]


def run_resilient(train_step: Callable[[Any, Any], Tuple[Any, Dict]],
                  init_state: Any,
                  batches: Callable[[int], Any],
                  n_steps: int,
                  checkpointer: Checkpointer,
                  ckpt_every: int = 10,
                  injector: Optional[FailureInjector] = None,
                  watchdog: Optional[StragglerWatchdog] = None,
                  max_restarts: int = 10,
                  device: DeviceLike = None) -> RunReport:
    """Drive training to ``n_steps``, surviving injected failures.

    ``train_step(state, batch) -> (state, metrics)``; ``state`` is a tree
    of tensors (dataclasses and dicts) the checkpointer round-trips;
    ``batches(step)`` returns the batch of a global step (the same after a
    restart).  ``device`` is where a restored state lands (default: each
    leaf's device in ``init_state``), in place of the reference's
    shardings."""
    restarts = 0
    metrics: Optional[Dict[str, Any]] = None
    while True:
        start = checkpointer.latest_step()
        if start is None:
            state, step = init_state, 0
        else:
            state = checkpointer.restore(init_state, step=start,
                                         device=device)
            step = start
        try:
            while step < n_steps:
                if injector is not None:
                    injector.maybe_fail(step)
                t0 = time.perf_counter()
                state, metrics = train_step(state, batches(step))
                dt = time.perf_counter() - t0
                if watchdog is not None:
                    watchdog.observe(step, dt)
                step += 1
                if step % ckpt_every == 0 or step == n_steps:
                    checkpointer.save(step, state)
            checkpointer.wait()
            return RunReport(
                steps_done=step, restarts=restarts,
                straggler_events=watchdog.events if watchdog else [],
                final_metrics=metrics)
        except SimulatedFailure:
            restarts += 1
            checkpointer.wait()   # let an in-flight save commit or be ignored
            if restarts > max_restarts:
                raise
