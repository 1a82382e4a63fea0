"""Request abstraction, arrival processes, and the bounded admission queue.

A numpy copy of ``repro.serving.request``.  A ``Request`` is one inference
query: a dict of host-side per-example features (for DLRM: ``dense
(n_dense,)`` and ``indices (T, L_r)`` global row ids), an arrival
timestamp, and an absolute SLO deadline.  Arrival processes model
production access streams: Poisson, a two-state bursty process
(Markov-modulated Poisson), and a deterministic uniform pacer.  All are
pure functions of their config -- same seed, same stream, bit for bit the
reference's.

Times are in seconds on the runtime's virtual clock (the discrete-event
loop in ``repro_torch.serving.runtime``); service times come from real
device execution, arrivals from these generators.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, List

import numpy as np

_ARRIVAL_TAG = 0x5EA1


@dataclasses.dataclass
class Request:
    """One inference query travelling through the serving runtime."""
    rid: int
    arrival_s: float
    deadline_s: float                 # absolute: arrival + SLO budget
    features: Dict[str, np.ndarray]   # per-example host arrays (unbatched)
    pooling: int = 1                  # lookups per bag (bucket dimension)
    user: int = -1                    # closed-loop: issuing virtual user
    start_s: float = math.nan         # set by the runtime at flush
    finish_s: float = math.nan        # set by the runtime at batch completion
    failed: bool = False              # retry budget exhausted / breaker open

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s

    @property
    def queued_s(self) -> float:
        return self.start_s - self.arrival_s

    @property
    def slo_ok(self) -> bool:
        return not self.failed and self.finish_s <= self.deadline_s


@dataclasses.dataclass(frozen=True)
class ArrivalConfig:
    """Open-loop arrival process (offered load)."""
    rate_qps: float
    process: str = "poisson"     # poisson | bursty | uniform
    # bursty = MMPP-2: a base state and a burst state whose instantaneous
    # rate is burst_factor * rate_qps; burst_fraction is the fraction of
    # *time* spent bursting.  Overall mean rate stays rate_qps.
    burst_factor: float = 8.0
    burst_fraction: float = 0.1
    mean_burst_s: float = 0.25   # average burst-state dwell time
    seed: int = 0

    def __post_init__(self):
        if self.rate_qps <= 0:
            raise ValueError("rate_qps must be positive")
        if self.process == "bursty" and not (
                0 < self.burst_fraction * self.burst_factor < 1):
            raise ValueError(
                "bursty process needs burst_fraction * burst_factor in (0, 1) "
                "so the base-state rate stays positive")


def arrival_times(cfg: ArrivalConfig, n: int) -> np.ndarray:
    """Absolute arrival times (seconds, ascending, start near 0) for n
    requests.  Deterministic in (cfg.seed, cfg)."""
    rng = np.random.default_rng([cfg.seed, _ARRIVAL_TAG])
    if cfg.process == "uniform":
        return np.arange(n, dtype=np.float64) / cfg.rate_qps
    if cfg.process == "poisson":
        gaps = rng.exponential(1.0 / cfg.rate_qps, n)
        return np.cumsum(gaps)
    if cfg.process != "bursty":
        raise ValueError(f"unknown arrival process {cfg.process!r}")
    # MMPP-2: rates chosen so time-weighted mean rate == rate_qps
    f = cfg.burst_fraction
    r_burst = cfg.burst_factor * cfg.rate_qps
    r_base = cfg.rate_qps * (1.0 - f * cfg.burst_factor) / (1.0 - f)
    mean_dwell = {True: cfg.mean_burst_s,
                  False: cfg.mean_burst_s * (1.0 - f) / f}
    times = np.empty(n, dtype=np.float64)
    t = 0.0
    bursting = False
    state_end = rng.exponential(mean_dwell[bursting])
    for i in range(n):
        gap = rng.exponential(1.0 / (r_burst if bursting else r_base))
        while t + gap > state_end:
            # rate changes mid-gap: re-draw the remainder under the new
            # rate (memoryless, so this is exact for an MMPP)
            t = state_end
            bursting = not bursting
            state_end = t + rng.exponential(mean_dwell[bursting])
            gap = rng.exponential(1.0 / (r_burst if bursting else r_base))
        t += gap
        times[i] = t
    return times


class AdmissionQueue:
    """Bounded FIFO admission queue with load-shedding accounting.

    ``offer`` rejects (sheds) when full -- the runtime records the drop so
    SLO math stays honest under overload instead of letting latency grow
    without bound."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("queue capacity must be positive")
        self.capacity = capacity
        self._q: "deque[Request]" = deque()
        self.offered = 0
        self.dropped = 0
        self.peak_depth = 0

    def __len__(self) -> int:
        return len(self._q)

    def set_capacity(self, capacity: int) -> None:
        """Resize the bound (the brown-out ladder's shed rung tightens it).

        Already-admitted requests are never evicted -- shrinking only
        affects future ``offer`` calls, so accounting stays monotonic."""
        if capacity <= 0:
            raise ValueError("queue capacity must be positive")
        self.capacity = capacity

    def offer(self, req: Request) -> bool:
        self.offered += 1
        if len(self._q) >= self.capacity:
            self.dropped += 1
            return False
        self._q.append(req)
        self.peak_depth = max(self.peak_depth, len(self._q))
        return True

    def view(self) -> List[Request]:
        """Current contents in arrival order (the batcher's read-only view)."""
        return list(self._q)

    def pop_n(self, n: int) -> List[Request]:
        if n > len(self._q):
            raise ValueError(f"pop_n({n}) from queue of {len(self._q)}")
        return [self._q.popleft() for _ in range(n)]
