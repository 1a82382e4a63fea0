"""Reduce a ``torch.profiler`` trace of a window to what the per-layer
metrics read: device time by operation, the device's busy time (the union
of every kernel and copy), and the idle gaps named by what the host was
doing at their middle (the innermost host event of the harness's thread).

The harness marks the window with a ``record_function`` span, so the host
events, the device events and the window share the profiler's clock.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

NAME_CHARS = 120    # operation names are cut to this length in the output


def _interval_union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _gaps(busy: List[Tuple[int, int]], w0: int, w1: int
          ) -> List[Tuple[int, int]]:
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Seconds of idle device time by the innermost host event (nested
    spans of one thread, sorted by start) covering each gap's middle."""
    by_name: Dict[str, float] = {}
    stack: List[Tuple[int, int, str]] = []
    k = 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) // 2
        while k < len(host) and host[k][0] <= mid:
            while stack and stack[-1][1] <= host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        name = stack[-1][2] if stack else "(no host event)"
        by_name[name] = by_name.get(name, 0.0) + (g1 - g0) / 1e9
    return by_name


def reduce(prof, window: str) -> dict:
    """``busy_s`` and ``window_s`` of the span named ``window``, device
    ``ops`` {name: [count, seconds]} inside it, and ``idle`` {host event:
    seconds}.  Raises if the trace holds no such span."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    spans = [e for e in events if e.name() == window
             and e.device_type() == DeviceType.CPU]
    if not spans:
        raise RuntimeError(f"the trace holds no {window!r} span")
    w = spans[0]
    w0 = w.start_ns()
    w1 = w0 + w.duration_ns()
    tid = w.start_thread_id()
    dev, host = [], []
    ops: Dict[str, List[float]] = {}
    for e in events:
        s = e.start_ns()
        d = e.duration_ns()
        if s < w0 or s + d > w1:
            continue
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or e.name().startswith("bench."):
                continue                    # a host span's mirror
            dev.append((s, s + d))
            rec = ops.setdefault(e.name()[:NAME_CHARS], [0, 0.0])
            rec[0] += 1
            rec[1] += d / 1e9
        elif e.start_thread_id() == tid and e is not w:
            host.append((s, s + d, e.name()[:NAME_CHARS]))
    busy = _interval_union(dev)
    host.sort(key=lambda h: (h[0], -h[1]))
    return {"window_s": (w1 - w0) / 1e9,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "ops": ops,
            "idle": _name_gaps(_gaps(busy, w0, w1), host)}


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    """The ``n`` largest entries as [name, value] pairs."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
