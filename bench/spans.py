"""The port's serve-path spans (``pifs.*``, ``repro_torch/trace.py``) in a
``torch.profiler`` trace of a window, and what they attribute.

For each span name: ``count``, ``host_s`` (the sum of its durations),
``device_s`` (kernels and copies whose launching runtime call starts in
it and in no inner ``pifs.`` span) and ``idle_s`` (the device's idle gaps
whose middle lies in it and in no inner ``pifs.`` span).  ``(caller)``
holds what lies in no ``pifs.`` span: the harness's own time around
``execute``.  The attribution is in pure functions on tuples
(:func:`attribute`), as ``devtrace._name_gaps`` is; busy time and gaps are
``devtrace``'s, so the idle parts sum to its idle.

    python bench/spans.py --workload <cell> --seed <n> --seconds <s>

runs one traced window of a cell on the card, set up as ``bench/run.py``
sets it up, and prints one JSON line: the spans, the per-layer readings
the benchmark takes from the same trace, the six span readings of
:func:`readings`, and the kernel libraries the process built or found.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[1]
PREFIX = "pifs."
EXECUTE = "pifs.execute"
CALLER = "(caller)"
STEP_GROUP = ("pifs.step", "pifs.bottom_mlp", "pifs.front_end",
              "pifs.top_mlp")
RUNTIME = "cu"      # CUDA API calls: cudaLaunchKernel, cuLaunchKernel, ...


def _innermost(points: Sequence[int], spans: Sequence[Tuple[int, int, str]]
               ) -> List[str]:
    """For each time in ``points``, the name of the innermost span holding
    it (spans nest, as ranges of one thread do), or ``CALLER``."""
    order = sorted(range(len(points)), key=lambda i: points[i])
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out = [CALLER] * len(points)
    stack: List[Tuple[int, int, str]] = []
    k = 0
    for i in order:
        t = points[i]
        while k < len(spans) and spans[k][0] <= t:
            while stack and stack[-1][1] <= spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if stack:
            out[i] = stack[-1][2]
    return out


def attribute(spans: Sequence[Tuple[int, int, str]],
              ops: Sequence[Tuple[Optional[int], int]],
              gaps: Sequence[Tuple[int, int]],
              host: Sequence[Tuple[int, int, str]] = ()
              ) -> Dict[str, dict]:
    """``spans``: (start, end, name) of the thread's ``pifs.`` spans, in
    ns; ``ops``: (start of the launching call or None, duration) of each
    device operation; ``gaps``: the device's idle (start, end).  Returns
    {name: {count, host_s, device_s, idle_s}} with ``CALLER``, and
    ``(unlinked)`` for operations whose launching call is not in the
    trace.  With ``host`` (the thread's events as ``devtrace`` lists them),
    each record also names its largest gaps by the innermost host event,
    ``idle_events``."""
    out: Dict[str, dict] = {}

    def rec(name):
        return out.setdefault(name, {"count": 0, "host_s": 0.0,
                                     "device_s": 0.0, "idle_s": 0.0})
    rec(CALLER)
    for s, e, name in spans:
        r = rec(name)
        r["count"] += 1
        r["host_s"] += (e - s) / 1e9
    linked = [(t, d) for t, d in ops if t is not None]
    for name, (_, d) in zip(_innermost([t for t, _ in linked], spans),
                            linked):
        rec(name)["device_s"] += d / 1e9
    unlinked = sum(d for t, d in ops if t is None)
    if unlinked:
        rec("(unlinked)")["device_s"] += unlinked / 1e9
    mids = [(g0 + g1) // 2 for g0, g1 in gaps]
    held: Dict[str, list] = {}
    for name, (g0, g1) in zip(_innermost(mids, spans), gaps):
        rec(name)["idle_s"] += (g1 - g0) / 1e9
        held.setdefault(name, []).append((g0, g1))
    if host:
        from bench import devtrace
        for name, g in held.items():
            out[name]["idle_events"] = devtrace.top(
                devtrace._name_gaps(g, host), 5)
    return out


def is_mirror(e) -> bool:
    """A host span's device-side mirror (kineto's ``gpu_user_annotation``):
    neither device time nor busy time."""
    return e.is_user_annotation() or e.name().startswith(("bench.", PREFIX))


def reduce(prof, window: str) -> Dict[str, dict]:
    """:func:`attribute` over the trace of the span named ``window``: the
    ``pifs.`` spans of the window's thread, its device operations matched
    to their launching runtime calls by ``correlation_id()`` (CUPTI's,
    shared by the call and what it launched; ``linked_correlation_id()``
    names the ATen operation, another count), and the idle gaps of
    ``devtrace``'s busy union."""
    from torch.autograd import DeviceType

    from bench import devtrace
    events = prof.profiler.kineto_results.events()
    w = next((e for e in events if e.name() == window
              and e.device_type() == DeviceType.CPU), None)
    if w is None:
        raise RuntimeError(f"the trace holds no {window!r} span")
    w0 = w.start_ns()
    w1 = w0 + w.duration_ns()
    tid = w.start_thread_id()
    launch: Dict[int, int] = {}
    spans, dev, host = [], [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        inside = s >= w0 and s + d <= w1
        if e.device_type() == DeviceType.CUDA:
            if inside and not is_mirror(e):
                dev.append(e)
            continue
        if e.name().startswith(RUNTIME) and not e.is_user_annotation():
            launch[e.correlation_id()] = s
        if inside and e.start_thread_id() == tid and e is not w:
            host.append((s, s + d, e.name()[:devtrace.NAME_CHARS]))
            if e.name().startswith(PREFIX):
                spans.append((s, s + d, e.name()))
    ops = [(launch.get(e.correlation_id()), e.duration_ns()) for e in dev]
    busy = devtrace._interval_union(
        [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in dev])
    host.sort(key=lambda h: (h[0], -h[1]))
    return attribute(spans, ops, devtrace._gaps(busy, w0, w1), host)


def readings(spans: Optional[Dict[str, dict]], window_s: float,
             busy_s: float, requests: int) -> Dict[str, Optional[float]]:
    """The six span readings: host and device ms a request of the seam,
    the MLPs and the front end, and the idle shares (% of the window) of
    the seam, the step and the caller.  Each is None without spans, when
    the spans' ``pifs.execute`` count differs from ``requests`` (a partial
    trace), and, of the device and idle readings, when ``busy_s`` <= 0."""
    names = ("seam_host_ms.bulk", "mlp_span_ms.bulk",
             "front_end_span_ms.bulk", "idle_seam_share.bulk",
             "idle_step_share.bulk", "idle_caller_share.bulk")
    out: Dict[str, Optional[float]] = dict.fromkeys(names)
    if not spans or spans.get(EXECUTE, {}).get("count") != requests:
        return out

    def get(name, key):
        return spans.get(name, {}).get(key, 0.0)
    out["seam_host_ms.bulk"] = get("pifs.h2d", "host_s") / requests * 1e3
    if busy_s <= 0:
        return out
    out["mlp_span_ms.bulk"] = (get("pifs.bottom_mlp", "device_s")
                               + get("pifs.top_mlp", "device_s")
                               ) / requests * 1e3
    out["front_end_span_ms.bulk"] = (get("pifs.front_end", "device_s")
                                     / requests * 1e3)
    out["idle_seam_share.bulk"] = 100 * get("pifs.h2d", "idle_s") / window_s
    out["idle_step_share.bulk"] = 100 * sum(
        get(n, "idle_s") for n in STEP_GROUP) / window_s
    out["idle_caller_share.bulk"] = 100 * get(CALLER, "idle_s") / window_s
    return out


def traced_window(p, seconds: float):
    """One window of ``p`` (``harness.prepare``) under ``torch.profiler``,
    as ``harness.measure`` takes it; returns (window start, requests,
    ``devtrace`` summary, spans)."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from bench import devtrace, harness
    acts = [ProfilerActivity.CPU]
    if p.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    with record_function(harness.WINDOW_SPAN):
        t0, reqs = harness.closed_loop(p.binding.execute, p.pool, seconds)
        harness._sync(p.device)
    prof.stop()
    return (t0, reqs, devtrace.reduce(prof, harness.WINDOW_SPAN),
            reduce(prof, harness.WINDOW_SPAN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import run
    run._environment()
    from types import SimpleNamespace

    import torch

    from bench import harness
    from repro_torch.kernels import build

    def log(msg):
        print(msg, file=sys.stderr, flush=True)
    if not torch.cuda.is_available():
        log("no CUDA device: the span tool runs on the card")
        return 3
    spec = harness.load_spec(args.workload, ROOT)
    p = harness.prepare(spec, args.seed, "cuda:0", log)
    t0, reqs, summary, spans = traced_window(p, args.seconds)
    for line in p.system.counters(p.binding):
        log(line)
    window_s = max(r.end for r in reqs) - t0
    ctx = SimpleNamespace(
        config=spec["config"], traffic=spec["traffic"], setup_s=None,
        window_s=window_s, requests=len(reqs),
        items=spec["traffic"]["items"] * len(reqs), trace=summary,
        flops_per_item=p.reference.flops_per_item(spec["config"]),
        front_end_bound_s=harness.front_end_bound_s(p, reqs))
    bench_metrics = {}
    for name, _ in spec["per_layer"]:
        v = harness.read_metric(name, ctx)
        if v is not None:
            bench_metrics[name] = v
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "requests": len(reqs), "window_s": summary["window_s"],
        "busy_s": summary["busy_s"], "metrics": bench_metrics,
        "span_readings": readings(spans, summary["window_s"],
                                  summary["busy_s"], len(reqs)),
        "spans": spans, "libraries": build.libraries_line(),
        "at": time.strftime("%Y-%m-%dT%H:%M:%S")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
