"""One run of one cell: set-up, the measured window, the check of every
answer against the plain reference, and the metrics.

``bench/run.py`` is the command; this module is what it, the calibration
script and the tests share.  A cell's files are found by the
names in ``BENCHMARK.json`` (see ``bench/__init__.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from bench import devtrace, loadgen, yardstick

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
WINDOW_SPAN = "bench.window"
WARMUP_CALLS = 3      # executes before the window (one shape per cell)


# ------------------------------------------------------------------ cells
def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(workload: str, root: Path = ROOT) -> dict:
    """The cell named ``workload`` in ``root/BENCHMARK.json``: its
    configuration, traffic and limits files, and the metrics it reports
    ([name, unit] pairs, end-to-end and per-layer)."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"have {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _load_json(root / configs[cell["config"]]["file"])
    traffic = _load_json(root / "bench" / "traffic"
                         / f"{cell['traffic']}.json")
    loadgen.check_traffic(traffic)

    def listed(metrics):
        return [[m["name"], m["unit"]] for m in metrics
                if workload in m.get("workloads", [workload])]
    return {"name": workload, "chips": cell["chips"], "config": cfg,
            "traffic": traffic,
            "limits": _load_json(root / "bench" / "limits"
                                 / f"{workload}.json"),
            "end_to_end": listed(bench["end_to_end"]),
            "per_layer": listed(bench["per_layer"])}


def _family(cfg: dict):
    return (importlib.import_module(f"bench.reference.{cfg['family']}"),
            importlib.import_module(f"bench.systems.{cfg['family']}"))


def read_metric(name: str, ctx) -> Optional[float]:
    """The reader ``bench/metrics/<name>.py`` applied to ``ctx``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


# ------------------------------------------------------------------ set-up
@dataclasses.dataclass
class Prepared:
    spec: dict
    seed: int
    device: torch.device
    pool: List[Dict[str, np.ndarray]]
    binding: object
    system: object
    reference: object
    setup_peak_bytes: int


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def prepare(spec: dict, seed: int, device,
            log: Callable = lambda msg: None, system=None) -> Prepared:
    """Traffic pool, tables and weights from ``seed``, the system built
    from them and warmed on the cell's one shape; the counters zeroed.
    ``system``: what stands in the program's place (default: the port's
    adapter for the configuration's family, ``systems/<family>.py``)."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, traffic = spec["config"], spec["traffic"]
    ref, port = _family(cfg)
    system = system or port
    offsets = ref.row_offsets(cfg)
    steps = [time.perf_counter()]
    pool = loadgen.make_pool(cfg, traffic, seed, offsets)
    steps.append(time.perf_counter())
    params, tables = ref.make_inputs(cfg, seed, device)
    _sync(device)
    steps.append(time.perf_counter())
    binding = system.build(cfg, params, tables, pool, offsets, device)
    del params, tables
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    _sync(device)
    steps.append(time.perf_counter())
    for b in pool[:WARMUP_CALLS]:
        binding.execute(b).cpu()
    _sync(device)
    steps.append(time.perf_counter())
    log("set-up s: traffic {:.3f}, tables and weights {:.3f}, system "
        "build {:.3f}, warm-up {:.3f}".format(
            *(b - a for a, b in zip(steps[:-1], steps[1:]))))
    system.reset_counters(binding)
    peak = _peak(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    return Prepared(spec, seed, device, pool, binding, system, ref, peak)


# ------------------------------------------------------------------ window
@dataclasses.dataclass
class Request:
    batch: int            # index into the pool
    start: float          # handed to execute
    end: float            # scores on the host
    scores: np.ndarray


def _serve(execute: Callable, batch: dict, k: int,
           out: List[Request]) -> None:
    from torch.autograd.profiler import record_function
    start = time.perf_counter()
    with record_function("bench.execute"):
        dev = execute(batch)
    with record_function("bench.scores_to_host"):
        host = dev.cpu().numpy()
    out.append(Request(k, start, time.perf_counter(), host))


def closed_loop(execute: Callable, pool: Sequence[dict], seconds: float):
    """One caller, batches back to back until ``seconds`` have passed;
    returns (window start, requests)."""
    out: List[Request] = []
    t0 = time.perf_counter()
    k = 0
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
        _serve(execute, pool[k % len(pool)], k % len(pool), out)
        k += 1
    return t0, out


def measure(p: Prepared, seconds: float, trace: bool,
            log: Callable = print):
    """The window, traced with ``torch.profiler`` when ``trace``.  Returns
    (window start, requests, trace summary or None)."""
    execute = p.binding.execute
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if p.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        t = time.perf_counter()
        prof.start()
        log(f"trace: profiler started in {time.perf_counter() - t:.3f} s")
    from torch.autograd.profiler import record_function
    with record_function(WINDOW_SPAN):
        t0, reqs = closed_loop(execute, p.pool, seconds)
        _sync(p.device)
    summary = None
    if prof is not None:
        t = time.perf_counter()
        prof.stop()
        t1 = time.perf_counter()
        summary = devtrace.reduce(prof, WINDOW_SPAN)
        log(f"trace: stopped in {t1 - t:.3f} s, reduced in "
            f"{time.perf_counter() - t1:.3f} s")
        del prof
    return t0, reqs, summary


# ------------------------------------------------------------------- check
def judge(p: Prepared, reqs: Sequence[Request], log: Callable) -> dict:
    """Every request's scores against the reference's for its batch: the
    widest gap |score - reference| and the count of non-finite scores.
    Runs after the system is freed: the reference draws the tables and
    weights anew from the seed."""
    cfg = p.spec["config"]
    ref = p.reference
    used = sorted({r.batch for r in reqs})
    t = time.perf_counter()
    params, tables = ref.make_inputs(cfg, p.seed, p.device)
    want = {k: ref.forward(cfg, params, tables, p.pool[k]).cpu().numpy()
            for k in used}
    del params, tables
    gap, nonfinite, bad_requests = 0.0, 0, 0
    for r in reqs:
        finite = np.isfinite(r.scores)
        if not finite.all() or r.scores.shape != want[r.batch].shape:
            bad_requests += 1
            nonfinite += int((~finite).sum()) or 1
            continue
        gap = max(gap, float(np.max(np.abs(r.scores - want[r.batch]))))
    log(f"reference: {len(used)} distinct batches, {len(reqs)} requests "
        f"compared in {time.perf_counter() - t:.3f} s")
    return {"score_gap": gap, "nonfinite_scores": nonfinite,
            "failed": bad_requests}


def front_end_bound_s(p: Prepared, reqs: Sequence[Request]) -> float:
    """Mean roofline bound of the front end over the window's requests."""
    cfg = p.spec["config"]
    per = {}
    for k in {r.batch for r in reqs}:
        idx = torch.as_tensor(p.pool[k]["indices"], device=p.device)
        per[k] = yardstick.bound_s(*p.reference.front_end_cost(cfg, idx))
    return sum(per[r.batch] for r in reqs) / len(reqs)


# -------------------------------------------------------------------- run
def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def release(p: Prepared) -> None:
    p.binding = None
    gc.collect()
    if p.device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, log: Callable = _stderr, system=None) -> dict:
    """One run; returns the result object (the last line of the command's
    standard output).  ``t_start``: the process's start on perf_counter;
    ``system``: as for :func:`prepare`."""
    p = prepare(spec, seed, device, log, system)
    cfg, traffic = spec["config"], spec["traffic"]
    log(f"set-up: peak {p.setup_peak_bytes} bytes before the window")
    setup_s = time.perf_counter() - t_start
    t0, reqs, summary = measure(p, seconds, trace, log=log)
    window_s = max(r.end for r in reqs) - t0
    memory_peak = _peak(p.device)
    for line in p.system.counters(p.binding):
        log(line)
    release(p)

    items = traffic["items"]
    chunks = [0] * (int(window_s // 2) + 1)
    for r in reqs:
        chunks[int((r.end - t0) // 2)] += items
    log("items/s by 2 s of the window: "
        + " ".join(f"{n / 2:.0f}" for n in chunks))
    ctx = SimpleNamespace(
        config=cfg, traffic=traffic, setup_s=setup_s, window_s=window_s,
        requests=len(reqs), items=items * len(reqs), trace=summary,
        flops_per_item=p.reference.flops_per_item(cfg),
        front_end_bound_s=(front_end_bound_s(p, reqs) if trace else None))
    checks = judge(p, reqs, log)
    names = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for name, unit in names:
        v = read_metric(name, ctx)
        if v is not None:
            metrics[name] = {"value": v, "unit": unit}

    limit = spec["limits"]["score_gap"]["limit"]
    compared = {
        "nonfinite_scores": {"value": checks["nonfinite_scores"],
                             "limit": 0},
        "score_gap": {"value": checks["score_gap"], "limit": limit}}
    correct = (checks["nonfinite_scores"] == 0
               and checks["score_gap"] <= limit and len(reqs) > 0)
    dev = p.device
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": len(reqs),
              "failed": checks["failed"], "metrics": metrics,
              "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = {
            "device_ops": [[k, v[1]] for k, v in sorted(
                summary["ops"].items(), key=lambda kv: -kv[1][1])[:10]],
            "idle_gaps": devtrace.top(summary["idle"])}
    result["checks"] = compared
    log(f"window: {len(reqs)} requests of {items} items in "
        f"{window_s:.6f} s; trace {'on' if trace else 'off'}")
    for k, v in compared.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    return result
