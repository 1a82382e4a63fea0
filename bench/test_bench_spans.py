"""CPU tests of the span reduction (``bench/spans.py``): the attribution
on synthetic tuples and on a synthetic trace, the six span readings and
their None cases, and one traced window of a tiny cell through the
harness's set-up."""
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from bench import devtrace, harness, spans  # noqa: E402
from bench.test_bench_harness import ZIPF, _spec, _tiny  # noqa: E402

# one execute, 0-100 ns: the copy, the step (its towers and front end),
# the wait; then the caller until 140
SPANS = [(0, 100, "pifs.execute"), (5, 30, "pifs.h2d"),
         (30, 80, "pifs.step"), (32, 40, "pifs.bottom_mlp"),
         (40, 60, "pifs.front_end"), (62, 78, "pifs.top_mlp"),
         (80, 98, "pifs.sync")]


def test_device_time_goes_to_the_innermost_span_of_its_launch():
    ops = [(10, 15), (35, 40), (38, 2), (45, 7), (61, 3), (70, 30),
           (99, 1), (120, 4), (None, 6)]
    got = spans.attribute(SPANS, ops, [])
    dev = {k: round(v["device_s"] * 1e9) for k, v in got.items()
           if v["device_s"]}
    assert dev == {"pifs.h2d": 15, "pifs.bottom_mlp": 42,
                   "pifs.front_end": 7, "pifs.step": 3, "pifs.top_mlp": 30,
                   "pifs.execute": 1, "(caller)": 4, "(unlinked)": 6}
    assert got["pifs.step"]["count"] == 1
    assert got["pifs.step"]["host_s"] == pytest.approx(50e-9)
    assert got["pifs.execute"]["host_s"] == pytest.approx(100e-9)


def test_idle_parts_sum_to_the_whole_idle():
    gaps = [(0, 4), (6, 12), (58, 64), (85, 97), (99, 101), (101, 139)]
    got = spans.attribute(SPANS * 2, [], gaps)
    idle = {k: round(v["idle_s"] * 1e9) for k, v in got.items()
            if v["idle_s"]}
    # middles 2, 9, 61, 91, 100, 120: execute, h2d, step, sync, caller x2
    assert idle == {"pifs.execute": 4, "pifs.h2d": 6, "pifs.step": 6,
                    "pifs.sync": 12, "(caller)": 40}
    assert sum(v["idle_s"] for v in got.values()) == pytest.approx(
        sum(e - s for s, e in gaps) / 1e9)
    assert got["pifs.execute"]["count"] == 2


class _Event:
    """The methods of a kineto event that the reductions call."""

    def __init__(self, name, dev, start, dur, corr=0, linked=0,
                 annotation=False, tid=1):
        self._v = (name, dev, start, dur, corr, linked, annotation, tid)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def duration_ns(self): return self._v[3]
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return self._v[5]
    def is_user_annotation(self): return self._v[6]
    def start_thread_id(self): return self._v[7]


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _trace():
    """A window of 0-200 ns holding SPANS; a copy launched in the seam, a
    GEMM in the bottom MLP, a kernel in the front end, each a runtime call
    with its correlation id; the spans' device-side mirrors, which cover
    the device's work and gaps alike; a span of another thread."""
    ev = [_Event("bench.window", CPU, 0, 200, annotation=True)]
    ev += [_Event(n, CPU, s, e - s, annotation=True) for s, e, n in SPANS]
    ev += [_Event("pifs.step", CPU, 31, 2, annotation=True, tid=2)]
    ev += [_Event("cudaMemcpyAsync", CPU, 10, 15, corr=7),
           _Event("cudaLaunchKernel", CPU, 35, 2, corr=8),
           _Event("cudaLaunchKernel", CPU, 45, 2, corr=9)]
    ev += [_Event("Memcpy HtoD (Pageable -> Device)", CUDA, 12, 20, corr=7),
           _Event("sm80_xmma_gemm", CUDA, 40, 30, corr=8),
           _Event("fused_front_end_kernel", CUDA, 70, 10, corr=9,
                  linked=3),
           # launched by no call in the trace; its ATen link is no launch
           _Event("elementwise_kernel", CUDA, 80, 5, corr=99, linked=8)]
    ev += [_Event(n, CUDA, s + 1, e - s, annotation=True)
           for s, e, n in SPANS]
    return _prof(ev)


def test_a_trace_reduces_to_spans_without_the_mirrors():
    got = spans.reduce(_trace(), "bench.window")
    summary = devtrace.reduce(_trace(), "bench.window")
    assert summary["busy_s"] == pytest.approx(65e-9)   # 12-32, 40-85
    assert {k: round(v["device_s"] * 1e9) for k, v in got.items()
            if v["device_s"]} == {"pifs.h2d": 20, "pifs.bottom_mlp": 30,
                                  "pifs.front_end": 10, "(unlinked)": 5}
    assert got["pifs.step"]["count"] == 1               # one thread only
    assert sum(v["idle_s"] for v in got.values()) == pytest.approx(
        sum(summary["idle"].values()))
    # gaps 0-12 (middle 6: h2d), 32-40 (36: bottom MLP), 85-200 (142)
    assert round(got["pifs.h2d"]["idle_s"] * 1e9) == 12
    assert round(got["pifs.bottom_mlp"]["idle_s"] * 1e9) == 8
    assert round(got["(caller)"]["idle_s"] * 1e9) == 115
    # each part's gaps named as devtrace names them
    assert got["pifs.h2d"]["idle_events"] == [["pifs.h2d",
                                               pytest.approx(12e-9)]]
    assert got["(caller)"]["idle_events"] == [["(no host event)",
                                               pytest.approx(115e-9)]]
    with pytest.raises(RuntimeError):
        spans.reduce(_trace(), "no.such.window")


def _mirror(**kw):
    base = dict(name="pifs.step", dev=CUDA, start=0, dur=1, annotation=True)
    base.update(kw)
    return _Event(**base)


@pytest.mark.parametrize("event,mirror", [
    (_mirror(), True),
    (_mirror(annotation=False), True),
    (_mirror(name="bench.execute", annotation=False), True),
    (_mirror(name="sm80_xmma_gemm", annotation=False), False),
], ids=["annotation", "pifs-name", "bench-name", "kernel"])
def test_a_spans_mirror_is_not_device_time(event, mirror):
    assert spans.is_mirror(event) is mirror


def _reduced(**over):
    rec = {"pifs.execute": dict(count=4, host_s=0.04, device_s=0.0,
                                idle_s=0.001),
           "pifs.h2d": dict(count=4, host_s=0.008, device_s=0.006,
                            idle_s=0.004),
           "pifs.step": dict(count=4, host_s=0.02, device_s=0.0004,
                             idle_s=0.002),
           "pifs.bottom_mlp": dict(count=4, host_s=0.001, device_s=0.004,
                                   idle_s=0.0005),
           "pifs.front_end": dict(count=4, host_s=0.001, device_s=0.001,
                                  idle_s=0.0),
           "pifs.top_mlp": dict(count=4, host_s=0.001, device_s=0.012,
                                idle_s=0.0005),
           "pifs.sync": dict(count=4, host_s=0.009, device_s=0.0,
                             idle_s=0.0),
           "(caller)": dict(count=0, host_s=0.0, device_s=0.0,
                            idle_s=0.002)}
    rec.update(over)
    return rec


def test_span_readings_per_request_and_share_of_the_window():
    got = spans.readings(_reduced(), window_s=0.05, busy_s=0.04,
                         requests=4)
    assert got == pytest.approx({
        "seam_host_ms.bulk": 2.0, "mlp_span_ms.bulk": 4.0,
        "front_end_span_ms.bulk": 0.25, "idle_seam_share.bulk": 8.0,
        "idle_step_share.bulk": 6.0, "idle_caller_share.bulk": 4.0})
    # with execute's own idle (the sync holds none here), the whole idle
    whole = 100 * (1 - 0.04 / 0.05)
    assert sum(v for k, v in got.items() if k.startswith("idle_")) \
        + 100 * 0.001 / 0.05 == pytest.approx(whole)


@pytest.mark.parametrize("case", ["no_spans", "partial", "idle_device"])
def test_span_readings_are_none_where_nothing_can_be_read(case):
    spans_, busy, requests = _reduced(), 0.04, 4
    if case == "no_spans":
        spans_ = None
    elif case == "partial":
        requests = 5
    else:
        busy = 0.0
    got = spans.readings(spans_, 0.05, busy, requests)
    if case == "idle_device":
        assert got.pop("seam_host_ms.bulk") == pytest.approx(2.0)
    assert set(got.values()) == {None}


def test_a_tiny_cell_has_one_execute_per_request_on_the_cpu():
    p = harness.prepare(_spec(_tiny(), ZIPF), 2**31 + 7, "cpu")
    t0, reqs, summary, got = spans.traced_window(p, 0.3)
    assert reqs and t0 <= reqs[0].start
    for name in ("pifs.execute", "pifs.h2d", "pifs.step", "pifs.sync",
                 "pifs.bottom_mlp", "pifs.front_end", "pifs.top_mlp"):
        assert got[name]["count"] == len(reqs), name
    assert got["pifs.execute"]["host_s"] >= got["pifs.step"]["host_s"] \
        >= got["pifs.top_mlp"]["host_s"] > 0
    assert sum(v["idle_s"] for v in got.values()) == pytest.approx(
        summary["window_s"] - summary["busy_s"])
    read = spans.readings(got, summary["window_s"], summary["busy_s"],
                          len(reqs))
    assert read.pop("seam_host_ms.bulk") > 0    # host spans, no device here
    assert set(read.values()) == {None}


def test_the_command_prints_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    r = subprocess.run([sys.executable, "bench/spans.py", "--workload",
                        "rmc4.bulk-zipf", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 3 and r.stdout.strip() == ""
