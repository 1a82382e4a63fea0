"""The port's serving runtime (``repro_torch.serving``: request, batcher,
metrics, runtime) against the JAX package's numpy-level modules on the
same seeded inputs.  Everything here is exact: arrival streams bitwise,
decisions, percentiles, flush traces and summaries equal.

The pinned flush trace is ``tests/test_serving.py::PINNED_REPLAY``; both
runtimes must reproduce it under ``SimulatedExecutor`` and
``FixedServiceModel``."""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serving import batcher as jbatcher
from repro.serving import metrics as jmetrics
from repro.serving import request as jrequest
from repro.serving import runtime as jruntime

from repro_torch.serving import batcher, metrics, request, runtime

from test_serving import PINNED_REPLAY

PKGS = {"port": (request, batcher, metrics, runtime),
        "ref": (jrequest, jbatcher, jmetrics, jruntime)}


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("process", ["poisson", "bursty", "uniform"])
def test_arrival_times_bitwise_equal(process, seed):
    for kw in ({}, {"mean_burst_s": 0.02, "burst_factor": 4.0,
                    "burst_fraction": 0.2}):
        got = request.arrival_times(
            request.ArrivalConfig(350.0, process=process, seed=seed, **kw),
            3000)
        want = jrequest.arrival_times(
            jrequest.ArrivalConfig(350.0, process=process, seed=seed, **kw),
            3000)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for bad in ({"rate_qps": 0.0}, {"rate_qps": 1.0, "process": "bursty",
                                    "burst_fraction": 0.2}):
        with pytest.raises(ValueError):
            request.ArrivalConfig(**bad)


def _req(mod, rid, t, slo=0.05, pooling=4):
    return mod.Request(rid=rid, arrival_s=t, deadline_s=t + slo,
                       features={}, pooling=pooling)


def test_admission_queue_accounting_matches():
    rng = np.random.default_rng(4)
    qs = {k: PKGS[k][0].AdmissionQueue(5) for k in PKGS}
    log = {k: [] for k in PKGS}
    for i in range(400):
        op, u = int(rng.integers(0, 4)), float(rng.random())
        for k, q in qs.items():
            mod = PKGS[k][0]
            if op < 2:
                log[k].append(q.offer(_req(mod, i, 0.001 * i)))
            elif op == 2 and len(q):
                n = 1 + int(u * len(q))
                log[k].append([r.rid for r in q.pop_n(n)])
            elif op == 3 and i % 50 < 10:
                q.set_capacity(3 + i % 4)
            log[k].append((len(q), q.capacity, q.offered, q.dropped,
                           q.peak_depth, [r.rid for r in q.view()]))
    assert log["port"] == log["ref"]
    assert qs["port"].dropped > 0
    for mod in (request, jrequest):
        with pytest.raises(ValueError):
            mod.AdmissionQueue(0)
        with pytest.raises(ValueError):
            mod.AdmissionQueue(2).pop_n(1)


@settings(max_examples=300, deadline=None)
@given(arrivals=st.lists(st.floats(0.0, 0.2), min_size=0, max_size=40),
       poolings=st.lists(st.sampled_from([1, 2, 4, 8]), min_size=40,
                         max_size=40),
       slo=st.floats(0.005, 0.2), now_gap=st.floats(0.0, 0.1),
       nxt=st.one_of(st.none(), st.floats(0.0, 0.1)),
       base=st.floats(1e-4, 2e-2), per_row=st.floats(0.0, 1e-3),
       ema=st.lists(st.floats(1e-4, 5e-2), min_size=3, max_size=3),
       max_wait=st.floats(1.0, 30.0), util=st.floats(0.05, 1.0))
def test_dynamic_batcher_decides_as_the_reference(
        arrivals, poolings, slo, now_gap, nxt, base, per_row, ema, max_wait,
        util):
    """The same queue, clock and service estimates give the same decision
    (a fixed affine model, and an EMA model fed the same measurements)."""
    times = sorted(arrivals)
    now = (times[-1] if times else 0.0) + now_gap
    nxt_t = None if nxt is None else now + nxt
    decisions = {}
    for k, (req_m, bat_m, _, _) in PKGS.items():
        cfg = bat_m.BatcherConfig(batch_sizes=(8, 16, 32),
                                  poolings=(2, 4, 8), max_wait_ms=max_wait,
                                  early_flush_util=util)
        queue = [_req(req_m, i, t, slo, poolings[i])
                 for i, t in enumerate(times)]
        fixed = bat_m.FixedServiceModel(base, per_row)
        emam = bat_m.ServiceModel(prior_s=base)
        for b, m in zip((8, 16, 32), ema):
            emam.update(bat_m.Bucket(b, 8), m)
            emam.update(bat_m.Bucket(b, 8), m / 2)
        out = []
        for svc in (fixed, emam):
            try:
                d = bat_m.DynamicBatcher(cfg).decide(now, queue, nxt_t, svc)
                out.append(None if d is None else
                           (type(d).__name__, dataclasses.astuple(d)))
            except ValueError as e:
                out.append(("ValueError", str(e)))
        fb = bat_m.FixedBatcher(16, 8)
        d = fb.decide(now, queue, nxt_t, fixed)
        out.append(None if d is None else
                   (type(d).__name__, dataclasses.astuple(d)))
        out.append([dataclasses.astuple(b) for b in cfg.buckets()]
                   + [dataclasses.astuple(b) for b in fb.buckets()])
        decisions[k] = out
    assert decisions["port"] == decisions["ref"]


def test_latency_histogram_matches():
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.lognormal(-4.0, 1.5, 700), [np.nan, np.inf],
                         [1e-9, 100.0]])
    h, jh = metrics.LatencyHistogram(), jmetrics.LatencyHistogram()
    assert h.percentiles_ms().keys() == jh.percentiles_ms().keys()
    for x in xs:
        h.record(float(x))
        jh.record(float(x))
    assert (len(h), h.nonfinite) == (len(jh), jh.nonfinite) == (702, 2)
    assert h.percentiles_ms() == jh.percentiles_ms()
    assert h.export() == jh.export()
    np.testing.assert_array_equal(h.counts, jh.counts)


BAT = dict(batch_sizes=(4, 8, 16), poolings=(4, 8), safety_ms=1.0,
           max_wait_ms=10.0)


def _replay(k, closed: bool, observe_every=0, replan_every=0):
    """The reference test's pinned replay (32 requests at 200 qps, seed
    11, pooling cycle 2/4/4/8, SLO 40 ms), open or closed loop (8 users,
    think 5 ms), through package ``k``'s runtime."""
    req_m, bat_m, _, rt_m = PKGS[k]
    model = bat_m.FixedServiceModel(base_s=4e-3, per_row_s=2.5e-4)
    rt = rt_m.ServingRuntime(
        rt_m.SimulatedExecutor(model),
        bat_m.DynamicBatcher(bat_m.BatcherConfig(**BAT)),
        padder=lambda reqs, bucket: {"n": len(reqs)},
        cfg=rt_m.RuntimeConfig(observe_every=observe_every,
                               replan_every=replan_every),
        service_model=model)
    cycle = (2, 4, 4, 8)
    if closed:
        src = rt_m.ClosedLoopSource(
            8, 40, lambda rid, user, t: _req(req_m, rid, t, 0.04,
                                             cycle[rid % 4]),
            think_time_s=0.005)
    else:
        times = req_m.arrival_times(req_m.ArrivalConfig(rate_qps=200.0,
                                                        seed=11), 32)
        src = rt_m.OpenLoopSource([_req(req_m, i, float(times[i]), 0.04,
                                        cycle[i % 4]) for i in range(32)])
    summary = rt.run(src)
    trace = [(b.bucket.batch, b.bucket.pooling, b.n_real, round(b.t, 5))
             for b in rt.metrics.batches]
    exact = [(b.t, b.service_s, b.queue_depth) for b in rt.metrics.batches]
    return trace, exact, summary


@pytest.mark.parametrize("maint", [(0, 0), (2, 3)])
@pytest.mark.parametrize("closed", [False, True], ids=["open", "closed"])
def test_runtime_replays_the_reference(closed, maint):
    got, got_exact, got_s = _replay("port", closed, *maint)
    want, want_exact, want_s = _replay("ref", closed, *maint)
    assert got == want and got_exact == want_exact
    if not closed:
        assert got[:len(PINNED_REPLAY)] == PINNED_REPLAY
    assert list(got_s) == list(want_s)           # same keys, same order
    for key in want_s:
        assert got_s[key] == want_s[key], key
    assert got_s["served"] == (40 if closed else 32)
    assert got_s["dropped"] == got_s["failed"] == 0


def test_runtime_sheds_and_warms_as_the_reference():
    """A queue of 3 under a burst sheds the same requests, and warmup runs
    every bucket twice, observes each once and re-plans once, seeding the
    service model with the second run."""
    out = {}
    for k, (req_m, bat_m, _, rt_m) in PKGS.items():
        calls = []

        class Exec(rt_m.SimulatedExecutor):
            def run_batch(self, bucket, batch):
                calls.append(("run", bucket.batch, bucket.pooling))
                return 1e-3 * (len(calls) % 3 + 1)

            def observe(self, batch):
                calls.append(("observe",))
                return 0.0

            def replan(self):
                calls.append(("replan",))
                return 0.0

        rt = rt_m.ServingRuntime(
            Exec(bat_m.ServiceModel()),
            bat_m.DynamicBatcher(bat_m.BatcherConfig(**BAT)),
            padder=lambda reqs, bucket: {},
            cfg=rt_m.RuntimeConfig(queue_capacity=3))
        warm = rt.warmup(lambda rid, pooling: _req(req_m, -1 - rid, 0.0,
                                                   1.0, pooling))
        est = [rt.service_model.estimate(b) for b in rt.batcher.buckets()]
        src = rt_m.OpenLoopSource([_req(req_m, i, 0.0005 * (i // 6), 0.05)
                                   for i in range(30)])
        s = rt.run(src)
        out[k] = (warm, est, calls, s)
    assert out["port"] == out["ref"]
    assert out["port"][3]["dropped"] > 0


def test_binding_executor_pads_its_own_batches():
    """The port's ``BindingExecutor`` is the runtime's padder: each score
    lands under the rid of the request it was served for, pinned service
    times replay the model's estimates, and a runtime refuses a second
    padder beside it (or none for an executor that does not pad)."""
    import torch

    class Binding:
        def execute(self, batch):
            return torch.as_tensor(batch["x"] * 0.5)

    def pad(reqs, bucket):
        x = np.zeros(bucket.batch, np.float32)
        x[:len(reqs)] = [r.rid for r in reqs]
        return {"x": x}

    model = batcher.FixedServiceModel(base_s=1e-3, per_row_s=1e-5)
    ex = runtime.BindingExecutor(Binding(), pad, model)
    bat = batcher.DynamicBatcher(batcher.BatcherConfig(**BAT))
    rt = runtime.ServingRuntime(ex, bat, cfg=runtime.RuntimeConfig(
        observe_every=0, replan_every=0), service_model=model)
    assert rt.padder == ex.pad
    s = rt.run(runtime.OpenLoopSource(
        [_req(request, i, 0.0004 * i, 0.05) for i in range(40)]))
    assert s["served"] == 40
    assert ex.scores == {i: np.float32(0.5 * i) for i in range(40)}
    assert all(b.service_s == model.estimate(b.bucket)
               for b in rt.metrics.batches)
    with pytest.raises(ValueError, match="padder"):
        runtime.ServingRuntime(ex, bat, pad)
    with pytest.raises(ValueError, match="padder"):
        runtime.ServingRuntime(runtime.SimulatedExecutor(model), bat)


def test_binding_executor_refuses_a_batch_without_request_ids():
    """A batch that does not come from the executor's ``pad`` carries no
    request ids, so its scores could not be filed: ``run_batch`` refuses
    it before running anything; a copy of a padded batch keeps its ids."""
    import copy

    import torch

    class Binding:
        calls = 0

        def execute(self, batch):
            Binding.calls += 1
            return torch.as_tensor(batch["x"])

    def pad(reqs, bucket):
        x = np.zeros(bucket.batch, np.float32)
        x[:len(reqs)] = [r.rid + 1 for r in reqs]
        return {"x": x}

    ex = runtime.BindingExecutor(Binding(), pad)
    bucket = batcher.Bucket(4, 4)
    batch = ex.pad([_req(request, i, 0.0) for i in range(3)], bucket)
    with pytest.raises(TypeError, match="PaddedBatch"):
        ex.run_batch(bucket, dict(batch))
    assert Binding.calls == 0 and ex.scores == {}
    ex.run_batch(bucket, copy.copy(batch))
    assert ex.scores == {0: np.float32(1), 1: np.float32(2),
                         2: np.float32(3)}
