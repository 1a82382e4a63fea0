"""Fault injection, degradation and recovery, port against the JAX package.

* The injection vocabulary: ``FailureInjector`` schedules (scheduled
  steps once each, seeded-hash chaos), the straggler watchdog's trips and
  ``run_resilient``'s restarts equal the reference's on the same inputs.
* ``FaultInjectingExecutor``: the same fire sequence (outcome per attempt,
  ``fired``, the corrupted batches and their contents, stalls) over the
  same executor; it forwards ``pad`` and ``scores`` where the wrapped
  executor has them.
* ``corrupt_store`` and ``flip_store_bits`` draw the reference's numbers
  and change the same elements to the same bits, in place.
* ``DegradationController`` reports equal under equal event sequences.
* Runtime summaries (``failed_batches``, ``retries``, ``degradation``,
  ``watchdog`` and every other key) equal the reference's on simulated
  executors, and on real bindings under transient chaos with a pinned
  service model.
* ``corrupt_store(mode='nan')`` -> ``scrub_scores`` -> ``wants_restore``
  -> ``restore`` heals to the clean scores.

The reference's ``test_faults.py::
test_scrub_and_checkpoint_restore_heal_corrupted_store`` depends on the
environment and ``::test_heal_replays_wal_for_post_snapshot_updates`` is
among its ten known failures; the tests here compare values with
reference calls and copy none of their assertions.  Summaries and reports
compare exactly; scores across the packages within 1e-5 (the MLPs'
reduction order differs), within the port bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.pifs import ServeBinding as JServeBinding
from repro.core.pifs import engine_for_tables as jengine_for_tables
from repro.distributed.sharding import make_mesh
from repro.runtime import fault_tolerance as jft
from repro.serving import batcher as jbatcher
from repro.serving import degradation as jdeg
from repro.serving import faults as jfaults
from repro.serving import loadgen as jloadgen
from repro.serving import request as jrequest
from repro.serving import runtime as jruntime

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.core.paging import PageTable
from repro_torch.core.pifs import ServeBinding, engine_for_tables
from repro_torch.launch import serve as srv
from repro_torch.models.dlrm import params_from_numpy
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.serving import batcher, degradation as deg
from repro_torch.serving import faults, loadgen, request, runtime
from repro_torch.serving.request import ArrivalConfig

VOCABS, DIM, PAGE_BYTES, HOT = [300, 200], 16, 512, 0.2


@pytest.fixture(scope="module")
def mesh11():
    return make_mesh((1, 1), ("data", "model"))


# ---------------------------------------------------------------------------
# The injection vocabulary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("at,prob,seed", [((2, 5), 0.0, 0), ((), 0.3, 7),
                                          ((1, 4, 9), 0.1, 123)])
def test_failure_injector_matches_reference(at, prob, seed):
    a = ft.FailureInjector(fail_at_steps=at, fail_prob=prob, seed=seed)
    b = jft.FailureInjector(fail_at_steps=at, fail_prob=prob, seed=seed)
    steps = list(range(60)) + [2, 5, 1]          # a fired step fires once
    assert [a.fires(s) for s in steps] == [b.fires(s) for s in steps]
    assert a.armed == b.armed == bool(at or prob)
    c = ft.FailureInjector(fail_at_steps=(3,))
    c.maybe_fail(2)
    with pytest.raises(ft.SimulatedFailure, match="step 3"):
        c.maybe_fail(3)
    c.maybe_fail(3)
    assert not ft.FailureInjector().armed


def test_straggler_watchdog_matches_reference():
    rng = np.random.default_rng(0)
    dts = list(rng.uniform(0.004, 0.006, 40))
    for i in (5, 17, 18, 30):
        dts[i] = 0.05
    calls = {"port": [], "ref": []}
    w = ft.StragglerWatchdog(
        threshold=3.0, warmup=3,
        on_straggler=lambda *a: calls["port"].append(a))
    jw = jft.StragglerWatchdog(
        threshold=3.0, warmup=3,
        on_straggler=lambda *a: calls["ref"].append(a))
    assert ([w.observe(i, d) for i, d in enumerate(dts)]
            == [jw.observe(i, d) for i, d in enumerate(dts)])
    assert w.events == jw.events and len(w.events) == 4
    assert w.ewma == jw.ewma and calls["port"] == calls["ref"]


def test_run_resilient_matches_reference(tmp_path):
    """A toy training loop with failures at steps 3 and 7 and a checkpoint
    every 2 steps: the same restarts, steps and final metrics, and the
    same final weights."""
    def batches(step):
        return np.full(4, step + 1, np.float32)

    def port_step(state, batch):
        w = state["w"] + torch.as_tensor(batch)
        return {"w": w}, {"sum": float(w.sum())}

    def ref_step(state, batch):
        w = jnp.asarray(state["w"]) + batch
        return {"w": w}, {"sum": float(w.sum())}

    rep = ft.run_resilient(
        port_step, {"w": torch.zeros(4)}, batches, 10,
        Checkpointer(str(tmp_path / "p")), ckpt_every=2,
        injector=ft.FailureInjector(fail_at_steps=(3, 7)),
        watchdog=ft.StragglerWatchdog(), device="cpu")
    jrep = jft.run_resilient(
        ref_step, {"w": np.zeros(4, np.float32)}, batches, 10,
        JCheckpointer(str(tmp_path / "j")), ckpt_every=2,
        injector=jft.FailureInjector(fail_at_steps=(3, 7)),
        watchdog=jft.StragglerWatchdog())
    assert (rep.steps_done, rep.restarts, rep.final_metrics) == (
        jrep.steps_done, jrep.restarts, jrep.final_metrics)
    assert rep.restarts == 2 and rep.final_metrics == {"sum": 220.0}
    np.testing.assert_array_equal(
        Checkpointer(str(tmp_path / "p")).read_leaf("w"),
        JCheckpointer(str(tmp_path / "j")).read_leaf("w"))
    with pytest.raises(ft.SimulatedFailure):
        ft.run_resilient(port_step, {"w": torch.zeros(4)}, batches, 10,
                         Checkpointer(str(tmp_path / "q")), ckpt_every=100,
                         injector=ft.FailureInjector(fail_prob=1.0),
                         max_restarts=2)


# ---------------------------------------------------------------------------
# The fault-injecting executor
# ---------------------------------------------------------------------------

FIRE_CFGS = [
    dict(straggler_at=(1,), straggler_factor=8.0, transient_at=(3,),
         stall_at=(0,), stall_s=0.5),
    dict(transient_at=(0,), transient_runs=3, corrupt_oob_at=(5,),
         corrupt_nan_at=(5, 6)),
    dict(seed=5, transient_prob=0.05, straggler_prob=0.1, stall_prob=0.2,
         corrupt_oob_prob=0.05, corrupt_nan_prob=0.05),
    dict(shard_loss_at=(4,), shard_loss_shard=2, transient_prob=0.03,
         seed=11),
]


def _drive(mod, exe_mod, cfg, n=80):
    model = exe_mod.FixedServiceModel(base_s=1e-3, per_row_s=1e-5)
    fex = mod.FaultInjectingExecutor(
        jruntime.SimulatedExecutor(model) if mod is jfaults
        else runtime.SimulatedExecutor(model), mod.FaultConfig(**cfg))
    rng = np.random.default_rng(3)
    bucket = exe_mod.Bucket(8, 4)
    out, batches = [], []
    for i in range(n):
        batch = {"indices": rng.integers(0, 100, (8, 2, 4)).astype(
            np.int32), "dense": rng.normal(size=(8, 13)).astype(np.float32)}
        seen = []
        fex.inner.run_batch = (lambda b, x, _s=seen, _m=model:
                               (_s.append(x), _m.estimate(b))[1])
        try:
            out.append(("ok", fex.run_batch(bucket, batch)))
        except mod.ShardLossFailure as e:
            out.append(("shard", e.shard))
        except mod.TransientServingFailure:
            out.append(("transient", None))
        batches.append(seen[0] if seen else None)
        if i == 40 and fex.lost_shard is not None:
            fex.on_remesh({})
        if i % 3 == 0:
            out.append(("observe", fex.observe({})))
            out.append(("replan", fex.replan()))
    return fex, out, batches


@pytest.mark.parametrize("cfg", FIRE_CFGS, ids=["sched", "burst", "chaos",
                                                "shard_loss"])
def test_fault_executor_fire_sequences_match_reference(cfg):
    fex, out, bats = _drive(faults, batcher, cfg)
    jfex, jout, jbats = _drive(jfaults, jbatcher, cfg)
    assert out == jout
    assert fex.report() == jfex.report()
    assert fex.corrupted_batches == jfex.corrupted_batches
    for a, b in zip(bats, jbats):
        assert (a is None) == (b is None)
        if a is not None:
            for k in ("indices", "dense"):
                np.testing.assert_array_equal(a[k], b[k])
    assert sum(v for v in fex.report().values()) > 0


def test_fault_executor_forwards_the_padder_and_scores():
    cfg = reduced(get_config("rmc1"))
    b = loadgen.bind_model(cfg, "cpu")
    inner = runtime.BindingExecutor(b, loadgen.make_padder(cfg))
    fex = faults.FaultInjectingExecutor(inner, faults.FaultConfig())
    assert fex.pad == inner.pad and fex.scores is inner.scores
    assert fex.binding is b
    rt = runtime.ServingRuntime(fex, batcher.FixedBatcher(8, cfg.pooling))
    assert rt.padder == inner.pad
    sim = faults.FaultInjectingExecutor(
        runtime.SimulatedExecutor(batcher.ServiceModel()),
        faults.FaultConfig())
    assert getattr(sim, "pad", None) is None and sim.binding is None
    with pytest.raises(ValueError, match="padder"):
        runtime.ServingRuntime(sim, batcher.FixedBatcher(8, 4))


# ---------------------------------------------------------------------------
# Store corruption
# ---------------------------------------------------------------------------


def _bindings(storage, mesh):
    """Reference and port bindings (no model) over the same engine state,
    a planner-placed hot tier."""
    n_shards = dict(mesh.shape)["model"]
    jeng, offs = jengine_for_tables(VOCABS, DIM, mesh, hot_fraction=HOT,
                                    page_bytes=PAGE_BYTES, storage=storage)
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    with mesh:
        ids = np.stack([np.minimum(rng.zipf(1.3, (16, 5)) - 1, v - 1) + o
                        for v, o in zip(VOCABS, offs)], axis=1)
        jstate = jeng.observe(jstate, jnp.asarray(ids, jnp.int32))
        jstate, _ = jeng.plan_and_migrate(jstate)
    eng, _ = engine_for_tables(VOCABS, DIM, device="cpu", hot_fraction=HOT,
                               page_bytes=PAGE_BYTES, storage=storage,
                               n_shards=n_shards)
    state = eng.pack_state(
        *map(np.asarray, jeng.export_state(jstate)),
        table=PageTable(np.asarray(jstate.page_to_shard),
                        np.asarray(jstate.page_to_slot)),
        counts=np.asarray(jstate.counts))
    # the reference's raw tiers, so unmapped slots match too
    state.cold.copy_(torch.as_tensor(np.array(jstate.cold)))
    state.hot.copy_(torch.as_tensor(np.array(jstate.hot)))
    return (JServeBinding(jeng, jstate, None, None),
            ServeBinding(eng, state, None, None))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint8 if x.dtype == np.int8 else np.uint32)


@pytest.mark.parametrize("mode", ["nan", "finite"])
@pytest.mark.parametrize("frac,seed", [(0.25, 0), (1.0, 3), (0.01, 9)])
def test_corrupt_store_touches_the_reference_elements(mode, frac, seed,
                                                      mesh11):
    jb, pb = _bindings("fp32", mesh11)
    hot = pb.state.hot
    ptr = hot.data_ptr()
    with mesh11:
        jn = jfaults.corrupt_store(jb, frac=frac, seed=seed, mode=mode)
    assert faults.corrupt_store(pb, frac=frac, seed=seed, mode=mode) == jn
    assert pb.state.hot.data_ptr() == ptr          # in place
    np.testing.assert_array_equal(_bits(pb.state.hot.numpy()),
                                  _bits(jb.state.hot))
    if mode == "finite":
        assert np.isfinite(pb.state.hot.numpy()).all()
    for mod, b in ((faults, pb), (jfaults, jb)):
        with pytest.raises(ValueError, match="unknown corrupt_store mode"):
            mod.corrupt_store(b, mode="bogus")


@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("meshname", ["mesh11", "mesh1d"])
@pytest.mark.parametrize("tier", ["hot", "cold", "both"])
def test_flip_store_bits_touches_the_reference_elements(storage, meshname,
                                                        tier, request):
    mesh = request.getfixturevalue(meshname)
    jb, pb = _bindings(storage, mesh)
    ptrs = (pb.state.cold.data_ptr(), pb.state.hot.data_ptr())
    for seed, n_rows in ((0, 2), (5, 7), (11, 40)):
        with mesh:
            jpages = jfaults.flip_store_bits(jb, n_rows=n_rows, seed=seed,
                                             tier=tier)
        pages = faults.flip_store_bits(pb, n_rows=n_rows, seed=seed,
                                       tier=tier)
        assert pages == jpages
        for f in ("cold", "hot"):
            np.testing.assert_array_equal(
                _bits(getattr(pb.state, f).numpy()),
                _bits(getattr(jb.state, f)), err_msg=f"{f} seed {seed}")
    assert (pb.state.cold.data_ptr(), pb.state.hot.data_ptr()) == ptrs
    assert np.isfinite(pb.state.hot.numpy()).all()
    with pytest.raises(ValueError, match="unknown tier"):
        faults.flip_store_bits(pb, tier="bogus")


# ---------------------------------------------------------------------------
# The degradation controller
# ---------------------------------------------------------------------------


class _FakeBinding:
    def __init__(self):
        self.checkpointer = object()
        self.can_remesh = True
        self.modes_set = []
        self.last_poisoned = 0

    def set_mode(self, label):
        self.modes_set.append(label)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_controller_reports_match_reference_under_equal_events(seed):
    def make(mod, fmod, qmod):
        fb = _FakeBinding()
        ctrl = mod.DegradationController(
            binding=fb, breaker=mod.BreakerConfig(trip_after=3,
                                                  cooldown_s=0.01),
            ladder=mod.LadderConfig(min_dwell_batches=2, remesh_after=3))
        q = qmod.AdmissionQueue(128)
        ctrl.bind_queue(q)
        return ctrl, fb, q, fmod

    sides = [make(deg, faults, request), make(jdeg, jfaults, jrequest)]
    rng = np.random.default_rng(seed)
    now = 0.0
    for _ in range(300):
        now += float(rng.uniform(0, 0.004))
        ev = int(rng.integers(0, 9))
        shard = int(rng.integers(0, 3))
        res = []
        for ctrl, fb, q, fmod in sides:
            if ev == 0:
                res.append(ctrl.allow_execute(now))
            elif ev == 1:
                ctrl.on_attempt_failure(now, fmod.ShardLossFailure("x",
                                                                   shard))
            elif ev == 2:
                ctrl.on_attempt_failure(now, fmod.TransientServingFailure())
            elif ev == 3:
                ctrl.on_attempt_failure(now)
            elif ev in (4, 5):
                ctrl.on_batch_done(now, ok=ev == 4,
                                   poisoned=int(rng.integers(0, 2))
                                   if False else ev % 2)
            elif ev == 6:
                ctrl.on_straggler(now)
            elif ev == 7:
                ctrl.on_corruption(now)
            elif ev == 8:
                res.append((ctrl.wants_restore, ctrl.wants_remesh))
                if ctrl.wants_remesh:
                    ctrl.note_remeshed(now, {"to_mesh": {"data": 1,
                                                         "model": 2}})
                if ctrl.wants_restore:
                    ctrl.note_restored()
            res.append((ctrl.rung_label, q.capacity))
        assert res[:len(res) // 2] == res[len(res) // 2:]
    (a, fa, _, _), (b, fb, _, _) = sides
    assert a.report() == b.report()
    assert fa.modes_set == fb.modes_set
    assert a.report()["n_transitions"] > 0
    assert deg.RUNGS == jdeg.RUNGS
    assert deg.RetryPolicy().backoff(3) == jdeg.RetryPolicy().backoff(3)


# ---------------------------------------------------------------------------
# Runtime summaries
# ---------------------------------------------------------------------------


def _reqs(mod, n, rate=1000.0, slo=0.05):
    times = np.arange(n) / rate
    return [mod.Request(rid=i, arrival_s=float(times[i]),
                        deadline_s=float(times[i]) + slo, features={},
                        pooling=4) for i in range(n)]


class _Spiky:
    def __init__(self, model):
        self.n = 0

    def run_batch(self, bucket, batch):
        self.n += 1
        return 0.1 if self.n == 10 else 0.004

    def observe(self, batch):
        return 0.0

    def replan(self):
        return 0.0


SCENARIOS = {
    "retry": dict(fault=dict(transient_at=(0,)), n=8),
    "exhausted": dict(fault=dict(transient_at=(0,), transient_runs=3), n=8),
    "breaker": dict(fault=dict(transient_at=(0,), transient_runs=8),
                    breaker=dict(trip_after=4, cooldown_s=0.01), n=40,
                    rate=400.0),
    "closed_loop": dict(fault=dict(transient_at=(0,), transient_runs=3),
                        users=4, n=24),
    "chaos": dict(fault=dict(seed=3, transient_prob=0.1,
                             straggler_prob=0.1, straggler_factor=6.0),
                  n=96, rate=600.0, watchdog=True),
    "ladder": dict(fault=dict(seed=1, transient_prob=0.2, transient_runs=3),
                   n=200,
                   rate=800.0, queue=16),
    "spiky": dict(spiky=True, n=64, watchdog=True),
}


def _sim_run(pkg, sc):
    bmod, rmod, dmod, fmod, qmod, wmod = (
        (batcher, runtime, deg, faults, request, ft) if pkg == "port" else
        (jbatcher, jruntime, jdeg, jfaults, jrequest, jft))
    model = bmod.FixedServiceModel(base_s=4e-3, per_row_s=0.0)
    ctrl = dmod.DegradationController(
        breaker=dmod.BreakerConfig(**sc["breaker"]) if "breaker" in sc
        else None, ladder=dmod.LadderConfig(min_dwell_batches=4))
    inner = (_Spiky(model) if sc.get("spiky")
             else rmod.SimulatedExecutor(model))
    exe = (inner if sc.get("spiky")
           else fmod.FaultInjectingExecutor(inner,
                                            fmod.FaultConfig(**sc["fault"])))
    wd = wmod.StragglerWatchdog(threshold=4.0, warmup=2) \
        if sc.get("watchdog") else None
    rt = rmod.ServingRuntime(
        exe, bmod.FixedBatcher(batch=4, pooling=4),
        padder=lambda reqs, bucket: {"n": len(reqs)},
        cfg=rmod.RuntimeConfig(observe_every=0, replan_every=0,
                               queue_capacity=sc.get("queue", 4096)),
        service_model=model, controller=ctrl, watchdog=wd)
    if sc.get("users"):
        def factory(rid, user, t):
            return qmod.Request(rid=rid, arrival_s=t, deadline_s=t + 0.05,
                                features={}, pooling=4)
        src = rmod.ClosedLoopSource(sc["users"], sc["n"], factory,
                                    think_time_s=0.001)
    else:
        src = rmod.OpenLoopSource(_reqs(qmod, sc["n"],
                                        rate=sc.get("rate", 1000.0)))
    return rt.run(src)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_simulated_runtime_summaries_match_reference(name):
    sc = SCENARIOS[name]
    s, js = _sim_run("port", sc), _sim_run("ref", sc)
    assert s == js
    assert s["served"] + s["failed"] + s["dropped"] == sc["n"]
    assert "degradation" in s and "failed_batches" in s
    assert ("watchdog" in s) == bool(sc.get("watchdog"))
    if name in ("exhausted", "closed_loop"):
        assert s["failed_batches"] >= 1 and s["failed"] > 0
    if name == "breaker":
        assert s["failed_fast"] > 0 and s["degradation"]["breaker_trips"] > 0
    if name == "ladder":
        assert s["degradation"]["n_transitions"] > 0
    if name == "spiky":
        assert s["watchdog"]["trips"] == 1
        assert s["degradation"]["straggler_trips"] == 1


SIZES, N = (8, 16), 64
SVC = dict(base_s=4e-3, per_row_s=2.5e-4)


class _RefPinned(jruntime.BindingExecutor):
    """The reference binding's pinned executor: scores by rid, service
    times from the model."""

    def __init__(self, binding, padder, service):
        super().__init__(binding)
        self._pad, self.service = padder, service
        self.scores, self._rids = {}, []

    def padder(self, reqs, bucket):
        self._rids = [r.rid for r in reqs]
        return self._pad(reqs, bucket)

    def run_batch(self, bucket, batch):
        out = np.asarray(self.binding.execute(batch))
        self.scores.update(zip(self._rids, out[:len(self._rids)]))
        return self.service.estimate(bucket)


def _trace(rt):
    return [(b.t, b.bucket.batch, b.bucket.pooling, b.n_real, b.service_s)
            for b in rt.metrics.batches]


def test_binding_runtime_under_transient_chaos_matches_reference(mesh11):
    """Both packages' runtimes over real bindings (every rung warmed, the
    score scrub on) with transient chaos and a 4-batch-dwell ladder, one
    pinned service model: identical flush traces, failures, retries and
    degradation reports; scores within 1e-5; no new signature."""
    jcfg, cfg = jreduced(jget_config("rmc1")), reduced(get_config("rmc1"))
    fcfg = dict(transient_at=(1,), transient_prob=0.2, transient_runs=3,
                seed=5)
    ladder = dict(min_dwell_batches=4)
    breaker = dict(trip_after=5, cooldown_s=0.02)
    maint = dict(observe_every=4, replan_every=0)
    load = dict(n_requests=N, slo_ms=200.0, seed=2)

    jb = jloadgen.bind_model(jcfg, mesh11, degraded_variants=True,
                             scrub_scores=True)
    svc = jbatcher.FixedServiceModel(**SVC)
    ex = _RefPinned(jb, jloadgen.make_padder(jcfg), svc)
    jctrl = jdeg.DegradationController(
        binding=jb, breaker=jdeg.BreakerConfig(**breaker),
        ladder=jdeg.LadderConfig(**ladder))
    jrt = jruntime.ServingRuntime(
        ex, jbatcher.DynamicBatcher(jbatcher.BatcherConfig(
            batch_sizes=SIZES, poolings=(jcfg.pooling,), max_wait_ms=25.0)),
        ex.padder, jruntime.RuntimeConfig(**maint), service_model=svc,
        controller=jctrl)
    jstate0 = jb.state
    with mesh11:
        for rung in jb.modes():
            jb.set_mode(rung)
            jrt.warmup(jloadgen.dummy_request_factory(jcfg))
        jb.set_mode("full")
        jrt.executor = jfaults.FaultInjectingExecutor(
            ex, jfaults.FaultConfig(**fcfg))
        js = jrt.run(jruntime.OpenLoopSource(jloadgen.request_stream(
            jcfg, jloadgen.LoadConfig(arrival=jrequest.ArrivalConfig(
                rate_qps=400.0, seed=2), **load))))

    rt, pb = srv.build_serving(
        cfg, "cpu", batch_sizes=SIZES, slo_ms=50.0,
        runtime_cfg=runtime.RuntimeConfig(**maint),
        service=batcher.FixedServiceModel(**SVC), elastic=True)
    pb.model.load_state_dict(params_from_numpy(
        jax.tree.map(np.asarray, jb.params)))
    pb.state = pb.engine.pack_state(
        *map(np.asarray, jb.engine.export_state(jstate0)),
        table=PageTable(np.asarray(jstate0.page_to_shard),
                        np.asarray(jstate0.page_to_slot)),
        counts=np.asarray(jstate0.counts))
    rt.controller = deg.DegradationController(
        binding=pb, breaker=deg.BreakerConfig(**breaker),
        ladder=deg.LadderConfig(**ladder))
    s = srv.run_offered_load(
        rt, pb, cfg, loadgen.LoadConfig(arrival=ArrivalConfig(
            rate_qps=400.0, seed=2), **load),
        faults=faults.FaultConfig(**fcfg))
    assert _trace(rt) == _trace(jrt)
    for k in ("served", "failed", "failed_fast", "retries", "failed_batches",
              "availability", "p99_ms", "degradation"):
        assert s[k] == js[k], k
    assert s["failed_batches"] >= 1 and s["retries"] >= 1
    assert s["steady_traces"] == 0 and s["served"] + s["failed"] == N
    assert s["faults_fired"] == jrt.executor.report()
    served = sorted(k for k in rt.executor.scores if k >= 0)
    assert served == sorted(k for k in ex.scores if k >= 0)
    np.testing.assert_allclose([rt.executor.scores[i] for i in served],
                               [ex.scores[i] for i in served],
                               rtol=1e-5, atol=1e-5)


def test_nan_store_heals_through_scrub_scores_and_restore(mesh11, tmp_path):
    """A NaN hot tier poisons the scores (scrubbed to 0, counted), two
    poisoned batches make the controller want a restore, and ``restore``
    heals to the clean scores -- as in the reference."""
    jcfg, cfg = jreduced(jget_config("rmc1")), reduced(get_config("rmc1"))
    rng = np.random.default_rng(0)
    batch = {"dense": rng.normal(size=(8, cfg.n_dense)).astype(np.float32),
             "indices": rng.integers(0, cfg.emb_num, (8, cfg.n_tables,
                                                      cfg.pooling)
                                     ).astype(np.int32),
             "weights": np.ones((8, cfg.n_tables, cfg.pooling), np.float32)}
    jb = jloadgen.bind_model(jcfg, mesh11, scrub_scores=True)
    with mesh11:
        jb.observe(batch)
        jb.replan()
    pb = loadgen.bind_model(cfg, "cpu", scrub_scores=True)
    pb.model.load_state_dict(params_from_numpy(
        jax.tree.map(np.asarray, jb.params)))
    js = jb.state
    pb.state = pb.engine.pack_state(
        *map(np.asarray, jb.engine.export_state(js)),
        table=PageTable(np.asarray(js.page_to_shard),
                        np.asarray(js.page_to_slot)),
        counts=np.asarray(js.counts))
    out = {}
    for name, b, mod, dmod, ck in (
            ("port", pb, faults, deg, Checkpointer),
            ("ref", jb, jfaults, jdeg, JCheckpointer)):
        with mesh11:
            clean = np.asarray(b.execute(batch)).copy()
            b.attach_checkpointer(ck(str(tmp_path / name)))
            b.reset_plan_stats()
            ctrl = dmod.DegradationController(binding=b)
            assert mod.corrupt_store(b, frac=1.0, seed=1, mode="nan") > 0
            poisoned = []
            while not ctrl.wants_restore:
                poisoned.append(np.asarray(b.execute(batch)).copy())
                ctrl.on_batch_done(0.0, ok=True, poisoned=b.last_poisoned)
            b.restore()
            ctrl.note_restored()
            healed = np.asarray(b.execute(batch)).copy()
        out[name] = (clean, poisoned, healed, b.poisoned_rows,
                     b.poisoned_batches, ctrl.report()["restores"])
    clean, poisoned, healed, rows, nb, restores = out["port"]
    np.testing.assert_array_equal(healed, clean)
    assert len(poisoned) == 2 and nb == 2 and rows > 0 and restores == 1
    assert all(np.isfinite(p).all() for p in poisoned)
    assert pb.plan_stats()["traces"] == 0
    jclean, jpoisoned, jhealed, jrows, jnb, jrestores = out["ref"]
    assert (rows, nb, restores) == (jrows, jnb, jrestores)
    np.testing.assert_allclose(healed, jhealed, rtol=1e-5, atol=1e-5)
    for a, b in zip(poisoned, jpoisoned):
        assert ((a == 0) == (b == 0)).all()
