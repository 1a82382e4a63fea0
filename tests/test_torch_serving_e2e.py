"""The port's serving runtime end to end on the CPU: ``ServingRuntime`` +
``ServeBinding`` against the JAX package's, and the port's own serving
invariants (reduced RMC1, buckets of batch 8 and 16 at pooling 4 and 8).

Across the packages the reference's ``bind_model`` on a (1, 1) CPU mesh is
the source of truth: its params cross with ``params_from_numpy`` and its
state with ``export_state`` / ``pack_state``, then each package's runtime
drives its own binding through an executor whose service times are pinned
to one ``FixedServiceModel``.  Flush traces must be identical and
per-request scores equal within 1e-5 (rtol and atol, as in
``test_torch_dlrm.py::test_serve_step_matches_reference``): lookups are
bitwise equal at serving's 0/1 weights, but the interaction dots and the
MLPs reduce in different orders, and with maintenance on the two planners
break ties apart (the port by the lowest page id), so a many-id bag that
mixes tiers may differ in its last bit (``ROADMAP.md``, decisions of the
second slice).

Three of the reference's end-to-end serving tests
(``tests/test_serving.py::test_end_to_end_serving_zero_steady_retraces``,
``..._dedup_matches_off[on]``, ``..._front_end_fused_matches_split``) are
among its known ten failures (``ROADMAP.md`` queue 3).  The port-only
checks below are the port's own, held on the port alone; none is copied
from those tests.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.distributed.sharding import make_mesh
from repro.serving import batcher as jbatcher
from repro.serving import loadgen as jloadgen
from repro.serving import request as jrequest
from repro.serving import runtime as jruntime

from repro_torch.configs import get_config, reduced
from repro_torch.core.paging import PageTable
from repro_torch.launch import serve as srv
from repro_torch.models.dlrm import params_from_numpy
from repro_torch.serving import batcher, loadgen
from repro_torch.serving.request import ArrivalConfig
from repro_torch.serving.runtime import (OpenLoopSource, RuntimeConfig,
                                         ServingRuntime)

SIZES, POOLINGS, SLO_MS, N = (8, 16), (4, 8), 50.0, 48
SVC = dict(base_s=4e-3, per_row_s=2.5e-4)


@pytest.fixture(scope="module")
def mesh11():
    return make_mesh((1, 1), ("data", "model"))


def _cfgs():
    return jreduced(jget_config("rmc1")), reduced(get_config("rmc1"))


def _load(mod, arrival_cls, storage="fp32", front_end="split", dedup="off",
          qps=200.0, seed=2):
    return mod.LoadConfig(n_requests=N,
                          arrival=arrival_cls(rate_qps=qps, seed=seed),
                          slo_ms=SLO_MS, poolings=POOLINGS, seed=seed,
                          storage=storage, front_end=front_end, dedup=dedup)


def _maint(on: bool):
    return dict(observe_every=2, replan_every=4) if on else \
        dict(observe_every=0, replan_every=0)


class _RefPinned(jruntime.BindingExecutor):
    """The reference binding's pinned counterpart of the port's
    ``BindingExecutor`` with a service model: scores kept by rid, service
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


def _ref_serve(jb, jstate0, jcfg, load, maint, mesh):
    jb.state = jstate0
    svc = jbatcher.FixedServiceModel(**SVC)
    ex = _RefPinned(jb, jloadgen.make_padder(jcfg), svc)
    rt = jruntime.ServingRuntime(
        ex, jbatcher.DynamicBatcher(jbatcher.BatcherConfig(
            batch_sizes=SIZES, poolings=POOLINGS, max_wait_ms=SLO_MS / 2)),
        ex.padder, jruntime.RuntimeConfig(**_maint(maint)),
        service_model=svc)
    with mesh:
        rt.warmup(jloadgen.dummy_request_factory(jcfg, storage=load.storage))
        jb.reset_plan_stats()
        jb.dedup_stats.clear()
        s = rt.run(jruntime.OpenLoopSource(jloadgen.request_stream(jcfg,
                                                                   load)))
    return rt, s, ex.scores


def _carry(pb, jb):
    """The reference binding's params and state into the port's binding."""
    pb.model.load_state_dict(params_from_numpy(
        jax.tree.map(np.asarray, jb.params)))
    st = jb.state
    pb.state = pb.engine.pack_state(
        *map(np.asarray, jb.engine.export_state(st)),
        table=PageTable(np.asarray(st.page_to_shard),
                        np.asarray(st.page_to_slot)),
        counts=np.asarray(st.counts))


def _port_serve(cfg, load, maint, carry_from=None, **kw):
    rt, pb = srv.build_serving(
        cfg, "cpu", batch_sizes=SIZES, poolings=POOLINGS, slo_ms=SLO_MS,
        storage=load.storage, dedup=load.dedup, front_end=load.front_end,
        runtime_cfg=RuntimeConfig(**_maint(maint)),
        service=batcher.FixedServiceModel(**SVC), **kw)
    if carry_from is not None:
        _carry(pb, carry_from)
    s = srv.run_offered_load(rt, pb, cfg, load)
    return rt, pb, s


@pytest.mark.parametrize("front_end", ["split", "fused"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_runtime_and_binding_match_the_reference(storage, front_end,
                                                 mesh11):
    """The two packages' runtimes over their own bindings, maintenance off
    and on (observe every 2 batches, re-plan every 4): identical flush
    traces, scores within 1e-5, every request served once, no signature
    new after warmup, the same re-plan count."""
    jcfg, cfg = _cfgs()
    jb = jloadgen.bind_model(jcfg, mesh11, storage=storage,
                             front_end=front_end)
    jstate0 = jb.state
    for maint in (False, True):
        jrt, js, jscores = _ref_serve(
            jb, jstate0, jcfg, _load(jloadgen, jrequest.ArrivalConfig,
                                     storage, front_end), maint, mesh11)
        jb.state = jstate0
        prt, pb, ps = _port_serve(
            cfg, _load(loadgen, ArrivalConfig, storage, front_end), maint,
            carry_from=jb)
        tag = f"{storage} {front_end} maintenance={maint}"
        assert _trace(prt) == _trace(jrt), tag
        assert len({b.bucket for b in prt.metrics.batches}) >= 3, tag
        assert ps["served"] == js["served"] == N, tag
        assert ps["replans"] == (js["batches"] // 4 if maint else 0), tag
        assert ps["steady_traces"] == 0, tag
        for key in ("bucket_mix", "p50_ms", "p99_ms", "queue_wait_p99_ms",
                    "batch_occupancy_mean", "maintenance_calls"):
            assert ps[key] == js[key], (tag, key)
        got = np.asarray([prt.executor.scores[i] for i in range(N)])
        want = np.asarray([jscores[i] for i in range(N)])
        assert np.isfinite(got).all() and ((got > 0) & (got < 1)).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=tag)
        recs = pb.plan_stats()["front_end"].values()   # one per bucket
        assert [r["resolved"] for r in recs] == (
            [] if front_end == "split"
            else ["fused"] * (len(SIZES) * len(POOLINGS))), tag


def _port_scores(rt):
    return np.asarray([rt.executor.scores[i] for i in range(N)], np.float32)


@pytest.mark.parametrize("front_end", ["split", "fused"])
def test_dedup_on_and_auto_equal_off_bitwise(front_end):
    """Through the maintenance cadence and a pinned flush sequence, dedup
    on and auto serve the stream with scores bitwise equal to off, and the
    resolution records say so."""
    _, cfg = _cfgs()
    runs = {d: _port_serve(cfg, _load(loadgen, ArrivalConfig,
                                      storage="int8", front_end=front_end,
                                      dedup=d), True)
            for d in ("off", "on", "auto")}
    base = _port_scores(runs["off"][0])
    for d in ("on", "auto"):
        rt, pb, s = runs[d]
        assert _trace(rt) == _trace(runs["off"][0])
        np.testing.assert_array_equal(_port_scores(rt), base)
        recs = pb.plan_stats()["dedup"]
        assert recs and all(r["requested"] == d for r in recs.values())
        assert s["steady_traces"] == 0
    assert any(r["resolved"] for r in runs["on"][1].plan_stats()["dedup"]
               .values())


def _batch(cfg, storage, seed=3, B=8):
    load = _load(loadgen, ArrivalConfig, storage, seed=seed)
    reqs = loadgen.request_stream(cfg, load)[:B - 2]     # 2 rows of padding
    return loadgen.make_padder(cfg)(reqs, batcher.Bucket(B, 8))


def test_degraded_rungs_match_the_reference(mesh11):
    """Each brown-out rung, port against the reference's rung on one padded
    batch (within 1e-5), and within the port: split_fe and no_dedup equal
    full bitwise, hot_only (cold rows zero-filled) differs from it."""
    jcfg, cfg = _cfgs()
    kw = dict(storage="int8", front_end="fused", dedup="on",
              degraded_variants=True)
    jb = jloadgen.bind_model(jcfg, mesh11, **kw)
    with mesh11:       # place a hot tier so hot_only has rows to read
        for r in jloadgen.request_stream(jcfg, _load(
                jloadgen, jrequest.ArrivalConfig, "int8"))[:16]:
            jb.observe({"indices": r.features["indices"][None]})
        jb.replan()
    pb = loadgen.bind_model(cfg, "cpu", **kw)
    _carry(pb, jb)
    assert pb.modes() == jb.modes() == ("full", "split_fe", "no_dedup",
                                        "hot_only", "shed")
    batch = _batch(cfg, "int8")
    got, want = {}, {}
    for rung in pb.modes():
        pb.set_mode(rung)
        jb.set_mode(rung)
        got[rung] = pb.execute(batch).numpy()
        with mesh11:
            want[rung] = np.asarray(jb.execute(batch))
        np.testing.assert_allclose(got[rung], want[rung], rtol=1e-5,
                                   atol=1e-5, err_msg=rung)
    for rung in ("split_fe", "no_dedup"):
        np.testing.assert_array_equal(got[rung], got["full"])
    assert not np.array_equal(got["hot_only"], got["full"])
    np.testing.assert_array_equal(got["shed"], got["hot_only"])
    pb.set_mode("no-such-rung")
    assert pb.active == "full"


def test_execute_guards_match_the_reference(mesh11):
    """``validate_ids`` raises in ``execute`` on an out-of-range id before
    the step runs, as the reference's does (without it the clamped row is
    served); ``scrub_scores`` zeroes a NaN score and counts it, as the
    reference's does."""
    jcfg, cfg = _cfgs()
    jb = jloadgen.bind_model(jcfg, mesh11, validate_ids=True,
                             scrub_scores=True)
    pb = loadgen.bind_model(cfg, "cpu", validate_ids=True, scrub_scores=True)
    _carry(pb, jb)
    rows = pb.engine.cfg.padded_rows
    for bad in (rows, -1):
        batch = _batch(cfg, "fp32")
        batch["indices"][1, 2, 3] = bad
        with pytest.raises(ValueError, match="validate_ids"):
            pb.execute(batch)
        with pytest.raises(ValueError, match="validate_ids"), mesh11:
            jb.execute(batch)
        pb.validate_ids = False
        assert torch.isfinite(pb.execute(batch)).all()
        pb.validate_ids = True
    batch = _batch(cfg, "fp32")
    batch["dense"][2, 0] = np.nan
    got = pb.execute(batch).numpy()
    with mesh11:
        want = np.asarray(jb.execute(batch))
    assert pb.last_poisoned == jb.last_poisoned == 1
    assert (pb.poisoned_rows, pb.poisoned_batches) == (1, 1)
    assert got[2] == want[2] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_warmup_that_skips_a_bucket_counts_traces():
    """A runtime warmed over buckets of batch 8 only, serving a stream that
    also flushes batch-16 buckets, sees new signatures after warmup
    (``plan_stats()['traces']`` > 0); warmed over both, none.  A reset with
    ``clear_plans`` forgets the signatures seen."""
    _, cfg = _cfgs()
    load = _load(loadgen, ArrivalConfig, qps=2000.0)
    rt, pb = srv.build_serving(cfg, "cpu", batch_sizes=SIZES,
                               poolings=POOLINGS, slo_ms=SLO_MS,
                               service=batcher.FixedServiceModel(**SVC))
    warm8 = ServingRuntime(rt.executor, batcher.DynamicBatcher(
        batcher.BatcherConfig(batch_sizes=(8,), poolings=POOLINGS)))
    warm8.warmup(loadgen.dummy_request_factory(cfg))
    assert pb.plan_stats()["traces"] == pb.plan_stats()["plans"] == 2
    pb.reset_plan_stats()
    assert pb.plan_stats()["traces"] == 0
    s = rt.run(OpenLoopSource(loadgen.request_stream(cfg, load)))
    used16 = {k for k in s["bucket_mix"] if k.startswith("16x")}
    assert used16 and pb.plan_stats()["traces"] == len(used16)
    pb.engine.reset_plan_stats(clear_plans=True)
    assert pb.plan_stats()["plans"] == 0
    full = srv.serve_offered_load(cfg, load, device="cpu", batch_sizes=SIZES)
    assert full["steady_traces"] == 0 and full["plans"] == 4


@pytest.mark.parametrize("users", [0, 12], ids=["open", "closed"])
def test_serve_offered_load_on_cpu(users):
    """serve_offered_load on the CPU, open loop and closed loop: every
    request served, none dropped, no signature new after warmup, re-plans
    taken on the cadence, the observe-cadence dedup probe recorded per
    bucket, and a warmup service time per bucket; with an update stream,
    batches applied and staleness sampled at every boundary; the scrub and
    mesh-fault regimes run (tests/test_torch_scrub.py and
    tests/test_torch_elastic.py hold them to the reference)."""
    _, cfg = _cfgs()
    load = _load(loadgen, ArrivalConfig, storage="int8", front_end="fused")
    out = srv.serve_offered_load(
        cfg, load, device="cpu", batch_sizes=SIZES, closed_loop_users=users,
        runtime_cfg=RuntimeConfig(observe_every=2, replan_every=4))
    assert out["served"] == N and out["dropped"] == out["failed"] == 0
    assert out["steady_traces"] == 0 and out["replans"] >= 1
    assert out["dedup_factors"]
    assert all(r["factor"] >= 1.0 and r["batches"] >= 1
               for r in out["dedup_factors"].values())
    assert set(out["warmup_service_ms"]) == {
        f"{b}x{l}" for b in SIZES for l in POOLINGS}
    assert out["p99.9_ms"] >= out["p99_ms"] >= out["p50_ms"] > 0
    scrubbed = srv.serve_offered_load(cfg, load, device="cpu",
                                      batch_sizes=SIZES, scrub=True,
                                      closed_loop_users=users)
    assert scrubbed["served"] == N and scrubbed["steady_traces"] == 0
    assert scrubbed["scrub_run"]["cycles"] == scrubbed["batches"]
    assert scrubbed["scrub_run"]["pages_detected"] == 0
    meshed = srv.serve_offered_load(cfg, load, device="cpu",
                                    batch_sizes=SIZES, mesh_faults=True,
                                    n_shards=4, closed_loop_users=users)
    assert meshed["served"] + meshed["failed"] == N
    assert meshed["remeshes"] == 1 and meshed["steady_traces"] == 0
    # streaming updates run: every generated batch due in the horizon is
    # applied, and staleness is sampled at every batch boundary
    up = srv.serve_offered_load(
        cfg, dataclasses.replace(load, update_qps=400.0, update_batch=16),
        device="cpu", batch_sizes=SIZES, closed_loop_users=users)
    assert up["served"] == N and up["steady_traces"] == 0
    assert up["updates"]["applied_batches"] > 0
    assert up["staleness"]["samples"] == up["batches"]
