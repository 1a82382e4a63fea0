"""The elastic re-mesh, port against the JAX package.

One card holds every shard of the port's engine, so a re-mesh changes the
engine's ``n_shards`` (the reference's tp axis); the event records the
reference's ``from_mesh`` / ``to_mesh``.

* ``scale_plan`` and ``validate_mesh_for`` equal the reference's.
* A 4 -> 2 -> 4 round trip is the identity on the export triple, bitwise,
  fp32 and int8.
* After ``remesh_engine`` 4 -> 2, the dense table equals the reference's
  re-meshed one and lookups at 0/1 weights equal the reference's bitwise
  (split, and the fused front end, which resolves ``fused_tp`` at tp 2).
* The serving runtime under a shard loss (both packages, one pinned
  service model): the same flush trace, failures and degradation report,
  the same ``remesh`` event less its wall-clock MTTR; no new signature in
  the port; post-re-mesh scores on fixed batches equal a fresh 2-shard
  binding packed from the same export, bitwise.
* ``_check_restore_extra`` sends a snapshot of another shard count (or
  storage) to the elastic path, for the port's snapshots and the
  reference's.
* ``serve_offered_load(mesh_faults=True)`` on the CPU.

The reference's ``test_faults.py::
test_serving_survives_shard_loss_with_elastic_remesh`` is among its ten
known failures; the runtime test here compares values with the
reference's run and copies none of its assertions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.pifs import engine_for_tables as jengine_for_tables
from repro.distributed.sharding import make_mesh
from repro.runtime import elastic as jelastic
from repro.runtime import fault_tolerance as jft
from repro.serving import batcher as jbatcher
from repro.serving import degradation as jdeg
from repro.serving import faults as jfaults
from repro.serving import loadgen as jloadgen
from repro.serving import request as jrequest
from repro.serving import runtime as jruntime

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.core.paging import HOT_SHARD, PageTable
from repro_torch.core.pifs import engine_for_tables
from repro_torch.launch import serve as srv
from repro_torch.models.dlrm import params_from_numpy
from repro_torch.runtime import elastic
from repro_torch.serving import batcher, loadgen
from repro_torch.serving.batcher import Bucket
from repro_torch.serving.faults import FaultConfig
from repro_torch.serving.request import ArrivalConfig
from repro_torch.serving.runtime import RuntimeConfig

VOCABS, DIM, PAGE_BYTES, HOT = [300, 200], 16, 512, 0.2


def test_scale_plan_and_validate_mesh_for_match_reference():
    for n in range(1, 17):
        for tp in (1, 2, 4, 8, 16):
            for granule in (0, 8, 6, 1):
                assert (elastic.scale_plan(n, tp, granule)
                        == jelastic.scale_plan(n, tp, granule)), (n, tp,
                                                                  granule)
    assert elastic.scale_plan(3, 2, 8) == ((1, 2), ("data", "model"))
    names = ("data", "model")
    for shape, div in (((2, 4), {"model": 64, "data": 8}),
                       ((3, 4), {"data": 8}), ((1, 5), {"model": 64})):
        outcomes = []
        for mod in (elastic, jelastic):
            try:
                mod.validate_mesh_for(shape, names, div)
                outcomes.append(None)
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1]
    with pytest.raises(ValueError, match="does not divide"):
        elastic.validate_mesh_for((3, 4), names, {"data": 8})


def _carried(storage, mesh):
    """A JAX engine on ``mesh`` with planner-placed hot pages and the port
    engine (n_shards = the mesh's tp) holding the same state."""
    n_shards = dict(mesh.shape)["model"]
    jeng, offs = jengine_for_tables(VOCABS, DIM, mesh, hot_fraction=HOT,
                                    page_bytes=PAGE_BYTES, storage=storage)
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    with mesh:
        for _ in range(3):
            ids = np.stack([np.minimum(rng.zipf(1.3, (8, 5)) - 1, v - 1) + o
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
    return jeng, jstate, eng, state, offs


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_remesh_round_trip_is_the_identity(storage, mesh1d):
    _, _, eng, state, _ = _carried(storage, mesh1d)
    want = [x.clone() for x in eng.export_state(state)]
    e2, s2 = elastic.remesh_engine(eng, 2, state)
    assert e2.cfg.n_shards == 2 and e2.cfg.num_pages == eng.cfg.num_pages
    assert s2.cold.shape[0] == 2 * e2.cfg.rows_per_shard
    e4, s4 = elastic.remesh_engine(e2, 4, s2)
    for a, b, c in zip(e2.export_state(s2), e4.export_state(s4), want):
        assert torch.equal(a, c) and torch.equal(b, c)
    assert torch.equal(s4.counts, state.counts)
    assert (e4.default_dedup, e4.validate_ids, e4.dedup_auto_hint) == (
        eng.default_dedup, eng.validate_ids, eng.dedup_auto_hint)


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_remesh_lookups_match_reference(storage, mesh1d):
    jeng, jstate, eng, state, offs = _carried(storage, mesh1d)
    mesh2 = make_mesh((1, 2), ("data", "model"))
    jeng2, jstate2 = jelastic.remesh_engine(jeng, mesh2, jstate)
    eng2, state2 = elastic.remesh_engine(eng, 2, state)
    assert eng2.cfg == dataclasses.replace(eng.cfg, n_shards=2)
    with mesh2:
        jdense = np.asarray(jeng2.to_dense(jstate2))
    np.testing.assert_array_equal(eng2.to_dense(state2).numpy(), jdense)
    jhot = np.asarray(jstate2.page_to_shard) == HOT_SHARD
    np.testing.assert_array_equal(
        state2.page_to_shard.numpy() == HOT_SHARD, jhot)
    rng = np.random.default_rng(7)
    B, L = 16, 5
    idx = np.stack([rng.integers(0, v, (B, L)) + o
                    for v, o in zip(VOCABS, offs)], axis=1).astype(np.int32)
    w = (rng.random((B, 2, L)) < 0.8).astype(np.float32)
    x = rng.normal(size=(B, DIM)).astype(np.float32)
    with mesh2:
        want = np.asarray(jeng2.lookup(jstate2, jnp.asarray(idx),
                                       jnp.asarray(w)))
        want_i = np.asarray(jeng2.lookup_interact(
            jstate2, jnp.asarray(idx), jnp.asarray(x), jnp.asarray(w),
            front_end="fused"))
    ti, tw, tx = map(torch.as_tensor, (idx, w, x))
    np.testing.assert_array_equal(eng2.lookup(state2, ti, tw).numpy(), want)
    got_i = eng2.lookup_interact(state2, ti, tx, tw, front_end="fused")
    np.testing.assert_allclose(got_i.numpy(), want_i, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        got_i.numpy(), eng2.lookup_interact(state2, ti, tx, tw).numpy())
    recs = [r for r in eng2.plan_stats()["front_end"].values()
            if r["requested"] == "fused"]
    assert len(recs) == 1
    assert recs[0]["resolved"] == "fused_tp" and recs[0]["tp"] == 2


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_shard_loss_remesh_in_the_runtime_matches_reference(storage,
                                                            mesh1d):
    jcfg, cfg = jreduced(jget_config("rmc1")), reduced(get_config("rmc1"))
    maint = dict(observe_every=4, replan_every=8)
    load = dict(n_requests=N, slo_ms=500.0, seed=2, storage=storage,
                front_end="fused")
    fcfg = dict(seed=13, shard_loss_at=(2,))

    jb = jloadgen.bind_model(jcfg, mesh1d, storage=storage,
                             front_end="fused", degraded_variants=True,
                             scrub_scores=True, elastic=True, prefer_tp=2)
    with mesh1d:        # before the run: the re-mesh replaces jb.engine
        triple0 = [np.asarray(x) for x in jb.engine.export_state(jb.state)]
    table0 = PageTable(np.asarray(jb.state.page_to_shard),
                       np.asarray(jb.state.page_to_slot))
    counts0 = np.asarray(jb.state.counts)
    svc = jbatcher.FixedServiceModel(**SVC)
    ex = _RefPinned(jb, jloadgen.make_padder(jcfg), svc)
    jrt = jruntime.ServingRuntime(
        ex, jbatcher.DynamicBatcher(jbatcher.BatcherConfig(
            batch_sizes=SIZES, poolings=(jcfg.pooling,), max_wait_ms=25.0)),
        ex.padder, jruntime.RuntimeConfig(**maint), service_model=svc,
        controller=jdeg.DegradationController(
            binding=jb, retry=jdeg.RetryPolicy(max_attempts=3),
            breaker=jdeg.BreakerConfig(trip_after=6, cooldown_s=0.02),
            ladder=jdeg.LadderConfig(min_dwell_batches=4, remesh_after=3)),
        watchdog=jft.StragglerWatchdog(threshold=4.0, warmup=4))
    factory = jloadgen.dummy_request_factory(jcfg, storage=storage)
    with mesh1d:
        for rung in jb.modes():
            jb.set_mode(rung)
            jrt.warmup(factory)
        jb.set_mode("full")
        jrt.executor = jfaults.FaultInjectingExecutor(
            ex, jfaults.FaultConfig(**fcfg), idx_key=jb.idx_key)
        js = jrt.run(jruntime.OpenLoopSource(jloadgen.request_stream(
            jcfg, jloadgen.LoadConfig(arrival=jrequest.ArrivalConfig(
                rate_qps=400.0, seed=2), **load))))

    rt, pb = srv.build_serving(
        cfg, "cpu", batch_sizes=SIZES, slo_ms=50.0, storage=storage,
        front_end="fused", runtime_cfg=RuntimeConfig(**maint),
        service=batcher.FixedServiceModel(**SVC), n_shards=4, elastic=True,
        prefer_tp=2)
    pb.model.load_state_dict(params_from_numpy(
        jax.tree.map(np.asarray, jb.params)))
    pb.state = pb.engine.pack_state(*triple0, table=table0, counts=counts0)
    srv.arm_mesh_faults(rt, pb)
    s = srv.run_offered_load(
        rt, pb, cfg, loadgen.LoadConfig(arrival=ArrivalConfig(
            rate_qps=400.0, seed=2), **load), faults=FaultConfig(**fcfg))

    assert _trace(rt) == _trace(jrt)
    rec = {k: v for k, v in s["remesh"].items() if k != "mttr_s"}
    jrec = {k: v for k, v in js["remesh"].items() if k != "mttr_s"}
    jrec["from_mesh"], jrec["to_mesh"] = (dict(jrec["from_mesh"]),
                                          dict(jrec["to_mesh"]))
    assert rec == jrec
    assert rec["from_mesh"] == {"data": 1, "model": 4}
    assert rec["to_mesh"] == {"data": 1, "model": 2} and rec["lost_shard"] == 3
    assert s["remesh"]["mttr_s"] > 0
    for k in ("served", "failed", "failed_batches", "retries",
              "degradation", "availability"):
        assert s[k] == js[k], k
    assert s["watchdog"]["trips"] == js["watchdog"]["trips"]
    assert s["faults_fired"] == jrt.executor.report()
    assert s["faults_fired"]["shard_loss"] >= 3
    assert s["remeshes"] == pb.remeshes == 1
    assert s["steady_traces"] == 0 and s["served"] + s["failed"] == N
    assert pb.engine.cfg.n_shards == 2 and rt.executor.lost_shard is None
    recs = [r for r in pb.engine.plan_stats()["front_end"].values()
            if r["requested"] == "fused"]
    assert recs and all(r["resolved"] == "fused_tp" and r["tp"] == 2
                        for r in recs)
    served = sorted(k for k in rt.executor.scores if k >= 0)
    assert len(served) == s["served"]
    # _RefPinned keys scores by the rids of the last padded batch, and the
    # re-warm pads its own between a batch and its retry: compare on the
    # requests it kept
    common = sorted(k for k in ex.scores if k >= 0)
    assert set(common) <= set(served) and len(common) >= N // 2
    np.testing.assert_allclose([rt.executor.scores[i] for i in common],
                               [ex.scores[i] for i in common],
                               rtol=1e-5, atol=1e-5)
    # a fresh 2-shard binding packed from the same export serves the same
    # scores, bitwise
    fresh = loadgen.bind_model(cfg, "cpu", storage=storage,
                               front_end="fused", n_shards=2)
    fresh.model.load_state_dict(pb.model.state_dict())
    fresh.state = fresh.engine.pack_state(
        *pb.engine.export_state(pb.state), table=pb.state.page_table,
        counts=pb.state.counts)
    padder = loadgen.make_padder(cfg)
    dummies = loadgen.dummy_request_factory(cfg, storage=storage)
    stream = loadgen.request_stream(cfg, loadgen.LoadConfig(
        arrival=ArrivalConfig(rate_qps=400.0, seed=5), **load))
    for b in SIZES:
        bucket = Bucket(b, cfg.pooling)
        for reqs in ([dummies(i, cfg.pooling) for i in range(b)],
                     stream[:b]):
            probe = padder(reqs, bucket)
            assert torch.equal(pb.execute(probe), fresh.execute(probe))


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_mismatched_snapshot_routes_to_the_elastic_path(writer, mesh1d,
                                                        tmp_path):
    jcfg, cfg = jreduced(jget_config("rmc1")), reduced(get_config("rmc1"))
    if writer == "port":
        b = loadgen.bind_model(cfg, "cpu", storage="int8", n_shards=4)
        b.attach_checkpointer(Checkpointer(str(tmp_path)))
    else:
        jb = jloadgen.bind_model(jcfg, mesh1d, storage="int8")
        with mesh1d:
            jb.attach_checkpointer(JCheckpointer(str(tmp_path)))
    extra = Checkpointer(str(tmp_path)).extra()
    assert extra["n_shards"] == 4 and extra["mesh"] == {"data": 1,
                                                        "model": 4}
    for n_shards, storage, match in ((2, "int8", "elastic path"),
                                     (1, "int8", "remesh_engine"),
                                     (4, "fp32", "storage")):
        other = loadgen.bind_model(cfg, "cpu", storage=storage,
                                   n_shards=n_shards)
        other.checkpointer = Checkpointer(str(tmp_path))
        with pytest.raises(ValueError, match=match):
            other.restore()
    same = loadgen.bind_model(cfg, "cpu", storage="int8", n_shards=4)
    same.checkpointer = Checkpointer(str(tmp_path))
    same.restore()
    assert same.restores == 1


def test_remesh_guards_and_heal(tmp_path):
    cfg = reduced(get_config("rmc1"))
    one = loadgen.bind_model(cfg, "cpu", elastic=True)
    with pytest.raises(RuntimeError, match="no survivor"):
        one.remesh(lost_shard=0)
    with pytest.raises(RuntimeError, match="attach_remesher"):
        loadgen.bind_model(cfg, "cpu", n_shards=4).remesh()
    b = loadgen.bind_model(cfg, "cpu", n_shards=4, elastic=True,
                           degraded_variants=True)
    assert b.can_remesh and set(b.modes()) == {
        "full", "split_fe", "no_dedup", "hot_only", "shed"}
    b.attach_checkpointer(Checkpointer(str(tmp_path)))
    want = [x.clone() for x in b.engine.export_state(b.state)]
    b.state.hot.fill_(float("nan"))                  # healed by the restore
    b.set_mode("hot_only")
    ev = b.remesh(lost_shard=1, heal=True,
                  new_mesh={"data": 1, "model": 3})
    assert ev == {"from_mesh": {"data": 1, "model": 4},
                  "to_mesh": {"data": 1, "model": 3}, "lost_shard": 1,
                  "n_shards": 3, "healed": True}
    assert b.remesh_events == [ev] and b.active == "hot_only"
    for a, c in zip(b.engine.export_state(b.state), want):
        assert torch.equal(a, c)
    # the new baseline snapshot restores in place on the survivor count
    assert Checkpointer(str(tmp_path)).extra()["n_shards"] == 3
    b.restore()


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_serve_offered_load_with_mesh_faults_on_cpu(storage):
    cfg = reduced(get_config("rmc1"))
    load = loadgen.LoadConfig(n_requests=96, arrival=ArrivalConfig(
        rate_qps=400.0, seed=1), storage=storage, front_end="fused")
    out = srv.serve_offered_load(cfg, load, device="cpu", mesh_faults=True,
                                 n_shards=4, batch_sizes=(8, 16))
    assert out["served"] + out["failed"] == 96 and out["served"] > 0
    assert out["steady_traces"] == 0 and out["remeshes"] == 1
    rec = out["remesh"]
    assert rec["to_mesh"] == {"data": 1, "model": 2}
    assert rec["lost_shard"] == 3 and rec["mttr_s"] > 0
    assert out["faults_fired"]["shard_loss"] >= 3
    assert out["degradation"]["remeshes"] == 1
    assert out["maintenance_calls"]["remesh"] == 1
    with pytest.raises(ValueError, match="tp-sharded"):
        srv.serve_offered_load(cfg, load, device="cpu", mesh_faults=True)
