"""The scrubber and page repair, port against the JAX package.

Both packages' bindings hold the same state (the reference's, hot pages
placed by its planner, exported and packed into the port) and model
weights; the same seeded flips (``flip_store_bits``) land in both.

* Detection within one sweep: the rotating window finds every flipped
  page inside ``ceil(num_pages / K)`` turns, the same turn in both
  packages; without a checkpointer the pages stay quarantined.
* Repair with a WAL tail, fp32 and int8: the snapshot page plus the
  filtered WAL replay leaves the port's store bitwise equal to the
  never-corrupted one (every tensor, every bit) and equal to the
  reference's repaired store (export triple); scores bitwise unchanged.
  A snapshot page that fails its recorded checksum raises.
* ``restore`` adopts the snapshot-time ledger.
* ``scrub_run`` of both runtimes with an update stream, a WAL, a
  checkpointer and scheduled bit flips under one pinned ``ServiceModel``:
  identical flush traces and scrub reports (less the wall-clock MTTR),
  equal final dense tables and WAL bytes.
* Scrub time is maintenance: it never moves a latency percentile.

Reports compare exactly, states bitwise; scores across the packages
within 1e-5 (the MLPs' reduction order differs).
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.wal import WriteAheadLog as JWriteAheadLog
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import updates as jupd
from repro.distributed.sharding import make_mesh
from repro.serving import batcher as jbatcher
from repro.serving import faults as jfaults
from repro.serving import loadgen as jloadgen
from repro.serving import metrics as jmetrics
from repro.serving import request as jrequest
from repro.serving import runtime as jruntime
from repro.serving import scrub as jscrub
from repro.serving import updates as jsupd

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.wal import WriteAheadLog
from repro_torch.configs import get_config, reduced
from repro_torch.core import updates as upd
from repro_torch.core.paging import HOT_SHARD, PageTable
from repro_torch.launch import serve as srv
from repro_torch.models.dlrm import params_from_numpy
from repro_torch.serving import batcher, loadgen
from repro_torch.serving.faults import FaultConfig, flip_store_bits
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.request import ArrivalConfig, Request
from repro_torch.serving.runtime import (OpenLoopSource, RuntimeConfig,
                                         ServingRuntime, SimulatedExecutor)
from repro_torch.serving.scrub import ScrubConfig, ScrubController

FIELDS = ("cold", "hot", "page_scales", "page_to_shard", "page_to_slot",
          "counts")


@pytest.fixture(scope="module")
def mesh11():
    return make_mesh((1, 1), ("data", "model"))


def _cfgs():
    return jreduced(jget_config("rmc1")), reduced(get_config("rmc1"))


def _batch(cfg, B=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"dense": rng.normal(size=(B, cfg.n_dense)).astype(np.float32),
            "indices": rng.integers(0, cfg.emb_num,
                                    (B, cfg.n_tables, cfg.pooling)
                                    ).astype(np.int32),
            "weights": np.ones((B, cfg.n_tables, cfg.pooling), np.float32)}


def _copy_into(pb, jb):
    """The port binding takes the reference binding's state and weights."""
    pb.model.load_state_dict(params_from_numpy(
        jax.tree.map(np.asarray, jb.params)))
    js = jb.state
    pb.state = pb.engine.pack_state(
        *map(np.asarray, jb.engine.export_state(js)),
        table=PageTable(np.asarray(js.page_to_shard),
                        np.asarray(js.page_to_slot)),
        counts=np.asarray(js.counts))


def _pair(storage, mesh):
    """Reference and port bindings of reduced RMC1 with the same state,
    some pages hot (a skewed observe and a re-plan in the reference)."""
    jcfg, cfg = _cfgs()
    jb = jloadgen.bind_model(jcfg, mesh, storage=storage)
    with mesh:
        idx = _batch(jcfg)["indices"] % 64
        jb.observe({"indices": idx})
        jb.replan()
    assert (np.asarray(jb.state.page_to_shard) == HOT_SHARD).any()
    pb = loadgen.bind_model(cfg, "cpu", storage=storage)
    _copy_into(pb, jb)
    return jb, pb


def _export_equal(jb, pb, mesh, what=""):
    with mesh:
        want = [np.asarray(x) for x in jb.engine.export_state(jb.state)]
    for a, b in zip(pb.engine.export_state(pb.state), want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=what)


def _less_mttr(rep):
    rep = dict(rep)
    rep["repairs"] = [{k: v for k, v in r.items() if k != "mttr_s"}
                      for r in rep["repairs"]]
    rep.pop("repair_mttr_mean_s", None)
    rep.pop("repair_mttr_max_s", None)
    return rep


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_rotating_window_detects_within_one_sweep_like_reference(storage,
                                                                 mesh11):
    jb, pb = _pair(storage, mesh11)
    with mesh11:
        jb.attach_integrity()
    pb.attach_integrity()
    n = int(pb.engine.cfg.num_pages)
    k = max(1, n // 4)
    cfg = dict(pages_per_cycle=k, repair=False)
    jsc = jscrub.ScrubController(jb, jscrub.ScrubConfig(**cfg))
    psc = ScrubController(pb, ScrubConfig(**cfg))
    with mesh11:
        jflipped = jfaults.flip_store_bits(jb, n_rows=3, seed=5, tier="both")
    flipped = flip_store_bits(pb, n_rows=3, seed=5, tier="both")
    assert flipped == jflipped
    _export_equal(jb, pb, mesh11, "after the flips")
    jm, pm = jmetrics.ServingMetrics(), ServingMetrics()
    sweep = -(-n // k)
    for _ in range(sweep):
        with mesh11:
            jsc.on_batch(0.0, jm)
        psc.on_batch(0.0, pm)
    rep = psc.report()
    assert rep == jsc.report()
    assert rep["sweep_cycles"] == sweep and rep["coverage"] == 1.0
    assert sorted(rep["detections"]) == flipped == rep["quarantined"]
    assert all(c <= sweep for c in rep["detections"].values())
    assert rep["pages_repaired"] == 0
    assert pm.summary()["scrub"] == jm.summary()["scrub"]
    assert pm.summary()["scrub"]["pages_detected"] == len(flipped)
    with pytest.raises(RuntimeError, match="attach_integrity"):
        ScrubController(loadgen.bind_model(_cfgs()[1], "cpu"))


def _arm_full(b, tmp, wal_cls, ckpt_cls, mesh=None):
    """Ledger, WAL, a snapshot with the ledger, then a WAL-logged delta
    batch touching every page past the snapshot."""
    import contextlib
    with (mesh if mesh is not None else contextlib.nullcontext()):
        b.attach_integrity()
        b.attach_wal(wal_cls(os.path.join(tmp, "t.wal")))
        b.attach_checkpointer(ckpt_cls(os.path.join(tmp, "ck")))
        eng = b.engine
        n, ps, d = eng.cfg.num_pages, eng.cfg.page_size, eng.cfg.dim
        rng = np.random.default_rng(23)
        rows = np.arange(n, dtype=np.int64) * ps + rng.integers(0, ps, n)
        deltas = (1e-3 * rng.standard_normal((n, d))).astype(np.float32)
        b.apply_deltas(rows, deltas)
    assert len(b.wal) > 0


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_repair_is_bitwise_with_a_wal_tail(storage, mesh11, tmp_path):
    jb, pb = _pair(storage, mesh11)
    _arm_full(jb, str(tmp_path / "j"), JWriteAheadLog, JCheckpointer, mesh11)
    _arm_full(pb, str(tmp_path / "p"), WriteAheadLog, Checkpointer)
    _export_equal(jb, pb, mesh11, "armed")
    batch = _batch(_cfgs()[1])
    truth_scores = pb.execute(batch).clone()
    truth = {f: getattr(pb.state, f).clone() for f in FIELDS}
    n = int(pb.engine.cfg.num_pages)
    psc = ScrubController(pb, ScrubConfig(pages_per_cycle=n))
    jsc = jscrub.ScrubController(jb, jscrub.ScrubConfig(pages_per_cycle=n))
    psc.warmup()
    for f in FIELDS:                      # warmup writes nothing
        assert torch.equal(getattr(pb.state, f), truth[f]), f
    with mesh11:
        jsc.warmup()
        jflipped = jfaults.flip_store_bits(jb, n_rows=3, seed=7, tier="both")
        jsc.on_batch(0.0)
    flipped = flip_store_bits(pb, n_rows=3, seed=7, tier="both")
    assert flipped == jflipped
    assert not all(torch.equal(getattr(pb.state, f), truth[f])
                   for f in ("cold", "hot"))
    psc.on_batch(0.0)
    rep = psc.report()
    assert _less_mttr(rep) == _less_mttr(jsc.report())
    assert sorted(rep["detections"]) == flipped
    assert rep["pages_repaired"] == len(flipped) and rep["quarantined"] == []
    assert all(r["wal_batches"] >= 1 and r["mttr_s"] > 0.0
               for r in rep["repairs"])
    for f in FIELDS:
        assert torch.equal(getattr(pb.state, f), truth[f]), f
    _export_equal(jb, pb, mesh11, "repaired")
    assert torch.equal(pb.execute(batch), truth_scores)
    assert pb.integrity.verify(pb.state).size == 0
    # a snapshot page that fails its recorded checksum is not written back
    page = flipped[0]
    flip_store_bits(pb, n_rows=1, seed=7, tier="both")
    snap = pb.checkpointer
    p2s = snap.read_leaf("page_to_shard")
    leaf = "hot" if p2s[page] == HOT_SHARD else "cold"
    path, _ = snap._leaf_path(leaf, None)
    arr = np.load(path, mmap_mode="r+")
    arr[:] = 0 if arr.dtype == np.int8 else 1.5
    arr.flush()
    del arr
    with pytest.raises(IOError, match="snapshot itself fails"):
        ScrubController(pb, ScrubConfig(pages_per_cycle=n))._repair(page)


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_restore_adopts_the_snapshot_ledger(storage, mesh11, tmp_path):
    jb, pb = _pair(storage, mesh11)
    _arm_full(jb, str(tmp_path / "j"), JWriteAheadLog, JCheckpointer, mesh11)
    _arm_full(pb, str(tmp_path / "p"), WriteAheadLog, Checkpointer)
    live = pb.integrity.checksums.copy()
    snap = pb.checkpointer.extra()["page_checksums"]
    assert snap == jb.checkpointer.extra()["page_checksums"]
    flip_store_bits(pb, n_rows=4, seed=3, tier="both")
    with mesh11:
        jfaults.flip_store_bits(jb, n_rows=4, seed=3, tier="both")
        jb.restore()
    pb.restore()
    np.testing.assert_array_equal(pb.integrity.checksums, live)
    np.testing.assert_array_equal(pb.integrity.checksums,
                                  jb.integrity.checksums)
    assert pb.integrity.verify(pb.state).size == 0
    _export_equal(jb, pb, mesh11, "restored")


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------

SIZES, POOLINGS, SLO_MS, N = (8, 16), (4, 8), 50.0, 48
SVC = dict(base_s=4e-3, per_row_s=2.5e-4)
FLIPS = dict(bit_flip_at=(1, 3, 5), bit_flip_rows=2, seed=4)


class _RefPinned(jruntime.BindingExecutor):
    """The reference binding's pinned executor (as in
    ``test_torch_serving_e2e.py``): scores by rid, service times from the
    model."""

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


def _load(mod, arrival_cls, storage):
    return mod.LoadConfig(n_requests=N,
                          arrival=arrival_cls(rate_qps=200.0, seed=2),
                          slo_ms=SLO_MS, poolings=POOLINGS, seed=2,
                          storage=storage, update_qps=600.0, update_batch=24)


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_scrub_run_matches_reference_under_a_pinned_service(storage, mesh11,
                                                            tmp_path):
    """Both runtimes: an update stream with a WAL, a checkpointer, the
    scrubber (every page every turn) and bit flips at attempts 1, 3 and 5, under
    one pinned service model (no re-plans: the planners' tie-breaks
    differ).  Every flipped page is detected and repaired the same turn in
    both, and the final tables are equal."""
    jcfg, cfg = _cfgs()
    maint = dict(observe_every=2, replan_every=0)
    jb, pb = _pair(storage, mesh11)
    svc = jbatcher.FixedServiceModel(**SVC)
    jload = _load(jloadgen, jrequest.ArrivalConfig, storage)
    ex = _RefPinned(jb, jloadgen.make_padder(jcfg), svc)
    jrt = jruntime.ServingRuntime(
        ex, jbatcher.DynamicBatcher(jbatcher.BatcherConfig(
            batch_sizes=SIZES, poolings=POOLINGS, max_wait_ms=SLO_MS / 2)),
        ex.padder, jruntime.RuntimeConfig(**maint), service_model=svc)
    jupdater = jsupd.StreamingUpdater(
        jb, jloadgen.update_stream(jcfg, jload),
        jupd.UpdateConfig(capacity=32),
        wal=JWriteAheadLog(str(tmp_path / "j.wal")))
    with mesh11:
        jrt.warmup(jloadgen.dummy_request_factory(jcfg, storage=storage))
        jupdater.warmup()
        jrt.updater = jupdater
        jb.attach_integrity()
        jb.attach_checkpointer(JCheckpointer(str(tmp_path / "jck")))
        jsc = jscrub.ScrubController(jb, jscrub.ScrubConfig(
            pages_per_cycle=16))
        jsc.warmup()
        jrt.scrubber = jsc
        jrt.executor = jfaults.FaultInjectingExecutor(
            ex, jfaults.FaultConfig(**FLIPS))
        jb.reset_plan_stats()
        js = jrt.run(jruntime.OpenLoopSource(
            jloadgen.request_stream(jcfg, jload)))
        jdense = np.asarray(jb.engine.to_dense(jb.state))

    load = _load(loadgen, ArrivalConfig, storage)
    rt, pb2 = srv.build_serving(
        cfg, "cpu", batch_sizes=SIZES, poolings=POOLINGS, slo_ms=SLO_MS,
        storage=storage, runtime_cfg=RuntimeConfig(**maint),
        service=batcher.FixedServiceModel(**SVC))
    pb2.model.load_state_dict(pb.model.state_dict())
    pb2.state = pb.state
    updater = srv.StreamingUpdater(
        pb2, loadgen.update_stream(cfg, load), upd.UpdateConfig(capacity=32),
        wal=WriteAheadLog(str(tmp_path / "p.wal")))
    pb2.attach_checkpointer(Checkpointer(str(tmp_path / "pck")))
    s = srv.run_offered_load(rt, pb2, cfg, load, updater=updater,
                             scrub=ScrubConfig(pages_per_cycle=16),
                             faults=FaultConfig(**FLIPS))
    assert _trace(rt) == _trace(jrt)
    rep, jrep = s["scrub_run"], js["scrub_run"]
    assert _less_mttr(rep) == _less_mttr(jrep)
    flips = rt.executor.bit_flip_events
    assert flips == jrt.executor.bit_flip_events and len(flips) == 3
    # a flipped page that an update lands in before the next audit is
    # re-recorded from its live (flipped) content by apply_deltas' ledger
    # hook, in both packages: only the others are detected
    assert 0 < rep["pages_detected"] <= len({p for e in flips
                                             for p in e["pages"]})
    assert rep["pages_repaired"] == rep["pages_detected"]
    assert rep["quarantined"] == []
    assert s["maintenance_calls"] == js["maintenance_calls"]
    assert s["maintenance_calls"]["scrub"] == s["batches"]
    assert _less_mttr({**s["scrub"], "repairs": []}) == _less_mttr(
        {**js["scrub"], "repairs": []})
    assert s["steady_traces"] == 0 and s["served"] == N
    assert s["faults_fired"] == jrt.executor.report()
    np.testing.assert_array_equal(pb2.engine.to_dense(pb2.state).numpy(),
                                  jdense)
    assert ((tmp_path / "p.wal").read_bytes()
            == (tmp_path / "j.wal").read_bytes())
    assert pb2.integrity.verify(pb2.state).size == 0
    got = np.asarray([rt.executor.scores[i] for i in range(N)])
    want = np.asarray([ex.scores[i] for i in range(N)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_scrub_time_is_maintenance_never_latency(mesh11):
    """Two runs on the virtual clock, one with the scrubber armed: equal
    latency numbers, the scrub's wall time under maintenance; the
    reference's runs give the same numbers."""
    jcfg, cfg = _cfgs()
    pb = loadgen.bind_model(cfg, "cpu")
    pb.attach_integrity()
    jb = jloadgen.bind_model(jcfg, mesh11)
    with mesh11:
        jb.attach_integrity()

    def run(pkg, scrubber):
        if pkg == "port":
            model = batcher.FixedServiceModel(base_s=2e-3, per_row_s=0.0)
            rt = ServingRuntime(
                SimulatedExecutor(model), batcher.FixedBatcher(4, 4),
                padder=lambda reqs, bucket: {"n": len(reqs)},
                cfg=RuntimeConfig(observe_every=0, replan_every=0),
                service_model=model, scrubber=scrubber)
            reqs = [Request(rid=i, arrival_s=1e-3 * i, deadline_s=10.0,
                            features={}, pooling=4) for i in range(32)]
            return rt.run(OpenLoopSource(reqs))
        model = jbatcher.FixedServiceModel(base_s=2e-3, per_row_s=0.0)
        rt = jruntime.ServingRuntime(
            jruntime.SimulatedExecutor(model), jbatcher.FixedBatcher(4, 4),
            padder=lambda reqs, bucket: {"n": len(reqs)},
            cfg=jruntime.RuntimeConfig(observe_every=0, replan_every=0),
            service_model=model, scrubber=scrubber)
        reqs = [jrequest.Request(rid=i, arrival_s=1e-3 * i, deadline_s=10.0,
                                 features={}, pooling=4) for i in range(32)]
        with mesh11:
            return rt.run(jruntime.OpenLoopSource(reqs))

    plain = run("port", None)
    cfg4 = dict(pages_per_cycle=4, repair=False)
    scrubbed = run("port", ScrubController(pb, ScrubConfig(**cfg4)))
    jscrubbed = run("ref", jscrub.ScrubController(jb,
                                                  jscrub.ScrubConfig(**cfg4)))
    assert "scrub" not in plain["maintenance_s"]
    assert scrubbed["maintenance_s"]["scrub"] > 0.0
    assert scrubbed["scrub_run"]["cycles"] == 8
    assert scrubbed["scrub"]["pages_detected"] == 0
    for k in ("p50_ms", "p99_ms", "p99.9_ms", "served", "qps",
              "availability", "batches"):
        assert plain[k] == scrubbed[k] == jscrubbed[k], k
    assert scrubbed["scrub_run"] == jscrubbed["scrub_run"]
    assert "scrub_run" not in plain
