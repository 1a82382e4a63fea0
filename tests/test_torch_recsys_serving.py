"""The recsys half of the port's serving surface against
``repro.serving.loadgen`` and ``repro.launch.serve`` on the CPU: request
streams, factories and padders (bit for bit), the runtime over each
package's binding under one pinned ``FixedServiceModel`` (identical flush
traces, scores within 1e-5 relative and absolute: lookups are bitwise,
the dense towers reduce in another order), the brown-out rung aliases,
the profiler-less binding (``idx_key=None``), the update-stream refusal,
the elastic re-mesh under ``--mesh-faults`` and the CLI.

The reference's ``steady_traces`` is not asserted: its end-to-end serving
tests are among its known CPU failures (``ROADMAP.md`` queue 3).  Its
meshes come from ``repro.distributed.sharding.make_mesh``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.distributed.sharding import make_mesh
from repro.launch import serve as jserve
from repro.serving import batcher as jbatcher
from repro.serving import loadgen as jloadgen
from repro.serving import request as jrequest
from repro.serving import runtime as jruntime

from repro_torch.configs import get_config, reduced
from repro_torch.core.paging import PageTable
from repro_torch.examples import serve_recsys
from repro_torch.launch import serve as srv
from repro_torch.models.recsys import params_from_numpy
from repro_torch.serving import batcher, loadgen
from repro_torch.serving.request import ArrivalConfig
from repro_torch.serving.runtime import RuntimeConfig

ARCHS = ["sasrec", "bst", "autoint", "dcn-v2"]
SIZES, SLO_MS, N = (8, 16), 50.0, 40
SVC = dict(base_s=4e-3, per_row_s=2.5e-4)


@pytest.fixture(scope="module")
def mesh11():
    return make_mesh((1, 1), ("data", "model"))


def _cfgs(arch, full=False):
    j, p = jget_config(arch), get_config(arch)
    return (j, p) if full else (jreduced(j), reduced(p))


def _load(mod, arrival_cls, n=N, seed=2, **kw):
    return mod.LoadConfig(n_requests=n,
                          arrival=arrival_cls(rate_qps=200.0, seed=seed),
                          slo_ms=SLO_MS, seed=seed, **kw)


def _same_request(p, j):
    assert (p.rid, p.arrival_s, p.deadline_s, p.pooling, p.user) == \
        (j.rid, j.arrival_s, j.deadline_s, j.pooling, j.user)
    assert p.features.keys() == j.features.keys()
    for k in p.features:
        a, b = np.asarray(p.features[k]), np.asarray(j.features[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


# ------------------------------------------------------- streams, padders
@pytest.mark.parametrize("arch", ARCHS)
def test_streams_factories_and_padders_equal_the_reference(arch):
    jcfg, cfg = _cfgs(arch)
    reqs = loadgen.request_stream(cfg, _load(loadgen, ArrivalConfig))
    jreqs = jloadgen.request_stream(jcfg, _load(jloadgen,
                                                jrequest.ArrivalConfig))
    assert len(reqs) == len(jreqs) == N
    for p, j in zip(reqs, jreqs):
        _same_request(p, j)
    # drawn in two spawned processes: the same bits
    for p, j in zip(loadgen.request_stream(cfg, _load(loadgen, ArrivalConfig),
                                           workers=2), jreqs):
        _same_request(p, j)
    make = loadgen.closed_loop_factory(cfg, _load(loadgen, ArrivalConfig))
    jmake = jloadgen.closed_loop_factory(
        jcfg, _load(jloadgen, jrequest.ArrivalConfig))
    for rid in range(6):
        _same_request(make(rid, rid % 3, 0.01 * rid),
                      jmake(rid, rid % 3, 0.01 * rid))
    dummy = loadgen.dummy_request_factory(cfg)
    jdummy = jloadgen.dummy_request_factory(jcfg)
    for rid in range(3):
        _same_request(dummy(rid, 1), jdummy(rid, 1))
    for n_real, B in ((5, 8), (16, 16), (1, 8)):
        got = loadgen.make_padder(cfg)(reqs[:n_real], batcher.Bucket(B, 1))
        want = jloadgen.make_padder(jcfg)(jreqs[:n_real],
                                          jbatcher.Bucket(B, 1))
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_requests_equal_the_reference(arch):
    """The published vocabularies (up to 10.1 M ids, each drawn through a
    permutation of the vocabulary: about a second per Criteo request)."""
    jcfg, cfg = _cfgs(arch, full=True)
    n = 1 if cfg.interaction in ("cross", "self-attn") else 3
    for p, j in zip(
            loadgen.request_stream(cfg, _load(loadgen, ArrivalConfig, n=n)),
            jloadgen.request_stream(jcfg, _load(jloadgen,
                                                jrequest.ArrivalConfig,
                                                n=n))):
        _same_request(p, j)


def test_update_streams_and_profiles_refuse_recsys_configs():
    jcfg, cfg = _cfgs("dcn-v2")
    load = _load(loadgen, ArrivalConfig, update_qps=10.0)
    with pytest.raises(TypeError):
        loadgen.update_stream(cfg, load)
    with pytest.raises(TypeError):
        jloadgen.update_stream(jcfg, _load(jloadgen, jrequest.ArrivalConfig,
                                           update_qps=10.0))
    with pytest.raises(TypeError):
        srv.serve_offered_load(cfg, load, device="cpu")
    with pytest.raises(TypeError):
        srv.main(["--arch", "sasrec", "--device", "cpu", "--requests", "8",
                  "--update-qps", "5"])
    reqs = loadgen.request_stream(cfg, _load(loadgen, ArrivalConfig, n=4))
    with pytest.raises(TypeError):
        loadgen.bind_model(cfg, "cpu", profile=reqs)


# ------------------------------------------------------------ the runtime
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


MAINT = dict(observe_every=2, replan_every=4)


@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("arch", ["dcn-v2", "sasrec"])
def test_runtime_matches_the_reference_under_a_pinned_service(
        arch, storage, mesh11):
    """Both packages' runtimes over their own bindings (maintenance on:
    re-plans on the untouched histogram, observes are no-ops): identical
    flush traces, every request served, scores within 1e-5; and
    ``serve_offered_load``'s summary has the reference's keys (the port
    adds only ``warmup_service_ms``)."""
    jcfg, cfg = _cfgs(arch)
    jb = jloadgen.bind_model(jcfg, mesh11, storage=storage)
    svc = jbatcher.FixedServiceModel(**SVC)
    ex = _RefPinned(jb, jloadgen.make_padder(jcfg), svc)
    jrt = jruntime.ServingRuntime(
        ex, jbatcher.DynamicBatcher(jbatcher.BatcherConfig(
            batch_sizes=SIZES, poolings=(1,), max_wait_ms=SLO_MS / 2)),
        ex.padder, jruntime.RuntimeConfig(**MAINT), service_model=svc)
    jstate0 = jb.state
    with mesh11:
        jrt.warmup(jloadgen.dummy_request_factory(jcfg, storage=storage))
        jb.reset_plan_stats()
        js = jrt.run(jruntime.OpenLoopSource(jloadgen.request_stream(
            jcfg, _load(jloadgen, jrequest.ArrivalConfig,
                        storage=storage))))
    jb.state = jstate0
    load = _load(loadgen, ArrivalConfig, storage=storage)
    prt, pb = srv.build_serving(
        cfg, "cpu", batch_sizes=SIZES, slo_ms=SLO_MS, storage=storage,
        runtime_cfg=RuntimeConfig(**MAINT),
        service=batcher.FixedServiceModel(**SVC))
    _carry(pb, jb)
    ps = srv.run_offered_load(prt, pb, cfg, load)
    assert _trace(prt) == _trace(jrt)
    assert len({b.bucket for b in prt.metrics.batches}) == 2
    assert ps["served"] == js["served"] == N
    assert ps["replans"] == js["batches"] // 4 >= 1
    assert ps["steady_traces"] == 0
    for key in ("bucket_mix", "p50_ms", "p99_ms", "batch_occupancy_mean",
                "maintenance_calls"):
        assert ps[key] == js[key], key
    got = np.asarray([prt.executor.scores[i] for i in range(N)])
    want = np.asarray([ex.scores[i] for i in range(N)])
    assert np.isfinite(got).all() and ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the summary's keys, each package's serve_offered_load end to end
    n = 16
    pl = _load(loadgen, ArrivalConfig, n=n, storage=storage)
    jl = _load(jloadgen, jrequest.ArrivalConfig, n=n, storage=storage)
    pout = srv.serve_offered_load(cfg, pl, device="cpu", batch_sizes=SIZES)
    jout = jserve.serve_offered_load(jcfg, mesh11, jl, batch_sizes=SIZES)
    assert pout["served"] == jout["served"] == n
    assert pout["steady_traces"] == 0
    assert set(pout) - {"warmup_service_ms"} == set(jout)


def test_rungs_alias_as_the_reference(mesh11):
    """Rec configs have no DLRM front end or tiers knob: split_fe is the
    full step, hot_only and shed are no_dedup; each rung scores a padded
    batch as the reference's rung does (within 1e-5) and all equal full
    bitwise."""
    jcfg, cfg = _cfgs("dcn-v2")
    kw = dict(storage="int8", dedup="on", degraded_variants=True)
    jb = jloadgen.bind_model(jcfg, mesh11, **kw)
    pb = loadgen.bind_model(cfg, "cpu", **kw)
    _carry(pb, jb)
    assert pb.modes() == jb.modes() == ("full", "split_fe", "no_dedup",
                                        "hot_only", "shed")
    assert pb.steps["split_fe"] is pb.steps["full"]
    assert pb.steps["hot_only"] is pb.steps["no_dedup"] is pb.steps["shed"]
    reqs = loadgen.request_stream(cfg, _load(loadgen, ArrivalConfig))
    batch = loadgen.make_padder(cfg)(reqs[:6], batcher.Bucket(8, 1))
    got = {}
    for rung in pb.modes():
        pb.set_mode(rung)
        jb.set_mode(rung)
        got[rung] = pb.execute(batch).numpy()
        with mesh11:
            want = np.asarray(jb.execute(batch))
        np.testing.assert_allclose(got[rung], want, rtol=1e-5, atol=1e-5,
                                   err_msg=rung)
        np.testing.assert_array_equal(got[rung], got["full"])


def test_bindings_without_an_index_key_keep_the_profiler_off(mesh11):
    """``idx_key=None`` (both packages): observe leaves the histogram and
    the dedup record alone, ``validate_ids`` checks nothing,
    ``prime_dedup_auto`` observes nothing and returns 0, and dedup 'auto'
    serves."""
    jcfg, cfg = _cfgs("sasrec")
    jb = jloadgen.bind_model(jcfg, mesh11)
    pb = loadgen.bind_model(cfg, "cpu", validate_ids=True)
    assert pb.idx_key is None and jb.idx_key is None
    reqs = loadgen.request_stream(cfg, _load(loadgen, ArrivalConfig))
    batch = loadgen.make_padder(cfg)(reqs[:8], batcher.Bucket(8, 1))
    counts = pb.state.counts.clone()
    pb.observe(batch)
    assert torch.equal(pb.state.counts, counts) and not pb.dedup_stats
    assert pb.execute(batch).shape == (8,)
    assert loadgen.prime_dedup_auto(pb, reqs) == 0
    assert jloadgen.prime_dedup_auto(jb, jloadgen.request_stream(
        jcfg, _load(jloadgen, jrequest.ArrivalConfig))) == 0
    out = srv.serve_offered_load(
        cfg, _load(loadgen, ArrivalConfig, n=24, dedup="auto"), device="cpu")
    assert out["served"] == 24 and out["steady_traces"] == 0


def test_a_drawn_stream_serves_as_the_loads_own():
    """``run_offered_load(requests=)`` with the load's own stream, drawn
    once and served twice: the same flushes and bitwise scores as the run
    that draws it."""
    _, cfg = _cfgs("bst")
    load = _load(loadgen, ArrivalConfig)
    reqs = loadgen.request_stream(cfg, load)
    runs = []
    for given in (None, reqs, reqs):
        rt, b = srv.build_serving(cfg, "cpu", batch_sizes=SIZES,
                                  service=batcher.FixedServiceModel(**SVC))
        s = srv.run_offered_load(rt, b, cfg, load, requests=given)
        assert s["served"] == N
        runs.append((_trace(rt), [rt.executor.scores[i] for i in range(N)]))
    assert runs[1] == runs[0] == runs[2]


def test_mesh_faults_remesh_four_shards_to_two():
    """``serve_offered_load(mesh_faults=True)`` on reduced DCN-v2 at 4
    shards: the shard loss at live attempt 2 re-meshes 4 -> 2 once and
    every request is served or counted failed, none new after warmup."""
    _, cfg = _cfgs("dcn-v2")
    n = 48
    out = srv.serve_offered_load(cfg, _load(loadgen, ArrivalConfig, n=n),
                                 device="cpu", n_shards=4, mesh_faults=True)
    assert out["remeshes"] == 1
    assert out["remesh"]["from_mesh"] == {"data": 1, "model": 4}
    assert out["remesh"]["to_mesh"]["model"] == 2
    assert out["served"] + out["failed"] == n and out["served"] > 0
    assert out["steady_traces"] == 0


# ------------------------------------------------------------------- CLIs
@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_every_request_on_the_cpu(arch):
    out = srv.main(["--arch", arch, "--device", "cpu", "--requests", "64"])
    assert out["served"] == 64 and out["steady_traces"] == 0
    s = out["scores"]
    assert s.shape == (64,) and np.isfinite(s).all()
    assert ((s > 0) & (s < 1)).all()


def test_cli_scrub_on_a_recsys_config():
    out = srv.main(["--arch", "autoint", "--device", "cpu", "--requests",
                    "32", "--scrub", "--scrub-pages-per-cycle", "4"])
    assert out["served"] == 32
    run = out["scrub_run"]
    assert run["pages_audited"] > 0
    assert run["pages_detected"] == run["pages_repaired"] == 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is present")
def test_cli_and_example_raise_without_cuda():
    with pytest.raises(RuntimeError):
        srv.main(["--arch", "dcn-v2", "--requests", "8"])
    with pytest.raises(RuntimeError):
        serve_recsys.main(["--requests", "8"])


def test_example_serves_pifs_and_pond_on_the_cpu():
    outs = serve_recsys.main(["--device", "cpu", "--requests", "64"])
    for mode in ("pifs", "pond"):
        assert outs[mode]["served"] == 64
        assert outs[mode]["steady_traces"] == 0
