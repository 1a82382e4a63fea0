"""Streaming embedding updates, port against the JAX package.

Numpy level, exact: ``core/updates.py`` (coalesce, chunk, the drift
tracker's candidates, ``demote_table``) and ``serving/loadgen.py:
update_stream`` on the same inputs as the reference's.

Engine level, bitwise: the port engine holds the reference engine's state
(``export_state`` -> ``pack_state`` with the reference's page table, hot
pages placed by its planner), both apply the same coalesced chunks, and
the leaves, ``export_state`` and ``to_dense`` must be equal, fp32 and int8,
at one shard (a (1, 1) mesh) and at four (the conftest ``mesh1d``).  The
int8 batches hold elements where a multiply then an add gives another
code than the reference's fused multiply-add (found by search, and
checked to differ), a zero-scale page and pads; an all-pad batch is a
bitwise no-op.  ``requant_hot_pages`` and the errors are the reference's.

Runtime: both packages' runtimes with an update stream under one pinned
``FixedServiceModel``: identical flush traces and updater reports, an
equal final ``to_dense``.  fp32 re-plans as it serves (its tiers add
alike, so placement ties do not matter); int8 does not (``replan_every=0``:
the two planners break ties apart, ``ROADMAP.md`` decisions of the second
slice, and the tier decides hot add against quantized read-modify-write).
The reference's ``tests/test_updates.py::
test_streaming_updater_runtime_integration`` is among its ten known
failures; the runtime test here compares values between the packages and
copies none of its trace assertions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.wal import WriteAheadLog as JWriteAheadLog
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import paging as jpaging
from repro.core import updates as jupd
from repro.core.pifs import engine_for_tables as jengine_for_tables
from repro.distributed.sharding import make_mesh
from repro.serving import batcher as jbatcher
from repro.serving import loadgen as jloadgen
from repro.serving import request as jrequest
from repro.serving import runtime as jruntime
from repro.serving import updates as jsupd

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.wal import WriteAheadLog
from repro_torch.configs import get_config, reduced
from repro_torch.core import paging
from repro_torch.core import updates as upd
from repro_torch.core.paging import HOT_SHARD, PageTable
from repro_torch.core.pifs import engine_for_tables
from repro_torch.kernels import ops
from repro_torch.kernels.ref import fma_f32
from repro_torch.launch import serve as srv
from repro_torch.models.dlrm import params_from_numpy
from repro_torch.serving import batcher, loadgen
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.request import ArrivalConfig
from repro_torch.serving.runtime import RuntimeConfig
from repro_torch.serving.updates import StreamingUpdater, UpdateBatch

VOCABS, DIM, PAGE_BYTES, HOT = [300, 200], 16, 512, 0.2


@pytest.fixture(scope="module")
def mesh11():
    return make_mesh((1, 1), ("data", "model"))


# ---------------------------------------------------------------------------
# Numpy level
# ---------------------------------------------------------------------------


def test_coalesce_and_chunk_match_reference():
    rng = np.random.default_rng(0)
    rows = rng.integers(-3, 40, 97)                 # duplicates and pads
    d = rng.normal(size=(97, 5)).astype(np.float32)
    got, want = upd.coalesce_deltas(rows, d), jupd.coalesce_deltas(rows, d)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    again = upd.coalesce_deltas(*got)               # the identity
    for a, b in zip(again, got):
        np.testing.assert_array_equal(a, b)
    for cap in (1, 7, 32, 64):
        pc = list(upd.chunk_delta_batch(*got, cap))
        jc = list(jupd.chunk_delta_batch(*want, cap))
        assert len(pc) == len(jc) == -(-got[0].size // cap)
        for (pr, pd), (jr, jd) in zip(pc, jc):
            np.testing.assert_array_equal(pr, jr)
            np.testing.assert_array_equal(pd, jd)
    assert list(upd.chunk_delta_batch(np.empty(0, np.int32),
                                      np.empty((0, 5), np.float32), 4)) == []
    for mod in (upd, jupd):
        with pytest.raises(ValueError):
            list(mod.chunk_delta_batch(*got, 0))


def _tables(n_shards, rng):
    """The same paging config in both packages and a random valid page
    table with about a quarter of the pages hot."""
    kw = dict(total_rows=512, dim=8, n_shards=n_shards, page_bytes=256,
              hot_fraction=0.25)
    cfg, jcfg = paging.PagingConfig(**kw), jpaging.PagingConfig(**kw)
    P, cap = cfg.num_pages, cfg.pages_per_shard
    hot = rng.permutation(P)[:cfg.hot_pages]
    shard = np.zeros(P, np.int32)
    slot = np.zeros(P, np.int32)
    shard[hot] = HOT_SHARD
    slot[hot] = np.arange(hot.size)
    cold = np.setdiff1d(np.arange(P), hot)
    free = [list(rng.permutation(cap)) for _ in range(n_shards)]
    for p in cold:
        s = int(rng.integers(n_shards))
        while not free[s]:
            s = (s + 1) % n_shards
        shard[p], slot[p] = s, free[s].pop()
    return cfg, jcfg, shard, slot


@pytest.mark.parametrize("n_shards", [1, 4])
def test_drift_tracker_and_demote_table_match_reference(n_shards):
    rng = np.random.default_rng(n_shards)
    cfg, jcfg, shard, slot = _tables(n_shards, rng)
    table = PageTable(shard, slot)
    jtable = jpaging.PageTable(shard, slot)
    tr, jtr = upd.DriftTracker(cfg), jupd.DriftTracker(jcfg)
    for _ in range(5):
        rows = rng.integers(-2, cfg.padded_rows, 40)
        d = rng.normal(size=(40, cfg.dim)).astype(np.float32)
        tr.update(rows, d)
        jtr.update(rows, d)
    np.testing.assert_array_equal(tr.drift, jtr.drift)
    np.testing.assert_array_equal(tr.rows_touched, jtr.rows_touched)
    counts = rng.integers(0, 4, cfg.num_pages).astype(np.float64)
    for ucfg in (upd.UpdateConfig(), upd.UpdateConfig(
            drift_threshold=0.5, max_demotions=5, hotness_guard=0.25),
            upd.UpdateConfig(drift_threshold=0.0, hotness_guard=0.0,
                             max_demotions=100)):
        jucfg = jupd.UpdateConfig(**dataclasses.asdict(ucfg))
        cand = tr.demote_candidates(table, counts, ucfg)
        np.testing.assert_array_equal(
            cand, jtr.demote_candidates(jtable, counts, jucfg))
    assert cand.size > 0
    tr.note_requantized(cand[:3])
    jtr.note_requantized(cand[:3])
    np.testing.assert_array_equal(tr.drift, jtr.drift)
    got = upd.demote_table(cfg, table, counts, cand)
    want = jupd.demote_table(jcfg, jtable, counts, cand)
    np.testing.assert_array_equal(got.page_to_shard, want.page_to_shard)
    np.testing.assert_array_equal(got.page_to_slot, want.page_to_slot)
    for mod, c, t in ((upd, cfg, got), (jupd, jcfg, want)):
        with pytest.raises(ValueError, match="not hot-resident"):
            mod.demote_table(c, t, counts, cand[:1])     # already cold


def test_demote_table_raises_when_the_cold_tier_is_full():
    """Eight pages in four slots: four cold pages fill the one shard, so a
    demotion has nowhere to go, in both packages."""
    kw = dict(total_rows=64, dim=8, n_shards=1, page_bytes=256,
              hot_fraction=0.5, headroom=0.5)
    shard = np.array([0, 0, 0, 0, -1, -1, -1, -1], np.int32)
    slot = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int32)
    counts = np.ones(8)
    with pytest.raises(RuntimeError, match="no free slot"):
        upd.demote_table(paging.PagingConfig(**kw), PageTable(shard, slot),
                         counts, [5])
    with pytest.raises(RuntimeError, match="no free slot"):
        jupd.demote_table(jpaging.PagingConfig(**kw),
                          jpaging.PageTable(shard, slot), counts, [5])


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_update_stream_matches_reference(storage):
    jcfg, cfg = jreduced(jget_config("rmc1")), reduced(get_config("rmc1"))
    kw = dict(n_requests=64, slo_ms=50.0, seed=4, storage=storage,
              update_qps=1000.0, update_batch=20)
    got = loadgen.update_stream(cfg, loadgen.LoadConfig(
        arrival=ArrivalConfig(rate_qps=500.0, seed=3), **kw))
    want = jloadgen.update_stream(jcfg, jloadgen.LoadConfig(
        arrival=jrequest.ArrivalConfig(rate_qps=500.0, seed=3), **kw))
    assert len(got) == len(want) > 3
    for a, b in zip(got, want):
        assert (a.seq, a.t_gen) == (b.seq, b.t_gen)
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.deltas, b.deltas)
        assert a.rows.dtype == b.rows.dtype and a.rows.shape == (20,)
    assert loadgen.update_stream(cfg, loadgen.LoadConfig(
        4, ArrivalConfig(10.0))) == []


# ---------------------------------------------------------------------------
# Engine level
# ---------------------------------------------------------------------------


def _carried(storage, mesh):
    """A JAX engine on ``mesh`` with planner-placed hot pages, and the port
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
        jstate, stats = jeng.plan_and_migrate(jstate)
    assert stats["hot_pages"] > 0
    eng, _ = engine_for_tables(VOCABS, DIM, device="cpu", hot_fraction=HOT,
                               page_bytes=PAGE_BYTES, storage=storage,
                               n_shards=n_shards)
    table = PageTable(np.asarray(jstate.page_to_shard),
                      np.asarray(jstate.page_to_slot))
    state = eng.pack_state(*map(np.asarray, jeng.export_state(jstate)),
                           table=table, counts=np.asarray(jstate.counts))
    return jeng, jstate, eng, state, rng


def _leaves(x):
    """The placement and scales (the tiers' slots no page maps to hold
    whatever each package left there, so the tiers compare through the
    export triple and the dense table)."""
    return [np.asarray(v) for v in (x.page_scales, x.page_to_shard,
                                    x.page_to_slot)]


def _assert_same(jeng, jstate, eng, state, mesh, what=""):
    for a, b in zip(_leaves(state), _leaves(jstate)):
        np.testing.assert_array_equal(a, b, err_msg=what)
    with mesh:
        want = [np.asarray(x) for x in jeng.export_state(jstate)]
        jdense = np.asarray(jeng.to_dense(jstate))
    for a, b in zip(eng.export_state(state), want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=what)
    np.testing.assert_array_equal(eng.to_dense(state).numpy(), jdense,
                                  err_msg=what)


def _fma_deltas(q, s, rng, tries=256):
    """Deltas (n, D) at which round((q * s + d) / s) with a multiply then
    an add gives another code than with one fma: each element searched
    among candidates near a code's halfway point.  Where ``q * s`` is
    exact in float32 (q = 0, a power of two) the two cannot differ; such
    elements, at most half, keep a plain gaussian delta."""
    n, D = q.shape
    qf = q.astype(np.float32)
    s2 = np.broadcast_to(s[:, None], (n, D)).astype(np.float32)
    out = (rng.normal(size=(n, D)) * 0.1).astype(np.float32)
    todo = np.ones((n, D), bool)
    for _ in range(tries):
        k = np.clip(q.astype(np.int64) + rng.integers(-3, 4, (n, D)),
                    -120, 120)
        d = ((k + 0.5 - qf) * s2.astype(np.float64)).astype(np.float32)
        d = (d * (1 + rng.uniform(-3e-7, 3e-7, (n, D)))).astype(np.float32)
        mul = np.clip(np.round((qf * s2 + d) / s2), -127, 127)
        fm = fma_f32(torch.from_numpy(qf), torch.from_numpy(s2),
                     torch.from_numpy(d)).numpy()
        fma = np.clip(np.round(fm / s2), -127, 127)
        hit = todo & (mul != fma)
        out[hit] = d[hit]
        todo &= ~hit
        if not todo.any():
            break
    assert todo.mean() < 0.5
    return out


def _batch(eng, state, rng, storage, zero_page=None):
    """One coalesced delta batch from the current state (duplicates and
    pads; at int8 the deltas of cold rows found by :func:`_fma_deltas`,
    and four rows of ``zero_page``, whose scale is 0)."""
    c = eng.cfg
    ps = c.page_size
    shard = state.page_to_shard.numpy()
    codes, _, scales = (x.numpy() for x in eng.export_state(state))
    rows = rng.integers(-2, c.padded_rows, 60)
    if zero_page is not None:
        rows[:4] = zero_page * ps + rng.integers(0, ps, 4)
    d = (rng.normal(size=(60, c.dim)) * 0.1).astype(np.float32)
    r, d = upd.coalesce_deltas(rows, d)
    if storage == "int8":
        cold = (shard[r // ps] != HOT_SHARD) & (scales[r // ps] > 0)
        d[cold] = _fma_deltas(codes[r[cold]], scales[r[cold] // ps], rng)
    return r, d


def _apply_both(jeng, jstate, eng, state, batches, mesh, capacity=32):
    with mesh:
        for r, d in batches:
            for cr, cd in upd.chunk_delta_batch(r, d, capacity):
                jstate = jeng.apply_deltas(jstate, jnp.asarray(cr),
                                           jnp.asarray(cd))
                state = eng.apply_deltas(state, cr, cd)
    return jstate, state


@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("meshname", ["mesh11", "mesh1d"])
def test_apply_deltas_matches_reference_bitwise(storage, meshname, request):
    """Three coalesced batches in chunks of 32 into both engines: every
    leaf, the export triple and the dense table bitwise equal after each,
    at 1 and 4 shards; untouched rows unchanged.  int8: every cold delta
    sits where a multiply then an add gives another code (checked: those
    codes differ from the reference's), and one page has a zero scale (its
    codes stay)."""
    mesh = request.getfixturevalue(meshname)
    jeng, jstate, eng, state, rng = _carried(storage, mesh)
    ps = eng.cfg.page_size
    zero_page = None
    if storage == "int8":
        shard = state.page_to_shard.numpy()
        zero_page = int(np.nonzero(shard != HOT_SHARD)[0][3])
        scales = np.asarray(jstate.page_scales).copy()
        scales[zero_page] = 0.0
        jstate = dataclasses.replace(jstate, page_scales=jnp.asarray(scales))
        state.page_scales[zero_page] = 0.0
    before = eng.to_dense(state).clone()
    cold0 = state.cold.clone()
    touched, misses = [], 0
    for k in range(3):
        r, d = _batch(eng, state, rng, storage, zero_page)
        codes0 = eng.export_state(state)[0].numpy().astype(np.float32)
        jstate, state = _apply_both(jeng, jstate, eng, state, [(r, d)], mesh)
        _assert_same(jeng, jstate, eng, state, mesh,
                     f"{storage} {meshname} batch {k}")
        touched.append(r)
        if storage == "int8":
            shard = state.page_to_shard.numpy()
            scales = state.page_scales.numpy()
            cold = (shard[r // ps] != HOT_SHARD) & (scales[r // ps] > 0)
            rc = r[cold]
            s = scales[rc // ps][:, None]
            mul = np.clip(np.round((codes0[rc] * s + d[cold]) / s), -127, 127)
            misses += int((mul != eng.export_state(state)[0].numpy()[rc])
                          .sum())
    touched = np.unique(np.concatenate(touched))
    untouched = np.setdiff1d(np.arange(eng.cfg.padded_rows), touched)
    after = eng.to_dense(state).numpy()
    np.testing.assert_array_equal(after[untouched],
                                  before.numpy()[untouched])
    assert (after[touched] != before.numpy()[touched]).any()
    if storage == "int8":
        assert misses > 100                     # the fma decides them
        base = (int(state.page_to_shard[zero_page]) * eng.cfg.rows_per_shard
                + int(state.page_to_slot[zero_page]) * ps)
        np.testing.assert_array_equal(state.cold[base:base + ps].numpy(),
                                      cold0[base:base + ps].numpy())


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_all_pad_batch_is_a_bitwise_noop(storage, mesh11):
    jeng, jstate, eng, state, _ = _carried(storage, mesh11)
    state.hot[0, 0] = -0.0                 # a pad writes no x + 0.0
    before = [x.clone() for x in (state.cold, state.hot)]
    rows = np.full(32, upd.PAD_ROW, np.int32)
    out = eng.apply_deltas(state, rows, np.ones((32, DIM), np.float32))
    assert out is state                    # in place
    for a, b in zip((state.cold, state.hot), before):
        assert torch.equal(a, b)
    assert torch.signbit(state.hot[0, 0])


@pytest.mark.parametrize("meshname", ["mesh11", "mesh1d"])
def test_requant_hot_pages_matches_reference(meshname, request):
    """After deltas pull hot rows off their grid, snapping the hot pages
    (with pads and a cold page in the list) equals the reference's; fp32
    is a no-op in both."""
    mesh = request.getfixturevalue(meshname)
    for storage in ("int8", "fp32"):
        jeng, jstate, eng, state, rng = _carried(storage, mesh)
        batches = [_batch(eng, state, rng, storage)]
        jstate, state = _apply_both(jeng, jstate, eng, state, batches, mesh)
        shard = state.page_to_shard.numpy()
        hot = np.nonzero(shard == HOT_SHARD)[0]
        cold = np.nonzero(shard != HOT_SHARD)[0]
        pages = np.concatenate([hot, [-1, int(cold[0]), -1]]).astype(np.int32)
        before = state.hot.clone()
        with mesh:
            jstate = jeng.requant_hot_pages(jstate, jnp.asarray(pages))
        state = eng.requant_hot_pages(state, pages)
        _assert_same(jeng, jstate, eng, state, mesh, storage)
        assert torch.equal(state.hot, before) == (storage == "fp32")


def test_apply_deltas_errors_and_signatures_match_reference(mesh11):
    """Bad shapes and a row past the padded address space raise in both
    (the port names the row); a negative row is a pad; one signature per
    (storage, U), so repeated applies add no trace."""
    jeng, jstate, eng, state, _ = _carried("fp32", mesh11)
    bad = [(np.zeros(4, np.int32), np.zeros((5, DIM), np.float32)),
           (np.zeros(4, np.int32), np.zeros((4, 8), np.float32)),
           (np.zeros((2, 2), np.int32), np.zeros((4, DIM), np.float32)),
           (np.asarray([eng.cfg.padded_rows], np.int32),
            np.zeros((1, DIM), np.float32))]
    for rows, d in bad:
        with pytest.raises(ValueError), mesh11:
            jeng.apply_deltas(jstate, jnp.asarray(rows), jnp.asarray(d))
        with pytest.raises(ValueError):
            eng.apply_deltas(state, rows, d)
    with pytest.raises(ValueError, match=str(eng.cfg.padded_rows + 5)):
        eng.apply_deltas(state, np.asarray([eng.cfg.padded_rows + 5]),
                         np.zeros((1, DIM), np.float32))
    eng.reset_plan_stats()
    for _ in range(3):
        eng.apply_deltas(state, np.arange(-1, 7, dtype=np.int32),
                         np.ones((8, DIM), np.float32))
    assert eng.plan_stats()["traces"] == 1
    eng.reset_plan_stats()
    eng.apply_deltas(state, np.arange(8, dtype=np.int32),
                     np.ones((8, DIM), np.float32))
    assert eng.plan_stats()["traces"] == 0


@pytest.mark.cuda
def test_cuda_apply_deltas_matches_its_plain_version_on_the_card():
    """The kernel against its plain version on the card, bitwise: fp32 and
    int8 tables, 1 and 4 shards, D = 16 (float4 path) and 18 (scalar),
    FMA-discriminating deltas, a zero-scale page and pads
    (chip_smoke.py runs the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    rng = np.random.default_rng(0)
    for storage in ("fp32", "int8"):
        for S in (1, 4):
            for D in (16, 18):
                eng, _ = engine_for_tables([300, 200], D, device="cuda",
                                           hot_fraction=HOT,
                                           page_bytes=PAGE_BYTES,
                                           storage=storage, n_shards=S)
                st = eng.init_state(torch.Generator("cuda").manual_seed(0))
                P = eng.cfg.num_pages
                st.page_to_shard[rng.permutation(P)[:eng.cfg.hot_pages]] = -1
                st.page_to_slot[st.page_to_shard == -1] = torch.arange(
                    int((st.page_to_shard == -1).sum()), device="cuda",
                    dtype=torch.int32)
                st.page_scales[1] = 0.0
                rows, d = upd.coalesce_deltas(
                    rng.integers(-3, eng.cfg.padded_rows, 200),
                    rng.normal(size=(200, D)).astype(np.float32) * 0.01)
                args = [torch.as_tensor(x, device="cuda") for x in (rows, d)]
                a = [x.clone() for x in (st.cold, st.hot)]
                b = [x.clone() for x in (st.cold, st.hot)]
                common = (st.page_scales, st.page_to_shard, st.page_to_slot,
                          *args, eng.cfg.page_size, eng.cfg.rows_per_shard)
                ops.apply_deltas(*a, *common)
                ops.apply_deltas(*b, *common, impl="torch")
                torch.cuda.synchronize()
                assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# Runtime
# ---------------------------------------------------------------------------

SIZES, POOLINGS, SLO_MS, N = (8, 16), (4, 8), 50.0, 48
SVC = dict(base_s=4e-3, per_row_s=2.5e-4)


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
def test_runtime_with_updates_matches_reference(storage, mesh11, tmp_path):
    """Both packages' runtimes over their own bindings with a live update
    stream, a WAL and (int8, with requant-demote scans every 2 batches) a
    checkpointer, one pinned service model: identical flush traces, equal
    updater reports and staleness summaries, equal final dense tables and
    WAL bytes; no signature new after warmup in the port."""
    jcfg, cfg = jreduced(jget_config("rmc1")), reduced(get_config("rmc1"))
    maint = (dict(observe_every=2, replan_every=4) if storage == "fp32"
             else dict(observe_every=2, replan_every=0))
    ucfg = dict(capacity=32, demote_every=2 if storage == "int8" else 0,
                drift_threshold=0.005, hotness_guard=0.0)
    jb = jloadgen.bind_model(jcfg, mesh11, storage=storage)
    with mesh11:          # a hot tier for the updates to drift
        for r in jloadgen.request_stream(jcfg, _load(
                jloadgen, jrequest.ArrivalConfig, storage))[:16]:
            jb.observe({"indices": r.features["indices"][None]})
        jb.replan()
    jstate0 = jb.state

    # the reference
    jload = _load(jloadgen, jrequest.ArrivalConfig, storage)
    svc = jbatcher.FixedServiceModel(**SVC)
    ex = _RefPinned(jb, jloadgen.make_padder(jcfg), svc)
    jrt = jruntime.ServingRuntime(
        ex, jbatcher.DynamicBatcher(jbatcher.BatcherConfig(
            batch_sizes=SIZES, poolings=POOLINGS, max_wait_ms=SLO_MS / 2)),
        ex.padder, jruntime.RuntimeConfig(**maint), service_model=svc)
    jupdater = jsupd.StreamingUpdater(
        jb, jloadgen.update_stream(jcfg, jload), jupd.UpdateConfig(**ucfg),
        wal=JWriteAheadLog(str(tmp_path / "j.wal")))
    with mesh11:
        if storage == "int8":
            jb.attach_checkpointer(JCheckpointer(str(tmp_path / "jck")))
        jrt.warmup(jloadgen.dummy_request_factory(jcfg, storage=storage))
        jupdater.warmup()
        jrt.updater = jupdater
        jb.reset_plan_stats()
        js = jrt.run(jruntime.OpenLoopSource(
            jloadgen.request_stream(jcfg, jload)))
        jrep = jupdater.report()
        jupdater.drain()
        jdense = np.asarray(jb.engine.to_dense(jb.state))

    # the port, from the reference's starting state
    load = _load(loadgen, ArrivalConfig, storage)
    rt, pb = srv.build_serving(
        cfg, "cpu", batch_sizes=SIZES, poolings=POOLINGS, slo_ms=SLO_MS,
        storage=storage, runtime_cfg=RuntimeConfig(**maint),
        service=batcher.FixedServiceModel(**SVC))
    pb.model.load_state_dict(params_from_numpy(
        jax.tree.map(np.asarray, jb.params)))
    pb.state = pb.engine.pack_state(
        *map(np.asarray, jb.engine.export_state(jstate0)),
        table=PageTable(np.asarray(jstate0.page_to_shard),
                        np.asarray(jstate0.page_to_slot)),
        counts=np.asarray(jstate0.counts))
    updater = StreamingUpdater(
        pb, loadgen.update_stream(cfg, load), upd.UpdateConfig(**ucfg),
        wal=WriteAheadLog(str(tmp_path / "p.wal")))
    if storage == "int8":
        pb.attach_checkpointer(Checkpointer(str(tmp_path / "pck")))
    s = srv.run_offered_load(rt, pb, cfg, load, updater=updater)
    assert _trace(rt) == _trace(jrt)
    assert s["updates"] == jrep
    assert s["staleness"] == js["staleness"]
    assert s["maintenance_calls"] == js["maintenance_calls"]
    assert s["steady_traces"] == 0 and s["served"] == N
    rep = s["updates"]
    assert rep["applied_batches"] > 0 and rep["wal_records"] >= 0
    if storage == "int8":
        assert rep["demoted_pages"] > 0 and rep["snapshots"] > 0
    else:
        assert rep["wal_records"] == rep["applied_batches"]
    updater.drain()
    assert updater.report() == jupdater.report()
    assert updater.report()["pending_batches"] == 0
    np.testing.assert_array_equal(pb.engine.to_dense(pb.state).numpy(),
                                  jdense)
    assert ((tmp_path / "p.wal").read_bytes()
            == (tmp_path / "j.wal").read_bytes())
    got = np.asarray([rt.executor.scores[i] for i in range(N)])
    want = np.asarray([ex.scores[i] for i in range(N)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_updater_drain_gate_and_refusal_match_reference(mesh11):
    """``apply_every`` skips a boundary but still samples staleness;
    ``drain`` flushes the tail; requant-demote with a WAL and no
    checkpointer refuses: as the reference's updater does."""
    jcfg, cfg = jreduced(jget_config("rmc1")), reduced(get_config("rmc1"))
    pb = loadgen.bind_model(cfg, "cpu")
    rng = np.random.default_rng(0)
    total = int(pb.engine.cfg.total_rows)
    raw = [(0.1 * (i + 1), rng.integers(0, total, 8),
            rng.normal(size=(8, cfg.emb_dim)).astype(np.float32))
           for i in range(4)]
    upd_ = StreamingUpdater(pb, [UpdateBatch(i + 1, t, r, d)
                                 for i, (t, r, d) in enumerate(raw)],
                            upd.UpdateConfig(capacity=16, apply_every=2))
    upd_.warmup()
    m = ServingMetrics()
    assert upd_.on_batch(0.15, m) == 0.0 and upd_.applied_batches == 0
    assert m.staleness_rows == [8.0]
    assert upd_.on_batch(0.25, m) > 0.0 and upd_.applied_batches == 2
    assert upd_.drain() == 2 and upd_.applied_batches == 4
    assert pb.update_seq == 4 and upd_.report()["pending_batches"] == 0
    with pytest.raises(RuntimeError, match="checkpointer"):
        StreamingUpdater(pb, [], upd.UpdateConfig(capacity=8),
                         wal=_NoWal()).requant_demote()
    jb = jloadgen.bind_model(jcfg, mesh11)
    with pytest.raises(RuntimeError, match="checkpointer"):
        jsupd.StreamingUpdater(jb, [], jupd.UpdateConfig(capacity=8),
                               wal=_NoWal()).requant_demote()


class _NoWal:
    """A stand-in WAL: the refusal checks only that one is attached."""

    def __len__(self):
        return 0


def test_serve_cli_runs_updates_and_raises_for_unported(tmp_path, capsys):
    """The CLI's --update-qps / --update-batch / --wal run on the CPU
    (every request served, applied batches all in the WAL, finite
    staleness), and with --scrub on top: the scrubber audits every batch,
    repairs nothing on a clean store, and the update stream is the same
    (how much of it drains within the run depends on the measured service
    times)."""
    wal = str(tmp_path / "u.wal")
    out = srv.main(["--device", "cpu", "--requests", "96", "--update-qps",
                    "400", "--update-batch", "32", "--wal", wal,
                    "--storage", "int8"])
    rep = out["updates"]
    assert out["served"] == 96 and out["steady_traces"] == 0
    assert rep["applied_batches"] == rep["wal_records"] > 0
    assert len(WriteAheadLog(wal)) == rep["applied_batches"]
    assert np.isfinite(out["staleness"]["seconds_behind_p99"])
    text = capsys.readouterr().out
    assert "-- streaming updates --" in text and "seconds_behind" in text
    wal2 = str(tmp_path / "s.wal")
    out2 = srv.main(["--device", "cpu", "--requests", "96", "--update-qps",
                     "400", "--update-batch", "32", "--wal", wal2,
                     "--storage", "int8", "--scrub",
                     "--scrub-pages-per-cycle", "2"])
    u = out2["updates"]
    assert u["generated_batches"] == rep["generated_batches"]
    assert u["applied_batches"] + u["pending_batches"] == \
        u["generated_batches"] and u["applied_batches"] > 0
    assert out2["scrub_run"]["cycles"] == out2["batches"]
    assert out2["scrub_run"]["pages_per_cycle"] == 2
    assert out2["scrub_run"]["pages_detected"] == 0
    assert "-- scrub --" in capsys.readouterr().out
