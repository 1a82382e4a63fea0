"""The port's maintenance path against the JAX package: ``observe`` counts,
the planner's page tables, ``migrate``'s leaves (fp32 and int8) and
placement invariance across observe/replan, plus the planner's cost at
RMC4's page count and the serving seam that places the hot tier.

Page tables are held equal to the reference planner's on tie-free counts:
on tied counts the reference picks by Python set order and the port by the
lowest page id (``repro_torch/core/planner.py``), which moves no lookup.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import planner as jplanner
from repro.core.paging import PageTable as JPageTable
from repro.core.paging import PagingConfig as JPagingConfig
from repro.core.paging import placement_gather_indices as jgather
from repro.core.pifs import engine_for_tables as jengine_for_tables
from repro.distributed.sharding import make_mesh

from repro_torch.configs import get_config, reduced
from repro_torch.core import planner
from repro_torch.core.paging import (HOT_SHARD, PageTable, PagingConfig,
                                     initial_page_table,
                                     placement_gather_indices)
from repro_torch.core.pifs import engine_for_tables
from repro_torch.launch import serve as srv
from repro_torch.models import dlrm
from repro_torch.serving import loadgen
from repro_torch.serving.request import ArrivalConfig

VOCABS, DIM, PAGE_BYTES, HOT = [300, 200], 16, 512, 0.2


@pytest.fixture(scope="module")
def mesh11():
    return make_mesh((1, 1), ("data", "model"))


def _stream(cfg, n, seed):
    return loadgen.request_stream(cfg, loadgen.LoadConfig(
        n, ArrivalConfig(200.0, seed=seed), seed=seed))


def _fused(b):
    return dlrm.make_serve_step(b.model, b.engine, front_end="fused")


def _ids(rng, offs, B=6, L=5):
    cols = [np.minimum(rng.zipf(1.3, (B, L)) - 1, v - 1) + o
            for v, o in zip(VOCABS, offs)]
    return np.stack(cols, axis=1).astype(np.int32)


def _np_table(t):
    return JPageTable(np.asarray(t.page_to_shard),
                      np.asarray(t.page_to_slot))


@pytest.mark.parametrize("weighted", [False, True])
def test_observe_counts_match_reference(weighted, mesh11):
    """Weight-0 entries do not count; ids past the last page are dropped."""
    jeng, offs = jengine_for_tables(VOCABS, DIM, mesh11, hot_fraction=HOT,
                                    page_bytes=PAGE_BYTES)
    eng, _ = engine_for_tables(VOCABS, DIM, device="cpu", hot_fraction=HOT,
                               page_bytes=PAGE_BYTES)
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    state = eng.init_state(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    for _ in range(3):
        idx = _ids(rng, offs)
        idx[0, 0, 0] = eng.cfg.padded_rows + 3 * eng.cfg.page_size
        w = ((rng.random(idx.shape) < 0.7).astype(np.float32) if weighted
             else None)
        jstate = jeng.observe(jstate, jnp.asarray(idx),
                              None if w is None else jnp.asarray(w))
        state = eng.observe(state, torch.as_tensor(idx),
                            None if w is None else torch.as_tensor(w))
        np.testing.assert_array_equal(state.counts.numpy(),
                                      np.asarray(jstate.counts))
    assert state.counts.sum() > 0


def _tie_free_counts(rng, P, touched=0.6):
    c = rng.permutation(P).astype(np.float64) + 1.0
    c[rng.random(P) > touched] = 0.0          # untouched pages: ties at 0
    return c


@pytest.mark.parametrize("n_shards,sticky", [(1, True), (3, True),
                                             (3, False), (4, True)])
def test_plan_page_tables_match_reference(n_shards, sticky):
    """First re-plan (empty hot tier) and the sticky second one, on counts
    with no ties among the pages the planner ranks; several shards so the
    LPT spreading and the warm-shard trigger run too."""
    kw = dict(total_rows=4000, dim=16, n_shards=n_shards, page_bytes=512,
              hot_fraction=0.1)
    cfg, jcfg = PagingConfig(**kw), JPagingConfig(**kw)
    rng = np.random.default_rng(n_shards)
    pcfg = planner.PlannerConfig(sticky=sticky)
    jpcfg = jplanner.PlannerConfig(sticky=sticky)
    t0 = initial_page_table(cfg)
    table, jtable = t0, JPageTable(t0.page_to_shard.numpy(),
                                   t0.page_to_slot.numpy())
    for step in range(3):
        counts = _tie_free_counts(rng, cfg.num_pages, touched=1.0)
        if step == 2:                     # a warm shard: most load on one
            warm = np.asarray(jtable.page_to_shard) == 0
            counts[warm] = counts[warm] * 5 + 0.5      # still tie-free
        table, stats = planner.plan(cfg, table, counts, pcfg)
        jtable, jstats = jplanner.plan(jcfg, jtable, counts, jpcfg)
        np.testing.assert_array_equal(table.page_to_shard,
                                      np.asarray(jtable.page_to_shard))
        np.testing.assert_array_equal(table.page_to_slot,
                                      np.asarray(jtable.page_to_slot))
        assert stats == jstats
        assert (np.asarray(table.page_to_shard) == HOT_SHARD).sum() == \
            cfg.hot_pages
    assert planner.needs_migration(cfg, table, counts, pcfg) == \
        jplanner.needs_migration(jcfg, jtable, counts, jpcfg)


def test_plan_breaks_ties_by_page_id():
    cfg = PagingConfig(total_rows=640, dim=16, n_shards=1, page_bytes=512,
                       hot_fraction=0.04)
    assert cfg.hot_pages == 3
    counts = np.zeros(cfg.num_pages)
    counts[[7, 3, 11]] = 5.0                  # three tied pages, one slot
    counts[[1, 2]] = 9.0
    table, _ = planner.plan(cfg, initial_page_table(cfg), counts)
    hot = np.nonzero(table.page_to_shard == HOT_SHARD)[0]
    assert list(hot[np.argsort(table.page_to_slot[hot])]) == [1, 2, 3]


def _random_table(rng, cfg):
    """A valid placement: a random hot set in random hot slots, the rest
    in random distinct cold slots (cold->cold moves included)."""
    P = cfg.num_pages
    shard = np.zeros(P, np.int32)
    hot = rng.permutation(P)[: cfg.hot_pages]
    shard[hot] = HOT_SHARD
    slot = np.zeros(P, np.int32)
    slot[hot] = rng.permutation(cfg.hot_pages)
    cold = np.nonzero(shard != HOT_SHARD)[0]
    slot[cold] = rng.permutation(cfg.pages_per_shard)[: cold.size]
    return shard, slot


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_migrate_leaves_match_reference_bitwise(storage, mesh11):
    """From the same packed start, two migrations (promotions, demotions,
    hot->hot and cold->cold moves): the port's leaves equal the reference
    ``migrate``'s bit for bit, counts decayed, and the gather maps match."""
    jeng, _ = jengine_for_tables(VOCABS, DIM, mesh11, hot_fraction=HOT,
                                 page_bytes=PAGE_BYTES, storage=storage)
    eng, _ = engine_for_tables(VOCABS, DIM, device="cpu", hot_fraction=HOT,
                               page_bytes=PAGE_BYTES, storage=storage)
    rng = np.random.default_rng(5)
    start = _random_table(rng, eng.cfg)
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    codes, values, scales = map(np.asarray, jeng.export_state(jstate))
    counts = rng.integers(0, 9, eng.cfg.num_pages).astype(np.float32)
    jstate = jeng.pack_state(codes, values, scales,
                             table=JPageTable(*map(jnp.asarray, start)),
                             counts=jnp.asarray(counts))
    state = eng.pack_state(codes, values, scales,
                           table=PageTable(*start), counts=counts)
    for _ in range(2):
        new = _random_table(rng, eng.cfg)
        for a, b in zip(placement_gather_indices(
                eng.cfg, state.page_table, PageTable(*new)),
                jgather(jeng.cfg, _np_table(jstate.page_table),
                        JPageTable(*new))):
            np.testing.assert_array_equal(a, b)
        jstate = jeng.migrate(jstate, JPageTable(*map(jnp.asarray, new)))
        state = eng.migrate(state, PageTable(*new))
        for f in ("cold", "hot", "page_scales", "page_to_shard",
                  "page_to_slot", "counts"):
            np.testing.assert_array_equal(getattr(state, f).numpy(),
                                          np.asarray(getattr(jstate, f)), f)
    assert state.cold.dtype == (torch.int8 if storage == "int8"
                                else torch.float32)


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_lookups_unchanged_across_observe_replan(storage):
    """Tied zipf histograms (where the port's tie-break may place pages
    otherwise than the reference): every row, and every one-id-per-bag
    lookup, is bitwise unchanged across three observe/replan cycles.
    Many-id bags pool each tier apart, so a page that changes tier may
    move their last bit: they stay within 1e-6."""
    eng, offs = engine_for_tables(VOCABS, DIM, device="cpu",
                                  hot_fraction=HOT, page_bytes=PAGE_BYTES,
                                  storage=storage)
    state = eng.init_state(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    probe = torch.as_tensor(_ids(rng, offs, B=40))
    singles = probe.reshape(-1, 1, 1)
    dense = eng.to_dense(state)
    before = eng.lookup(state, singles)
    bags = eng.lookup(state, probe)
    promoted = 0
    for cycle in range(3):
        idx = _ids(rng, offs) if cycle % 2 == 0 else (
            _ids(rng, offs) * 7 + 3) % sum(VOCABS)
        state = eng.observe(state, torch.as_tensor(idx.astype(np.int32)))
        state, stats = eng.plan_and_migrate(state)
        promoted = max(promoted, stats["hot_pages"])
        np.testing.assert_array_equal(eng.to_dense(state).numpy(),
                                      dense.numpy())
        np.testing.assert_array_equal(eng.lookup(state, singles).numpy(),
                                      before.numpy())
        np.testing.assert_allclose(eng.lookup(state, probe).numpy(),
                                   bags.numpy(), rtol=0, atol=1e-6)
    assert promoted == eng.cfg.hot_pages


def test_planner_second_replan_at_rmc4_scale_is_fast():
    """RMC4 fp32's page count (8 tables x 1,048,576 rows, 4096-byte pages:
    1,048,576 pages, 52,428 hot), numpy counts only: the sticky second
    re-plan, which the reference's quadratic victim search cannot finish
    at this size, takes under 10 s."""
    cfg4 = get_config("rmc4")
    cfg = PagingConfig(total_rows=cfg4.n_tables * cfg4.emb_num,
                       dim=cfg4.emb_dim, n_shards=1, hot_fraction=0.05)
    assert (cfg.num_pages, cfg.hot_pages) == (1_048_576, 52_428)
    rng = np.random.default_rng(0)
    counts = rng.zipf(1.2, cfg.num_pages).astype(np.float64)
    table, _ = planner.plan(cfg, initial_page_table(cfg), counts)
    counts = counts * 0.5 + rng.zipf(1.2, cfg.num_pages)
    t = time.perf_counter()
    table2, stats = planner.plan(cfg, table, counts)
    assert time.perf_counter() - t < 10.0
    hot = table2.page_to_shard == HOT_SHARD
    assert hot.sum() == cfg.hot_pages and stats["hot_pages"] == cfg.hot_pages
    assert np.unique(table2.page_to_slot[hot]).size == cfg.hot_pages
    cold = ~hot
    assert np.unique(table2.page_to_slot[cold]).size == cold.sum()


def test_bound_hot_tier_holds_the_most_observed_pages():
    """bind_model places the hot tier with observe over the profile and
    plan_and_migrate: the hot pages are the most observed ones."""
    cfg = reduced(get_config("rmc1"))
    reqs = _stream(cfg, 8, seed=0)
    b = loadgen.bind_model(cfg, "cpu", hot_fraction=0.25, profile=reqs[:2])
    c = b.engine.cfg
    hot = np.nonzero(b.state.page_to_shard.numpy() == HOT_SHARD)[0]
    assert hot.size == c.hot_pages
    counts = np.bincount(np.concatenate(
        [r.features["indices"].reshape(-1) for r in reqs[:2]])
        // c.page_size, minlength=c.num_pages)
    cold = np.setdiff1d(np.arange(c.num_pages), hot)
    assert counts[hot].min() >= counts[cold].max()
    np.testing.assert_array_equal(b.state.counts.numpy(), counts * 0.5)
    assert sorted(b.state.page_to_slot.numpy()[hot]) == list(range(hot.size))


def test_binding_maintenance_seam():
    """serve() runs observe and replan on the reference cadence, off the
    service time; the dedup probe records per-bucket factors."""
    cfg = reduced(get_config("rmc1"))
    reqs = _stream(cfg, 48, seed=1)
    b = loadgen.bind_model(cfg, "cpu", profile=reqs[:8])
    out = srv.serve(b, _fused(b), reqs, 8, observe_every=2,
                    replan_every=3)
    assert (out["batches"], out["observes"], out["replans"]) == (6, 3, 2)
    rep = b.dedup_report()
    assert list(rep) == [f"8x{cfg.n_tables}x{cfg.pooling}"]
    assert rep[next(iter(rep))]["batches"] == 3
    assert rep[next(iter(rep))]["factor"] >= 1.0
    # the same run with no maintenance scores the same requests the same
    b2 = loadgen.bind_model(cfg, "cpu", profile=reqs[:8])
    quiet = srv.serve(b2, _fused(b2), reqs, 8, observe_every=0,
                      replan_every=0)
    np.testing.assert_allclose(out["scores"], quiet["scores"], rtol=0,
                               atol=1e-6)
