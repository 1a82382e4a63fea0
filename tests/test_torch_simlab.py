"""The port's paper comparison against the reference: the simulator, the
TCO / power / PPW analysis, the buffer policies and profiler, the trace
helpers and batch generators, and the two engine examples.

Tolerances: none.  The simulator, TCO, policies, traces and batches are
numpy (or Python) in both packages, so every field must be equal (arrays
``array_equal``, floats ``==``); ``update_counts`` adds ones in index
order in both, so it is bitwise equal too.  The examples' cross-checks
hold pifs == pond within the reference's 1e-5 and the measured duplicate
factor equal to the reference engine's on the same ids.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import hot_cache as jhc
from repro.core.pifs import engine_for_tables as jengine_for_tables
from repro.data import synth as jsynth
from repro.data import traces as jtraces
from repro.simlab import devices as jdev
from repro.simlab import simulator as jsim
from repro.simlab import tco as jtco

from repro_torch.configs import get_config, reduced
from repro_torch.core import hot_cache
from repro_torch.data import synth, traces
from repro_torch.examples import pifs_vs_pond, quickstart
from repro_torch.simlab import devices, simulator, tco


def _same_result(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for k in da:
        if isinstance(da[k], np.ndarray):
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)
        else:
            assert da[k] == db[k], k


def _small_trace(distribution="zipfian", seed=0):
    arr = traces.make_trace(distribution, n_rows=2048, n_tables=4,
                            pooling=8, batch=64, n_batches=4, seed=seed)
    return traces.flatten_trace(arr.reshape(-1, 4, 8), 2048)


# (factory, kwargs): every system, the Fig. 12e ablations, the three
# buffer policies at a buffer small enough to miss, both granularities
SYSTEMS = [("make_system", {"name": n}) for n in jsim.ALL_SYSTEMS] + [
    ("pifs", {"pc": False}), ("pifs", {"pm": False}),
    ("pifs", {"buffer_kb": 0}), ("pifs", {"ooo": False}),
    ("pifs", {"buffer_policy": "htr", "buffer_kb": 16}),
    ("pifs", {"buffer_policy": "lru", "buffer_kb": 16}),
    ("pifs", {"buffer_policy": "fifo", "buffer_kb": 16}),
    ("pifs", {"migration_granularity": "line"}),
    ("pifs", {"migration_granularity": "page"}),
]


def _system(mod, hw, factory, kw):
    if factory == "make_system":
        return mod.make_system(kw["name"], hw)
    return getattr(mod, factory)(hw, **kw)


@pytest.mark.parametrize("factory,kw", SYSTEMS,
                         ids=[f"{f}-{'-'.join(map(str, k.values()))}"
                              for f, k in SYSTEMS])
@pytest.mark.parametrize("n_devices", [4, 8])
def test_simulate_equals_reference(factory, kw, n_devices):
    flat = _small_trace()
    hw, jhw = devices.HardwareParams(), jdev.HardwareParams()
    assert dataclasses.asdict(hw) == dataclasses.asdict(jhw)
    sys_p, sys_j = _system(simulator, hw, factory, kw), \
        _system(jsim, jhw, factory, kw)
    assert dataclasses.asdict(sys_p) == dataclasses.asdict(sys_j)
    for row_bytes in (64, 128):
        got = simulator.simulate(flat, row_bytes, 8, sys_p, hw,
                                 n_rows_total=4 * 2048,
                                 n_devices=n_devices)
        want = jsim.simulate(flat, row_bytes, 8, sys_j, jhw,
                             n_rows_total=4 * 2048, n_devices=n_devices)
        _same_result(got, want)


def test_simulate_other_distributions_and_capacity():
    hw, jhw = devices.HardwareParams(), jdev.HardwareParams()
    for dist in ("uniform", "normal", "random"):
        flat = _small_trace(dist, seed=3)
        for name in jsim.ALL_SYSTEMS:
            got = simulator.simulate(flat, 128, 8,
                                     simulator.make_system(name, hw), hw,
                                     local_capacity_frac=0.2)
            want = jsim.simulate(flat, 128, 8, jsim.make_system(name, jhw),
                                 jhw, local_capacity_frac=0.2)
            _same_result(got, want)
            assert got.speedup_over(got) == 1.0


@pytest.mark.parametrize("arch", ["rmc1", "rmc2", "rmc3", "rmc4"])
def test_tco_and_amdahl_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert tco.model_memory_gb(cfg) == jtco.model_memory_gb(jcfg)
    assert tco.tco_comparison(cfg) == jtco.tco_comparison(jcfg)
    assert tco.tco_comparison(cfg, (1, 8), 512.0) == \
        jtco.tco_comparison(jcfg, (1, 8), 512.0)
    for batch in (1, 64, 2048):
        assert simulator.sls_fraction_for(cfg, batch) == \
            jsim.sls_fraction_for(jcfg, batch)
    for sp, fr in ((2.0, 0.5), (3.89, 0.9), (1.0, 0.0)):
        assert simulator.e2e_speedup(sp, fr) == jsim.e2e_speedup(sp, fr)


def test_power_area_ppw_and_reports_equal_reference():
    assert tco.power_area_table() == jtco.power_area_table()
    for s in (0.0, 0.05, 0.25, 0.5, 1.0):
        assert tco.performance_per_watt(s) == jtco.performance_per_watt(s)
    for mem in (64.0, 2048.0):
        for a, b in ((tco.pifs_tco(mem), jtco.pifs_tco(mem)),
                     (tco.gpu_tco(mem, 4), jtco.gpu_tco(mem, 4))):
            assert (a.capex, a.opex, a.total) == (b.capex, b.opex, b.total)
    assert dataclasses.asdict(devices.CostParams()) == \
        dataclasses.asdict(jdev.CostParams())
    assert dataclasses.asdict(devices.SiliconParams()) == \
        dataclasses.asdict(jdev.SiliconParams())
    assert devices.CostParams().opex(500.0) == jdev.CostParams().opex(500.0)


@pytest.mark.parametrize("name", ["htr", "lru", "fifo"])
@pytest.mark.parametrize("capacity", [1, 16, 100])
def test_policy_hit_sequences_equal_reference(name, capacity):
    keys = _small_trace(seed=1)[:6000]
    pol, jpol = hot_cache.make_policy(name, capacity), \
        jhc.make_policy(name, capacity)
    got = [pol.access(int(k)) for k in keys]
    want = [jpol.access(int(k)) for k in keys]
    assert got == want
    assert pol.run(keys[:500]) == jpol.run(keys[:500])
    assert (pol.hits, pol.accesses) == (jpol.hits, jpol.accesses)


def test_htr_reranks_and_unknown_policy():
    keys = _small_trace(seed=2)[:5000]
    pol = hot_cache.HTRCache(32, rerank_every=64, decay=0.9)
    jpol = jhc.HTRCache(32, rerank_every=64, decay=0.9)
    assert [pol.access(int(k)) for k in keys] == \
        [jpol.access(int(k)) for k in keys]
    assert pol._resident == jpol._resident
    assert pol._freq == jpol._freq
    with pytest.raises(ValueError):
        hot_cache.make_policy("arc", 4)


def test_access_profiler_equals_reference():
    rng = np.random.default_rng(4)
    prof, jprof = hot_cache.AccessProfiler(500), jhc.AccessProfiler(500)
    for _ in range(5):
        items = np.minimum(rng.zipf(1.3, 400) - 1, 499)
        prof.observe(items)
        jprof.observe(items)
    np.testing.assert_array_equal(prof.counts, jprof.counts)
    for k in (1, 7, 50, 500, 600):
        np.testing.assert_array_equal(prof.hottest(k), jprof.hottest(k))


@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_update_counts_equals_reference(decay):
    rng = np.random.default_rng(5)
    counts = (rng.random(300) * 10).astype(np.float32)
    pages = rng.integers(-310, 320, (7, 9)).astype(np.int32)
    got = hot_cache.update_counts(torch.as_tensor(counts),
                                  torch.as_tensor(pages), decay)
    want = jhc.update_counts(jnp.asarray(counts), jnp.asarray(pages), decay)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32


def test_trace_helpers_equal_reference():
    for dist in ("zipfian", "uniform", "normal", "random"):
        got = traces.make_trace(dist, 1000, n_tables=3, pooling=5, batch=7,
                                n_batches=4, seed=9)
        want = jtraces.make_trace(dist, 1000, n_tables=3, pooling=5,
                                  batch=7, n_batches=4, seed=9)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(traces.flatten_trace(got[0], 1000),
                                      jtraces.flatten_trace(want[0], 1000))
    cfg = traces.TraceConfig(n_rows=500, n_tables=2, pooling=3, batch=4)
    jcfg = jtraces.TraceConfig(n_rows=500, n_tables=2, pooling=3, batch=4)
    for a, b in zip(traces.TraceGenerator(cfg).stream(3),
                    jtraces.TraceGenerator(jcfg).stream(3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dist", ["zipfian", "uniform", "normal", "random"])
def test_dlrm_batches_equal_reference(dist):
    for arch in ("rmc1", "rmc2"):
        cfg, jcfg = reduced(get_config(arch)), jget_config(arch)
        from repro.configs import reduced as jreduced
        jcfg = jreduced(jcfg)
        for a, b in zip(synth.dlrm_batches(cfg, 9, 3, dist, seed=2),
                        jsynth.dlrm_batches(jcfg, 9, 3, dist, seed=2)):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                assert a[k].dtype == b[k].dtype
    for storage in ("fp32", "int8"):
        for arch in ("rmc1", "rmc4"):
            assert synth._padded_rows(get_config(arch), storage=storage) == \
                jsynth._padded_rows(jget_config(arch), storage=storage)


@pytest.mark.parametrize("arch", ["sasrec", "bst", "autoint", "dcn-v2"])
@pytest.mark.parametrize("kind", ["train", "serve"])
def test_rec_batches_equal_reference(arch, kind):
    from repro.configs import reduced as jreduced
    cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
    for a, b in zip(synth.rec_batches(cfg, 6, 3, seed=4, kind=kind),
                    jsynth.rec_batches(jcfg, 6, 3, seed=4, kind=kind)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype


def test_paper_comparison_equals_reference_example():
    """The example's RMC4 trace (6 batches of 512, 196,608 accesses) and
    all five systems, as ``examples/pifs_vs_pond.py`` computes them; the
    paper's ordering holds (PIFS fastest, Pond slowest)."""
    model, jmodel = get_config("rmc4"), jget_config("rmc4")
    flat = pifs_vs_pond.paper_trace(model)
    gen = jtraces.TraceGenerator(jtraces.TraceConfig(
        n_rows=jmodel.emb_num, n_tables=jmodel.n_tables,
        pooling=jmodel.pooling, batch=512, distribution="zipfian", seed=0))
    arr = np.stack([gen.next_batch() for _ in range(6)])
    jflat = jtraces.flatten_trace(arr.reshape(-1, 8, 8), jmodel.emb_num)
    np.testing.assert_array_equal(flat, jflat)
    assert flat.size == 196_608
    got = pifs_vs_pond.simulate_all(model, flat)
    jhw = jdev.HardwareParams()
    for name in jsim.ALL_SYSTEMS:
        want = jsim.simulate(jflat, jmodel.emb_dim, jmodel.pooling,
                             jsim.make_system(name, jhw), jhw,
                             n_rows_total=jmodel.emb_num * jmodel.n_tables)
        _same_result(got[name], want)
    t = {k: r.total_us for k, r in got.items()}
    assert min(t, key=t.get) == "pifs" and max(t, key=t.get) == "pond"
    assert t["pond"] > t["pond_pm"] > t["beacon"] > t["recnmp"] > t["pifs"]


@pytest.mark.parametrize("storage,dedup", [("fp32", "off"), ("int8", "on"),
                                           ("fp32", "auto")])
def test_engine_cross_check_runs_on_cpu(storage, dedup, mesh1d):
    model = get_config("rmc4")
    out = pifs_vs_pond.engine_cross_check(model, storage, dedup, "cuda",
                                          "cpu")
    assert out["n_rows"] == 8192
    assert out["pifs"].shape == (64, 8, 128)
    assert bool(torch.isfinite(out["pifs"]).all())
    # the measured factor is the reference engine's on the same ids, at
    # dp = 1 (the reference example's dp = 2 counts each half apart)
    jeng, joffs = jengine_for_tables([8192] * 8, dim=128, mesh=mesh1d,
                                     hot_fraction=0.05, storage=storage,
                                     dedup=dedup)
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    _, _, idx, _ = pifs_vs_pond.cross_check_setup(model, storage, dedup,
                                                  "cpu")
    want = jeng.dedup_factor(jstate, jnp.asarray(idx.numpy()))
    assert out["dedup"] == want
    res = pifs_vs_pond.main(["--device", "cpu", "--skip-engine"])
    assert "engine" not in res and set(res["sim"]) == set(jsim.ALL_SYSTEMS)


@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("dedup", ["off", "on"])
def test_quickstart_runs_on_cpu(storage, dedup):
    out = quickstart.main(["--device", "cpu", "--storage", storage,
                           "--dedup", dedup])
    assert tuple(out["pooled"].shape) == (64, 2, 32)
    assert out["stats"]["hot_pages"] > 0
    assert ("dedup" in out) == (dedup != "off")
    plain = quickstart.main(["--device", "cpu", "--storage", storage,
                             "--dedup", dedup, "--impl", "torch"])
    np.testing.assert_array_equal(out["after"], plain["after"])


def test_examples_raise_without_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pifs_vs_pond.engine_cross_check(get_config("rmc1"), "fp32", "off",
                                        "cuda")
