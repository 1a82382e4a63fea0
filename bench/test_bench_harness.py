"""CPU tests of the benchmark: its files load by name, its arithmetic, its
traffic, the reference against the port and the control and faults
against the limits, at sizes a test run holds; and one run of a cell on
the card, which skips here."""
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from bench import control, devtrace, harness, loadgen, yardstick  # noqa: E402
from bench.reference import dlrm as ref  # noqa: E402
from bench.systems import dlrm as system  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
END_TO_END = ("items_per_s", "setup_s")
READERS = sorted(p.stem for p in (ROOT / "bench" / "metrics").glob("*.py"))


def _config(config: str, **changes) -> dict:
    cfg = json.loads((ROOT / "bench" / "configs" / f"{config}.json")
                     .read_text())
    cfg.update(changes)
    return cfg


def _spec(cfg: dict, traffic: dict, limit: float = None) -> dict:
    if limit is None:
        limit = json.loads((ROOT / "bench" / "limits"
                            / "rmc4.bulk-zipf.json").read_text())[
            "score_gap"]["limit"]
    return {"name": "test", "chips": 1, "config": cfg, "traffic": traffic,
            "limits": {"score_gap": {"limit": limit}},
            "end_to_end": [[n, "u"] for n in END_TO_END],
            "per_layer": [[n, "u"] for n in READERS
                          if n not in END_TO_END]}


def _tiny(storage: str = "fp32") -> dict:
    """Tiny widths for runs of the whole harness on the CPU."""
    return _config("rmc4", name="tiny", emb_num=1024, emb_dim=16,
                   bottom_mlp=[64, 32], top_mlp=[32, 16, 1],
                   storage=storage)


ZIPF = {"items": 64, "distribution": "zipfian", "pool": 4}
RANDOM = {"items": 64, "distribution": "random", "pool": 3}


def _run(spec, seconds=0.3, trace=False, seed=2**31 + 5, system=None):
    return harness.run_cell(spec, seed, seconds, trace, "cpu",
                            time.perf_counter(), log=lambda m: None,
                            system=system)


# ---------------------------------------------------------------- files
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(cell):
    spec = harness.load_spec(cell, ROOT)
    assert spec["limits"]["score_gap"]["limit"] > 0
    assert spec["end_to_end"] and spec["per_layer"]
    assert ["setup_s", "s"] in spec["end_to_end"]
    for name, _ in spec["end_to_end"] + spec["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{name}.py").is_file()


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for d in ("configs", "traffic", "limits",
                                       "metrics")
    for p in (ROOT / "bench" / d).iterdir() if p.suffix in (".json",
                                                            ".py")))
def test_every_benchmark_file_loads(path):
    p = ROOT / path
    if p.suffix == ".json":
        data = json.loads(p.read_text())
        if "traffic" in p.parts:
            loadgen.check_traffic(data)
        if "configs" in p.parts:
            assert data["name"] == p.stem and set(data["assumed"]) <= set(
                data)
        return
    spec = importlib.util.spec_from_file_location("m", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read) and mod.__doc__


def test_configs_hold_the_published_widths():
    """PIFS-Rec Table I, RMC3 and RMC4, uncut; the port's own registry
    holds the same numbers."""
    from repro_torch.configs.rmc import RMC3, RMC4
    for name, mc in (("rmc4", RMC4), ("rmc3-int8", RMC3)):
        cfg = _config(name)
        assert (cfg["emb_num"], cfg["emb_dim"], tuple(cfg["bottom_mlp"]),
                tuple(cfg["top_mlp"]), cfg["n_tables"], cfg["pooling"],
                cfg["n_dense"]) == (mc.emb_num, mc.emb_dim, mc.bottom_mlp,
                                    mc.top_mlp, mc.n_tables, mc.pooling,
                                    mc.n_dense)


# ----------------------------------------------------------- arithmetic
def test_flops_per_item_from_the_widths():
    # RMC4: MLP and projection MACs, 36 dots of 128, 64 pooled adds of 128
    macs = (13 * 2048 + 2048 * 2048 + 2048 * 256 + 256 * 128
            + 164 * 768 + 768 * 384 + 384 * 1)
    assert ref.flops_per_item(_config("rmc4")) == (
        2 * macs + 2 * 36 * 128 + 64 * 128 * 2)
    macs3 = (13 * 2048 + 2048 * 1024 + 1024 * 256 + 256 * 64
             + 100 * 512 + 512 * 256 + 256 * 1)
    assert ref.flops_per_item(_config("rmc3-int8")) == (
        2 * macs3 + 2 * 36 * 64 + 64 * 64 * 3)


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_front_end_bytes_and_bound_from_shapes(storage):
    cfg = _config("rmc4", storage=storage)
    # 6 distinct rows of 8; int8 pages of 32 rows at D 128: rows 0-31, 40
    idx = torch.tensor([[[0, 1], [1, 5]], [[0, 0], [40, 9]]])
    cfg.update(n_tables=2, pooling=2)
    nbytes, flops = ref.front_end_cost(cfg, idx)
    P = 3                                       # F = 3 features
    width = 128 if storage == "int8" else 512
    scales = 2 * 4 if storage == "int8" else 0
    assert nbytes == 5 * width + scales + 8 * 8 + 2 * 128 * 4 + 2 * P * 4
    assert flops == 8 * 128 * (3 if storage == "int8" else 2) \
        + 2 * P * 128 * 2
    assert yardstick.bound_s(nbytes, flops) == max(
        nbytes / 3.35e12, flops / 67e12)


def test_rate_over_the_whole_window():
    ctx = SimpleNamespace(items=3 * 16384, window_s=0.02, requests=3,
                          trace=None, setup_s=12.5)
    assert harness.read_metric("items_per_s", ctx) == 3 * 16384 / 0.02
    assert harness.read_metric("setup_s", ctx) == 12.5
    for name in ("h2d_ms.bulk", "mlp_ms.bulk", "step_mfu.bulk",
                 "front_end_ms.bulk", "idle_share.bulk"):
        assert harness.read_metric(name, ctx) is None     # untraced


def test_trace_readers_on_a_synthetic_trace():
    ops = {"Memcpy HtoD (Pageable -> Device)": [4, 0.004],
           "sm80_xmma_gemm_f32f32": [8, 0.012],
           "void gemv2T_kernel_val": [2, 0.001],
           "void fused_front_end_kernel<float, 4, 4>(...)": [2, 0.0005],
           "void at::native::elementwise_kernel": [6, 0.0015]}
    ctx = SimpleNamespace(
        items=2 * 1000, window_s=0.025,
        requests=2, flops_per_item=1e9, front_end_bound_s=1e-4,
        trace={"busy_s": 0.019, "window_s": 0.025, "ops": ops})
    assert harness.read_metric("h2d_ms.bulk", ctx) == pytest.approx(2.0)
    assert harness.read_metric("mlp_ms.bulk", ctx) == pytest.approx(6.5)
    assert harness.read_metric("front_end_ms.bulk", ctx) == \
        pytest.approx(0.25)
    assert harness.read_metric("front_end_roofline.bulk", ctx) == \
        pytest.approx(40.0)
    assert harness.read_metric("idle_share.bulk", ctx) == \
        pytest.approx(24.0)
    assert harness.read_metric("step_mfu.bulk", ctx) == pytest.approx(
        100 * 1e9 * 2000 / 0.025 / 67e12)
    ctx.trace = dict(ctx.trace, ops={}, busy_s=0.0)
    for name in ("h2d_ms.bulk", "mlp_ms.bulk", "front_end_ms.bulk",
                 "front_end_roofline.bulk", "idle_share.bulk"):
        assert harness.read_metric(name, ctx) is None


def test_busy_union_and_idle_gaps_named_by_the_host():
    busy = devtrace._interval_union([(10, 20), (15, 30), (40, 50)])
    assert busy == [(10, 30), (40, 50)]
    gaps = devtrace._gaps(busy, 0, 60)
    assert gaps == [(0, 10), (30, 40), (50, 60)]
    host = [(0, 60, "bench.execute"), (32, 38, "cudaMemcpyAsync"),
            (52, 53, "aten::mm")]
    named = devtrace._name_gaps(gaps, host)
    assert named == {"bench.execute": pytest.approx(20e-9),
                     "cudaMemcpyAsync": pytest.approx(10e-9)}


# -------------------------------------------------------------- traffic
def test_traffic_is_the_ports_trace_generator_frozen():
    from repro_torch.data.traces import TraceConfig, TraceGenerator
    for dist in loadgen.DISTRIBUTIONS:
        kw = dict(n_rows=5000, n_tables=3, pooling=4, batch=16,
                  distribution=dist, seed=2**33 + 1)
        a = loadgen.TraceGenerator(loadgen.TraceConfig(**kw))
        b = TraceGenerator(TraceConfig(**kw))
        for _ in range(3):
            np.testing.assert_array_equal(a.next_batch(), b.next_batch())


def test_pool_is_fixed_by_the_seed():
    cfg = _tiny()
    offs = ref.row_offsets(cfg)
    a = loadgen.make_pool(cfg, ZIPF, 7, offs)
    b = loadgen.make_pool(cfg, ZIPF, 7, offs)
    c = loadgen.make_pool(cfg, ZIPF, 8, offs)
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["indices"], c[0]["indices"])
    assert a[0]["indices"].dtype == np.int32
    assert (a[0]["indices"][:, 1] >= offs[1]).all()


# Tables that differ: a 3-row table with single-id bags beside a 5000-row
# table with 100-id bags; offsets with gaps, so a table read through
# another's offset shows.
MIXED = {"n_dense": 13, "vocab_sizes": [3, 1000, 40, 5000],
         "pooling": [1, 7, 2, 100]}
MIXED_OFFSETS = np.array([0, 100, 1200, 1300], dtype=np.int64)
MIXED_TRAFFIC = {
    "zipf": {"items": 256, "distribution": "zipfian", "pool": 6},
    "random": {"items": 256, "distribution": "random", "pool": 6}}


def _same_pool(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("traffic", [ZIPF, RANDOM], ids=["zipf", "random"])
def test_listed_tables_alike_give_the_integer_forms_pool(traffic):
    cfg = _tiny()
    T, L = cfg["n_tables"], cfg["pooling"]
    listed = {k: v for k, v in cfg.items() if k not in ("emb_num",
                                                          "n_tables")}
    listed.update(vocab_sizes=[cfg["emb_num"]] * T, pooling=[L] * T)
    offs = ref.row_offsets(cfg)
    a = loadgen.make_pool(cfg, traffic, 2**31 + 9, offs)
    _same_pool(a, loadgen.make_pool(listed, traffic, 2**31 + 9, offs))
    assert a[0]["indices"].shape == (traffic["items"], T, L)


@pytest.mark.parametrize("dist", sorted(MIXED_TRAFFIC))
def test_mixed_tables_lay_out_each_bag_in_its_columns(dist):
    traffic = MIXED_TRAFFIC[dist]
    items, rows = traffic["items"], MIXED["vocab_sizes"]
    edges = loadgen.bag_edges(MIXED)
    a = loadgen.make_pool(MIXED, traffic, 2**33 + 5, MIXED_OFFSETS)
    for b in a:                       # every batch: drift on the 3-row table
        assert b["indices"].shape == (items, 110)
        assert b["indices"].dtype == np.int32
        assert b["weights"].shape == (items, 110)
        assert (b["weights"] == 1).all()
        assert b["dense"].shape == (items, 13)
        for t, n in enumerate(rows):
            bag = b["indices"][:, edges[t]:edges[t + 1]]
            assert bag.min() >= MIXED_OFFSETS[t], (t, bag.min())
            assert bag.max() < MIXED_OFFSETS[t] + n, (t, bag.max())
    _same_pool(a, loadgen.make_pool(MIXED, traffic, 2**33 + 5,
                                    MIXED_OFFSETS))
    c = loadgen.make_pool(MIXED, traffic, 2**33 + 6, MIXED_OFFSETS)
    for t in range(len(rows)):
        cols = slice(edges[t], edges[t + 1])
        assert not np.array_equal(a[0]["indices"][:, cols],
                                  c[0]["indices"][:, cols]), t


def test_mixed_tables_zipf_peaks_at_each_tables_rank_0():
    """The first batch is drawn before any drift: each table's most
    frequent id is the row its own permutation (drawn in table order from
    the seed) puts at rank 0."""
    seed, rows = 2**31 + 17, MIXED["vocab_sizes"]
    init = np.random.default_rng([seed, loadgen._INIT_TAG])
    top = [init.permutation(n)[0] for n in rows]
    first = loadgen.make_pool(MIXED, dict(MIXED_TRAFFIC["zipf"], pool=1),
                              seed, MIXED_OFFSETS)[0]["indices"]
    edges = loadgen.bag_edges(MIXED)
    for t in range(len(rows)):
        ids, counts = np.unique(first[:, edges[t]:edges[t + 1]]
                                - MIXED_OFFSETS[t], return_counts=True)
        assert ids[counts.argmax()] == top[t], t


def test_bag_edges_follow_the_bag_lengths():
    assert loadgen.bag_edges(MIXED).tolist() == [0, 1, 8, 10, 110]
    assert loadgen.tables(MIXED) == ((3, 1000, 40, 5000), (1, 7, 2, 100))
    cfg = _tiny()
    T, L = cfg["n_tables"], cfg["pooling"]
    edges = loadgen.bag_edges(cfg)
    assert edges.tolist() == [t * L for t in range(T + 1)]
    offs = ref.row_offsets(cfg)
    b = loadgen.make_pool(cfg, ZIPF, 5, offs)[0]["indices"]
    flat = b.reshape(len(b), -1)
    assert flat.shape[1] == edges[-1]
    for t in range(T):
        np.testing.assert_array_equal(flat[:, edges[t]:edges[t + 1]],
                                      b[:, t, :])
        assert (b[:, t] >= offs[t]).all()
        assert (b[:, t] < offs[t] + cfg["emb_num"]).all()


@pytest.mark.parametrize("changes", [
    {"pooling": [1, 7, 2]}, {"vocab_sizes": [3, 0, 40, 5000]},
    {"pooling": [1, 7, 2.5, 100]}, {"n_tables": 5}, {"pooling": 0}],
    ids=["short-pooling", "empty-table", "fractional-bag", "n_tables",
         "zero-pooling"])
def test_tables_refuse_a_malformed_configuration(changes):
    with pytest.raises((ValueError, TypeError)):
        loadgen.make_pool(dict(MIXED, **changes), MIXED_TRAFFIC["random"],
                          1, MIXED_OFFSETS)


# ------------------------------------------------- reference and port
@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("traffic", [ZIPF, RANDOM], ids=["zipf", "random"])
def test_port_matches_the_reference_through_the_harness(storage, traffic):
    r = _run(_spec(_tiny(storage), traffic))
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert r["checks"]["score_gap"]["value"] < 1e-6
    assert set(r["metrics"]) == {"items_per_s", "setup_s"}


def test_trace_run_reports_the_per_layer_metrics_it_can_read():
    r = _run(_spec(_tiny(), ZIPF), trace=True)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"step_mfu.bulk"}
    # no device here: no device-trace metric is read, none is 0
    assert r["device"]["window_s"] > 0 and r["breakdown"]["idle_gaps"]


def _broken(monkeypatch, fault):
    build = system.build

    def broken_build(*a, **kw):
        binding = build(*a, **kw)
        execute = binding.execute

        def bad(batch):
            out = execute(batch).clone()
            n = out.shape[0]
            if fault == "half_batch":        # half left out, their mean
                out[n // 2:] = out[:n // 2].mean()
            else:                            # one answer altered
                out[3] = out[n // 2 + 3]
            return out
        binding.execute = bad
        return binding
    monkeypatch.setattr(system, "build", broken_build)


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, storage):
    _broken(monkeypatch, fault)
    r = _run(_spec(_tiny(storage), ZIPF))
    assert r["correct"] is False
    assert r["checks"]["score_gap"]["value"] > \
        r["checks"]["score_gap"]["limit"]


@pytest.mark.parametrize("cell,precision", [
    ("rmc4.bulk-zipf", "tf32"), ("rmc4.bulk-uniform", "tf32"),
    ("rmc3-int8.bulk-zipf", "int4"), ("rmc3-int8.bulk-zipf", "tf32")])
def test_the_control_fails_the_cells_limit(cell, precision):
    """The reference one precision below the configuration's, in the
    program's place through the whole harness, at the published widths
    with few rows and items, reads not correct under the cell's limit."""
    spec = harness.load_spec(cell, ROOT)
    spec["config"] = dict(spec["config"], emb_num=4096)
    spec["traffic"] = dict(spec["traffic"], items=256, pool=2)
    r = _run(spec, seconds=0.2, seed=11,
             system=control.Control(ref, precision))
    assert r["correct"] is False and r["attempted"] > 0
    assert r["checks"]["score_gap"]["value"] > \
        r["checks"]["score_gap"]["limit"]
    assert precision in control.precisions(spec["config"])


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-10,
                      3.0e38])
    got = ref.round_tf32(x)
    assert got[:4].tolist() == [1.0, 1.0, 1.0 + 4 * 2**-11, -1.0 - 2**-10]
    assert torch.isfinite(got).all()
    bits = got.view(torch.int32) & 0x1FFF
    assert (bits == 0).all()


# --------------------------------------------------------------- command
def _command(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_command_refuses_without_a_card_or_without_the_port(tmp_path):
    args = ("--workload", "rmc4.bulk-zipf", "--seed", "1", "--seconds", "1",
            "--trace", "0")
    if not torch.cuda.is_available():
        r = _command(ROOT, *args)
        assert r.returncode != 0 and r.stdout.strip() == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    r = _command(tmp_path, *args)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.cuda
def test_one_cell_on_the_card():
    """``python bench/run.py`` on the card: correct, every end-to-end
    metric of the cell, and the checks last."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    r = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "rmc4.bulk-zipf",
         "--seed", str(2**31 + 99), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, r.stderr[-4000:]
    assert set(res["metrics"]) == {"items_per_s", "setup_s"}
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
