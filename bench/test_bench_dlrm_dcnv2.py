"""CPU tests of the benchmark's DLRM-DCNv2 family at sizes a test run holds
(a few MB; never the full configuration or its pool): the configuration
file against the port's registry, the reference's tables and arithmetic,
the port's ``dcn`` DLRM against the reference, the harness's run of a tiny
configuration (correct; a broken timed path not), the control against the
cell's limit with each table's rows cut, and the per-layer readers."""
import dataclasses
import json
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

from bench import control, harness, loadgen, yardstick  # noqa: E402
from bench.reference import dlrm_dcnv2 as ref  # noqa: E402
from bench.systems import dlrm_dcnv2 as system  # noqa: E402

CELL = "dlrm-dcnv2.bulk-zipf"
CONFIG = json.loads((ROOT / "bench" / "configs" / "dlrm-dcnv2.json")
                    .read_text())
ZIPF = {"items": 64, "distribution": "zipfian", "pool": 3}


def _tiny(**changes) -> dict:
    """The configuration with every table cut to 64 rows and the widths to
    a few MB of weights; bag lengths as published."""
    cfg = dict(CONFIG, vocab_sizes=[min(v, 64) for v in
                                    CONFIG["vocab_sizes"]],
               emb_dim=16, bottom_mlp=[32, 16], top_mlp=[32, 16, 1],
               cross_rank=8)
    cfg.update(changes)
    return cfg


def _spec(cfg, traffic=ZIPF):
    spec = harness.load_spec(CELL, ROOT)
    spec.update(config=cfg, traffic=traffic,
                end_to_end=[["items_per_s", "items/s"], ["setup_s", "s"]])
    return spec


def _run(spec, seconds=0.3, trace=False, seed=2**31 + 3, system=None):
    return harness.run_cell(spec, seed, seconds, trace, "cpu",
                            time.perf_counter(), log=lambda m: None,
                            system=system)


# ---------------------------------------------------------- configuration
def test_the_configuration_holds_the_registered_published_widths():
    """``configs/dlrm-dcnv2.json`` against the port's registry
    (``configs/dlrm_dcnv2.py``): the same tables, bags and layers; the
    only cut listed is the tables' precision."""
    from repro_torch.configs import get_config
    mc = get_config("dlrm-dcnv2")
    cfg = CONFIG
    assert tuple(cfg["vocab_sizes"]) == mc.table_rows
    assert tuple(cfg["pooling"]) == mc.bag_lengths
    assert (cfg["emb_dim"], cfg["n_dense"], tuple(cfg["bottom_mlp"]),
            tuple(cfg["top_mlp"]), cfg["cross_layers"], cfg["cross_rank"],
            cfg["dtype"]) == (mc.emb_dim, mc.n_dense, mc.bottom_mlp,
                              mc.top_mlp, mc.cross_layers, mc.cross_rank,
                              mc.dtype)
    assert cfg["reduced"] == ["storage"] and cfg["storage"] == "int8"
    assert dataclasses.replace(system.model_config(cfg),
                               source=mc.source) == mc
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "dlrm-dcnv2")
    assert entry["reduced"] == ["storage"]


def test_the_layout_of_the_published_tables():
    """204,184,588 rows, each table padded to whole pages of 32 int8 rows:
    204,184,992 rows, the port's offsets; 214 ids an item."""
    from repro_torch.models import dlrm
    mc = system.model_config(CONFIG)
    assert sum(CONFIG["vocab_sizes"]) == 204184588
    assert ref.page_rows(CONFIG) == 32
    assert ref.n_rows(CONFIG) == 204184992
    offs = ref.row_offsets(CONFIG)
    assert (offs % 32 == 0).all() and offs[0] == 0
    assert loadgen.bag_edges(CONFIG)[-1] == 214
    # the port's engine is built from the same numbers, allocating nothing
    eng, port_offs = dlrm.build_engine(mc, "cpu", storage="int8")
    np.testing.assert_array_equal(port_offs, offs)
    assert eng.cfg.padded_rows == 204184992 and eng.cfg.page_size == 32


def test_flops_per_item_from_the_widths():
    """32.06 MFLOP of matrix products an item, 66 % of them in the cross
    layers; plus the crosses' elementwise work and the pooling's."""
    macs_bottom = 13 * 512 + 512 * 256 + 256 * 128
    macs_cross = 3 * 2 * 3456 * 512
    macs_top = (3456 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256
                + 256 * 1)
    macs = macs_bottom + macs_cross + macs_top
    assert 2 * macs == 32060928
    assert round(macs_cross / macs, 2) == 0.66
    assert ref.flops_per_item(CONFIG) == (2 * macs + 3 * 3 * 3456
                                          + 214 * 128 * 3)


def test_front_end_bytes_and_bound_from_shapes():
    cfg = _tiny(vocab_sizes=[100, 100], pooling=[1, 3], emb_dim=128)
    # rows 0, 5 and 40 distinct; pages of 32 rows: 0 and 1
    idx = torch.tensor([[0, 5, 5, 40], [40, 0, 0, 0]])
    nbytes, flops = ref.front_end_cost(cfg, idx)
    assert nbytes == 3 * 128 + 2 * 4 + 8 * 8 + 2 * 2 * 128 * 4
    assert flops == 8 * 128 * 3
    assert yardstick.bound_s(nbytes, flops) == max(nbytes / 3.35e12,
                                                   flops / 67e12)


# ------------------------------------------------------------------ tables
def test_tables_are_int8_codes_whose_pages_requantize_to_themselves():
    """Every page holds a code of +-127, so its values quantized per page
    (scale max|x| / 127, round half to even) give back its codes and
    scale: the port's dequantized hot tier and int8 cold tier hold the
    reference's numbers.  The same seed draws the same tables."""
    cfg = _tiny()
    params, tables = ref.make_inputs(cfg, 2**33 + 1, "cpu")
    codes, scales = tables["codes"], tables["scales"]
    ps = ref.page_rows(cfg)
    assert codes.dtype == torch.int8 and codes.shape == (ref.n_rows(cfg),
                                                         16)
    pages = codes.view(-1, ps * 16)
    assert (pages.abs().amax(dim=1) == 127).all()
    values = pages.float() * scales[:, None]
    amax = values.abs().amax(dim=1)
    assert torch.equal(amax / 127, scales)
    assert torch.equal(torch.round(values / (amax / 127)[:, None])
                       .clamp(-127, 127).to(torch.int8), pages)
    assert torch.equal(ref.page_scales(tables, cfg, 127), scales)
    assert torch.equal(ref.page_scales(tables, cfg, 7), scales * 127 / 7)
    again = ref.make_inputs(cfg, 2**33 + 1, "cpu")
    assert torch.equal(again[1]["codes"], codes)
    assert all(torch.equal(again[0][k], v) for k, v in params.items())
    with pytest.raises(ValueError):
        ref.make_inputs(dict(cfg, storage="fp32"), 1, "cpu")


# -------------------------------------------------------- port, reference
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_port_matches_the_reference_on_seeded_weights(storage,
                                                      monkeypatch):
    """The port's dcn DLRM (engine placed by observe and plan_and_migrate
    in place) against the reference: an int8 tier packed from the codes,
    or an fp32 tier from the values ``code * scale`` (its tables start on
    its own, larger pages, so its ids move with them).  Tolerance 1e-6 on
    scores near 0.5: the engine adds each bag's hot-tier and cold-tier
    sums apart, where the reference adds the bag's rows in one chain,
    which moves a pooled feature by a rounding or two; every other
    operation is the same."""
    from repro_torch.models import dlrm
    cfg = _tiny()
    offs = ref.row_offsets(cfg)
    pool = loadgen.make_pool(cfg, ZIPF, 21, offs)
    params, tables = ref.make_inputs(cfg, 21, "cpu")
    mc = system.model_config(cfg)
    engine, port_offs = dlrm.build_engine(mc, "cpu", hot_fraction=0.2,
                                          storage=storage)
    if storage == "int8":
        state = engine.from_codes(tables["codes"], tables["scales"])
    else:
        ps = ref.page_rows(cfg)
        values = tables["codes"].float() * tables["scales"].repeat_interleave(
            ps)[:, None]
        dense = torch.zeros((engine.cfg.padded_rows, cfg["emb_dim"]))
        for a, b, n in zip(offs, port_offs, cfg["vocab_sizes"]):
            dense[b:b + n] = values[a:a + n]
        state = engine.from_dense(dense)
    shift = np.repeat(port_offs - offs, cfg["pooling"]).astype(np.int32)
    batches = [{k: torch.as_tensor(v + shift if k == "indices" else v)
                for k, v in b.items()} for b in pool]
    for b in batches:
        state = engine.observe(state, b["indices"])
    # the move the card makes beside the reference's codes
    monkeypatch.setattr(type(engine), "_move_in_place",
                        lambda self, state: True)
    state, stats = engine.plan_and_migrate(state)
    assert stats["hot_pages"] > 0
    model = dlrm.DLRM(mc, "cpu")
    model.load_state_dict(params, strict=True)
    step = dlrm.make_serve_step(model, engine, front_end="split")
    for host, batch in zip(pool, batches):
        got = step(state, batch)
        want = ref.forward(cfg, params, tables, host, block=24)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# ----------------------------------------------------------------- harness
def test_a_tiny_cell_runs_correct_through_the_harness():
    r = _run(_spec(_tiny()))
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"items_per_s", "setup_s"}
    assert r["checks"]["score_gap"]["value"] < 1e-6


def test_a_traced_tiny_cell_reports_what_it_can_read():
    """On the CPU no kernel runs: the ragged pooling's readers find
    nothing and report nothing; the step's share of the peak is read."""
    r = _run(_spec(_tiny()), trace=True)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"step_mfu.bulk"}


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    build = system.build

    def broken_build(*a, **kw):
        binding = build(*a, **kw)
        execute = binding.execute

        def bad(batch):
            out = execute(batch).clone()
            n = out.shape[0]
            if fault == "half_batch":
                out[n // 2:] = out[:n // 2].mean()
            else:
                out[3] = out[n // 2 + 3]
            return out
        binding.execute = bad
        return binding
    monkeypatch.setattr(system, "build", broken_build)
    r = _run(_spec(_tiny()))
    assert r["correct"] is False
    assert r["checks"]["score_gap"]["value"] > \
        r["checks"]["score_gap"]["limit"]


@pytest.mark.parametrize("precision", ["tf32", "int4"])
def test_the_control_fails_the_cells_limit(precision):
    """The reference one precision below the configuration's, in the
    program's place through the whole harness, reads not correct under
    the cell's limit: each table's rows cut (``vocab_sizes``, which the
    traffic reads before ``emb_num``), the published bags and D 128, and
    few items."""
    spec = harness.load_spec(CELL, ROOT)
    cfg = dict(spec["config"], vocab_sizes=[min(v, 256) for v in
                                            spec["config"]["vocab_sizes"]],
               cross_rank=64, top_mlp=[256, 128, 1])
    spec["config"] = cfg
    spec["traffic"] = dict(spec["traffic"], items=128, pool=2)
    assert precision in control.precisions(cfg)
    r = _run(spec, seconds=0.2, seed=11,
             system=control.Control(ref, precision))
    assert r["correct"] is False and r["attempted"] > 0
    assert r["checks"]["score_gap"]["value"] > \
        r["checks"]["score_gap"]["limit"]


def test_the_ragged_pooling_readers_on_a_synthetic_trace():
    ops = {"void ragged_sls_kernel<signed char, 16, 4>(...)": [2, 0.0006],
           "void ragged_sls_kernel<float, 4, 4>(...)": [2, 0.0004],
           "void masked_sls_kernel<float, 4, 4>(...)": [2, 0.5]}
    ctx = SimpleNamespace(items=2000, window_s=0.025, requests=2,
                          flops_per_item=1e7, front_end_bound_s=2e-4,
                          trace={"busy_s": 0.02, "window_s": 0.025,
                                 "ops": ops})
    assert harness.read_metric("ragged_pool_ms.bulk", ctx) == \
        pytest.approx(0.5)
    assert harness.read_metric("ragged_pool_roofline.bulk", ctx) == \
        pytest.approx(40.0)
    ctx.trace = dict(ctx.trace, ops={})
    assert harness.read_metric("ragged_pool_ms.bulk", ctx) is None
    assert harness.read_metric("ragged_pool_roofline.bulk", ctx) is None
    ctx.trace = None
    assert harness.read_metric("ragged_pool_ms.bulk", ctx) is None


def test_the_cell_reports_the_step_metrics_and_the_ragged_pooling():
    spec = harness.load_spec(CELL, ROOT)
    assert [n for n, _ in spec["end_to_end"]] == ["items_per_s", "setup_s"]
    assert {n for n, _ in spec["per_layer"]} == {
        "h2d_ms.bulk", "mlp_ms.bulk", "step_mfu.bulk", "idle_share.bulk",
        "ragged_pool_ms.bulk", "ragged_pool_roofline.bulk"}


def test_the_span_tool_attributes_the_cross_layers():
    """``pifs.cross`` is a ``pifs.`` span: ``bench/spans.py`` gives it the
    device time it launched and the idle gaps it holds, inside
    ``pifs.step``."""
    from bench import spans
    got = spans.attribute(
        [(0, 100, "pifs.step"), (10, 30, "pifs.front_end"),
         (40, 70, "pifs.cross"), (70, 90, "pifs.top_mlp")],
        [(15, 5), (45, 200), (50, 300), (75, 7), (95, 1)],
        [(55, 65), (80, 82)])
    assert got["pifs.cross"]["count"] == 1
    assert got["pifs.cross"]["device_s"] == pytest.approx(500e-9)
    assert got["pifs.cross"]["idle_s"] == pytest.approx(10e-9)
    assert got["pifs.step"]["device_s"] == pytest.approx(1e-9)
    assert got["pifs.top_mlp"]["idle_s"] == pytest.approx(2e-9)
