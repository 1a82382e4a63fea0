"""The dry-run (``launch/dryrun.py``) and what it stands on: the kernels'
shape functions (``kernels/fake.py``), the fake route in ``kernels/ops.py``,
the counter ``launch/op_stats.py``, and the per-layer multiplier.

The counts of a dry-run on fake tensors must equal the counts of the same
cell run for real: on reduced configs, one cell of each kind, the matmul
FLOPs by dtype, the dot bytes and the kernel calls are equal to an
``OpStats`` count of a real CPU run (its kernels' plain versions, one
event each).  On the card ``chip_smoke.py`` holds the same against the
kernels.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro_torch.configs import get_config, reduced, reduced_shape
from repro_torch.device import is_fake
from repro_torch.kernels import build, fake, ops
from repro_torch.launch import cells, dryrun
from repro_torch.launch.op_stats import summarize, top_dots

ROOT = Path(__file__).resolve().parents[1]


def _outs(o):
    if o is None:
        return []
    return [o] if isinstance(o, torch.Tensor) else list(o)


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_shape_functions_match_the_plain_versions(storage):
    """Every entry of build.KERNELS: the shape function's outputs have the
    plain version's shapes, dtypes, devices and strides (none for the
    in-place apply_deltas)."""
    gen = torch.Generator().manual_seed(0)
    cases = fake.kernel_cases("cpu", gen, storage=storage)
    assert set(cases) == set(build.KERNELS) == set(fake.shape_functions())
    plain = fake.plain_versions()
    for name, args in cases.items():
        got, want = _outs(fake.shape_functions()[name](*args)), \
            _outs(plain[name](*args))
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert (g.shape, g.dtype, g.device, g.stride()) == \
                (w.shape, w.dtype, w.device, w.stride()), name


def test_shape_functions_on_fake_inputs_and_the_ops_route():
    """On fake inputs (the dry-run's) the shape functions give fake
    outputs; ops sends a fake tensor, and only a fake tensor, there."""
    gen = torch.Generator().manual_seed(1)
    cases = fake.kernel_cases("cpu", gen)
    with FakeTensorMode() as mode:
        for name, args in cases.items():
            fargs = tuple(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                          else a for a in args)
            for o in _outs(fake.shape_functions()[name](*fargs)):
                assert isinstance(o, FakeTensor), name
        ft = torch.empty(4, 8)
        assert ops._route("cuda", ft) == "fake" and is_fake(ft)
        assert ops._route("torch", ft) == "plain"
    real = torch.zeros(4, 8)
    assert ops._route("cuda", real) == "plain" and not is_fake(real)
    with pytest.raises(ValueError):
        ops._route("pallas", real)


def test_a_real_tensor_never_takes_the_fake_route(monkeypatch):
    """A real serve and train step with every shape function replaced by
    one that raises: nothing reaches them."""
    def boom(*a, **k):
        raise AssertionError("a real tensor reached a shape function")
    for name in build.KERNELS:
        monkeypatch.setattr(fake, name, boom)
    cfg = reduced(get_config("rmc1"))
    for shape, fe in (("serve_p99", "split"), ("serve_p99", "fused"),
                      ("train_batch", "split")):
        cell = cells.build_cell("rmc1", shape, "cpu", seed=0, cfg=cfg,
                                shape=reduced_shape(cfg.shapes()[shape]),
                                front_end=fe)
        s, _ = summarize(cell.fn, *cell.args)
        assert s.kernels


def test_op_stats_hand_counts():
    """A Linear, a bmm, a kernel call and a chain of temporaries, each
    against its count by hand."""
    lin = torch.nn.Linear(64, 32)
    x = torch.randn(16, 64)
    s, out = summarize(lambda x: lin(x), x)
    assert s.flops_by_dtype == {"float32": 2 * 16 * 64 * 32}
    assert s.dot_bytes == (16 * 64 + 64 * 32 + 16 * 32) * 4
    assert s.argument_bytes == 16 * 64 * 4
    assert s.output_bytes == s.peak_bytes == 16 * 32 * 4
    assert s.kernels == {}

    a = torch.randn(3, 5, 7, dtype=torch.bfloat16)
    b = torch.randn(3, 7, 2, dtype=torch.bfloat16)
    s, _ = summarize(torch.bmm, a, b)
    assert s.flops_by_dtype == {"bfloat16": 2 * 3 * 5 * 7 * 2}
    assert s.dot_bytes == (3 * 5 * 7 + 3 * 7 * 2 + 3 * 5 * 2) * 2
    assert top_dots(s)[0][1].startswith("bmm bfloat16 (3, 5, 7)x(3, 7, 2)")

    # a kernel call is one event; the bmm inside its plain version is not
    # a dot of the step
    feats = torch.randn(8, 5, 16)
    s, out = summarize(ops.dot_interaction, feats)
    assert s.kernels == {"dot_interaction": 1} and s.flops_by_dtype == {}
    assert s.output_bytes == out.numel() * 4

    def chain(v):
        t1 = v * 2          # 4N live
        t2 = t1 + 1         # 8N live: the peak
        del t1              # 4N
        return t2.sum()     # + 4 bytes
    v = torch.randn(1000)
    s, _ = summarize(chain, v)
    assert s.peak_bytes == 8000 and s.output_bytes == 4
    assert s.argument_bytes == 4000
    with FakeTensorMode():
        s_fake, _ = summarize(chain, torch.empty(1000))
    assert (s_fake.peak_bytes, s_fake.output_bytes) == (8000, 4)


# one cell of each kind: (arch, shape, builder keywords)
KINDS = [
    ("llama3.2-3b", "train_4k", {}),
    ("llama3.2-3b", "prefill_32k", {}),
    ("llama3.2-3b", "decode_32k", {}),
    ("granite-moe-1b-a400m", "train_4k", {}),
    ("granite-moe-1b-a400m", "decode_32k", {}),
    ("deepseek-v3-671b", "train_4k", {}),
    ("deepseek-v3-671b", "prefill_32k", {}),
    ("deepseek-v3-671b", "decode_32k", {}),
    ("sasrec", "train_batch", {}),
    ("sasrec", "retrieval_cand", {}),
    ("dcn-v2", "serve_p99", {}),
    ("dcn-v2", "retrieval_cand", {}),
    ("autoint", "train_batch", {}),
    ("bst", "serve_bulk", {}),
    ("graphsage-reddit", "full_graph_sm", {}),
    ("graphsage-reddit", "minibatch_lg", {}),
    ("graphsage-reddit", "molecule", {}),
    ("rmc1", "serve_p99", {"front_end": "split"}),
    ("rmc1", "serve_p99", {"front_end": "fused"}),
    ("rmc4", "serve_bulk", {"front_end": "fused"}),
    ("rmc1", "train_batch", {}),
]


def _reduced(arch, shape):
    cfg = reduced(get_config(arch))
    return cfg, reduced_shape(cfg.shapes()[shape])


@pytest.mark.parametrize("arch,shape,kw", KINDS,
                         ids=[f"{a}:{s}:{k.get('front_end', '')}"
                              for a, s, k in KINDS])
def test_dry_run_counts_equal_a_real_run(arch, shape, kw):
    cfg, sh = _reduced(arch, shape)
    _, dry, layers = dryrun.count_cell(arch, shape, "cpu", cfg=cfg,
                                       shape=sh, **kw)
    assert layers == "whole"
    cell = cells.build_cell(arch, shape, "cpu", seed=0, cfg=cfg, shape=sh,
                            **kw)
    real, out = summarize(cell.fn, *cell.args)
    assert dry.flops_by_dtype == real.flops_by_dtype
    if getattr(cfg, "moe", None) is None:
        assert dry.dot_bytes == real.dot_bytes
    else:
        # the dry-run splits the rows evenly over the experts, so it reads
        # every expert's weights; real routing may leave some idle (a
        # decode step of 4 tokens), reading fewer
        assert dry.dot_bytes >= real.dot_bytes
    assert dry.kernels == real.kernels
    assert real.flops > 0
    if kw.get("front_end") == "fused":
        assert dry.kernels == {"fused_front_end": 1}
    elif cfg.family in ("dlrm", "recsys"):
        assert dry.kernels.get("masked_sls", 0) >= 1
    assert dry.argument_bytes == real.argument_bytes
    assert dry.output_bytes == real.output_bytes


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "llama3.2-3b"])
def test_per_layer_multiplier_equals_the_whole_trace(arch, shape):
    """At depth 4 (deepseek: 1 dense and 3 MoE layers, plus its MTP block)
    the per-layer count is the whole trace's.  The peak is extrapolated
    the same way: it may differ by the few scalars a layer's loop keeps
    (the aux loss), at most 8 bytes a layer."""
    cfg, sh = _reduced(arch, shape)
    cfg = cells.lm_depth_variant(
        cfg, *((1, 3) if cfg.moe is not None else (4, 0)))
    _, whole, _ = dryrun.count_cell(arch, shape, "cpu", cfg=cfg, shape=sh,
                                    layers="whole")
    _, per, layers = dryrun.count_cell(arch, shape, "cpu", cfg=cfg,
                                       shape=sh, layers="per_layer")
    assert layers == "per_layer"
    for f in ("flops_by_dtype", "dot_bytes", "kernels", "n_ops",
              "argument_bytes", "output_bytes", "dots"):
        assert getattr(per, f) == getattr(whole, f), f
    assert abs(per.peak_bytes - whole.peak_bytes) <= 8 * cfg.n_layers


def test_run_cell_record_and_roofline(tmp_path):
    rec = dryrun.run_cell("rmc4", "serve_p99", "cpu", out_dir=str(tmp_path),
                          front_end="fused")
    assert rec["kernels"] == {"fused_front_end": 1}
    fl = rec["flops_by_dtype"]["float32"]
    assert rec["roofline"]["compute_s"] == fl / dryrun.FP32_FLOPS_PER_S
    assert rec["roofline"]["memory_s"] == \
        rec["cost"]["dot_bytes"] / dryrun.HBM_BYTES_PER_S
    assert rec["roofline"]["collective_s"] == 0.0 and rec["collectives"] == {}
    m = rec["memory"]
    assert m["total_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    assert m["fits_80gb"] is (m["total_bytes"] < 80e9)
    with open(tmp_path / "rmc4__serve_p99.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))


def _cli(*argv, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--device", "cpu", *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


KEYS = {"arch", "shape", "device", "n_chips", "ok", "layers", "trace_s",
        "memory", "cost", "flops_by_dtype", "kernels", "collectives",
        "roofline", "top_dots"}


def test_cli_one_cell_and_all_of_an_arch(tmp_path):
    r = _cli("--arch", "rmc1", "--shape", "serve_p99", "--out",
             str(tmp_path), cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    rec = json.loads((tmp_path / "rmc1__serve_p99.json").read_text())
    assert set(rec) == KEYS and rec["ok"]
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "total_bytes", "fits_80gb"}
    assert set(rec["cost"]) >= {"flops", "dot_bytes"}
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "dominant", "model_flops",
                                    "useful_flops_ratio"}
    assert rec["kernels"] == {"dot_interaction": 1, "masked_sls": 2}
    assert rec["memory"]["fits_80gb"] is True

    r = _cli("--all", "--arch", "graphsage-reddit", "--out", str(tmp_path),
             cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    for shape in get_config("graphsage-reddit").shapes():
        rec = json.loads((tmp_path / f"graphsage-reddit__{shape}.json")
                         .read_text())
        assert set(rec) == KEYS and rec["ok"] and rec["cost"]["flops"] > 0
    # ogbn-products' full graph at d_feat 100 and Cora's both fit one card
    assert "[cache]" not in r.stdout
    r = _cli("--all", "--arch", "graphsage-reddit", "--out", str(tmp_path),
             cwd=tmp_path)
    assert r.stdout.count("[cache]") == 4


def test_an_lm_cell_deeper_than_four_layers_counts_per_layer():
    rec = dryrun.run_cell("granite-moe-1b-a400m", "decode_32k", "cpu")
    assert rec["layers"] == "per_layer" and rec["kernels"] == {}
    assert rec["flops_by_dtype"]["bfloat16"] > 0
    assert rec["roofline"]["useful_flops_ratio"] > 0
