"""Dry-run: trace every (architecture x input shape) cell at full published
width on fake tensors and report what a step costs on one H100 and
whether it fits (the port of ``repro.launch.dryrun``).

Each cell (``launch/cells.py``) is built and run once inside a
``torch._subclasses.fake_tensor.FakeTensorMode``: parameters, optimizer
state, engine state, cache and batch are fake, nothing is allocated, and
the hand-written kernels take their shape functions (``kernels/fake.py``).
:class:`launch.op_stats.OpStats` counts the step: matmul FLOPs by dtype,
dot operand and output bytes, kernel calls, and the bytes the step holds
above its arguments at its peak.  The roofline terms use the H100 SXM's
data-sheet peaks; one card has no collectives.

An LM cell deeper than ``PER_LAYER_MIN`` layers is counted per layer, as
``hlo_stats`` multiplies a while body by its trip count: a trace with one
layer of each kind, one with a second dense layer and one with a second
MoE layer give each layer's counts, which are multiplied by the layer
counts (its layers are identical, so FLOPs, bytes and kernel calls are
exact; the peak is extrapolated the same way).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
      one cell, prints and writes JSON under results/dryrun_torch/
  python -m repro_torch.launch.dryrun --all [--arch ARCH]
      every cell of ``iter_cells`` (the 5 long_500k cells carry the
      reference's skip reason) and the RMC1 / RMC4 cells, each in its own
      process, skipping cells whose JSON already says ok (the cache)
  python -m repro_torch.launch.dryrun --table
      the records as a markdown table

The entry point traces fake tensors on the card (``--device cuda``, the
default); ``--device cpu`` traces CPU fakes where there is no card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import base as cfgs
from repro_torch.configs import get_config, iter_cells
from repro_torch.device import resolve_device
from repro_torch.kernels.build import REPO_ROOT
from repro_torch.launch.cells import build_cell, dlrm_cells, lm_depth_variant
from repro_torch.launch.op_stats import storage_bytes, summarize, top_dots

RESULTS_DIR = REPO_ROOT / "results" / "dryrun_torch"

# H100 SXM data sheet (the constants chip_smoke.py uses): dense bf16 on the
# tensor cores, float32 outside them (TF32 is off), HBM3 bandwidth
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
CARD_BYTES = 80e9
RATES = {"bfloat16": BF16_FLOPS_PER_S, "float32": FP32_FLOPS_PER_S}

PER_LAYER_MIN = 4        # deeper LM cells are counted per layer


def _trace(cell):
    return summarize(cell.fn, *cell.args)[0]


def count_cell(arch: str, shape_name: str, device: str = "cuda",
               cfg=None, shape=None, layers: str = "auto", **kw):
    """(cell, OpSummary, layers) of a cell traced on fake tensors.
    ``layers``: 'whole', 'per_layer' or 'auto' (per layer for an LM
    deeper than ``PER_LAYER_MIN``)."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else cfg.shapes()[shape_name]
    lm = isinstance(cfg, cfgs.LMConfig)
    if layers == "auto":
        layers = ("per_layer" if lm and cfg.n_layers > PER_LAYER_MIN
                  else "whole")
    if layers == "per_layer" and not lm:
        raise ValueError(f"{arch} has no layer stacks to multiply")
    with FakeTensorMode():
        cell = build_cell(arch, shape_name, device, cfg=cfg, shape=shape,
                          **kw)
        if layers == "whole":
            return cell, _trace(cell), layers
        n_dense, n_moe = ((cfg.n_layers, 0) if cfg.moe is None else
                          (cfg.moe.first_dense_layers,
                           cfg.n_layers - cfg.moe.first_dense_layers))
        d0, m0 = min(n_dense, 1), min(n_moe, 1)

        def at(nd, nm):
            return _trace(build_cell(arch, shape_name, device,
                                     cfg=lm_depth_variant(cfg, nd, nm),
                                     shape=shape, **kw))
        base = at(d0, m0)
        terms = []
        if n_dense > d0:
            terms += [(n_dense - d0, at(d0 + 1, m0)), (-(n_dense - d0), base)]
        if n_moe > m0:
            terms += [(n_moe - m0, at(d0, m0 + 1)), (-(n_moe - m0), base)]
        summary = base.combine(terms)
        summary.argument_bytes = storage_bytes(cell.args)
        return cell, summary, layers


def roofline(summary, model_flops: float) -> Dict:
    flops = summary.flops
    compute_s = sum(f / RATES.get(dt, FP32_FLOPS_PER_S)
                    for dt, f in summary.flops_by_dtype.items())
    terms = {"compute_s": compute_s,
             "memory_s": summary.dot_bytes / HBM_BYTES_PER_S,
             "collective_s": 0.0}
    return {**terms, "dominant": max(terms, key=terms.get),
            "model_flops": model_flops,
            "useful_flops_ratio": model_flops / flops if flops else 0.0}


def run_cell(arch: str, shape_name: str, device: str = "cuda",
             out_dir: Optional[str] = None, **kw) -> Dict:
    """Trace one cell on fake tensors; the record (written to
    ``out_dir/<arch>__<shape>.json`` when given)."""
    t0 = time.time()
    cell, s, layers = count_cell(arch, shape_name, device, **kw)
    trace_s = time.time() - t0
    temp = int(s.peak_bytes)
    rec = {
        "arch": arch, "shape": shape_name, "device": str(device),
        "n_chips": 1, "ok": True, "layers": layers,
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_bytes": int(s.argument_bytes),
            "output_bytes": int(s.output_bytes),
            # the most the step holds above its arguments (its outputs
            # included while they are live), so total is the step's peak
            "temp_bytes": temp,
            "total_bytes": int(s.argument_bytes) + temp,
        },
        "cost": {"flops": s.flops, "dot_bytes": s.dot_bytes,
                 "n_ops": s.n_ops},
        "flops_by_dtype": s.flops_by_dtype,
        "kernels": s.kernels,
        "collectives": s.collectives,
        "roofline": roofline(s, cell.model_flops),
        "top_dots": [[f, d] for f, d in top_dots(s, 8)],
    }
    rec["memory"]["fits_80gb"] = rec["memory"]["total_bytes"] < CARD_BYTES
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(cell_path(out_dir, arch, shape_name), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def cell_path(out_dir: str, arch: str, shape: str) -> str:
    return os.path.join(out_dir, f"{arch}__{shape}.json")


def all_cells() -> List:
    """``iter_cells`` (the reference's 40) and the RMC1 / RMC4 cells."""
    return iter_cells() + dlrm_cells()


def orchestrate(out_dir: str, device: str = "cuda", arch_filter=None,
                timeout_s: int = 3600) -> int:
    """Each cell in a fresh process, with a JSON cache and a per-cell
    timeout; a failed or timed-out cell is recorded ``ok: false`` with its
    error.  Returns the number of failures."""
    os.makedirs(out_dir, exist_ok=True)
    failures = 0
    src = str(REPO_ROOT / "src")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH", "")) if p)}
    for arch, shape, skip in all_cells():
        if arch_filter and arch != arch_filter:
            continue
        path = cell_path(out_dir, arch, shape)
        if skip:
            with open(path, "w") as f:
                json.dump({"arch": arch, "shape": shape, "ok": True,
                           "skipped": skip}, f, indent=1)
            print(f"[skip] {arch}:{shape} — {skip}")
            continue
        if os.path.exists(path):
            with open(path) as f:
                prev = json.load(f)
            if prev.get("ok"):
                print(f"[cache] {arch}:{shape}")
                continue
        print(f"[run ] {arch}:{shape} ...", flush=True)
        t0 = time.time()
        err = None
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--device", device,
                 "--out", out_dir],
                capture_output=True, text=True, timeout=timeout_s, env=env)
            if proc.returncode != 0:
                err = "\n".join(proc.stderr.strip().splitlines()[-12:])
        except subprocess.TimeoutExpired:
            err = f"timeout after {timeout_s} s"
        dt = time.time() - t0
        if err is not None:
            failures += 1
            with open(path, "w") as f:
                json.dump({"arch": arch, "shape": shape, "ok": False,
                           "error": err}, f, indent=1)
            print(f"[FAIL] {arch}:{shape} ({dt:.0f}s)\n  "
                  + err.replace("\n", "\n  "))
        else:
            print(f"[ ok ] {arch}:{shape} ({dt:.0f}s)", flush=True)
    return failures


def table(out_dir: str) -> str:
    """The records of every cell under ``out_dir`` as a markdown table:
    FLOPs, dot bytes, argument bytes, peak bytes (arguments included),
    ``fits_80gb``, the dominant roofline term, the predicted step time (the
    larger term) and the trace time."""
    rows = ["| cell | FLOPs | dot bytes | arguments | peak | fits 80 GB "
            "| dominant | predicted ms | trace s |",
            "|---|---|---|---|---|---|---|---|---|"]
    skipped: Dict[str, List[str]] = {}
    for arch, shape, skip in all_cells():
        if skip:                        # one row per reason, at the end
            skipped.setdefault(skip, []).append(f"{arch}:{shape}")
            continue
        path = cell_path(out_dir, arch, shape)
        if not os.path.exists(path):
            rows.append(f"| {arch}:{shape} | not run | | | | | | | |")
            continue
        with open(path) as f:
            r = json.load(f)
        if not r["ok"]:
            err = r["error"].splitlines()[-1][:80]
            rows.append(f"| {arch}:{shape} | ok: false ({err}) "
                        "| | | | | | | |")
            continue
        m, rf = r["memory"], r["roofline"]
        ms = max(rf["compute_s"], rf["memory_s"]) * 1e3
        rows.append(
            f"| {arch}:{shape}{' (per layer)' * (r['layers'] == 'per_layer')}"
            f" | {r['cost']['flops']:.4g} | {r['cost']['dot_bytes']:.4g} "
            f"| {m['argument_bytes']:.4g} | {m['total_bytes']:.4g} "
            f"| {m['fits_80gb']} | {rf['dominant'][:-2]} | {ms:.4g} "
            f"| {r['trace_s']} |")
    for reason, names in skipped.items():
        rows.append(f"| {', '.join(names)} | skipped: {reason} "
                    "| | | | | | | |")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' device (default: the card)")
    ap.add_argument("--timeout", type=int, default=3600,
                    help="seconds per cell under --all")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--table", action="store_true",
                    help="print the records under --out as a markdown table")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return
    resolve_device(args.device)      # the card unless --device cpu
    if args.all:
        failures = orchestrate(args.out, args.device, args.arch,
                               args.timeout)
        sys.exit(1 if failures else 0)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    rec = run_cell(args.arch, args.shape, args.device, out_dir=args.out)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
