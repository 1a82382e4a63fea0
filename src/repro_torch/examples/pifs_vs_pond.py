"""Reproduce the paper's headline comparison: PIFS-Rec vs Pond vs Pond+PM vs
BEACON vs RecNMP on an RMC4-scale zipfian trace (simlab, Table II params).

The port of ``examples/pifs_vs_pond.py``.  The analytic comparison
(``repro_torch.simlab``, numpy on the host) is backed by a live-engine
cross-check: the same zipfian trace runs through a real
``PIFSEmbeddingEngine`` with the datapath knobs, its cold tier in 4
shards on one device (the reference example's model axis), verifying
pifs == pond numerically and reporting the measured duplicate-access
factor the knobs exploit.

Run:  PYTHONPATH=src python -m repro_torch.examples.pifs_vs_pond
      [--storage int8] [--dedup on] [--impl torch] [--skip-engine]
      [--device cpu] [--rows N]

The cross-check runs on the card unless ``--device cpu``.  Its tables
hold ``min(emb_num, 8192)`` rows each by default (the reference's CPU
shrink); ``--rows 1048576`` is RMC4's full width.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.pifs import engine_for_tables
from repro_torch.data.traces import (TraceConfig, TraceGenerator,
                                     flatten_trace)
from repro_torch.device import DeviceLike
from repro_torch.simlab.devices import HardwareParams
from repro_torch.simlab.simulator import ALL_SYSTEMS, make_system, simulate

PAPER = {"pond": 3.89, "pond_pm": 3.57, "beacon": 2.03, "recnmp": 1.11}
N_SHARDS = 4          # the reference example's (2, 4) mesh: tp = 4
CPU_ROWS = 8192       # the reference's CPU-sized shrink


def paper_trace(model, n_batches: int = 6, batch: int = 512) -> np.ndarray:
    """The example's trace: ``n_batches`` zipfian batches of ``batch``
    samples over the model's tables, flattened to global row ids."""
    gen = TraceGenerator(TraceConfig(
        n_rows=model.emb_num, n_tables=model.n_tables,
        pooling=model.pooling, batch=batch, distribution="zipfian", seed=0))
    arr = np.stack([gen.next_batch() for _ in range(n_batches)])
    return flatten_trace(arr.reshape(-1, model.n_tables, model.pooling),
                         model.emb_num)


def simulate_all(model, flat: np.ndarray, hw: Optional[HardwareParams] = None
                 ) -> dict:
    """``simulate`` for every system of ``ALL_SYSTEMS`` on ``flat``, as the
    reference example calls it (``row_bytes = model.emb_dim``)."""
    hw = hw or HardwareParams()
    return {name: simulate(flat, model.emb_dim, model.pooling,
                           make_system(name, hw), hw,
                           n_rows_total=model.emb_num * model.n_tables)
            for name in ALL_SYSTEMS}


def cross_check_setup(model, storage: str, dedup: str,
                      device: DeviceLike = None, n_rows: Optional[int] = None,
                      batch: int = 64):
    """The cross-check's engine (``n_rows`` rows per table, default
    ``min(emb_num, 8192)``; 4 shards), its state (normal * 0.01 from seed
    0) and one zipfian batch of ids on the engine's device:
    ``(engine, state, idx, n_rows)``."""
    n_rows = min(model.emb_num, CPU_ROWS) if n_rows is None else n_rows
    engine, offsets = engine_for_tables(
        [n_rows] * model.n_tables, dim=model.emb_dim, device=device,
        hot_fraction=0.05, storage=storage, dedup=dedup, n_shards=N_SHARDS)
    state = engine.init_state(
        torch.Generator(device=engine.device).manual_seed(0))
    ids = TraceGenerator(TraceConfig(
        n_rows=n_rows, n_tables=model.n_tables, pooling=model.pooling,
        batch=batch, distribution="zipfian", seed=0)).next_batch()
    idx = torch.as_tensor(ids + offsets[None, :, None], dtype=torch.int32,
                          device=engine.device)
    return engine, state, idx, n_rows


def engine_cross_check(model, storage: str, dedup: str, impl: str,
                       device: DeviceLike = None,
                       n_rows: Optional[int] = None) -> dict:
    """Run the trace through a real engine with the requested knobs (the
    simulation is analytic; this is the live datapath the knobs change):
    pifs == pond within 1e-5, and the measured duplicate factor.  Returns
    both lookups, the factor and the engine, state and ids it used."""
    engine, state, idx, n_rows = cross_check_setup(model, storage, dedup,
                                                   device, n_rows)
    pifs = engine.lookup(state, idx, mode="pifs", impl=impl)
    pond = engine.lookup(state, idx, mode="pond", impl=impl)
    np.testing.assert_allclose(pifs.cpu().numpy(), pond.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    d = engine.dedup_factor(state, idx)
    print(f"\nlive engine ({storage}, dedup={dedup}, impl={impl}, "
          f"{n_rows} rows/table, {N_SHARDS} shards on "
          f"{engine.device.type}): pifs == pond ok; "
          f"zipfian duplicate factor {d['factor']:.2f}x "
          f"({d['entries']} entries -> {d['unique_rows']} unique rows)")
    return {"pifs": pifs, "pond": pond, "dedup": d, "n_rows": n_rows,
            "engine": engine, "state": state, "idx": idx}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--storage", default="fp32", choices=["fp32", "int8"],
                    help="engine cold-tier format for the live cross-check")
    ap.add_argument("--dedup", default="off", choices=["off", "auto", "on"],
                    help="gather-once duplicate coalescing knob")
    ap.add_argument("--impl", default="cuda", choices=["cuda", "torch"],
                    help="engine SLS datapath (cuda: the kernels on the "
                         "card; torch: their plain versions)")
    ap.add_argument("--skip-engine", action="store_true",
                    help="analytic simulation only (no live engine)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rows", type=int, default=None,
                    help="rows per table in the cross-check (default "
                         f"min(emb_num, {CPU_ROWS}))")
    args = ap.parse_args(argv)

    model = get_config("rmc4")
    flat = paper_trace(model)
    print(f"trace: {flat.size} row accesses, {model.emb_num * 8} rows, "
          f"{model.emb_dim}B rows, pooling {model.pooling}")
    print(f"{'system':10s} {'latency':>12s} {'binding':>12s} "
          f"{'local%':>7s} {'hit%':>6s} {'vs pifs':>8s} {'paper':>7s}")
    res = simulate_all(model, flat)
    p = res["pifs"].total_us
    for name in ALL_SYSTEMS:
        r = res[name]
        ratio = r.total_us / p
        paper = PAPER.get(name)
        print(f"{name:10s} {r.total_us:10.1f}us {r.binding:>12s} "
              f"{100 * r.frac_local_access:6.1f} "
              f"{100 * r.buffer_hit_rate:5.1f} {ratio:8.2f} "
              f"{paper if paper else '':>7}")
    out = {"sim": res}
    if not args.skip_engine:
        out["engine"] = engine_cross_check(model, args.storage, args.dedup,
                                           args.impl, args.device,
                                           args.rows)
    return out


if __name__ == "__main__":
    main()
