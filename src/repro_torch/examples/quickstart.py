"""Quickstart: the PIFS embedding engine in ~80 lines (the port of
``examples/quickstart.py``).

Builds a sharded multi-table embedding, looks up in all three modes
(pifs / pond / beacon), observes traffic, and runs one plan+migrate cycle
-- the paper's core loop.  The engine knobs are exposed so the quickstart
exercises the same datapaths production serving uses:

  --storage {fp32,int8}   cold-tier format (int8 = per-page scales, dequant
                          fused into the SLS accumulate)
  --dedup {off,auto,on}   gather-once duplicate coalescing (bit-exact)
  --impl {cuda,torch}     SLS datapath (cuda: the hand-written kernels on
                          the card, their plain versions on the CPU;
                          torch: the plain versions)
  --device {cuda,cpu}     where the engine lives (default: the card)

The reference's (2, 4) mesh is 4 cold-tier shards on one device here.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      [--storage int8] [--dedup on] [--impl torch] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.pifs import engine_for_tables
from repro_torch.data.traces import TraceConfig, TraceGenerator

N_SHARDS = 4     # 4 "memory devices"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--storage", default="fp32", choices=["fp32", "int8"])
    ap.add_argument("--dedup", default="off", choices=["off", "auto", "on"])
    ap.add_argument("--impl", default="cuda", choices=["cuda", "torch"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    # two embedding tables (think: ad ids, user ids) stacked into one engine
    engine, offsets = engine_for_tables(
        vocab_sizes=[100_000, 50_000], dim=32, device=args.device,
        hot_fraction=0.05, storage=args.storage, dedup=args.dedup,
        n_shards=N_SHARDS)
    state = engine.init_state(
        torch.Generator(device=engine.device).manual_seed(0))
    print(f"pages={engine.cfg.num_pages} page_size={engine.cfg.page_size} "
          f"rows cold_shards={engine.cfg.n_shards} "
          f"hot_rows={engine.cfg.hot_rows} storage={args.storage} "
          f"dedup={args.dedup} impl={args.impl} device={engine.device}")

    # a zipfian access trace (the DLRM reality: a few rows are very hot);
    # table-local ids are folded into each table's own vocab before the
    # global offsets are applied
    gen = TraceGenerator(TraceConfig(n_rows=100_000, n_tables=2, pooling=4,
                                     batch=64, distribution="zipfian"))
    batch = gen.next_batch()                     # (64, 2, 4) table-local ids
    batch = batch % np.array([100_000, 50_000])[None, :, None]
    idx = torch.as_tensor(batch + offsets[None, :, None], dtype=torch.int32,
                          device=engine.device)

    def host(t):
        return t.cpu().numpy()

    # pifs: reduce near the data -- only pooled (B, T, D) partials leave a
    # shard; pond: the communicate-then-reduce baseline (raw rows move)
    pooled = engine.lookup(state, idx, mode="pifs", impl=args.impl)
    pooled_pond = engine.lookup(state, idx, mode="pond", impl=args.impl)
    np.testing.assert_allclose(host(pooled), host(pooled_pond),
                               rtol=1e-5, atol=1e-5)
    print("pifs == pond numerically:", tuple(pooled.shape))

    # observe traffic -> plan -> migrate (placement-invariant!)
    for _ in range(4):
        state = engine.observe(state, idx)
    before = host(engine.lookup(state, idx, impl=args.impl))
    state, stats = engine.plan_and_migrate(state)
    after = host(engine.lookup(state, idx, impl=args.impl))
    # migration moves rows between the cold and hot partial sums, so the
    # pooled association can shift an ulp -- values, not placement, are
    # invariant (the engine tests pin the exact-domain contracts)
    np.testing.assert_allclose(before, after, rtol=1e-5, atol=1e-5)
    print(f"migrated {stats['moved_pages']} pages "
          f"(hot={stats['hot_pages']}, "
          f"load std {stats['load_std_before']:.1f} -> "
          f"{stats['load_std_after']:.1f}); lookups unchanged")
    out = {"pooled": pooled, "pond": pooled_pond, "before": before,
           "after": after, "stats": stats}
    if args.dedup != "off":
        d = engine.dedup_factor(state, idx)
        print(f"duplicate-access factor: {d['factor']:.2f}x "
              f"({d['entries']} entries -> {d['unique_rows']} unique)")
        out["dedup"] = d
    return out


if __name__ == "__main__":
    main()
