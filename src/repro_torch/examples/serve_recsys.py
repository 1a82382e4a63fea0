"""Online-serving example: recsys CTR inference (DCN-v2 by default)
through the ``repro_torch.serving`` runtime -- Poisson arrivals,
deadline-aware dynamic micro-batching into shape buckets (no lookup
signature new after warmup) -- comparing pifs and pond tail latency at
the same offered load.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_recsys
      [--arch dcn-v2] [--requests 2048] [--qps 200] [--full]
      [--device cpu]

The port of ``examples/serve_recsys.py``: the reduced config unless
``--full``, its cold tier in 4 shards on one device (the reference
example's model axis), on the card unless ``--device cpu``.
"""
import argparse

from repro_torch.configs import get_config, reduced
from repro_torch.launch.serve import serve_offered_load
from repro_torch.serving import ArrivalConfig, LoadConfig

N_SHARDS = 4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dcn-v2")
    ap.add_argument("--requests", type=int, default=2048)
    ap.add_argument("--qps", type=float, default=200.0)
    ap.add_argument("--slo-ms", type=float, default=50.0)
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "bursty", "uniform"])
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: reduced)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    load = LoadConfig(
        n_requests=args.requests,
        arrival=ArrivalConfig(rate_qps=args.qps, process=args.arrival),
        slo_ms=args.slo_ms)
    outs = {}
    for mode in ("pifs", "pond"):
        out = serve_offered_load(cfg, load, device=args.device, mode=mode,
                                 n_shards=N_SHARDS)
        outs[mode] = out
        print(f"{args.arch} [{mode:5s}] served={out['served']} "
              f"qps={out['qps']:.1f} p50={out['p50_ms']:.2f}ms "
              f"p99={out['p99_ms']:.2f}ms "
              f"slo_viol={out['slo_violation_rate']:.3f} "
              f"occupancy={out['batch_occupancy_mean']:.2f} "
              f"steady_traces={out['steady_traces']}")
    return outs


if __name__ == "__main__":
    main()
