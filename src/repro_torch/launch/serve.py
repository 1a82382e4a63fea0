"""Serving entry point: online DLRM inference through ``repro_torch.serving``.

``python -m repro_torch.launch.serve --arch rmc4 --full --qps 200
--slo-ms 50``

The port of ``repro.launch.serve``: binds the model to a ``ServeBinding``
(``core/pifs.py``) on the card (``--device cpu`` for the CPU), generates
an open- or closed-loop request stream from the trace distributions (the
reference's streams, bit for bit), warms every shape bucket (afterwards
no lookup signature is new: ``steady_traces`` is 0), and drives the
deadline-aware dynamic micro-batcher (``--batcher fixed``: always a full
batch of ``max(--batch-sizes)``).  The engine's access profiler and
periodic re-planning (paper section IV-B4) fold into the serving cadence
between micro-batches (``--observe-every``, ``--replan-every``).
``--mode pifs|pond|beacon`` is the engine's mode (every mode, beacon too,
gets the same hot tier, and the engine serves beacon as pifs); the cold
tier's shard count is :func:`build_serving`'s ``n_shards`` (the
reference CLI has no flag for its mesh either).  ``--update-qps`` arms the
streaming-update stream (``--update-batch`` rows per trainer batch,
``--wal`` to write-ahead-log every applied batch), drained between
micro-batches with its staleness in the summary.  The reference's scrub
and mesh-fault regimes raise until ``ROADMAP.md`` queue 1 items 12 and 13
port them.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.wal import WriteAheadLog
from repro_torch.configs import DLRMConfig, get_config, reduced
from repro_torch.core.pifs import ServeBinding
from repro_torch.core.updates import UpdateConfig
from repro_torch.device import DeviceLike
from repro_torch.serving.batcher import (BatcherConfig, DynamicBatcher,
                                         FixedBatcher, ServiceModel)
from repro_torch.serving.loadgen import (LoadConfig, bind_model,
                                         closed_loop_factory,
                                         dummy_request_factory, make_padder,
                                         prime_dedup_auto, request_stream,
                                         update_stream)
from repro_torch.serving.request import ArrivalConfig, Request
from repro_torch.serving.runtime import (BindingExecutor, ClosedLoopSource,
                                         OpenLoopSource, RuntimeConfig,
                                         ServingRuntime)
from repro_torch.serving.updates import StreamingUpdater


def _not_ported(scrub: bool = False, mesh_faults: bool = False) -> None:
    if scrub:
        raise NotImplementedError("--scrub is not ported yet (ROADMAP.md "
                                  "queue 1 item 12)")
    if mesh_faults:
        raise NotImplementedError("--mesh-faults is not ported yet "
                                  "(ROADMAP.md queue 1 item 13)")


def build_serving(cfg: DLRMConfig, device: DeviceLike = None, *,
                  mode: str = "pifs", impl: str = "cuda",
                  batcher: str = "dynamic",
                  batch_sizes: Tuple[int, ...] = (8, 16, 32),
                  poolings: Tuple[int, ...] = (),
                  slo_ms: float = 50.0, hot_fraction: float = 0.05,
                  storage: str = "fp32", dedup: str = "off",
                  front_end: str = "split",
                  runtime_cfg: RuntimeConfig = RuntimeConfig(),
                  validate_ids: bool = False, n_shards: int = 1,
                  service: Optional[ServiceModel] = None,
                  ) -> Tuple[ServingRuntime, ServeBinding]:
    """Compose (runtime, binding) for a config on ``device`` (the card
    unless ``"cpu"``), its cold tier in ``n_shards`` shards; buckets are
    warmed by the caller (:func:`run_offered_load`).  The executor is a
    ``BindingExecutor`` (``runtime.executor.scores``); ``service`` pins its
    service times to that model's estimates (and seeds the batcher with
    the same model), so the flush sequence depends on the stream alone."""
    binding = bind_model(cfg, device, mode=mode, impl=impl,
                         hot_fraction=hot_fraction, storage=storage,
                         dedup=dedup, front_end=front_end,
                         validate_ids=validate_ids, n_shards=n_shards)
    levels = tuple(sorted(set(poolings))) or (cfg.pooling,)
    if batcher == "dynamic":
        b = DynamicBatcher(BatcherConfig(
            batch_sizes=tuple(sorted(batch_sizes)), poolings=levels,
            max_wait_ms=slo_ms / 2))
    elif batcher == "fixed":
        b = FixedBatcher(batch=max(batch_sizes), pooling=levels[-1])
    else:
        raise ValueError(f"unknown batcher {batcher!r}")
    runtime = ServingRuntime(
        BindingExecutor(binding, make_padder(cfg), service), b,
        cfg=runtime_cfg, service_model=service)
    return runtime, binding


def make_updater(binding: ServeBinding, cfg: DLRMConfig, load: LoadConfig,
                 update_cfg: Optional[UpdateConfig] = None,
                 wal_path: Optional[str] = None
                 ) -> Optional[StreamingUpdater]:
    """The ``StreamingUpdater`` of ``load``'s update stream (none when
    ``load.update_qps`` is 0), logging to a WAL at ``wal_path`` if one is
    given."""
    if load.update_qps <= 0:
        return None
    return StreamingUpdater(
        binding, update_stream(cfg, load), update_cfg or UpdateConfig(),
        wal=WriteAheadLog(wal_path) if wal_path else None)


def run_offered_load(runtime: ServingRuntime, binding: ServeBinding,
                     cfg: DLRMConfig, load: LoadConfig,
                     closed_loop_users: int = 0,
                     updater: Optional[StreamingUpdater] = None
                     ) -> Dict[str, object]:
    """Warm every bucket, serve the stream, and report the runtime's
    summary plus the steady-state signature count (``steady_traces``,
    which must be 0), the re-plans taken while serving, the front-end and
    dedup resolutions, the measured per-bucket dedup factors, and (this
    port only) each bucket's warmup service time
    (``warmup_service_ms``).  An ``updater`` is warmed before the stats
    reset, drains on the runtime's maintenance seam, and reports under
    ``updates``."""
    dummies = dummy_request_factory(cfg, storage=load.storage)
    warm = runtime.warmup(dummies)
    # the open-loop stream is only materialised when something uses it
    # (the serving source, or the 'auto' priming prefix)
    reqs = (request_stream(cfg, load)
            if load.dedup == "auto" or closed_loop_users <= 0 else None)
    if load.dedup == "auto" and prime_dedup_auto(binding, reqs):
        # 'auto' resolves at a signature's first lookup: prime the profiler
        # with a prefix of the live stream, then resolve the buckets again
        # against the primed histogram (still before steady state)
        warm = runtime.warmup(dummies)
    if updater is not None:
        updater.warmup()              # the apply signature, before steady
        runtime.updater = updater
    binding.reset_plan_stats()        # steady state begins here
    binding.dedup_stats.clear()       # drop warmup-dummy observations
    warm_replans = binding.replans
    if closed_loop_users > 0:
        source = ClosedLoopSource(
            closed_loop_users, load.n_requests,
            closed_loop_factory(cfg, load),
            think_time_s=closed_loop_users / load.arrival.rate_qps)
    else:
        source = OpenLoopSource(reqs)
    summary = runtime.run(source)
    stats = binding.plan_stats()
    summary["steady_traces"] = stats["traces"]
    summary["plans"] = stats["plans"]
    summary["front_end"] = stats.get("front_end", {})
    summary["replans"] = binding.replans - warm_replans
    summary["dedup_factors"] = binding.dedup_report()
    summary["warmup_service_ms"] = {k: v * 1e3 for k, v in warm.items()}
    if updater is not None:
        summary["updates"] = updater.report()
    return summary


def serve_offered_load(cfg: DLRMConfig, load: LoadConfig, *,
                       device: DeviceLike = None, mode: str = "pifs",
                       impl: str = "cuda", batcher: str = "dynamic",
                       batch_sizes: Tuple[int, ...] = (8, 16, 32),
                       hot_fraction: float = 0.05,
                       runtime_cfg: RuntimeConfig = RuntimeConfig(),
                       closed_loop_users: int = 0,
                       validate_ids: bool = False, n_shards: int = 1,
                       update_cfg: Optional[UpdateConfig] = None,
                       wal_path: Optional[str] = None,
                       mesh_faults: bool = False, scrub: bool = False,
                       ) -> Dict[str, object]:
    """End to end: bind, warm every bucket, serve the stream, and report
    metrics and the steady-state signature count (must be 0).  The
    engine's cold-tier storage rides in ``load.storage`` (the request
    streams need it for the tables' page-rounded offsets), the gather-once
    knob in ``load.dedup``, the front end in ``load.front_end``.
    ``device`` and ``n_shards`` take the place of the reference's mesh.

    ``load.update_qps > 0`` arms the streaming-update stream
    (``update_stream``), drained between micro-batches by a
    ``StreamingUpdater`` of ``update_cfg`` (warmed before the stats
    reset); with ``wal_path`` every applied batch is write-ahead-logged
    there.  The summary then carries ``updates`` (the updater's report)
    and ``staleness``.  The scrub and mesh-fault regimes raise until
    ``ROADMAP.md`` queue 1 items 12 and 13 port them."""
    _not_ported(scrub, mesh_faults)
    runtime, binding = build_serving(
        cfg, device, mode=mode, impl=impl, batcher=batcher,
        batch_sizes=batch_sizes, poolings=load.poolings, slo_ms=load.slo_ms,
        hot_fraction=hot_fraction, storage=load.storage, dedup=load.dedup,
        front_end=load.front_end, runtime_cfg=runtime_cfg,
        validate_ids=validate_ids, n_shards=n_shards)
    return run_offered_load(runtime, binding, cfg, load, closed_loop_users,
                            make_updater(binding, cfg, load, update_cfg,
                                         wal_path))


def serve(binding: ServeBinding, step, requests: Sequence[Request],
          batch: int, observe_every: int = 4, replan_every: int = 64,
          service: Optional[ServiceModel] = None) -> dict:
    """Serve ``requests`` through ``step`` (a ``make_serve_step`` of the
    binding's model and engine, made the binding's active variant for the
    run) with a fixed batcher of ``batch`` and the runtime's maintenance
    cadence, without warmup.  Returns the scores in request order, the
    per-batch service times (the wall time of ``execute``: copy, step,
    synchronize; or ``service``'s estimates), their p50 / p99, the
    requests per second of service time, and the maintenance calls and
    times."""
    executor = BindingExecutor(binding, make_padder(binding.model.cfg),
                               service)
    runtime = ServingRuntime(
        executor, FixedBatcher(batch, max(r.pooling for r in requests)),
        cfg=RuntimeConfig(queue_capacity=len(requests),
                          observe_every=observe_every,
                          replan_every=replan_every),
        service_model=service)
    active = binding.active
    binding.steps["serve"] = step
    binding.set_mode("serve")
    try:
        runtime.run(OpenLoopSource(requests))
    finally:
        binding.set_mode(active)
        del binding.steps["serve"]
    m = runtime.metrics
    ms = np.asarray([b.service_s * 1e3 for b in m.batches])
    return {"scores": np.asarray([executor.scores[r.rid] for r in requests],
                                 np.float32),
            "service_ms": ms, "batches": len(ms),
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "qps": len(requests) / (ms.sum() * 1e-3),
            "observes": m.maintenance_calls.get("observe", 0),
            "replans": m.maintenance_calls.get("replan", 0),
            "maintenance_ms": {k: v * 1e3
                               for k, v in m.maintenance_s.items()}}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rmc1")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the reduced "
                         "config of CPU smoke tests)")
    ap.add_argument("--requests", type=int, default=1024)
    ap.add_argument("--qps", type=float, default=200.0,
                    help="offered load (virtual-clock requests/second)")
    ap.add_argument("--slo-ms", type=float, default=50.0)
    ap.add_argument("--mode", default="pifs",
                    choices=["pifs", "pond", "beacon"])
    ap.add_argument("--storage", default="fp32", choices=["fp32", "int8"])
    ap.add_argument("--dedup", default="off", choices=["off", "auto", "on"],
                    help="gather-once coalescing of duplicate rows")
    ap.add_argument("--front-end", default="split",
                    choices=["split", "fused"])
    ap.add_argument("--batcher", default="dynamic",
                    choices=["dynamic", "fixed"])
    ap.add_argument("--batch-sizes", type=int, nargs="+",
                    default=[8, 16, 32])
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "bursty", "uniform"])
    ap.add_argument("--closed-loop-users", type=int, default=0,
                    help="> 0 switches to a closed-loop load of N users")
    ap.add_argument("--validate-ids", action="store_true",
                    help="raise on out-of-range embedding ids (checked on "
                         "the host) instead of serving the clamped row")
    ap.add_argument("--update-qps", type=float, default=0.0,
                    help="> 0 arms the streaming embedding-update stream "
                         "(delta rows/second on the virtual clock), "
                         "drained between micro-batches")
    ap.add_argument("--update-batch", type=int, default=64,
                    help="rows per trainer-emitted delta batch")
    ap.add_argument("--wal", default=None, metavar="PATH",
                    help="write-ahead-log applied update batches to PATH")
    ap.add_argument("--scrub", action="store_true")
    ap.add_argument("--mesh-faults", action="store_true")
    ap.add_argument("--observe-every", type=int, default=4,
                    help="batches between histogram updates (0 = off)")
    ap.add_argument("--replan-every", type=int, default=64,
                    help="batches between re-plans (0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    _not_ported(args.scrub, args.mesh_faults)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    load = LoadConfig(
        n_requests=args.requests,
        arrival=ArrivalConfig(rate_qps=args.qps, process=args.arrival,
                              seed=args.seed),
        slo_ms=args.slo_ms, seed=args.seed, storage=args.storage,
        dedup=args.dedup, front_end=args.front_end,
        update_qps=args.update_qps, update_batch=args.update_batch)
    # every mode, beacon too, gets the reference CLI's hot tier
    # (hot_fraction=0.05); the engine serves beacon as pifs
    runtime, binding = build_serving(
        cfg, args.device, mode=args.mode, batcher=args.batcher,
        batch_sizes=tuple(args.batch_sizes), slo_ms=args.slo_ms,
        hot_fraction=0.05, storage=args.storage, dedup=args.dedup,
        front_end=args.front_end, validate_ids=args.validate_ids,
        runtime_cfg=RuntimeConfig(observe_every=args.observe_every,
                                  replan_every=args.replan_every))
    out = run_offered_load(runtime, binding, cfg, load,
                           closed_loop_users=args.closed_loop_users,
                           updater=make_updater(binding, cfg, load,
                                                wal_path=args.wal))
    scores = runtime.executor.scores
    out["scores"] = np.asarray([scores[i] for i in range(args.requests)
                                if i in scores], np.float32)
    out["scores_finite"] = bool(np.isfinite(out["scores"]).all())
    out["dedup"] = binding.plan_stats().get("dedup", {})
    dev = binding.engine.device
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    hidden = ("scores", "latency_hist", "front_end", "dedup_factors",
              "staleness", "updates")
    for k, v in out.items():
        if k not in hidden:
            print(f"  {k:24s} {v}")
    if "updates" in out:
        print("  -- streaming updates --")
        for k, v in out["updates"].items():
            print(f"  {k:24s} {v}")
    staleness = out.get("staleness")
    if staleness is not None:
        print("  -- staleness (rows / seconds behind) --")
        print(f"  rows_behind   p50={staleness['rows_behind_p50']:.1f} "
              f"p99={staleness['rows_behind_p99']:.1f} "
              f"max={staleness['rows_behind_max']:.1f}")
        print(f"  seconds_behind p50={staleness['seconds_behind_p50']:.4f} "
              f"p99={staleness['seconds_behind_p99']:.4f} "
              f"max={staleness['seconds_behind_max']:.4f}")
    for label, rec in out["front_end"].items():
        print(f"  front_end[{label}]  requested={rec['requested']} "
              f"resolved={rec['resolved']} (tp={rec['tp']})")
    for bucket, rec in out["dedup_factors"].items():
        print(f"  dedup[{bucket}]  factor={rec['factor']:.2f} "
              f"({rec['entries']} entries -> {rec['unique_rows']} unique "
              f"rows over {rec['batches']} observed batches)")
    return out


if __name__ == "__main__":
    main()
