"""Serving entry point: online DLRM and recsys inference through
``repro_torch.serving``.

``python -m repro_torch.launch.serve --arch rmc4 --full --qps 200
--slo-ms 50``; ``--arch`` also takes the recsys ids ``sasrec``, ``bst``,
``autoint`` and ``dcn-v2`` (their requests are L = 1 bags, pooling 1).

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
micro-batches with its staleness in the summary.  ``--scrub`` arms the
page-checksum ledger, a snapshot and the scrubber (``--scrub-pages-per-
cycle`` pages audited per micro-batch, diverged pages repaired from the
snapshot and the WAL tail).  ``--mesh-faults`` serves on 4 cold shards,
kills the highest one at live attempt 2 and recovers by an elastic
re-mesh onto the survivors (``--prefer-tp``), under the degradation
controller and a straggler watchdog.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.wal import WriteAheadLog
from repro_torch.configs import Config, get_config, list_archs, reduced
from repro_torch.core.pifs import ServeBinding
from repro_torch.core.updates import UpdateConfig
from repro_torch.device import DeviceLike
from repro_torch.runtime.fault_tolerance import StragglerWatchdog
from repro_torch.serving.batcher import (BatcherConfig, DynamicBatcher,
                                         FixedBatcher, ServiceModel)
from repro_torch.serving.degradation import (BreakerConfig,
                                             DegradationController,
                                             LadderConfig, RetryPolicy)
from repro_torch.serving.faults import FaultConfig, FaultInjectingExecutor
from repro_torch.serving.loadgen import (LoadConfig, bind_model,
                                         closed_loop_factory,
                                         dummy_request_factory, make_padder,
                                         prime_dedup_auto, request_stream,
                                         update_stream)
from repro_torch.serving.request import ArrivalConfig, Request
from repro_torch.serving.runtime import (BindingExecutor, ClosedLoopSource,
                                         OpenLoopSource, RuntimeConfig,
                                         ServingRuntime)
from repro_torch.serving.scrub import ScrubConfig, ScrubController
from repro_torch.serving.updates import StreamingUpdater

MESH_FAULT_SHARDS = 4   # the reference CLI's model axis, min(4, devices)


def build_serving(cfg: Config, device: DeviceLike = None, *,
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
                  elastic: bool = False, prefer_tp: int = 2,
                  ) -> Tuple[ServingRuntime, ServeBinding]:
    """Compose (runtime, binding) for a config on ``device`` (the card
    unless ``"cpu"``), its cold tier in ``n_shards`` shards; buckets are
    warmed by the caller (:func:`run_offered_load`).  The executor is a
    ``BindingExecutor`` (``runtime.executor.scores``); ``service`` pins its
    service times to that model's estimates (and seeds the batcher with
    the same model), so the flush sequence depends on the stream alone.
    ``elastic`` also binds the brown-out rungs, the score scrub and the
    re-mesh rebinder (tp preference ``prefer_tp``), so a persistent shard
    loss can recover mid-serving onto the survivors."""
    binding = bind_model(cfg, device, mode=mode, impl=impl,
                         hot_fraction=hot_fraction, storage=storage,
                         dedup=dedup, front_end=front_end,
                         validate_ids=validate_ids, n_shards=n_shards,
                         degraded_variants=elastic, scrub_scores=elastic,
                         elastic=elastic, prefer_tp=prefer_tp)
    levels = tuple(sorted(set(poolings))) or (
        (cfg.pooling,) if hasattr(cfg, "pooling") else (1,))
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


def make_updater(binding: ServeBinding, cfg: Config, load: LoadConfig,
                 update_cfg: Optional[UpdateConfig] = None,
                 wal_path: Optional[str] = None
                 ) -> Optional[StreamingUpdater]:
    """The ``StreamingUpdater`` of ``load``'s update stream (none when
    ``load.update_qps`` is 0), logging to a WAL at ``wal_path`` if one is
    given.  A recsys config with ``update_qps > 0`` raises ``TypeError``
    (``update_stream``)."""
    if load.update_qps <= 0:
        return None
    return StreamingUpdater(
        binding, update_stream(cfg, load), update_cfg or UpdateConfig(),
        wal=WriteAheadLog(wal_path) if wal_path else None)


def arm_mesh_faults(runtime: ServingRuntime, binding: ServeBinding) -> None:
    """The reference's degraded-mesh regime on ``runtime``: a degradation
    controller (3 attempts, a breaker tripping after 6 failures with a
    20 ms cooldown, a ladder dwelling 4 batches that escalates to a
    re-mesh after 3 same-shard failures) and a straggler watchdog
    (threshold 4, warmup 4)."""
    runtime.controller = DegradationController(
        binding=binding,
        retry=RetryPolicy(max_attempts=3),
        breaker=BreakerConfig(trip_after=6, cooldown_s=0.02),
        ladder=LadderConfig(min_dwell_batches=4, remesh_after=3))
    runtime.watchdog = StragglerWatchdog(threshold=4.0, warmup=4)


def run_offered_load(runtime: ServingRuntime, binding: ServeBinding,
                     cfg: Config, load: LoadConfig,
                     closed_loop_users: int = 0,
                     updater: Optional[StreamingUpdater] = None,
                     scrub: Optional[ScrubConfig] = None,
                     scrub_dir: Optional[str] = None,
                     faults: Optional[FaultConfig] = None,
                     requests: Optional[Sequence[Request]] = None
                     ) -> Dict[str, object]:
    """Warm every bucket, serve the stream, and report the runtime's
    summary plus the steady-state signature count (``steady_traces``,
    which must be 0), the re-plans taken while serving, the front-end and
    dedup resolutions, the measured per-bucket dedup factors, and (this
    port only) each bucket's warmup service time of the full rung
    (``warmup_service_ms``).  With a controller on the runtime, every
    rung is warmed.  An ``updater`` is warmed before the stats reset,
    drains on the runtime's maintenance seam, and reports under
    ``updates``.  ``scrub`` arms the binding's checksum ledger, a
    checkpointer in ``scrub_dir`` if the binding has none (its snapshot
    records the ledger) and a ``ScrubController`` on the maintenance seam
    (warmed), reporting under ``scrub_run``.  ``faults`` wraps the
    executor in a ``FaultInjectingExecutor`` after every warmup, so the
    schedule indexes live attempts only; the summary then carries
    ``remeshes`` and ``faults_fired``.  ``requests`` (this port only) is
    the open-loop stream when the caller has drawn it already
    (``request_stream(cfg, load)``), so two runs of one load share one
    draw."""
    dummies = dummy_request_factory(cfg, storage=load.storage)
    if runtime.controller is not None:
        # the controller may switch rungs mid-run: warm each over every
        # bucket through the clean executor, then serve on 'full'
        warms = {}
        for rung in binding.modes():
            binding.set_mode(rung)
            warms[rung] = runtime.warmup(dummies)
        binding.set_mode("full")
        warm = warms["full"]
    else:
        warm = runtime.warmup(dummies)
    # the open-loop stream is only materialised when something uses it
    # (the serving source, or the 'auto' priming prefix)
    reqs = requests
    if reqs is None and (load.dedup == "auto" or closed_loop_users <= 0):
        reqs = request_stream(cfg, load)
    if load.dedup == "auto" and prime_dedup_auto(binding, reqs):
        # 'auto' resolves at a signature's first lookup: prime the profiler
        # with a prefix of the live stream, then resolve the buckets again
        # against the primed histogram (still before steady state)
        warm = runtime.warmup(dummies)
    if updater is not None:
        updater.warmup()              # the apply signature, before steady
        runtime.updater = updater
    if scrub is not None:
        # arm the ledger over the live store, snapshot it (the manifest
        # records the checksums the repair path verifies against), and
        # ride the maintenance seam
        binding.attach_integrity()
        if binding.checkpointer is None:
            if scrub_dir is None:
                raise ValueError("scrub needs a checkpointer on the binding "
                                 "or a scrub_dir to snapshot into")
            binding.attach_checkpointer(Checkpointer(scrub_dir))
        scrubber = ScrubController(binding, scrub,
                                   controller=runtime.controller)
        scrubber.warmup()
        runtime.scrubber = scrubber
    if faults is not None:
        runtime.executor = FaultInjectingExecutor(runtime.executor, faults,
                                                  idx_key=binding.idx_key)
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
    if faults is not None:
        summary["remeshes"] = binding.remeshes
        summary["faults_fired"] = runtime.executor.report()
    summary["plans"] = stats["plans"]
    summary["front_end"] = stats.get("front_end", {})
    summary["replans"] = binding.replans - warm_replans
    summary["dedup_factors"] = binding.dedup_report()
    summary["warmup_service_ms"] = {k: v * 1e3 for k, v in warm.items()}
    if updater is not None:
        summary["updates"] = updater.report()
    return summary


def serve_offered_load(cfg: Config, load: LoadConfig, *,
                       device: DeviceLike = None, mode: str = "pifs",
                       impl: str = "cuda", batcher: str = "dynamic",
                       batch_sizes: Tuple[int, ...] = (8, 16, 32),
                       hot_fraction: float = 0.05,
                       runtime_cfg: RuntimeConfig = RuntimeConfig(),
                       closed_loop_users: int = 0,
                       validate_ids: bool = False, n_shards: int = 1,
                       update_cfg: Optional[UpdateConfig] = None,
                       wal_path: Optional[str] = None,
                       mesh_faults: bool = False, prefer_tp: int = 2,
                       fault_seed: int = 13, scrub: bool = False,
                       scrub_pages_per_cycle: int = 8,
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
    and ``staleness``.

    ``mesh_faults`` arms the degraded-mesh regime (the cold tier needs
    ``n_shards`` >= 2): a ``shard_loss`` fault kills the highest shard at
    live attempt 2, the degradation controller attributes the same-shard
    streak and escalates past the brown-out ladder to an elastic re-mesh
    (export, re-plan and pack on the survivor plan's shard count, rebuild
    and re-warm the serve steps), and the run finishes on the survivors.
    The summary carries ``remesh`` (MTTR: the maintenance-seam wall time),
    ``watchdog`` and ``degradation``.

    ``scrub`` arms the integrity regime: the checksum ledger, a snapshot
    into a temp dir (removed after the run) and a ``ScrubController``
    auditing ``scrub_pages_per_cycle`` pages per micro-batch and repairing
    diverged pages from the snapshot and the WAL tail; the summary
    carries ``scrub_run``."""
    return _serve(cfg, load, device=device, mode=mode, impl=impl,
                  batcher=batcher, batch_sizes=batch_sizes,
                  hot_fraction=hot_fraction, runtime_cfg=runtime_cfg,
                  closed_loop_users=closed_loop_users,
                  validate_ids=validate_ids, n_shards=n_shards,
                  update_cfg=update_cfg, wal_path=wal_path,
                  mesh_faults=mesh_faults, prefer_tp=prefer_tp,
                  fault_seed=fault_seed, scrub=scrub,
                  scrub_pages_per_cycle=scrub_pages_per_cycle)[0]


def _serve(cfg: Config, load: LoadConfig, *, device, mode, impl,
           batcher, batch_sizes, hot_fraction, runtime_cfg,
           closed_loop_users, validate_ids, n_shards, update_cfg, wal_path,
           mesh_faults, prefer_tp, fault_seed, scrub, scrub_pages_per_cycle
           ) -> Tuple[Dict[str, object], ServingRuntime, ServeBinding]:
    """:func:`serve_offered_load`, returning the runtime and the binding
    beside the summary (the CLI reads the scores from the executor)."""
    if mesh_faults and n_shards < 2:
        raise ValueError(
            "--mesh-faults needs a tp-sharded mesh (model >= 2): losing the "
            "only model shard is total loss, not a degraded mesh (got "
            f"{ {'data': 1, 'model': n_shards} })")
    runtime, binding = build_serving(
        cfg, device, mode=mode, impl=impl, batcher=batcher,
        batch_sizes=batch_sizes, poolings=load.poolings, slo_ms=load.slo_ms,
        hot_fraction=hot_fraction, storage=load.storage, dedup=load.dedup,
        front_end=load.front_end, runtime_cfg=runtime_cfg,
        validate_ids=validate_ids, n_shards=n_shards, elastic=mesh_faults,
        prefer_tp=prefer_tp)
    if mesh_faults:
        arm_mesh_faults(runtime, binding)
    scrub_dir = tempfile.mkdtemp(prefix="serve_scrub_") if scrub else None
    try:
        summary = run_offered_load(
            runtime, binding, cfg, load, closed_loop_users,
            make_updater(binding, cfg, load, update_cfg, wal_path),
            scrub=(ScrubConfig(pages_per_cycle=scrub_pages_per_cycle)
                   if scrub else None),
            scrub_dir=scrub_dir,
            faults=(FaultConfig(seed=fault_seed, shard_loss_at=(2,))
                    if mesh_faults else None))
    finally:
        if scrub_dir is not None:
            shutil.rmtree(scrub_dir, ignore_errors=True)
    return summary, runtime, binding


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
    ap.add_argument("--arch", default="rmc1",
                    help="registry id: rmc1-4 or " + ", ".join(
                        a for a in list_archs()
                        if get_config(a).family == "recsys"))
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
    ap.add_argument("--mesh-faults", action="store_true",
                    help="degraded-mesh regime: serve on "
                         f"{MESH_FAULT_SHARDS} cold shards, inject a "
                         "persistent shard_loss fault (highest shard, live "
                         "attempt 2) and recover by an elastic re-mesh onto "
                         "the survivors; prints the re-mesh record (MTTR, "
                         "from/to mesh) and the degradation report")
    ap.add_argument("--prefer-tp", type=int, default=2,
                    help="tp preference of scale_plan when the re-mesh lays "
                         "out the survivor mesh")
    ap.add_argument("--scrub", action="store_true",
                    help="arm the integrity scrubber: per-page checksum "
                         "ledger and a snapshot, then audit a rotating page "
                         "window between micro-batches and repair any "
                         "diverged page from the snapshot and the WAL tail "
                         "(prints the scrub report)")
    ap.add_argument("--scrub-pages-per-cycle", type=int, default=8,
                    help="pages audited per maintenance turn (--scrub); a "
                         "full store sweep every ceil(num_pages / K) "
                         "micro-batches")
    ap.add_argument("--observe-every", type=int, default=4,
                    help="batches between histogram updates (0 = off)")
    ap.add_argument("--replan-every", type=int, default=64,
                    help="batches between re-plans (0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.family == "lm":
        ap.error(f"--arch {args.arch}: an LM is served through "
                 "repro_torch.models.transformer (prefill_step, "
                 "decode_step), not the request runtime")
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
    # (hot_fraction=0.05); the engine serves beacon as pifs.  The reference
    # CLI's model axis is min(4, devices); one card serves 1 shard, and 4
    # under --mesh-faults (a one-shard mesh has no survivor to re-mesh to)
    out, runtime, binding = _serve(
        cfg, load, device=args.device, mode=args.mode, impl="cuda",
        batcher=args.batcher, batch_sizes=tuple(args.batch_sizes),
        hot_fraction=0.05,
        runtime_cfg=RuntimeConfig(observe_every=args.observe_every,
                                  replan_every=args.replan_every),
        closed_loop_users=args.closed_loop_users,
        validate_ids=args.validate_ids,
        n_shards=MESH_FAULT_SHARDS if args.mesh_faults else 1,
        update_cfg=None, wal_path=args.wal, mesh_faults=args.mesh_faults,
        prefer_tp=args.prefer_tp, fault_seed=13, scrub=args.scrub,
        scrub_pages_per_cycle=args.scrub_pages_per_cycle)
    scores = runtime.executor.scores
    out["scores"] = np.asarray([scores[i] for i in range(args.requests)
                                if i in scores], np.float32)
    out["scores_finite"] = bool(np.isfinite(out["scores"]).all())
    out["dedup"] = binding.plan_stats().get("dedup", {})
    dev = binding.engine.device
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    hidden = ("scores", "latency_hist", "front_end", "dedup_factors",
              "staleness", "updates", "scrub_run", "remesh", "watchdog",
              "degradation")
    for k, v in out.items():
        if k not in hidden:
            print(f"  {k:24s} {v}")
    remesh = out.get("remesh")
    if remesh is not None:
        print("  -- elastic re-mesh --")
        for k, v in remesh.items():
            print(f"  {k:24s} {v}")
    watchdog = out.get("watchdog")
    if watchdog is not None:
        print(f"  watchdog_trips           {watchdog['trips']} "
              f"(ewma={watchdog['ewma_s']:.4f}s)")
    degradation = out.get("degradation")
    if degradation is not None:
        print(f"  degradation              rung={degradation['rung']} "
              f"remeshes={degradation['remeshes']} "
              f"suspect_shard={degradation['suspect_shard']} "
              f"straggler_trips={degradation['straggler_trips']}")
    if "updates" in out:
        print("  -- streaming updates --")
        for k, v in out["updates"].items():
            print(f"  {k:24s} {v}")
    scrub_run = out.get("scrub_run")
    if scrub_run is not None:
        print("  -- scrub --")
        print(f"  audited                  "
              f"{scrub_run['pages_audited']} pages over "
              f"{scrub_run['cycles']} cycles "
              f"(window={scrub_run['pages_per_cycle']}, full sweep every "
              f"{scrub_run['sweep_cycles']} cycles, "
              f"{scrub_run['sweeps_completed']} sweeps, "
              f"coverage={scrub_run['coverage']:.2f})")
        print(f"  detected/repaired        "
              f"{scrub_run['pages_detected']}/"
              f"{scrub_run['pages_repaired']} "
              f"(quarantined={scrub_run['quarantined']})")
        if "repair_mttr_mean_s" in scrub_run:
            print(f"  repair_mttr              "
                  f"mean={scrub_run['repair_mttr_mean_s']:.4f}s "
                  f"max={scrub_run['repair_mttr_max_s']:.4f}s")
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
