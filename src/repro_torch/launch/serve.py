"""Serving driver for the DLRM serve path on one device.

``python -m repro_torch.launch.serve --arch rmc1 --full --storage int8
--front-end fused --requests 512 --batch 32``

The port of ``repro.launch.serve`` with ``--batcher fixed``: a seeded
zipfian request stream (the reference's ``serving/loadgen.request_stream``
ids, bit for bit), a fixed-size batcher with exact padding, and the serve
step (bottom MLP -> lookup -> interaction -> top MLP -> sigmoid) on the
card.  Runs on CUDA unless ``--device cpu``.  ``--mode pifs|pond|beacon``
is the engine's mode (the reference CLI's: every mode, beacon too, gets
the same hot tier, and the engine serves beacon as pifs); the engine's
cold-tier shard
count is :func:`bind_model`'s ``n_shards`` (the reference CLI has no
flag for it either).

The hot tier starts placed by ``observe`` over a profile of the stream's
first requests and ``plan_and_migrate``; serving then runs the reference
runtime's maintenance cadence (``--observe-every 4``, ``--replan-every
64`` batches), off the batches' service time.  ``--dedup off|auto|on`` is
the engine's gather-once knob ('auto' is primed from the stream's prefix,
:func:`prime_dedup_auto`).  Flags of the reference driver that are not
ported yet (dynamic batcher, streaming updates, scrub, faults, elastic
re-mesh) raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import DLRMConfig, get_config, reduced
from repro_torch.core.pifs import EngineState, PIFSEmbeddingEngine
from repro_torch.data.traces import TraceConfig, TraceGenerator
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models.params import initialize
from repro_torch.serving.batcher import (Bucket, FixedBatcher, Flush,
                                         pad_pooled_indices, stack_feature)
from repro_torch.serving.request import Request

_DENSE_TAG = 0xD0          # the reference loadgen's dense-feature stream tag


def padded_rows(cfg: DLRMConfig, storage: str = "fp32",
                page_bytes: int = 4096) -> int:
    """Per-table padded rows: the engine's page rounding (an int8 page of
    the same bytes holds 4x the rows)."""
    ps = max(1, page_bytes // (cfg.emb_dim * (1 if storage == "int8"
                                              else 4)))
    return -(-cfg.emb_num // ps) * ps


def request_stream(cfg: DLRMConfig, n_requests: int, seed: int = 0,
                   storage: str = "fp32", distribution: str = "zipfian",
                   drift_every: int = 256) -> List[Request]:
    """The reference's DLRM request stream (same seed, same ids and dense
    features); all requests arrive at t = 0 with no deadline."""
    gen = TraceGenerator(TraceConfig(
        n_rows=cfg.emb_num, n_tables=cfg.n_tables, pooling=cfg.pooling,
        batch=1, distribution=distribution, seed=seed))
    offs = (np.arange(cfg.n_tables, dtype=np.int64)
            * padded_rows(cfg, storage))[:, None]
    reqs = []
    for i, ids in enumerate(gen.serve_requests(n_requests,
                                               drift_every=drift_every)):
        rng = np.random.default_rng([seed, _DENSE_TAG, i])
        feats = {"dense": rng.normal(size=(cfg.n_dense,)).astype(np.float32),
                 "indices": (ids + offs).astype(np.int32)}
        reqs.append(Request(rid=i, arrival_s=0.0, deadline_s=np.inf,
                            features=feats, pooling=ids.shape[1]))
    return reqs


@dataclasses.dataclass
class Binding:
    """A DLRM bound to its engine and state on one device, with the
    maintenance seam of the reference's ``ServeBinding``: :meth:`observe`
    (with the dedup probe), :meth:`dedup_report` and :meth:`replan`.  Each
    waits for the card before it returns, so maintenance is never charged
    to the next batch's service time."""
    cfg: DLRMConfig
    model: dlrm_mod.DLRM
    engine: PIFSEmbeddingEngine
    state: EngineState
    dedup_stats: Dict[tuple, dict] = dataclasses.field(default_factory=dict)

    def step(self, front_end: str = "split", mode: str = "pifs",
             impl: str = "cuda", dedup: Optional[str] = None):
        return dlrm_mod.make_serve_step(self.model, self.engine, mode=mode,
                                        impl=impl, front_end=front_end,
                                        dedup=dedup)

    def _sync(self) -> None:
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)

    def observe(self, batch: Dict[str, torch.Tensor]) -> None:
        """Add a served batch to the page histogram (pad entries, weight 0,
        do not count) and its measured duplicate factor to the per-bucket
        record."""
        idx, w = batch["indices"], batch.get("weights")
        self.state = self.engine.observe(self.state, idx, weights=w)
        self._sync()
        d = self.engine.dedup_factor(self.state, idx, weights=w)
        rec = self.dedup_stats.setdefault(
            tuple(idx.shape), {"batches": 0, "entries": 0, "unique_rows": 0})
        rec["batches"] += 1
        rec["entries"] += d["entries"]
        rec["unique_rows"] += d["unique_rows"]

    def dedup_report(self) -> dict:
        """Measured per-bucket duplicate factors from the observe cadence:
        ``{bucket_shape: {batches, entries, unique_rows, factor}}``."""
        return {"x".join(map(str, shape)): {
            **rec, "factor": rec["entries"] / max(rec["unique_rows"], 1)}
            for shape, rec in self.dedup_stats.items()}

    def replan(self) -> dict:
        """Plan from the histogram and migrate; returns the planner's
        stats."""
        self.state, stats = self.engine.plan_and_migrate(self.state)
        self._sync()
        return stats


def bind_model(cfg: DLRMConfig, device: DeviceLike = None,
               storage: str = "fp32", seed: int = 0,
               hot_fraction: float = 0.05,
               profile: Sequence[Request] = (),
               dedup: str = "off", n_shards: int = 1) -> Binding:
    """Engine + random weights + state on ``device`` (the card unless
    ``"cpu"``).  Tables and weights are drawn from generators seeded with
    ``seed``, on the device itself.  ``profile`` places the hot tier:
    ``observe`` over its requests, then ``plan_and_migrate``; with no
    profile the hot tier is empty.  ``dedup`` is the engine default;
    ``n_shards`` the cold tier's shards (the reference's tp), all on
    ``device``."""
    dev = resolve_device(device)
    engine, _ = dlrm_mod.build_engine(cfg, dev, hot_fraction=hot_fraction,
                                      storage=storage, dedup=dedup,
                                      n_shards=n_shards)
    gen = torch.Generator(device=dev)
    model = initialize(dlrm_mod.DLRM(cfg, dev), gen.manual_seed(seed))
    state = engine.init_state(gen.manual_seed(seed + 1))
    if profile:
        idx = np.stack([r.features["indices"] for r in profile])
        state = engine.observe(state, torch.as_tensor(idx, device=dev))
        state, _ = engine.plan_and_migrate(state)
    return Binding(cfg, model, engine, state)


def prime_dedup_auto(binding: Binding, requests: Sequence[Request],
                     n: int = 64) -> int:
    """Prime ``dedup='auto'`` from the stream's prefix: observe the first
    ``n`` requests one by one (maintenance path), set the engine's
    measured-factor hint from their stacked replay, and drop the dedup
    resolution records so every signature resolves again against the
    primed histogram (the port compiles nothing, so there are no plans to
    drop).  Returns the number of requests observed."""
    engine = binding.engine
    seen = 0
    by_pooling: dict = {}
    for r in requests[:n]:
        feats = np.asarray(r.features["indices"])
        binding.observe({"indices": torch.as_tensor(
            feats[None], device=engine.device)})
        by_pooling.setdefault(feats.shape[-1], []).append(feats)
        seen += 1
    if seen:
        entries = uniques = 0
        for feats_list in by_pooling.values():
            d = engine.dedup_factor(binding.state, np.stack(feats_list))
            entries += d["entries"]
            uniques += d["unique_rows"]
        engine.dedup_auto_hint = entries / max(uniques, 1)
        engine.reset_plan_stats(clear_plans=True)
        binding.dedup_stats.clear()
    return seen


def pad_batch(reqs: Sequence[Request], bucket: Bucket,
              device: torch.device) -> Dict[str, torch.Tensor]:
    idx, w = pad_pooled_indices(reqs, bucket)
    dense = stack_feature(reqs, bucket, "dense")
    return {"dense": torch.as_tensor(dense).to(device),
            "indices": torch.as_tensor(idx).to(device),
            "weights": torch.as_tensor(w).to(device)}


def serve(binding: Binding, step, requests: Sequence[Request],
          batch: int, observe_every: int = 4, replan_every: int = 64
          ) -> dict:
    """Drive ``requests`` through a fixed batcher and ``step``, with the
    reference runtime's maintenance cadence: ``binding.observe`` after
    every ``observe_every``-th batch and ``binding.replan`` after every
    ``replan_every``-th (0 = never).  Returns the scores in request order,
    the per-batch service times (host clock around padding, the step and
    the copy back, which waits for the device) and the maintenance times
    apart."""
    batcher = FixedBatcher(batch, binding.cfg.pooling)
    dev = binding.engine.device
    scores = np.empty(len(requests), np.float32)
    service_ms: List[float] = []
    maint_ms: Dict[str, List[float]] = {"observe": [], "replan": []}
    queue: List[Request] = []
    done = 0                  # the batcher flushes in arrival order
    for i, r in enumerate(requests):
        queue.append(r)
        nxt = requests[i + 1].arrival_s if i + 1 < len(requests) else None
        decision = batcher.decide(r.arrival_s, queue, nxt)
        while isinstance(decision, Flush):
            reqs, queue = queue[:decision.count], queue[decision.count:]
            t0 = time.perf_counter()
            padded = pad_batch(reqs, decision.bucket, dev)
            out = step(binding.state, padded)
            got = out[:decision.count].cpu().numpy()
            service_ms.append((time.perf_counter() - t0) * 1e3)
            scores[done:done + decision.count] = got
            done += decision.count
            n = len(service_ms)
            if observe_every and n % observe_every == 0:
                t0 = time.perf_counter()
                binding.observe(padded)
                maint_ms["observe"].append((time.perf_counter() - t0) * 1e3)
            if replan_every and n % replan_every == 0:
                t0 = time.perf_counter()
                binding.replan()
                maint_ms["replan"].append((time.perf_counter() - t0) * 1e3)
            decision = batcher.decide(r.arrival_s, queue, nxt)
    ms = np.asarray(service_ms)
    return {"scores": scores, "service_ms": ms, "batches": len(ms),
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "qps": len(requests) / (ms.sum() * 1e-3),
            "observes": len(maint_ms["observe"]),
            "replans": len(maint_ms["replan"]),
            "maintenance_ms": {k: float(sum(v)) for k, v in
                               maint_ms.items()}}


_NOT_PORTED = {
    "batcher": ("fixed", "--batcher dynamic is not ported yet (ROADMAP.md "
                         "queue 1 item 8)"),
    "update_qps": (0.0, "streaming updates are not ported yet (ROADMAP.md "
                        "queue 1 item 11)"),
    "scrub": (False, "--scrub is not ported yet (ROADMAP.md queue 1 item "
                     "12)"),
    "mesh_faults": (False, "--mesh-faults is not ported yet (ROADMAP.md "
                           "queue 1 item 13)"),
}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rmc1")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the reduced "
                         "config of CPU smoke tests)")
    ap.add_argument("--storage", default="fp32", choices=["fp32", "int8"])
    ap.add_argument("--front-end", default="split",
                    choices=["split", "fused"])
    ap.add_argument("--mode", default="pifs",
                    choices=["pifs", "pond", "beacon"])
    ap.add_argument("--requests", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--batcher", default="fixed",
                    choices=["fixed", "dynamic"])
    ap.add_argument("--dedup", default="off", choices=["off", "auto", "on"],
                    help="gather-once coalescing of duplicate rows")
    ap.add_argument("--observe-every", type=int, default=4,
                    help="batches between histogram updates (0 = off)")
    ap.add_argument("--replan-every", type=int, default=64,
                    help="batches between re-plans (0 = off)")
    ap.add_argument("--update-qps", type=float, default=0.0)
    ap.add_argument("--scrub", action="store_true")
    ap.add_argument("--mesh-faults", action="store_true")
    args = ap.parse_args(argv)
    for flag, (default, msg) in _NOT_PORTED.items():
        if getattr(args, flag) != default:
            raise NotImplementedError(msg)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    reqs = request_stream(cfg, args.requests, seed=args.seed,
                          storage=args.storage)
    # every mode, beacon too, gets the hot tier the reference CLI gives it
    # (hot_fraction=0.05, serve_offered_load's default); its datapath
    # serves beacon as pifs
    binding = bind_model(cfg, args.device, storage=args.storage,
                         seed=args.seed, hot_fraction=0.05,
                         profile=reqs[: max(1, len(reqs) // 4)],
                         dedup=args.dedup)
    if args.dedup == "auto":
        prime_dedup_auto(binding, reqs)
    out = serve(binding, binding.step(args.front_end, args.mode), reqs,
                args.batch, observe_every=args.observe_every,
                replan_every=args.replan_every)
    out["device"] = (torch.cuda.get_device_name(binding.engine.device)
                     if binding.engine.device.type == "cuda" else "cpu")
    out["scores_finite"] = bool(np.isfinite(out["scores"]).all())
    stats = binding.engine.plan_stats()
    out["front_end"] = stats["front_end"]
    out["dedup"] = stats.get("dedup", {})
    out["dedup_factors"] = binding.dedup_report()
    for k, v in out.items():
        if k not in ("scores", "service_ms"):
            print(f"  {k:24s} {v}")
    return out


if __name__ == "__main__":
    main()
