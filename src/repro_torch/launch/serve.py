"""Serving driver for the DLRM serve path on one device.

``python -m repro_torch.launch.serve --arch rmc1 --full --storage int8
--front-end fused --requests 512 --batch 32``

The port of ``repro.launch.serve`` with ``--batcher fixed``: a seeded
zipfian request stream (the reference's ``serving/loadgen.request_stream``
ids, bit for bit), a fixed-size batcher with exact padding, and the serve
step (bottom MLP -> lookup -> interaction -> top MLP -> sigmoid) on the
card.  Runs on CUDA unless ``--device cpu``.

The planner is not ported yet, so the hot tier is placed from a profile of
the stream's first requests (see :func:`profile_page_table`) instead of by
``observe`` + ``plan_and_migrate``.  Flags of the reference driver that
are not ported yet (dynamic batcher, dedup, streaming updates, scrub,
faults, elastic re-mesh) raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import DLRMConfig, get_config, reduced
from repro_torch.core.paging import HOT_SHARD, PageTable
from repro_torch.core.pifs import EngineState, PIFSEmbeddingEngine
from repro_torch.data.traces import TraceConfig, TraceGenerator
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models.params import initialize
from repro_torch.serving.batcher import (Bucket, FixedBatcher, Flush,
                                         pad_pooled_indices, stack_feature)
from repro_torch.serving.request import Request

_DENSE_TAG = 0xD0          # the reference loadgen's dense-feature stream tag
_HOT_TAG = 0x407           # fills the hot tier past the profiled pages


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


def profile_page_table(engine: PIFSEmbeddingEngine,
                       profile: Sequence[Request], seed: int = 0
                       ) -> PageTable:
    """A placement with a full hot tier (``engine.cfg.hot_pages`` pages):
    the pages the profiled requests touch, most-accessed first, then
    untouched pages drawn from ``seed`` until the tier is full.  Cold pages
    keep their initial interleaved slots.  Stands in for ``observe`` +
    ``plan_and_migrate`` until the planner is ported (``ROADMAP.md`` queue
    1, item 6)."""
    c = engine.cfg
    counts = np.zeros(c.num_pages, np.int64)
    for r in profile:
        np.add.at(counts, np.asarray(r.features["indices"]).reshape(-1)
                  // c.page_size, 1)
    ranked = np.argsort(-counts, kind="stable")
    touched = ranked[counts[ranked] > 0][: c.hot_pages]
    rest = np.setdiff1d(np.arange(c.num_pages), touched)
    fill = np.random.default_rng([seed, _HOT_TAG]).permutation(rest)
    hot = np.concatenate([touched, fill[: c.hot_pages - touched.size]])
    shard = np.zeros(c.num_pages, np.int32)
    slot = np.arange(c.num_pages, dtype=np.int32)   # interleave, n_shards=1
    shard[hot] = HOT_SHARD
    slot[hot] = np.arange(hot.size, dtype=np.int32)
    return PageTable(torch.as_tensor(shard, device=engine.device),
                     torch.as_tensor(slot, device=engine.device))


@dataclasses.dataclass
class Binding:
    """A DLRM bound to its engine and state on one device."""
    cfg: DLRMConfig
    model: dlrm_mod.DLRM
    engine: PIFSEmbeddingEngine
    state: EngineState

    def step(self, front_end: str = "split", mode: str = "pifs",
             impl: str = "cuda"):
        return dlrm_mod.make_serve_step(self.model, self.engine, mode=mode,
                                        impl=impl, front_end=front_end)


def bind_model(cfg: DLRMConfig, device: DeviceLike = None,
               storage: str = "fp32", seed: int = 0,
               hot_fraction: float = 0.05,
               profile: Sequence[Request] = ()) -> Binding:
    """Engine + random weights + state on ``device`` (the card unless
    ``"cpu"``).  Tables and weights are drawn from generators seeded with
    ``seed``, on the device itself.  ``profile`` places the hot tier
    (:func:`profile_page_table`); with no profile the hot tier is empty."""
    dev = resolve_device(device)
    engine, _ = dlrm_mod.build_engine(cfg, dev, hot_fraction=hot_fraction,
                                      storage=storage)
    gen = torch.Generator(device=dev)
    model = initialize(dlrm_mod.DLRM(cfg, dev), gen.manual_seed(seed))
    table = profile_page_table(engine, profile, seed) if profile else None
    state = engine.init_state(gen.manual_seed(seed + 1), table=table)
    return Binding(cfg, model, engine, state)


def pad_batch(reqs: Sequence[Request], bucket: Bucket,
              device: torch.device) -> Dict[str, torch.Tensor]:
    idx, w = pad_pooled_indices(reqs, bucket)
    dense = stack_feature(reqs, bucket, "dense")
    return {"dense": torch.as_tensor(dense).to(device),
            "indices": torch.as_tensor(idx).to(device),
            "weights": torch.as_tensor(w).to(device)}


def serve(binding: Binding, step, requests: Sequence[Request],
          batch: int) -> dict:
    """Drive ``requests`` through a fixed batcher and ``step``.  Returns
    the scores in request order and the per-batch service times (host
    clock around padding, the step and the copy back, which waits for the
    device)."""
    batcher = FixedBatcher(batch, binding.cfg.pooling)
    dev = binding.engine.device
    scores = np.empty(len(requests), np.float32)
    service_ms: List[float] = []
    queue: List[Request] = []
    done = 0                  # the batcher flushes in arrival order
    for i, r in enumerate(requests):
        queue.append(r)
        nxt = requests[i + 1].arrival_s if i + 1 < len(requests) else None
        decision = batcher.decide(r.arrival_s, queue, nxt)
        while isinstance(decision, Flush):
            reqs, queue = queue[:decision.count], queue[decision.count:]
            t0 = time.perf_counter()
            out = step(binding.state, pad_batch(reqs, decision.bucket, dev))
            got = out[:decision.count].cpu().numpy()
            service_ms.append((time.perf_counter() - t0) * 1e3)
            scores[done:done + decision.count] = got
            done += decision.count
            decision = batcher.decide(r.arrival_s, queue, nxt)
    ms = np.asarray(service_ms)
    return {"scores": scores, "service_ms": ms, "batches": len(ms),
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "qps": len(requests) / (ms.sum() * 1e-3)}


_NOT_PORTED = {
    "batcher": ("fixed", "--batcher dynamic is not ported yet (ROADMAP.md "
                         "queue 1 item 8)"),
    "dedup": ("off", "--dedup is not ported yet (ROADMAP.md queue 1 item 7)"),
    "update_qps": (0.0, "streaming updates are not ported yet (ROADMAP.md "
                        "queue 1 item 11)"),
    "scrub": (False, "--scrub is not ported yet (ROADMAP.md queue 1 item "
                     "12)"),
    "mesh_faults": (False, "--mesh-faults is not ported yet (ROADMAP.md "
                           "queue 1 items 10 and 13)"),
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
    ap.add_argument("--mode", default="pifs", choices=["pifs", "beacon"])
    ap.add_argument("--requests", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--batcher", default="fixed",
                    choices=["fixed", "dynamic"])
    ap.add_argument("--dedup", default="off", choices=["off", "auto", "on"])
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
    # beacon: tiering disabled, no page promoted
    hot = args.mode != "beacon"
    binding = bind_model(cfg, args.device, storage=args.storage,
                         seed=args.seed,
                         hot_fraction=0.05 if hot else 0.0,
                         profile=reqs[: max(1, len(reqs) // 4)] if hot else ())
    out = serve(binding, binding.step(args.front_end, args.mode), reqs,
                args.batch)
    scores = out.pop("scores")
    out.pop("service_ms")
    out["device"] = (torch.cuda.get_device_name(binding.engine.device)
                     if binding.engine.device.type == "cuda" else "cpu")
    out["scores_finite"] = bool(np.isfinite(scores).all())
    out["front_end"] = binding.engine.plan_stats()["front_end"]
    for k, v in out.items():
        print(f"  {k:24s} {v}")
    return out


if __name__ == "__main__":
    main()
