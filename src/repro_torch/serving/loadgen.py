"""Load generation and model-binding glue for the serving runtime.

The port of ``repro.serving.loadgen``, the only serving module that knows
model families: it builds the ``ServeBinding`` (engine + model + serve
steps) for a DLRM or recsys config on one device, provides the request ->
bucket padder, fabricates warmup dummies, and turns the trace
distributions (``repro_torch.data.traces``, ``repro_torch.data.synth``)
into per-request open-loop or closed-loop streams with SLO deadlines
attached, and the trainer-side delta stream (:func:`update_stream`) --
the reference's streams, bit for bit.

Request features are host numpy, one example each:

  * DLRM:            ``dense (n_dense,)``, ``indices (T, L_r)`` (global
                     row ids, variable per-request pooling ``L_r``)
  * field recsys:    ``fields (F,)`` (+ ``dense`` when the config has it)
  * sequence recsys: ``seq (S,)``, ``target ()`` (+ ``dense`` for BST)
"""
from __future__ import annotations

import dataclasses
import functools
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import Config, DLRMConfig, RecConfig
from repro_torch.core.pifs import ServeBinding
from repro_torch.data.synth import _zipf_ids
from repro_torch.data.traces import TraceConfig, TraceGenerator
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import recsys as rec_mod
from repro_torch.models.params import initialize
from repro_torch.serving.batcher import (Bucket, pad_pooled_indices,
                                         stack_feature)
from repro_torch.serving.request import ArrivalConfig, Request, arrival_times
from repro_torch.serving.updates import UpdateBatch

_DENSE_TAG = 0xD0
_FIELD_TAG = 0xF1
_DELTA_TAG = 0xDE17A


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """One offered-load experiment: how many requests, arriving how, with
    what SLO budget and (DLRM) per-request pooling mix."""
    n_requests: int
    arrival: ArrivalConfig
    slo_ms: float = 50.0
    poolings: Tuple[int, ...] = ()       # DLRM pooling choices; () = fixed
    distribution: str = "zipfian"
    drift_every: int = 256               # serve-stream hot-set churn period
    seed: int = 0
    storage: str = "fp32"                # engine cold-tier storage; table
    #                                      offsets depend on its page size
    dedup: str = "off"                   # gather-once duplicate coalescing
    #                                      (off/auto/on; bit-exact either way)
    front_end: str = "split"             # DLRM lookup -> interaction:
    #                                      'fused' resolves the single-kernel
    #                                      front end, or 'fused_tp' (partial
    #                                      pool -> shard sum -> resume) at
    #                                      n_shards > 1 and in pond
    update_qps: float = 0.0              # streaming embedding updates: delta
    #                                      rows/second on the virtual clock
    #                                      (0 = no update stream)
    update_batch: int = 64               # rows per trainer-emitted delta batch


# ---------------------------------------------------------------------------
# Model binding
# ---------------------------------------------------------------------------


def padded_rows(cfg: DLRMConfig, storage: str = "fp32",
                page_bytes: int = 4096) -> int:
    """Per-table padded rows: the engine's page rounding (an int8 page of
    the same bytes holds 4x the rows)."""
    ps = max(1, page_bytes // (cfg.emb_dim * (1 if storage == "int8"
                                              else 4)))
    return -(-cfg.emb_num // ps) * ps


def _dlrm_steps(model, engine, *, mode, impl, dedup, front_end,
                degraded_variants):
    """The serve step and, with ``degraded_variants``, the brown-out
    ladder's variants: ``split_fe`` (split front end, bitwise equal),
    ``no_dedup`` (split, dedup off, bitwise equal), ``hot_only`` (hot
    tier only, cold rows zero: scores change) and ``shed`` (the same
    datapath as hot_only)."""
    def dlrm_step(**kw):
        return dlrm_mod.make_serve_step(model, engine, mode=mode, impl=impl,
                                        **kw)
    step = dlrm_step(dedup=dedup, front_end=front_end)
    steps = None
    if degraded_variants:
        hot_only = dlrm_step(dedup="off", front_end="split",
                             tiers="hot_only")
        steps = {"split_fe": dlrm_step(dedup=dedup, front_end="split"),
                 "no_dedup": dlrm_step(dedup="off", front_end="split"),
                 "hot_only": hot_only, "shed": hot_only}
    return step, steps


def _rec_steps(model, engine, offs, *, mode, impl, dedup,
               degraded_variants):
    """The recsys analogue of :func:`_dlrm_steps` (``offs`` are the
    tables' page-rounded offsets, a function of the storage and not of the
    shard count, so they carry verbatim across a re-mesh).  Rec configs
    have no DLRM front end or tiers knob: ``split_fe`` aliases the full
    step and ``hot_only`` / ``shed`` alias ``no_dedup``."""
    def rec_step(d):
        return rec_mod.make_serve_step(model, engine, offs, mode=mode,
                                       impl=impl, dedup=d)
    step = rec_step(dedup)
    steps = None
    if degraded_variants:
        no_dedup = rec_step("off")
        steps = {"split_fe": step, "no_dedup": no_dedup,
                 "hot_only": no_dedup, "shed": no_dedup}
    return step, steps


def bind_model(cfg: Config, device: DeviceLike = None,
               mode: str = "pifs", impl: str = "cuda",
               hot_fraction: float = 0.05, seed: int = 0,
               storage: str = "fp32", dedup: str = "off",
               front_end: str = "split", degraded_variants: bool = False,
               validate_ids: bool = False, scrub_scores: bool = False,
               n_shards: int = 1, profile: Sequence[Request] = (),
               update_capacity: int = 0, elastic: bool = False,
               prefer_tp: int = 4) -> ServeBinding:
    """Engine + random weights + state + serve steps for a DLRM or recsys
    config on ``device`` (the card unless ``"cpu"``), as the reference's
    ``bind_model`` builds them on a mesh.

    ``n_shards`` is the cold tier's shard count (the reference mesh's tp),
    all on ``device``.  ``mode`` (pifs / pond / beacon), ``impl`` ('cuda':
    the kernels on the card, the plain versions on CPU tensors; 'torch':
    the plain versions), ``dedup`` and ``front_end`` configure the serve
    step; ``degraded_variants`` adds the brown-out rungs
    (:func:`_dlrm_steps`, :func:`_rec_steps`); ``validate_ids`` /
    ``scrub_scores`` arm the
    binding's host-side guards; ``update_capacity`` (> 0) sets the
    binding's fixed streaming-update apply width (rows per device chunk:
    one signature); ``elastic`` arms the binding's re-mesh
    (``attach_remesher`` with a rebinder that rebuilds every serve-step
    variant, same knobs, for the re-meshed engine; ``prefer_tp`` the
    survivor-mesh policy's knob).  Tables and weights are drawn from
    generators seeded with ``seed``, on the device itself.  ``profile``
    (this port only) places the hot tier before serving: ``observe`` over
    its requests, then ``plan_and_migrate``; without it the hot tier
    starts empty and serving's warmup and maintenance place it.

    A recsys config binds with ``idx_key=None`` (its batches hold
    table-local ids): the profiler stays off, so every re-plan (the
    warmup's first) places the hot tier from the untouched histogram, as
    in the reference; ``profile`` is DLRM-only, and ``front_end`` is
    ignored."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    if isinstance(cfg, DLRMConfig):
        engine, _ = dlrm_mod.build_engine(cfg, dev, hot_fraction=hot_fraction,
                                          storage=storage, dedup=dedup,
                                          n_shards=n_shards)
        model = initialize(dlrm_mod.DLRM(cfg, dev), gen.manual_seed(seed))
        idx_key = "indices"

        def rebind(new_engine):
            return _dlrm_steps(model, new_engine, mode=mode, impl=impl,
                               dedup=dedup, front_end=front_end,
                               degraded_variants=degraded_variants)
    elif isinstance(cfg, RecConfig):
        if profile:
            raise TypeError("profile= places the hot tier from DLRM "
                            "requests' global row ids; a recsys config's "
                            "ids are table-local")
        engine, offs = rec_mod.build_engine(cfg, dev,
                                            hot_fraction=hot_fraction,
                                            storage=storage, dedup=dedup,
                                            n_shards=n_shards)
        model = initialize(rec_mod.RecModel(cfg, dev), gen.manual_seed(seed))
        idx_key = None     # field ids are table-local; profiler stays off

        def rebind(new_engine):
            return _rec_steps(model, new_engine, offs, mode=mode, impl=impl,
                              dedup=dedup,
                              degraded_variants=degraded_variants)
    else:
        raise TypeError(f"unsupported serving config {type(cfg)}")
    state = engine.init_state(gen.manual_seed(seed + 1))
    if profile:
        idx = np.stack([r.features["indices"] for r in profile])
        state = engine.observe(state, torch.as_tensor(idx, device=dev))
        state, _ = engine.plan_and_migrate(state)
    step, steps = rebind(engine)
    binding = ServeBinding(engine, state, model, step, steps=steps,
                           validate_ids=validate_ids,
                           scrub_scores=scrub_scores, impl=impl,
                           idx_key=idx_key)
    if update_capacity > 0:
        binding.update_capacity = int(update_capacity)
    if elastic:
        binding.attach_remesher(rebind, prefer_tp=prefer_tp)
    return binding


def make_padder(cfg: Config
                ) -> Callable[[Sequence[Request], Bucket], dict]:
    """Request list -> bucket-shaped host batch for the config's family."""
    if isinstance(cfg, DLRMConfig):
        def pad_dlrm(reqs, bucket):
            idx, w = pad_pooled_indices(reqs, bucket)
            return {"dense": stack_feature(reqs, bucket, "dense"),
                    "indices": idx, "weights": w}
        return pad_dlrm
    if not isinstance(cfg, RecConfig):
        raise TypeError(f"unsupported serving config {type(cfg)}")
    if cfg.interaction in ("self-attn-seq", "transformer-seq"):
        def pad_seq(reqs, bucket):
            out = {"seq": stack_feature(reqs, bucket, "seq"),
                   "target": stack_feature(reqs, bucket, "target")}
            if cfg.n_dense:
                out["dense"] = stack_feature(reqs, bucket, "dense")
            return out
        return pad_seq

    def pad_fields(reqs, bucket):
        out = {"fields": stack_feature(reqs, bucket, "fields")}
        if cfg.n_dense:
            out["dense"] = stack_feature(reqs, bucket, "dense")
        return out
    return pad_fields


# ---------------------------------------------------------------------------
# Request fabrication
# ---------------------------------------------------------------------------


def _dlrm_features(cfg: DLRMConfig, ids: np.ndarray, rid: int,
                   seed: int, storage: str = "fp32") -> dict:
    # global-row offsets follow the engine's page rounding, which depends
    # on the cold-tier storage format (int8 pages hold 4x the rows)
    offs = (np.arange(cfg.n_tables, dtype=np.int64)
            * padded_rows(cfg, storage=storage))[:, None]
    rng = np.random.default_rng([seed, _DENSE_TAG, rid])
    return {"dense": rng.normal(size=(cfg.n_dense,)).astype(np.float32),
            "indices": (ids + offs).astype(np.int32)}


def _rec_features(cfg: RecConfig, rid: int, seed: int) -> dict:
    rng = np.random.default_rng([seed, _FIELD_TAG, rid])
    out: dict = {}
    if cfg.interaction in ("self-attn-seq", "transformer-seq"):
        V = cfg.vocab_sizes[0]
        out["seq"] = _zipf_ids(rng, V, (cfg.seq_len,)).astype(np.int32)
        out["target"] = _zipf_ids(rng, V, ()).astype(np.int32)
    else:
        out["fields"] = np.stack(
            [_zipf_ids(rng, v, ()) for v in cfg.vocab_sizes]
        ).astype(np.int32)
    if cfg.n_dense:
        out["dense"] = rng.normal(size=(cfg.n_dense,)).astype(np.float32)
    return out


def _serve_ids(cfg: DLRMConfig, load: LoadConfig, n):
    gen = TraceGenerator(TraceConfig(
        n_rows=cfg.emb_num, n_tables=cfg.n_tables, pooling=cfg.pooling,
        batch=1, distribution=load.distribution, seed=load.seed))
    return gen.serve_requests(n, poolings=load.poolings or None,
                              drift_every=load.drift_every)


def request_stream(cfg: Config, load: LoadConfig, workers: int = 1
                   ) -> List[Request]:
    """Materialise an open-loop request list (arrival times + features).

    ``workers`` > 1 draws a recsys stream's features in that many spawned
    processes (each request has its own generator, so the bits do not
    change): a full-width Criteo request permutes five vocabularies of
    2-10 M ids, about a second of host time each request."""
    times = arrival_times(load.arrival, load.n_requests)
    slo_s = load.slo_ms * 1e-3
    if isinstance(cfg, RecConfig):
        draw = functools.partial(_rec_features, cfg, seed=load.seed)
        rids = range(load.n_requests)
        if workers > 1:
            with ProcessPoolExecutor(
                    workers,
                    mp_context=multiprocessing.get_context("spawn")) as ex:
                feats = list(ex.map(draw, rids, chunksize=4))
        else:
            feats = [draw(i) for i in rids]
        return [Request(rid=i, arrival_s=float(times[i]),
                        deadline_s=float(times[i]) + slo_s,
                        features=f, pooling=1)
                for i, f in enumerate(feats)]
    return [Request(rid=i, arrival_s=float(times[i]),
                    deadline_s=float(times[i]) + slo_s,
                    features=_dlrm_features(cfg, ids, i, load.seed,
                                            storage=load.storage),
                    pooling=ids.shape[1])
            for i, ids in enumerate(_serve_ids(cfg, load, load.n_requests))]


def closed_loop_factory(cfg: Config, load: LoadConfig
                        ) -> Callable[[int, int, float], Request]:
    """Request factory for ``ClosedLoopSource`` (the open-loop stream's
    features, arrival set by the completion that frees the virtual
    user)."""
    slo_s = load.slo_ms * 1e-3
    if isinstance(cfg, RecConfig):
        def make_rec(rid: int, user: int, arrival_s: float) -> Request:
            return Request(rid=rid, arrival_s=arrival_s,
                           deadline_s=arrival_s + slo_s,
                           features=_rec_features(cfg, rid, load.seed),
                           pooling=1, user=user)
        return make_rec
    it = _serve_ids(cfg, load, None)

    def make_dlrm(rid: int, user: int, arrival_s: float) -> Request:
        ids = next(it)
        return Request(rid=rid, arrival_s=arrival_s,
                       deadline_s=arrival_s + slo_s,
                       features=_dlrm_features(cfg, ids, rid, load.seed,
                                               storage=load.storage),
                       pooling=ids.shape[1], user=user)
    return make_dlrm


def update_stream(cfg: Config, load: LoadConfig, scale: float = 1e-3
                  ) -> List[UpdateBatch]:
    """The trainer-side delta stream for an offered load.

    Batches of ``load.update_batch`` rows arrive at ``load.update_qps``
    delta rows/second on the request stream's virtual clock, covering its
    horizon (the last arrival).  Rows follow the load's trace distribution
    from an independent ``TraceGenerator`` (seed + 1) with its own drift,
    so updates skew hot as trainer output does; deltas are gaussians of
    ``scale``, keyed per batch.  Empty when ``update_qps`` is 0.  Only
    DLRM configs carry the engine-global row ids ``apply_deltas``
    addresses: a recsys config raises ``TypeError``."""
    if load.update_qps <= 0:
        return []
    if not isinstance(cfg, DLRMConfig):
        raise TypeError(
            "update streams address engine-global row ids; only DLRM "
            f"configs are supported (got {type(cfg).__name__})")
    times = arrival_times(load.arrival, load.n_requests)
    horizon = float(times[-1]) if len(times) else 0.0
    interval = load.update_batch / load.update_qps
    n_batches = max(1, int(horizon / interval) + 1)
    per_table = -(-load.update_batch // cfg.n_tables)
    gen = TraceGenerator(TraceConfig(
        n_rows=cfg.emb_num, n_tables=cfg.n_tables, pooling=per_table,
        batch=1, distribution=load.distribution, seed=load.seed + 1))
    offs = (np.arange(cfg.n_tables, dtype=np.int64)
            * padded_rows(cfg, storage=load.storage))[:, None]
    out: List[UpdateBatch] = []
    for k in range(n_batches):
        ids = gen.next_batch()[0] + offs             # (T, per_table)
        rows = ids.reshape(-1)[: load.update_batch].astype(np.int64)
        rng = np.random.default_rng([load.seed, _DELTA_TAG, k])
        deltas = (rng.normal(size=(rows.size, cfg.emb_dim)) * scale
                  ).astype(np.float32)
        out.append(UpdateBatch(seq=k + 1, t_gen=(k + 1) * interval,
                               rows=rows, deltas=deltas))
    return out


def prime_dedup_auto(binding: ServeBinding, requests: Sequence[Request],
                     n: int = 64) -> int:
    """Prime the engine's access histogram for serving ``dedup='auto'``.

    'auto' resolves once per signature, at its first lookup -- for a
    serving runtime that is during bucket warmup, before live traffic has
    reached the histogram.  This observes the first ``n`` requests one by
    one (maintenance path), sets the engine's measured-factor hint from
    their stacked replay, and drops the resolution records and the seen
    signatures, so the caller's re-warmup resolves every bucket again
    against the primed histogram before steady state.  Returns the number
    of requests observed: 0 for a binding whose profiler is off (no
    ``idx_key``), which drops nothing."""
    if binding.idx_key is None:
        return 0
    engine = binding.engine
    seen = 0
    by_pooling: dict = {}
    for r in requests[:n]:
        feats = np.asarray(r.features[binding.idx_key])
        binding.observe({binding.idx_key: feats[None]})
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


def dummy_request_factory(cfg: Config, storage: str = "fp32"
                          ) -> Callable[[int, int], Request]:
    """Fabricate bucket-warmup dummies (valid ids, seeded features).  A
    recsys dummy's features are request 0's of seed 0, as the reference's;
    drawn once per factory and shared, since at the Criteo vocabularies one
    draw costs about a second of host time."""
    if isinstance(cfg, RecConfig):
        feats: dict = {}

        def make_rec(rid: int, pooling: int) -> Request:
            if not feats:
                feats.update(_rec_features(cfg, 0, 0))
            return Request(rid=-1 - rid, arrival_s=0.0, deadline_s=1e9,
                           features=feats, pooling=1)
        return make_rec

    def make_dlrm(rid: int, pooling: int) -> Request:
        ids = np.zeros((cfg.n_tables, pooling), dtype=np.int64)
        return Request(rid=-1 - rid, arrival_s=0.0, deadline_s=1e9,
                       features=_dlrm_features(cfg, ids, 0, 0,
                                               storage=storage),
                       pooling=pooling)
    return make_dlrm
