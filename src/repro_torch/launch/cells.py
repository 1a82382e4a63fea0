"""Dry-run cell builders: (arch x input shape) -> a step with its arguments
(the port of ``repro.launch.cells``).

Every builder returns a :class:`CellSpec` whose ``fn(*args)`` is the
port's own step -- the LM train step (adafactor, the config's remat and
``train_accum``), prefill and decode; the recsys and DLRM serve,
retrieval and train steps; the GNN train step -- over the parameters,
optimizer state, engine state, cache and batch of the cell at its full
published width.  With ``seed=None`` every argument is an empty tensor:
built inside a ``FakeTensorMode`` (``launch/dryrun.py``) they are fake and
nothing is allocated.  With a ``seed`` the arguments are real: weights
and tables drawn from it, batches of ids in range, so the same cell runs
for real (the tests and ``chip_smoke.py`` hold the dry-run to such runs).

One card is the mesh: no shardings (``CellSpec`` has no
``in_shardings``), the engine's cold tier in one shard as the CLIs bind
it, dp = tp = 1.  The reference's quirks are kept where they change a
count, each noted where it is.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import base as cfgs
from repro_torch.configs import get_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import params as prm
from repro_torch.models import recsys as rec_mod
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import adafactor, adam, rowwise_adagrad


@dataclasses.dataclass
class CellSpec:
    name: str
    fn: Callable
    args: Tuple[Any, ...]
    donate_argnums: Tuple[int, ...] = ()
    # model FLOPs per step for the roofline's model / counted FLOPs ratio
    model_flops: float = 0.0


# ---------------------------------------------------------------------------
# Model-FLOPs estimates (6·N·D dense / 6·N_active·D MoE; serving: 2·N·D)
# ---------------------------------------------------------------------------


def lm_param_counts(cfg: cfgs.LMConfig) -> Tuple[float, float]:
    """(total_params, active_params) excluding embeddings (6ND convention)."""
    d = cfg.d_model
    if cfg.attn_type == "mla":
        m = cfg.mla
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim
        attn = (d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qd
                + d * m.kv_lora_rank
                + m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + d * m.qk_rope_head_dim + cfg.n_heads * m.v_head_dim * d)
    else:
        h = cfg.head_dim
        attn = d * cfg.n_heads * h * 2 + d * cfg.n_kv_heads * h * 2
    glu = cfg.activation != "relu2"
    ffn_dense = d * cfg.d_ff * (3 if glu else 2)
    n_dense = cfg.n_layers if cfg.moe is None else cfg.moe.first_dense_layers
    n_moe = 0 if cfg.moe is None else cfg.n_layers - n_dense
    total = active = cfg.n_layers * attn + n_dense * ffn_dense
    if cfg.moe is not None:
        e = cfg.moe
        expert = d * e.d_ff_expert * 3
        total += n_moe * (e.n_experts + e.n_shared_experts) * expert
        active += n_moe * (e.top_k + e.n_shared_experts) * expert
    return float(total), float(active)


def lm_model_flops(cfg: cfgs.LMConfig, tokens: int, kind: str,
                   seq: int = 0) -> float:
    """6ND (train) / 2ND (serve) plus the attention score/value flops
    (2 x 2 x s_kv_avg x H x h per token per layer, causal halves prefill)."""
    total, active = lm_param_counts(cfg)
    per_tok = 6.0 * active if kind == "train" else 2.0 * active
    if seq:
        if cfg.attn_type == "mla":
            d_attn = cfg.n_heads * (cfg.mla.qk_nope_head_dim
                                    + cfg.mla.qk_rope_head_dim)
        else:
            d_attn = cfg.n_heads * cfg.head_dim
        kv_avg = seq / 2.0 if kind in ("train", "prefill") else seq
        attn = 4.0 * kv_avg * d_attn * cfg.n_layers
        per_tok += attn * (3.0 if kind == "train" else 1.0)
    return per_tok * tokens


def _rec_model_flops(cfg: cfgs.RecConfig, shape: cfgs.RecShape) -> float:
    d = cfg.embed_dim
    it = cfg.interaction
    if it == "self-attn-seq":
        S = cfg.seq_len
        per = cfg.n_blocks * (4 * S * d * d * 2 + 2 * S * S * d * 2)
    elif it == "transformer-seq":
        S = cfg.seq_len + 1
        per = cfg.n_blocks * (4 * S * d * d * 2 + 2 * S * S * d * 2
                              + 8 * S * d * d * 2)
        dims = (S * d + cfg.n_dense,) + cfg.mlp_dims + (1,)
        per += sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    elif it == "self-attn":
        F = cfg.n_sparse
        da = cfg.d_attn * cfg.n_heads
        per = cfg.n_attn_layers * (3 * F * d * da * 2 + 2 * F * F * da * 2
                                   + F * d * d * 2)
    else:
        x0 = cfg.n_dense + cfg.n_sparse * d
        per = cfg.n_cross_layers * 2 * x0 * x0
        dims = (x0,) + cfg.mlp_dims
        per += sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    if shape.kind == "retrieval" and it == "self-attn-seq":
        # two-tower retrieval: one query encode + a dot per candidate
        return float(per) + 2.0 * d * max(shape.n_candidates, 1)
    n = shape.n_candidates if shape.kind == "retrieval" else shape.batch
    mult = 3.0 if shape.kind == "train" else 1.0   # fwd+bwd
    return float(per) * max(n, 1) * mult


def gnn_model_flops(cfg: cfgs.GNNConfig, shape: cfgs.GNNShape) -> float:
    """2 (gather+matmul) x edges x d x d' per layer + node transforms, x3
    for forward and backward (the reference's estimate)."""
    dims = gnn_mod.layer_dims(cfg, shape.d_feat or 16)
    if shape.kind == "full":
        f = sum(2 * shape.n_edges * dims[i] +
                2 * shape.n_nodes * dims[i] * dims[i + 1] * 2
                for i in range(cfg.n_layers))
    elif shape.kind == "minibatch":
        B = shape.batch_nodes
        f1, f2 = shape.fanout
        n_agg = B * (1 + f1 + f1 * f2)
        f = 2 * n_agg * dims[0] * dims[1] * 2 + 2 * B * dims[1] * dims[2] * 2
    else:
        f = shape.graph_batch * sum(
            2 * shape.n_edges * dims[i]
            + 2 * shape.n_nodes * dims[i] * dims[i + 1] * 2
            for i in range(cfg.n_layers))
    return float(f) * 3.0


# ---------------------------------------------------------------------------
# Real arguments for a seeded cell
# ---------------------------------------------------------------------------


def _fill(batch: Dict[str, torch.Tensor], bounds: Dict[str, int],
          gen: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
    """A seeded cell's batch: float leaves standard normal, int leaves
    uniform in ``[0, bounds[key])``; an unseeded one stays empty."""
    if gen is None:
        return batch
    for k, t in batch.items():
        if t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=gen, device=gen.device))
        else:
            t.copy_(torch.randint(0, bounds[k], t.shape, generator=gen,
                                  device=gen.device))
    return batch


def _gen(seed: Optional[int], device) -> Optional[torch.Generator]:
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def build_lm_cell(cfg: cfgs.LMConfig, shape: cfgs.LMShape,
                  device: DeviceLike = None, seed: Optional[int] = None
                  ) -> CellSpec:
    dev = resolve_device(device)
    gen = _gen(seed, dev)
    specs = tfm.model_specs(cfg)
    params = (prm.abstract(specs, dev) if gen is None
              else prm.initialize_specs(specs, gen))
    B, S = shape.global_batch, shape.seq_len
    name = f"{cfg.name}:{shape.name}"
    i32 = dict(dtype=torch.int32, device=dev)

    if shape.kind == "train":
        opt = adafactor(lr=1e-2)
        batch = _fill({"tokens": torch.empty((B, S), **i32),
                       "labels": torch.empty((B, S), **i32)},
                      {"tokens": cfg.vocab, "labels": cfg.vocab}, gen)
        step = tfm.make_train_step(cfg, opt, remat=cfg.remat,
                                   accum=cfg.train_accum)
        return CellSpec(
            name=name, fn=step, args=(params, opt.init(params), batch),
            donate_argnums=(0, 1),
            model_flops=lm_model_flops(cfg, B * S, "train", seq=S))

    if shape.kind == "prefill":
        def prefill(params, tokens):
            return tfm.prefill_step(params, tokens, cfg)
        tokens = _fill({"tokens": torch.empty((B, S), **i32)},
                       {"tokens": cfg.vocab}, gen)["tokens"]
        return CellSpec(
            name=name, fn=prefill, args=(params, tokens),
            model_flops=lm_model_flops(cfg, B * S, "prefill", seq=S))

    # decode: one new token against a KV cache of S positions, written at
    # the last one (the reference's pos is a traced scalar; the port's a
    # host int, and the scores cover the whole cache either way)
    cache = {k: torch.empty(shp, dtype=dt, device=dev)
             for k, (shp, dt) in tfm.cache_specs(cfg, B, S).items()}
    if gen is not None:
        for t in cache.values():
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))

    def decode(params, cache, tokens, pos):
        return tfm.decode_step(params, cache, tokens, pos, cfg)
    tokens = _fill({"tokens": torch.empty((B, 1), **i32)},
                   {"tokens": cfg.vocab}, gen)["tokens"]
    return CellSpec(
        name=name, fn=decode, args=(params, cache, tokens, S - 1),
        donate_argnums=(1,),
        model_flops=lm_model_flops(cfg, B, "serve", seq=S))


def lm_depth_variant(cfg: cfgs.LMConfig, n_dense: int, n_moe: int
                     ) -> cfgs.LMConfig:
    """``cfg`` cut to ``n_dense`` dense and ``n_moe`` MoE layers (the
    per-layer multiplier's traces, ``launch/dryrun.py``)."""
    if cfg.moe is None:
        return dataclasses.replace(cfg, n_layers=n_dense)
    return dataclasses.replace(
        cfg, n_layers=n_dense + n_moe,
        moe=dataclasses.replace(cfg.moe, first_dense_layers=n_dense))


# ---------------------------------------------------------------------------
# Recsys cells
# ---------------------------------------------------------------------------


def _rec_bounds(cfg: cfgs.RecConfig) -> Dict[str, int]:
    v = min(cfg.vocab_sizes)       # in range for every field and table
    return {"seq": v, "pos": v, "neg": v, "target": v, "cand_ids": v,
            "fields": v, "labels": 2}


def build_rec_cell(cfg: cfgs.RecConfig, shape: cfgs.RecShape,
                   device: DeviceLike = None, seed: Optional[int] = None
                   ) -> CellSpec:
    dev = resolve_device(device)
    gen = _gen(seed, dev)
    engine, offsets = rec_mod.build_engine(cfg, device=dev)
    model = rec_mod.RecModel(cfg, device=dev)
    if gen is not None:
        prm.initialize(model, gen)
    params = dict(model.named_parameters())
    state = (engine.state_shapes() if gen is None
             else engine.init_state(gen))
    kind = shape.kind
    batch = _fill(rec_mod.input_specs(
        cfg, kind, shape.batch, n_candidates=shape.n_candidates,
        with_labels=True, device=dev), _rec_bounds(cfg), gen)
    flops = _rec_model_flops(cfg, shape)
    name = f"{cfg.name}:{shape.name}"

    if kind == "train":
        opt, eopt = adam(1e-3), rowwise_adagrad(1e-2)
        step = rec_mod.make_train_step(model, engine, offsets, opt, eopt)

        def train(params, state, ostate, eostate, batch):
            return step(state, ostate, eostate, batch)
        return CellSpec(
            name=name, fn=train,
            args=(params, state, opt.init(params),
                  eopt.init({"cold": state.cold, "hot": state.hot}), batch),
            donate_argnums=(1, 2, 3), model_flops=flops)

    step = (rec_mod.make_retrieval_step(model, engine, offsets)
            if kind == "retrieval"
            else rec_mod.make_serve_step(model, engine, offsets))

    def serve(params, state, batch):
        return step(state, batch)
    return CellSpec(name=name, fn=serve, args=(params, state, batch),
                    model_flops=flops)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def build_gnn_cell(cfg: cfgs.GNNConfig, shape: cfgs.GNNShape,
                   device: DeviceLike = None, seed: Optional[int] = None
                   ) -> CellSpec:
    dev = resolve_device(device)
    gen = _gen(seed, dev)
    tp_size = dp_size = 1                  # one card
    model_flops = gnn_model_flops(cfg, shape)
    # the reference pads node and edge counts to its mesh (inert pad
    # edges); at tp = dp = 1 the pads are none
    pad_nodes = -(-shape.n_nodes // tp_size) * tp_size
    d_feat = shape.d_feat or 16
    specs = gnn_mod.model_specs(cfg, d_feat)
    params = (prm.abstract(specs, dev) if gen is None
              else {"layers": [prm.initialize_specs(lp, gen)
                               for lp in specs["layers"]]})
    if shape.kind == "full":
        pad_edges = -(-shape.n_edges // dp_size) * dp_size
        shape = dataclasses.replace(shape, n_edges=pad_edges)
    n = shape.n_nodes if shape.kind == "batched_small" else pad_nodes
    batch = _fill(gnn_mod.input_specs(cfg, shape, pad_nodes=pad_nodes,
                                      device=dev),
                  {"edges": n, "roots": n, "hop1": n, "hop2": n,
                   "labels": cfg.n_classes}, gen)
    regime = {"full": "full", "minibatch": "minibatch",
              "batched_small": "molecule"}[shape.kind]
    opt = adam(1e-2)
    step = gnn_mod.make_train_step(cfg, opt, regime)
    return CellSpec(
        name=f"{cfg.name}:{shape.name}", fn=step,
        args=(params, opt.init(params), batch), donate_argnums=(0, 1),
        model_flops=model_flops)


# ---------------------------------------------------------------------------
# DLRM cells (the paper's RMC models)
# ---------------------------------------------------------------------------


def build_dlrm_cell(cfg: cfgs.DLRMConfig, shape: cfgs.RecShape,
                    device: DeviceLike = None, seed: Optional[int] = None,
                    front_end: str = "split") -> CellSpec:
    """The paper's RMC models (benchmarks' cells, not the assigned pool).
    Every shape but ``train`` serves ``shape.batch`` samples, through
    ``front_end`` (the serve step's default, split, as the reference's)."""
    dev = resolve_device(device)
    gen = _gen(seed, dev)
    engine, _ = dlrm_mod.build_engine(cfg, device=dev)
    model = dlrm_mod.DLRM(cfg, device=dev)
    if gen is not None:
        prm.initialize(model, gen)
    params = dict(model.named_parameters())
    state = (engine.state_shapes() if gen is None
             else engine.init_state(gen))
    train = shape.kind == "train"
    batch = _fill(dlrm_mod.input_specs(cfg, shape.batch, train, device=dev),
                  {"indices": cfg.emb_num, "labels": 2}, gen)
    name = f"{cfg.name}:{shape.name}"
    # the reference passes no model_flops for these cells: they stay 0
    if train:
        opt, eopt = adam(1e-3), rowwise_adagrad(1e-2)
        step = dlrm_mod.make_train_step(model, engine, opt, eopt)

        def train_step(params, state, ostate, eostate, batch):
            return step(state, ostate, eostate, batch)
        return CellSpec(
            name=name, fn=train_step,
            args=(params, state, opt.init(params),
                  eopt.init({"cold": state.cold, "hot": state.hot}), batch),
            donate_argnums=(1, 2, 3))
    step = dlrm_mod.make_serve_step(model, engine, front_end=front_end)

    def serve(params, state, batch):
        return step(state, batch)
    return CellSpec(name=name, fn=serve, args=(params, state, batch))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def build_cell(arch: str, shape_name: str, device: DeviceLike = None,
               seed: Optional[int] = None, cfg: Any = None,
               shape: Any = None, **kw) -> CellSpec:
    """The cell ``arch:shape_name``; ``cfg`` / ``shape`` replace the
    registered config and shape (a cut or reduced cell of the same
    kind), ``kw`` goes to the builder (``front_end`` for DLRM)."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else cfg.shapes()[shape_name]
    if isinstance(cfg, cfgs.LMConfig):
        return build_lm_cell(cfg, shape, device, seed, **kw)
    if isinstance(cfg, cfgs.RecConfig):
        return build_rec_cell(cfg, shape, device, seed, **kw)
    if isinstance(cfg, cfgs.GNNConfig):
        return build_gnn_cell(cfg, shape, device, seed, **kw)
    if isinstance(cfg, cfgs.DLRMConfig):
        return build_dlrm_cell(cfg, shape, device, seed, **kw)
    raise TypeError(type(cfg))


def dlrm_cells() -> list:
    """The paper's RMC1 and RMC4 cells, four shapes each: (arch, shape,
    None) as ``iter_cells`` lists them."""
    return [(arch, s, None) for arch in ("rmc1", "rmc4")
            for s in cfgs.REC_SHAPES]

