"""Training entry point: ``python -m repro_torch.launch.train --arch <id>``
(the port of ``repro.launch.train``: every family).

Wires the stack: config -> model -> data pipeline -> optimizer -> train
step (``models.dlrm`` / ``models.recsys`` through the joint step,
``models.transformer``, ``models.gnn``) -> fault-tolerant runtime (LM
with ``--ckpt-dir``) -> metrics.  On the card unless ``--device cpu``;
the *reduced* config by default, the published widths with ``--full``.
The reference CLI binds tp = ``min(4, devices)``, one shard on one card;
so does this, with no ``--tp`` (as the serve CLI).  The reference's LM
loop builds ``make_train_step(cfg, mesh, opt)``, so it trains with remat
``"dots"`` whatever ``cfg.remat`` says; so does this.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Any, Dict, Iterable, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import base as cfgs
from repro_torch.configs import get_config, reduced
from repro_torch.data import synth
from repro_torch.data.pipeline import Prefetcher, shard_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as rec_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.params import initialize
from repro_torch.optim.optimizers import adafactor, adam, rowwise_adagrad
from repro_torch.runtime.fault_tolerance import (StragglerWatchdog,
                                                 run_resilient)


def _seeded(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _run(model, engine, step_fn, state, ostate, eostate, batches,
         log_every: int, after_step=None):
    """The loop; ``step_s`` holds each step's host-clock seconds up to its
    loss on the host (reading it waits for the device), the maintenance
    after it excluded."""
    losses, step_s = [], []
    for i, b in enumerate(batches):
        t = time.perf_counter()
        state, ostate, eostate, m = step_fn(state, ostate, eostate, b)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t)
        if after_step is not None:
            state = after_step(i, state, b)
        if i % log_every == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f}")
    return {"first_loss": losses[0], "final_loss": losses[-1],
            "median_step_ms": statistics.median(step_s) * 1e3,
            "losses": losses, "step_s": step_s, "model": model,
            "engine": engine, "state": state,
            "opt_state": ostate, "emb_opt_state": eostate}


def _batches(stream: Iterable, given: Optional[Iterable], dev):
    """The synthetic stream, or the caller's numpy batches (drawn once,
    trained on several times), prefetched onto ``dev``."""
    return Prefetcher(iter(given) if given is not None else stream,
                      device=dev)


def train_lm(cfg, steps: int, batch: int, seq: int, ckpt_dir=None,
             log_every: int = 10, device: DeviceLike = None
             ) -> Dict[str, Any]:
    """The reference's ``train_lm``: weights from seed 0, ``adafactor(lr=
    3e-3)``, ``synth.lm_batches``, remat ``"dots"``.  With ``ckpt_dir``,
    ``run_resilient`` with a checkpoint every ``max(steps // 4, 1)`` steps
    and a straggler watchdog, resuming from the directory's last
    checkpoint; returns ``steps`` and ``final_loss``.  Else the losses,
    each step's host-clock time (to the loss on the host), the parameters
    and the optimizer state."""
    dev = resolve_device(device)
    params = tfm.init_params(cfg, seed=0, device=dev)
    opt = adafactor(lr=3e-3)
    step_fn = tfm.make_train_step(cfg, opt)
    batches = list(synth.lm_batches(cfg, batch, seq, steps))
    state = {"params": params, "opt": opt.init(params)}

    def one(state, b):
        p, o, m = step_fn(state["params"], state["opt"], shard_batch(b, dev))
        return {"params": p, "opt": o}, m

    if ckpt_dir:
        rep = run_resilient(one, state, lambda i: batches[i], steps,
                            Checkpointer(ckpt_dir),
                            ckpt_every=max(steps // 4, 1),
                            watchdog=StragglerWatchdog())
        return {"steps": rep.steps_done,
                "final_loss": float(rep.final_metrics["loss"])}
    losses, step_s = [], []
    for i, b in enumerate(batches):
        t = time.perf_counter()
        state, m = one(state, b)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t)
        if i % log_every == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f}")
    return {"first_loss": losses[0], "final_loss": losses[-1],
            "median_step_ms": statistics.median(step_s) * 1e3,
            "losses": losses, "step_s": step_s, "params": state["params"],
            "opt_state": state["opt"]}


def train_gnn(cfg, steps: int, log_every: int = 10,
              device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's ``train_gnn``: ``make_graph(256, 2048, d_feat=32)``,
    weights from seed 0, ``adam(1e-2)``, the full-graph regime."""
    dev = resolve_device(device)
    g = synth.make_graph(256, 2048, d_feat=32, n_classes=cfg.n_classes)
    params = gnn_mod.init_params(cfg, 32, seed=0, device=dev)
    opt = adam(1e-2)
    ostate = opt.init(params)
    step_fn = gnn_mod.make_train_step(cfg, opt, "full")
    batch = shard_batch(g, dev)
    batch["graph"] = gnn_mod.graph_edges(batch["edges"], g["feats"].shape[0])
    losses = []
    for i in range(steps):
        params, ostate, m = step_fn(params, ostate, batch)
        losses.append(float(m["loss"]))
        if i % log_every == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f}")
    return {"first_loss": losses[0], "final_loss": losses[-1],
            "losses": losses, "params": params}


def train_dlrm(cfg, steps: int, batch: int, mode: str = "pifs",
               replan_every: int = 0, log_every: int = 10,
               device: DeviceLike = None, n_shards: int = 1,
               impl: str = "cuda", batches: Optional[Iterable] = None
               ) -> Dict[str, Any]:
    """The reference's ``train_dlrm``: model from seed 0, tables from seed
    1, adam(1e-3) on the towers and rowwise_adagrad(5e-2) on the tiers,
    ``synth.dlrm_batches`` (seed 0) unless ``batches`` (numpy dicts) are
    given; an observe after every step and a re-plan every
    ``replan_every`` steps (0: none).  Returns the losses, each step's
    host-clock time, the model, the engine, the final state and the
    optimizer states."""
    dev = resolve_device(device)
    engine, _ = dlrm_mod.build_engine(cfg, dev, n_shards=n_shards)
    model = initialize(dlrm_mod.DLRM(cfg, dev), _seeded(dev, 0))
    state = engine.init_state(_seeded(dev, 1))
    opt, eopt = adam(1e-3), rowwise_adagrad(5e-2)
    ostate = opt.init(dict(model.named_parameters()))
    eostate = eopt.init({"cold": state.cold, "hot": state.hot})
    step_fn = dlrm_mod.make_train_step(model, engine, opt, eopt, mode=mode,
                                       impl=impl)

    def maintain(i, state, b):
        state = engine.observe(state, b["indices"])
        if replan_every and (i + 1) % replan_every == 0:
            state, _ = engine.plan_and_migrate(state)
        return state

    return _run(model, engine, step_fn, state, ostate, eostate,
                _batches(synth.dlrm_batches(cfg, batch, steps), batches,
                         dev), log_every, maintain)


def train_rec(cfg, steps: int, batch: int, mode: str = "pifs",
              log_every: int = 10, device: DeviceLike = None,
              n_shards: int = 1, impl: str = "cuda",
              batches: Optional[Iterable] = None) -> Dict[str, Any]:
    """The reference's ``train_rec``: as :func:`train_dlrm` over
    ``synth.rec_batches`` (or ``batches``), with no observe (recsys
    batches hold table-local ids)."""
    dev = resolve_device(device)
    engine, offs = rec_mod.build_engine(cfg, dev, n_shards=n_shards)
    model = initialize(rec_mod.RecModel(cfg, dev), _seeded(dev, 0))
    state = engine.init_state(_seeded(dev, 1))
    opt, eopt = adam(1e-3), rowwise_adagrad(5e-2)
    ostate = opt.init(dict(model.named_parameters()))
    eostate = eopt.init({"cold": state.cold, "hot": state.hot})
    step_fn = rec_mod.make_train_step(model, engine, offs, opt, eopt,
                                      mode=mode, impl=impl)
    return _run(model, engine, step_fn, state, ostate, eostate,
                _batches(synth.rec_batches(cfg, batch, steps), batches, dev),
                log_every)


def main(argv=None) -> Optional[Dict[str, Any]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mode", default="pifs",
                    choices=["pifs", "pond", "beacon"])
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: reduced)")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    t0 = time.time()
    if isinstance(cfg, cfgs.LMConfig):
        out = train_lm(cfg, args.steps, args.batch, args.seq,
                       ckpt_dir=args.ckpt_dir, device=args.device)
    elif isinstance(cfg, cfgs.DLRMConfig):
        out = train_dlrm(cfg, args.steps, args.batch, mode=args.mode,
                         replan_every=max(args.steps // 4, 1),
                         device=args.device)
    elif isinstance(cfg, cfgs.RecConfig):
        out = train_rec(cfg, args.steps, args.batch, mode=args.mode,
                        device=args.device)
    else:
        out = train_gnn(cfg, args.steps, device=args.device)
    for k in ("losses", "step_s", "model", "engine", "state", "params",
              "opt_state", "emb_opt_state"):
        out.pop(k, None)
    print(f"done in {time.time() - t0:.1f}s: {out}")
    return out


if __name__ == "__main__":
    main()
