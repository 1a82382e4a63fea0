"""Training entry point: ``python -m repro_torch.launch.train --arch <id>``
(the port of ``repro.launch.train`` for the DLRM and recsys families).

Wires the stack: config -> model -> data pipeline -> optimizer -> the
joint train step (``models.dlrm`` / ``models.recsys``
``make_train_step``) -> metrics.  On the card unless ``--device cpu``;
the *reduced* config by default, the published widths with ``--full``.
The reference CLI binds tp = ``min(4, devices)``, one shard on one card;
so does this, with no ``--tp`` (as the serve CLI).  LM training and the
GNN family are ``ROADMAP.md`` queue 1 item 17: their ids raise
``NotImplementedError`` (the LM family serves through
``models.transformer``).
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Any, Dict, Iterable, Optional

import torch

from repro_torch.configs import base as cfgs
from repro_torch.configs import get_config, reduced
from repro_torch.data import synth
from repro_torch.data.pipeline import Prefetcher
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import recsys as rec_mod
from repro_torch.models.params import initialize
from repro_torch.optim.optimizers import adam, rowwise_adagrad

# the reference's LM and GNN ids (repro/configs/*.py), whose training is
# queue 1 item 17
ITEM17_ARCHS = ("llama3.2-3b", "deepseek-67b", "deepseek-v3-671b",
                "nemotron-4-340b", "granite-moe-1b-a400m",
                "graphsage-reddit")


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
    ap.add_argument("--mode", default="pifs",
                    choices=["pifs", "pond", "beacon"])
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: reduced)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.arch in ITEM17_ARCHS:
        raise NotImplementedError(
            f"--arch {args.arch}: LM training and the GNN family are not "
            "ported yet (ROADMAP.md queue 1 item 17)")
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    t0 = time.time()
    if isinstance(cfg, cfgs.DLRMConfig):
        out = train_dlrm(cfg, args.steps, args.batch, mode=args.mode,
                         replan_every=max(args.steps // 4, 1),
                         device=args.device)
    else:
        out = train_rec(cfg, args.steps, args.batch, mode=args.mode,
                        device=args.device)
    for k in ("losses", "step_s", "model", "engine", "state", "opt_state",
              "emb_opt_state"):
        out.pop(k)
    print(f"done in {time.time() - t0:.1f}s: {out}")
    return out


if __name__ == "__main__":
    main()
