"""End-to-end example: train a DLRM (the paper's RMC1, reduced by default)
for a few hundred steps with the full stack -- PIFS engine, planner
re-plans during training, fault-tolerant runtime with an injected
failure, asynchronous checkpoints.  The port of ``examples/train_dlrm.py``.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_dlrm
      [--steps 200] [--batch 64] [--mode pifs] [--full] [--device cpu]

The reference's (2, 4) mesh is 4 cold-tier shards on one device (the
card unless ``--device cpu``); ``--full`` trains RMC1 at its published
widths.  After a restart ``run_resilient`` hands back the state restored
from the last checkpoint; the model's parameters take its values, and
training goes on from there.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import shard_batch
from repro_torch.data.synth import dlrm_batches
from repro_torch.device import resolve_device
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models.params import initialize
from repro_torch.optim.optimizers import adam, rowwise_adagrad
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 StragglerWatchdog,
                                                 run_resilient)

N_SHARDS = 4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--mode", default="pifs")
    ap.add_argument("--full", action="store_true",
                    help="RMC1 at its published widths (default: reduced)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config("rmc1")
    if not args.full:
        cfg = reduced(cfg)
    engine, _ = dlrm_mod.build_engine(cfg, dev, n_shards=N_SHARDS)
    model = initialize(dlrm_mod.DLRM(cfg, dev),
                       torch.Generator(device=dev).manual_seed(0))
    params = dict(model.named_parameters())
    estate = engine.init_state(torch.Generator(device=dev).manual_seed(1))
    opt, eopt = adam(1e-3), rowwise_adagrad(5e-2)
    step_fn = dlrm_mod.make_train_step(model, engine, opt, eopt,
                                       mode=args.mode)

    batches = list(dlrm_batches(cfg, args.batch, args.steps, seed=7))
    state0 = {
        "params": params, "emb": estate,
        "opt": opt.init(params),
        "eopt": eopt.init({"cold": estate.cold, "hot": estate.hot}),
    }

    losses = []

    def train_one(state, batch):
        if state["params"] is not params:       # restored after a failure
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(state["params"][k])
        jb = shard_batch(batch, dev)
        e, o, eo, m = step_fn(state["emb"], state["opt"], state["eopt"], jb)
        e = engine.observe(e, jb["indices"])
        losses.append(float(m["loss"]))
        return {"params": params, "emb": e, "opt": o, "eopt": eo}, m

    with tempfile.TemporaryDirectory() as ckdir:
        ck = Checkpointer(ckdir, keep=2)
        injector = FailureInjector(fail_at_steps=(args.steps // 2,))
        wd = StragglerWatchdog()
        t0 = time.time()
        rep = run_resilient(train_one, state0, lambda i: batches[i],
                            args.steps, ck, ckpt_every=args.steps // 5,
                            injector=injector, watchdog=wd)
        dt = time.time() - t0
        # one planner cycle at the end (periodic in production)
        final = ck.restore(state0)
        emb, stats = engine.plan_and_migrate(final["emb"])
        print(f"steps={rep.steps_done} restarts={rep.restarts} "
              f"stragglers={len(rep.straggler_events)} time={dt:.0f}s")
        print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}  "
              f"(injected failure at step {args.steps // 2} survived)")
        print(f"planner: {stats['moved_pages']} pages moved, hot="
              f"{stats['hot_pages']}, balance "
              f"{stats['load_std_before']:.1f}->"
              f"{stats['load_std_after']:.1f}")
        assert losses[-1] < losses[0], "training must make progress"
    return {"report": rep, "losses": losses, "stats": stats, "emb": emb,
            "seconds": dt}


if __name__ == "__main__":
    main()
