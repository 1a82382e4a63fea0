"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--only PHASE[,PHASE]]

1. builds the ten CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all in parallel; the gather-once kernels,
   the partial pools and the resume share the sources of the kernels they
   vary);
2. kernel phase: holds each kernel against its plain PyTorch version on
   the card -- D in {16, 18, 64, 128}, fp32 and int8 tables, weights of 0/1
   (bitwise) and general weights (tolerance below), L = 7, batches that
   no block size divides, and an empty hot tier; the per-entry kernels
   masked_sls and fused_front_end also at L above a team's run, with bag
   counts on both sides of WALK_MIN_BAGS_PER_SM per SM, every entry
   masked, and rows of +-1e30 (int8: +-127 under a scale of 1e28) at row
   0 and under every masked entry of either tier; every kernel that takes
   row ids (masked_sls, also with no mask through ``ops.sls``,
   masked_sls_dedup, the fused front ends and the partial pools), called
   through ``kernels/ops.py`` on out-of-range and negative ids -- past the
   end, in [-V, 0), below -V, the int32 limits, in both tiers and on
   masked entries; fp32 and int8, D = 64 and 50, B = 37 and 2053, 1 and 4
   cold slices --, bitwise equal to its plain version (exact data: small
   integers, int8 scales powers of two) with no device-side fault, and at
   4 slices one-id bags past each slice's edge reading their own slice's
   last row, never the neighbour's -- and each gather-once
   (dedup) kernel against the kernel it varies, bitwise for every weight,
   on random, all-duplicate, all-unique and all-masked batches, at
   (B, G, L) that no block divides evenly, and with
   rows of +-1e30 (int8: +-127 under a scale of 1e28) wherever a masked
   entry could read; the
   partial pools (1, 2, 4, 8 and 12 cold shards in one launch; above 8
   the grid rows of 8 shards) and the resume kernel against their plain
   versions, the gather-once partial pool against the per-entry one
   (bitwise, every weight), and S shards' partial pools summed in shard
   order and resumed against the split composition of kernels (bitwise,
   every weight), with an empty hot tier and with every entry masked;
   rows of +-1e30 (int8: +-127) under every masked entry leave the tiles
   unchanged; and the resume alone at B = 1, 31, 32, 2053, D in {16, 18,
   64, 128} and S in {1, 2, 3, 4, 8, 12} against its plain version and,
   bitwise, against dot_interaction of the shard-order sum; and
   dot_interaction alone, both triangles, F in {2, 9, 27}, at B = 1 and
   batches no block size divides, against its plain version (bitwise on
   integer feats), and bitwise equal across its paths: float4 and the
   scalar path a view offset by one float takes; and apply_deltas against
   its plain version, bitwise, fp32 and int8, D in {16, 18, 64, 128}, 1
   and 4 shards, a random hot set and none, pads, zero-scale pages, int8
   deltas at which a multiply then an add gives another code than the
   fma, and an all-pad batch (a bitwise no-op); and masked_sls and
   masked_sls_dedup at the recsys lookups' shape -- L = 1 bags with no
   weights or 0/1 weights, D in {16, 32, 50} (D = 50: 200-byte fp32 and
   50-byte int8 rows, no 16-byte path), fp32 and int8, 1 and 4 shards in
   one launch, 21 * 512 and 26 * 512 bags -- bitwise equal to their plain
   versions;
3. slice phase: serves RMC1 and RMC4 at their published widths through
   ``repro_torch.launch.serve`` (fp32 and int8 cold tier, split and fused
   front end, batch 32 over a seeded zipfian stream plus one batch of
   2048, a hot tier of 5 % of the pages placed by ``observe`` over a
   profile and ``plan_and_migrate``, the reference's maintenance cadence)
   and checks that scores are finite and in (0, 1), that fused == split
   bitwise, that kernel-path lookups equal the plain path bitwise and
   kernel-path scores the plain path's within tolerance, and that every
   kernel of the path was launched (launch counts are zeroed just before
   the path's serve runs and read just after); and serves one batch
   holding out-of-range and negative ids (the reference clamps them) at 1
   and 4 shards, split and fused: no device-side assert, lookups bitwise
   equal to the plain path's, fused == split;
4. dedup serve phase, per configuration: the same serve runs with
   ``dedup='on'`` (at batch 32 under the 4 MiB staging budget, at batch
   2048 with the budget raised so that it resolves on) give scores
   bitwise equal to ``dedup='off'`` and launch both gather-once kernels;
   ``dedup='auto'`` after ``prime_dedup_auto`` prints its resolution
   record and the measured duplicate factor;
5. tp/pond phase, per configuration: pifs with the cold tier in 4 shards
   on one card (the reference serve launcher's tp = 4) and pond on the
   one-shard engine, each split and fused, dedup off and on, at batch 32
   and 2048, launch counts zeroed just before and read just after (the
   partial pools and the resume must have run).  Checks: scores in
   (0, 1); at 4 shards fused == split and dedup on == off bitwise; pond
   fused == pifs fused bitwise on the one-shard engine; pond split within
   1e-5 of pond fused, 4-shard scores within 1e-5 of one shard's; the
   front-end records say ``fused_tp`` with tp = 4 and tp = 1; dedup auto
   at 4 shards equals off; and at RMC4 the maintenance phase below also
   runs on the 4-shard engine;
6. maintenance phase at RMC4 (fp32 and int8): observes 16 batch-32
   batches, re-plans, observes 16 batches of drifted traffic, re-plans
   again, timing the planner and the migration apart; the dense table and
   one-id-per-bag probe lookups stay bitwise equal across each re-plan;
   prints the peak device memory of each migration;
7. times each kernel (CUDA events, L2 flushed, median), its plain version
   and the library call where one exists, beside its bound
   max(bytes / 3.35 TB/s, flops / 67 TFLOP/s) from this run's inputs
   (each distinct row counted once) -- the partial pools and the resume
   at 4 shards and at 1 (pond's fused path), ``masked_sls`` and
   ``masked_sls_dedup`` also at 4 shards (the split path's stacked
   bags), ``dot_interaction`` beside ``feats.clone()`` (``copy_ms``) and
   both also with the L2 flushed clean and warm --, times ``dedup_plan``,
   and
   times the serve steps at batch 32 and 2048 with dedup off and on, at 4
   shards (split and fused also with dedup on) and in pond (host clock to
   a synchronize), with the device's busy time and operations in them
   from ``torch.profiler``;
8. runtime phase: ``serve_offered_load``'s path (``build_serving`` +
   ``run_offered_load``: the deadline-aware dynamic batcher over buckets
   of batch 8, 16 and 32, SLO 50 ms, observe every 4 batches and re-plan
   every 64, warmup first) at RMC1 and RMC4's published widths, launch
   counts zeroed just before and read just after (rows 1 and 3-9 must
   have run).  Measured runs, one ``runtime`` JSON line each: Poisson at
   200 qps, 1024 requests (fp32 and int8, split and fused); Poisson at
   half the rate the batch-32 bucket sustains by its warmup service time
   (fp32 fused, 4096 requests; the batcher must coalesce past batch 8);
   bursty MMPP-2 at 200 qps with poolings 2, 4 and 8 (split and fused);
   64 closed-loop users; at RMC1 also dedup on (split and fused) and 4
   shards fused with dedup off and on.  Each run serves every request,
   drops and fails none, sees no signature new after warmup (and
   re-plans if it covers 64 batches), with scores finite in (0, 1).
   Under one pinned service model, the kernel path and the plain path
   give the same flush trace and scores within 1e-5, and fused == split
   and dedup on == off bitwise per request;
9. updates phase: the same path at RMC4's published widths (fp32 and
   int8) with a live update stream -- 2000 delta rows/s in batches of 64,
   applied in chunks of 256 between micro-batches through the
   ``apply_deltas`` kernel, int8 also requant-demote scans every 8 batches
   -- with a write-ahead log and a checkpointer in a temp dir (removed
   after), one ``updates`` JSON line per measured run (latency, staleness,
   the drains' cost, the updater's report, the snapshot's time and
   bytes).  Checks: every request served, every generated batch applied
   after the final drain, the WAL holding exactly the batches since the
   last snapshot, no signature new after warmup, ``apply_deltas``
   launched (counts zeroed just before the measured runs, read just
   after); under the pinned service model the kernel path and the plain
   path give the same flush trace and bitwise-equal final states; the
   kernel timed at one full chunk of the stream's rows (CUDA events, L2
   flushed) beside its plain version, its bound and, fp32, ``index_add_``
   per tier; and a durability round trip at RMC4 int8 and RMC1 fp32
   (snapshot, 3 batches, both tiers overwritten, ``restore``): state and
   scores bitwise, with the snapshot, restore and replay times;
10. integrity phase: the ``page_checksums`` kernel on whole RMC4 stores
   (fp32 and int8, 1 and 4 shards, a hot tier placed from a profile):
   bitwise equal to its plain version on every page and on pad entries,
   to ``page_checksum_host`` on every page, and (4 shards) to the
   1-shard store's checksums on pages in the same tier; timed over the
   whole store and a 64-page window (CUDA events, L2 flushed) beside its
   bound, the plain version over the whole store, and on the host clock
   a whole-store ledger build, ``verify`` and ``export``.  Then phase 9's
   path at RMC4 (fp32 and int8) with the scrubber (a quarter of the store
   audited per batch), a checkpointer and seeded bit flips landing while
   it serves, one ``integrity`` JSON line each (latency, scrub report,
   repair MTTR); launch counts zeroed just before and read just after
   (``page_checksums`` and ``apply_deltas`` must have run): every flipped
   page detected and repaired, none quarantined, the ledger equal to the
   store after the run; under the pinned service model the flipped and
   repaired run ends with ``cold``, ``hot`` and ``page_scales`` bitwise
   equal to a twin run on the same stream without flips;
11. faults phase at RMC4 (fp32 and int8) on 4 shards, fused:
   ``serve_offered_load(mesh_faults=True)`` at 200 qps (one ``faults``
   JSON line each: one re-mesh 4 -> 2, every request served or counted
   failed, no signature new after warmup, the re-mesh MTTR), launch counts
   zeroed just before and read just after (the partial pools and the
   resume must have run); the same regime under the pinned service model,
   then fixed batches bitwise equal through the recovered binding and a
   fresh 2-shard binding packed from its export; transient failures and
   stragglers under the degradation controller (finite scores, retries,
   watchdog trips); and ``corrupt_store(mode='nan')`` -> ``scrub_scores``
   -> ``wants_restore`` -> ``restore``: scores bitwise equal to the clean
   ones;
12. recsys phase: DCN-v2, AutoInt, SASRec and BST at their published
   widths, uncut (the Criteo vocabularies: 33.8 M rows at D = 16, 2.16 GB
   fp32; SASRec 1 M x 50; BST 1.01 M x 32), fp32 and, for DCN-v2 and
   SASRec, int8: ``serve_offered_load``'s path under phase 8's load
   (Poisson 200 qps, 48 Criteo or 512 sequence requests, drawn once per
   arch in spawned processes and timed; one ``recsys`` JSON line per run:
   p50 / p99 / p99.9, served, ``steady_traces`` 0), launch counts zeroed
   just before each run and read just after (``masked_sls`` must have
   run), DCN-v2 also pond at one shard and pifs at 4; at batch 512 drawn
   on the card (zipf by inverse transform, no permutation) the kernel
   path's lookups bitwise equal to the plain path's, scores within 1e-5
   and dedup on == off bitwise, the serve step timed with its device busy
   share (DCN-v2 fp32 also pond and 4 shards: lookups bitwise equal to one
   shard's), and the cold-tier ``masked_sls`` / ``masked_sls_dedup`` of
   the step's first lookup timed beside the plain versions and bounds
   (SASRec: the D = 50 row); SASRec's ``make_retrieval_step`` over
   1,000,000 candidates (finite, within 1e-5 of the plain path, timed);
   and a pinned SASRec pair, dedup off and on: one flush trace, scores
   bitwise equal, ``masked_sls_dedup`` launched.
13. paper phase: the paper's comparison -- ``simulate`` for the five
   systems on the RMC4 trace of ``examples/pifs_vs_pond.py`` (196,608
   accesses; one ``paper_sim`` line each, beside the paper's ratio; the
   paper's ordering holds); that example's engine cross-check at RMC4's
   full width (8 x 1,048,576 rows, D = 128, 4 shards), fp32 and int8,
   dedup off and on, the kernel path against the plain path bitwise (pifs
   and pond), the duplicate factor equal, each lookup timed (one
   ``paper_lookup`` line each); and ``examples/quickstart.py`` on the card,
   kernel path against plain bitwise; launch counts zeroed just before
   each kernel-path run and read just after (``masked_sls`` and
   ``masked_sls_dedup`` must have run);
14. train phase: ``launch.train`` on the card at published widths --
   DLRM RMC1 (pifs and pond) and RMC4 (pifs), fp32, batch 2048, 4 steps
   with an observe after each and a re-plan after step 3, the kernel path
   against the plain path from the same seeds and batches (losses within
   1e-5 relative, both tiers within 1e-5 + 1e-4 relative, the same page
   table), DCN-v2 over the full Criteo vocabularies and SASRec at 1 M x 50
   (batches drawn once; kernel == plain bitwise, losses and tiers); one
   ``train`` line per run with step times and peak memory; at RMC4 the
   step's device busy share and operations, each backward and the dense
   ``rowwise_adagrad`` update timed against their bounds
   (``train_timing`` lines); and ``examples/train_dlrm.py`` on the card
   with its injected failure (one restart); launch and backward counts
   zeroed just before each kernel-path run and read just after
   (``masked_sls`` and ``dot_interaction`` must have run);
15. LM phase: the LM family's serve path (``models.transformer``:
   ``prefill_step``, ``decode_step``; no kernel) -- first the five reduced
   LM configs in fp32, prefill and 4 decode steps on the card against the
   port on the CPU from the same weights within 1e-5; then bf16 at the
   published widths, llama3.2-3b and granite-moe-1b-a400m whole and
   deepseek-v3-671b cut to 4 layers (each cut printed): a 64-token
   ``lm_batches`` prompt fed through ``decode_step`` from a zero cache of
   32,768 positions ends at ``prefill_step``'s logits (within
   LM_BF16_TOL of their spread, top-1 equal or tied within it); llama's
   bf16 prefill against an fp32 run of the same weights; the prefill
   timed (seq 32,768, deepseek 4,096; batch 1); decode at pos 32,767 over
   a cache drawn on the card (batch 8, deepseek 64) attends to every
   position (layer 0 against a plain softmax over all of them, and the
   logits move when position 0 alone changes); decode steps timed with
   their bytes bound and device busy share; the prefill attention (beside
   ``F.scaled_dot_product_attention``), the decode attention and the MoE
   block timed alone; one ``lm`` JSON line per model, ``lm_timing``
   lines;
16. LM train phase: the LM family's train path (``models.transformer.
   make_train_step``, adafactor, remat "dots", the differentiable flash
   attention; no kernel) -- first the five reduced LM configs in fp32,
   one train step on the card against the port on the CPU from the same
   weights and batch (deepseek-v3 reduced keeps MTP and MoE); then bf16
   at train_4k's seq 4096, batch cut 256 -> 2: llama3.2-3b and
   granite-moe-1b-a400m whole, deepseek-v3-671b at its widths with 3
   dense layers and no MTP (each cut printed): 4 adafactor steps (lr
   1e-5) on one repeated ``lm_batches`` batch (finite, the loss falls),
   timed, tokens/s, the
   busy share of a step and peak memory; the flash backward against
   autograd through a plain masked softmax at layer 0's shapes; remat
   "full" against "none" on a 2-layer cut; llama's gradient against a
   central difference of the loss (fp32, 2 layers) and its accum=2
   against accum=1; the flash forward + backward beside SDPA's, llama's adafactor
   update beside its bytes bound and its cross-entropy beside
   ``F.cross_entropy``, granite's MoE block forward + backward; and
   ``train_lm`` with a checkpoint directory on granite (cut to 2 layers):
   4 steps against 2 steps resumed to 4, the last checkpoints byte for
   byte; ``lm_train_cpu``, ``lm_train``, ``lm_train_timing``,
   ``lm_train_ckpt`` lines;
17. GNN phase: graphsage-reddit (fp32; no kernel) -- first the reduced
   config's three regimes, forward and one adam step, card against CPU;
   then ``GNN_SHAPES`` at their sizes: Cora full batch (chunked against
   one-chunk aggregation and pad edges inert, within 1e-5), ogbn-products
   full batch (2,449,029 nodes, 61,859,140 edges) and Reddit's
   fanout-sampled minibatch (232,965 nodes, 114,615,892 edges; its CSR
   sampled on the host), both graphs drawn on the card, and 128
   molecules; 4 adam steps each on one batch (finite, the loss falls),
   timed, edges per second, peak memory; the aggregation alone at
   ogbn-products beside its bytes bound and ``torch.sparse.mm``; and
   ``launch.train --arch graphsage-reddit`` (reduced and ``--full``);
   ``gnn_cpu``, ``gnn``, ``gnn_timing``, ``gnn_cli`` lines;
18. dry-run phase (``launch/dryrun.py``): each of the ten kernels against
   its shape function (``kernels/fake.py``) at RMC4's widths, the kernel
   on real inputs and the shape function on fake copies (shape, dtype,
   device, strides equal); then RMC4 serve at batch 2048 (split, fused),
   RMC4 train at batch 2048 and llama3.2-3b decode at batch 8 over 32,768
   positions, each traced on fake CUDA tensors and run once for real under
   ``launch/op_stats.py``: FLOPs by dtype and kernel calls equal, and the
   calls equal the kernels' launches; the predicted peak above the
   arguments beside ``torch.cuda.max_memory_allocated`` and the roofline
   time beside the measured step (``dryrun`` lines); and ``fits_80gb`` of
   the cells phases 15-16 cut (false) and of their cuts (true;
   ``dryrun_fits`` lines).

``--only`` runs the build and the named phases alone, for a quicker look,
and prints neither of the last two lines; ``--only slice`` prints phase
7's ``timing`` and ``serve_step`` lines (what ``chip_ab.py --only slice``
compares).

The line before the last is the ``{"kernels": [...]}`` JSON; the last is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before either.  Exits non-zero without CUDA, and when run outside the
repository (it needs ``src/repro_torch``).

Probe lookups hold one id per bag: a bag that mixes tiers pools each tier
apart and adds the two, so a page that changes tier may change the last
bit of a many-id bag; a one-id bag adds an exact zero.

Tolerances: with general weights the kernels' fmaf accumulate and the
plain versions' multiply-then-add may differ by one rounding per step, so
SLS results must agree within 2 * L * 2^-23 * sum_l |f_l * row_l|; the
interaction kernel sums over d in order while ``torch.bmm`` does not, so
dots agree within 2 * D * 2^-23 * sum_d |x_i[d] * x_j[d]|.  Serve scores
(after the MLPs and a sigmoid) of the kernel and plain paths agree within
1e-5 absolute.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
EPS = 2.0 ** -23


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def ptxas_report(log: str) -> list:
    """(kernel, registers line, spill line) for each entry function of an
    ``-Xptxas -v`` report, names demangled with ``c++filt`` where the
    toolchain has it."""
    rows, entry, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif entry and "Used" in line and "registers" in line:
            rows.append((entry, line.split(":", 1)[-1].strip(), spill))
            entry = None
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(r[0] for r in rows),
            capture_output=True, text=True, timeout=60,
            check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = [r[0] for r in rows]
    if len(names) != len(rows):
        names = [r[0] for r in rows]
    return [(n.split("(")[0], r[1], r[2]) for n, r in zip(names, rows)]


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


# ----------------------------------------------------------------- timing
class Timer:
    """CUDA-event time of one launch with a cold L2: each repetition
    overwrites a 256 MB buffer (> the 50 MB L2), keeps the card busy while
    the host enqueues, then records events around the call alone.

    ``l2="dirty"`` (the default) flushes by writing, so the call's reads
    also write back the buffer's dirty lines; ``"clean"`` flushes by
    reading the buffer; ``"warm"`` does not flush, and the call finds what
    its last repetition left in the L2."""

    def __init__(self, reps: int = 25):
        self.reps = reps
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, l2: str = "dirty") -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            if l2 == "dirty":
                self.flush.zero_()
            elif l2 == "clean":
                self.flush.amax()
            torch.cuda._sleep(2_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def bound(nbytes: float, flops: float) -> dict:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / FP32_FLOPS_PER_S * 1e3
    return {"bytes": int(nbytes), "flops": int(flops),
            "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def sls_cost(table, idx, owned, w, scales) -> dict:
    N, L = idx.shape
    D = table.shape[1]
    safe = idx if owned is None else torch.where(owned, idx,
                                                 torch.zeros_like(idx))
    rows = torch.unique(safe).numel()
    meta = idx.numel() * (4 + (owned is not None) + 4 * (w is not None)
                          + 4 * (scales is not None))
    nbytes = rows * D * table.element_size() + meta + N * D * 4
    flops = N * L * D * (2 + (scales is not None))
    return bound(nbytes, flops)


def interaction_cost(B, F, D, P) -> dict:
    return bound(B * F * D * 4 + B * P * 4, B * P * D * 2)


def fused_cost(cold, hot, rows, owned, is_hot, w, scales) -> dict:
    B, G, L = rows.shape
    D = cold.shape[1]
    F = G + 1
    P = F * (F - 1) // 2
    zero = torch.zeros_like(rows)
    uc = torch.unique(torch.where(owned, rows, zero)).numel()
    uh = torch.unique(torch.where(is_hot, rows, zero)).numel()
    meta = rows.numel() * (4 + 1 + 1 + 4 * (w is not None)
                           + 4 * (scales is not None))
    nbytes = (uc * D * cold.element_size() + uh * D * 4 + B * D * 4 + meta
              + B * P * 4)
    flops = 2 * rows.numel() * D * 2 + B * P * D * 2
    return bound(nbytes, flops)


def dedup_cost(table, plan) -> dict:
    """What one tier of a gather-once call must read: each live staging
    slot's row once (in the table's storage type) and the live part of the
    plan (row id, scale).  Per-entry inputs and outputs are the caller's
    to add."""
    n = int(plan.n_slots)
    D = table.shape[1]
    return {"rows": n, "nbytes": n * D * table.element_size()
            + n * (4 + 4 * (plan.unique_scales is not None)),
            "dequant_flops": n * D * (plan.unique_scales is not None)}


def device_busy(step, state, batch, step_ms: float, reps: int = 10) -> dict:
    """Device time of one serve step from ``torch.profiler`` (the sum of
    its kernels and copies), its share of the step's host-clock time, the
    device operations (kernels and copies) per step, those whose count is
    not the same in every step (``uneven_ops``: work that not every step
    runs, or records the profiler lost), and the kernels that take most of
    it.  ``None`` where the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step(state, batch)
        torch.cuda.synchronize()
    dev, n_ops, uneven = {}, 0, {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = ev.cuda_time_total
            dev[ev.key] = t / 1e3 / reps                 # us -> ms per step
            n_ops += ev.count
            if ev.count % reps:
                k = ev.key[:60]
                uneven[k] = uneven.get(k, 0.0) + ev.count / reps
    busy = sum(dev.values())
    if busy <= 0:
        return {"device_busy_ms": None, "idle_share": None,
                "device_ops": None, "uneven_ops": None,
                "top_device_ms": None}
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
    return {"device_busy_ms": busy, "idle_share": 1 - busy / step_ms,
            "device_ops": n_ops / reps, "uneven_ops": uneven,
            "top_device_ms": {k[:60]: v for k, v in top}}


# -------------------------------------------------------------- tolerances
def sls_tol(table, idx, owned, w, scales) -> torch.Tensor:
    """2 * L * eps * sum_l |f_l * row_l| per output element."""
    from repro_torch.kernels import ref
    a = ref._fixed_order_masked_sls(
        table.abs(), idx, owned, None if w is None else w.abs(),
        None if scales is None else scales.abs())
    return 2 * idx.shape[1] * EPS * a


def dot_tol(feats, self_interaction=False) -> torch.Tensor:
    from repro_torch.kernels import ref
    return 2 * feats.shape[2] * EPS * ref.dot_interaction_ref(
        feats.abs(), self_interaction) + 1e-30


def assert_close(got, want, tol, what):
    err = (got - want).abs()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(bool((err <= tol).all()),
          f"{what}: max err {err.max().item():.3e} exceeds tolerance "
          f"(worst tol {tol.min().item():.3e})")
    return float(err.max().item()) if err.numel() else 0.0


def assert_equal(got, want, what):
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    if not torch.equal(got, want):
        fail(f"{what}: not bitwise equal (max err "
             f"{(got.float() - want.float()).abs().max().item():.3e})")


def fused_tol(cold, hot, x, rows3, own3, hot3, w3, s3, general: bool):
    """Tolerance of a fused kernel against its plain version: the dots'
    order, plus, with general weights, the pooled features' SLS tolerance
    carried through the dots."""
    from repro_torch.kernels import ops
    B, G, L = rows3.shape
    D = cold.shape[1]
    flat, N = rows3.reshape(-1, L), B * G
    w = None if w3 is None else w3.reshape(N, L)
    s2 = None if s3 is None else s3.reshape(N, L)
    pooled = (ops.masked_sls(cold, flat, own3.reshape(N, L), w, s2,
                             impl="torch")
              + ops.masked_sls(hot, flat, hot3.reshape(N, L), w,
                               impl="torch")).reshape(B, G, D)
    feats = torch.cat([x[:, None], pooled], 1)
    tol = dot_tol(feats)
    if general:
        a = (sls_tol(cold, flat, own3.reshape(N, L), w, s2)
             + sls_tol(hot, flat, hot3.reshape(N, L), w, None)
             ).reshape(B, G, D)
        a = torch.cat([torch.zeros_like(x[:, None]), a], 1)
        e = torch.bmm(a, feats.abs().transpose(1, 2))
        ij = torch.tril_indices(G + 1, G + 1, -1, device=x.device)
        tol = tol + 2 * (e + e.transpose(1, 2))[:, ij[0], ij[1]]
    return tol


# ---------------------------------------------------------- kernel phase
def kernel_phase(gen: torch.Generator) -> None:
    from repro_torch.core import sls as core_sls
    from repro_torch.kernels import build, ops

    def rand(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    n_cases = 0
    V, G, L = 5000, 8, 7
    for D in (16, 18, 64, 128):
        for storage in ("fp32", "int8"):
            if storage == "int8":
                table = torch.randint(-127, 128, (V, D), generator=gen,
                                      device="cuda", dtype=torch.int8)
            else:
                table = torch.randn((V, D), generator=gen, device="cuda")
            hot = torch.randn((300, D), generator=gen, device="cuda")
            for B in (37, 2053):
                N = B * G
                idx = torch.randint(0, V, (N, L), generator=gen,
                                    device="cuda", dtype=torch.int32)
                owned = rand((N, L)) < 0.6
                scales = (rand((N, L), 1e-4, 2e-2) if storage == "int8"
                          else None)
                for weighting in ("01", "general"):
                    w = ((rand((N, L)) < 0.8).float() if weighting == "01"
                         else rand((N, L), -2.0, 2.0))
                    tag = f"D={D} {storage} B={B} w={weighting}"
                    # masked_sls vs its plain version
                    k = ops.masked_sls(table, idx, owned, w, scales)
                    p = ops.masked_sls(table, idx, owned, w, scales,
                                       impl="torch")
                    if weighting == "01":
                        assert_equal(k, p, f"masked_sls {tag}")
                    else:
                        assert_close(k, p, sls_tol(table, idx, owned, w,
                                                   scales),
                                     f"masked_sls {tag}")
                    if storage == "fp32":   # plain SLS: the null-mask path
                        k = ops.masked_sls(table, idx, None, w)
                        p = ops.masked_sls(table, idx, None, w, impl="torch")
                        if weighting == "01":
                            assert_equal(k, p, f"sls {tag}")
                        else:
                            assert_close(k, p, sls_tol(table, idx, None, w,
                                                       None), f"sls {tag}")
                    # fused front end == split composition of kernels
                    rows3 = idx.reshape(B, G, L) % 300
                    own3 = owned.reshape(B, G, L)
                    hot3 = ~own3 & (rand((B, G, L)) < 0.7)
                    w3 = w.reshape(B, G, L)
                    s3 = None if scales is None else scales.reshape(B, G, L)
                    x = torch.randn((B, D), generator=gen, device="cuda")
                    fk = ops.fused_front_end(table, hot, x, rows3, own3,
                                             hot3, w3, s3)
                    flat = rows3.reshape(N, L)
                    cold_p = ops.masked_sls(table, flat, own3.reshape(N, L),
                                            w, scales)
                    hot_p = ops.masked_sls(hot, flat, hot3.reshape(N, L), w)
                    feats = torch.cat(
                        [x[:, None], (cold_p + hot_p).reshape(B, G, D)], 1)
                    split = ops.dot_interaction(feats)
                    assert_equal(fk, split, f"fused == split {tag}")
                    fp = ops.fused_front_end(table, hot, x, rows3, own3,
                                             hot3, w3, s3, impl="torch")
                    assert_close(fk, fp, fused_tol(
                        table, hot, x, rows3, own3, hot3, w3, s3,
                        weighting == "general"), f"fused vs plain {tag}")
                    # interaction kernel vs torch.bmm, both triangles
                    for si in (False, True):
                        assert_close(ops.dot_interaction(feats, si),
                                     ops.dot_interaction(feats, si,
                                                         impl="torch"),
                                     dot_tol(feats, si),
                                     f"dot_interaction self={si} {tag}")
                    n_cases += 1
            # empty hot tier (hot_fraction = 0, BEACON): nothing is hot and
            # the hot table has no rows; core/sls keeps one zero line
            B = 37
            rows3 = torch.randint(0, V, (B, G, L), generator=gen,
                                  device="cuda", dtype=torch.int32)
            own3 = torch.ones((B, G, L), dtype=torch.bool, device="cuda")
            none = torch.zeros_like(own3)
            s3 = (rand((B, G, L), 1e-4, 2e-2) if storage == "int8" else None)
            x = torch.randn((B, D), generator=gen, device="cuda")
            empty = torch.zeros((0, D), device="cuda")
            fk = core_sls.fused_front_end_dense(table, empty, x, rows3, own3,
                                                none, None, s3)
            cold_p = ops.masked_sls(table, rows3.reshape(-1, L),
                                    own3.reshape(-1, L), None,
                                    None if s3 is None else s3.reshape(-1, L))
            split = ops.dot_interaction(torch.cat(
                [x[:, None], (cold_p + 0.0).reshape(B, G, D)], 1))
            assert_equal(fk, split, f"fused empty-hot D={D} {storage}")
    n_edge = per_entry_edge_checks(gen)
    # its own generator: what the later checks and phases draw from gen
    # does not depend on these cases
    n_oob = oob_kernel_checks(
        torch.Generator(device="cuda").manual_seed(4321))
    n_dot = interaction_edge_checks(gen)
    n_dedup = dedup_kernel_checks(gen)
    n_tp = partial_pool_kernel_checks(gen)
    n_upd = apply_deltas_checks(gen)
    n_rec = recsys_kernel_checks(gen)
    torch.cuda.synchronize()
    print(f"kernel phase: {n_cases} cases + empty-hot cases + {n_edge} "
          f"per-entry edge cases + {n_oob} out-of-range id cases + {n_dot} "
          f"interaction cases + {n_dedup} "
          f"gather-once cases + {n_tp} partial-pool/resume cases + {n_upd} "
          f"apply_deltas cases + {n_rec} recsys L = 1 cases passed; "
          f"launches "
          f"{dict((k, v.launches) for k, v in build.KERNELS.items())}",
          flush=True)


def dedup_kernel_checks(gen: torch.Generator) -> int:
    """The gather-once kernels against the kernels they vary (bitwise, every
    weight) and their plain versions (bitwise at 0/1 weights, within the
    tolerances otherwise), on random (repeating), all-duplicate, all-unique
    and all-masked batches."""
    from repro_torch.core import sls as core_sls
    from repro_torch.kernels import ops

    def rand(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    n_cases = 0
    V, G, L = 5000, 8, 7
    for D in (16, 18, 64, 128):
        for storage in ("fp32", "int8"):
            if storage == "int8":
                table = torch.randint(-127, 128, (V, D), generator=gen,
                                      device="cuda", dtype=torch.int8)
            else:
                table = torch.randn((V, D), generator=gen, device="cuda")
            hot = torch.randn((V, D), generator=gen, device="cuda")
            row_scale = rand((V,), 1e-4, 2e-2)     # one scale per row
            for kind in ("random", "all_dup", "all_unique", "all_masked"):
                for B in ((37, 2053) if kind == "random" else (37,)):
                    N = B * G
                    if kind == "all_dup":
                        idx = torch.full((N, L), V // 3, dtype=torch.int32,
                                         device="cuda")
                    elif kind == "all_unique":
                        idx = torch.randperm(V, generator=gen, device="cuda")[
                            :N * L].reshape(N, L).to(torch.int32)
                    else:       # skewed: many repeats
                        idx = (rand((N, L)) ** 4 * V).to(torch.int32)
                    owned = (torch.zeros((N, L), dtype=torch.bool,
                                         device="cuda")
                             if kind == "all_masked" else rand((N, L)) < 0.6)
                    scales = row_scale[idx] if storage == "int8" else None
                    rows3 = idx.reshape(B, G, L)
                    own3 = owned.reshape(B, G, L)
                    hot3 = ~own3 & (rand((B, G, L)) < 0.7)
                    if kind == "all_masked":
                        hot3 = torch.zeros_like(own3)
                    s3 = None if scales is None else scales.reshape(B, G, L)
                    x = torch.randn((B, D), generator=gen, device="cuda")
                    for weighting in ("01", "general"):
                        w = ((rand((N, L)) < 0.8).float()
                             if weighting == "01"
                             else rand((N, L), -2.0, 2.0))
                        tag = f"D={D} {storage} {kind} B={B} w={weighting}"
                        plan = core_sls.dedup_plan(idx, owned, scales)
                        k = ops.masked_sls_dedup(table, plan, owned, w)
                        assert_equal(k, ops.masked_sls(table, idx, owned, w,
                                                       scales),
                                     f"masked_sls_dedup == masked_sls {tag}")
                        p = ops.masked_sls_dedup(table, plan, owned, w,
                                                 impl="torch")
                        if weighting == "01":
                            assert_equal(k, p, f"masked_sls_dedup {tag}")
                        else:
                            assert_close(k, p, sls_tol(table, idx, owned, w,
                                                       scales),
                                         f"masked_sls_dedup {tag}")
                        w3 = w.reshape(B, G, L)
                        fd = core_sls.fused_front_end_dense(
                            table, hot, x, rows3, own3, hot3, w3, s3,
                            dedup=True)
                        assert_equal(fd, core_sls.fused_front_end_dense(
                            table, hot, x, rows3, own3, hot3, w3, s3),
                            f"fused_front_end_dedup == fused {tag}")
                        fp = core_sls.fused_front_end_dense(
                            table, hot, x, rows3, own3, hot3, w3, s3,
                            impl="torch", dedup=True)
                        assert_close(fd, fp, fused_tol(
                            table, hot, x, rows3, own3, hot3, w3, s3,
                            weighting == "general"),
                            f"fused_front_end_dedup vs plain {tag}")
                        n_cases += 1
    return n_cases + dedup_edge_checks(gen)


def dedup_edge_checks(gen: torch.Generator) -> int:
    """The gather-once kernels read rows through the plan and skip masked
    entries, in launches shaped by the batch (``sls_shape``,
    ``front_end_shape``).
    Held bitwise against the per-entry kernels, for every weight:
    - at (B, G, L) whose bags no block divides evenly, L above a team's
      run (two metadata runs) and G above a CTA's teams;
    - with rows of +-1e30 (int8: +-127 under a masked entry's scale of
      1e28) wherever a masked entry could read -- row 0 (the per-entry
      kernels' row) and the last row (the sentinel slot's) of each table --
      on random and all-masked batches: the result equals the per-entry
      kernel on the unmodified tables."""
    from repro_torch.core import sls as core_sls
    from repro_torch.kernels import ops

    def rand(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    n_cases = 0
    V, H = 3000, 700
    shapes = ((1, 1, 3), (3, 5, 7), (32, 8, 8), (5, 26, 4), (37, 3, 33),
              (131, 8, 8))
    for D in (18, 64, 128):
        for storage in ("fp32", "int8"):
            if storage == "int8":
                table = torch.randint(-127, 128, (V, D), generator=gen,
                                      device="cuda", dtype=torch.int8)
            else:
                table = torch.randn((V, D), generator=gen, device="cuda")
            hot = torch.randn((H, D), generator=gen, device="cuda")
            row_scale = rand((V,), 1e-4, 2e-2)
            edge_c = torch.tensor([0, V - 1], device="cuda")
            edge_h = torch.tensor([0, H - 1], device="cuda")
            big = table.clone()
            sign = torch.where(rand((2, D)) < 0.5, -1.0, 1.0)
            big[edge_c] = ((sign * 127).to(torch.int8) if storage == "int8"
                           else sign * 1e30)
            big_hot = hot.clone()
            big_hot[edge_h] = torch.where(rand((2, D)) < 0.5, -1e30, 1e30)
            cases = [(B, G, L, kind) for B, G, L in shapes
                     for kind in ("random",)] + [(37, 8, 8, "all_masked")]
            for B, G, L, kind in cases:
                N = B * G
                # owned and hot rows avoid the tables' first and last rows
                rows3 = (rand((B, G, L)) ** 3 * (H - 2)).to(torch.int32) + 1
                own3 = rand((B, G, L)) < 0.6
                hot3 = ~own3 & (rand((B, G, L)) < 0.7)
                if kind == "all_masked":
                    own3 = torch.zeros_like(own3)
                    hot3 = torch.zeros_like(own3)
                s3 = (torch.where(own3, row_scale[rows3], 1e28)
                      if storage == "int8" else None)
                x = torch.randn((B, D), generator=gen, device="cuda")
                flat, own2 = rows3.reshape(N, L), own3.reshape(N, L)
                s2 = None if s3 is None else s3.reshape(N, L)
                plan = core_sls.dedup_plan(flat, own2, s2)
                for weighting in ("01", "general"):
                    w3 = ((rand((B, G, L)) < 0.8).float()
                          if weighting == "01" else rand((B, G, L), -2.0, 2.0))
                    w2 = w3.reshape(N, L)
                    tag = (f"D={D} {storage} B={B} G={G} L={L} {kind} "
                           f"w={weighting}")
                    want = ops.masked_sls(table, flat, own2, w2, s2)
                    for t, what in ((table, ""), (big, " +-1e30")):
                        assert_equal(ops.masked_sls_dedup(t, plan, own2, w2),
                                     want, f"masked_sls_dedup == masked_sls "
                                           f"{tag}{what}")
                    fwant = core_sls.fused_front_end_dense(
                        table, hot, x, rows3, own3, hot3, w3, s3)
                    for (t, h), what in (((table, hot), ""),
                                         ((big, big_hot), " +-1e30")):
                        assert_equal(core_sls.fused_front_end_dense(
                            t, h, x, rows3, own3, hot3, w3, s3, dedup=True),
                            fwant, f"fused_front_end_dedup == fused "
                                   f"{tag}{what}")
                    n_cases += 1
    return n_cases


def interaction_edge_checks(gen: torch.Generator) -> int:
    """The dot_interaction kernel on its own, both triangles, F in {2, 9,
    27}, D in {16, 18, 64, 128}, B in {1, 37, 531, 2053} (one sample, and
    batches no block size divides):
    - within the dot tolerance of its plain version on random feats, and
      bitwise equal to it on integer feats (every product and sum exact);
    - bitwise equal on a contiguous view offset by one float (not 16-byte
      aligned: the scalar path, interact_tile, the parent kernel's
      arithmetic and the fused front end's)."""
    from repro_torch.kernels import ops

    n_cases = 0
    for F in (2, 9, 27):
        for D in (16, 18, 64, 128):
            for B in (1, 37, 531, 2053):
                feats = torch.randn((B, F, D), generator=gen, device="cuda")
                buf = torch.empty(feats.numel() + 1, device="cuda")
                buf[1:] = feats.flatten()
                mis = buf[1:].view(B, F, D)
                check(mis.data_ptr() % 16 != 0, "offset view is aligned")
                ints = torch.randint(-8, 9, (B, F, D), generator=gen,
                                     device="cuda").float()
                for si in (False, True):
                    tag = f"dot_interaction F={F} D={D} B={B} self={si}"
                    k = ops.dot_interaction(feats, si)
                    assert_close(k, ops.dot_interaction(feats, si,
                                                        impl="torch"),
                                 dot_tol(feats, si), tag)
                    assert_equal(ops.dot_interaction(mis, si), k,
                                 f"{tag}: scalar path (misaligned view)")
                    assert_equal(ops.dot_interaction(ints, si),
                                 ops.dot_interaction(ints, si, impl="torch"),
                                 f"{tag}: integer feats")
                    n_cases += 1
    return n_cases


def per_entry_edge_checks(gen: torch.Generator) -> int:
    """The per-entry kernels (``masked_sls``, ``fused_front_end``) skip a
    masked entry, in launches shaped by the batch (``sls_shape``,
    ``front_end_shape``).  Held against their plain versions (bitwise at
    0/1 weights; within the SLS and dot tolerances otherwise), fused also
    against the split composition of kernels (bitwise, every weight):
    - at D in {16, 18, 64, 128}, fp32 and int8, L = 7 and L above a
      team's run, batches no block divides, and bag counts on both sides
      of ``WALK_MIN_BAGS_PER_SM`` per SM (where rows in flight and int8's
      chunk width switch), the plain SLS (``owned=None``) too;
    - with every entry masked, and with an empty hot tier;
    - with rows of +-1e30 (int8: +-127 under a masked entry's scale of
      1e28) at row 0 and under every masked entry of either tier (an
      owned entry's row in the hot table, a hot entry's in the cold
      table, a neither entry's in both): the kernels equal their results
      on the unmodified tables, for every weight, and the plain versions
      (which read row 0 at a factor of 0) at 0/1 weights;
    - with NaN and +-inf in the same places (int8: a NaN scale under every
      masked entry), where the plain versions' fmaf(0, inf, acc) gives
      NaN: the kernels skip the masked entries, so their results are
      finite, equal to those on the unmodified tables and to the
      gather-once kernels' on the same non-finite tables."""
    from repro_torch.core import sls as core_sls
    from repro_torch.kernels import ops
    from repro_torch.kernels import sls as ksls

    def rand(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    n_cases = 0
    A = 200                          # rows per entry kind (below)
    V = H = 3 * A
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    walk = ksls.WALK_MIN_BAGS_PER_SM * n_sm
    G8 = 8
    shapes = [(1, 1, 3), (3, 5, 7), (37, 8, 7), (5, 26, 4), (37, 3, 33),
              ((walk - 1) // G8, G8, 7), (-(-walk // G8), G8, 7),
              (2053, 8, 7)]
    for D in (16, 18, 64, 128):
        for storage in ("fp32", "int8"):
            if storage == "int8":
                cold = torch.randint(-127, 128, (V, D), generator=gen,
                                     device="cuda", dtype=torch.int8)
            else:
                cold = torch.randn((V, D), generator=gen, device="cuda")
            hot = torch.randn((H, D), generator=gen, device="cuda")
            row_scale = rand((V,), 1e-4, 2e-2)
            # owned entries read rows [1, A), hot ones [A, 2A), entries
            # of neither tier [2A, 3A); every row a masked entry of a
            # tier can name, and row 0, holds +-1e30 in that tier
            sign_c = torch.where(rand((V, D)) < 0.5, -1.0, 1.0)
            sign_h = torch.where(rand((H, D)) < 0.5, -1.0, 1.0)
            big_c, big_h = cold.clone(), hot.clone()
            masked_c = torch.zeros(V, dtype=torch.bool, device="cuda")
            masked_c[0] = True
            masked_c[A:] = True
            masked_h = torch.zeros(H, dtype=torch.bool, device="cuda")
            masked_h[:A] = True
            masked_h[2 * A:] = True
            big_c[masked_c] = ((sign_c[masked_c] * 127).to(torch.int8)
                               if storage == "int8"
                               else sign_c[masked_c] * 1e30)
            big_h[masked_h] = sign_h[masked_h] * 1e30
            inf_or_nan = torch.tensor([float("nan"), float("inf"),
                                       -float("inf")], device="cuda")
            bad_c, bad_h = cold.clone(), hot.clone()
            if storage == "fp32":
                bad_c[masked_c] = inf_or_nan[torch.randint(
                    0, 3, (int(masked_c.sum()), D), generator=gen,
                    device="cuda")]
            bad_h[masked_h] = inf_or_nan[torch.randint(
                0, 3, (int(masked_h.sum()), D), generator=gen,
                device="cuda")]
            cases = [(B, G, L, "random") for B, G, L in shapes]
            cases += [(37, 8, 7, "all_masked"), (37, 8, 7, "empty_hot")]
            for B, G, L, kind in cases:
                N = B * G
                u = rand((B, G, L))
                kind_of = torch.where(u < 0.6, 0, torch.where(u < 0.85, 1, 2))
                if kind == "all_masked":
                    kind_of = torch.full_like(kind_of, 2)
                elif kind == "empty_hot":
                    kind_of = torch.where(kind_of == 1, 0, kind_of)
                rows3 = ((rand((B, G, L)) ** 3 * (A - 1)).to(torch.int32)
                         + 1 + kind_of.to(torch.int32) * A)
                own3, hot3 = kind_of == 0, kind_of == 1
                s3 = (torch.where(own3, row_scale[rows3], 1e28)
                      if storage == "int8" else None)
                x = torch.randn((B, D), generator=gen, device="cuda")
                flat, own2, hot2 = (rows3.reshape(N, L), own3.reshape(N, L),
                                    hot3.reshape(N, L))
                s2 = None if s3 is None else s3.reshape(N, L)
                bad_s3 = (None if s3 is None
                          else torch.where(own3, s3, float("nan")))
                bad_s2 = None if bad_s3 is None else bad_s3.reshape(N, L)
                plans = {"cold": core_sls.dedup_plan(flat, own2, bad_s2),
                         "hot": core_sls.dedup_plan(flat, hot2)}
                for weighting in ("01", "general"):
                    w3 = ((rand((B, G, L)) < 0.8).float()
                          if weighting == "01" else rand((B, G, L), -2.0, 2.0))
                    w2 = w3.reshape(N, L)
                    tag = (f"D={D} {storage} B={B} G={G} L={L} {kind} "
                           f"w={weighting}")
                    # masked_sls, each tier, unmodified then +-1e30 and
                    # non-finite tables
                    for t, big, bad, m, s, bs, tier in (
                            (cold, big_c, bad_c, own2, s2, bad_s2, "cold"),
                            (hot, big_h, bad_h, hot2, None, None, "hot")):
                        k = ops.masked_sls(t, flat, m, w2, s)
                        p = ops.masked_sls(t, flat, m, w2, s, impl="torch")
                        what = f"masked_sls {tier} {tag}"
                        if weighting == "01":
                            assert_equal(k, p, what)
                        else:
                            assert_close(k, p, sls_tol(t, flat, m, w2, s),
                                         what)
                        assert_equal(ops.masked_sls(big, flat, m, w2, s), k,
                                     f"{what} +-1e30")
                        if weighting == "01":
                            assert_equal(ops.masked_sls(big, flat, m, w2, s,
                                                        impl="torch"), k,
                                         f"{what} +-1e30 plain")
                        nf = ops.masked_sls(bad, flat, m, w2, bs)
                        assert_equal(nf, k, f"{what} non-finite")
                        assert_equal(ops.masked_sls_dedup(bad, plans[tier], m,
                                                          w2), nf,
                                     f"{what} non-finite == gather-once")
                    if storage == "fp32":   # plain SLS: every entry kept
                        k = ops.masked_sls(cold, flat, None, w2)
                        p = ops.masked_sls(cold, flat, None, w2,
                                           impl="torch")
                        if weighting == "01":
                            assert_equal(k, p, f"sls {tag}")
                        else:
                            assert_close(k, p, sls_tol(cold, flat, None, w2,
                                                       None), f"sls {tag}")
                    # fused_front_end: plain, split, and +-1e30 tables
                    fk = ops.fused_front_end(cold, hot, x, rows3, own3, hot3,
                                             w3, s3)
                    split = ops.dot_interaction(torch.cat(
                        [x[:, None],
                         (ops.masked_sls(cold, flat, own2, w2, s2)
                          + ops.masked_sls(hot, flat, hot2, w2)
                          ).reshape(B, G, D)], 1))
                    assert_equal(fk, split, f"fused == split {tag}")
                    fp = ops.fused_front_end(cold, hot, x, rows3, own3, hot3,
                                             w3, s3, impl="torch")
                    assert_close(fk, fp, fused_tol(
                        cold, hot, x, rows3, own3, hot3, w3, s3,
                        weighting == "general"), f"fused vs plain {tag}")
                    assert_equal(ops.fused_front_end(big_c, big_h, x, rows3,
                                                     own3, hot3, w3, s3), fk,
                                 f"fused +-1e30 {tag}")
                    fnf = ops.fused_front_end(bad_c, bad_h, x, rows3, own3,
                                              hot3, w3, bad_s3)
                    assert_equal(fnf, fk, f"fused non-finite {tag}")
                    assert_equal(core_sls.fused_front_end_dense(
                        bad_c, bad_h, x, rows3, own3, hot3, w3, bad_s3,
                        dedup=True), fnf,
                        f"fused non-finite == gather-once {tag}")
                    n_cases += 1
    return n_cases


def oob_ids(V: int) -> list:
    """Row ids outside a V-row table: past the end (the first, and far),
    negative (one wrap lands in the table, or not), the int32 limits."""
    return [V, V + 93, -1, -V, -V - 1, -100, 2 ** 31 - 1, -2 ** 31]


def dense_slice_checks(cold, hot, x, rows, own4, hot3, w3, storage,
                       tag) -> None:
    """The dense S-slice pools of ``core/sls.py`` on raw ids (any int32):
    the fused partial pool through its gather-once plans equal to the
    per-entry kernel, and the split path's pool of the S slices, per
    entry and gather-once, equal to ``masked_sls`` on each slice alone;
    bitwise.  int8 scales are a function of the row each entry reads, as
    pages carry them, so duplicates a plan merges share theirs."""
    from repro_torch.core import sls as core_sls
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import clamp_rows
    S = own4.shape[0]
    R = cold.shape[0] // S
    s3 = (torch.exp2(-2.0 - (clamp_rows(rows, R) % 2).float())
          if storage == "int8" else None)
    args = (cold, hot, x, rows, own4, hot3, w3, s3)
    want = ops.fused_partial_pool(*args)
    got = core_sls.fused_partial_pool_dense(*args, dedup=True)
    torch.cuda.synchronize()
    for i in (0, 1):
        assert_equal(got[i], want[i], f"oob dense gather-once [{i}] {tag}")
    N, L = rows.shape[0] * rows.shape[1], rows.shape[2]
    flat, w2 = rows.reshape(N, L), w3.reshape(N, L)
    s2 = None if s3 is None else s3.reshape(N, L)
    per = [ops.masked_sls(cold[s * R:(s + 1) * R], flat,
                          own4[s].reshape(N, L), w2, s2) for s in range(S)]
    for dd in (False, True):
        got = core_sls.masked_partial_sls_dense(
            cold, flat, own4.reshape(S, N, L), w2, scales=s2, dedup=dd)
        torch.cuda.synchronize()
        for s in range(S):
            assert_equal(got[s], per[s],
                         f"oob dense split shard {s} dedup={dd} {tag}")


def oob_kernel_checks(gen: torch.Generator) -> int:
    """Every kernel that takes row ids, called directly through
    ``kernels/ops.py`` on out-of-range and negative ids (``oob_ids`` of
    each table's rows, on owned, hot and masked entries alike): each reads
    the row ``ref.clamp_rows`` names and equals its plain version bitwise,
    with no device-side fault (a synchronize after each kernel).  fp32 and
    int8, D = 64 (16-byte path) and 50 (scalar path), B = 37 and 2053
    (both launch shapes), 1 and 4 cold slices; masks of the 4 slices
    overlap, so the partial pool's further-owner read runs too.  Tables
    and x hold small integers and int8 scales are powers of two, so every
    pooled value and every dot is exact: the fused kernels equal their
    plain versions bitwise too.  At 4 slices, ``dense_slice_checks``
    holds the dense pools of ``core/sls.py`` on the same raw ids to each
    slice's own pool.  And one-id bags past each slice's edge (ids R,
    R + 93, -1 of a slice of R rows) read their own slice's row R - 1,
    never the neighbour's: per entry, through the gather-once plans of
    ``fused_partial_pool_dense``, and on the split path's pool."""
    from repro_torch.core import sls as core_sls
    from repro_torch.kernels import ops

    def ints(lo, hi, shape, dtype=torch.float32):
        return torch.randint(lo, hi + 1, shape, generator=gen,
                             device="cuda").to(dtype)

    def plant(ids, where, test_ids):
        pos = torch.nonzero(where.reshape(-1)).reshape(-1)
        k = min(pos.numel(), 2 * len(test_ids))
        pick = pos[torch.randperm(pos.numel(), generator=gen,
                                  device="cuda")[:k]]
        vals = torch.tensor(test_ids * 2, dtype=torch.int64)[:k]
        ids.view(-1)[pick] = vals.to(torch.int32).to("cuda")

    def same(k, p, what):
        torch.cuda.synchronize()
        if isinstance(k, tuple):
            for i, (a, b) in enumerate(zip(k, p)):
                assert_equal(a, b, f"{what} [{i}]")
        else:
            assert_equal(k, p, what)

    n_cases = 0
    VC, H, G, L = 5000, 300, 8, 7
    for D in (64, 50):
        for storage in ("fp32", "int8"):
            cold = (ints(-15, 15, (VC, D), torch.int8) if storage == "int8"
                    else ints(-3, 3, (VC, D)))
            hot = ints(-3, 3, (H, D))
            for B in (37, 2053):
                N = B * G
                x = ints(-3, 3, (B, D))
                for S in (1, 4):
                    R = VC // S
                    tag = f"D={D} {storage} B={B} S={S}"
                    shape = (B, G, L)
                    rows = torch.randint(0, H, shape, generator=gen,
                                         device="cuda", dtype=torch.int32)
                    u = torch.rand(shape, generator=gen, device="cuda")
                    kind = torch.where(u < 0.55, 0, torch.where(u < 0.85,
                                                                1, 2))
                    plant(rows, kind == 0, oob_ids(R))
                    plant(rows, kind == 1, oob_ids(H))
                    plant(rows, kind == 2, oob_ids(R) + oob_ids(H))
                    own4 = (kind == 0)[None] & (torch.rand(
                        (S,) + shape, generator=gen, device="cuda") < 0.6)
                    own4[0] |= (kind == 0) & ~own4.any(0)
                    own3, hot3 = own4[0], kind == 1
                    w3 = (torch.rand(shape, generator=gen, device="cuda")
                          < 0.8).float()
                    w3[(rows < 0) | (rows >= H)] = 1.0
                    s3 = (torch.exp2(-ints(2, 3, shape))
                          if storage == "int8" else None)
                    flat, o2, h2, w2 = (rows.reshape(N, L),
                                        own3.reshape(N, L),
                                        hot3.reshape(N, L), w3.reshape(N, L))
                    s2 = None if s3 is None else s3.reshape(N, L)
                    if S == 1:
                        # the SLS kernels, each tier on its own table
                        for t, m, sc, tier in ((cold, o2, s2, "cold"),
                                               (hot, h2, None, "hot")):
                            same(ops.masked_sls(t, flat, m, w2, sc),
                                 ops.masked_sls(t, flat, m, w2, sc,
                                                impl="torch"),
                                 f"oob masked_sls {tier} {tag}")
                            plan = core_sls.dedup_plan(flat, m, sc)
                            same(ops.masked_sls_dedup(t, plan, m, w2),
                                 ops.masked_sls_dedup(t, plan, m, w2,
                                                      impl="torch"),
                                 f"oob masked_sls_dedup {tier} {tag}")
                        if storage == "fp32":
                            same(ops.sls(cold, flat, w2),
                                 ops.sls(cold, flat, w2, impl="torch"),
                                 f"oob sls {tag}")
                        else:
                            same(ops.masked_sls(cold, flat, None, w2, s2),
                                 ops.masked_sls(cold, flat, None, w2, s2,
                                                impl="torch"),
                                 f"oob masked_sls owned=None {tag}")
                        args = (cold, hot, x, rows, own3, hot3, w3, s3)
                        same(ops.fused_front_end(*args),
                             ops.fused_front_end(*args, impl="torch"),
                             f"oob fused_front_end {tag}")
                        cp = core_sls.dedup_plan(flat, o2, s2)
                        hp = core_sls.dedup_plan(flat, h2)
                        plans = (cp._replace(slots=cp.slots.reshape(shape)),
                                 hp._replace(slots=hp.slots.reshape(shape)))
                        fargs = (cold, hot, x, *plans, own3, hot3, w3)
                        same(ops.fused_front_end_dedup(*fargs),
                             ops.fused_front_end_dedup(*fargs, impl="torch"),
                             f"oob fused_front_end_dedup {tag}")
                    own = own3 if S == 1 else own4
                    args = (cold, hot, x, rows, own, hot3, w3, s3)
                    same(ops.fused_partial_pool(*args),
                         ops.fused_partial_pool(*args, impl="torch"),
                         f"oob fused_partial_pool {tag}")
                    # the cold plan over rows of the whole tier: raw ids
                    # plus each slice's offset, read against the whole tier
                    cp, hp = core_sls.partial_pool_plans(VC, rows, own,
                                                         hot3, s3)
                    dargs = (cold, hot, x, cp, hp, own, hot3, w3)
                    same(ops.fused_partial_pool_dedup(*dargs),
                         ops.fused_partial_pool_dedup(*dargs, impl="torch"),
                         f"oob fused_partial_pool_dedup {tag}")
                    if S > 1:
                        dense_slice_checks(cold, hot, x, rows, own4, hot3,
                                           w3, storage, tag)
                    n_cases += 1
            # past each slice's edge: one-id bags owned by shard s read row
            # R - 1 of slice s, not the next slice's row 0 nor the last row
            # of the one before
            S, R = 4, VC // 4
            edge = torch.tensor([R, R + 93, -1], dtype=torch.int32,
                                device="cuda")
            rows = edge.repeat(S).reshape(S * 3, 1, 1)
            owner = torch.arange(S, device="cuda").repeat_interleave(3)
            own4 = (owner[None] == torch.arange(S, device="cuda")[:, None]
                    ).reshape(S, S * 3, 1, 1)
            none = torch.zeros((S * 3, 1, 1), dtype=torch.bool,
                               device="cuda")
            s3 = (torch.full((S * 3, 1, 1), 0.25, device="cuda")
                  if storage == "int8" else None)
            xe = torch.zeros((S * 3, D), device="cuda")
            pc, _ = ops.fused_partial_pool(cold, hot, xe, rows, own4, none,
                                           None, s3)
            torch.cuda.synchronize()
            got = pc[owner, torch.arange(S * 3, device="cuda"), 1]
            want = cold[owner * R + R - 1].float()
            if s3 is not None:
                want = want * 0.25
            assert_equal(got, want, f"slice edge D={D} {storage}")
            pd, _ = core_sls.fused_partial_pool_dense(
                cold, hot, xe, rows, own4, none, None, s3, dedup=True)
            same(pd, pc, f"slice edge D={D} {storage} gather-once")
            for dd in (False, True):
                ps = core_sls.masked_partial_sls_dense(
                    cold, rows.reshape(S * 3, 1), own4.reshape(S, S * 3, 1),
                    None, scales=None if s3 is None
                    else s3.reshape(S * 3, 1), dedup=dd)
                same(ps[owner, torch.arange(S * 3, device="cuda")], want,
                     f"slice edge D={D} {storage} split dedup={dd}")
            for nb in (owner * R + R, owner * R - 1):
                ok = (nb >= 0) & (nb < VC)
                other = cold[nb.clamp(0, VC - 1)].float() * (
                    0.25 if s3 is not None else 1.0)
                check(bool(((got != other).any(1) | ~ok).all()),
                      f"slice edge D={D} {storage}: a neighbour's row read")
            n_cases += 1
    return n_cases


def partial_pool_kernel_checks(gen: torch.Generator) -> int:
    """Rows 7-9: the partial pool (all shards in one launch), its
    gather-once variant and the resume kernel, against their plain versions
    (bitwise at 0/1 weights, within the SLS and dot tolerances otherwise),
    the gather-once tiles against the per-entry tiles (bitwise, every
    weight) and the composition -- S shards' partial pools, summed in shard
    order and resumed -- against the split composition of kernels (bitwise,
    every weight), at S = 1, 2, 4, 8 and 12 (more than 8: the grouped
    path), with an empty hot tier and with every entry masked; rows of
    +-1e30 (int8: +-127) under every masked entry leave the tiles as they
    are; and the resume alone at B = 1, 31, 32, 2053, D in {16, 18, 64,
    128} (18: the scalar path) and S in {1, 2, 3, 4, 8, 12}."""
    from repro_torch.core import sls as core_sls
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import shard_sum

    def rand(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    n_cases = 0
    V, G, L, H = 3000, 8, 7, 300
    every = ((37, "random"), (2053, "random"), (37, "empty_hot"),
             (37, "all_masked"))
    for D in (16, 18, 64, 128):
        for storage in ("fp32", "int8"):
            S_max = 12
            if storage == "int8":
                cold = torch.randint(-127, 128, (S_max * V, D),
                                     generator=gen, device="cuda",
                                     dtype=torch.int8)
            else:
                cold = torch.randn((S_max * V, D), generator=gen,
                                   device="cuda")
            hot = torch.randn((H, D), generator=gen, device="cuda")
            # one scale per (shard, row), as pages carry them: duplicates
            # of a row share it, which the gather-once plan relies on
            row_scale = rand((S_max, H), 1e-4, 2e-2)
            for S in (1, 2, 4, 8, 12):
                tier = cold[:S * V]
                for B, kind in (every if S in (1, 4) else every[:2]
                                + every[3:]):
                    N = B * G
                    rows3 = torch.randint(0, H, (B, G, L), generator=gen,
                                          device="cuda", dtype=torch.int32)
                    # each entry: a shard in [0, S) or the hot tier (-1)
                    shard = torch.randint(-1, S, (B, G, L), generator=gen,
                                          device="cuda")
                    if kind == "all_masked":
                        shard = torch.full_like(shard, S)   # nobody owns it
                    own4 = shard[None] == torch.arange(
                        S, device="cuda").view(S, 1, 1, 1)
                    hot3 = shard == -1
                    hot_t = hot
                    if kind == "empty_hot":
                        hot3 = torch.zeros_like(hot3)
                        hot_t = torch.zeros((0, D), device="cuda")
                    s3 = (row_scale[shard.clamp(0, S - 1), rows3]
                          if storage == "int8" else None)
                    x = torch.randn((B, D), generator=gen, device="cuda")
                    own = own4[0] if S == 1 else own4
                    for weighting in ("01", "general"):
                        w3 = ((rand((B, G, L)) < 0.8).float()
                              if weighting == "01"
                              else rand((B, G, L), -2.0, 2.0))
                        tag = (f"D={D} {storage} S={S} B={B} {kind} "
                               f"w={weighting}")
                        args = (tier, hot_t, x, rows3, own, hot3, w3, s3)
                        pc, ph = core_sls.fused_partial_pool_dense(*args)
                        qc, qh = core_sls.fused_partial_pool_dense(
                            *args, impl="torch")
                        dc, dh = core_sls.fused_partial_pool_dense(
                            *args, dedup=True)
                        assert_equal(dc, pc, f"partial pool dedup == "
                                             f"per-entry part_c {tag}")
                        assert_equal(dh, ph, f"partial pool dedup == "
                                             f"per-entry part_h {tag}")
                        if weighting == "01":
                            assert_equal(pc, qc, f"partial pool part_c {tag}")
                            assert_equal(ph, qh, f"partial pool part_h {tag}")
                        else:
                            flat = rows3.reshape(N, L)
                            hs = hot_t if hot_t.shape[0] else \
                                torch.zeros((1, D), device="cuda")
                            wf = w3.reshape(N, L)
                            sf = None if s3 is None else s3.reshape(N, L)
                            tc = torch.stack([sls_tol(
                                tier[s * V:(s + 1) * V], flat,
                                own4[s].reshape(N, L), wf, sf)
                                for s in range(S)]).reshape(S, B, G, D)
                            th = sls_tol(hs, flat, hot3.reshape(N, L), wf,
                                         None).reshape(B, G, D)
                            z = torch.zeros((S, B, 1, D), device="cuda")
                            tc = torch.cat([z, tc], 2)
                            assert_close(pc, qc, tc[0] if S == 1 else tc,
                                         f"partial pool part_c {tag}")
                            assert_close(ph, qh, torch.cat([z[0], th], 1),
                                         f"partial pool part_h {tag}")
                        # resume vs its plain version, on the same tiles
                        out = core_sls.fused_resume_dense(pc, ph)
                        feats = (shard_sum(pc) if S > 1 else pc) + ph
                        assert_close(out, core_sls.fused_resume_dense(
                            pc, ph, impl="torch"), dot_tol(feats),
                            f"fused_resume {tag}")
                        # composition == split composition of kernels
                        flat = rows3.reshape(N, L)
                        cold_p = core_sls.masked_partial_sls_dense(
                            tier, flat, own4.reshape(S, N, L),
                            w3.reshape(N, L),
                            scales=None if s3 is None else s3.reshape(N, L))
                        hot_p = core_sls.masked_partial_sls_dense(
                            hot_t if hot_t.shape[0] else
                            torch.zeros((1, D), device="cuda"),
                            flat, hot3.reshape(N, L), w3.reshape(N, L))
                        split = ops.dot_interaction(torch.cat(
                            [x[:, None],
                             (shard_sum(cold_p) + hot_p).reshape(B, G, D)],
                            1))
                        assert_equal(out, split, f"partial pool -> resume "
                                                 f"== split {tag}")
                        n_cases += 1
                # +-1e30 (int8: +-127) under every masked entry: row 0 of
                # each slice (what a non-owner's per-entry gather would
                # read) and the tier's last row (the dedup sentinel slot's);
                # no owned entry reads them, and the tiles do not change
                B = 37
                rows3 = torch.randint(1, H, (B, G, L), generator=gen,
                                      device="cuda", dtype=torch.int32)
                shard = torch.randint(-1, S + 1, (B, G, L), generator=gen,
                                      device="cuda")
                own4 = shard[None] == torch.arange(
                    S, device="cuda").view(S, 1, 1, 1)
                own = own4[0] if S == 1 else own4
                hot3 = shard == -1
                s3 = (row_scale[shard.clamp(0, S - 1), rows3]
                      if storage == "int8" else None)
                x = torch.randn((B, D), generator=gen, device="cuda")
                big = tier.clone()
                edge = torch.cat([torch.arange(S, device="cuda") * V,
                                  torch.tensor([S * V - 1], device="cuda")])
                sign = torch.where(rand((edge.numel(), D)) < 0.5, -1.0, 1.0)
                big[edge] = (sign * 127).to(torch.int8) if storage == "int8" \
                    else sign * 1e30
                for weighting in ("01", "general"):
                    w3 = ((rand((B, G, L)) < 0.8).float()
                          if weighting == "01" else rand((B, G, L), -2.0, 2.0))
                    tag = f"D={D} {storage} S={S} +-1e30 w={weighting}"
                    want = core_sls.fused_partial_pool_dense(
                        tier, hot, x, rows3, own, hot3, w3, s3)
                    for dd in (False, True):
                        got = core_sls.fused_partial_pool_dense(
                            big, hot, x, rows3, own, hot3, w3, s3, dedup=dd)
                        for a, z, part in zip(got, want, ("part_c", "part_h")):
                            assert_equal(a, z, f"{tag} dedup={dd} {part}")
                    if weighting == "01":
                        plain = core_sls.fused_partial_pool_dense(
                            big, hot, x, rows3, own, hot3, w3, s3,
                            impl="torch")
                        for a, z, part in zip(plain, want,
                                              ("part_c", "part_h")):
                            assert_equal(a, z, f"{tag} plain {part}")
                    n_cases += 1
    # the resume alone: batches no block size divides, every D path and
    # shard count class (S in {1, 2, 4, 8} templated, 3 and 12 the loop)
    F = G + 1
    for B in (1, 31, 32, 2053):
        for D in (16, 18, 64, 128):
            for S in (1, 2, 3, 4, 8, 12):
                pc = torch.randn((S, B, F, D), generator=gen, device="cuda")
                pc[:, :, 0] = 0.0
                ph = torch.randn((B, F, D), generator=gen, device="cuda")
                out = ops.fused_resume(pc, ph)
                feats = shard_sum(pc) + ph
                tag = f"fused_resume B={B} D={D} S={S}"
                assert_close(out, ops.fused_resume(pc, ph, impl="torch"),
                             dot_tol(feats), tag)
                assert_equal(out, ops.dot_interaction(feats),
                             f"{tag} == dot_interaction(shard_sum + h)")
                n_cases += 1
    return n_cases


# ----------------------------------------------------------- slice phase
BIG_BUDGET = 1 << 30    # staging budget that lets batch 2048 resolve on


def serve_step(b, front_end="split", **kw):
    """A serve step over binding ``b``'s model and engine."""
    from repro_torch.models import dlrm
    return dlrm.make_serve_step(b.model, b.engine, front_end=front_end, **kw)


def stream(cfg, n, seed, storage, **kw):
    """The seeded zipfian DLRM request stream (200 qps Poisson arrivals)."""
    from repro_torch.serving import loadgen
    from repro_torch.serving.request import ArrivalConfig
    return loadgen.request_stream(cfg, loadgen.LoadConfig(
        n, ArrivalConfig(200.0, seed=seed), seed=seed, storage=storage,
        **kw))


def pad_batch(cfg, reqs, batch):
    """``reqs`` padded to one bucket of ``batch``, on the card."""
    from repro_torch.serving.batcher import Bucket
    from repro_torch.serving.loadgen import make_padder
    host = make_padder(cfg)(reqs, Bucket(batch, cfg.pooling))
    return {k: torch.as_tensor(v, device="cuda") for k, v in host.items()}


def serve_runs(b, state0, reqs, bulk, batch, big, dedup, mode="pifs"):
    """Split and fused serve runs of ``reqs`` at ``batch`` and ``bulk`` at
    ``big``, each from the same starting state (the maintenance cadence
    moves the state along during a run)."""
    from repro_torch.launch import serve as srv

    def run(fe, rq, bs):
        b.state = state0
        return srv.serve(b, serve_step(b, fe, mode=mode, dedup=dedup), rq,
                         bs)

    small = {fe: run(fe, reqs, batch) for fe in ("split", "fused")}
    if dedup == "on":
        # batch 32 resolved on under the default 4 MiB budget; batch 2048's
        # staging exceeds it, so raise the budget for its signatures
        recs = b.engine.plan_stats()["dedup"]
        check(len(recs) == 2 and all(r["resolved"] and r["capacity_ok"]
                                     for r in recs.values()),
              f"dedup on at batch {batch} under the default budget: {recs}")
        b.engine.dedup_staging_bytes = BIG_BUDGET
    large = {fe: run(fe, bulk, big) for fe in ("split", "fused")}
    return small, large


def check_scores(tag, runs):
    for name, r in runs.items():
        s = r["scores"]
        check(bool(np.isfinite(s).all() and (s > 0).all() and (s < 1).all()),
              f"{tag} {name}: scores not finite in (0, 1)")


def oob_checks(b, state, hb, tag: str) -> None:
    """One batch-32 serve step with out-of-range and negative ids (past
    the end, 2**31 - 2 as the reference's ``corrupt_oob`` fault sends, and
    -1, -padded_rows, -padded_rows - 5) on the card, split and fused: it
    completes with no device-side assert (a synchronize after it), the
    kernel-path lookup equals the plain path's bitwise, fused == split
    bitwise, and the scores are in (0, 1) and within 1e-5 of the plain
    path's."""
    eng = b.engine
    R = eng.cfg.padded_rows
    ids = torch.tensor([R, R + 1000, 2 ** 31 - 2, -1, -R, -R - 5],
                       dtype=torch.int32, device="cuda")
    sub = {k: v[:32].clone() for k, v in hb.items()}
    flat_i = sub["indices"].view(-1)
    flat_w = sub["weights"].view(-1)
    pos = torch.arange(ids.numel(), device="cuda") * 37 % flat_i.numel()
    flat_i[pos] = ids
    flat_w[pos] = 1.0
    lk = eng.lookup(state, sub["indices"], sub["weights"])
    lp = eng.lookup(state, sub["indices"], sub["weights"], impl="torch")
    torch.cuda.synchronize()
    assert_equal(lk, lp, f"{tag}: out-of-range ids, lookup kernel vs plain")
    out = {fe: serve_step(b, fe)(state, sub) for fe in ("split", "fused")}
    plain = serve_step(b, "split", impl="torch")(state, sub)
    torch.cuda.synchronize()
    assert_equal(out["fused"], out["split"],
                 f"{tag}: out-of-range ids, fused vs split")
    s = out["split"]
    check(bool(torch.isfinite(s).all() and (s > 0).all() and (s < 1).all()),
          f"{tag}: out-of-range ids, scores not finite in (0, 1)")
    err = float((s - plain).abs().max())
    check(err <= 1e-5, f"{tag}: out-of-range ids, kernel vs plain scores "
                       f"differ by {err:.3e}")
    print(f"{tag}: out-of-range ids {ids.tolist()} served at "
          f"{eng.cfg.n_shards} shard(s), split and fused, no device assert; "
          f"kernel vs plain score err {err:.2e}", flush=True)


def slice_phase(timer: Timer):
    from repro_torch.configs import get_config
    from repro_torch.core import sls as core_sls
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve as srv
    from repro_torch.serving import loadgen

    n_req, batch, big = 256, 32, 2048
    paths = {"off": ("masked_sls", "dot_interaction", "fused_front_end"),
             "on": ("masked_sls_dedup", "dot_interaction",
                    "fused_front_end_dedup")}
    launches = {p: {k: 0 for k in build.KERNELS} for p in (*paths, "tp")}
    details, steps, dedup_lines, maint = [], [], [], []
    for arch in ("rmc1", "rmc4"):
        cfg = get_config(arch)
        G, L, D = cfg.n_tables, cfg.pooling, cfg.emb_dim
        F = G + 1
        P = F * (F - 1) // 2
        for storage in ("fp32", "int8"):
            t0 = time.perf_counter()
            reqs = stream(cfg, n_req, 0, storage)
            bulk = stream(cfg, big, 1, storage)
            b = loadgen.bind_model(cfg, "cuda", storage=storage, seed=0,
                                   profile=reqs[: n_req // 4])
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            tag = f"{arch} {storage}"
            eng = b.engine
            state0 = b.state
            # ---- each path: counts zeroed just before, read just after
            res = {}
            for path, kernels in paths.items():
                build.reset_launches()
                res[path] = serve_runs(b, state0, reqs, bulk, batch, big,
                                       path)
                got = {k: v.launches for k, v in build.KERNELS.items()}
                for k in kernels:
                    check(got[k] > 0, f"{tag}: kernel {k} was not launched "
                                      f"by the dedup={path} serve runs")
                    launches[path][k] += got[k]
                print(f"{tag}: dedup={path} path launches {got}", flush=True)
            n_steps = res["off"][0]["split"]["batches"] + \
                res["off"][1]["split"]["batches"]
            # ---- checks on the served scores
            for i, bs in enumerate((batch, big)):
                off, on = res["off"][i], res["on"][i]
                check_scores(f"{tag} batch {bs}",
                             {f"{p} {fe}": res[p][i][fe] for p in res
                              for fe in ("split", "fused")})
                check(np.array_equal(off["split"]["scores"],
                                     off["fused"]["scores"]),
                      f"{tag} batch {bs}: fused != split bitwise")
                for fe in ("split", "fused"):
                    check(np.array_equal(on[fe]["scores"],
                                         off[fe]["scores"]),
                          f"{tag} batch {bs} {fe}: dedup on != off bitwise")
            b.state = state0
            plain = srv.serve(b, serve_step(b, "split", impl="torch"), reqs,
                              batch)
            err = float(np.abs(plain["scores"]
                               - res["off"][0]["split"]["scores"]).max())
            check(err <= 1e-5, f"{tag}: kernel vs plain serve scores differ "
                               f"by {err:.3e} > 1e-5")
            rec = eng.plan_stats()["front_end"]
            check(all(v["resolved"] == "fused" for k, v in rec.items()
                      if v["requested"] == "fused"), f"{tag}: {rec}")
            # ---- dedup auto, primed from the stream's prefix
            b.state = state0
            primed = loadgen.prime_dedup_auto(b, reqs)
            auto = {fe: srv.serve(b, serve_step(b, fe, dedup="auto"), reqs,
                                  batch)
                    for fe in ("split", "fused")}
            for fe in ("split", "fused"):
                check(np.array_equal(auto[fe]["scores"],
                                     res["off"][0][fe]["scores"]),
                      f"{tag} {fe}: dedup auto != off bitwise")
            auto_recs = eng.plan_stats().get("dedup", {})
            print(f"{tag}: dedup auto after priming {primed} requests: "
                  f"hint {eng.dedup_auto_hint:.4f}; records "
                  f"{json.dumps(auto_recs)}; measured per bucket "
                  f"{json.dumps(b.dedup_report())}", flush=True)
            eng.reset_plan_stats(clear_plans=True)
            eng.dedup_staging_bytes = BIG_BUDGET
            b.state = state0
            # ---- lookups: kernel == plain bitwise (0/1 weights)
            hb = pad_batch(cfg, bulk, big)
            lk = eng.lookup(state0, hb["indices"], hb["weights"])
            lp = eng.lookup(state0, hb["indices"], hb["weights"],
                            impl="torch")
            assert_equal(lk, lp, f"{tag}: lookup kernel vs plain")
            oob_checks(b, state0, hb, tag)
            loc, owned, is_hot, scale = eng._address(state0, hb["indices"])
            owned = owned[0]                       # one shard
            real = hb["weights"] != 0
            hot_share = float((is_hot & real).sum() / real.sum())
            print(f"{tag}: setup {setup_s:.1f} s; served {n_req} requests at "
                  f"batch {batch} and {big} at batch {big}, split and "
                  f"fused, dedup off and on; hot-tier share of lookups "
                  f"{hot_share:.3f}; kernel-vs-plain score err {err:.2e}; "
                  f"{n_steps} split + {n_steps} fused steps per path",
                  flush=True)
            # ---- per-kernel timing at this config's serve shapes
            for B in (batch, big):
                sub = {k: v[:B] for k, v in hb.items()}
                loc, owned, is_hot, scale = eng._address(state0,
                                                         sub["indices"])
                owned = owned[0]                   # one shard
                x = torch.randn((B, D), device="cuda")
                flat = loc.reshape(-1, L)
                own2, hot2 = owned.reshape(-1, L), is_hot.reshape(-1, L)
                w2 = sub["weights"].reshape(-1, L)
                s2 = None if scale is None else scale.reshape(-1, L)
                feats = torch.cat([x[:, None], lk[:B]], 1).contiguous()
                cold, hot = state0.cold, state0.hot
                cp = core_sls.dedup_plan(flat, own2, s2)
                hp = core_sls.dedup_plan(flat, hot2)
                cp3 = cp._replace(slots=cp.slots.reshape(B, G, L))
                hp3 = hp._replace(slots=hp.slots.reshape(B, G, L))
                fused_args = (cold, hot, x, loc, owned, is_hot,
                              sub["weights"], scale)
                c_dd, h_dd = dedup_cost(cold, cp), dedup_cost(hot, hp)
                n_e = flat.numel()      # per entry: slot 4 B, mask 1, w 4
                calls = {
                    "masked_sls/cold": (
                        lambda: ops.masked_sls(cold, flat, own2, w2, s2),
                        lambda: ops.masked_sls(cold, flat, own2, w2, s2,
                                               impl="torch"),
                        sls_cost(cold, flat, own2, w2, s2)),
                    "masked_sls/hot": (
                        lambda: ops.masked_sls(hot, flat, hot2, w2),
                        lambda: ops.masked_sls(hot, flat, hot2, w2,
                                               impl="torch"),
                        sls_cost(hot, flat, hot2, w2, None)),
                    "dot_interaction": (
                        lambda: ops.dot_interaction(feats),
                        lambda: ops.dot_interaction(feats, impl="torch"),
                        interaction_cost(B, F, D, P)),
                    "fused_front_end": (
                        lambda: ops.fused_front_end(*fused_args),
                        lambda: ops.fused_front_end(*fused_args,
                                                    impl="torch"),
                        fused_cost(cold, hot, loc, owned, is_hot,
                                   sub["weights"], scale)),
                    "masked_sls_dedup/cold": (
                        lambda: ops.masked_sls_dedup(cold, cp, own2, w2),
                        lambda: ops.masked_sls_dedup(cold, cp, own2, w2,
                                                     impl="torch"),
                        bound(c_dd["nbytes"] + n_e * 9 + B * G * D * 4,
                              n_e * D * 2 + c_dd["dequant_flops"])),
                    "fused_front_end_dedup": (
                        lambda: ops.fused_front_end_dedup(
                            cold, hot, x, cp3, hp3, owned, is_hot,
                            sub["weights"]),
                        lambda: ops.fused_front_end_dedup(
                            cold, hot, x, cp3, hp3, owned, is_hot,
                            sub["weights"], impl="torch"),
                        bound(c_dd["nbytes"] + h_dd["nbytes"] + n_e * 14
                              + B * D * 4 + B * P * 4,
                              2 * n_e * D * 2 + c_dd["dequant_flops"]
                              + B * P * D * 2)),
                }
                lib = {}
                if storage == "fp32":
                    # row 2 of the table: the null-mask SLS (sls_pallas),
                    # through its own entry point
                    calls["sls"] = (
                        lambda: ops.sls(cold, flat, w2),
                        lambda: ops.sls(cold, flat, w2, impl="torch"),
                        sls_cost(cold, flat, None, w2, None))
                    lib["sls"] = lambda: torch.nn.functional.embedding_bag(
                        flat, cold, mode="sum", per_sample_weights=w2)
                    safe = torch.where(own2, flat, torch.zeros_like(flat))
                    fw = own2.float() * w2
                    lib["masked_sls/cold"] = lambda: torch.nn.functional \
                        .embedding_bag(safe, cold, mode="sum",
                                       per_sample_weights=fw)
                    lib["masked_sls_dedup/cold"] = lib["masked_sls/cold"]
                ij = torch.tril_indices(F, F, -1, device="cuda")
                lib["dot_interaction"] = lambda: torch.bmm(
                    feats, feats.transpose(1, 2))[:, ij[0], ij[1]]
                outs = {}
                for name, (kfn, pfn, cost) in calls.items():
                    kout, pout = kfn(), pfn()
                    outs[name] = kout
                    what = f"{name} {tag} batch {B}"
                    if name.startswith(("masked_sls", "sls")):  # 0/1 weights
                        assert_equal(kout, pout, what)
                    else:
                        assert_close(kout, pout, dot_tol(feats), what)
                    if name.startswith("fused_front_end"):
                        assert_equal(kout, ops.dot_interaction(feats),
                                     f"{name} == split {tag} batch {B}")
                    d = {"name": name, "arch": arch, "storage": storage,
                         "batch": B, "ms": timer(kfn), "plain_ms": timer(pfn),
                         "library_ms": (timer(lib[name]) if name in lib
                                        else None),
                         "max_abs_err": float((kout - pout).abs().max()),
                         **cost}
                    if name == "dot_interaction":
                        # the same bytes read (and written) by a copy, and
                        # both with the L2 flushed clean and warm
                        copy = lambda: feats.clone()  # noqa: E731
                        d["copy_ms"] = timer(copy)
                        for l2 in ("clean", "warm"):
                            d[f"{l2}_ms"] = timer(kfn, l2)
                            d[f"copy_{l2}_ms"] = timer(copy, l2)
                    details.append(d)
                assert_equal(outs["masked_sls_dedup/cold"],
                             outs["masked_sls/cold"],
                             f"masked_sls_dedup == masked_sls {tag} {B}")
                # ---- dedup_plan (plain PyTorch: ~10 launches per tier)
                t = time.perf_counter()
                for _ in range(20):
                    core_sls.dedup_plan(flat, own2, s2)
                host_ms = (time.perf_counter() - t) * 1e3 / 20
                torch.cuda.synchronize()
                entries = int(real[:B].sum())
                f_cold = eng.dedup_factor(state0, sub["indices"],
                                          sub["weights"])
                dedup_lines.append({
                    "arch": arch, "storage": storage, "batch": B,
                    "dedup_plan_ms": timer(
                        lambda: core_sls.dedup_plan(flat, own2, s2)),
                    "dedup_plan_host_ms": host_ms,
                    "factor": f_cold["factor"], "entries": entries,
                    "unique_cold": f_cold["unique_cold"],
                    "unique_hot": f_cold["unique_hot"],
                    "n_slots_cold": int(cp.n_slots),
                    "n_slots_hot": int(hp.n_slots),
                    "staging_bytes": (int(cp.n_slots) + int(hp.n_slots))
                    * D * 4,
                    "gathered_bytes_dedup": c_dd["rows"] * D
                    * cold.element_size() + h_dd["rows"] * D * 4,
                    "gathered_bytes_per_entry": int(own2.sum()) * D
                    * cold.element_size() + int(hot2.sum()) * D * 4})
                # ---- serve step time: host clock to synchronize
                for dedup in ("off", "on"):
                    for fe in ("split", "fused"):
                        step = serve_step(b, fe, dedup=dedup)
                        for _ in range(3):
                            step(state0, sub)
                        torch.cuda.synchronize()
                        ts = []
                        for _ in range(20):
                            t = time.perf_counter()
                            step(state0, sub)
                            torch.cuda.synchronize()
                            ts.append((time.perf_counter() - t) * 1e3)
                        ms = statistics.median(ts)
                        steps.append({"arch": arch, "storage": storage,
                                      "n_shards": 1, "mode": "pifs",
                                      "front_end": fe, "dedup": dedup,
                                      "batch": B, "step_ms": ms,
                                      **device_busy(step, state0, sub, ms)})
            tp_phase(b, state0, cfg, storage, reqs, bulk, res["off"], hb,
                     timer, launches["tp"], details, steps, maint)
            if arch == "rmc4":
                maint.append(maintenance_phase(b, state0, cfg, storage))
            del b, hb, lk, lp, state0, res, auto, plain, cold, hot
            torch.cuda.empty_cache()
    return launches, details, steps, dedup_lines, maint


# -------------------------------------------------------- tp/pond phase
TP = 4          # the reference serve launcher's tp: make_test_mesh(n, 4)


def step_time(step, state, batch) -> dict:
    """Median host-clock time of 20 serve steps (to a synchronize) and the
    device's busy share in them."""
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()
    ts = []
    for _ in range(20):
        t = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    ms = statistics.median(ts)
    return {"step_ms": ms, **device_busy(step, state, batch, ms)}


def tp_phase(b1, state1, cfg, storage, reqs, bulk, pifs1, hb, timer,
             launches, details, steps, maint) -> None:
    """The fused_tp paths.  pifs at n_shards = 4 on a binding of its own
    (same seed, same profile) and pond on the one-shard binding ``b1``,
    each split and fused, dedup off and on, at batch 32 and 2048; launch
    counts zeroed just before and read just after.  Checks: scores in
    (0, 1); pifs fused == split and dedup on == off bitwise at 4 shards;
    pond-fused == pifs-fused bitwise on the one-shard engine (``pifs1``,
    the slice phase's dedup-off runs); pond split within 1e-5 of pond
    fused; 4-shard scores within 1e-5 of one shard's; the front-end
    records; dedup auto at 4 shards; and (RMC4) the re-plans at 4 shards.
    Then times the partial pools and the resume (4 shards) and the serve
    steps of both paths."""
    from repro_torch.core import sls as core_sls
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.ref import shard_sum
    from repro_torch.launch import serve as srv
    from repro_torch.serving import loadgen

    n_req, batch, big = len(reqs), 32, len(bulk)
    G, L, D = cfg.n_tables, cfg.pooling, cfg.emb_dim
    F = G + 1
    P = F * (F - 1) // 2
    tag = f"{cfg.name} {storage}"
    t0 = time.perf_counter()
    b4 = loadgen.bind_model(cfg, "cuda", storage=storage, seed=0,
                            profile=reqs[: n_req // 4], n_shards=TP)
    state4 = b4.state
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eng1, eng4 = b1.engine, b4.engine
    eng1.reset_plan_stats(clear_plans=True)
    eng1.dedup_staging_bytes = 4 << 20
    # ---- the path: counts zeroed just before, read just after
    build.reset_launches()
    tp = {d: serve_runs(b4, state4, reqs, bulk, batch, big, d)
          for d in ("off", "on")}
    pond = {}
    for d in ("off", "on"):
        eng1.dedup_staging_bytes = 4 << 20
        eng1.reset_plan_stats(clear_plans=True)
        pond[d] = serve_runs(b1, state1, reqs, bulk, batch, big, d,
                             mode="pond")
    got = {k: v.launches for k, v in build.KERNELS.items()}
    for k in ("masked_sls", "dot_interaction", "masked_sls_dedup",
              "fused_partial_pool", "fused_partial_pool_dedup",
              "fused_resume"):
        check(got[k] > 0, f"{tag}: kernel {k} was not launched by the "
                          f"tp/pond serve runs")
    for k in launches:
        launches[k] += got[k]
    print(f"{tag}: tp/pond path launches {got}", flush=True)
    rec4 = eng4.plan_stats()["front_end"]
    rec1 = eng1.plan_stats()["front_end"]
    check(all(v["resolved"] == "fused_tp" and v["tp"] == TP
              for v in rec4.values() if v["requested"] == "fused"),
          f"{tag}: 4-shard records {rec4}")
    check(all(v["resolved"] == "fused_tp" and v["tp"] == 1
              for v in rec1.values() if v["requested"] == "fused"),
          f"{tag}: pond records {rec1}")
    # ---- checks on the served scores
    for i, bs in enumerate((batch, big)):
        check_scores(f"{tag} batch {bs} tp={TP}",
                     {f"{d} {fe}": tp[d][i][fe] for d in tp
                      for fe in ("split", "fused")})
        check_scores(f"{tag} batch {bs} pond",
                     {f"{d} {fe}": pond[d][i][fe] for d in pond
                      for fe in ("split", "fused")})
        for d in ("off", "on"):
            check(np.array_equal(tp[d][i]["split"]["scores"],
                                 tp[d][i]["fused"]["scores"]),
                  f"{tag} batch {bs} tp={TP} dedup={d}: fused != split")
        for fe in ("split", "fused"):
            check(np.array_equal(tp["on"][i][fe]["scores"],
                                 tp["off"][i][fe]["scores"]),
                  f"{tag} batch {bs} tp={TP} {fe}: dedup on != off")
            check(np.array_equal(pond["on"][i][fe]["scores"],
                                 pond["off"][i][fe]["scores"]),
                  f"{tag} batch {bs} pond {fe}: dedup on != off")
        check(np.array_equal(pond["off"][i]["fused"]["scores"],
                             pifs1[i]["fused"]["scores"]),
              f"{tag} batch {bs}: pond fused != pifs fused bitwise")
        e = float(np.abs(pond["off"][i]["split"]["scores"]
                         - pond["off"][i]["fused"]["scores"]).max())
        check(e <= 1e-5, f"{tag} batch {bs}: pond split vs fused {e:.3e}")
        e4 = float(np.abs(tp["off"][i]["split"]["scores"]
                          - pifs1[i]["split"]["scores"]).max())
        check(e4 <= 1e-5, f"{tag} batch {bs}: tp={TP} vs one shard {e4:.3e}")
        print(f"{tag} batch {bs}: pond split vs fused max diff {e:.2e}; "
              f"tp={TP} vs one shard {e4:.2e}", flush=True)
    oob_checks(b4, state4, hb, f"{tag} tp={TP}")
    # ---- dedup auto at 4 shards, primed from the stream's prefix
    b4.state = state4
    loadgen.prime_dedup_auto(b4, reqs)
    for fe in ("split", "fused"):
        auto = srv.serve(b4, serve_step(b4, fe, dedup="auto"), reqs, batch)
        check(np.array_equal(auto["scores"], tp["off"][0][fe]["scores"]),
              f"{tag} tp={TP} {fe}: dedup auto != off bitwise")
    print(f"{tag}: tp={TP} setup {setup_s:.1f} s; dedup auto records "
          f"{json.dumps(eng4.plan_stats().get('dedup', {}))}", flush=True)
    # ---- timing at the serve shapes: 4 shards, and 1 (pond's fused path)
    b4.state = state4
    eng4.dedup_staging_bytes = BIG_BUDGET
    ij = torch.tril_indices(F, F, -1, device="cuda")
    for B in (batch, big):
        sub = {k: v[:B] for k, v in hb.items()}
        w = sub["weights"]
        x = torch.randn((B, D), device="cuda")
        for eng, st, n in ((eng4, state4, TP), (eng1, state1, 1)):
            loc, own, is_hot, scale = eng._address(st, sub["indices"])
            cold, hot = st.cold, st.hot
            pp_args = (cold, hot, x, loc, own, is_hot, w, scale)
            cp, hp = core_sls.partial_pool_plans(cold.shape[0], loc, own,
                                                 is_hot, scale)
            pc, ph = ops.fused_partial_pool(*pp_args)
            n_e = loc.numel()
            R = eng.cfg.rows_per_shard
            base = torch.arange(n, device="cuda").view(n, 1, 1, 1) * R
            uc = torch.unique((loc[None] + base)[own]).numel()
            uh = torch.unique(loc[is_hot]).numel()
            tiles = (n + 1) * B * F * D * 4
            meta = n_e * (4 + n + 1 + 4 + 4 * (scale is not None))
            flops = 2 * n_e * D * 2 + n_e * D * (scale is not None)
            c_dd, h_dd = dedup_cost(cold, cp), dedup_cost(hot, hp)

            def lib_resume():
                f = shard_sum(pc) + ph
                return torch.bmm(f, f.transpose(1, 2))[:, ij[0], ij[1]]

            calls = {
                "fused_partial_pool": (
                    lambda: ops.fused_partial_pool(*pp_args),
                    lambda: ops.fused_partial_pool(*pp_args, impl="torch"),
                    bound(uc * D * cold.element_size() + uh * D * 4 + meta
                          + B * D * 4 + tiles, flops), None),
                "fused_partial_pool_dedup": (
                    lambda: ops.fused_partial_pool_dedup(cold, hot, x, cp,
                                                         hp, own, is_hot, w),
                    lambda: ops.fused_partial_pool_dedup(cold, hot, x, cp,
                                                         hp, own, is_hot, w,
                                                         impl="torch"),
                    bound(c_dd["nbytes"] + h_dd["nbytes"]
                          + n_e * (4 * n + 4 + n + 1 + 4) + B * D * 4
                          + tiles, 2 * n_e * D * 2 + c_dd["dequant_flops"]),
                    None),
                "fused_resume": (
                    lambda: ops.fused_resume(pc, ph),
                    lambda: ops.fused_resume(pc, ph, impl="torch"),
                    bound(tiles + B * P * 4, 2 * B * F * F * D), lib_resume),
            }
            if n == TP:
                # the 4-shard split path's SLS: the S shards as S stacked
                # batches of bags over the whole tier, one dedup plan
                S, N = n, B * G
                rows = core_sls._stacked_rows(loc.reshape(N, L), S,
                                              cold.shape[0] // S
                                              ).reshape(S * N, L)
                own2 = own.reshape(S * N, L)
                w2 = w.reshape(N, L).repeat(S, 1)
                s2 = (None if scale is None
                      else scale.reshape(N, L).repeat(S, 1))
                sp = core_sls.dedup_plan(rows, own2, s2)
                s_dd = dedup_cost(cold, sp)
                calls["masked_sls/cold"] = (
                    lambda: ops.masked_sls(cold, rows, own2, w2, s2),
                    lambda: ops.masked_sls(cold, rows, own2, w2, s2,
                                           impl="torch"),
                    sls_cost(cold, rows, own2, w2, s2), None)
                calls["masked_sls_dedup/cold"] = (
                    lambda: ops.masked_sls_dedup(cold, sp, own2, w2),
                    lambda: ops.masked_sls_dedup(cold, sp, own2, w2,
                                                 impl="torch"),
                    bound(s_dd["nbytes"] + S * n_e * 9 + S * N * D * 4,
                          S * n_e * D * 2 + s_dd["dequant_flops"]), None)
            feats = shard_sum(pc) + ph
            outs = {}
            for name, (kfn, pfn, cost, lib) in calls.items():
                kout, pout = kfn(), pfn()
                outs[name] = kout
                what = f"{name} {tag} tp={n} batch {B}"
                if name == "fused_resume":
                    assert_close(kout, pout, dot_tol(feats), what)
                    err = float((kout - pout).abs().max())
                elif name.startswith("masked_sls"):    # 0/1 weights
                    assert_equal(kout, pout, what)
                    err = 0.0
                else:                               # 0/1 weights: bitwise
                    for a, z, part in zip(kout, pout, ("part_c", "part_h")):
                        assert_equal(a, z, f"{what} {part}")
                    err = 0.0
                details.append({"name": name, "arch": cfg.name,
                                "storage": storage, "batch": B,
                                "n_shards": n, "ms": timer(kfn),
                                "plain_ms": timer(pfn),
                                "library_ms": None if lib is None
                                else timer(lib), "max_abs_err": err, **cost})
            if n == TP:
                assert_equal(outs["masked_sls_dedup/cold"],
                             outs["masked_sls/cold"],
                             f"masked_sls_dedup == masked_sls {tag} tp={n} "
                             f"batch {B}")
        # ---- serve steps: pifs at 4 shards, pond at one; and the 4-shard
        # steps with dedup on (the gather-once kernels' launches)
        for mode, bb, st, fe, dedup in (
                ("pifs", b4, state4, "split", "off"),
                ("pifs", b4, state4, "fused", "off"),
                ("pond", b1, state1, "split", "off"),
                ("pond", b1, state1, "fused", "off"),
                ("pifs", b4, state4, "split", "on"),
                ("pifs", b4, state4, "fused", "on")):
            steps.append({"arch": cfg.name, "storage": storage,
                          "n_shards": bb.engine.cfg.n_shards,
                          "mode": mode, "front_end": fe, "dedup": dedup,
                          "batch": B,
                          **step_time(serve_step(bb, fe, mode=mode,
                                                 dedup=dedup),
                                      st, sub)})
    if cfg.name == "rmc4":
        maint.append(maintenance_phase(b4, state4, cfg, storage))
    b1.state = state1
    del b4, state4, tp, pond, pc, ph, cp, hp, calls
    torch.cuda.empty_cache()


# ----------------------------------------------------- maintenance phase
def maintenance_phase(b, state0, cfg, storage) -> dict:
    """Observe 16 batch-32 batches, re-plan; observe 16 batches of drifted
    traffic, re-plan again.  The planner (host) and the migration (card)
    are timed apart; the dense table and one-id-per-bag probe lookups must
    stay bitwise equal across each re-plan."""
    from repro_torch.core.paging import HOT_SHARD, host
    from repro_torch.core.planner import plan

    eng = b.engine
    b.state = state0
    # the hot set drifts after the first 16 batches' 512 requests
    reqs = stream(cfg, 2 * 16 * 32, 2, storage, drift_every=16 * 32)
    out = {"arch": "rmc4", "storage": storage,
           "n_shards": eng.cfg.n_shards, "replans": []}
    for half in range(2):
        batches = [pad_batch(cfg, reqs[(half * 16 + i) * 32:
                                      (half * 16 + i + 1) * 32], 32)
                   for i in range(16)]
        t = time.perf_counter()
        for bt in batches:
            b.observe(bt)
        observe_ms = (time.perf_counter() - t) * 1e3 / len(batches)
        probe = torch.cat([bt["indices"] for bt in batches]).reshape(-1, 1, 1)
        bags = torch.cat([bt["indices"] for bt in batches])
        before = eng.lookup(b.state, probe)
        bags_before = eng.lookup(b.state, bags)
        dense_before = eng.to_dense(b.state)
        hot_before = host(b.state.page_to_shard) == HOT_SHARD
        torch.cuda.synchronize()
        t = time.perf_counter()
        table, stats = plan(eng.cfg, b.state.page_table,
                            host(b.state.counts), eng.planner)
        plan_s = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t = time.perf_counter()
        b.state = eng.migrate(b.state, table)
        torch.cuda.synchronize()
        migrate_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        assert_equal(eng.lookup(b.state, probe), before,
                     f"rmc4 {storage} S={eng.cfg.n_shards} replan "
                     f"{half + 1}: probe lookups")
        assert_equal(eng.to_dense(b.state), dense_before,
                     f"rmc4 {storage} S={eng.cfg.n_shards} replan "
                     f"{half + 1}: dense table")
        bag_diff = (eng.lookup(b.state, bags) - bags_before).abs()
        flips = int((hot_before != (host(b.state.page_to_shard)
                                    == HOT_SHARD)).sum())
        rec = {"replan": half + 1, "observe_ms_per_batch": observe_ms,
               "plan_s": plan_s, "migrate_s": migrate_s,
               "resident_bytes": resident, "peak_bytes": peak,
               "migrate_extra_bytes": peak - resident,
               "tier_flips": flips,
               "bags_changed": int((bag_diff > 0).any(-1).sum()),
               "bags_max_abs_diff": float(bag_diff.max()),
               **{k: stats[k] for k in ("moved_pages", "hot_pages",
                                        "sticky_kept")}}
        out["replans"].append(rec)
        print(f"maintenance rmc4 {storage} n_shards={eng.cfg.n_shards}: "
              f"{json.dumps(rec)}", flush=True)
        del dense_before, before, bags_before
    return out


# --------------------------------------------------------- runtime phase
RT_SIZES, RT_SLO_MS, RT_QPS, RT_N = (8, 16, 32), 50.0, 200.0, 1024
RT_PIN = dict(base_s=2e-3, per_row_s=1e-4)   # the pinned service model
RT_ROWS = ("masked_sls", "dot_interaction", "fused_front_end",
           "masked_sls_dedup", "fused_front_end_dedup", "fused_partial_pool",
           "fused_partial_pool_dedup", "fused_resume")   # rows 1, 3-9


def runtime_run(cfg, storage="fp32", front_end="split", dedup="off",
                n_shards=1, impl="cuda", n=RT_N, qps=RT_QPS,
                arrival="poisson", poolings=(), users=0, pin=False) -> dict:
    """One ``run_offered_load`` on the card through the dynamic batcher
    (buckets of batch 8, 16 and 32, SLO 50 ms, observe every 4 batches,
    re-plan every 64), with measured service times, or with ``pin`` the
    pinned ``FixedServiceModel``.  Checks the run's counts and scores;
    returns its printed line, the scores by rid and the flush trace."""
    from repro_torch.launch import serve as srv
    from repro_torch.serving.batcher import FixedServiceModel
    from repro_torch.serving.loadgen import LoadConfig
    from repro_torch.serving.request import ArrivalConfig

    load = LoadConfig(n, ArrivalConfig(qps, process=arrival, seed=0),
                      slo_ms=RT_SLO_MS, poolings=poolings, seed=0,
                      storage=storage, dedup=dedup, front_end=front_end)
    t0 = time.perf_counter()
    rt, b = srv.build_serving(
        cfg, "cuda", impl=impl, batch_sizes=RT_SIZES, poolings=poolings,
        slo_ms=RT_SLO_MS, storage=storage, dedup=dedup, front_end=front_end,
        n_shards=n_shards, service=FixedServiceModel(**RT_PIN) if pin
        else None)
    s = srv.run_offered_load(rt, b, cfg, load, closed_loop_users=users)
    wall = time.perf_counter() - t0
    tag = (f"runtime {cfg.name} {storage} {front_end} dedup={dedup} "
           f"S={n_shards} impl={impl} {arrival} qps={qps:.0f} "
           f"users={users} pin={pin}")
    check(s["served"] == n and s["dropped"] == s["failed"] == 0,
          f"{tag}: served {s['served']} of {n}, dropped {s['dropped']}, "
          f"failed {s['failed']}")
    check(s["steady_traces"] == 0,
          f"{tag}: {s['steady_traces']} signatures new after warmup")
    check(s["batches"] < 64 or s["replans"] >= 1,
          f"{tag}: {s['batches']} batches and no re-plan")
    scores = np.asarray([rt.executor.scores[i] for i in range(n)],
                        np.float32)
    check(bool(np.isfinite(scores).all() and (scores > 0).all()
               and (scores < 1).all()), f"{tag}: scores not finite in (0, 1)")
    line = {"arch": cfg.name, "storage": storage, "front_end": front_end,
            "dedup": dedup, "n_shards": n_shards, "impl": impl,
            "arrival": arrival, "offered_qps": qps, "users": users,
            "poolings": list(poolings) or [cfg.pooling], "requests": n,
            "pinned": pin,
            **{k: s[k] for k in ("served", "batches", "p50_ms", "p99_ms",
                                 "p99.9_ms", "qps", "goodput_qps",
                                 "slo_violation_rate",
                                 "batch_occupancy_mean", "queue_wait_p99_ms",
                                 "bucket_mix", "replans", "steady_traces",
                                 "warmup_service_ms", "maintenance_s")},
            "service_ms": {f"{k.batch}x{k.pooling}":
                           rt.service_model.estimate(k) * 1e3
                           for k in rt.batcher.buckets()},
            "wall_s": wall}
    trace = [(r.t, r.bucket.batch, r.bucket.pooling, r.n_real)
             for r in rt.metrics.batches]
    del rt, b
    torch.cuda.empty_cache()
    return {"line": line, "scores": scores, "trace": trace}


def runtime_phase() -> tuple:
    """Phase 8: ``serve_offered_load``'s path (``build_serving`` +
    ``run_offered_load``) on the card at RMC1 and RMC4's published widths,
    launch counts zeroed just before and read just after.  Measured runs:
    Poisson at 200 qps (fp32 and int8, split and fused), Poisson at half
    the rate the batch-32 bucket sustains (32 / its warmup service time;
    fp32 fused, 4096 requests), bursty MMPP-2 at 200 qps with poolings 2,
    4 and 8 (split and fused), 64 closed-loop users (fused); at RMC1 also
    dedup on (split and fused) and 4 shards fused, dedup off and on.
    Under one pinned ``FixedServiceModel``: the kernel path and the plain
    path give the same flush trace and scores within 1e-5, fused == split
    and dedup on == off bitwise per request."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    lines = []

    def measured(cfg, **kw):
        r = runtime_run(cfg, **kw)
        lines.append(r["line"])
        print("runtime " + json.dumps(r["line"]), flush=True)
        return r

    def same(a, b, what, bitwise=True):
        check(a["trace"] == b["trace"], f"{what}: flush traces differ")
        if bitwise:
            assert_equal(torch.from_numpy(a["scores"]),
                         torch.from_numpy(b["scores"]), what)
            return 0.0
        err = float(np.abs(a["scores"] - b["scores"]).max())
        check(err <= 1e-5, f"{what}: scores differ by {err:.3e} > 1e-5")
        return err

    t0 = time.perf_counter()
    build.reset_launches()
    for arch in ("rmc1", "rmc4"):
        cfg = get_config(arch)
        runs = {}
        for storage in ("fp32", "int8"):
            for fe in ("split", "fused"):
                runs[storage, fe] = measured(cfg, storage=storage,
                                             front_end=fe)
            pin = {fe: runtime_run(cfg, storage=storage, front_end=fe,
                                   pin=True) for fe in ("split", "fused")}
            plain = runtime_run(cfg, storage=storage, impl="torch", pin=True)
            same(pin["fused"], pin["split"],
                 f"runtime {arch} {storage}: fused vs split")
            err = same(pin["split"], plain,
                       f"runtime {arch} {storage}: kernel vs plain", False)
            print(f"runtime {arch} {storage}: pinned flush traces equal "
                  f"({len(plain['trace'])} batches); fused == split bitwise; "
                  f"kernel vs plain score err {err:.2e}", flush=True)
            if arch == "rmc1" and storage == "fp32":
                base = pin
        warm32 = runs["fp32", "fused"]["line"]["warmup_service_ms"][
            f"32x{cfg.pooling}"]
        rate = 0.5 * 32 / (warm32 * 1e-3)
        print(f"runtime {arch}: batch-32 warmup service {warm32:.4f} ms, "
              f"high load {rate:.0f} qps", flush=True)
        high = measured(cfg, front_end="fused", n=4 * RT_N, qps=rate)
        mix = high["line"]["bucket_mix"]
        check(any(not k.startswith("8x") for k in mix),
              f"runtime {arch} high load: no coalescing, {mix}")
        for fe in ("split", "fused"):
            measured(cfg, front_end=fe, arrival="bursty", poolings=(2, 4, 8))
        measured(cfg, front_end="fused", users=64)
        if arch != "rmc1":
            continue
        for fe in ("split", "fused"):
            measured(cfg, front_end=fe, dedup="on")
            same(runtime_run(cfg, front_end=fe, dedup="on", pin=True),
                 base[fe], f"runtime rmc1 {fe}: dedup on vs off")
        shards = {}
        for d in ("off", "on"):
            measured(cfg, front_end="fused", dedup=d, n_shards=TP)
            shards[d] = runtime_run(cfg, front_end="fused", dedup=d,
                                    n_shards=TP, pin=True)
        same(shards["on"], shards["off"],
             f"runtime rmc1 S={TP} fused: dedup on vs off")
        e4 = same(shards["off"], base["fused"],
                  f"runtime rmc1 fused: S={TP} vs one shard", False)
        print(f"runtime rmc1: dedup on == off bitwise (1 and {TP} shards); "
              f"{TP} shards vs one within {e4:.2e}", flush=True)
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    for k in RT_ROWS:
        check(launches[k] > 0, f"runtime phase: kernel {k} not launched")
    print(f"runtime phase: {len(lines)} measured runs in "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}",
          flush=True)
    return lines, launches


# ------------------------------------------------ streaming updates phase
UP_QPS, UP_BATCH, UP_CAP = 2000.0, 64, 256   # rows/s, rows per batch, chunk
# the pinned int8 runs' demote scans: two per run, a page qualifying after
# one row update (each moves ~0.1 of drift at D = 128), so that pages are
# demoted and each demote is fenced by a snapshot
UP_DEMOTE = {"demote_every": 64, "drift_threshold": 0.01}
UP_FIELDS = ("cold", "hot", "page_scales", "page_to_shard", "page_to_slot",
             "counts")


def fma_deltas(q, s, gen, tries=64):
    """Deltas (n, D) at which round((q * s + d) / s) with a multiply then an
    add gives another int8 code than with one fma, searched near each
    code's halfway points (elements with ``q * s`` exact in float32, such as
    q = 0, cannot differ and keep a small gaussian delta)."""
    from repro_torch.kernels.ref import fma_f32
    dev = q.device
    qf = q.float()
    s2 = s[:, None].expand_as(qf).contiguous()
    out = torch.randn(qf.shape, generator=gen, device=dev) * 0.01
    todo = torch.ones_like(qf, dtype=torch.bool)
    for _ in range(tries):
        k = (q.long() + torch.randint(-3, 4, q.shape, generator=gen,
                                      device=dev)).clamp(-120, 120)
        d = ((k.double() + 0.5 - qf.double()) * s2.double()).float()
        d = d * (1 + (torch.rand(q.shape, generator=gen, device=dev) - 0.5)
                 * 6e-7)
        mul = torch.round((qf * s2 + d) / s2).clamp(-127, 127)
        fma = torch.round(fma_f32(qf, s2, d) / s2).clamp(-127, 127)
        hit = todo & (mul != fma)
        out = torch.where(hit, d, out)
        todo &= ~hit
    return out


def delta_positions(eng, state, rows):
    """(is_hot, storage row in its tier) of host row ids (>= 0)."""
    from repro_torch.core.paging import HOT_SHARD, host
    c = eng.cfg
    ps = c.page_size
    page = rows // ps
    shard = host(state.page_to_shard)[page].astype(np.int64)
    local = host(state.page_to_slot)[page].astype(np.int64) * ps + rows % ps
    is_hot = shard == HOT_SHARD
    return is_hot, np.where(is_hot, local, shard * c.rows_per_shard + local)


def apply_deltas_checks(gen: torch.Generator) -> int:
    """The apply_deltas kernel against its plain version on the card,
    bitwise: fp32 and int8, D in {16, 18, 64, 128} (18: the scalar path),
    1 and 4 shards, a random hot set and an empty one, hot and cold rows,
    pads, zero-scale pages, int8 deltas at which a multiply then an add
    would give another code (the count the fma decides must be > 0), and
    an all-pad batch that leaves both tiers bitwise unchanged."""
    from repro_torch.core.pifs import engine_for_tables
    from repro_torch.core.updates import coalesce_deltas
    from repro_torch.kernels import ops

    n, decided = 0, 0
    for D in (16, 18, 64, 128):
        for storage in ("fp32", "int8"):
            for S in (1, 4):
                for hot in (True, False):
                    eng, _ = engine_for_tables(
                        [3000, 2000], D, device="cuda", hot_fraction=0.05,
                        storage=storage, n_shards=S)
                    c = eng.cfg
                    st = eng.init_state(gen)
                    if hot:
                        hp = torch.randperm(c.num_pages, generator=gen,
                                            device="cuda")[:c.hot_pages]
                        st.page_to_shard[hp] = -1
                        st.page_to_slot[hp] = torch.arange(
                            hp.numel(), device="cuda", dtype=torch.int32)
                    st.hot.normal_(generator=gen)
                    st.hot[0, :2] = -0.0
                    cold_pages = torch.nonzero(st.page_to_shard >= 0)[:, 0]
                    st.page_scales[cold_pages[:3]] = 0.0
                    g = np.random.default_rng(D * 10 + S)
                    rows, d = coalesce_deltas(
                        g.integers(-3, c.padded_rows, 400),
                        g.normal(size=(400, D)).astype(np.float32) * 0.01)
                    rows, d = rows[:UP_CAP], d[:UP_CAP]
                    pad = UP_CAP - rows.size
                    rows = np.concatenate([rows, np.full(pad, -1, np.int32)])
                    d = np.concatenate([d, np.zeros((pad, D), np.float32)])
                    dt = torch.as_tensor(d, device="cuda")
                    is_hot, pos = delta_positions(eng, st,
                                                  np.maximum(rows, 0))
                    sc = st.page_scales[torch.as_tensor(
                        np.maximum(rows, 0) // c.page_size, device="cuda")]
                    sel = np.nonzero((rows >= 0) & ~is_hot)[0]
                    selt = torch.as_tensor(sel, device="cuda")
                    post = torch.as_tensor(pos[sel], device="cuda")
                    if storage == "int8":
                        live = sc[selt] > 0
                        q = st.cold[post[live]]
                        dt[selt[live]] = fma_deltas(q, sc[selt][live], gen)
                        before = st.cold[post].float()
                    rt = torch.as_tensor(rows, device="cuda")
                    tiers = [(st.cold.clone(), st.hot.clone())
                             for _ in range(2)]
                    common = (st.page_scales, st.page_to_shard,
                              st.page_to_slot, rt, dt, c.page_size,
                              c.rows_per_shard)
                    ops.apply_deltas(*tiers[0], *common)
                    ops.apply_deltas(*tiers[1], *common, impl="torch")
                    tag = f"apply_deltas D={D} {storage} S={S} hot={hot}"
                    assert_equal(tiers[0][0], tiers[1][0], f"{tag} cold")
                    assert_equal(tiers[0][1], tiers[1][1], f"{tag} hot")
                    if storage == "int8":
                        s2 = sc[selt][:, None]
                        mul = torch.round((before * s2 + dt[selt]) / s2
                                          ).clamp(-127, 127)
                        after = tiers[0][0][post].float()
                        live2 = (s2 > 0).expand_as(mul)
                        decided += int(((mul != after) & live2).sum())
                    # an all-pad batch writes nothing
                    keep = [x.clone() for x in tiers[0]]
                    ops.apply_deltas(*tiers[0], *common[:3],
                                     torch.full_like(rt, -1), dt,
                                     *common[5:])
                    assert_equal(tiers[0][0], keep[0], f"{tag} all-pad cold")
                    assert_equal(tiers[0][1], keep[1], f"{tag} all-pad hot")
                    n += 1
    check(decided > 0, "apply_deltas: no element where the fma decides")
    torch.cuda.synchronize()
    print(f"apply_deltas kernel checks: {n} cases bitwise equal to the "
          f"plain version; {decided} int8 codes where a multiply then an "
          f"add would differ", flush=True)
    return n


def apply_deltas_timing(b, batches, timer: Timer, arch: str,
                        storage: str) -> dict:
    """The kernel at one full chunk (``UP_CAP`` unique rows of the update
    stream) on the serving state, its plain version, and (fp32) the
    library's ``index_add_`` per tier on precomputed addresses; first the
    kernel against the plain version on the same rows, bitwise."""
    from repro_torch.core.updates import coalesce_deltas
    from repro_torch.kernels import ops
    eng, st = b.engine, b.state
    c = eng.cfg
    rows, d = coalesce_deltas(np.concatenate([x.rows for x in batches]),
                              np.concatenate([x.deltas for x in batches]))
    rows, d = rows[:UP_CAP], d[:UP_CAP]
    U = rows.size
    is_hot, pos = delta_positions(eng, st, rows.astype(np.int64))
    rt = torch.as_tensor(rows, device="cuda")
    dt = torch.as_tensor(d, device="cuda")
    hp = torch.as_tensor(pos[is_hot], device="cuda")
    cp = torch.as_tensor(pos[~is_hot], device="cuda")
    hmask = torch.as_tensor(is_hot, device="cuda")
    common = (st.page_scales, st.page_to_shard, st.page_to_slot, rt, dt,
              c.page_size, c.rows_per_shard)

    def kernel():
        ops.apply_deltas(st.cold, st.hot, *common)

    def plain():
        ops.apply_deltas(st.cold, st.hot, *common, impl="torch")

    saved = (st.cold[cp].clone(), st.hot[hp].clone())
    kernel()
    got = (st.cold[cp].clone(), st.hot[hp].clone())
    st.cold[cp], st.hot[hp] = saved
    plain()
    assert_equal(got[0], st.cold[cp], f"apply_deltas {arch} {storage} cold")
    assert_equal(got[1], st.hot[hp], f"apply_deltas {arch} {storage} hot")
    err = max([float((g.float() - w.float()).abs().max())
               for g, w in zip(got, (st.cold[cp], st.hot[hp]))
               if g.numel()] or [0.0])
    lib = None
    if storage == "fp32":
        dh, dc = dt[hmask], dt[~hmask]

        def lib():
            st.cold.index_add_(0, cp, dc)
            st.hot.index_add_(0, hp, dh)
    n_hot, n_cold = int(is_hot.sum()), int((~is_hot).sum())
    D = c.dim
    cs = st.cold.element_size()
    nbytes = (n_hot * D * 8 + n_cold * D * cs * 2 + U * D * 4 + U * 4
              + U * 8 + (n_cold * 4 if storage == "int8" else 0))
    flops = n_hot * D + n_cold * D * (4 if storage == "int8" else 1)
    row = {"name": "apply_deltas", "arch": arch,
           "storage": storage, "rows": U, "hot_rows": n_hot, "dim": D,
           "n_shards": c.n_shards, "max_abs_err": err, "ms": timer(kernel),
           "plain_ms": timer(plain),
           "library_ms": None if lib is None else timer(lib),
           **bound(nbytes, flops)}
    return row


def corrupt_state(state, gen) -> None:
    """Overwrite both tiers with garbage (NaN hot rows; random codes or
    values): what a restore must undo."""
    state.hot.fill_(float("nan"))
    if state.cold.dtype == torch.int8:
        state.cold.copy_(torch.randint(-127, 128, state.cold.shape,
                                       generator=gen, device="cuda",
                                       dtype=torch.int8))
    else:
        state.cold.normal_(generator=gen)


def updates_run(cfg, storage, impl="cuda", pin=False, ckpt=True,
                demote=None) -> dict:
    """``serve_offered_load``'s path with a live update stream on the card:
    ``build_serving`` + a ``StreamingUpdater`` over ``update_stream``
    (``UP_QPS`` rows/s in batches of ``UP_BATCH``, chunks of ``UP_CAP``;
    int8 also requant-demote scans, every 8 applied batches under the
    reference's default drift knobs, or as ``demote`` sets them) with a
    WAL and, with ``ckpt`` (always at int8: a demote is fenced by a
    snapshot), a checkpointer, both in a temp dir removed after, then
    ``run_offered_load`` and a final ``drain``.  Checks the counts; returns
    the printed line, the flush trace, the final state and the stream."""
    import os
    import shutil
    import tempfile
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.checkpoint.wal import WriteAheadLog
    from repro_torch.core.updates import UpdateConfig
    from repro_torch.launch import serve as srv
    from repro_torch.serving.batcher import FixedServiceModel
    from repro_torch.serving.loadgen import LoadConfig, update_stream
    from repro_torch.serving.request import ArrivalConfig
    from repro_torch.serving.updates import StreamingUpdater

    tmp = tempfile.mkdtemp(prefix="chip_smoke_updates_")
    try:
        load = LoadConfig(RT_N, ArrivalConfig(RT_QPS, seed=0),
                          slo_ms=RT_SLO_MS, seed=0, storage=storage,
                          update_qps=UP_QPS, update_batch=UP_BATCH)
        t0 = time.perf_counter()
        rt, b = srv.build_serving(
            cfg, "cuda", impl=impl, batch_sizes=RT_SIZES, slo_ms=RT_SLO_MS,
            storage=storage, service=FixedServiceModel(**RT_PIN) if pin
            else None)
        batches = update_stream(cfg, load)
        knobs = demote or {"demote_every": 8}
        updater = StreamingUpdater(
            b, batches, UpdateConfig(capacity=UP_CAP, **(
                knobs if storage == "int8" else {})),
            wal=WriteAheadLog(os.path.join(tmp, "u.wal")))
        snap = None
        if ckpt or storage == "int8":
            t1 = time.perf_counter()
            b.attach_checkpointer(Checkpointer(os.path.join(tmp, "ck"),
                                               keep=1))
            snap = {"snapshot_s": time.perf_counter() - t1,
                    "snapshot_bytes": int(sum(
                        getattr(b.state, f).nbytes for f in UP_FIELDS)),
                    "free_disk_bytes": shutil.disk_usage(tmp).free}
        s = srv.run_offered_load(rt, b, cfg, load, updater=updater)
        t1 = time.perf_counter()
        tail = updater.drain()
        drain_s = time.perf_counter() - t1
        rep = updater.report()
        wall = time.perf_counter() - t0
        tag = (f"updates {cfg.name} {storage} impl={impl} pin={pin}")
        check(s["served"] == RT_N and s["dropped"] == s["failed"] == 0,
              f"{tag}: served {s['served']} of {RT_N}")
        check(s["steady_traces"] == 0,
              f"{tag}: {s['steady_traces']} signatures new after warmup")
        check(rep["applied_batches"] == rep["generated_batches"] ==
              len(batches) and rep["pending_batches"] == 0,
              f"{tag}: {rep}")
        committed = (b.checkpointer.extra()["update_seq"]
                     if b.checkpointer is not None else 0)
        check(rep["wal_records"] == rep["update_seq"] - committed
              and (rep["snapshots"] > 0
                   or rep["wal_records"] == rep["applied_batches"]),
              f"{tag}: WAL holds {rep['wal_records']} records, "
              f"{rep['applied_batches']} applied, seq {committed} "
              f"committed: {rep}")
        check(s["maintenance_calls"].get("updates", 0) > 0,
              f"{tag}: no update drain on the maintenance seam")
        stale = s["staleness"]
        calls = s["maintenance_calls"]["updates"]
        line = {"arch": cfg.name, "storage": storage, "impl": impl,
                "pinned": pin, "requests": RT_N, "offered_qps": RT_QPS,
                "update_qps": UP_QPS, "update_batch": UP_BATCH,
                "capacity": UP_CAP,
                **{k: s[k] for k in ("served", "batches", "p50_ms", "p99_ms",
                                     "p99.9_ms", "qps", "bucket_mix",
                                     "replans", "steady_traces",
                                     "maintenance_calls", "maintenance_s")},
                "staleness": {k: stale[k] for k in (
                    "rows_behind_p50", "rows_behind_p99",
                    "seconds_behind_p50", "seconds_behind_p99")},
                "updates_mean_ms": s["maintenance_s"]["updates"] / calls
                * 1e3,
                "updates": rep, "run_batches_applied": s["updates"][
                    "applied_batches"], "drained_tail": tail,
                "drain_s": drain_s, **(snap or {}), "wall_s": wall}
        trace = [(r.t, r.bucket.batch, r.bucket.pooling, r.n_real)
                 for r in rt.metrics.batches]
        return {"line": line, "trace": trace, "binding": b,
                "batches": batches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def durability_run(cfg, storage, gen) -> dict:
    """Snapshot -> 3 update batches -> both tiers corrupted -> ``restore``
    (the checkpoint, then the WAL's suffix): state and scores bitwise as
    before the corruption, ``update_seq`` 3, no new signature.  Times the
    snapshot, the restore and (again, after the checks) the replay of the
    3 batches alone."""
    import os
    import shutil
    import tempfile
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.checkpoint.wal import WriteAheadLog
    from repro_torch.serving import loadgen
    from repro_torch.serving.request import ArrivalConfig

    tmp = tempfile.mkdtemp(prefix="chip_smoke_durability_")
    try:
        reqs = stream(cfg, 64, 0, storage)
        b = loadgen.bind_model(cfg, "cuda", storage=storage, seed=0,
                               profile=reqs)
        batches = loadgen.update_stream(cfg, loadgen.LoadConfig(
            RT_N, ArrivalConfig(RT_QPS, seed=0), seed=0, storage=storage,
            update_qps=UP_QPS, update_batch=UP_BATCH))[:3]
        b.attach_wal(WriteAheadLog(os.path.join(tmp, "u.wal")))
        t0 = time.perf_counter()
        b.attach_checkpointer(Checkpointer(os.path.join(tmp, "ck"), keep=1))
        snapshot_s = time.perf_counter() - t0
        for x in batches:
            b.apply_deltas(x.rows, x.deltas)
        batch = pad_batch(cfg, reqs[:32], 32)
        want = {f: getattr(b.state, f).clone() for f in UP_FIELDS}
        scores = b.execute(batch).clone()
        b.reset_plan_stats()
        corrupt_state(b.state, gen)
        check(not torch.equal(b.state.cold, want["cold"]),
              f"durability {cfg.name} {storage}: corruption changed nothing")
        t0 = time.perf_counter()
        b.restore()
        restore_s = time.perf_counter() - t0
        tag = f"durability {cfg.name} {storage}"
        for f in UP_FIELDS:
            assert_equal(getattr(b.state, f), want[f], f"{tag}: {f}")
        assert_equal(b.execute(batch), scores, f"{tag}: scores")
        check(b.update_seq == 3, f"{tag}: update_seq {b.update_seq}")
        check(b.plan_stats()["traces"] == 0, f"{tag}: a new signature")
        t0 = time.perf_counter()
        replayed = b.replay_wal(after_seq=0)
        replay_s = time.perf_counter() - t0
        check(replayed == 3, f"{tag}: replayed {replayed} of 3")
        return {"arch": cfg.name, "storage": storage, "check": "bitwise",
                "snapshot_bytes": int(sum(want[f].nbytes for f in UP_FIELDS)),
                "snapshot_s": snapshot_s, "restore_s": restore_s,
                "replay_batches": replayed, "replay_s": replay_s}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def updates_phase(gen: torch.Generator) -> tuple:
    """Phase 9: streaming updates on the card at RMC4's published widths,
    fp32 and int8 (``updates_run``), launch counts zeroed just before the
    measured runs and read just after (``apply_deltas`` must have run);
    under the pinned service model the kernel path and the plain path give
    identical flush traces and bitwise-equal final states (int8 with
    ``UP_DEMOTE``'s scans, which demote pages and fence each demote with a
    snapshot); the kernel timed at one full chunk; durability round trips
    at RMC4 int8 and RMC1 fp32."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    cfg = get_config("rmc4")
    lines, timing = [], []
    build.reset_launches()
    for storage in ("fp32", "int8"):
        r = updates_run(cfg, storage)
        lines.append(r["line"])
        print("updates " + json.dumps(r["line"]), flush=True)
        del r
        torch.cuda.empty_cache()
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    check(launches["apply_deltas"] > 0,
          "updates phase: kernel apply_deltas not launched")
    timer = Timer()
    for storage in ("fp32", "int8"):
        k = updates_run(cfg, storage, pin=True, ckpt=False, demote=UP_DEMOTE)
        kb = k.pop("binding")
        p = updates_run(cfg, storage, impl="torch", pin=True, ckpt=False,
                        demote=UP_DEMOTE)
        pb = p.pop("binding")
        tag = f"updates rmc4 {storage}: kernel vs plain"
        check(k["trace"] == p["trace"], f"{tag}: flush traces differ")
        check(k["line"]["updates"] == p["line"]["updates"],
              f"{tag}: reports differ")
        check(storage == "fp32" or k["line"]["updates"]["demoted_pages"] > 0,
              f"{tag}: no page demoted")
        for f in UP_FIELDS:
            assert_equal(getattr(kb.state, f), getattr(pb.state, f),
                         f"{tag}: {f}")
        print(f"{tag}: flush traces equal ({len(k['trace'])} batches), "
              f"final states bitwise equal; report "
              f"{json.dumps(k['line']['updates'])}", flush=True)
        del pb, p
        torch.cuda.empty_cache()
        timing.append(apply_deltas_timing(kb, k["batches"], timer,
                                          cfg.name, storage))
        del kb, k
        torch.cuda.empty_cache()
    del timer
    dur = [durability_run(get_config("rmc4"), "int8", gen),
           durability_run(get_config("rmc1"), "fp32", gen)]
    for d in dur:
        print("updates " + json.dumps({"durability": d}), flush=True)
    print(f"updates phase: {len(lines)} measured runs in "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}",
          flush=True)
    return lines, timing, dur, launches


# ------------------------------------------------------ integrity phase
SCRUB_SWEEP = 4          # the scrub window covers the store in 4 batches
SCRUB_FLIPS = dict(bit_flip_at=(3, 11, 29, 57, 97), bit_flip_rows=2,
                   bit_flip_tier="both", seed=7)


def _u64(cs: np.ndarray) -> np.ndarray:
    cs = cs.astype(np.uint64)
    return (cs[:, 1] << np.uint64(32)) | cs[:, 0]


def checksum_bytes(eng, st, pages: torch.Tensor) -> int:
    """What a ``page_checksums`` call over ``pages`` must move: each listed
    page's lanes in its tier once (cold codes or values, hot fp32), its
    page-table entries and scale, the page id, 16 bytes out."""
    from repro_torch.core.paging import HOT_SHARD
    c = eng.cfg
    valid = pages[pages >= 0].long()
    n_hot = int((st.page_to_shard[valid] == HOT_SHARD).sum())
    lanes = c.page_size * c.dim
    return (n_hot * lanes * 4 + (valid.numel() - n_hot) * lanes
            * st.cold.element_size() + valid.numel() * 12
            + pages.numel() * (4 + 16))


def checksum_edge_checks(gen: torch.Generator) -> int:
    """The page_checksums kernel on its own at shapes no RMC4 store gives:
    D = 18 with 5-row pages (90 lanes: no page spans whole 16-byte chunks,
    so both scalar instantiations run) and D = 16 with 8-row pages (the
    16-byte path); fp32 and int8, 1 and 4 shards, a hot tier.  Each page
    list holds every page in a shuffled order, pads (-1) and ids past the
    end (P, P + 5: the clamp to the last page).  Bitwise equal to the
    plain version; pads are zero, a clamped id equals the last page."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.integrity import vec_pages

    n_cases = 0
    for storage in ("fp32", "int8"):
        for S in (1, TP):
            for D, ps, vec in ((18, 5, 0), (16, 8, 1)):
                cold_slots, n_hot = 24, 8             # pages per shard, hot
                P = S * cold_slots - 5 + n_hot        # a few slots unused
                perm = torch.randperm(P, generator=gen, device="cuda")
                p2s = torch.empty(P, dtype=torch.int32, device="cuda")
                slot = torch.empty(P, dtype=torch.int32, device="cuda")
                p2s[perm[:n_hot]] = -1                # paging.HOT_SHARD
                slot[perm[:n_hot]] = torch.arange(
                    n_hot, dtype=torch.int32, device="cuda")
                rest = torch.arange(P - n_hot, dtype=torch.int32,
                                    device="cuda")
                p2s[perm[n_hot:]] = rest % S
                slot[perm[n_hot:]] = rest // S
                rps = cold_slots * ps
                if storage == "int8":
                    cold = torch.randint(-127, 128, (S * rps, D),
                                         generator=gen, device="cuda",
                                         dtype=torch.int8)
                else:
                    cold = torch.randn((S * rps, D), generator=gen,
                                       device="cuda")
                hot = torch.randn((n_hot * ps, D), generator=gen,
                                  device="cuda")
                scales = torch.rand(P, generator=gen, device="cuda") + 0.01
                pages = torch.cat([
                    torch.randperm(P, generator=gen, device="cuda"),
                    torch.tensor([-1, P, P + 5, -1, P - 1],
                                 device="cuda")]).to(torch.int32)
                tag = f"page_checksums edge {storage} S={S} D={D} ps={ps}"
                check(vec_pages(ps, D, cold, hot) == vec,
                      f"{tag}: vec_pages is not {vec}")
                args = (cold, hot, scales, p2s, slot, pages, ps, rps)
                got = ops.page_checksums(*args)
                assert_equal(got, ops.page_checksums(*args, impl="torch"),
                             tag)
                check(bool((got[[P, P + 3]] == 0).all()),
                      f"{tag}: a pad is not zero")
                check(bool((got[[P + 1, P + 2]] == got[P + 4]).all()),
                      f"{tag}: an id past the end is not the last page")
                n_cases += 1
    return n_cases


SCRUB_AIMED = 2          # flips aimed at pages updated since the snapshot


class AimedFlips:
    """The run's ``StreamingUpdater``, and after its turn of the
    maintenance seam a one-bit flip in a row the update stream changed
    since the binding's last snapshot (read from the WAL), on a page the
    scrubber audits next, up to ``SCRUB_AIMED`` flips from the second
    sweep on.  Each such page's repair must replay its WAL tail (through
    the ``apply_deltas`` kernel) to come back bitwise.  The scrubber is
    read from ``runtime`` at each turn (``run_offered_load`` arms it
    after the updater); the flip's cost is not in the drain time
    returned."""

    def __init__(self, updater, runtime, seed: int = 11):
        self.inner, self.runtime = updater, runtime
        self.rng = np.random.default_rng(seed)
        self.turns = 0
        self.events = []         # [{turn, page, row, col, wal_seq_from}]

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def on_batch(self, now: float, metrics=None) -> float:
        dt = self.inner.on_batch(now, metrics)
        self.turns += 1
        scrub = self.runtime.scrubber
        if (scrub is not None and len(self.events) < SCRUB_AIMED
                and self.turns > SCRUB_SWEEP):
            self._aim(scrub)
        return dt

    def _aim(self, scrub) -> None:
        from repro_torch.core.paging import HOT_SHARD

        b = self.inner.binding
        c = b.engine.cfg
        snap_seq = int(b.checkpointer.extra().get("update_seq", 0))
        if b.update_seq <= snap_seq:
            return
        rows = np.concatenate([r for seq, r, _ in b.wal.replay()
                               if seq > snap_seq])
        rows = rows[rows >= 0].astype(np.int64)
        page = rows // c.page_size
        done = [e["page"] for e in self.events]
        keep = ((page - scrub.cursor) % c.num_pages < scrub.window) \
            & ~np.isin(page, done)
        if not keep.any():
            return
        row = int(rows[keep][0])
        page = row // c.page_size
        shard = int(b.state.page_to_shard[page])
        pos = int(b.state.page_to_slot[page]) * c.page_size \
            + row % c.page_size
        tier = b.state.hot if shard == HOT_SHARD else b.state.cold
        if shard != HOT_SHARD:
            pos += shard * c.rows_per_shard
        col = int(self.rng.integers(0, c.dim))
        if tier.dtype == torch.int8:
            view, bit = tier.view(torch.uint8), int(self.rng.integers(0, 8))
        else:
            view, bit = tier.view(torch.int32), int(self.rng.integers(0, 23))
        view[pos, col] ^= 1 << bit
        self.events.append({"turn": self.turns, "page": page, "row": row,
                            "col": col, "wal_seq_from": snap_seq + 1})


def integrity_kernel_checks(gen: torch.Generator, timer: Timer) -> list:
    """The ``page_checksums`` kernel on whole RMC4 stores (fp32 and int8,
    1 and 4 shards, a hot tier placed from a profile): bitwise equal to
    its plain version on every page and on pad entries, equal to
    ``page_checksum_host`` on every page; the 4-shard store's checksums
    equal the 1-shard store's on every page both hold in the same tier
    (the same content).  Times the kernel over the whole store and over a
    64-page window (CUDA events, L2 flushed), the plain version over the
    whole store, and, on the host clock, a whole-store ledger build and
    ``verify``, and the ledger's ``export`` (the manifest payload)."""
    from repro_torch.configs import get_config
    from repro_torch.core.integrity import (PageChecksumLedger,
                                            page_checksum_host)
    from repro_torch.core.paging import HOT_SHARD
    from repro_torch.kernels import ops
    from repro_torch.serving import loadgen

    cfg = get_config("rmc4")
    rows = []
    for storage in ("fp32", "int8"):
        one = None
        for S in (1, TP):
            t0 = time.perf_counter()
            b = loadgen.bind_model(cfg, "cuda", storage=storage, n_shards=S,
                                   profile=stream(cfg, 64, 0, storage))
            eng, st = b.engine, b.state
            c = eng.cfg
            P = c.num_pages
            pages = torch.cat([torch.arange(P, dtype=torch.int32,
                                            device="cuda"),
                               torch.tensor([-1, -1, -1], dtype=torch.int32,
                                            device="cuda")])
            common = (st.cold, st.hot, st.page_scales, st.page_to_shard,
                      st.page_to_slot)
            geo = (c.page_size, c.rows_per_shard)
            got = ops.page_checksums(*common, pages, *geo)
            want = ops.page_checksums(*common, pages, *geo, impl="torch")
            tag = f"page_checksums rmc4 {storage} S={S}"
            assert_equal(got, want, tag)
            check(bool((got[P:] == 0).all()), f"{tag}: a pad is not zero")
            cs = _u64(got[:P].cpu().numpy())
            cold, hot = st.cold.cpu().numpy(), st.hot.cpu().numpy()
            p2s = st.page_to_shard.cpu().numpy()
            slot = st.page_to_slot.cpu().numpy().astype(np.int64)
            scales = st.page_scales.cpu().numpy()
            ps = c.page_size
            for p in range(P):
                first = slot[p] * ps
                if p2s[p] == HOT_SHARD:
                    page_rows = hot[first:first + ps]
                else:
                    first += int(p2s[p]) * c.rows_per_shard
                    page_rows = cold[first:first + ps]
                if page_checksum_host(page_rows, scales[p]) != int(cs[p]):
                    fail(f"{tag}: page {p} differs from page_checksum_host")
            del cold, hot
            hot_mask = p2s == HOT_SHARD
            if one is None:
                one = (cs, hot_mask)
            else:
                same = hot_mask == one[1]
                check(bool((cs[same] == one[0][same]).all())
                      and same.mean() > 0.9,
                      f"{tag}: checksums differ from one shard's on pages "
                      f"in the same tier ({same.mean():.4f} of pages)")
            check_s = time.perf_counter() - t0
            window = pages[P // 3:P // 3 + 64].contiguous()
            whole = pages[:P].contiguous()
            nbytes = checksum_bytes(eng, st, whole)
            wbytes = checksum_bytes(eng, st, window)
            lanes = c.page_size * c.dim
            row = {"name": "page_checksums", "arch": "rmc4",
                   "storage": storage, "n_shards": S, "pages": P,
                   "hot_pages": int(hot_mask.sum()), "check": "bitwise",
                   "host_twin_pages": P, "check_s": check_s,
                   "max_abs_err": float((got - want).abs().max()),
                   "ms": timer(lambda: ops.page_checksums(*common, whole,
                                                          *geo)),
                   **bound(nbytes, 3 * P * lanes),
                   "window_ms": timer(lambda: ops.page_checksums(
                       *common, window, *geo)),
                   "window_bound_ms": bound(wbytes, 3 * 64 * lanes)[
                       "bound_ms"],
                   "library_ms": None}
            # write_page (plain PyTorch: host lookups, two slice copies) of
            # a cold page's own content, beside the slice copy alone
            cold_pages = np.nonzero(~hot_mask)[0]
            wp = int(cold_pages[cold_pages.size // 2])
            first = (int(p2s[wp]) * c.rows_per_shard
                     + int(slot[wp]) * c.page_size)
            dst = st.cold[first:first + c.page_size]
            src = dst.clone()
            zeros = torch.zeros((c.page_size, c.dim), device="cuda")
            row["write_page_ms"] = timer(lambda: eng.write_page(
                st, wp, src, zeros, float(scales[wp])))
            row["write_page_copy_ms"] = timer(lambda: dst.copy_(src))
            row["write_page_bound_ms"] = bound(
                2 * src.numel() * src.element_size() + 12, 0)["bound_ms"]
            assert_equal(dst, src, f"{tag}: write_page of a page's content")
            if S == 1:
                slow = Timer(reps=3)
                row["plain_ms"] = slow(lambda: ops.page_checksums(
                    *common, whole, *geo, impl="torch"))
                del slow
            walls = {"build_s": [], "verify_s": [], "export_s": []}
            for _ in range(3):
                t1 = time.perf_counter()
                led = PageChecksumLedger.build(eng, st)
                walls["build_s"].append(time.perf_counter() - t1)
                t1 = time.perf_counter()
                bad = led.verify(st)
                walls["verify_s"].append(time.perf_counter() - t1)
                check(bad.size == 0, f"{tag}: verify found {bad.size} pages")
                t1 = time.perf_counter()
                exported = led.export()
                walls["export_s"].append(time.perf_counter() - t1)
            row.update({k: statistics.median(v) for k, v in walls.items()})
            row["export_json_bytes"] = len(json.dumps(exported))
            rows.append(row)
            print(f"{tag}: bitwise equal to the plain version on {P} pages "
                  f"and 3 pads, to page_checksum_host on every page; "
                  f"{json.dumps(row)}", flush=True)
            del b, eng, st, common, got, want, led, exported
            torch.cuda.empty_cache()
    return rows


def scrub_run(cfg, storage, impl="cuda", pin=False, flips=True,
              scrub=True) -> dict:
    """``serve_offered_load``'s path with a live update stream (as phase 9),
    a WAL and, with ``scrub``, the integrity regime: the checksum ledger, a
    checkpointer in a temp dir (removed after) and a ``ScrubController``
    whose window sweeps the store every ``SCRUB_SWEEP`` batches; with
    ``flips``, ``SCRUB_FLIPS``' seeded bit flips land in live pages while
    the run serves, and with both, ``AimedFlips`` lands ``SCRUB_AIMED``
    more in rows updated since the snapshot, whose repairs must replay the
    WAL tail.  Returns the printed line, the flush trace and the
    binding."""
    import math
    import os
    import shutil
    import tempfile
    from repro_torch.checkpoint.wal import WriteAheadLog
    from repro_torch.core.updates import UpdateConfig
    from repro_torch.launch import serve as srv
    from repro_torch.serving.batcher import FixedServiceModel
    from repro_torch.serving.faults import FaultConfig
    from repro_torch.serving.loadgen import LoadConfig, update_stream
    from repro_torch.serving.request import ArrivalConfig
    from repro_torch.serving.scrub import ScrubConfig
    from repro_torch.serving.updates import StreamingUpdater

    tmp = tempfile.mkdtemp(prefix="chip_smoke_scrub_")
    try:
        load = LoadConfig(RT_N, ArrivalConfig(RT_QPS, seed=0),
                          slo_ms=RT_SLO_MS, seed=0, storage=storage,
                          update_qps=UP_QPS, update_batch=UP_BATCH)
        t0 = time.perf_counter()
        rt, b = srv.build_serving(
            cfg, "cuda", impl=impl, batch_sizes=RT_SIZES, slo_ms=RT_SLO_MS,
            storage=storage, service=FixedServiceModel(**RT_PIN) if pin
            else None)
        updater = StreamingUpdater(
            b, update_stream(cfg, load), UpdateConfig(capacity=UP_CAP),
            wal=WriteAheadLog(os.path.join(tmp, "u.wal")))
        window = math.ceil(b.engine.cfg.num_pages / SCRUB_SWEEP)
        aimed = AimedFlips(updater, rt) if flips and scrub else None
        s = srv.run_offered_load(
            rt, b, cfg, load, updater=aimed or updater,
            scrub=ScrubConfig(pages_per_cycle=window) if scrub else None,
            scrub_dir=os.path.join(tmp, "ck"),
            faults=FaultConfig(**SCRUB_FLIPS) if flips else None)
        updater.drain()
        b._sync()
        wall = time.perf_counter() - t0
        tag = f"scrub {cfg.name} {storage} impl={impl} pin={pin} " \
              f"flips={flips}"
        check(s["served"] == RT_N and s["dropped"] == s["failed"] == 0,
              f"{tag}: served {s['served']} of {RT_N}")
        check(s["steady_traces"] == 0,
              f"{tag}: {s['steady_traces']} signatures new after warmup")
        line = {"arch": cfg.name, "storage": storage, "impl": impl,
                "pinned": pin, "flips": flips, "requests": RT_N,
                "offered_qps": RT_QPS, "update_qps": UP_QPS,
                **{k: s[k] for k in ("served", "batches", "p50_ms", "p99_ms",
                                     "p99.9_ms", "qps", "bucket_mix",
                                     "replans", "steady_traces",
                                     "maintenance_calls", "maintenance_s")},
                "wall_s": wall}
        flipped = []
        if flips:
            events = rt.executor.bit_flip_events
            flipped = {p for e in events for p in e["pages"]}
            check(len(events) == len(SCRUB_FLIPS["bit_flip_at"]),
                  f"{tag}: {len(events)} flip events")
            if aimed is not None:
                check(len(aimed.events) == SCRUB_AIMED,
                      f"{tag}: {len(aimed.events)} of {SCRUB_AIMED} aimed "
                      "flips found a page updated since the snapshot")
                flipped |= {e["page"] for e in aimed.events}
                line["aimed_flips"] = aimed.events
            flipped = sorted(flipped)
            line["flipped_pages"] = flipped
        if scrub:
            rep = s["scrub_run"]
            line["scrub_run"] = {k: rep[k] for k in (
                "cycles", "pages_per_cycle", "pages_audited",
                "pages_detected", "pages_repaired", "sweep_cycles",
                "sweeps_completed", "coverage", "quarantined")}
            line["repairs"] = rep["repairs"]
            for k in ("repair_mttr_mean_s", "repair_mttr_max_s"):
                line[k] = rep.get(k)
            line["scrub_mean_ms"] = (s["maintenance_s"]["scrub"]
                                     / s["maintenance_calls"]["scrub"] * 1e3)
            check(sorted(rep["detections"]) == flipped
                  and sorted({r["page"] for r in rep["repairs"]}) == flipped
                  and rep["quarantined"] == [],
                  f"{tag}: flipped {flipped}, scrub report {rep}")
            if aimed is not None:
                for e in aimed.events:
                    check(any(r["page"] == e["page"] and r["wal_batches"] > 0
                              for r in rep["repairs"]),
                          f"{tag}: aimed page {e['page']} repaired with no "
                          f"WAL batch replayed ({rep['repairs']})")
            check(b.integrity.verify(b.state).size == 0,
                  f"{tag}: the ledger disagrees with the store after the "
                  "run")
            if not pin:
                # a snapshot's cost with the ledger in its manifest, and
                # without it
                t1 = time.perf_counter()
                b.snapshot()
                line["snapshot_ledger_s"] = time.perf_counter() - t1
                line["manifest_bytes"] = len(json.dumps(
                    b.checkpointer.manifest()))
                ledger, b.integrity = b.integrity, None
                t1 = time.perf_counter()
                b.snapshot()
                line["snapshot_s"] = time.perf_counter() - t1
                b.integrity = ledger
        trace = [(r.t, r.bucket.batch, r.bucket.pooling, r.n_real)
                 for r in rt.metrics.batches]
        return {"line": line, "trace": trace, "binding": b}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def integrity_phase(gen: torch.Generator) -> tuple:
    """Phase 10: the ``page_checksums`` kernel at small edge shapes
    (``checksum_edge_checks``) and on whole RMC4 stores
    (``integrity_kernel_checks``); then ``serve_offered_load``'s path at
    RMC4 (fp32 and int8) with updates, a WAL, a checkpointer and the
    scrubber, seeded bit flips landing while it serves and flips aimed at
    pages with a WAL tail (``scrub_run``), launch counts zeroed just
    before and read just after: every flipped page detected and repaired,
    each aimed page through its WAL tail, none left quarantined; under the pinned
    service model the flipped-and-repaired run ends with ``cold``, ``hot``
    and ``page_scales`` equal to a twin run on the same stream without
    flips or scrubber."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    n_edge = checksum_edge_checks(gen)
    print(f"page_checksums: bitwise equal to the plain version in {n_edge} "
          "edge cases (scalar and 16-byte paths, pads, ids past the end)",
          flush=True)
    timer = Timer()
    rows = integrity_kernel_checks(gen, timer)
    del timer
    torch.cuda.empty_cache()
    cfg = get_config("rmc4")
    lines = []
    build.reset_launches()
    for storage in ("fp32", "int8"):
        r = scrub_run(cfg, storage)
        lines.append(r["line"])
        print("integrity " + json.dumps(r["line"]), flush=True)
        del r
        torch.cuda.empty_cache()
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    for k in ("page_checksums", "apply_deltas", "masked_sls",
              "dot_interaction"):
        check(launches[k] > 0, f"integrity phase: kernel {k} not launched")
    for storage in ("fp32", "int8"):
        k = scrub_run(cfg, storage, pin=True)
        kb = k.pop("binding")
        tw = scrub_run(cfg, storage, pin=True, flips=False, scrub=False)
        tb = tw.pop("binding")
        tag = f"integrity rmc4 {storage}: repaired vs unflipped twin"
        check(k["trace"] == tw["trace"], f"{tag}: flush traces differ")
        for f in ("cold", "hot", "page_scales"):
            assert_equal(getattr(kb.state, f), getattr(tb.state, f),
                         f"{tag}: {f}")
        wal = sum(r["wal_batches"] for r in k["line"]["repairs"])
        print(f"{tag}: flush traces equal ({len(k['trace'])} batches), "
              f"{len(k['line']['flipped_pages'])} flipped pages repaired "
              f"({wal} WAL batches replayed), cold/hot/page_scales bitwise "
              f"equal", flush=True)
        del kb, tb, k, tw
        torch.cuda.empty_cache()
    print(f"integrity phase: {len(lines)} measured runs in "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}",
          flush=True)
    return rows, lines, launches


# ---------------------------------------------------------- faults phase
def mesh_faults_run(cfg, storage) -> dict:
    """``serve_offered_load(mesh_faults=True)`` itself at RMC4 on 4 shards,
    fused, Poisson 200 qps: one re-mesh 4 -> 2, every request served or
    counted failed, no signature new after warmup."""
    from repro_torch.launch import serve as srv
    from repro_torch.serving.loadgen import LoadConfig
    from repro_torch.serving.request import ArrivalConfig

    load = LoadConfig(RT_N, ArrivalConfig(RT_QPS, seed=0), slo_ms=RT_SLO_MS,
                      seed=0, storage=storage, front_end="fused")
    t0 = time.perf_counter()
    s = srv.serve_offered_load(cfg, load, device="cuda",
                               batch_sizes=RT_SIZES, mesh_faults=True,
                               n_shards=TP)
    wall = time.perf_counter() - t0
    tag = f"faults {cfg.name} {storage} mesh_faults"
    rec = s["remesh"]
    check(s["served"] + s["failed"] == RT_N and s["dropped"] == 0,
          f"{tag}: {s['served']} served + {s['failed']} failed of {RT_N}")
    check(s["remeshes"] == 1 and rec["from_mesh"] == {"data": 1, "model": TP}
          and rec["to_mesh"] == {"data": 1, "model": 2},
          f"{tag}: re-mesh {rec}")
    check(s["steady_traces"] == 0,
          f"{tag}: {s['steady_traces']} signatures new after warmup")
    return {"arch": cfg.name, "storage": storage, "front_end": "fused",
            "n_shards": TP, "requests": RT_N, "offered_qps": RT_QPS,
            **{k: s[k] for k in ("served", "failed", "failed_batches",
                                 "retries", "batches", "p50_ms", "p99_ms",
                                 "p99.9_ms", "availability", "remeshes",
                                 "steady_traces", "faults_fired",
                                 "maintenance_s")},
            "remesh": rec, "degradation": {
                k: s["degradation"][k] for k in (
                    "rung", "n_transitions", "breaker_trips", "remeshes",
                    "straggler_trips")},
            "watchdog_trips": s["watchdog"]["trips"], "wall_s": wall}


def remesh_bitwise_run(cfg, storage) -> dict:
    """The same regime composed by hand (``build_serving(elastic=True)``,
    ``arm_mesh_faults``, ``run_offered_load(faults=...)``) under the pinned
    service model, then fixed batches through the recovered binding and
    through a fresh 2-shard binding packed from its export: bitwise
    equal scores."""
    from repro_torch.launch import serve as srv
    from repro_torch.serving import loadgen
    from repro_torch.serving.batcher import Bucket, FixedServiceModel
    from repro_torch.serving.faults import FaultConfig
    from repro_torch.serving.request import ArrivalConfig

    load = loadgen.LoadConfig(RT_N, ArrivalConfig(RT_QPS, seed=0),
                              slo_ms=RT_SLO_MS, seed=0, storage=storage,
                              front_end="fused")
    rt, b = srv.build_serving(
        cfg, "cuda", batch_sizes=RT_SIZES, slo_ms=RT_SLO_MS,
        storage=storage, front_end="fused", n_shards=TP, elastic=True,
        service=FixedServiceModel(**RT_PIN))
    srv.arm_mesh_faults(rt, b)
    s = srv.run_offered_load(rt, b, cfg, load,
                             faults=FaultConfig(seed=13, shard_loss_at=(2,)))
    tag = f"faults {cfg.name} {storage} pinned re-mesh"
    check(b.remeshes == 1 and b.engine.cfg.n_shards == 2
          and s["steady_traces"] == 0, f"{tag}: {s.get('remesh')}")
    fresh = loadgen.bind_model(cfg, "cuda", storage=storage,
                               front_end="fused", n_shards=2)
    fresh.model.load_state_dict(b.model.state_dict())
    codes, values, scales = b.engine.export_state(b.state)
    fresh.state = fresh.engine.pack_state(codes, values, scales,
                                          table=b.state.page_table,
                                          counts=b.state.counts)
    del codes, values, scales
    padder = loadgen.make_padder(cfg)
    reqs = stream(cfg, 64, 3, storage)
    n = 0
    for size in RT_SIZES:
        batch = padder(reqs[:size], Bucket(size, cfg.pooling))
        got, want = b.execute(batch), fresh.execute(batch)
        assert_equal(got, want, f"{tag}: batch {size}")
        check(bool(torch.isfinite(got).all()), f"{tag}: scores not finite")
        n += size
    out = {"arch": cfg.name, "storage": storage, "check": "bitwise",
           "scores_compared": n, "remesh": s["remesh"],
           "failed": s["failed"], "served": s["served"]}
    del rt, b, fresh
    torch.cuda.empty_cache()
    return out


def chaos_run(cfg, storage) -> dict:
    """Transient failures (bursts of 2 attempts) and stragglers (service
    times x 8) under the degradation controller and the watchdog, RMC4 on
    4 shards, fused: every request served or failed, finite scores."""
    from repro_torch.launch import serve as srv
    from repro_torch.serving.faults import FaultConfig
    from repro_torch.serving.loadgen import LoadConfig
    from repro_torch.serving.request import ArrivalConfig

    load = LoadConfig(RT_N, ArrivalConfig(RT_QPS, seed=0), slo_ms=RT_SLO_MS,
                      seed=0, storage=storage, front_end="fused")
    rt, b = srv.build_serving(cfg, "cuda", batch_sizes=RT_SIZES,
                              slo_ms=RT_SLO_MS, storage=storage,
                              front_end="fused", n_shards=TP, elastic=True)
    srv.arm_mesh_faults(rt, b)
    s = srv.run_offered_load(rt, b, cfg, load, faults=FaultConfig(
        seed=5, transient_prob=0.05, transient_runs=2, straggler_prob=0.05,
        straggler_factor=8.0))
    tag = f"faults {cfg.name} {storage} transient+straggler"
    scores = np.asarray([v for k, v in rt.executor.scores.items() if k >= 0],
                        np.float32)
    check(s["served"] + s["failed"] == RT_N and s["served"] > 0,
          f"{tag}: {s['served']} + {s['failed']} of {RT_N}")
    check(scores.size == s["served"] and bool(np.isfinite(scores).all()),
          f"{tag}: {scores.size} scores, finite {np.isfinite(scores).all()}")
    check(s["retries"] > 0 and s["faults_fired"]["straggler"] > 0,
          f"{tag}: faults {s['faults_fired']}")
    check(s["steady_traces"] == 0, f"{tag}: new signatures")
    out = {"arch": cfg.name, "storage": storage,
           **{k: s[k] for k in ("served", "failed", "failed_batches",
                                "retries", "p50_ms", "p99_ms", "availability",
                                "faults_fired", "steady_traces")},
           "degradation": {k: s["degradation"][k] for k in (
               "rung", "n_transitions", "breaker_trips", "straggler_trips")},
           "watchdog_trips": s["watchdog"]["trips"]}
    del rt, b
    torch.cuda.empty_cache()
    return out


def heal_run(cfg, storage) -> dict:
    """``corrupt_store(mode='nan')`` on a 4-shard binding's hot tier: the
    score scrub zeroes the NaN scores and counts them, two poisoned batches
    make the degradation controller want a restore, and ``restore`` heals:
    scores bitwise equal to the clean ones."""
    import shutil
    import tempfile
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.serving import loadgen
    from repro_torch.serving.degradation import DegradationController
    from repro_torch.serving.faults import corrupt_store
    from repro_torch.serving.batcher import Bucket

    tmp = tempfile.mkdtemp(prefix="chip_smoke_heal_")
    try:
        reqs = stream(cfg, 64, 0, storage)
        b = loadgen.bind_model(cfg, "cuda", storage=storage, n_shards=TP,
                               front_end="fused", scrub_scores=True,
                               profile=reqs)
        batch = loadgen.make_padder(cfg)(reqs[:32], Bucket(32, cfg.pooling))
        clean = b.execute(batch).clone()
        t0 = time.perf_counter()
        b.attach_checkpointer(Checkpointer(tmp, keep=1))
        snapshot_s = time.perf_counter() - t0
        b.reset_plan_stats()
        ctrl = DegradationController(binding=b)
        n_bad = corrupt_store(b, frac=0.25, seed=1, mode="nan")
        poisoned = []
        while not ctrl.wants_restore and len(poisoned) < 8:
            out = b.execute(batch)
            poisoned.append(b.last_poisoned)
            check(bool(torch.isfinite(out).all()),
                  "heal: a scrubbed score is not finite")
            ctrl.on_batch_done(0.0, ok=True, poisoned=b.last_poisoned)
        tag = f"faults {cfg.name} {storage} heal"
        check(ctrl.wants_restore and all(poisoned),
              f"{tag}: poisoned rows per batch {poisoned}")
        t0 = time.perf_counter()
        b.restore()
        restore_s = time.perf_counter() - t0
        ctrl.note_restored()
        assert_equal(b.execute(batch), clean, f"{tag}: healed scores")
        check(b.last_poisoned == 0 and b.plan_stats()["traces"] == 0,
              f"{tag}: still poisoned or a new signature")
        return {"arch": cfg.name, "storage": storage, "n_shards": TP,
                "check": "bitwise", "poisoned_rows_corrupted": n_bad,
                "poisoned_per_batch": poisoned,
                "restores": ctrl.report()["restores"],
                "snapshot_s": snapshot_s, "restore_s": restore_s}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def faults_phase() -> tuple:
    """Phase 11: the degraded-mesh regime at RMC4 (fp32 and int8) on 4
    shards, fused -- ``serve_offered_load(mesh_faults=True)``, launch
    counts zeroed just before and read just after (the partial pools and
    the resume ran before and after the re-mesh); the pinned composition
    with bitwise post-re-mesh scores; a transient and straggler run under
    the controller; and a NaN store healed by the restore the controller
    asks for."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    cfg = get_config("rmc4")
    lines = []
    build.reset_launches()
    for storage in ("fp32", "int8"):
        line = mesh_faults_run(cfg, storage)
        lines.append(line)
        print("faults " + json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    for k in ("fused_partial_pool", "fused_resume"):
        check(launches[k] > 0, f"faults phase: kernel {k} not launched")
    checks = [remesh_bitwise_run(cfg, s) for s in ("fp32", "int8")]
    checks.append(chaos_run(cfg, "fp32"))
    checks.append(heal_run(cfg, "int8"))
    for c in checks:
        print("faults " + json.dumps(c), flush=True)
    print(f"faults phase: {len(lines)} measured runs in "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}",
          flush=True)
    return lines, checks, launches


# ----------------------------------------------------------- recsys phase
REC_ARCHS = ("dcn-v2", "autoint", "sasrec", "bst")
REC_INT8 = ("dcn-v2", "sasrec")
# requests per runtime run: a Criteo request permutes five 2-10 M id
# vocabularies (~1.35 s of host time each), a sequence one 1 M catalogue
REC_N = {"dcn-v2": 48, "autoint": 48, "sasrec": 512, "bst": 512}
ZIPF_ALPHA = 1.05


def zipf_ids_on_card(vocab: int, shape, gen: torch.Generator
                     ) -> torch.Tensor:
    """Bounded zipf ids (alpha 1.05) by ``_zipf_ids``' inverse transform,
    drawn on the card from ``gen``, without its permutation of the
    vocabulary: the most popular ids are the lowest."""
    u = torch.rand(shape, generator=gen, device="cuda", dtype=torch.float64)
    a = 1.0 - ZIPF_ALPHA
    ids = torch.floor(((vocab ** a - 1.0) * u + 1.0) ** (1.0 / a)) - 1.0
    return ids.clamp_(0, vocab - 1).to(torch.int32)


def rec_batch(cfg, B: int, gen: torch.Generator) -> dict:
    """A batch of ``B`` recsys requests drawn on the card."""
    if cfg.interaction in ("self-attn-seq", "transformer-seq"):
        V = cfg.vocab_sizes[0]
        out = {"seq": zipf_ids_on_card(V, (B, cfg.seq_len), gen),
               "target": zipf_ids_on_card(V, (B,), gen)}
    else:
        out = {"fields": torch.stack(
            [zipf_ids_on_card(v, (B,), gen) for v in cfg.vocab_sizes], 1)}
    if cfg.n_dense:
        out["dense"] = torch.randn((B, cfg.n_dense), generator=gen,
                                   device="cuda")
    return out


def rec_lookup_ids(cfg, offs, batch) -> list:
    """The engine-global (B, G, 1) ids of every lookup the arch's forward
    makes."""
    if "fields" in batch:
        o = torch.as_tensor(np.asarray(offs, np.int32), device="cuda")
        return [(batch["fields"] + o)[..., None]]
    if cfg.interaction == "transformer-seq":
        return [torch.cat([batch["seq"], batch["target"][:, None]],
                          1)[..., None]]
    return [batch["seq"][..., None], batch["target"][:, None, None]]


def recsys_kernel_checks(gen: torch.Generator) -> int:
    """``masked_sls`` and ``masked_sls_dedup`` at the recsys lookups' shape:
    L = 1 bags (one row each, no weights or 0/1 weights), D in {16, 32,
    50} (64-, 128- and 200-byte fp32 rows; 16-, 32- and 50-byte int8
    rows), 1 and 4 shards pooled in one launch as the engine's split path
    stacks them, G * B = 21 * 512 and 26 * 512 bags of skewed ids (a
    quarter owned by no shard): bitwise equal to their plain versions, and
    the gather-once kernel to the per-entry one."""
    from repro_torch.core import sls as core_sls

    def rand(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    n_cases, R = 0, 40_000               # rows per shard
    for D in (16, 32, 50):
        for storage in ("fp32", "int8"):
            for S in (1, 4):
                if storage == "int8":
                    table = torch.randint(-127, 128, (S * R, D),
                                          generator=gen, device="cuda",
                                          dtype=torch.int8)
                else:
                    table = torch.randn((S * R, D), generator=gen,
                                        device="cuda")
                row_scale = rand((S * R,), 1e-4, 2e-2)
                for G in (21, 26):
                    N = G * 512
                    loc = (rand((N, 1)) ** 4 * R).to(torch.int32)
                    shard = torch.randint(0, S + 1, (N, 1), generator=gen,
                                          device="cuda")   # S: not owned
                    owned = shard[None] == torch.arange(
                        S, device="cuda").view(S, 1, 1)
                    # one scale per stored row, as the pages give them
                    scales = (row_scale[shard.clamp(max=S - 1) * R + loc]
                              if storage == "int8" else None)
                    for w in (None, (rand((N, 1)) < 0.8).float()):
                        tag = (f"L=1 D={D} {storage} S={S} G={G} B=512 "
                               f"w={'none' if w is None else '01'}")
                        outs = {}
                        for dedup in (False, True):
                            k = core_sls.masked_partial_sls_dense(
                                table, loc, owned, w, impl="cuda",
                                scales=scales, dedup=dedup)
                            p = core_sls.masked_partial_sls_dense(
                                table, loc, owned, w, impl="torch",
                                scales=scales, dedup=dedup)
                            name = "masked_sls_dedup" if dedup \
                                else "masked_sls"
                            assert_equal(k, p, f"{name} {tag}")
                            outs[dedup] = k
                        assert_equal(outs[True], outs[False],
                                     f"masked_sls_dedup == masked_sls {tag}")
                        n_cases += 1
    return n_cases


def rec_runtime_run(cfg, reqs, storage="fp32", mode="pifs", n_shards=1,
                    dedup="off", pin=False) -> dict:
    """One ``run_offered_load`` of a recsys config on the card (phase 8's
    load: Poisson 200 qps, SLO 50 ms, buckets of batch 8, 16 and 32,
    observe every 4 batches -- a no-op without an index key -- and re-plan
    every 64) over the stream ``reqs``, drawn once per arch; measured
    service times, or with ``pin`` the pinned ``FixedServiceModel``.
    Checks the run's counts and scores; returns its line, the scores by
    rid, the flush trace and the binding."""
    from repro_torch.core.paging import HOT_SHARD
    from repro_torch.launch import serve as srv
    from repro_torch.serving.batcher import FixedServiceModel
    from repro_torch.serving.loadgen import LoadConfig
    from repro_torch.serving.request import ArrivalConfig

    n = len(reqs)
    load = LoadConfig(n, ArrivalConfig(RT_QPS, seed=0), slo_ms=RT_SLO_MS,
                      seed=0, storage=storage, dedup=dedup)
    t0 = time.perf_counter()
    rt, b = srv.build_serving(
        cfg, "cuda", mode=mode, batch_sizes=RT_SIZES, slo_ms=RT_SLO_MS,
        storage=storage, dedup=dedup, n_shards=n_shards,
        service=FixedServiceModel(**RT_PIN) if pin else None)
    s = srv.run_offered_load(rt, b, cfg, load, requests=reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tag = (f"recsys {cfg.name} {storage} {mode} S={n_shards} dedup={dedup} "
           f"pin={pin}")
    check(s["served"] == n and s["dropped"] == s["failed"] == 0,
          f"{tag}: served {s['served']} of {n}, dropped {s['dropped']}, "
          f"failed {s['failed']}")
    check(s["steady_traces"] == 0,
          f"{tag}: {s['steady_traces']} signatures new after warmup")
    scores = np.asarray([rt.executor.scores[i] for i in range(n)],
                        np.float32)
    check(bool(np.isfinite(scores).all() and (scores > 0).all()
               and (scores < 1).all()), f"{tag}: scores not finite in (0, 1)")
    line = {"arch": cfg.name, "storage": storage, "mode": mode,
            "n_shards": n_shards, "dedup": dedup, "offered_qps": RT_QPS,
            "requests": n, "pinned": pin,
            **{k: s[k] for k in ("served", "batches", "p50_ms", "p99_ms",
                                 "p99.9_ms", "qps", "slo_violation_rate",
                                 "batch_occupancy_mean", "bucket_mix",
                                 "replans", "steady_traces",
                                 "warmup_service_ms")},
            "hot_pages": int((b.state.page_to_shard == HOT_SHARD).sum()),
            "wall_s": wall}
    trace = [(r.t, r.bucket.batch, r.bucket.pooling, r.n_real)
             for r in rt.metrics.batches]
    return {"line": line, "scores": scores, "trace": trace, "binding": b}


def rec_kernel_rows(cfg, storage, b, ids, timer: Timer) -> list:
    """``masked_sls`` and ``masked_sls_dedup`` on the cold tier at the
    first lookup of the batch-512 serve step (L = 1, no weights), timed
    (CUDA events, L2 flushed) beside their plain versions, their bounds
    from this run's inputs and, fp32, ``F.embedding_bag``."""
    from repro_torch.core import sls as core_sls
    from repro_torch.kernels import ops

    eng, st = b.engine, b.state
    B, G, L = ids.shape
    loc, owned, _, scale = eng._address(st, ids.reshape(B * G, L))
    own = owned[0]
    cold = st.cold
    D = cold.shape[1]
    plan = core_sls.dedup_plan(loc, own, scale)
    dd = dedup_cost(cold, plan)
    n_e = loc.numel()
    calls = {
        "masked_sls/cold": (
            lambda: ops.masked_sls(cold, loc, own, None, scale),
            lambda: ops.masked_sls(cold, loc, own, None, scale,
                                   impl="torch"),
            sls_cost(cold, loc, own, None, scale)),
        "masked_sls_dedup/cold": (
            lambda: ops.masked_sls_dedup(cold, plan, own, None),
            lambda: ops.masked_sls_dedup(cold, plan, own, None,
                                         impl="torch"),
            bound(dd["nbytes"] + n_e * 5 + B * G * D * 4,
                  n_e * D + dd["dequant_flops"])),
    }
    lib = None
    if storage == "fp32":
        safe = torch.where(own, loc, torch.zeros_like(loc))
        fw = own.float()
        lib = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
            safe, cold, mode="sum", per_sample_weights=fw)
    rows, outs = [], {}
    for name, (kfn, pfn, cost) in calls.items():
        kout, pout = kfn(), pfn()
        what = f"{name} {cfg.name} {storage} batch {B}"
        assert_equal(kout, pout, what)
        outs[name] = kout
        rows.append({"name": name, "arch": cfg.name, "storage": storage,
                     "batch": B, "bags": B * G, "L": L, "dim": D,
                     "n_shards": 1, "ms": timer(kfn), "plain_ms": timer(pfn),
                     "library_ms": None if lib is None else timer(lib),
                     "max_abs_err": 0.0, "owned": int(own.sum()), **cost})
    assert_equal(outs["masked_sls_dedup/cold"], outs["masked_sls/cold"],
                 f"masked_sls_dedup == masked_sls {cfg.name} {storage}")
    return rows


def rec_step_checks(cfg, storage, b, offs, gen, timer: Timer) -> tuple:
    """At batch 512 (``REC_SHAPES['serve_p99']``) drawn on the card: every
    lookup of the forward, kernel path == plain path bitwise; scores
    within 1e-5 of the plain path's, finite in (0, 1); the serve step
    timed (median of 20, host clock to a synchronize) with its device
    busy share; at DCN-v2 fp32 also pond (1 shard) and pifs at 4 shards
    (``remesh_engine`` of the same store): lookups bitwise equal to pifs
    at one shard, scores within 1e-5.  Returns the step lines and the
    kernel timing rows."""
    from repro_torch.configs import REC_SHAPES
    from repro_torch.models import recsys as rec
    from repro_torch.runtime.elastic import remesh_engine

    B = REC_SHAPES["serve_p99"].batch
    batch = rec_batch(cfg, B, gen)
    eng, st, model = b.engine, b.state, b.model
    tag = f"recsys {cfg.name} {storage} batch {B}"
    ids = rec_lookup_ids(cfg, offs, batch)
    kl = [eng.lookup(st, i) for i in ids]
    for k, i in zip(kl, ids):
        assert_equal(k, eng.lookup(st, i, impl="torch"),
                     f"{tag}: lookup kernel vs plain")
    step = rec.make_serve_step(model, eng, offs)
    got = step(st, batch)
    want = rec.make_serve_step(model, eng, offs, impl="torch")(st, batch)
    err = float((got - want).abs().max())
    check(err <= 1e-5, f"{tag}: scores kernel vs plain differ by {err:.3e}")
    check(bool(torch.isfinite(got).all() and (got > 0).all()
               and (got < 1).all()), f"{tag}: scores not finite in (0, 1)")
    on = rec.make_serve_step(model, eng, offs, dedup="on")(st, batch)
    assert_equal(on, got, f"{tag}: dedup on vs off")
    steps = [{"arch": cfg.name, "storage": storage, "n_shards": 1,
              "mode": "pifs", "batch": B, "score_err": err,
              **step_time(step, st, batch)}]
    rows = rec_kernel_rows(cfg, storage, b, ids[0], timer)
    if cfg.name == "dcn-v2" and storage == "fp32":
        pond = rec.make_serve_step(model, eng, offs, mode="pond")
        for i, k in zip(ids, kl):
            assert_equal(eng.lookup(st, i, mode="pond"), k,
                         f"{tag}: pond vs pifs lookup")
        e = float((pond(st, batch) - got).abs().max())
        check(e <= 1e-5, f"{tag}: pond vs pifs scores differ by {e:.3e}")
        steps.append({"arch": cfg.name, "storage": storage, "n_shards": 1,
                      "mode": "pond", "batch": B, "score_err": e,
                      **step_time(pond, st, batch)})
        eng4, st4 = remesh_engine(eng, TP, st)
        for i, k in zip(ids, kl):
            assert_equal(eng4.lookup(st4, i), k,
                         f"{tag}: {TP} shards vs one, lookup")
        step4 = rec.make_serve_step(model, eng4, offs)
        e = float((step4(st4, batch) - got).abs().max())
        check(e <= 1e-5, f"{tag}: {TP} shards vs one, scores {e:.3e}")
        steps.append({"arch": cfg.name, "storage": storage, "n_shards": TP,
                      "mode": "pifs", "batch": B, "score_err": e,
                      **step_time(step4, st4, batch)})
        del eng4, st4
    return steps, rows


def rec_retrieval(cfg, storage, b, offs, gen) -> dict:
    """``make_retrieval_step`` at ``REC_SHAPES['retrieval_cand']``: one
    history against 1,000,000 candidates drawn on the card; scores finite
    of that shape, within 1e-5 of the plain path's; median of 10 (host
    clock to a synchronize)."""
    from repro_torch.configs import REC_SHAPES
    from repro_torch.models import recsys as rec

    n = REC_SHAPES["retrieval_cand"].n_candidates
    q = {"seq": zipf_ids_on_card(cfg.vocab_sizes[0], (1, cfg.seq_len), gen),
         "cand_ids": torch.randint(0, cfg.vocab_sizes[0], (n,),
                                   generator=gen, device="cuda",
                                   dtype=torch.int32)}
    step = rec.make_retrieval_step(b.model, b.engine, offs)
    got = step(b.state, q)
    want = rec.make_retrieval_step(b.model, b.engine, offs,
                                   impl="torch")(b.state, q)
    tag = f"retrieval {cfg.name} {storage} {n} candidates"
    check(tuple(got.shape) == (n,) and bool(torch.isfinite(got).all()),
          f"{tag}: shape {tuple(got.shape)} or non-finite scores")
    err = float((got - want).abs().max())
    check(err <= 1e-5 * (1 + float(want.abs().max())),
          f"{tag}: kernel vs plain differ by {err:.3e}")
    torch.cuda.synchronize()
    ts = []
    for _ in range(10):
        t = time.perf_counter()
        step(b.state, q)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return {"arch": cfg.name, "storage": storage, "candidates": n,
            "ms": statistics.median(ts), "score_err": err,
            "bitwise": bool(torch.equal(got, want))}


def recsys_phase(gen: torch.Generator) -> tuple:
    """Phase 12: the recsys family at its published widths, uncut (DCN-v2
    and AutoInt over the 26 Criteo vocabularies, 33.8 M rows at D = 16;
    SASRec 1 M x 50; BST 1 M + 10 k x 32): fp32, and int8 for DCN-v2 and
    SASRec.  Per (arch, storage): ``serve_offered_load``'s path under phase
    8's load (launch counts zeroed just before and read just after:
    ``masked_sls`` must have run), at DCN-v2 fp32 also pond and 4 shards;
    then :func:`rec_step_checks`, the cold-tier kernels timed at the batch-
    512 lookup (:func:`rec_kernel_rows`), SASRec's retrieval over 1 M
    candidates; and a pinned SASRec pair whose ``dedup='on'`` run launches
    ``masked_sls_dedup`` and serves scores bitwise equal to off."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import recsys as rec
    from repro_torch.serving.loadgen import LoadConfig, request_stream
    from repro_torch.serving.request import ArrivalConfig

    t0 = time.perf_counter()
    timer = Timer()
    workers = max(1, min(8, len(os.sched_getaffinity(0))))
    lines, steps, rows, retrieval = [], [], [], []
    launches = {k: 0 for k in build.KERNELS}

    def measured(cfg, reqs, **kw):
        build.reset_launches()
        r = rec_runtime_run(cfg, reqs, **kw)
        for k, v in build.KERNELS.items():
            launches[k] += v.launches
        lines.append(r["line"])
        print("recsys " + json.dumps(r["line"]), flush=True)
        return r

    for arch in REC_ARCHS:
        cfg = get_config(arch)
        t = time.perf_counter()
        reqs = request_stream(cfg, LoadConfig(
            REC_N[arch], ArrivalConfig(RT_QPS, seed=0), slo_ms=RT_SLO_MS,
            seed=0), workers=workers)
        print(f"recsys {arch}: generated {len(reqs)} requests in "
              f"{time.perf_counter() - t:.3f} s ({workers} processes)",
              flush=True)
        for storage in ("fp32", "int8") if arch in REC_INT8 else ("fp32",):
            r = measured(cfg, reqs, storage=storage)
            b = r["binding"]
            _, offs = rec.build_engine(cfg, "cuda", storage=storage)
            s, k = rec_step_checks(cfg, storage, b, offs, gen, timer)
            steps += s
            rows += k
            if cfg.interaction == "self-attn-seq":
                retrieval.append(rec_retrieval(cfg, storage, b, offs, gen))
                print("retrieval " + json.dumps(retrieval[-1]), flush=True)
            del r, b
            torch.cuda.empty_cache()
            if arch == "dcn-v2" and storage == "fp32":
                for kw in ({"mode": "pond"}, {"n_shards": TP}):
                    measured(cfg, reqs, storage=storage, **kw)
                    torch.cuda.empty_cache()
        if arch == "sasrec":
            pin = {}
            for d in ("off", "on"):
                build.reset_launches()
                pin[d] = rec_runtime_run(cfg, reqs, dedup=d, pin=True)
                pin[d]["launches"] = {k: v.launches
                                      for k, v in build.KERNELS.items()}
                del pin[d]["binding"]
                torch.cuda.empty_cache()
            check(pin["on"]["trace"] == pin["off"]["trace"],
                  "recsys sasrec: dedup on vs off flush traces differ")
            assert_equal(torch.from_numpy(pin["on"]["scores"]),
                         torch.from_numpy(pin["off"]["scores"]),
                         "recsys sasrec: dedup on vs off scores")
            dedup_launches = pin["on"]["launches"]["masked_sls_dedup"]
            check(dedup_launches > 0,
                  "recsys phase: masked_sls_dedup not launched under dedup on")
            print(f"recsys sasrec: pinned dedup on == off bitwise "
                  f"({len(pin['on']['trace'])} batches); masked_sls_dedup "
                  f"launched {dedup_launches} times", flush=True)
        del reqs
    del timer
    torch.cuda.empty_cache()
    check(launches["masked_sls"] > 0,
          "recsys phase: kernel masked_sls not launched")
    for s in steps:
        print("recsys_step " + json.dumps(s), flush=True)
    print(f"recsys phase: {len(lines)} measured runs in "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}",
          flush=True)
    return lines, steps, rows, launches, dedup_launches


# ------------------------------------------------------------ paper phase
def paper_phase(gen: torch.Generator) -> tuple:
    """Phase 13: the paper's comparison.  (a) ``simulate`` for all five
    systems on the example's RMC4 trace (6 batches of 512, 196,608
    accesses; numpy on the host), one ``paper_sim`` line per system beside
    the paper's ratio, and the paper's ordering as ``tests/test_simlab.py``
    holds it.  (b) ``examples.pifs_vs_pond.engine_cross_check`` at RMC4's
    full width (8 x 1,048,576 rows, D = 128, 4 shards), fp32 and int8,
    dedup off and on: the kernel path's run (launch counts zeroed just
    before, read just after) against the plain path's run from the same
    seed, pifs and pond bitwise, the duplicate factor equal, pifs == pond
    within 1e-5 (the example checks it); each lookup timed (CUDA events,
    dirty L2), pifs beside pond.  (c) ``examples.quickstart`` at its own
    sizes, fp32 / int8 and dedup off / on, kernel path against plain:
    lookups before and after its re-plan bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.examples import pifs_vs_pond as pvp
    from repro_torch.examples import quickstart
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    model = get_config("rmc4")
    t = time.perf_counter()
    flat = pvp.paper_trace(model)
    res = pvp.simulate_all(model, flat)
    sim_s = time.perf_counter() - t
    check(flat.size == 196_608, f"paper: trace of {flat.size} accesses")
    tt = {k: r.total_us for k, r in res.items()}
    sim = []
    for name, r in res.items():
        sim.append({"system": name, "latency_us": r.total_us,
                    "binding": r.binding,
                    "local_pct": 100 * r.frac_local_access,
                    "hit_pct": 100 * r.buffer_hit_rate,
                    "vs_pifs": r.total_us / tt["pifs"],
                    "paper": pvp.PAPER.get(name)})
        print("paper_sim " + json.dumps(sim[-1]), flush=True)
    check(tt["pifs"] < tt["recnmp"] < tt["beacon"] < tt["pond"],
          f"paper: system ordering {tt}")
    check(tt["pifs"] < tt["pond_pm"] <= tt["pond"] * 1.05,
          f"paper: pond_pm ordering {tt}")
    print(f"paper: simulated {len(res)} systems in {sim_s:.2f} s", flush=True)

    timer = Timer()
    launches = {k: 0 for k in build.KERNELS}
    lookups = []
    for storage in ("fp32", "int8"):
        for dedup in ("off", "on"):
            tag = f"paper cross-check rmc4 {storage} dedup={dedup}"
            build.reset_launches()
            k = pvp.engine_cross_check(model, storage, dedup, "cuda", "cuda",
                                       n_rows=model.emb_num)
            torch.cuda.synchronize()
            for name, v in build.KERNELS.items():
                launches[name] += v.launches
            p = pvp.engine_cross_check(model, storage, dedup, "torch",
                                       "cuda", n_rows=model.emb_num)
            assert_equal(k["pifs"], p["pifs"], f"{tag}: pifs kernel vs plain")
            assert_equal(k["pond"], p["pond"], f"{tag}: pond kernel vs plain")
            check(k["dedup"] == p["dedup"], f"{tag}: duplicate factors "
                                            f"{k['dedup']} != {p['dedup']}")
            del p
            eng, st, idx = k["engine"], k["state"], k["idx"]
            line = {"storage": storage, "dedup": dedup,
                    "rows_per_table": k["n_rows"],
                    "n_shards": eng.cfg.n_shards,
                    "bags": int(idx.shape[0] * idx.shape[1]),
                    "factor": k["dedup"]["factor"],
                    "pifs_pond_max_diff": float(
                        (k["pifs"] - k["pond"]).abs().max())}
            for mode in ("pifs", "pond"):
                line[f"{mode}_ms"] = timer(
                    lambda: eng.lookup(st, idx, mode=mode, dedup=dedup))
                line[f"{mode}_plain_ms"] = timer(
                    lambda: eng.lookup(st, idx, mode=mode, dedup=dedup,
                                       impl="torch"))
            lookups.append(line)
            print("paper_lookup " + json.dumps(line), flush=True)
            del k, eng, st, idx
            torch.cuda.empty_cache()
    del timer
    for storage, dedup in (("fp32", "off"), ("int8", "on")):
        argv = ["--storage", storage, "--dedup", dedup]
        build.reset_launches()
        k = quickstart.main(argv)
        torch.cuda.synchronize()
        for name, v in build.KERNELS.items():
            launches[name] += v.launches
        p = quickstart.main(argv + ["--impl", "torch"])
        for key in ("pooled", "pond"):
            assert_equal(k[key], p[key], f"quickstart {storage} {dedup}: "
                                         f"{key} kernel vs plain")
        check(np.array_equal(k["before"], p["before"])
              and np.array_equal(k["after"], p["after"]),
              f"quickstart {storage} {dedup}: re-planned lookups differ")
    for name in ("masked_sls", "masked_sls_dedup"):
        check(launches[name] > 0, f"paper phase: kernel {name} not launched")
    print(f"paper phase: {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}", flush=True)
    return sim, lookups, launches


# ------------------------------------------------------------ train phase
TRAIN_B = 2048           # DLRM and recsys train batches
TRAIN_STEPS = 4          # a re-plan after step 3 (DLRM)
TRAIN_REPLAN = 3
TIER_RTOL, TIER_ATOL = 1e-4, 1e-5    # as the CPU tests hold the reference


def sls_grad_cost(grad_out, indices, n_rows: int) -> dict:
    """What ``ref.sls_table_grad`` must move: the dense (n_rows, D) table
    gradient written once, the bag gradients, ids and masks read once; a
    multiply and an add per entry and element."""
    N, L = indices.shape
    D = grad_out.shape[1]
    nbytes = n_rows * D * 4 + N * D * 4 + N * L * (4 + 1)
    return bound(nbytes, 2 * N * L * D)


def train_timing(k: dict, batch: dict) -> list:
    """On a trained RMC4 state (``train_dlrm``'s result): the train step
    (host clock to a synchronize, median of 5) with the card's busy share
    and operations per step from ``torch.profiler``; each backward (CUDA
    events, dirty L2) against its bound at the step's shapes, the library
    call where one computes the same from the entries' contributions; and
    the dense ``rowwise_adagrad`` update of both tiers, with its bytes."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.kernels import ref
    from repro_torch.models import dlrm
    from repro_torch.optim.optimizers import adam, rowwise_adagrad

    model, eng, st = k["model"], k["engine"], k["state"]
    os_, eos = k["opt_state"], k["emb_opt_state"]
    opt, eopt = adam(1e-3), rowwise_adagrad(5e-2)
    step_fn = dlrm.make_train_step(model, eng, opt, eopt)
    b = shard_batch(batch, "cuda")

    def step(s, bb):
        step_fn(s, os_, eos, bb)
    for _ in range(2):
        step(st, b)
    torch.cuda.synchronize()
    ts = []
    for _ in range(5):
        t = time.perf_counter()
        step(st, b)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    ms = statistics.median(ts)
    rows = [{"name": "train_step", "arch": "rmc4",
             "batch": int(b["dense"].shape[0]), "step_ms": ms,
             **device_busy(step, st, b, ms, reps=3)}]

    timer = Timer(reps=10)
    B, T, L = b["indices"].shape
    N = B * T
    local_row, owned, is_hot, _ = eng._address(st, b["indices"].reshape(N,
                                                                         L))
    gen = torch.Generator(device="cuda").manual_seed(5)
    g = torch.randn((N, eng.cfg.dim), generator=gen, device="cuda")
    for tier, table, mask in (("cold", st.cold, owned[0]),
                              ("hot", st.hot, is_hot)):
        R = table.shape[0]
        fn = (lambda: ref.sls_table_grad(g, local_row, mask, None, R))
        safe = torch.where(mask, local_row, 0).reshape(-1).long()
        contrib = (mask.to(torch.float32)[..., None] * g[:, None, :]
                   ).reshape(N * L, -1)
        zero = torch.zeros_like(table, dtype=torch.float32)
        lib = (lambda: zero.index_add_(0, safe, contrib))
        err = float((fn() - zero.zero_().index_add_(0, safe, contrib)
                     ).abs().max())
        rows.append({"name": f"masked_sls_backward/{tier}", "rows": R,
                     "entries": N * L, "ms": timer(fn),
                     "library_ms": timer(lib), "max_abs_err": err,
                     **sls_grad_cost(g, local_row, R)})
        del zero, lib
    F = T + 1
    feats = torch.randn((B, F, eng.cfg.dim), generator=gen, device="cuda")
    gi = torch.randn((B, F * (F - 1) // 2), generator=gen, device="cuda")
    fn = (lambda: ref.dot_interaction_grad(gi, feats))
    fi = feats.clone().requires_grad_(True)
    auto = torch.autograd.grad(ref.dot_interaction_ref(fi), fi, gi)[0]
    P = F * (F - 1) // 2
    rows.append({"name": "dot_interaction_backward", "batch": B, "F": F,
                 "ms": timer(fn), "library_ms": None,
                 "max_abs_err": float((fn() - auto).abs().max()),
                 **bound(2 * B * F * eng.cfg.dim * 4 + B * P * 4,
                         4 * B * P * eng.cfg.dim)})
    gc = torch.randn_like(st.cold) * 1e-3
    gh = torch.randn_like(st.hot) * 1e-3
    tiers = {"cold": st.cold, "hot": st.hot}
    upd = (lambda: eopt.update({"cold": gc, "hot": gh}, eos, tiers))
    R, D = st.cold.shape[0] + st.hot.shape[0], eng.cfg.dim
    rows.append({"name": "rowwise_adagrad_dense_update", "rows": R,
                 "ms": timer(upd), "library_ms": None, "max_abs_err": None,
                 **bound((3 * R * D + 2 * R) * 4, 5 * R * D)})
    del gc, gh, timer
    return rows


def _clone_tree(t):
    if isinstance(t, dict):
        return {k: _clone_tree(v) for k, v in t.items()}
    return t.clone()


def lockstep_dlrm(cfg, mode: str, batches: list) -> dict:
    """The kernel path's DLRM train steps against the plain path's, each
    from the same state: ``launch.train.train_dlrm``'s set-up (seeds 0 and
    1, adam and rowwise_adagrad), and before every step a copy of the
    model, both tiers and the optimizer states takes the plain step while
    the originals take the kernel step; then the originals observe, and
    re-plan after step ``TRAIN_REPLAN``.  Whole runs are not compared: a
    gradient at the noise level that changes sign moves an adam weight by
    2 lr, and at RMC4 the run is chaotic after a few steps (loss 0.69 ->
    0.50 -> 4.34 on this card), so run-long differences say nothing of
    the kernels.  Losses within 1e-5 relative, both tiers within
    ``TIER_ATOL`` + ``TIER_RTOL`` relative, each step; the largest errors
    and the kernel steps' host-clock times are returned."""
    import copy
    import dataclasses
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models import dlrm
    from repro_torch.models.params import initialize
    from repro_torch.optim.optimizers import adam, rowwise_adagrad

    eng, _ = dlrm.build_engine(cfg, "cuda")
    model = initialize(dlrm.DLRM(cfg, "cuda"),
                       torch.Generator(device="cuda").manual_seed(0))
    st = eng.init_state(torch.Generator(device="cuda").manual_seed(1))
    opt, eopt = adam(1e-3), rowwise_adagrad(5e-2)
    os_ = opt.init(dict(model.named_parameters()))
    eos = eopt.init({"cold": st.cold, "hot": st.hot})
    kstep = dlrm.make_train_step(model, eng, opt, eopt, mode=mode)
    tag = f"train lockstep {cfg.name} {mode}"
    lerr = terr = 0.0
    losses, step_ms = [], []
    for i, nb in enumerate(batches):
        b = shard_batch(nb, "cuda")
        m2 = copy.deepcopy(model)
        st2 = dataclasses.replace(st, cold=st.cold.clone(),
                                  hot=st.hot.clone())
        os2, eos2 = _clone_tree(os_), _clone_tree(eos)
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, os_, eos, mk = kstep(st, os_, eos, b)
        lk = float(mk["loss"])
        step_ms.append((time.perf_counter() - t) * 1e3)
        pstep = dlrm.make_train_step(m2, eng, opt, eopt, mode=mode,
                                     impl="torch")
        st2, _, _, mp = pstep(st2, os2, eos2, b)
        lp = float(mp["loss"])
        check(np.isfinite(lk), f"{tag}: step {i} loss {lk}")
        e = abs(lk - lp) / abs(lp)
        check(e <= 1e-5, f"{tag}: step {i} losses {lk} vs {lp}")
        lerr = max(lerr, e)
        for a, p in ((st.cold, st2.cold), (st.hot, st2.hot)):
            d = (a - p).abs()
            check(bool((d <= TIER_ATOL + TIER_RTOL * p.abs()).all()),
                  f"{tag}: step {i} tiers differ by {float(d.max()):.3e}")
            terr = max(terr, float(d.max()))
        losses.append(lk)
        del m2, st2, os2, eos2
        st = eng.observe(st, b["indices"])
        if (i + 1) % TRAIN_REPLAN == 0:
            st, _ = eng.plan_and_migrate(st)
    return {"losses": losses, "lockstep_step_ms": step_ms,
            "loss_rel_err": lerr, "tier_max_err": terr}


def train_phase(gen: torch.Generator) -> tuple:
    """Phase 14: training on the card.  DLRM at RMC1 and RMC4's published
    widths, fp32, pifs (RMC1 also pond), batch 2048, 4 steps with an
    observe after each and a re-plan after step 3: ``launch.train.
    train_dlrm`` (its step times, peak memory, finite losses), then
    :func:`lockstep_dlrm` (kernel path against plain path, each step from
    the same state).  The recsys family: DCN-v2 over the full Criteo
    vocabularies and SASRec at 1 M x 50, batch 2048, 4 steps, batches
    drawn once: ``launch.train.train_rec``'s kernel run == its plain run
    bitwise, losses and tiers (every lookup an L = 1 bag of weight 1, one
    deterministic backward).  Launch and backward counts are zeroed just
    before each kernel-path run and read just after (``masked_sls`` and
    ``dot_interaction`` must have run).  One ``train`` JSON line per
    config.  Then at RMC4 :func:`train_timing`; and
    ``examples.train_dlrm`` on the card: 200 steps with its injected
    failure, one restart."""
    from repro_torch.configs import get_config
    from repro_torch.data import synth
    from repro_torch.examples import train_dlrm as train_example
    from repro_torch.kernels import build, ops
    from repro_torch.launch import train as lt

    t0 = time.perf_counter()
    launches = {k: 0 for k in build.KERNELS}
    backwards = {k: 0 for k in ops.BACKWARDS}

    def counted(fn, *a, **kw):
        build.reset_launches()
        ops.reset_backwards()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        for k, v in build.KERNELS.items():
            launches[k] += v.launches
        for k, v in ops.BACKWARDS.items():
            backwards[k] += v
        return out

    lines, timing = [], []
    for arch, mode in (("rmc1", "pifs"), ("rmc1", "pond"),
                       ("rmc4", "pifs"), ("dcn-v2", "pifs"),
                       ("sasrec", "pifs")):
        cfg = get_config(arch)
        dlrm_arch = arch.startswith("rmc")
        t = time.perf_counter()
        batches = list(synth.dlrm_batches(cfg, TRAIN_B, TRAIN_STEPS)
                       if dlrm_arch else
                       synth.rec_batches(cfg, TRAIN_B, TRAIN_STEPS))
        draw_s = time.perf_counter() - t
        fn = lt.train_dlrm if dlrm_arch else lt.train_rec
        kw = dict(mode=mode, log_every=10 ** 9, device="cuda",
                  batches=batches)
        if dlrm_arch:
            kw["replan_every"] = TRAIN_REPLAN
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k = counted(fn, cfg, TRAIN_STEPS, TRAIN_B, **kw)
        peak = torch.cuda.max_memory_allocated()
        ks = k["state"]
        tag = f"train {arch} {mode}"
        check(all(np.isfinite(k["losses"])), f"{tag}: non-finite loss")
        line = {"arch": arch, "mode": mode, "batch": TRAIN_B,
                "steps": TRAIN_STEPS, "draw_s": draw_s,
                "losses": k["losses"],
                "step_ms": [x * 1e3 for x in k["step_s"]],
                "median_step_ms": k["median_step_ms"],
                "peak_gb": peak / 1e9,
                "cold_gb": ks.cold.numel() * 4 / 1e9}
        if dlrm_arch:
            if arch == "rmc4":
                timing = train_timing(k, batches[0])
            del k, ks
            torch.cuda.empty_cache()
            line.update(counted(lockstep_dlrm, cfg, mode, batches))
        else:
            p = fn(cfg, TRAIN_STEPS, TRAIN_B, impl="torch", **kw)
            check(k["losses"] == p["losses"],
                  f"{tag}: losses kernel vs plain {k['losses']} != "
                  f"{p['losses']}")
            assert_equal(ks.cold, p["state"].cold, f"{tag}: cold tier")
            assert_equal(ks.hot, p["state"].hot, f"{tag}: hot tier")
            line.update({"plain_median_step_ms": p["median_step_ms"],
                         "bitwise": True})
            del k, ks, p
        lines.append(line)
        print("train " + json.dumps(line), flush=True)
        del batches
        torch.cuda.empty_cache()
    for r in timing:
        print("train_timing " + json.dumps(r), flush=True)
    for name in ("masked_sls", "dot_interaction"):
        check(launches[name] > 0, f"train phase: kernel {name} not launched")
    check(backwards["masked_sls"] > 0 and backwards["dot_interaction"] > 0,
          f"train phase: backwards {backwards}")
    out = counted(train_example.main, [])
    rep = out["report"]
    check(rep.steps_done == 200 and rep.restarts == 1,
          f"train example: {rep.steps_done} steps, {rep.restarts} restarts")
    example = {"steps": rep.steps_done, "restarts": rep.restarts,
               "loss_first": out["losses"][0],
               "loss_last": out["losses"][-1], "seconds": out["seconds"]}
    print("train_example " + json.dumps(example), flush=True)
    print(f"train phase: {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}; backwards {backwards}", flush=True)
    return lines, timing, launches, backwards


# --------------------------------------------------------------- LM phase
LM_ARCHS = ("llama3.2-3b", "granite-moe-1b-a400m", "deepseek-v3-671b",
            "deepseek-67b", "nemotron-4-340b")
# (arch, layers kept, prefill seq, prefill batch, decode batch): the cuts
# from prefill_32k (batch 32) and decode_32k (batch 128) that one card holds
LM_RUNS = (("llama3.2-3b", None, 32768, 1, 8),
           ("granite-moe-1b-a400m", None, 32768, 1, 8),
           ("deepseek-v3-671b", 4, 4096, 1, 64))
LM_CACHE = 32768         # decode_32k's positions
LM_PROMPT = 64           # decode == prefill prompt, fed one token a step
LM_FP32_SEQ = 4096       # llama's bf16 against fp32 prefill
LM_DECODE_STEPS = 5
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 (tensor cores)
# bf16 logits, decode against prefill and bf16 against fp32: both sides
# round every product, norm and residual add to bf16 at other points (the
# decode softmax stays fp32, prefill casts p to bf16 before PV); within
# LM_BF16_TOL of the logits' own spread (their standard deviation).  A
# random-weight model's top-1 can lead its runner-up over a 128k vocab by
# less than that noise: the top-1 tokens must be equal or tied within it
LM_BF16_TOL = 0.25


def lm_cpu_checks() -> list:
    """The reduced configs of all five LM ids, fp32: prefill (batch 2, 64
    tokens of ``lm_batches``) and 4 decode steps on the card against the
    port on the CPU from the same weights, within 1e-5 (TF32 off)."""
    from dataclasses import replace
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.synth import lm_batches
    from repro_torch.models import transformer as tr

    out = []
    for arch in LM_ARCHS:
        cfg = replace(reduced(get_config(arch)), dtype="float32")
        cp = tr.init_params(cfg, seed=7, device="cpu")
        gp = _tree_to(cp, "cuda")
        toks = next(lm_batches(cfg, 2, LM_PROMPT, 1, seed=3))["tokens"]
        errs = [_max_err(tr.prefill_step(gp, toks, cfg),
                         tr.prefill_step(cp, toks, cfg))]
        cc = tr.init_cache(cfg, 2, LM_PROMPT, device="cpu")
        gc = tr.init_cache(cfg, 2, LM_PROMPT, device="cuda")
        for t in range(4):
            cl, cc = tr.decode_step(cp, cc, toks[:, t:t + 1], t, cfg)
            gl, gc = tr.decode_step(gp, gc, toks[:, t:t + 1], t, cfg)
            errs.append(_max_err(gl, cl))
        errs.append(max(_max_err(gc[k], cc[k]) for k in cc))
        check(max(errs) <= 1e-5, f"lm {arch} reduced fp32: card vs CPU max "
                                 f"err {max(errs):.3e} > 1e-5")
        out.append({"arch": arch, "card_vs_cpu_max_err": max(errs)})
        print("lm_cpu " + json.dumps(out[-1]), flush=True)
    return out


def _tree_to(tree, device, dtype=None):
    return {k: _tree_to(v, device, dtype) if isinstance(v, dict)
            else v.to(device=device, dtype=dtype or v.dtype)
            for k, v in tree.items()}


def _max_err(got, want) -> float:
    return float((got.float().cpu() - want.float().cpu()).abs().max())


def _logit_diff(got, want) -> dict:
    """Max |got - want| beside the spread of ``want``; whether each row's
    top-1 token is equal, and whether it is tied within the tolerance
    (``want``'s logit of ``got``'s top-1 within LM_BF16_TOL x spread of
    ``want``'s max); ``want``'s smallest top-1 margin over its second."""
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    top2 = w.topk(2, dim=-1).values
    std = float(w.std())
    gi = g.argmax(-1, keepdim=True)
    near = w.gather(-1, gi)[:, 0] >= top2[:, 0] - LM_BF16_TOL * std
    return {"max_err": float((g - w).abs().max()), "std": std,
            "top1_equal": bool((gi[:, 0] == w.argmax(-1)).all()),
            "top1_within_tol": bool(near.all()),
            "top1_margin": float((top2[:, 0] - top2[:, 1]).min())}


def _attn_cost(b, H, sq, h, dv, itemsize) -> dict:
    """A causal prefill attention (sq == skv): the valid (q, k) pairs'
    products, q / k / v read and the output written once; bf16 operands at
    the tensor cores' rate."""
    pairs = b * H * sq * (sq + 1) // 2
    nbytes = b * sq * H * (2 * h + 2 * dv) * itemsize
    flops = 2 * pairs * (h + dv)
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def _sdpa_ms(timer, q, k, v, **kw):
    """``F.scaled_dot_product_attention`` on the same tensors."""
    import torch.nn.functional as F
    return timer(lambda: F.scaled_dot_product_attention(q, k, v, **kw))


def lm_model_run(arch, n_layers, seq, pb, db, gen, timer) -> dict:
    """One full-width LM on the card: decode == prefill, (llama) bf16
    against fp32, the timed prefill, the whole cache read, timed decode
    steps with their device busy share, the prefill attention, the decode
    attention and the MoE block timed alone."""
    from dataclasses import replace
    from repro_torch.configs import LM_SHAPES, get_config
    from repro_torch.data.synth import lm_batches
    from repro_torch.models import transformer as tr
    from repro_torch.models.params import count_params

    t0 = time.perf_counter()
    cfg = get_config(arch)
    cuts = [f"prefill batch {LM_SHAPES['prefill_32k'].global_batch} -> {pb}",
            f"decode batch {LM_SHAPES['decode_32k'].global_batch} -> {db}"]
    if seq != LM_SHAPES["prefill_32k"].seq_len:
        cuts.append(f"prefill seq {LM_SHAPES['prefill_32k'].seq_len} -> "
                    f"{seq}")
    if n_layers is not None:
        cuts.append(f"layers {cfg.n_layers} -> {n_layers}")
        cuts.append(f"mtp_depth {cfg.mtp_depth} -> 0")
        cfg = replace(cfg, n_layers=n_layers, mtp_depth=0)
    print(f"lm {arch}: cuts {cuts}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    specs = tr.model_specs(cfg)
    n_params = count_params(specs)
    t = time.perf_counter()
    params = tr.init_params(cfg, seed=11, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    wbytes = n_params * 2
    line = {"arch": arch, "card": smi(), "layers": cfg.n_layers,
            "params": n_params, "weights_gb": wbytes / 1e9,
            "init_s": init_s, "cuts": cuts}
    S = LM_CACHE

    # -- decode == prefill: a prompt fed one position at a time
    prompt = next(lm_batches(cfg, 1, LM_PROMPT, 1, seed=1))["tokens"]
    cache = tr.init_cache(cfg, 1, S, device="cuda")
    for t_ in range(LM_PROMPT):
        dl, cache = tr.decode_step(params, cache, prompt[:, t_:t_ + 1], t_,
                                   cfg)
    pl = tr.prefill_step(params, prompt, cfg)
    check(dl.shape == pl.shape == (1, 1, cfg.vocab),
          f"lm {arch}: logits {tuple(dl.shape)} / {tuple(pl.shape)}")
    check(bool(torch.isfinite(dl).all() and torch.isfinite(pl).all()),
          f"lm {arch}: non-finite logits")
    for k, (shape, dt) in tr.cache_specs(cfg, 1, S).items():
        check(tuple(cache[k].shape) == shape and cache[k].dtype == dt,
              f"lm {arch}: cache {k} {tuple(cache[k].shape)}")
    check(not any(cache[k][:, :, LM_PROMPT:].any() for k in cache),
          f"lm {arch}: decode wrote past its positions")
    dp = _logit_diff(dl, pl)
    line["decode_vs_prefill"] = dp
    print(f"lm {arch}: decode vs prefill {dp}", flush=True)
    check(dp["max_err"] <= LM_BF16_TOL * dp["std"],
          f"lm {arch}: decode vs prefill max err {dp['max_err']:.4f} > "
          f"{LM_BF16_TOL} x std {dp['std']:.4f}")
    check(dp["top1_within_tol"],
          f"lm {arch}: decode's top-1 is not prefill's within the tolerance "
          f"(prefill's margin {dp['top1_margin']:.4f})")
    del cache, dl, pl

    # -- llama: bf16 against fp32 weights of the same values (the warmup
    # of the long prefill too)
    if arch == "llama3.2-3b":
        toks = next(lm_batches(cfg, 1, LM_FP32_SEQ, 1, seed=2))["tokens"]
        bl = tr.prefill_step(params, toks, cfg)
        p32 = _tree_to(params, "cuda", torch.float32)
        fl = tr.prefill_step(p32, toks, replace(cfg, dtype="float32"))
        del p32
        torch.cuda.empty_cache()
        bf = _logit_diff(bl, fl)
        line["bf16_vs_fp32"] = dict(bf, seq=LM_FP32_SEQ)
        print(f"lm {arch}: bf16 vs fp32 prefill {bf}", flush=True)
        check(bf["max_err"] <= LM_BF16_TOL * bf["std"],
              f"lm {arch}: bf16 vs fp32 max err {bf['max_err']:.4f} > "
              f"{LM_BF16_TOL} x std {bf['std']:.4f}")

    # -- the timed prefill
    toks = next(lm_batches(cfg, pb, seq, 1, seed=3))["tokens"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits = tr.prefill_step(params, toks, cfg)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t
    check(tuple(logits.shape) == (pb, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"lm {arch}: prefill logits {tuple(logits.shape)}")
    line.update(prefill_seq=seq, prefill_batch=pb, prefill_ms=pre_s * 1e3,
                prefill_tok_s=pb * seq / pre_s)
    del logits

    # -- the decode cache: every position drawn on the card
    cache = tr.init_cache(cfg, db, S, device="cuda")
    for v in cache.values():
        v.normal_(generator=gen)
    cache_bytes = sum(v.numel() * v.element_size() for v in cache.values())
    dtoks = torch.randint(0, cfg.vocab, (db, 1), generator=gen,
                          device="cuda")
    stats = {}
    dl, cache = tr.decode_step(params, cache, dtoks, S - 1, cfg, stats)
    check(tuple(dl.shape) == (db, 1, cfg.vocab)
          and bool(torch.isfinite(dl).all()),
          f"lm {arch}: decode logits {tuple(dl.shape)} at pos {S - 1}")
    # the whole cache is read: layer 0's attention at pos S - 1 against a
    # plain softmax over every position, and the step's logits move when
    # only position 0 of every layer changes
    whole = lm_whole_cache_check(params, cache, dtoks, cfg)
    first = {k: v[:, :, 0].clone() for k, v in cache.items()}
    for v in cache.values():
        v[:, :, 0] = 4.0
    dl2, _ = tr.decode_step(params, cache, dtoks, S - 1, cfg)
    for k, v in cache.items():
        v[:, :, 0] = first[k]
    moved = _max_err(dl2, dl)
    check(moved > 0, f"lm {arch}: decode at pos {S - 1} ignores position 0")
    line["whole_cache"] = dict(whole, logits_moved_by_pos0=moved)
    print(f"lm {arch}: whole cache read {line['whole_cache']}", flush=True)

    # -- timed decode steps (host clock to a synchronize) and busy share
    step_ms = []
    for _ in range(LM_DECODE_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.decode_step(params, cache, dtoks, S - 1, cfg)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    med = statistics.median(step_ms)
    n_moe = tr._layer_split(cfg)[1]
    expert_bytes = 0
    if n_moe:
        m = cfg.moe
        per_expert = 3 * cfg.d_model * m.d_ff_expert * 2
        hit = stats["experts_hit"]
        expert_bytes = sum(m.n_experts - h for h in hit) * per_expert
    # weights read: all but the embedding (b rows of it) and the experts
    # no token chose
    d = cfg.d_model
    read = (wbytes - cfg.vocab * d * 2 + db * d * 2 - expert_bytes
            + cache_bytes)
    busy = device_busy(
        lambda st, bt: tr.decode_step(params, cache, bt, S - 1, cfg),
        None, dtoks, med, reps=3)
    line.update(decode_batch=db, decode_cache=S, decode_ms=med,
                decode_step_ms=step_ms, decode_tok_s=db / med * 1e3,
                decode_bytes=read, cache_gb=cache_bytes / 1e9,
                decode_bound_ms=read / HBM_BYTES_PER_S * 1e3,
                experts_hit=stats.get("experts_hit"), **busy)
    del dl, dl2, first

    # -- device code timed alone: prefill attention, decode attention, MoE
    rows = lm_code_rows(arch, cfg, params, cache, seq, pb, db, gen, timer)
    del cache, params
    torch.cuda.empty_cache()
    line["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    line["seconds"] = time.perf_counter() - t0
    return {"line": line, "rows": rows}


def lm_whole_cache_check(params, cache, dtoks, cfg) -> dict:
    """Layer 0's decode attention at pos S - 1 over the filled cache
    against a plain fp32 softmax over all S positions (no mask)."""
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tr
    from repro_torch.models.layers import rms_norm
    key = "dense_layers" if "dense_layers" in params else "moe_layers"
    lp = tr._layer(params[key], 0)["attn"]
    x = tr.embed_tokens(params, dtoks, cfg).to(tr.cfg_dtype(cfg))
    h = rms_norm(x, tr._layer(params[key], 0)["attn_norm"], cfg.norm_eps)
    b, S = dtoks.shape[0], LM_CACHE
    if cfg.attn_type == "mla":
        m = cfg.mla
        q_nope, q_rope, _, _ = attn._mla_qkv(
            lp, h, cfg, attn._pos(S - 1, h.device))
        wuk = lp["wukv"].reshape(m.kv_lora_rank, cfg.n_heads, -1)[
            :, :, :m.qk_nope_head_dim]
        q_abs = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(),
                             wuk.float())
        scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
        ckv, kr = cache["ckv"][0].float(), cache["kr"][0].float()
        got = attn.mla_decode_core(q_abs, q_rope[:, 0], cache["ckv"][0],
                                   cache["kr"][0], S - 1, scale)
        s = (q_abs @ ckv.transpose(1, 2)
             + q_rope[:, 0].float() @ kr.transpose(1, 2)) * scale
        want = torch.softmax(s, -1) @ ckv
    else:
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = attn.apply_rope((h @ lp["wq"]).reshape(b, 1, H, hd),
                            attn._pos(S - 1, h.device), cfg.rope_theta
                            ).reshape(b, K, H // K, hd)
        got = attn.gqa_decode_core(q, cache["k"][0], cache["v"][0], S - 1,
                                   hd ** -0.5)
        k = cache["k"][0].float().permute(0, 2, 3, 1)
        v = cache["v"][0].float().permute(0, 2, 1, 3)
        want = torch.softmax((q.float() @ k) * hd ** -0.5, -1) @ v
    err = _max_err(got, want)
    check(err <= 1e-5, f"lm whole cache: decode attention vs a softmax over "
                       f"all {S} positions: max err {err:.3e}")
    return {"layer0_attn_vs_full_softmax": err, "positions": S}


def lm_code_rows(arch, cfg, params, cache, seq, pb, db, gen, timer
                 ) -> list:
    """The LM path's device code timed alone (CUDA events, dirty L2,
    median) on layer 0's weights and inputs drawn at the path's shapes:
    ``flash_attention`` at the prefill shape beside
    ``F.scaled_dot_product_attention`` (causal, same tensors); the decode
    attention core over the whole cache at pos S - 1 (GQA: beside SDPA
    with ``enable_gqa``); the MoE block at the decode and prefill
    shapes."""
    from repro_torch.models import attention as attn
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tr
    rows = []
    bf = torch.bfloat16
    H, S = cfg.n_heads, LM_CACHE

    def row(name, ms, cost, library_ms, calls, **kw):
        r = {"name": name, "arch": arch, "ms": ms, "plain_ms": ms,
             "library_ms": library_ms, "calls_per_step": calls, **cost, **kw}
        rows.append(r)
        print("lm_timing " + json.dumps(r), flush=True)

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # prefill attention, the flat-head layout the layers pass it
    if cfg.attn_type == "mla":
        m = cfg.mla
        h, dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    else:
        h = dv = cfg.head_dim
    q, k, v = randn(pb, seq, H, h), randn(pb, seq, H, h), randn(pb, seq, H, dv)
    scale = h ** -0.5
    ms = timer(lambda: attn.flash_attention(q, k, v, scale=scale))
    lib = _sdpa_ms(timer, q.transpose(1, 2), k.transpose(1, 2),
                   v.transpose(1, 2), is_causal=True, scale=scale)
    row("flash_attention", ms, _attn_cost(pb, H, seq, h, dv, 2), lib,
        cfg.n_layers, shape=f"q/k ({pb}, {seq}, {H}, {h}), v dv {dv}, "
                            "causal, bf16")
    del q, k, v
    torch.cuda.empty_cache()

    # decode attention over the whole cache (layer 0's slice)
    if cfg.attn_type == "mla":
        m = cfg.mla
        r, dr = m.kv_lora_rank, m.qk_rope_head_dim
        q_abs, q_rope = randn(db, H, r, dtype=torch.float32), randn(db, H, dr)
        ckv, kr = cache["ckv"][0], cache["kr"][0]
        ms = timer(lambda: attn.mla_decode_core(q_abs, q_rope, ckv, kr,
                                                S - 1, scale))
        nbytes = ((ckv.numel() + kr.numel()) * 2 + q_abs.numel() * 4
                  + q_rope.numel() * 2 + db * H * r * 4)
        flops = 2 * db * H * S * (2 * r + dr)
        row("mla_decode_core", ms, bound(nbytes, flops), None, cfg.n_layers,
            shape=f"batch {db}, {S} positions, latent {r} + rope {dr}, "
                  f"{H} heads; library none: no one call scores a split "
                  "latent key")
    else:
        K, hd = cfg.n_kv_heads, cfg.head_dim
        G = H // K
        qd = randn(db, K, G, hd)
        kc, vc = cache["k"][0], cache["v"][0]
        ms = timer(lambda: attn.gqa_decode_core(qd, kc, vc, S - 1,
                                                hd ** -0.5))
        nbytes = (kc.numel() + vc.numel() + qd.numel()) * 2 + qd.numel() * 4
        flops = 4 * db * H * S * hd
        lib = _sdpa_ms(timer, qd.reshape(db, H, 1, hd), kc.permute(0, 2, 1, 3),
                       vc.permute(0, 2, 1, 3), enable_gqa=True)
        row("gqa_decode_core", ms, bound(nbytes, flops), lib, cfg.n_layers,
            shape=f"batch {db}, {S} positions, {K} kv heads x {G}, h {hd}")

    # the MoE block (routing, expert loop, combine; shared expert)
    n_dense, n_moe = tr._layer_split(cfg)
    if n_moe:
        mp = tr._layer(params["moe_layers"], 0)["moe"]
        mc = cfg.moe
        d, f = cfg.d_model, mc.d_ff_expert
        for tag, shape in (("decode", (db, 1, d)), ("prefill", (pb, seq, d))):
            x = randn(*shape)
            st = {}
            moe_mod.moe_apply(mp, x, cfg, st)
            ms = timer(lambda: moe_mod.moe_apply(mp, x, cfg))
            n = shape[0] * shape[1]
            hit = st["experts_hit"][0]
            fs = f * mc.n_shared_experts
            nbytes = (hit * 3 * d * f + 3 * d * fs) * 2 + d * mc.n_experts * 4 \
                + 2 * x.numel() * 2
            flops = 2 * 3 * d * f * n * mc.top_k + 2 * 3 * d * fs * n \
                + 2 * d * mc.n_experts * n
            c = bound(nbytes, 0)
            to = flops / BF16_FLOPS_PER_S * 1e3
            if to > c["bound_ms"]:
                c = dict(c, bound_ms=to, bound_by="operations")
            c["flops"] = int(flops)
            row(f"moe_apply/{tag}", ms, c, None, n_moe,
                shape=f"{n} tokens x top {mc.top_k} of {mc.n_experts} "
                      f"experts ({hit} hit), d {d}, f {f}, shared {fs}; "
                      "library none")
            del x
    return rows


def lm_phase(gen: torch.Generator) -> tuple:
    """Phase 15: the LM family's serve path (``models.transformer``), bf16
    at published widths: llama3.2-3b and granite-moe-1b-a400m whole,
    deepseek-v3-671b cut to 4 layers (3 dense + the first MoE layer, MTP
    cut).  Per model (:func:`lm_model_run`): a 64-token ``lm_batches``
    prompt fed through ``decode_step`` from a zero cache of 32,768
    positions ends at ``prefill_step``'s logits (within LM_BF16_TOL of
    their spread, top-1 equal); llama's bf16 prefill against the same
    weights in fp32; the timed prefill (seq 32,768, deepseek 4,096; batch
    1); decode at pos 32,767 over a cache drawn on the card (batch 8,
    deepseek 64) reads every position; timed decode steps with their bytes
    bound and device busy share; the prefill attention, decode attention
    and MoE block timed alone.  First, :func:`lm_cpu_checks`.  Kernel
    launch counts are zeroed before and read after: no kernel is on this
    path."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.reset_launches()
    cpu = lm_cpu_checks()
    timer = Timer(reps=5)
    lines, rows = [], []
    for arch, n_layers, seq, pb, db in LM_RUNS:
        r = lm_model_run(arch, n_layers, seq, pb, db, gen, timer)
        lines.append(r["line"])
        rows += r["rows"]
        print("lm " + json.dumps(lines[-1]), flush=True)
        torch.cuda.empty_cache()
    del timer
    torch.cuda.empty_cache()
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    print(f"lm phase: {time.perf_counter() - t0:.1f} s; kernel launches "
          f"{launches} (none on this path)", flush=True)
    return cpu, lines, rows


# --------------------------------------------------------- LM train phase
# (arch, layers kept, batch): train_4k's seq 4096, batch cut from 256.
# deepseek-v3's 4-layer serving cut cannot take a train step on one 80 GB
# card (its MoE layer is 11.5 B parameters, 46 GB with its bf16 gradient,
# plus adafactor's fp32 temporaries of whole leaves): 3 dense layers,
# MTP cut
LMT_RUNS = (("llama3.2-3b", None, 2),
            ("granite-moe-1b-a400m", None, 2),
            ("deepseek-v3-671b", 3, 2))
LMT_SEQ = 4096
LMT_STEPS = 4            # on one repeated batch: the loss must fall
LMT_LR = 3e-3            # train_lm's adafactor
# the full-width steps' adafactor.  Its steps are absolute (lr x an update
# of RMS <= 1, not scaled by the parameter's RMS), so one step moves a
# d-wide layer's output by ~lr x d x its input: on one batch llama's loss
# went 12.18, 11.11, 21.06, 15.23 at train_lm's 3e-3, 12.18, 15.38, 14.26,
# 14.71 at 3e-4, and 12.18, 10.88, 11.10, 10.60 at 1e-5 (NVIDIA H100 80GB
# HBM3, 700.00 W)
LMT_STEP_LR = 1e-5
# bf16: accum=2 sums two bf16 microbatch gradients, each from activations
# rounded at other batch shapes: the gradient tree within 2^-5 relative
# (Frobenius), the loss within 2^-7; flash's backward rounds p to bf16
# before dV and its inputs are bf16: within 2^-6 of autograd through a
# plain fp32 softmax; remat "full" recomputes the same ops: within 2^-8
LMT_ACCUM_TOL, LMT_LOSS_TOL = 2 ** -5, 2 ** -7
LMT_FLASH_TOL, LMT_REMAT_TOL = 2 ** -6, 2 ** -8
LMT_CKPT_LAYERS = 2      # the resume check's granite cut (see lm_train_ckpt)
LMT_PLAIN_BYTES = 48e9   # the flash check's plain softmax: its seq halves
                         # until its fp32 tiles fit (deepseek: 2048)
# the gradient at width: a central difference of the fp32 loss along a
# random unit direction, step 0.1, against g.d; the loss (~12) keeps ~7
# significant digits, so the difference (~1e-4) is good to ~1 %
LMT_FD_EPS, LMT_FD_TOL = 0.1, 0.05


class _GradCapture:
    """An optimizer that keeps the gradients and changes nothing."""
    init = staticmethod(lambda params: {})

    @staticmethod
    def update(grads, state, params):
        from repro_torch.models import transformer as tr
        state["grads"] = dict(tr.tree_leaves(grads))
        return params, state


def _rel_fro(got: dict, want: dict) -> float:
    """Relative Frobenius error over a whole gradient tree."""
    num = den = 0.0
    for k, w in want.items():
        g = got[k].float()
        w = w.float()
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
    return (num / max(den, 1e-30)) ** 0.5


def _leaf_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def lm_train_cpu_checks() -> list:
    """The five reduced LM configs, fp32: one ``make_train_step``
    (adafactor, remat "dots") on the card against the port on the CPU from
    the same weights and batch: the loss and ``grad_norm`` within 1e-5
    relative, the parameters within 1e-5 (adafactor's first step moves a
    weight by about lr x the sign of its gradient: a gradient at the noise
    level may flip it, so at most 1e-4 of the elements may differ, by at
    most 2 lr).  deepseek-v3 reduced keeps MTP and MoE."""
    from dataclasses import replace
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.synth import lm_batches
    from repro_torch.models import transformer as tr
    from repro_torch.optim.optimizers import adafactor

    out = []
    for arch in LM_ARCHS:
        cfg = replace(reduced(get_config(arch)), dtype="float32")
        cp = tr.init_params(cfg, seed=7, device="cpu")
        gp = _tree_to(cp, "cuda")
        b = next(lm_batches(cfg, 4, 64, 1, seed=3))
        res = {}
        for dev, p in (("cpu", cp), ("cuda", gp)):
            o = adafactor(lr=LMT_LR)
            st = o.init(p)
            _, _, m = tr.make_train_step(cfg, o)(p, st, b)
            res[dev] = {k: float(v) for k, v in m.items()}
        loss_err = abs(res["cuda"]["loss"] - res["cpu"]["loss"]) / abs(
            res["cpu"]["loss"])
        gn_err = abs(res["cuda"]["grad_norm"] - res["cpu"]["grad_norm"]) / \
            res["cpu"]["grad_norm"]
        worst, far, n = 0.0, 0, 0
        for (k, a), (_, c) in zip(tr.tree_leaves(gp), tr.tree_leaves(cp)):
            d = (a.cpu() - c).abs()
            worst = max(worst, float(d.max()))
            far += int((d > 1e-5).sum())
            n += d.numel()
        line = {"arch": arch, "mtp_depth": cfg.mtp_depth,
                "moe": cfg.moe is not None, "loss_rel_err": loss_err,
                "grad_norm_rel_err": gn_err, "param_max_err": worst,
                "param_far_share": far / n}
        check(loss_err <= 1e-5 and gn_err <= 1e-5,
              f"lm_train {arch} reduced: card vs CPU loss {loss_err:.2e}, "
              f"grad_norm {gn_err:.2e} > 1e-5")
        check(worst <= 2 * LMT_LR + 1e-6 and far / n <= 1e-4,
              f"lm_train {arch} reduced: params max err {worst:.2e}, "
              f"{far} of {n} beyond 1e-5")
        out.append(line)
        print("lm_train_cpu " + json.dumps(line), flush=True)
    return out


def _flash_cost(b, H, s, h, dv, itemsize) -> dict:
    """A causal flash attention's forward and backward (sq == skv): the
    valid pairs' products (forward s and PV; backward s again, dP, dV, dQ,
    dK), q / k / v / out / dout read once and dq / dk / dv written once;
    bf16 operands at the tensor cores' rate."""
    pairs = b * H * s * (s + 1) // 2
    nbytes = b * s * H * (3 * h + 3 * dv) * itemsize + b * H * s * 4
    flops = 2 * pairs * (h + dv) + 2 * pairs * (3 * h + 2 * dv)
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def lm_flash_check(cfg, b, gen) -> dict:
    """``flash_attention``'s backward (bf16 inputs, layer 0's head layout
    at the train shape) against autograd through a plain, unchunked
    masked fp32 softmax: dq, dk, dv within LMT_FLASH_TOL relative."""
    from repro_torch.models import attention as attn
    H = cfg.n_heads
    if cfg.attn_type == "mla":
        m = cfg.mla
        h, dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    else:
        h = dv = cfg.head_dim
    s = LMT_SEQ           # the plain side holds ~6 (b, H, s, s) fp32 tiles
    while 24 * b * H * s * s > LMT_PLAIN_BYTES:
        s //= 2

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16).requires_grad_()
    q, k, v = randn(b, s, H, h), randn(b, s, H, h), randn(b, s, H, dv)
    w = torch.randn((b, s, H, dv), generator=gen, device="cuda")
    scale = h ** -0.5
    out = attn.flash_attention(q, k, v, scale=scale)
    got = torch.autograd.grad((out.float() * w).sum(), [q, k, v])
    f32 = [t.detach().float().requires_grad_() for t in (q, k, v)]
    sc = torch.einsum("bqhd,bkhd->bhqk", f32[0], f32[1]) * scale
    mask = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    p = torch.softmax(sc.masked_fill(~mask, float("-inf")), -1)
    del sc
    ref = torch.einsum("bhqk,bkhd->bqhd", p, f32[2])
    del p
    want = torch.autograd.grad((ref * w).sum(), f32)
    errs = {n: _leaf_rel(g, wg) for n, g, wg in zip("qkv", got, want)}
    check(max(errs.values()) <= LMT_FLASH_TOL,
          f"lm_train {cfg.name}: flash backward vs plain softmax {errs}")
    del got, want, ref, f32
    torch.cuda.empty_cache()
    return {"shape": f"({b}, {s}, {H}, {h}), dv {dv}, causal, bf16",
            "seq": s, "d_rel_err": errs}


def lm_remat_check(cfg, b) -> dict:
    """remat "full" against "none" on a 2-layer cut at full width: the
    gradients within LMT_REMAT_TOL per leaf; bitwise or not."""
    from dataclasses import replace
    from repro_torch.data.synth import lm_batches
    from repro_torch.models import transformer as tr
    c2 = replace(cfg, n_layers=2, mtp_depth=0)
    if c2.moe is not None and c2.moe.first_dense_layers:
        # deepseek's first two layers, both dense
        c2 = replace(c2, moe=replace(c2.moe, first_dense_layers=2))
    p = tr.init_params(c2, seed=5, device="cuda")
    batch = next(lm_batches(c2, b, LMT_SEQ, 1, seed=4))
    grads = {}
    for remat in ("none", "full"):
        st = {}
        tr.make_train_step(c2, _GradCapture, remat=remat)(p, st, batch)
        grads[remat] = st["grads"]
    errs = {k: _leaf_rel(grads["full"][k], grads["none"][k])
            for k in grads["none"]}
    bitwise = all(torch.equal(grads["full"][k], grads["none"][k])
                  for k in grads["none"])
    worst = max(errs.values())
    check(worst <= LMT_REMAT_TOL, f"lm_train {cfg.name}: remat full vs "
                                  f"none max leaf err {worst:.2e}")
    del p, grads
    torch.cuda.empty_cache()
    return {"layers": 2, "max_leaf_rel_err": worst, "bitwise": bitwise}


def lm_grad_check(cfg, gen) -> dict:
    """The gradient at full width: a 2-layer fp32 cut (seq 1024, batch 2),
    ``make_train_step``'s gradient g (remat "dots") against a central
    difference of ``loss_fn`` along a random unit direction d, within
    LMT_FD_TOL of g.d."""
    from dataclasses import replace
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.data.synth import lm_batches
    from repro_torch.models import transformer as tr
    c2 = replace(cfg, n_layers=2, mtp_depth=0, dtype="float32")
    p = tr.init_params(c2, seed=5, device="cuda")
    b = shard_batch(next(lm_batches(c2, 2, 1024, 1, seed=4)), "cuda")
    st = {}
    tr.make_train_step(c2, _GradCapture)(p, st, b)
    g = st["grads"]
    d = {k: torch.randn(v.shape, generator=gen, device="cuda")
         for k, v in g.items()}
    norm = sum(float((x * x).sum()) for x in d.values()) ** 0.5
    gd = sum(float((g[k] * d[k]).sum()) for k in g) / norm
    leaves = dict(tr.tree_leaves(p))
    loss = []
    for sign in (1, -1):
        q = tr._tree(list(leaves), [v + sign * LMT_FD_EPS / norm * d[k]
                                    for k, v in leaves.items()])
        with torch.no_grad():
            loss.append(float(tr.loss_fn(q, b["tokens"], b["labels"], c2)))
        del q
    fd = (loss[0] - loss[1]) / (2 * LMT_FD_EPS)
    err = abs(fd - gd) / abs(gd)
    check(err <= LMT_FD_TOL, f"lm_train {cfg.name}: gradient along a random "
                             f"direction {gd:.4e}, central difference "
                             f"{fd:.4e}")
    del p, g, d, leaves
    torch.cuda.empty_cache()
    return {"layers": 2, "dtype": "float32", "seq": 1024, "g_dot_d": gd,
            "central_difference": fd, "rel_err": err}


def lm_accum_check(cfg, params, batch) -> dict:
    """accum=2 against accum=1 on the same batch of 2 (no update): the
    gradient tree and the loss within the bf16 accumulation's
    tolerance."""
    from repro_torch.models import transformer as tr
    res = {}
    for accum in (1, 2):
        st = {}
        _, _, m = tr.make_train_step(cfg, _GradCapture, accum=accum)(
            params, st, batch)
        res[accum] = (float(m["loss"]), st["grads"])
    err = _rel_fro(res[2][1], res[1][1])
    lerr = abs(res[2][0] - res[1][0]) / abs(res[1][0])
    check(err <= LMT_ACCUM_TOL and lerr <= LMT_LOSS_TOL,
          f"lm_train {cfg.name}: accum=2 vs 1 grads {err:.2e}, loss "
          f"{lerr:.2e}")
    return {"grad_tree_rel_err": err, "loss_rel_err": lerr}


def lm_train_ckpt() -> dict:
    """``train_lm`` with ``--ckpt-dir`` on granite: 4 steps, against 2
    steps then the run continued from its checkpoint to 4; the last
    checkpoints' leaves byte for byte (their md5s) and the final loss
    equal.  Granite is cut to LMT_CKPT_LAYERS layers: each step writes a
    checkpoint (``max(steps // 4, 1)``), eight in all, and the whole
    model's 2.77 GB each would spend ~40 s hashing and writing."""
    import tempfile
    from dataclasses import replace
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    cfg = get_config("granite-moe-1b-a400m")
    cut = f"layers {cfg.n_layers} -> {LMT_CKPT_LAYERS}"
    cfg = replace(cfg, n_layers=LMT_CKPT_LAYERS)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        whole = launch_train.train_lm(cfg, 4, 2, 512, ckpt_dir=f"{d}/a")
        part = launch_train.train_lm(cfg, 2, 2, 512, ckpt_dir=f"{d}/b")
        cont = launch_train.train_lm(cfg, 4, 2, 512, ckpt_dir=f"{d}/b")
        ma = Checkpointer(f"{d}/a").manifest(4)["leaves"]
        mb = Checkpointer(f"{d}/b").manifest(4)["leaves"]
    same = ma.keys() == mb.keys() and all(ma[k]["crc"] == mb[k]["crc"]
                                          for k in ma)
    check(part["steps"] == 2 and cont["steps"] == whole["steps"] == 4,
          f"lm_train ckpt: steps {part}, {cont}, {whole}")
    check(same and cont["final_loss"] == whole["final_loss"],
          f"lm_train ckpt: the resumed run's checkpoint differs "
          f"({cont['final_loss']} vs {whole['final_loss']})")
    return {"arch": "granite-moe-1b-a400m", "cut": cut, "batch": 2,
            "seq": 512, "leaves": len(ma), "bitwise": same,
            "final_loss": whole["final_loss"],
            "seconds": time.perf_counter() - t0}


def lm_train_run(arch, n_layers, batch, gen) -> dict:
    """One full-width LM trained on the card (bf16): LMT_STEPS adafactor
    steps (lr LMT_STEP_LR) on one repeated ``lm_batches`` batch (the loss
    falls), timed
    (host clock to the loss on the host), tokens/s, the busy share of one
    step, peak memory; the flash backward against a plain softmax; remat
    full vs none on a 2-layer cut; llama: the gradient against a central
    difference (fp32, 2 layers) and accum=2 against accum=1."""
    from dataclasses import replace
    from repro_torch.configs import LM_SHAPES, get_config
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.data.synth import lm_batches
    from repro_torch.models import transformer as tr
    from repro_torch.models.params import count_params
    from repro_torch.optim.optimizers import adafactor

    t0 = time.perf_counter()
    cfg = get_config(arch)
    cuts = [f"batch {LM_SHAPES['train_4k'].global_batch} -> {batch}"]
    if n_layers is not None:
        # deepseek's first_dense_layers is 3: a 3-layer cut is all dense
        cuts += [f"layers {cfg.n_layers} -> {n_layers} (dense)",
                 f"mtp_depth {cfg.mtp_depth} -> 0"]
        cfg = replace(cfg, n_layers=n_layers, mtp_depth=0)
        check(tr._layer_split(cfg)[1] == 0, f"lm_train {arch}: the cut "
                                            "keeps an MoE layer")
    if batch % cfg.train_accum:
        cuts.append(f"train_accum {cfg.train_accum} -> 1")
        cfg = replace(cfg, train_accum=1)
    print(f"lm_train {arch}: cuts {cuts}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    line = {"arch": arch, "card": smi(), "layers": cfg.n_layers,
            "params": count_params(tr.model_specs(cfg)), "batch": batch,
            "seq": LMT_SEQ, "remat": "dots", "lr": LMT_STEP_LR,
            "cuts": cuts}
    line["flash_check"] = lm_flash_check(cfg, batch, gen)
    print(f"lm_train {arch}: flash check {line['flash_check']}", flush=True)
    line["remat_check"] = lm_remat_check(cfg, batch)
    print(f"lm_train {arch}: remat check {line['remat_check']}", flush=True)
    if arch == "llama3.2-3b":
        line["grad_check"] = lm_grad_check(cfg, gen)
        print(f"lm_train {arch}: gradient check {line['grad_check']}",
              flush=True)
    params = tr.init_params(cfg, seed=11, device="cuda")
    b = shard_batch(next(lm_batches(cfg, batch, LMT_SEQ, 1, seed=5)),
                    "cuda")
    if arch == "llama3.2-3b":
        line["accum_check"] = lm_accum_check(cfg, params, b)
        print(f"lm_train {arch}: accum check {line['accum_check']}",
              flush=True)
    opt = adafactor(lr=LMT_STEP_LR)
    ostate = opt.init(params)
    step = tr.make_train_step(cfg, opt)
    losses, gnorms, step_ms = [], [], []
    for _ in range(LMT_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, m = step(params, ostate, b)
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t) * 1e3)
        gnorms.append(float(m["grad_norm"]))
    print(f"lm_train {arch}: losses {losses}, step ms {step_ms}",
          flush=True)
    check(all(np.isfinite(losses + gnorms)),
          f"lm_train {arch}: non-finite loss or grad_norm {losses} {gnorms}")
    check(losses[-1] < losses[0],
          f"lm_train {arch}: loss does not fall on one batch: {losses}")
    med = statistics.median(step_ms[1:])
    busy = device_busy(lambda st, bb: step(params, ostate, bb), None, b,
                       med, reps=1)
    line.update(losses=losses, grad_norms=gnorms, step_ms=step_ms,
                median_step_ms=med, tok_s=batch * LMT_SEQ / med * 1e3,
                **busy)
    line["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rows = lm_train_rows(arch, cfg, params, ostate, b, gen)
    del params, ostate, b
    torch.cuda.empty_cache()
    line["seconds"] = time.perf_counter() - t0
    return {"line": line, "rows": rows}


def _adafactor_bytes(params, state) -> int:
    """adafactor's update, each byte once: the gradient and parameter
    read, the parameter written, each second-moment leaf read and
    written."""
    from repro_torch.models import transformer as tr
    from repro_torch.optim.optimizers import _leaves
    p = sum(t.numel() * t.element_size() for _, t in tr.tree_leaves(params))
    v = sum(t.numel() * t.element_size() for _, t in _leaves(state["v"]))
    return 3 * p + 2 * v


def lm_train_rows(arch, cfg, params, ostate, b, gen) -> list:
    """The train path's device code timed alone (CUDA events, dirty L2,
    median): the flash attention forward + backward at layer 0's train
    shape beside SDPA's (causal, bf16); llama: the adafactor update of the
    whole tree beside its bytes bound, the cross-entropy forward +
    backward beside ``F.cross_entropy``'s; granite: the MoE block forward
    + backward."""
    import torch.nn.functional as F
    from repro_torch.models import attention as attn
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tr
    from repro_torch.optim.optimizers import adafactor
    timer = Timer(reps=5)
    rows = []
    bf = torch.bfloat16
    B, s = b["tokens"].shape

    def row(name, ms, cost, library_ms, calls, **kw):
        r = {"name": name, "arch": arch, "ms": ms, "plain_ms": ms,
             "library_ms": library_ms, "calls_per_step": calls, **cost, **kw}
        rows.append(r)
        print("lm_train_timing " + json.dumps(r), flush=True)

    def randn(*shape, dtype=bf, grad=False):
        return torch.randn(shape, generator=gen, device="cuda").to(
            dtype).requires_grad_(grad)

    H = cfg.n_heads
    if cfg.attn_type == "mla":
        h, dv = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim, \
            cfg.mla.v_head_dim
    else:
        h = dv = cfg.head_dim
    q, k, v = (randn(B, s, H, h, grad=True), randn(B, s, H, h, grad=True),
               randn(B, s, H, dv, grad=True))
    do = randn(B, s, H, dv)
    scale = h ** -0.5

    def flash():
        out = attn.flash_attention(q, k, v, scale=scale)
        torch.autograd.grad(out, [q, k, v], do)
    ms = timer(flash)
    fwd = timer(lambda: attn.flash_attention(q.detach(), k.detach(),
                                             v.detach(), scale=scale))
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             scale=scale)
        torch.autograd.grad(out, [qt, kt, vt], dot)
    row("flash_attention/fwd+bwd", ms, _flash_cost(B, H, s, h, dv, 2),
        timer(sdpa), cfg.n_layers, forward_ms=fwd,
        shape=f"({B}, {s}, {H}, {h}), dv {dv}, causal, bf16; library: SDPA "
              "forward + backward")
    del q, k, v, do, qt, kt, vt, dot
    torch.cuda.empty_cache()

    if arch == "llama3.2-3b":
        grads = tr._tree(*zip(*[(kk, torch.randn(
            t.shape, generator=gen, device="cuda").to(t.dtype) * 1e-3)
            for kk, t in tr.tree_leaves(params)]))
        opt = adafactor(lr=LMT_LR)
        nbytes = _adafactor_bytes(params, ostate)
        n = sum(t.numel() for _, t in tr.tree_leaves(params))
        ms = timer(lambda: opt.update(grads, ostate, params))
        c = bound(nbytes, 12 * n)
        row("adafactor_update", ms, c, None, 1,
            shape=f"{n} parameters (bf16), factored second moments; "
                  "library none: torch.optim.Adafactor scales its step by "
                  "the parameter's RMS, another function")
        del grads
        torch.cuda.empty_cache()
        V = cfg.vocab
        logits = randn(B, s, V, grad=True)
        labels = b["labels"].long()

        def xent():
            loss = tr._xent_vocab_parallel(logits, labels)
            torch.autograd.grad(loss, [logits])

        def lib():
            loss = F.cross_entropy(logits.float().reshape(-1, V),
                                   labels.reshape(-1))
            torch.autograd.grad(loss, [logits])
        with torch.no_grad():
            err = float((tr._xent_vocab_parallel(logits, labels)
                         - F.cross_entropy(logits.float().reshape(-1, V),
                                           labels.reshape(-1))).abs())
        row("lm_xent/fwd+bwd", timer(xent),
            bound(2 * logits.numel() * 2 + labels.numel() * 8,
                  5 * logits.numel()), timer(lib), 1, max_abs_err=err,
            shape=f"logits ({B}, {s}, {V}) bf16; library F.cross_entropy "
                  "on the fp32 logits")
        del logits
        torch.cuda.empty_cache()

    n_dense, n_moe = tr._layer_split(cfg)
    if n_moe:
        mp = {kk: t.detach().requires_grad_()
              for kk, t in tr._layer(params["moe_layers"], 0)["moe"].items()}
        mc = cfg.moe
        d, f = cfg.d_model, mc.d_ff_expert
        x = randn(B, s, d, grad=True)
        dy = randn(B, s, d)
        st = {}
        moe_mod.moe_apply(mp, x, cfg, st)

        def moe():
            out, aux = moe_mod.moe_apply(mp, x, cfg)
            torch.autograd.grad([out, aux], [x] + list(mp.values()),
                                [dy, torch.ones_like(aux)])
        ntok = B * s
        hit = st["experts_hit"][0]
        fs = f * mc.n_shared_experts
        wbytes = (hit * 3 * d * f + 3 * d * fs) * 2 + d * mc.n_experts * 4
        nbytes = 3 * wbytes + 4 * ntok * d * 2
        flops = 3 * (2 * 3 * d * f * ntok * mc.top_k + 2 * 3 * d * fs * ntok
                     + 2 * d * mc.n_experts * ntok)
        c = bound(nbytes, 0)
        to = flops / BF16_FLOPS_PER_S * 1e3
        if to > c["bound_ms"]:
            c = dict(c, bound_ms=to, bound_by="operations")
        c["flops"] = int(flops)
        row("moe_apply/fwd+bwd", timer(moe), c, None, n_moe,
            shape=f"{ntok} tokens x top {mc.top_k} of {mc.n_experts} "
                  f"experts ({hit} hit), d {d}, f {f}, shared {fs}; library "
                  "none")
        del x, dy, mp
    del timer
    torch.cuda.empty_cache()
    return rows


def lm_train_phase(gen: torch.Generator) -> tuple:
    """Phase 16: the LM family's train path (``models.transformer.
    make_train_step`` with adafactor, the differentiable flash attention,
    ``launch.train.train_lm``), bf16 at the published widths: llama3.2-3b
    and granite-moe-1b-a400m whole, deepseek-v3-671b at its widths with 3
    dense layers and no MTP; seq 4096, batch 2.  First,
    :func:`lm_train_cpu_checks`; last, :func:`lm_train_ckpt`.  Kernel
    launch counts are zeroed before and read after: no kernel is on this
    path."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.reset_launches()
    cpu = lm_train_cpu_checks()
    lines, rows = [], []
    for arch, n_layers, batch in LMT_RUNS:
        r = lm_train_run(arch, n_layers, batch, gen)
        lines.append(r["line"])
        rows += r["rows"]
        print("lm_train " + json.dumps(lines[-1]), flush=True)
        torch.cuda.empty_cache()
    ck = lm_train_ckpt()
    print("lm_train_ckpt " + json.dumps(ck), flush=True)
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    print(f"lm_train phase: {time.perf_counter() - t0:.1f} s; kernel "
          f"launches {launches} (none on this path)", flush=True)
    return cpu, lines, rows, ck


# --------------------------------------------------------------- GNN phase
GNN_STEPS = 4            # on one batch: the loss must fall
GNN_LR = 1e-2            # train_gnn's adam
GNN_SEED = 17
# card vs CPU logits within 1e-5 (relative to the largest), the loss within
# 1e-6; the aggregation against sparse.mm is held to an order bound
# (gnn_agg_rows)
GNN_TOL = 1e-5


def gnn_cpu_checks() -> list:
    """The reduced config, the three regimes on the card against the port
    on the CPU from the same weights and batch: the logits within
    GNN_TOL, then one ``adam`` step (the loss within 1e-6 relative; adam's
    first step moves each weight by about lr x the sign of its gradient,
    so at most 1 % of a leaf may differ beyond 1e-5, by at most 2 lr)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import gnn
    from repro_torch.optim.optimizers import adam
    cfg = reduced(get_config("graphsage-reddit"))
    rng = np.random.default_rng(3)
    N, E, F = 200, 800, 16
    batches = {
        "full": {"feats": rng.normal(size=(N, F)).astype(np.float32),
                 "edges": rng.integers(0, N, (E, 2)).astype(np.int32),
                 "labels": rng.integers(0, 5, N).astype(np.int32)},
        "minibatch": {"feats": rng.normal(size=(N, F)).astype(np.float32),
                      "roots": rng.integers(0, N, 8).astype(np.int32),
                      "hop1": rng.integers(0, N, (8, 3)).astype(np.int32),
                      "hop2": rng.integers(0, N, (8, 3, 3)).astype(np.int32),
                      "labels": rng.integers(0, 5, 8).astype(np.int32)},
        "molecule": {"feats": rng.normal(size=(4, 30, F)).astype(np.float32),
                     "edges": rng.integers(0, 30, (4, 64, 2)).astype(
                         np.int32),
                     "labels": rng.integers(0, 5, 4).astype(np.int32)}}
    out = []
    for regime, nb in batches.items():
        res = {}
        for dev in ("cpu", "cuda"):
            p = gnn.init_params(cfg, F, seed=7, device="cpu")
            p = {"layers": [_tree_to(lp, dev) for lp in p["layers"]]}
            b = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
            with torch.no_grad():
                logits = {"full": lambda: gnn.full_forward(
                    p, b["feats"], b["edges"], cfg),
                    "minibatch": lambda: gnn.minibatch_forward(
                        p, b["feats"], b, cfg),
                    "molecule": lambda: gnn.molecule_forward(
                        p, b["feats"], b["edges"], cfg)}[regime]()
            o = adam(GNN_LR)
            _, _, m = gnn.make_train_step(cfg, o, regime)(p, o.init(p), b)
            res[dev] = (logits.cpu(), float(m["loss"]), p)
        lerr = _max_err(res["cuda"][0], res["cpu"][0])
        loss_err = abs(res["cuda"][1] - res["cpu"][1]) / abs(res["cpu"][1])
        worst, far, n = 0.0, 0, 0
        for la, lc in zip(res["cuda"][2]["layers"], res["cpu"][2]["layers"]):
            for k in la:
                d = (la[k].cpu() - lc[k]).abs()
                worst = max(worst, float(d.max()))
                far = max(far, float((d > 1e-5).float().mean()))
        line = {"regime": regime, "logits_max_err": lerr,
                "loss_rel_err": loss_err, "param_max_err": worst,
                "param_far_share": far}
        check(lerr <= GNN_TOL and loss_err <= 1e-6,
              f"gnn {regime} reduced: card vs CPU logits {lerr:.2e}, loss "
              f"{loss_err:.2e}")
        check(far <= 0.01 and worst <= 2 * GNN_LR + 1e-6,
              f"gnn {regime} reduced: params max err {worst:.2e}, far share "
              f"{far:.4f}")
        out.append(line)
        print("gnn_cpu " + json.dumps(line), flush=True)
    return out


def graph_on_card(n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
                  gen: torch.Generator, seed: int) -> dict:
    """``make_graph``'s distribution drawn on the card (numpy takes tens of
    seconds at Reddit's and ogbn-products' sizes): the node popularity
    ``zipf(1.3)`` on the host, then on the card ``src`` by inverse
    transform of its CDF (``rng.choice``'s method), ``dst``, the labels
    and the features from ``gen``.  Edges int64 (src, dst)."""
    pop = np.random.default_rng(seed).zipf(1.3, n_nodes).astype(np.float64)
    cdf = torch.from_numpy(np.cumsum(pop / pop.sum())).to("cuda")
    cdf /= cdf[-1].clone()
    src = torch.empty(n_edges, dtype=torch.int64, device="cuda")
    step = 1 << 24
    for e0 in range(0, n_edges, step):
        n = min(step, n_edges - e0)
        u = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64)
        src[e0:e0 + n] = torch.searchsorted(cdf, u, right=True)
    dst = torch.randint(0, n_nodes, (n_edges,), generator=gen,
                        device="cuda")
    labels = torch.randint(0, n_classes, (n_nodes,), generator=gen,
                           device="cuda")
    centers = torch.randn((n_classes, d_feat), generator=gen, device="cuda")
    feats = centers[labels]
    feats += torch.randn((n_nodes, d_feat), generator=gen, device="cuda")
    return {"feats": feats, "src": src.clamp_(max=n_nodes - 1), "dst": dst,
            "labels": labels}


def gnn_agg_rows(g: dict, shape, timer) -> list:
    """The aggregation alone at ``shape``'s full graph (layer 1's input
    width): forward, and forward + backward, beside the bytes bound (the
    features, ids and the output once each) and ``torch.sparse.mm`` of
    the (dst, src) adjacency (built outside the timing)."""
    from repro_torch.models import gnn
    h = g["feats"]
    N, d = h.shape
    src, dst = g["graph"]["src"], g["graph"]["dst"]
    E = src.numel()
    adj = torch.sparse_coo_tensor(torch.stack([dst, src]),
                                  torch.ones(E, device="cuda"),
                                  (N, N)).coalesce().to_sparse_csr()
    want = torch.sparse.mm(adj, h)
    got = gnn.aggregate(h, src, dst, N)
    diff = (got - want).abs()
    err = float((diff / (want.abs() + 1)).max())
    # two float32 orders of a node's k-term sum: each within (k - 1) x
    # 2^-24 x sum|h| of the exact sum, sparse.mm's multiplicity products
    # and the float32 sum|h| within one more each: (k + 1) x 2^-23 x sum|h|
    agg_bound = ((g["graph"]["deg"] + 1)[:, None] * 2.0 ** -23
                 * torch.sparse.mm(adj, h.abs()))
    share = float((diff / agg_bound.clamp_min(1e-30)).max())
    check(share <= 1.0, f"gnn {shape.name}: aggregate vs sparse.mm "
                        f"{share:.3f} of the order bound (relative {err:.2e})")
    del diff, agg_bound
    hg = h.detach().clone().requires_grad_()
    dy = torch.randn((N, d), device="cuda")
    rows = []
    c_f = bound(2 * N * d * 4 + 2 * E * 8, E * d)
    c_fb = bound(4 * N * d * 4 + 4 * E * 8, 2 * E * d)
    for tag, fn, lib, c in (
            ("fwd", lambda: gnn.aggregate(h, src, dst, N),
             lambda: torch.sparse.mm(adj, h), c_f),
            ("fwd+bwd",
             lambda: torch.autograd.grad(gnn.aggregate(hg, src, dst, N),
                                         [hg], dy),
             lambda: torch.autograd.grad(torch.sparse.mm(adj, hg), [hg], dy),
             c_fb)):
        r = {"name": f"gnn_aggregate/{tag}", "shape": shape.name,
             "nodes": N, "edges": E, "dim": d, "ms": timer(fn),
             "library_ms": timer(lib), "max_rel_err": err,
             "order_bound_share": share, **c,
             "library": "torch.sparse.mm of the CSR adjacency"}
        r["plain_ms"] = r["ms"]
        rows.append(r)
        print("gnn_timing " + json.dumps(r), flush=True)
    del adj, want, got, hg, dy
    torch.cuda.empty_cache()
    return rows


def gnn_train_run(cfg, regime: str, shape, batch: dict, d_feat: int,
                  messages: int) -> dict:
    """GNN_STEPS ``adam`` steps on one batch: finite, falling, timed (host
    clock to the loss on the host), messages (gathered edges) per second,
    peak memory."""
    from repro_torch.models import gnn
    from repro_torch.optim.optimizers import adam
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p = gnn.init_params(cfg, d_feat, seed=GNN_SEED, device="cuda")
    o = adam(GNN_LR)
    st = o.init(p)
    step = gnn.make_train_step(cfg, o, regime)
    losses, ms = [], []
    for _ in range(GNN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, m = step(p, st, batch)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t) * 1e3)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"gnn {shape.name}: losses {losses}")
    med = statistics.median(ms[1:])
    line = {"shape": shape.name, "regime": regime, "card": smi(),
            "nodes": shape.n_nodes, "edges": shape.n_edges, "d_feat": d_feat,
            "messages": messages, "losses": losses, "step_ms": ms,
            "median_step_ms": med, "edges_s": messages / med * 1e3,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    return line


def gnn_phase(gen: torch.Generator) -> tuple:
    """Phase 17: the GNN family (``models.gnn``, graphsage-reddit at its
    widths, fp32) in its three regimes at ``GNN_SHAPES``' sizes.  First
    :func:`gnn_cpu_checks`.  Cora (``full_graph_sm``, ``make_graph`` in
    numpy): chunked against one-chunk aggregation, pad and out-of-range
    edges inert, 4 steps; ogbn-products full batch (2,449,029 nodes,
    61,859,140 edges, d 100; drawn on the card, :func:`graph_on_card`): 4
    steps and the aggregation timed alone; Reddit (232,965 nodes,
    114,615,892 edges, d 602; drawn on the card, its CSR sorted on the
    card and sampled on the host by ``make_sampler``, fanout (15, 10), 1024
    roots); 128 molecules of 30 nodes and 64 edges (``molecule_batches``);
    and ``launch.train`` with ``--arch graphsage-reddit`` as the CLI runs
    it, reduced and ``--full``."""
    from repro_torch.configs import GNN_SHAPES, get_config
    from repro_torch.data import synth
    from repro_torch.kernels import build
    from repro_torch.launch import train as launch_train
    from repro_torch.models import gnn

    t0 = time.perf_counter()
    build.reset_launches()
    cpu = gnn_cpu_checks()
    cfg = get_config("graphsage-reddit")
    lines, rows = [], []

    # -- Cora: chunking, pad edges, training
    sh = GNN_SHAPES["full_graph_sm"]
    g = synth.make_graph(sh.n_nodes, sh.n_edges, sh.d_feat, cfg.n_classes,
                         seed=GNN_SEED)
    b = {k: torch.from_numpy(v).to("cuda") for k, v in g.items()}
    p = gnn.init_params(cfg, sh.d_feat, seed=GNN_SEED, device="cuda")
    with torch.no_grad():
        whole = gnn.full_forward(p, b["feats"], b["edges"], cfg)
        keep = gnn.AGG_BYTES
        gnn.AGG_BYTES = 1000 * sh.d_feat * 4       # 1000 edges a chunk
        try:
            chunked = gnn.full_forward(p, b["feats"], b["edges"], cfg)
        finally:
            gnn.AGG_BYTES = keep
        pads = torch.tensor([[-1, 0], [sh.n_nodes, 1], [2, -1],
                             [3, sh.n_nodes]] * 4, device="cuda",
                            dtype=b["edges"].dtype)
        padded = gnn.full_forward(p, b["feats"],
                                  torch.cat([b["edges"], pads]), cfg)
    scale = float(whole.abs().max())
    ce, pe = _max_err(chunked, whole) / scale, _max_err(padded, whole) / scale
    check(ce <= GNN_TOL and pe <= GNN_TOL,
          f"gnn cora: chunked {ce:.2e}, padded {pe:.2e} vs one chunk")
    b["graph"] = gnn.graph_edges(b["edges"], sh.n_nodes)
    line = gnn_train_run(cfg, "full", sh, b, sh.d_feat, sh.n_edges)
    line.update(chunked_rel_err=ce, padded_rel_err=pe, drawn="numpy")
    lines.append(line)
    print("gnn " + json.dumps(line), flush=True)
    del b, p

    # -- ogbn-products, full batch
    sh = GNN_SHAPES["ogb_products"]
    g = graph_on_card(sh.n_nodes, sh.n_edges, sh.d_feat, cfg.n_classes, gen,
                      GNN_SEED)
    g["graph"] = {"src": g["src"], "dst": g["dst"],
                  "deg": torch.bincount(g["dst"], minlength=sh.n_nodes).to(
                      torch.float32)}
    b = {"feats": g["feats"], "edges": None, "graph": g["graph"],
         "labels": g["labels"]}
    line = gnn_train_run(cfg, "full", sh, b, sh.d_feat, sh.n_edges)
    line["drawn"] = "on the card"
    lines.append(line)
    print("gnn " + json.dumps(line), flush=True)
    timer = Timer(reps=5)
    rows += gnn_agg_rows(g, sh, timer)
    del g, b, timer
    torch.cuda.empty_cache()

    # -- Reddit, fanout-sampled minibatch
    sh = GNN_SHAPES["minibatch_lg"]
    g = graph_on_card(sh.n_nodes, sh.n_edges, sh.d_feat, cfg.n_classes, gen,
                      GNN_SEED + 1)
    t = time.perf_counter()
    order = torch.sort(g["src"], stable=True).indices
    indices = g["dst"][order].cpu().numpy()
    indptr = np.zeros(sh.n_nodes + 1, dtype=np.int64)
    np.cumsum(torch.bincount(g["src"], minlength=sh.n_nodes).cpu().numpy(),
              out=indptr[1:])
    del order
    csr_s = time.perf_counter() - t
    sample = gnn.make_sampler(indptr, indices, sh.fanout, seed=GNN_SEED)
    roots = np.random.default_rng(GNN_SEED).integers(0, sh.n_nodes,
                                                     sh.batch_nodes)
    t = time.perf_counter()
    ids = sample(roots)
    sample_ms = (time.perf_counter() - t) * 1e3
    b = {k: torch.from_numpy(v).to("cuda") for k, v in ids.items()}
    b["feats"] = g["feats"]
    b["labels"] = g["labels"][b["roots"].long()]
    f1, f2 = sh.fanout
    line = gnn_train_run(cfg, "minibatch", sh, b, sh.d_feat,
                         sh.batch_nodes * f1 * (1 + f2))
    line.update(csr_s=csr_s, sample_ms=sample_ms, fanout=list(sh.fanout),
                roots=sh.batch_nodes, drawn="on the card; CSR sorted on "
                                            "the card, sampled on the host")
    lines.append(line)
    print("gnn " + json.dumps(line), flush=True)
    del g, b, indices, indptr
    torch.cuda.empty_cache()

    # -- molecules
    sh = GNN_SHAPES["molecule"]
    mb = next(synth.molecule_batches(sh.graph_batch, sh.n_nodes, sh.n_edges,
                                     sh.d_feat, cfg.n_classes, 1,
                                     seed=GNN_SEED))
    b = {k: torch.from_numpy(v).to("cuda") for k, v in mb.items()}
    line = gnn_train_run(cfg, "molecule", sh, b, sh.d_feat,
                         sh.graph_batch * sh.n_edges)
    line["drawn"] = "numpy"
    lines.append(line)
    print("gnn " + json.dumps(line), flush=True)

    # -- the CLI
    cli = {}
    for argv in (["--arch", "graphsage-reddit", "--steps", "50"],
                 ["--arch", "graphsage-reddit", "--full", "--steps", "50"]):
        out = launch_train.main(argv)
        check(np.isfinite(out["final_loss"])
              and out["final_loss"] < out["first_loss"],
              f"gnn cli {argv}: {out}")
        cli[" ".join(argv)] = out
    print("gnn_cli " + json.dumps(cli), flush=True)
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    print(f"gnn phase: {time.perf_counter() - t0:.1f} s; kernel launches "
          f"{launches} (none on this path)", flush=True)
    return cpu, lines, rows, cli


# ----------------------------------------------------------- dry-run phase
# the cut cells this phase runs for real and dry: (label, arch, shape, the
# shape's cut, the builder's keywords)
DRY_RUNS = (("rmc4 serve split", "rmc4", "serve_p99", {"batch": 2048},
             {"front_end": "split"}),
            ("rmc4 serve fused", "rmc4", "serve_p99", {"batch": 2048},
             {"front_end": "fused"}),
            ("rmc4 train", "rmc4", "train_batch", {"batch": 2048}, {}),
            ("llama decode", "llama3.2-3b", "decode_32k",
             {"global_batch": 8}, {}))
DRY_STEPS = 5            # timed steps of each cut cell
# whether one card holds a cell: the uncut cells that phases 15-16 cut
# (PERF.md section 4) must not fit, the cuts they run must: (label, arch,
# shape, config changes, shape cut, fits)
DRY_FITS = (
    ("llama decode_32k", "llama3.2-3b", "decode_32k", {}, {}, False),
    ("llama decode b8", "llama3.2-3b", "decode_32k", {},
     {"global_batch": 8}, True),
    ("granite decode_32k", "granite-moe-1b-a400m", "decode_32k", {}, {},
     False),
    ("granite decode b8", "granite-moe-1b-a400m", "decode_32k", {},
     {"global_batch": 8}, True),
    ("llama train_4k", "llama3.2-3b", "train_4k", {}, {}, False),
    ("llama train b2", "llama3.2-3b", "train_4k", {}, {"global_batch": 2},
     True),
    ("deepseek-v3 decode_32k", "deepseek-v3-671b", "decode_32k", {}, {},
     False),
    ("deepseek-v3 4 layers decode b64", "deepseek-v3-671b", "decode_32k",
     {"depth": (3, 1), "mtp_depth": 0}, {"global_batch": 64}, True),
    ("deepseek-v3 4 layers train b2", "deepseek-v3-671b", "train_4k",
     {"depth": (3, 1), "mtp_depth": 0, "train_accum": 1},
     {"global_batch": 2}, False),
    ("deepseek-v3 3 layers train b2", "deepseek-v3-671b", "train_4k",
     {"depth": (3, 0), "mtp_depth": 0, "train_accum": 1},
     {"global_batch": 2}, True),
)


def _out_layout(o) -> list:
    outs = [] if o is None else [o] if torch.is_tensor(o) else list(o)
    return [(tuple(t.shape), str(t.dtype), str(t.device), t.stride())
            for t in outs]


def dryrun_shape_checks(gen: torch.Generator) -> list:
    """Each kernel against its shape function at RMC4's widths (B 2048, 8
    tables of L 8, D 128; 4 cold shards for the partial pools): the kernel
    on real inputs, the shape function on fake copies of them (fake CUDA
    tensors), outputs equal in shape, dtype, device and strides."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import fake
    rows = []
    for storage in ("fp32", "int8"):
        cases = fake.kernel_cases("cuda", gen, B=2048, G=8, L=8, D=128, S=4,
                                  rows=4096, storage=storage)
        check(set(cases) == set(fake.wrappers()), "a kernel has no case")
        for name, args in cases.items():
            want = _out_layout(fake.wrappers()[name](*args))
            torch.cuda.synchronize()
            with FakeTensorMode() as mode:
                fargs = tuple(mode.from_tensor(a) if torch.is_tensor(a)
                              else a for a in args)
                got = _out_layout(fake.shape_functions()[name](*fargs))
            check(got == want, f"dryrun {name} {storage}: shape function "
                  f"{got} != kernel {want}")
            rows.append({"name": name, "storage": storage, "outputs": want})
        del cases
    torch.cuda.empty_cache()
    return rows


def _cut_cfg(cfg, changes: dict):
    from repro_torch.launch.cells import lm_depth_variant
    changes = dict(changes)
    if "depth" in changes:
        cfg = lm_depth_variant(cfg, *changes.pop("depth"))
    return dataclasses.replace(cfg, **changes) if changes else cfg


def dryrun_phase(gen: torch.Generator) -> tuple:
    """Phase 18: the dry-run (``launch/dryrun.py``) against the card.
    Every kernel against its shape function (:func:`dryrun_shape_checks`);
    then the cut cells of ``DRY_RUNS``, each traced on fake CUDA tensors
    and run once for real under ``launch.op_stats``: the FLOPs by dtype
    and the kernel calls equal, and the calls equal the kernels' launch
    counts (zeroed just before the real step); the predicted peak above
    the arguments beside ``torch.cuda.max_memory_allocated``, and the
    roofline time beside the measured step.  Last, ``fits_80gb`` of the
    cells in ``DRY_FITS``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import cells, dryrun, op_stats

    t0 = time.perf_counter()
    shapes = dryrun_shape_checks(gen)
    print("dryrun_shapes " + json.dumps(
        {"checked": len(shapes), "kernels": sorted({r["name"]
                                                   for r in shapes})}),
        flush=True)
    lines, launches = [], {k: 0 for k in build.KERNELS}
    for label, arch, shape, cut, kw in DRY_RUNS:
        cfg = get_config(arch)
        sh = dataclasses.replace(cfg.shapes()[shape], **cut)
        t = time.perf_counter()
        _, dry, layers = dryrun.count_cell(arch, shape, "cuda", shape=sh,
                                           **kw)
        trace_s = time.perf_counter() - t
        roof = dryrun.roofline(dry, 0.0)
        torch.cuda.empty_cache()
        cell = cells.build_cell(arch, shape, "cuda", seed=0, shape=sh, **kw)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        real, out = op_stats.summarize(cell.fn, *cell.args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        launched = {k: v.launches for k, v in build.KERNELS.items()
                    if v.launches}
        for k in build.KERNELS:
            launches[k] += build.KERNELS[k].launches
        check(all(bool(torch.isfinite(t).all())
                  for t in op_stats.tensors_of(out) if t.is_floating_point()),
              f"dryrun {label}: output not finite")
        del out
        check(dry.flops_by_dtype == real.flops_by_dtype,
              f"dryrun {label}: FLOPs {dry.flops_by_dtype} != "
              f"{real.flops_by_dtype}")
        check(dry.kernels == real.kernels == launched,
              f"dryrun {label}: kernel calls {dry.kernels} / "
              f"{real.kernels} / launched {launched}")
        ts = []
        for i in range(DRY_STEPS + 2):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            cell.fn(*cell.args)
            e.record()
            e.synchronize()
            if i >= 2:
                ts.append(s.elapsed_time(e))
        line = {"cell": label, "arch": arch, "shape": shape, "cut": cut,
                **kw, "layers": layers, "trace_s": trace_s,
                "flops_by_dtype": dry.flops_by_dtype,
                "dot_bytes": dry.dot_bytes, "real_dot_bytes": real.dot_bytes,
                "kernels": dry.kernels, "launches": launched,
                "argument_bytes": dry.argument_bytes,
                "predicted_peak_bytes": dry.peak_bytes,
                "measured_peak_bytes": peak,
                "predicted_ms": max(roof["compute_s"],
                                    roof["memory_s"]) * 1e3,
                "compute_ms": roof["compute_s"] * 1e3,
                "memory_ms": roof["memory_s"] * 1e3,
                "measured_ms": statistics.median(ts)}
        lines.append(line)
        print("dryrun " + json.dumps(line), flush=True)
        del cell
        torch.cuda.empty_cache()
    for k in ("masked_sls", "dot_interaction", "fused_front_end"):
        check(launches[k] > 0, f"dryrun phase: {k} never launched")

    fits = []
    for label, arch, shape, changes, cut, want in DRY_FITS:
        cfg = _cut_cfg(get_config(arch), changes)
        sh = dataclasses.replace(cfg.shapes()[shape], **cut)
        t = time.perf_counter()
        _, s, layers = dryrun.count_cell(arch, shape, "cuda", cfg=cfg,
                                         shape=sh)
        total = s.argument_bytes + s.peak_bytes
        got = total < dryrun.CARD_BYTES
        rec = {"cell": label, "layers": layers, "argument_bytes":
               s.argument_bytes, "temp_bytes": s.peak_bytes,
               "total_bytes": total, "fits_80gb": got,
               "trace_s": time.perf_counter() - t}
        fits.append(rec)
        print("dryrun_fits " + json.dumps(rec), flush=True)
        check(got == want, f"dryrun {label}: fits_80gb {got}, the smoke's "
              f"cuts say {want}")
    print(f"dryrun phase: {time.perf_counter() - t0:.1f} s; kernel launches "
          f"{launches}", flush=True)
    return lines, fits, launches


def print_slice_rows(result) -> None:
    """The slice phase's kernel timings and serve steps (``timing`` and
    ``serve_step`` lines, the rows ``chip_ab.py`` reads), for ``--only
    slice``; a whole run prints them with the other phases' at its end."""
    _, details, steps, _, _ = result
    for d in details:
        print("timing " + json.dumps(d), flush=True)
    for st in steps:
        print("serve_step " + json.dumps(st), flush=True)


PHASES = ("kernel", "slice", "runtime", "updates", "integrity", "faults",
          "recsys", "paper", "train", "lm", "lm_train", "gnn", "dryrun")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="", metavar="PHASE[,PHASE]",
                    help="run only these phases (of " + ", ".join(PHASES)
                         + ") after the build, for a quicker look; such a "
                           "run prints no kernels or result line")
    args = ap.parse_args(argv)
    only = [p for p in args.only.split(",") if p]
    for p in only:
        if p not in PHASES:
            ap.error(f"unknown phase {p!r}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a GPU",
              file=sys.stderr)
        raise SystemExit(2)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build
    from repro_torch.device import resolve_device

    t_start = time.perf_counter()
    resolve_device("cuda")        # TF32 off for matmuls and cuDNN
    print(smi(), flush=True)          # name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t = time.perf_counter()
    paths = build.build_all()
    print(f"built {len(paths)} libraries ({len(build.KERNELS)} kernels) in "
          f"{time.perf_counter() - t:.1f} s; {build.libraries_line()}",
          flush=True)
    for name, p in paths.items():
        log = p.with_suffix(".log").read_text() if p.with_suffix(
            ".log").exists() else ""
        for kernel, regs, spill in ptxas_report(log):
            print(f"  ptxas {name}: {kernel}: {regs}; {spill}", flush=True)
    print(json.dumps({"kernels_built": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces} for k in build.KERNELS.values()]}),
        flush=True)

    gen = torch.Generator(device="cuda").manual_seed(1234)
    if only:
        run = {"kernel": lambda: kernel_phase(gen),
               "slice": lambda: print_slice_rows(slice_phase(Timer())),
               "runtime": runtime_phase,
               "updates": lambda: updates_phase(gen),
               "integrity": lambda: integrity_phase(gen),
               "faults": faults_phase,
               "recsys": lambda: recsys_phase(gen),
               "paper": lambda: paper_phase(gen),
               "train": lambda: train_phase(gen),
               "lm": lambda: lm_phase(gen),
               "lm_train": lambda: lm_train_phase(gen),
               "gnn": lambda: gnn_phase(gen),
               "dryrun": lambda: dryrun_phase(gen)}
        for p in only:
            run[p]()
            torch.cuda.empty_cache()
        print(f"total {time.perf_counter() - t_start:.1f} s; partial run "
              f"({','.join(only)}): no result line", flush=True)
        return
    kernel_phase(gen)
    timer = Timer()
    launches, details, steps, dedup_lines, maint = slice_phase(timer)
    del timer                   # its 256 MB flush buffer
    torch.cuda.empty_cache()
    _, rt_launches = runtime_phase()
    _, up_timing, _, up_launches = updates_phase(gen)
    details += up_timing
    integ_rows, _, integ_launches = integrity_phase(gen)
    details += integ_rows
    _, _, fault_launches = faults_phase()
    torch.cuda.empty_cache()
    _, _, rec_rows, rec_launches, rec_dedup_launches = recsys_phase(gen)
    details += rec_rows
    torch.cuda.empty_cache()
    _, _, paper_launches = paper_phase(gen)
    torch.cuda.empty_cache()
    _, _, train_launches, _ = train_phase(gen)
    torch.cuda.empty_cache()
    lm_phase(gen)
    torch.cuda.empty_cache()
    lm_train_phase(gen)
    torch.cuda.empty_cache()
    gnn_phase(gen)
    torch.cuda.empty_cache()
    _, _, dry_launches = dryrun_phase(gen)
    torch.cuda.empty_cache()
    for d in details:
        print("timing " + json.dumps(d), flush=True)
    for s in steps:
        print("serve_step " + json.dumps(s), flush=True)
    for d in dedup_lines:
        print("dedup " + json.dumps(d), flush=True)
    for m in maint:
        print("maintenance " + json.dumps(m), flush=True)

    # (timing row, the path whose serve runs count the kernel's launches)
    pick = {"masked_sls": ("masked_sls/cold", "off"),
            "dot_interaction": ("dot_interaction", "off"),
            "fused_front_end": ("fused_front_end", "off"),
            "masked_sls_dedup": ("masked_sls_dedup/cold", "on"),
            "fused_front_end_dedup": ("fused_front_end_dedup", "on"),
            "fused_partial_pool": ("fused_partial_pool", "tp"),
            "fused_partial_pool_dedup": ("fused_partial_pool_dedup", "tp"),
            "fused_resume": ("fused_resume", "tp")}
    kernels = []
    for k in build.KERNELS.values():
        if k.name == "page_checksums":  # phase 10's path, the whole store
            d = next(x for x in integ_rows if x["storage"] == "fp32"
                     and x["n_shards"] == 1)
            kernels.append({
                "name": k.name, "route": "cuda", "source": k.source,
                "replaces": k.replaces, "launches": integ_launches[k.name],
                **{key: d[key] for key in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms")},
                "runtime_launches": rt_launches[k.name],
                "faults_launches": fault_launches[k.name],
                "paper_launches": paper_launches[k.name],
                "train_launches": train_launches[k.name],
                "dryrun_launches": dry_launches[k.name],
                "shape": f"rmc4 fp32 whole store, {d['pages']} pages "
                         f"({d['hot_pages']} hot), 1 shard"})
            continue
        if k.name == "apply_deltas":    # phase 9's path, at a full chunk
            d = next(x for x in up_timing if x["storage"] == "fp32")
            kernels.append({
                "name": k.name, "route": "cuda", "source": k.source,
                "replaces": k.replaces, "launches": up_launches[k.name],
                **{key: d[key] for key in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms")},
                "runtime_launches": rt_launches[k.name],
                "paper_launches": paper_launches[k.name],
                "train_launches": train_launches[k.name],
                "dryrun_launches": dry_launches[k.name],
                "shape": f"rmc4 fp32 {d['rows']} rows x {d['dim']} "
                         f"({d['hot_rows']} hot), library index_add_ per "
                         "tier"})
            continue
        row, path = pick[k.name]
        d = next(x for x in details if x["name"] == row
                 and x["arch"] == "rmc4" and x["storage"] == "fp32"
                 and x["batch"] == 2048
                 and x.get("n_shards", 1) == (TP if path == "tp" else 1))
        rec_extra = {}
        if k.name in ("masked_sls", "masked_sls_dedup"):
            # phase 12: its runtime runs' launches (masked_sls) or the
            # dedup-on run's, and the SASRec D = 50 cold-tier lookup
            d50 = next(x for x in rec_rows if x["name"] == row
                       and x["arch"] == "sasrec" and x["storage"] == "fp32")
            rec_extra = {
                "recsys_launches": (rec_launches[k.name]
                                    if k.name == "masked_sls"
                                    else rec_dedup_launches),
                "recsys_d50": {key: d50[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err", "bags", "dim")}}
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[path][k.name],
            "max_abs_err": d["max_abs_err"], "ms": d["ms"],
            "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": d["library_ms"],
            "runtime_launches": rt_launches[k.name], **rec_extra,
            "paper_launches": paper_launches[k.name],
            "train_launches": train_launches[k.name],
            "dryrun_launches": dry_launches[k.name],
            "shape": f"rmc4 fp32 batch 2048 ({row}, "
                     f"{d.get('n_shards', 1)} shard(s))"})
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
