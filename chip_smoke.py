"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the three CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all in parallel);
2. kernel phase: holds each kernel against its plain PyTorch version on
   the card -- D in {16, 18, 64, 128}, fp32 and int8 tables, weights of 0/1
   (bitwise) and general weights (tolerance below), L = 7, batches that
   no block size divides, and an empty hot tier;
3. slice phase: serves RMC1 and RMC4 at their published widths through
   ``repro_torch.launch.serve`` (fp32 and int8 cold tier, split and fused
   front end, batch 32 over a seeded zipfian stream plus one batch of
   2048, a profiled hot tier of 5 % of the pages) and checks that scores
   are finite and in (0, 1), that fused == split bitwise, that kernel-path
   lookups equal the plain path bitwise and kernel-path scores the plain
   path's within tolerance, and that every kernel was launched by the
   serve runs (launch counts are zeroed just before them and read just
   after);
4. times each kernel (CUDA events, L2 flushed, median), its plain version
   and the library call where one exists, beside its bound
   max(bytes / 3.35 TB/s, flops / 67 TFLOP/s) from this run's inputs, and
   times the serve steps at batch 32 and 2048 (host clock to a
   synchronize), with the device's busy time in them from
   ``torch.profiler``.

The line before the last is the ``{"kernels": [...]}`` JSON; the last is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before either.  Exits non-zero without CUDA, and when run outside the
repository (it needs ``src/repro_torch``).

Tolerances: with general weights the kernels' fmaf accumulate and the
plain versions' multiply-then-add may differ by one rounding per step, so
SLS results must agree within 2 * L * 2^-23 * sum_l |f_l * row_l|; the
interaction kernel sums over d in order while ``torch.bmm`` does not, so
dots agree within 2 * D * 2^-23 * sum_d |x_i[d] * x_j[d]|.  Serve scores
(after the MLPs and a sigmoid) of the kernel and plain paths agree within
1e-5 absolute.
"""
from __future__ import annotations

import json
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
    the host enqueues, then records events around the call alone."""

    def __init__(self, reps: int = 25):
        self.reps = reps
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
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


def device_busy(step, state, batch, step_ms: float, reps: int = 10) -> dict:
    """Device time of one serve step from ``torch.profiler`` (the sum of
    its kernels and copies), its share of the step's host-clock time, and
    the kernels that take most of it.  ``None`` where the profiler saw no
    device activity."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step(state, batch)
        torch.cuda.synchronize()
    dev = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = ev.cuda_time_total
            dev[ev.key] = t / 1e3 / reps                 # us -> ms per step
    busy = sum(dev.values())
    if busy <= 0:
        return {"device_busy_ms": None, "idle_share": None,
                "top_device_ms": None}
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
    return {"device_busy_ms": busy, "idle_share": 1 - busy / step_ms,
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
    check(bool(torch.equal(got, want)),
          f"{what}: not bitwise equal (max err "
          f"{(got - want).abs().max().item():.3e})")


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
                    tol = dot_tol(feats)
                    if weighting == "general":
                        # pooled features may differ by the SLS tolerance
                        # too: propagate it through the dots
                        a = (sls_tol(table, flat, own3.reshape(N, L), w,
                                     scales)
                             + sls_tol(hot, flat, hot3.reshape(N, L), w,
                                       None)).reshape(B, G, D)
                        a = torch.cat([torch.zeros_like(x[:, None]), a], 1)
                        e = torch.bmm(a, feats.abs().transpose(1, 2))
                        ij = torch.tril_indices(G + 1, G + 1, -1,
                                                device="cuda")
                        tol = tol + 2 * (e + e.transpose(1, 2))[:, ij[0],
                                                                ij[1]]
                    assert_close(fk, fp, tol, f"fused vs plain {tag}")
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
    torch.cuda.synchronize()
    print(f"kernel phase: {n_cases} cases + empty-hot cases passed; "
          f"launches {dict((k, v.launches) for k, v in build.KERNELS.items())}",
          flush=True)


# ----------------------------------------------------------- slice phase
def slice_phase(timer: Timer):
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve as srv
    from repro_torch.launch.serve import pad_batch
    from repro_torch.serving.batcher import Bucket

    n_req, batch, big = 256, 32, 2048
    launches = {k: 0 for k in build.KERNELS}
    details, steps = [], []
    main_inputs = None
    for arch in ("rmc1", "rmc4"):
        cfg = get_config(arch)
        for storage in ("fp32", "int8"):
            t0 = time.perf_counter()
            reqs = srv.request_stream(cfg, n_req, seed=0, storage=storage)
            bulk = srv.request_stream(cfg, big, seed=1, storage=storage)
            b = srv.bind_model(cfg, "cuda", storage=storage, seed=0,
                               profile=reqs[: n_req // 4])
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            tag = f"{arch} {storage}"
            eng = b.engine
            # ---- the main path: counts zeroed just before, read after
            build.reset_launches()
            res = {fe: srv.serve(b, b.step(fe), reqs, batch)
                   for fe in ("split", "fused")}
            bulk_res = {fe: srv.serve(b, b.step(fe), bulk, big)
                        for fe in ("split", "fused")}
            got = {k: v.launches for k, v in build.KERNELS.items()}
            for k in launches:
                check(got[k] > 0, f"{tag}: kernel {k} was not launched by "
                                  "the serve runs")
                launches[k] += got[k]
            n_steps = res["split"]["batches"] + bulk_res["split"]["batches"]
            # ---- checks on the served scores
            for fe in ("split", "fused"):
                for r in (res[fe], bulk_res[fe]):
                    s = r["scores"]
                    check(bool(np.isfinite(s).all()
                               and (s > 0).all() and (s < 1).all()),
                          f"{tag} {fe}: scores not finite in (0, 1)")
            for r in (res, bulk_res):
                check(np.array_equal(r["split"]["scores"],
                                     r["fused"]["scores"]),
                      f"{tag}: fused != split bitwise")
            plain = srv.serve(b, b.step("split", impl="torch"), reqs, batch)
            err = float(np.abs(plain["scores"] - res["split"]["scores"]).max())
            check(err <= 1e-5, f"{tag}: kernel vs plain serve scores differ "
                               f"by {err:.3e} > 1e-5")
            rec = eng.plan_stats()["front_end"]
            check(all(v["resolved"] == "fused" for k, v in rec.items()
                      if v["requested"] == "fused"), f"{tag}: {rec}")
            # ---- lookups: kernel == plain bitwise (0/1 weights)
            hb = pad_batch(bulk, Bucket(big, cfg.pooling), eng.device)
            lk = eng.lookup(b.state, hb["indices"], hb["weights"])
            lp = eng.lookup(b.state, hb["indices"], hb["weights"],
                            impl="torch")
            assert_equal(lk, lp, f"{tag}: lookup kernel vs plain")
            idx = hb["indices"]
            loc, owned, is_hot, scale = eng._address(b.state, idx)
            real = hb["weights"] != 0
            hot_share = float((is_hot & real).sum() / real.sum())
            print(f"{tag}: setup {setup_s:.1f} s; served {n_req} requests at "
                  f"batch {batch} and {big} at batch {big}, split and "
                  f"fused; hot-tier share of lookups {hot_share:.3f}; "
                  f"kernel-vs-plain score err {err:.2e}; launches {got} "
                  f"over {n_steps} split + {n_steps} fused steps", flush=True)
            # ---- per-kernel timing at this config's serve shapes
            for B in (batch, big):
                sub = {k: v[:B] for k, v in hb.items()}
                G, L, D = cfg.n_tables, cfg.pooling, cfg.emb_dim
                loc, owned, is_hot, scale = eng._address(b.state,
                                                         sub["indices"])
                x = torch.randn((B, D), device="cuda")
                flat = loc.reshape(-1, L)
                own2, hot2 = owned.reshape(-1, L), is_hot.reshape(-1, L)
                w2 = sub["weights"].reshape(-1, L)
                s2 = None if scale is None else scale.reshape(-1, L)
                feats = torch.cat([x[:, None], lk[:B]], 1).contiguous()
                F = G + 1
                P = F * (F - 1) // 2
                calls = {
                    "masked_sls/cold": (
                        lambda: ops.masked_sls(b.state.cold, flat, own2, w2,
                                               s2),
                        lambda: ops.masked_sls(b.state.cold, flat, own2, w2,
                                               s2, impl="torch"),
                        sls_cost(b.state.cold, flat, own2, w2, s2)),
                    "masked_sls/hot": (
                        lambda: ops.masked_sls(b.state.hot, flat, hot2, w2),
                        lambda: ops.masked_sls(b.state.hot, flat, hot2, w2,
                                               impl="torch"),
                        sls_cost(b.state.hot, flat, hot2, w2, None)),
                    "dot_interaction": (
                        lambda: ops.dot_interaction(feats),
                        lambda: ops.dot_interaction(feats, impl="torch"),
                        interaction_cost(B, F, D, P)),
                    "fused_front_end": (
                        lambda: ops.fused_front_end(
                            b.state.cold, b.state.hot, x, loc, owned, is_hot,
                            sub["weights"], scale),
                        lambda: ops.fused_front_end(
                            b.state.cold, b.state.hot, x, loc, owned, is_hot,
                            sub["weights"], scale, impl="torch"),
                        fused_cost(b.state.cold, b.state.hot, loc, owned,
                                   is_hot, sub["weights"], scale)),
                }
                lib = {}
                if storage == "fp32":
                    safe = torch.where(own2, flat, torch.zeros_like(flat))
                    fw = own2.float() * w2
                    lib["masked_sls/cold"] = lambda: torch.nn.functional \
                        .embedding_bag(safe, b.state.cold, mode="sum",
                                       per_sample_weights=fw)
                ij = torch.tril_indices(F, F, -1, device="cuda")
                lib["dot_interaction"] = lambda: torch.bmm(
                    feats, feats.transpose(1, 2))[:, ij[0], ij[1]]
                for name, (kfn, pfn, cost) in calls.items():
                    kout, pout = kfn(), pfn()
                    what = f"{name} {tag} batch {B}"
                    if name.startswith("masked_sls"):       # 0/1 weights
                        assert_equal(kout, pout, what)
                    else:
                        assert_close(kout, pout, dot_tol(feats), what)
                    if name == "fused_front_end":
                        assert_equal(kout, ops.dot_interaction(feats),
                                     f"fused == split {tag} batch {B}")
                    d = {"name": name, "arch": arch, "storage": storage,
                         "batch": B, "ms": timer(kfn), "plain_ms": timer(pfn),
                         "library_ms": (timer(lib[name]) if name in lib
                                        else None),
                         "max_abs_err": float((kout - pout).abs().max()),
                         **cost}
                    details.append(d)
                    if (arch, storage, B, name) == ("rmc4", "fp32", big,
                                                    "masked_sls/cold"):
                        main_inputs = d
                # ---- serve step time: host clock to synchronize
                for fe in ("split", "fused"):
                    step = b.step(fe)
                    for _ in range(3):
                        step(b.state, sub)
                    torch.cuda.synchronize()
                    ts = []
                    for _ in range(20):
                        t = time.perf_counter()
                        step(b.state, sub)
                        torch.cuda.synchronize()
                        ts.append((time.perf_counter() - t) * 1e3)
                    ms = statistics.median(ts)
                    steps.append({"arch": arch, "storage": storage,
                                  "front_end": fe, "batch": B,
                                  "step_ms": ms,
                                  **device_busy(step, b.state, sub, ms)})
            del b, hb, lk, lp
            torch.cuda.empty_cache()
    check(main_inputs is not None, "no main-path timing")
    return launches, details, steps


def main() -> None:
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
    print(f"built {len(paths)} kernels in {time.perf_counter() - t:.1f} s",
          flush=True)
    for name, p in paths.items():
        log = p.with_suffix(".log").read_text() if p.with_suffix(
            ".log").exists() else ""
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    print(json.dumps({"kernels_built": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces} for k in build.KERNELS.values()]}),
        flush=True)

    gen = torch.Generator(device="cuda").manual_seed(1234)
    kernel_phase(gen)
    timer = Timer()
    launches, details, steps = slice_phase(timer)
    for d in details:
        print("timing " + json.dumps(d), flush=True)
    for s in steps:
        print("serve_step " + json.dumps(s), flush=True)

    pick = {"masked_sls": "masked_sls/cold",
            "dot_interaction": "dot_interaction",
            "fused_front_end": "fused_front_end"}
    kernels = []
    for k in build.KERNELS.values():
        d = next(x for x in details if x["name"] == pick[k.name]
                 and x["arch"] == "rmc4" and x["storage"] == "fp32"
                 and x["batch"] == 2048)
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": d["max_abs_err"], "ms": d["ms"],
            "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": d["library_ms"],
            "shape": f"rmc4 fp32 batch 2048 ({pick[k.name]})"})
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
