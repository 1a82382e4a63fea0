"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each compared number beside its limit); the same checks are the last lines
of standard error.  With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of the window and the harness's own spans.

Exits non-zero, printing no result, without a card (or with fewer cards
than the cell asks for), without the port's sources beside the benchmark,
or if JAX, Flax or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "bench" / "out" / "cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """The program's build and kernel caches inside the checkout, at fixed
    paths (the port's own CUDA libraries build into ``build/kernels``);
    few host threads, so that one run loads the host steadily."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_ext")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        p for p in sys.path[1:] if p not in (str(ROOT), str(ROOT / "src"))]


def _card_query():
    """``nvidia-smi`` asked for the card's name and power limit, started at
    once so that it runs while the harness imports."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    except OSError as e:
        return f"nvidia-smi unavailable: {e}"


def _card_line(query) -> str:
    """The query's answer; the process has ended when this returns."""
    if isinstance(query, str):
        return query
    try:
        out, err = query.communicate(timeout=20)
    except subprocess.TimeoutExpired:
        query.kill()
        query.communicate()
        return "nvidia-smi timed out"
    return out.strip() or err.strip()


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        ap.error("--seed must be >= 0 and --seconds > 0")
    _environment()
    card = _card_query()
    try:
        return _run(args, card)
    finally:
        if not isinstance(card, str) and card.poll() is None:
            card.kill()
            card.communicate()


def _run(args, card) -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no port beside the benchmark: {ROOT / 'src'} lacks "
              "repro_torch", file=sys.stderr)
        return 2
    t = time.perf_counter()
    import torch
    from bench import harness
    t_imports = time.perf_counter()
    spec = harness.load_spec(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < spec["chips"]:
        print(f"the cell asks for {spec['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    t_driver = time.perf_counter()
    torch.zeros(1, device="cuda:0")
    print(f"set-up s: start {t - T_START:.3f}, imports {t_imports - t:.3f}, "
          f"CUDA driver {t_driver - t_imports:.3f}, CUDA context "
          f"{time.perf_counter() - t_driver:.3f}", file=sys.stderr,
          flush=True)
    print(f"card: {_card_line(card)}", file=sys.stderr, flush=True)
    result = harness.run_cell(spec, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules the port must not need: {bad}",
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
