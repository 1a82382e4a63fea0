"""The readings a cell's limits are set from (``limits/<cell>.json``).

    python bench/calibrate.py --workload <cell> --seeds 101,102,...
        [--seconds 3] [--control-seeds 201,202,203] [--out FILE]

Every reading is a whole run of the cell through ``harness.run_cell``
(set-up, a window of ``--seconds`` at the cell's own load and sizes, every
answer compared with the reference), in one process so that the card and
the build are shared.

``--seeds``: the program's readings; the lower reading is the largest.
``--control-seeds``: the control's (``bench/control.py``: the reference in
the program's place, one precision below the configuration's: ``tf32`` for
float32 matrix products, ``int4`` for an int8 tier; an int8 configuration
reports both); the upper reading is the smallest, and each has to come out
``correct: false``.  Prints one JSON line per reading.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import control, harness
    spec = harness.load_spec(args.workload, ROOT)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(dict(rec, workload=args.workload))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def reading(seed, system=None):
        r = harness.run_cell(spec, seed, args.seconds, False, "cuda:0",
                             time.perf_counter(), log=lambda msg: None,
                             system=system)
        return {"seed": seed, "correct": r["correct"],
                "requests": r["attempted"],
                **{k: v["value"] for k, v in r["checks"].items()},
                "metrics": {k: v["value"] for k, v in r["metrics"].items()}}

    for seed in (int(s) for s in args.seeds.split(",") if s):
        emit({"reading": "program", **reading(seed)})
    ref, _ = harness._family(spec["config"])
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        for prec in control.precisions(spec["config"]):
            emit({"reading": "control", "precision": prec,
                  **reading(seed, control.Control(ref, prec))})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
