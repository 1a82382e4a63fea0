"""Parent -> change kernel and serve-step numbers on one card, from
``chip_smoke.py``.

    python3 chip_ab.py PARENT_DIR CHANGE_DIR [--out DIR]

PARENT_DIR and CHANGE_DIR are checkouts (``git archive``) of two commits.
This runs CHANGE_DIR's ``chip_smoke.py --only slice`` in both -- the build
and the slice phase, which prints every row read here (about 95 s a run
on an H100); in PARENT_DIR it drives the parent's package, calling only
the kernels' public wrappers -- in turns parent, change, change, parent,
each run's output in ``DIR/run<i>_<tree>.log`` (default ``build/ab``),
and fails if a run fails.  Then it prints, for every ``timing`` row of
``chip_smoke.py`` (kernel, configuration, batch, shards, and how the L2
was flushed), the mean time of the parent's two runs and of the
change's two, change / parent, the bound and, where the row has one,
the mean time of a copy of the same bytes over all runs; and for every
``serve_step`` row the device operations and busy time per step, parent
and change.  Each run prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import collections
import json
import shutil
import subprocess
import sys
from pathlib import Path


def run(tree: Path, smoke: Path, log: Path) -> None:
    dst = tree / "chip_smoke.py"
    if dst.resolve() != smoke.resolve():
        shutil.copyfile(smoke, dst)
    with open(log, "w") as f:
        rc = subprocess.run([sys.executable, "chip_smoke.py", "--only",
                             "slice"], cwd=tree, stdout=f,
                            stderr=subprocess.STDOUT).returncode
    if rc != 0:
        print(log.read_text()[-4000:])
        raise SystemExit(f"chip_ab: chip_smoke.py failed in {tree} (rc={rc})")


def rows(log: Path, tag: str) -> list:
    out = []
    for line in log.read_text().splitlines():
        if line.startswith(tag + " "):
            out.append(json.loads(line[len(tag) + 1:]))
    return out


def mean(v):
    return sum(v) / len(v) if v else float("nan")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--out", type=Path, default=Path("build/ab"))
    a = ap.parse_args()
    a.out.mkdir(parents=True, exist_ok=True)
    smoke = a.change / "chip_smoke.py"
    logs = {"parent": [], "change": []}
    for i, which in enumerate(("parent", "change", "change", "parent")):
        log = a.out / f"run{i}_{which}.log"
        run(getattr(a, which), smoke, log)
        logs[which].append(log)
        print(f"run {i} {which}: {log.read_text().splitlines()[0]}",
              flush=True)
    ms = collections.defaultdict(lambda: {"parent": [], "change": []})
    copy = collections.defaultdict(list)
    bound = {}
    for which, paths in logs.items():
        for p in paths:
            for d in rows(p, "timing"):
                for l2, key in (("dirty", "ms"), ("clean", "clean_ms"),
                                ("warm", "warm_ms")):
                    if key not in d:
                        continue
                    k = (d["name"], d["arch"], d["storage"], d["batch"],
                         d.get("n_shards", 1), l2)
                    ms[k][which].append(d[key])
                    bound[k] = d["bound_ms"]
                    if "copy_" + key in d:
                        copy[k].append(d["copy_" + key])
    print("| kernel | config | batch | shards | L2 | parent ms | change ms "
          "| change / parent | bound ms | copy ms |")
    for k, v in ms.items():
        p, c = mean(v["parent"]), mean(v["change"])
        cp = f"{mean(copy[k]):.4f}" if copy[k] else "-"
        print(f"| {k[0]} | {k[1]} {k[2]} | {k[3]} | {k[4]} | {k[5]} | "
              f"{p:.4f} | {c:.4f} | {c / p:.3f} | {bound[k]:.5f} | {cp} |")
    steps = collections.defaultdict(lambda: {"parent": [], "change": []})
    for which, paths in logs.items():
        for p in paths:
            for d in rows(p, "serve_step"):
                k = (d["arch"], d["storage"], d["n_shards"], d["mode"],
                     d["front_end"], d["dedup"], d["batch"])
                steps[k][which].append((d["device_ops"], d["device_busy_ms"],
                                        d["step_ms"]))
    print("| step | parent ops | change ops | parent busy ms | change busy "
          "ms | parent step ms | change step ms |")
    for k, v in steps.items():
        def col(which, i):
            return " / ".join("-" if x[i] is None else f"{x[i]:.3f}"
                              for x in v[which])
        print(f"| {' '.join(map(str, k))} | {col('parent', 0)} | "
              f"{col('change', 0)} | {col('parent', 1)} | "
              f"{col('change', 1)} | {col('parent', 2)} | "
              f"{col('change', 2)} |")


if __name__ == "__main__":
    main()
