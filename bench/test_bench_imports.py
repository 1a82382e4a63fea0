"""The import guard: a run loads neither JAX nor the JAX package, and the
reference loads nothing of the program.  Top-level module names (the part
before the first dot) are compared whole, since ``repro_torch`` begins
with ``repro``.  Every family file under ``bench/reference`` and
``bench/systems`` is guarded, found by name, so a family added as new files
is guarded too."""
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _families(kind):
    return [f"bench.{kind}.{p.stem}"
            for p in sorted((ROOT / "bench" / kind).glob("*.py"))
            if p.stem != "__init__"]


REFERENCES = _families("reference")
SYSTEMS = _families("systems")


def _loaded(*modules):
    code = ("import sys\n"
            f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
            + "".join(f"import {m}\n" for m in modules)
            + "print('\\n'.join(sorted(sys.modules)))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    return r.stdout.split()


def test_every_family_has_a_reference_and_a_system():
    assert REFERENCES and [m.split(".")[-1] for m in REFERENCES] == [
        m.split(".")[-1] for m in SYSTEMS]


@pytest.mark.parametrize("family", REFERENCES + SYSTEMS)
def test_harness_and_system_load_neither_jax_nor_the_jax_package(family):
    mods = _loaded("bench.run", "bench.harness", family, "bench.calibrate",
                   "bench.control", "repro_torch.models.dlrm",
                   "repro_torch.core.pifs")
    assert family in mods and "repro_torch.core.pifs" in mods
    bad = [m for m in mods if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("family", REFERENCES)
def test_reference_loads_nothing_of_the_program(family):
    mods = _loaded(family, "bench.loadgen", "bench.yardstick")
    tops = {m.split(".")[0] for m in mods}
    assert family in mods
    assert not tops & {"repro_torch", *FORBIDDEN}, sorted(tops)


def test_the_command_checks_whole_top_level_names():
    sys.path[:0] = [str(ROOT)]
    try:
        from bench import run
    finally:
        sys.path.remove(str(ROOT))
    fake =("repro_torch_like", "jaxlibx.y", "jaxlib.xla")
    try:
        sys.modules["repro_torch_like"] = sys
        sys.modules["jaxlibx.y"] = sys
        assert not set(run.forbidden_modules()) & set(fake)
        sys.modules["jaxlib.xla"] = sys
        assert "jaxlib.xla" in run.forbidden_modules()
    finally:
        for m in fake:
            sys.modules.pop(m, None)
