"""The port stands alone: importing every ``repro_torch`` module pulls in
neither JAX nor the JAX package, and ``chip_smoke.py`` imports neither and
refuses to run without CUDA or outside the repository."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_every_port_module_leaves_jax_and_repro_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "assert len(names) >= 73, names\n"
        "for m in ('core.planner', 'serving.loadgen', 'serving.metrics',\n"
        "          'serving.runtime', 'core.updates', 'checkpoint.wal',\n"
        "          'checkpoint.checkpointer', 'serving.updates',\n"
        "          'kernels.updates', 'core.integrity', 'kernels.integrity',\n"
        "          'serving.scrub', 'serving.faults', 'serving.degradation',\n"
        "          'runtime.fault_tolerance', 'runtime.elastic',\n"
        "          'models.recsys', 'data.synth', 'configs.sasrec',\n"
        "          'configs.bst', 'configs.autoint', 'configs.dcn_v2',\n"
        "          'examples.serve_recsys', 'core.hot_cache',\n"
        "          'simlab.devices', 'simlab.simulator', 'simlab.tco',\n"
        "          'optim.optimizers', 'optim.compression', 'data.pipeline',\n"
        "          'launch.train', 'examples.pifs_vs_pond',\n"
        "          'examples.quickstart', 'examples.train_dlrm',\n"
        "          'models.attention', 'models.moe', 'models.transformer',\n"
        "          'configs.llama3_2_3b', 'configs.granite_moe_1b_a400m',\n"
        "          'configs.deepseek_v3_671b', 'configs.deepseek_67b',\n"
        "          'configs.nemotron_4_340b'):\n"
        "    assert 'repro_torch.' + m in names, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 73


def test_chip_smoke_imports_neither_jax_nor_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module.split(".")[0])
    assert not mods & {"jax", "jaxlib", "repro"}, mods
    assert "repro_torch" in mods


def test_chip_smoke_fails_without_a_gpu_or_the_repo(tmp_path):
    """Here (no CUDA) and alone in a directory it exits non-zero and prints
    no result line."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.pop("PYTHONPATH")
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
