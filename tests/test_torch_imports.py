"""Import hygiene of the port: every ``repro_torch`` module and everything
``chip_smoke.py`` imports load without JAX and without the JAX package, and
importing builds nothing."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
from repro_torch.kernels import _build
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
assert not _build.load.cache_info().currsize, "importing built a kernel"
print(len(names))
"""


def test_port_imports_neither_jax_nor_the_reference():
    code = PROBE.format(src=os.path.join(ROOT, "src"), root=ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 16


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """No CUDA device: a non-zero exit and no result line. Alone in a
    directory without the rest of the repository: a non-zero exit too."""
    import shutil

    import torch

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = [(ROOT, os.path.join(ROOT, "chip_smoke.py"))]
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    runs.append((str(tmp_path), str(tmp_path / "chip_smoke.py")))
    for cwd, script in runs:
        if cwd == ROOT and torch.cuda.is_available():
            continue  # with a card the script runs for real
        proc = subprocess.run(
            [sys.executable, script], capture_output=True, text=True, env=env, cwd=cwd,
            timeout=300,
        )
        assert proc.returncode != 0, (cwd, proc.stdout)
        assert '"ok"' not in proc.stdout
