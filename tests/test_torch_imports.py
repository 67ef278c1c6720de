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
missing = sorted(set({required!r}) - set(names))
assert not missing, missing
import chip_smoke
for script in {scripts!r}:
    chip_smoke.load_script(script)
from repro_torch.kernels import _build
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
assert not _build.load.cache_info().currsize, "importing built a kernel"
assert "msgpack" not in sys.modules and "zstandard" not in sys.modules, "eager checkpoint deps"
print(len(names))
"""


# the twins of the examples and of scripts/hillclimb.py: loaded by path, they
# import neither JAX nor the JAX package either
SCRIPTS = [
    "examples/torch_quickstart.py", "examples/torch_serve_cluster.py",
    "examples/torch_train_100m.py", "examples/torch_fleet_demo.py",
    "scripts/torch_hillclimb.py",
]
# the modules of each slice of the port; the probe fails if one is missing
REQUIRED = [
    "repro_torch.core.jrba", "repro_torch.core.online", "repro_torch.fleet.runtime",
    "repro_torch.kernels.jrba_congestion",
    # the serving slice
    "repro_torch.configs", "repro_torch.configs.base", "repro_torch.configs.shapes",
    "repro_torch.configs.gemma3_1b", "repro_torch.core.placement",
    "repro_torch.kernels.flash_attention", "repro_torch.kernels.ops", "repro_torch.kernels.ref",
    "repro_torch.models", "repro_torch.models.layers", "repro_torch.models.attention",
    "repro_torch.models.transformer", "repro_torch.models.model", "repro_torch.models.convert",
    "repro_torch.serving", "repro_torch.serving.engine", "repro_torch.launch.serve",
    # the SSM slice
    "repro_torch.configs.zamba2_7b", "repro_torch.configs.rwkv6_3b",
    "repro_torch.kernels.ssd", "repro_torch.kernels.rwkv6", "repro_torch.models.ssm",
    # the MLA and MoE slice
    "repro_torch.configs.minicpm3_4b", "repro_torch.configs.deepseek_v2_lite_16b",
    "repro_torch.configs.deepseek_v3_671b", "repro_torch.models.moe",
    # the training slice
    "repro_torch.tree", "repro_torch.kernels.grad", "repro_torch.optim",
    "repro_torch.optim.adamw", "repro_torch.optim.compression", "repro_torch.train",
    "repro_torch.train.losses", "repro_torch.train.train_step", "repro_torch.train.checkpoint",
    "repro_torch.train.fault_tolerance", "repro_torch.data", "repro_torch.data.pipeline",
    "repro_torch.launch.train",
    # the last slice: analysis and the dry run
    "repro_torch.analysis", "repro_torch.analysis.framework", "repro_torch.analysis.sanitizer",
    "repro_torch.analysis.__main__", "repro_torch.analysis.passes",
    "repro_torch.analysis.passes.cache_coherence", "repro_torch.analysis.passes.determinism",
    "repro_torch.analysis.passes.host_sync", "repro_torch.analysis.passes.telemetry",
    "repro_torch.launch.mesh", "repro_torch.launch.sharding", "repro_torch.launch.variants",
    "repro_torch.launch.dryrun", "repro_torch.models.hints",
]


def test_port_imports_neither_jax_nor_the_reference():
    scripts = [os.path.join(ROOT, s) for s in SCRIPTS]
    assert all(os.path.exists(s) for s in scripts)
    code = PROBE.format(src=os.path.join(ROOT, "src"), root=ROOT, required=REQUIRED,
                        scripts=scripts)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 16


def test_h100_node_class_is_exported_and_v5e_unchanged():
    """The port's ``core`` exports an H100 class with the peaks chip_smoke
    bounds its kernels by; the TPU class the reference's scenarios read is as
    it was."""
    import repro_torch.core as core
    from repro_torch.core import H100, TPU_V5E, NodeClass

    assert "H100" in core.profiler.__all__ and core.H100 is H100
    assert H100 == NodeClass("h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, mem=80e9)
    assert TPU_V5E == NodeClass("tpu-v5e", peak_flops=197e12, hbm_bw=819e9, mem=16e9)


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


SCHEDULER_TESTS = ("test_torch_jrba.py", "test_torch_online_fleet.py", "test_torch_graph_paths.py")


def test_scheduler_tests_arm_the_ports_sanitizer(monkeypatch):
    """The port's scheduler test modules take the autouse fixture of
    ``tests/_torch_sanitize.py``; under ``REPRO_SANITIZE=1`` it installs the
    port's sanitizer (every port graph and engine audited) and takes it out
    after, and without it does nothing."""
    import _torch_sanitize

    from repro_torch.core.graph import random_edge_network
    from repro_torch.core.jrba import JRBAEngine

    line = "from _torch_sanitize import port_sanitizer  # noqa: F401"
    for name in SCHEDULER_TESTS:
        with open(os.path.join(ROOT, "tests", name), encoding="utf-8") as f:
            assert line in f.read().splitlines(), name
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    with _torch_sanitize.armed() as on:
        assert on
        assert getattr(random_edge_network(5), "_repro_sanitized", False)
        assert getattr(JRBAEngine(device="cpu"), "_repro_sanitized", False)
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    with _torch_sanitize.armed() as on:
        assert not on
        assert not getattr(random_edge_network(5), "_repro_sanitized", False)
    assert not getattr(JRBAEngine(device="cpu"), "_repro_sanitized", False)
