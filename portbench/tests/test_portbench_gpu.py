"""Each cell, run once on the card for a few seconds, correct. Card only:
``python -m pytest -q -m gpu portbench/tests/test_portbench_gpu.py``."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench.tests import smoke

CELLS = [w["name"] for w in json.loads((smoke.REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "2147483659",
         "--seconds", "3", "--trace", "0"],
        cwd=smoke.REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["correct"], (last["checks"], proc.stderr[-2000:])
    assert last["device"]["platform"] == "gpu" and last["metrics"]["setup_s"]["value"] > 0
