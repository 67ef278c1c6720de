"""The dry run's per-device counts on a sharded mesh, held to the JAX
package's: on a fake (2, 4) mesh, where ``model`` exceeds internlm2's and
starcoder2's KV heads so that their KV views are refused and resharded,
each smoke config's prefill and train cells give FLOPs and collective bytes
a device within a stated band of what the JAX package's dry run compiles
for a (2, 4) mesh of host devices (in a child process, as the host device
count is fixed when JAX starts), and no refused op gathers the batch. A
file of its own, so that it runs beside ``test_torch_dryrun.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro.configs import ARCH_IDS
from repro_torch.configs.shapes import CELLS, ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = [f"{a}-smoke" for a in ARCH_IDS]

# the JAX package's per-device counts on a (2, 4) mesh of host devices, in a
# child: the host device count is fixed when JAX starts
_REF_SHARDED = """
import json, sys
import repro.launch.dryrun as rd  # sets its host device count before JAX starts
from repro.configs import shapes
from repro.launch.mesh import make_debug_mesh
cells, archs = json.loads(sys.argv[1]), json.loads(sys.argv[2])
for name, kind, seq, batch in cells:
    shapes.CELLS[name] = shapes.ShapeCell(name, kind, seq, batch)
mesh = make_debug_mesh((2, 4))
out = {}
for arch in archs:
    for name, *_ in cells:
        rec = rd._scan_corrected(arch, name, mesh)
        if rec:
            rec = rec["corrected"]
        else:
            lowered, _ = rd.lower_cell(arch, name, mesh)
            rec = rd.analyze(lowered, lowered.compile())
        out[arch + " " + name] = [rec["flops"], rec["collectives"]["total"]]
print(json.dumps(out))
"""
SHARDED_CELLS = (ShapeCell("prefill_b8", "prefill", 64, 8), ShapeCell("train_b8", "train", 64, 8))
# port over JAX package, per device on the (2, 4) mesh, read on this CPU
# (PyTorch 2.13): FLOPs prefill 0.816-0.898, train 0.662-1.015 (the (1, 1)
# gap: XLA counts elementwise FLOPs too); collective bytes prefill
# 0.370-2.092, train 0.917-2.522 (DTensor gathers an FSDP weight at each
# use, forward, recompute and backward; GSPMD picks its own layouts)
SHARDED_FLOP_BAND = {"prefill": (0.80, 0.92), "train": (0.64, 1.04)}
SHARDED_COLL_BAND = {"prefill": (0.35, 2.2), "train": (0.9, 2.6)}


@pytest.fixture(scope="module")
def ref_sharded():
    cells = [dataclasses.astuple(c) for c in SHARDED_CELLS]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _REF_SHARDED, json.dumps(cells),
                          json.dumps(SMOKE)], capture_output=True, text=True, cwd=REPO,
                         env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", SMOKE)
def test_per_device_counts_within_band_of_the_reference(arch, ref_sharded, monkeypatch):
    for cell in SHARDED_CELLS:
        monkeypatch.setitem(CELLS, cell.name, cell)
    with dryrun.fake_world(8):
        mesh = make_debug_mesh((2, 4), device_type="cpu")
        for cell in SHARDED_CELLS:
            rec = dryrun.run_cell(arch, cell.name, mesh, "debug")
            assert rec["ok"], (cell.name, rec.get("error"), rec.get("traceback"))
            assert rec["reshard"]["batch_gathered"] == 0
            flops, coll = ref_sharded[f"{arch} {cell.name}"]
            lo, hi = SHARDED_FLOP_BAND[cell.kind]
            assert lo <= rec["flops"] / flops <= hi, (cell.name, rec["flops"], flops)
            lo, hi = SHARDED_COLL_BAND[cell.kind]
            got = rec["collectives"]["total"]
            assert lo <= got / coll <= hi, (cell.name, got, coll)
