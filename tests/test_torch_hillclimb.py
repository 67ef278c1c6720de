"""``scripts/torch_hillclimb.py``, the port's twin of ``scripts/hillclimb.py``:
on the production mesh (16 x 16 over a fake group of 256 ranks), as
``tests/test_torch_dryrun.py`` runs its cells, its FLOPs and collective
bytes are the dry-run record's of the same cell, its roofline terms divide
by one H100's peaks (``core.profiler.H100``) and the named inter-node link
rate, and ``--breakdown`` sums the counter's collectives by (op, shape)."""

import pytest

from chip_smoke import load_script
from repro_torch.configs.shapes import CELLS, ShapeCell
from repro_torch.core import H100
from repro_torch.launch import dryrun, variants
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import hints

# smoke-sized cells whose batch the production mesh's 16-way data axis divides
CELLS_16 = {"train": ShapeCell("train_smoke16", "train", 64, 16),
            "prefill": ShapeCell("prefill_smoke16", "prefill", 64, 16)}


@pytest.fixture(autouse=True)
def smoke_cells(monkeypatch):
    for cell in CELLS_16.values():
        monkeypatch.setitem(CELLS, cell.name, cell)


@pytest.mark.parametrize("arch,kind", [("internlm2-1.8b-smoke", "train"),
                                       ("zamba2-7b-smoke", "prefill")])
def test_hillclimb_counts_are_the_dry_runs(arch, kind, capsys):
    hc = load_script("scripts/torch_hillclimb.py")
    cell = CELLS_16[kind].name
    out = hc.main(["--arch", arch, "--cell", cell, "--variant", "default", "--device", "cpu",
                   "--breakdown"])
    with dryrun.fake_world(hc.RANKS):
        rec = dryrun.run_cell(arch, cell, make_production_mesh(device_type="cpu"), "single")
    assert rec["ok"], rec.get("error")
    info = out["info"]
    assert info["flops"] == rec["flops"] > 0
    assert info["collectives"] == rec["collectives"]
    assert info["bytes_accessed"] == rec["bytes_accessed"]
    assert out["static_state_bytes_per_device"] == rec["static_state_bytes_per_device"]
    assert out["terms"] == {"compute": rec["flops"] / 989e12,
                            "memory": rec["bytes_accessed"] / 3.35e12,
                            "collective": rec["collectives"]["total"] / 50e9}
    assert out["dominant"] == max(out["terms"], key=out["terms"].get)
    rows = out["breakdown"]
    assert rows and [b for b, _, _ in rows] == sorted((b for b, _, _ in rows), reverse=True)
    assert sum(b for b, _, _ in rows) <= rec["collectives"]["total"]
    assert all(op in dryrun.COLLECTIVES and "[" in shape for _, op, shape in rows)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"=== {arch} x {cell} [default] ==="
    assert lines[2].startswith("compute ") and f"dominant={out['dominant']}" in lines[2]
    assert lines[3].startswith("collective bytes by op:")
    assert lines[4].startswith("top collective contributors")
    # the script leaves the knobs and the hints as it found them
    assert variants.KNOBS == variants._DEFAULTS
    assert hints._ACTIVATION_SHARDING is None and hints._MOE_SHARDING is None


def test_hillclimb_uses_the_h100_and_the_inter_node_rate():
    hc = load_script("scripts/torch_hillclimb.py")
    assert hc.LINK_BW == 400e9 / 8  # one 400 Gb/s InfiniBand port a GPU
    assert hc.H100 is H100

