"""The plain reference against the port at smoke size on the CPU, and the
check against planted faults and the control.

In float32 the reference and the port compute the same function, so their
numbers agree to float32's rounding; a run with a fault planted under it, or
with the control put in the program's place, has to come out not correct
under the full-size cells' limits."""
from __future__ import annotations

import ast
import dataclasses
import json

import pytest
import torch

from portbench import faults, harness
from portbench.reference import mla as ref_model
from portbench.reference.lowp import Arith, round_e4m3
from portbench.tests import smoke

F32_LIMIT = 1e-5  # float32 rounding over a smoke model's few layers


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("roots")
    return {dt: smoke.make_root(tmp / dt, dt) for dt in ("float32", "bfloat16")}


def test_reference_imports_nothing_of_the_program():
    for path in sorted((smoke.REPO / "portbench" / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
                  and n.level == 0]
        assert all(n.split(".")[0] in ("torch", "math", "dataclasses", "__future__")
                   or n.startswith("portbench.reference.") for n in names), (path.name, names)


@pytest.mark.parametrize("arch", sorted(smoke.CONFIGS))
def test_reference_weights_and_logits_are_the_ports(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.tree import tree_leaves

    c = dict(smoke.CONFIGS[arch], torch_dtype="float32")
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    params = model.init_params(cfg, 11, device="cpu")
    spec = ref_model.spec_from_config(c)
    mine = ref_model.all_weights(spec, 11, "cpu", torch.float32)
    theirs = tree_leaves(params)
    assert sum(t.numel() for t in mine.values()) == sum(t.numel() for t in theirs)
    assert {(tuple(t.shape), float(t.sum())) for t in mine.values()} == {
        (tuple(t.shape), float(t.sum())) for t in theirs}
    tokens = torch.randint(0, c["vocab_size"], (2, 48), generator=torch.Generator().manual_seed(1))
    got, _ = model.prefill(params, cfg, tokens)
    want = ref_model.prefill_logits(spec, 11, tokens, dtype=torch.float32)
    assert float((got[:, -1] - want).abs().max() / want.abs().max()) < F32_LIMIT


@pytest.mark.parametrize("cell", sorted(smoke.CELLS))
def test_a_float32_run_agrees_with_the_reference(roots, cell):
    code, last, _, err = smoke.run_cell(roots["float32"], cell)
    assert code == 0, err[-2000:]
    assert last["correct"], last["checks"]
    assert all(c["value"] < F32_LIMIT for c in last["checks"].values()), last["checks"]


FAULTS = [("minicpm3-4b-smoke.prefill", faults.stale_answer),
          ("minicpm3-4b-smoke.prefill", faults.token_altered),
          ("minicpm3-4b-smoke.prefill", faults.half_batch_prefill),
          ("deepseek-v2-lite-16b-smoke.train", faults.state_unchanged),
          ("deepseek-v2-lite-16b-smoke.train", faults.half_batch),
          ("deepseek-v2-lite-16b-smoke.train", faults.loss_altered)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f.__name__ for _, f in FAULTS])
def test_a_run_with_a_fault_under_it_is_not_correct(roots, cell, fault):
    """The whole run, with the timed path broken underneath: the check has
    to come out false under the full-size cell's limits."""
    with fault():
        code, last, _, err = smoke.run_cell(roots["float32"], cell, seconds=0.5)
    assert code == 0, err[-2000:]
    assert last["correct"] is False, last["checks"]
    assert "FAIL" in err


@pytest.mark.parametrize("cell", ["minicpm3-4b-smoke.prefill", "deepseek-v2-lite-16b-smoke.train"])
def test_the_control_is_not_correct(roots, cell, monkeypatch):
    """The reference at float8 in the program's place: the check's numbers
    against the exact reference's fail the cell's limits."""
    c = harness.find_cell(roots["bfloat16"], cell)
    drv = c.driver().Driver(harness.Ctx(c, 3, torch.device("cpu")))
    spec = ref_model.spec_from_config(c.config)
    if c.mix["kind"] == "prefill":
        picks = drv.picks(1)
        tokens = torch.stack([torch.from_numpy(drv.prompt(i)[row]) for i, row in picks])
        drv.sampled = dict(zip(picks, ref_model.prefill_logits(spec, 3, tokens, Arith(lowp=True))))
        readings = drv.check()
    else:
        train = c.driver()
        from portbench.reference.train import train_steps

        batches = [{k: torch.from_numpy(v) for k, v in drv.host_batch(i).items()}
                   for i in range(drv.first)]
        args = (ref_model, spec, 3, batches, c.mix["optimizer"], 0.01, "cpu")
        exact = train_steps(*args, first_grad=lambda k, g: g.clone())
        first = exact.pop("first")
        low = train_steps(*args, Arith(lowp=True),
                          first_grad=lambda k, g: train.distance(g, first[k]))
        readings = train.compare(low, exact, low["first"])
    assert any(readings[k] > c.limits[k] for k in readings), (readings, c.limits)


def test_e4m3_rounding():
    x = torch.tensor([1.0, 1.0625, 1.125, -448.0, 3e-3], requires_grad=True)
    y = round_e4m3(x)
    assert y.tolist()[:4] == [1.0, 1.0, 1.125, -448.0]
    y.sum().backward()
    assert x.grad.tolist() == [1.0] * 5


def test_limits_are_data():
    for path in (smoke.REPO / "portbench" / "limits").glob("*.json"):
        limits = json.loads(path.read_text())
        assert limits and all(v > 0 for v in limits.values())
