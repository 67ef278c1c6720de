"""The harness on the CPU: finding cells, configurations and metrics by
name, the yardstick's counts, the import guard, and the result's form.

Run from the repository root: ``python -m pytest -q portbench/tests``."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import counts, devtrace, harness, importguard
from portbench.reference import mla
from portbench.tests import smoke

REPO = smoke.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_cell_finds_its_files():
    for w in BENCH["workloads"]:
        cell = harness.find_cell(REPO, w["name"])
        assert cell.mix["kind"] in ("prefill", "train")
        assert cell.limits and cell.end_to_end() and cell.per_layer()
        assert {m["name"] for m in cell.end_to_end()} >= {"setup_s", "peak_mem_gb"}
        for m in cell.per_layer():
            assert callable(cell.reader(m["name"]).read)
        assert hasattr(cell.driver(), "Driver")


def arch_of(c: dict):
    return harness.load_code(REPO / "portbench" / "reference" / f"{c['reference']}.py")


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_each_configuration_is_the_ports(name):
    """The port's registered configuration, cut as the file states, is the
    architecture the file describes as it is run; ``reduced`` names cuts
    only, and where the program departs from the source is ``departs``'."""
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    c = json.loads((REPO / entry["file"]).read_text())
    cfg = harness.port_config(harness.as_run(c), arch_of(c))
    assert cfg.n_layers == c["num_hidden_layers"]
    assert set(entry["reduced"]) == set(c["reduced"])
    assert not set(c["reduced"]) & set(c.get("departs", {}))
    assert all(set(d) <= {"source", "as_run", "why"} and "as_run" in d
               for d in c.get("departs", {}).values())


def test_a_wrong_configuration_is_refused():
    c = json.loads((REPO / "portbench/configs/deepseek-v2-lite-16b.json").read_text())
    run = harness.as_run(c)
    assert run["norm_topk_prob"] is True and c["norm_topk_prob"] is False
    with pytest.raises(harness.BenchError, match="hidden_size"):
        harness.port_config(dict(run, hidden_size=1024), arch_of(c))
    with pytest.raises(harness.BenchError, match="norm_topk_prob"):
        harness.port_config(c, arch_of(c))
    with pytest.raises(harness.BenchError, match="rms_norm_eps"):
        harness.port_config(dict(run, port={"arch": "deepseek-v2-lite-16b",
                                            "replace": {"n_pattern_repeats": 4}}), arch_of(c))


def test_cells_configs_and_metrics_are_added_by_files(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, added as
    files and BENCHMARK.json entries alone, are found and run."""
    root = smoke.make_root(tmp_path)
    reader = root / "portbench" / "metrics" / "items.prefill.py"
    reader.write_text("def read(run):\n    return float(run['items'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "items.prefill", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "prefill_tokens_per_s",
                               "workloads": ["minicpm3-4b-smoke.prefill"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.find_cell(root, "minicpm3-4b-smoke.prefill")
    assert "items.prefill" in [m["name"] for m in cell.per_layer()]
    assert cell.reader("items.prefill").read({"items": 3}) == 3.0
    code, last, _, _ = smoke.run_cell(root, "minicpm3-4b-smoke.prefill")
    assert code == 0 and last["attempted"] >= 1


def test_an_architecture_is_added_by_files(tmp_path):
    """A configuration names its architecture's module, which the harness,
    the drivers and the metrics load by that name: a new module file serves
    a cell with no edit to any of them."""
    root = smoke.make_root(tmp_path)
    refdir = root / "portbench" / "reference"
    (refdir / "mla_copy.py").write_text((refdir / "mla.py").read_text())
    config = root / "portbench" / "configs" / "deepseek-v2-lite-16b-smoke.json"
    config.write_text(json.dumps(dict(json.loads(config.read_text()), reference="mla_copy")))
    cell = harness.find_cell(root, "deepseek-v2-lite-16b-smoke.train")
    assert cell.arch().__file__ == str(refdir / "mla_copy.py")
    code, last, _, err = smoke.run_cell(root, "deepseek-v2-lite-16b-smoke.train")
    assert code == 0 and last["correct"], err[-2000:]
    run = {"mix": cell.mix, "config": cell.config, "arch": cell.arch(), "items": 2,
           "window_s": 1.0}
    assert cell.reader("mfu.train").read(run) > 0


def test_flop_and_byte_counts_by_hand():
    c = smoke.CONFIGS["deepseek-v2-lite-16b-smoke"]
    d, H, Dk, Dv, r = 64, 4, 24, 16, 32
    mixer = 2 * d * H * Dk + 2 * d * (r + 8) + 2 * r * H * (16 + Dv) + 2 * H * Dv * d
    per = mla.token_flops(c)
    assert per["dense"] == mixer + 2 * 3 * d * 128
    assert per["moe"] == mixer + 2 * d * 8 + (2 + 2) * 2 * 3 * d * 32
    assert per["unembed"] == 2 * d * 512
    S = 16
    pairs = S * (S + 1) // 2
    assert counts.live_pairs(S) == pairs
    assert counts.live_pairs(S, window=4) == sum(min(i + 1, 4) for i in range(S))
    attn = (2 * Dk + 2 * Dv) * pairs * 2 * H
    assert counts.attention_flops(mla, c, 2, S) == attn
    layers = (per["dense"] + 2 * per["moe"]) * 2 * S
    assert counts.prefill_flops(mla, c, 2, S) == layers + 3 * attn + 2 * per["unembed"]
    assert counts.train_step_flops(mla, c, 2, S) == 3 * (layers + 3 * attn
                                                         + 2 * S * per["unembed"])
    nbytes = 2 * H * S * (2 * Dk + 2 * Dv) * 2
    assert counts.attention_bound_s(mla, c, 2, S) == max(attn / 989e12, nbytes / 3.35e12)
    # minicpm3-4b at S=32768: the flash bound chip_smoke used, 6.949 ms
    m = json.loads((REPO / "portbench/configs/minicpm3-4b.json").read_text())
    assert counts.attention_bound_s(mla, m, 1, 32768) == pytest.approx(6.9486e-3, rel=1e-4)


def test_import_guard_compares_top_level_names_whole():
    names = ["repro_torch", "repro_torch.models", "jaxtyping", "reprolint", "numpy"]
    assert importguard.forbidden_loaded(names) == []
    found = importguard.forbidden_loaded(names + ["jax", "jax.numpy", "jaxlib.xla", "flax",
                                                  "repro", "repro.core"])
    assert found == ["flax", "jax", "jax.numpy", "jaxlib.xla", "repro", "repro.core"]


def test_a_run_that_loaded_jax_prints_no_result(tmp_path, monkeypatch):
    root = smoke.make_root(tmp_path)
    monkeypatch.setitem(sys.modules, "jaxlib", sys.modules["json"])
    code, last, out, err = smoke.run_cell(root, "minicpm3-4b-smoke.prefill")
    assert code == 3 and last is None and out == ""
    assert "jaxlib" in err


def test_the_result_line(tmp_path):
    root = smoke.make_root(tmp_path)
    code, last, out, err = smoke.run_cell(root, "minicpm3-4b-smoke.prefill", seed=2**31 + 7)
    assert code == 0
    assert list(last) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] >= 1
    assert set(last["metrics"]) == {"prefill_tokens_per_s", "setup_s"}  # no peak off the card
    assert all(set(m) == {"value", "unit"} for m in last["metrics"].values())
    assert set(last["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    limit = json.loads((REPO / "portbench/limits/minicpm3-4b.prefill-32k.json").read_text())
    assert last["checks"] == {"logit_gap": {"value": last["checks"]["logit_gap"]["value"],
                                            "limit": limit["logit_gap"]}}
    assert err.strip().splitlines()[-1].startswith("check logit_gap ")
    assert len(out.strip().splitlines()) == 1


def test_the_same_seed_gives_the_same_inputs():
    from portbench import zipf

    a = zipf.prompt(2**31 + 3, 4, 1, 64, 73448, 1.2)
    assert (a == zipf.prompt(2**31 + 3, 4, 1, 64, 73448, 1.2)).all()
    assert not (a == zipf.prompt(2**31 + 3, 5, 1, 64, 73448, 1.2)).all()
    b = zipf.train_batch(7, 0, 4, 32, 512, 1.2, 16)
    assert (b["tokens"][:, 1:] == b["labels"][:, :-1]).all()
    assert len({bytes(row) for row in b["tokens"]}) == 4


def test_trace_summary():
    kernels = [(0.0, 10.0, "a"), (5.0, 20.0, "flash_fwd_wgmma<96, 64>"), (30.0, 40.0, "a"),
               (45.0, 50.0, "b")]
    s = devtrace.summarize(kernels, 60e-6)
    assert s["busy_s"] == pytest.approx(35e-6)
    assert s["idle_gaps"] == [["host launching a", pytest.approx(10e-6)],
                              ["host launching b", pytest.approx(5e-6)]]
    assert s["device_ops"][0] == ["a", pytest.approx(20e-6)]
    run = {"mix": {"kind": "prefill", "batch": 1, "seq_len": 16}, "items": 2,
           "window_s": 60e-6, "trace": s, "config": smoke.CONFIGS["minicpm3-4b-smoke"],
           "arch": mla}
    flash = harness.load_code(REPO / "portbench/metrics/flash_roofline.prefill.py").read(run)
    bound = counts.attention_bound_s(mla, run["config"], 1, 16) * 2 * 2
    assert flash == pytest.approx(100 * bound / 15e-6)
    idle = harness.load_code(REPO / "portbench/metrics/device_idle.prefill.py").read(run)
    assert idle == pytest.approx(100 * 25 / 60)
    assert harness.load_code(REPO / "portbench/metrics/device_idle.train.py").read(run) is None
    s = devtrace.summarize([(0.0, 1.0, "gemm")], 1e-6)
    assert harness.load_code(REPO / "portbench/metrics/flash_roofline.prefill.py").read(
        dict(run, trace=s)) is None


def test_without_a_card_a_run_prints_no_result(tmp_path):
    """On this machine (no card), and in a folder holding only
    BENCHMARK.json and portbench/, the command exits non-zero with no
    result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for root in (REPO, tmp_path):
        proc = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", "minicpm3-4b.prefill-32k",
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=root, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and proc.stdout.strip() == "", proc.stderr[-2000:]
