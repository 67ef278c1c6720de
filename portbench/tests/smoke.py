"""Smoke-size cells for the CPU tests: a benchmark root in a temporary
folder, holding the real harness's files with small configurations, traffic
mixes and limits added, and a runner that drives a cell there on the CPU."""
from __future__ import annotations

import contextlib
import io
import json
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

MLA = {"num_attention_heads": 4, "num_key_value_heads": 4, "qk_nope_head_dim": 16,
       "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32, "hidden_size": 64,
       "intermediate_size": 128, "vocab_size": 512, "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
       "hidden_act": "silu", "tie_word_embeddings": False, "reference": "mla"}
CONFIGS = {
    "minicpm3-4b-smoke": dict(MLA, q_lora_rank=32, num_hidden_layers=2,
                              port={"arch": "minicpm3-4b-smoke", "replace": {}}),
    "deepseek-v2-lite-16b-smoke": dict(
        MLA, q_lora_rank=None, num_hidden_layers=3, first_k_dense_replace=1, n_routed_experts=8,
        n_shared_experts=2, num_experts_per_tok=2, moe_intermediate_size=32, norm_topk_prob=True,
        capacity_factor=1.25, port={"arch": "deepseek-v2-lite-16b-smoke", "replace": {}}),
}
MIXES = {
    "prefill-smoke": {"kind": "prefill", "batch": 4, "seq_len": 64, "zipf_a": 1.2},
    "train-smoke": {"kind": "train", "batch": 4, "seq_len": 32, "zipf_a": 1.2, "doc_len": 16,
                    "check_steps": 3,
                    "optimizer": {"lr": 0.003, "beta1": 0.9, "beta2": 0.95, "eps": 1e-08,
                                  "weight_decay": 0.1, "clip_norm": 1.0, "warmup_steps": 1,
                                  "total_steps": 8, "min_lr_frac": 0.1},
                    "train": {"microbatches": 1, "mtp_weight": 0.0, "moe_balance_weight": 0.01}},
}
CELLS = {
    "minicpm3-4b-smoke.prefill": ("minicpm3-4b-smoke", "prefill-smoke"),
    "deepseek-v2-lite-16b-smoke.prefill": ("deepseek-v2-lite-16b-smoke", "prefill-smoke"),
    "deepseek-v2-lite-16b-smoke.train": ("deepseek-v2-lite-16b-smoke", "train-smoke"),
    "minicpm3-4b-smoke.train": ("minicpm3-4b-smoke", "train-smoke"),
}
# the limits of the cells these stand for
LIMITS = {"prefill": "minicpm3-4b.prefill-32k", "train": "deepseek-v2-lite-16b.train-2k"}


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_root(tmp: Path, dtype: str = "bfloat16") -> Path:
    """A benchmark root: the repository's BENCHMARK.json and portbench/ with
    the smoke cells added as files and entries, the configurations at
    ``dtype``."""
    root = tmp / "root"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, c in CONFIGS.items():
        c = dict(c, torch_dtype=dtype, port=dict(c["port"], replace={"dtype": dtype}))
        write(root / "portbench" / "configs" / f"{name}.json", c)
        bench["configs"].append({"name": name, "source": "smoke", "reduced": [], "why": "test",
                                 "file": f"portbench/configs/{name}.json"})
    for name, mix in MIXES.items():
        write(root / "portbench" / "traffic" / f"{name}.json", mix)
    for cell, (config, traffic) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "test"})
        real = json.loads((REPO / "portbench" / "limits" /
                           f"{LIMITS[traffic.split('-')[0]]}.json").read_text())
        write(root / "portbench" / "limits" / f"{cell}.json", real)
        rate = "prefill_tokens_per_s" if traffic.startswith("prefill") else "train_tokens_per_s"
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] == rate or m.get("moves") == rate:
                m["workloads"].append(cell)
    write(root / "BENCHMARK.json", bench)
    return root


def run_cell(root: Path, cell: str, seed: int = 5, seconds: float = 0.2, trace: int = 0):
    """Drive a cell once on the CPU: (exit code, last stdout line parsed or
    None, stdout, stderr)."""
    from portbench import harness

    out, err = io.StringIO(), io.StringIO()
    # the repository's conftest.py loads the JAX package's sanitizer into
    # the test process; the run's own guard would refuse it
    hidden = {k: sys.modules.pop(k) for k in list(sys.modules) if k.split(".")[0] == "repro"}
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]
    try:
        with contextlib.redirect_stdout(out):
            code = harness.run(argv, root=root, t_start=time.perf_counter(), device="cpu",
                               out=out, err=err)
    finally:
        sys.modules.update(hidden)
    lines = out.getvalue().strip().splitlines()
    last = json.loads(lines[-1]) if code == 0 and lines else None
    return code, last, out.getvalue(), err.getvalue()
