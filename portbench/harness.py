"""The benchmark of the PyTorch port: one cell, one run.

Everything a cell needs is found by name, as data or as a small file of its
own, so that a later cell, configuration or metric is added by files and
``BENCHMARK.json`` entries alone:

- ``BENCHMARK.json`` (at the root): the cells, their configuration and
  traffic names, and the metrics each cell reports;
- ``portbench/configs/<config>.json``: the configuration (the file the
  ``configs`` entry names): the source's keys, ``departs`` (where the program
  runs a key otherwise, and how), ``reference`` naming its architecture's
  module ``portbench/reference/<reference>.py`` (the plain reference, the
  port's fields it is held to, its operation counts), and ``port`` naming
  the port's registered configuration and the fields it replaces;
- ``portbench/traffic/<traffic>.json``: a traffic mix's parameters, whose
  ``kind`` names its driver, ``portbench/traffic/<kind>.py``;
- ``portbench/metrics/<metric>.py``: a per-layer metric's reader;
- ``portbench/limits/<cell>.json``: the limit of each number the cell's
  correctness check compares.

A run builds the program from the seed and warms it (set-up), then runs the
traffic back to back for ``--seconds``: the window closes when the first
batch or step finishes after that, and a rate is the tokens completed over
the window's whole length. After the window the program's state is freed and
its outputs are checked against the plain reference (``reference/``). With
``--trace 1`` the window runs under the device profiler and the run reports
the per-layer metrics and the breakdown instead of the end-to-end ones.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

from . import importguard

BENCH_DIR = "portbench"


class BenchError(Exception):
    """A cell that cannot run as its files describe it."""


# ---------------------------------------------------------------------------
# Finding a cell's files
# ---------------------------------------------------------------------------
def load_json(path: Path) -> dict:
    try:
        return json.loads(Path(path).read_text())
    except FileNotFoundError:
        raise BenchError(f"missing {path}") from None


def load_code(path: Path):
    """The module at ``path``, loaded under a name of its own."""
    if not path.is_file():
        raise BenchError(f"missing {path}")
    name = "portbench_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


def as_run(c: dict) -> dict:
    """The configuration as the program runs it: each key in ``departs`` at
    its ``as_run`` value."""
    return dict(c, **{k: d["as_run"] for k, d in c.get("departs", {}).items()})


@dataclasses.dataclass
class Cell:
    root: Path
    bench: dict
    workload: dict
    config: dict
    mix: dict
    limits: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def arch(self):
        """The configuration's architecture module, ``reference/<name>.py``."""
        return load_code(self.root / BENCH_DIR / "reference" / f"{self.config['reference']}.py")

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in reported)]

    def driver(self):
        return load_code(self.root / BENCH_DIR / "traffic" / f"{self.mix['kind']}.py")

    def reader(self, metric: str):
        return load_code(self.root / BENCH_DIR / "metrics" / f"{metric}.py")


def find_cell(root: Path, name: str) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json; known: "
                         f"{[w['name'] for w in bench['workloads']]}")
    config = next((c for c in bench["configs"] if c["name"] == workload["config"]), None)
    if config is None:
        raise BenchError(f"no config {workload['config']!r} in BENCHMARK.json")
    return Cell(root, bench, workload, as_run(load_json(root / config["file"])),
                load_json(root / BENCH_DIR / "traffic" / f"{workload['traffic']}.json"),
                load_json(root / BENCH_DIR / "limits" / f"{name}.json"))


# ---------------------------------------------------------------------------
# The program's configuration, held to the file's
# ---------------------------------------------------------------------------
# configuration key -> the port's ModelConfig field, for every architecture;
# an architecture's module adds its own (``PORT_FIELDS``)
PORT_FIELDS = {
    "hidden_size": "d_model", "vocab_size": "vocab", "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads", "intermediate_size": "d_ff",
    "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta", "num_hidden_layers": "n_layers",
    "tie_word_embeddings": "tie_embeddings", "torch_dtype": "dtype",
}


def port_config(c: dict, arch):
    """The port's registered configuration ``c["port"]["arch"]`` with the
    fields ``c["port"]["replace"]`` gives; raises unless it is what the
    configuration ``c`` (as run) states, field by field and in the layout
    its architecture module ``arch`` checks."""
    from repro_torch.configs import get_config

    port = c["port"]
    cfg = dataclasses.replace(get_config(port["arch"]), **port.get("replace", {}))
    wrong = []
    for key, field in dict(PORT_FIELDS, **arch.PORT_FIELDS).items():
        if key in c:
            want = c[key] if c[key] is not None else 0
            if getattr(cfg, field) != want:
                wrong.append(f"{key}={c[key]!r} but the port's {field}={getattr(cfg, field)!r}")
    wrong += arch.port_mismatches(c, cfg)
    if wrong:
        raise BenchError(f"{port['arch']}: " + "; ".join(wrong))
    return cfg


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Ctx:
    """What a traffic driver is given."""

    cell: Cell
    seed: int
    device: object  # torch.device

    def __post_init__(self) -> None:
        self.arch = self.cell.arch()

    @property
    def config(self) -> dict:
        return self.cell.config

    def port_config(self):
        return port_config(self.config, self.arch)

    @property
    def mix(self) -> dict:
        return self.cell.mix


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_window(drv, seconds: float, sync) -> tuple[int, float]:
    """Items back to back, each prepared on the host while the one before
    runs, until the first finishes after ``seconds``: (items, seconds)."""
    drv.prepare(0)
    t0 = time.perf_counter()
    n = 0
    while True:
        drv.item(n)
        drv.prepare(n + 1)
        sync()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            return n, time.perf_counter() - t0


def check_modules(err) -> bool:
    found = importguard.forbidden_loaded()
    if found:
        print(f"the run loaded the JAX package or JAX: {', '.join(found)}", file=err)
    return not found


def run(argv=None, *, root: Path, t_start: float, device=None, out=None, err=None) -> int:
    """One run of one cell; prints the result's line last on ``out`` and
    returns the exit code. ``device`` (tests only) skips the look for a card
    and runs there."""
    out, err = out or sys.stdout, err or sys.stderr
    args = parse(argv)
    cell = find_cell(Path(root), args.workload)
    import torch

    phases = {"import_s": time.perf_counter() - t_start}

    if device is None:
        want = cell.workload["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < want:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{cell.name} needs {want} CUDA device(s); found {found}", file=err)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    ctx = Ctx(cell, args.seed, device)
    drv = cell.driver().Driver(ctx)
    drv.setup()
    gc.collect()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    print(f"setup {json.dumps(dict(phases, **drv.phases, setup_s=setup_s))}", file=err)
    trace: dict = {}
    if args.trace:
        from . import devtrace

        with devtrace.record(trace):
            items, window_s = run_window(drv, args.seconds, sync)
    else:
        items, window_s = run_window(drv, args.seconds, sync)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    if not check_modules(err):
        return 3
    attempted, failed = items * drv.requests_per_item, drv.failed(items)

    metrics: dict = {}
    device_line = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    run_info = {"config": cell.config, "arch": ctx.arch, "mix": cell.mix, "items": items,
                "window_s": window_s}
    if args.trace:
        from . import devtrace

        summary = devtrace.summarize(trace.get("kernels", []), window_s)
        run_info["trace"] = summary
        device_line.update(busy_s=summary["busy_s"], window_s=window_s)
        for m in cell.per_layer():
            value = cell.reader(m["name"]).read(run_info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        found = {"setup_s": setup_s,
                 drv.rate_metric: items * drv.tokens_per_item / window_s}
        if peak is not None:
            found["peak_mem_gb"] = peak / 1e9
        for m in cell.end_to_end():
            if m["name"] not in found:
                if on_card:
                    raise BenchError(f"{cell.name} does not measure {m['name']}")
                continue
            metrics[m["name"]] = {"value": found[m["name"]], "unit": m["unit"]}

    drv.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    readings = drv.check()
    checks = {}
    for name, value in readings.items():
        if name not in cell.limits:
            raise BenchError(f"no limit for {name!r} in limits/{cell.name}.json")
        checks[name] = {"value": value, "limit": cell.limits[name]}
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    if not check_modules(err):
        return 3
    line = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device_line}
    if args.trace:
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["checks"] = checks
    for name, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=err)
    err.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0
