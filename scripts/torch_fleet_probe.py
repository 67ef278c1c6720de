#!/usr/bin/env python3
"""Time the port's 256-lane fleet on one NVIDIA GPU for one source tree.

Usage, from the repository root on a machine with a CUDA card::

    python3 scripts/torch_fleet_probe.py [--root DIR] [--label NAME] [--lanes 256]
        [--after-stream]

Runs ``chip_smoke.py``'s fleet (the fleet families plus ``wan-mesh-xl`` and
``edge-mesh-flash``, drift churn on every 4th lane, ``n_jobs=4``,
``n_iters=250``, k=3) on the JRBA kernel of the tree at ``--root``: its
``src/repro_torch``, with the kernel built into that tree's own build
directory. A 32-lane lockstep run warms up first; then the lockstep and the
async runtime run the same fleet, whose records must agree exactly. For each
run it prints events/s, the wall time, the engine's stage seconds and the
kernel wrapper's launches, with their host time (the wrapper's Python and
the launch, no synchronisation) and their device time (CUDA events around
each launch). ``--after-stream`` first runs that tree's ``chip_smoke.py``
scheduler-stream phase in the same process, so that the fleet runs where it
runs in ``chip_smoke.py``: after that phase, and not warmed up apart. To
compare two trees on one host, run the script once for each
in one session (a parent's ``git archive`` beside this one), alternating
them. The last line is the result as one JSON object.
"""
from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
K = 3
FLEET_ITERS = 250
EXTRA = ("wan-mesh-xl", "edge-mesh-flash")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class TimedWrapper:
    """Stands in for the kernel's wrapper: times each call on the host and
    on the device, and forwards it. The wrapper counts its launches on the
    name it is called by, so ``launches`` is the wrapper's own count."""

    def __init__(self, wrapper):
        self.wrapper = wrapper
        self.host: list[float] = []
        self.events: list[tuple] = []

    @property
    def launches(self) -> int:
        return self.wrapper.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.wrapper.launches = n

    def __call__(self, *args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        out = self.wrapper(*args, **kwargs)
        self.host.append(time.perf_counter() - t0)
        end.record()
        self.events.append((start, end))
        return out

    def take(self) -> dict:
        torch.cuda.synchronize()
        device = [s.elapsed_time(e) * 1e-3 for s, e in self.events]
        out = {"calls": len(self.host), "host_s": float(np.sum(self.host)),
               "device_s": float(np.sum(device)),
               "host_ms_mean": float(np.mean(self.host) * 1e3) if self.host else 0.0,
               "device_ms_mean": float(np.mean(device) * 1e3) if device else 0.0}
        self.host, self.events = [], []
        return out


def max_record_dev(results_a, results_b) -> float:
    """Worst relative deviation between two runs' job records."""
    dev = 0.0
    for a, b in zip(results_a, results_b):
        if len(a.records) != len(b.records):
            return 1.0
        for ra, rb in zip(a.records, b.records):
            for va, vb in ((ra.schedule_time, rb.schedule_time), (ra.finish_time, rb.finish_time)):
                if va != vb:
                    scale = abs(va) if np.isfinite(va) and va != 0 else 1.0
                    gap = abs(va - vb)
                    dev = max(dev, gap / scale if np.isfinite(gap) else 1.0)
    return dev


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT), help="the source tree whose port runs")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--lanes", type=int, default=256)
    ap.add_argument("--after-stream", action="store_true",
                    help="run the tree's chip_smoke.py stream phase first, in this process")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("fleet probe: no CUDA device", file=sys.stderr)
        return 2
    root = Path(opts.root).resolve()
    sys.path.insert(0, str(root / "src"))
    core = importlib.import_module("repro_torch.core")
    fleet = importlib.import_module("repro_torch.fleet")
    build = importlib.import_module("repro_torch.kernels._build")
    jc = importlib.import_module("repro_torch.kernels.jrba_congestion")
    dumps = importlib.import_module("repro_torch.obs.trace").dumps_strict
    assert Path(jc.__file__).resolve().is_relative_to(root), jc.__file__
    card = card_line()
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.load("jrba_congestion")
    build_s = time.perf_counter() - t0
    timed = TimedWrapper(jc.sparse_congestion_solve)
    jc.sparse_congestion_solve = timed  # the engine looks the wrapper up at each dispatch
    names = fleet.FLEET_SCENARIOS + EXTRA

    def run(mode: str, lanes: int):
        eng = core.JRBAEngine(k=K, n_iters=FLEET_ITERS, solver="cuda", device=device)
        sims = fleet.build_async_fleet(eng, lanes, n_jobs=4, names=names)
        launches0 = timed.wrapper.launches
        res = fleet.FleetRuntime(eng, mode=mode).run(sims)
        torch.cuda.synchronize()
        s, st = res.telemetry.summary, eng.stats
        out = {"mode": mode, "lanes": lanes, "events": res.total_events,
               "wall_s": res.wall_seconds, "events_per_s": s["events_per_s"],
               "batch_calls": s["batch_calls"], "unfinished": res.unfinished,
               "launches": timed.wrapper.launches - launches0,
               "engine_s": {"build": st.build_seconds, "cache": st.cache_seconds,
                            "dispatch": st.dispatch_seconds, "finalize": st.finalize_seconds},
               "wrapper": timed.take()}
        print(f"[fleet] {opts.label} {dumps(out)} [{card}]", flush=True)
        return res, out

    if opts.after_stream:
        sys.path.insert(0, str(root))
        smoke = importlib.import_module("chip_smoke")
        t0 = time.perf_counter()
        smoke.stream_phase(device, "cuda", "sparse", seeds=(0, 1), n_jobs=8)
        print(f"[fleet] {opts.label} stream phase {time.perf_counter() - t0:.1f} s", flush=True)
        timed.take()
    else:
        run("lockstep", 32)  # warm-up: every instance the fleet takes is loaded
    lock, lock_out = run("lockstep", opts.lanes)
    asyn, asyn_out = run("async", opts.lanes)
    dev = max_record_dev(lock.results, asyn.results)
    ok = dev == 0.0 and lock.unfinished == 0 and asyn.unfinished == 0
    result = {"label": opts.label, "root": str(root), "card": card, "build_s": build_s,
              "after_stream": opts.after_stream,
              "lockstep": lock_out, "async": asyn_out, "max_record_rel_dev": dev,
              "async_over_lockstep": asyn_out["events_per_s"] / lock_out["events_per_s"],
              "ok": ok}
    print(card, flush=True)
    print(dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
