#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Usage, from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each failing hard:

1. Device: the card's name, count and power limit. No card, no run.
2. Build: every kernel under ``src/repro_torch/kernels/csrc`` is compiled
   with ``nvcc`` for ``sm_90a``, all sources at once (``-Xptxas -v`` shown).
3. Kernel against plain: every JRBA program that the port's
   ``OnlineScheduler`` solves (OTFS and OTFA, k=3, all 12 scenarios, seeds
   0-1, 8 jobs) is replayed through the CUDA kernel (``solver="cuda"``) and
   through its plain PyTorch version (``solver="sparse"``), both on the
   card at ``n_iters=400``, singly and as ``solve_many`` batches of up to 64.
   Rounded routes, bandwidths and spans must be identical, relaxed spans
   within rtol 5e-2. The kernel and the plain version are timed with CUDA
   events on batches from that stream, where ``w``, spans and step counts
   must agree bit for bit.
4. Fleet: a 256-lane async-built fleet (the fleet families plus
   ``wan-mesh-xl`` and ``edge-mesh-flash``, drift churn on every 4th lane,
   ``n_jobs=4``, ``n_iters=250``) runs under the lockstep and the async
   runtime on a ``solver="cuda"`` engine: records must be identical, every
   job must finish and the kernel must have launched. A 32-lane fleet on the
   kernel and on the plain version must give identical records.

Every path is driven with the kernel's launch count set to 0 just before it
and read just after: each path on ``solver="cuda"`` (the scheduler, the
single and batched replays, each fleet run) must have launched the kernel,
and each on ``solver="sparse"`` must not have.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import SCENARIOS, JRBAEngine, OnlineScheduler  # noqa: E402
from repro_torch.core.graph import NetworkGraph  # noqa: E402
from repro_torch.core.jrba import sparse_batch_inputs  # noqa: E402
from repro_torch.fleet import FLEET_SCENARIOS, FleetRuntime, build_async_fleet  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import jrba_congestion as jc  # noqa: E402

K = 3
STREAM_ITERS = 400
FLEET_ITERS = 250
SPAN_RTOL = 5e-2
BATCH = 64
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------
def build_all() -> None:
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    # one nvcc per source, all started together, so the build takes as long
    # as the slowest source however many the port grows
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        built = list(pool.map(lambda n: _build.build(n, ptxas_verbose=True), names))
    for name, (lib, seconds, output) in zip(names, built):
        for line in output.strip().splitlines():
            log(f"[build] {name}: {line}")
        log(f"[build] {name}: {lib.name} in {seconds:.2f} s (nvcc, sm_90a)")
    log(f"[build] all {len(names)} kernel sources in {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# phase 3: the scheduler's program stream through the kernel and the plain version
# ---------------------------------------------------------------------------
class CapturingEngine(JRBAEngine):
    """Records every (net, flows, capacity) solve request it serves."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.captured: list = []

    def _record(self, net, flows, capacity):
        self.captured.append((net, list(flows), None if capacity is None else capacity.copy()))

    def solve(self, net, flows, *, capacity=None, **kwargs):
        self._record(net, flows, capacity)
        return super().solve(net, flows, capacity=capacity, **kwargs)

    def solve_many(self, net, flow_sets, *, capacities=None, **kwargs):
        nets = [net] * len(flow_sets) if isinstance(net, NetworkGraph) else list(net)
        caps = capacities if capacities is not None else [None] * len(flow_sets)
        for g, fs, c in zip(nets, flow_sets, caps):
            self._record(g, fs, c)
        return super().solve_many(net, flow_sets, capacities=capacities, **kwargs)


def capture_stream(device, solver, *, seeds=(0, 1), n_jobs=8, n_iters=STREAM_ITERS) -> list:
    eng = CapturingEngine(k=K, n_iters=n_iters, solver=solver, device=device)
    for name in sorted(SCENARIOS):
        for seed in seeds:
            for policy in ("OTFS", "OTFA"):
                net, arrivals = SCENARIOS[name].build(seed=seed, n_jobs=n_jobs)
                OnlineScheduler(net, policy, k_paths=K, jrba_iters=n_iters, engine=eng).run(
                    arrivals
                )
    return eng.captured


def replay_single(eng: JRBAEngine, stream: list) -> tuple[list, list[int]]:
    results, steps = [], []
    for net, flows, cap in stream:
        s0 = eng.stats.solver_steps
        results.append(eng.solve(net, flows, capacity=cap))
        steps.append(eng.stats.solver_steps - s0)
    return results, steps


def batch_groups(eng: JRBAEngine, stream: list, size: int = BATCH) -> list[list[int]]:
    """Stream indices grouped by the kernel's batch signature, in chunks of
    at most ``size``, so that ``solve_many`` sees full batches."""
    by_key: dict[tuple, list[int]] = {}
    for i, (net, flows, cap) in enumerate(stream):
        prog = eng.build(net, flows, capacity=cap)
        key = ("empty",) if prog is None else eng._shape_key(prog)
        by_key.setdefault(key, []).append(i)
    return [idx[j : j + size] for idx in by_key.values() for j in range(0, len(idx), size)]


def replay_batched(eng: JRBAEngine, stream: list, groups: list[list[int]]) -> list:
    out: list = [None] * len(stream)
    for idx in groups:
        res = eng.solve_many(
            [stream[i][0] for i in idx],
            [stream[i][1] for i in idx],
            capacities=[stream[i][2] for i in idx],
        )
        for i, r in zip(idx, res):
            out[i] = r
    return out


def compare(label: str, got: list, want: list) -> float:
    """Identical records; returns the worst relative relaxed-span gap."""
    worst = 0.0
    bad = []
    for i, (a, b) in enumerate(zip(got, want)):
        if (a is None) != (b is None):
            bad.append((i, "one side empty"))
            continue
        if a is None:
            continue
        if a.routes != b.routes or not np.array_equal(a.bandwidth, b.bandwidth) or a.span != b.span:
            bad.append((i, f"routes/bandwidth/span differ: span {a.span} vs {b.span}"))
        gap = abs(a.relaxed_span - b.relaxed_span) / max(abs(b.relaxed_span), 1e-12)
        worst = max(worst, gap)
        if gap > SPAN_RTOL:
            bad.append((i, f"relaxed span {a.relaxed_span} vs {b.relaxed_span}"))
    if bad:
        raise AssertionError(f"{label}: {len(bad)} of {len(got)} programs disagree: {bad[:10]}")
    return worst


def counted(label: str, kernel: bool, fn, *args, **kwargs):
    """Drive one path with the kernel's launch count set to 0 just before it;
    returns ``(result, launches)``. A kernel path must have launched the
    kernel, a plain one must not have."""
    jc.sparse_congestion_solve.launches = 0
    out = fn(*args, **kwargs)
    n = jc.sparse_congestion_solve.launches
    log(f"[launches] {label}: {n}")
    if kernel:
        assert n > 0, f"{label}: the kernel was never launched"
    else:
        assert n == 0, f"{label}: the plain path launched the kernel {n} times"
    return out, n


def time_call(fn, args, kwargs, reps: int) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` warm calls."""
    for _ in range(2):
        fn(*args, **kwargs)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args, **kwargs)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_batch(progs: list, device) -> dict:
    """Kernel and plain version on one batch: agreement, CUDA-event times,
    and the card's bound for the same work."""
    args = sparse_batch_inputs(progs, device)
    kw = dict(n_iters=STREAM_ITERS)
    w_k, span_k, steps_k = jc.sparse_congestion_solve(*args, **kw)
    w_p, span_p, steps_p = jc.sparse_congestion_plain(*args, **kw)
    torch.cuda.synchronize()
    # the plain version sums in the kernel's order: bit for bit, or a fault
    assert torch.equal(w_k, w_p), f"w differs: max abs {float((w_k - w_p).abs().max())}"
    assert torch.equal(span_k, span_p), "spans differ"
    assert torch.equal(steps_k, steps_p), "step counts differ"
    ms = time_call(jc.sparse_congestion_solve, args, kw, reps=20)
    plain_ms = time_call(jc.sparse_congestion_plain, args, kw, reps=3)
    # bound: each input read once, each output written once; operations per
    # executed step per lane ~ softmax+Adam on Nf*K slots (25 each), the
    # scatter and gather over the lane's link entries (2 each), the smoothed
    # max over La links (9 each), counted with the steps this run took
    B, Nf, Kp, P = args[0].shape
    La = args[3].shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in args)
    nbytes += STREAM_ITERS * 3 * 4 + B * Nf * Kp * 4  # schedule table, derived mask
    nbytes += (w_k.numel() + span_k.numel() + steps_k.numel()) * 4
    nnz = (args[5][:, -1] - args[5][:, 0]).double()
    ops = float((steps_k.double() * (25 * Nf * Kp + 2 * nnz + 9 * La)).sum())
    bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    out = {
        "shape": {"B": B, "Nf": Nf, "K": Kp, "P": P, "La": La, "n_iters": STREAM_ITERS},
        "mean_steps": float(steps_k.double().mean()),
        "max_abs_err": float((w_k - w_p).abs().max()),
        "max_span_rel_err": float(((span_k - span_p).abs() / span_p.clamp_min(1e-12)).max()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    log(f"[kernel] {json.dumps(out)}")
    return out


def kernel_record(eng: JRBAEngine, stream: list, groups: list[list[int]], device) -> dict:
    """Time the kernel and its plain version on batches from the stream: a
    full batch of the most common signature (the record), a full batch of
    the widest signature, and that signature's first program alone."""

    def progs_of(idx):
        return [eng.build(*stream[i][:2], capacity=stream[i][2]) for i in idx]

    def padded(progs):  # the engine pads a batch the same way
        return progs + [progs[-1]] * (BATCH - len(progs))

    groups = [g for g in groups if eng.build(*stream[g[0]][:2], capacity=stream[g[0]][2])]
    common = progs_of(max(groups, key=len))
    widest = progs_of(max(groups, key=lambda g: eng.build(*stream[g[0]][:2]).usage_active.size))
    timings = [time_batch(padded(common), device), time_batch(padded(widest), device)]
    timings.append(time_batch(widest[:1], device))
    main = timings[0]
    return {
        "name": "jrba_congestion",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/jrba_congestion.cu",
        "replaces": "src/repro/kernels/jrba_congestion.py:42",
        "launches": None,  # set from the main path's run
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "shape": main["shape"],
        "tolerance": "timed batches: w, span, steps bit for bit; stream: records identical, "
        "relaxed span rtol 5e-2",
        "timings": timings,
    }


def stream_phase(device, kernel_solver: str, plain_solver: str, *, seeds, n_jobs) -> tuple:
    """Returns the kernel's record and the launches of each kernel path."""
    launches = {}
    t0 = time.perf_counter()
    stream, launches["scheduler"] = counted(
        "scheduler (OnlineScheduler.run, OTFS+OTFA, 12 scenarios)", True,
        capture_stream, device, kernel_solver, seeds=seeds, n_jobs=n_jobs,
    )
    log(f"[stream] captured {len(stream)} JRBA programs in {time.perf_counter() - t0:.1f} s")
    ek = JRBAEngine(k=K, n_iters=STREAM_ITERS, solver=kernel_solver, device=device)
    ep = JRBAEngine(k=K, n_iters=STREAM_ITERS, solver=plain_solver, device=device)
    t0 = time.perf_counter()
    (single_k, steps_k), launches["stream_single"] = counted(
        f"stream single ({kernel_solver})", True, replay_single, ek, stream
    )
    tk = time.perf_counter() - t0
    t0 = time.perf_counter()
    (single_p, steps_p), _ = counted(
        f"stream single ({plain_solver})", False, replay_single, ep, stream
    )
    tp = time.perf_counter() - t0
    gap1 = compare("single", single_k, single_p)
    relaxed = sum(1 for s in steps_k if s)
    n_diff = sum(1 for a, b in zip(steps_k, steps_p) if a != b)
    log(
        f"[stream] single: {len(stream)} programs ({relaxed} relaxed, "
        f"{ek.stats.fast_path_solves} fast-path) identical records; worst relaxed-span "
        f"gap {gap1:.3g}; steps differ on {n_diff}; replay {tk:.2f} s kernel, {tp:.2f} s plain"
    )
    groups = batch_groups(ek, stream)
    batch_k, launches["stream_batched"] = counted(
        f"stream batched ({kernel_solver})", True, replay_batched, ek, stream, groups
    )
    batch_p, _ = counted(
        f"stream batched ({plain_solver})", False, replay_batched, ep, stream, groups
    )
    gap2 = compare("batched", batch_k, batch_p)
    moved = sum(
        1
        for a, b in zip(batch_k, single_k)
        if a is not None and (a.routes, a.span) != (b.routes, b.span)
    )
    log(
        f"[stream] batched: {len(groups)} solve_many calls, largest {max(map(len, groups))}, "
        f"identical records; worst relaxed-span gap {gap2:.3g}; "
        f"{moved} programs round differently batched than single (kernel)"
    )
    return kernel_record(ek, stream, groups, device), launches


# ---------------------------------------------------------------------------
# phase 4: fleets
# ---------------------------------------------------------------------------
def max_record_dev(results_a, results_b) -> float:
    """Worst relative deviation between two runs' job records: zero only when
    every schedule/finish time is exactly equal."""
    dev = 0.0
    for a, b in zip(results_a, results_b):
        if len(a.records) != len(b.records):
            return 1.0
        for ra, rb in zip(a.records, b.records):
            for va, vb in ((ra.schedule_time, rb.schedule_time), (ra.finish_time, rb.finish_time)):
                if va == vb:
                    continue
                scale = abs(va) if np.isfinite(va) and va != 0 else 1.0
                gap = abs(va - vb)
                dev = max(dev, gap / scale if np.isfinite(gap) else 1.0)
    return dev


def run_fleet(device, solver: str, mode: str, lanes: int, names) -> tuple:
    eng = JRBAEngine(k=K, n_iters=FLEET_ITERS, solver=solver, device=device)
    sims = build_async_fleet(eng, lanes, n_jobs=4, names=names)
    res = FleetRuntime(eng, mode=mode).run(sims)
    return res, eng


def report_fleet(label: str, res, eng: JRBAEngine, card: str) -> None:
    s = res.telemetry.summary
    st = eng.stats
    log(
        f"[fleet] {label}: {res.total_events} events in {res.wall_seconds:.2f} s = "
        f"{s['events_per_s']:.1f} events/s; dispatches {s['n_dispatches']}, rounds "
        f"{s['n_rounds']}, batch calls {s['batch_calls']}, mean batch occupancy "
        f"{s['mean_batch_occupancy']:.2f}; engine build {st.build_seconds:.2f} s, cache "
        f"{st.cache_seconds:.2f} s, dispatch {st.dispatch_seconds:.2f} s, finalize "
        f"{st.finalize_seconds:.2f} s; steps {st.solver_steps}/{st.solver_step_budget}; "
        f"unfinished {res.unfinished} [{card}]"
    )


def fleet_phase(device, kernel_solver, plain_solver, card, *, lanes, small_lanes) -> dict:
    """Returns the launches of each kernel fleet run."""
    names = FLEET_SCENARIOS + ("wan-mesh-xl", "edge-mesh-flash")
    launches = {}
    (lock, eng_l), launches[f"fleet_{lanes}_lockstep"] = counted(
        f"{lanes}-lane fleet lockstep ({kernel_solver})", True,
        run_fleet, device, kernel_solver, "lockstep", lanes, names,
    )
    (asyn, eng_a), launches[f"fleet_{lanes}_async"] = counted(
        f"{lanes}-lane fleet async ({kernel_solver})", True,
        run_fleet, device, kernel_solver, "async", lanes, names,
    )
    report_fleet(f"{lanes} lanes lockstep ({kernel_solver})", lock, eng_l, card)
    report_fleet(f"{lanes} lanes async ({kernel_solver})", asyn, eng_a, card)
    dev = max_record_dev(lock.results, asyn.results)
    log(f"[fleet] lockstep vs async max_record_rel_dev {dev}")
    assert dev == 0.0, f"lockstep and async records differ: {dev}"
    assert lock.unfinished == 0 and asyn.unfinished == 0, "unfinished jobs"
    (small_k, eng_k), launches[f"fleet_{small_lanes}_lockstep"] = counted(
        f"{small_lanes}-lane fleet lockstep ({kernel_solver})", True,
        run_fleet, device, kernel_solver, "lockstep", small_lanes, names,
    )
    (small_p, eng_p), _ = counted(
        f"{small_lanes}-lane fleet lockstep ({plain_solver})", False,
        run_fleet, device, plain_solver, "lockstep", small_lanes, names,
    )
    report_fleet(f"{small_lanes} lanes lockstep ({kernel_solver})", small_k, eng_k, card)
    report_fleet(f"{small_lanes} lanes lockstep ({plain_solver})", small_p, eng_p, card)
    dev = max_record_dev(small_k.results, small_p.results)
    log(f"[fleet] kernel vs plain max_record_rel_dev {dev}")
    assert dev == 0.0, f"kernel and plain fleet records differ: {dev}"
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    log(f"[device] {kind} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)
    build_all()
    record, by_path = stream_phase(device, "cuda", "sparse", seeds=(0, 1), n_jobs=8)
    log(f"[time] after stream phase {time.perf_counter() - t_start:.1f} s")
    by_path.update(fleet_phase(device, "cuda", "sparse", card, lanes=256, small_lanes=32))
    # the main path is the 256-lane lockstep fleet; every other path's count
    # stands beside it
    record["launches"] = by_path["fleet_256_lockstep"]
    record["launches_by_path"] = by_path
    log(f"[time] total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
