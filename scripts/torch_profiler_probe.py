#!/usr/bin/env python3
"""How often a ``torch.profiler`` session on one NVIDIA GPU loses launches.

Usage, from the repository root on a machine with a CUDA card::

    python3 scripts/torch_profiler_probe.py [--sessions 400] [--pauses 0 0.001 0.005]
        [--checks 100]

Each session records the device only, as ``chip_smoke.py``'s
``profile_window`` does, around 32 ``add_`` and then 32 ``mul_`` launches on a
4 MB tensor, which start a host pause of one of ``--pauses`` seconds after the
session does; the pauses take turns session by session. For each pause it
prints how many sessions recorded each (adds, multiplies) count: a loss at
the window's start takes adds first. Then it runs ``chip_smoke.py``'s own
profiler check (``profile_window`` on 64 known launches, raw events against
the event tree) ``--checks`` times and counts the passes. The last line is
the result as one JSON object.
"""
from __future__ import annotations

import argparse
import collections
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
LAUNCHES = 32  # of each kernel


def window(x: torch.Tensor, pause: float) -> tuple[int, int]:
    """One session; the adds and multiplies it recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pause)
        for _ in range(LAUNCHES):
            x.add_(1.0)
        for _ in range(LAUNCHES):
            x.mul_(1.0)
        torch.cuda.synchronize()
    names = [e.name().lower() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA
             and not getattr(e, "is_hidden_event", lambda: False)()]
    return sum("add" in n for n in names), sum("mul" in n for n in names)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=400, help="sessions at each pause")
    ap.add_argument("--pauses", type=float, nargs="+", default=[0.0, 0.001, 0.005])
    ap.add_argument("--checks", type=int, default=100, help="chip_smoke profiler checks")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_profiler_probe: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.obs.trace import dumps_strict

    card = chip_smoke.card_line()
    x = torch.zeros(1 << 20, device="cuda")
    t0 = time.perf_counter()
    tally = {p: collections.Counter() for p in args.pauses}
    for _ in range(args.sessions):
        for p in args.pauses:
            tally[p][window(x, p)] += 1
    out = {"card": card, "torch": torch.__version__, "launches": [LAUNCHES, LAUNCHES],
           "sessions": {str(p): {f"{a},{m}": n for (a, m), n in sorted(c.items())}
                        for p, c in tally.items()},
           "lossy_sessions": {str(p): sum(n for (a, m), n in c.items()
                                          if (a, m) != (LAUNCHES, LAUNCHES))
                              for p, c in tally.items()}}
    passed = 0
    for _ in range(args.checks):
        try:
            chip_smoke.profiler_check(torch.device("cuda", 0), card)
            passed += 1
        except AssertionError as e:
            print(f"[profiler probe] check failed: {e}", flush=True)
    out.update(checks=args.checks, checks_passed=passed,
               settle_s=chip_smoke.PROFILER_SETTLE_S, seconds=time.perf_counter() - t0)
    print(dumps_strict(out), flush=True)
    return out


if __name__ == "__main__":
    main()
