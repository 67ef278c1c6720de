"""The device trace of a traced run's window, reduced to what the per-layer
metrics and the breakdown read.

A frozen copy of ``chip_smoke.py:1249`` ``profile_window``: ``torch.profiler``
records the device's activity only (recording the host's ops too doubled a
window's cost), the kernels are read from the trace's raw events, and the
window starts ``PROFILER_SETTLE_S`` after the session does, since a session
may miss the launches made in its first moments (``chip_smoke.py:1246``).
Only the summary is kept; nothing is written to disk.
"""
from __future__ import annotations

import contextlib
import time

import torch

PROFILER_SETTLE_S = 0.02
TOP = 10


@contextlib.contextmanager
def record(out: dict):
    """Profile the block's device activity; on exit ``out["kernels"]`` holds
    (start_us, end_us, name) of every device operation, in start order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_SETTLE_S)
        yield out
        torch.cuda.synchronize()
    out["kernels"] = sorted(
        (e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3, e.name())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA
        and not getattr(e, "is_hidden_event", lambda: False)()
    )


def summarize(kernels: list, window_s: float) -> dict:
    """Busy seconds (the union of the operations' intervals), time by
    operation name, and the idle gaps between operations, each named by the
    operation the device waited for: the one the host was launching."""
    busy_us, end = 0.0, None
    by_name: dict[str, float] = {}
    gaps: dict[str, float] = {}
    for start, stop, name in kernels:
        if end is not None and start > end:
            key = f"host launching {name[:72]}"
            gaps[key] = gaps.get(key, 0.0) + (start - end) / 1e6
        if end is None or stop > end:
            busy_us += stop - (start if end is None else max(start, end))
            end = stop
        by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "by_name": by_name,
        "device_ops": [[name[:96], s] for name, s in top],
        "idle_gaps": [[k, s] for k, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    }
