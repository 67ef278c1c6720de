"""Span tracer with a Chrome trace-event (Perfetto-loadable) exporter.

The scheduling stack is a host-side control plane: its latency story is told
by *spans* — where did the wall-clock of one event go? — not by aggregate
counters. :class:`Tracer` records begin/end (``B``/``E``) spans, explicit
complete (``X``) spans with caller-supplied timestamps (the fleet runtime
uses these to draw per-lane barrier-stall intervals it attributes
arithmetically rather than measures), and instant (``i``) markers, each on a
named *track* (one per fleet lane plus one for the shared engine).

Design constraints:

* **Near-zero overhead when disabled.** ``Tracer(enabled=False)`` (or the
  module-level :data:`NULL_TRACER` default every instrumented component
  carries) answers ``span()`` with one shared no-op context manager and
  returns immediately from every emit method — instrumentation stays in the
  hot paths permanently, gated by a single attribute load + branch. The
  fleet benchmark's ``latency`` section asserts the enabled path costs <5%
  wall-clock on the non-smoke fleet run.
* **Strict JSON out.** Both exporters serialize through
  :func:`dumps_strict` (non-finite floats -> ``null``, ``allow_nan=False``),
  the same sanitizer the fleet telemetry JSONL uses, so every artifact
  parses under RFC 8259 — ``chrome://tracing`` and Perfetto both reject the
  non-standard ``Infinity``/``NaN`` tokens.

Timestamps are seconds on the tracer's own monotonic clock (zeroed at
construction); the Chrome exporter converts to the microseconds the format
requires. Load the exported file in https://ui.perfetto.dev ("Open trace
file") or ``chrome://tracing``.
"""
from __future__ import annotations

import json
import math
import time

__all__ = [
    "NULL_TRACER",
    "Tracer",
    "dumps_strict",
    "sanitize_nonfinite",
]


def sanitize_nonfinite(obj):
    """Recursively replace non-finite floats (inf / -inf / nan) with None so
    the result serializes under RFC 8259 (which has no such literals)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: sanitize_nonfinite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_nonfinite(v) for v in obj]
    return obj


def dumps_strict(obj, **kwargs) -> str:
    """``json.dumps`` that can never emit a non-RFC-8259 token. Extra kwargs
    (``indent=``, ``sort_keys=``…) pass through to ``json.dumps``; the
    telemetry-strictness lint (TS401) makes this the repo's only
    serialization door outside this module."""
    return json.dumps(sanitize_nonfinite(obj), allow_nan=False, **kwargs)


class _NullSpan:
    """Shared no-op context manager the disabled tracer hands out."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Context manager emitting a ``B``/``E`` pair on one track."""

    __slots__ = ("_tracer", "_name", "_track", "_cat", "_args")

    def __init__(self, tracer: "Tracer", name: str, track: str, cat: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_Span":
        self._tracer.begin(self._name, track=self._track, cat=self._cat, **self._args)
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer.end(self._name, track=self._track)
        return False


class Tracer:
    """Event-level span recorder with one timeline track per component.

    All emit methods are no-ops when ``enabled`` is False. ``ts``/``dur``
    are seconds on the tracer clock (:meth:`now`); events accumulate
    in-memory (a control-plane run emits thousands, not millions) and export
    via :meth:`to_chrome`.
    """

    def __init__(self, *, enabled: bool = True) -> None:
        self.enabled = enabled
        self.events: list[dict] = []
        self._t0 = time.perf_counter()
        self._tracks: dict[str, int] = {}

    # -- clock ----------------------------------------------------------------
    def now(self) -> float:
        """Seconds since tracer construction (the trace's time origin)."""
        return time.perf_counter() - self._t0

    def _tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            tid = self._tracks[track] = len(self._tracks)
        return tid

    # -- emit -----------------------------------------------------------------
    def begin(self, name: str, *, track: str = "main", cat: str = "span", **args) -> None:
        """Open a span on ``track``; must be closed by :meth:`end` (stack
        discipline per track — the exporter test asserts balance)."""
        if not self.enabled:
            return
        self.events.append(
            {
                "ph": "B",
                "name": name,
                "cat": cat,
                "tid": self._tid(track),
                "ts": self.now(),
                "args": args or None,
            }
        )

    def end(self, name: str, *, track: str = "main") -> None:
        if not self.enabled:
            return
        self.events.append(
            {"ph": "E", "name": name, "cat": "", "tid": self._tid(track), "ts": self.now()}
        )

    def span(self, name: str, *, track: str = "main", cat: str = "span", **args):
        """Context manager measuring a span on the tracer clock."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, track, cat, args)

    def complete(
        self,
        name: str,
        *,
        track: str = "main",
        cat: str = "span",
        ts: float,
        dur: float,
        **args,
    ) -> None:
        """Explicit-interval span (``X`` event): the caller supplies start +
        duration in tracer-clock seconds. This is how *attributed* (computed,
        not measured) intervals are drawn — e.g. a lane's barrier-stall share
        of a batched dispatch."""
        if not self.enabled:
            return
        self.events.append(
            {
                "ph": "X",
                "name": name,
                "cat": cat,
                "tid": self._tid(track),
                "ts": ts,
                "dur": dur,
                "args": args or None,
            }
        )

    def instant(self, name: str, *, track: str = "main", cat: str = "span", **args) -> None:
        """Zero-duration marker (``i`` event)."""
        if not self.enabled:
            return
        self.events.append(
            {
                "ph": "i",
                "name": name,
                "cat": cat,
                "tid": self._tid(track),
                "ts": self.now(),
                "s": "t",
                "args": args or None,
            }
        )

    # -- export ---------------------------------------------------------------
    def to_chrome(self, path: str, *, process_name: str = "repro-scheduler") -> None:
        """Write the Chrome trace-event JSON (Perfetto / ``chrome://tracing``
        loadable): metadata rows naming the process and one thread per track
        (in registration order, so lane tracks sort stably), then every
        recorded event with timestamps converted to microseconds."""
        pid = 1
        trace_events: list[dict] = [
            {
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "name": "process_name",
                "args": {"name": process_name},
            }
        ]
        for track, tid in sorted(self._tracks.items(), key=lambda kv: kv[1]):
            trace_events.append(
                {
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "name": "thread_name",
                    "args": {"name": track},
                }
            )
            trace_events.append(
                {
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "name": "thread_sort_index",
                    "args": {"sort_index": tid},
                }
            )
        for ev in self.events:
            out = {"pid": pid, **ev}
            out["ts"] = ev["ts"] * 1e6
            if "dur" in ev:
                out["dur"] = ev["dur"] * 1e6
            if out.get("args") is None:
                out.pop("args", None)
            trace_events.append(out)
        with open(path, "w") as f:
            f.write(dumps_strict({"traceEvents": trace_events, "displayTimeUnit": "ms"}))


NULL_TRACER = Tracer(enabled=False)
