"""Lightweight tracing + metrics for the scheduling stack.

Stdlib-only by design: the scheduler's host code imports this package, so
it must not grow mandatory dependencies.
"""
from .metrics import NULL_METRICS, MetricsRegistry, StreamingHistogram
from .trace import NULL_TRACER, Tracer, dumps_strict, sanitize_nonfinite

__all__ = [
    "NULL_METRICS",
    "NULL_TRACER",
    "MetricsRegistry",
    "StreamingHistogram",
    "Tracer",
    "dumps_strict",
    "sanitize_nonfinite",
]
