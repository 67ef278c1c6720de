"""Counters, gauges, and streaming histograms for the scheduling stack.

:class:`StreamingHistogram` answers p50/p95/p99 without retaining every
sample: the first ``exact_n`` observations are kept verbatim (so small-N
percentiles are *exact*, matching ``numpy.percentile``'s linear
interpolation), after which samples only land in fixed log-spaced buckets
(growth factor ``2**0.25`` ≈ 1.19, i.e. four buckets per octave). Bucketed
quantiles log-interpolate inside the covering bucket, so the estimate is off
from the true order statistic by at most one bucket width — a ≤19% relative
band, plenty for latency percentile reporting.

Everything here is stdlib-only (the minimal-env CI job imports it), no-ops
when constructed ``enabled=False``, and merges across registries so the
fleet runtime can aggregate per-lane histograms into per-scenario ones.
"""
from __future__ import annotations

import math

__all__ = ["NULL_METRICS", "MetricsRegistry", "StreamingHistogram"]

#: Default bucket growth factor: four log-spaced buckets per octave.
DEFAULT_GROWTH = 2.0**0.25
#: Samples kept verbatim before falling back to bucket quantiles.
DEFAULT_EXACT_N = 256


def _exact_percentile(sorted_vals: list[float], q: float) -> float:
    """numpy.percentile(method='linear') on an already-sorted list."""
    n = len(sorted_vals)
    if n == 0:
        return float("nan")
    rank = (n - 1) * q / 100.0
    lo = int(math.floor(rank))
    hi = min(lo + 1, n - 1)
    frac = rank - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class StreamingHistogram:
    """Fixed log-spaced-bucket histogram for non-negative samples.

    Samples ``<= 0`` are counted in a dedicated zero bucket (latencies can
    legitimately be 0.0 on coarse clocks). ``observe`` is O(1); memory is
    O(exact_n + occupied buckets).
    """

    def __init__(
        self, *, growth: float = DEFAULT_GROWTH, exact_n: int = DEFAULT_EXACT_N
    ) -> None:
        if growth <= 1.0:
            raise ValueError("growth must be > 1")
        self.growth = growth
        self.exact_n = exact_n
        self._log_growth = math.log(growth)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.zeros = 0  # samples <= 0 (treated as exactly 0.0)
        self._exact: list[float] = []
        self._buckets: dict[int, int] = {}  # bucket i covers [growth**i, growth**(i+1))

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if len(self._exact) < self.exact_n:
            self._exact.append(x)
            return
        self._bucket_in(x)

    def _bucket_in(self, x: float) -> None:
        if x <= 0.0:
            self.zeros += 1
            return
        i = int(math.floor(math.log(x) / self._log_growth))
        self._buckets[i] = self._buckets.get(i, 0) + 1

    def _spill(self) -> None:
        """Move the exact staging list into buckets (after a merge overflows
        the exact budget, exactness is gone anyway)."""
        for x in self._exact:
            self._bucket_in(x)
        self._exact = []

    @property
    def is_exact(self) -> bool:
        """True while every sample is still held verbatim."""
        return self.count == len(self._exact)

    def percentile(self, q: float) -> float:
        """q-th percentile. Exact (numpy-linear) while ``is_exact``; otherwise
        log-interpolated within the covering bucket (≤ one bucket width off)."""
        if self.count == 0:
            return float("nan")
        if self.is_exact:
            return _exact_percentile(sorted(self._exact), q)
        # Bucketed path: treat the exact staging samples as bucketed too so
        # ranks are consistent.
        zeros = self.zeros
        buckets = dict(self._buckets)
        for x in self._exact:
            if x <= 0.0:
                zeros += 1
            else:
                i = int(math.floor(math.log(x) / self._log_growth))
                buckets[i] = buckets.get(i, 0) + 1
        rank = (self.count - 1) * q / 100.0
        if rank < zeros:
            return 0.0
        c = zeros
        for i in sorted(buckets):
            n = buckets[i]
            if rank < c + n:
                lo = self.growth**i
                hi = self.growth ** (i + 1)
                # Clamp the edge buckets to the observed range.
                lo = max(lo, self.min) if self.min > 0 else lo
                hi = min(hi, self.max)
                if hi <= lo:
                    return hi
                frac = (rank - c + 0.5) / n
                return lo * (hi / lo) ** min(frac, 1.0)
            c += n
        return self.max

    def merge(self, other: "StreamingHistogram") -> None:
        """Fold ``other`` into self (same growth required)."""
        if abs(other.growth - self.growth) > 1e-12:
            raise ValueError("cannot merge histograms with different growth factors")
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self.zeros += other.zeros
        for i, n in other._buckets.items():
            self._buckets[i] = self._buckets.get(i, 0) + n
        if len(self._exact) + len(other._exact) <= self.exact_n and not self._buckets:
            self._exact.extend(other._exact)
        else:
            self._spill()
            for x in other._exact:
                self._bucket_in(x)

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": self.total / self.count,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50.0),
            "p95": self.percentile(95.0),
            "p99": self.percentile(99.0),
        }


class MetricsRegistry:
    """Named counters / gauges / histograms behind one enabled flag.

    Instrumented components hold :data:`NULL_METRICS` by default so hot
    paths pay only an attribute load + branch when observability is off.
    """

    def __init__(self, *, enabled: bool = True) -> None:
        self.enabled = enabled
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, StreamingHistogram] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        if not self.enabled:
            return
        self.counters[name] = self.counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = StreamingHistogram()
        h.observe(value)

    def histogram(self, name: str) -> StreamingHistogram:
        """Fetch-or-create a histogram (even when disabled, for merging)."""
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = StreamingHistogram()
        return h

    def merge(self, other: "MetricsRegistry") -> None:
        for k, v in other.counters.items():
            self.counters[k] = self.counters.get(k, 0.0) + v
        self.gauges.update(other.gauges)
        for k, h in other.histograms.items():
            self.histogram(k).merge(h)

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: h.snapshot() for k, h in self.histograms.items()},
        }


NULL_METRICS = MetricsRegistry(enabled=False)
