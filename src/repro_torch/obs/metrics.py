"""Metrics registry: counters, gauges, and log-bucket histograms.

One namespaced surface for telemetry that would otherwise scatter across
``FleetExecutor.last_bin_stats`` dicts, ``InvocationMonitor`` record
lists, per-store read counters, journal stats, and the module-global
retrace counter in ``forecast/features.py``.

Design constraints:

- **Zero-alloc hot path.** ``Counter.inc`` / ``Gauge.set`` are single
  attribute writes; ``Histogram.observe`` indexes a pre-allocated bucket
  list via ``math.frexp`` (no log, no dict, no allocation). Hot code
  holds a direct reference to the metric object — the registry dict is
  only probed at get-or-create time.
- **Log buckets.** Buckets are powers of two: bucket ``i`` covers
  ``[2**(i+EMIN-1), 2**(i+EMIN))`` (bucket 0 additionally absorbs
  underflow and non-positive values). 64 buckets starting at 2**-27
  (~7.5 ns) span everything from sub-microsecond span durations to
  multi-gigabyte byte counts.
- **Quantiles are bucket-bounded.** ``quantile(q)`` returns the upper
  edge of the bucket where the cumulative count crosses ``q``, clamped
  to the observed ``[min, max]`` — so the estimate is always within a
  factor of 2 of the true order statistic and never outside the
  observed range. The hypothesis property tests pin exactly this.

Thread-safety: metric *creation* is locked; *updates* are plain
attribute read-modify-writes. Concurrent increments may rarely lose an
update under free-threading — acceptable for telemetry, and the repo's
hot paths (fleet bins, journal flush) update metrics from one thread.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Tuple

_EMIN = -27          # bucket 0 upper edge = 2**_EMIN (~7.5e-9)
_NBUCKETS = 64       # top bucket lower edge = 2**(_EMIN+62) (~3.4e10)

_frexp = math.frexp


class Counter:
    """Monotonic counter. ``inc`` is one attribute add."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


def bucket_index(v: float) -> int:
    """Log2 bucket index for ``v`` (clamped to [0, _NBUCKETS-1]).

    For ``v > 0``: ``frexp(v) = (m, e)`` with ``v = m * 2**e`` and
    ``0.5 <= m < 1``, so ``v`` lies in ``[2**(e-1), 2**e)`` and the
    bucket index is ``e - _EMIN``. Non-positive values land in bucket 0.
    """
    if v <= 0.0:
        return 0
    i = _frexp(v)[1] - _EMIN
    if i < 0:
        return 0
    if i >= _NBUCKETS:
        return _NBUCKETS - 1
    return i


def bucket_bounds(i: int) -> Tuple[float, float]:
    """(lower, upper] edges of bucket ``i``; bucket 0's lower edge is 0."""
    hi = 2.0 ** (i + _EMIN)
    lo = 0.0 if i == 0 else 2.0 ** (i + _EMIN - 1)
    return lo, hi


class Histogram:
    """Fixed 64-bucket log2 histogram with running count/sum/min/max."""
    __slots__ = ("name", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.counts: List[int] = [0] * _NBUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            i = 0
        else:
            i = _frexp(v)[1] - _EMIN
            if i < 0:
                i = 0
            elif i >= _NBUCKETS:
                i = _NBUCKETS - 1
        self.counts[i] += 1

    def quantile(self, q: float) -> float:
        """Bucket-upper-edge estimate of the ``q`` order statistic,
        clamped to the observed [min, max]. 0.0 when empty."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                hi = 2.0 ** (i + _EMIN)
                if hi < self.min:
                    return self.min
                if hi > self.max:
                    return self.max
                return hi
        return self.max

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "mean": (self.sum / self.count) if self.count else 0.0,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Get-or-create registry keyed by dotted metric name.

    Names are namespaced by subsystem: ``exec.*`` (fleet bins),
    ``serverless.*`` (invocations), ``store.*``, ``wal.*`` (journal),
    ``runtime.*``, ``rollout_cache.*``, ``jit.retrace.*``,
    ``detection.*`` (per-deployment rolling error gauges).
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name)
                    self._metrics[name] = m
        if type(m) is not cls:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def items(self):
        with self._lock:
            return sorted(self._metrics.items())

    def snapshot(self) -> dict:
        """{name: scalar | histogram-summary dict}, sorted by name."""
        out = {}
        for name, m in self.items():
            if type(m) is Histogram:
                out[name] = m.summary()
            else:
                out[name] = m.value
        return out

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


_GLOBAL = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    """The process-global registry. Components constructed outside a
    ``Castor`` (direct executor/store construction in tests and
    benchmarks) default to this."""
    return _GLOBAL


def note_retrace(name: str) -> None:
    """Shared retrace-counter helper.

    Call as the first line of a traced (compiled) function body: the
    Python body only runs while it is traced, so each increment is one
    (re)trace of that function. Eager PyTorch traces nothing, so the
    port's counters stay at 0. Unlike ``forecast.features.note_trace`` this keeps a
    *named* counter per hot-path fn (``jit.retrace.<name>``) in the
    global registry; the legacy un-named total keeps its existing delta
    semantics and is mirrored here by ``features.note_trace`` itself.
    """
    _GLOBAL.counter("jit.retrace." + name).inc()


def retrace_counts() -> Dict[str, int]:
    """{fn-name: retrace count} for every ``jit.retrace.*`` counter."""
    pre = "jit.retrace."
    return {name[len(pre):]: m.value for name, m in _GLOBAL.items()
            if name.startswith(pre)}
