"""Lightweight metrics registry: counters, gauges, bucketed histograms.

The port's copy of ``repro/obs/registry.py``, with the same snapshot and
dump format, so one reader (the reference's ``obs`` CLI) reads the dumps
of both packages. The aggregate twin of the span journal: instrumentation
points increment in-process metrics with near-zero cost (a dict lookup + an
add), and the registry renders a Prometheus-style text exposition or a
JSON dump that merges across processes. No background threads, no sockets:
everything is pull-based and file-backed.

Histograms use fixed exponential bucket bounds (default: 1 µs → ~2100 s,
factor 2), tracking count/sum/min/max plus per-bucket counts; ``p50``/
``p99`` are rank interpolations inside the landing bucket — exact enough
for the serving layer's latency accounting at O(1) memory, and mergeable
across processes because the bounds are part of the dump.
"""
from __future__ import annotations

import bisect
import json
import math
import os
from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_buckets"]


def default_buckets() -> List[float]:
    """Exponential bounds 1e-6 * 2^k, k=0..30 (1 µs .. ~2147 s)."""
    return [1e-6 * (2.0 ** k) for k in range(31)]


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}

    def merge(self, snap: dict) -> None:
        self.value += float(snap.get("value", 0.0))


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}

    def merge(self, snap: dict) -> None:
        self.value = float(snap.get("value", self.value))   # last wins


class Histogram:
    """Fixed-bound bucketed histogram with interpolated percentiles."""

    __slots__ = ("bounds", "buckets", "count", "sum", "min", "max")

    def __init__(self, bounds: Optional[List[float]] = None):
        self.bounds = list(bounds) if bounds is not None else \
            default_buckets()
        self.buckets = [0] * (len(self.bounds) + 1)   # +overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.buckets[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def percentile(self, p: float) -> Optional[float]:
        """Rank-interpolated percentile estimate (None when empty)."""
        if self.count == 0:
            return None
        rank = (p / 100.0) * self.count
        seen = 0
        for i, c in enumerate(self.buckets):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else min(self.min, 0.0)
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return lo
                frac = (rank - seen) / c
                return lo + frac * (hi - lo)
            seen += c
        return self.max

    @property
    def p50(self) -> Optional[float]:
        return self.percentile(50)

    @property
    def p99(self) -> Optional[float]:
        return self.percentile(99)

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def snapshot(self) -> dict:
        return {"type": "histogram", "bounds": self.bounds,
                "buckets": list(self.buckets), "count": self.count,
                "sum": self.sum,
                "min": None if self.count == 0 else self.min,
                "max": None if self.count == 0 else self.max}

    def merge(self, snap: dict) -> None:
        if snap.get("bounds") != self.bounds:
            raise ValueError("cannot merge histograms with different bounds")
        self.buckets = [a + b for a, b in zip(self.buckets,
                                              snap["buckets"])]
        self.count += int(snap["count"])
        self.sum += float(snap["sum"])
        if snap.get("min") is not None:
            self.min = min(self.min, float(snap["min"]))
        if snap.get("max") is not None:
            self.max = max(self.max, float(snap["max"]))


class MetricsRegistry:
    """Name -> metric table with get-or-create accessors.

    Names follow Prometheus conventions (``snake_case``, unit-suffixed:
    ``_total``, ``_seconds``). ``to_prom`` renders the text exposition;
    ``dump``/``load``/``merge_snapshot`` move registries across process
    boundaries as JSON files."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = cls(*args)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: Optional[List[float]] = None) -> Histogram:
        if bounds is None:
            return self._get(name, Histogram)
        return self._get(name, Histogram, bounds)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    # -- serialization ------------------------------------------------------
    def snapshot(self) -> dict:
        return {name: m.snapshot() for name, m in
                sorted(self._metrics.items())}

    def dump(self, path: str) -> str:
        """Atomic JSON dump: write-then-rename, so a process crash leaves
        either the old file or the new one, never a torn mix. No fsync:
        metrics are a derived view (the journal is the source of truth),
        so power-loss durability is not worth milliseconds on the serving
        tick path."""
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(), f)
        os.replace(tmp, path)
        return path

    def merge_snapshot(self, snap: dict) -> "MetricsRegistry":
        """Fold a ``snapshot()``/``dump`` document into this registry
        (counters/histograms add, gauges last-write-wins)."""
        for name, doc in snap.items():
            kind = doc.get("type")
            if kind == "counter":
                self.counter(name).merge(doc)
            elif kind == "gauge":
                self.gauge(name).merge(doc)
            elif kind == "histogram":
                self.histogram(name, doc["bounds"]).merge(doc)
        return self

    @classmethod
    def load(cls, path: str) -> "MetricsRegistry":
        with open(path) as f:
            return cls().merge_snapshot(json.load(f))

    # -- exposition ---------------------------------------------------------
    def to_prom(self, prefix: str = "repro") -> str:
        """Prometheus-style text exposition of every metric."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            full = f"{prefix}_{name}"
            if isinstance(m, Counter):
                lines += [f"# TYPE {full} counter",
                          f"{full} {m.value:g}"]
            elif isinstance(m, Gauge):
                lines += [f"# TYPE {full} gauge",
                          f"{full} {m.value:g}"]
            else:
                lines.append(f"# TYPE {full} histogram")
                cum = 0
                for b, c in zip(m.bounds, m.buckets):
                    cum += c
                    if c:
                        lines.append(f'{full}_bucket{{le="{b:g}"}} {cum}')
                lines += [f'{full}_bucket{{le="+Inf"}} {m.count}',
                          f"{full}_sum {m.sum:g}",
                          f"{full}_count {m.count}"]
                if m.count:
                    lines.append(f"{full}_p99 {m.p99:g}")
        return "\n".join(lines) + ("\n" if lines else "")
