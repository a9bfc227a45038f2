"""Process-wide metrics registry: counters, gauges, histograms.

Counterpart of ``deepspeed_tpu/telemetry/registry.py``. One registry owns
every series; exporters render snapshots of it, and the instrumented layers
(the training and inference engines, the serving front-end, resilience)
only talk to ``telemetry.get_registry()``, which returns
:class:`NoopRegistry` when telemetry is off, so a disabled run pays one
attribute load and a no-op call per instrumentation point.

Histograms keep exact count/sum/min/max, exact bucket counts when bounds
are configured (``telemetry.histogram_buckets``), and a fixed-size
reservoir (algorithm R, its ``random.Random`` seeded from the CRC-32 of the
metric's name, as in JAX) for p50/p90/p99: the same observations give the
same quantiles in both packages.
"""

from __future__ import annotations

import random
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.utils import locks as _locks


def _labels_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter. ``inc`` is locked: resilience counters fire from
    checkpoint-I/O and elastic-agent threads while the main thread reads."""

    kind = "counter"

    def __init__(self, name: str, labels=None):
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0.0
        self._lock = _locks.make_lock("telemetry.counter")

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def snapshot(self) -> dict:
        return {"kind": self.kind, "name": self.name, "labels": self.labels,
                "value": self.value}


class Gauge:
    """Last-write-wins scalar."""

    kind = "gauge"

    def __init__(self, name: str, labels=None):
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> dict:
        return {"kind": self.kind, "name": self.name, "labels": self.labels,
                "value": self.value}


class Histogram:
    """Exact count/sum/min/max (+ bucket counts when ``bounds`` given) and
    reservoir-sampled percentiles.

    The reservoir holds at most ``max_samples`` observations; past that,
    observation ``k`` replaces a random slot with probability
    ``max_samples/k`` (algorithm R), so the sample stays uniform over the
    whole stream. The RNG is seeded from the metric name: a run's
    percentile estimates reproduce exactly.
    """

    kind = "histogram"

    def __init__(self, name: str, labels=None, max_samples: int = 512,
                 bounds: Optional[Sequence[float]] = None):
        self.name = name
        self.labels = dict(labels or {})
        self.max_samples = max(1, int(max_samples))
        self.bounds = sorted(float(b) for b in bounds) if bounds else None
        self.bucket_counts = [0] * (len(self.bounds) + 1) if self.bounds else None
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.samples: List[float] = []
        self._rng = random.Random(zlib.crc32(name.encode("utf-8")))
        # observe() is a multi-field update (count/sum/buckets/reservoir);
        # interleaved cross-thread observes would desync count from buckets
        self._lock = _locks.make_lock("telemetry.histogram")

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if self.bounds is not None:
                i = 0
                for i, b in enumerate(self.bounds):
                    if v <= b:
                        break
                else:
                    i = len(self.bounds)
                self.bucket_counts[i] += 1
            if len(self.samples) < self.max_samples:
                self.samples.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self.max_samples:
                    self.samples[j] = v

    def percentile(self, p: float) -> float:
        """Linear-interpolated percentile over the reservoir (exact while
        count <= max_samples)."""
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        if len(s) == 1:
            return s[0]
        idx = (len(s) - 1) * (p / 100.0)
        lo = int(idx)
        hi = min(lo + 1, len(s) - 1)
        frac = idx - lo
        return s[lo] * (1 - frac) + s[hi] * frac

    def snapshot(self) -> dict:
        out = {"kind": self.kind, "name": self.name, "labels": self.labels,
               "count": self.count, "sum": self.sum,
               "min": self.min if self.min is not None else 0.0,
               "max": self.max if self.max is not None else 0.0,
               "p50": self.percentile(50), "p90": self.percentile(90),
               "p99": self.percentile(99)}
        if self.bounds is not None:
            out["bounds"] = self.bounds
            out["bucket_counts"] = list(self.bucket_counts)
        return out


class MetricsRegistry:
    """Name+labels → metric, created on first touch. Creation, counter
    increments, and histogram observes are all locked (the elastic agent and
    async checkpointing touch counters off the main thread); gauges are a
    single last-write-wins store and stay lock-free."""

    enabled = True

    def __init__(self, default_max_samples: int = 512,
                 default_bounds: Optional[Sequence[float]] = None):
        self.default_max_samples = default_max_samples
        self.default_bounds = list(default_bounds) if default_bounds else None
        self._metrics: Dict[tuple, object] = {}
        self._lock = _locks.make_lock("telemetry.registry")

    def _get(self, kind: str, name: str, labels, factory):
        key = (kind, name, _labels_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = factory()
                    self._metrics[key] = m
        return m

    def counter(self, name: str, labels=None) -> Counter:
        return self._get("counter", name, labels, lambda: Counter(name, labels))

    def gauge(self, name: str, labels=None) -> Gauge:
        return self._get("gauge", name, labels, lambda: Gauge(name, labels))

    def histogram(self, name: str, labels=None, max_samples: Optional[int] = None,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(
            "histogram", name, labels,
            lambda: Histogram(name, labels,
                              max_samples=max_samples or self.default_max_samples,
                              bounds=bounds if bounds is not None else self.default_bounds))

    def snapshot(self) -> List[dict]:
        """Point-in-time dump of every metric, insertion-ordered."""
        with self._lock:
            metrics = list(self._metrics.values())
        return [m.snapshot() for m in metrics]

    def __len__(self) -> int:
        return len(self._metrics)


class _NoopMetric:
    """One shared instance absorbs every mutation when telemetry is off."""

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    value = 0.0
    count = 0


_NOOP_METRIC = _NoopMetric()


class NoopRegistry:
    """Same surface as :class:`MetricsRegistry`, zero state, zero overhead —
    the default when no telemetry session is configured (NoopTimer pattern)."""

    enabled = False

    def counter(self, name, labels=None):
        return _NOOP_METRIC

    def gauge(self, name, labels=None):
        return _NOOP_METRIC

    def histogram(self, name, labels=None, max_samples=None, bounds=None):
        return _NOOP_METRIC

    def snapshot(self):
        return []

    def __len__(self):
        return 0


NOOP_REGISTRY = NoopRegistry()
