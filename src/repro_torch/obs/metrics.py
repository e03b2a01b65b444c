"""Counters/gauges/histograms with Prometheus text exposition.

A `MetricsRegistry` aggregates across collections: each instrument is
registered once by name and fans out per label-set (tenant/collection/
backend/...).  Fixed-bucket histograms replace the reservoir-only
percentiles of `CollectionTelemetry` for cross-collection aggregation —
bucket counts sum across label-sets and scrape intervals, reservoirs do
not.

Everything is lock-protected and allocation-light: `inc`/`set`/
`observe` take one dict lookup + one lock.  When no registry is
attached the callers skip the calls entirely (see telemetry.py), so
disabled mode pays nothing here.

`prometheus_text()` renders the standard text exposition format
(HELP/TYPE headers, label escaping, cumulative `_bucket{le=...}` +
`_sum`/`_count` per histogram series) suitable for a Prometheus scrape
(`obs.start_metrics_server`).  A copy of the JAX package's
`repro.obs.metrics`, which imports nothing of JAX: the same record
sequence renders the same text in both packages.
"""

from __future__ import annotations

import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_LATENCY_BUCKETS"]

# Request latencies from sub-ms kernel calls to multi-second cold
# compiles; seconds, matching Prometheus convention.
DEFAULT_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(label_names: tuple, labels: dict) -> tuple:
    return tuple(str(labels.get(n, "")) for n in label_names)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(names: tuple, values: tuple, extra: str = "") -> str:
    parts = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_num(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


class _Instrument:
    def __init__(self, name: str, help_text: str, label_names: tuple):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()


class Counter(_Instrument):
    kind = "counter"

    def __init__(self, name, help_text="", label_names=()):
        super().__init__(name, help_text, label_names)
        self._values: dict[tuple, float] = {}

    def inc(self, v: float = 1, **labels):
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + v

    def value(self, **labels) -> float:
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._values.get(key, 0)

    def expose(self) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{_fmt_labels(self.label_names, k)} "
                f"{_fmt_num(v)}" for k, v in items]


class Gauge(_Instrument):
    kind = "gauge"

    def __init__(self, name, help_text="", label_names=()):
        super().__init__(name, help_text, label_names)
        self._values: dict[tuple, float] = {}

    def set(self, v: float, **labels):
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._values[key] = v

    def inc(self, v: float = 1, **labels):
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + v

    def value(self, **labels) -> float:
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._values.get(key, 0)

    def expose(self) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{_fmt_labels(self.label_names, k)} "
                f"{_fmt_num(v)}" for k, v in items]


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name, help_text="", label_names=(),
                 buckets=DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help_text, label_names)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # per label-set: [bucket counts..., +Inf count], sum
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}

    def observe(self, v: float, **labels):
        key = _label_key(self.label_names, labels)
        v = float(v)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
                self._sums[key] = 0.0
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[key] += v

    def snapshot(self, **labels):
        """(cumulative bucket counts keyed by upper bound, sum, count)."""
        key = _label_key(self.label_names, labels)
        with self._lock:
            counts = list(self._counts.get(key, []))
            total_sum = self._sums.get(key, 0.0)
        if not counts:
            counts = [0] * (len(self.buckets) + 1)
        cum, acc = {}, 0
        for ub, c in zip(self.buckets, counts):
            acc += c
            cum[ub] = acc
        cum[math.inf] = acc + counts[-1]
        return cum, total_sum, cum[math.inf]

    def quantile(self, q: float, **labels) -> float:
        """Bucket-interpolated quantile (upper bound of the bucket the
        q-th observation falls in) — coarse but aggregation-safe."""
        cum, _, count = self.snapshot(**labels)
        if count == 0:
            return 0.0
        rank = q * count
        for ub, c in cum.items():
            if c >= rank:
                return self.buckets[-1] if ub == math.inf else ub
        return self.buckets[-1]

    def expose(self) -> list[str]:
        with self._lock:
            keys = sorted(self._counts)
        lines = []
        for key in keys:
            cum, total_sum, count = self.snapshot(
                **dict(zip(self.label_names, key)))
            for ub, c in cum.items():
                le = _fmt_labels(self.label_names, key,
                                 f'le="{_fmt_num(ub)}"')
                lines.append(f"{self.name}_bucket{le} {c}")
            base = _fmt_labels(self.label_names, key)
            lines.append(f"{self.name}_sum{base} {_fmt_num(total_sum)}")
            lines.append(f"{self.name}_count{base} {count}")
        return lines


class MetricsRegistry:
    """Get-or-create instrument registry with one text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}

    def _get(self, cls, name, help_text, label_names, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help_text, tuple(label_names), **kw)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{inst.kind}, not {cls.kind}")
            return inst

    def counter(self, name, help_text="", labels=()) -> Counter:
        return self._get(Counter, name, help_text, labels)

    def gauge(self, name, help_text="", labels=()) -> Gauge:
        return self._get(Gauge, name, help_text, labels)

    def histogram(self, name, help_text="", labels=(),
                  buckets=DEFAULT_LATENCY_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_text, labels,
                         buckets=buckets)

    def get(self, name) -> _Instrument | None:
        with self._lock:
            return self._instruments.get(name)

    def prometheus_text(self) -> str:
        with self._lock:
            instruments = sorted(self._instruments.items())
        lines = []
        for name, inst in instruments:
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            lines.append(f"# TYPE {name} {inst.kind}")
            lines.extend(inst.expose())
        return "\n".join(lines) + "\n"
