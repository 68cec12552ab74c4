"""Prometheus-style metrics registry for the serving gateway.

Self-contained (stdlib-only) implementation of the three metric
families the gateway needs, plus a rolling-window ratio/mean type for
SLA attainment over recent outcomes:

  * :class:`Counter`   — monotone totals (``gateway_requests_total``);
    ``inc()`` for event feeds, ``set_total()`` for sampling an already-
    monotone upstream counter (the session's ``runs_executed``) without
    double counting,
  * :class:`Gauge`     — point-in-time values (queue depth, arena
    residency), re-sampled at scrape time,
  * :class:`Histogram` — cumulative-bucket distributions with
    configurable upper bounds (request latency, TTFT), exposed with the
    standard ``_bucket{le=...}`` / ``_sum`` / ``_count`` series,
  * :class:`Rolling`   — a fixed-window deque of recent observations
    exposed as a gauge (mean over the window). ``Rolling`` of 0/1
    outcomes is the gateway's *live* per-model/per-class attainment:
    unlike a since-boot ratio it recovers when an overload clears,
    which is what an operator (or the brownout controller) wants to
    watch.

Exposition follows the Prometheus text format (version 0.0.4): one
``# HELP`` / ``# TYPE`` pair per family, label values escaped, series
in insertion order. All durations are exported in **seconds** on the
session clock (the SLA-relevant clock — virtual under the sim backend,
wall under the JAX engine); metric names carry the ``gateway_`` prefix
and counters end in ``_total`` (see README "Serving gateway" for the
full naming convention).
"""
from __future__ import annotations

import math
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_LabelKey = Tuple[str, ...]


def _escape(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt(value: float) -> str:
    if isinstance(value, float):
        if math.isnan(value):
            return "NaN"
        if math.isinf(value):
            return "+Inf" if value > 0 else "-Inf"
        if value == int(value) and abs(value) < 1e15:
            return str(int(value))
    return repr(value) if isinstance(value, float) else str(value)


class Metric:
    """One metric family: a name, help text, declared label names, and
    a per-label-value-tuple series table."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._series: Dict[_LabelKey, object] = {}

    def _key(self, labels: Dict[str, str]) -> _LabelKey:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def _render_labels(self, key: _LabelKey,
                       extra: Sequence[Tuple[str, str]] = ()) -> str:
        pairs = [f'{n}="{_escape(v)}"'
                 for n, v in zip(self.labelnames, key)]
        pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
        return "{" + ",".join(pairs) + "}" if pairs else ""

    def samples(self) -> Iterable[Tuple[str, str, float]]:
        """Yield ``(suffix, rendered_labels, value)`` rows."""
        raise NotImplementedError

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for suffix, labels, value in self.samples():
            lines.append(f"{self.name}{suffix}{labels} {_fmt(value)}")
        return lines


class Counter(Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc {amount})")
        key = self._key(labels)
        self._series[key] = self._series.get(key, 0.0) + amount

    def set_total(self, value: float, **labels):
        """Feed an upstream *already-monotone* counter by absolute value
        (e.g. the session's ``runs_executed`` sampled at run
        boundaries): the series takes ``max(current, value)`` so
        re-sampling is idempotent and monotonicity is preserved."""
        key = self._key(labels)
        self._series[key] = max(self._series.get(key, 0.0), float(value))

    def value(self, **labels) -> float:
        return float(self._series.get(self._key(labels), 0.0))

    def total(self) -> float:
        return float(sum(self._series.values()))

    def samples(self):
        for key, value in self._series.items():
            yield "", self._render_labels(key), value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, **labels):
        self._series[self._key(labels)] = float(value)

    def value(self, **labels) -> float:
        return float(self._series.get(self._key(labels), float("nan")))

    def samples(self):
        for key, value in self._series.items():
            yield "", self._render_labels(key), value


#: Default latency buckets (seconds, session clock): spans the sim
#: workloads' ms-scale SLAs and the JAX engine's CPU wall-clock runs.
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                   2.5, 5.0, 10.0)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds or any(b <= 0 for b in bounds):
            raise ValueError(
                f"histogram {name} needs positive, non-empty buckets, "
                f"got {buckets}")
        self.bounds = bounds

    def observe(self, value: float, **labels):
        key = self._key(labels)
        row = self._series.get(key)
        if row is None:
            row = {"buckets": [0] * len(self.bounds),
                   "sum": 0.0, "count": 0}
            self._series[key] = row
        for i, bound in enumerate(self.bounds):
            if value <= bound:
                row["buckets"][i] += 1
        row["sum"] += float(value)
        row["count"] += 1

    def count(self, **labels) -> int:
        row = self._series.get(self._key(labels))
        return 0 if row is None else row["count"]

    def samples(self):
        for key, row in self._series.items():
            for bound, n in zip(self.bounds, row["buckets"]):
                yield ("_bucket",
                       self._render_labels(key, [("le", _fmt(bound))]), n)
            yield ("_bucket",
                   self._render_labels(key, [("le", "+Inf")]),
                   row["count"])
            yield "_sum", self._render_labels(key), row["sum"]
            yield "_count", self._render_labels(key), row["count"]


class Rolling(Metric):
    """Rolling-window mean exposed as a gauge: each series keeps its last
    ``window`` observations; the exported value is their mean (NaN until
    the first observation). Observing 0/1 outcomes makes this a live
    attainment ratio; observing durations makes it a rolling mean."""

    kind = "gauge"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (), window: int = 256):
        super().__init__(name, help, labelnames)
        if window < 1:
            raise ValueError(f"rolling window must be >= 1, got {window}")
        self.window = window

    def observe(self, value: float, **labels):
        key = self._key(labels)
        dq = self._series.get(key)
        if dq is None:
            dq = deque(maxlen=self.window)
            self._series[key] = dq
        dq.append(float(value))

    def value(self, **labels) -> float:
        dq = self._series.get(self._key(labels))
        if not dq:
            return float("nan")
        return sum(dq) / len(dq)

    def samples(self):
        for key, dq in self._series.items():
            mean = sum(dq) / len(dq) if dq else float("nan")
            yield "", self._render_labels(key), mean


class MetricsRegistry:
    """Name-keyed collection of metric families with one text-format
    exposition entry point (the body of ``GET /metrics``)."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def register(self, metric: Metric) -> Metric:
        cur = self._metrics.get(metric.name)
        if cur is not None:
            raise ValueError(f"metric {metric.name!r} already registered")
        self._metrics[metric.name] = metric
        return metric

    def counter(self, name, help, labelnames=()) -> Counter:
        return self.register(Counter(name, help, labelnames))

    def gauge(self, name, help, labelnames=()) -> Gauge:
        return self.register(Gauge(name, help, labelnames))

    def histogram(self, name, help, labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help, labelnames, buckets))

    def rolling(self, name, help, labelnames=(),
                window: int = 256) -> Rolling:
        return self.register(Rolling(name, help, labelnames, window))

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def expose(self) -> str:
        lines: List[str] = []
        for metric in self._metrics.values():
            lines.extend(metric.expose())
        return "\n".join(lines) + "\n"
