"""Inference query traffic generation (paper §V).

Poisson arrivals per the MLPerf cloud-inference methodology; rate buckets
low/medium/high = 0-256 / 256-500 / 500+ queries/sec. Also supports a
bursty MMPP-style generator (beyond-paper robustness studies) and
multi-model traces for the co-location experiment (§VI-C):
:func:`poisson_mixture` superposes per-model Poisson processes with
**independent, name-keyed RNG streams** — registering an extra model (or
reordering the mixture) never perturbs another model's sampled arrivals
or lengths — and tags each request with its registry ``model`` name so
``ServingSession.submit`` routes it without an explicit argument.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.request import Request, SLAClass
from .workload import Workload


@dataclass
class Trace:
    """Arrival-sorted list of requests (each optionally ``model``-tagged)."""
    requests: List[Request]
    duration: float

    def __len__(self):
        return len(self.requests)

    @property
    def models(self) -> Tuple[str, ...]:
        """Distinct model tags present, sorted (empty for untagged traces)."""
        return tuple(sorted({r.model for r in self.requests
                             if r.model is not None}))

    def fresh(self) -> "Trace":
        """Unexecuted copy — required when replaying one trace across
        several policies (request state is mutated by a run)."""
        return Trace([r.clone() for r in self.requests], self.duration)


def poisson_trace(wl: Workload, rate: float, duration: float,
                  seed: int = 0, model: Optional[str] = None) -> Trace:
    rng = np.random.default_rng(seed)
    t, reqs = 0.0, []
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= duration:
            break
        req = wl.sample_request(rng, t)
        req.model = model
        reqs.append(req)
    return Trace(reqs, duration)


def _stream_key(name: str) -> int:
    """Stable per-model RNG stream key (CRC32 of the model name — NOT
    ``hash()``, which is salted per process)."""
    return zlib.crc32(name.encode("utf-8"))


def poisson_mixture(models: Sequence[Tuple[str, Workload, float]],
                    duration: float, seed: int = 0) -> Trace:
    """Superposition of per-model Poisson processes for multi-tenant
    serving: ``models`` is a sequence of ``(name, workload, rate)``
    triples; each request is tagged with its model ``name``.

    Each model draws from its own RNG stream seeded by ``(seed,
    crc32(name))``, so a model's arrivals and sampled prompt/decode
    lengths are a pure function of (seed, name, rate, duration) — adding,
    removing, or reordering other mixture components cannot perturb them
    (determinism across experiment grids). Ties in arrival time keep the
    mixture's listing order (stable sort)."""
    names = [name for name, _, _ in models]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate model names in mixture: {names}")
    reqs: List[Request] = []
    for name, wl, rate in models:
        if rate <= 0:
            raise ValueError(
                f"model {name!r} has non-positive rate {rate}")
        rng = np.random.default_rng([seed, _stream_key(name)])
        t = 0.0
        while True:
            t += rng.exponential(1.0 / rate)
            if t >= duration:
                break
            req = wl.sample_request(rng, t)
            req.model = name
            reqs.append(req)
    reqs.sort(key=lambda r: r.arrival)
    return Trace(reqs, duration)


def bursty_trace(wl: Workload, rate_low: float, rate_high: float,
                 switch_period: float, duration: float, seed: int = 0) -> Trace:
    """Two-state MMPP: alternates between low/high Poisson rates."""
    rng = np.random.default_rng(seed)
    t, reqs, high = 0.0, [], False
    next_switch = switch_period
    while t < duration:
        rate = rate_high if high else rate_low
        t += rng.exponential(1.0 / rate)
        if t >= next_switch:
            high = not high
            next_switch += switch_period
        if t < duration:
            reqs.append(wl.sample_request(rng, t))
    return Trace(reqs, duration)


def colocated_trace(workloads: Sequence[Workload], rates: Sequence[float],
                    duration: float, seed: int = 0) -> Trace:
    """Superposition of per-model Poisson processes (co-location, §VI-C)."""
    reqs: List[Request] = []
    for i, (wl, rate) in enumerate(zip(workloads, rates)):
        reqs.extend(poisson_trace(wl, rate, duration, seed=seed + i).requests)
    reqs.sort(key=lambda r: r.arrival)
    return Trace(reqs, duration)


def with_sla_classes(trace: Trace, classes: Sequence[SLAClass],
                     probs: Optional[Sequence[float]] = None,
                     seed: int = 0) -> Trace:
    """Assign per-request SLA classes i.i.d. across a trace (mixed-tier
    serving): each request draws one of ``classes`` with the given
    probabilities (uniform when omitted). Mutates and returns ``trace``;
    ``Trace.fresh()`` clones preserve the assignment."""
    rng = np.random.default_rng(seed)
    p = None if probs is None else list(probs)
    idx = rng.choice(len(classes), size=len(trace.requests), p=p)
    for r, i in zip(trace.requests, idx):
        r.sla = classes[int(i)]
    return trace
