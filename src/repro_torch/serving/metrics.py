"""Serving metrics: latency distribution, throughput, SLA satisfaction.

Per-SLA-class reporting: every request carries a class name (``"default"``
when it has no :class:`~repro.core.request.SLAClass`), and a finished
session records the classes it saw (name -> deadline, ``None`` for the
default class, whose deadline is supplied at ``summary(sla=...)`` time).

Per-model reporting: requests routed through a
:class:`~repro.serving.registry.ModelRegistry` carry a model tag
(untagged requests fall back to their workload's name), and the session
records the registered models (name -> policy name) so a model with zero
finishers still appears, NaN-safe, in :meth:`ServeStats.per_model`.
Aggregate *attainment* across mixed SLA classes judges every request
against its **own** deadline (class deadline, else the supplied default).

SLA accounting judges every SUBMITTED request: a request rejected at
admission control counts as a violation of its own class deadline (the
paper's SLA-satisfaction figures count all submitted requests — without
this a policy could inflate attainment by rejecting aggressively). The
same rule covers every *dropped* disposition of the failure model —
cancelled, expired, failed (fault retries exhausted), shed — none ever
produced a response by any deadline, so cancellation/shedding can only
raise attainment by rescuing OTHER requests, never by hiding its
victims. Latency/TTFT/TPOT/throughput remain finished-only by
construction.

All aggregates are NaN-safe when a slice has no finishers. TTFT/TPOT need
``t_first_token``, which only the session front-end stamps (at the run
boundary emitting token #1) — trace replays through
``run_trace``/``InferenceServer.run`` get it for free.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..core.request import Request

_NAN = float("nan")


def _mean(xs: List[float]) -> float:
    return float(np.mean(xs)) if xs else _NAN


def _percentile(reqs: List[Request], q: float) -> float:
    if not reqs:
        return _NAN
    return float(np.percentile([r.latency() for r in reqs], q))


@dataclass
class ServeStats:
    policy: str
    duration: float
    finished: List[Request] = field(default_factory=list)
    rejected: int = 0                       # refused at admission control
    # the rejected requests themselves: SLA accounting counts every
    # SUBMITTED request (paper Fig. SLA-satisfaction), so a rejection is a
    # violation of its class deadline — a policy cannot inflate attainment
    # by rejecting aggressively
    rejected_requests: List[Request] = field(default_factory=list)
    # failure-model terminal dispositions (see serving.session): all are
    # SLA violations of their own class deadline, like rejections
    cancelled_requests: List[Request] = field(default_factory=list)
    expired_requests: List[Request] = field(default_factory=list)
    failed_requests: List[Request] = field(default_factory=list)
    shed_requests: List[Request] = field(default_factory=list)
    retried: int = 0                        # fault-retry requeue events
    # SLA classes observed at submission: name -> relative deadline
    # (None for the default class — its target arrives via summary(sla=...))
    classes: Dict[str, Optional[float]] = field(default_factory=dict)
    # registered models: name -> policy name (empty for pre-registry stats)
    models: Dict[str, str] = field(default_factory=dict)

    # ------------------------------------------------------------------
    def of_class(self, name: Optional[str] = None) -> List[Request]:
        if name is None:
            return self.finished
        return [r for r in self.finished if r.sla_name == name]

    def of_model(self, name: Optional[str] = None) -> List[Request]:
        if name is None:
            return self.finished
        return [r for r in self.finished if r.model_name == name]

    def rejected_of_class(self, name: Optional[str] = None) -> List[Request]:
        if name is None:
            return self.rejected_requests
        return [r for r in self.rejected_requests if r.sla_name == name]

    def rejected_of_model(self, name: Optional[str] = None) -> List[Request]:
        if name is None:
            return self.rejected_requests
        return [r for r in self.rejected_requests if r.model_name == name]

    @property
    def dropped_requests(self) -> List[Request]:
        """Every request removed from service without a response:
        cancelled + expired + failed + shed (rejections are reported
        separately — they never entered service at all)."""
        return (self.cancelled_requests + self.expired_requests
                + self.failed_requests + self.shed_requests)

    def dropped_of_class(self, name: Optional[str] = None) -> List[Request]:
        if name is None:
            return self.dropped_requests
        return [r for r in self.dropped_requests if r.sla_name == name]

    def dropped_of_model(self, name: Optional[str] = None) -> List[Request]:
        if name is None:
            return self.dropped_requests
        return [r for r in self.dropped_requests if r.model_name == name]

    @property
    def latencies(self) -> np.ndarray:
        return np.array([r.latency() for r in self.finished])

    @property
    def avg_latency(self) -> float:
        lat = self.latencies
        return float(lat.mean()) if len(lat) else _NAN

    def percentile(self, q: float, cls: Optional[str] = None) -> float:
        return _percentile(self.of_class(cls), q)

    @property
    def makespan(self) -> float:
        if not self.finished:
            return self.duration
        return max(r.t_finish for r in self.finished)

    @property
    def throughput(self) -> float:
        """Completed requests per second over the busy window (arrival span
        + drain) — policies that stall requests pay for the longer drain."""
        return len(self.finished) / max(self.duration, self.makespan)

    # ------------------------------------------------------------------
    def sla_violation_rate(self, sla: float,
                           cls: Optional[str] = None) -> float:
        """Fraction of SUBMITTED requests (finished + rejected + dropped)
        of the class missing ``sla``; every rejection and every dropped
        disposition (cancelled/expired/failed/shed) is a violation — it
        never produced a response by any deadline. NaN when the class saw
        no submissions at all (an all-refused class reports 1.0)."""
        reqs = self.of_class(cls)
        n_rej = (len(self.rejected_of_class(cls))
                 + len(self.dropped_of_class(cls)))
        if not reqs and not n_rej:
            return _NAN
        viol = n_rej
        if reqs:
            lat = np.array([r.latency() for r in reqs])
            viol += int((lat > sla).sum())
        return viol / (len(reqs) + n_rej)

    def sla_attainment(self, sla: float, cls: Optional[str] = None) -> float:
        v = self.sla_violation_rate(sla, cls)
        return _NAN if np.isnan(v) else 1.0 - v

    def _deadline_of(self, req: Request,
                     default_sla: Optional[float]) -> Optional[float]:
        """The deadline ``req`` is judged against: its own SLA class, else
        its class's recorded deadline, else the supplied default."""
        if req.sla is not None:
            return req.sla.deadline
        return self._class_deadline(req.sla_name, default_sla)

    def attainment(self, sla: Optional[float] = None,
                   model: Optional[str] = None) -> float:
        """Aggregate SLA attainment with per-request deadlines: the
        fraction of SUBMITTED requests (finished **and rejected** — the
        paper's SLA-satisfaction counts everything submitted) meeting
        their *own* class deadline (``sla`` supplies the default
        class's). Mixed-tier and multi-model runs are judged fairly — a
        request is never held to another tier's target; every rejection
        with a deadline counts as a miss. NaN when no submission has a
        deadline."""
        judged = [(r.latency() <= d)
                  for r in self.of_model(model)
                  for d in [self._deadline_of(r, sla)] if d is not None]
        judged += [False
                   for r in (self.rejected_of_model(model)
                             + self.dropped_of_model(model))
                   if self._deadline_of(r, sla) is not None]
        return _mean([float(ok) for ok in judged])

    def ttft(self, cls: Optional[str] = None) -> float:
        """Mean time-to-first-token (seconds from arrival; session-stamped)."""
        return _mean([r.t_first_token - r.arrival for r in self.of_class(cls)
                      if r.t_first_token is not None])

    def tpot(self, cls: Optional[str] = None) -> float:
        """Mean time-per-output-token over the decode phase (first token ->
        finish, across the remaining n_tokens - 1 tokens)."""
        return _mean([(r.t_finish - r.t_first_token) / (r.n_tokens - 1)
                      for r in self.of_class(cls)
                      if r.t_first_token is not None and r.n_tokens >= 2])

    def _class_deadline(self, name: str,
                        default_sla: Optional[float]) -> Optional[float]:
        d = self.classes.get(name)
        return default_sla if d is None else d

    def per_class(self, sla: Optional[float] = None
                  ) -> Dict[str, Dict[str, float]]:
        """Per-SLA-class breakdown: completion count, attainment/violation
        against the class's own deadline, p50/p99, TTFT, TPOT. ``sla``
        supplies the default class's deadline. NaN-safe throughout."""
        names = (set(self.classes) | {r.sla_name for r in self.finished}
                 | {r.sla_name for r in self.rejected_requests}
                 | {r.sla_name for r in self.dropped_requests})
        out: Dict[str, Dict[str, float]] = {}
        for name in sorted(names):
            deadline = self._class_deadline(name, sla)
            viol = (self.sla_violation_rate(deadline, name)
                    if deadline is not None else _NAN)
            out[name] = {
                "completed": len(self.of_class(name)),
                "rejected": len(self.rejected_of_class(name)),
                "cancelled": len([r for r in self.cancelled_requests
                                  if r.sla_name == name]),
                "expired": len([r for r in self.expired_requests
                                if r.sla_name == name]),
                "failed": len([r for r in self.failed_requests
                               if r.sla_name == name]),
                "shed": len([r for r in self.shed_requests
                             if r.sla_name == name]),
                "deadline_ms": (deadline * 1e3 if deadline is not None
                                else _NAN),
                "sla_violation_rate": viol,
                "sla_attainment": (_NAN if np.isnan(viol) else 1.0 - viol),
                "p50_ms": self.percentile(50, name) * 1e3,
                "p95_ms": self.percentile(95, name) * 1e3,
                "p99_ms": self.percentile(99, name) * 1e3,
                "ttft_ms": self.ttft(name) * 1e3,
                "tpot_ms": self.tpot(name) * 1e3,
            }
        return out

    def per_model(self, sla: Optional[float] = None
                  ) -> Dict[str, Dict[str, float]]:
        """Per-model breakdown across the registry: completion count,
        attainment against each request's *own* SLA-class deadline
        (``sla`` = default class target), p50/p99 latency, TTFT, TPOT.
        Registered models with no finishers appear with NaN rows."""
        names = (set(self.models) | {r.model_name for r in self.finished}
                 | {r.model_name for r in self.rejected_requests}
                 | {r.model_name for r in self.dropped_requests})
        out: Dict[str, Dict[str, float]] = {}
        for name in sorted(names):
            reqs = self.of_model(name)
            att = self.attainment(sla, model=name)
            out[name] = {
                "completed": len(reqs),
                "rejected": len(self.rejected_of_model(name)),
                "cancelled": len([r for r in self.cancelled_requests
                                  if r.model_name == name]),
                "expired": len([r for r in self.expired_requests
                                if r.model_name == name]),
                "failed": len([r for r in self.failed_requests
                               if r.model_name == name]),
                "shed": len([r for r in self.shed_requests
                             if r.model_name == name]),
                "sla_attainment": att,
                "sla_violation_rate": (_NAN if np.isnan(att) else 1.0 - att),
                "p50_ms": _percentile(reqs, 50) * 1e3,
                "p95_ms": _percentile(reqs, 95) * 1e3,
                "p99_ms": _percentile(reqs, 99) * 1e3,
                "ttft_ms": _mean([r.t_first_token - r.arrival for r in reqs
                                  if r.t_first_token is not None]) * 1e3,
                "tpot_ms": _mean(
                    [(r.t_finish - r.t_first_token) / (r.n_tokens - 1)
                     for r in reqs
                     if r.t_first_token is not None and r.n_tokens >= 2])
                    * 1e3,
            }
        return out

    # ------------------------------------------------------------------
    def summary(self, sla: Optional[float] = None) -> Dict[str, float]:
        out = {
            "policy": self.policy,
            "completed": len(self.finished),
            "avg_latency_ms": self.avg_latency * 1e3,
            "p25_ms": self.percentile(25) * 1e3,
            "p50_ms": self.percentile(50) * 1e3,
            "p75_ms": self.percentile(75) * 1e3,
            "p95_ms": self.percentile(95) * 1e3,
            "p99_ms": self.percentile(99) * 1e3,
            "throughput_rps": self.throughput,
        }
        if self.rejected:
            out["rejected"] = self.rejected
        # failure-model dispositions only appear when they happened, so a
        # fault-free run's summary dict is byte-identical to before
        for key, reqs in (("cancelled", self.cancelled_requests),
                          ("expired", self.expired_requests),
                          ("failed", self.failed_requests),
                          ("shed", self.shed_requests)):
            if reqs:
                out[key] = len(reqs)
        if self.retried:
            out["retried"] = self.retried
        if sla is not None:
            out["sla_violation_rate"] = self.sla_violation_rate(sla)
        # per-class violation rates (only meaningful keys: a class needs a
        # deadline from its SLAClass or the summary's sla argument)
        for name, row in self.per_class(sla).items():
            if name == "default" and len(self.classes) <= 1:
                continue                         # single-tier: no breakdown
            if not np.isnan(row["deadline_ms"]):
                out[f"sla_viol[{name}]"] = row["sla_violation_rate"]
        # per-model breakdown only for genuinely multi-tenant runs
        if len(self.models) > 1 or len({r.model_name
                                        for r in self.finished}) > 1:
            for name, row in self.per_model(sla).items():
                out[f"sla_viol[model:{name}]"] = row["sla_violation_rate"]
                out[f"p99_ms[model:{name}]"] = row["p99_ms"]
        return out
