"""Gateway observability: the concrete metric set and structured logs.

:class:`GatewayMetrics` owns every metric family the gateway exports
and the three feed points that keep them current:

  * ``on_run_boundary(session, model, done)`` — wired into
    ``ServingSession.on_run_boundary`` by the driver, so the registry is
    fed at every scheduling run boundary (queue depth, arena residency,
    the session's monotone run/fault/retry counters),
  * ``observe_outcome(...)`` — one terminal request outcome (driver
    finalization): per-model/per-class attainment over a rolling
    window, latency/TTFT histograms, rolling TTFT/TPOT means,
  * ``observe_http(...)`` — one completed HTTP exchange (access-log
    moment): request counts by model/class/status, streamed-token and
    backpressure counters.

``sample(session)`` refreshes the point-in-time gauges right before a
``/metrics`` scrape (and adds injected-fault counts when the backend is
a ``FaultInjectingBackend`` — duck-typed via ``fault_stats`` so the
gateway works over any backend stack).

:class:`AccessLog` writes one JSON object per line (machine-parseable,
one event per HTTP exchange plus lifecycle events like ``ready`` /
``drain``); ``request_id()`` tags each exchange with a process-unique
id that appears in the access log and the ``X-Request-Id`` response
header.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
from typing import Dict, List, Optional

from .prom import DEFAULT_BUCKETS, MetricsRegistry

_req_seq = itertools.count(1)
_RID_PREFIX = f"{os.getpid():08x}"


def request_id() -> str:
    """Process-unique request id: pid-prefixed monotone counter (cheap,
    collision-free within one gateway, and greppable across its logs)."""
    return f"{_RID_PREFIX}-{next(_req_seq):08x}"


class AccessLog:
    """Structured JSON-lines log. Each record is one event object; the
    gateway emits ``http`` records per exchange (request id, method,
    path, status, model, class, fate, token/latency figures) and
    lifecycle records (``ready``, ``metrics``, ``drain``)."""

    def __init__(self, stream=None, enabled: bool = True):
        self.stream = stream if stream is not None else sys.stderr
        self.enabled = enabled
        self.records: List[dict] = []       # in-memory tail for tests
        self.keep = 1000

    def emit(self, event: str, **fields):
        record = {"event": event, **fields}
        self.records.append(record)
        if len(self.records) > self.keep:
            del self.records[:len(self.records) - self.keep]
        if self.enabled:
            print(json.dumps(record, sort_keys=True), file=self.stream,
                  flush=True)
        return record


class GatewayMetrics:
    """Every metric family the gateway exposes, with typed feed points.

    Durations are in seconds on the session clock; ``deadline_by_class``
    maps SLA class name -> relative deadline for attainment judging
    (``default_sla`` covers the default class).
    """

    def __init__(self, *, default_sla: Optional[float] = None,
                 deadline_by_class: Optional[Dict[str, float]] = None,
                 window: int = 256,
                 buckets=DEFAULT_BUCKETS):
        self.default_sla = default_sla
        self.deadlines = dict(deadline_by_class or {})
        reg = self.registry = MetricsRegistry()
        self.requests = reg.counter(
            "gateway_requests_total",
            "completed HTTP exchanges by model, SLA class and status",
            ("model", "sla_class", "status"))
        self.backpressure = reg.counter(
            "gateway_backpressure_total",
            "requests refused with 429 at the bounded ingress",
            ("model",))
        self.tokens = reg.counter(
            "gateway_tokens_streamed_total",
            "SSE tokens streamed to clients", ("model",))
        self.outcomes = reg.counter(
            "gateway_outcomes_total",
            "terminal request fates as seen by the session",
            ("model", "fate"))
        self.latency = reg.histogram(
            "gateway_request_latency_seconds",
            "arrival-to-completion latency (session clock)",
            ("model",), buckets)
        self.ttft = reg.histogram(
            "gateway_ttft_seconds",
            "arrival-to-first-token latency (session clock)",
            ("model",), buckets)
        self.attainment = reg.rolling(
            "gateway_attainment",
            "rolling SLA attainment over recent terminal outcomes",
            ("model", "sla_class"), window)
        self.rolling_ttft = reg.rolling(
            "gateway_ttft_seconds_rolling",
            "rolling mean TTFT over recent completions (session clock)",
            ("model",), window)
        self.rolling_tpot = reg.rolling(
            "gateway_tpot_seconds_rolling",
            "rolling mean time-per-output-token over recent completions",
            ("model",), window)
        self.queue_depth = reg.gauge(
            "gateway_queue_depth",
            "requests waiting in the model policy's admission queue",
            ("model",))
        self.inflight = reg.gauge(
            "gateway_inflight",
            "live gateway requests (submitted, not yet terminal)")
        self.slots_live = reg.gauge(
            "gateway_arena_slots_live", "resident KV slots (pool-wide)")
        self.slots_total = reg.gauge(
            "gateway_arena_slots_total", "current KV pool capacity")
        self.slots_max = reg.gauge(
            "gateway_arena_slots_max",
            "configured KV pool hard cap (NaN = unbounded)")
        self.bytes_resident = reg.gauge(
            "gateway_arena_bytes_resident", "resident KV bytes (pool-wide)")
        self.runs = reg.counter(
            "gateway_session_runs_total", "committed runs executed")
        self.faults = reg.counter(
            "gateway_session_faults_total",
            "backend faults the session absorbed")
        self.retries = reg.counter(
            "gateway_session_retries_total", "fault-retry requeue events")
        self.injected = reg.counter(
            "gateway_injected_faults_total",
            "faults injected by the chaos backend",
            ("model", "kind"))
        self.loop_max_stall = reg.gauge(
            "gateway_loop_max_stall_seconds",
            "worst event-loop callback latency the stall watchdog saw")
        self.loop_lag_p99 = reg.gauge(
            "gateway_loop_lag_p99_seconds",
            "p99 event-loop wakeup lag over the watchdog's recent window")
        self.loop_stalls = reg.counter(
            "gateway_loop_stalls_total",
            "watchdog probes whose lag exceeded the stall threshold")
        self.loop_ticks = reg.counter(
            "gateway_loop_ticks_total", "stall-watchdog probes taken")

    # ------------------------------------------------------------------
    def deadline_for(self, sla_class: str) -> Optional[float]:
        if sla_class in self.deadlines:
            return self.deadlines[sla_class]
        return self.default_sla

    # ------------------------------------------------------------------
    # feed points
    # ------------------------------------------------------------------
    def on_run_boundary(self, session, model: str, done) -> None:
        """Session hook: refresh the session-derived series at a run
        boundary. ``done`` (the requests finished by this run) is unused
        here — terminal accounting runs through the driver's
        finalization, which also sees cancel/expiry/shed fates."""
        self.sample_session(session)

    def sample_session(self, session) -> None:
        for entry in session.registry.entries():
            self.queue_depth.set(len(entry.policy.queue), model=entry.name)
        mem = session.backend.memory_stats()
        self.slots_live.set(mem.slots_live)
        self.slots_total.set(mem.slots_total)
        self.slots_max.set(mem.max_slots if mem.max_slots is not None
                           else float("nan"))
        self.bytes_resident.set(mem.bytes_resident)
        self.runs.set_total(session.log.runs_executed)
        self.faults.set_total(session.log.faults)
        self.retries.set_total(session.retried)
        fault_stats = getattr(session.backend, "fault_stats", None)
        if callable(fault_stats):
            for model, kinds in fault_stats().items():
                for kind, n in kinds.items():
                    self.injected.set_total(n, model=model, kind=kind)

    def sample_loop(self, sanitizer) -> None:
        """Mirror the loop-stall watchdog's counters into the registry
        (scrape-time refresh, same idiom as ``sample_session``)."""
        if sanitizer is None:
            return
        stats = sanitizer.stats
        self.loop_max_stall.set(stats.max_lag_s)
        self.loop_lag_p99.set(stats.lag_p99_s())
        self.loop_stalls.set_total(stats.stalls)
        self.loop_ticks.set_total(stats.ticks)

    def observe_outcome(self, model: str, sla_class: str, fate: str,
                        latency_s: Optional[float],
                        ttft_s: Optional[float],
                        n_tokens: int) -> None:
        """One terminal request outcome (driver finalization)."""
        self.outcomes.inc(model=model, fate=fate)
        deadline = self.deadline_for(sla_class)
        if deadline is not None:
            ok = (fate == "done" and latency_s is not None
                  and latency_s <= deadline)
            self.attainment.observe(1.0 if ok else 0.0,
                                    model=model, sla_class=sla_class)
        if latency_s is not None:
            self.latency.observe(latency_s, model=model)
        if ttft_s is not None:
            self.ttft.observe(ttft_s, model=model)
            self.rolling_ttft.observe(ttft_s, model=model)
            if latency_s is not None and n_tokens >= 2:
                self.rolling_tpot.observe(
                    (latency_s - ttft_s) / (n_tokens - 1), model=model)

    def observe_http(self, model: str, sla_class: str, status: int,
                     n_tokens: int = 0) -> None:
        """One completed HTTP exchange (access-log moment)."""
        self.requests.inc(model=model, sla_class=sla_class,
                          status=str(status))
        if status == 429:
            self.backpressure.inc(model=model)
        if n_tokens:
            self.tokens.inc(n_tokens, model=model)

    # ------------------------------------------------------------------
    def expose(self) -> str:
        return self.registry.expose()

    def snapshot(self) -> dict:
        """Compact dict for the periodic metrics log line."""
        att = {}
        for key, dq in self.attainment._series.items():
            if dq:
                att["/".join(key)] = round(sum(dq) / len(dq), 4)
        return {
            "inflight": self.inflight.value(),
            "slots_live": self.slots_live.value(),
            "slots_total": self.slots_total.value(),
            "runs": self.runs.total(),
            "faults": self.faults.total(),
            "retries": self.retries.total(),
            "requests": self.requests.total(),
            "backpressure_429": self.backpressure.total(),
            "tokens_streamed": self.tokens.total(),
            "loop_stalls": self.loop_stalls.total(),
            "loop_max_stall_s": self.loop_max_stall.value(),
            "attainment": att,
        }
