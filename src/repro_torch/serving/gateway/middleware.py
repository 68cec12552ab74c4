"""Gateway middleware: backpressure, fate mapping, per-request timeouts.

The middleware stack sits between the HTTP layer and the
:class:`~repro.serving.session.ServingSession`:

  * **Bounded ingress / backpressure** — the gateway refuses work with
    ``429 Too Many Requests`` + ``Retry-After`` *before* submitting it,
    when either its own in-flight budget (``max_inflight``) or the
    session's queue/memory budget is exhausted. Refusing at the door is
    deliberately distinct from the session's own load shedding: a 429'd
    request never enters the scheduler (cheap, retryable by the
    client), while a SHED fate means admitted work was sacrificed
    (503). High-``shed_priority`` requests keep a reserved headroom
    above the soft bound so an interactive tier can still get in while
    bulk traffic is being turned away — the per-request
    ``shed_priority`` (defaulting to the model's registered priority)
    is honored at the door exactly like the session honors it in the
    shedder.
  * **Fate -> HTTP status** — every terminal
    :class:`~repro.serving.session.HandleState` maps to one status
    (:data:`FATE_STATUS`); mid-stream fates arrive as a final SSE
    ``error`` event instead, carrying the same status number.
  * **Per-request timeout** — a :class:`TimeoutBudget` caps the
    wall-clock an exchange may take; expiry cancels the handle
    (``handle.cancel()`` frees its KV slot immediately) and reports
    ``408`` (or a terminal SSE event when streaming already began).
"""
from __future__ import annotations

from typing import Dict, Optional

#: Terminal handle fate -> HTTP status. Distinct statuses per fate so a
#: client (and the load generator's error accounting) can tell refusal
#: modes apart without parsing bodies:
#:
#:   done      -> 200  (completed; SSE stream closed with a `done` event)
#:   rejected  -> 422  (admission control: the deadline is provably
#:                      unmeetable — retrying immediately cannot help)
#:   shed      -> 503  (load shedding sacrificed admitted work; Retry-After
#:                      is attached — capacity should recover)
#:   expired   -> 504  (deadline provably blown mid-flight; reaped)
#:   failed    -> 502  (backend fault, retry budget exhausted)
#:   cancelled -> 499  (client closed the request; never sent on the wire,
#:                      log-only — the nginx convention)
#:
#: Gateway-level refusals use 429 (bounded ingress, never submitted) and
#: 408 (per-request timeout, handle cancelled) — those are not fates.
FATE_STATUS: Dict[str, int] = {
    "done": 200,
    "rejected": 422,
    "shed": 503,
    "expired": 504,
    "failed": 502,
    "cancelled": 499,
}

#: Statuses on which a Retry-After hint is attached.
RETRYABLE_STATUSES = frozenset({429, 503})

STATUS_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout",
    413: "Payload Too Large", 422: "Unprocessable Entity",
    429: "Too Many Requests", 499: "Client Closed Request",
    500: "Internal Server Error", 502: "Bad Gateway",
    503: "Service Unavailable", 504: "Gateway Timeout",
}


def status_for_state(state) -> int:
    """HTTP status for a terminal ``HandleState`` (its ``value`` is the
    lifecycle fate string; DONE maps through ``"done"``)."""
    return FATE_STATUS[state.value]


class Backpressure:
    """Bounded-ingress admission at the gateway door.

    ``check(model, shed_priority)`` returns ``None`` to admit, or a
    ``Retry-After`` hint in wall seconds to refuse with 429. Refusal
    triggers when

      * the gateway's in-flight budget is full — ``max_inflight`` live
        exchanges (soft bound; requests at the session's *protected*
        shed priority may run ``headroom`` past it so an interactive
        tier is not starved by bulk arrivals already in the house), or
      * the session's own ingress is saturated: its bounded queue
        (``max_queue``) is at capacity, or memory-aware admission
        reports zero free-slot room for the model with a backlog
        already waiting (every new submission would join a queue the
        device cannot drain yet).

    The Retry-After hint scales with the backlog over the observed
    completion rate (the driver's rolling throughput estimate), clamped
    to ``[min_hint, max_hint]`` — a loaded gateway asks clients to back
    off longer, an idle one barely at all.
    """

    def __init__(self, driver, *, max_inflight: Optional[int] = None,
                 headroom: Optional[int] = None,
                 retry_after: float = 0.5,
                 min_hint: float = 0.05, max_hint: float = 5.0):
        self.driver = driver
        self.max_inflight = max_inflight
        self.headroom = (headroom if headroom is not None
                         else max(8, (max_inflight or 0) // 8))
        self.retry_after = retry_after
        self.min_hint = min_hint
        self.max_hint = max_hint

    # ------------------------------------------------------------------
    def _hint(self, backlog: int) -> float:
        rate = self.driver.completion_rate()
        if rate > 0.0:
            return min(self.max_hint,
                       max(self.min_hint, backlog / rate))
        return self.retry_after

    def check(self, model: str, shed_priority: int) -> Optional[float]:
        session = self.driver.session
        inflight = self.driver.inflight
        if self.max_inflight is not None:
            bound = self.max_inflight
            if shed_priority >= self.driver.protected_priority():
                bound += self.headroom
            if inflight >= bound:
                return self._hint(inflight)
        depth = sum(len(e.policy.queue)
                    for e in session.registry.entries())
        if session.max_queue is not None and depth >= session.max_queue:
            return self._hint(depth)
        if session.memory_aware and depth > 0:
            if self.driver.mem_room(model) == 0:
                return self._hint(depth)
        return None


class TimeoutBudget:
    """Wall-clock budget for one HTTP exchange. ``remaining()`` feeds
    each successive ``wait_for`` so the *total* exchange time is capped,
    not each individual event gap."""

    def __init__(self, clock, timeout_s: float):
        self._clock = clock              # wall-clock callable (loop.time)
        self.timeout_s = float(timeout_s)
        self.t0 = clock()

    def remaining(self) -> float:
        return self.timeout_s - (self._clock() - self.t0)

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0
