"""Asyncio serving gateway: HTTP/SSE ingress over ServingSession.

The gateway is the repo's network front-end (ROADMAP: "a network
front-end with backpressure and live observability"): an asyncio HTTP
server streaming tokens over SSE, a bounded-ingress middleware stack,
a Prometheus-style metrics registry fed at run boundaries, and the
audited wall-clock <-> session-clock bridge that lets the same server
run over the virtual-time sim backend (paced by ``time_scale``) or the
JAX engine (real run latencies).

Kept as an explicit subpackage import (``repro.serving.gateway``) so
importing ``repro.serving`` alone stays asyncio-free.
"""
from .app import GatewayApp
from .bridge import GatewayRequest, SessionDriver
from .middleware import (FATE_STATUS, Backpressure, TimeoutBudget,
                         status_for_state)
from .prom import (Counter, Gauge, Histogram, MetricsRegistry, Rolling,
                   DEFAULT_BUCKETS)
from .sanitizer import LoopStallSanitizer, LoopStallStats
from .telemetry import AccessLog, GatewayMetrics, request_id

__all__ = [
    "GatewayApp", "GatewayRequest", "SessionDriver",
    "FATE_STATUS", "Backpressure", "TimeoutBudget", "status_for_state",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Rolling",
    "DEFAULT_BUCKETS", "AccessLog", "GatewayMetrics", "request_id",
    "LoopStallSanitizer", "LoopStallStats",
]
