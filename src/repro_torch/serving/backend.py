"""The one model-keyed Backend contract every execution substrate implements.

A *backend* is what a :class:`~repro.serving.session.ServingSession` (and
therefore the ``InferenceServer`` wrapper) drives: something that can
execute committed node runs for a sub-batch of a named **model** and
report latency on its own clock —

  * ``SimExecutor`` (``server.py``) — the analytical NPU latency model;
    latency is *virtual* time (the paper's methodology). It reads each
    request's own workload, so ONE instance serves every registered model,
  * ``JaxEngine`` (``engine.py``) — real jitted dispatches on a reduced
    model; latency is *wall-clock* time measured at run boundaries. One
    engine holds one model's parameters and KV arena, so multi-tenant
    sessions put one engine per model behind a :class:`MultiBackend`.

Every method takes the registry model name first (``prepare(model, req,
...)``, ``execute_run(model, sb, run)``): the session always says *which*
model's work this is, single-model backends are free to ignore the key,
and :class:`MultiBackend` routes on it. The session never branches on
which backend it holds: admission, clock advancement, handle lifecycle,
and metrics are identical — only the meaning of a second differs. All
backends behind one session share one **device-time clock**: whichever
backend executes a run, its latency advances the same ``session.now``, so
co-located models contend for device time exactly as on one accelerator.

Beyond execution, the contract covers the two things an online front-end
needs that the offline trace loop did not:

  * ``prepare(model, req, rng, prompt_tokens=...)`` — per-request setup at
    submit time (the JAX engine registers/samples the prompt here; the
    simulator needs nothing),
  * ``token_count(model, req)`` / ``tokens(model, req)`` — response-
    progress observability at run boundaries, driving TTFT/TPOT metrics
    and the ``on_token`` streaming callbacks. The base implementation
    derives a *virtual* token count from request progress (one token per
    completed decode cycle; a static graph's single response counts as one
    token on completion), which is exactly right for the simulator; the
    JAX engine overrides both with its actually sampled token ids.

``Executor`` — the pre-session name of this contract — is retired;
accessing ``repro.serving.server.Executor`` still resolves to ``Backend``
behind a ``DeprecationWarning``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.request import Request, SubBatch


class BackendError(RuntimeError):
    """A backend dispatch fault with *defined* session semantics.

    Raised by ``execute``/``execute_run`` when a dispatch cannot complete.
    The session's failure model (see ``ServingSession``) treats it as a
    whole-run loss: every member's device-side progress (KV rows, slot)
    is discarded via :meth:`Backend.reset_request` and — when
    ``retryable`` — the requests are requeued with capped exponential
    backoff to replay prefill from node 0; retries exhausted (or
    ``retryable=False``) turns them terminal ``FAILED``, an SLA
    violation. ``latency`` is the device time burned before the fault
    was detected — charged to the session clock so faults are not free.

    Subclasses ``RuntimeError`` deliberately: code predating the failure
    model that catches RuntimeError keeps working unchanged.
    """

    def __init__(self, message: str, *, latency: float = 0.0,
                 retryable: bool = True):
        super().__init__(message)
        self.latency = float(latency)
        self.retryable = retryable


class TransientBackendError(BackendError):
    """A fault expected to clear on retry (flaky dispatch, preempted
    device, dropped interconnect message)."""


class BackendOOMError(BackendError):
    """Slot-allocation failure under memory pressure: the KV arena is at
    its cap with every slot held. Retryable — residency drains as live
    requests complete, so a backed-off replay can succeed."""


@dataclass
class MemoryStats:
    """One backend memory pool's accounting snapshot.

    A *slot* is the unit of KV-cache residency (one concurrently served
    request). ``slots_total`` is the pool's CURRENT capacity (a paged
    arena grows and shrinks it), ``max_slots`` the configured hard cap
    (``None`` = unbounded — memory-aware admission disengages). ``pool``
    identifies the owning device pool (``id()`` of the arena holder):
    models whose stats report the same pool contend for the same slots,
    which is how the session tells one shared simulated device apart from
    per-model engines with disjoint arenas behind a ``MultiBackend``.

    When queried for a specific model (``memory_stats(model=...)``),
    ``slots_live``/``bytes_resident_model`` are that model's share while
    the capacity fields stay pool-wide.
    """
    slots_total: int = 0
    slots_live: int = 0
    slots_free: int = 0
    bytes_resident: int = 0          # pool-wide resident KV bytes
    bytes_per_slot: float = 0.0
    max_slots: Optional[int] = None  # None = unbounded (no admission cap)
    pool: int = 0                    # identity of the owning device pool

    @property
    def bounded(self) -> bool:
        return self.max_slots is not None


@dataclass
class SanitizerStats:
    """Runtime hot-path sanitizer counters (the dynamic half of reprolint).

    The static checkers (``repro.analysis``) prove the *code* contains no
    stray sync or retrace constructs; these counters prove the *execution*
    honored the contract: ``host_syncs`` counts run-boundary host
    synchronization events (one per committed run epilogue — readback of
    the head tokens plus the arena fence count as ONE logical sync, since
    they happen at one boundary), ``retraces`` counts actual jit traces
    (a Python-side effect inside each jitted body runs only while JAX is
    tracing, so this is exact — warmup compiles show up here, and a
    steady-state phase must add zero). ``runs`` mirrors the engine's
    committed-run counter so callers can assert ``syncs_delta <=
    runs_delta`` over any window. Backends with no device state report
    all-zero stats (the simulator never syncs or traces anything).
    """
    runs: int = 0
    host_syncs: int = 0          # run-boundary sync events (<= runs)
    retraces: int = 0            # jit traces = XLA compiles triggered
    max_syncs_per_run: int = 0   # worst single run (contract: <= 1)

    @property
    def ok(self) -> bool:
        return self.max_syncs_per_run <= 1


class Backend:
    def prepare(self, model: str, req: Request, rng,
                prompt_tokens=None) -> None:
        """Per-request setup at submission time (before the request can be
        scheduled). Real engines allocate/register request state here —
        e.g. the JAX engine stores the prompt (``prompt_tokens``, or a
        random one sampled from ``rng`` at the request's ``prompt_len``).
        The analytic simulator keeps no per-request state — default no-op."""

    def execute(self, model: str, sb: SubBatch, node_id: str) -> float:
        """Execute one node for a sub-batch; returns latency in seconds."""
        raise NotImplementedError

    def execute_run(self, model: str, sb: SubBatch,
                    node_ids: Sequence[str]) -> Tuple[float, Optional[List[float]]]:
        """Execute a committed run of consecutive nodes for one sub-batch.

        Returns ``(total_latency, per_node_latencies)``. Backends that
        fuse the run into fewer device dispatches than nodes return
        ``(total, None)`` — per-node latency is unobservable inside a fused
        dispatch, and the server clock only needs run latency (sync points
        live at scheduler-visible run boundaries). The default loops
        :meth:`execute` per node, the degenerate single-dispatch-per-node
        behavior.
        """
        lats = [self.execute(model, sb, nid) for nid in node_ids]
        return sum(lats), lats

    def on_finished(self, model: str, reqs: Sequence[Request]) -> None:
        """Completion hook: the session calls this with every request that
        finished at the last run boundary, so stateful backends can
        release per-request *device* resources (e.g. KV-cache arena
        slots). Host-side results (generated tokens) must survive it —
        they stay readable until :meth:`release_request`. The analytic
        simulator keeps no per-request state — default no-op."""

    def reset_request(self, model: str, req: Request) -> None:
        """Discard ``req``'s *device-side* progress after a fault so the
        request can re-execute from node 0 (prefill replay): release its
        KV slot back to the pool idempotently and reset any per-request
        execution state to its freshly-prepared form — the prompt (and
        host-side tokens already streamed) must survive, a retry
        regenerates the rest bit-exactly. Stateless backends need
        nothing — default no-op."""

    def release_request(self, model: str, req: Request) -> None:
        """Forget ``req`` entirely (``ServingSession.release``): drop any
        remaining host-side state, e.g. the JAX engine's per-request
        prompt/token record. Long-lived online sessions call this per
        completed request; offline trace replays never do, so results
        remain inspectable after a drained run. Default no-op."""

    def token_count(self, model: str, req: Request) -> int:
        """Response tokens produced so far for ``req`` (consulted at run
        boundaries). Default: derived from request progress — one token
        per completed decode cycle, or one token at completion for static
        (single-response) graphs."""
        return req.n_tokens

    def tokens(self, model: str, req: Request) -> Optional[Sequence[int]]:
        """Actual sampled token ids for ``req`` (prefix of length
        :meth:`token_count`), or ``None`` when the backend has no real
        tokens (the simulator) — streaming then reports placeholder ids."""
        return None

    def memory_stats(self, model: Optional[str] = None) -> MemoryStats:
        """Device-memory accounting for this backend's KV pool (pool-wide,
        or one model's share when ``model`` is given). The default is an
        empty, unbounded pool — backends with no device state (or no
        accounting) never constrain memory-aware admission."""
        return MemoryStats(pool=id(self))

    def sanitizer_stats(self, model: Optional[str] = None) -> SanitizerStats:
        """Hot-path sanitizer counters (sync/retrace accounting). The
        default is all-zero: a backend with no device dispatches never
        syncs or retraces, which trivially satisfies the contract."""
        return SanitizerStats()


class MultiBackend(Backend):
    """Model-keyed mux over per-model backends.

    ``MultiBackend({"llama": JaxEngine(cfg_a), "mamba": JaxEngine(cfg_b)})``
    routes every contract call to the named model's backend, passing the
    model key through (inner backends may themselves be shared across
    keys — e.g. one stateless ``SimExecutor`` registered under several
    names). The mux is what makes per-model engines look like ONE device
    to the session: all inner latencies accumulate on the session's single
    device-time clock (each model's share of it is tracked by the session
    in ``ServerLog.busy_by_model``).
    """

    def __init__(self, backends: Dict[str, Backend]):
        if not backends:
            raise ValueError("MultiBackend needs at least one backend")
        self.backends = dict(backends)

    def backend_for(self, model: str) -> Backend:
        try:
            return self.backends[model]
        except KeyError:
            raise KeyError(
                f"no backend for model {model!r} "
                f"(have: {sorted(self.backends)})") from None

    # ------------------------------------------------------------------
    def prepare(self, model, req, rng, prompt_tokens=None):
        self.backend_for(model).prepare(model, req, rng,
                                        prompt_tokens=prompt_tokens)

    def execute(self, model, sb, node_id):
        return self.backend_for(model).execute(model, sb, node_id)

    def execute_run(self, model, sb, node_ids):
        return self.backend_for(model).execute_run(model, sb, node_ids)

    def on_finished(self, model, reqs):
        self.backend_for(model).on_finished(model, reqs)

    def reset_request(self, model, req):
        self.backend_for(model).reset_request(model, req)

    def release_request(self, model, req):
        self.backend_for(model).release_request(model, req)

    def token_count(self, model, req):
        return self.backend_for(model).token_count(model, req)

    def tokens(self, model, req):
        return self.backend_for(model).tokens(model, req)

    def memory_stats(self, model=None):
        """Route to the named model's backend; with no model, aggregate
        across the DISTINCT inner backends (shared instances counted
        once). The aggregate is a reporting view — admission gating
        always queries per model, where the ``pool`` id is meaningful."""
        if model is not None:
            return self.backend_for(model).memory_stats(model)
        seen: Dict[int, MemoryStats] = {}
        for name, be in self.backends.items():
            if id(be) not in seen:
                seen[id(be)] = be.memory_stats()
        agg = MemoryStats(pool=id(self))
        caps: List[Optional[int]] = []
        for st in seen.values():
            agg.slots_total += st.slots_total
            agg.slots_live += st.slots_live
            agg.slots_free += st.slots_free
            agg.bytes_resident += st.bytes_resident
            caps.append(st.max_slots)
        if caps and all(c is not None for c in caps):
            agg.max_slots = sum(caps)
        if agg.slots_total:
            agg.bytes_per_slot = agg.bytes_resident / agg.slots_total
        return agg

    def sanitizer_stats(self, model=None):
        """Route to the named model's backend; with no model, sum the
        counters across DISTINCT inner backends (shared instances counted
        once) — ``max_syncs_per_run`` takes the worst inner value, so the
        aggregate ``ok`` property holds iff every engine's does."""
        if model is not None:
            return self.backend_for(model).sanitizer_stats(model)
        seen: Dict[int, SanitizerStats] = {}
        for be in self.backends.values():
            if id(be) not in seen:
                seen[id(be)] = be.sanitizer_stats()
        agg = SanitizerStats()
        for st in seen.values():
            agg.runs += st.runs
            agg.host_syncs += st.host_syncs
            agg.retraces += st.retraces
            agg.max_syncs_per_run = max(agg.max_syncs_per_run,
                                        st.max_syncs_per_run)
        return agg


@dataclass
class NodeLat:
    """Per-node-id (or per-fused-run-span) latency accumulator."""
    count: int = 0
    total: float = 0.0

    @property
    def mean(self) -> float:
        return self.total / max(1, self.count)


@dataclass
class ServerLog:
    nodes_executed: int = 0
    runs_executed: int = 0
    busy_time: float = 0.0
    batch_size_sum: int = 0
    # backend faults the session absorbed (BackendError from execute_run:
    # injected or real); the faulted dispatch's detection latency is in
    # busy_time but its nodes are NOT in nodes_executed — nothing ran
    faults: int = 0
    # per-node-id latency breakdown; fused runs (no per-node observability)
    # are keyed by their span, e.g. "D0..head" — making run-fusion wins
    # visible per phase next to the per-node entries. Multi-model sessions
    # prefix keys with the model name ("llama:D0..head").
    node_lat: Dict[str, NodeLat] = field(default_factory=dict)
    # per-model share of the (single) device-time clock
    busy_by_model: Dict[str, float] = field(default_factory=dict)

    def record(self, key: str, latency: float, n: int = 1):
        ent = self.node_lat.setdefault(key, NodeLat())
        ent.count += n
        ent.total += latency

    @property
    def avg_batch_size(self) -> float:
        return self.batch_size_sum / max(1, self.nodes_executed)

    @property
    def avg_run_length(self) -> float:
        return self.nodes_executed / max(1, self.runs_executed)


def run_label(node_ids: Sequence[str]) -> str:
    return (node_ids[0] if len(node_ids) == 1
            else f"{node_ids[0]}..{node_ids[-1]}")
