"""Online serving session: submit/stream front-end over the run-commit core.

The paper's premise is SLA-aware scheduling of a *live* request stream
across **co-located models sharing one NPU** (§VI-C). A
:class:`ServingSession` is that front-end: requests are submitted against
a :class:`~repro.serving.registry.ModelRegistry` of named models, each
with its *own* batching policy (and therefore its own per-graph
BatchTable and slack predictor — batching never crosses models), while a
cross-model :class:`~repro.core.arbiter.Arbiter` decides whose committed
run dispatches next on the one shared device clock:

    session = ServingSession(backend=SimExecutor(perf),
                             arbiter=LeastSlackArbiter())
    session.register("llama", wl_a, policy=LazyBatching(pred_a))
    session.register("mamba", wl_b, policy=LazyBatching(pred_b))
    h = session.submit(req, model="llama", on_token=lambda h, t: ...)
    session.run_until(t)        # incremental clock advancement
    session.step()              # ... or one scheduling step at a time
    h.state                     # QUEUED → ADMITTED → RUNNING → DONE
    session.drain()             # finish everything -> ServeStats

The single-model construction ``ServingSession(policy, backend)`` is
unchanged — it registers the policy under the ``"default"`` name and
every ``submit`` routes to it; with one registered model the arbiter is
never consulted, so results are bit-identical to the pre-registry
sessions. The scheduling core underneath is exactly the PR-2 run-commit
loop: each model's policy is consulted at every run boundary, commits a
run of consecutive node ids, the arbiter picks among the ready models,
and the backend executes the winner as one fused dispatch.

Device memory is part of admission: when the backend reports a bounded
KV pool (``memory_stats().max_slots``), the session wires each policy's
admission to the pool's free-slot budget — overflow defers in the InfQ,
per-model memory shares cap each tenant's residency, and (under
``reject_infeasible``) a request that cannot get a slot before its own
deadline is rejected at submit. See :meth:`ServingSession._mem_room`.

Handle lifecycle
----------------
``QUEUED``   — submitted, waiting in its model policy's InfQ (or in the
               session's future-arrivals queue when submitted ahead of its
               arrival time, e.g. trace replay);
``ADMITTED`` — the policy pulled it out of the InfQ into its batch state
               (``t_first_issue`` is set);
``REJECTED`` — refused at admission control (``reject_infeasible=True``
               and the request's own deadline is already unmeetable even
               if it ran alone immediately);
``RUNNING``  — a committed run containing the request has executed;
``DONE``     — finished; ``t_finish``/``latency``/``tokens`` are final.

Terminal failure/degradation states (all count as SLA violations):

``CANCELLED`` — the caller called ``handle.cancel()`` mid-flight;
``EXPIRED``   — ``cancel_expired=True`` and, at a run boundary, the
                request's deadline was provably blown (already past, or
                past even under the predictor's isolated-run bound) — it
                is evicted from its SubBatch and its KV slot freed so it
                stops stealing capacity from requests that can attain;
``FAILED``    — a backend fault (``BackendError``) consumed the request's
                retry budget (or was not retryable);
``SHED``      — dropped by graceful load shedding (bounded ingress queue
                overflow, or brownout mode protecting a higher tier).

Failure model
-------------
A ``BackendError`` from ``execute_run`` loses the whole dispatched run:
every member's device-side progress is discarded
(``Backend.reset_request`` — KV slot released idempotently, no leaks)
and, per the session's :class:`RetryPolicy`, members are requeued with
capped exponential backoff + deterministic jitter (virtual time in sim,
wall-clock in JAX — both are the one session clock) to replay prefill
from node 0. SLA accounting always judges the ORIGINAL deadline: retries
buy a response, never absolution. Eviction — cancellation, expiry,
fault requeue — never perturbs surviving batch members: they keep their
slots, caches, and (in the JAX engine) bit-exact tokens.

Streaming
---------
At every run boundary the session asks the backend how many response
tokens each just-executed request has produced (decode megasteps already
hold the sampled tokens — the JAX engine surfaces them; the simulator
reports virtual tokens, one per completed decode cycle). New tokens fire
the handle's ``on_token(handle, token)`` callback, stamp
``t_first_token`` (TTFT), and accumulate in ``handle.tokens`` — for the
JAX backend these are bit-exact the batch ``execute_run`` results.

Compatibility
-------------
``run_trace(policy, backend, trace)`` replays an offline trace through a
single-model session and returns the familiar :class:`ServeStats`;
``run_mixture(models, backend, trace)`` is its multi-tenant sibling
(requests route on their ``model`` tag); ``InferenceServer.run`` and
``run_policy`` are thin wrappers over ``run_trace``, so every
pre-existing experiment script and test runs unmodified.
"""
from __future__ import annotations

import heapq
import itertools
from enum import Enum
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dataclasses import dataclass
from collections import deque

from ..core import lifecycle
from ..core.arbiter import Arbiter, LeastSlackArbiter
from ..core.policies import Policy
from ..core.request import Request
from .backend import Backend, BackendError, ServerLog, run_label
from .metrics import ServeStats
from .registry import ModelEntry, ModelRegistry
from .traffic import Trace

DEFAULT_MODEL = "default"

#: Handle lifecycle states, DERIVED from the declarative state machine in
#: :mod:`repro.core.lifecycle` (the same table the ``handle-lattice``
#: static checker enforces): QUEUED / ADMITTED / RUNNING / DONE /
#: REJECTED / CANCELLED / EXPIRED / FAILED / SHED, with the legal edges
#: (monotone-except-retry) in ``lifecycle.EDGES``.
HandleState = Enum("HandleState",
                   {name.upper(): name for name in lifecycle.STATES})

#: request.fate value -> terminal HandleState (one entry per declared
#: lifecycle fate — the table, not this module, says what fates exist)
_FATE_STATE = {fate: HandleState(fate) for fate in lifecycle.FATES}


@dataclass(frozen=True)
class RetryPolicy:
    """Fault-retry semantics for ``BackendError`` dispatch faults.

    A transiently failed request is requeued ``max_retries`` times with
    capped exponential backoff — attempt ``k`` waits
    ``min(backoff_base * 2**(k-1), backoff_cap)`` scaled by a
    deterministic jitter draw in ``[1, 1+jitter]`` from the session's
    seeded retry stream. Exhaustion (or a non-retryable fault) turns the
    request terminal ``FAILED``. ``max_retries=0`` fails every faulted
    request immediately."""
    max_retries: int = 3
    backoff_base: float = 0.002       # seconds (session clock)
    backoff_cap: float = 0.5
    jitter: float = 0.25              # max fractional extra backoff

    def __post_init__(self):
        if self.max_retries < 0 or self.backoff_base < 0 \
                or self.backoff_cap < self.backoff_base or self.jitter < 0:
            raise ValueError(f"invalid RetryPolicy: {self}")

    def backoff(self, attempt: int, rng) -> float:
        """Backoff before retry ``attempt`` (1-based), jittered."""
        base = min(self.backoff_base * (2.0 ** (attempt - 1)),
                   self.backoff_cap)
        return base * (1.0 + self.jitter * float(rng.random()))


@dataclass(frozen=True)
class BrownoutConfig:
    """Attainment-triggered brownout: when the PROTECTED tier's rolling
    attainment (a window over its last ``window`` terminal outcomes,
    evaluated once ``min_samples`` exist) drops below ``floor``, the
    session sheds all queued + arriving work of strictly lower
    ``shed_priority`` models until attainment recovers above
    ``floor + hysteresis``. The protected tier is the highest registered
    ``shed_priority``; with a single priority level brownout never
    engages (there is nothing lower-tier to shed)."""
    floor: float = 0.9
    window: int = 64
    hysteresis: float = 0.05
    min_samples: int = 16

    def __post_init__(self):
        if not 0.0 < self.floor <= 1.0 or self.window < 1 \
                or self.hysteresis < 0 or self.min_samples < 1:
            raise ValueError(f"invalid BrownoutConfig: {self}")


class RequestHandle:
    """Caller-facing view of one submitted request's lifecycle."""

    def __init__(self, req: Request, session: "ServingSession",
                 on_token: Optional[Callable] = None,
                 model: Optional[str] = None):
        self.request = req
        self._session = session
        self.t_submit = session.now
        self.on_token = on_token
        # registry name of the entry serving this request (authoritative
        # routing key — independent of the request's reporting tag)
        self.model = model
        self.tokens: List[int] = []     # streamed response tokens so far
        self._n_tokens = 0
        self._rejected = False
        self._running = False

    @property
    def state(self) -> HandleState:
        """Derived, monotone lifecycle state (no per-step bookkeeping)."""
        if self._rejected:
            return HandleState.REJECTED
        r = self.request
        if r.fate is not None:
            return _FATE_STATE[r.fate]
        if r.done:
            return HandleState.DONE
        if self._running:
            return HandleState.RUNNING
        if r.t_first_issue is not None:
            return HandleState.ADMITTED
        return HandleState.QUEUED

    _TERMINAL = frozenset(HandleState(s) for s in lifecycle.TERMINAL)

    @property
    def done(self) -> bool:
        """Terminal: the request will never run (again) — completed,
        refused, cancelled, expired, failed, or shed."""
        return self.state in self._TERMINAL

    @property
    def retries(self) -> int:
        """Fault-retry attempts consumed so far."""
        return self.request.retries

    def cancel(self) -> bool:
        """Cancel this request mid-flight: evict it from its model's
        scheduling state (InfQ or SubBatch — surviving batch members are
        untouched) and free its KV slot immediately. Terminal state
        becomes ``CANCELLED``; tokens streamed so far stay readable.
        Returns ``False`` (no-op) when the handle is already terminal."""
        return self._session.cancel(self)

    @property
    def t_first_token(self) -> Optional[float]:
        return self.request.t_first_token

    @property
    def t_finish(self) -> Optional[float]:
        return self.request.t_finish

    @property
    def latency(self) -> Optional[float]:
        r = self.request
        return None if r.t_finish is None else r.t_finish - r.arrival

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (from arrival)."""
        r = self.request
        return (None if r.t_first_token is None
                else r.t_first_token - r.arrival)

    def __repr__(self):
        return (f"RequestHandle(rid={self.request.rid}, "
                f"state={self.state.value}, tokens={len(self.tokens)})")


class ServingSession:
    """Online serving front-end over a model registry and one backend.

    ``policy`` (positional, optional): single-model convenience — the
    policy is registered under the ``"default"`` model name, preserving
    the pre-registry ``ServingSession(policy, backend)`` construction
    bit-identically. Multi-tenant sessions omit it and call
    :meth:`register` per model instead.

    ``arbiter``: cross-model dispatch order when several registered
    models have committed runs ready (default
    :class:`~repro.core.arbiter.LeastSlackArbiter`, the paper's SLA-aware
    behavior; never consulted with a single registered model).

    ``reject_infeasible``: when a model's policy carries a slack
    predictor, refuse at submit time any request whose own deadline is
    unmeetable even running alone immediately (conservative single-input
    bound) — the handle goes straight to ``REJECTED`` instead of burning
    batch slack on a guaranteed violation. Off by default (the paper's
    system never drops work).

    ``memory_aware``: when the backend reports a bounded KV pool
    (``memory_stats().max_slots`` set — e.g. ``JaxEngine(max_slots=...)``
    or ``SimExecutor(max_slots=...)``), wire each registered policy's
    admission to the pool's free-slot budget: admission beyond free
    memory defers in the InfQ, and per-model memory shares (from
    ``register(mem_share=...)`` or the arbiter's ``mem_shares``) cap each
    tenant's resident slots. On by default — a no-op until a backend
    actually reports a cap; ``False`` restores fully memory-blind
    scheduling for A/B comparison.

    ``seed`` feeds the RNG handed to ``Backend.prepare`` (the JAX engine
    samples synthetic prompts from it when none is supplied).

    Failure & degradation knobs (all default to the pre-failure-model
    behavior bit-identically):

    ``cancel_expired``: at every run boundary, expire (terminal
    ``EXPIRED``, slot freed, batch survivors untouched) any request whose
    deadline is provably blown — already past, or unreachable even under
    the predictor's conservative isolated-run bound
    (``single_remaining``). Off by default (the paper's system never
    drops work).

    ``retry``: the :class:`RetryPolicy` that ARMS the failure model —
    when set, a ``BackendError`` from a dispatch is absorbed: retryable
    faults requeue with capped exponential backoff and deterministic
    jitter, everything else (and budget exhaustion) goes terminal
    ``FAILED``. ``None`` (the default) leaves the failure model off:
    backend errors propagate to the caller exactly as before — an
    engine's own "arena exhausted / memory cap" errors stay loud unless
    the caller opted into fault handling.

    ``max_queue``: bounded ingress queue — when the total InfQ backlog
    (across models) is at the bound, an arriving request triggers
    deadline-aware shedding: the least valuable of (backlog + newcomer)
    — lowest ``shed_priority`` tier first, loosest absolute deadline
    within a tier — goes terminal ``SHED``. ``None`` = unbounded.

    ``brownout``: a :class:`BrownoutConfig` enabling attainment-triggered
    tier shedding via ``register(..., shed_priority=...)``.
    """

    def __init__(self, policy: Optional[Policy] = None,
                 backend: Optional[Backend] = None, *,
                 arbiter: Optional[Arbiter] = None, seed: int = 0,
                 reject_infeasible: bool = False,
                 memory_aware: bool = True,
                 cancel_expired: bool = False,
                 retry: Optional[RetryPolicy] = None,
                 max_queue: Optional[int] = None,
                 brownout: Optional[BrownoutConfig] = None,
                 log: Optional[ServerLog] = None):
        if backend is None:
            raise ValueError(
                "ServingSession requires a backend — pass SimExecutor(...) "
                "or a JaxEngine-backed MultiBackend")
        self.registry = ModelRegistry()
        self.backend = backend
        self.arbiter = arbiter if arbiter is not None else LeastSlackArbiter()
        self.log = log if log is not None else ServerLog()
        self.now = 0.0
        self.duration: Optional[float] = None    # reporting window override
        self.reject_infeasible = reject_infeasible
        self.memory_aware = memory_aware
        self.cancel_expired = cancel_expired
        self.retry = retry          # None = failure model off (errors raise)
        self.max_queue = max_queue
        self.brownout = brownout
        self.handles: Dict[int, RequestHandle] = {}
        self._finished: Dict[int, Request] = {}   # rid-keyed: O(1) release
        self._rejected: Dict[int, Request] = {}
        # terminal failure/degradation dispositions, keyed like _finished:
        # one bucket per fate the lifecycle table declares
        self._disposed: Dict[str, Dict[int, Request]] = {
            fate: {} for fate in lifecycle.FATES}
        self.retried = 0                 # fault-retry requeue events
        self.brownouts = 0               # brownout activations
        self._brownout_active = False
        self._attain_window: deque = deque(
            maxlen=brownout.window if brownout is not None else 1)
        self._rng = np.random.default_rng(seed)
        # separate stream for retry jitter: backoff draws must never
        # perturb prompt sampling (survivors stay bit-exact vs fault-free)
        self._retry_rng = np.random.default_rng([seed, 0x5EED])
        self._arrivals: list = []        # heap of (t, rid, seq, req, entry)
        self._seq = itertools.count()
        self._classes: Dict[str, Optional[float]] = {}
        # observer hook, fired after each executed run (and after fault
        # handling): on_run_boundary(session, model_name, done_requests).
        # The serving gateway wires its metrics registry here so queue
        # depth / arena residency / run counters are sampled at every
        # scheduling boundary without polling.
        self.on_run_boundary: Optional[Callable] = None
        if policy is not None:
            self.register(DEFAULT_MODEL, policy=policy)

    # ------------------------------------------------------------------
    # Model registry
    # ------------------------------------------------------------------
    def register(self, name: str, workload=None, *, policy: Policy,
                 mem_share: Optional[float] = None,
                 shed_priority: int = 0) -> ModelEntry:
        """Register a model: ``name`` becomes the routing key for
        ``submit(model=...)``, trace tags, backend muxing, and per-model
        stats; ``policy`` is the model's private batching policy (its own
        BatchTable / slack predictor — batching never crosses models).
        ``workload`` is advisory: when given, submitted requests are
        checked against it. ``mem_share`` caps the model's resident KV
        slots at that fraction of its backend pool's ``max_slots`` under
        memory-aware admission (falls back to the arbiter's
        ``mem_shares``). ``shed_priority`` ranks the model for graceful
        load shedding (higher = protected; lower tiers shed first under
        ingress overflow or brownout)."""
        entry = self.registry.register(name, workload, policy=policy,
                                       mem_share=mem_share,
                                       shed_priority=shed_priority)
        if self.memory_aware:
            # the gate re-reads backend stats on every admission decision,
            # so it tracks arena growth/shrink and cross-model usage live
            entry.policy.mem_gate = (lambda e=entry: self._mem_room(e))
        else:
            # a policy instance reused from a memory-aware session must not
            # keep that session's gate
            entry.policy.mem_gate = None
        return entry

    def _mem_share(self, entry: ModelEntry) -> Optional[float]:
        if entry.mem_share is not None:
            return entry.mem_share
        return self.arbiter.mem_share(entry.name)

    def _mem_room(self, entry: ModelEntry) -> Optional[int]:
        """New admissions ``entry`` may make before oversubscribing device
        memory (None = the backend reports no cap — memory-blind).

        Usage is counted from the policies' *admitted* sets, not the
        backend's live slots: a request holds its KV slot from admission
        (its first dispatch is imminent) to completion, and counting at
        the admission layer closes the window where several models could
        admit against the same free slot in one scheduling step. Models
        whose stats report the same ``pool`` contend for the same slots
        (one shared simulated device); per-model engines behind a
        MultiBackend each own a disjoint pool.

        A model's share is BOTH a cap on its own residency and a
        reservation against everyone else: other pool tenants can never
        admit into the unused remainder of a shared model's reserved
        slots, so an uncapped bulk tenant cannot starve a shared
        interactive tenant either."""
        stats = self.backend.memory_stats(entry.name)
        if stats is None or stats.max_slots is None:
            return None
        used_pool = 0
        reserved_unused = 0          # other tenants' untouched reservations
        for e in self.registry.entries():
            if e is entry:
                used_pool += e.policy.admitted
                continue
            st = self.backend.memory_stats(e.name)
            if st is not None and st.pool == stats.pool:
                used_pool += e.policy.admitted
                other_share = self._mem_share(e)
                if other_share is not None:
                    cap_other = max(1, int(other_share * stats.max_slots))
                    reserved_unused += max(0, cap_other - e.policy.admitted)
        room = stats.max_slots - used_pool - reserved_unused
        share = self._mem_share(entry)
        if share is not None:
            cap = max(1, int(share * stats.max_slots))
            room = min(room, cap - entry.policy.admitted)
        return max(0, room)

    def _resolve_model(self, model: Optional[str],
                       req: Request) -> ModelEntry:
        """Routing precedence: explicit ``model`` argument > sole
        registered model (single-model sessions accept every request —
        legacy compat; a foreign workload is still rejected by the
        submit-time workload check) > the request's own ``model`` tag.
        Ambiguous (multi-model, untagged) submissions raise."""
        entries = self.registry.entries()
        if not entries:
            raise RuntimeError(
                "no model registered — call session.register() first")
        if model is not None:
            return self.registry[model]
        if len(entries) == 1:
            return entries[0]
        if req.model is not None:
            return self.registry[req.model]
        raise ValueError(
            f"request {req.rid} carries no model tag and session serves "
            f"{self.registry.names()} — pass submit(model=...)")

    @property
    def policy(self) -> Policy:
        """The sole registered model's policy (single-model compat)."""
        entries = self.registry.entries()
        if len(entries) != 1:
            raise RuntimeError(
                "session.policy is single-model only — use "
                "session.registry[name].policy")
        return entries[0].policy

    # ------------------------------------------------------------------
    # Submission
    # ------------------------------------------------------------------
    def submit(self, req: Request, *, model: Optional[str] = None,
               prompt_tokens=None,
               on_token: Optional[Callable] = None) -> RequestHandle:
        """Register a request with the session and return its handle.

        ``model`` routes the request to a registered model; omitted, a
        single-model session serves it unconditionally (legacy compat),
        while a multi-model session falls back to the request's own
        ``model`` tag (traffic mixtures stamp one) and raises when that
        is missing too. ``req.arrival`` in the future
        (relative to the session clock) is honored — the request enters
        its model policy's InfQ when the clock reaches it (trace replay);
        an arrival in the past is clamped to *now* (live submission —
        waiting time, slack, and latency all count from the submission
        instant, not a stale timestamp). ``on_token(handle, token)`` fires
        once per response token at the producing run's boundary.
        """
        if req.rid in self.handles:
            raise ValueError(f"rid {req.rid} already submitted — clone the "
                             f"request to resubmit the same trace entry")
        entry = self._resolve_model(model, req)
        # workloads are compared by name, not identity: PAPER_WORKLOADS /
        # get_workload return a fresh instance per call, and same-name
        # workloads share profile tables (slack predictors key on name)
        if (entry.workload is not None
                and req.workload is not entry.workload
                and getattr(req.workload, "name", None)
                != entry.workload.name):
            raise ValueError(
                f"request {req.rid} was built for workload "
                f"{getattr(req.workload, 'name', '?')!r} but model "
                f"{entry.name!r} serves {entry.workload.name!r}")
        if len(self.registry) > 1:
            # normalize the reporting tag to the registry name; sole-model
            # sessions leave it alone so untagged requests keep the
            # per-workload ``model_name`` fallback in ServeStats.per_model
            # (the handle carries the authoritative routing key either way)
            req.model = entry.name
        req.arrival = max(req.arrival, self.now)
        handle = RequestHandle(req, self, on_token=on_token,
                               model=entry.name)
        self.handles[req.rid] = handle
        deadline = req.sla.deadline if req.sla else None
        prev = self._classes.setdefault(req.sla_name, deadline)
        if prev != deadline:
            del self.handles[req.rid]
            raise ValueError(
                f"SLA class {req.sla_name!r} submitted with deadline "
                f"{deadline} but previously seen with {prev} — per-class "
                f"reporting needs one deadline per class name")
        if self.reject_infeasible and self._infeasible(entry, req):
            handle._rejected = True
            self._rejected[req.rid] = req
            # the feasibility probe may have memoized predictor state for a
            # request the policy will never see finish — release it here
            entry.policy.request_finished([req])
            return handle
        self.backend.prepare(entry.name, req, self._rng,
                             prompt_tokens=prompt_tokens)
        # same-timestamp arrivals (co-located models replaying one trace)
        # tiebreak on rid — an intrinsic, submission-order-independent key —
        # so cross-model enqueue order never depends on registration or
        # trace-assembly dict order (the session seq is a last-resort
        # tiebreak for exotic cloned-rid submissions only)
        heapq.heappush(self._arrivals,
                       (req.arrival, req.rid, next(self._seq), req, entry))
        return handle

    def _infeasible(self, entry: ModelEntry, req: Request) -> bool:
        # arrival is already clamped to the session clock, so the deadline
        # window opens now: unmeetable iff even an isolated immediate run
        # (the conservative single-input bound) overshoots it
        pred = getattr(entry.policy, "predictor", None)
        if pred is None or not hasattr(pred, "single_total"):
            return False
        if pred.single_total(req) > pred.deadline(req):
            return True
        # memory-infeasible: the model's KV pool is exhausted AND — by the
        # predictor's own per-request bounds — no resident request can
        # release a slot early enough for this one to still meet its
        # deadline (projected footprint cannot fit before the deadline).
        # The slot is only needed at the request's ARRIVAL: a future
        # arrival absorbs (part of) the release wait, so trace-style
        # ahead-of-time submissions are never rejected for congestion
        # that clears before they arrive.
        if self.memory_aware and hasattr(pred, "release_bound"):
            room = self._mem_room(entry)
            if room == 0:
                wait = max(0.0,
                           pred.release_bound(entry.policy.admitted_requests)
                           - (req.arrival - self.now))
                return wait + pred.single_total(req) > pred.deadline(req)
        return False

    # ------------------------------------------------------------------
    # Clock advancement
    # ------------------------------------------------------------------
    def _enqueue_due(self):
        while self._arrivals and self._arrivals[0][0] <= self.now + 1e-12:
            _, _, _, req, entry = heapq.heappop(self._arrivals)
            if req.terminal:        # cancelled/shed while future-queued
                continue
            if (self._brownout_active
                    and entry.shed_priority < self._protected_priority()):
                self._terminate(self.handles.get(req.rid), "shed")
                continue
            if self.max_queue is not None:
                self._bound_ingress(req, entry)
                if req.terminal:    # the newcomer itself was the victim
                    continue
            entry.policy.enqueue(req, self.now)

    # ------------------------------------------------------------------
    # Failure model: cancellation, expiry, faults, shedding
    # ------------------------------------------------------------------
    def cancel(self, handle: RequestHandle) -> bool:
        """Cancel ``handle``'s request mid-flight (see
        :meth:`RequestHandle.cancel`). Returns ``False`` when already
        terminal."""
        return self._terminate(handle, "cancelled")

    def _terminate(self, handle: Optional[RequestHandle],
                   fate: str) -> bool:
        """Make a live request terminal with ``fate`` (``cancelled`` /
        ``expired`` / ``failed`` / ``shed``): physically evict it from
        its model's scheduling state (InfQ or SubBatch — survivors are
        untouched), free its backend resources (KV slot) immediately,
        and record it for stats. Idempotent: a terminal handle is a
        no-op (returns ``False``)."""
        if handle is None or handle.done:
            return False
        req = handle.request
        entry = self.registry[handle.model]
        req.fate = fate
        # evict BEFORE touching backend state: the policy drops it from
        # its InfQ / SubBatch via the same live-filtering a finished
        # request takes, so the batch-table invariants never see it
        entry.policy.cancel([req])
        # batch release + single reclaim; idempotent when it never held
        # a slot (e.g. cancelled while future-queued)
        self.backend.on_finished(entry.name, [req])
        entry.policy.request_finished([req])
        self._disposed[fate][req.rid] = req
        if fate != "cancelled":      # caller choice is not a QoS outcome
            self._note_outcome(entry, ok=False)
        return True

    def _rel_deadline(self, req: Request,
                      entry: ModelEntry) -> Optional[float]:
        """The request's relative deadline as the scheduler sees it: its
        model predictor's view (per-request SLA class, else the
        predictor's global target) — without a predictor, the SLA class
        alone (None = no deadline, never expires)."""
        pred = getattr(entry.policy, "predictor", None)
        if pred is not None and hasattr(pred, "deadline"):
            return pred.deadline(req)
        return req.sla.deadline if req.sla is not None else None

    def _abs_deadline(self, req: Request,
                      entry: ModelEntry) -> Optional[float]:
        rel = self._rel_deadline(req, entry)
        return None if rel is None else req.arrival + rel

    def _expire_due(self):
        """Run-boundary expiry sweep (``cancel_expired=True``): turn
        terminal-``EXPIRED`` every queued or admitted request whose
        deadline is provably blown — the clock is already past it, or
        even the predictor's conservative isolated-run bound
        (``single_remaining``, the mid-flight continuation of the
        ``reject_infeasible`` single bound) cannot land before it. An
        expired batch member is evicted and its slot freed so it stops
        burning device time the survivors could attain with."""
        for entry in self.registry.entries():
            pred = getattr(entry.policy, "predictor", None)
            rem = getattr(pred, "single_remaining", None)
            pending = list(entry.policy.queue) \
                + list(entry.policy.admitted_requests)
            for req in pending:
                if req.terminal:
                    continue
                dl = self._abs_deadline(req, entry)
                if dl is None:
                    continue
                blown = self.now > dl + 1e-12
                if not blown and rem is not None:
                    blown = self.now + rem(req) > dl + 1e-12
                if blown:
                    self._terminate(self.handles.get(req.rid), "expired")

    def _bound_ingress(self, req: Request, entry: ModelEntry):
        """Bounded ingress (``max_queue``): when the total InfQ backlog
        is at the bound, shed the least valuable of (backlog +
        newcomer) — lowest ``shed_priority`` tier first, loosest
        absolute deadline (most slack to give up) within a tier,
        newest arrival as the tiebreak."""
        depth = sum(len(e.policy.queue) for e in self.registry.entries())
        if depth < self.max_queue:
            return
        cands = [(e, r) for e in self.registry.entries()
                 for r in e.policy.queue]
        cands.append((entry, req))

        def _key(pair):
            e, r = pair
            dl = self._abs_deadline(r, e)
            # no deadline = infinitely loose = first to go within a tier
            return (e.shed_priority,
                    -dl if dl is not None else -float("inf"),
                    -r.arrival)

        victim_e, victim_r = min(cands, key=_key)
        self._terminate(self.handles.get(victim_r.rid), "shed")

    def _protected_priority(self) -> int:
        return max((e.shed_priority for e in self.registry.entries()),
                   default=0)

    def _note_outcome(self, entry: ModelEntry, ok: bool):
        """Feed the brownout controller one terminal outcome of the
        PROTECTED tier (finish-within-deadline = ok; late finish,
        expiry, fault-failure, shed = not ok)."""
        if self.brownout is None:
            return
        if entry.shed_priority != self._protected_priority():
            return
        self._attain_window.append(1 if ok else 0)
        cfg = self.brownout
        if len(self._attain_window) < cfg.min_samples:
            return
        att = sum(self._attain_window) / len(self._attain_window)
        if not self._brownout_active and att < cfg.floor:
            self._brownout_active = True
            self.brownouts += 1
            self._brownout_shed()
        elif self._brownout_active and att >= cfg.floor + cfg.hysteresis:
            self._brownout_active = False

    def _brownout_shed(self):
        """Brownout activation: shed every QUEUED (not yet admitted —
        admitted work already holds slots and finishes soon) request of
        strictly lower-priority models; arrivals keep shedding at the
        ingress while the brownout stays active."""
        prot = self._protected_priority()
        for entry in self.registry.entries():
            if entry.shed_priority >= prot:
                continue
            for req in list(entry.policy.queue):
                self._terminate(self.handles.get(req.rid), "shed")

    def _on_fault(self, entry: ModelEntry, sb, reqs: List[Request],
                  err: BackendError):
        """A dispatched run raised ``BackendError``: the whole run's
        device-side progress is lost. Members are evicted from the
        batch, their slots/caches discarded (``reset_request`` — KV is
        gone, so a retry replays prefill from node 0), and each is
        either requeued with capped exponential backoff + deterministic
        jitter or turned terminal ``FAILED`` (non-retryable fault or
        retry budget exhausted). The fault's own latency burns device
        time (``busy_time``) but commits no nodes; SLA accounting keeps
        judging the ORIGINAL arrival/deadline."""
        lat = float(err.latency)
        self.log.faults += 1
        self.log.busy_time += lat
        self.log.busy_by_model[entry.name] = (
            self.log.busy_by_model.get(entry.name, 0.0) + lat)
        self.now += lat
        # evict from the SubBatch first, while member idx values still
        # satisfy the common-node invariant — THEN rewind per-request
        entry.policy.cancel(reqs)
        for req in reqs:
            # idempotent device-side discard: slot released, engine state
            # rewound to post-prepare (prompt intact, KV/progress gone)
            self.backend.reset_request(entry.name, req)
            handle = self.handles.get(req.rid)
            if err.retryable and req.retries < self.retry.max_retries:
                entry.policy.request_finished([req])   # predictor forgets
                req.retries += 1
                self.retried += 1
                req.idx = 0                  # prefill replay from node 0
                req.t_first_issue = None
                if handle is not None:
                    handle._running = False
                delay = self.retry.backoff(req.retries, self._retry_rng)
                heapq.heappush(
                    self._arrivals,
                    (self.now + delay, req.rid, next(self._seq), req,
                     entry))
            else:
                self._terminate(handle, "failed")

    def step(self, limit: Optional[float] = None) -> bool:
        """One scheduling step: enqueue due arrivals, collect each model
        policy's next committed run, let the arbiter pick one, and execute
        it (clock advances by its latency) — or, with no run ready, jump
        the clock to the next event (arrival / earliest policy timer).
        Returns ``False`` when fully idle — nothing queued, running, or
        pending — or when the next event lies beyond ``limit``.

        Consulting ``next_work`` commits admission state (batch
        formation, ``t_first_issue``) for EVERY model with ready work at
        this run boundary, not just the arbiter's winner — deliberately:
        host-side admission proceeds while the device is busy with
        another model's run, exactly as the paper's co-located stacks
        admit into their BatchTables between dispatches. A non-dispatched
        model's formed batch simply stays parked (its policy returns the
        same work next step) and burns waiting time until the arbiter
        picks it."""
        self._enqueue_due()
        if self.cancel_expired:
            self._expire_due()
        entries = self.registry.entries()
        candidates: List[Tuple[ModelEntry, object, Tuple[str, ...]]] = []
        for entry in entries:
            work = entry.policy.next_work(self.now)
            if work is not None:
                candidates.append((entry, work[0], work[1]))
        if not candidates:
            nxt = []
            if self._arrivals:
                nxt.append(self._arrivals[0][0])
            for entry in entries:
                t = entry.policy.next_timer(self.now)
                if t is not None:
                    nxt.append(max(t, self.now))
            if not nxt:
                return False                      # fully drained
            target = min(nxt)
            if limit is not None and target > limit:
                self.now = max(self.now, limit)
                return False
            self.now = target
            return True

        if len(entries) == 1:          # single-model: bit-exact legacy path
            entry, sb, run = candidates[0]
        else:
            # multi-model sessions consult the arbiter even for a single
            # candidate so stateful arbiters (round-robin's cursor) see
            # every dispatch, not just the contended ones
            entry, sb, run = candidates[self.arbiter.pick(candidates,
                                                          self.now)]
        reqs = list(sb.live_requests)
        try:
            latency, per_node = self.backend.execute_run(entry.name, sb, run)
        except BackendError as err:
            if self.retry is None:
                raise       # no retry policy armed: pre-failure-model
            self._on_fault(entry, sb, reqs, err)
            if self.on_run_boundary is not None:
                self.on_run_boundary(self, entry.name, [])
            return True
        self.log.nodes_executed += len(run)
        self.log.runs_executed += 1
        self.log.busy_time += latency
        self.log.batch_size_sum += sb.size * len(run)
        self.log.busy_by_model[entry.name] = (
            self.log.busy_by_model.get(entry.name, 0.0) + latency)
        prefix = f"{entry.name}:" if len(entries) > 1 else ""
        if per_node is not None:
            for nid, lat in zip(run, per_node):
                self.log.record(prefix + nid, lat)
        else:
            self.log.record(prefix + run_label(run), latency, n=len(run))
        self.now += latency
        done_now = entry.policy.work_done(sb, self.now, len(run))
        # observe (stream tokens, stamp TTFT) BEFORE the completion hooks:
        # backends may release per-request device resources there
        for r in reqs:
            self._observe(entry, r)
        if done_now:
            self.backend.on_finished(entry.name, done_now)
            entry.policy.request_finished(done_now)
        for r in done_now:
            self._finished[r.rid] = r
            dl = self._rel_deadline(r, entry)
            self._note_outcome(entry,
                               ok=(dl is None or r.latency() <= dl + 1e-12))
        if self.on_run_boundary is not None:
            self.on_run_boundary(self, entry.name, done_now)
        return True

    def _observe(self, entry: ModelEntry, req: Request):
        """Run-boundary bookkeeping for one just-executed request: state
        transition to RUNNING, TTFT stamp, token streaming."""
        handle = self.handles.get(req.rid)
        if handle is None:
            return
        handle._running = True
        n = self.backend.token_count(entry.name, req)
        if n <= handle._n_tokens:
            return
        if req.t_first_token is None:
            req.t_first_token = self.now
        toks = self.backend.tokens(entry.name, req)
        new = (list(toks[handle._n_tokens:n]) if toks is not None
               else [-1] * (n - handle._n_tokens))   # virtual tokens (sim)
        handle._n_tokens = n
        handle.tokens.extend(new)
        if handle.on_token is not None:
            for t in new:
                handle.on_token(handle, t)

    def run_until(self, t: float) -> float:
        """Advance the session clock to (at least) ``t``, executing every
        run that *starts* at or before ``t`` — a run in flight at the
        boundary completes (the clock only advances at run boundaries).
        Returns the clock."""
        while self.now <= t:
            if not self.step(limit=t):
                break
        self.now = max(self.now, t)
        return self.now

    def drain(self, *, stall_limit: int = 1000) -> ServeStats:
        """Run everything outstanding to completion and return stats.

        Liveness guard: a step that reports progress (``True``) must
        change *something* observable — the clock, a run/fault count, a
        retry, or a terminal disposition. ``stall_limit`` consecutive
        steps with an identical progress signature mean the scheduler is
        livelocked (e.g. a policy re-offering work the backend can never
        place); rather than spinning forever, drain raises a
        ``RuntimeError`` carrying per-model queue/backlog diagnostics."""
        last_sig = None
        stalls = 0
        while self.step():
            sig = (self.now, self.log.runs_executed, self.log.faults,
                   self.retried, self.outstanding, len(self._finished),
                   *(len(d) for d in self._disposed.values()))
            if sig == last_sig:
                stalls += 1
                if stalls >= stall_limit:
                    backlog = {e.name: {"queued": len(e.policy.queue),
                                        "admitted": e.policy.admitted}
                               for e in self.registry.entries()}
                    raise RuntimeError(
                        f"drain() livelocked: no observable progress for "
                        f"{stall_limit} consecutive steps at "
                        f"t={self.now:.6f} — future arrivals="
                        f"{len(self._arrivals)}, outstanding="
                        f"{self.outstanding}, per-model backlog={backlog}")
            else:
                stalls = 0
                last_sig = sig
        return self.stats()

    def release(self, handle: RequestHandle) -> None:
        """Drop a finished/rejected handle's per-request state from the
        session (long-lived online sessions otherwise accumulate every
        handle, request, and token list ever submitted). The request no
        longer contributes to :meth:`stats`.

        Only terminal handles (DONE / REJECTED / CANCELLED / EXPIRED /
        FAILED / SHED) may be released: a QUEUED / ADMITTED / RUNNING
        request's scheduler and backend state is live, and silently
        dropping the session's view of it mid-flight would orphan
        tokens, stats, and KV slots — raises ``ValueError`` (a real
        error, not an ``assert``, so it cannot be optimized away)."""
        if not handle.done:
            raise ValueError(
                f"cannot release live request {handle.request.rid} "
                f"(state={handle.state.value}): only terminal handles "
                f"may be released — wait for completion or drain first")
        req = handle.request
        self.handles.pop(req.rid, None)
        self._finished.pop(req.rid, None)
        self._rejected.pop(req.rid, None)
        for bucket in self._disposed.values():
            bucket.pop(req.rid, None)
        self.backend.release_request(handle.model, req)

    # ------------------------------------------------------------------
    @property
    def outstanding(self) -> int:
        return len(self._arrivals) + sum(e.policy.outstanding
                                         for e in self.registry.entries())

    @property
    def finished(self) -> List[Request]:
        return list(self._finished.values())

    @property
    def rejected(self) -> List[Request]:
        return list(self._rejected.values())

    @property
    def cancelled(self) -> List[Request]:
        return list(self._disposed["cancelled"].values())

    @property
    def expired(self) -> List[Request]:
        return list(self._disposed["expired"].values())

    @property
    def failed(self) -> List[Request]:
        return list(self._disposed["failed"].values())

    @property
    def shed(self) -> List[Request]:
        return list(self._disposed["shed"].values())

    def stats(self) -> ServeStats:
        duration = self.duration if self.duration is not None else self.now
        entries = self.registry.entries()
        if len(entries) == 1:
            pname = entries[0].policy.name
        else:
            pname = (self.arbiter.name + "["
                     + "+".join(f"{e.name}:{e.policy.name}" for e in entries)
                     + "]")
        return ServeStats(policy=pname, duration=duration,
                          finished=list(self._finished.values()),
                          rejected=len(self._rejected),
                          rejected_requests=list(self._rejected.values()),
                          cancelled_requests=self.cancelled,
                          expired_requests=self.expired,
                          failed_requests=self.failed,
                          shed_requests=self.shed,
                          retried=self.retried,
                          classes=dict(self._classes),
                          models={e.name: e.policy.name for e in entries})


def run_trace(policy: Policy, backend: Backend, trace: Trace, *,
              drain: bool = True, seed: int = 0,
              log: Optional[ServerLog] = None,
              reject_infeasible: bool = False,
              memory_aware: bool = True) -> ServeStats:
    """Offline-compatibility wrapper: replay a whole trace through a
    single-model :class:`ServingSession` and return its
    :class:`ServeStats` — the ``InferenceServer.run(trace)`` contract,
    now a thin shim."""
    session = ServingSession(policy, backend, seed=seed, log=log,
                             reject_infeasible=reject_infeasible,
                             memory_aware=memory_aware)
    session.duration = trace.duration
    for req in sorted(trace.requests, key=lambda r: r.arrival):
        session.submit(req)
    if drain:
        return session.drain()
    session.run_until(trace.duration)
    return session.stats()


def run_mixture(models: Sequence[Tuple[str, object, Policy]],
                backend: Backend, trace: Trace, *,
                arbiter: Optional[Arbiter] = None, drain: bool = True,
                seed: int = 0, log: Optional[ServerLog] = None,
                reject_infeasible: bool = False,
                memory_aware: bool = True) -> ServeStats:
    """Multi-tenant sibling of :func:`run_trace`: register every
    ``(name, workload, policy)`` triple, replay a (model-tagged) trace —
    e.g. from :func:`~repro.serving.traffic.poisson_mixture` — and return
    the drained stats with per-model breakdowns."""
    session = ServingSession(backend=backend, arbiter=arbiter, seed=seed,
                             log=log, reject_infeasible=reject_infeasible,
                             memory_aware=memory_aware)
    for name, workload, policy in models:
        session.register(name, workload, policy=policy)
    session.duration = trace.duration
    for req in sorted(trace.requests, key=lambda r: r.arrival):
        session.submit(req)
    if drain:
        return session.drain()
    session.run_until(trace.duration)
    return session.stats()
