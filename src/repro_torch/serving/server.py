"""Discrete-event inference serving (paper Fig. 9 serving architecture).

One backend processor executes one committed *run* of consecutive nodes at
a time for one (sub-)batch; the scheduler (policy) is consulted at every
run boundary and on arrivals when idle. Policies commit exactly the span
to their next possible merge/preemption point (see ``core.policies``), so
scheduling stays node-granular where it matters while the executor is free
to fuse a whole run into one device dispatch.

The loop itself lives in :class:`~repro.serving.session.ServingSession`
(the online submit/stream front-end); this module keeps the offline
conveniences on top of it:

  * ``SimExecutor``  — analytical NPU latency model (paper's methodology);
    model-agnostic — it reads each request's own workload, so one
    instance serves every registered model of a multi-tenant session,
  * ``InferenceServer`` / ``run_policy`` — trace-in, stats-out wrappers
    (each run is one drained session; behavior and statistics unchanged).

``Executor`` — the pre-session alias of the :class:`~repro.serving.
backend.Backend` contract — is retired; accessing it here still resolves
to ``Backend`` behind a ``DeprecationWarning``.
"""
from __future__ import annotations

import warnings
from typing import Optional

from ..core.policies import Policy
from .backend import Backend, NodeLat, ServerLog, run_label
from .metrics import ServeStats
from .npu_model import NPUPerfModel
from .session import run_trace
from .traffic import Trace


def __getattr__(name):
    if name == "Executor":          # retired alias: warn once per call site
        warnings.warn("Executor is deprecated; use "
                      "repro.serving.backend.Backend",
                      DeprecationWarning, stacklevel=2)
        return Backend
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class SimExecutor(Backend):
    """Analytic backend; optionally memory-bounded.

    ``max_slots`` models a device whose KV arena holds at most that many
    concurrently resident requests (one *slot* per live request, held
    from its first dispatched node until completion — the same lifetime
    the JAX engine's arena slots have). The simulator never refuses work:
    when the live set oversubscribes the cap, every dispatched node pays
    a linear thrash factor ``live / max_slots`` (the oversubscribed
    fraction of resident context must be re-staged over the host link
    each dispatch — the cost a memory-blind policy silently eats and a
    memory-aware one avoids by deferring admission). ``max_slots=None``
    (default) keeps the seed's unbounded behavior bit-identically.

    Per-request KV bytes are estimated analytically from the workload's
    node byte model (max context seen per node id × ``bytes_per_ctx``),
    feeding ``memory_stats()``'s per-model accounting.
    """

    def __init__(self, perf_model: NPUPerfModel,
                 max_slots: Optional[int] = None):
        self.perf = perf_model
        self.max_slots = max_slots
        # model -> {rid: kv_bytes}: requests seen executing, not yet finished
        self._live: dict = {}

    # ------------------------------------------------------------------
    @staticmethod
    def _kv_bytes(req) -> float:
        """Analytic per-request KV footprint: peak context per node id
        through the node byte model (weights are batch-amortized and
        excluded — this is the per-slot resident state)."""
        peak: dict = {}
        for nid, ctx in req.sequence:
            if ctx > peak.get(nid, -1):
                peak[nid] = ctx
        nodes = req.workload.nodes
        return float(sum(nodes[nid].bytes_per_ctx * c
                         for nid, c in peak.items()))

    def _touch(self, model, reqs):
        """Mark ``reqs`` live (slot held) and return the thrash factor."""
        live = self._live.setdefault(model, {})
        for r in reqs:
            if r.rid not in live:
                live[r.rid] = self._kv_bytes(r)
        if self.max_slots is None:
            return 1.0
        total = sum(len(per) for per in self._live.values())
        return max(1.0, total / self.max_slots)

    def on_finished(self, model, reqs):
        live = self._live.get(model)
        if live:
            for r in reqs:
                live.pop(r.rid, None)

    def reset_request(self, model, req):
        """Fault recovery: drop the request's simulated KV residency (its
        slot) — idempotent; a retry re-acquires via ``_touch`` on its
        next dispatch, exactly like a fresh admission."""
        live = self._live.get(model)
        if live:
            live.pop(req.rid, None)

    def release_request(self, model, req):
        """Forget the request entirely (``ServingSession.release``): the
        reset/release pair the Backend contract expects must BOTH exist on
        any backend that tracks per-request residency — releasing a
        terminal request whose residency was never dropped (e.g. a handle
        released without a drain) would otherwise leave a phantom slot
        inflating the thrash factor forever. Idempotent, like reset."""
        self.reset_request(model, req)

    def memory_stats(self, model=None):
        from .backend import MemoryStats
        n_live = sum(len(per) for per in self._live.values())
        n_mine = (n_live if model is None
                  else len(self._live.get(model, ())))
        total = self.max_slots if self.max_slots is not None else n_live
        return MemoryStats(
            slots_total=total,
            slots_live=n_mine,
            slots_free=max(0, total - n_live),
            bytes_resident=int(sum(b for per in self._live.values()
                                   for b in per.values())),
            bytes_per_slot=0.0,
            max_slots=self.max_slots,
            pool=id(self))

    # ------------------------------------------------------------------
    def execute(self, model, sb, node_id: str) -> float:
        reqs = sb.live_requests
        wl = reqs[0].workload
        node = wl.nodes[node_id]
        ctxs = [r.next_ctx for r in reqs]
        return self.perf.node_latency(node, ctxs) * self._touch(model, reqs)

    def execute_run(self, model, sb, node_ids):
        # per-node ctx is read at the node's own offset into each member's
        # sequence (requests only advance at run boundaries, but attention
        # context still grows per node *within* the run)
        reqs = sb.live_requests
        wl = reqs[0].workload
        thrash = self._touch(model, reqs)
        lats = []
        for k, nid in enumerate(node_ids):
            ctxs = [r.sequence[r.idx + k][1] for r in reqs]
            lats.append(self.perf.node_latency(wl.nodes[nid], ctxs) * thrash)
        return sum(lats), lats


class InferenceServer:
    """Offline wrapper: one drained :class:`ServingSession` per ``run``."""

    def __init__(self, policy: Policy, executor: Backend):
        self.policy = policy
        self.executor = executor
        self.log = ServerLog()

    def run(self, trace: Trace, *, drain: bool = True) -> ServeStats:
        """Run the trace to completion; returns serving statistics."""
        return run_trace(self.policy, self.executor, trace, drain=drain,
                         log=self.log)


def run_policy(policy: Policy, trace: Trace,
               perf_model: Optional[NPUPerfModel] = None) -> ServeStats:
    perf_model = perf_model or NPUPerfModel()
    server = InferenceServer(policy, SimExecutor(perf_model))
    return server.run(trace.fresh())
