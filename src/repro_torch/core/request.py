"""Inference requests and sub-batches (BatchTable entries).

A request's execution is a linear sequence of graph nodes (paper §II-A:
the DAG is lowered to a serialized node-wise execution order; dynamic
seq2seq graphs are unrolled per-request into their actual length). Node ids
are *shared* across unroll steps when the underlying weights are shared
(RNN cells, decode-cycle layers) — two requests at the same node id can be
merged into one sub-batch regardless of their absolute timestep, which is
exactly the property cellular batching exploits and LazyBatching
generalizes.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from . import lifecycle

_rid_counter = itertools.count()


@dataclass(frozen=True)
class SLAClass:
    """Per-request service tier: a latency deadline plus a reporting name.

    The deadline is *relative* (seconds from arrival to completion) — the
    same quantity the paper's single global ``SLA_target`` froze at
    predictor-build time. Requests without an ``sla`` fall back to that
    global scalar, so single-tier serving is byte-identical to before;
    mixed-tier traces attach different classes per request and the slack
    predictors / LazyBatching admission honor each request's own deadline.
    """
    name: str = "default"
    deadline: float = 0.1

    def __post_init__(self):
        if not self.deadline > 0.0:
            raise ValueError(
                f"SLA class {self.name!r} deadline must be positive, "
                f"got {self.deadline!r}")


@dataclass
class Request:
    workload: "object"                  # serving.workload.Workload
    arrival: float
    sequence: List[Tuple[str, int]]     # [(node_id, ctx), ...]
    rid: int = field(default_factory=lambda: next(_rid_counter))
    idx: int = 0                        # next node to execute
    sla: Optional[SLAClass] = None      # None = predictor's global target
    # registry model tag: which registered model serves this request
    # (stamped by traffic.poisson_mixture and by multi-model
    # ServingSession.submit; None falls back to the workload's own name
    # for per-model reporting)
    model: Optional[str] = None
    # terminal out-of-band disposition (None = normal lifecycle): one of
    # core.lifecycle.FATES — "cancelled" (caller), "expired" (deadline
    # provably blown mid-flight), "failed" (backend fault, retries
    # exhausted), "shed" (load shedding). A fated request is dead to the
    # scheduler: SubBatch live-filtering drops it exactly like a finished
    # one, but it never gets a t_finish. Writes are validated against the
    # lifecycle table (see __setattr__): only declared fates, and a fate
    # is absorbing — it can never be overwritten with a different one.
    fate: Optional[str] = None
    retries: int = 0                    # fault-retry attempts so far
    t_first_issue: Optional[float] = None
    # stamped by the session at the run boundary emitting token #1:
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    # sequence-structure metadata (set by Workload.sample_request)
    prompt_len: int = 0
    decode_len: int = 0
    prefix_len: int = 0                 # node count before the decode cycles
    cycle_len: int = 0                  # nodes per decode cycle (0 = static)

    def __setattr__(self, name, value):
        # fate writes are lifecycle edges: enforce the declarative table
        # (core.lifecycle) at runtime — the handle-lattice static checker
        # polices the same table at review time
        if name == "fate" and value is not None:
            if value not in lifecycle.FATES:
                raise ValueError(
                    f"request {self.__dict__.get('rid', '?')}: fate "
                    f"{value!r} is not a declared terminal disposition "
                    f"(lifecycle.FATES={lifecycle.FATES})")
            cur = self.__dict__.get("fate")
            if cur is not None and cur != value:
                raise RuntimeError(
                    f"request {self.__dict__.get('rid', '?')}: fate is "
                    f"absorbing — cannot move {cur!r} -> {value!r} "
                    f"(terminal states have no out-edges)")
        super().__setattr__(name, value)

    @property
    def done(self) -> bool:
        return self.idx >= len(self.sequence)

    @property
    def terminal(self) -> bool:
        """Finished OR removed from service (cancelled/expired/failed/
        shed) — either way the scheduler never dispatches it again."""
        return self.done or self.fate is not None

    @property
    def next_node_id(self) -> Optional[str]:
        if self.done:
            return None
        return self.sequence[self.idx][0]

    @property
    def next_ctx(self) -> int:
        return self.sequence[self.idx][1]

    def advance(self):
        if self.done:
            raise RuntimeError(
                f"request {self.rid} advanced past its final node "
                f"(idx={self.idx}, sequence length {len(self.sequence)})")
        self.idx += 1

    def latency(self) -> float:
        if self.t_finish is None:
            raise RuntimeError(
                f"request {self.rid} has no latency yet — it has not "
                f"finished (idx={self.idx}/{len(self.sequence)})")
        return self.t_finish - self.arrival

    def clone(self) -> "Request":
        """Fresh, unexecuted copy (for comparing policies on one trace)."""
        return Request(workload=self.workload, arrival=self.arrival,
                       sequence=self.sequence, rid=self.rid, sla=self.sla,
                       model=self.model,
                       prompt_len=self.prompt_len, decode_len=self.decode_len,
                       prefix_len=self.prefix_len, cycle_len=self.cycle_len)

    @property
    def sla_name(self) -> str:
        return self.sla.name if self.sla is not None else "default"

    @property
    def model_name(self) -> str:
        """Reporting key for per-model breakdowns: the registry tag when
        the request was routed through one, else its workload's name."""
        if self.model is not None:
            return self.model
        return getattr(self.workload, "name", "default")

    @property
    def n_tokens(self) -> int:
        """Response tokens a completed request produced (one per decode
        cycle; a static graph's single response counts as one)."""
        if self.cycle_len:
            return max(0, self.idx - self.prefix_len) // self.cycle_len
        return 1 if self.done else 0

    def __repr__(self):
        return (f"Request(rid={self.rid}, wl={getattr(self.workload, 'name', '?')}, "
                f"idx={self.idx}/{len(self.sequence)})")


@dataclass
class SubBatch:
    """One BatchTable stack entry: requests advancing in lockstep.

    Invariant: all member requests share the same ``next_node_id`` (they are
    at a common graph node). Members may *complete* at different times
    (variable unrolled lengths) — finished requests simply leave the batch.
    """
    requests: List[Request]

    @property
    def node_id(self) -> Optional[str]:
        live = [r for r in self.requests if not r.terminal]
        if not live:
            return None
        nid = live[0].next_node_id
        if any(r.next_node_id != nid for r in live):
            raise RuntimeError(
                "SubBatch invariant violated: members at different nodes "
                + str(sorted({str(r.next_node_id) for r in live})))
        return nid

    @property
    def live_requests(self) -> List[Request]:
        # fated (cancelled/expired/failed/shed) members fall out exactly
        # like finished ones — the session evicts them physically at run
        # boundaries; this filter makes any missed path fail-safe instead
        # of dispatching a dead request
        return [r for r in self.requests if not r.terminal]

    @property
    def size(self) -> int:
        return len(self.live_requests)

    def advance(self, now: float) -> List[Request]:
        """Advance every live member one node; return newly finished."""
        return self.advance_n(1, now)

    def advance_n(self, n: int, now: float) -> List[Request]:
        """Advance every live member ``n`` nodes (one committed run);
        return newly finished requests. ``n`` must not exceed any member's
        remaining node count — runs are committed via :meth:`run_nodes`,
        which caps at the earliest-finishing member."""
        finished = []
        for r in self.live_requests:
            for _ in range(n):
                r.advance()
            if r.done:
                r.t_finish = now
                finished.append(r)
        self.requests = self.live_requests
        return finished

    def run_nodes(self, *, stop_before=(), stop_after=()) -> Tuple[str, ...]:
        """Maximal run of consecutive node ids the batch can commit.

        All live members share the same forward node-id stream from their
        common current node (same workload, shared cycle ids), so the run is
        read off any member and capped at ``min`` remaining nodes — no
        member ever finishes *mid*-run, only exactly at a run boundary.

        ``stop_before``: node ids the run must not enter (the entry below
        on the BatchTable stack sits at such a node — stopping there keeps
        every merge opportunity a single-node scheduler would have seen).
        ``stop_after``: node ids the run ends on *inclusively* (decode-cycle
        boundaries — the scheduler re-evaluates admission/preemption there).
        The first node is always included: a single-node run is the
        degenerate (always valid) case.
        """
        live = self.live_requests
        n = min(len(r.sequence) - r.idx for r in live)
        r0 = live[0]
        ids = [nid for nid, _ in r0.sequence[r0.idx:r0.idx + n]]
        run = [ids[0]]
        for nid in ids[1:]:
            if nid in stop_before:
                break
            run.append(nid)
            if nid in stop_after:
                break
        return tuple(run)

    def mergeable_with(self, other: "SubBatch", max_batch: int) -> bool:
        a, b = self.node_id, other.node_id
        if a is None or a != b or self.size + other.size > max_batch:
            return False
        # co-location: node ids only denote shared weights within ONE model —
        # sub-batches of different workloads never merge (§VI-C)
        return (self.live_requests[0].workload
                is other.live_requests[0].workload)

    def merge(self, other: "SubBatch"):
        if self.node_id != other.node_id:
            raise RuntimeError(
                f"cannot merge sub-batches at different nodes: "
                f"{self.node_id!r} vs {other.node_id!r} — merge_top must "
                f"check mergeable_with first")
        self.requests = self.live_requests + other.live_requests
