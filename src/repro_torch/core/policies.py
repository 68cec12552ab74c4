"""Scheduling / batching policies (paper §VI design points).

  * ``Serial``      — no batching, FIFO, one request at a time.
  * ``GraphBatching(window, max_batch)`` — the baseline: whole-graph batches
    formed by a static batching time-window + model-allowed max batch size.
  * ``CellularBatching`` — application-specific baseline [Gao et al.]:
    node-level interleaving but merges permitted only at weight-shared
    *cell* nodes; no SLA awareness. Degenerates to graph-like serialization
    on workloads without cell nodes (paper Fig. 7).
  * ``LazyBatching``  — the paper's contribution: BatchTable stack +
    SLA-aware conservative slack prediction.
  * ``Oracle``        — LazyBatching with the oracular latency-vs-batch
    tradeoff curves and true decode lengths.

All policies speak one interface consumed by both the discrete-event
simulator and the real-JAX serving engine:

    enqueue(req, now); next_work(now) -> (SubBatch, run) | None;
    work_done(sub_batch, now, n_nodes) -> finished requests; next_timer(now).

``run`` is a tuple of *consecutive* node ids committed for dispatch in one
go (the run-commit contract): the scheduler decides per node but commits
the maximal span during which no scheduling decision could change the
outcome, so the executor may fuse the whole run into one device dispatch.
Each policy commits exactly the span to its next possible merge /
preemption point:

  * ``Serial`` / ``GraphBatching`` never merge into or preempt a running
    batch — they commit whole remaining graphs (capped at the
    earliest-finishing member, so completions stay run-boundary events);
  * ``CellularBatching`` / ``LazyBatching`` stop *before* the node the
    stack entry below is parked at (where a catch-up merge is possible —
    for cellular only when that node is a weight-shared cell) and stop
    *after* each decode-cycle boundary, the point where admission and
    preemption are re-evaluated. On static (non-cyclic) graphs they keep
    single-node commits: the paper's node granularity, unchanged.

A single-node run is always a valid degenerate commit.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import List, Optional, Tuple

from .batch_table import BatchTable
from .request import Request, SubBatch
from .slack import SlackPredictor

Work = Tuple[SubBatch, Tuple[str, ...]]


def _group_pushable(reqs: List[Request]) -> List[List[Request]]:
    """Split a request list into SubBatch-compatible groups: same workload
    AND same next node (co-located models never share a sub-batch)."""
    groups: dict = {}
    for r in reqs:
        groups.setdefault((id(r.workload), r.next_node_id), []).append(r)
    return list(groups.values())


class Policy:
    name = "abstract"

    # memory-aware admission hook, wired by the serving session when the
    # backend reports a bounded KV pool: a callable returning how many NEW
    # requests this policy may admit right now without oversubscribing
    # device memory (None = unbounded / memory-blind — the seed behavior).
    # Policies that honor it defer admission (requests wait in the InfQ,
    # burning slack like any other wait) instead of overcommitting; the
    # whole-graph baselines (Serial/GraphBatching) stay memory-blind.
    mem_gate = None

    def __init__(self, max_batch: int = 64):
        self.max_batch = max_batch
        self.queue: deque[Request] = deque()

    def enqueue(self, req: Request, now: float):
        self.queue.append(req)

    def _mem_room(self) -> Optional[int]:
        """New admissions the memory gate allows now (None = unbounded —
        no gate wired, or the backend reports no memory cap)."""
        if self.mem_gate is None:
            return None
        room = self.mem_gate()
        return None if room is None else max(0, room)

    @property
    def admitted_requests(self) -> List[Request]:
        """Live requests admitted out of the InfQ (each holds — or is
        about to hold — one KV slot until it finishes)."""
        return []

    @property
    def admitted(self) -> int:
        return len(self.admitted_requests)

    def next_work(self, now: float) -> Optional[Work]:
        raise NotImplementedError

    def commit_run(self, sb: SubBatch) -> Tuple[str, ...]:
        """Run of node ids committed for the active batch (degenerate
        default: one node — correct for any policy, fuses nothing)."""
        return (sb.node_id,)

    def work_done(self, sb: SubBatch, now: float,
                  n_nodes: int = 1) -> List[Request]:
        raise NotImplementedError

    def request_finished(self, reqs: List[Request]) -> None:
        """Completion hook: the serving session reports every request that
        finished at the last run boundary, so policies can release
        per-request scheduling state (e.g. slack-predictor memo entries).
        Default no-op."""

    def cancel(self, reqs: List[Request]) -> None:
        """Evict ``reqs`` from this policy's scheduling state mid-flight
        (cancellation / expiry / fault-retry requeue): drop them from the
        InfQ and physically remove them from any batch entry, pruning
        entries that empty out — the same live-filtering / drop-empty
        machinery that removes finished members at run boundaries, so
        surviving batch members are untouched. Only called at run
        boundaries (never while a run is in flight). Idempotent: unknown
        rids are ignored."""
        gone = {r.rid for r in reqs}
        if any(r.rid in gone for r in self.queue):
            self.queue = deque(r for r in self.queue if r.rid not in gone)
        self._evict_batched(gone)

    def _evict_batched(self, gone: set) -> None:
        """Hook: remove ``gone`` rids from the policy's batch state."""

    def next_timer(self, now: float) -> Optional[float]:
        return None

    @property
    def outstanding(self) -> int:
        raise NotImplementedError


class Serial(Policy):
    name = "serial"

    def __init__(self):
        super().__init__(max_batch=1)
        self.active: Optional[SubBatch] = None

    def next_work(self, now):
        if self.active is None or self.active.size == 0:
            if not self.queue:
                return None
            req = self.queue.popleft()
            req.t_first_issue = now
            self.active = SubBatch([req])
        return self.active, self.commit_run(self.active)

    def commit_run(self, sb):
        # no batching, no merging: the whole remaining graph is one run
        return sb.run_nodes()

    def work_done(self, sb, now, n_nodes=1):
        finished = sb.advance_n(n_nodes, now)
        if sb.size == 0:
            self.active = None
        return finished

    def _evict_batched(self, gone):
        if self.active is not None:
            self.active.requests = [r for r in self.active.requests
                                    if r.rid not in gone]
            if self.active.size == 0:
                self.active = None

    @property
    def admitted_requests(self):
        return self.active.live_requests if self.active else []

    @property
    def outstanding(self):
        return len(self.queue) + (self.active.size if self.active else 0)


class GraphBatching(Policy):
    def __init__(self, window: float, max_batch: int = 64):
        super().__init__(max_batch=max_batch)
        self.window = window
        self.active: Optional[SubBatch] = None
        self.name = f"graphb({window * 1e3:g}ms)"

    def _head_group(self) -> List[Request]:
        """Oldest request + up to max_batch-1 same-model followers (per-model
        graph batches — co-located models are never batched together)."""
        head = self.queue[0]
        group = [r for r in self.queue if r.workload is head.workload]
        return group[:self.max_batch]

    def _batch_ready(self, now) -> bool:
        if not self.queue:
            return False
        return (len(self._head_group()) >= self.max_batch
                or now + 1e-12 >= self.queue[0].arrival + self.window)

    def next_work(self, now):
        if self.active is not None and self.active.size:
            return self.active, self.commit_run(self.active)
        if not self._batch_ready(now):
            return None
        reqs = self._head_group()
        for r in reqs:
            self.queue.remove(r)
            r.t_first_issue = now
        self.active = SubBatch(reqs)
        return self.active, self.commit_run(self.active)

    def commit_run(self, sb):
        # whole-graph batches never merge mid-flight or preempt: commit the
        # full remaining segment (capped at the earliest-finishing member)
        return sb.run_nodes()

    def work_done(self, sb, now, n_nodes=1):
        finished = sb.advance_n(n_nodes, now)
        if sb.size == 0:
            self.active = None
        return finished

    def _evict_batched(self, gone):
        if self.active is not None:
            self.active.requests = [r for r in self.active.requests
                                    if r.rid not in gone]
            if self.active.size == 0:
                self.active = None

    def next_timer(self, now):
        if self.queue and (self.active is None or self.active.size == 0):
            return self.queue[0].arrival + self.window
        return None

    @property
    def admitted_requests(self):
        return self.active.live_requests if self.active else []

    @property
    def outstanding(self):
        return len(self.queue) + (self.active.size if self.active else 0)


class _TableBased(Policy):
    """Shared machinery for node-level interleaving policies."""

    def __init__(self, max_batch: int = 64):
        super().__init__(max_batch=max_batch)
        self.table = BatchTable(max_batch=max_batch)

    # optional callable(top, below) -> bool restricting merges beyond the
    # structural BatchTable rule (None = paper LazyBatching: always merge)
    merge_predicate = None

    def _merge_top(self):
        """Merge the topmost entries subject to the policy's merge rule."""
        self.table.merge_top(self.merge_predicate)
        self.table.pop_if_done()

    def _admit(self, now: float):
        raise NotImplementedError

    def _select_active(self, now: float):
        """Hook: reorder the stack before dispatch (default: paper LIFO)."""

    def next_work(self, now):
        self._merge_top()
        self._admit(now)
        self._merge_top()
        self._select_active(now)
        active = self.table.active
        if active is None or active.size == 0:
            return None
        return active, self.commit_run(active)

    # does reaching ``node_id`` open a merge opportunity for this policy?
    # (LazyBatching merges at any shared node — paper §IV-B)
    def _merge_possible_at(self, wl, node_id: str) -> bool:
        return True

    def commit_run(self, sb):
        """Span to the next possible merge / preemption point.

        Static graphs keep the paper's single-node granularity (admission
        and preemption are re-evaluated at every layer). Cyclic graphs
        commit at most one *segment* — a run ends at every segment-final
        node (the prefill/decode boundary and each decode cycle's last
        node), the iteration-level points where admission, preemption, and
        SLA slack are re-checked, so the slack burned by a committed run is
        bounded by one prefill segment or one decode cycle (inside the
        predictor's dec_timesteps overprovision) — and always stops
        *before* the node the stack entry directly below is parked at,
        where a catch-up merge could fire.
        """
        wl = sb.live_requests[0].workload
        if wl.cycle_end_id() is None:
            return (sb.node_id,)
        stop_before = set()
        stack = self.table.stack
        if len(stack) >= 2:
            below = stack[-2]
            if (below.size
                    and below.live_requests[0].workload is wl
                    and self._merge_possible_at(wl, below.node_id)):
                stop_before.add(below.node_id)
        return sb.run_nodes(stop_before=stop_before,
                            stop_after=wl.commit_boundaries())

    def work_done(self, sb, now, n_nodes=1):
        finished = sb.advance_n(n_nodes, now)
        self._merge_top()
        return finished

    def _evict_batched(self, gone):
        for sb in self.table.stack:
            sb.requests = [r for r in sb.requests if r.rid not in gone]
        self.table._drop_empty()

    @property
    def admitted_requests(self):
        return self.table.all_requests()

    @property
    def outstanding(self):
        return len(self.queue) + self.table.total_size


class CellularBatching(_TableBased):
    name = "cellular"

    @staticmethod
    def merge_predicate(top, below):
        # application-specific baseline: merges permitted only at
        # weight-shared *cell* nodes [Gao et al.]
        wl = top.live_requests[0].workload
        return wl.nodes[top.node_id].cell

    def _merge_possible_at(self, wl, node_id):
        return wl.nodes[node_id].cell

    def _admit(self, now):
        # iteration-level scheduling: admit new requests unconditionally at
        # node boundaries (no SLA model); capacity- and memory-bounded
        room = self.max_batch - self.table.total_size
        mem = self._mem_room()
        if mem is not None:
            room = min(room, mem)
        if room <= 0 or not self.queue:
            return
        take = min(room, len(self.queue))
        reqs = [self.queue.popleft() for _ in range(take)]
        for r in reqs:
            r.t_first_issue = now
        for group in _group_pushable(reqs):
            self.table.push(group)


class LazyBatching(_TableBased):
    """The paper's SLA-aware node-level batching system."""
    name = "lazyb"

    def __init__(self, predictor: SlackPredictor, max_batch: int = 64):
        super().__init__(max_batch=max_batch)
        self.predictor = predictor
        self.n_preemptions = 0
        self.n_rejections = 0

    def request_finished(self, reqs):
        # evict the predictor's per-request memo entries (unbounded growth
        # otherwise: every (rid, idx) ever evaluated stayed cached)
        forget = getattr(self.predictor, "forget", None)
        if forget is not None:
            for r in reqs:
                forget(r.rid)

    def _select_active(self, now):
        """Paper LIFO preserved: the newest entry must run so it can catch
        up and merge (urgency-first dispatch was tried and REFUTED — it
        breaks the catch-up mechanism and serialized everything; see
        EXPERIMENTS.md §Paper-validation co-location notes). Only
        exception: an entry whose slack has gone negative while a
        *different-model* entry is on top gets promoted once — bounded
        anti-starvation for co-location, unreachable in single-model
        serving."""
        stack = self.table.stack
        if len(stack) < 2:
            return
        top_wl = stack[-1].live_requests[0].workload
        for i in range(len(stack) - 1):
            sb = stack[i]
            if sb.live_requests[0].workload is top_wl:
                continue
            slack = min(self.predictor.slack(r, [r], now)
                        for r in sb.live_requests)
            if slack < 0.0:
                stack.append(stack.pop(i))
                self.n_preemptions += 1
                return

    def _edf_take(self, candidates: List[Request], k: int) -> List[Request]:
        """The ``k`` earliest-absolute-deadline candidates (arrival + the
        request's own SLA-class deadline). ``nsmallest`` is stable, so with
        a single class (constant deadline) this is exactly the FIFO prefix;
        O(n log k) instead of a full sort."""
        return heapq.nsmallest(
            k, candidates, key=lambda r: r.arrival + self.predictor.deadline(r))

    def _take_from_queue(self, reqs: List[Request], now: float) -> None:
        """Remove ``reqs`` from the InfQ in one pass and stamp first issue."""
        taken = {r.rid for r in reqs}
        self.queue = deque(r for r in self.queue if r.rid not in taken)
        for r in reqs:
            r.t_first_issue = now

    def _admit(self, now):
        if not self.queue:
            return
        # memory-aware mode (session-wired gate): never admit more new
        # requests than free KV slots — the overflow defers in the InfQ
        # (burning slack exactly like any other wait, so EDF order still
        # decides who gets a slot when one frees) instead of overcommitting
        # device memory. Gate unset = the paper's memory-blind admission.
        mem = self._mem_room()
        ongoing = self.table.all_requests()
        if not ongoing:
            # idle processor: schedule immediately (no batching conflict);
            # earliest-absolute-deadline first when the backlog exceeds
            # max_batch (== FIFO for a single SLA class)
            cap = self.max_batch if mem is None else min(self.max_batch, mem)
            if cap <= 0:
                return
            reqs = self._edf_take(self.queue, cap)
            self._take_from_queue(reqs, now)
            for group in _group_pushable(reqs):
                self.table.push(group)
            return
        room = self.max_batch - len(ongoing)
        if mem is not None:
            room = min(room, mem)
        if room <= 0:
            return
        # largest authorized deadline-ordered prefix (adding requests only
        # shrinks slack, so feasibility is monotone in the prefix length):
        # earliest-deadline-first across mixed tiers, identical to FIFO when
        # every request shares the global target. Under co-location the
        # prefix is drawn from the head request's model only: admitting a
        # same-model group preserves merge opportunities, while interleaving
        # models per admission only deepens the stack (§VI-C).
        head_wl = self.queue[0].workload
        candidates = [r for r in self.queue if r.workload is head_wl]
        pending = self._edf_take(candidates, min(room, len(candidates)))
        # Cross-model preemption has no merge upside (sub-batches of
        # different models never share a node): only preempt for a foreign
        # model when its head is more urgent than every ongoing request —
        # otherwise it waits its turn in the InfQ (beyond-paper refinement
        # of §VI-C co-location; no effect on single-model serving).
        if pending and all(r.workload is not head_wl for r in ongoing):
            head_urgency = self.predictor.slack(pending[0], [pending[0]], now)
            ongoing_urgency = min(self.predictor.slack(r, [r], now)
                                  for r in ongoing)
            # defer only while the head can still afford to wait — under
            # heavy load its slack burns down and it gets admitted, so no
            # model can head-of-line-block the others
            if head_urgency > max(ongoing_urgency, 0.0):
                self.n_rejections += 1
                return
        while pending:
            if self.predictor.authorize(ongoing, pending, now):
                break
            pending = pending[:-1]
        if not pending:
            self.n_rejections += 1
            return
        self._take_from_queue(pending, now)
        self.n_preemptions += 1
        for group in _group_pushable(pending):
            self.table.push(group)


class Oracle(LazyBatching):
    """LazyBatching driven by oracular latency knowledge (paper §VI)."""
    name = "oracle"
