"""SLA-aware slack time prediction (paper §IV-C, Eq. 1-2, Algorithm 1).

    Slack_r = SLA_r - (T_wait_r + Σ_{i in batch} SingleInputExecTime_i)

Deliberately conservative: the latency of a batch is overestimated as the
*sum* of its members' isolated single-batch latencies, so estimated slack
shrinks and SLA violations are minimized first, throughput second.

``SLA_r`` is *per request*: a request carrying an :class:`~repro.core.
request.SLAClass` is judged against its own class deadline; requests
without one fall back to the predictor's global ``sla_target`` (the
paper's single frozen scalar), so single-tier behavior is unchanged while
mixed-tier traces get per-tier admission control.

SingleInputExecTime_i comes from the profiled per-node latency lookup table
(``NodeLatency(n)``); dynamic graphs are overprovisioned with
``dec_timesteps`` = the N-% quantile of the output-length distribution
(default N = 90%, paper Fig. 11).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

from .request import Request

# memoized single-exec entries across ALL live requests before a panic
# clear (a backstop only: entries are evicted per request on completion)
_MEMO_CAP = 100_000


class _PredictorBase:
    """Shared predictor scaffolding: the per-request deadline rule and the
    per-rid memo — one dict of entries per live request, evicted wholesale
    via :meth:`forget` when the request finishes (wired through
    ``Policy.request_finished``), with a global-size panic clear as a leak
    backstop."""

    _memo_cap = _MEMO_CAP

    def deadline(self, req: Request) -> float:
        """The deadline ``req`` is judged against: its own SLA class when
        it carries one, else the predictor's global target."""
        return self.sla_target if req.sla is None else req.sla.deadline

    def _memo_get(self, rid: int) -> Dict:
        per = self._memo.get(rid)
        if per is None:
            if self._memo_n > self._memo_cap:     # leak backstop
                self._memo.clear()
                self._memo_n = 0
            per = self._memo[rid] = {}
        return per

    def forget(self, rid: int) -> None:
        """Drop all memoized entries of a finished request."""
        per = self._memo.pop(rid, None)
        if per is not None:
            self._memo_n -= len(per)

    def release_bound(self, ongoing: Iterable["Request"]) -> float:
        """Lower-bound-style estimate of how long until the earliest KV
        slot frees: the smallest remaining single-input execution time
        among the resident requests (0 when none are resident). Used by
        memory-aware admission control to decide whether a request whose
        model's memory pool is exhausted could still get a slot before
        its own deadline — the same Eq. 1 per-request quantities the
        slack bound is built from, so rejection stays exactly as
        conservative as the paper's admission."""
        times = [self.single_remaining(r) for r in ongoing]
        return min(times) if times else 0.0

    @property
    def memo_size(self) -> int:
        return sum(len(per) for per in self._memo.values())


@dataclass
class SlackPredictor(_PredictorBase):
    sla_target: float
    # per-workload-name profiled node latency tables (single-batch)
    tables: Dict[str, Dict[str, float]]
    # per-workload-name dec_timesteps (quantile of decode-length profile)
    dec_timesteps: Dict[str, int]
    coverage: float = 0.90
    # per-rid memo of single_remaining values: {rid: {idx: seconds}} —
    # evicted via forget(rid) when the request finishes
    _memo: Dict[int, Dict] = field(default_factory=dict, init=False,
                                   repr=False, compare=False)
    _memo_n: int = field(default=0, init=False, repr=False, compare=False)

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, workloads, perf_model, sla_target: float,
              coverage: float = 0.90) -> "SlackPredictor":
        tables, dect = {}, {}
        for wl in workloads:
            tables[wl.name] = perf_model.profile_table(wl)
            dect[wl.name] = (wl.decode_dist.quantile(coverage)
                             if wl.decode_dist else 0)
        return cls(sla_target=sla_target, tables=tables, dec_timesteps=dect,
                   coverage=coverage)

    # ------------------------------------------------------------------
    def single_remaining(self, req: Request) -> float:
        """Conservative remaining single-batch execution time (Algorithm 1).

        Memoized per (request, progress) — the scheduler evaluates the same
        requests at every admission decision."""
        per = self._memo_get(req.rid)
        if req.idx in per:
            return per[req.idx]
        wl = req.workload
        table = self.tables[wl.name]
        dec = self.dec_timesteps.get(wl.name, 0)
        val = sum(table[nid]
                  for nid, _ctx in wl.predicted_remaining_nodes(req, dec))
        per[req.idx] = val
        self._memo_n += 1
        return val

    def single_total(self, req: Request) -> float:
        """SingleInputExecTime for a request that has not started (Eq. 1)."""
        wl = req.workload
        table = self.tables[wl.name]
        dec = self.dec_timesteps.get(wl.name, 0)
        if req.cycle_len:
            prefix = sum(table[nid] for nid, _ in req.sequence[:req.prefix_len])
            cycle = sum(table[nid] for nid in wl.cycle_ids())
            return prefix + dec * cycle
        return sum(table[nid] for nid, _ in req.sequence)

    def slack(self, req: Request, group: Iterable[Request], now: float) -> float:
        """Eq. 2 slack of ``req`` if batched with ``group`` (which includes
        req itself): SLA_req - T_wait - Σ_i SingleInputExecTime_i(remaining)."""
        t_wait = now - req.arrival
        total = sum(self.single_remaining(r) for r in group)
        return self.deadline(req) - t_wait - total

    # ------------------------------------------------------------------
    def authorize(self, ongoing: List[Request], pending: List[Request],
                  now: float) -> bool:
        """Authorize lazily batching ``pending`` with ``ongoing`` iff no
        request in the merged set is predicted to violate *its own* SLA
        (§IV-C: minimize violations first, throughput second)."""
        merged = list(ongoing) + list(pending)
        total = sum(self.single_remaining(r) for r in merged)
        for r in merged:
            if self.deadline(r) - (now - r.arrival) - total < 0.0:
                return False
        return True


@dataclass
class OracleSlackPredictor(_PredictorBase):
    """Oracular slack estimation (paper §VI design point 4).

    Uses (a) the *true* unrolled sequence lengths (no dec_timesteps
    overprovision) and (b) the precise batched latency-vs-throughput curve
    of every node (the NPU model evaluated at the merged batch size) instead
    of the conservative sum-of-singles bound.
    """
    sla_target: float
    perf_model: "object"        # serving.npu_model.NPUPerfModel
    # per-rid memo: {rid: {(idx, batch): seconds}} — evicted via forget()
    _memo: Dict[int, Dict] = field(default_factory=dict, init=False,
                                   repr=False, compare=False)
    _memo_n: int = field(default=0, init=False, repr=False, compare=False)
    _memo_cap = 2 * _MEMO_CAP          # (idx, batch) keys: more per request

    def _batched_remaining(self, req: Request, batch: int) -> float:
        per = self._memo_get(req.rid)
        key = (req.idx, batch)
        if key in per:
            return per[key]
        wl = req.workload
        val = sum(self.perf_model.node_latency(wl.nodes[nid], [ctx] * batch)
                  for nid, ctx in req.sequence[req.idx:])
        per[key] = val
        self._memo_n += 1
        return val

    def single_remaining(self, req: Request) -> float:
        return self._batched_remaining(req, 1)

    # an unstarted request's total IS its remaining time (idx == 0)
    single_total = single_remaining

    def slack(self, req: Request, group, now: float) -> float:
        group = list(group)
        return (self.deadline(req) - (now - req.arrival)
                - self._batched_remaining(req, len(group)))

    def authorize(self, ongoing: List[Request], pending: List[Request],
                  now: float) -> bool:
        merged = list(ongoing) + list(pending)
        n = len(merged)
        npend = len(pending)
        # catch-up phase: the pending sub-batch executes its own remaining
        # prefix (batched at |pending|) before it can merge with the ongoing
        # entries; ongoing requests are stalled for that long.
        catch = 0.0
        if pending:
            lead = pending[0]
            stop = lead.prefix_len if lead.cycle_len else len(lead.sequence)
            catch = sum(
                self.perf_model.node_latency(
                    lead.workload.nodes[nid], [ctx] * npend)
                for nid, ctx in lead.sequence[lead.idx:stop])
        for r in ongoing:
            finish = catch + self._batched_remaining(r, n)
            if (now - r.arrival) + finish > self.deadline(r):
                return False
        for p in pending:
            if (now - p.arrival) + self._batched_remaining(p, n) > self.deadline(p):
                return False
        return True
