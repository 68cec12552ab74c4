"""Cross-model SLA arbitration for co-located serving (paper §VI-C).

Batching happens *within* a model — batch tables are per-graph, and
sub-batches of different models never merge — but the accelerator is one:
when several registered models have a committed run ready, something must
decide whose run dispatches next. That decision is the *arbiter*, the one
scheduling layer that sits above the per-model policies:

  * :class:`RoundRobinArbiter` — the GraphBatching-style baseline: cycle
    through the registered models in registration order, skipping models
    with nothing ready. SLA-blind, starvation-free.
  * :class:`LeastSlackArbiter` — the LazyBatching-style SLA-aware arbiter:
    dispatch the model whose most urgent live request has the least
    predicted slack (its policy's conservative slack predictor, Eq. 2);
    models whose policy carries no predictor are ranked by earliest
    absolute deadline (``arrival + per-request/default SLA``), the EDF
    degeneration. Ties break on earliest arrival (FIFO across models),
    then registration order — no model can starve: a parked model's slack
    and absolute deadline both decay monotonically while it waits, so it
    eventually ranks first.

An arbiter sees *candidates*: ``(entry, sub_batch, run)`` triples, one per
registered model whose policy returned work this scheduling step, where
``entry`` is the session's :class:`~repro.serving.registry.ModelEntry`
(exposing ``name``, ``policy``, and registration ``index``). ``pick``
returns the index of the candidate to dispatch. With a single registered
model the session never consults the arbiter, so single-model serving is
bit-identical to the pre-registry sessions regardless of arbiter choice.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

_INF = float("inf")

# (entry, sub_batch, committed run) — entry is a registry ModelEntry
Candidate = Tuple[object, object, Tuple[str, ...]]


class Arbiter:
    """Picks which model's committed run dispatches next.

    ``mem_shares``: optional per-model **device-memory shares** for
    bounded-memory serving — ``{"gold": 0.5, "bulk": 0.5}`` caps each
    model's admitted-resident KV slots at its fraction of the pool's
    ``max_slots``, so one bulk tenant can never starve an interactive
    tenant of slots. The session's memory-aware admission consults
    :meth:`mem_share` (an explicit ``register(mem_share=...)`` on the
    model entry takes precedence); models without a share draw freely
    from the unreserved pool. Ignored when the backend reports no memory
    cap.
    """

    name = "abstract"

    def __init__(self, mem_shares: Optional[Dict[str, float]] = None):
        # real errors, not asserts: a silently-constructed oversubscribed
        # share map under ``python -O`` would quietly void the
        # anti-starvation guarantee
        if mem_shares is not None:
            if not all(0.0 < s <= 1.0 for s in mem_shares.values()):
                raise ValueError(
                    f"memory shares must lie in (0, 1]: {mem_shares}")
            if sum(mem_shares.values()) > 1.0 + 1e-9:
                raise ValueError(
                    f"memory shares oversubscribe the pool: {mem_shares}")
        self.mem_shares = dict(mem_shares) if mem_shares else None

    def mem_share(self, model: str) -> Optional[float]:
        """The fraction of the memory pool reserved-as-cap for ``model``
        (None = uncapped: the model draws from the shared pool)."""
        return None if self.mem_shares is None else self.mem_shares.get(model)

    def pick(self, candidates: List[Candidate], now: float) -> int:
        raise NotImplementedError


class RoundRobinArbiter(Arbiter):
    """Baseline: rotate through registered models in registration order,
    skipping models with no ready work (the per-model GraphBatching
    deployment the paper compares against: fair device shares, no SLA
    awareness)."""

    name = "rr"

    def __init__(self, mem_shares: Optional[Dict[str, float]] = None):
        super().__init__(mem_shares=mem_shares)
        self._last = -1          # registration index of the last dispatch

    def pick(self, candidates, now):
        # exact cyclic order without a modulus: candidates past the last
        # dispatched index come first (ascending), wrapped ones after
        best = min(range(len(candidates)),
                   key=lambda i: (candidates[i][0].index <= self._last,
                                  candidates[i][0].index))
        self._last = candidates[best][0].index
        return best


class LeastSlackArbiter(Arbiter):
    """SLA-aware arbitration: least predicted slack across models.

    A candidate's urgency is the minimum over its sub-batch's live
    requests of the model policy's conservative slack estimate
    (``predictor.slack(r, [r], now)`` — Eq. 2 with the request alone, the
    same quantity LazyBatching's anti-starvation promotion uses). When the
    policy has no slack predictor the request's time-to-absolute-deadline
    (``arrival + deadline - now``) stands in — slack minus remaining
    execution time degenerates to EDF ordering. Requests with neither an
    SLA class nor a ``sla_default`` rank last (infinite slack).
    """

    name = "least-slack"

    def __init__(self, sla_default: Optional[float] = None,
                 mem_shares: Optional[Dict[str, float]] = None):
        super().__init__(mem_shares=mem_shares)
        self.sla_default = sla_default

    def _urgency(self, entry, sb, now: float):
        pred = getattr(entry.policy, "predictor", None)
        best_u = best_arr = _INF
        for r in sb.live_requests:
            if pred is not None:
                u = pred.slack(r, [r], now)
            else:
                d = r.sla.deadline if r.sla is not None else self.sla_default
                u = (r.arrival + d - now) if d is not None else _INF
            best_u = min(best_u, u)
            best_arr = min(best_arr, r.arrival)
        return best_u, best_arr

    def pick(self, candidates, now):
        keys = [self._urgency(e, sb, now) + (e.index,)
                for (e, sb, _run) in candidates]
        return min(range(len(candidates)), key=keys.__getitem__)


ARBITERS = {
    RoundRobinArbiter.name: RoundRobinArbiter,
    LeastSlackArbiter.name: LeastSlackArbiter,
}
