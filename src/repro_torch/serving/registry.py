"""The model registry: the front door for multi-tenant serving.

The paper evaluates LazyBatching on co-located DNNs sharing one NPU:
batching is per-model (batch tables are per-graph), while scheduling
arbitrates node-level work *across* the concurrently served graphs. The
:class:`ModelRegistry` is that co-location made explicit — each registered
model owns

  * a **name** (the routing key: ``submit(req, model=...)``, traffic
    tags, backend muxing, per-model stats),
  * a **workload** (its node graph / request template; optional for the
    legacy single-model sessions that infer it from submitted requests),
  * a **policy** — its own batching policy and therefore its own
    BatchTable and slack predictor; admission and merging never cross
    models.

What *is* shared is the device: one :class:`~repro.serving.backend.
Backend` (possibly a :class:`~repro.serving.backend.MultiBackend` mux)
executes every model's committed runs on one session clock, and one
cross-model :class:`~repro.core.arbiter.Arbiter` decides whose run
dispatches next.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from ..core.policies import Policy


@dataclass
class ModelEntry:
    """One registered model: name + workload + its private policy.

    ``mem_share`` caps this model's admitted-resident KV slots at a
    fraction of the backend pool's ``max_slots`` under memory-aware
    admission (``None`` = uncapped; the session falls back to the
    arbiter's ``mem_shares``). Per-model shares are what keep a bulk
    tenant from starving an interactive tenant of device memory.

    ``shed_priority`` ranks the model for graceful load shedding (higher
    = more protected): under an ingress-queue overflow or an active
    brownout, work from strictly lower-priority models is shed first.
    Ties (the default: every model at 0) shed deadline-aware instead."""
    name: str
    workload: Optional[object]          # serving.workload.Workload
    policy: Policy
    index: int                          # registration order (arbiter RR)
    mem_share: Optional[float] = None   # fraction of the pool's max_slots
    shed_priority: int = 0              # higher = protected tier

    def __repr__(self):
        wl = getattr(self.workload, "name", None)
        share = f", mem_share={self.mem_share:g}" if self.mem_share else ""
        return (f"ModelEntry({self.name!r}, workload={wl!r}, "
                f"policy={self.policy.name}{share})")


class ModelRegistry:
    """Name-keyed registry of served models, in registration order."""

    def __init__(self):
        self._entries: Dict[str, ModelEntry] = {}

    def register(self, name: str, workload=None, *, policy: Policy,
                 mem_share: Optional[float] = None,
                 shed_priority: int = 0) -> ModelEntry:
        if name in self._entries:
            raise ValueError(f"model {name!r} already registered")
        if mem_share is not None and not 0.0 < mem_share <= 1.0:
            raise ValueError(
                f"mem_share for {name!r} must lie in (0, 1]: {mem_share}")
        entry = ModelEntry(name=name, workload=workload, policy=policy,
                           index=len(self._entries), mem_share=mem_share,
                           shed_priority=shed_priority)
        self._entries[name] = entry
        return entry

    # ------------------------------------------------------------------
    def __getitem__(self, name: str) -> ModelEntry:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"model {name!r} is not registered "
                f"(registered: {sorted(self._entries) or 'none'})") from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> List[ModelEntry]:
        """All entries in registration order (dicts preserve insertion)."""
        return list(self._entries.values())

    def names(self) -> List[str]:
        return list(self._entries)
