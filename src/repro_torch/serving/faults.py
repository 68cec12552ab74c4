"""Seeded fault injection: a deterministic chaos wrapper for backends.

Real serving fleets lose dispatches — preempted device VMs, XLA OOMs
under fragmentation, straggler replicas — and an SLA-aware scheduler is
only credible if its attainment numbers survive them. The
:class:`FaultInjectingBackend` makes those failures *reproducible*: it
wraps any model-keyed :class:`~repro.serving.backend.Backend`
(``SimExecutor``, ``JaxEngine``, a ``MultiBackend`` mux) and, on each
``execute_run`` dispatch, draws ONE uniform from a per-model seeded
stream to decide among

  * **transient failure** — raises
    :class:`~repro.serving.backend.TransientBackendError` (retryable;
    the session's RetryPolicy requeues the members with backoff),
  * **injected OOM** — raises
    :class:`~repro.serving.backend.BackendOOMError` (a transient
    slot-allocation failure, also retryable),
  * **latency-spike straggler** — the run executes *correctly* but its
    reported latency (total and per-node) is multiplied by
    ``straggler_factor``: results are bit-exact, deadlines burn,
  * **normal dispatch** — delegated untouched.

Determinism: each model's stream is ``default_rng([seed, crc32(model)])``
— independent of every other model, of the session's prompt-sampling
stream, and of dict ordering; two runs with the same seed, trace, and
spec inject byte-identical fault sequences. Exactly one draw happens per
``execute_run`` whether or not any probability is nonzero, so enabling a
zero-rate spec never perturbs the sequence of a nonzero one.

Per-model specs: pass ``{model_name: FaultSpec}`` to fault only some
tenants (e.g. chaos on the bulk tier while the interactive tier stays
clean); a single :class:`FaultSpec` applies to every model.

The single-node ``execute`` path (legacy pre-run-commit servers) is
delegated without injection — the failure model is defined at run
granularity, matching the session's retry unit.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np

from .backend import (Backend, BackendOOMError, TransientBackendError)


@dataclass(frozen=True)
class FaultSpec:
    """Per-dispatch fault probabilities (disjoint bands of one uniform
    draw — their sum must not exceed 1).

    ``fault_latency`` is the device time a failed dispatch burns before
    the failure is detected (charged to the session clock via
    ``BackendError.latency`` — faults are not free retries).
    ``straggler_factor`` multiplies a straggler run's reported latency."""
    p_transient: float = 0.0
    p_oom: float = 0.0
    p_straggler: float = 0.0
    straggler_factor: float = 4.0
    fault_latency: float = 0.0

    def __post_init__(self):
        probs = (self.p_transient, self.p_oom, self.p_straggler)
        if any(p < 0.0 for p in probs) or sum(probs) > 1.0 + 1e-12:
            raise ValueError(
                f"fault probabilities must be non-negative and sum to "
                f"<= 1: {self}")
        if self.straggler_factor < 1.0 or self.fault_latency < 0.0:
            raise ValueError(
                f"straggler_factor must be >= 1 and fault_latency >= 0: "
                f"{self}")

    @property
    def any_faults(self) -> bool:
        return (self.p_transient > 0 or self.p_oom > 0
                or self.p_straggler > 0)


def parse_fault_spec(text: str) -> FaultSpec:
    """Parse a CLI fault spec: comma-separated ``kind:value`` fields —

        ``transient:0.05,oom:0.01,straggler:0.1x8,latency:0.002``

    ``straggler`` takes an optional ``xFACTOR`` suffix (latency
    multiplier, default 4). Unknown kinds raise."""
    kw = {}
    for fld in filter(None, (f.strip() for f in text.split(","))):
        kind, sep, val = fld.partition(":")
        if not sep:
            raise ValueError(f"malformed fault spec field {fld!r} "
                             f"(expected kind:value)")
        kind = kind.strip().lower()
        if kind == "transient":
            kw["p_transient"] = float(val)
        elif kind == "oom":
            kw["p_oom"] = float(val)
        elif kind == "straggler":
            p, x, factor = val.partition("x")
            kw["p_straggler"] = float(p)
            if x:
                kw["straggler_factor"] = float(factor)
        elif kind == "latency":
            kw["fault_latency"] = float(val)
        else:
            raise ValueError(
                f"unknown fault kind {kind!r} in spec {text!r} — expected "
                f"transient / oom / straggler / latency")
    return FaultSpec(**kw)


def parse_fault_specs(text: str) -> Union[FaultSpec,
                                          Dict[str, FaultSpec]]:
    """Parse a possibly model-keyed CLI spec: either one global spec or
    ``;``-separated ``model=spec`` entries, e.g.
    ``bulk=transient:0.1;gold=straggler:0.02x6``."""
    if "=" not in text:
        return parse_fault_spec(text)
    out: Dict[str, FaultSpec] = {}
    for part in filter(None, (p.strip() for p in text.split(";"))):
        model, sep, spec = part.partition("=")
        if not sep or not model.strip():
            raise ValueError(f"malformed per-model fault spec {part!r} "
                             f"(expected model=kind:value,...)")
        out[model.strip()] = parse_fault_spec(spec)
    return out


class FaultInjectingBackend(Backend):
    """Deterministic chaos wrapper around any model-keyed backend."""

    def __init__(self, inner: Backend,
                 spec: Union[FaultSpec, Dict[str, FaultSpec]],
                 *, seed: int = 0):
        self.inner = inner
        self._spec = spec
        self._seed = seed
        self._rngs: Dict[str, np.random.Generator] = {}
        # injected-fault counters per model (observability + tests)
        self.counts: Dict[str, Dict[str, int]] = {}

    def spec_for(self, model: str) -> Optional[FaultSpec]:
        if isinstance(self._spec, FaultSpec):
            return self._spec
        return self._spec.get(model)

    def _rng(self, model: str) -> np.random.Generator:
        rng = self._rngs.get(model)
        if rng is None:
            # crc32 keys the stream on the model NAME, so the sequence is
            # independent of registration order and of other models
            rng = np.random.default_rng(
                [self._seed, zlib.crc32(model.encode("utf-8"))])
            self._rngs[model] = rng
        return rng

    def _count(self, model: str, kind: str):
        per = self.counts.setdefault(
            model, {"draws": 0, "transient": 0, "oom": 0, "straggler": 0})
        per[kind] += 1

    def fault_stats(self) -> Dict[str, Dict[str, int]]:
        """Injected-fault counters: model -> {draws, transient, oom,
        straggler}."""
        return {m: dict(per) for m, per in self.counts.items()}

    # ------------------------------------------------------------------
    def execute_run(self, model, sb, node_ids):
        spec = self.spec_for(model)
        if spec is None or not spec.any_faults:
            return self.inner.execute_run(model, sb, node_ids)
        self._count(model, "draws")
        u = float(self._rng(model).random())
        if u < spec.p_transient:
            self._count(model, "transient")
            raise TransientBackendError(
                f"injected transient fault on {model!r} run "
                f"{node_ids[0]}..{node_ids[-1]} "
                f"(batch={sb.size}, u={u:.4f})",
                latency=spec.fault_latency)
        if u < spec.p_transient + spec.p_oom:
            self._count(model, "oom")
            raise BackendOOMError(
                f"injected slot-allocation OOM on {model!r} run "
                f"{node_ids[0]}..{node_ids[-1]} "
                f"(batch={sb.size}, u={u:.4f})",
                latency=spec.fault_latency)
        latency, per_node = self.inner.execute_run(model, sb, node_ids)
        if u > 1.0 - spec.p_straggler:
            # straggler: correct results, inflated device time
            self._count(model, "straggler")
            f = spec.straggler_factor
            latency = latency * f
            if per_node is not None:
                per_node = [l * f for l in per_node]
        return latency, per_node

    # -- pure delegation: the wrapper is transparent everywhere else ----
    def prepare(self, model, req, rng, prompt_tokens=None):
        return self.inner.prepare(model, req, rng,
                                  prompt_tokens=prompt_tokens)

    def execute(self, model, sb, node_id):
        return self.inner.execute(model, sb, node_id)

    def on_finished(self, model, reqs):
        return self.inner.on_finished(model, reqs)

    def reset_request(self, model, req):
        return self.inner.reset_request(model, req)

    def release_request(self, model, req):
        return self.inner.release_request(model, req)

    def token_count(self, model, req):
        return self.inner.token_count(model, req)

    def tokens(self, model, req):
        return self.inner.tokens(model, req)

    def memory_stats(self, model=None):
        return self.inner.memory_stats(model)

    def sanitizer_stats(self, model=None):
        return self.inner.sanitizer_stats(model)
