"""SessionDriver: the audited wall-clock <-> session-clock bridge.

This module is the ONE place where wall time meets the serving core's
session clock, and it is declared an audited wall-clock boundary in the
reprolint scope config (``repro.analysis.base.WALLCLOCK_AUDITED_PREFIXES``
covers ``repro/serving/gateway/``): pacing SSE streams, Retry-After
hints, and request timeouts are inherently wall-clock concerns, while
everything at or below :class:`~repro.serving.session.ServingSession`
stays on the virtual/event clock. The bridge rule:

  * **wall -> session, one direction, one mapping.** The driver anchors
    the event-loop clock at :meth:`start` and maps elapsed wall time to
    a session-clock *target*: ``target = (loop.time() - t0) *
    time_scale``. Each pump tick calls ``session.run_until(target)`` —
    the scheduler executes every run that starts at or before the
    target and the session clock never runs ahead of the mapping (sim
    runs are instantaneous in wall time). Under the JAX engine the
    session clock is itself wall-measured run latency, so the same loop
    simply keeps idle time honest between dispatches.
  * **session values never flow back into wall-clock arithmetic** except
    for display/logging — deadlines, latencies, and attainment are all
    judged on the session clock exactly as in offline replay, so a
    gateway run at ``time_scale=50`` reports the same SLA numbers the
    simulator would.

``time_scale`` compresses wall time for the sim backend (50x means one
wall second carries 50 virtual seconds of traffic — tests and CI smokes
use this); the JAX engine should run at 1.0 (its run latencies are real
seconds already).
"""
from __future__ import annotations

import asyncio
import zlib
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ...core.request import Request, SLAClass
from ..session import RequestHandle, ServingSession

#: Stream-event kinds put on a GatewayRequest's queue.
EV_TOKEN = "token"
EV_END = "end"


class GatewayRequest:
    """One in-flight gateway exchange: the session handle plus the
    asyncio queue its HTTP handler consumes stream events from."""

    def __init__(self, request_id: str, model: str, sla_class: str,
                 handle: RequestHandle):
        self.request_id = request_id
        self.model = model
        self.sla_class = sla_class
        self.handle = handle
        self.events: asyncio.Queue = asyncio.Queue()

    @property
    def rid(self) -> int:
        return self.handle.request.rid

    def cancel(self) -> bool:
        return self.handle.cancel()


class SessionDriver:
    """Owns the ServingSession inside the gateway's event loop: paces
    the session clock against the wall, submits HTTP-originated
    requests, streams their tokens out, and finalizes terminal handles.

    Single-threaded by construction — every method runs on the event
    loop thread, interleaved with the HTTP handlers, so no locking is
    needed around session state (the session is not thread-safe and
    never needs to be here).
    """

    def __init__(self, session: ServingSession, *,
                 time_scale: float = 1.0, tick: float = 0.002,
                 metrics=None, access_log=None,
                 metrics_log_interval: Optional[float] = None,
                 seed: int = 0, rate_window: float = 5.0):
        if time_scale <= 0 or tick <= 0:
            raise ValueError(
                f"time_scale and tick must be positive "
                f"(got {time_scale}, {tick})")
        self.session = session
        self.time_scale = time_scale
        self.tick = tick
        self.metrics = metrics
        self.access_log = access_log
        self.metrics_log_interval = metrics_log_interval
        self.seed = seed
        self.rate_window = rate_window
        # single-writer fields: only the pump task's synchronous
        # advance/finalize path mutates these (handlers read them via
        # the admission views) — declared so await-atomicity spans on
        # them are sanctioned file-wide
        self.active: Dict[int, GatewayRequest] = {}  # reprolint: owner=pump
        self.completed = 0                   # reprolint: owner=pump
        self._t0: Optional[float] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stopping = False               # reprolint: owner=pump
        self._done_stamps: deque = deque()   # reprolint: owner=pump
        self._length_rngs: Dict[str, np.random.Generator] = {}
        self._sla_classes: Dict[str, SLAClass] = {}
        self._last_metrics_log = 0.0         # reprolint: owner=pump

    # ------------------------------------------------------------------
    # clock mapping
    # ------------------------------------------------------------------
    def start(self) -> None:
        """Anchor the wall clock and wire the session's run-boundary
        feed. Must be called from inside the running event loop."""
        self._loop = asyncio.get_running_loop()
        self._t0 = self._loop.time()
        self._last_metrics_log = self._t0
        if self.metrics is not None:
            self.session.on_run_boundary = self.metrics.on_run_boundary

    def wall(self) -> float:
        if self._loop is None:
            raise RuntimeError("SessionDriver.start() was never called")
        return self._loop.time()

    def target(self) -> float:
        """Session-clock target for the current wall instant."""
        return (self.wall() - self._t0) * self.time_scale

    # ------------------------------------------------------------------
    # pump
    # ------------------------------------------------------------------
    def advance(self) -> None:
        """Advance the session to the current wall-mapped target and
        finalize any handles that went terminal."""
        # AUDITED loop-blocking seed: the pump tick's catch-up is the
        # one sanctioned place scheduler work runs on the event loop —
        # bounded by the tick budget (per-tick targets advance by
        # tick * time_scale), and the stall watchdog enforces the
        # budget at runtime. Every transitive caller (pump, submit's
        # mini-tick, GatewayApp.drain) is sanctioned through this seed.
        self.session.run_until(self.target())  # reprolint: disable=blocking-in-async
        self._finalize()
        if self.metrics is not None:
            self.metrics.inflight.set(len(self.active))

    async def pump(self) -> None:
        """Background pacing task: advance every ``tick`` wall seconds
        until :meth:`stop`; emits the periodic metrics log line."""
        while not self._stopping:
            self.advance()
            self._maybe_log_metrics()
            await asyncio.sleep(self.tick)

    def stop(self) -> None:
        self._stopping = True

    def _maybe_log_metrics(self) -> None:
        if (self.metrics_log_interval is None or self.metrics is None
                or self.access_log is None):
            return
        now = self.wall()
        if now - self._last_metrics_log >= self.metrics_log_interval:
            self._last_metrics_log = now
            self.metrics.sample_session(self.session)
            self.access_log.emit("metrics", **self.metrics.snapshot())

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def sla_class_for(self, name: str,
                      deadline: Optional[float]) -> Optional[SLAClass]:
        """Session SLAClass for a tier name (memoized so every request
        of a tier shares one instance). ``default`` with no explicit
        deadline means "no per-request class" — the policy predictor's
        global target applies."""
        if name == "default" and deadline is None:
            return None
        if deadline is None:
            raise ValueError(f"SLA class {name!r} has no deadline")
        cls = self._sla_classes.get(name)
        if cls is None:
            cls = SLAClass(name=name, deadline=deadline)
            self._sla_classes[name] = cls
        return cls

    def _length_rng(self, model: str) -> np.random.Generator:
        rng = self._length_rngs.get(model)
        if rng is None:
            # per-model stream, independent of cross-model interleaving
            rng = np.random.default_rng(
                [self.seed, zlib.crc32(model.encode()), 0x1E46])
            self._length_rngs[model] = rng
        return rng

    def submit(self, request_id: str, model: str, *,
               sla_class: str = "default",
               deadline: Optional[float] = None,
               prompt_len: Optional[int] = None,
               decode_len: Optional[int] = None) -> GatewayRequest:
        """Build a Request for ``model``'s workload and submit it at the
        current session-clock instant. Unspecified lengths are sampled
        from the workload's own distributions (per-model seeded
        streams, so one tenant's traffic never perturbs another's)."""
        entry = self.session.registry[model]
        wl = entry.workload
        if wl is None:
            raise ValueError(
                f"model {model!r} was registered without a workload — "
                f"the gateway cannot build request sequences for it")
        rng = self._length_rng(model)
        p = (int(prompt_len) if prompt_len is not None
             else (wl.prompt_dist.sample(rng) if wl.prompt_dist else 0))
        d = (int(decode_len) if decode_len is not None
             else (wl.decode_dist.sample(rng) if wl.decode_dist else 0))
        seq, prefix_len, cycle_len = wl.build_sequence(p, d)
        if not seq:
            raise ValueError(
                f"empty request sequence for model {model!r} "
                f"(prompt_len={p}, decode_len={d})")
        self.advance()                       # session clock == wall target
        req = Request(workload=wl, arrival=self.session.now, sequence=seq,
                      sla=self.sla_class_for(sla_class, deadline))
        req.prompt_len = p
        req.decode_len = d
        req.prefix_len = prefix_len
        req.cycle_len = cycle_len
        gr_box: List[GatewayRequest] = []

        def _on_token(handle, token):
            gr_box[0].events.put_nowait((EV_TOKEN, token))

        handle = self.session.submit(req, model=model, on_token=_on_token)
        gr = GatewayRequest(request_id, model, sla_class, handle)
        gr_box.append(gr)
        if handle.done:                      # REJECTED at admission
            self._finish(gr)
        else:
            self.active[req.rid] = gr
        return gr

    # ------------------------------------------------------------------
    # finalization
    # ------------------------------------------------------------------
    def _finalize(self) -> None:
        done = [gr for gr in self.active.values() if gr.handle.done]
        for gr in done:
            del self.active[gr.rid]
            self._finish(gr)

    def _finish(self, gr: GatewayRequest) -> None:
        handle = gr.handle
        fate = handle.state.value
        if fate == "done":
            self.completed += 1
            self._done_stamps.append(self.wall())
        if self.metrics is not None:
            self.metrics.observe_outcome(
                gr.model, gr.sla_class, fate,
                latency_s=handle.latency, ttft_s=handle.ttft,
                n_tokens=len(handle.tokens))
        gr.events.put_nowait((EV_END, handle.state))

    # ------------------------------------------------------------------
    # admission-support views (used by the Backpressure middleware)
    # ------------------------------------------------------------------
    @property
    def inflight(self) -> int:
        return len(self.active)

    def protected_priority(self) -> int:
        return self.session._protected_priority()

    def mem_room(self, model: str) -> Optional[int]:
        """Free-slot admission room for ``model`` under memory-aware
        admission (None = unbounded pool)."""
        if not self.session.memory_aware:
            return None
        return self.session._mem_room(self.session.registry[model])

    def completion_rate(self) -> float:
        """Completions per wall second over the trailing window."""
        if self._loop is None:
            return 0.0
        now = self.wall()
        while self._done_stamps and self._done_stamps[0] < now - self.rate_window:
            self._done_stamps.popleft()
        if not self._done_stamps:
            return 0.0
        return len(self._done_stamps) / self.rate_window

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------
    def drain(self):
        """Run everything outstanding to completion (virtual fast-forward
        — pacing no longer applies during shutdown) and finalize every
        remaining handle. Returns the drained ServeStats."""
        self.stop()
        # AUDITED loop-blocking seed: shutdown fast-forward — pacing
        # (and loop liveness for new work) no longer applies; the
        # server socket is already closed when GatewayApp calls this.
        stats = self.session.drain()  # reprolint: disable=blocking-in-async
        self._finalize()
        if self.metrics is not None:
            self.metrics.sample_session(self.session)
            self.metrics.inflight.set(len(self.active))
        return stats
