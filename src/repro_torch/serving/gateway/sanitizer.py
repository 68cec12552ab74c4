"""Event-loop stall watchdog: the runtime mirror of blocking-in-async.

The static checker proves no *known* blocking primitive is reachable
from the gateway's async surface; this sanitizer catches everything the
checker cannot see — a slow C extension, an accidental O(n^2) pass over
the backlog, a pump tick whose sanctioned ``run_until`` catch-up grows
past its budget. The technique is the classic asyncio watchdog: a task
that sleeps a short ``interval`` and measures how late the loop woke it
up. Overshoot beyond the interval is *callback latency* — some callback
(ours or a peer task's) held the loop that long — so the maximum
overshoot bounds the worst stall any concurrently-running handler
observed.

Counters follow the ``SanitizerStats`` idiom from the JAX engine
(cheap monotone counts, scraped not pushed): ``ticks`` probes taken,
``stalls`` probes whose lag exceeded ``threshold``, ``max_lag_s`` the
worst observed lag, and a bounded recent-lag window for the p99 gauge.
``GatewayMetrics.sample_loop`` mirrors them into ``/metrics`` at scrape
time and the gateway CI smoke asserts ``stalls == 0`` under load
(``--assert-no-stall``).
"""
from __future__ import annotations

import asyncio
from collections import deque
from typing import Optional


class LoopStallStats:
    """Monotone stall counters plus a bounded recent-lag window."""

    __slots__ = ("ticks", "stalls", "max_lag_s", "recent")

    def __init__(self, window: int = 2048):
        self.ticks = 0
        self.stalls = 0
        self.max_lag_s = 0.0
        self.recent: deque = deque(maxlen=window)

    def observe(self, lag_s: float, threshold_s: float) -> None:
        self.ticks += 1
        self.recent.append(lag_s)
        if lag_s > self.max_lag_s:
            self.max_lag_s = lag_s
        if lag_s > threshold_s:
            self.stalls += 1

    def lag_p99_s(self) -> float:
        if not self.recent:
            return 0.0
        ordered = sorted(self.recent)
        return ordered[min(len(ordered) - 1,
                           int(0.99 * (len(ordered) - 1) + 0.5))]

    def as_dict(self) -> dict:
        return {"ticks": self.ticks, "stalls": self.stalls,
                "max_lag_s": round(self.max_lag_s, 6),
                "lag_p99_s": round(self.lag_p99_s(), 6)}


class LoopStallSanitizer:
    """Watchdog task measuring event-loop callback latency.

    ``interval`` is the probe period (wall seconds — small enough to
    catch stalls between pump ticks, large enough to cost nothing);
    ``threshold`` is the lag above which a probe counts as a *stall*.
    The defaults (5 ms probe, 250 ms threshold) flag anything that
    would visibly freeze concurrent SSE streams while ignoring
    scheduler jitter under load.
    """

    def __init__(self, *, interval: float = 0.005,
                 threshold: float = 0.25, window: int = 2048):
        if interval <= 0 or threshold <= 0:
            raise ValueError(
                f"interval and threshold must be positive "
                f"(got {interval}, {threshold})")
        self.interval = interval
        self.threshold = threshold
        self.stats = LoopStallStats(window)
        self._task: Optional[asyncio.Task] = None
        self._stopping = False

    # ------------------------------------------------------------------
    async def _watch(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stopping:
            before = loop.time()
            await asyncio.sleep(self.interval)
            lag = loop.time() - before - self.interval
            self.stats.observe(max(0.0, lag), self.threshold)

    def start(self) -> None:
        """Spawn the watchdog on the running loop (idempotent)."""
        if self._task is None or self._task.done():
            self._stopping = False
            self._task = asyncio.create_task(self._watch())

    async def stop(self) -> None:
        """Cancel the watchdog and reap it."""
        self._stopping = True
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass                         # reaping our own cancel
