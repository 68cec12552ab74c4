"""GatewayApp: routes, request lifecycle, and graceful shutdown.

The gateway is a single-threaded asyncio application around one
:class:`~repro.serving.gateway.bridge.SessionDriver`:

  * ``POST /v1/generate`` — submit one request, stream its tokens back
    as SSE (``token`` events, then ``done`` or ``error``). The JSON body
    selects ``model``, ``sla_class``/``deadline``, ``prompt_len``/
    ``decode_len`` (sampled from the model's workload when omitted) and
    ``shed_priority`` (defaults to the model's registered priority —
    used by the bounded-ingress door, see middleware).
  * ``GET /metrics`` — Prometheus text exposition (gauges re-sampled at
    scrape time).
  * ``GET /healthz`` — liveness (always 200 while the process runs).
  * ``GET /readyz`` — readiness: 200 only once serving and not
    draining, so load generators and orchestrators can gate on it.

Shutdown (SIGTERM/SIGINT) is a *drain*, not an abort: stop accepting,
flip ``/readyz`` to 503, run ``session.drain()`` so every admitted
request reaches a terminal fate (handlers observe their ``end`` events
and finish their streams), then report the drained stats and leak
check in a final ``drain`` log record.
"""
from __future__ import annotations

import asyncio
import signal
from typing import Dict, Optional, Set

from . import http
from .bridge import EV_END, EV_TOKEN, SessionDriver
from .middleware import (RETRYABLE_STATUSES, Backpressure, TimeoutBudget,
                         status_for_state)
from .sanitizer import LoopStallSanitizer
from .telemetry import AccessLog, GatewayMetrics, request_id

#: Status used for client-closed-request accounting (log-only; never
#: sent on the wire — the client is gone).
CLIENT_CLOSED = 499


class GatewayApp:
    """One serving gateway: HTTP front-end + driver + middleware."""

    def __init__(self, session, *, host: str = "127.0.0.1",
                 port: int = 0, time_scale: float = 1.0,
                 tick: float = 0.002,
                 request_timeout: Optional[float] = None,
                 max_inflight: Optional[int] = None,
                 metrics_log_interval: Optional[float] = None,
                 default_sla: Optional[float] = None,
                 deadline_by_class: Optional[Dict[str, float]] = None,
                 seed: int = 0, drain_grace: float = 5.0,
                 stall_interval: float = 0.005,
                 stall_threshold: float = 0.25,
                 log_stream=None, log_enabled: bool = True):
        self.session = session
        self.host = host
        # written once more in start() (ephemeral-port resolution),
        # before any handler can exist — the startup path is the only
        # writer, so the read-bind-write span there cannot interleave
        self.port = port                     # reprolint: owner=startup
        self.request_timeout = request_timeout
        self.drain_grace = drain_grace
        self.deadline_by_class = dict(deadline_by_class or {})
        self.access_log = AccessLog(stream=log_stream, enabled=log_enabled)
        self.metrics = GatewayMetrics(
            default_sla=default_sla,
            deadline_by_class=self.deadline_by_class)
        self.driver = SessionDriver(
            session, time_scale=time_scale, tick=tick,
            metrics=self.metrics, access_log=self.access_log,
            metrics_log_interval=metrics_log_interval, seed=seed)
        self.backpressure = Backpressure(self.driver,
                                         max_inflight=max_inflight)
        self.sanitizer = LoopStallSanitizer(interval=stall_interval,
                                            threshold=stall_threshold)
        self.ready = False
        self.draining = False
        self.drained_stats = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._handlers: Set[asyncio.Task] = set()
        self._shutdown = asyncio.Event()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    async def start(self) -> None:
        self.driver.start()
        self.sanitizer.start()
        self._pump_task = asyncio.create_task(self.driver.pump())
        self._server = await asyncio.start_server(
            self._on_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self.ready = True
        self.access_log.emit("ready", host=self.host, port=self.port,
                             models=[e.name for e in
                                     self.session.registry.entries()])

    def request_shutdown(self) -> None:
        self._shutdown.set()

    def install_signal_handlers(self) -> None:
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, self.request_shutdown)

    async def run(self) -> None:
        """Serve until a shutdown request, then drain."""
        await self.start()
        self.install_signal_handlers()
        await self._shutdown.wait()
        await self.drain()

    async def drain(self):
        """Graceful shutdown: refuse new work, run everything admitted
        to a terminal fate, let handlers flush, report."""
        self.draining = True
        self.ready = False
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        stats = self.driver.drain()          # pushes every end event
        if self._handlers:
            await asyncio.wait(set(self._handlers),
                               timeout=self.drain_grace)
        if self._pump_task is not None:
            # cancel-and-reap: absorb the CancelledError we caused so
            # the pump cannot outlive the drain or die unobserved; the
            # handle is swapped out BEFORE the suspension so the
            # shared field never spans the await
            pump, self._pump_task = self._pump_task, None
            pump.cancel()
            try:
                await pump
            except asyncio.CancelledError:
                pass
        await self.sanitizer.stop()
        self.drained_stats = stats
        mem = self.session.backend.memory_stats()
        self.access_log.emit(
            "drain", completed=self.driver.completed,
            outstanding=self.driver.inflight,
            slots_live=mem.slots_live,
            loop=self.sanitizer.stats.as_dict(),
            summary=stats.summary())
        return stats

    # ------------------------------------------------------------------
    # connection handling
    # ------------------------------------------------------------------
    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._handlers.add(task)
        try:
            await self._serve_one(reader, writer)
        except ConnectionError:
            pass                             # peer vanished mid-response
        finally:
            self._handlers.discard(task)
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass

    async def _serve_one(self, reader, writer) -> None:
        try:
            req = await http.read_request(reader)
        except http.BadRequest as exc:
            await http.send_json(writer, 400, {"error": str(exc)})
            return
        if req is None:                      # EOF before any request
            return
        route = (req.method, req.path)
        if route == ("GET", "/healthz"):
            await http.send_json(writer, 200, {"status": "ok"})
        elif route == ("GET", "/readyz"):
            if self.ready and not self.draining:
                await http.send_json(writer, 200, {"status": "ready"})
            else:
                await http.send_json(
                    writer, 503,
                    {"status": "draining" if self.draining
                     else "starting"})
        elif route == ("GET", "/metrics"):
            self.metrics.sample_session(self.session)
            self.metrics.sample_loop(self.sanitizer)
            body = self.metrics.expose().encode("utf-8")
            await http.send_response(
                writer, 200, body,
                content_type="text/plain; version=0.0.4; charset=utf-8")
        elif route == ("POST", "/v1/generate"):
            await self._generate(req, reader, writer)
        elif req.path in ("/healthz", "/readyz", "/metrics",
                          "/v1/generate"):
            await http.send_json(writer, 405,
                                 {"error": f"{req.method} not allowed"})
        else:
            await http.send_json(writer, 404,
                                 {"error": f"no route {req.path}"})

    # ------------------------------------------------------------------
    # POST /v1/generate
    # ------------------------------------------------------------------
    def _parse_generate(self, req: http.Request) -> dict:
        body = req.json()
        model = body.get("model")
        entries = {e.name: e for e in self.session.registry.entries()}
        if len(entries) == 1 and model is None:
            model = next(iter(entries))
        if model not in entries:
            raise http.BadRequest(
                f"unknown model {model!r}; serving "
                f"{sorted(entries)}")
        sla_class = body.get("sla_class", "default")
        if not isinstance(sla_class, str) or not sla_class:
            raise http.BadRequest("sla_class must be a non-empty string")
        deadline = body.get("deadline", self.deadline_by_class.get(
            sla_class))
        if deadline is not None:
            deadline = float(deadline)
            if deadline <= 0:
                raise http.BadRequest("deadline must be positive")
        elif sla_class != "default":
            raise http.BadRequest(
                f"unknown SLA class {sla_class!r} and no deadline given")
        out = {"model": model, "sla_class": sla_class,
               "deadline": deadline,
               "shed_priority": body.get("shed_priority",
                                         entries[model].shed_priority)}
        for field in ("prompt_len", "decode_len"):
            value = body.get(field)
            if value is not None:
                value = int(value)
                if not 0 <= value <= 100_000:
                    raise http.BadRequest(
                        f"{field} out of range: {value}")
            out[field] = value
        if not isinstance(out["shed_priority"], int):
            raise http.BadRequest("shed_priority must be an integer")
        return out

    async def _generate(self, req, reader, writer) -> None:
        rid = request_id()
        loop = asyncio.get_running_loop()
        t_wall = loop.time()
        model = sla_class = "?"
        status = 500
        fate = None
        tokens_sent = 0
        try:
            params = self._parse_generate(req)
        except http.BadRequest as exc:
            await http.send_json(writer, 400, {"error": str(exc)},
                                 extra_headers=[("x-request-id", rid)])
            self._log_http(rid, req, 400, model, sla_class, fate, 0,
                           None, t_wall)
            return
        model, sla_class = params["model"], params["sla_class"]
        if self.draining or not self.ready:
            await http.send_json(writer, 503, {"error": "draining"},
                                 extra_headers=[("x-request-id", rid),
                                                ("retry-after", "1")])
            self._finish_http(rid, req, 503, model, sla_class, "draining",
                              0, None, t_wall)
            return
        hint = self.backpressure.check(model, params["shed_priority"])
        if hint is not None:
            await http.send_json(
                writer, 429,
                {"error": "gateway at capacity", "retry_after": hint},
                extra_headers=[("x-request-id", rid),
                               ("retry-after", f"{hint:.3f}")])
            self._finish_http(rid, req, 429, model, sla_class,
                              "backpressure", 0, None, t_wall)
            return
        try:
            gr = self.driver.submit(
                rid, model, sla_class=sla_class,
                deadline=params["deadline"],
                prompt_len=params["prompt_len"],
                decode_len=params["decode_len"])
        except ValueError as exc:
            await http.send_json(writer, 400, {"error": str(exc)},
                                 extra_headers=[("x-request-id", rid)])
            self._finish_http(rid, req, 400, model, sla_class, None, 0,
                              None, t_wall)
            return
        budget = (TimeoutBudget(loop.time, self.request_timeout)
                  if self.request_timeout is not None else None)
        gone, watcher = http.watch_disconnect(reader)
        sse = http.SSEStream(writer)
        get_task: Optional[asyncio.Task] = None
        gone_task = asyncio.create_task(gone.wait())
        try:
            while True:
                timeout = budget.remaining() if budget else None
                if timeout is not None and timeout <= 0:
                    status, fate = await self._on_timeout(gr, sse, rid)
                    break
                if get_task is None:
                    get_task = asyncio.create_task(gr.events.get())
                done, _ = await asyncio.wait(
                    {get_task, gone_task}, timeout=timeout,
                    return_when=asyncio.FIRST_COMPLETED)
                if not done:                         # timed out
                    status, fate = await self._on_timeout(gr, sse, rid)
                    break
                if gone_task in done and get_task not in done:
                    gr.cancel()
                    status, fate = CLIENT_CLOSED, "client_disconnect"
                    break
                event, payload = get_task.result()
                get_task = None
                if event == EV_TOKEN:
                    if not sse.started:
                        await sse.start([("x-request-id", rid)])
                    await sse.send("token",
                                   {"i": tokens_sent, "token": payload})
                    tokens_sent += 1
                    continue
                if event == EV_END:
                    status, fate = await self._on_end(
                        gr, payload, sse, rid, tokens_sent)
                    break
        except ConnectionError:
            gr.cancel()
            status, fate = CLIENT_CLOSED, "write_failed"
        finally:
            # cancel-and-reap every helper task: an unreaped cancel
            # leaves the task pending past the handler (drain cannot
            # find it) and its exceptions are never observed
            reap = [watcher, gone_task]
            if get_task is not None:
                reap.append(get_task)
            for t in reap:
                t.cancel()
            await asyncio.gather(*reap, return_exceptions=True)
        self._finish_http(rid, req, status, model, sla_class, fate,
                          tokens_sent, gr, t_wall)

    async def _on_timeout(self, gr, sse, rid):
        """Per-request wall-clock budget exhausted: cancel (frees the
        KV slot) and report 408 — in-band if the stream already began."""
        gr.cancel()
        if sse.started:
            await self._try_send(sse, "error",
                                 {"status": 408, "fate": "timeout"})
        else:
            await http.send_json(sse.writer, 408,
                                 {"error": "request timeout"},
                                 extra_headers=[("x-request-id", rid)])
        return 408, "timeout"

    async def _on_end(self, gr, state, sse, rid, tokens_sent):
        fate = state.value
        status = status_for_state(state)
        handle = gr.handle
        summary = {"fate": fate, "tokens": len(handle.tokens),
                   "latency_s": handle.latency, "ttft_s": handle.ttft}
        if status == 200:
            if not sse.started:
                await sse.start([("x-request-id", rid)])
            await self._try_send(sse, "done", summary)
        elif sse.started:                    # status line already sent
            await self._try_send(sse, "error",
                                 {"status": status, **summary})
        else:
            headers = [("x-request-id", rid)]
            if status in RETRYABLE_STATUSES:
                hint = self.backpressure._hint(self.driver.inflight + 1)
                headers.append(("retry-after", f"{hint:.3f}"))
            await http.send_json(sse.writer, status,
                                 {"error": fate, **summary},
                                 extra_headers=headers)
        return status, fate

    async def _try_send(self, sse, event, payload) -> None:
        try:
            await sse.send(event, payload)
        except ConnectionError:
            pass                             # peer left during the final event

    # ------------------------------------------------------------------
    # logging
    # ------------------------------------------------------------------
    def _finish_http(self, rid, req, status, model, sla_class, fate,
                     tokens_sent, gr, t_wall) -> None:
        self.metrics.observe_http(model, sla_class, status,
                                  n_tokens=tokens_sent)
        self._log_http(rid, req, status, model, sla_class, fate,
                       tokens_sent, gr, t_wall)

    def _log_http(self, rid, req, status, model, sla_class, fate,
                  tokens_sent, gr, t_wall) -> None:
        loop = asyncio.get_running_loop()
        fields = {
            "id": rid, "method": req.method, "path": req.path,
            "status": status, "model": model, "sla_class": sla_class,
            "wall_ms": round((loop.time() - t_wall) * 1e3, 3),
            "tokens": tokens_sent,
        }
        if fate is not None:
            fields["fate"] = fate
        if gr is not None and gr.handle.done:
            if gr.handle.latency is not None:
                fields["latency_ms"] = round(gr.handle.latency * 1e3, 3)
            if gr.handle.ttft is not None:
                fields["ttft_ms"] = round(gr.handle.ttft * 1e3, 3)
        self.access_log.emit("http", **fields)
