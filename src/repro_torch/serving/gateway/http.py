"""Minimal HTTP/1.1 + SSE plumbing over stdlib asyncio streams.

Deliberately small: the gateway serves ``Connection: close`` exchanges
(one request per TCP connection) which keeps the parser to a request
line, a header block, and an optional ``Content-Length`` body — no
keep-alive state machine, no chunked *request* bodies, no TLS. SSE
responses are written straight to the stream with explicit ``drain()``
per event so a slow client exerts backpressure on its own stream only.

Client disconnects are detected two ways (both matter in practice):

  * a **reader watcher** task awaits EOF on the request's read side —
    a client that aborts mid-SSE closes its socket, which surfaces as
    EOF long before the next write would fail, and
  * **write failures** — ``ConnectionError`` from ``drain()`` when the
    peer reset.

Either path sets the returned ``gone`` event; the request handler
treats it as a cancellation signal (``handle.cancel()`` → slot freed).
"""
from __future__ import annotations

import asyncio
import json
from typing import Dict, Optional, Sequence, Tuple

from .middleware import STATUS_REASONS

#: Upper bounds keeping a misbehaving client from ballooning memory.
MAX_HEADER_BYTES = 16384
MAX_BODY_BYTES = 1 << 20


class BadRequest(Exception):
    """Malformed HTTP from the client (maps to a 400 response)."""


class Request:
    """One parsed HTTP request."""

    def __init__(self, method: str, path: str, headers: Dict[str, str],
                 body: bytes):
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body

    def json(self) -> dict:
        if not self.body:
            return {}
        try:
            payload = json.loads(self.body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as exc:
            raise BadRequest(f"invalid JSON body: {exc}") from exc
        if not isinstance(payload, dict):
            raise BadRequest("JSON body must be an object")
        return payload


async def read_request(reader: asyncio.StreamReader) -> Optional[Request]:
    """Parse one request off the stream; None on EOF before any bytes."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as exc:
        if not exc.partial:
            return None
        raise BadRequest("truncated request head") from exc
    except asyncio.LimitOverrunError as exc:
        raise BadRequest("request head too large") from exc
    if len(head) > MAX_HEADER_BYTES:
        raise BadRequest("request head too large")
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise BadRequest(f"malformed request line: {lines[0]!r}")
    method, target = parts[0].upper(), parts[1]
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            raise BadRequest(f"malformed header line: {line!r}")
        headers[name.strip().lower()] = value.strip()
    body = b""
    if "content-length" in headers:
        try:
            length = int(headers["content-length"])
        except ValueError as exc:
            raise BadRequest("bad Content-Length") from exc
        if length < 0 or length > MAX_BODY_BYTES:
            raise BadRequest(f"unacceptable Content-Length {length}")
        if length:
            try:
                body = await reader.readexactly(length)
            except asyncio.IncompleteReadError as exc:
                raise BadRequest("truncated request body") from exc
    path = target.split("?", 1)[0]
    return Request(method, path, headers, body)


def _head(status: int,
          headers: Sequence[Tuple[str, str]] = ()) -> bytes:
    reason = STATUS_REASONS.get(status, "Unknown")
    lines = [f"HTTP/1.1 {status} {reason}"]
    lines += [f"{name}: {value}" for name, value in headers]
    lines.append("connection: close")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


async def send_response(writer: asyncio.StreamWriter, status: int,
                        body: bytes = b"",
                        content_type: str = "application/json",
                        extra_headers: Sequence[Tuple[str, str]] = ()
                        ) -> None:
    headers = [("content-type", content_type),
               ("content-length", str(len(body)))]
    headers += list(extra_headers)
    writer.write(_head(status, headers) + body)
    await writer.drain()


async def send_json(writer: asyncio.StreamWriter, status: int,
                    payload: dict,
                    extra_headers: Sequence[Tuple[str, str]] = ()) -> None:
    body = (json.dumps(payload, sort_keys=True) + "\n").encode("utf-8")
    await send_response(writer, status, body,
                        extra_headers=extra_headers)


class SSEStream:
    """Server-Sent Events writer over a raw StreamWriter. Events carry a
    JSON payload; the terminal event is ``done`` (success) or ``error``
    (a non-200 fate after streaming already started — the HTTP status
    was committed at 200, so the fate rides in-band)."""

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.started = False
        self.events_sent = 0

    async def start(self, extra_headers: Sequence[Tuple[str, str]] = ()
                    ) -> None:
        headers = [("content-type", "text/event-stream"),
                   ("cache-control", "no-store")]
        headers += list(extra_headers)
        self.writer.write(_head(200, headers))
        await self.writer.drain()
        self.started = True

    async def send(self, event: str, payload: dict) -> None:
        data = json.dumps(payload, sort_keys=True)
        self.writer.write(f"event: {event}\ndata: {data}\n\n"
                          .encode("utf-8"))
        await self.writer.drain()
        self.events_sent += 1


def watch_disconnect(reader: asyncio.StreamReader
                     ) -> Tuple[asyncio.Event, asyncio.Task]:
    """Start a task that sets an event when the peer closes its write
    side (EOF on our reader). Callers must cancel the task when the
    exchange ends normally."""
    gone = asyncio.Event()

    async def _watch():
        try:
            while True:
                chunk = await reader.read(4096)
                if not chunk:
                    break
        except asyncio.CancelledError:
            raise                        # exchange ended normally
        except ConnectionError:
            pass                         # peer reset == peer gone
        gone.set()

    task = asyncio.create_task(_watch())
    return gone, task
