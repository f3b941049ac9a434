"""Copied from serenedb_tpu/server/frontdoor.py (less a history note's
change number).

The front door: one asyncio event loop owning the sockets for BOTH
protocols.

Reference analog: the reference serves pgwire and HTTP/ES from one
asio+coroutine IO layer (PAPER.md §2.2 network/server layer) — idle
connections cost a suspended coroutine, not an OS thread, and overload
is shed at the SOCKET before it consumes engine resources. This module
is that layer for serenedb_tpu:

- **HTTP/ES on asyncio streams** — keep-alive, pipelining, chunked
  request bodies. The route table is the same pure request→response
  `Router` the legacy ThreadingHTTPServer uses (server/http_server.py),
  so frontdoor-on/off results are bit-identical by construction. The
  engine boundary stays synchronous: each request's route runs on the
  shared executor via `run_in_executor` (the pgwire session pool when
  pgwire is hosted here, so both protocols draw on ONE bounded pool).
- **pgwire on the same loop/lifecycle** — `PgServer` was already
  asyncio (the TLS backport, server/pgwire.py); hosting it here gives
  both protocols one loop, one executor, one ordered shutdown.
- **Socket-level admission** (sched/governor.py `ConnectionGate`) —
  `serene_max_connections` caps open sockets across both protocols;
  past it, a pgwire client gets a clean 53300 ErrorResponse and an
  HTTP client a 429 + Retry-After BEFORE any byte of the session is
  parsed. The statement governor still arbitrates what the
  admitted connections may run — two gates, one backpressure story.
- **Per-connection in-flight cap** — requests on one connection are
  strictly serialized: the next pipelined request is not even read
  until the current response has fully drained, so one firehose client
  holds at most one executor slot (concurrency comes from connections,
  which the accept gate bounds).
- **Slow-writer backpressure** — responses are written in chunks;
  past the `serene_conn_write_high_kb` transport high-water mark the
  session calls `transport.pause_reading()` and blocks in `drain()`
  until the client catches up, so a stalled reader never buffers
  unbounded result bytes.
- **Idle reaping** — `serene_idle_conn_timeout_s` bounds how long a
  connection may sit sending nothing (half-open clients, abandoned
  keep-alives) before its socket and admission slot are reclaimed.
- **Deterministic shutdown** — `stop()` closes listeners, cancels
  idle sessions, lets in-flight responses drain (bounded), then joins
  the loop thread and the executor with no silent leak — the fix for
  the legacy tier's join(timeout=10)-and-forget.

Embedding: `HttpServer` (server/http_server.py) constructs a
FrontDoor per `serene_frontdoor` and runs it threaded via
`start()`/`stop()`; serened runs `start_async()`/`stop_async()` inline
on the process's main loop with pgwire hosted alongside.
"""

from __future__ import annotations

import asyncio
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.client import responses as _http_reasons
from typing import Optional

from ..engine import Database
from ..sched.governor import CONNGATE
from ..utils import log, metrics
from ..utils.config import REGISTRY as _settings
from .es_api import EsApi
from .http_server import Router

#: bytes written to the transport per chunk between drain checks —
#: bounds the per-write buffer spike on top of the high-water mark
_WRITE_CHUNK = 64 * 1024

#: headers per request / bytes per header line an h1 peer may send
_MAX_HEADERS = 100


class _BadRequest(Exception):
    """Malformed HTTP/1.x framing: answered with a 400 and a close."""


def _idle_timeout() -> Optional[float]:
    t = float(_settings.get_global("serene_idle_conn_timeout_s") or 0.0)
    return t if t > 0 else None


def _write_high_water() -> int:
    return int(_settings.get_global("serene_conn_write_high_kb")) * 1024


async def _read_request(reader: asyncio.StreamReader,
                        timeout: Optional[float]):
    """One HTTP/1.x request off the stream: (method, target, headers,
    body, keep_alive), or None on a clean EOF between requests. Only
    the FIRST readline carries the idle timeout — once a request has
    started arriving the connection is active, not idle."""
    if timeout:
        line = await asyncio.wait_for(reader.readline(), timeout)
    else:
        line = await reader.readline()
    if not line:
        return None
    try:
        method, target, version = line.decode("latin-1").strip().split(" ", 2)
    except ValueError:
        raise _BadRequest("malformed request line")
    if not version.startswith("HTTP/1."):
        raise _BadRequest(f"unsupported protocol [{version}]")
    headers: dict[str, str] = {}
    for _ in range(_MAX_HEADERS):
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    else:
        raise _BadRequest("too many headers")
    conn_tok = headers.get("connection", "").lower()
    keep_alive = (version == "HTTP/1.1" and conn_tok != "close") or \
        (version == "HTTP/1.0" and conn_tok == "keep-alive")
    if headers.get("transfer-encoding", "").lower() == "chunked":
        body = bytearray()
        while True:
            size_line = await reader.readline()
            try:
                size = int(size_line.split(b";")[0].strip() or b"0", 16)
            except ValueError:
                raise _BadRequest("malformed chunk size")
            if size == 0:
                while True:       # trailers until the blank line
                    t = await reader.readline()
                    if t in (b"\r\n", b"\n", b""):
                        break
                break
            body += await reader.readexactly(size)
            await reader.readexactly(2)   # the chunk's trailing CRLF
        body = bytes(body)
    else:
        ln = int(headers.get("content-length") or 0)
        body = await reader.readexactly(ln) if ln else b""
    return method, target, headers, body, keep_alive


class FrontDoor:
    """One event loop, both protocols, connections as tasks."""

    def __init__(self, db: Database, host: str = "127.0.0.1",
                 http_port: int = 0, pg=None, drain_s: float = 5.0):
        self.db = db
        self.host = host
        self.router = Router(EsApi(db))
        #: optional PgServer hosted on this loop (serened); its session
        #: pool becomes the shared engine-boundary executor
        self.pg = pg
        self.drain_s = drain_s
        if pg is not None:
            self.executor = pg.pool
            self._owns_executor = False
        else:
            import os
            self.executor = ThreadPoolExecutor(
                max_workers=max(4, (os.cpu_count() or 4)),
                thread_name_prefix="serene-frontdoor-exec")
            self._owns_executor = True
        # pre-bind so .port is known at construction (the legacy
        # HttpServer contract); asyncio adopts the socket in start_async
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, http_port))
        self._sock.setblocking(False)
        self.port = self._sock.getsockname()[1]
        self._server: Optional[asyncio.AbstractServer] = None
        self._sessions: dict[asyncio.Task, object] = {}
        self._draining = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_event: Optional[asyncio.Event] = None
        self._ready = threading.Event()
        self._startup_error: Optional[BaseException] = None

    # -- lifecycle (async core) -------------------------------------------

    async def start_async(self):
        self._loop = asyncio.get_running_loop()
        self._draining = False
        self._server = await asyncio.start_server(
            self._on_http_conn, sock=self._sock, backlog=2048)
        log.info("http", f"front door listening on port {self.port} "
                 "(asyncio tier)")
        if self.pg is not None:
            await self.pg.start()

    async def stop_async(self):
        """Graceful drain, then deterministic teardown: stop accepting,
        reap idle sessions now, give in-flight responses `drain_s` to
        finish, hard-cancel stragglers, and await every session task —
        nothing outlives this call on the loop."""
        self._draining = True
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        # idle keep-alive sessions are parked in a read — cancel them
        # now; active ones get to finish their current response
        for task, info in list(self._sessions.items()):
            if info is None or getattr(info, "state", "") == "idle":
                task.cancel()
        pending = [t for t in self._sessions if not t.done()]
        if pending:
            done, pending = await asyncio.wait(
                pending, timeout=self.drain_s)
            for t in pending:
                t.cancel()
            if pending:
                await asyncio.wait(pending, timeout=self.drain_s)
        self._sessions.clear()
        if self.pg is not None:
            await self.pg.stop()

    # -- lifecycle (threaded embedding) -----------------------------------

    def start(self):
        """Run the loop on a dedicated thread (test/embedded mode);
        returns once the listeners are live."""
        self._ready.clear()
        self._startup_error = None
        self._thread = threading.Thread(
            target=self._thread_main, name="serene-frontdoor", daemon=True)
        self._thread.start()
        self._ready.wait(timeout=30)
        if self._startup_error is not None:
            err, self._startup_error = self._startup_error, None
            self._thread.join(timeout=10)
            raise err

    def _thread_main(self):
        async def main():
            self._stop_event = asyncio.Event()
            try:
                await self.start_async()
            except BaseException as e:  # noqa: BLE001 — report to start()
                self._startup_error = e
                self._ready.set()
                return
            self._ready.set()
            await self._stop_event.wait()
            await self.stop_async()
        asyncio.run(main())

    def stop(self):
        """Deterministic shutdown from sync code: signal the loop, join
        the thread, join the executor. Raises instead of silently
        leaking a thread (the legacy tier's failure mode)."""
        if self._thread is None:
            self._sock.close()
            if self._owns_executor:
                self.executor.shutdown(wait=True)
            return
        if self._loop is not None and self._stop_event is not None:
            self._loop.call_soon_threadsafe(self._stop_event.set)
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            raise RuntimeError(
                "frontdoor loop thread failed to stop within 30s")
        self._thread = None
        if self._owns_executor:
            self.executor.shutdown(wait=True)

    # -- HTTP sessions -----------------------------------------------------

    def _on_http_conn(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        # sync accept callback: stamp NOW, so the gap to the session
        # task's first step measures the event-loop accept backlog
        accept_ns = time.monotonic_ns()
        task = asyncio.get_running_loop().create_task(
            self._http_session(reader, writer, accept_ns))
        self._sessions[task] = None
        task.add_done_callback(self._sessions.pop)

    async def _http_session(self, reader, writer, accept_ns: int):
        transport = writer.transport
        peer = writer.get_extra_info("peername")
        info = CONNGATE.try_admit("http", peer, accept_ns)
        if info is None:
            # rejected at the accept gate: answer 429 without having
            # read — let alone parsed — a single request byte
            writer.write(
                b"HTTP/1.1 429 Too Many Requests\r\n"
                b"Content-Type: application/json\r\n"
                b"Content-Length: 102\r\n"
                b"Retry-After: 1\r\nConnection: close\r\n\r\n"
                b'{"error": {"type": "too_many_connections", "reason": '
                b'"serene_max_connections reached"}, "status": 429}')
            await self._close(writer)
            return
        task = asyncio.current_task()
        if task in self._sessions:
            self._sessions[task] = info
        info.buffered = transport.get_write_buffer_size
        transport.set_write_buffer_limits(high=_write_high_water())
        loop = asyncio.get_running_loop()
        try:
            while not self._draining:
                CONNGATE.set_state(info, "idle")
                req = await _read_request(reader, _idle_timeout())
                if req is None:
                    break
                CONNGATE.set_state(info, "active")
                method, target, _headers, body, keep_alive = req
                # one request in flight per connection: the route runs
                # on the executor while this task — the connection's
                # only reader — awaits it, then fully drains the
                # response before reading the next pipelined request
                with metrics.HTTP_CONNECTIONS.scoped():
                    status, data, ctype = await loop.run_in_executor(
                        self.executor, self.router.handle,
                        method, target, body)
                    await self._write_response(
                        writer, status, data, ctype, keep_alive)
                if not keep_alive:
                    break
        except asyncio.TimeoutError:
            log.debug("http", "idle connection reaped "
                      "(serene_idle_conn_timeout_s)")
        except _BadRequest as e:
            try:
                await self._write_response(
                    writer, 400, encode_error(str(e)),
                    "application/json", False)
            except (ConnectionResetError, RuntimeError):
                pass
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError, ValueError):
            pass        # peer vanished / overlong header line
        except asyncio.CancelledError:
            pass        # drain-time reap: close and release below
        finally:
            CONNGATE.release(info)
            await self._close(writer)

    async def _write_response(self, writer: asyncio.StreamWriter,
                              status: int, data: bytes, ctype: str,
                              keep_alive: bool):
        reason = _http_reasons.get(status, "Unknown")
        head = (f"HTTP/1.1 {status} {reason}\r\n"
                f"Server: serenedb-tpu/0.1\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(data)}\r\n"
                "X-Elastic-Product: Elasticsearch\r\n"
                + ("" if keep_alive else "Connection: close\r\n")
                + "\r\n").encode("latin-1")
        payload = memoryview(head + data)
        transport = writer.transport
        high = _write_high_water()
        for off in range(0, len(payload), _WRITE_CHUNK):
            writer.write(bytes(payload[off:off + _WRITE_CHUNK]))
            if transport.get_write_buffer_size() >= high:
                # slow reader: stop reading THIS connection until the
                # client drains us below the low-water mark — result
                # bytes stay bounded no matter how stalled the peer is
                paused = False
                try:
                    if transport.is_reading():
                        transport.pause_reading()
                        paused = True
                        CONNGATE.note_pause()
                except (AttributeError, RuntimeError):
                    pass
                try:
                    await writer.drain()
                finally:
                    if paused and not transport.is_closing():
                        transport.resume_reading()
        await writer.drain()

    @staticmethod
    async def _close(writer: asyncio.StreamWriter):
        try:
            writer.close()
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError, RuntimeError):
            pass


def encode_error(reason: str) -> bytes:
    import json
    return json.dumps({"error": {"type": "bad_request",
                                 "reason": reason}, "status": 400}).encode()
