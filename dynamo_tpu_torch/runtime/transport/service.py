"""Service transport: direct TCP request → response-stream between processes.

The port's copy of the JAX package's `runtime/transport/service.py`: the
client holds a pooled, multiplexed TCP connection straight to the worker
and runs request + response stream over one socket, with per-stream
CANCEL (graceful) / KILL control frames and an error prologue.  Same frames
as the JAX package, so a JAX frontend can route to a port worker.  The
trace-context headers and the chaos gate of the JAX module are left out.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from typing import Any, AsyncIterator, Callable

from ..engine import Context
from .wire import (
    Frame,
    K_CANCEL,
    K_DATA,
    K_END,
    K_ERR,
    K_KILL,
    K_PING,
    K_PONG,
    K_REQ,
    pack,
    read_frame,
    unpack,
)

logger = logging.getLogger(__name__)

# handler(request, context) -> async iterator of msgpack-able responses
Handler = Callable[[Any, Context], AsyncIterator[Any]]


class ServiceServer:
    """Worker-side TCP server hosting named endpoint handlers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._handlers: dict[str, Handler] = {}
        self._server: asyncio.Server | None = None
        self._inflight: dict[tuple[int, int], tuple[asyncio.Task, Context]] = {}
        self._conn_ids = itertools.count(1)
        self._writers: set[asyncio.StreamWriter] = set()
        self.draining = False

    def register(self, endpoint: str, handler: Handler) -> None:
        self._handlers[endpoint] = handler

    def unregister(self, endpoint: str) -> None:
        self._handlers.pop(endpoint, None)

    async def start(self) -> "ServiceServer":
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def inflight_count(self) -> int:
        return len(self._inflight)

    async def stop(self) -> None:
        if self._server:
            self._server.close()
        for task, ctx in list(self._inflight.values()):
            ctx.kill()
            task.cancel()
        # Force-close connections before wait_closed (py3.12 waits on handlers).
        for writer in list(self._writers):
            try:
                writer.close()
            except OSError:  # close on an already-dead socket
                pass
        if self._server:
            await self._server.wait_closed()

    async def drain(self, timeout: float = 30.0) -> None:
        """Graceful shutdown: refuse new work, wait for in-flight streams."""
        self.draining = True
        deadline = asyncio.get_running_loop().time() + timeout
        while self._inflight and asyncio.get_running_loop().time() < deadline:
            await asyncio.sleep(0.05)

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        conn_id = next(self._conn_ids)
        self._writers.add(writer)
        send_lock = asyncio.Lock()

        async def send(frame: Frame) -> None:
            async with send_lock:
                try:
                    writer.write(frame.encode())
                    await writer.drain()
                except (ConnectionError, RuntimeError):
                    pass

        try:
            while True:
                frame = await read_frame(reader)
                key = (conn_id, frame.stream_id)
                if frame.kind == K_REQ:
                    if self.draining:
                        await send(Frame(K_ERR, frame.stream_id,
                                         {"code": "draining"},
                                         pack({"message": "worker draining"})))
                        continue
                    endpoint = frame.header.get("endpoint", "")
                    handler = self._handlers.get(endpoint)
                    if handler is None:
                        await send(Frame(K_ERR, frame.stream_id,
                                         {"code": "no_endpoint"},
                                         pack({"message": f"no endpoint {endpoint!r}"})))
                        continue
                    ctx = Context(frame.header.get("rid") or None)
                    task = asyncio.create_task(
                        self._run_stream(send, frame, handler, ctx, key)
                    )
                    self._inflight[key] = (task, ctx)
                elif frame.kind == K_CANCEL:
                    entry = self._inflight.get(key)
                    if entry:
                        entry[1].stop_generating()
                elif frame.kind == K_KILL:
                    entry = self._inflight.get(key)
                    if entry:
                        entry[1].kill()
                        entry[0].cancel()
                elif frame.kind == K_PING:
                    await send(Frame(K_PONG, frame.stream_id, {}, b""))
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            # Client connection dropped: kill everything it had in flight
            # (reference: http disconnect -> context.kill, disconnect.rs).
            for key in [k for k in self._inflight if k[0] == conn_id]:
                task, ctx = self._inflight.pop(key)
                ctx.kill()
                task.cancel()
            self._writers.discard(writer)
            writer.close()

    async def _run_stream(self, send, req_frame: Frame, handler: Handler,
                          ctx: Context, key) -> None:
        sid = req_frame.stream_id
        try:
            request = unpack(req_frame.payload)
            async for item in handler(request, ctx):
                if ctx.is_killed():
                    break
                await send(Frame(K_DATA, sid, {}, pack(item)))
            await send(Frame(K_END, sid, {}, b""))
        except asyncio.CancelledError:
            pass
        except Exception as e:  # noqa: BLE001 — stream errors go to the client
            logger.exception("handler error on stream %d", sid)
            await send(Frame(K_ERR, sid, {"code": "handler"}, pack({"message": str(e)})))
        finally:
            self._inflight.pop(key, None)


class ServiceUnavailable(Exception):
    """Worker refused (draining) or unreachable — retryable on another
    instance (drives request migration)."""


class Overloaded(ServiceUnavailable):
    """Deliberate load shedding (every candidate worker is busy) — NOT
    retryable: the frontend answers 503 at once, and the instance is not
    cooled down (a healthy worker that sheds is not a lost one)."""


class RemoteStreamError(Exception):
    """The remote handler raised mid-stream."""


class _Conn:
    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        self.streams: dict[int, asyncio.Queue] = {}
        self.ids = itertools.count(1)
        self.send_lock = asyncio.Lock()
        self.recv_task: asyncio.Task | None = None
        self.broken = False


class ServiceClient:
    """Client-side connection pool; one multiplexed connection per address."""

    def __init__(self):
        self._conns: dict[str, _Conn] = {}
        self._locks: dict[str, asyncio.Lock] = {}

    async def close(self) -> None:
        for conn in self._conns.values():
            if conn.recv_task:
                conn.recv_task.cancel()
            conn.writer.close()
        self._conns.clear()

    async def _get_conn(self, address: str) -> _Conn:
        lock = self._locks.setdefault(address, asyncio.Lock())
        async with lock:
            conn = self._conns.get(address)
            if conn and not conn.broken:
                return conn
            if conn is not None:
                # Replacing a broken connection: release its socket.
                if conn.recv_task:
                    conn.recv_task.cancel()
                try:
                    conn.writer.close()
                except OSError:  # close on an already-dead socket
                    pass
            host, port = address.rsplit(":", 1)
            try:
                reader, writer = await asyncio.open_connection(host, int(port))
            except OSError as e:
                raise ServiceUnavailable(f"connect {address}: {e}") from e
            conn = _Conn(reader, writer)
            conn.recv_task = asyncio.create_task(self._recv_loop(conn))
            self._conns[address] = conn
            return conn

    async def _recv_loop(self, conn: _Conn) -> None:
        try:
            while True:
                frame = await read_frame(conn.reader)
                q = conn.streams.get(frame.stream_id)
                if q is not None:
                    await q.put(frame)
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            conn.broken = True
            for q in conn.streams.values():
                await q.put(None)

    async def call_stream(
        self,
        address: str,
        endpoint: str,
        request: Any,
        context: Context | None = None,
    ) -> AsyncIterator[Any]:
        """Send a request; yield response items until the end sentinel.
        Cancelling `context` sends CANCEL (graceful) / KILL to the worker."""
        conn = await self._get_conn(address)
        sid = next(conn.ids)
        q: asyncio.Queue = asyncio.Queue()
        conn.streams[sid] = q
        ctx = context or Context()

        frame = Frame(K_REQ, sid, {"endpoint": endpoint, "rid": ctx.id},
                      pack(request))
        async with conn.send_lock:
            try:
                conn.writer.write(frame.encode())
                await conn.writer.drain()
            except (ConnectionError, RuntimeError) as e:
                conn.broken = True
                conn.streams.pop(sid, None)
                raise ServiceUnavailable(f"send to {address}: {e}") from e

        watcher = asyncio.create_task(self._watch_cancel(conn, sid, ctx))
        finished = False
        try:
            first = True
            while True:
                item = await q.get()
                if item is None:
                    finished = True
                    raise ServiceUnavailable(f"connection to {address} lost mid-stream")
                if item.kind == K_DATA:
                    first = False
                    yield unpack(item.payload)
                elif item.kind == K_END:
                    finished = True
                    return
                elif item.kind == K_ERR:
                    finished = True
                    msg = unpack(item.payload).get("message", "remote error")
                    code = item.header.get("code", "")
                    if first and code in ("draining", "no_endpoint"):
                        raise ServiceUnavailable(msg)
                    raise RemoteStreamError(msg)
        finally:
            watcher.cancel()
            conn.streams.pop(sid, None)
            if not finished and not conn.broken:
                # Stream abandoned (break / GC / exception upstream): tell the
                # worker to stop generating — mirrors the reference's
                # disconnect -> kill semantics (http/service/disconnect.rs).
                try:
                    async with conn.send_lock:
                        conn.writer.write(Frame(K_KILL, sid, {}, b"").encode())
                        await conn.writer.drain()
                except (ConnectionError, RuntimeError):
                    pass

    async def _watch_cancel(self, conn: _Conn, sid: int, ctx: Context) -> None:
        try:
            await ctx.stopped()
            kind = K_KILL if ctx.is_killed() else K_CANCEL
            async with conn.send_lock:
                conn.writer.write(Frame(kind, sid, {}, b"").encode())
                await conn.writer.drain()
        except (asyncio.CancelledError, ConnectionError, RuntimeError):
            pass
