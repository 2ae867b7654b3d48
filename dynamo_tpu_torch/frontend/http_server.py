"""A minimal HTTP/1.1 server on `asyncio.start_server` for the OpenAI
frontend (the GPU machine has no `aiohttp`).

What it speaks: a request line, headers, a ``Content-Length`` body (no
chunked request bodies: 411), keep-alive (HTTP/1.1 unless ``Connection:
close``), unary responses with a ``Content-Length`` and streamed
responses in chunked transfer encoding (the SSE streams).  Routes are
exact (method, path) pairs; an unknown path answers 404, a known path with
another method 405, a body over `max_body` bytes 413, a handler exception
500.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Awaitable, Callable, Dict, Optional, Tuple, Union
from urllib.parse import urlsplit

logger = logging.getLogger(__name__)

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 411: "Length Required",
            413: "Payload Too Large", 429: "Too Many Requests",
            500: "Internal Server Error", 501: "Not Implemented",
            502: "Bad Gateway", 503: "Service Unavailable"}
MAX_BODY = 1 << 20  # aiohttp's default client_max_size
_MAX_HEADERS = 100


class Request:
    def __init__(self, method: str, target: str, version: str,
                 headers: Dict[str, str], body: bytes,
                 writer: asyncio.StreamWriter):
        self.method = method
        self.path = urlsplit(target).path
        self.version = version
        self.headers = headers  # lower-cased names
        self.body = body
        self._writer = writer

    async def json(self):
        """The body as JSON; raises `json.JSONDecodeError` when it is not."""
        return json.loads(self.body or b"")

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"


def _head(status: int, headers: Dict[str, str]) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class Response:
    """A unary response: status, headers and the whole body."""

    def __init__(self, body: bytes = b"", status: int = 200,
                 content_type: str = "text/plain; charset=utf-8",
                 headers: Optional[Dict[str, str]] = None):
        self.body = body
        self.status = status
        self.headers = {"Content-Type": content_type, **(headers or {})}

    def encode(self, keep_alive: bool) -> bytes:
        hdrs = {**self.headers, "Content-Length": str(len(self.body)),
                "Connection": "keep-alive" if keep_alive else "close"}
        return _head(self.status, hdrs) + self.body


def json_response(obj, status: int = 200,
                  headers: Optional[Dict[str, str]] = None) -> Response:
    return Response(json.dumps(obj).encode(), status,
                    "application/json; charset=utf-8", headers)


class StreamResponse:
    """A response written as it is produced, in chunked transfer
    encoding.  `prepare` sends the head; each `write` is one chunk;
    `write_eof` ends the body.  Writes to a closed connection raise
    `ConnectionResetError`."""

    def __init__(self, status: int = 200,
                 headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.headers = dict(headers or {})
        self._writer: Optional[asyncio.StreamWriter] = None
        self._eof = False

    async def prepare(self, request: Request) -> None:
        self._writer = request._writer  # noqa: SLF001
        self.headers["Transfer-Encoding"] = "chunked"
        self.headers.setdefault("Connection",
                                "keep-alive" if request.keep_alive else "close")
        await self._send(_head(self.status, self.headers))

    async def _send(self, data: bytes) -> None:
        w = self._writer
        if w is None or w.is_closing():
            raise ConnectionResetError("client connection closed")
        w.write(data)
        await w.drain()

    async def write(self, data: bytes) -> None:
        if data:
            await self._send(b"%x\r\n%s\r\n" % (len(data), data))

    async def write_eof(self) -> None:
        if not self._eof:
            self._eof = True
            await self._send(b"0\r\n\r\n")


Handler = Callable[[Request], Awaitable[Union[Response, StreamResponse]]]


class HttpServer:
    """Serves `routes` {(method, path): handler} on host:port (0 →
    ephemeral; `.port` holds the bound port after `start`)."""

    def __init__(self, routes: Dict[Tuple[str, str], Handler],
                 host: str = "0.0.0.0", port: int = 0, max_body: int = MAX_BODY):
        self.routes = routes
        self.host = host
        self.port = port
        self.max_body = max_body
        self._server: Optional[asyncio.base_events.Server] = None
        self._writers: set = set()

    async def start(self) -> "HttpServer":
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        # close live connections before wait_closed (py3.12 waits on them)
        for w in list(self._writers):
            w.close()
        await self._server.wait_closed()
        self._server = None

    async def _read_request(self, reader, writer) -> Optional[Request]:
        line = await reader.readline()
        if not line:
            return None
        try:
            method, target, version = line.decode("latin-1").rstrip("\r\n").split(" ")
        except ValueError:
            raise _HttpError(400, "malformed request line") from None
        headers: Dict[str, str] = {}
        for _ in range(_MAX_HEADERS + 1):
            h = (await reader.readline()).decode("latin-1").rstrip("\r\n")
            if not h:
                break
            name, _, value = h.partition(":")
            headers[name.strip().lower()] = value.strip()
        else:
            raise _HttpError(400, "too many headers")
        if "chunked" in headers.get("transfer-encoding", "").lower():
            raise _HttpError(411, "chunked request bodies are not supported")
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise _HttpError(400, "bad Content-Length") from None
        if length > self.max_body:
            raise _HttpError(413, f"body of {length} bytes exceeds {self.max_body}")
        body = await reader.readexactly(length) if length else b""
        return Request(method.upper(), target, version, headers, body, writer)

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while True:
                try:
                    req = await self._read_request(reader, writer)
                except _HttpError as e:
                    writer.write(Response(f"{e.status}: {e}".encode(), e.status)
                                 .encode(keep_alive=False))
                    await writer.drain()
                    return
                if req is None:
                    return
                resp = await self._dispatch(req)
                if isinstance(resp, StreamResponse):
                    await resp.write_eof()
                else:
                    writer.write(resp.encode(req.keep_alive))
                    await writer.drain()
                if not req.keep_alive:
                    return
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()

    async def _dispatch(self, req: Request):
        handler = self.routes.get((req.method, req.path))
        if handler is None:
            known = any(path == req.path for _, path in self.routes)
            status = 405 if known else 404
            return Response(f"{status}: {_REASONS[status]}".encode(), status)
        try:
            return await handler(req)
        except (ConnectionError, asyncio.CancelledError):
            raise
        except Exception:  # noqa: BLE001 — a handler bug answers 500
            logger.exception("handler for %s %s failed", req.method, req.path)
            return Response(b"500 Internal Server Error", 500)


class _HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
