"""Control plane: discovery KV with leases and watches, pub/sub, durable
streams and an object store.

The port's copy of the JAX package's `runtime/transport/control_plane.py`
(the etcd + NATS analog of the reference stack):

  * **KV + leases + watch** (etcd analog): `put/get/delete/get_prefix`,
    `grant_lease/keepalive/revoke`, `watch_prefix` (PUT/DELETE events;
    keys attached to a lease vanish when it expires — the liveness
    mechanism for instance discovery).
  * **Pub/sub** (NATS core analog): `publish/subscribe` with NATS subject
    wildcards (``*`` one token, ``>`` the rest) and round-robin queue
    groups — worker load metrics for the KV router.
  * **Durable streams** (JetStream analog): append-only logs with
    monotonically increasing sequence numbers and bounded retention — the
    KV-event stream the router's index is built from.
  * **Object store**: named buckets of blobs — radix snapshots and the
    KVBM object-store tier (G4).
  * **Work queues**: named FIFOs with a blocking pop — the prefill queue
    of disaggregated serving.

The ops, their replies and the wire format are the JAX package's, so a
port process can join a JAX control plane and the other way round.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, AsyncIterator

from .wire import Frame, K_CTRL, K_DATA, K_ERR, pack, read_frame, unpack

logger = logging.getLogger(__name__)

DEFAULT_STREAM_RETENTION = 100_000  # max entries kept per stream

# --------------------------------------------------------------------------- #
# Server state
# --------------------------------------------------------------------------- #


@dataclass
class _Lease:
    lease_id: int
    ttl_s: float
    deadline: float
    keys: set[str] = field(default_factory=set)


@dataclass
class _Watch:
    prefix: str
    conn: "_Conn"
    watch_id: int


@dataclass
class _Subscription:
    pattern: str  # subject pattern, '*' wildcards per token
    group: str | None
    conn: "_Conn"
    sub_id: int


@dataclass
class _StreamEntry:
    seq: int
    subject: str
    data: bytes


class _Conn:
    """One connected client."""

    def __init__(self, server: "ControlPlaneServer", writer: asyncio.StreamWriter):
        self.server = server
        self.writer = writer
        self.watches: dict[int, _Watch] = {}
        self.subs: dict[int, _Subscription] = {}
        self.leases: set[int] = set()
        self._send_lock = asyncio.Lock()
        self.alive = True

    async def send(self, frame: Frame) -> None:
        if not self.alive:
            return
        async with self._send_lock:
            try:
                self.writer.write(frame.encode())
                await self.writer.drain()
            except (ConnectionError, RuntimeError):
                self.alive = False


def _subject_matches(pattern: str, subject: str) -> bool:
    """NATS-style matching: tokens split on '.', '*' matches one token,
    '>' matches the rest."""
    if pattern == subject:
        return True
    pt, st = pattern.split("."), subject.split(".")
    for i, p in enumerate(pt):
        if p == ">":
            return len(st) > i  # '>' must match at least one token (NATS)
        if i >= len(st):
            return False
        if p != "*" and p != st[i]:
            return False
    return len(pt) == len(st)


class ControlPlaneServer:
    """In-process control-plane server. `await start()` binds; `.port` is the
    bound port (use port=0 for ephemeral)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 stream_retention: int = DEFAULT_STREAM_RETENTION):
        self.host = host
        self.port = port
        self.stream_retention = stream_retention
        self._server: asyncio.Server | None = None
        # KV
        self._kv: dict[str, tuple[bytes, int]] = {}  # key -> (value, lease_id)
        self._watches: dict[str, list[_Watch]] = defaultdict(list)
        # Leases
        self._leases: dict[int, _Lease] = {}
        self._lease_ids = itertools.count(1000)
        # Pub/sub
        self._subs: list[_Subscription] = []
        self._rr: dict[tuple[str, str], int] = defaultdict(int)  # queue-group RR
        # Streams
        self._streams: dict[str, deque[_StreamEntry]] = {}
        self._stream_seq: dict[str, int] = defaultdict(int)
        self._stream_waiters: dict[str, list[asyncio.Event]] = defaultdict(list)
        # Object store
        self._objects: dict[str, dict[str, bytes]] = defaultdict(dict)
        # Work queues
        self._queues: dict[str, deque[bytes]] = defaultdict(deque)
        self._queue_waiters: dict[str, deque[asyncio.Future]] = defaultdict(deque)
        self._reaper_task: asyncio.Task | None = None
        self._conns: set[_Conn] = set()
        # strong refs to in-flight op dispatches: the loop only weakly
        # references tasks, and a dropped dispatch loses its exception
        self._dispatch_tasks: set[asyncio.Task] = set()

    # -- lifecycle ---------------------------------------------------------- #

    async def start(self) -> "ControlPlaneServer":
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._reaper_task = asyncio.create_task(self._reap_leases())
        logger.info("control plane listening on %s:%d", self.host, self.port)
        return self

    def _reap_dispatch(self, task: asyncio.Task) -> None:
        self._dispatch_tasks.discard(task)
        if not task.cancelled() and task.exception() is not None:
            logger.warning("control-plane dispatch failed: %r",
                           task.exception())

    async def stop(self) -> None:
        if self._reaper_task:
            self._reaper_task.cancel()
            await asyncio.gather(self._reaper_task, return_exceptions=True)
        for task in list(self._dispatch_tasks):
            task.cancel()
        if self._dispatch_tasks:
            await asyncio.gather(*self._dispatch_tasks,
                                 return_exceptions=True)
        if self._server:
            self._server.close()
        # Force-close live connections BEFORE wait_closed: in py3.12
        # Server.wait_closed waits for connection handlers to finish.
        for conn in list(self._conns):
            conn.alive = False
            try:
                conn.writer.close()
            except OSError:  # close on an already-dead socket
                pass
        if self._server:
            await self._server.wait_closed()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # -- lease reaper ------------------------------------------------------- #

    async def _reap_leases(self) -> None:
        while True:
            await asyncio.sleep(0.25)
            now = time.monotonic()
            for lease_id in [l for l, le in self._leases.items() if le.deadline < now]:
                await self._revoke(lease_id)

    async def _revoke(self, lease_id: int) -> None:
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return
        for key in list(lease.keys):
            await self._delete_key(key)

    async def _delete_key(self, key: str) -> None:
        entry = self._kv.pop(key, None)
        if entry is None:
            return
        _, lease_id = entry
        if lease_id and lease_id in self._leases:
            self._leases[lease_id].keys.discard(key)
        await self._notify_watchers("delete", key, b"")

    async def _notify_watchers(self, ev: str, key: str, value: bytes) -> None:
        for prefix, watches in list(self._watches.items()):
            if key.startswith(prefix):
                for w in list(watches):
                    if not w.conn.alive:
                        watches.remove(w)
                        continue
                    await w.conn.send(
                        Frame(K_DATA, w.watch_id, {"ev": ev, "key": key}, value)
                    )

    # -- connection handling ------------------------------------------------ #

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        conn = _Conn(self, writer)
        self._conns.add(conn)
        try:
            while True:
                frame = await read_frame(reader)
                if frame.kind != K_CTRL:
                    continue
                task = asyncio.ensure_future(self._dispatch(conn, frame))
                self._dispatch_tasks.add(task)
                task.add_done_callback(self._reap_dispatch)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            conn.alive = False
            self._conns.discard(conn)
            for w in conn.watches.values():
                if w in self._watches.get(w.prefix, []):
                    self._watches[w.prefix].remove(w)
            self._subs = [s for s in self._subs if s.conn is not conn]
            # Leases owned by a dropped connection expire naturally via TTL —
            # deliberate: a worker may reconnect and keepalive before expiry.
            writer.close()

    async def _dispatch(self, conn: _Conn, frame: Frame) -> None:
        op = frame.header.get("op", "")
        try:
            result = await self._handle(conn, op, frame)
            if result is not _NO_REPLY:
                await conn.send(Frame(K_DATA, frame.stream_id, {}, pack(result)))
        except Exception as e:  # noqa: BLE001 — reported to client
            logger.debug("control-plane op %s failed: %s", op, e)
            await conn.send(
                Frame(K_ERR, frame.stream_id, {}, pack({"message": str(e)}))
            )

    async def _handle(self, conn: _Conn, op: str, frame: Frame) -> Any:
        args = unpack(frame.payload) if frame.payload else {}
        h = getattr(self, f"_op_{op}", None)
        if h is None:
            raise ValueError(f"unknown op {op!r}")
        return await h(conn, args, frame)

    # -- ops: KV / lease ---------------------------------------------------- #

    async def _op_put(self, conn, args, frame):
        key, value, lease_id = args["key"], args["value"], args.get("lease", 0)
        prev = self._kv.get(key)
        if prev and prev[1] and prev[1] != lease_id and prev[1] in self._leases:
            # Re-put under a new lease reassociates ownership (etcd semantics).
            self._leases[prev[1]].keys.discard(key)
        if lease_id:
            lease = self._leases.get(lease_id)
            if lease is None:
                raise ValueError(f"lease {lease_id} not found")
            lease.keys.add(key)
        self._kv[key] = (value, lease_id)
        await self._notify_watchers("put", key, value)
        return {"ok": True}

    async def _op_get(self, conn, args, frame):
        entry = self._kv.get(args["key"])
        return {"found": entry is not None, "value": entry[0] if entry else b""}

    async def _op_delete(self, conn, args, frame):
        await self._delete_key(args["key"])
        return {"ok": True}

    async def _op_get_prefix(self, conn, args, frame):
        prefix = args["prefix"]
        return {
            "kvs": [
                {"key": k, "value": v}
                for k, (v, _) in sorted(self._kv.items())
                if k.startswith(prefix)
            ]
        }

    async def _op_grant_lease(self, conn, args, frame):
        ttl = float(args.get("ttl", 10.0))
        lease_id = next(self._lease_ids)
        self._leases[lease_id] = _Lease(lease_id, ttl, time.monotonic() + ttl)
        conn.leases.add(lease_id)
        return {"lease": lease_id}

    async def _op_keepalive(self, conn, args, frame):
        lease = self._leases.get(args["lease"])
        if lease is None:
            return {"ok": False}
        lease.deadline = time.monotonic() + lease.ttl_s
        return {"ok": True}

    async def _op_revoke(self, conn, args, frame):
        await self._revoke(args["lease"])
        return {"ok": True}

    async def _op_watch(self, conn, args, frame):
        # Streamed reply: initial snapshot entries then live events, all on
        # frame.stream_id.  Client treats it as an infinite stream.
        prefix = args["prefix"]
        w = _Watch(prefix=prefix, conn=conn, watch_id=frame.stream_id)
        conn.watches[frame.stream_id] = w
        self._watches[prefix].append(w)
        for k, (v, _) in sorted(self._kv.items()):
            if k.startswith(prefix):
                await conn.send(Frame(K_DATA, frame.stream_id, {"ev": "put", "key": k}, v))
        await conn.send(Frame(K_DATA, frame.stream_id, {"ev": "sync", "key": ""}, b""))
        return _NO_REPLY

    async def _op_unwatch(self, conn, args, frame):
        w = conn.watches.pop(args["watch_id"], None)
        if w and w in self._watches.get(w.prefix, []):
            self._watches[w.prefix].remove(w)
        return {"ok": True}

    # -- ops: pub/sub ------------------------------------------------------- #

    async def _op_publish(self, conn, args, frame):
        subject = args["subject"]
        delivered = 0
        groups: dict[tuple[str, str], list[_Subscription]] = defaultdict(list)
        direct: list[_Subscription] = []
        for s in self._subs:
            if not s.conn.alive:
                continue
            if _subject_matches(s.pattern, subject):
                if s.group:
                    groups[(s.pattern, s.group)].append(s)
                else:
                    direct.append(s)
        data = args.get("data", b"")
        for s in direct:
            await s.conn.send(Frame(K_DATA, s.sub_id, {"subject": subject}, data))
            delivered += 1
        for key, members in groups.items():
            idx = self._rr[key] % len(members)
            self._rr[key] += 1
            s = members[idx]
            await s.conn.send(Frame(K_DATA, s.sub_id, {"subject": subject}, data))
            delivered += 1
        return {"delivered": delivered}

    async def _op_subscribe(self, conn, args, frame):
        s = _Subscription(
            pattern=args["subject"], group=args.get("group"), conn=conn,
            sub_id=frame.stream_id,
        )
        conn.subs[frame.stream_id] = s
        self._subs.append(s)
        return _NO_REPLY

    async def _op_unsubscribe(self, conn, args, frame):
        s = conn.subs.pop(args["sub_id"], None)
        if s in self._subs:
            self._subs.remove(s)
        return {"ok": True}

    # -- ops: durable streams ---------------------------------------------- #

    async def _op_stream_append(self, conn, args, frame):
        name = args["stream"]
        self._stream_seq[name] += 1
        seq = self._stream_seq[name]
        q = self._streams.setdefault(name, deque(maxlen=self.stream_retention))
        q.append(_StreamEntry(seq=seq, subject=args.get("subject", ""),
                              data=args["data"]))
        for ev in self._stream_waiters.pop(name, []):
            ev.set()
        return {"seq": seq}

    async def _op_stream_fetch(self, conn, args, frame):
        """Fetch entries with seq > after, blocking up to timeout_ms if empty."""
        name, after = args["stream"], args.get("after", 0)
        timeout = args.get("timeout_ms", 0) / 1000.0
        q = self._streams.setdefault(name, deque(maxlen=self.stream_retention))
        entries = [e for e in q if e.seq > after]
        if not entries and timeout > 0:
            ev = asyncio.Event()
            self._stream_waiters[name].append(ev)
            try:
                await asyncio.wait_for(ev.wait(), timeout)
            except asyncio.TimeoutError:
                pass
            finally:
                waiters = self._stream_waiters.get(name)
                if waiters and ev in waiters:
                    waiters.remove(ev)
            entries = [e for e in q if e.seq > after]
        limit = args.get("limit", 1000)
        entries = entries[:limit]
        return {
            "entries": [
                {"seq": e.seq, "subject": e.subject, "data": e.data}
                for e in entries
            ],
            "last_seq": self._stream_seq[name],
            # oldest retained seq — a consumer whose offset is older has a
            # GAP (events aged out of retention) and must resync from a
            # snapshot
            "first_available": q[0].seq if q else self._stream_seq[name] + 1,
        }

    async def _op_stream_len(self, conn, args, frame):
        return {"last_seq": self._stream_seq[args["stream"]],
                "len": len(self._streams.get(args["stream"], ()))}

    # -- ops: object store -------------------------------------------------- #

    async def _op_obj_put(self, conn, args, frame):
        self._objects[args["bucket"]][args["name"]] = args["data"]
        return {"ok": True}

    async def _op_obj_get(self, conn, args, frame):
        data = self._objects.get(args["bucket"], {}).get(args["name"])
        return {"found": data is not None, "data": data or b""}

    async def _op_obj_list(self, conn, args, frame):
        return {"names": sorted(self._objects.get(args["bucket"], {}))}

    # -- ops: work queues --------------------------------------------------- #

    async def _op_queue_push(self, conn, args, frame):
        name = args["queue"]
        waiters = self._queue_waiters[name]
        # a blocked pop takes the item straight away
        while waiters:
            fut = waiters.popleft()
            if not fut.done():
                fut.set_result(args["data"])
                return {"ok": True, "depth": len(self._queues[name])}
        self._queues[name].append(args["data"])
        return {"ok": True, "depth": len(self._queues[name])}

    async def _op_queue_pop(self, conn, args, frame):
        name = args["queue"]
        timeout = args.get("timeout_ms", 0) / 1000.0
        q = self._queues[name]
        if q:
            return {"found": True, "data": q.popleft()}
        if timeout <= 0:
            return {"found": False, "data": b""}
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._queue_waiters[name].append(fut)
        try:
            data = await asyncio.wait_for(fut, timeout)
            return {"found": True, "data": data}
        except asyncio.TimeoutError:
            return {"found": False, "data": b""}
        finally:
            waiters = self._queue_waiters.get(name)
            if waiters and fut in waiters:
                waiters.remove(fut)

    async def _op_queue_depth(self, conn, args, frame):
        return {"depth": len(self._queues[args["queue"]])}


_NO_REPLY = object()


# --------------------------------------------------------------------------- #
# Client
# --------------------------------------------------------------------------- #


class WatchEvent:
    __slots__ = ("type", "key", "value")

    def __init__(self, type_: str, key: str, value: bytes):
        self.type = type_
        self.key = key
        self.value = value

    def __repr__(self):
        return f"WatchEvent({self.type}, {self.key})"


class ControlPlaneClient:
    """Async client; one multiplexed TCP connection, request/response matched
    by stream id.

    Reconnects transparently: when the connection drops, in-flight calls
    fail with ConnectionError and live watch/sub streams end (yield None);
    the NEXT `_call` re-opens the socket, so retry loops (ModelWatcher,
    KvRouter, Client discovery) converge instead of spinning on a dead
    socket.  Leases survive brief outages server-side via their TTL."""

    def __init__(self, address: str):
        self.address = address
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._ids = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._streams: dict[int, asyncio.Queue] = {}  # watch/sub deliveries
        self._recv_task: asyncio.Task | None = None
        self._send_lock = asyncio.Lock()
        self._closed = False

    async def connect(self) -> "ControlPlaneClient":
        await self._ensure_connection()
        return self

    async def _ensure_connection(self) -> None:
        """(Re)open the socket if needed. Caller must hold no assumptions
        about stream ids across reconnects — streams end on disconnect."""
        if self._closed:
            raise ConnectionError("control plane client closed")
        if self._writer is not None and not self._writer.is_closing():
            return
        # anything still registered belongs to the dead connection: fail
        # pending calls and end streams NOW — the old recv task may be
        # superseded before its own cleanup runs
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError("control plane connection lost"))
        self._pending.clear()
        streams, self._streams = self._streams, {}
        for q in streams.values():
            await q.put(None)
        host, port = self.address.rsplit(":", 1)
        self._reader, self._writer = await asyncio.open_connection(host, int(port))
        if self._recv_task is not None:
            self._recv_task.cancel()
            await asyncio.gather(self._recv_task, return_exceptions=True)
        self._recv_task = asyncio.create_task(self._recv_loop())

    async def close(self) -> None:
        self._closed = True
        if self._recv_task:
            self._recv_task.cancel()
            await asyncio.gather(self._recv_task, return_exceptions=True)
        if self._writer:
            self._writer.close()

    async def _recv_loop(self) -> None:
        reader = self._reader
        try:
            while True:
                frame = await read_frame(reader)
                sid = frame.stream_id
                if sid in self._streams:
                    await self._streams[sid].put(frame)
                elif sid in self._pending:
                    fut = self._pending.pop(sid)
                    if not fut.done():
                        if frame.kind == K_ERR:
                            fut.set_exception(
                                RuntimeError(unpack(frame.payload)["message"])
                            )
                        else:
                            fut.set_result(unpack(frame.payload))
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            if reader is not self._reader:
                return  # superseded by a reconnect; new state isn't ours
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("control plane connection lost"))
            self._pending.clear()
            # end live streams; consumers re-watch/re-subscribe (which
            # reconnects via _ensure_connection)
            streams, self._streams = self._streams, {}
            for q in streams.values():
                await q.put(None)
            if self._writer is not None:
                self._writer.close()

    async def _call(self, op: str, args: dict, stream: bool = False) -> Any:
        async with self._send_lock:
            await self._ensure_connection()
            sid = next(self._ids)
            frame = Frame(K_CTRL, sid, {"op": op}, pack(args))
            if stream:
                q: asyncio.Queue = asyncio.Queue()
                self._streams[sid] = q
            else:
                fut = asyncio.get_running_loop().create_future()
                self._pending[sid] = fut
            self._writer.write(frame.encode())
            await self._writer.drain()
        if stream:
            return sid
        return await fut

    # -- KV / lease --------------------------------------------------------- #

    async def put(self, key: str, value: bytes, lease: int = 0) -> None:
        await self._call("put", {"key": key, "value": value, "lease": lease})

    async def get(self, key: str) -> bytes | None:
        r = await self._call("get", {"key": key})
        return r["value"] if r["found"] else None

    async def delete(self, key: str) -> None:
        await self._call("delete", {"key": key})

    async def get_prefix(self, prefix: str) -> list[tuple[str, bytes]]:
        r = await self._call("get_prefix", {"prefix": prefix})
        return [(kv["key"], kv["value"]) for kv in r["kvs"]]

    async def grant_lease(self, ttl: float = 10.0) -> int:
        return (await self._call("grant_lease", {"ttl": ttl}))["lease"]

    async def keepalive(self, lease: int) -> bool:
        return (await self._call("keepalive", {"lease": lease}))["ok"]

    async def revoke(self, lease: int) -> None:
        await self._call("revoke", {"lease": lease})

    async def watch_prefix(self, prefix: str) -> "WatchStream":
        sid = await self._call("watch", {"prefix": prefix}, stream=True)
        return WatchStream(self, sid)

    # -- pub/sub ------------------------------------------------------------ #

    async def publish(self, subject: str, data: bytes) -> int:
        r = await self._call("publish", {"subject": subject, "data": data})
        return r["delivered"]

    async def subscribe(self, subject: str, group: str | None = None) -> "SubStream":
        sid = await self._call(
            "subscribe", {"subject": subject, "group": group}, stream=True
        )
        return SubStream(self, sid)

    # -- streams ------------------------------------------------------------ #

    async def stream_append(self, stream: str, data: bytes, subject: str = "") -> int:
        return (
            await self._call(
                "stream_append", {"stream": stream, "data": data, "subject": subject}
            )
        )["seq"]

    async def stream_fetch(
        self, stream: str, after: int, timeout_ms: int = 0, limit: int = 1000
    ) -> tuple[list[dict], int, int]:
        """Returns (entries, last_seq, first_available).  `after <
        first_available - 1` means entries were lost to retention — resync
        from a snapshot before applying."""
        r = await self._call(
            "stream_fetch",
            {"stream": stream, "after": after, "timeout_ms": timeout_ms,
             "limit": limit},
        )
        return r["entries"], r["last_seq"], r.get("first_available", 1)

    async def stream_len(self, stream: str) -> tuple[int, int]:
        """(last_seq, retained entries) of a stream."""
        r = await self._call("stream_len", {"stream": stream})
        return r["last_seq"], r["len"]

    # -- object store ------------------------------------------------------- #

    async def obj_put(self, bucket: str, name: str, data: bytes) -> None:
        await self._call("obj_put", {"bucket": bucket, "name": name, "data": data})

    async def obj_get(self, bucket: str, name: str) -> bytes | None:
        r = await self._call("obj_get", {"bucket": bucket, "name": name})
        return r["data"] if r["found"] else None

    async def obj_list(self, bucket: str) -> list[str]:
        return (await self._call("obj_list", {"bucket": bucket}))["names"]

    # -- work queues -------------------------------------------------------- #

    async def queue_push(self, queue: str, data: bytes) -> int:
        return (await self._call("queue_push", {"queue": queue, "data": data}))["depth"]

    async def queue_pop(self, queue: str, timeout_ms: int = 0) -> bytes | None:
        r = await self._call("queue_pop", {"queue": queue, "timeout_ms": timeout_ms})
        return r["data"] if r["found"] else None

    async def queue_depth(self, queue: str) -> int:
        return (await self._call("queue_depth", {"queue": queue}))["depth"]


async def watch_resilient(control: "ControlPlaneClient", prefix: str,
                          what: str = "") -> AsyncIterator[WatchEvent]:
    """Watch `prefix` forever, transparently re-watching on connection
    loss with exponential backoff (reset once a watch reaches its 'sync'
    marker) AND reconciling across reconnects: a key that was present but
    is absent from a reconnect's snapshot was deleted while the watch was
    down — its lost delete is replayed as a synthetic ``forget`` event
    (emitted just before the ``sync`` marker).  Consumers therefore only
    handle ``put``, ``delete``/``forget`` (same meaning), and optionally
    ``sync`` — no per-consumer seen-set bookkeeping."""
    backoff = 0.2
    known: set[str] = set()  # keys live per the server, across reconnects
    while True:
        try:
            stream = await control.watch_prefix(prefix)
            seen: set[str] = set()
            synced = False
            async for ev in stream:
                if ev.type == "sync":
                    backoff = 0.2
                    synced = True
                    for key in known - seen:
                        yield WatchEvent("forget", key, b"")
                    known = seen
                elif ev.type == "put":
                    if not synced:
                        # also into `known` NOW: if this stream dies before
                        # its sync, the next reconnect must still be able
                        # to emit a forget for this key
                        seen.add(ev.key)
                    known.add(ev.key)
                elif ev.type == "delete":
                    known.discard(ev.key)
                yield ev
            logger.warning("watch on %s ended; retrying in %.1fs",
                           what or prefix, backoff)
        except (ConnectionError, RuntimeError) as e:
            logger.warning("watch on %s failed (%s); retrying in %.1fs",
                           what or prefix, e, backoff)
        await asyncio.sleep(backoff)
        backoff = min(backoff * 2, 5.0)


class WatchStream:
    """Async iterator of WatchEvents. First yields current state (snapshot)
    then a 'sync' marker event, then live updates."""

    def __init__(self, client: ControlPlaneClient, sid: int):
        self._client = client
        self._sid = sid

    def __aiter__(self) -> AsyncIterator[WatchEvent]:
        return self._iter()

    async def _iter(self):
        q = self._client._streams[self._sid]
        while True:
            frame = await q.get()
            if frame is None:
                return
            yield WatchEvent(frame.header["ev"], frame.header["key"], frame.payload)

    async def cancel(self) -> None:
        try:
            await self._client._call("unwatch", {"watch_id": self._sid})
        except (ConnectionError, RuntimeError):
            pass
        self._client._streams.pop(self._sid, None)


class SubStream:
    """Async iterator of (subject, payload) published messages."""

    def __init__(self, client: ControlPlaneClient, sid: int):
        self._client = client
        self._sid = sid

    def __aiter__(self):
        return self._iter()

    async def _iter(self):
        q = self._client._streams[self._sid]
        while True:
            frame = await q.get()
            if frame is None:
                return
            yield frame.header.get("subject", ""), frame.payload

    async def cancel(self) -> None:
        try:
            await self._client._call("unsubscribe", {"sub_id": self._sid})
        except (ConnectionError, RuntimeError):
            pass
        self._client._streams.pop(self._sid, None)
