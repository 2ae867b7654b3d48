"""Block-ID KV transfer service: the data plane of disaggregated serving.

The port's copy of the JAX package's `disagg/transfer.py`.  KV *layout*
metadata is registered once per worker in the control plane; per-request
messages carry only a transfer handle and a page count; the data moves
one of three ways, tried in order:

- "colocated": the source lives in this process (a single-process disagg
  graph, every in-process test): `kv_repage` reads the other engine's pool
  directly (`device_transfer.fetch_colocated`);
- "ipc": the source is another process on the same card: its pools are
  mapped into this process through CUDA IPC once per source lease, and
  `kv_repage` reads them (`device_transfer.fetch_ipc`) -- the lane the
  JAX protocol reserves for a cross-process device pull (`dma_addr`);
- "host": page-sized chunks stream over a dedicated data-plane socket
  (the source exports chunk k+1 while chunk k is on the wire, the client
  imports chunk k while reading chunk k+1), re-paged token-major on the
  host when prefill and decode engines use different page sizes.  Works
  across cards and hosts, and between this package and the JAX one: the
  frames are the JAX package's.

A failure on a device lane raises: the caller (the decode handler) then
prefills locally and counts it; no lane falls back to another quietly.
The port has no tracing yet, so the fetch frames carry no trace headers.
"""

from __future__ import annotations

import asyncio
import logging
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..runtime.transport.wire import (
    Frame,
    K_CTRL,
    K_DATA,
    K_END,
    K_ERR,
    K_REQ,
    pack,
    read_frame,
    unpack,
    write_frame,
)

logger = logging.getLogger(__name__)

LAYOUT_PREFIX = "/kv_layouts"

# target bytes per streamed chunk (whole source pages)
_CHUNK_BYTES = 2 << 20
# unclaimed transfers are released after this many seconds
_DEFAULT_TTL = 120.0

# the JAX package's dtype names (numpy's, and ml_dtypes' "bfloat16")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclass
class KvLayout:
    """KV pool geometry, registered once per worker: the JAX package's
    `KvLayout`, key for key.  `dtype` carries the JAX package's names
    ("bfloat16", "float32")."""

    layers: int
    page_size: int
    n_kv_heads: int
    head_dim: int
    dtype: str

    @classmethod
    def of_engine(cls, engine) -> "KvLayout":
        mc = engine.model_cfg
        return cls(
            layers=mc.num_hidden_layers,
            page_size=engine.cfg.page_size,
            n_kv_heads=mc.num_key_value_heads,
            head_dim=mc.head_dim_,
            dtype=str(engine.kv.k.dtype).removeprefix("torch."),
        )

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def bytes_per_page(self) -> int:
        return (2 * self.layers * self.page_size * self.n_kv_heads
                * self.head_dim * self.torch_dtype.itemsize)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "layers": self.layers,
            "page_size": self.page_size,
            "n_kv_heads": self.n_kv_heads,
            "head_dim": self.head_dim,
            "dtype": self.dtype,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KvLayout":
        return cls(**d)

    def compatible_heads(self, other: "KvLayout") -> bool:
        return (
            self.layers == other.layers
            and self.n_kv_heads == other.n_kv_heads
            and self.head_dim == other.head_dim
        )


def tensor_bytes(t: torch.Tensor) -> bytes:
    """A host tensor's raw bytes (bf16 included, which numpy lacks)."""
    return t.contiguous().view(torch.uint8).numpy().tobytes()


@dataclass
class _Held:
    pages: List[int]
    prompt_len: int
    deadline: float
    # the ipc lane: the interprocess event the engine recorded on its
    # stream after the prompt's KV writes, and its handle for descriptors
    event: Optional[Any] = None
    event_handle: Optional[bytes] = None


class KvTransferSource:
    """Prefill-side data-plane server: holds pages under a transfer handle,
    streams them by block id on request, frees them on release or TTL.
    On a card it also offers its pools to the ipc lane (`ipc`: the CUDA IPC
    entry of `device_transfer.ipc_export`, made once at start; the pools
    are never reallocated, so it lasts the worker's life).  A card whose
    pools cannot be exported fails `start`: a decode worker on the same
    card would otherwise move every prompt through the host lane."""

    def __init__(self, engine, host: str = "127.0.0.1", ttl: float = _DEFAULT_TTL):
        self.engine = engine
        self.layout = KvLayout.of_engine(engine)
        self.host = host
        self.ttl = ttl
        self.port: int = 0
        self.ipc: Optional[Dict[str, Any]] = None
        self._held: Dict[str, _Held] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._reaper: Optional[asyncio.Task] = None

    @property
    def address(self) -> List[Any]:
        return [self.host, self.port]

    @property
    def held_pages(self) -> int:
        return sum(len(h.pages) for h in self._held.values())

    async def start(self) -> "KvTransferSource":
        from .device_transfer import group_entry, ipc_export

        # a dp group's pages sit on one replica's ranks (or on every
        # replica): it serves them through its exports, on the host lane
        # (an entry naming one replica's ranks is not ported: ROADMAP
        # 2.2b.6); so does a pipeline, whose ranks hold a window of the
        # layers (ROADMAP 2.3b), and a sequence-parallel group (ROADMAP
        # 2.4b)
        if (self.engine.device.type == "cuda"
                and getattr(self.engine, "dp", 1) == 1
                and getattr(self.engine, "pp", 1) == 1
                and getattr(self.engine, "sp", 1) == 1):
            if getattr(self.engine, "tp", 1) > 1:
                # every rank's pools (an ``ipc_export`` plan, between steps)
                self.ipc = group_entry(await self.engine._device_op(  # noqa: SLF001
                    self.engine.ipc_entries))
            else:
                self.ipc = ipc_export(self.engine)
        self._server = await asyncio.start_server(self._on_conn, self.host, 0)
        self.port = self._server.sockets[0].getsockname()[1]
        self._reaper = asyncio.create_task(self._reap_loop())
        return self

    async def stop(self) -> None:
        if self._reaper:
            self._reaper.cancel()
            await asyncio.gather(self._reaper, return_exceptions=True)
        if self._server:
            self._server.close()
            await self._server.wait_closed()
        for tid in list(self._held):
            await self._release(tid)

    async def register_layout(self, runtime, namespace: str, component: str) -> None:
        """Publish the pool layout, the data-plane address and (on a card)
        the pools' IPC entry once, lease-scoped."""
        key = f"{LAYOUT_PREFIX}/{namespace}/{component}/{runtime.primary_lease}"
        value = {"layout": self.layout.to_dict(), "addr": self.address}
        if self.ipc is not None:
            self.ipc["lease"] = runtime.primary_lease
            for e in self.ipc.get("ranks", ()):
                e["lease"] = runtime.primary_lease
            value["cuda_ipc"] = self.ipc
        await runtime.put_leased(key, pack(value))

    # -- handle lifecycle --------------------------------------------------- #

    async def register(self, pages: List[int], prompt_len: int,
                       event=None) -> str:
        """Hold the pages under a fresh transfer handle.  `event`: the
        interprocess event the engine recorded on its step thread right
        after the prompt's last KV write (`TorchEngine._prefill_pass`);
        the ipc lane's reader waits on it, and on no later work."""
        from .device_transfer import register_local

        tid = uuid.uuid4().hex
        held = _Held(pages=list(pages), prompt_len=prompt_len,
                     deadline=time.monotonic() + self.ttl)
        if self.ipc is not None and event is not None:
            held.event = event
            held.event_handle = event.ipc_handle()
        self._held[tid] = held
        register_local(tid, self)
        return tid

    def descriptor(self, tid: str) -> Dict[str, Any]:
        """What rides the request path: a handle, a page count, where the
        data plane lives (and, for the ipc lane, the pools' entry with this
        transfer's pages and event) -- never the data."""
        from .device_transfer import process_token

        held = self._held[tid]
        out = {
            "transfer_id": tid,
            "addr": self.address,
            # colocated clients (same process) skip the socket
            "proc": process_token(),
            # the JAX package's PJRT pull address: this package has none
            "dma_addr": None,
            "num_pages": len(held.pages),
            "prompt_len": held.prompt_len,
            # also in the registry; carried inline so a fetch can proceed
            # before a watcher catches up
            "layout": self.layout.to_dict(),
        }
        if self.ipc is not None:
            out["cuda_ipc"] = {**self.ipc, "pages": list(held.pages),
                               "event": held.event_handle}
        return out

    async def _release(self, tid: str) -> None:
        from .device_transfer import unregister_local

        unregister_local(tid)
        held = self._held.pop(tid, None)
        if held is None or not held.pages:
            return
        try:
            await self.engine.free_pages(held.pages)
        except Exception:  # noqa: BLE001
            logger.exception("failed to free transfer %s pages", tid)

    async def _reap_loop(self) -> None:
        while True:
            await asyncio.sleep(self.ttl / 4)
            now = time.monotonic()
            for tid, held in list(self._held.items()):
                if held.deadline < now:
                    logger.warning("kv transfer %s expired unclaimed", tid)
                    await self._release(tid)

    # -- wire protocol ------------------------------------------------------ #

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                frame = await read_frame(reader)
                if frame.kind == K_REQ and frame.header.get("op") == "fetch":
                    await self._serve_fetch(frame, writer)
                elif frame.kind == K_CTRL and frame.header.get("op") == "release":
                    await self._release(frame.header.get("transfer_id", ""))
                    write_frame(writer, Frame(K_END, frame.stream_id, {}, b""))
                    await writer.drain()
                elif frame.kind == K_CTRL and frame.header.get("op") == "layout":
                    write_frame(writer, Frame(K_DATA, frame.stream_id, {},
                                              pack(self.layout.to_dict())))
                    await writer.drain()
                else:
                    write_frame(writer, Frame(K_ERR, frame.stream_id, {},
                                              pack({"message": "bad request"})))
                    await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    async def _serve_fetch(self, frame: Frame, writer: asyncio.StreamWriter) -> None:
        tid = frame.header.get("transfer_id", "")
        held = self._held.get(tid)
        if held is None:
            write_frame(writer, Frame(K_ERR, frame.stream_id, {},
                                      pack({"message": f"unknown transfer {tid}"})))
            await writer.drain()
            return
        held.deadline = time.monotonic() + self.ttl  # claimed; re-arm
        chunk_pages = max(1, _CHUNK_BYTES // max(self.layout.bytes_per_page, 1))
        pages = held.pages
        # export in 16 MB strides (each a device op), stream 2 MB frames
        export_pages_n = max(chunk_pages,
                             (16 << 20) // max(self.layout.bytes_per_page, 1))
        seq = 0
        for estart in range(0, len(pages), export_pages_n):
            ids = pages[estart:estart + export_pages_n]
            k_all, v_all = await self.engine.export_pages(ids)
            for start in range(0, len(ids), chunk_pages):
                n = min(chunk_pages, len(ids) - start)
                kb = tensor_bytes(k_all[:, start:start + n])
                vb = tensor_bytes(v_all[:, start:start + n])
                write_frame(writer, Frame(K_DATA, frame.stream_id,
                                          {"seq": seq, "n": n, "klen": len(kb)},
                                          kb + vb))
                seq += 1
                await writer.drain()
        write_frame(writer, Frame(K_END, frame.stream_id, {}, b""))
        await writer.drain()


@dataclass
class TransferStats:
    bytes: int = 0
    ms: float = 0.0
    src_pages: int = 0
    dest_pages: int = 0
    lane: str = "host"  # "host" (TCP staging) | "device" (colocated) | "ipc"


class KvTransferClient:
    """Decode side: fetch a registered transfer into the local engine's
    pool, re-paging between source and destination layouts.

    Lanes, tried in order: "colocated" (the source is in this process),
    "ipc" (the descriptor offers the source's pools on this card, or an
    opener was injected), "host" (always possible).  `lanes` restricts the
    order (tests pin single lanes).  `ipc_opener` / `ipc_event_opener`
    replace the CUDA IPC mapping (tests on the CPU)."""

    def __init__(self, engine,
                 lanes: Tuple[str, ...] = ("colocated", "ipc", "host"),
                 ipc_opener=None, ipc_event_opener=None):
        from .device_transfer import IpcLane

        self.engine = engine
        self.dest_layout = KvLayout.of_engine(engine)
        self.lanes = lanes
        self.ipc = IpcLane(engine.device, opener=ipc_opener,
                           event_opener=ipc_event_opener,
                           stages=getattr(engine, "pp", 1),
                           sp=getattr(engine, "sp", 1))

    async def fetch(self, descriptor: Dict[str, Any],
                    timeout: Optional[float] = 60.0,
                    ) -> Tuple[List[int], TransferStats]:
        """Returns (dest page ids holding the prompt KV, stats).  Raises on
        incompatibility or transport failure -- callers fall back to local
        prefill.  Allocated pages are freed on failure.  ``timeout`` bounds
        the whole transfer (``None``: no deadline)."""
        if timeout is not None:
            return await asyncio.wait_for(self._fetch(descriptor), timeout)
        return await self._fetch(descriptor)

    async def _fetch(self, descriptor: Dict[str, Any]) -> Tuple[List[int], TransferStats]:
        from .device_transfer import fetch_colocated, fetch_ipc, local_source

        t0 = time.perf_counter()
        src = KvLayout.from_dict(descriptor["layout"])
        dst = self.dest_layout
        if not src.compatible_heads(dst):
            raise ValueError(f"incompatible KV layouts: src {src} vs dst {dst}")
        prompt_len = int(descriptor["prompt_len"])
        n_dest = -(-prompt_len // dst.page_size)
        lane = None
        if "colocated" in self.lanes:
            source = local_source(descriptor)
            if source is not None:
                dest_pages = await fetch_colocated(self, source, descriptor)
                lane = "device"
        if (lane is None and "ipc" in self.lanes
                and self.ipc.usable(descriptor.get("cuda_ipc"))):
            dest_pages = await fetch_ipc(self, descriptor)
            lane = "ipc"
        if lane is not None:
            # logical bytes moved, device to device (nothing crossed the host)
            return dest_pages, TransferStats(
                bytes=n_dest * dst.bytes_per_page,
                ms=(time.perf_counter() - t0) * 1000.0,
                src_pages=int(descriptor["num_pages"]), dest_pages=n_dest,
                lane=lane)
        dest_pages = await self.engine.alloc_pages(n_dest)
        stats = TransferStats(dest_pages=n_dest)
        pending_box: List[Optional[asyncio.Task]] = [None]
        try:
            await self._fetch_into(descriptor, src, dst, prompt_len,
                                   dest_pages, stats, pending_box)
        except BaseException:
            # settle any in-flight import BEFORE freeing: it must not land
            # after the pages are handed to someone else
            task = pending_box[0]
            if task is not None:
                try:
                    await task
                except Exception:  # noqa: BLE001 — the original error wins
                    pass
            await self.engine.free_pages(dest_pages)
            await self._release_remote(descriptor)
            raise
        stats.ms = (time.perf_counter() - t0) * 1000.0
        return dest_pages, stats

    async def _release_remote(self, descriptor: Dict[str, Any]) -> None:
        """Best effort: tell the source to drop its hold now rather than
        wait out the TTL (the TTL is the backstop for a lost release)."""
        try:
            host, port = descriptor["addr"]
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port), timeout=2.0)
            write_frame(writer, Frame(
                K_CTRL, 1,
                {"op": "release", "transfer_id": descriptor["transfer_id"]}, b""))
            await asyncio.wait_for(writer.drain(), timeout=2.0)
            # wait for the source's answer: the hold is gone when it comes
            await asyncio.wait_for(read_frame(reader), timeout=2.0)
            writer.close()
        except Exception:  # noqa: BLE001 — the remote TTL backstops a lost release
            pass

    async def _fetch_into(self, descriptor, src: KvLayout, dst: KvLayout,
                          prompt_len: int, dest_pages: List[int],
                          stats: TransferStats,
                          pending_box: List[Optional[asyncio.Task]]) -> None:
        host, port = descriptor["addr"]
        reader, writer = await asyncio.open_connection(host, port)
        sdtype, ddtype = src.torch_dtype, dst.torch_dtype
        L, kvh, hd = src.layers, src.n_kv_heads, src.head_dim
        try:
            write_frame(writer, Frame(
                K_REQ, 1, {"op": "fetch", "transfer_id": descriptor["transfer_id"]},
                b""))
            await writer.drain()

            stage = _TokenStager(L, kvh, hd, ddtype)
            next_dest = 0  # index into dest_pages
            # import stride: small transfers import once, large ones stream
            # with bounded host memory
            flush_tokens = max(
                dst.page_size,
                (16 << 20) // max(2 * L * kvh * hd * ddtype.itemsize, 1))

            async def flush(final: bool) -> None:
                """Cut whole destination pages off the stage and import
                them; pipeline depth 1, so the import of chunk k overlaps
                reading chunk k+1 off the wire."""
                nonlocal next_dest
                if not final and stage.tokens < flush_tokens:
                    return
                n_whole = stage.tokens // dst.page_size
                if final and stage.tokens % dst.page_size:
                    stage.pad_to(n_whole * dst.page_size + dst.page_size)
                    n_whole += 1
                if n_whole == 0:
                    return
                k_chunk, v_chunk = stage.pop(n_whole * dst.page_size)
                k_chunk = k_chunk.reshape(L, n_whole, dst.page_size, kvh, hd)
                v_chunk = v_chunk.reshape(L, n_whole, dst.page_size, kvh, hd)
                ids = dest_pages[next_dest:next_dest + n_whole]
                if len(ids) != n_whole:
                    raise RuntimeError("transfer longer than prompt_len")
                next_dest += n_whole
                if pending_box[0] is not None:
                    await pending_box[0]
                pending_box[0] = asyncio.ensure_future(
                    self.engine.import_page_chunk(ids, k_chunk, v_chunk))

            while True:
                frame = await read_frame(reader)
                if frame.kind == K_ERR:
                    raise RuntimeError(
                        unpack(frame.payload).get("message", "fetch failed"))
                if frame.kind == K_END:
                    break
                n = frame.header["n"]
                klen = frame.header["klen"]
                stats.bytes += len(frame.payload)
                stats.src_pages += n
                payload = bytearray(frame.payload)
                shape = (L, n * src.page_size, kvh, hd)
                kb = torch.frombuffer(payload[:klen], dtype=sdtype).reshape(shape)
                vb = torch.frombuffer(payload[klen:], dtype=sdtype).reshape(shape)
                stage.push(kb.to(ddtype), vb.to(ddtype))
                # keep only prompt_len tokens (source pages are page-padded)
                stage.truncate_total(prompt_len)
                await flush(final=False)

            stage.truncate_total(prompt_len)
            await flush(final=True)
            if pending_box[0] is not None:
                await pending_box[0]
                pending_box[0] = None
            if next_dest != len(dest_pages):
                raise RuntimeError(
                    f"transfer filled {next_dest}/{len(dest_pages)} pages")

            # release the source's hold (best effort: the TTL covers failure)
            write_frame(writer, Frame(
                K_CTRL, 2,
                {"op": "release", "transfer_id": descriptor["transfer_id"]}, b""))
            await writer.drain()
        finally:
            writer.close()


class _TokenStager:
    """Token-major staging between mismatched page sizes: frames push
    [L, t, kv, hd] slabs; pop() cuts an exact token count off the front."""

    def __init__(self, L: int, kvh: int, hd: int, dtype: torch.dtype):
        self._shape = (L, kvh, hd)
        self._dtype = dtype
        self._k: List[torch.Tensor] = []
        self._v: List[torch.Tensor] = []
        self.tokens = 0  # tokens currently staged
        self.popped = 0

    def push(self, k: torch.Tensor, v: torch.Tensor) -> None:
        self._k.append(k)
        self._v.append(v)
        self.tokens += k.shape[1]

    def truncate_total(self, limit: int) -> None:
        """Drop staged tokens beyond stream position `limit`."""
        excess = (self.popped + self.tokens) - limit
        while excess > 0 and self._k:
            tail = self._k[-1].shape[1]
            cut = min(tail, excess)
            if cut == tail:
                self._k.pop()
                self._v.pop()
            else:
                self._k[-1] = self._k[-1][:, :tail - cut]
                self._v[-1] = self._v[-1][:, :tail - cut]
            self.tokens -= cut
            excess -= cut

    def pad_to(self, n: int) -> None:
        L, kvh, hd = self._shape
        if n > self.tokens:
            z = torch.zeros((L, n - self.tokens, kvh, hd), dtype=self._dtype)
            self._k.append(z)
            self._v.append(z)
            self.tokens = n

    def pop(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        assert n <= self.tokens
        out_k, out_v, got = [], [], 0
        while got < n:
            k, v = self._k[0], self._v[0]
            take = min(k.shape[1], n - got)
            out_k.append(k[:, :take])
            out_v.append(v[:, :take])
            if take == k.shape[1]:
                self._k.pop(0)
                self._v.pop(0)
            else:
                self._k[0] = k[:, take:]
                self._v[0] = v[:, take:]
            got += take
        self.tokens -= n
        self.popped += n
        return torch.cat(out_k, dim=1), torch.cat(out_v, dim=1)


async def lookup_layouts(runtime, namespace: str, component: str
                         ) -> Dict[str, Dict[str, Any]]:
    """Read registered layouts for a component from the control plane,
    keyed by the registering worker's lease."""
    rows = await runtime.control.get_prefix(f"{LAYOUT_PREFIX}/{namespace}/{component}/")
    return {key.rsplit("/", 1)[-1]: unpack(value) for key, value in rows}
