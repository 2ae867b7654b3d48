"""Device lanes of the KV data plane: colocated and CUDA IPC.

The port's counterpart of the JAX package's `disagg/device_transfer.py`.
Both lanes move a prompt's pages with one `kv_repage` launch that reads
the source pool and writes the destination pool in place
(`ops/kv_transfer.py`, `csrc/kv_transfer.cu`), under the same handle/page
protocol as the host lane:

1. **Colocated**: the source is in this process (a process-local registry
   keyed by transfer id; the descriptor's process token tells colocated
   sources from remote ones).  The kernel reads the other engine's pool.
2. **CUDA IPC**: the source is another process on the same card (the
   descriptor's ``cuda_ipc`` entry names the card's UUID).  The source
   exports its K and V pools once (`ipc_export`: PyTorch's own
   `UntypedStorage._share_cuda_`, which finds the `cudaMalloc` allocation's
   base under the caching allocator and sends the offset); the client maps
   them once per source lease (`IpcLane`, through
   `UntypedStorage._new_shared_cuda`) and drops the mapping when the lease
   goes.  Ordering: the source's engine records an interprocess event on
   its step thread right after the prompt's last KV write (so it covers
   no later work of that engine); the client waits on it on its engine's
   stream, launches the kernel, and synchronises before it sends the
   release frame, so the source cannot reuse a page under the read.
   This is the lane the JAX package's protocol reserves for a
   cross-process device pull (``dma_addr``), which its TPU plugin cannot
   serve.

Under tensor parallelism every rank of a prefill group exports its pools
(`TorchEngine.ipc_entries`: the descriptor's entry lists them under
``ranks``, each rank's pools holding its n_kv / tp heads), and every rank
of a decode group maps the source ranks whose heads it holds and re-pages
its own head window from each (`TorchEngine.import_ipc`: one windowed
`kv_repage` launch per overlapping source rank, through a ``kv_import``
plan).  The source's event is its leader's, recorded after the prompt's
last chunk; a follower's KV writes are complete before its share of that
chunk's last collective, which gloo (the backend of ranks sharing a card,
as the lane needs) copies to the host before the leader's returns.  The
colocated lane under tp moves the source's export (every kv head,
gathered through its group) into the destination's pages: one whole-row
re-page into a flat destination, or into a staging tensor of the
destination's page size that a tp destination imports.

A process cannot open its own IPC handle: that case is the colocated
lane, which the client tries first.  Pools allocated under
``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` cannot be exported
this way: a source on a card refuses to start under it (and the worker
refuses ``--disagg-role prefill``), since the host lane is no stand-in.
"""

from __future__ import annotations

import logging
import os
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..ops.kv_transfer import kv_repage

logger = logging.getLogger(__name__)

# process-local registry of live KvTransferSource objects: transfer_id ->
# source.  A descriptor whose process token matches ours refers to a
# source whose pools this process can read directly.
_PROCESS_TOKEN = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
_LOCAL_SOURCES: Dict[str, object] = {}


def process_token() -> str:
    return _PROCESS_TOKEN


def register_local(tid: str, source) -> None:
    _LOCAL_SOURCES[tid] = source


def unregister_local(tid: str) -> None:
    _LOCAL_SOURCES.pop(tid, None)


def local_source(descriptor: dict):
    """The colocated source for a descriptor, or None."""
    if descriptor.get("proc") != _PROCESS_TOKEN:
        return None
    return _LOCAL_SOURCES.get(descriptor.get("transfer_id", ""))


# -- colocated lane ------------------------------------------------------------ #


async def fetch_colocated(client, source, descriptor) -> List[int]:
    """Move a colocated source's held pages into freshly allocated pages of
    the client's engine with one re-page launch on the destination
    engine's stream (a device op: it runs between steps, under the step
    lock); then release the source's hold.  Returns the destination
    pages."""
    src_engine, dst_engine = source.engine, client.engine
    held = source._held.get(descriptor["transfer_id"])  # noqa: SLF001
    if held is None:
        raise RuntimeError(f"unknown transfer {descriptor['transfer_id']}")
    n_dst = -(-held.prompt_len // client.dest_layout.page_size)
    dest_pages = await dst_engine.alloc_pages(n_dst)
    try:
        if getattr(src_engine, "world", 1) > 1 or getattr(dst_engine, "world", 1) > 1:
            await _colocated_tp(src_engine, dst_engine, held, dest_pages)
        else:
            await _colocated_flat(src_engine, dst_engine, held, dest_pages)
    except BaseException:
        await dst_engine.free_pages(dest_pages)
        raise
    await source._release(descriptor["transfer_id"])  # noqa: SLF001
    return dest_pages


async def _colocated_tp(src_engine, dst_engine, held, dest_pages) -> None:
    """The colocated lane when either side is a group: the source's export
    (every kv head, from the pages' replica; a device op of its own
    engine) re-paged on the destination's device, straight into a flat
    destination's pool or into a staging tensor that a group destination
    imports (a ``kv_import`` to the pages' partition, or to every
    replica)."""
    k, v = await src_engine._device_op(  # noqa: SLF001
        lambda: src_engine._export_dev(held.pages))  # noqa: SLF001

    def op():
        dev = dst_engine.device
        sk, sv = k.to(dev), v.to(dev)
        n = len(held.pages)
        if getattr(dst_engine, "world", 1) == 1:
            kv_repage(sk, sv, dst_engine.kv.k, dst_engine.kv.v, range(n),
                      dest_pages, held.prompt_len)
            return
        # every layer of every head (a pipeline's pool holds its stage's)
        ps_d = dst_engine.kv.k.shape[2]
        stage = [torch.empty((sk.shape[0], len(dest_pages), ps_d,
                              *sk.shape[3:]),
                             dtype=dst_engine.kv.k.dtype, device=dev)
                 for _ in range(2)]
        kv_repage(sk, sv, stage[0], stage[1], range(n),
                  range(len(dest_pages)), held.prompt_len)
        dst_engine._import_dev(dest_pages, stage[0], stage[1])  # noqa: SLF001

    await dst_engine._device_op(op)  # noqa: SLF001


async def _colocated_flat(src_engine, dst_engine, held, dest_pages) -> None:
    def op():
        kv_repage(src_engine.kv.k, src_engine.kv.v, dst_engine.kv.k,
                  dst_engine.kv.v, held.pages, dest_pages, held.prompt_len)
        # the source's next step may reuse the pages once released:
        # engines on other streams wait for the read first
        stream = dst_engine._stream  # noqa: SLF001
        if stream is not None and stream != src_engine._stream:  # noqa: SLF001
            stream.synchronize()

    await dst_engine._device_op(op)  # noqa: SLF001


# -- CUDA IPC lane --------------------------------------------------------------- #


def _card(device: torch.device) -> torch.device:
    """The device with its index (a bare "cuda" means the current card)."""
    if device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def device_uuid(device: torch.device) -> str:
    return str(torch.cuda.get_device_properties(_card(device)).uuid)


def expandable_segments() -> bool:
    conf = ",".join(os.environ.get(v, "") for v in
                    ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"))
    return "expandable_segments:true" in conf.replace(" ", "").lower()


def ipc_export(engine) -> Dict[str, Any]:
    """The source's IPC entry for its K and V pools: the card's UUID, the
    pools' shape, stride and dtype, and for each pool what
    `UntypedStorage._share_cuda_` gives (the memory handle of its
    allocation, the byte offset and size of its storage in it, and the
    reference-count and event handles of PyTorch's IPC protocol), passed
    on as it is.  Made once: the pool tensors are never replaced (the
    captured graphs hold their addresses)."""
    if expandable_segments():
        raise ValueError(
            "the KV pools were allocated under PYTORCH_CUDA_ALLOC_CONF="
            "expandable_segments:True, whose memory CUDA IPC handles cannot "
            "export; unset it to serve the ipc lane")
    k = engine.kv.k
    entry: Dict[str, Any] = {
        "uuid": device_uuid(k.device), "shape": list(k.shape),
        "stride": list(k.stride()),
        "dtype": str(k.dtype).removeprefix("torch."), "lease": 0,
        "pp": getattr(engine, "pp", 1), "sp": getattr(engine, "sp", 1),
    }
    for name, t in (("k", engine.kv.k), ("v", engine.kv.v)):
        entry[name] = {"share": list(t.untyped_storage()._share_cuda_()),
                       "tensor_offset": t.storage_offset()}
    return entry


def rank_entries(entry: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Each source rank's pool entry, in rank order (a flat source's entry
    is its only rank's)."""
    return entry.get("ranks") or [entry]


def group_entry(entries: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The source entry a tp group publishes: rank 0's, with every rank's
    under ``ranks`` (a flat engine's is its own)."""
    if len(entries) == 1:
        return entries[0]
    return {**entries[0], "ranks": entries}


def open_ipc_pools(entry: Dict[str, Any], device: torch.device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map a source's K and V pools into this process (on the card the
    entry's UUID names): tensors over the source's memory."""
    from .transfer import DTYPES

    dtype = DTYPES[entry["dtype"]]
    out = []
    for name in ("k", "v"):
        p = entry[name]
        # the share's first field is the source's device index: ours here
        storage = torch.UntypedStorage._new_shared_cuda(
            _card(device).index, *p["share"][1:])
        typed = torch.storage.TypedStorage(wrap_storage=storage, dtype=dtype,
                                           _internal=True)
        out.append(torch._utils._rebuild_tensor(
            typed, p["tensor_offset"], tuple(entry["shape"]),
            tuple(entry["stride"])))
    return out[0], out[1]


def open_ipc_event(handle: Optional[bytes], device: torch.device):
    """The source's interprocess event of one transfer, or None."""
    if handle is None:
        return None
    return torch.cuda.Event.from_ipc_handle(_card(device), handle)


class IpcLane:
    """The client's side of the CUDA IPC lane: which descriptors it can
    serve, and the source pools it has mapped, opened once per source
    lease and closed (dropped: PyTorch closes the mapping with the last
    tensor over it) when the lease goes.  `opener` / `event_opener`
    replace the CUDA mapping (tests on the CPU inject them)."""

    def __init__(self, device: torch.device, opener=None, event_opener=None,
                 stages: int = 1, sp: int = 1):
        self.device = device
        # the destination's pipeline stages: each rank would need a window
        # of the source's layers as well as of its heads (ROADMAP 2.3b)
        self.stages = stages
        # the destination's sequence slots: each (replica, slot) of a
        # partitioned pool holds other pages (ROADMAP 2.4b)
        self.sp = sp
        self.injected = opener is not None
        self._open = opener or open_ipc_pools
        self._open_event = event_opener or open_ipc_event
        # (lease, k handle) -> (k, v) mapped pools; mapped on the engine's
        # step thread, dropped from the event loop's  # guarded-by: _lock
        self._maps: Dict[Tuple[int, bytes], Tuple[torch.Tensor, torch.Tensor]] = {}
        self._lock = threading.Lock()
        self.opened = 0  # mappings made, for tests and counters

    def usable(self, entry: Optional[Dict[str, Any]]) -> bool:
        """True when this lane serves the entry: every source rank's pools
        lie on this engine's card (or an opener was injected), and neither
        side is a pipeline (ROADMAP 2.3b: its pages then move on the host
        lane, as a dp source's do) or a sequence-parallel group (ROADMAP
        2.4b, the same way)."""
        if (not entry or self.stages > 1 or entry.get("pp", 1) > 1
                or self.sp > 1 or entry.get("sp", 1) > 1):
            return False
        if self.injected:
            return True
        return (self.device.type == "cuda"
                and all(e.get("uuid") == device_uuid(self.device)
                        for e in rank_entries(entry)))

    def pools(self, entry: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (int(entry.get("lease", 0)), bytes(entry["k"]["share"][1]))
        with self._lock:
            pools = self._maps.get(key)
            if pools is None:
                pools = self._open(entry, self.device)
                self._maps[key] = pools
                self.opened += 1
            return pools

    def event(self, entry: Dict[str, Any]):
        return self._open_event(entry.get("event"), self.device)

    def drop(self, lease: int) -> int:
        """Close the mappings of a source lease; returns how many."""
        with self._lock:
            keys = [k for k in self._maps if k[0] == int(lease)]
            for k in keys:
                del self._maps[k]
            return len(keys)

    @property
    def mapped(self) -> int:
        with self._lock:
            return len(self._maps)


async def fetch_ipc(client, descriptor) -> List[int]:
    """Move a transfer's pages from a source process's pools on this card:
    allocate the destination pages, then as one device op map the source
    pools (once per lease, through the client's `IpcLane`), wait on the
    source's event, launch the re-page on every destination rank
    (`TorchEngine.import_ipc`: one whole-row launch between flat engines,
    a head window per overlapping source rank under tp) and synchronise;
    only then release the source's hold.  Any failure frees the
    destination pages, releases the hold and raises (the caller prefills
    locally)."""
    engine = client.engine
    entry = descriptor["cuda_ipc"]
    prompt_len = int(descriptor["prompt_len"])
    n_dst = -(-prompt_len // client.dest_layout.page_size)
    dest_pages = await engine.alloc_pages(n_dst)
    try:
        await engine._device_op(lambda: engine.import_ipc(  # noqa: SLF001
            entry, dest_pages, prompt_len, client.ipc))
    except BaseException:
        await engine.free_pages(dest_pages)
        await client._release_remote(descriptor)  # noqa: SLF001
        raise
    await client._release_remote(descriptor)  # noqa: SLF001
    return dest_pages
