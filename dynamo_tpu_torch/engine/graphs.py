"""CUDA-graph runner of the engine's device loop, and pinned host fetches.

The counterpart of the JAX engine's compiled-step caches (`_ljit` and
`compiled_variants` / `compiled_decode_rungs` / `rung_histogram`): the
JAX engine compiles one program per (rung, variant) and runs K steps with
no host between them; here each decode block function is captured ONCE
per key -- (kind, rung, greedy, penalized, with_top, table-width bucket,
...) -- into a `torch.cuda.CUDAGraph` and replayed for every later block.

- Each graph owns static input and output tensors.  A dispatch copies its
  changed inputs straight into the static inputs (page-locked host
  tensors host-to-device, device carries device-to-device) and replays;
  the outputs stay valid until the next replay of any graph.
- All captures share one memory pool (`torch.cuda.graph_pool_handle()`),
  so a later capture reuses the intermediates an earlier one freed.
  That is safe because graphs replay one at a time on one stream and a
  graph's outputs are consumed (copied to the host, or into the next
  graph's inputs) before any other graph replays: a replay may
  overwrite another graph's outputs.
- A new key is warmed up once on a side stream (library handles, the
  kernels' first-use `cudaFuncSetAttribute`), then captured, then
  replayed.  The warm-up is a real run of the block on the dispatch's own
  inputs: the block's only in-place effect is the KV it writes, and the
  replay writes the same values into the same slots.
- A capture or a replay that fails raises: there is no eager fallback on
  CUDA and no switch to turn capture off.
- Kernel launches inside a graph happen at replay, where the Python
  wrappers do not run, so the runner counts them: the capturing thread's
  launches go to the capture's own record (`ops/_launches.recording`),
  which is added to the registry at every replay.
- The data-parallel ranks of one worker are engines in one process, each
  with its own runner on its own step thread.  A capture synchronizes the
  device and empties the allocator's cache, which the allocator refuses
  while another thread captures, so captures are serialised by one
  process-wide lock; the other ranks go on launching and replaying
  meanwhile, and their launches stay in the registry.

On the CPU the same block functions run eagerly on the same inputs (the
plain kernel versions), so the CPU tests exercise the code the graphs
hold; the runner still records each key, so a test can hold the key set
fixed the way the JAX tests hold compiles fixed.

An engine of a tp group (``capture=False``, chosen by the engine from its
group) runs the blocks eagerly on the card too: their model collectives
go through `torch.distributed`, and gloo's cannot be captured into a
CUDA graph.  Its stats say ``"mode": "eager"``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, List, Optional

import numpy as np
import torch

from ..ops._launches import LAUNCHES, count_launch, recording

# one capture at a time in the process, whichever runner makes it
_CAPTURE_LOCK = threading.Lock()

BlockFn = Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]


@dataclass
class _Graph:
    fn: BlockFn
    inputs: Dict[str, torch.Tensor]
    outputs: Dict[str, torch.Tensor] = field(default_factory=dict)
    graph: Optional["torch.cuda.CUDAGraph"] = None
    launches: Dict[str, int] = field(default_factory=dict)
    capture_s: float = 0.0
    pool_bytes: int = 0
    replays: int = 0


class GraphRunner:
    """Captures and replays the engine's block functions (CUDA), or runs
    them eagerly (CPU).  One runner per engine; used from the engine's
    step thread only (runners of other engines may run beside it)."""

    def __init__(self, device: torch.device, capture: bool = True):
        self.device = device
        # capture and replay graphs (CUDA), or run each block eagerly
        self.cuda = device.type == "cuda" and capture
        self._graphs: Dict[Hashable, _Graph] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.cuda else None
        # one side stream for every warm-up and capture: the allocator
        # reuses a freed block only on the stream that allocated it, so
        # captures on one stream share the pool's freed intermediates
        self._side = torch.cuda.Stream(device) if self.cuda else None
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        self.last_key: Optional[Hashable] = None
        # kernel launches made by replays (also added to LAUNCHES)
        self.replayed_launches: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)

    @property
    def keys(self) -> List[Hashable]:
        return sorted(self._graphs, key=repr)

    def stats(self) -> dict:
        return {"mode": "graphs" if self.cuda else "eager",
                "graphs": len(self._graphs), "captures": self.captures,
                "replays": self.replays,
                "capture_seconds": self.capture_seconds,
                "pool_bytes": self.pool_bytes}

    def graph_stats(self) -> List[dict]:
        return [{"key": repr(k), "capture_s": g.capture_s,
                 "pool_bytes": g.pool_bytes, "replays": g.replays,
                 "launches_per_replay": dict(g.launches)}
                for k, g in sorted(self._graphs.items(), key=lambda kv: repr(kv[0]))]

    def run(self, key: Hashable, fn: BlockFn,
            updates: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Run the block of `key`: `updates` replace inputs of the graph
        (all of them the first time a key is seen; later dispatches may
        pass only what changed, e.g. a chained block's carries).  Returns
        the block's outputs, valid until the next run of any key."""
        self.last_key = key
        g = self._graphs.get(key)
        if g is None:
            g = _Graph(fn, {})
            self._graphs[key] = g
            if self.cuda:
                try:
                    self._capture(g, updates)
                except BaseException:
                    del self._graphs[key]
                    raise
        elif self.cuda:
            for name, t in updates.items():
                dst = g.inputs[name]
                if t is dst:
                    continue
                if tuple(t.shape) != tuple(dst.shape):
                    raise ValueError(
                        f"graph {key!r}: input {name} has shape "
                        f"{tuple(t.shape)}, captured {tuple(dst.shape)}")
                dst.copy_(t, non_blocking=True)
        if not self.cuda:
            g.inputs.update({k: t.to(self.device, non_blocking=True)
                             for k, t in updates.items()})
            g.outputs = g.fn(g.inputs)
            return g.outputs
        g.graph.replay()
        g.replays += 1
        self.replays += 1
        for name, n in g.launches.items():
            count_launch(name, n)
            self.replayed_launches[name] += n
        return g.outputs

    def _capture(self, g: _Graph, inputs: Dict[str, torch.Tensor]) -> None:
        t0 = time.perf_counter()
        stream = torch.cuda.current_stream(self.device)
        g.inputs = {k: torch.empty_like(v, device=self.device).copy_(
                        v, non_blocking=True) for k, v in inputs.items()}
        side = self._side
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            g.fn(g.inputs)  # warm-up: a real run, discarded
        stream.wait_stream(side)
        with _CAPTURE_LOCK:
            # what the capture adds to the shared pool (entering the
            # capture empties the allocator's cache, so empty it first
            # here too); other ranks' allocations meanwhile count in it
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved0 = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            # thread-local capture: the drain thread may wait on events,
            # and other ranks' step threads launch, while this one captures
            with recording() as launches, torch.cuda.graph(
                    graph, pool=self._pool, stream=side,
                    capture_error_mode="thread_local"):
                g.outputs = g.fn(g.inputs)
            g.launches = dict(launches)
            stream.wait_stream(side)
            g.graph = graph
            torch.cuda.synchronize(self.device)
            g.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved0
        g.capture_s = time.perf_counter() - t0
        self.captures += 1
        self.capture_seconds += g.capture_s
        self.pool_bytes += g.pool_bytes

    def check_replay(self, key: Hashable, names: List[str]) -> Dict[str, bool]:
        """Debugging check of one captured block: run its function
        uncaptured on the inputs of its last dispatch and compare the named
        outputs, bit for bit, with a replay on the same inputs.  Both runs
        rewrite the KV slots of that dispatch with the same values, so call
        it only while those slots still belong to the same sequences (at
        the end of a run, before the pages are reused)."""
        g = self._graphs[key]
        saved = {k: v.clone() for k, v in g.inputs.items()}
        eager = {k: v.clone() for k, v in g.fn(saved).items()}
        replayed = self.run(key, g.fn, {})
        return {n: bool(torch.equal(eager[n], replayed[n])) for n in names}


class HostFetch:
    """A device tensor on its way to the host: an async copy into a pinned
    buffer plus the event behind it (the counterpart of JAX's
    `copy_to_host_async` + `device_get`).  On the CPU the tensor is
    already host memory."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t
            self._event = None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()
