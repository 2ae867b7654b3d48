"""SSE egress data plane — the frontend's streaming write path.

The port's copy of the JAX package's `frontend/egress.py` (stdlib only).
The reference serves deltas from a compiled axum frontend plus a
dedicated PushRouter egress stage; our per-delta Python cost
(dict build + ``json.dumps`` + f-string encode + one ``resp.write`` per
token) is what caps concurrent streams per process.  This module is the
single seam every SSE byte goes through (docs/frontend_dataplane.md):

- ``ChunkTemplate`` — zero-copy detokenize-to-frame: the chunk skeleton
  (id/model/created/choice index) is serialized ONCE per (stream,
  choice); each delta splices the escaped content string between the
  pre-encoded prefix/suffix bytes.  ``encode_basestring_ascii`` is the
  exact escaper ``json.dumps`` uses internally, so the uncoalesced frame
  is byte-identical to the legacy ``json.dumps`` round trip
  (tests/test_frontend_egress.py pins this).
- ``StreamEgress`` — per-stream frame buffer with write batching and
  optional same-template delta coalescing.  The serving loop drains its
  queue in bursts; everything a burst produced goes out in ONE
  ``resp.write``.  Coalescing only ever merges deltas that were queued
  together (i.e. the connection's write queue had backed up), so an
  unloaded stream emits one frame per delta either way.

Knobs (read by HttpService at construction):

- ``DYN_TPU_SSE_COALESCE``      merge same-choice deltas under
                                backpressure (default off; the frontend
                                CLI turns it on)
- ``DYN_TPU_SSE_COALESCE_MAX``  max deltas merged into one frame (64)
- ``DYN_TPU_SSE_LEGACY``        per-delta dict + json.dumps writer (the
                                pre-optimization path, kept for A/B —
                                bench's frontend_saturation phase
                                measures both arms)
"""

from __future__ import annotations

import json
import time
from json.encoder import encode_basestring_ascii as _escape
from typing import Any, Dict, List, Optional

__all__ = [
    "CONTENT_SENTINEL",
    "ChunkTemplate",
    "StreamEgress",
    "sse_frame",
]

# placeholder content spliced into the chunk skeleton; pure ASCII with no
# JSON-escaped characters so it serializes verbatim (and can never appear
# in a model/request id, which are hex + known literals)
CONTENT_SENTINEL = "*DYN-TPU-CONTENT-SLOT*"

_PING = b": keep-alive\n\n"


def sse_frame(obj: Any) -> bytes:
    """One SSE data frame — byte-identical to the legacy writer's
    ``f"data: {json.dumps(obj)}\\n\\n".encode()``."""
    return b"data: " + json.dumps(obj).encode() + b"\n\n"


class ChunkTemplate:
    """Pre-serialized SSE frame skeleton with a spliced content slot.

    Built from a chunk dict whose content field holds CONTENT_SENTINEL;
    ``frame(text)`` replaces the sentinel *string literal* with the
    escaped text, skipping per-delta dict construction and the full
    ``json.dumps`` walk."""

    __slots__ = ("prefix", "suffix")

    def __init__(self, chunk_with_sentinel: Dict[str, Any]):
        body = json.dumps(chunk_with_sentinel)
        slot = '"' + CONTENT_SENTINEL + '"'
        if body.count(slot) != 1:
            raise ValueError(
                "chunk skeleton must contain CONTENT_SENTINEL exactly once"
            )
        pre, _, post = body.partition(slot)
        self.prefix = b"data: " + pre.encode()
        self.suffix = post.encode() + b"\n\n"

    def frame(self, text: str) -> bytes:
        # _escape returns the quoted, escaped string — exactly the bytes
        # json.dumps would have embedded for this value
        return self.prefix + _escape(text).encode() + self.suffix


class StreamEgress:
    """Per-stream SSE writer: frame building, write batching, optional
    same-template coalescing, and write-anchored keepalive bookkeeping.

    The wall-clock the serving loop's keepalive keys off is
    ``last_write`` — the time of the last bytes actually written to the
    connection — NOT the time of the last queue item (a slow-but-steady
    stream of token deltas must still never leave the socket silent
    longer than the keepalive interval when deltas stop producing
    writes, and an idle proxy must see pings during a long prefill).

    ``cpu_ns`` accumulates ``perf_counter_ns`` around the synchronous
    build/serialize/write sections only — the per-token frontend cost
    the saturation bench reports and the tier-1 micro-gate pins."""

    __slots__ = (
        "resp", "coalesce", "coalesce_max",
        "_buf", "_open_tmpl", "_open_texts",
        "frames", "deltas", "coalesced", "writes", "backpressure_events",
        "depth_samples", "bytes_out", "cpu_ns", "last_write",
    )

    _MAX_DEPTH_SAMPLES = 2048

    def __init__(self, resp, *, coalesce: bool = False,
                 coalesce_max: int = 64):
        self.resp = resp
        self.coalesce = coalesce
        self.coalesce_max = max(1, int(coalesce_max))
        self._buf: List[bytes] = []
        self._open_tmpl: Optional[ChunkTemplate] = None
        self._open_texts: List[str] = []
        self.frames = 0
        self.deltas = 0
        self.coalesced = 0
        self.writes = 0
        self.backpressure_events = 0
        self.depth_samples: List[int] = []
        self.bytes_out = 0
        self.cpu_ns = 0
        self.last_write = time.monotonic()

    # -- frame building ------------------------------------------------------ #

    def add_fast(self, tmpl: ChunkTemplate, text: str) -> None:
        """One simple content delta via the zero-copy template path.
        Consecutive deltas sharing a template object (same stream,
        choice and kind) merge into one frame when coalescing is on —
        which can only happen when several deltas were drained between
        flushes, i.e. under backpressure."""
        t0 = time.perf_counter_ns()
        self.deltas += 1
        if self.coalesce:
            if (self._open_tmpl is tmpl
                    and len(self._open_texts) < self.coalesce_max):
                self._open_texts.append(text)
                self.coalesced += 1
            else:
                self._seal()
                self._open_tmpl = tmpl
                self._open_texts.append(text)
        else:
            self._buf.append(tmpl.frame(text))
        self.cpu_ns += time.perf_counter_ns() - t0

    def add_obj(self, obj: Dict[str, Any]) -> None:
        """Full-serialization frame (finish / logprobs / parser / error
        chunks); ordering relative to fast-path frames is preserved."""
        t0 = time.perf_counter_ns()
        self.deltas += 1
        self._seal()
        self._buf.append(sse_frame(obj))
        self.cpu_ns += time.perf_counter_ns() - t0

    def _seal(self) -> None:
        tmpl = self._open_tmpl
        if tmpl is not None:
            texts = self._open_texts
            self._buf.append(tmpl.frame(
                texts[0] if len(texts) == 1 else "".join(texts)
            ))
            self._open_tmpl = None
            self._open_texts = []

    # -- IO ------------------------------------------------------------------ #

    def note_backpressure(self, depth: int) -> None:
        """Record that a drain started with `depth` items already queued
        (the pump outran the writer)."""
        self.backpressure_events += 1
        if len(self.depth_samples) < self._MAX_DEPTH_SAMPLES:
            self.depth_samples.append(depth)

    async def flush(self) -> None:
        """Write every buffered frame in ONE resp.write."""
        t0 = time.perf_counter_ns()
        self._seal()
        buf = self._buf
        if not buf:
            self.cpu_ns += time.perf_counter_ns() - t0
            return
        data = buf[0] if len(buf) == 1 else b"".join(buf)
        self.frames += len(buf)
        self.writes += 1
        self.bytes_out += len(data)
        self._buf = []
        await self.resp.write(data)
        self.cpu_ns += time.perf_counter_ns() - t0
        self.last_write = time.monotonic()

    async def ping(self) -> None:
        """Keepalive comment frame (proxies during long prefills)."""
        await self.resp.write(_PING)
        self.bytes_out += len(_PING)
        self.last_write = time.monotonic()
