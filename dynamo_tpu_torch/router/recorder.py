"""KV event recorder + replay: the port's copy of the JAX package's
`router/recorder.py` (reference lib/llm/src/kv_router/recorder.rs —
capture the KV event stream to a file, replay it later into an indexer
for offline router analysis and benchmarks).

Record: drain a component's durable KV-event stream to JSONL, one event
per line with its stream sequence number.
Replay: feed a recorded file back into a `RadixIndex` (optionally
time-scaled) — the deterministic input for router benchmarks.

CLI: ``python -m dynamo_tpu_torch.router.recorder --control H:P --component
backend --out events.jsonl [--follow]``
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Iterator, Optional, TextIO

from ..runtime.transport.wire import unpack
from .indexer import RadixIndex
from .publisher import kv_stream_name

logger = logging.getLogger(__name__)


class KvEventRecorder:
    """Drains a KV-event stream to a JSONL file."""

    def __init__(self, runtime, namespace: str, component: str, out: TextIO):
        self.runtime = runtime
        self.stream = kv_stream_name(namespace, component)
        self.out = out
        self.events_written = 0
        self._task: Optional[asyncio.Task] = None
        self._stop = asyncio.Event()

    async def drain_once(self, after: int = 0) -> int:
        """Fetch everything currently retained after `after`; returns the
        last sequence seen."""
        entries, last, first_avail = await self.runtime.control.stream_fetch(
            self.stream, after=after
        )
        if after and first_avail > after + 1:
            logger.warning(
                "recorder gap: events %d..%d aged out of retention",
                after + 1, first_avail - 1,
            )
        for entry in entries:
            ev = unpack(entry["data"])
            self.out.write(json.dumps({"seq": entry["seq"], **ev}) + "\n")
            self.events_written += 1
        self.out.flush()
        # cursor = last entry WE saw, not the stream's global last_seq —
        # a fetch truncated by `limit` must resume where it stopped
        return entries[-1]["seq"] if entries else after

    async def follow(self, poll_s: float = 0.5) -> None:
        after = 0
        while not self._stop.is_set():
            after = await self.drain_once(after)
            try:
                await asyncio.wait_for(self._stop.wait(), poll_s)
            except asyncio.TimeoutError:
                pass

    def start(self) -> "KvEventRecorder":
        self._task = asyncio.get_running_loop().create_task(self.follow())
        return self

    async def stop(self) -> None:
        self._stop.set()
        if self._task:
            await asyncio.gather(self._task, return_exceptions=True)


def read_events(fh: TextIO) -> Iterator[dict]:
    for line in fh:
        line = line.strip()
        if line:
            yield json.loads(line)


def replay_into_index(fh: TextIO, index: Optional[RadixIndex] = None
                      ) -> RadixIndex:
    """Rebuild a radix index from a recording — what the router's state
    would have been after the captured traffic."""
    index = index or RadixIndex()
    for ev in read_events(fh):
        if ev["kind"] == "stored":
            index.apply_stored(ev["worker_id"], ev["block_hashes"])
        elif ev["kind"] == "removed":
            index.apply_removed(ev["worker_id"], ev["block_hashes"])
        elif ev["kind"] == "cleared":
            index.clear_worker(ev["worker_id"])
    return index


def main(argv=None) -> None:
    import argparse
    import signal
    import sys

    ap = argparse.ArgumentParser("dynamo_tpu_torch.router.recorder")
    ap.add_argument("--control", required=True)
    ap.add_argument("--namespace", default="dynamo")
    ap.add_argument("--component", default="backend")
    ap.add_argument("--out", required=True, help="JSONL path ('-' = stdout)")
    ap.add_argument("--follow", action="store_true",
                    help="keep recording until SIGINT/SIGTERM")
    args = ap.parse_args(argv)

    async def run():
        from ..runtime import DistributedRuntime

        runtime = await DistributedRuntime.connect(args.control)
        out = sys.stdout if args.out == "-" else open(args.out, "w")
        rec = KvEventRecorder(runtime, args.namespace, args.component, out)
        try:
            if args.follow:
                stop = asyncio.Event()
                loop = asyncio.get_running_loop()
                for sig in (signal.SIGINT, signal.SIGTERM):
                    loop.add_signal_handler(sig, stop.set)
                rec.start()
                await stop.wait()
                await rec.stop()
            else:
                await rec.drain_once()
        finally:
            if out is not sys.stdout:
                out.close()
            await runtime.shutdown(graceful=False)
        print(f"recorded {rec.events_written} events", file=sys.stderr)

    asyncio.run(run())


if __name__ == "__main__":
    main()
