"""Standalone KV-router service: `python -m dynamo_tpu_torch.router`.

The port's copy of `python -m dynamo_tpu.router` (reference
components/src/dynamo/router): a routing-as-a-service process other
components call to pick a worker (the disagg decode handler uses one as
its *prefill router*).  Prints ``READY router ...``.

Serves `{namespace}.{component}.generate` with two request shapes:
- {"op": "choose", "token_ids": [...], "request_id": ...}
      → {"worker_id": int}   (KV-aware selection over the target workers;
        the id is a PACKED (instance, dp_rank) key — callers unpack with
        `router.worker_key.unpack_worker`, direct to the instance, and
        stamp dp_rank on the request)
- {"op": "finished", "request_id": ...}
      → {"status": "ok"}     (releases the request's load tracking)
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

logger = logging.getLogger(__name__)


async def _amain(args) -> None:
    from ..runtime import DistributedRuntime
    from .kv_router import KvRouter

    runtime = await DistributedRuntime.connect(args.control)
    target_ep = (
        runtime.namespace(args.namespace)
        .component(args.target_component)
        .endpoint(args.target_endpoint)
    )
    client = target_ep.client()
    await client.start()
    router = KvRouter(
        runtime, args.namespace, args.target_component, client,
        block_size=args.block_size,
        overlap_score_weight=args.overlap_score_weight,
        temperature=args.router_temperature,
        use_approx=args.no_kv_events,
    )
    await router.start()

    async def handle(request, context):
        op = request.get("op", "choose")
        if op == "choose":
            try:
                wid = await router.choose(request)
                yield {"worker_id": wid}
            except Exception as e:  # noqa: BLE001 — report, don't kill the service
                yield {"error": str(e)}
        elif op == "finished":
            router.mark_finished(request.get("request_id", ""))
            yield {"status": "ok"}
        else:
            yield {"error": f"unknown op {op!r}"}

    ep = (
        runtime.namespace(args.namespace)
        .component(args.component)
        .endpoint("generate")
    )
    await ep.serve_endpoint(handle)
    print(f"READY router {args.namespace}.{args.component} -> "
          f"{args.target_component}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await router.stop()
    await client.stop()
    await runtime.shutdown()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("dynamo_tpu_torch.router")
    ap.add_argument("--control", required=True)
    ap.add_argument("--namespace", default="dynamo")
    ap.add_argument("--component", default="router",
                    help="component this service registers as")
    ap.add_argument("--target-component", default="prefill",
                    help="worker set routed over")
    ap.add_argument("--target-endpoint", default="generate")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--overlap-score-weight", type=float, default=1.0)
    ap.add_argument("--router-temperature", type=float, default=0.0)
    ap.add_argument("--no-kv-events", action="store_true",
                    help="use the approx indexer (workers emit no events)")
    ap.add_argument("--log-level", default="info")
    return ap


def main() -> None:
    args = build_parser().parse_args()
    logging.basicConfig(level=args.log_level.upper(),
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    asyncio.run(_amain(args))


if __name__ == "__main__":
    main()
