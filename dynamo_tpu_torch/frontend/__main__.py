"""Frontend CLI: `python -m dynamo_tpu_torch.frontend --control HOST:PORT
--port 8000`.

The port's copy of `python -m dynamo_tpu.frontend`: the OpenAI HTTP
server, model discovery and routed pipelines, round-robin, random or
KV-aware (``--router-mode kv``, with ``--busy-threshold`` shedding load
as 503 when every worker is above it), with request migration on worker
loss and ``/v1/embeddings``.  TLS, gRPC, shards, the status
server and the fleet telemetry plane are later slices.  Prints ``READY
http://host:port``.
"""

import argparse
import asyncio
import logging
import os
import signal


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="dynamo_tpu_torch OpenAI frontend")
    env_control = os.environ.get("DYN_CONTROL", "")
    ap.add_argument("--control", required=not env_control, default=env_control,
                    help="control plane host:port")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--namespace", default="dynamo",
                    help="accepted for symmetry; model cards carry their "
                         "own namespace and the watcher follows all of them")
    ap.add_argument("--router-mode", default="round_robin",
                    choices=["round_robin", "random", "kv"])
    ap.add_argument("--busy-threshold", type=float, default=0.0,
                    help="kv-router mode: shed load (503) when every "
                         "worker's kv_usage exceeds this (0 = off)")
    ap.add_argument("--sse-coalesce", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="merge same-choice token deltas into one SSE frame "
                         "when a connection's write queue backs up "
                         "(default: DYN_TPU_SSE_COALESCE, else on)")
    ap.add_argument("--log-level", default="info")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level.upper(),
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    asyncio.run(_run(args))


def kv_factory(runtime, args):
    """The KvRouter factory of `--router-mode kv` (None in other modes)."""
    if args.router_mode != "kv":
        return None
    from ..router import kv_chooser_factory

    return kv_chooser_factory(runtime, busy_threshold=args.busy_threshold)


async def _run(args) -> None:
    from ..runtime import DistributedRuntime
    from . import FrontendMetrics, HttpService, ModelManager, ModelWatcher
    from .openai_http import _env_bool

    runtime = await DistributedRuntime.connect(args.control)
    manager = ModelManager()
    # one metrics surface shared by the HTTP service and the discovery /
    # migration layer, so migrations_total lands on the same /metrics
    metrics = FrontendMetrics()
    watcher = await ModelWatcher(
        runtime, manager, router_mode=args.router_mode,
        kv_chooser_factory=kv_factory(runtime, args), metrics=metrics).start()
    # the serving CLI turns coalescing on unless the flag/env says otherwise
    sse_coalesce = (args.sse_coalesce if args.sse_coalesce is not None
                    else _env_bool("DYN_TPU_SSE_COALESCE", True))
    http = await HttpService(manager, host=args.host, port=args.port,
                             metrics=metrics,
                             sse_coalesce=sse_coalesce).start()
    print(f"READY http://{args.host}:{http.port}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await http.stop()
    await watcher.stop()
    await runtime.shutdown()


if __name__ == "__main__":
    main()
