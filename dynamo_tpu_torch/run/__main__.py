"""Unified launcher of the port: `python -m dynamo_tpu_torch.run --in X
--out engine --model M`.

  --in http    the OpenAI HTTP frontend over a local TorchEngine worker
               (default): an embedded control plane unless --control is
               given, the worker registered on it (publishing its KV
               events and load), the model watcher (``--router-mode
               round_robin|random|kv``, ``--busy-threshold``) and
               `HttpService`; prints ``READY http://host:port``.
  --in batch   JSONL of token-id requests in, JSONL out (--input-file,
               --output-file): every request sent to
               `TorchEngine.generate` at once.

``--model`` takes a checkpoint directory (the loader and tokenizer.json),
``tiny`` or a canned config name (``llama-3.1-8b``, ``gpt-oss-20b``, ...;
random weights from ``--seed``); ``--quantization int8`` serves int8
projections; ``--tp N`` (``--tp-devices``) serves on a tensor-parallel
group of N processes, ``--dp D`` on D replicas of it (``--kv-partition``
partitions the pool over them), ``--pp S`` stages the layers over S
pipeline stages of such groups; see `dynamo_tpu_torch.worker`.  Runs on CUDA unless
given ``--device cpu``.

A batch input line is a JSON object with ``token_ids`` plus optional
sampling fields (``temperature``, ``top_k``, ``top_p``, ``seed``,
``frequency_penalty``, ``presence_penalty``, ``logprobs``) and stop fields
(``max_tokens``, ``stop_token_ids``, ``ignore_eos``); nested
``sampling_options`` / ``stop_conditions`` objects are taken as they are.
The output is one JSON line per input, in input order: ``{"index",
"token_ids", "finish_reason"}``.  The text/endpoint inputs and the
mock/echo/dyn outputs of the JAX launcher are later slices.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import sys
from typing import List, Optional

_SAMPLING = ("temperature", "top_k", "top_p", "seed", "frequency_penalty",
             "presence_penalty", "logprobs", "top_logprobs")
_STOP = ("max_tokens", "stop_token_ids", "ignore_eos", "stop_sequences")


def parse_args(argv=None):
    from ..worker.__main__ import add_model_args

    ap = argparse.ArgumentParser("dynamo_tpu_torch.run")
    ap.add_argument("--in", dest="in_mode", default="http",
                    choices=["http", "batch"])
    ap.add_argument("--out", dest="out_mode", default="engine",
                    choices=["engine"])
    ap.add_argument("--control", default="",
                    help="existing control plane address (default: embedded)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--namespace", default="dynamo")
    ap.add_argument("--router-mode", default="round_robin",
                    choices=["round_robin", "random", "kv"])
    ap.add_argument("--busy-threshold", type=float, default=0.0,
                    help="kv-router mode: shed load (503) when every "
                         "worker's kv_usage exceeds this (0 = off)")
    ap.add_argument("--input-file", default=None)
    ap.add_argument("--output-file", default=None)
    add_model_args(ap)
    return ap.parse_args(argv)


def to_request(line: dict) -> dict:
    so = dict(line.get("sampling_options") or {})
    sc = dict(line.get("stop_conditions") or {})
    so.update({k: line[k] for k in _SAMPLING if k in line})
    sc.update({k: line[k] for k in _STOP if k in line})
    return {"token_ids": list(line["token_ids"]), "sampling_options": so,
            "stop_conditions": sc}


async def run_batch(engine, requests: List[dict]) -> List[dict]:
    async def one(i, req):
        toks, reason = [], None
        async for delta in engine.generate(req):
            toks.extend(delta["token_ids"])
            reason = delta["finish_reason"]
            if delta.get("error"):
                return {"index": i, "token_ids": toks, "finish_reason": reason,
                        "error": delta["error"]}
        return {"index": i, "token_ids": toks, "finish_reason": reason}

    try:
        return await asyncio.gather(*[one(i, r) for i, r in enumerate(requests)])
    finally:
        await engine.shutdown()


async def start_stack(args, engine, mdc):
    """Runtime (embedded control plane unless --control), the engine's
    worker endpoint, the model watcher and the HTTP service."""
    from ..frontend import FrontendMetrics, HttpService, ModelManager, ModelWatcher
    from ..frontend.__main__ import kv_factory
    from ..runtime import DistributedRuntime
    from ..worker import serve_engine

    if args.control:
        runtime = await DistributedRuntime.connect(args.control)
    else:
        runtime = await DistributedRuntime.detached()
    await serve_engine(runtime, engine, mdc, namespace=args.namespace)
    manager = ModelManager()
    metrics = FrontendMetrics()
    watcher = await ModelWatcher(
        runtime, manager, router_mode=args.router_mode,
        kv_chooser_factory=kv_factory(runtime, args), metrics=metrics).start()
    await watcher.wait_for_model(mdc.name)
    http = await HttpService(manager, host=args.host, port=args.port,
                             metrics=metrics).start()
    return runtime, watcher, http


async def serve_http(args, engine, mdc) -> None:
    runtime, watcher, http = await start_stack(args, engine, mdc)
    print(f"READY http://{args.host}:{http.port}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    try:
        await stop.wait()
    finally:
        await http.stop()
        await watcher.stop()
        await runtime.shutdown(graceful=False)
        await engine.shutdown()


def main(argv: Optional[list] = None) -> int:
    from ..worker.__main__ import build_engine

    args = parse_args(argv)
    if args.in_mode == "batch" and not args.input_file:
        print("--in batch needs --input-file", file=sys.stderr)
        return 2
    engine, mdc = build_engine(args)
    if args.in_mode == "http":
        asyncio.run(serve_http(args, engine, mdc))
        return 0
    with open(args.input_file) as f:
        requests = [to_request(json.loads(ln)) for ln in f if ln.strip()]
    results = asyncio.run(run_batch(engine, requests))
    out = open(args.output_file, "w") if args.output_file else sys.stdout
    try:
        for r in results:
            out.write(json.dumps(r) + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
