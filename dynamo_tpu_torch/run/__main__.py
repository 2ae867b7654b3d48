"""Batch launcher of the port: `python -m dynamo_tpu_torch.run --in batch
--out engine --model {tiny,llama-3.1-8b,...} --seed N --input-file
prompts.jsonl [--device cpu]`.

Each input line is a JSON object with ``token_ids`` plus optional
sampling fields (``temperature``, ``top_k``, ``top_p``, ``seed``,
``frequency_penalty``, ``presence_penalty``, ``logprobs``) and stop fields
(``max_tokens``, ``stop_token_ids``, ``ignore_eos``); nested
``sampling_options`` / ``stop_conditions`` objects are taken as they are.
Every request is sent to `TorchEngine.generate` at once; the output is one
JSON line per input, in input order: ``{"index", "token_ids",
"finish_reason"}``.  Weights are random, drawn from ``--seed``.

``--in http`` is not ported yet: the OpenAI frontend, the tokenizer and
the control-plane transport need packages the GPU machine does not have.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from typing import List, Optional

import torch

_SAMPLING = ("temperature", "top_k", "top_p", "seed", "frequency_penalty",
             "presence_penalty", "logprobs", "top_logprobs")
_STOP = ("max_tokens", "stop_token_ids", "ignore_eos", "stop_sequences")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_args(argv=None):
    ap = argparse.ArgumentParser("dynamo_tpu_torch.run")
    ap.add_argument("--in", dest="in_mode", default="batch",
                    choices=["batch", "http"])
    ap.add_argument("--out", dest="out_mode", default="engine",
                    choices=["engine"])
    ap.add_argument("--model", default="tiny",
                    help="tiny or a canned config name (llama-3.1-8b, ...)")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the model's depth (widths stay as published)")
    ap.add_argument("--dtype", default=None, choices=sorted(_DTYPES),
                    help="default: float32 for tiny, bfloat16 otherwise")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; there is no silent fallback")
    ap.add_argument("--input-file", default=None)
    ap.add_argument("--output-file", default=None)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=1024)
    ap.add_argument("--max-model-len", type=int, default=4096)
    ap.add_argument("--max-num-seqs", type=int, default=8)
    ap.add_argument("--max-prefill-tokens", type=int, default=512)
    return ap.parse_args(argv)


def build_engine(args):
    """(TorchEngine, ModelConfig) from the CLI arguments."""
    import dataclasses

    from ..device import resolve_device
    from ..engine import EngineConfig, TorchEngine
    from ..models import CONFIGS, init_params, tiny_config

    device = resolve_device(args.device)
    if args.model == "tiny":
        cfg = tiny_config()
    elif args.model in CONFIGS:
        cfg = CONFIGS[args.model]
    else:
        raise SystemExit(f"unknown model {args.model!r}: tiny or one of "
                         f"{sorted(CONFIGS)}")
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_hidden_layers=args.num_layers)
    dtype = _DTYPES[args.dtype or ("float32" if args.model == "tiny" else "bfloat16")]
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = init_params(cfg, gen, dtype=dtype, device=device)
    ecfg = EngineConfig(
        page_size=args.page_size, num_pages=args.num_pages,
        max_model_len=args.max_model_len, max_num_seqs=args.max_num_seqs,
        max_prefill_tokens=args.max_prefill_tokens,
    )
    return TorchEngine(cfg, model, ecfg, device=device), cfg


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


def main(argv: Optional[list] = None) -> int:
    args = parse_args(argv)
    if args.in_mode == "http":
        print("dynamo_tpu_torch.run: --in http is not yet ported (the OpenAI "
              "frontend, tokenizer and transport come in a later slice); "
              "use --in batch", file=sys.stderr)
        return 2
    if not args.input_file:
        print("--in batch needs --input-file", file=sys.stderr)
        return 2
    with open(args.input_file) as f:
        requests = [to_request(json.loads(ln)) for ln in f if ln.strip()]
    engine, _ = build_engine(args)
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
