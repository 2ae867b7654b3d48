"""Worker CLI: `python -m dynamo_tpu_torch.worker --control HOST:PORT
--model ...`.

The port's copy of `python -m dynamo_tpu.worker`: builds a `TorchEngine`
and serves it as a discovered model endpoint, then prints ``READY worker
<name>``.  ``--model`` takes a checkpoint directory (safetensors +
config.json + tokenizer.json), ``tiny`` (the test model and tokenizer) or
a canned config name (``llama-3.1-8b``, ``gpt-oss-20b``, ``qwen2.5-7b``,
``qwen2.5-vl-7b``, ``mistral-7b``, ...; random weights from ``--seed``
and a seeded byte-level tokenizer of the model's vocabulary, 201088 ids
for gpt-oss, with the published media placeholders for qwen2.5-vl-7b;
``--sharpen`` scales such weights so greedy output follows the input).
Checkpoints of every family the port's loader reads are served: qwen2
biases, sliding windows, gpt-oss sinks and experts (MXFP4 dequantized on
load), mixtral experts.
The engine's device-loop flags are the JAX worker's (multi-step decode
blocks, chains or ``--decode-chain continuous``, the block ladder, chunk
rows, mixed dispatches, speculative decoding), and so are its overload
flags (priority class, shedding, batch deadline, ``--park-max-pages`` for
the preemption parking lot) and its KVBM flags (``--kvbm``: host, disk
and object-store KV tiers through the leader/worker bootstrap; the
leader's ``--kvbm-g4-bucket`` names the shared object-store bucket).  The
worker publishes its KV events, load metrics and (with KVBM) its tier
summary for a frontend in ``--router-mode kv``.  ``--quantization
int8`` serves int8 projections (quantized at engine construction).
``--dp-ranks N``
serves N `TorchEngine` replicas behind the one endpoint (`DpRankEngine`),
sharing one set of weights on the card, each with its own pool of
``--num-pages`` and its own KV events and metrics under the packed
(instance, rank) key; it does not compose with ``--disagg-role``,
``--kvbm`` or ``--encode-component``.  Every worker answers embedding
requests (``/v1/embeddings`` at the frontend).  ``--tp N`` serves the
model on a tensor-parallel group of N processes (`TorchEngine(parallel=
ParallelConfig(tp=N))`): this process leads, builds rank 0's shard and
spawns the other ranks, each building its own shard from the same
``--model`` / ``--seed`` (``--sharpen``) or checkpoint; one card a rank
under NCCL by default, or ``--tp-devices`` to name them (``cuda:0`` N
times shares one card over gloo; ``--device cpu`` runs the group on the
CPU).  The card and the publishers are the leader's alone; a tp group
parks, serves KVBM tiers and takes either disagg role, with every kv head
in what leaves the device (`TorchEngine`).  ``--dp N`` (with ``--tp
M``) serves N data-parallel replicas of M ranks each in one group of N *
M processes under this one leader (`ParallelConfig(dp=N, tp=M)`;
``--tp-devices`` then lists all N * M ranks' devices), their pool
replicated over the replicas or, with ``--kv-partition``, partitioned
(each replica owns its own pages, so the KV capacity grows with N); its
``/metrics`` and KV events report the partitions as one pool.
``--pp S`` (with ``--dp`` and ``--tp``) stages the layers over S
pipeline stages of dp x pp x tp processes in all (`ParallelConfig(dp, pp,
tp)`, rank ``(d * S + s) * M + t``; ``--tp-devices`` lists them all):
each stage holds L/S layers and their KV pages, a prefill pass runs the
GPipe schedule and a decode dispatch the full ring (`parallel/
pipeline.py`); vision towers and M-RoPE models are not served under pp
(ROADMAP 2.8).  ``--sp N`` (with ``--dp``, ``--tp`` and
``--kv-partition``; not with ``--pp``) shards each prompt's uncached
remainder over N sequence slots of dp x sp x tp processes in all
(`ParallelConfig(dp, sp, tp)`, rank ``(d * N + i) * M + t``): the prefill
runs as ring attention (`parallel/sp_prefill.py`), every slot decodes its
replica's rows (a partitioned pool's partitions are the (replica, slot)
pairs); it needs ``--max-prefill-tokens`` of at least ``--max-model-len``
(whole prompts), and serves no vision tower (ROADMAP 2.8) and no CUDA IPC
lane (ROADMAP 2.4b).  ``--dp-ranks`` does not compose with ``--dp``,
``--tp``, ``--pp`` or ``--sp`` (ROADMAP 2.2b.4).  Multihost and mock
engines are later slices.  Multimodal models serve image and
video chats: a qwen-vl checkpoint directory or ``qwen2.5-vl-7b`` brings
its tower, ``--vision tiny`` pairs a tiny CLIP tower with ``--model
tiny`` or a checkpoint; ``--disagg-role encode`` serves only the tower
(component ``encoder``), and a serving worker with ``--encode-component
encoder`` sends its media there and carries no tower.  Under ``--tp`` /
``--dp`` the tower is loaded on the leader alone (its ranks build only
their LLM shards), and media chats and ``--encode-component`` are served
as on one device.  ``--disagg-role prefill``
serves a prefill-only worker (component ``prefill``, its KV layout and
data plane registered), ``--disagg-role decode`` wraps the engine in the
disagg decode handler (long prompts prefill remotely, through the router
service ``--prefill-router`` names when given).  ``--status-port`` serves
the engine's
counters on ``/metrics`` (with the data plane's for a disagg role) and,
on ``/metrics.json``, the kernel launch counts too.  Runs on CUDA unless
given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging
import os
import signal

_DTYPES = ("bfloat16", "float32")


def _ladder_arg(s: str):
    if not s:
        return None
    try:
        return [int(r) for r in s.split(",") if r.strip()] or None
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"invalid ladder {s!r}: expected comma-separated ints") from None


def _chain_arg(s: str):
    """--decode-chain takes an int (fixed chain depth) or the literal
    `continuous` (the device-resident loop, docs/device_loop.md)."""
    if s.strip().lower() == "continuous":
        return "continuous"
    try:
        return int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"invalid --decode-chain {s!r}: expected an int or "
            f"'continuous'") from None


def add_model_args(ap: argparse.ArgumentParser) -> None:
    """Model, device and engine flags shared by the worker and `run`."""
    ap.add_argument("--model", default="tiny",
                    help="HF checkpoint dir, 'tiny', or a canned config name")
    ap.add_argument("--model-name", default=None)
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut a canned model's depth (widths stay as published)")
    ap.add_argument("--dtype", default=None, choices=_DTYPES,
                    help="default: float32 for tiny, bfloat16 otherwise")
    ap.add_argument("--seed", type=int, default=0,
                    help="random weights and tokenizer of tiny/canned models")
    ap.add_argument("--sharpen", action="store_true",
                    help="scale a canned model's random weights so greedy "
                         "output depends on the input (testing.sharpen)")
    ap.add_argument("--vision", default="", choices=["", "tiny"],
                    help="attach a vision tower: 'tiny' pairs a tiny CLIP "
                         "tower with --model tiny (multimodal models bring "
                         "their own)")

    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; there is no silent fallback")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=1024)
    ap.add_argument("--max-model-len", type=int, default=4096)
    ap.add_argument("--max-num-seqs", type=int, default=8)
    ap.add_argument("--max-prefill-tokens", type=int, default=512)
    ap.add_argument("--mixed-prefill-tokens", type=int, default=None,
                    help="prefill token budget inside a mixed "
                         "(prefill + decode block) dispatch; default "
                         "--max-prefill-tokens, 0 disables mixed plans")
    ap.add_argument("--no-prefix-caching", action="store_true")
    # overload control: priority classes + the shed / queue-deadline /
    # preemption-parking knobs
    ap.add_argument("--priority-class", default="interactive",
                    choices=["interactive", "batch"],
                    help="default priority class for requests that don't "
                         "set one (per-request `priority` wins)")
    ap.add_argument("--overload-queue-depth", type=int, default=0,
                    help="shed NEW batch-class requests once the waiting "
                         "queue is this deep AND watermark headroom is at "
                         "or under --overload-headroom-pages (0 disables)")
    ap.add_argument("--overload-headroom-pages", type=int, default=0,
                    help="watermark-headroom floor (pages) below which "
                         "the queue-depth threshold counts as pressure")
    ap.add_argument("--batch-deadline-s", type=float, default=0.0,
                    help="shed a batch request queued this long without "
                         "ever being admitted (0 disables)")
    ap.add_argument("--park-max-pages", type=int, default=0,
                    help="cap on KV pages the decode-preemption parking "
                         "lot may hold host-side (0 = unbounded)")
    # the device loop (TorchEngine; every decode block is a CUDA graph)
    ap.add_argument("--decode-steps", type=int, default=1,
                    help="tokens decoded per dispatch (one block); up to "
                         "N-1 tokens past a stop are computed and dropped")
    ap.add_argument("--decode-chain", type=_chain_arg, default=1,
                    help="decode blocks chained on their device-side "
                         "carries before fetching, or 'continuous' for the "
                         "device-resident loop (--decode-continuous)")
    ap.add_argument("--decode-continuous", action="store_true",
                    help="device-resident decode loop: open-ended chaining "
                         "with on-device stop detection and a drain "
                         "thread; with an integer --decode-chain N, N is "
                         "the page pre-reservation horizon in blocks")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=None,
                    help="chunked prefill inside the continuous chain: a "
                         "per-block budget of prompt tokens fed as chunk "
                         "rows, so an admission splices into the running "
                         "chain; default --max-prefill-tokens, 0 disables")
    ap.add_argument("--decode-block-ladder", type=_ladder_arg, default=None,
                    help="comma-separated block sizes (e.g. 1,4,16) beside "
                         "--decode-steps: full blocks while no prompt "
                         "waits, the shortest rung (no chaining) while "
                         "one does")
    ap.add_argument("--speculative-ngram-k", type=int, default=0,
                    help="self-speculative decoding: draft K tokens from "
                         "the sequence's own n-grams and verify them in "
                         "one forward; 0 disables")
    ap.add_argument("--quantization", default="none", choices=["none", "int8"])
    ap.add_argument("--kv-partition", action="store_true",
                    help="partition the KV pool over the --dp replicas and "
                         "--sp slots (each owns its own pages)")
    # the serving mesh: dp x pp|sp x tp over torch.distributed
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel degree: replicas of the --tp group "
                         "under one leader")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: a group of N processes")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel degree: each prompt's prefill "
                         "sharded over N slots of --tp ranks each (ring "
                         "attention)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline-parallel degree: the layers staged over "
                         "N stages of --tp ranks each")
    ap.add_argument("--tp-devices", default="",
                    help="comma-separated device of each of the dp*pp*sp*tp "
                         "ranks, rank (d*pp*sp+s)*tp+t for replica d's stage "
                         "or slot s's tensor rank t (default: one card a "
                         "rank, or the CPU with --device cpu); ranks sharing "
                         "a card use gloo")


def parallel_from_args(args):
    """(ParallelConfig or None, the ranks' devices or None)."""
    from ..parallel import ParallelConfig, check_ported

    pcfg = ParallelConfig(dp=args.dp, tp=args.tp, sp=args.sp, pp=args.pp)
    check_ported(pcfg)
    if pcfg.world == 1:
        return None, None
    if args.tp_devices:
        devices = [d.strip() for d in args.tp_devices.split(",") if d.strip()]
        if len(devices) != pcfg.world:
            raise ValueError(
                f"--tp-devices names {len(devices)} devices; a group of "
                f"dp={pcfg.dp} x {'' if pcfg.pp == 1 else f'pp={pcfg.pp} x '}"
                f"{'' if pcfg.sp == 1 else f'sp={pcfg.sp} x '}"
                f"tp={pcfg.tp} has {pcfg.world} ranks")
    elif args.device == "cpu":
        devices = ["cpu"] * pcfg.world
    else:
        devices = None
    return pcfg, devices


def engine_config_from_args(args):
    from ..engine import EngineConfig

    return EngineConfig(
        page_size=args.page_size,
        num_pages=args.num_pages,
        max_num_seqs=args.max_num_seqs,
        max_prefill_tokens=args.max_prefill_tokens,
        max_model_len=args.max_model_len,
        mixed_prefill_tokens=args.mixed_prefill_tokens,
        enable_prefix_caching=not args.no_prefix_caching,
        default_priority=args.priority_class,
        overload_queue_depth=args.overload_queue_depth,
        overload_headroom_pages=args.overload_headroom_pages,
        batch_deadline_s=args.batch_deadline_s,
        park_max_pages=args.park_max_pages,
        decode_steps=args.decode_steps,
        # 'continuous': the default double-buffer horizon of 2 blocks
        decode_chain=(args.decode_chain
                      if isinstance(args.decode_chain, int) else 2),
        decode_continuous=(args.decode_continuous
                           or args.decode_chain == "continuous"),
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        decode_block_ladder=args.decode_block_ladder,
        speculative_ngram_k=args.speculative_ngram_k,
        quantization=args.quantization,
        kv_partition=args.kv_partition,
    )


def _media_card(vcfg, image_token: str, image_token_id: int) -> dict:
    """The card fields a preprocessor needs for a tower's media."""
    from ..models.qwen_vl import Qwen2VLVisionConfig

    if isinstance(vcfg, Qwen2VLVisionConfig):
        return dict(image_token=image_token, image_token_id=image_token_id,
                    mm_arch="qwen2_vl", mm_config=dict(
                        depth=vcfg.depth, embed_dim=vcfg.embed_dim,
                        num_heads=vcfg.num_heads, mlp_ratio=vcfg.mlp_ratio,
                        patch_size=vcfg.patch_size,
                        temporal_patch_size=vcfg.temporal_patch_size,
                        spatial_merge_size=vcfg.spatial_merge_size,
                        hidden_size=vcfg.out_hidden_size,
                        min_pixels=vcfg.min_pixels, max_pixels=vcfg.max_pixels))
    return dict(image_token=image_token, image_token_id=image_token_id,
                image_patches=vcfg.num_patches, image_size=vcfg.image_size)


def build_engine(args):
    """(TorchEngine, ModelDeploymentCard) from the CLI arguments."""
    import json

    import torch

    from ..device import resolve_device
    from ..engine import TorchEngine
    from ..llm import HuggingFaceTokenizer, ModelDeploymentCard
    from ..models import CONFIGS, ModelConfig, init_params, tiny_config
    from ..models.config import MEDIA_TOKENS
    from ..models.loader import load_params
    from ..models.qwen_vl import init_qwen_vl_vision_params, vision_config
    from ..models.vision import init_vision_params, tiny_vision_config
    from ..testing import MEDIA_SPECIALS, sharpen, synthetic_tokenizer, tiny_tokenizer

    device = resolve_device(args.device)
    ecfg = engine_config_from_args(args)
    parallel, tp_devices = parallel_from_args(args)
    dtype = getattr(torch, args.dtype or (
        "float32" if args.model == "tiny" else "bfloat16"))
    offload = bool(getattr(args, "encode_component", ""))
    # a group's tower lives on its leader (rank 0) alone
    tower_dev = torch.device(tp_devices[0]) if tp_devices else device
    tower, vcfg, media = None, None, {}
    if os.path.isdir(args.model):
        cfg = ModelConfig.from_pretrained(args.model)
        tok = HuggingFaceTokenizer.from_pretrained(args.model)
        if cfg.model_type in ("qwen2_vl", "qwen2_5_vl"):
            from ..models.vlm import load_qwen_vl, load_qwen_vl_tower

            if parallel is not None:
                from ..parallel import CheckpointShards

                tower, vcfg, cfg, prefix = load_qwen_vl_tower(
                    args.model, device=tower_dev)
                model = CheckpointShards(cfg, args.model,
                                         str(dtype).split(".")[-1], prefix)
            else:
                model, cfg, tower, vcfg = load_qwen_vl(args.model, dtype=dtype,
                                                      device=device)
            with open(os.path.join(args.model, "config.json")) as f:
                img_id = json.load(f).get("image_token_id", 151655)
            # decode() skips special tokens (the placeholder is one)
            img_tok = tok.decode([img_id], skip_special_tokens=False)
            if not img_tok or tok.encode(img_tok)[-1:] != [img_id]:
                raise SystemExit(f"image_token_id {img_id} does not round-trip "
                                 f"through the tokenizer (got {img_tok!r})")
            media = _media_card(vcfg, img_tok, img_id)
        elif parallel is not None:
            from ..parallel import CheckpointShards

            # each rank reads the checkpoint and keeps its slices
            model = CheckpointShards(cfg, args.model, str(dtype).split(".")[-1])
        else:
            model = load_params(args.model, cfg, dtype=dtype, device=device)
        if vcfg is None and (args.vision or offload):
            # the tiny CLIP tower (or, for an encode worker's media, its
            # geometry) beside any checkpoint, as the JAX worker pairs it
            image_ids = tok.encode("<image>")
            if len(image_ids) != 1:
                raise SystemExit("--vision tiny needs a tokenizer with a "
                                 "single-token <image> marker")
            vcfg = tiny_vision_config(out_hidden_size=cfg.hidden_size)
            tower = init_vision_params(vcfg, torch.Generator(
                device=tower_dev).manual_seed(args.seed + 1), device=tower_dev)
            media = _media_card(vcfg, "<image>", image_ids[0])
    else:
        if args.model == "tiny":
            tok = tiny_tokenizer()
            cfg = tiny_config(vocab_size=tok.vocab_size)
        elif args.model in CONFIGS:
            cfg = CONFIGS[args.model]
            tok = synthetic_tokenizer(cfg.vocab_size, args.seed,
                                      specials=MEDIA_SPECIALS.get(args.model))
        else:
            raise SystemExit(f"unknown model {args.model!r}: a checkpoint "
                             f"directory, tiny, or one of {sorted(CONFIGS)}")
        if args.num_layers:
            cfg = cfg.with_depth(args.num_layers)
        if parallel is not None:
            from ..parallel import SeededShards

            # each rank draws the flat model's tensors and keeps its slices
            model = SeededShards(cfg, args.seed, str(dtype).split(".")[-1],
                                 sharpen=args.sharpen)
        else:
            gen = torch.Generator(device=device).manual_seed(args.seed)
            model = init_params(cfg, gen, dtype=dtype, device=device)
        # the tower draws from a generator of its own, so cutting the
        # LLM's depth (an encode worker's) leaves it unchanged
        vgen = torch.Generator(device=tower_dev).manual_seed(args.seed + 1)
        if args.model in MEDIA_TOKENS:
            vcfg = vision_config(args.model)
            tower = init_qwen_vl_vision_params(vcfg, vgen, device=tower_dev)
            img_id = MEDIA_TOKENS[args.model]["image_token_id"]
            media = _media_card(vcfg, MEDIA_SPECIALS[args.model][img_id], img_id)
        elif args.vision or (offload and args.model == "tiny"):
            vcfg = tiny_vision_config(out_hidden_size=cfg.hidden_size)
            tower = init_vision_params(vcfg, vgen, device=tower_dev)
            media = _media_card(vcfg, "<image>", tok.encode("<image>")[0])
        qwen_tower = tower if media.get("mm_arch") == "qwen2_vl" else None
        if args.sharpen and parallel is None:
            sharpen(model, qwen_tower)
        elif args.sharpen and qwen_tower is not None:
            # the tower's scale reads the whole sharpened embedding, which
            # no rank holds: draw the flat model once on the leader's
            # device, as the ranks draw it, then let it go
            flat = init_params(cfg, torch.Generator(device=tower_dev)
                               .manual_seed(args.seed), dtype=dtype,
                               device=tower_dev)
            sharpen(flat, qwen_tower)
            del flat
            if tower_dev.type == "cuda":
                torch.cuda.empty_cache()
    if offload:
        tower = None  # media go to the encode worker; keep the geometry
    eos = list(tok.eos_token_ids)
    ranks = getattr(args, "dp_ranks", 1)
    if ranks > 1 and ecfg.quantization == "int8":
        # quantize ONCE before building the replicas: each TorchEngine
        # would otherwise quantize the shared model again
        from ..models.quantization import quantize_params

        quantize_params(model)
        ecfg = dataclasses.replace(ecfg, quantization="none")

    def make_engine():
        if parallel is not None:
            return TorchEngine(cfg, model, ecfg, eos_token_ids=eos,
                               vision=(tower, vcfg) if vcfg is not None else None,
                               parallel=parallel, devices=tp_devices)
        return TorchEngine(cfg, model, ecfg, eos_token_ids=eos, device=device,
                           vision=(tower, vcfg) if vcfg is not None else None)

    if ranks > 1:
        from . import DpRankEngine

        # the replicas share the weights; each gets its own KV pool
        engine = DpRankEngine([make_engine() for _ in range(ranks)])
    else:
        engine = make_engine()
    mdc = ModelDeploymentCard(
        name=args.model_name or ("tiny-chat" if args.model == "tiny" else cfg.name),
        tokenizer_json=tok.to_json_str(),
        eos_token_ids=eos,
        context_length=args.max_model_len,
        priority_class=args.priority_class,
        disagg_role=getattr(args, "disagg_role", "both"),
        **media,
    )
    return engine, mdc


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="dynamo_tpu_torch worker")
    env_control = os.environ.get("DYN_CONTROL", "")
    ap.add_argument("--control", required=not env_control, default=env_control)
    ap.add_argument("--namespace", default="dynamo")
    ap.add_argument("--component", default="backend")
    ap.add_argument("--endpoint", default="generate")
    ap.add_argument("--log-level", default="info")
    ap.add_argument("--status-port", type=int, default=0,
                    help="status server port (0 = ephemeral, -1 = disabled); "
                         "serves /health /live /metrics /metrics.json")
    # distributed KVBM: shared host/disk KV tiers
    ap.add_argument("--kvbm", action="store_true",
                    help="attach shared KV tiers via the kvbm bootstrap")
    ap.add_argument("--kvbm-leader", type=int, default=0, metavar="WORLD",
                    help="also run the kvbm leader, barriering WORLD workers")
    ap.add_argument("--kvbm-disk-root", default=None)
    ap.add_argument("--kvbm-g4-bucket", default=None,
                    help="object-store tier (G4): the shared control-plane "
                         "bucket host evictions demote to when there is no "
                         "disk tier (set on the leader)")
    ap.add_argument("--kvbm-host-bytes", type=int, default=1 << 30)
    # disaggregated prefill/decode
    ap.add_argument("--disagg-role", default="both",
                    choices=["both", "prefill", "decode", "encode"],
                    help="prefill: serve remote prefills (component "
                         "'prefill'); decode: prefill long prompts remotely "
                         "and adopt their KV; encode: serve only the vision "
                         "tower (component 'encoder' unless --component "
                         "names another)")
    ap.add_argument("--encode-component", default="", metavar="COMPONENT",
                    help="send media to the encode worker registered at "
                         "this component; this worker then carries no tower")
    ap.add_argument("--prefill-router", default="", metavar="COMPONENT",
                    help="route remote prefills through a standalone router "
                         "service registered at this component (decode role "
                         "only)")
    ap.add_argument("--dp-ranks", type=int, default=1,
                    help="independent engine replicas behind this endpoint "
                         "(per-rank KV pools + events; the router targets "
                         "(instance, dp_rank))")
    add_model_args(ap)
    return ap


async def start_status_server(engine, args):
    """/health, /live, /metrics (the engine's ``dynamo_tpu_worker_*``
    families) and /metrics.json on `--status-port`."""
    from ..frontend.http_server import HttpServer, Response, json_response
    from ..frontend.metrics import engine_stats_exposition
    from ..ops._launches import LAUNCHES

    def stats():
        return vars(engine.metrics())

    async def ok(_req):
        return json_response({"status": "healthy"})

    async def live(_req):
        return json_response({"status": "live"})

    async def metrics(_req):
        return Response(engine_stats_exposition(stats(), args.namespace,
                                                args.component))

    async def metrics_json(_req):
        return json_response({**stats(), "kernel_launches": dict(LAUNCHES)})

    return await HttpServer({("GET", "/health"): ok, ("GET", "/live"): live,
                             ("GET", "/metrics"): metrics,
                             ("GET", "/metrics.json"): metrics_json},
                            port=args.status_port).start()


def check_role(args) -> None:
    """Refuse the role combinations the port cannot serve."""
    from ..models.config import MEDIA_TOKENS

    multimodal = args.vision or args.model in MEDIA_TOKENS or (
        os.path.isdir(args.model) and _is_qwen_vl(args.model))
    if args.disagg_role == "encode" and not multimodal:
        raise SystemExit("--disagg-role encode needs a vision tower (--vision, "
                         "or a multimodal model)")
    if args.encode_component and args.vision:
        raise SystemExit("--encode-component sends media to the encode worker: "
                         "drop --vision on this worker")
    if args.encode_component and args.disagg_role in ("prefill", "encode"):
        raise SystemExit("--encode-component composes with --disagg-role "
                         "both|decode")
    if args.prefill_router and args.disagg_role != "decode":
        raise SystemExit("--prefill-router routes a decode worker's remote "
                         "prefills: it needs --disagg-role decode")
    if args.disagg_role == "prefill" and args.kvbm:
        raise SystemExit("a prefill worker hands its pages to decode workers; "
                         "--kvbm tiers are served by --disagg-role both|decode")
    if args.dp_ranks > 1:
        # DpRankEngine serves the plain generate/embed surface only; the
        # disagg handlers and the KVBM worker require the single-engine
        # API (the port has no multihost or mock engines to refuse)
        for bad, flag in [
            (args.disagg_role != "both", "--disagg-role"),
            (args.kvbm, "--kvbm"),
            (bool(args.encode_component), "--encode-component"),
        ]:
            if bad:
                raise SystemExit(f"--dp-ranks > 1 is incompatible with {flag}")
    for axis in ("tp", "dp", "pp", "sp"):
        # a dp x pp|sp x tp group serves generate, embed, media (the tower
        # on the leader, or an encode worker's embeddings; not under pp or
        # sp) and every KV move (parking, KVBM tiers, the disagg roles);
        # --dp-ranks would stack engines on it
        if getattr(args, axis) > 1 and args.dp_ranks > 1:
            raise SystemExit(f"--{axis} > 1 with --dp-ranks is not served "
                             f"yet (ROADMAP 2.2b.4)")
    if args.disagg_role == "prefill" and args.device != "cpu":
        from ..disagg.device_transfer import expandable_segments

        if expandable_segments():
            raise SystemExit(
                "a prefill worker on a card serves its pages through CUDA "
                "IPC, which cannot export memory allocated under "
                "PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True; unset it")


def _is_qwen_vl(path: str) -> bool:
    import json

    try:
        with open(os.path.join(path, "config.json")) as f:
            return json.load(f).get("model_type") in ("qwen2_vl", "qwen2_5_vl")
    except (OSError, ValueError):
        return False


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    check_role(args)
    logging.basicConfig(level=args.log_level.upper(),
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    asyncio.run(_run(args))


async def _run(args) -> None:
    from ..runtime import DistributedRuntime
    from . import serve_engine

    # build the engine BEFORE taking a lease: model load can take longer
    # than the lease TTL
    engine, mdc = build_engine(args)
    runtime = await DistributedRuntime.connect(args.control)
    if args.kvbm:
        from ..kvbm import KvbmConfig, KvbmLeader, KvbmWorker

        leader_task = None
        if args.kvbm_leader > 0:
            leader_task = asyncio.ensure_future(KvbmLeader(
                runtime,
                KvbmConfig(disk_root=args.kvbm_disk_root,
                           g4_bucket=args.kvbm_g4_bucket,
                           host_bytes=args.kvbm_host_bytes),
                world=args.kvbm_leader, namespace=args.namespace,
            ).start())
        await KvbmWorker(runtime, engine, namespace=args.namespace).start()
        if leader_task is not None:
            await leader_task
    def wrap_encode(inner):
        """Outermost: media become encoder embeddings before anything
        routes the request."""
        if not args.encode_component:
            return inner
        from ..disagg import EncodeOffload

        return EncodeOffload(inner, runtime, namespace=args.namespace,
                             component=args.encode_component)

    if args.disagg_role == "encode":
        from ..disagg import ENCODE_COMPONENT, serve_encode_worker

        engine = await serve_encode_worker(
            runtime, engine, mdc, namespace=args.namespace,
            component=(args.component if args.component != "backend"
                       else ENCODE_COMPONENT))
    elif args.disagg_role == "prefill":
        from ..disagg import serve_prefill_worker

        engine = (await serve_prefill_worker(runtime, engine, mdc,
                                             namespace=args.namespace)).facade
    elif args.disagg_role == "decode":
        from ..disagg import DisaggDecodeHandler
        from ..disagg.handler import RemoteRouterClient

        prefill_router = (
            RemoteRouterClient(runtime, args.namespace, args.prefill_router)
            if args.prefill_router else None)
        engine = wrap_encode(DisaggDecodeHandler(
            engine, runtime, namespace=args.namespace,
            prefill_router=prefill_router))
        await serve_engine(runtime, engine, mdc, namespace=args.namespace,
                           component=args.component, endpoint=args.endpoint)
    else:
        engine = wrap_encode(engine)
        await serve_engine(runtime, engine, mdc, namespace=args.namespace,
                           component=args.component, endpoint=args.endpoint)
    status = None
    if args.status_port >= 0:
        status = await start_status_server(engine, args)
        print(f"STATUS http://0.0.0.0:{status.port}", flush=True)
    print(f"READY worker {mdc.name}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    if status is not None:
        await status.stop()
    await runtime.shutdown()
    await engine.shutdown()


if __name__ == "__main__":
    main()
