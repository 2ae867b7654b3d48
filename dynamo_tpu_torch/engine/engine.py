"""TorchEngine — the flat single-GPU serving engine of the port.

The counterpart of the JAX package's `JaxEngine` for one device, with the
same serving API (`generate`, `metrics`, `add_event_sink`,
`clear_kv_blocks`, `shutdown`) and the same host side (the copied
`Scheduler`, `PagePool` and block hashes):

- an asyncio pump plans steps (continuous batching, chunked prefill,
  prefix cache, mixed plans) and runs each on ONE dedicated step thread;
- prefill chunks and per-step decodes run the model eagerly over the
  paged KV pool; a mixed plan runs its prefill part, then its decode part;
- sampled tokens stream back as deltas into per-request queues.

Not ported yet (later slices): multi-step decode blocks and the block
ladder, the continuous device loop, fused prefill→decode, speculative
decoding, park/resume, KVBM tiers, meshes (dp/tp/pp/sp), multihost,
vision and int8 weights.
"""

from __future__ import annotations

import asyncio
import concurrent.futures as cf
import logging
import random
import time
from dataclasses import dataclass
from typing import Any, AsyncIterator, Callable, Dict, List, Optional

import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.llama import KVCache, Llama
from ..ops.sampling import (
    SamplingParams,
    apply_penalties,
    compute_logprobs,
    sample_tokens,
    top_logprobs,
)
from ..runtime.engine import Context
from .config import EngineConfig
from .page_pool import KvEvent, PagePool
from .scheduler import PrefillItem, SamplingOptions, Scheduler, Sequence, StepPlan

logger = logging.getLogger(__name__)

# static top-k width for OpenAI `top_logprobs` responses (API max is 20)
TOPLP = 20


@dataclass
class ForwardPassMetrics:
    """Load snapshot published to the router (the JAX engine's fields
    that a flat single-device engine fills; the rest stay 0)."""

    active_seqs: int = 0
    waiting_seqs: int = 0
    kv_usage: float = 0.0
    kv_total_pages: int = 0
    num_requests_total: int = 0
    ttft_block_wait_ms_total: float = 0.0
    ttft_queue_wait_ms_total: float = 0.0
    ttft_prefill_ms_total: float = 0.0
    ttft_attributed_total: int = 0
    prefix_cached_tokens_total: int = 0
    batch_occupancy: float = 0.0
    kv_watermark_headroom_pages: int = 0
    shed_total: int = 0
    queued_total: int = 0
    preempted_total: int = 0


def _unported(cfg: EngineConfig) -> List[str]:
    return [name for name, on in {
        "decode_steps > 1": cfg.decode_steps > 1,
        "decode_chain > 1": cfg.decode_chain > 1,
        "decode_continuous": cfg.decode_continuous,
        "decode_block_ladder": bool(cfg.decode_block_ladder)
        and len(cfg.block_ladder) > 1,
        "speculative_ngram_k": cfg.speculative_ngram_k > 0,
        "kv_partition": cfg.kv_partition,
        "quantization": cfg.quantization != "none",
    }.items() if on]


class TorchEngine:
    """Continuous-batching engine over a paged KV cache on one device."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        model: Llama,
        engine_cfg: Optional[EngineConfig] = None,
        eos_token_ids: Optional[List[int]] = None,
        event_sink: Optional[Callable[[KvEvent], None]] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(
                f"model lives on {model.device}, engine on {self.device}")
        self.model_cfg = model_cfg
        self.model = model
        self.cfg = engine_cfg or EngineConfig()
        bad = _unported(self.cfg)
        if bad:
            raise ValueError(f"not ported to TorchEngine yet: {', '.join(bad)}")
        self.eos_token_ids = eos_token_ids or []
        self.kv = self._make_kv()
        self._extra_event_sinks: List[Callable[[KvEvent], None]] = []
        if event_sink:
            self._extra_event_sinks.append(event_sink)
        self.pool = PagePool(self.cfg.num_pages, self.cfg.page_size,
                             event_sink=self._emit_event)
        self.scheduler = Scheduler(self.cfg, self.pool)
        self._py_rng = random.Random(0xD1A)
        self._queues: Dict[str, asyncio.Queue] = {}
        self._contexts: Dict[str, Context] = {}
        self._wake = asyncio.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._executor: Optional[cf.ThreadPoolExecutor] = None
        self._closed = False
        self._pending_aborts: set = set()
        self._pending_adds: List[Sequence] = []
        self._requests_total = 0
        self._ttft = {"block_wait_ms": 0.0, "queue_wait_ms": 0.0,
                      "prefill_ms": 0.0}
        self._ttft_attributed = 0
        self._cached_tokens_total = 0  # prompt tokens served by the prefix cache

    def _make_kv(self) -> KVCache:
        return KVCache.create(self.model_cfg, self.cfg.num_pages,
                              self.cfg.page_size, dtype=self.model.dtype,
                              device=self.device)

    # -- events / metrics ------------------------------------------------- #

    def _emit_event(self, ev: KvEvent) -> None:
        for sink in self._extra_event_sinks:
            try:
                sink(ev)
            except Exception:  # noqa: BLE001 — sinks must not break the engine
                logger.exception("kv event sink failed")

    def add_event_sink(self, sink: Callable[[KvEvent], None]) -> None:
        self._extra_event_sinks.append(sink)

    def metrics(self) -> ForwardPassMetrics:
        running, waiting = self.scheduler.num_requests()
        return ForwardPassMetrics(
            active_seqs=running,
            waiting_seqs=waiting,
            kv_usage=self.pool.usage(),
            kv_total_pages=self.cfg.usable_pages,
            num_requests_total=self._requests_total,
            ttft_block_wait_ms_total=self._ttft["block_wait_ms"],
            ttft_queue_wait_ms_total=self._ttft["queue_wait_ms"],
            ttft_prefill_ms_total=self._ttft["prefill_ms"],
            ttft_attributed_total=self._ttft_attributed,
            prefix_cached_tokens_total=self._cached_tokens_total,
            batch_occupancy=running / max(self.cfg.max_num_seqs, 1),
            kv_watermark_headroom_pages=max(
                0, self.pool.available_pages
                - self.scheduler._watermark_pages()),  # noqa: SLF001
            shed_total=self.scheduler.shed_total,
            queued_total=self.scheduler.queued_total,
            preempted_total=self.scheduler.preempted_total,
        )

    def clear_kv_blocks(self) -> int:
        return self.pool.clear_cache()

    # -- AsyncEngine protocol --------------------------------------------- #

    async def generate(
        self, request: Dict[str, Any], context: Optional[Context] = None
    ) -> AsyncIterator[Dict[str, Any]]:
        """request: {"token_ids": [...], "sampling_options": {...},
        "stop_conditions": {...}} → stream of {"token_ids": [...],
        "finish_reason": str|None} (the JAX engine's wire protocol)."""
        context = context or Context()
        self._ensure_pump()
        opts = _opts_from_request(request)
        prompt = list(request["token_ids"])
        max_prompt = min(
            self.cfg.max_model_len - 1,
            self.cfg.max_pages_per_seq * self.cfg.page_size - 1,
            self.cfg.usable_pages * self.cfg.page_size - 1,
        )
        if not prompt or len(prompt) > max_prompt:
            yield {"token_ids": [], "finish_reason": "error",
                   "error": f"prompt length {len(prompt)} outside [1, {max_prompt}]"}
            return
        if opts.max_tokens <= 0:
            yield {"token_ids": [], "finish_reason": "length"}
            return
        priority = request.get("priority") or self.cfg.default_priority
        if priority not in ("interactive", "batch"):
            yield {"token_ids": [], "finish_reason": "error",
                   "error": f"unknown priority class {priority!r}"}
            return
        seq = Sequence(context.id, prompt, opts)
        seq.priority = priority
        seq.t_arrival = time.monotonic()
        seq.seed = opts.seed if opts.seed is not None else self._py_rng.getrandbits(31)
        queue: asyncio.Queue = asyncio.Queue()
        self._queues[context.id] = queue
        self._contexts[context.id] = context
        self._requests_total += 1
        self._pending_adds.append(seq)
        self._wake.set()
        killed = asyncio.create_task(context.killed())
        finished = False
        try:
            while True:
                get = asyncio.create_task(queue.get())
                done, _ = await asyncio.wait(
                    {get, killed}, return_when=asyncio.FIRST_COMPLETED)
                if get not in done:
                    get.cancel()
                    return
                out = get.result()
                yield out
                if out.get("finish_reason"):
                    finished = True
                    return
        finally:
            killed.cancel()
            self._queues.pop(context.id, None)
            self._contexts.pop(context.id, None)
            if not finished:
                # consumer went away (kill, disconnect): drop the sequence
                self._pending_aborts.add(context.id)
                self._wake.set()

    # -- pump --------------------------------------------------------------- #

    def _ensure_pump(self) -> None:
        if self._pump_task is None or self._pump_task.done():
            if self._executor is None:
                # one dedicated step thread per engine, joined at shutdown
                self._executor = cf.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="torch-engine-step")
            self._loop = asyncio.get_running_loop()
            self._pump_task = self._loop.create_task(self._pump())

    async def shutdown(self) -> None:
        self._closed = True
        self._wake.set()
        if self._pump_task:
            await asyncio.gather(self._pump_task, return_exceptions=True)
        # the pump exits as soon as _closed is set: reap every sequence
        # still scheduled so the pool ends balanced
        while self._pending_aborts:
            self.scheduler.abort(self._pending_aborts.pop())
        for seq in list(self.scheduler.running) + list(self.scheduler.waiting):
            self.scheduler.abort(seq.request_id)
        if self._executor is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self._executor.shutdown, True)
            self._executor = None

    def _plan_step(self) -> StepPlan:
        """Apply queued adds (before aborts, so an abort always finds its
        sequence) and graceful stops, then plan the next step."""
        while self._pending_adds:
            self.scheduler.add(self._pending_adds.pop(0))
        while self._pending_aborts:
            self.scheduler.abort(self._pending_aborts.pop())
        for rid, ctx in list(self._contexts.items()):
            if ctx.is_stopped() and not ctx.is_killed():
                for seq in list(self.scheduler.running):
                    if seq.request_id == rid and seq.output_tokens:
                        self.scheduler.finish(seq, "cancelled")
                        self._deliver(seq, [], "cancelled")
        return self.scheduler.schedule()

    async def _pump(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._closed:
            plan = self._plan_step()
            for seq in self.scheduler.drain_errored():
                self._deliver(seq, [], "error")
            for seq in self.scheduler.drain_shed():
                self._deliver(seq, [], "error", error={
                    "code": "overloaded",
                    "message": "batch request shed after "
                               f"{self.cfg.batch_deadline_s:g}s queued "
                               "without admission; retry later"})
            if plan.kind == "idle":
                if not (self.scheduler.has_work or self._pending_adds
                        or self._pending_aborts):
                    if self._closed:
                        break
                    self._wake.clear()
                    await self._wake.wait()
                else:
                    await asyncio.sleep(0)
                continue
            try:
                await loop.run_in_executor(self._executor, self._run_plan, plan)
            except Exception:  # noqa: BLE001
                logger.exception("engine step failed; resetting KV state")
                self._recover_after_error()
            await asyncio.sleep(0)

    # -- device steps (step thread) ---------------------------------------- #

    def _run_plan(self, plan: StepPlan) -> None:
        with torch.no_grad():
            if plan.prefill:
                self._run_prefill(plan.prefill)
            decode = [s for s in plan.decode if s.status == "running"]
            if decode:
                self._run_decode(decode)

    def _ints(self, values, dtype=torch.int32) -> torch.Tensor:
        return torch.tensor(values, dtype=dtype).to(self.device, non_blocking=True)

    def _table(self, seqs: List[Sequence]) -> torch.Tensor:
        """Page-table batch [B, width], width = the longest row's pages;
        unused entries point at trash page 0."""
        width = max(1, max(len(s.pages) for s in seqs))
        return self._ints([s.pages + [0] * (width - len(s.pages)) for s in seqs])

    def _samp(self, seqs: List[Sequence]) -> SamplingParams:
        return SamplingParams.make(
            [s.opts.temperature for s in seqs],
            [s.opts.top_k for s in seqs],
            [s.opts.top_p for s in seqs],
            [s.opts.frequency_penalty for s in seqs],
            [s.opts.presence_penalty for s in seqs],
            device=self.device,
        )

    def _sample(self, logits: torch.Tensor, seqs: List[Sequence]):
        """Penalties → sample → logprobs (→ top logprobs) for one row per
        sequence; returns host lists (tokens, logprobs, tops-or-None)."""
        samp = self._samp(seqs)
        if any(s.opts.penalized for s in seqs):
            counts = torch.zeros(logits.shape, dtype=torch.float32)
            for i, s in enumerate(seqs):
                for t in s.output_tokens:
                    counts[i, t] += 1.0
            logits = apply_penalties(logits, counts.to(self.device),
                                     samp.frequency_penalty,
                                     samp.presence_penalty)
        toks = sample_tokens(logits, samp, [s.seed for s in seqs],
                             [len(s.output_tokens) for s in seqs])
        logp = compute_logprobs(logits, toks)
        tops = None
        if any(s.opts.top_logprobs > 0 for s in seqs):
            ids, lps = top_logprobs(logits, min(TOPLP, logits.shape[-1]))
            tops = (ids.cpu().tolist(), lps.cpu().tolist())
        return toks.cpu().tolist(), logp.cpu().tolist(), tops

    def _run_prefill(self, items: List[PrefillItem]) -> None:
        items = [it for it in items if it.seq.status == "running"]
        if not items:
            return
        seqs = [it.seq for it in items]
        S = max(it.chunk_len for it in items)
        tokens = [it.seq.prompt[it.chunk_start:it.chunk_start + it.chunk_len]
                  for it in items]
        tokens = self._ints([t + [0] * (S - len(t)) for t in tokens], torch.int64)
        logits = self.model.forward_prefill(
            self.kv, tokens, self._table(seqs),
            self._ints([it.chunk_start for it in items]),
            self._ints([it.chunk_len for it in items]),
        )
        sampling = [it for it in items if it.samples]
        out = (self._sample(logits[[items.index(it) for it in sampling]],
                            [it.seq for it in sampling])
               if sampling else None)
        for it in items:
            it.seq.num_computed += it.chunk_len
            self.scheduler.commit_full_pages(it.seq)
        for j, it in enumerate(sampling):
            toks, logp, tops = out
            self._append_token(it.seq, toks[j], logp[j], _tops_for(it.seq, tops, j))

    def _run_decode(self, seqs: List[Sequence]) -> None:
        """One decode step.  The batch is padded to `max_num_seqs` rows
        (token 0 at position 0 of trash page 0): every step then has the
        same matrix shapes, and the GEMM library picks the same kernels
        whatever the batch holds, so a row's tokens do not depend on its
        batch-mates."""
        pad = self.cfg.max_num_seqs - len(seqs)
        tokens = self._ints([s.output_tokens[-1] for s in seqs] + [0] * pad,
                            torch.int64)
        positions = self._ints([s.num_computed for s in seqs] + [0] * pad,
                               torch.int64)
        table = self._table(seqs)
        if pad:
            table = torch.cat([table, table.new_zeros(pad, table.shape[1])])
        logits = self.model.forward_decode(self.kv, tokens, positions, table)
        toks, logp, tops = self._sample(logits[:len(seqs)], seqs)
        for i, s in enumerate(seqs):
            s.num_computed += 1
            self.scheduler.commit_full_pages(s)
            self._append_token(s, toks[i], logp[i], _tops_for(s, tops, i))

    def _recover_after_error(self) -> None:
        """A failed step may have left the pool half-written: error out the
        running sequences, rebuild the pool, and re-prefill the waiting."""
        for seq in list(self.scheduler.running):
            self.scheduler.finish(seq, "error")
            self._deliver(seq, [], "error")
        self.kv = self._make_kv()
        self.pool = PagePool(self.cfg.num_pages, self.cfg.page_size,
                             event_sink=self._emit_event)
        self._emit_event(KvEvent("cleared", []))
        self.scheduler.pool = self.pool
        for seq in self.scheduler.waiting:
            seq.pages = []
            seq.num_cached = 0
            seq.num_computed = 0
            seq.committed_pages = 0
            seq.block_hashes = []

    # -- delivery ----------------------------------------------------------- #

    def _append_token(self, seq: Sequence, token: int, logprob: float,
                      tops=None) -> None:
        seq.output_tokens.append(token)
        if len(seq.output_tokens) == 1:
            self._note_first_token(seq)
        reason = self.scheduler.check_stop(seq, self.eos_token_ids)
        if reason:
            self.scheduler.finish(seq, reason)
        self._deliver(seq, [token], reason, logprob, tops)

    def _note_first_token(self, seq: Sequence) -> None:
        """Attribute this request's TTFT (block-wait / queue-wait /
        prefill); the first delta carries the per-request dict."""
        now = time.monotonic()
        seq.t_first_token = now
        seen = seq.t_seen if seq.t_seen is not None else seq.t_arrival
        admitted = seq.t_admitted if seq.t_admitted is not None else seen
        attr = {
            "block_wait_ms": max(0.0, (seen - seq.t_arrival) * 1e3),
            "queue_wait_ms": max(0.0, (admitted - seen) * 1e3),
            "prefill_ms": max(0.0, (now - admitted) * 1e3),
        }
        seq.ttft_attr = attr
        for k, v in attr.items():
            self._ttft[k] += v
        self._ttft_attributed += 1
        self._cached_tokens_total += seq.num_cached

    def _deliver(self, seq: Sequence, tokens: List[int],
                 finish_reason: Optional[str], logprob: Optional[float] = None,
                 tops=None, error: Any = None) -> None:
        queue = self._queues.get(seq.request_id)
        if queue is None:
            return
        out: Dict[str, Any] = {"token_ids": tokens, "finish_reason": finish_reason}
        if error is not None:
            out["error"] = error
        if logprob is not None and seq.opts.logprobs:
            out["log_probs"] = [logprob]
        if tops is not None:
            out["top_logprobs"] = [tops]
        if seq.ttft_attr is not None:
            out["ttft"] = seq.ttft_attr
            seq.ttft_attr = None
        try:  # may run on the step thread: hop back to the loop
            self._loop.call_soon_threadsafe(queue.put_nowait, out)
        except RuntimeError:
            if not self._loop.is_closed():
                raise


def _tops_for(seq: Sequence, tops, i: int):
    """This row's requested top-k [[id, logprob], ...], or None."""
    k = seq.opts.top_logprobs
    if not k or tops is None:
        return None
    ids, lps = tops
    return [[int(ids[i][j]), float(lps[i][j])] for j in range(min(k, len(ids[i])))]


def _opts_from_request(request: Dict[str, Any]) -> SamplingOptions:
    so = request.get("sampling_options", {}) or {}
    sc = request.get("stop_conditions", {}) or {}
    max_tokens = sc.get("max_tokens")
    temperature = so.get("temperature")
    return SamplingOptions(
        # OpenAI default is 1.0 (sampled); explicit 0 means greedy
        temperature=1.0 if temperature is None else temperature,
        top_k=so.get("top_k") or 0,
        top_p=so.get("top_p") if so.get("top_p") is not None else 1.0,
        frequency_penalty=so.get("frequency_penalty") or 0.0,
        presence_penalty=so.get("presence_penalty") or 0.0,
        # None → generate to the context window (Scheduler.add clamps)
        max_tokens=(1 << 30) if max_tokens is None else max_tokens,
        stop_token_ids=sc.get("stop_token_ids") or [],
        stop_sequences=sc.get("stop_sequences") or [],
        ignore_eos=sc.get("ignore_eos") or False,
        logprobs=bool(so.get("logprobs")),
        top_logprobs=int(so.get("top_logprobs") or 0),
        seed=so.get("seed"),
    )
