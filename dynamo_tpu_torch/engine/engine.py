"""TorchEngine — the flat single-GPU serving engine of the port.

The counterpart of the JAX package's `JaxEngine` for one device, with the
same serving API (`generate`, `metrics`, `add_event_sink`,
`clear_kv_blocks`, `shutdown`), the same host side (the copied
`Scheduler`, `PagePool` and block hashes) and the same device loop, under
the JAX engine's names:

- an asyncio pump plans steps (continuous batching, chunked prefill,
  prefix cache, mixed plans) and runs each on ONE dedicated step thread;
- prefill chunks run the model eagerly over the paged KV pool; their
  sampled tokens can feed the first decode chain device-to-device
  (`_maybe_fuse_decode`, `fuse_prefill_decode`);
- every decode dispatch is a block of `n_steps` forward + sample steps
  (`blocks.py`): `decode_steps`, or the rung the block ladder picks
  (`decode_block_ladder`); blocks chain on their device-side carries
  (`decode_chain`) or run the device-resident continuous loop with
  on-device stop masks, chunk rows and splice admission
  (`decode_continuous`, `prefill_chunk_tokens`; docs/device_loop.md), or
  verify n-gram drafts in one forward (`speculative_ngram_k`);
- on CUDA every decode block is a CUDA graph captured once per (kind,
  rung, variant, table-width bucket) and replayed (`graphs.py`); on the
  CPU the same block functions run eagerly over the plain kernels;
- sampled tokens come back in one packed buffer per block and stream as
  deltas into per-request queues;
- KV leaves the device two ways (`kvbm/`): a batch-class decode preempted
  for an interactive arrival parks its pages byte-exact in host memory
  and resumes from them (`_park_seq`, `_resume_parked`), and an attached
  tier (`attach_connector`) offloads committed blocks to host and disk on
  a drain thread and onboards them into the prefix cache at admission.
  Pages move with a gather (`index_select`) and an in-place scatter
  (`index_copy_`): the pool tensors are never reallocated, since every
  captured graph holds their addresses;
- disaggregated serving (`disagg/`): a prefill worker's `prefill_remote`
  computes the prompt and its first token and holds the pages
  (`_hold_pages`) for the data plane, which moves them into a decode
  worker's pages (`alloc_pages`, `import_page_chunk`, or one `kv_repage`
  launch on a device lane); `generate_imported` adopts them there as a
  prompt computed elsewhere.  Page operations requested from outside the
  pump (`_device_op`) run on the step thread between steps, under the
  step lock and on the engine's stream; chains, fusion and the
  continuous loop yield to them.

With ``quantization="int8"`` the model's dense projections and LM head
are quantized at construction, in place (`models.quantization.
quantize_params`, layer by layer), as `JaxEngine` quantizes its params.

Embedding requests (`embed`) run the model's cache-free `forward_embed`
as a device op between steps.

Multimodal requests (``vision=(tower, vision_cfg)``; `media.py`): media
are validated and attached on arrival, the tower runs on the step thread
before the sequence's first prefill chunk, each chunk splices in the
embeddings of the runs it covers (and an M-RoPE model's three rope
streams), and every later position ropes at its index plus the
sequence's delta: the per-row ``rope_off`` input of every decode, block,
chain and verify graph, refreshed at each dispatch and splice.  Media
prompts take the pure prefill path (not mixed plans, not chunk rows).
In a dp x tp group the tower lives on the leader alone and runs there
before the prefill plan goes out; the plan carries the pass's media rows
(each run's slice in the model's dtype, its mask, the M-RoPE streams),
and every rank splices its replica's block of them (`media.py`); decode
plans carry each row's ``rope_off``.  A leader with ``vision=(None,
vcfg)`` serves the embeddings an encode worker computed the same way.

Tensor parallelism (``parallel=ParallelConfig(tp=N)``, ``devices``): the
engine leads a group of N processes (`lockstep.py`): it spawns N - 1
followers, each building its own shard of the model (``model`` is then a
picklable source, `parallel.SeededShards` / `TreeShards` /
`CheckpointShards`: ``source(rank, tp, device) -> Llama``) and a pool of
nkv/tp heads, and sends them every device operation before running it
itself: prefill passes, decode blocks and chains, speculative verifies,
embeddings.  Under tp the blocks run eagerly (`graphs.py`), a decode
dispatch takes the chained paths (not the continuous loop, as JAX's
`_cc_ok` under a mesh) and no prefill fuses into a decode chain (the
followers replay from host arrays only, as JAX's multihost plans).
KV moves under tp hold every kv head, as the JAX engine's (whose export
gathers the sharded pool): `_export_dev` sends a ``kv_export`` plan and
joins every rank's head slice in rank order (`parallel.collectives.
gather_heads`), `_import_dev` a ``kv_import`` plan whose full-head pages
the leader broadcasts and each rank scatters its own heads of, in place.
So parked sequences, KVBM blocks on the host and the disk and the disagg
host lane carry one layout whatever the tp, and a block written by a tp 2
engine onboards into a flat one.  The disagg CUDA IPC lane instead lets
every destination rank read its head window straight from the source
ranks' pools (`import_ipc`: a ``kv_import`` plan of the ``ipc`` lane,
one windowed `kv_repage` launch per overlapping source rank).
fuse_projections is refused under tp (its fused output axis does not
carry the tp splits).

Meshed data parallelism (``parallel=ParallelConfig(dp=D, tp=N)``): the
group holds D replicas of N ranks each (rank ``d * N + t``), every
replica holding the same tp shards; the leader (rank 0) runs the one
scheduler and sends every plan to the whole group.  A dispatch's rows
are laid out as D uniform blocks, one a replica: each rank computes its
replica's block (the model's collectives on its replica's tp group), and
each replica's tensor rank 0 returns its block's packed results to the
leader over its dp group (`parallel.collectives.all_parts`), which joins
them (`blocks.join_packed`).  The pool is either

- replicated over dp (the default): every replica holds every page, and
  the decode batch rounds up to a multiple of D (JAX `engine.py:1508-
  1516`, its rows ``P("dp")``); after each dispatch the replicas swap
  the K/V rows their blocks wrote over their dp groups and write the
  others' rows too, so every replica's pool ends each dispatch
  byte-equal to the others' (what GSPMD's scatter into JAX's replicated
  pool gives), the trash page aside; or
- partitioned (``kv_partition=True``, JAX `:1483-1507`): a
  `ShardedPagePool` of D partitions (global page ``d * num_pages +
  local``), each replica's pool holding its own; the scheduler pins a
  sequence to a partition (`Sequence.kv_rank`), a block holds the rows
  of its replica's sequences with LOCAL page tables, and nothing crosses
  replicas but the results.  The fused prefill is off, mixed dispatches
  stay on, speculative decoding is off (as in JAX).

KV moves follow the pool: an export reads one partition (the owner's
heads joined over its tp group, then sent to the leader), an import
lands on the admitting sequence's partition, or on every replica of a
replicated pool.  Media rows go to their block's replica only.

Pipeline parallelism (``parallel=ParallelConfig(pp=S, dp=D, tp=N)``):
the group's D x S x N ranks are laid out as JAX's ``(dp, pp, tp)`` mesh
(rank ``(d * S + s) * N + t``); each stage holds L/S contiguous layers
(every rank of a stage its tp shard of them) and only those layers' KV
pages.  A prefill pass runs the GPipe schedule and a decode dispatch the
full ring (`parallel/pipeline.py`; a chain of blocks is one ring of all
its steps); the last stage samples, and on each replica its tensor rank
0 returns the packed results to the leader (over the dp group at the
last stage, then the pp group).  A replicated pool swaps each stage's
new rows over that stage's dp group; a partitioned pool is unchanged
(the page axis and the layer axis are orthogonal, as JAX's
`kv_pspec_pp`).  KV moves join every stage's layers in stage order over
the pp group after the heads (export) and give each rank its layers'
heads of the leader's full pages (import), so parked sequences, KVBM
blocks and the disagg host lane carry the flat layout; the CUDA IPC
lane does not serve a pipeline (ROADMAP 2.3b).  As in JAX, pp refuses
vision towers and M-RoPE models (ROADMAP 2.8), turns the fused prefill,
mixed dispatches and speculative decoding off, and rounds the decode
rows to dp x pp (a partitioned pool's blocks to pp).

Sequence parallelism (``parallel=ParallelConfig(dp=D, sp=N, tp=M)``):
the ranks are JAX's ``(dp, sp, tp)`` mesh (rank ``(d * N + i) * M + t``);
every slot holds every layer (its tp shard).  A prefill pass is whole
remainders (`_sp_config`: no mixed dispatches, a step budget that never
chunks a prompt), padded to a multiple of N; each slot of a replica takes
N-th of its block's columns through the ring prefill
(`parallel/sp_prefill.py`: ring attention on the `ring_block` kernel,
the cached prefix folded first from the pool), and the chunk's K/V,
gathered over the sp group, is written by every slot (a replicated pool,
then levelled over dp) or by the row's owner slot alone (``kv_partition``:
the pool partitioned over the D x N (replica, slot) pairs, prefill rows
grouped by ``kv_rank // N``).  Decode runs the paged decode kernel: on a
replicated pool every slot of a replica runs the replica's rows (results
from slot 0), on a partitioned pool each (replica, slot) its partition's
block.  KV moves read and write partitions over the pool group; the CUDA
IPC lane turns an sp group down (ROADMAP 2.4b), as do vision towers and
M-RoPE (ROADMAP 2.8), pp (as in JAX) and speculative decoding.

Not ported yet (later slices): multihost.
"""

from __future__ import annotations

import asyncio
import concurrent.futures as cf
import logging
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kvbm.host_pool import to_host
from ..kvbm.park import ParkedSeq, ParkingLot
from ..models.config import ModelConfig
from ..models.llama import KVCache, Llama
from ..models.quantization import quantize_params
from ..runtime.engine import Context
from ..tokens import compute_block_hash_for_seq
from . import blocks, media
from .blocks import TOPLP, Variant
from .config import EngineConfig, bucket_for
from . import lockstep
from .graphs import GraphRunner, HostFetch
from .page_pool import KvEvent, NoPagesError, PagePool
from .scheduler import PrefillItem, SamplingOptions, Scheduler, Sequence, StepPlan

logger = logging.getLogger(__name__)

__all__ = ["ForwardPassMetrics", "TOPLP", "TorchEngine"]


@dataclass
class ForwardPassMetrics:
    """Load snapshot published to the router (the JAX engine's fields that
    a flat single-device engine fills; the rest stay 0).  Per-rung
    dispatch counts ride as dynamic `decode_rung{n}_dispatches_total`
    attributes."""

    active_seqs: int = 0
    waiting_seqs: int = 0
    kv_usage: float = 0.0
    kv_total_pages: int = 0
    num_requests_total: int = 0
    spec_draft_tokens_total: int = 0
    spec_accepted_tokens_total: int = 0
    spec_dispatches_total: int = 0
    spec_acceptance_rate: float = 0.0
    ttft_block_wait_ms_total: float = 0.0
    ttft_queue_wait_ms_total: float = 0.0
    ttft_prefill_ms_total: float = 0.0
    ttft_attributed_total: int = 0
    # device-resident decode loop: chains run and blocks dispatched
    decode_cc_blocks_total: int = 0
    decode_cc_chains_total: int = 0
    # per-reason chain fall-out counts (a labeled counter
    # decode_cc_fallout_total{reason} on /metrics)
    decode_cc_fallout_total: Dict[str, int] = field(default_factory=dict)
    prefix_cached_tokens_total: int = 0
    batch_occupancy: float = 0.0
    kv_watermark_headroom_pages: int = 0
    # overload control: batch-class sheds, batch adds that queued,
    # mid-decode preemptions parked to host and parked sequences resumed,
    # plus the parking lot's live footprint
    shed_total: int = 0
    queued_total: int = 0
    preempted_total: int = 0
    resumed_total: int = 0
    parked_seqs: int = 0
    parked_pages: int = 0


# the host arrays each plan kind must carry (`TorchEngine.replay_inputs`)
_PLAN_ARRAYS = {
    "prefill": ("tokens", "table", "prefix", "chunk"),
    "decode": ("tok", "pos", "ctr", "table", "seeds") + blocks.SAMP_COLUMNS,
    "spec": ("tokens", "pos", "ctr", "table", "seeds") + blocks.SAMP_COLUMNS,
    "embed": ("tokens", "lens"),
    "kv_export": ("pages",),
    "kv_import": ("pages",),
}

def _group_refusals(cfg: EngineConfig, tp: int) -> List[str]:
    bad = []
    if cfg.fuse_projections and tp > 1:
        bad.append("fuse_projections (the fused output axis does not carry "
                   "the megatron tp splits, as in JAX)")
    return bad


def _pp_config(cfg: EngineConfig, model_cfg: ModelConfig, pp: int,
               vision) -> EngineConfig:
    """The engine config of a pipeline (JAX `engine.py:1381-1422`): pp
    divides the layers (`models.llama._check_supported`), a vision tower
    or an M-RoPE model is refused (ROADMAP 2.8, as JAX refuses it), and
    the fused prefill and mixed dispatches are off (the decode ring
    splits the rows into pp microbatches; its row layouts round to them,
    `_decode_rows`)."""
    import dataclasses

    if vision is not None or model_cfg.mrope_section:
        raise ValueError(
            f"pp={pp} does not serve a vision tower or M-RoPE yet "
            f"(ROADMAP 2.8, as the JAX engine refuses it)")
    return dataclasses.replace(cfg, fuse_prefill_decode=False,
                               mixed_prefill_tokens=0)


def _sp_config(cfg: EngineConfig, model_cfg: ModelConfig, parallel,
               vision) -> EngineConfig:
    """The engine config of a sequence-parallel group (JAX `engine.py:
    1423-1482`): whole-remainder prefill (no mixed dispatches, a step
    budget that never splits a prompt), chunk buckets divisible by sp, no
    prefix cache on a partitioned pool (prefix pages are owner-shard-
    local), MoE experts on the tp axis through the ragged dispatch, and
    even tp splits of the heads, the vocab and a dense ffn.  The a2a MoE
    (ROADMAP 2.5), a vision tower or an M-RoPE model (ROADMAP 2.8) are
    refused."""
    import dataclasses

    sp, tp = parallel.sp, parallel.tp
    if vision is not None or model_cfg.mrope_section:
        raise ValueError(
            f"sp={sp} does not serve a vision tower or M-RoPE yet "
            f"(ROADMAP 2.8)")
    cfg = dataclasses.replace(cfg, mixed_prefill_tokens=0)
    if cfg.enable_prefix_caching and cfg.kv_partition:
        raise ValueError(
            "sp > 1 with kv_partition requires "
            "enable_prefix_caching=False (prefix pages are "
            "owner-shard-local)")
    if cfg.max_prefill_tokens < cfg.max_model_len * cfg.prefill_batch_size:
        raise ValueError(
            "sp > 1 requires max_prefill_tokens >= "
            "max_model_len * prefill_batch_size — the step "
            "budget is shared across co-planned prompts and "
            "none may be split into chunks")
    bad = [b for b in cfg.chunk_buckets if b % sp]
    if bad:
        raise ValueError(f"chunk buckets {bad} not divisible by sp={sp}")
    if tp > 1 and model_cfg.is_moe:
        if model_cfg.moe_impl == "a2a":
            raise ValueError(
                "sp×tp MoE with moe_impl='a2a' (wide-EP capacity drops) is "
                "not ported yet (ROADMAP 2.5); use moe_impl='ragged'")
        if (model_cfg.moe_impl != "ragged"
                or model_cfg.num_experts % tp):
            raise ValueError(
                "sp×tp MoE requires moe_impl='ragged'|'a2a' and "
                "num_experts divisible by tp")
    uneven = {"q heads": model_cfg.num_attention_heads,
              "kv heads": model_cfg.num_key_value_heads,
              "vocab_size": model_cfg.vocab_size}
    if not model_cfg.is_moe:
        uneven["intermediate_size"] = model_cfg.intermediate_size
    bad_dims = [k for k, v in uneven.items() if v % tp]
    if bad_dims:
        raise ValueError(
            f"tp={tp} must evenly divide "
            f"{', '.join(bad_dims)} for sp×tp prefill")
    return cfg


def _dp_config(cfg: EngineConfig, dp: int) -> EngineConfig:
    """The engine config of a dp group (JAX `engine.py:1483-1516`): a
    partitioned pool turns the fused prefill off and refuses decode
    buckets below ``max_num_seqs``; a replicated one rounds every decode
    bucket up to a multiple of dp."""
    import dataclasses

    if cfg.kv_partition:
        if max(cfg.decode_batch_buckets) < cfg.max_num_seqs:
            # bucket_for clamps to buckets[-1]: a per-rank decode group
            # wider than the largest bucket would break the R-uniform-
            # blocks layout (JAX's refusal)
            raise ValueError(
                f"kv_partition requires max(decode_batch_buckets)"
                f"={max(cfg.decode_batch_buckets)} >= "
                f"max_num_seqs={cfg.max_num_seqs}")
        return dataclasses.replace(cfg, fuse_prefill_decode=False)
    return dataclasses.replace(cfg, decode_batch_buckets=sorted(
        {-(-b // dp) * dp for b in cfg.decode_batch_buckets}))


class TorchEngine:
    """Continuous-batching engine over a paged KV cache on one device."""

    @property
    def parts(self) -> int:
        """The pool's partitions (each (replica, slot) of a partitioned
        pool; else the dp replicas)."""
        return self.dp * self.sp if self._pooled else self.dp

    def __init__(
        self,
        model_cfg: ModelConfig,
        model: Llama,
        engine_cfg: Optional[EngineConfig] = None,
        eos_token_ids: Optional[List[int]] = None,
        event_sink: Optional[Callable[[KvEvent], None]] = None,
        device=None,
        tiered=None,  # kvbm.TieredKvCache — host/disk KV tiers
        vision=None,  # (tower or None, VisionConfig | Qwen2VLVisionConfig)
        parallel=None,  # parallel.ParallelConfig — the dp x tp group
        devices=None,  # each rank's device (default: one card a rank)
        group=None,  # a follower's TpGroup (set by lockstep.follower_main)
    ):
        self.cfg = engine_cfg or EngineConfig()
        self.tp = parallel.tp if parallel is not None else 1
        self.dp = parallel.dp if parallel is not None else 1
        self.pp = parallel.pp if parallel is not None else 1
        self.sp = parallel.sp if parallel is not None else 1
        self.world = self.tp * self.dp * self.pp * self.sp
        # a pipeline runs its dispatches through `parallel/pipeline.py`.
        # A check hook besides: set on a flat engine before its first
        # request, it runs that path at one stage (eagerly), which must be
        # bit-equal to the flat rows (chip_smoke.py phase 19 (a))
        self._staged = self.pp > 1
        self.group = group
        self._lockstep: Optional[lockstep.Leader] = None
        if parallel is not None:
            from ..models.llama import _check_supported
            from ..parallel import check_ported

            check_ported(parallel)
            if self.sp > 1:  # its rules first, with JAX's messages
                self.cfg = _sp_config(self.cfg, model_cfg, parallel, vision)
            _check_supported(model_cfg, self.tp, self.pp)
        if self.pp > 1:
            self.cfg = _pp_config(self.cfg, model_cfg, self.pp, vision)
        if self.cfg.kv_partition and self.dp * self.sp == 1:
            raise ValueError("kv_partition requires a serving mesh "
                             "(ParallelConfig with dp*sp > 1)")
        # a partitioned pool: one partition a (dp, sp) shard (JAX
        # `_pooled`, `_pool_ranks`)
        self._pooled = bool(self.cfg.kv_partition)
        if self.dp * self.sp > 1:
            self.cfg = _dp_config(self.cfg, self.dp)
        if self.world > 1:
            bad = _group_refusals(self.cfg, self.tp)
            if bad:
                what = ("dp x sp x tp" if self.sp > 1 else
                        "dp x tp" if self.dp > 1 else "tp")
                raise ValueError(f"not served under {what}: {'; '.join(bad)}")
            if group is None:
                # the leader: spawn the followers, join, build rank 0
                self.group, procs, devs = lockstep.start_group(
                    parallel, devices, {
                        "model": model, "model_cfg": model_cfg,
                        "engine_cfg": self.cfg,
                        "eos": list(eos_token_ids or [])})
                self._lockstep = lockstep.Leader(self.group, procs)
                try:
                    shard = lockstep.build_in_turn(
                        0, devs, lambda: lockstep.build_shard(model,
                                                              self.group))
                    self._setup(model_cfg, shard, eos_token_ids, event_sink,
                                self.group.device, tiered, vision)
                except BaseException:
                    self._lockstep.abort()
                    raise
                # every rank has built its shard, engine and pool
                try:
                    lockstep.handshake(True, "build its engine")
                except RuntimeError as e:
                    self._lockstep.lost = str(e)
                    self._lockstep.shutdown()
                    raise
                return
            device = self.group.device
        self._setup(model_cfg, model, eos_token_ids, event_sink, device,
                    tiered, vision)

    def _setup(self, model_cfg, model, eos_token_ids, event_sink, device,
               tiered, vision) -> None:
        if self.world > 1:
            model.attach_group(self.group)
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(
                f"model lives on {model.device}, engine on {self.device}")
        self.model_cfg = model_cfg
        self.model = model
        # the vision tower and its config; a tower of None keeps only the
        # geometry (a worker whose media an encode worker encodes)
        self.vision = vision
        if self.cfg.quantization == "int8":
            # in place: the caller's model becomes the int8 one, so an 8B
            # model never holds both copies (a tp shard's row-parallel
            # scales come from the whole weight: a collective)
            quantize_params(model)
        self.eos_token_ids = eos_token_ids or []
        # every device op of the engine goes to ONE stream, whichever
        # thread issues it: a park on the event-loop thread is then
        # ordered after the step thread's last replay into those pages
        self._stream = (torch.cuda.default_stream(self.device)
                        if self.device.type == "cuda" else None)
        self.kv = self._make_kv()
        self._extra_event_sinks: List[Callable[[KvEvent], None]] = []
        if event_sink:
            self._extra_event_sinks.append(event_sink)
        self.pool = self._make_pool()
        self.scheduler = Scheduler(self.cfg, self.pool)
        # preemption parking lot (overload control): batch-class victims
        # preempted mid-decode park byte-exact KV here (every kv head,
        # under tp too) and resume through ordinary admission
        self.parking = ParkingLot(self.cfg.park_max_pages)
        self.scheduler.park_fn = self._park_seq
        self.scheduler.resume_fn = self._resume_parked
        self.scheduler.unpark_fn = self._unpark_seq
        self.tiered = None
        # a follower's mappings of disagg source pools (the CUDA IPC lane;
        # the leader maps through its transfer client's `IpcLane`)
        self._ipc_lane = None
        # the device loop: captured block graphs, block functions per
        # (kind, rung, variant); a group's blocks run eagerly (their gloo
        # collectives and the replicas' gathers cannot be captured)
        self.graphs = GraphRunner(self.device, capture=self.world == 1)
        self._block_fns: Dict[tuple, Callable] = {}
        self._py_rng = random.Random(0xD1A)
        self._queues: Dict[str, asyncio.Queue] = {}
        self._contexts: Dict[str, Context] = {}
        self._wake = asyncio.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._executor: Optional[cf.ThreadPoolExecutor] = None
        # the continuous loop's drain thread (fetch + unpack of block k
        # while the step thread dispatches block k+1), started lazily
        self._drain_pool: Optional[cf.ThreadPoolExecutor] = None
        # held by a step for its whole body (its deferred frees included),
        # by the planning between steps and by `clear_kv_blocks`: a clear
        # from any thread waits for the step in flight, so the pages of a
        # stream that has ended are back in the LRU when it reads them,
        # and no two threads walk the pool at once
        self._step_lock = threading.RLock()
        self._closed = False
        self._pending_aborts: set = set()
        # ("add" | "imported", seq): imported sequences hold KV written
        # elsewhere and are admitted without a prefill
        self._pending_adds: List[Tuple[str, Sequence]] = []
        # (op, future) page operations for the step thread (`_device_op`)
        self._pending_ops: List[Tuple[Callable[[], Any], asyncio.Future]] = []
        self._requests_total = 0
        self._ttft = {"block_wait_ms": 0.0, "queue_wait_ms": 0.0,
                      "prefill_ms": 0.0}
        self._ttft_attributed = 0
        self._cached_tokens_total = 0  # prompt tokens served by the prefix cache
        self._cc_blocks_total = 0
        self._cc_chains_total = 0
        self._cc_fallout_by_reason: Dict[str, int] = {}
        self._spec_draft_total = 0
        self._spec_accepted_total = 0
        self._spec_dispatch_total = 0
        self._spec_window: deque = deque(maxlen=128)  # (drafted, accepted)
        self._rung_dispatches: Dict[int, int] = {}
        # optional dispatch trace (tests / chip checks): set to a list and
        # every device dispatch appends {kind, n_steps, blocks, ...}; KV
        # moves (park, resume, onboard) add their pages and host ms
        self.dispatch_trace: Optional[List[dict]] = None
        # the layout rows whose media each recent prefill spliced on this
        # rank (`media.block_extras`), and a leader's media on its plans
        self.media_rows: deque = deque(maxlen=256)
        self.media_plan = {"chunks": 0, "bytes": 0, "ms": 0.0}
        if tiered is not None:
            self.attach_connector(tiered)

    def _make_kv(self) -> KVCache:
        """This rank's pool: ``num_pages`` pages of its heads and its
        stage's layers (a replica of a partitioned pool holds its
        partition's pages, local ids)."""
        return KVCache.create(self.model_cfg, self.cfg.num_pages,
                              self.cfg.page_size, dtype=self.model.dtype,
                              device=self.device, tp=self.tp, pp=self.pp)

    def _make_pool(self):
        if self._pooled:
            from .page_pool import ShardedPagePool

            return ShardedPagePool(self.parts, self.cfg.num_pages,
                                   self.cfg.page_size,
                                   event_sink=self._emit_event)
        return PagePool(self.cfg.num_pages, self.cfg.page_size,
                        event_sink=self._emit_event)

    # -- events / metrics ------------------------------------------------- #

    def _emit_event(self, ev: KvEvent) -> None:
        for sink in self._extra_event_sinks:
            try:
                sink(ev)
            except Exception:  # noqa: BLE001 — sinks must not break the engine
                logger.exception("kv event sink failed")

    def add_event_sink(self, sink: Callable[[KvEvent], None]) -> None:
        self._extra_event_sinks.append(sink)

    def _spec_acceptance_rate(self) -> float:
        """Rolling acceptance over the recent verify dispatches."""
        drafted = sum(d for d, _ in self._spec_window)
        if not drafted:
            return 0.0
        return sum(a for _, a in self._spec_window) / drafted

    def metrics(self) -> ForwardPassMetrics:
        running, waiting = self.scheduler.num_requests()
        m = ForwardPassMetrics(
            active_seqs=running,
            waiting_seqs=waiting,
            # the fullest partition: one full rank blocks admission (a
            # sequence pins to a rank); capacity sums the partitions
            kv_usage=self.pool.usage_max_rank(),
            kv_total_pages=self.cfg.usable_pages * self.pool.ranks,
            num_requests_total=self._requests_total,
            spec_draft_tokens_total=self._spec_draft_total,
            spec_accepted_tokens_total=self._spec_accepted_total,
            spec_dispatches_total=self._spec_dispatch_total,
            spec_acceptance_rate=self._spec_acceptance_rate(),
            ttft_block_wait_ms_total=self._ttft["block_wait_ms"],
            ttft_queue_wait_ms_total=self._ttft["queue_wait_ms"],
            ttft_prefill_ms_total=self._ttft["prefill_ms"],
            ttft_attributed_total=self._ttft_attributed,
            decode_cc_blocks_total=self._cc_blocks_total,
            decode_cc_chains_total=self._cc_chains_total,
            decode_cc_fallout_total=dict(self._cc_fallout_by_reason),
            prefix_cached_tokens_total=self._cached_tokens_total,
            batch_occupancy=running / max(self.cfg.max_num_seqs, 1),
            kv_watermark_headroom_pages=max(
                0, self.pool.available_pages
                - self.scheduler._watermark_pages()),  # noqa: SLF001
            shed_total=self.scheduler.shed_total,
            queued_total=self.scheduler.queued_total,
            preempted_total=self.scheduler.preempted_total,
            resumed_total=self.scheduler.resumed_total,
            parked_seqs=len(self.parking),
            parked_pages=self.parking.pages_held,
        )
        for rung, n in sorted(self._rung_dispatches.items()):
            setattr(m, f"decode_rung{rung}_dispatches_total", n)
        if self._lockstep is not None:
            # the group: its size, backend, plans sent, and each rank's
            # kernel launches (the followers' as of their last report:
            # `group_stats` or shutdown)
            from ..ops._launches import LAUNCHES

            m.tp = self.tp
            m.dp = self.dp
            m.pp = self.pp
            m.sp = self.sp
            m.kv_partition = self._pooled
            m.tp_backend = self.group.backend
            m.tp_plans_total = self._lockstep.plans
            m.tp_rank_launches = {
                **{str(r): dict(v)
                   for r, v in self._lockstep.rank_launches.items()},
                "0": dict(LAUNCHES)}
        if self.tiered is not None:
            # KVBM tier stats ride the same snapshot as dynamic attrs
            t = self.tiered
            m.kvbm_host_blocks = len(t.host)
            m.kvbm_pending_offloads = t.pending_offloads
            m.kvbm_inflight_offloads = t.inflight_offloads
            m.kvbm_offload_total = t.offloaded_blocks
            m.kvbm_onboard_total = t.onboarded_blocks
            m.kvbm_evict_total = t.host.evicted
            m.kvbm_host_hits_total = t.host.hits
            m.kvbm_host_misses_total = t.host.misses
            m.kvbm_host_bytes = t.host.bytes_used
            m.kvbm_host_capacity_bytes = t.host.capacity_bytes
            if t.disk is not None:
                m.kvbm_disk_blocks = len(t.disk)
                m.kvbm_disk_hits_total = t.disk.hits
                m.kvbm_disk_misses_total = t.disk.misses
                m.kvbm_disk_bytes = t.disk.bytes_used
        return m

    @property
    def rung_histogram(self) -> Dict[int, int]:
        """Dispatch count per chosen decode-block rung (decode, mixed and
        fused dispatches; chained blocks count once per block)."""
        return dict(self._rung_dispatches)

    @property
    def graph_keys(self) -> List[tuple]:
        """Keys of the block graphs captured so far (on the CPU: the keys
        the blocks ran under) — the counterpart of the JAX engine's
        `compiled_variants`."""
        return self.graphs.keys

    def clear_kv_blocks(self) -> int:
        """Drop every evictable cached page; returns the pages reclaimed.
        Safe from any thread: it waits for the step in flight (whose
        deferred frees return a finished stream's pages first).  The
        worker's control op calls it off the event loop."""
        with self._step_lock:
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
        # a remote prefill keeps its pages past finish for the data plane
        seq.hold_pages = bool(request.get("_hold_pages"))
        if (request.get("mm_pixels") or request.get("mm_patches")
                or request.get("mm_embeds") is not None):
            err = media.attach(self, seq, request)
            if err:
                yield {"token_ids": [], "finish_reason": "error", "error": err}
                return
        queue: asyncio.Queue = asyncio.Queue()
        self._queues[context.id] = queue
        self._contexts[context.id] = context
        self._requests_total += 1
        self._pending_adds.append(("add", seq))
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
        if self.scheduler.deferred_free:
            self.pool.free(self.scheduler.deferred_free)
            self.scheduler.deferred_free = None
        # page operations the pump will never run
        while self._pending_ops:
            _, fut = self._pending_ops.pop(0)
            if not fut.done():
                fut.set_exception(RuntimeError("engine shut down"))
        loop = asyncio.get_running_loop()
        for name in ("_executor", "_drain_pool"):
            pool = getattr(self, name)
            if pool is not None:
                await loop.run_in_executor(None, pool.shutdown, True)
                setattr(self, name, None)
        if self.tiered is not None:
            # join the kvbm-offload drain thread: no tier write outlives
            # shutdown(); a tier shared with a later engine reopens it
            await loop.run_in_executor(None, self.tiered.close)
        if self._lockstep is not None and not self.group.closed:
            # stop and join the followers (their launches come back)
            await loop.run_in_executor(None, self._lockstep.shutdown)

    def _plan_step(self) -> StepPlan:
        """Apply queued adds (before aborts, so an abort always finds its
        sequence) and graceful stops, then plan the next step."""
        with self._step_lock:
            while self._pending_adds:
                kind, seq = self._pending_adds.pop(0)
                if kind == "imported":
                    self.scheduler.add_imported(seq)
                else:
                    self.scheduler.add(seq)
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
            # queued page operations (disagg export/import, alloc, free)
            while self._pending_ops:
                op, fut = self._pending_ops.pop(0)
                try:
                    result = await loop.run_in_executor(
                        self._executor, self._step, _call, op)
                    if not fut.done():
                        fut.set_result(result)
                except Exception as e:  # noqa: BLE001 — the caller's error
                    if not fut.done():
                        fut.set_exception(e)
                    if self._lockstep is not None and self._lockstep.open:
                        # a plan of the failed op went out: recover the
                        # group, as after a failed step
                        self._recover_after_error()
            # launch one batch of queued offloads (KVBM): the gather runs
            # on the step thread between steps, the copy on the drain
            if self.tiered is not None and self.tiered.pending_offloads:
                try:
                    await loop.run_in_executor(
                        self._executor, self._step,
                        self.tiered.pump_offloads, self)
                except Exception:  # noqa: BLE001
                    logger.exception("kv offload failed")
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
                        or self._pending_aborts or self._pending_ops):
                    if self.tiered is not None and self.tiered.pending_offloads:
                        # only offload work remains: keep pumping batches,
                        # with a real sleep — a backpressured dispatch
                        # (drain busy) would otherwise spin the step thread
                        await asyncio.sleep(0.002)
                        continue
                    # shutdown() may have set _closed while this iteration
                    # was suspended: clearing _wake would eat its wakeup
                    if self._closed:
                        break
                    self._wake.clear()
                    await self._wake.wait()
                else:
                    await asyncio.sleep(0)
                continue
            run = {"prefill": self._run_prefill, "mixed": self._run_mixed,
                   "decode": self._run_decode}[plan.kind]
            arg = {"prefill": plan.prefill, "mixed": plan,
                   "decode": plan.decode}[plan.kind]
            try:
                await loop.run_in_executor(self._executor, self._step, run, arg)
            except Exception:  # noqa: BLE001
                logger.exception("engine step failed; resetting KV state")
                self._recover_after_error()
            await asyncio.sleep(0)

    def _step(self, run, arg):
        with self._step_lock, torch.no_grad(), torch.cuda.stream(self._stream):
            out = run(arg)
        if self._lockstep is not None:
            self._lockstep.open = None  # every plan of this op completed
        return out

    # -- the tp group's plan channel (lockstep.py) ------------------------- #

    def _plan(self, kind: str, **fields) -> None:
        """A leader sends every device operation to its followers before
        running it (no-op without a group, and on a follower)."""
        if self._lockstep is not None:
            self._lockstep.send({"kind": kind, **fields})

    async def group_stats(self) -> Dict[int, Dict[str, int]]:
        """Each rank's kernel launches, asked of the followers now
        (between steps, on the step thread)."""
        from ..ops._launches import LAUNCHES

        stats = ({} if self._lockstep is None
                 else await self._device_op(lambda: self._lockstep.stats(self)))
        return {**stats, 0: dict(LAUNCHES)}

    async def group_reports(self) -> Dict[int, Dict[str, Any]]:
        """A leader's view of every rank now: its launches, the layout rows
        its recent prefills spliced media into, and its vision tower's
        parameter count (`lockstep._own_stats`)."""
        if self._lockstep is None:
            raise RuntimeError("group_reports: this engine leads no group")
        await self._device_op(lambda: self._lockstep.stats(self))
        return dict(self._lockstep.rank_stats)

    def reset_kv(self) -> None:
        """Zero the pool in place (captured graphs hold its addresses)."""
        self.kv.k.zero_()
        self.kv.v.zero_()

    def replay_inputs(self, desc: Dict[str, Any]):
        """A follower's host half of a plan: the dispatch's inputs, built
        before the group's ready check (`lockstep.follow`)."""
        kind = desc["kind"]
        need = _PLAN_ARRAYS.get(kind)
        if need is None:
            raise ValueError(f"unknown plan kind {kind!r}")
        missing = [k for k in need if k not in desc["arrays"]]
        if missing:
            raise KeyError(f"a {kind!r} plan lacks {missing}")
        if kind == "prefill":
            mm = desc.get("media")
            return {"arrays": self._to_device(desc["arrays"]),
                    "media": None if mm is None else media.from_wire(self, mm)}
        if kind == "embed":
            return self._to_device(desc["arrays"])
        if kind == "kv_export":
            return {"pages": self._page_index(desc["arrays"]["pages"]),
                    "src": desc.get("src", 0)}
        if kind == "kv_import":
            return self._import_inputs(desc)
        if kind in ("decode", "spec"):
            d = self._host(desc["arrays"])
            if desc.get("counts") is not None:
                d["counts"] = self._counts_from_sparse(desc["counts"],
                                                       desc["arrays"]["tok"])
            return d

    def replay(self, desc: Dict[str, Any], d: Dict[str, torch.Tensor]) -> None:
        """A follower's device half of a plan: the leader's dispatch on
        this rank's shard and pool (its results stay on the device)."""
        self._step(self._replay, (desc, d))

    def _replay(self, arg) -> None:
        desc, d = arg
        kind = desc["kind"]
        if kind == "prefill":
            self._prefill_block(d["arrays"], Variant(*desc["variant"]),
                                mm=d["media"],
                                prefix_pages=desc.get("prefix_pages", 0))
        elif kind == "decode":
            self._dispatch_decode(d, Variant(*desc["variant"]),
                                  desc["chain_len"], desc["n_steps"])
        elif kind == "spec":
            self._spec_block(d, desc["k"], desc["greedy"])
        elif kind == "embed":
            # replica 0 (its sequence slot 0) embeds (`_embed_rows`)
            if self.group.replica == 0 and self.group.sp_rank == 0:
                self._embed_dev(d["tokens"], d["lens"])
        elif kind == "kv_export":
            self._export_replay(d["pages"], d["src"])
        elif kind == "kv_import":
            self._import_replay(desc, d)

    @staticmethod
    def _sparse_counts(counts: Optional[torch.Tensor]):
        """A decode plan's penalty histograms as (row, token, count)
        triples: the dense [B, vocab] rows would put ~4 MB a dispatch on
        the plan channel at a 128k vocabulary (JAX's sparse plans)."""
        if counts is None:
            return None
        idx = counts.nonzero()
        return {"idx": idx.cpu().numpy(), "n": counts[idx[:, 0], idx[:, 1]]
                .cpu().numpy()}

    def _counts_from_sparse(self, sparse, tok: np.ndarray) -> torch.Tensor:
        counts = torch.zeros((len(tok), self.model_cfg.vocab_size),
                             dtype=torch.float32, device=self.device)
        idx = torch.from_numpy(sparse["idx"]).to(self.device)
        counts[idx[:, 0], idx[:, 1]] = torch.from_numpy(sparse["n"]).to(
            self.device)
        return counts

    # -- host arrays of a dispatch (row layouts) ---------------------------- #

    def _decode_rows(self, seqs: List[Sequence]) -> List[Optional[Sequence]]:
        """Decode rows padded to `max_num_seqs` (None = padding: token 0 at
        position 0 of trash page 0).  Every block then has the same matrix
        shapes, so the GEMM library picks the same kernels whatever the
        batch holds, a row's tokens do not depend on its batch-mates, and
        one graph per key serves every batch.  Under dp the rows are dp
        uniform blocks, one a replica: a replicated pool pads to the next
        multiple of dp and splits the rows in order; a partitioned pool
        gives each partition's sequences a block of `max_num_seqs` rows
        (JAX `_decode_rows`).  A pipeline rounds the rows up to dp x pp
        (a partitioned pool's blocks to pp): each replica's block splits
        into pp microbatches (JAX rounds its decode buckets so).  Under sp
        a replicated pool's rows split over dp alone (every sequence slot
        of a replica runs its replica's block), a partitioned pool's over
        its dp x sp partitions (JAX `engine.py:1492-1494`)."""
        n = self.cfg.max_num_seqs
        if not self._pooled:
            unit = self.dp * self.pp
            n = -(-n // unit) * unit
            return list(seqs) + [None] * (n - len(seqs))
        n = -(-n // self.pp) * self.pp
        return self._rank_blocks(seqs, lambda s: s.kv_rank, n, self.parts)

    def _rank_blocks(self, items, rank_of, width: int,
                     blocks_n: Optional[int] = None) -> list:
        """`items` grouped by `rank_of` into `blocks_n` (default dp) blocks
        of `width` rows each (None-padded), in block order."""
        by_rank: List[list] = [[] for _ in range(blocks_n or self.dp)]
        for it in items:
            by_rank[rank_of(it)].append(it)
        if max(len(g) for g in by_rank) > width:
            raise ValueError(f"a partition's rows exceed the block width "
                             f"{width}")
        rows: list = []
        for g in by_rank:
            rows += g + [None] * (width - len(g))
        return rows

    def _prefill_rows(self, items: List[PrefillItem]) -> List[Optional[PrefillItem]]:
        """The prefill row layout: the items themselves on a flat engine;
        under dp, dp uniform blocks (a replicated pool pads to a multiple
        of dp, a partitioned pool groups the items by partition, JAX
        `_prefill_rows`; under sp by dp shard, ``kv_rank // sp``: the
        sequence axis rides sp, JAX `engine.py:2632-2636`).  A padding row
        runs a 1-token chunk into the trash page."""
        if self.dp == 1:
            return list(items)
        if not self._pooled:
            n = -(-len(items) // self.dp) * self.dp
            return list(items) + [None] * (n - len(items))
        counts = [0] * self.dp
        for it in items:
            counts[it.seq.kv_rank // self.sp] += 1
        return self._rank_blocks(items, lambda it: it.seq.kv_rank // self.sp,
                                 max(counts))

    # -- the replicas of a dp group ------------------------------------------ #

    def _span(self, rows: int, by_part: bool = False) -> Tuple[int, int]:
        """(first row, rows) of this replica's block of a `rows`-row
        layout: the whole of it without dp.  `by_part`: the layout is one
        block a partition of a partitioned pool (a decode layout; under sp
        a (replica, slot) each), this rank's partition's block."""
        n_blocks, me = self.dp, (0 if self.group is None
                                 else self.group.replica)
        if by_part and self._pooled:
            n_blocks, me = self.parts, self.group.part
        if n_blocks == 1:
            return 0, rows
        n = rows // n_blocks
        return me * n, n

    def _block(self, d: Dict[str, torch.Tensor],
               by_part: bool = False) -> Dict[str, torch.Tensor]:
        """This replica's (`by_part`: this partition's) rows of a
        dispatch's inputs (every input is row-major)."""
        lo, n = self._span(next(iter(d.values())).shape[0], by_part)
        if n == next(iter(d.values())).shape[0]:
            return d
        return {k: t[lo:lo + n] for k, t in d.items()}

    def _partition(self, pages) -> Tuple[Optional[int], List[int]]:
        """(the partition holding `pages`, their local ids) on a
        partitioned pool; (None, the pages) on a replicated or flat one.
        The pages of one sequence or transfer share one partition."""
        pages = [int(p) for p in pages]
        if not self._pooled:
            return None, pages
        ranks = {self.pool.rank_of(p) for p in pages} or {0}
        if len(ranks) > 1:
            raise ValueError(f"pages {pages} span partitions {sorted(ranks)}")
        return ranks.pop(), [self.pool.local_id(p) for p in pages]

    def _replica_writes(self, table: np.ndarray, start, count) -> list:
        """The pool slots each replica's block wrote in a dispatch: row i
        wrote positions start[i] .. start[i] + count[i] - 1 (those below
        the context cap; the rest, and padding rows, hit the trash page).
        Returns one (pages, slots) pair of int64 arrays a replica."""
        ps, cap = self.cfg.page_size, self.cfg.hard_cap
        start = np.asarray(start, np.int64).reshape(-1)
        count = np.broadcast_to(np.asarray(count, np.int64),
                                start.shape).copy()
        width = table.shape[1]
        q = start[:, None] + np.arange(max(int(count.max()), 1))[None]
        ok = (q - start[:, None] < count[:, None]) & (q < cap)
        col = np.minimum(q // ps, width - 1)
        ok &= q // ps < width
        page = np.where(ok, np.take_along_axis(table.astype(np.int64), col, 1),
                        0)
        ok &= page != 0
        n = len(start) // self.dp
        out = []
        for d in range(self.dp):
            m = ok[d * n:(d + 1) * n]
            out.append((page[d * n:(d + 1) * n][m],
                        (q[d * n:(d + 1) * n] % ps)[m]))
        return out

    def _sync_replicas(self, table, start, count) -> None:
        """A replicated pool after a dispatch: every replica sends the K/V
        rows its block wrote to the others over its dp group (each tensor
        rank its own heads) and writes theirs, so every replica's pool is
        byte-equal again, the trash page aside.  No-op without dp and on
        a partitioned pool."""
        if self.dp == 1 or self._pooled:
            return
        from ..parallel.collectives import all_parts

        g = self.group
        writes = self._replica_writes(_host_array(table), _host_array(start),
                                      _host_array(count))
        L, _, _, h, hd = self.kv.k.shape
        idx = [(torch.as_tensor(p, device=self.device),
                torch.as_tensor(sl, device=self.device)) for p, sl in writes]
        pg, sl = idx[g.replica]
        own = torch.stack([self.kv.k[:, pg, sl], self.kv.v[:, pg, sl]])
        parts = all_parts(own, g.replica, g.dp_ranks(), g.dp_group,
                          shapes=[(2, L, len(p), h, hd) for p, _ in writes])
        for r, part in enumerate(parts):
            if r != g.replica and part.shape[2]:
                pg, sl = idx[r]
                self.kv.k[:, pg, sl] = part[0]
                self.kv.v[:, pg, sl] = part[1]

    def _gather_results(self, packed: List[torch.Tensor], widths,
                        shapes=None, by_part: bool = False
                        ) -> Optional[List[torch.Tensor]]:
        """Each replica's packed results (one tensor a block) joined over
        every row, on the leader; None on the other ranks.  Without dp
        the leader's own.  Under dp every replica's tensor rank 0 sends
        its block's over its dp group.  Under pp the results are the last
        stage's: its replicas' tensor ranks 0 join them over their dp
        group, then replica 0's sends them to the leader over its pp group
        (`shapes`: each joined tensor's shape, for the other stages'
        buffers)."""
        if self.pp > 1:
            g = self.group
            if g.tp_rank != 0:
                return None
            if g.last_stage and self.dp > 1:
                from ..parallel.collectives import all_parts

                packed = [blocks.join_packed(all_parts(
                    p, g.replica, g.dp_ranks(), g.dp_group), widths)
                          for p in packed]
            if g.replica != 0:
                return None
            out = [self._from_last_stage(p, shape)
                   for p, shape in zip(packed, shapes)]
            return out if g.rank == 0 else None
        if self.dp * self.sp == 1:
            return packed if self._lockstep is not None or self.group is None \
                else None
        g = self.group
        if g.tp_rank != 0:
            return None
        from ..parallel.collectives import all_parts

        if by_part and self._pooled and self.sp > 1:
            # a partition's block each: every (replica, slot) sends
            me, ranks, pg = g.part, g.pool_ranks(), g.pool_group
        else:
            # a replica's block each, from its sequence slot 0
            if g.sp_rank != 0:
                return None
            if self.dp == 1:
                return packed if g.rank == 0 else None
            me, ranks, pg = g.replica, g.dp_ranks(), g.dp_group
        joined = [blocks.join_packed(all_parts(p, me, ranks, pg), widths)
                  for p in packed]
        return joined if g.rank == 0 else None

    def _from_last_stage(self, t: Optional[torch.Tensor], shape) -> torch.Tensor:
        """The last stage's f32 tensor `t` of `shape` on every stage of
        this (replica, tensor rank)'s pp group (a broadcast over it; the
        other stages pass None and get the bytes)."""
        from ..parallel.collectives import broadcast_bytes

        g = self.group
        if not g.last_stage:
            t = torch.empty(shape, dtype=torch.float32, device=self.device)
        return broadcast_bytes(t.contiguous(), g.rank_of(
            g.replica, self.pp - 1, g.tp_rank), g.pp_group)

    def _seed_arrays(self, rows: List[Optional[Sequence]]):
        seeds = [s.seed & 0xFFFFFFFF if s else 0 for s in rows]
        counters = [len(s.output_tokens) if s else 0 for s in rows]
        return np.asarray(seeds, np.int64), np.asarray(counters, np.int64)

    @staticmethod
    def _is_greedy(rows: List[Optional[Sequence]]) -> bool:
        """True when every row is temperature 0: the dispatch takes the
        STATIC greedy variant (no noise drawn)."""
        return all(s is None or s.opts.temperature <= 0.0 for s in rows)

    def _variant(self, rows: List[Optional[Sequence]]) -> Variant:
        live = [s for s in rows if s is not None]
        return Variant(penalized=any(s.opts.penalized for s in live),
                       with_top=any(s.opts.top_logprobs > 0 for s in live),
                       greedy=self._is_greedy(rows))

    def _table_array(self, rows: List[Optional[Sequence]]) -> np.ndarray:
        """Page-table batch, width bucketed to the longest row present
        (`table_width_buckets`): the decode kernel's grid follows the
        width, so a graph fixes its bucket.  Unused entries point at trash
        page 0; padding changes only how many EMPTY splits the decode
        merge sees, which leaves its output bit-identical."""
        need = max((len(s.pages) for s in rows if s), default=1)
        width = bucket_for(max(need, 1), self.cfg.table_width_buckets)
        table = np.zeros((len(rows), width), np.int32)
        npp = self.cfg.num_pages
        for i, s in enumerate(rows):
            if s is not None:
                n = min(len(s.pages), width)
                # a partitioned pool's tables hold LOCAL ids (each
                # partition's page 0 is its own trash page)
                table[i, :n] = ([p % npp for p in s.pages[:n]] if self._pooled
                                else s.pages[:n])
        return table

    def _samp_arrays(self, rows: List[Optional[Sequence]]) -> Dict[str, np.ndarray]:
        def col(get, default, dtype):
            return np.asarray([get(s.opts) if s else default for s in rows], dtype)

        return {
            "temperature": col(lambda o: o.temperature, 0.0, np.float32),
            "top_k": col(lambda o: o.top_k, 0, np.int64),
            "top_p": col(lambda o: o.top_p, 1.0, np.float32),
            "fp": col(lambda o: o.frequency_penalty, 0.0, np.float32),
            "pp": col(lambda o: o.presence_penalty, 0.0, np.float32),
        }

    def _rope_inputs(self, rows: List[Optional[Sequence]]) -> Dict[str, np.ndarray]:
        """An M-RoPE model's per-row rope offset, a static input of every
        decode-side graph; nothing for other models."""
        if not self.model_cfg.mrope_section:
            return {}
        return {"rope_off": media.rope_offsets(rows)}

    def _decode_arrays(self, rows: List[Optional[Sequence]]):
        """(last tokens [B], positions [B]) for a decode row layout."""
        tokens = np.zeros((len(rows),), np.int64)
        positions = np.zeros((len(rows),), np.int64)
        for i, s in enumerate(rows):
            if s is None:
                continue
            tokens[i] = s.output_tokens[-1] if s.output_tokens else (
                s.prompt[-1] if s.prompt else 0)
            positions[i] = s.num_computed
        return tokens, positions

    def _counts_tensor(self, rows: List[Optional[Sequence]]) -> torch.Tensor:
        """[B, vocab] output-token histograms on the device, built from
        the rows' output tokens by one scatter-add (prompt tokens are not
        penalized); blocks then update them on the device."""
        rid, tid = [], []
        for i, s in enumerate(rows):
            if s is not None:
                rid += [i] * len(s.output_tokens)
                tid += s.output_tokens
        counts = torch.zeros((len(rows), self.model_cfg.vocab_size),
                             dtype=torch.float32, device=self.device)
        if tid:
            idx = self._to_device({"r": np.asarray(rid, np.int64),
                                   "t": np.asarray(tid, np.int64)})
            counts.index_put_((idx["r"], idx["t"]),
                              torch.ones_like(idx["t"], dtype=torch.float32),
                              accumulate=True)
        return counts

    def _host(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host arrays as tensors to copy from without a sync: page-locked
        on CUDA.  PyTorch's caching host allocator keeps each pinned block
        from reuse until the non_blocking copy that reads it has run, so a
        graph's static input can take the copy straight from here."""
        out = {k: torch.from_numpy(np.ascontiguousarray(a))
               for k, a in arrays.items()}
        if self.device.type == "cuda":
            out = {k: t.pin_memory() for k, t in out.items()}
        return out

    def _to_device(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host arrays → device tensors, for the eager paths."""
        return {k: t.to(self.device, non_blocking=True)
                for k, t in self._host(arrays).items()}

    def _note_dispatch(self, kind: str, n_steps: int = 0, blocks: int = 1,
                       **extra) -> None:
        """Account one device dispatch: rung histogram (decode-bearing
        kinds; a chained run counts once per block) + the optional
        dispatch trace."""
        if n_steps:
            self._rung_dispatches[n_steps] = (
                self._rung_dispatches.get(n_steps, 0) + blocks)
        if self.dispatch_trace is not None:
            self.dispatch_trace.append({
                "kind": kind, "n_steps": n_steps, "blocks": blocks,
                "pending": self.scheduler.prompts_pending(),
                "t": time.monotonic(), **extra})

    def _block_fn(self, kind: str, n: int, v: Variant) -> Callable:
        key = (kind, n, v)
        fn = self._block_fns.get(key)
        if fn is None:
            if kind == "spec":
                fn = blocks.make_spec_block(self.model, self.kv, v.greedy)
            else:
                make = (blocks.make_cc_block if kind == "cc"
                        else blocks.make_decode_block)
                fn = make(self.model, self.kv, n, self.cfg.hard_cap, v)
            self._block_fns[key] = fn
        return fn

    # -- prefill (eager) ----------------------------------------------------- #

    def _prefill_pass(self, items: List[PrefillItem]):
        """Run one prefill chunk per item eagerly and sample every row;
        returns (device tokens [B] (flat engines), host fetch of the
        packed result, with_top, the row layout)."""
        seqs = [it.seq for it in items]
        rows = self._prefill_rows(items)
        seq_rows = [it.seq if it else None for it in rows]
        S = max(it.chunk_len for it in items)
        # the ring splits the chunk into sp equal slots: pad to a multiple
        S = -(-S // self.sp) * self.sp
        toks = np.zeros((len(rows), S), np.int64)
        for i, it in enumerate(rows):
            if it is not None:
                toks[i, :it.chunk_len] = it.seq.prompt[
                    it.chunk_start:it.chunk_start + it.chunk_len]
        seeds, counters = self._seed_arrays(seq_rows)
        samp = self._samp_arrays(seq_rows)
        v = self._variant(seqs)
        v = Variant(with_top=v.with_top, greedy=v.greedy)
        host = {
            "tokens": toks, "table": self._table_array(seq_rows),
            "prefix": np.asarray([it.chunk_start if it else 0 for it in rows],
                                 np.int32),
            "chunk": np.asarray([it.chunk_len if it else 1 for it in rows],
                                np.int32)}
        samp_arrays = {"seeds": seeds, "ctr": counters, **samp}
        if self.dp * self.pp * self.sp > 1:
            # every replica samples its own rows, on its last stage
            host.update(samp_arrays)
        prefix_pages = 0
        if self.sp > 1:
            prefix_pages = self._sp_arrays(host, rows)
        # the tower runs here, on the leader, before the plan: what the
        # other ranks need of it rides the plan
        media.encode_pending(self, seqs)
        mm = media.chunk_media(self, rows, S)
        self._plan_prefill(host, v, mm, prefix_pages)
        d = self._to_device({**host, **samp_arrays})
        tok_d, packed = self._prefill_block(
            d, v, held=[it.seq for it in items
                        if it.samples and it.seq.hold_pages], mm=mm,
            prefix_pages=prefix_pages)
        return tok_d, HostFetch(packed), v.with_top, rows

    def _sp_arrays(self, host: Dict[str, np.ndarray], rows) -> int:
        """A ring prefill's extras (JAX `engine.py:2784-2806`, `:3410-
        3430`): on a partitioned pool the sp slot owning each row's pages
        (``owner``, into `host`); otherwise the table columns that cover
        the pass's longest cached prefix (0 when no row has one), which
        the ring folds first."""
        if self._pooled:
            if host["prefix"].any():
                # whole prompts with the prefix cache off: a scheduler
                # fault would corrupt the ring (JAX's guard)
                raise RuntimeError("sp prefill on a partitioned pool "
                                   "requires prefix_lens == 0")
            host["owner"] = np.asarray(
                [it.seq.kv_rank % self.sp if it else 0 for it in rows],
                np.int32)
            return 0
        longest = int(host["prefix"].max()) if len(rows) else 0
        return min(-(-longest // self.cfg.page_size), host["table"].shape[1])

    def _plan_prefill(self, host: Dict[str, np.ndarray], v: Variant,
                      mm: Optional[Dict[str, Any]],
                      prefix_pages: int = 0) -> None:
        """Send a prefill plan; a pass with media carries them (the rows'
        embeddings as bytes, masks, rope streams), its bytes and the
        send's host ms accounted in ``media_plan``."""
        if self._lockstep is None:
            return
        t0 = time.perf_counter()
        wire = None if mm is None else media.to_wire(mm)
        self._plan("prefill", arrays=host, media=wire,
                   variant=[v.penalized, v.with_top, v.greedy],
                   prefix_pages=prefix_pages)
        if wire is not None:
            mp = self.media_plan
            mp["chunks"] += 1
            mp["bytes"] += int(wire["embeds"].nbytes + wire["mask"].nbytes
                               + (wire["pos"].nbytes if "pos" in wire else 0))
            mp["ms"] += (time.perf_counter() - t0) * 1e3

    def _prefill_block(self, d: Dict[str, torch.Tensor], v: Variant,
                       held=(), mm=None, prefix_pages: int = 0):
        """Every rank's device half of a prefill pass: its replica's rows
        through the model (with their media, `media.block_extras` of the
        pass's `media.chunk_media`; under sp the ring prefill of its
        sequence slot, `parallel.sp_prefill`), the replicas' pools brought
        level, and the rows sampled where their results go (the leader;
        each replica's tensor rank 0 under dp, of its slot 0 under sp).
        Returns (tokens, packed) on the leader, (None, None) elsewhere."""
        blk = self._block(d)
        if self._staged:
            return self._prefill_stages(d, blk, v)
        if self.sp > 1:
            from ..parallel.sp_prefill import forward_prefill_sp

            logits = forward_prefill_sp(
                self.model, self.group, self.kv, blk["tokens"], blk["table"],
                blk["prefix"], blk["chunk"], owner=blk.get("owner"),
                prefix_pages=prefix_pages)
        else:
            extras = media.block_extras(self, mm,
                                        self._span(d["tokens"].shape[0]),
                                        blk["prefix"])
            logits = self.model.forward_prefill(
                self.kv, blk["tokens"], blk["table"], blk["prefix"],
                blk["chunk"], **extras)
        if self.device.type == "cuda":
            for seq in held:
                # the held prompt's KV is all written once this chunk is:
                # an event recorded here orders a reader in another
                # process after these writes and after nothing later
                seq.kv_ready = torch.cuda.Event(interprocess=True)
                seq.kv_ready.record()
        self._sync_replicas(d["table"], d["prefix"], d["chunk"])
        if self.group is not None and self.group.rank != 0 and (
                self.dp == 1 or self.group.tp_rank != 0
                or self.group.sp_rank != 0):
            return None, None
        tok, packed = blocks.sample_pack(logits, blk, blk["ctr"], v)
        joined = self._gather_results([packed], blocks.out_widths(v.with_top))
        return (tok, joined[0]) if joined is not None else (None, None)

    def _prefill_stages(self, d: Dict[str, torch.Tensor],
                        blk: Dict[str, torch.Tensor], v: Variant):
        """`_prefill_block` through the pipeline (`parallel.pipeline.
        forward_prefill_pp`): every stage writes its layers' KV, the
        replicas level a replicated pool stage by stage, and the last
        stage samples its replica's rows."""
        from ..parallel.pipeline import forward_prefill_pp

        logits = forward_prefill_pp(self.model, self.group, self.kv,
                                    blk["tokens"], blk["table"], blk["prefix"],
                                    blk["chunk"])
        self._sync_replicas(d["table"], d["prefix"], d["chunk"])
        tok = packed = None
        if logits is not None and (self.group is None
                                   or self.group.tp_rank == 0):
            tok, packed = blocks.sample_pack(logits, blk, blk["ctr"], v)
        widths = blocks.out_widths(v.with_top)
        joined = self._gather_results(
            [packed], widths, [(d["tokens"].shape[0] * sum(widths),)])
        if joined is None:
            return None, None
        return (tok if self.group is None else None), joined[0]

    def _consume_prefill(self, rows: List[Optional[PrefillItem]],
                         fetch: HostFetch, with_top: bool) -> None:
        out, logp, tids, tlps = blocks.unpack_out(fetch.numpy(), len(rows),
                                                  with_top)
        for i, it in enumerate(rows):
            if it is None:
                continue
            s = it.seq
            if s.status != "running":  # preempted after planning
                continue
            self.scheduler.commit_full_pages(s)
            if it.samples:
                self._append_token(s, int(out[i]), float(logp[i]),
                                   _tops_for(s, tids, tlps, i))

    def _run_prefill(self, items: List[PrefillItem]) -> None:
        items = [it for it in items if it.seq.status == "running"]
        if not items:
            return
        self._note_dispatch("prefill")
        tok_d, fetch, with_top, rows = self._prefill_pass(items)
        # the dispatch is committed: account the computed tokens NOW so a
        # fused decode chain plans from current positions
        for it in items:
            it.seq.num_computed += it.chunk_len
        fused = self._maybe_fuse_decode(items, tok_d, with_top)
        # frees are deferred while the fused chain is in flight: an EOS on
        # the prefill token must not hand pages back under its table
        deferred = [] if fused else None
        self.scheduler.deferred_free = deferred
        try:
            self._consume_prefill(rows, fetch, with_top)
            if fused:
                rows, fetches, v = fused
                self._consume_decode(fetches, rows, v.with_top)
        finally:
            self.scheduler.deferred_free = None
            if deferred:
                self.pool.free(deferred)

    def _maybe_fuse_decode(self, items, tok_d, with_top):
        """Dispatch the first decode chain straight off the prefill's
        device-side sampled tokens (copied device-to-device into the
        decode graph's token input), with no host fetch between.  Returns
        (rows, fetches, variant), or None when the batch is not
        eligible."""
        seqs = [it.seq for it in items]
        hard_cap = self.cfg.hard_cap
        if (
            not self.cfg.fuse_prefill_decode
            or self.world > 1  # followers replay from host arrays only
            or self.cfg.speculative_ngram_k > 0  # drafts need the fetched token
            or not all(it.samples for it in items)
            or any(s.status != "running" for s in seqs)
            or any(s.opts.penalized for s in seqs)  # counts need the token
            or any(s.opts.max_tokens <= 1 for s in seqs)
            or any(s.num_computed >= hard_cap for s in seqs)
        ):
            return None
        # same gating as _chain_ok block 0: nothing else needs the pump,
        # and no other running prompt waits behind the chain
        if self._pending_aborts or self._pending_ops or self.scheduler.waiting:
            return None
        if any(not s.prefill_done for s in self.scheduler.running
               if s not in seqs):
            return None
        if self._offloads_pending():
            return None
        T, allow_chain = self.scheduler.peek_decode_rung()
        if not all(self.scheduler.try_extend_pages(
                s, min(s.num_computed + T, hard_cap)) for s in seqs):
            return None
        self.scheduler.commit_decode_rung()
        chain_len = 1
        while (allow_chain and chain_len < max(1, self.cfg.decode_chain)
               and self._chain_ok(seqs, chain_len, T, hard_cap)):
            chain_len += 1
        self._note_dispatch("fused", T, blocks=chain_len)
        rows = self._decode_rows(seqs)
        v = Variant(False, with_top, self._is_greedy(seqs))
        d = self._decode_inputs(rows, v)
        d["tok"] = torch.cat([tok_d, tok_d.new_zeros(len(rows) - len(seqs))])
        d["ctr"][:len(seqs)] += 1  # past the prefill sample
        return rows, self._dispatch_decode(d, v, chain_len, T), v

    # -- decode blocks ------------------------------------------------------- #

    def _dispatch_decode(self, d: Dict[str, torch.Tensor], v: Variant,
                         chain_len: int, T: int) -> List[HostFetch]:
        """Issue `chain_len` decode blocks of T steps: block k+1 takes
        block k's device-side token, position, counter (and counts)
        carries.  Returns one host fetch per block (None on a follower).
        Under dp each rank runs its replica's rows, then the replicas
        level a replicated pool and send their results to the leader."""
        if self._lockstep is not None:
            self._plan("decode", arrays={k: t.numpy() for k, t in d.items()
                                         if k != "counts"},
                       counts=self._sparse_counts(d.get("counts")),
                       variant=[v.penalized, v.with_top, v.greedy],
                       chain_len=chain_len, n_steps=T)
        if self._staged:
            return self._decode_stages(d, v, chain_len, T)
        key = ("decode", T, v.greedy, v.penalized, v.with_top,
               d["table"].shape[1])
        fn = self._block_fn("decode", T, v)
        fetches, ups = [], self._block(d, by_part=True)
        meshed = self.dp * self.sp > 1
        for _ in range(chain_len):
            outs = self.graphs.run(key, fn, ups)
            fetches.append(outs["packed"] if meshed
                           else HostFetch(outs["packed"]))
            ups = {k: outs[k] for k in ("tok", "pos", "ctr", "counts")
                   if k in outs}
        if not meshed:
            return fetches
        self._sync_replicas(d["table"], d["pos"], chain_len * T)
        joined = self._gather_results(fetches, blocks.out_widths(v.with_top),
                                      by_part=True)
        return None if joined is None else [HostFetch(p) for p in joined]

    def _decode_stages(self, d: Dict[str, torch.Tensor], v: Variant,
                       chain_len: int, T: int) -> Optional[List[HostFetch]]:
        """`_dispatch_decode` through the pipeline: a chain of `chain_len`
        blocks of T steps is one ring of chain_len x T steps
        (`parallel.pipeline.forward_decode_pp`; a block's carries are its
        last step's, so the steps are the same), its packed results cut
        back into one fetch a block."""
        from ..parallel.pipeline import forward_decode_pp

        steps = chain_len * T
        blk = self._block({k: t.to(self.device, non_blocking=True)
                           for k, t in d.items()})
        packed = forward_decode_pp(self.model, self.group, self.kv, blk, steps,
                                   self.cfg.hard_cap, v, TOPLP)
        self._sync_replicas(d["table"], d["pos"], steps)
        widths = blocks.out_widths(v.with_top)
        joined = self._gather_results(
            [packed], widths, [(steps, d["tok"].shape[0] * sum(widths))])
        if joined is None:
            return None
        return [HostFetch(joined[0][k * T:(k + 1) * T])
                for k in range(chain_len)]

    def _decode_inputs(self, rows, v: Variant) -> Dict[str, torch.Tensor]:
        tokens, positions = self._decode_arrays(rows)
        seeds, counters = self._seed_arrays(rows)
        d = self._host({"tok": tokens, "pos": positions, "ctr": counters,
                        "table": self._table_array(rows), "seeds": seeds,
                        **self._samp_arrays(rows), **self._rope_inputs(rows)})
        if v.penalized:
            d["counts"] = self._counts_tensor(rows)
        return d

    def _chain_ok(self, seqs: List[Sequence], k: int, T: int, hard_cap: int) -> bool:
        """May decode block k be dispatched before block k-1's results are
        fetched?  Only when nothing else needs the pump, no running prompt
        waits for its prefill, at least one sequence can still use the
        block, and every page can grow without preemption (preempting
        would invalidate in-flight tables)."""
        if self._pending_aborts or self._pending_ops or self.scheduler.waiting:
            return False
        if any(not s.prefill_done for s in self.scheduler.running):
            return False
        if self._offloads_pending():
            return False
        if all(min(s.opts.max_tokens - len(s.output_tokens),
                   hard_cap - s.num_computed) <= k * T for s in seqs):
            return False
        return all(self.scheduler.try_extend_pages(
            s, min(s.num_computed + (k + 1) * T, hard_cap)) for s in seqs)

    def _run_decode(self, seqs: List[Sequence]) -> None:
        # a sequence the planner scheduled may have stopped since
        seqs = [s for s in seqs if s.status == "running"]
        if not seqs:
            return
        if self._spec_ok(seqs):
            return self._run_spec_decode(seqs)
        # block ladder: the scheduler picks this dispatch's block size
        T, allow_chain = self.scheduler.select_decode_rung()
        if allow_chain and self._cc_ok():
            return self._run_decode_continuous(seqs, T)
        hard_cap = self.cfg.hard_cap
        # the chain length is decided upfront and pages pre-reserved for
        # the whole horizon, so ONE page table serves every block
        chain_len = 1
        while (allow_chain and chain_len < max(1, self.cfg.decode_chain)
               and self._chain_ok(seqs, chain_len, T, hard_cap)):
            chain_len += 1
        self._note_dispatch("decode", T, blocks=chain_len)
        rows = self._decode_rows(seqs)
        v = self._variant(rows)
        fetches = self._dispatch_decode(self._decode_inputs(rows, v), v,
                                        chain_len, T)
        # page frees deferred until the whole chain drains: an in-flight
        # block must never see its table's pages reallocated
        deferred = [] if len(fetches) > 1 else None
        self.scheduler.deferred_free = deferred
        try:
            self._consume_decode(fetches, rows, v.with_top)
        finally:
            self.scheduler.deferred_free = None
            if deferred:
                self.pool.free(deferred)

    def _consume_decode(self, fetches: List[HostFetch], rows, with_top) -> None:
        """Fetch + account a decode chain's blocks.  Rows that cannot stop
        inside a block take one extend + one page commit + one delivery
        for the whole block instead of T per-token iterations."""
        B = len(rows)
        for fetch in fetches:
            out, logp, tids, tlps = blocks.unpack_out(fetch.numpy(), B, with_top)
            T = out.shape[0]
            for i, s in enumerate(rows):
                if s is None or s.status != "running":
                    continue
                if (s.opts.ignore_eos and not s.opts.stop_token_ids
                        and not s.opts.stop_sequences
                        and len(s.output_tokens) + T < s.opts.max_tokens
                        and s.total_len + T < self.cfg.max_model_len
                        and s.num_computed + T <= self.cfg.hard_cap):
                    first = not s.output_tokens
                    s.num_computed += T
                    s.output_tokens.extend(int(x) for x in out[:, i])
                    if first:
                        self._note_first_token(s)
                    self.scheduler.commit_full_pages(s)
                    self._deliver_block(s, out[:, i], logp[:, i], tids, tlps,
                                        i, with_top)
                    continue
                for t in range(T):
                    s.num_computed += 1
                    self.scheduler.commit_full_pages(s)
                    self._append_token(s, int(out[t, i]), float(logp[t, i]),
                                       _tops_for(s, tids, tlps, (t, i)))
                    if s.status != "running":
                        break  # stop hit mid-block; rest discarded

    def _run_mixed(self, plan: StepPlan) -> None:
        """One dispatch of the mixed plan: a bounded prefill chunk (eager),
        then a decode block of the rung the ladder picks (a graph).  Decode
        rows' pages were reserved preemptively at planning, prefill rows
        extended non-preemptively, so neither side invalidates the other."""
        items, dseqs = plan.prefill, plan.decode
        # a mixed plan means prompts are pending: the ladder picks the
        # shortest rung, and the next chunk rides the following dispatch
        T, _ = self.scheduler.select_decode_rung()
        self._note_dispatch("mixed", T)
        _, p_fetch, p_top, p_rows = self._prefill_pass(items)
        rows = self._decode_rows(dseqs)
        v = self._variant(rows)
        d_fetch = self._dispatch_decode(self._decode_inputs(rows, v), v, 1, T)
        for it in items:
            if it.seq.status == "running":
                it.seq.num_computed += it.chunk_len
        self._consume_prefill(p_rows, p_fetch, p_top)
        self._consume_decode(d_fetch, rows, v.with_top)

    # -- speculative decoding (n-gram draft + fused verify) ------------------ #

    def _spec_ok(self, seqs: List[Sequence]) -> bool:
        """May this decode batch take the draft-verify path?  Penalties
        need sequential count updates the fused verify cannot thread,
        top-logprobs rows want the full packed layout, and rows within
        k+1 tokens of the context cap would write drafts past their
        page-table horizon."""
        k = self.cfg.speculative_ngram_k
        # JAX runs no verify on a partition, nor under pp or sp
        # (`engine.py:3497`)
        if k <= 0 or self._pooled or self._staged or self.sp > 1:
            return False
        if any(s.opts.penalized or s.opts.top_logprobs > 0 for s in seqs):
            return False
        return all(s.num_computed + k + 1 <= self.cfg.hard_cap for s in seqs)

    def _run_spec_decode(self, seqs: List[Sequence]) -> None:
        """One draft-verify dispatch: host n-gram drafts feed the fused
        (k+1)-position verify; the accepted prefix plus the model's own
        sample at the first divergence come back in one fetch and go
        through the per-token stop path."""
        k = self.cfg.speculative_ngram_k
        self._note_dispatch("spec")
        rows = self._decode_rows(seqs)
        B = len(rows)
        tokens = np.zeros((B, k + 1), np.int64)
        positions = np.zeros((B,), np.int64)
        for i, s in enumerate(rows):
            if s is None:
                continue
            tokens[i, 0] = s.output_tokens[-1] if s.output_tokens else (
                s.prompt[-1] if s.prompt else 0)
            tokens[i, 1:] = blocks.ngram_draft(
                s.all_tokens(), k, self.cfg.speculative_min_match,
                self.cfg.speculative_max_match, self.cfg.speculative_history)
            positions[i] = s.num_computed
        seeds, counters = self._seed_arrays(rows)
        table = self._table_array(rows)
        greedy = self._is_greedy(rows)
        host = {"tokens": tokens, "pos": positions, "ctr": counters,
                "table": table, "seeds": seeds, **self._samp_arrays(rows),
                **self._rope_inputs(rows)}
        self._plan("spec", arrays=host, k=k, greedy=greedy)
        packed = self._spec_block(self._host(host), k, greedy)
        out, logp, n_acc = blocks.unpack_spec(HostFetch(packed).numpy(),
                                              B, k + 1)
        self._spec_dispatch_total += 1
        drafted = accepted = 0
        live = []
        for i, s in enumerate(rows):
            if s is None or s.status != "running":
                continue
            a = int(n_acc[i])
            drafted += k
            accepted += a
            s.spec_draft_tokens += k
            s.spec_accepted_tokens += a
            live.append((i, s, a))
        # totals published before any token is appended (a consumer woken
        # by the finishing token may read metrics() at once)
        self._spec_draft_total += drafted
        self._spec_accepted_total += accepted
        self._spec_window.append((drafted, accepted))
        for i, s, a in live:
            for t in range(a + 1):
                s.num_computed += 1
                self.scheduler.commit_full_pages(s)
                self._append_token(s, int(out[i, t]), float(logp[i, t]))
                if s.status != "running":
                    break  # stop inside the accepted run; rest discarded

    def _spec_block(self, d: Dict[str, torch.Tensor], k: int, greedy: bool):
        """Every rank's device half of a verify: its replica's rows, the
        replicas levelled (k + 1 positions a row), the packed results on
        the leader (None elsewhere)."""
        blk = self._block(d)
        key = ("spec", k, greedy, blk["table"].shape[1])
        outs = self.graphs.run(key, self._block_fn("spec", k,
                                                   Variant(greedy=greedy)), blk)
        self._sync_replicas(d["table"], d["pos"], k + 1)
        joined = self._gather_results([outs["packed"]], (k + 1, k + 1, 1))
        return None if joined is None else joined[0]

    # -- the device-resident decode loop (continuous chaining) --------------- #

    def _cc_ok(self) -> bool:
        """The continuous loop for a flat engine; a group keeps the
        chained paths (JAX's `_cc_ok` under a mesh; the loop is
        output-invisible)."""
        return self.cfg.decode_continuous and self.world == 1

    def _ensure_drain_pool(self) -> cf.ThreadPoolExecutor:
        if self._drain_pool is None:
            self._drain_pool = cf.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="torch-engine-drain")
        return self._drain_pool

    def _stop_arrays(self, rows: List[Optional[Sequence]]) -> np.ndarray:
        """Per-row device stop-token ids ([B, K] int64, -1-padded, K a pow2
        bucket): the row's stop_token_ids plus the engine eos set unless
        ignore_eos.  Multi-token stop SEQUENCES stay with the host, which
        detects them at consume and forces chain fall-out."""
        sets = []
        for s in rows:
            if s is None:
                sets.append([])
                continue
            ids = set(s.opts.stop_token_ids)
            if not s.opts.ignore_eos:
                ids.update(self.eos_token_ids)
            sets.append(sorted(ids))
        K = max(1, max((len(x) for x in sets), default=1))
        K = 1 << (K - 1).bit_length()
        out = np.full((len(rows), K), -1, np.int64)
        for i, ids in enumerate(sets):
            out[i, :len(ids)] = ids
        return out

    def _seq_budget(self, s: Sequence) -> int:
        """Tokens `s` may still emit before a LENGTH stop — the bound
        `check_stop` enforces (max_tokens, model window, page-table
        horizon); ONE definition shared by the device budget and the
        horizon pre-reservation.  A chunk row still mid-prompt emits only
        after its prompt completes, so the page-table term counts from
        prompt_len."""
        return max(0, min(
            s.opts.max_tokens - len(s.output_tokens),
            self.cfg.max_model_len - s.total_len,
            self.cfg.hard_cap - max(s.num_computed, s.prompt_len),
        ))

    def _budget_array(self, rows: List[Optional[Sequence]]) -> np.ndarray:
        out = np.zeros((len(rows),), np.int64)
        for i, s in enumerate(rows):
            if s is not None:
                out[i] = self._seq_budget(s)
        return out

    def _cc_reserve(self, seqs: List[Sequence], T: int,
                    inflight_blocks: int = 0) -> int:
        """Watermark page pre-reservation: grow every running row's pages
        up to `cc_horizon_blocks` blocks ahead WITHOUT preemption and
        without dipping into the admission watermark; returns how many
        more whole blocks the tables cover for every row.
        `inflight_blocks` counts dispatched-but-undrained blocks."""
        ps = self.cfg.page_size
        hard_cap = self.cfg.hard_cap
        horizon = self.cfg.cc_horizon_blocks
        allowance = horizon
        for s in seqs:
            if s.status != "running":
                continue
            remaining = (max(0, s.prompt_len - s.num_computed)
                         + self._seq_budget(s))
            target = min(s.num_computed + (inflight_blocks + horizon) * T,
                         s.num_computed + remaining, hard_cap)
            self.scheduler.try_extend_pages(s, target, keep_watermark=True)
            covered = (min(len(s.pages) * ps, hard_cap) - s.num_computed
                       - inflight_blocks * T)
            if remaining - inflight_blocks * T > covered:
                allowance = min(allowance, max(0, covered) // T)
        return allowance

    def _cc_fall_out(self, seqs: List[Sequence], splice: bool = False) -> Optional[str]:
        """The chain's fall-out signals (None = keep feeding the loop).
        With `splice` (chunked prefill in-chain) new adds and admissible
        waiting prompts are not fall-outs: `_cc_intake` splices them at
        the next block and falls out itself when it cannot."""
        if self._closed:
            return "shutdown"
        # a chain splices plain adds; imported adoptions and page
        # operations need the pump
        adds = [e for e in self._pending_adds if e[0] != "add" or not splice]
        if adds or self._pending_aborts or self._pending_ops:
            return "pending_work"
        if (not splice and self.scheduler.waiting
                and self.scheduler.admission_ready()):
            return "admit"
        if self.scheduler.preempt_ready():
            return "preempted"
        if any(s.status != "running" for s in seqs):
            return "stop"
        if self._offloads_pending():
            return "offload"
        for s in seqs:
            ctx = self._contexts.get(s.request_id)
            if ctx is not None and ctx.is_stopped() and not ctx.is_killed():
                return "cancel"
        return None

    def _fetch_packed_cc(self, fetch: HostFetch, B: int, with_top: bool):
        """Drain-thread half of the double buffer: wait for block k's host
        copy and unpack it while block k+1 runs.  Scheduler state is not
        touched here."""
        return blocks.unpack_out_cc(fetch.numpy(), B, with_top)

    def _cc_intake(self, rows: List[Optional[Sequence]], seqs: List[Sequence],
                   v: Variant) -> Tuple[List[int], Optional[str]]:
        """Admission intake for the running chain (step thread): move new
        adds into the scheduler, then splice every admissible waiting
        prompt into a free padding slot.  Returns (spliced slots, fall-out
        reason): "admit" when an admissible prompt cannot ride this chain
        (no free slot, or its sampling needs another variant)."""
        while self._pending_adds and self._pending_adds[0][0] == "add":
            self.scheduler.add(self._pending_adds.pop(0)[1])
        spliced: List[int] = []
        while self.scheduler.waiting and self.scheduler.admission_ready():
            head = self.scheduler.waiting[0]
            if head.parked or media.has_media(head):
                # a media prompt's embeddings exist only on the prefill
                # path: the chain falls out and the pump prefills it
                return spliced, "admit"
            so = head.opts
            if ((v.greedy and so.temperature > 0)
                    or (not v.penalized and so.penalized)
                    or (not v.with_top and so.top_logprobs > 0)):
                return spliced, "admit"
            try:
                slot = rows.index(None)
            except ValueError:
                return spliced, "admit"
            seq = self.scheduler.splice_admit()
            if seq is None:
                break
            rows[slot] = seq
            seqs.append(seq)
            spliced.append(slot)
        return spliced, None

    def _cc_plan_feed(self, rows: List[Optional[Sequence]], T: int,
                      needs_reset: set, fed_complete: set):
        """Plan this block's chunk-row feeds: every mid-prompt row gets up
        to T prompt tokens from the per-block `prefill_chunk_tokens`
        budget, clamped to its page coverage.  Fed tokens count into
        `num_computed` at dispatch, except the prompt-completing one,
        which the first emission's drain accounts (the split engine's
        prefill→decode handoff).  Rows in `needs_reset` carry their
        splice reset on their first fed block.  None on a quiet block."""
        ps = self.cfg.page_size
        hard_cap = self.cfg.hard_cap
        budget = int(self.cfg.prefill_chunk_tokens)
        B = len(rows)
        feed = None
        for i, s in enumerate(rows):
            if s is None or s.status != "running" or id(s) in fed_complete:
                continue
            left = s.prompt_len - s.num_computed
            if left <= 0 or budget <= 0:
                continue
            n = min(T, left, budget)
            self.scheduler.try_extend_pages(
                s, min(s.num_computed + T, hard_cap), keep_watermark=True)
            n = min(n, max(0, len(s.pages) * ps - s.num_computed))
            if n <= 0:
                continue
            if feed is None:
                feed = {"chunk_toks": np.zeros((B, T), np.int64),
                        "chunk_rem": np.zeros((B,), np.int64),
                        "chunk_samples": np.zeros((B,), bool),
                        "reset": np.zeros((B,), bool),
                        "init_pos": np.zeros((B,), np.int64),
                        "init_budget": np.zeros((B,), np.int64)}
            feed["chunk_toks"][i, :n] = s.prompt[s.num_computed:s.num_computed + n]
            feed["chunk_rem"][i] = n
            completing = n == left
            feed["chunk_samples"][i] = completing
            if i in needs_reset:
                feed["reset"][i] = True
                feed["init_pos"][i] = s.num_computed
                feed["init_budget"][i] = self._seq_budget(s)
                needs_reset.discard(i)
            budget -= n
            if completing:
                s.num_computed += n - 1
                fed_complete.add(id(s))
            else:
                s.num_computed += n
        return feed

    def _run_decode_continuous(self, seqs: List[Sequence], T: int) -> None:
        """The device-resident decode loop (docs/device_loop.md): an
        open-ended chain of blocks whose varying inputs (last token,
        positions, counters, active mask, budgets, penalty counts) stay on
        the device.  Per block the host only issues the next replay, hands
        the previous block to the drain thread and checks the fall-out
        signals; stops latch on the device; pages are pre-reserved
        `cc_horizon_blocks` ahead; the chain ends on a fall-out signal or
        when every row finishes."""
        rows = self._decode_rows(seqs)
        seqs = list(seqs)  # chain-local: splices append
        B = len(rows)
        v = self._variant(rows)
        budget = self._budget_array(rows)
        active = np.array([s is not None and budget[i] > 0
                           for i, s in enumerate(rows)])
        fn = self._block_fn("cc", T, v)
        drain = self._ensure_drain_pool()
        splice_on = self.cfg.prefill_chunk_tokens > 0
        allowance = max(1, self._cc_reserve(seqs, T))
        tokens, positions = self._decode_arrays(rows)
        seeds, counters = self._seed_arrays(rows)
        table = self._table_array(rows)
        cur = self._host({
            "tok": tokens, "pos": positions, "ctr": counters, "act": active,
            "budget": budget, "stops": self._stop_arrays(rows),
            "table": table, "seeds": seeds, **self._samp_arrays(rows),
            **self._rope_inputs(rows)})
        if v.penalized:
            cur["counts"] = self._counts_tensor(rows)
        # quiet-block chunk operands, made once and reused
        quiet = self._host({
            "chunk_toks": np.zeros((B, T), np.int64),
            "chunk_rem": np.zeros((B,), np.int64),
            "chunk_samples": np.zeros((B,), bool), "reset": np.zeros((B,), bool),
            "init_pos": np.zeros((B,), np.int64),
            "init_budget": np.zeros((B,), np.int64)})
        needs_reset: set = set()
        fed_complete: set = set()
        inflight: deque = deque()
        deferred: List[int] = []
        self.scheduler.deferred_free = deferred
        fallout = None
        self._cc_chains_total += 1
        try:
            while True:
                splice_fall = None
                spliced: List[int] = []
                if splice_on:
                    spliced, splice_fall = self._cc_intake(rows, seqs, v)
                    needs_reset.update(spliced)
                    if spliced:
                        # per-row operands now cover the new rows; their
                        # carried state is reset in-step by the overlay
                        cur.update(self._host({
                            "seeds": self._seed_arrays(rows)[0],
                            "stops": self._stop_arrays(rows),
                            **self._samp_arrays(rows),
                            **self._rope_inputs(rows)}))
                feed = (self._cc_plan_feed(rows, T, needs_reset, fed_complete)
                        if splice_on else None)
                chunk_rows = 0
                if feed is not None:
                    cur.update(self._host(feed))
                    chunk_rows = int((feed["chunk_rem"] > 0).sum())
                else:
                    cur.update(quiet)
                if spliced or feed is not None:
                    # splices and feeds may have grown page lists
                    table = self._table_array(rows)
                    cur.update(self._host({"table": table}))
                key = ("cc", T, v.greedy, v.penalized, v.with_top,
                       table.shape[1], cur["stops"].shape[1])
                outs = self.graphs.run(key, fn, cur)
                for k in ("tok", "pos", "ctr", "act", "budget", "counts"):
                    if k in outs:
                        cur[k] = outs[k]
                fetch = HostFetch(outs["packed"])
                allowance -= 1
                self._cc_blocks_total += 1
                self._note_dispatch("decode", T, blocks=1, continuous=True,
                                    chunk_rows=chunk_rows,
                                    spliced=len(spliced))
                # pair each drain with the rows it was dispatched against
                inflight.append((list(rows), drain.submit(
                    self._fetch_packed_cc, fetch, B, v.with_top)))
                # double buffer: with two blocks undrained, consume the
                # older one (its host copy overlapped this dispatch)
                while len(inflight) >= 2:
                    rows_snap, fut = inflight.popleft()
                    self._consume_cc_block(fut.result(), rows_snap, v.with_top)
                fallout = splice_fall or self._cc_fall_out(seqs, splice=splice_on)
                if fallout is not None:
                    break
                if allowance < 1:
                    # rolling horizon exhausted: re-reserve, push a table
                    allowance = self._cc_reserve(seqs, T,
                                                 inflight_blocks=len(inflight))
                    if allowance < 1:
                        fallout = ("admission" if self.scheduler.waiting
                                   else "pages")
                        break
                    table = self._table_array(rows)
                    cur.update(self._host({"table": table}))
        finally:
            err = None
            while inflight:
                rows_snap, fut = inflight.popleft()
                try:
                    self._consume_cc_block(fut.result(), rows_snap, v.with_top)
                except Exception as e:  # noqa: BLE001 — drain the window first
                    err = err or e
            self.scheduler.deferred_free = None
            if deferred:
                self.pool.free(deferred)
            reason = fallout or "error"
            self._cc_fallout_by_reason[reason] = (
                self._cc_fallout_by_reason.get(reason, 0) + 1)
            if err is not None:
                raise err

    def _consume_cc_block(self, fetched, rows: List[Optional[Sequence]],
                          with_top: bool) -> None:
        """Account one drained continuous block: the emitted flags say
        which tokens are real and where each row stopped, so rows without
        host-only stop sequences take one extend + one stop check + one
        delivery per block.  A stop found here was latched on the device
        in the same step, so the row's pages free at once."""
        out, logp, flags, tids, tlps = fetched  # [T, B] each
        for i, s in enumerate(rows):
            if s is None or s.status != "running":
                continue
            # a chunk row completing MID-block emits on the tail only:
            # index by the flags, never by an assumed prefix
            steps = np.nonzero(flags[:, i])[0]
            if steps.size == 0:
                continue
            if s.opts.stop_sequences:
                for t in steps:
                    s.num_computed += 1
                    self.scheduler.commit_full_pages(s)
                    self._append_token(s, int(out[t, i]), float(logp[t, i]),
                                       _tops_for(s, tids, tlps, (t, i)))
                    if s.status != "running":
                        break
                continue
            first = not s.output_tokens
            s.num_computed += int(steps.size)
            s.output_tokens.extend(int(x) for x in out[steps, i])
            if first:
                self._note_first_token(s)
            self.scheduler.commit_full_pages(s)
            reason = self.scheduler.check_stop(s, self.eos_token_ids)
            if reason:
                # device-latched stop: no later block writes these pages
                saved = self.scheduler.deferred_free
                self.scheduler.deferred_free = None
                try:
                    self.scheduler.finish(s, reason)
                finally:
                    self.scheduler.deferred_free = saved
            self._deliver_block(s, out[steps, i], logp[steps, i],
                                tids[steps] if tids is not None else None,
                                tlps[steps] if tlps is not None else None,
                                i, with_top, finish_reason=reason)

    def _offloads_pending(self) -> bool:
        """Queued offloads need the pump (their gather runs between
        steps): chains, fusion and the continuous loop yield to them."""
        return self.tiered is not None and self.tiered.pending_offloads > 0

    # -- KV off the device: export/import, park/resume, KVBM ----------------- #

    def _page_index(self, pages) -> torch.Tensor:
        return torch.as_tensor(np.asarray(pages, np.int64), device=self.device)

    def _export_dev(self, pages: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gather of page ids → fresh device tensors k, v [L, n, page, n_kv,
        hd] (exactly n pages: no padding width to bound recompiles).  Under
        tp every rank gathers its head slice and the slices join in rank
        order: the model's full kv heads (a ``kv_export`` plan).  Under pp
        the stages' layers then join in stage order over the pp group: the
        model's every layer.  Under dp the pages are read on one replica
        (the partition holding them, or replica 0 of a replicated pool)
        and reach the leader over its dp group (JAX
        `_build_export_fn_pooled`, `_build_export_fn_pp_pooled`); under sp
        on one (replica, slot), over the pool group."""
        src, local = self._partition(pages)
        src = src or 0
        self._plan("kv_export", arrays={"pages": np.asarray(local, np.int64)},
                   src=src)
        return self._export_replay(self._page_index(local), src)

    def _export_replay(self, idx: torch.Tensor, src: int = 0):
        """Every rank's device half of an export from partition `src` (a
        replica; a (replica, slot) under sp); the full-head pages on the
        leader (what the other ranks return is not used)."""
        g = self.group
        if self.world == 1:
            return self.kv.k.index_select(1, idx), self.kv.v.index_select(1, idx)
        from ..parallel.collectives import broadcast_bytes, gather_heads

        L, _, ps, h, hd = self.kv.k.shape
        full = (L * self.pp, len(idx), ps, h * self.tp, hd)
        k = v = None
        if g.part == src:
            k, v = self.kv.k.index_select(1, idx), self.kv.v.index_select(1, idx)
            if self.tp > 1:
                ranks = g.tp_ranks()
                k = gather_heads(k, g.tp_rank, ranks, g.dev_group)
                v = gather_heads(v, g.tp_rank, ranks, g.dev_group)
            if self.pp > 1 and g.tp_rank == 0:
                # every stage's layers, in stage order (JAX
                # `_build_export_fn_pp_pooled`'s all_gather over pp)
                ranks = g.pp_ranks()
                k = gather_heads(k, g.stage, ranks, g.pp_group, axis=0)
                v = gather_heads(v, g.stage, ranks, g.pp_group, axis=0)
        if src != 0 and g.tp_rank == 0 and g.stage == 0:
            # the owner's stage 0, tensor rank 0 sends the pages to the
            # leader
            if g.part != src:
                k = self.kv.k.new_empty(full)
                v = self.kv.v.new_empty(full)
            owner = g.part_rank(src)
            broadcast_bytes(k, owner, g.pool_group)
            broadcast_bytes(v, owner, g.pool_group)
        return k, v

    def _import_dev(self, pages: List[int], k: torch.Tensor,
                    v: torch.Tensor) -> None:
        """Scatter k, v [L, n, page, n_kv, hd] (host or device) into page ids
        IN PLACE: the captured graphs hold the pool's addresses, so the
        pool tensors are never replaced.  Under tp `k`, `v` hold every kv
        head: the leader broadcasts them and each rank scatters its own
        heads (a ``kv_import`` plan); under dp (and sp) they land on the
        pages' partition, or on every replica of a replicated pool."""
        dst, local = self._partition(pages)
        idx = self._page_index(local)
        k = k.to(self.device, non_blocking=True)
        v = v.to(self.device, non_blocking=True)
        if self.world == 1:
            self.kv.k.index_copy_(1, idx, k)
            self.kv.v.index_copy_(1, idx, v)
            return
        self._plan("kv_import", arrays={"pages": np.asarray(local, np.int64)},
                   lane="leader", shape=list(k.shape), dst=dst,
                   dtype=str(k.dtype).removeprefix("torch."))
        self._import_replay({"lane": "leader", "dst": dst},
                            {"pages": idx, "k": k.contiguous(),
                             "v": v.contiguous()})

    def _lands_here(self, dst: Optional[int]) -> bool:
        """Does an import into partition `dst` (None: every replica of a
        replicated pool) write this rank's pool?"""
        return self.group is None or dst is None or dst == self.group.part

    def _import_inputs(self, desc: Dict[str, Any]) -> Dict[str, Any]:
        """A follower's host half of a ``kv_import`` plan: the page ids
        and, for the leader's broadcast, the buffers it lands in; for the
        ipc lane, the mapped source pools of each window (so a follower
        that cannot map them answers not-ready before any collective)."""
        pages = desc["arrays"]["pages"]
        if desc["lane"] == "ipc" and not self._lands_here(desc.get("dst")):
            return {"pages": pages.tolist(), "lane": None, "windows": []}
        if desc["lane"] == "leader":
            from ..disagg.transfer import DTYPES

            return {"pages": self._page_index(pages), **{
                name: torch.empty(desc["shape"], dtype=DTYPES[desc["dtype"]],
                                  device=self.device) for name in ("k", "v")}}
        if desc["lane"] == "ipc":
            if self._ipc_lane is None:
                from ..disagg.device_transfer import IpcLane

                self._ipc_lane = IpcLane(self.device)
            return {"pages": pages.tolist(), "lane": self._ipc_lane,
                    "windows": self._ipc_windows(desc["entry"], self._ipc_lane)}
        raise ValueError(f"unknown kv_import lane {desc['lane']!r}")

    def _import_replay(self, desc: Dict[str, Any], d: Dict[str, Any]) -> None:
        """Every rank's device half of a group's ``kv_import``: the
        leader's full pages (every layer, every head) reach the
        destination replicas' stage 0, tensor rank 0 over the dp group
        (under sp: every (replica, slot)'s over the pool group; when the
        destination is not partition 0 alone), then every stage's
        tensor rank 0 over the pp group, then each stage's ranks over its
        tp group, and each rank scatters its own layers' own heads (JAX
        `_build_import_fn_pp_pooled`)."""
        if desc["lane"] == "ipc":
            return self._ipc_import_replay(desc, d)
        from ..parallel.collectives import broadcast_bytes

        g = self.group
        dst = desc.get("dst")
        L, _, _, h, _ = self.kv.k.shape
        for name, pool in (("k", self.kv.k), ("v", self.kv.v)):
            full = d[name]
            if (self.dp * self.sp > 1 and dst != 0 and g.tp_rank == 0
                    and g.stage == 0):
                broadcast_bytes(full, 0, g.pool_group)
            if not self._lands_here(dst):
                continue
            if self.pp > 1 and g.tp_rank == 0:
                broadcast_bytes(full, g.rank_of(g.replica, 0, 0), g.pp_group)
            if self.tp > 1:
                broadcast_bytes(full, g.tp_ranks()[0], g.dev_group)
            pool.index_copy_(1, d["pages"], full.narrow(0, g.stage * L, L)
                             .narrow(3, g.tp_rank * h, h))

    def rank_pages(self, pages) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each rank's own heads of `pages` as host tensors [L, n, page,
        n_kv / tp, hd], in global rank order: under a group a ``kv_read``
        plan, answered over the plan group like ``stats`` (a check of what
        every rank's pool holds that does not ride the device groups'
        gathers).  On a partitioned pool every rank reads the pages'
        LOCAL ids: the partition's replica holds them, the others hold
        other pages there."""
        _, local = self._partition(pages)
        own = self.local_pages(local)
        if self._lockstep is None:
            return [own]
        return self._lockstep.read_pages(local, own)

    def local_pages(self, pages) -> Tuple[torch.Tensor, torch.Tensor]:
        idx = self._page_index(pages)
        return (self.kv.k.index_select(1, idx).cpu(),
                self.kv.v.index_select(1, idx).cpu())

    # -- the CUDA IPC lane into a tp group: each rank reads its window ------ #

    def ipc_entries(self) -> List[Dict[str, Any]]:
        """Every rank's CUDA IPC entry for its K and V pools
        (`disagg.device_transfer.ipc_export`), in rank order: the source
        side of the ipc lane (a disagg prefill worker publishes them once;
        under tp the followers answer an ``ipc_export`` plan)."""
        from ..disagg.device_transfer import ipc_export

        own = ipc_export(self)
        if self._lockstep is None:
            return [own]
        return self._lockstep.ipc_entries(own)

    def _ipc_windows(self, entry: Dict[str, Any], lane) -> list:
        """(source k, source v, src_head, dst_head, heads) of each source
        rank this rank's heads overlap, their pools mapped into this
        process through `lane` (once per source lease)."""
        from ..disagg.device_transfer import rank_entries
        from ..ops.kv_transfer import head_windows

        ranks = rank_entries(entry)
        n_kv = self.model_cfg.num_key_value_heads
        rank = self.group.tp_rank if self.group is not None else 0
        out = []
        for s, src_head, dst_head, heads in head_windows(
                n_kv, len(ranks), self.tp, rank):
            if not lane.usable(ranks[s]):
                raise ValueError(f"source rank {s}'s pools are not on this "
                                 f"rank's card")
            k, v = lane.pools(ranks[s])
            out.append((k, v, src_head, dst_head, heads))
        return out

    def import_ipc(self, entry: Dict[str, Any], dest_pages: List[int],
                   prompt_len: int, lane) -> None:
        """Move a prompt held by a source group's pools (its ipc entry:
        every rank's pools, the prompt's pages and the source's event)
        into `dest_pages` of every destination rank's pool: each rank
        waits on the event and re-pages its own head window from each
        source rank it overlaps (one launch each), then the group
        all-reduces a flag, so every rank's reads are done when this
        returns.  Under dp the destination ranks are the replica of the
        pages' partition (the other replicas read nothing), or every
        replica of a replicated pool.  A flat engine reading a flat
        source is one whole-row launch.  The leader maps its own windows
        before it sends the plan, so a failure there reaches no
        follower."""
        dst, local = self._partition(dest_pages)
        d = {"pages": local, "lane": lane,
             "windows": (self._ipc_windows(entry, lane)
                         if self._lands_here(dst) else [])}
        desc = {"lane": "ipc", "entry": entry, "prompt_len": int(prompt_len),
                "dst": dst}
        self._plan("kv_import",
                   arrays={"pages": np.asarray(local, np.int64)}, **desc)
        self._ipc_import_replay(desc, d)

    def _ipc_import_replay(self, desc: Dict[str, Any], d: Dict[str, Any]) -> None:
        from ..ops.kv_transfer import kv_repage

        entry, pages = desc["entry"], d["pages"]
        stream = self._stream
        if d["windows"]:
            event = d["lane"].event(entry)
            if event is not None and stream is not None:
                event.wait(stream)
        for k, v, src_head, dst_head, heads in d["windows"]:
            kv_repage(k, v, self.kv.k, self.kv.v, entry["pages"], pages,
                      desc["prompt_len"], src_head=src_head,
                      dst_head=dst_head, heads=heads)
        if stream is not None:
            stream.synchronize()
        if self.world > 1:
            # every rank's reads are done (its stream synchronised) before
            # the leader returns and the source releases its pages
            import torch.distributed as dist

            dist.all_reduce(torch.ones(1))

    def _note_move(self, kind: str, pages: int, t0: float, **extra) -> None:
        if self.dispatch_trace is not None:
            self._note_dispatch(kind, pages=pages,
                                ms=(time.perf_counter() - t0) * 1e3, **extra)

    def _park_seq(self, seq: Sequence) -> bool:
        """Scheduler park hook: copy the victim's live KV pages —
        including the partial tail page — device→host byte-exact into the
        parking lot.  Byte-exact restore (not recompute) is what makes the
        preempt→park→resume round trip token-identical: the resumed decode
        sees the same KV bytes at the same positions, the same
        ``output_tokens[-1]`` input, and PRNG counters derived from
        ``len(output_tokens)``.  Returns False (victim keeps running) when
        the lot is at budget."""
        ps = self.cfg.page_size
        n_used = -(-seq.num_computed // ps)
        if n_used <= 0 or n_used > len(seq.pages):
            return False
        if not self.parking.can_park(n_used):
            return False
        t0 = time.perf_counter()
        # parking IS a synchronous device→host copy: the victim's pages
        # are freed the moment park_fn returns
        try:
            with torch.cuda.stream(self._stream):
                k, v = to_host(list(self._export_dev(seq.pages[:n_used])))
        except lockstep.FollowerError:
            # a follower refused the export before any collective: the
            # group is intact, and the victim keeps running
            logger.exception("park of %s refused by a tp follower",
                             seq.request_id)
            return False
        ok = self.parking.park(ParkedSeq(
            request_id=seq.request_id, k=k, v=v, n_pages=n_used,
            num_computed=seq.num_computed, kv_rank=seq.kv_rank,
            block_hashes=list(seq.block_hashes),
        ))
        if ok:
            self._note_move("park", n_used, t0)
        return ok

    def _resume_parked(self, seq: Sequence) -> None:
        """Scheduler resume hook (admission time): restore a parked
        sequence's KV into fresh pages — device prefix-cache hits first
        (full blocks committed at park time may still be cached), the
        rest imported from the lot's host bytes.  Full blocks re-commit to
        the prefix cache; the partial tail page stays uncommitted.  The
        import is waited for, so a failure raises here: the scheduler then
        errors the request (a silent recompute would break token
        identity)."""
        entry = self.parking.take(seq.request_id)
        if entry is None:
            raise KeyError(f"no parked KV for {seq.request_id}")
        t0 = time.perf_counter()
        full = len(entry.block_hashes)
        hit: List[int] = []
        if self.cfg.enable_prefix_caching and entry.block_hashes:
            hit = self.pool.lookup_on(seq.kv_rank, entry.block_hashes)
        rest = entry.n_pages - len(hit)
        try:
            fresh = (self.pool.allocate_on(seq.kv_rank, rest)
                     if rest else [])
        except NoPagesError:
            self.pool.free(hit)
            raise
        if fresh:
            try:
                with torch.cuda.stream(self._stream):
                    self._import_dev(fresh, entry.k[:, len(hit):],
                                     entry.v[:, len(hit):])
                    if self._stream is not None:
                        self._stream.synchronize()
            except Exception:
                self.pool.free(hit + fresh)
                raise
            if self.cfg.enable_prefix_caching:
                for off, page in enumerate(fresh):
                    idx = len(hit) + off
                    if idx >= full:
                        break  # partial tail page — never committed
                    parent = (entry.block_hashes[idx - 1] if idx > 0
                              else None)
                    self.pool.commit(page, entry.block_hashes[idx], parent)
        seq.pages = list(hit) + list(fresh)
        seq.committed_pages = full
        seq.num_computed = entry.num_computed
        seq.block_hashes = list(entry.block_hashes)
        self._note_move("resume", len(fresh), t0, cached=len(hit))

    def _unpark_seq(self, seq: Sequence) -> None:
        """Scheduler unpark hook: a parked request was aborted/shed —
        drop its lot entry."""
        self.parking.discard(seq.request_id)

    def attach_connector(self, connector) -> None:
        """Attach a KVBM connector (`kvbm.TieredKvCache` shape: on_event /
        pump_offloads / onboard).  The engine pumps its offload queue and
        routes admission-time cache misses through it."""
        self.tiered = connector
        self.add_event_sink(connector.on_event)

        # onboarding runs inside admission (the pump's planning, or a
        # splice on the step thread), between device steps; it leaves the
        # scheduler's watermark reserve untouched (onboarding must not
        # eat the pages `_admit_check` holds back for decode growth)
        def _onboard(hashes, rank=0):
            t0 = time.perf_counter()
            pages = connector.onboard(
                self, hashes, rank=rank,
                headroom=self.scheduler._watermark_pages() + 1,  # noqa: SLF001
            )
            if pages:
                self._note_move("onboard", len(pages), t0)
            return pages

        self.scheduler.onboard_fn = _onboard

    def export_cached_blocks_device(self, hashes):
        """Device half of the offload export (step thread between steps, or
        the planning loop; never the drain thread).  Returns chunks
        ``[(hashes, k_dev, v_dev)]`` WITHOUT copying to the host: the
        outputs are fresh device tensors, so the copy can run on the KVBM
        drain thread while later steps run.  Hashes no longer cached are
        skipped."""
        resolved, pages = [], []
        for h in hashes:
            page = self.pool.cached_page(h)
            if page is not None:
                resolved.append(h)
                pages.append(page)
        if not pages:
            return []
        if self._pooled:
            # cached blocks may sit on several partitions; an export reads
            # one: a chunk a partition (JAX's grouping)
            by_rank: Dict[int, List[tuple]] = {}
            for h, p in zip(resolved, pages):
                by_rank.setdefault(self.pool.rank_of(p), []).append((h, p))
            groups = list(by_rank.values())
        else:
            groups = [list(zip(resolved, pages))]
        chunks = []
        with torch.cuda.stream(self._stream):
            for items in groups:
                k, v = self._export_dev([p for _, p in items])
                chunks.append(([h for h, _ in items], k, v))
        return chunks

    def export_cached_blocks(self, hashes):
        """SYNC device→host export of committed blocks (pump/executor
        thread only — never concurrent with a step).  Returns
        (resolved_hashes, k, v) with k/v host tensors [L, n, page, n_kv,
        hd]; hashes no longer cached are skipped."""
        chunks = self.export_cached_blocks_device(hashes)
        if not chunks:
            return [], None, None
        out_h = [h for c in chunks for h in c[0]]
        with torch.cuda.stream(self._stream):
            k, v = to_host([torch.cat([c[1] for c in chunks], dim=1),
                            torch.cat([c[2] for c in chunks], dim=1)])
        return out_h, k, v

    def import_committed_blocks(self, blocks, rank: Optional[int] = None
                                ) -> List[int]:
        """Import (hash, parent_hash, k, v) blocks (k, v host tensors [L,
        page, n_kv, hd]) into freshly allocated pages, committed to the
        prefix cache (between device steps).  Returns the page ids."""
        if not blocks:
            return []
        pages = (self.pool.allocate(len(blocks)) if rank is None
                 else self.pool.allocate_on(rank, len(blocks)))
        self._import_blocks(pages, [b[2] for b in blocks],
                            [b[3] for b in blocks])
        for (h, parent, _, _), page in zip(blocks, pages):
            self.pool.commit(page, h, parent)
        return pages

    def _import_blocks(self, pages: List[int], ks: List[torch.Tensor],
                       vs: List[torch.Tensor]) -> None:
        """Import per-block host tensors [L, page, n_kv, hd] into `pages`
        through a block-major staging tensor on the device: one
        host→device copy per block plane, straight from the host tier's
        tensors, then one in-place scatter per plane."""
        with torch.cuda.stream(self._stream):
            kd = torch.empty((len(ks), *ks[0].shape), dtype=ks[0].dtype,
                             device=self.device)
            vd = torch.empty_like(kd)
            for i, (k, v) in enumerate(zip(ks, vs)):
                kd[i].copy_(k, non_blocking=True)
                vd[i].copy_(v, non_blocking=True)
            self._import_dev(pages, kd.transpose(0, 1), vd.transpose(0, 1))

    # -- embeddings --------------------------------------------------------- #

    async def embed(self, request: Dict[str, Any],
                    context: Optional[Context] = None) -> Dict[str, Any]:
        """Embedding request: {"embed_token_ids": [[...], ...]} ->
        {"embeddings": [[...], ...], "prompt_tokens": N}, as `JaxEngine.embed`
        answers it.  Each input is truncated where JAX truncates it (to
        ``bucket_for(longest, chunk_buckets + [max_model_len])`` tokens,
        the longest clipped to max_model_len).  The forward
        (`Llama.forward_embed`) runs as one device op between steps, never
        beside one, eagerly (no graph).  Padding differs from JAX's, which
        pads every row to that bucket: rows are sorted by length and cut
        into groups whose padded size (rows x the group's longest row)
        stays within `embed_token_budget` tokens, each group padded only
        to its longest row.  Padded positions are masked out of the
        attention and the mean, so a row's vector does not depend on its
        group (up to the last bits of a GEMM tiled by shape on the card)."""
        del context
        batches = request.get("embed_token_ids") or []
        if not batches:
            return {"error": "no inputs"}
        longest = min(max(len(t) for t in batches), self.cfg.max_model_len)
        S = bucket_for(longest, list(self.cfg.chunk_buckets)
                       + [self.cfg.max_model_len])
        rows = [list(t[:S]) for t in batches]
        vecs = await self._device_op(lambda: self._embed_rows(rows))
        return {"embeddings": [vecs[i].tolist() for i in range(len(rows))],
                "prompt_tokens": sum(len(r) for r in rows)}

    @property
    def embed_token_budget(self) -> int:
        """Padded tokens of one embed group: the larger of max_model_len
        (one whole input) and a full decode batch of prefill chunks
        (max_num_seqs x max_prefill_tokens), the activations a serving
        step of this engine is sized for."""
        return max(self.cfg.max_model_len,
                   self.cfg.max_num_seqs * self.cfg.max_prefill_tokens)

    def _embed_rows(self, rows: List[List[int]]) -> np.ndarray:
        """The device half of `embed` (on the step thread): f32 [B, h]."""
        order = sorted(range(len(rows)), key=lambda i: -len(rows[i]))
        out = np.zeros((len(rows), self.model_cfg.hidden_size), np.float32)
        budget = self.embed_token_budget
        i = 0
        while i < len(order):
            S = len(rows[order[i]])  # the group's longest row
            n = max(1, min(len(order) - i, budget // max(S, 1)))
            group = order[i:i + n]
            tokens = np.zeros((n, S), np.int64)
            lens = np.zeros((n,), np.int32)
            for r, j in enumerate(group):
                tokens[r, :len(rows[j])] = rows[j]
                lens[r] = len(rows[j])
            self._plan("embed", arrays={"tokens": tokens, "lens": lens})
            d = self._to_device({"tokens": tokens, "lens": lens})
            vec = self._embed_dev(d["tokens"], d["lens"])
            out[group] = vec.cpu().numpy()
            i += n
        return out

    def _embed_dev(self, tokens: torch.Tensor, lens: torch.Tensor):
        """`Llama.forward_embed` on this rank: through the stages under pp
        (`parallel.pipeline.forward_embed_pp`), the vectors then sent from
        the last stage to the leader; f32 [B, h] on the leader."""
        if not self._staged:
            return self.model.forward_embed(tokens, lens)
        from ..parallel.pipeline import forward_embed_pp

        vec = forward_embed_pp(self.model, self.group, tokens, lens)
        if self.group is None:
            return vec
        if self.group.tp_rank != 0:
            return None
        return self._from_last_stage(
            vec, (tokens.shape[0], self.model_cfg.hidden_size))

    # -- disaggregated serving: page ops, remote prefill, adoption ---------- #

    async def _device_op(self, op: Callable[[], Any]) -> Any:
        """Run `op` on the step thread between steps (under the step lock,
        on the engine's stream) and return its result: every page
        operation requested from outside the pump goes through here."""
        if self._closed:
            raise RuntimeError("engine shut down")
        self._ensure_pump()
        fut = self._loop.create_future()
        self._pending_ops.append((op, fut))
        self._wake.set()
        return await fut

    async def export_pages(self, pages: List[int]):
        """Copy pages device->host: (k, v) host tensors [L, n, page, n_kv,
        hd] (page-locked on CUDA)."""
        def op():
            return tuple(to_host(list(self._export_dev(pages))))

        return await self._device_op(op)

    async def alloc_pages(self, n: int) -> List[int]:
        return await self._device_op(lambda: self.pool.allocate(n))

    async def free_pages(self, pages: List[int]) -> None:
        await self._device_op(lambda: self.pool.free(pages))

    async def import_page_chunk(self, pages: List[int], k_chunk: torch.Tensor,
                                v_chunk: torch.Tensor) -> None:
        """Write KV pages [L, n, page, n_kv, hd] (host or device tensors)
        into the pool at the given page ids, in place."""
        await self._device_op(lambda: self._import_dev(pages, k_chunk, v_chunk))

    async def _release_held(self, held) -> None:
        """Free the pages a failed remote prefill held (`held`: the
        (pages, event) its last output carried, or None)."""
        if held is None or not held[0]:
            return
        try:
            await self.free_pages(held[0])
        except Exception:  # noqa: BLE001
            logger.exception("failed to release held pages")

    def cached_prefix_len(self, prompt: List[int]) -> int:
        """Tokens of this prompt already in the device prefix cache (no
        references taken): the disagg router's input."""
        if not self.cfg.enable_prefix_caching or not prompt:
            return 0
        ps = self.cfg.page_size
        hashes = compute_block_hash_for_seq(prompt, ps, self.cfg.block_hash_salt)
        if len(prompt) % ps == 0 and hashes:
            hashes = hashes[:-1]
        return self.pool.peek(hashes) * ps

    async def prefill_remote(self, request: Dict[str, Any],
                             context: Optional[Context] = None,
                             transfer_source=None) -> Dict[str, Any]:
        """Prefill only: compute the prompt, sample the first token and hand
        the KV pages over.  With `transfer_source` (`disagg.transfer.
        KvTransferSource`) the pages stay held under a transfer handle and
        the answer carries only its descriptor; without it the KV rides
        inline (the JAX package's fallback blob)."""
        from ..disagg.transfer import tensor_bytes

        request = dict(request)
        request["stop_conditions"] = {
            **(request.get("stop_conditions") or {}), "max_tokens": 1}
        request["_hold_pages"] = True
        context = context or Context()
        prompt_len = len(request["token_ids"])
        first_token = None
        held = None
        async for out in self.generate(request, context):
            held = out.get("_held", held)
            if out.get("finish_reason") == "error":
                await self._release_held(held)
                return {"error": out.get("error", "prefill failed")}
            if out.get("token_ids"):
                first_token = out["token_ids"][0]
        if held is None or first_token is None:
            await self._release_held(held)
            return {"error": "prefill produced no token"}
        pages, kv_ready = held
        if transfer_source is not None:
            tid = await transfer_source.register(pages, prompt_len, kv_ready)
            return {"token_ids": [first_token],
                    "kv_descriptor": transfer_source.descriptor(tid)}

        def export_op():
            k, v = to_host(list(self._export_dev(pages)))
            # release the held pages now that the copy is out
            self.pool.free(pages)
            return k, v

        k, v = await self._device_op(export_op)
        return {"token_ids": [first_token],
                "kv": {"k": tensor_bytes(k), "v": tensor_bytes(v),
                       "dtype": str(k.dtype).removeprefix("torch."),
                       "shape": list(k.shape), "prompt_len": prompt_len,
                       "page_size": self.cfg.page_size}}

    async def generate_with_kv(
        self, request: Dict[str, Any], first_token: int,
        kv_blob: Dict[str, Any], context: Optional[Context] = None,
    ) -> AsyncIterator[Dict[str, Any]]:
        """Decode side of the inline-blob fallback: import a whole KV blob,
        then continue decoding (the block-ID path is `generate_imported`
        fed by the data plane)."""
        from ..disagg.transfer import DTYPES

        context = context or Context()
        if kv_blob["page_size"] != self.cfg.page_size:
            yield {"token_ids": [], "finish_reason": "error",
                   "error": "kv import rejected: page_size mismatch on the "
                            "inline path (use the transfer service)"}
            return
        shape = kv_blob["shape"]
        dtype = DTYPES[kv_blob["dtype"]]
        k = torch.frombuffer(bytearray(kv_blob["k"]), dtype=dtype).reshape(shape)
        v = torch.frombuffer(bytearray(kv_blob["v"]), dtype=dtype).reshape(shape)

        def import_op():
            pages = self.pool.allocate(shape[1])
            self._import_dev(pages, k, v)
            return pages

        try:
            pages = await self._device_op(import_op)
        except NoPagesError as e:
            # the pool cannot take the prefix now: the caller prefills
            # locally (which queues normally)
            yield {"token_ids": [], "finish_reason": "error",
                   "error": f"kv import rejected: {e}"}
            return
        async for out in self.generate_imported(request, first_token, pages,
                                                context):
            yield out

    async def generate_imported(
        self, request: Dict[str, Any], first_token: int, pages: List[int],
        context: Optional[Context] = None,
    ) -> AsyncIterator[Dict[str, Any]]:
        """Adopt pages already written into the pool (by the data plane or
        the blob path) as a prompt computed elsewhere, and stream the
        continuation after its first token.  The sequence reaches the
        scheduler through `add_imported` (never `add`, which would prefill
        it again)."""
        context = context or Context()
        self._ensure_pump()
        opts = _opts_from_request(request)
        prompt = list(request["token_ids"])
        seq = Sequence(context.id, prompt, opts)
        seq.seed = opts.seed if opts.seed is not None else self._py_rng.getrandbits(31)
        seq.t_arrival = time.monotonic()
        seq.pages = list(pages)
        if self._pooled and pages:
            # adopted on the partition its pages were imported into
            seq.kv_rank = self.pool.rank_of(pages[0])
        seq.num_computed = len(prompt)
        seq.num_cached = len(prompt)
        seq.output_tokens = [first_token]
        queue: asyncio.Queue = asyncio.Queue()
        self._queues[context.id] = queue
        self._contexts[context.id] = context
        self._requests_total += 1
        # the remote first token counts toward stop conditions
        reason = self.scheduler.check_stop(seq, self.eos_token_ids)
        yield {"token_ids": [first_token], "finish_reason": reason}
        if reason:
            self._queues.pop(context.id, None)
            self._contexts.pop(context.id, None)
            await self.free_pages(seq.pages)
            seq.pages = []
            return
        self._pending_adds.append(("imported", seq))
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
                self._pending_aborts.add(context.id)
                self._wake.set()

    def _recover_after_error(self) -> None:
        """A failed step may have left the pool half-written: error out the
        running sequences, zero the pool IN PLACE (captured graphs hold
        its addresses), rebuild the page pool and re-prefill the
        waiting."""
        for seq in list(self.scheduler.running):
            seq.hold_pages = False  # held pages go with the pool
            self.scheduler.finish(seq, "error")
            self._deliver(seq, [], "error")
        self.scheduler.deferred_free = None
        if self._lockstep is not None:
            # the followers zero their pools too, and every rank opens a
            # fresh device group; a group that cannot recover is lost,
            # and every later dispatch fails at once
            try:
                self._lockstep.recover()
            except Exception as e:  # noqa: BLE001
                logger.exception("tp group recovery failed")
                self._lockstep.lost = self._lockstep.lost or f"recover: {e}"
        self.reset_kv()
        self.pool = self._make_pool()
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
        if seq.t_first_token is not None:
            return
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
        if seq.hold_pages and finish_reason:
            # a held prompt's last output hands `prefill_remote` its pages
            # and the event after their writes
            out["_held"] = (list(seq.pages), seq.kv_ready)
            seq.pages = []
        if error is not None:
            out["error"] = error
        if logprob is not None and seq.opts.logprobs:
            out["log_probs"] = [logprob]
        if tops is not None:
            out["top_logprobs"] = [tops]
        self._post(seq, queue, out)

    def _deliver_block(self, seq: Sequence, toks, logps, tids, tlps,
                       col: int, with_top: bool,
                       finish_reason: Optional[str] = None) -> None:
        """One queue item for a whole decode block (the block was appended
        without per-token stop checks: either none can hit, or the device
        mask already cut it and `finish_reason` rides the same delta)."""
        queue = self._queues.get(seq.request_id)
        if queue is None:
            return
        out: Dict[str, Any] = {"token_ids": [int(x) for x in toks],
                               "finish_reason": finish_reason}
        if seq.opts.logprobs:
            out["log_probs"] = [float(x) for x in logps]
        if with_top and seq.opts.top_logprobs and tids is not None:
            out["top_logprobs"] = [_tops_for(seq, tids, tlps, (t, col))
                                   for t in range(len(out["token_ids"]))]
        self._post(seq, queue, out)

    def _post(self, seq: Sequence, queue, out: Dict[str, Any]) -> None:
        if seq.spec_draft_tokens:
            # cumulative per-request speculative stats ride every delta
            out["spec"] = {"draft_tokens": seq.spec_draft_tokens,
                           "accepted_tokens": seq.spec_accepted_tokens}
        if seq.ttft_attr is not None:
            out["ttft"] = seq.ttft_attr
            seq.ttft_attr = None
        try:  # may run on the step thread: hop back to the loop
            self._loop.call_soon_threadsafe(queue.put_nowait, out)
        except RuntimeError:
            if not self._loop.is_closed():
                raise


def _call(fn: Callable[[], Any]) -> Any:
    return fn()


def _host_array(x) -> np.ndarray:
    """A plan's host array, from numpy, a number or a tensor anywhere."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _tops_for(seq: Sequence, tids, tlps, idx):
    """This row's requested top-k [[id, logprob], ...] out of the packed
    TOPLP-wide arrays (idx a row, or a (step, row) pair), or None."""
    k = seq.opts.top_logprobs
    if not k or tids is None:
        return None
    ids, lps = tids[idx], tlps[idx]
    return [[int(ids[j]), float(lps[j])] for j in range(min(k, len(ids)))]


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
