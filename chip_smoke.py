"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero before the
final line):

1. environment: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and the versions of the packages the port relies on
   (torch, numpy, jinja2; a missing one fails the run);
2. build: compiles the hand-written kernels from ``dynamo_tpu_torch/csrc``;
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the shapes of Llama-3.1-8B (32 q heads, 8 kv heads, head dim 128,
   page 16, bf16; ragged lengths, prefixes 0 and 48, windows, sinks,
   padding rows, a chunk and a prefix off the tile and page grid) plus f32
   and head-dim-64 cases, on inputs whose scores spread enough to make
   each softmax peaked; every output row must lie within a relative
   tolerance of its plain row.  With times of the kernel, the plain
   version and `scaled_dot_product_attention` over the gathered KV (the
   library yardstick, never used by the port), for the first slice's
   cases and for the serving shapes (decode: 8 padded rows of up to 2080
   tokens; prefill: a 512-token chunk after a 1536-token prefix, and the
   speculative verify's 5-token chunks on 8 rows, one of them padding;
   the embeddings' cache-free call: prefix 0, 8 ragged rows of 16-2048
   tokens padded to 2048, a one-slot pool, in bf16 and f32),
   and both kernels at gpt-oss-20b's heads (64 q / 8 kv of 64, window 128,
   sinks).  The MoE kernels (`csrc/grouped_gemm.cu`) against their
   plain per-expert loops at gpt-oss-20b's expert shapes (K = N = 2880, 32
   experts): the grouped GEMM on a decode step's 32 rows and a 512-token
   chunk's 2048 rows routed top-4 at random (timed, with
   `torch._grouped_mm` as the yardstick), empty groups, one group holding
   all 2048 rows, the decode rows with `b_down`, and the decode rows
   bit-identical inside a batch of ~64 more rows per expert (128-row tiles
   where the case has 64-row ones); at the router's shape (one group, N
   32: a partial column tile, K in slices), 8 and 512 rows (timed), and
   512 with its bias; the fused gate||up (`grouped_glu`) with gpt-oss's
   clamped GLU and biases at the decode and chunk shapes (timed against
   two `torch._grouped_mm` and the same epilogue in eager torch; the
   decode rows across tile variants bit-identical), with silu and no
   bias, and on one group of 2048 rows; both kernels off the tile grid
   (40 experts, K 200, N 40, split-K in slices of 3 and 1 K tiles).  The
   KV re-page of disaggregated serving (`csrc/kv_transfer.cu`) at the 8B's
   layout, bit for bit against its plain version over both whole pools:
   a 2049-token prompt from pages of 16 into pages of 16 and of 32 (timed,
   with the engine's `index_select` + `index_copy_` page move as the
   yardstick where the page sizes match), a 77-token prompt 16 -> 16 and
   an f32 -> bf16 cast of 333 tokens 16 -> 32.  Both attention kernels at
   Qwen2's head groups (not powers of two): 28 q / 4 kv heads of 128 (G 7:
   Qwen2.5-7B and the Qwen2.5-VL-7B text stack; decode ragged and serving
   rows, prefill of a 512-token chunk after a 1536-token prefix, all
   timed), 12 / 2 (G 6, timed), 14 / 2 of 64 (G 7, Qwen2.5-0.5B) and f32.
   The vision towers' segment attention (`csrc/vision_attention.cu`, f32
   in three TF32 passes) against its plain per-segment softmax at a
   Qwen2.5-VL-7B full layer over one 1288x728 image (4784 patches, 16
   heads of 80), a windowed layer over the same image (84 windows) and
   CLIP ViT-L/14-336 over 2 images of 577 tokens (16 heads of 64), each
   timed with `scaled_dot_product_attention` and the boolean block mask as
   the yardstick and bound by three TF32 passes (the f32 FMA bound of the
   first version kept beside it), the golden LLaVA tower's 2 heads of 16,
   and head dims 128 (32-key tiles) and 48 on short segments.  Phase 15's
   and 18's per-rank shapes, all timed: both attention kernels at
   Llama-3.1-8B tp 2 (16 q / 4 kv heads of 128), Llama-3-70B tp 4 (16 / 2,
   G 8), gpt-oss-20b tp 2 (32 / 4 of 64, window 128, the rank's sinks) and
   Qwen2.5-VL-7B tp 2 and tp 4 (14 / 2 and 7 / 1 of 128, G 7) on the
   serving decode rows and a 512-token chunk after a 1536-token prefix;
   the grouped GEMM (with b_down) and the fused gate||up at gpt-oss-20b's
   16 experts a rank, the other rank's rows riding its last group, on a
   decode step's and a chunk's rows.
   Then the seeded sampler's threefry bits on the card against the CPU's,
   and the sampler's time per step;
4. serving: `TorchEngine` at Llama-3.1-8B full width and depth (random bf16
   weights from a seed, sharpened so the output depends on the input)
   answers 5 concurrent `generate()` requests (prompts of 64-2048 tokens, a
   shared prefix that hits the prefix cache, greedy plus one seeded row);
   every kernel must have launched during it, and greedy requests repeated
   alone must return the same tokens (that repeat is traced with
   `torch.profiler` for the device time per kernel group and the idle
   share);
5. kernel path vs plain path at full width: one 512-token prompt through
   `forward_prefill` and 8 `forward_decode` steps, once on the kernels and
   once on the plain attention, same weights and same fed tokens; planted
   attention faults (zero attention, a decode that skips the newest token
   or the first page) must fail the same check;
6. golden: the head-dim-64 transformers checkpoint
   (``tests/fixtures/torch_golden_llama_hd64``) loaded through the port's
   loader onto the card in f32 and bf16, its paged prefill and decode
   steps run through both kernels, the logits held to transformers'
   (f32: the CPU test's 2e-4; bf16: a share of each step's logit spread)
   and the greedy continuation required equal (bf16: up to a near-tie);
7. http: the port's whole stack in this process (embedded control plane,
   worker over `TorchEngine` with phase 4's 8B weights cut to its first
   CUT_LAYERS layers, full width, model watcher,
   `HttpService` on a free port) with a seeded byte-level BPE tokenizer of
   exactly 128256 ids written to ``build/``; phase 4's five prompts as
   pre-tokenized /v1/completions requests: a concurrent unary wave, then
   each prompt alone as unary, as SSE and straight into `generate()`
   (each from the same prefix-cache state), then timed SSE waves from a
   client process, one an arm since PR 15: direct, in-process frontend,
   frontend process (its SSE coalescing off, one frame a token); two chat
   requests (greedy; seeded at temperature 0.8, repeated) run under
   `torch.profiler`.  SSE text must equal the unary text and the
   `generate()` tokens detokenized, the seeded chat must repeat,
   /v1/models, /health and /metrics must answer, and both attention
   kernels must appear in the trace.  Mean TTFT, ITL and decode tokens/s
   of each arm at the client and the frontend's SSE CPU per token are
   printed on a line of their own beside phase 4's numbers and the card;
8. device_loop: the engine's device loop at phase 4's width and weights
   (its first 8 layers since PR 13, LOOP_LAYERS (2) since PR 15), in four
   engines: (a) one-step blocks, (b) 8-step blocks with
   the ladder 1/2/4 and chains of 2, (c) as (b) with the continuous loop
   and chunk rows of up to 512 prompt tokens a block, (d) speculative
   decoding with 4 n-gram drafts.  Each serves phase 4's five prompts, a
   long greedy prompt of repeated n-grams, and a 64-token arrival sent
   once the five are done and a block of the long row is in flight (arm
   (c) splices it into the running chain): two warm-up passes, a
   measured pass (TTFT, ITL, tokens/s; launches counted through graph
   replays; no new capture allowed), a check that one block's replay is
   bit-equal to its uncaptured run, and a `torch.profiler` pass.  Greedy
   rows that ran the same arithmetic must equal arm (a)'s; a chunk-row or
   verified row may part from it only at a near-tie (its margin in logit
   std units, measured on the prefill path, within LOGIT_TOL).  Last, a
   2-layer model whose drafts are accepted (`spec_accepting`): the
   speculative engine's tokens and KV against the one-step engine's;
9. kv_tiers: KV off the device at phase 4's width and weights, on its
   first SHALLOW_LAYERS layers.
   (a) 128 pages (256 MiB) exported to host memory, imported into 128
   other pages and exported again: equal bytes, the pool's storage
   unchanged, and the GB/s each way of the engine's page-locked host
   blocks against ordinary memory behind a pinned staging buffer; (b) one
   decode slot, a batch victim (1224-token prompt, 64 tokens) parked for
   a 64-token interactive arrival and resumed, greedy (twice), seeded at
   0.8, greedy without a prefix cache (all 77 pages imported at resume)
   and in the continuous loop: the victim's tokens equal an uncontended
   run's, every park resumed, the lot empty, the continuous chain fallen
   out with reason ``preempted``; (c) a 256-page pool serving a
   2049-token prompt (128 full pages) cold with no tier, then with a
   2 GiB host tier and a disk tier under ``build/`` (cold, a device-cache
   hit, and onboarded from host after filler prompts evicted it), then
   with a 4-block host tier (onboarded from disk): equal tokens in every
   run, at least 127 blocks onboarded each time, every committed block
   offloaded, the onboarded blocks byte-equal to the offloaded ones.
   Park and resume ms with their pages, the TTFTs, and decode ITL with
   offload on and off go on a line of their own;
10. kv_router: the KV-aware router at phase 4's width and weights, on
   its first SHALLOW_LAYERS layers.
   Two `TorchEngine`s share the weights, each with its own 512-page pool
   (1 GiB of K+V), served by `serve_engine` (KV events, load metrics) on
   an embedded control plane; `python -m dynamo_tpu_torch.frontend
   --router-mode kv` in a process of its own routes, a second frontend
   process in round_robin is the contrast, and an observer `KvRouter` in
   this process reads the same event stream.  Pre-tokenized greedy SSE
   /v1/completions of 16 tokens: ROUTER_PREFIXES (2) 1024-token prefixes
   with a 64-token suffix, one at a time, cold; each again with a new
   suffix (each must go to the worker holding its prefix, whose
   prefix-cache counter rises by 1024, with the observer's decision at 64
   blocks of overlap); the same through the round-robin frontend.  Then the observer's block
   count per worker must equal its pool's cached hashes and fall to 0
   after `clear_kv_blocks`; last, worker A (which the router's tie-break
   never picks) gets a 2 GiB host tier and a `TierSummaryPublisher`,
   prefix 0 served straight into A, filler prompts evict it from A's
   device pool, and the returning prompt must go to A by tier overlap
   (at least 63 blocks), onboard at least 63 blocks and give round 2's
   tokens.  The whole phase runs twice: with the control plane embedded
   in this process (the main path), and in a process of its own
   (`python -m dynamo_tpu_torch.runtime`).  The TTFT of each round and
   arm (KV hits and misses against round-robin's) goes on a line of its
   own with the card;
11. breadth: model breadth at full width, with the 8B model freed first.
   (a) gpt-oss-20b at its catalog widths (h 2880, 64 q / 8 kv heads of
   64, 128-token windows on even layers, sinks, q/k/v/o biases, 32
   clamped-GLU experts top-4 behind a biased router, yarn rope), its
   first CUT_LAYERS of 24 layers, random bf16 weights from a seed,
   sharpened as phase 4's; (b) phase 5's
   check on it: one 512-token prompt and 8 decode steps on the kernels
   (attention, the grouped GEMM and the fused gate||up) against the plain
   versions routed to
   the kernel path's experts (router logits held like the logits; where
   the plain path's own routing would differ, each flip is reported with
   its margin), and planted faults (the window ignored, the sinks
   dropped, one token's top-1 expert swapped) that must fail the check,
   with a kernel-free witness beside it (the plain path against itself
   with another f32 order of the expert sums, at this sharpening and at
   q/k x1.5); (c)-(e) run at SHALLOW_LAYERS layers, full width:
   (c) `TorchEngine` on the first layers of (a)'s model serving four
   concurrent
   requests of 64-1536 prompt tokens (two behind a cached 512-token
   prefix, one seeded), 32 tokens each, with one-step and 8-step graph
   blocks: all three kernels launched, greedy requests alone equal to
   their batched run, the arms' greedy rows equal up to near-ties, TTFT,
   ITL, tokens/s and a traced breakdown with a "moe" group; (d) `python -m
   dynamo_tpu_torch.worker --model gpt-oss-20b --num-layers
   SHALLOW_LAYERS` behind the control plane and frontend processes
   answers chats over HTTP; (e) Llama-3.1-8B from phase 4's seed, drawn
   at SHALLOW_LAYERS layers,
   served with `quantization="int8"`: phase 4's prompts
   (greedy repeats alone equal), logits against the bf16 model within a
   factor of a noise twin's error, weight GB and ITL beside phase 4's;
   `matmul_any` at its eight int8 shapes against the f32 product of the
   dequantized weights, planted int8 faults failing that check;
12. disagg (run before 11, while phase 4's model is on the card):
   disaggregated prefill/decode at the 8B's full width, on its first
   SHALLOW_LAYERS layers (the worker processes of (b) draw the model at
   that depth).  (a) In
   this process, two `TorchEngine`s on phase 4's model, the prefill engine
   served by `serve_prefill_worker` on an embedded control plane and the
   decode engine behind `DisaggDecodeHandler`, with pages 16 -> 16 and
   16 -> 32: a 2048-token transfer by hand on the colocated lane (one
   `kv_repage` launch) and on the host lane, each destination page bit
   equal to the source's tokens with zeros past the prompt; then 1088-
   and 2048-token greedy prompts through the handler, every one on the
   colocated lane, equal to an aggregated engine's tokens up to a
   near-tie.  (b) The normal entry points as processes on the one card:
   the control plane, `python -m dynamo_tpu_torch.worker --disagg-role
   prefill` and `--disagg-role decode` (the 8B from `--seed`) and the
   frontend; pre-tokenized SSE /v1/completions, each from a cleared decode
   cache: a 64-token prompt (stays local), 1088- and 2048-token greedy
   prompts and a seeded 1088-token one, every remote prefill on the CUDA
   IPC lane (the decode worker's /metrics), no fallback, the prefill
   worker's pool released; then the prefill worker is killed and the
   greedy prompts resent: prefilled locally, counted as fallbacks, the
   same text.  TTFT remote against local, transfer ms and GB/s per lane
   and the `kv_repage` launches go on its lines;
13. vision (after 11, the card free): (a) the golden LLaVA checkpoint
   (``tests/fixtures/golden_llava``): its CLIP tower on the card through
   the segment kernel, its LLM (head dim 16, below the paged kernels') on
   the CPU, logits against transformers' at tests/test_golden.py's limits;
   then Qwen2.5-VL-7B-Instruct at full width (h 3584, 28 q / 4 kv heads
   of 128, M-RoPE [16, 24, 24]; the 32-layer 2.5 tower with 112-px
   windows), its LLM cut to CUT_LAYERS of its 28 layers (the tower
   whole), built as ``python -m dynamo_tpu_torch.worker --model
   qwen2.5-vl-7b --seed S --sharpen --num-layers CUT_LAYERS`` builds it (random weights,
   sharpened: embedding x50, q/k x1.5, the merger scaled to the token
   embeddings' RMS); (b) the whole tower on the kernel against its plain
   version on a 448x448 image (relative error), the first token's logits
   of the kernel path against the plain path within LOGIT_TOL std, and
   another image under the same text moving them beyond it; the tower's
   host-clock ms on a 1288x728 image, and one run of it under
   `torch.profiler`: device ms of the segment kernel, the GEMMs and the
   rest; (c) `TorchEngine` serving chats
   built by the port's preprocessor from PNG / APNG data URIs (the port's
   codec): text only, a 448x448 image (256 tokens), a 1288x728 image (1196
   tokens, crossing two 512-token chunk boundaries), two images, a 4-frame
   video (t 2), the first image again (a prefix hit of at least its run)
   and another image under the same text (no reuse, other tokens), in a
   one-step engine (the main path, its launches counted: both attention
   kernels and the segment kernel) and an 8-step one: greedy rows equal
   across engines up to near-ties (the margin at a flip on the plain
   prefill path), TTFT per request and decode tokens/s; (d) the control
   plane, an encode worker (``--disagg-role encode``, its LLM cut to one
   layer), a serving worker (``--encode-component encoder``, no tower,
   CUT_LAYERS layers)
   and the frontend as processes: a chat with a data: PNG over HTTP gives
   (c)'s text for the same chat served alone;
14. embeddings, data-parallel ranks and request migration (after 12, on
   phase 4's 8B at full width, its first CUT_LAYERS layers: (c)'s
   reference tokens are phase 7's at that depth).  (a) `TorchEngine.embed` on
   eight ragged inputs of 16-2048 tokens (one call of the prefill kernel
   at phase 3's embeddings shape), on the kernels and on the plain
   attention: every vector within EMBED_TOL of its plain-path vector,
   three planted faults (the final norm dropped, the mean over padded
   positions, a prefix page attended) beyond it; the prefill kernel
   launched and no plain attention run; a 128-token input alone and
   inside a 64-input batch within EMBED_TOL; the inputs apart by
   EMBED_APART limits; ms per request at 1x512, 8x512, 64x128 and 1x4096
   tokens and the peak memory of the last.  (b) The same engine behind the
   in-process stack: /v1/embeddings gives (a)'s vectors exactly, its
   usage, 404 for an unknown model, 400 for a card without
   ``embedding`` and for 65 inputs.  (c) A `DpRankEngine` of two 512-page
   engines sharing the weights (`serve_engine`: per-rank publishers, the
   card scaled by the ranks) and the worker's status server, behind a
   `python -m dynamo_tpu_torch.frontend --router-mode kv` process: phase
   10's two 1024-token prefixes rank-less (the ranks alternate), then
   each with a new suffix through the kv frontend (each on the rank that
   holds it, its prefix-cache counter up by 1024), phase 4's greedy
   prompts rank-less (alternating, phase 7's tokens up to a near-tie),
   three of them sent to both ranks at once with top logprobs (graph keys
   new to both ranks, captured while the other rank prefills, replays and
   captures: phase 7's tokens up to a near-tie, each new decode graph's
   recorded launches T x CUT_LAYERS layers, and the registry's launches equal to
   the replays', the new graphs' warm-up runs and CUT_LAYERS per eager prefill
   pass), /metrics equal to the
   ranks' sums, an embed for ``dp_rank`` 1 served there.  (d) The control plane, two `python -m dynamo_tpu_torch.worker`
   processes (the 8B from the same ``--seed``, CUT_LAYERS layers since
   PR 15) and a
   round-robin frontend: a greedy SSE request of 64 tokens on a 1024-token
   prompt, undisturbed, then again with its worker SIGKILLed after the
   8th token: all 64 tokens, the undisturbed text up to a near-tie,
   ``dynamo_frontend_migrations_total`` 1, the longest inter-token gap at
   the kill printed, and a later request served by the survivor.
15. tensor parallelism (`TorchEngine(parallel=ParallelConfig(tp=N))`,
   its ranks sharing the one card over gloo, eager).  (a) After 14, phase
   4's engine through ``ParallelConfig(tp=1)`` repeats phase 4's tokens
   bit for bit at full depth; then phase 4's 8B at full width cut to
   CUT_LAYERS layers: its flat twin (drawn from phase 4's seed at that
   depth) and a tp group of 2 (the same draw on each rank) serve phase
   4's five requests: greedy rows equal to the twin's up to near-ties,
   tokens/s and TTFT printed, and every rank launched the decode and
   prefill kernels; three planted faults, each in a copy of the port run
   as its own process on the 8B cut to TP_FAULT_LAYERS layers, fail
   (a)'s check: no all-reduce after ``w_down``, kv heads sharded in the
   wrong order, a follower that skips one dispatch.  (b) After 13,
   Llama-3-70B at its published widths cut to TP_70B_LAYERS layers: a
   flat engine, then a tp group of 4, on phase 4's traffic (rows equal up
   to near-ties); then one greedy request through the control plane and
   the frontend to each of ``python -m dynamo_tpu_torch.worker --tp 2``
   (the 8B at CUT_LAYERS) and ``--tp 4`` (the 70B), both workers built at
   once: each gives its flat engine's text up to a near-tie.  (c)
   gpt-oss-20b at its catalog width cut to SHALLOW_LAYERS layers on a tp
   group of 2 (16 experts a rank) on
   phase 11's requests, beside its flat twin's tokens; the gate: phase 11 (b)'s prompt with the twin's router
   choices forced on the ranks, logits within LOGIT_TOL std; every rank
   launched the attention and grouped kernels.
16. KV moves under tensor parallelism (after 15, on phase 4's 8B at full
   width cut to TPKV_LAYERS layers: a flat engine and a tp group of 2 in
   this process, the same weights).  (a) Each engine's cold tokens of
   phase 12's 1088- and 2048-token greedy prompts; phase 9's storm on one
   decode slot (a 1224-token batch victim parked for a 64-token arrival,
   then resumed): the victim's tokens equal its uncontended run's bit for
   bit on both; the tp group's export (``kv_export``: every rank's head
   slice joined) byte-equal to its ranks' pools laid side by side (read
   through the ``kv_read`` plan); then a host tier on each engine over
   one host pool: the flat engine writes the 1088-token prompt's blocks
   and the tp group onboards them, the tp group writes the 2048-token
   prompt's and the flat engine onboards them, each giving its cold
   tokens up to a near-tie, every block holding all 8 kv heads.  (b)
   Disaggregated serving across tp: three ``python -m
   dynamo_tpu_torch.worker --disagg-role prefill`` processes (tp 2, flat
   and tp 4, built while (a) runs) hand the two prompts to this
   process's flat engine or tp group behind a `DisaggDecodeHandler` over
   the CUDA IPC lane (tp 2 -> flat, flat -> tp 2, tp 4 -> tp 2): every
   transfer on the lane, every destination rank's pages equal to the
   source's head window byte for byte (read back through ``kv_read``,
   the source pools mapped here), tokens equal to the decode engine's
   cold run up to near-ties, each rank's windowed ``kv_repage``
   launches counted.  (c) The same byte check on a transfer made in
   process (`window_probe`: two tp 2 source pools under an injected
   opener into the flat engine); the mutation check runs it in a copy
   whose re-page reads one head off, where it must fail.
17. Meshed data parallelism (after 16, on the 8B at full width cut to
   CUT_LAYERS layers, random bf16 weights from the script's seed, the
   ranks sharing the card over gloo), each layout against phase 15
   (a)'s flat twin (the same weights and depth) on phase 4's five
   requests of 32 tokens.  (a) dp 2 x tp 1, the pool replicated: the
   five at once, greedy rows equal to the twin's up to near-ties, and
   both replicas' pools byte-equal on every page the wave used (read
   through ``kv_read``).  (b) dp 2 x tp 2, the pool partitioned
   (``kv_partition``, 160 pages a partition, two decode slots): the five
   sent one after another's first token, tokens as in (a), every
   sequence's pages on its partition (the small ones' KV on its
   replica's ranks only), the wave holding more pages at once than one
   partition has.  (c) On (b)'s group: a 1224-token batch victim beside
   a 2048-token interactive anchor (which holds partition 0) parked for
   a 64-token arrival on partition 1 and resumed there, bit-equal to the
   same run without the arrival; phase 12's 1088-token prompt's blocks
   onboarded from a host tier into the partition that admits it again,
   against its cold tokens; one remote prefill of the same prompt from
   a flat ``--disagg-role prefill`` worker process over the CUDA IPC
   lane, the imported pages byte-equal to the source's on the admitting
   replica's ranks only, its tokens the cold run's.  (d) ``python -m
   dynamo_tpu_torch.worker --dp 2 --tp 2 --kv-partition`` behind a
   frontend answers phase 4's A_64 over HTTP, its tokens the twin's up
   to a near-tie.  Each rank's launches of (a), (b) and (c) are read.
   ``python3 chip_smoke.py --dp-probe`` runs a small partitioned group
   against a flat engine alone: the mutation check runs it in a copy
   whose partitioned dispatch hands replica 1 replica 0's page table.
18. Vision under groups (right after 13, on its Qwen2.5-VL-7B: the LLM
   at CUT_LAYERS layers drawn by each rank from the same seed,
   sharpened, the whole tower on the leader alone: phase 13's tower
   object), each arm against phase 13 (c)'s one-step rows of the same
   requests (text, a 448x448 image, a 1288x728 image, two images, a
   4-frame video; VL_TOKENS greedy tokens each) up to near-ties judged by
   `vl_first_flip` on phase 13's model.  (a) A tp 2 group (ranks sharing
   the card over gloo): the five at once, each rank's launches, the
   prefill plan's media bytes and host ms a chunk (the masked runs'
   embeddings in bf16, the masks, the M-RoPE streams), the tower's ms on
   the leader.  (b) dp 2 x tp 1, the pool partitioned: the five sent one
   after another's first token, media rows on both partitions, each
   replica splicing only its own block's rows (the ranks' own records),
   no tower parameter on the follower; the first image again hits its
   run on the partition holding it, another image hits nothing.  (c)
   (a)'s group without its tower (``vision=(None, vcfg)``), fed the
   embeddings `disagg.encode.encode_media` computes in process, from a
   cleared cache: tokens identical to (a).  (d) ``python -m
   dynamo_tpu_torch.worker --tp 2`` serving Qwen2.5-VL-7B with its tower
   (spawned with phase 13's processes, on its control plane and frontend
   under its own model name): phase 13 (d)'s image chat streams its
   tokens, phase 13's solo row up to a near-tie.  ``python3
   chip_smoke.py --vl-probe`` runs (b) at VL_PROBE_LAYERS layers against
   a flat engine alone: the mutation check runs it in copies whose
   replica 1 splices replica 0's media rows, or whose plan drops the
   M-RoPE streams.
19. Pipeline parallelism (after 17, phase 4's 8B drawn again from its
   seed; the ranks sharing the card over gloo, eagerly; 4-step decode
   blocks, so each decode dispatch is a ring whose last stage hands
   tokens back to stage 0).  Every reference row comes from a flat
   engine's own decode path.  (a) Phase 4's engine serves a penalized
   and a top-logprobs (3) request; the same model through the pipeline
   path at one stage serves phase 4's wave, bit-equal to phase 4's rows;
   then phase 4's 8B at full width and all 32 layers on a pp 2 group (16
   layers a stage) serves all seven at once, against phase 4's rows and
   the flat engine's two up to near-ties (the penalized row's margin
   with its penalties); tokens/s and TTFT beside phase 4's and the one
   stage's, each stage's launches of both attention kernels, the
   handoffs' count and bytes per dispatch.
   (b) Llama-3-70B's published widths at PP_70B_LAYERS (4) layers on pp
   2 x tp 2 (4 ranks) against its flat twin's engine at that depth.  (c) dp 2 x
   pp 2, the pool partitioned (phase 17's 160 pages a partition), the 8B
   at CUT_LAYERS layers: phase 17 (b)'s wave against phase 15 (a)'s twin,
   phase 17 (c)'s parked victim and host-tier onboard, the onboarded
   pages (every layer, exported from the group) byte-equal to the flat
   twin's pages of the same prompt.  (d) ``python -m
   dynamo_tpu_torch.worker --pp 2 --tp 2`` (built while (a)-(c) run)
   behind a frontend answers phase 4's A_64 over HTTP, the twin's tokens
   up to a near-tie.  ``python3 chip_smoke.py --pp-probe`` runs (a) at
   PP_PROBE_LAYERS layers: the mutation check runs it in a copy whose
   ring hands stage 0 the previous step's token.
20. Sequence parallelism (after 19; the ranks share the card over gloo,
   eagerly; whole-remainder prefills as ring attention on the
   `ring_block` kernel, decode on the paged decode kernel).  (a) Phase
   4's 8B drawn again, full width and all 32 layers, on an sp 2 group
   against the flat engine on the same weights (its prefill chunked at
   512): prompts of 8192, 4096 and 1000 tokens (32 greedy tokens each)
   and a seeded 1000-token row; the 8192-token prompt alone first, its
   TTFT beside the flat engine's; the greedy rows up to near-ties; each
   rank's ring rotations (sends, bytes, host ms, per layer), sequence
   gathers, ring and decode launches; decode tokens/s; then a host tier
   onboards a 1088-token prompt's blocks into the group; then the logits
   through `forward_prefill_sp` itself (a 2047-token tail after a cached
   2048-token prefix, then 16 decode steps, on an sp 2 group of forked
   ranks) against the flat `forward_prefill`'s, within LOGIT_TOL std
   (the served rows' argmax cannot see a wrong ring).  The flat
   engine goes before (b).  (b) gpt-oss-20b's widths at SHALLOW_LAYERS
   layers on sp 2 x tp 2 (four ranks), the prefix cache on: a 2048-token
   prompt, then the same with a 512-token tail that hits it (the ring
   starts at the prefix boundary, the prefix folded from the pages); the
   served tokens reported beside the flat twin's, and the check with the
   flat run's router choices forced on four ranks (phase 15 (c)'s rule),
   logits within LOGIT_TOL std.  (c) dp 2 x sp 2, the pool partitioned
   over the four (replica, slot) pairs (160 pages each, no prefix cache,
   as JAX requires), the 8B at CUT_LAYERS layers: phase 4's requests
   against phase 15 (a)'s twin; a batch victim parked for an arrival and
   resumed onto its partition, the imported pages byte-equal to the
   parked bytes.  Every rank of (a)-(c) launches `ring_block` and the
   decode kernel; first, the ring as the engine runs it over 2 simulated
   slots against the plain prefill attention (`sp_ring_check`).  ``python3
   chip_smoke.py --sp-probe`` runs that check over 4 slots and (a), its
   logits check included, at SP_PROBE_LAYERS layers on sp 4: the mutation
   check runs it in copies whose
   ring hands a slot the wrong source's block, or whose kernel masks the
   diagonal.

On the card every decode block is a replayed CUDA graph (a group's
blocks run eagerly: gloo's collectives cannot be captured); the wrappers
count launches in Python, so the graph runner adds each graph's recorded
launches at every replay.  Every JSON line is also written to
``chip_smoke.jsonl`` in the output directory below, for the lines a
terminal's scrollback loses.  Launch counts are read per path (phases 4, 6
and 7, each arm of 8, 9, 10, 11, 12 and 13, 14 (a) and (c), 16 (a) and
each case of (b), 17 (a)-(c), 18 (a)-(b), 19 (a)-(c), 20 (a)-(c), each
zeroed just before it): the
kernel summary line's ``launches`` are those of the HTTP traffic, the
main path, for the attention kernels, of phase 11's one-step gpt-oss
serving for the grouped GEMM and the fused gate||up, of phase 12
(b)'s decode worker process (read from its /metrics.json before and
after the measured round) for the KV re-page, and of phase 13 (c)'s
one-step Qwen2.5-VL-7B engine, this slice's path, for the segment
attention, and of phase 20 (a)'s rank 0 for the ring kernel; the prefill entry adds its launches on phase 14 (a)'s
embeddings path, and ``launches_by_path`` each rank's of phases 15,
16, 17, 18, 19 and 20 (the followers' read from their own registries at
the group's stats plan).  After phases 17, 19 and 20 a ``children`` line
lists
the child processes still there.  Then the timing line (each phase's seconds, the helpers'
inside them, and the total: what each path costs of the 1200 s limit),
the kernel summary line, the card line, and as the last line
``{"ok": true, "device": {...}}``.  Long compiler output goes to
``chiprun_out/``.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import threading
import time

import torch

SEED = 20261016
ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
# H100 SXM published peaks (dense): bf16 tensor cores, f32 CUDA cores,
# TF32 tensor cores, HBM
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# Phase 3 inputs: K/V std 0.3 and q std 8 spread the scaled scores q.k/sqrt(hd)
# by about 2.4, so each row's softmax is peaked and the online rescale between
# tiles decides the result.  An output row (one query row, one head) passes
# when its largest error is within RTOL of its largest reference value: a few
# bf16 roundings of the output, where a zeroed row, a skipped tile or a
# missing rescale is wrong by about the row's own size.
Q_STD, KV_STD = 8.0, 0.3
RTOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# Phase 5: the kernel path's logits must lie within LOGIT_TOL standard
# deviations of the plain path's logits at every step, and each planted
# attention fault must lie outside it.  Its greedy token must be the plain
# path's, or a near-tie: a token the plain logits put within LOGIT_TOL of
# their best (a 128k-token vocabulary puts the top two ~0.2 std apart, the
# size of the bf16 differences between the paths).
LOGIT_TOL = 0.5


_JSONL = None  # every emitted line, also kept in OUT_DIR/chip_smoke.jsonl
# the kernels every Llama path launches, and those MoE models add
ATTENTION_KERNELS = ("decode_attention", "decode_merge", "prefill_attention")
MOE_KERNELS = ("moe_grouped_gemm", "moe_split_reduce", "moe_grouped_glu")


_T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:  # seconds since the script started
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 1)}
    line = json.dumps(obj)
    print(line, flush=True)
    if _JSONL is not None:
        _JSONL.write(line + "\n")
        _JSONL.flush()


# seconds of each phase of `main` (its top-level calls, summed when a
# call repeats) and of the helpers in `_CLOCKED` inside them: the
# "timing" line, printed before the kernel summary, tells a later slice
# what each path costs of the script's time limit
PHASE_SECONDS: dict = {}
DETAIL_SECONDS: dict = {}


def clocked(name, fn, *args, **kw):
    """fn(*args, **kw), its seconds added to PHASE_SECONDS[name]."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        PHASE_SECONDS[name] = (PHASE_SECONDS.get(name, 0.0)
                               + time.perf_counter() - t0)


def _clock_helper(name, fn):
    def run(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            s, n = DETAIL_SECONDS.get(name, (0.0, 0))
            DETAIL_SECONDS[name] = (s + time.perf_counter() - t0, n + 1)

    run.__name__ = fn.__name__
    run.__doc__ = fn.__doc__
    return run


def timing_line() -> dict:
    return {"phase": "timing",
            "seconds": {k: round(v, 1) for k, v in PHASE_SECONDS.items()},
            "detail": {k: {"s": round(s, 1), "calls": n}
                       for k, (s, n) in DETAIL_SECONDS.items()},
            "total_s": round(time.perf_counter() - _T0, 1)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------------- #

_FLUSH = None
# the sleep that holds the device while a timed run is queued (~0.2 s)
SLEEP_CYCLES = 400_000_000


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` calls, each after a 128 MB
    write that evicts the 50 MB L2 (a serving step finds its KV cold).
    The calls are queued behind a sleep kernel, so the device runs each
    call's launches back to back: the time is the device's, not the host
    Python that launches them (`host_paced_ms` keeps that).  Fails if the
    host had not queued every call before the first one started."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for a, b in ev:
        _FLUSH.zero_()
        a.record()
        fn()
        b.record()
    queued_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if queued_s * 1e3 >= start.elapsed_time(ev[0][0]):
        fail(f"timing: the host took {queued_s:.3f} s to queue the run, "
             "longer than the sleep that holds the device")
    return sum(a.elapsed_time(b) for a, b in ev) / iters


def host_paced_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """The first slice's timing: events around each call after the L2
    flush, the device free to idle while the host launches."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        _FLUSH.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #


def _table(rows_pages, maxp):
    """Distinct live pages per row from 1 up; unused entries → trash 0."""
    t = torch.zeros((len(rows_pages), maxp), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(rows_pages):
        t[b, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
        nxt += n
    return t, nxt


def _pool(gen, P, page, n_kv, hd, dtype):
    def one():
        return (torch.randn((P, page, n_kv, hd), generator=gen, device="cuda")
                * KV_STD).to(dtype)
    return one(), one()


def _errors(out, ref, dtype):
    """Largest absolute error, and largest error of an output row (the last
    axis) relative to that row's largest reference value."""
    d = (out.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1).clamp_min(1e-30)
    return {"max_abs_err": d.max().item(),
            "max_rel_err": (d / scale).max().item(), "rtol": RTOL[dtype]}


def sdpa_sink_column(k, v, mask, sink):
    """SDPA's inputs for the sink softmax the kernels compute: one more
    key/value column of zeros whose float mask is the head's sink logit
    (its score is then the sink, and its value adds nothing).  k, v [B, H,
    L, hd]; mask bool [B, 1, S, L]."""
    B, H, _, hd = k.shape
    S = mask.shape[2]
    zeros = k.new_zeros((B, H, 1, hd))
    fmask = torch.zeros((B, H, S, mask.shape[3]), dtype=k.dtype, device=k.device)
    fmask.masked_fill_(~mask.expand(B, H, S, mask.shape[3]), float("-inf"))
    col = sink.to(k.dtype)[None, :, None, None].expand(B, H, S, 1)
    return (torch.cat([k, zeros], 2), torch.cat([v, zeros], 2),
            torch.cat([fmask, col], 3))


def decode_case(name, gen, dtype, hd, H, n_kv, seq_lens, window=None,
                with_sink=False, page=16, timed=False):
    from dynamo_tpu_torch.ops import cuda_attention as ca
    from dynamo_tpu_torch.ops import paged_attention as pa

    B = len(seq_lens)
    maxp = max(1, -(-max(seq_lens) // page))
    table, P = _table([-(-s // page) for s in seq_lens], maxp)
    kp, vp = _pool(gen, P, page, n_kv, hd, dtype)
    table = table.cuda()
    lens = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    q = (torch.randn((B, H, hd), generator=gen, device="cuda") * Q_STD).to(dtype)
    sink = (torch.randn((H,), generator=gen, device="cuda")
            if with_sink else None)
    out = ca.decode_attention_cuda(q, kp, vp, table, lens, window, sink)
    ref = pa.decode_attention_plain(q, kp, vp, table, lens, window, sink)
    torch.cuda.synchronize()
    live = [b for b, s in enumerate(seq_lens) if s > 0]
    n_split = ca.decode_num_splits(maxp, page)
    res = {"case": name, "kernel": "decode_attention", "dtype": str(dtype),
           **_errors(out[live], ref[live], dtype),
           "finite": bool(torch.isfinite(out).all()),
           "n_split": n_split, "grid_blocks": n_kv * B * n_split}
    if with_sink or 0 in seq_lens:
        zero_rows = [b for b, s in enumerate(seq_lens) if s == 0]
        res["zero_rows_ok"] = all(bool((out[b] == 0).all()) for b in zero_rows)
    if timed:
        attended = [min(s, window) if window else s for s in seq_lens]
        esize = q.element_size()
        kv_bytes = sum(attended) * n_kv * hd * 2 * esize
        nbytes = kv_bytes + 2 * q.numel() * esize + table.numel() * 4 + B * 4
        flops = 4 * H * hd * sum(attended)
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
        # library yardstick: SDPA over the gathered, head-expanded KV
        k_g, v_g = pa.gather_kv(kp, vp, table)
        L = k_g.shape[1]
        g = H // n_kv
        k_l = k_g.permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
        v_l = v_g.permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
        pos = torch.arange(L, device="cuda")[None, :]
        mask = pos < lens[:, None].long()
        if window:
            mask &= pos >= lens[:, None].long() - window
        mask = mask[:, None, None, :]
        if sink is not None:
            k_l, v_l, mask = sdpa_sink_column(k_l, v_l, mask, sink)
        q_l = q[:, :, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = sdpa(q_l, k_l, v_l, attn_mask=mask)[:, :, 0]
        res.update({
            # the yardstick computes the same function
            "library_max_rel_err": _errors(lib[live], ref[live], dtype)["max_rel_err"],
            "ms": time_ms(lambda: ca.decode_attention_cuda(
                q, kp, vp, table, lens, window, sink)),
            "host_paced_ms": host_paced_ms(lambda: ca.decode_attention_cuda(
                q, kp, vp, table, lens, window, sink)),
            "plain_ms": time_ms(lambda: pa.decode_attention_plain(
                q, kp, vp, table, lens, window, sink), iters=3),
            "library_ms": time_ms(lambda: sdpa(q_l, k_l, v_l, attn_mask=mask)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
        })
    return res


def decode_width_case(gen, page=16):
    """The engine pads page tables to a width bucket and a CUDA graph fixes
    its bucket, so the same rows must decode to the same bits at table
    width W and at a padded 2W: the extra entries point at trash page 0
    and only add EMPTY splits to the merge."""
    from dynamo_tpu_torch.ops import cuda_attention as ca
    from dynamo_tpu_torch.ops import paged_attention as pa

    seq_lens, dtype = SERVING_DECODE, torch.bfloat16
    B = len(seq_lens)
    maxp = -(-max(seq_lens) // page)
    table, P = _table([-(-s // page) for s in seq_lens], maxp)
    kp, vp = _pool(gen, P, page, 8, 128, dtype)
    table = table.cuda()
    wide = torch.cat([table, torch.zeros_like(table)], dim=1)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    q = (torch.randn((B, 32, 128), generator=gen, device="cuda") * Q_STD).to(dtype)
    out = ca.decode_attention_cuda(q, kp, vp, table, lens)
    out2 = ca.decode_attention_cuda(q, kp, vp, wide, lens)
    ref = pa.decode_attention_plain(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    live = [b for b, s in enumerate(seq_lens) if s > 0]
    return {"case": "decode serving shape at width W and padded 2W",
            "kernel": "decode_attention", "dtype": str(dtype),
            **_errors(out[live], ref[live], dtype),
            "finite": bool(torch.isfinite(out).all()),
            "widths": [maxp, 2 * maxp],
            "n_split": [ca.decode_num_splits(maxp, page),
                        ca.decode_num_splits(2 * maxp, page)],
            "bit_identical": bool(torch.equal(out, out2))}


def prefill_case(name, gen, dtype, hd, H, n_kv, S, prefix, chunk, window=None,
                 with_sink=False, page=16, timed=False, trash_rows=(),
                 cache_free=False):
    """`trash_rows`: padding rows whose whole table points at trash page 0,
    as the engine pads a batch (the speculative verify's empty rows).
    `cache_free`: the embeddings' call (`Llama.forward_embed`): every
    prefix 0, a pool of one one-slot page and a one-column zero table."""
    from dynamo_tpu_torch.ops import cuda_attention as ca
    from dynamo_tpu_torch.ops import paged_attention as pa

    B = len(prefix)
    if cache_free:
        page, maxp = 1, 1
        table, P = torch.zeros((B, 1), dtype=torch.int32), 1
    else:
        maxp = max(1, -(-max(p + S for p in prefix) // page))
        table, P = _table([maxp] * B, maxp)
    table[list(trash_rows)] = 0
    kp, vp = _pool(gen, P, page, n_kv, hd, dtype)
    table = table.cuda()
    pre = torch.tensor(prefix, dtype=torch.int32, device="cuda")
    cl = torch.tensor(chunk, dtype=torch.int32, device="cuda")

    def rnd(*shape, s):
        return (torch.randn(shape, generator=gen, device="cuda") * s).to(dtype)

    q = rnd(B, S, H, hd, s=Q_STD)
    kn, vn = rnd(B, S, n_kv, hd, s=KV_STD), rnd(B, S, n_kv, hd, s=KV_STD)
    sink = (torch.randn((H,), generator=gen, device="cuda")
            if with_sink else None)
    out = ca.prefill_attention_cuda(q, kn, vn, kp, vp, table, pre, cl,
                                    window, sink)
    ref = pa.prefill_attention_plain(q, kn, vn, kp, vp, table, pre, cl,
                                     window, sink)
    torch.cuda.synchronize()
    live = [(b, c) for b, c in enumerate(chunk) if c > 0]  # rows below chunk_len
    res = {"case": name, "kernel": "prefill_attention", "dtype": str(dtype),
           **_errors(torch.cat([out[b, :c] for b, c in live]),
                     torch.cat([ref[b, :c] for b, c in live]), dtype),
           "finite": bool(torch.isfinite(out).all()),
           "padded_rows_zero": all(bool((out[b, c:] == 0).all())
                                   for b, c in enumerate(chunk))}
    if timed:
        esize = q.element_size()
        keys = 0  # (query row, key) pairs these inputs attend
        for b in range(B):
            for i in range(chunk[b]):
                lo_pre = max(0, prefix[b] + i - window + 1) if window else 0
                lo_new = max(0, i - window + 1) if window else 0
                keys += (prefix[b] - min(lo_pre, prefix[b])) + (i + 1 - lo_new)
        nbytes = ((2 * q.numel() + kn.numel() + vn.numel()) * esize
                  + sum(prefix) * n_kv * hd * 2 * esize
                  + table.numel() * 4 + 2 * B * 4)
        flops = 4 * hd * H * keys
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
        # library yardstick: SDPA over [gathered prefix | chunk] KV
        k_g, v_g = pa.gather_kv(kp, vp, table)
        Lp = k_g.shape[1]
        g = H // n_kv
        k_all = torch.cat([k_g, kn], 1).permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
        v_all = torch.cat([v_g, vn], 1).permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
        i = torch.arange(S, device="cuda")[None, :, None]
        p = torch.arange(Lp, device="cuda")[None, None, :]
        j = torch.arange(S, device="cuda")[None, None, :]
        m_pre = p < pre.long()[:, None, None]
        m_new = (j <= i) & (j < cl.long()[:, None, None])
        if window:
            m_pre = m_pre & (p > pre.long()[:, None, None] + i - window)
            m_new = m_new & (j > i - window)
        mask = torch.cat([m_pre.expand(B, S, Lp), m_new.expand(B, S, S)], -1)
        mask = mask[:, None]
        if sink is not None:
            k_all, v_all, mask = sdpa_sink_column(k_all, v_all, mask, sink)
        q_l = q.permute(0, 2, 1, 3).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = sdpa(q_l, k_all, v_all, attn_mask=mask).permute(0, 2, 1, 3)
        res.update({
            # the yardstick computes the same function
            "library_max_rel_err": _errors(
                torch.cat([lib[b, :c] for b, c in live]),
                torch.cat([ref[b, :c] for b, c in live]), dtype)["max_rel_err"],
            "ms": time_ms(lambda: ca.prefill_attention_cuda(
                q, kn, vn, kp, vp, table, pre, cl, window, sink)),
            "host_paced_ms": host_paced_ms(lambda: ca.prefill_attention_cuda(
                q, kn, vn, kp, vp, table, pre, cl, window, sink)),
            "plain_ms": time_ms(lambda: pa.prefill_attention_plain(
                q, kn, vn, kp, vp, table, pre, cl, window, sink), iters=3),
            "library_ms": time_ms(lambda: sdpa(q_l, k_all, v_all, attn_mask=mask)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
        })
    return res


# the main path's shapes: a decode step of the serving run (8 padded rows,
# three of them empty) and a prefill chunk after a cached prefix
SERVING_DECODE = [96, 1256, 2080, 1556, 332, 0, 0, 0]
SERVING_PREFILL = dict(S=512, prefix=[1536], chunk=[512])
# the speculative verify of phase 8 (k 4): S = k+1 on every row of a batch
# padded to max_num_seqs, the padding row's table all trash
SERVING_VERIFY = dict(S=5, prefix=[96, 1256, 2080, 1556, 332, 300, 64, 0],
                      chunk=[5] * 8, trash_rows=(7,))


# the embeddings' prefill (phase 14 (a)): eight ragged inputs of 16-2048
# tokens in one call, prefix 0, padded to the longest
EMBED_LENS = [2048, 1999, 1536, 1024, 777, 512, 128, 16]


# Qwen2's head groups: Qwen2.5-7B and the Qwen2.5-VL-7B
# text stack have 28 q / 4 kv heads of 128 (G 7), Qwen2-VL-2B 12 / 2 (G 6),
# Qwen2.5-0.5B 14 / 2 of 64 (G 7)
QWEN_G7 = dict(hd=128, H=28, n_kv=4)
QWEN_G6 = dict(hd=128, H=12, n_kv=2)

# The vision towers' segment attention (f32, `csrc/vision_attention.cu`):
# q std 2 over k, v std 1 spreads each head's scores by 2, so every softmax
# is peaked and the online rescale between key tiles decides the result.
# One TF32 pass a product would miss RTOL[float32] by ~20x here
# (tests/test_torch_segment_tf32.py); the kernel's three must hold it.
SEG_Q_STD = 2.0


def segment_layouts():
    """cu_seqlens of the main path's shapes: a Qwen2.5-VL-7B full layer and
    windowed layer over one 1288x728 image (grid 1 x 52 x 92: 4784
    patches), and CLIP ViT-L/14-336 over 2 images of 577 tokens."""
    from dynamo_tpu_torch.models import qwen_vl as tq

    vcfg = tq.vision_config("qwen2.5-vl-7b")
    _, cu_frames, cu_win = tq.stream_layout((1, 52, 92), vcfg)
    return {"full": cu_frames, "window": cu_win, "clip": [0, 577, 1154]}


def segment_case(name, gen, cu, nh, hd, timed=False):
    from dynamo_tpu_torch.ops import vision_attention as va

    L = cu[-1]
    q = torch.randn((L, nh, hd), generator=gen, device="cuda") * SEG_Q_STD
    k = torch.randn((L, nh, hd), generator=gen, device="cuda")
    v = torch.randn((L, nh, hd), generator=gen, device="cuda")
    out = va.segment_attention_cuda(q, k, v, cu)
    ref = va.segment_attention_plain(q, k, v, cu)
    torch.cuda.synchronize()
    res = {"case": name, "kernel": "segment_attention", "dtype": str(torch.float32),
           **_errors(out, ref, torch.float32),
           "finite": bool(torch.isfinite(out).all()),
           "tokens": L, "segments": len(cu) - 1}
    if timed:
        lens = [b - a for a, b in zip(cu[:-1], cu[1:])]
        flops = sum(4 * n * n * hd * nh for n in lens)
        nbytes = 4 * q.numel() * 4  # q, k, v read once, out written once
        # the kernel's products: three TF32 passes each on the tensor
        # cores; the f32 FMA bound of the CUDA-core first version beside it
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 3 * flops / PEAK_TF32 * 1e3
        # library yardstick: one SDPA call over the stream with the
        # boolean block mask of the segments
        seg = torch.repeat_interleave(torch.arange(len(lens), device="cuda"),
                                      torch.tensor(lens, device="cuda"))
        mask = (seg[:, None] == seg[None, :])[None, None]
        q_l, k_l, v_l = (t.permute(1, 0, 2)[None] for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = sdpa(q_l, k_l, v_l, attn_mask=mask)[0].permute(1, 0, 2)
        res.update({
            "library_max_rel_err": _errors(lib, ref, torch.float32)["max_rel_err"],
            "ms": time_ms(lambda: va.segment_attention_cuda(q, k, v, cu)),
            "host_paced_ms": host_paced_ms(
                lambda: va.segment_attention_cuda(q, k, v, cu)),
            # host-paced: the windowed layout's ~1000 launches a call
            # outrun the launch queue behind the sleep
            "plain_ms": host_paced_ms(
                lambda: va.segment_attention_plain(q, k, v, cu), iters=3),
            "library_ms": time_ms(lambda: sdpa(q_l, k_l, v_l, attn_mask=mask)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations (3xTF32)",
            "f32_bound_ms": max(t_bytes, flops / PEAK_F32 * 1e3),
            "bytes": nbytes, "flops": flops,
        })
    return res


def group_and_segment_cases(gen):
    """Phase 3's vision-slice cases: both attention kernels at Qwen2's head
    groups, and the segment kernel at the towers' shapes."""
    bf, f32 = torch.bfloat16, torch.float32
    sp = SERVING_PREFILL
    g7, g6 = QWEN_G7, QWEN_G6
    lay = segment_layouts()
    return [
        decode_case("decode qwen2.5-7b: 28 q / 4 kv (G 7), ragged", gen, bf,
                    g7["hd"], g7["H"], g7["n_kv"], [1, 17, 1000, 4095], timed=True),
        decode_case("decode qwen2.5-7b: 28 q / 4 kv (G 7), serving rows", gen, bf,
                    g7["hd"], g7["H"], g7["n_kv"], SERVING_DECODE, timed=True),
        decode_case("decode G 6: 12 q / 2 kv, serving rows", gen, bf,
                    g6["hd"], g6["H"], g6["n_kv"], SERVING_DECODE, timed=True),
        decode_case("decode f32 hd64 G 7 (qwen2.5-0.5b) + sinks", gen, f32, 64, 14, 2,
                    [0, 17, 1000, 333], with_sink=True),
        prefill_case("prefill qwen2.5-7b: 28 q / 4 kv (G 7), chunk 512 after 1536",
                     gen, bf, g7["hd"], g7["H"], g7["n_kv"], sp["S"], sp["prefix"],
                     sp["chunk"], timed=True),
        prefill_case("prefill G 6: 12 q / 2 kv, chunk 512 after 1536", gen, bf,
                     g6["hd"], g6["H"], g6["n_kv"], sp["S"], sp["prefix"],
                     sp["chunk"], timed=True),
        prefill_case("prefill bf16 hd64 G 7 (qwen2.5-0.5b): chunk 333 / prefixes 37, 0",
                     gen, bf, 64, 14, 2, 333, [37, 0], [333, 190], window=100),
        prefill_case("prefill f32 hd128 G 7: chunk 77 / prefix 40", gen, f32,
                     g7["hd"], g7["H"], g7["n_kv"], 77, [40], [77]),
        segment_case("segment qwen2.5-vl-7b full layer: 4784 patches, 16 heads of 80",
                     gen, lay["full"], 16, 80, timed=True),
        segment_case(f"segment qwen2.5-vl-7b windowed layer: 4784 patches in "
                     f"{len(lay['window']) - 1} windows, 16 heads of 80", gen,
                     lay["window"], 16, 80, timed=True),
        segment_case("segment clip vit-l/14-336: 2 images x 577 tokens, 16 heads of 64",
                     gen, lay["clip"], 16, 64, timed=True),
        segment_case("segment golden llava: 2 x 5 tokens, 2 heads of 16", gen,
                     [0, 5, 10], 2, 16),
        # the ring's other sizes: 32-key tiles at hd 128, 64 at hd 48
        segment_case("segment hd 128: segments of 100 and 200, 4 heads", gen,
                     [0, 100, 300], 4, 128),
        segment_case("segment hd 48: segments of 70, 7 and 123, 4 heads", gen,
                     [0, 70, 77, 200], 4, 48),
    ]


# the MoE grouped GEMM at gpt-oss-20b's expert shapes (K = N = 2880, 32
# experts, top-4): a decode step of 8 rows and a 512-token prefill chunk
GG_K = GG_N = 2880
GG_E = 32
# each output row within GG_RTOL of its largest plain value: both sides
# sum the same exact bf16 products in f32, in another order (K = 2880
# terms), where a wrong group, row or tile is wrong by the row's own size.
# The fused gate||up rounds its activation to bf16 on both sides, from f32
# sums taken in other orders, so a value may land one bf16 ulp apart: its
# rows are held at GG_RTOL beyond one ulp of each plain value.
GG_RTOL = 1e-4
# the fused cases' expert weights are scaled so gate and up spread with a
# std of ~4 and the clamped GLU's limits (gate <= 7, |up| <= 7) bind
GLU_W_SCALE = 4.0
# the cross-variant check: every expert gets 60-64 more rows ahead of the
# case's own, so the batch (A ~ 2000) takes 128-row tiles where the case
# (A 32) takes 64-row ones
INVARIANCE_PAD = 60
# the off-grid cases' 260 rows over 40 experts, some empty
OFF_GRID_SIZES = [7, 0, 12, 3, 0, 9, 15, 1, 0, 8, 6, 11, 4, 0, 10, 2, 13, 5, 0, 7,
                  9, 14, 0, 6, 3, 12, 8, 0, 5, 10, 4, 16, 0, 9, 7, 11, 2, 6, 14, 11]


def routing_sizes(gen, tokens, k=4, E=GG_E):
    """Group sizes of `tokens` tokens each routed to k distinct experts
    drawn uniformly, as a random router spreads them."""
    pick = torch.rand((tokens, E), generator=gen, device="cuda").argsort(-1)[:, :k]
    return torch.bincount(pick.reshape(-1), minlength=E).tolist()


def grouped_gemm_library_ms(xs, w, offs):
    """`torch._grouped_mm` over the same groups (bf16 out: it takes no f32
    output for bf16 inputs), the library yardstick, never used by the
    port; (ms, what), or (None, why) where the card's torch lacks it."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch._grouped_mm missing"
    ends = offs[1:].clone()
    return time_ms(lambda: fn(xs, w, ends)), "torch._grouped_mm, bf16 out"


def _moe_inputs(gen, sizes, n, n_weights, scale=1.0, bias=False, k=GG_K):
    """xs [A, k] bf16, n_weights expert weights [E, k, n] (std
    scale/sqrt(k), bf16), their biases [E, n] (std 1, bf16) or Nones, the
    offsets on the card and on the host."""
    import itertools

    E, K = len(sizes), k
    xs = torch.randn((sum(sizes), K), generator=gen, device="cuda").to(torch.bfloat16)
    ws = [(torch.randn((E, K, n), generator=gen, device="cuda") * (scale / K ** 0.5)
           ).to(torch.bfloat16) for _ in range(n_weights)]
    bs = [torch.randn((E, n), generator=gen, device="cuda").to(torch.bfloat16)
          if bias else None for _ in range(n_weights)]
    o = [0, *itertools.accumulate(sizes)]
    return xs, ws, bs, torch.tensor(o, dtype=torch.int32, device="cuda"), o


def _invariance(gen, xs, sizes, o, call):
    """The case's rows again inside a batch where every expert holds
    INVARIANCE_PAD + 0..4 more rows ahead of them (other tiles, other
    places in a tile, 128-row tiles where the case has 64): (their output
    rows from call(xs2, offs2), the batch's row count)."""
    parts, rows, pos, o2 = [], [], 0, [0]
    for e in range(len(sizes)):
        pad = INVARIANCE_PAD + e % 5
        parts += [torch.randn((pad, xs.shape[1]), generator=gen, device="cuda").to(
            torch.bfloat16), xs[o[e]:o[e + 1]]]
        rows += range(pos + pad, pos + pad + sizes[e])
        pos += pad + sizes[e]
        o2.append(pos)
    out2 = call(torch.cat(parts), torch.tensor(o2, dtype=torch.int32, device="cuda"))
    return out2[rows], pos


def _moe_common(res, sizes, A, out, invariance, call, gen, xs, o):
    from dynamo_tpu_torch.ops import moe

    E = len(sizes)
    res.update({"A": A, "K": xs.shape[1], "experts": E,
                "experts_touched": sum(s > 0 for s in sizes),
                "empty_groups": sum(s == 0 for s in sizes),
                "largest_group": max(sizes), "tile_rows": moe.tile_rows(A, E)})
    if invariance:
        rows, A2 = _invariance(gen, xs, sizes, o, call)
        res["bit_identical"] = bool(torch.equal(rows, out))
        res["invariance_A"] = A2
        res["invariance_tile_rows"] = moe.tile_rows(A2, E)


def _bound(res, nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16 * 1e3
    res.update({"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops})


def grouped_gemm_case(name, gen, sizes, timed=False, invariance=False, n=GG_N,
                      bias=False, k=GG_K):
    """The kernel against `grouped_gemm_plain` on random xs [A, k] and
    expert weights [E, k, n] (bf16) with the given group sizes, and a
    bias [E, n] when `bias`.  `invariance`: the same rows inside a batch
    of ~64 more rows an expert must come out bit-identical."""
    from dynamo_tpu_torch.ops import moe

    E, K, N = len(sizes), k, n
    A = sum(sizes)
    xs, (w,), (b,), offs, o = _moe_inputs(gen, sizes, n, 1, bias=bias, k=k)
    out = moe.grouped_gemm_cuda(xs, w, offs, b)
    ref = moe.grouped_gemm_plain(xs, w, offs, b)
    torch.cuda.synchronize()
    res = {"case": name, "kernel": "moe_grouped_gemm", "dtype": str(torch.bfloat16),
           "N": N, "bias": bias, "k_slices": moe.k_slices(E, K, N),
           **_errors(out, ref, torch.bfloat16), "rtol": GG_RTOL,
           "finite": bool(torch.isfinite(out).all())}
    _moe_common(res, sizes, A, out, invariance,
                lambda x2, o2: moe.grouped_gemm_cuda(x2, w, o2, b), gen, xs, o)
    if timed:
        touched = res["experts_touched"]
        _bound(res, touched * K * N * 2 + A * K * 2 + A * N * 4 + (E + 1) * 4
               + (touched * N * 2 if bias else 0), 2 * A * K * N)
        lib_ms, lib_what = grouped_gemm_library_ms(xs, w, offs)
        res.update({
            "ms": time_ms(lambda: moe.grouped_gemm_cuda(xs, w, offs, b)),
            "host_paced_ms": host_paced_ms(lambda: moe.grouped_gemm_cuda(xs, w, offs, b)),
            # the plain loop reads the offsets on the host: host-paced
            "plain_ms": host_paced_ms(lambda: moe.grouped_gemm_plain(xs, w, offs, b),
                                      iters=3),
            "library_ms": lib_ms, "library": lib_what,
        })
    return res


def _glu_errors(out, ref):
    """`_errors` for bf16 activations rounded on both sides: each value's
    error beyond one bf16 ulp of the plain value (2^-7 of its power of
    two), relative to its row's largest plain value."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    ulp = torch.where(r != 0, torch.exp2(torch.floor(torch.log2(r.abs())) - 7),
                      torch.zeros_like(r))
    excess = (err - ulp).clamp(min=0)
    scale = r.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    return {"max_abs_err": err.max().item(),
            "max_rel_err": (excess / scale).max().item(),
            "max_rel_err_raw": (err / scale).max().item(),
            "values_one_ulp_apart": int((err > 0).sum())}


def glu_library_ms(xs, wg, wu, bg, bu, offs, sizes, act):
    """Two `torch._grouped_mm` calls (bf16 out) and the same epilogue in
    eager torch (the biases gathered per row, `moe_act`, the cast): the
    library yardstick of the fused op, never used by the port."""
    from dynamo_tpu_torch.ops import moe

    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch._grouped_mm missing"
    ends = offs[1:].clone()
    expert = torch.repeat_interleave(
        torch.arange(len(sizes), device="cuda"),
        torch.tensor(sizes, device="cuda"))

    def lib():
        g, u = fn(xs, wg, ends).float(), fn(xs, wu, ends).float()
        if bg is not None:
            g, u = g + bg.float()[expert], u + bu.float()[expert]
        return moe.moe_act(act, g, u).to(torch.bfloat16)
    return time_ms(lib), "2 x torch._grouped_mm (bf16 out) + eager bias, act, cast"


def grouped_glu_case(name, gen, sizes, act, bias, timed=False, invariance=False,
                     n=GG_N, k=GG_K):
    """The fused gate||up kernel against `grouped_glu_plain`, by default at
    gpt-oss-20b's expert shapes (K = f = 2880), weights scaled by
    GLU_W_SCALE, with or without biases; GG_RTOL beyond one bf16 ulp
    (`_glu_errors`)."""
    from dynamo_tpu_torch.ops import moe

    E, K, N = len(sizes), k, n
    A = sum(sizes)
    xs, (wg, wu), (bg, bu), offs, o = _moe_inputs(gen, sizes, N, 2, GLU_W_SCALE,
                                                  bias, k)
    out = moe.grouped_glu_cuda(xs, wg, wu, bg, bu, offs, act)
    ref = moe.grouped_glu_plain(xs, wg, wu, bg, bu, offs, act)
    gate = moe.grouped_gemm_plain(xs, wg, offs, bg)
    torch.cuda.synchronize()
    res = {"case": name, "kernel": "moe_grouped_glu", "dtype": str(torch.bfloat16),
           "N": N, "act": act, "bias": bias, **_glu_errors(out, ref),
           "rtol": GG_RTOL, "finite": bool(torch.isfinite(out.float()).all()),
           "gate_share_clamped": (gate > 7).float().mean().item()}
    _moe_common(res, sizes, A, out, invariance,
                lambda x2, o2: moe.grouped_glu_cuda(x2, wg, wu, bg, bu, o2, act),
                gen, xs, o)
    if timed:
        touched = res["experts_touched"]
        _bound(res, 2 * touched * K * N * 2 + A * K * 2 + A * N * 2 + (E + 1) * 4
               + (2 * touched * N * 2 if bias else 0), 2 * 2 * A * K * N)
        lib_ms, lib_what = glu_library_ms(xs, wg, wu, bg, bu, offs, sizes, act)
        res.update({
            "ms": time_ms(lambda: moe.grouped_glu_cuda(xs, wg, wu, bg, bu, offs, act)),
            "host_paced_ms": host_paced_ms(
                lambda: moe.grouped_glu_cuda(xs, wg, wu, bg, bu, offs, act)),
            "plain_ms": host_paced_ms(
                lambda: moe.grouped_glu_plain(xs, wg, wu, bg, bu, offs, act), iters=3),
            "library_ms": lib_ms, "library": lib_what,
        })
    return res


# The KV re-page (`csrc/kv_transfer.cu`) at Llama-3.1-8B's layout: 32
# layers, 8 kv heads of 128.  It moves bytes, so it is held to its plain
# version bit for bit over both whole pools (the pages outside the
# transfer must come through untouched as well).
REPAGE_LAYOUT = dict(L=32, n_kv=8, hd=128)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def kv_repage_case(name, gen, prompt_len, ps_s, ps_d, src_dtype=torch.bfloat16,
                   dst_dtype=torch.bfloat16, timed=False):
    from dynamo_tpu_torch.ops import kv_transfer as kt

    L, n_kv, hd = REPAGE_LAYOUT["L"], REPAGE_LAYOUT["n_kv"], REPAGE_LAYOUT["hd"]
    n_src, n_dst = -(-prompt_len // ps_s), -(-prompt_len // ps_d)
    P_s, P_d = n_src + 8, n_dst + 8
    cpu = torch.Generator().manual_seed(SEED + prompt_len + ps_s * 7 + ps_d)

    def pool(P, ps, dtype):
        return (torch.randn((L, P, ps, n_kv, hd), generator=gen, device="cuda")
                * KV_STD).to(dtype)

    src_k, src_v = pool(P_s, ps_s, src_dtype), pool(P_s, ps_s, src_dtype)
    # unordered pages, never the last one (a page id off by one stays in
    # the pool, so a planted fault reads garbage instead of faulting)
    src_pages = (torch.randperm(P_s - 2, generator=cpu)[:n_src] + 1).tolist()
    dst_pages = (torch.randperm(P_d - 1, generator=cpu)[:n_dst] + 1).tolist()
    dst_k, dst_v = pool(P_d, ps_d, dst_dtype), pool(P_d, ps_d, dst_dtype)
    ref_k, ref_v = dst_k.clone(), dst_v.clone()
    kt.kv_repage_cuda(src_k, src_v, dst_k, dst_v, src_pages, dst_pages, prompt_len)
    kt.kv_repage_plain(src_k, src_v, ref_k, ref_v, src_pages, dst_pages, prompt_len)
    torch.cuda.synchronize()
    differ = sum(int((_bits(a) != _bits(b)).sum())
                 for a, b in ((dst_k, ref_k), (dst_v, ref_v)))
    res = {"case": name, "kernel": "kv_repage",
           "dtype": f"{src_dtype} -> {dst_dtype}",
           "pages": f"{n_src} x {ps_s} -> {n_dst} x {ps_d}",
           "differing_elements": differ,
           "max_abs_err": max((a.float() - b.float()).abs().max().item()
                              for a, b in ((dst_k, ref_k), (dst_v, ref_v))),
           # byte-exact: any differing element fails the check
           "max_rel_err": float(differ), "rtol": 0.0,
           "finite": bool(torch.isfinite(dst_k).all() and torch.isfinite(dst_v).all())}
    if timed:
        row = n_kv * hd
        nbytes = (2 * L * prompt_len * row * src_k.element_size()
                  + 2 * L * n_dst * ps_d * row * dst_k.element_size()
                  + 4 * (n_src + n_dst))
        t_bytes = nbytes / PEAK_BYTES * 1e3
        # the page ids built once: a per-call copy would wait for the
        # sleep that holds the device
        idx = kt.repage_index(src_pages, dst_pages, ps_s, ps_d, "cuda")

        def kernel():
            kt.kv_repage_cuda(src_k, src_v, dst_k, dst_v, src_pages, dst_pages,
                              prompt_len, index=idx)

        res.update({
            "ms": time_ms(kernel), "host_paced_ms": host_paced_ms(kernel),
            "plain_ms": time_ms(lambda: kt.kv_repage_plain(
                src_k, src_v, ref_k, ref_v, src_pages, dst_pages, prompt_len,
                index=idx), iters=3),
            "library_ms": None, "library": None,
            "bound_ms": t_bytes, "bound_by": "bytes", "bytes": nbytes, "flops": 0,
        })
        if ps_s == ps_d and src_dtype == dst_dtype:
            # the engine's page move before this slice (`_export_dev` +
            # `_import_dev`): index_select + index_copy_, no mask
            sidx = torch.tensor(src_pages, device="cuda")
            didx = torch.tensor(dst_pages, device="cuda")

            def library():
                ref_k.index_copy_(1, didx, src_k.index_select(1, sidx))
                ref_v.index_copy_(1, didx, src_v.index_select(1, sidx))

            res["library_ms"] = time_ms(library)
            res["library"] = "index_select + index_copy_ (the engine's page move)"
    return res


def kv_repage_window_case(name, gen, prompt_len, ps_s, ps_d, tp_s, tp_d,
                          rank_d, L=32, src_dtype=torch.bfloat16,
                          dst_dtype=torch.bfloat16):
    """The re-page between tp groups (phase 16's path): destination rank
    `rank_d` of a tp_d group fills its heads from a tp_s group's pools,
    one launch per source rank it overlaps (`head_windows`), held bit for
    bit against the plain version's same windows over the whole
    destination pool; timed (every launch of the rank), bound by its
    bytes: each token's window of `n_kv / tp_d` heads read once and its
    destination pages written once."""
    from dynamo_tpu_torch.ops import kv_transfer as kt

    n_kv, hd = REPAGE_LAYOUT["n_kv"], REPAGE_LAYOUT["hd"]
    h_s, h_d = n_kv // tp_s, n_kv // tp_d
    n_src, n_dst = -(-prompt_len // ps_s), -(-prompt_len // ps_d)
    P_s, P_d = n_src + 8, n_dst + 8
    cpu = torch.Generator().manual_seed(SEED + prompt_len + 31 * tp_s + tp_d)
    windows = kt.head_windows(n_kv, tp_s, tp_d, rank_d)

    def pool(P, ps, heads, dtype):
        return (torch.randn((L, P, ps, heads, hd), generator=gen, device="cuda")
                * KV_STD).to(dtype)

    # only the source ranks this destination rank reads
    src = {s: (pool(P_s, ps_s, h_s, src_dtype), pool(P_s, ps_s, h_s, src_dtype))
           for s, *_ in windows}
    src_pages = (torch.randperm(P_s - 2, generator=cpu)[:n_src] + 1).tolist()
    dst_pages = (torch.randperm(P_d - 1, generator=cpu)[:n_dst] + 1).tolist()
    dst_k, dst_v = pool(P_d, ps_d, h_d, dst_dtype), pool(P_d, ps_d, h_d, dst_dtype)
    ref_k, ref_v = dst_k.clone(), dst_v.clone()
    idx = kt.repage_index(src_pages, dst_pages, ps_s, ps_d, "cuda")

    def run(fn, dk, dv):
        for s, src_head, dst_head, heads in windows:
            fn(*src[s], dk, dv, src_pages, dst_pages, prompt_len, index=idx,
               src_head=src_head, dst_head=dst_head, heads=heads)

    run(kt.kv_repage_cuda, dst_k, dst_v)
    run(kt.kv_repage_plain, ref_k, ref_v)
    torch.cuda.synchronize()
    differ = sum(int((_bits(a) != _bits(b)).sum())
                 for a, b in ((dst_k, ref_k), (dst_v, ref_v)))
    nbytes = (2 * L * prompt_len * h_d * hd * torch.empty((), dtype=src_dtype).element_size()
              + 2 * L * n_dst * ps_d * h_d * hd * dst_k.element_size()
              + 4 * (n_src + n_dst))
    res = {"case": name, "kernel": "kv_repage",
           "dtype": f"{src_dtype} -> {dst_dtype}",
           "pages": f"{n_src} x {ps_s} -> {n_dst} x {ps_d}",
           "tp": f"{tp_s} -> {tp_d}, destination rank {rank_d}",
           "windows": [list(w) for w in windows], "launches": len(windows),
           "differing_elements": differ,
           "max_abs_err": max((a.float() - b.float()).abs().max().item()
                              for a, b in ((dst_k, ref_k), (dst_v, ref_v))),
           "max_rel_err": float(differ), "rtol": 0.0,
           "finite": bool(torch.isfinite(dst_k).all() and torch.isfinite(dst_v).all()),
           "ms": time_ms(lambda: run(kt.kv_repage_cuda, dst_k, dst_v)),
           "host_paced_ms": host_paced_ms(lambda: run(kt.kv_repage_cuda, dst_k, dst_v)),
           "plain_ms": time_ms(lambda: run(kt.kv_repage_plain, ref_k, ref_v),
                               iters=3),
           "library_ms": None, "library": None,
           "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
           "bytes": nbytes, "flops": 0}
    if ps_s == ps_d and src_dtype == dst_dtype:
        # the per-rank page move without the kernel: the window of the
        # gathered source pages copied into the window of the destination
        sidx = torch.tensor(src_pages, device="cuda")
        didx = torch.tensor(dst_pages, device="cuda")

        def library():
            for s, src_head, dst_head, heads in windows:
                for a, b in zip(src[s], (ref_k, ref_v)):
                    b.narrow(3, dst_head, heads).index_copy_(
                        1, didx, a.index_select(1, sidx).narrow(3, src_head, heads))

        res["library_ms"] = time_ms(library)
        res["library"] = "index_select + narrow + index_copy_ (the per-rank page move)"
    return res


# the windowed re-page cases of phase 3 (phase 16's shapes)
REPAGE_WINDOW_CASES = (
    ("kv_repage window: 8B tp 2 -> flat, 2049 tokens, pages 16 -> 16",
     dict(prompt_len=2049, ps_s=16, ps_d=16, tp_s=2, tp_d=1, rank_d=0)),
    ("kv_repage window: 8B flat -> tp 2 rank 1, 2049 tokens, pages 16 -> 32",
     dict(prompt_len=2049, ps_s=16, ps_d=32, tp_s=1, tp_d=2, rank_d=1)),
    ("kv_repage window: Llama-3-70B layout (80 layers) tp 4 -> tp 2 rank 1, "
     "2049 tokens, pages 16 -> 16",
     dict(prompt_len=2049, ps_s=16, ps_d=16, tp_s=4, tp_d=2, rank_d=1, L=80)),
    ("kv_repage window: f32 -> bf16 tp 4 -> flat, 333 tokens, pages 16 -> 32",
     dict(prompt_len=333, ps_s=16, ps_d=32, tp_s=4, tp_d=1, rank_d=0,
          src_dtype=torch.float32)),
)


# phases 9-16 run phase 4's 8B (and phase 11 gpt-oss-20b's) cut to this
# depth, full width, so the whole script fits its time limit (phase 8 at
# it since PR 13, the others since PR 15); phase 8's device loop, whose
# four engines capture and replay their graphs at every depth alike, at
# LOOP_LAYERS since PR 15
CUT_LAYERS = 8
# the depth of phases 9, 10, 11 (c)-(e), 12, 15 (c) and 16, full width:
# their checks hold each path against itself or a twin at the same depth
SHALLOW_LAYERS = 4
LOOP_LAYERS = 2


def depth_view(model, cfg, layers=CUT_LAYERS):
    """(model, cfg) of `model` cut to its first `layers` layers: a shallow
    copy sharing every tensor."""
    import copy

    view = copy.copy(model)
    view._modules = dict(model._modules)
    view.layers = torch.nn.ModuleList(list(model.layers)[:layers])
    view.cfg = cfg.with_depth(layers)
    return view, view.cfg


def tp_rank_sizes(sizes, rank=0, tp=2):
    """A tp rank's expert groups for a dispatch routed as `sizes` over
    every expert (`_moe_ragged` under tp): its own experts' rows, the
    other ranks' rows riding its last group."""
    n = len(sizes) // tp
    mine = list(sizes[rank * n:(rank + 1) * n])
    mine[-1] += sum(sizes) - sum(mine)
    return mine


def tp_rank_cases(gen):
    """The kernels at phase 15's and 18's per-rank shapes: both attention
    kernels at Llama-3.1-8B tp 2 (16 q / 4 kv heads of 128), Llama-3-70B
    tp 4 (16 / 2 of 128, G 8), gpt-oss-20b tp 2 (32 / 4 of 64, window 128,
    the rank's half of the sinks) and Qwen2.5-VL-7B tp 2 and tp 4 (14 / 2
    and 7 / 1 of 128, G 7), on the serving decode rows and a 512-token
    chunk after a 1536-token prefix; the grouped GEMM (with b_down) and
    the fused gate||up at gpt-oss-20b's 16 experts a rank on a decode
    step's and a chunk's rows.  All timed."""
    bf, sp = torch.bfloat16, SERVING_PREFILL
    out = []
    for model, H, n_kv, hd, extra in (
            ("Llama-3.1-8B tp 2 rank", 16, 4, 128, {}),
            ("Llama-3-70B tp 4 rank", 16, 2, 128, {}),
            ("gpt-oss-20b tp 2 rank", 32, 4, 64,
             {"window": 128, "with_sink": True}),
            ("Qwen2.5-VL-7B tp 2 rank", 14, 2, 128, {}),
            ("Qwen2.5-VL-7B tp 4 rank", 7, 1, 128, {})):
        out.append(decode_case(
            f"decode {model}: {H} q / {n_kv} kv heads of {hd}, serving rows",
            gen, bf, hd, H, n_kv, SERVING_DECODE, timed=True, **extra))
        out.append(prefill_case(
            f"prefill {model}: {H} q / {n_kv} kv heads of {hd}, chunk 512 "
            f"after a 1536 prefix", gen, bf, hd, H, n_kv, sp["S"], sp["prefix"],
            sp["chunk"], timed=True, **extra))
    dec = tp_rank_sizes(routing_sizes(gen, 8))
    chunk = tp_rank_sizes(routing_sizes(gen, 512))
    out += [
        grouped_gemm_case("moe tp 2 rank: 8 rows x top-4, 16 of 32 experts + "
                          "the other rank's rows, b_down", gen, dec, timed=True,
                          bias=True),
        grouped_gemm_case("moe tp 2 rank: 512 tokens x top-4, 16 of 32 experts "
                          "+ the other rank's rows, b_down", gen, chunk,
                          timed=True, bias=True),
        grouped_glu_case("moe glu tp 2 rank: 8 rows x top-4, 16 experts, "
                         "clamped GLU + biases", gen, dec, "gpt_oss_glu", True,
                         timed=True),
        grouped_glu_case("moe glu tp 2 rank: 512 tokens x top-4, 16 experts, "
                         "clamped GLU + biases", gen, chunk, "gpt_oss_glu", True,
                         timed=True),
    ]
    return out


# The ring prefill's block kernel (`csrc/ring_attention.cu`, phase 20's
# path): one round folded into a carry that a plain fold of a random
# earlier block made non-empty, the kernel's carry against the plain
# version's on the same inputs (each finished by the plain finish, so the
# block kernel alone is judged), and the finish kernel against the plain
# finish on the plain carry.  Tolerances: the attention cases' bars.
RING_8B = dict(hd=128, H=32, n_kv=8)
RING_OSS = dict(hd=64, H=64, n_kv=8)


def _ring_mask(q_base, k_base, Sq, Sk, causal, window, nk=None):
    """The (query, key) pairs these inputs attend [B, Sq, Sk] (bool, on
    the CPU)."""
    from dynamo_tpu_torch.ops import ring_attention as ra

    qp = ra._positions(q_base.cpu(), Sq)
    kp = ra._positions(k_base.cpu(), Sk)
    mask = ra._mask(qp, kp, causal, window)
    if nk is not None:
        mask = mask & (torch.arange(Sk)[None, :] < nk.cpu().long()[:, None])[:, None]
    return mask


def ring_case(name, gen, dtype, hd, H, n_kv, Sq, Sk=None, q_base=(0,),
              k_base=(0,), prefix=0, window=None, with_sink=False,
              timed=False, page=16, permuted=False):
    """`prefix` > 0: the cached-prefix fold through the page table (keys
    0 .. prefix - 1 of every row, pages of `page`: rows' pages 1, 2, ...
    in order, or with `permuted` pages drawn at random from a pool of twice
    their number, as a pool looks after churn); else a block of Sk keys at
    `k_base` (the causal ring round)."""
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import ring_attention as ra

    B = len(q_base)
    dev = "cuda"

    def rnd(*shape, s):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    q = rnd(B, Sq, H, hd, s=Q_STD)
    qb = torch.tensor(q_base, dtype=torch.int32, device=dev)
    sink = torch.randn((H,), generator=gen, device=dev) if with_sink else None
    carry = ra.ring_state(B, Sq, H, hd, dev)
    ra.ring_block_plain(q, rnd(B, 256, n_kv, hd, s=KV_STD),
                        rnd(B, 256, n_kv, hd, s=KV_STD), *carry, qb,
                        torch.zeros_like(qb), causal=False)
    if prefix:
        maxp = -(-prefix // page)
        table, P = _table([maxp] * B, maxp)
        if permuted:
            # the rows' pages drawn from a pool of twice their number: a
            # row that reads other pages than its table's reads others'
            # keys (over a pool of exactly its pages, only their order
            # would differ, which a fold of all visible keys cannot see)
            P = 2 * B * maxp + 1
            perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
            table = perm[:B * maxp].view(B, maxp).to(torch.int32)
        table = table.cuda()
        kp, vp = _pool(gen, P, page, n_kv, hd, dtype)
        plens = torch.full((B,), prefix, dtype=torch.int32, device=dev)

        def kern(m, l, o):
            ra.ring_prefix(q, kp, vp, table, plens, m, l, o, qb, window)

        def plain(m, l, o):
            ra.ring_prefix_plain(q, kp, vp, table, plens, m, l, o, qb, window)

        mask = _ring_mask(qb, torch.zeros_like(qb), Sq, maxp * page, False,
                          window, plens)
        key_bytes = B * prefix * n_kv * hd * 2 * q.element_size() + table.numel() * 4
    else:
        Sk = Sk or Sq
        k, v = rnd(B, Sk, n_kv, hd, s=KV_STD), rnd(B, Sk, n_kv, hd, s=KV_STD)
        kb = torch.tensor(k_base, dtype=torch.int32, device=dev)

        def kern(m, l, o):
            ra.ring_block(q, k, v, m, l, o, qb, kb, True, window)

        def plain(m, l, o):
            ra.ring_block_plain(q, k, v, m, l, o, qb, kb, True, window)

        mask = _ring_mask(qb, kb, Sq, Sk, True, window)
        key_bytes = (k.numel() + v.numel()) * q.element_size()
    pairs = int(mask.sum())
    got = [t.clone() for t in carry]
    want = [t.clone() for t in carry]
    kern(*got)
    plain(*want)
    fin = ra.ring_finish(*want, sink, dtype)
    fin_ref = ra.ring_finish_plain(*want, sink, dtype)
    torch.cuda.synchronize()
    err = _errors(ra.ring_finish_plain(*got, sink, torch.float32),
                  ra.ring_finish_plain(*want, sink, torch.float32), dtype)
    fin_err = _errors(fin, fin_ref, dtype)
    res = {"case": name, "kernel": "ring_attention", "dtype": str(dtype),
           **err, "block_max_rel_err": err["max_rel_err"],
           "finish_max_rel_err": fin_err["max_rel_err"],
           "max_rel_err": max(err["max_rel_err"], fin_err["max_rel_err"]),
           "max_abs_err": max(err["max_abs_err"], fin_err["max_abs_err"]),
           "m_max_abs_err": (got[0] - want[0]).abs().max().item(),
           "finite": bool(torch.isfinite(got[2]).all()
                          and torch.isfinite(fin).all()),
           "visible_pairs": pairs}
    if not timed:
        return res
    esize = q.element_size()
    carry_bytes = sum(t.numel() * 4 for t in carry)
    nbytes = q.numel() * esize + key_bytes + 2 * carry_bytes
    flops = 4 * pairs * H * hd
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    # the library: one call computing a round's attention with its
    # log-sum-exp (what merges into the carry; sinks join only at the
    # finish), kv heads repeated.  Without a window in bf16 the flash op,
    # causal for the diagonal round; with a window, or in f32 (which the
    # flash op refuses), the memory-efficient op with the round's mask as
    # an additive bias (NEG_INF where masked, broadcast over heads)
    g = H // n_kv
    if prefix:
        kg, vg = pa.gather_kv(kp, vp, table)
    else:
        kg, vg = k, v
    q_l = q.permute(0, 2, 1, 3).contiguous()
    k_l = kg.repeat_interleave(g, 2).permute(0, 2, 1, 3).contiguous()
    v_l = vg.repeat_interleave(g, 2).permute(0, 2, 1, 3).contiguous()
    if dtype == torch.bfloat16 and not window:
        causal = not prefix and q_base == k_base
        flash = torch.ops.aten._scaled_dot_product_flash_attention
        library = "flash"
        lib_ms = time_ms(lambda: flash(q_l, k_l, v_l, 0.0, causal))
    else:
        bias = torch.zeros(mask.shape, dtype=dtype).masked_fill_(
            ~mask, ra.NEG_INF).to(dev)[:, None].expand(B, H, Sq, k_l.shape[2])
        eff = torch.ops.aten._scaled_dot_product_efficient_attention
        library = "efficient + mask bias"
        lib_ms = time_ms(lambda: eff(q_l, k_l, v_l, bias, True))
    res.update({
        "ms": time_ms(lambda: kern(*got)),
        "host_paced_ms": host_paced_ms(lambda: kern(*got)),
        "plain_ms": time_ms(lambda: plain(*[t.clone() for t in carry]),
                            iters=3),
        "finish_ms": time_ms(lambda: ra.ring_finish(*want, sink, dtype)),
        # the finish reads m, l, o (f32) and the sinks once and writes the
        # output in q's dtype once: bytes bound it
        "finish_bound_ms": (carry_bytes + q.numel() * esize
                            + (sink.numel() * 4 if sink is not None else 0))
        / PEAK_BYTES * 1e3,
        "library_ms": lib_ms, "library": library,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    })
    return res


def ring_cases(gen):
    """Phase 3's cases of the ring kernel (the shapes of phase 20's path:
    an 8192-token prompt on sp 2 gives each slot Sq = Sk = 4096)."""
    bf, f32 = torch.bfloat16, torch.float32
    return [
        ring_case("ring 8B sp 2 rank 1: diagonal round, Sq = Sk = 4096", gen,
                  bf, **RING_8B, Sq=4096, q_base=(4096,), k_base=(4096,),
                  timed=True),
        ring_case("ring 8B sp 2 rank 1: earlier-source round, Sq = Sk = 4096",
                  gen, bf, **RING_8B, Sq=4096, q_base=(4096,), k_base=(0,),
                  timed=True),
        ring_case("ring 8B prefix through the table: 2048 tokens, Sq 4096",
                  gen, bf, **RING_8B, Sq=4096, q_base=(2048,), prefix=2048,
                  timed=True),
        ring_case("ring 8B prefix through the table: 2048 tokens on pages "
                  "drawn at random from a pool of twice as many, Sq 4096",
                  gen, bf, **RING_8B, Sq=4096, q_base=(2048,), prefix=2048,
                  permuted=True, timed=True),
        # pages of 48 are not a power of two: the kernel finds a key's
        # page by division (pages of 16 by a shift)
        ring_case("ring 8B prefix on pages of 48 (not a power of two): "
                  "1000 tokens, the last page partial, Sq 1000", gen, bf,
                  **RING_8B, Sq=1000, q_base=(1000,), prefix=1000, page=48,
                  permuted=True),
        ring_case("ring gpt-oss-20b: 64 q / 8 kv of 64, window 128, sinks, "
                  "diagonal round Sq = Sk = 2048", gen, bf, **RING_OSS,
                  Sq=2048, q_base=(2048,), k_base=(2048,), window=128,
                  with_sink=True, timed=True),
        ring_case("ring 8B tp 2 rank: 16 q / 4 kv, diagonal round Sq = Sk = "
                  "4096", gen, bf, hd=128, H=16, n_kv=4, Sq=4096,
                  q_base=(4096,), k_base=(4096,), timed=True),
        ring_case("ring f32 hd 64: 2 rows at offsets 96 / 200, window 40",
                  gen, f32, hd=64, H=8, n_kv=2, Sq=96, q_base=(96, 200),
                  k_base=(0, 152), window=40, timed=True),
        ring_case("ring f32 prefix 77 through the table", gen, f32, hd=128,
                  H=8, n_kv=8, Sq=50, q_base=(77,), prefix=77),
        ring_case("ring bf16 G 7: Sq 1000, prefix 333, window 300", gen, bf,
                  hd=128, H=28, n_kv=4, Sq=1000, q_base=(333,), prefix=333,
                  window=300),
        ring_case("ring bf16 G 7: Sq = Sk = 1000 partial tiles, diagonal",
                  gen, bf, hd=128, H=28, n_kv=4, Sq=1000, q_base=(1000,),
                  k_base=(1000,)),
    ]


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf, f32 = torch.bfloat16, torch.float32
    ragged = [1, 17, 1000, 4095]
    sp = SERVING_PREFILL
    results = [
        decode_case("decode ragged", gen, bf, 128, 32, 8, ragged, timed=True),
        decode_case("decode window 1000", gen, bf, 128, 32, 8, ragged, window=1000),
        decode_case("decode sinks + padding row", gen, bf, 128, 32, 8,
                    [0, 17, 1000, 4095], with_sink=True),
        decode_case("decode f32 hd64", gen, f32, 64, 32, 8, ragged),
        decode_case("decode splits + window 700 + sinks", gen, bf, 128, 32, 8,
                    [0, 17, 1000, 4095], window=700, with_sink=True),
        decode_case("decode bf16 hd64 G1", gen, bf, 64, 8, 8, [5, 300, 2049]),
        decode_case("decode serving shape", gen, bf, 128, 32, 8,
                    SERVING_DECODE, timed=True),
        prefill_case("prefill prefixes 0/48", gen, bf, 128, 32, 8, 512,
                     [0, 48], [512, 301], timed=True),
        prefill_case("prefill window 64", gen, bf, 128, 32, 8, 512,
                     [0, 48], [512, 301], window=64),
        prefill_case("prefill sinks + empty chunk", gen, bf, 128, 32, 8, 512,
                     [0, 48, 64], [512, 301, 0], with_sink=True),
        prefill_case("prefill f32 hd64", gen, f32, 64, 32, 8, 128,
                     [0, 48], [128, 77]),
        prefill_case("prefill chunk 333 / prefixes 37, 517", gen, bf, 128, 32, 8,
                     333, [37, 517], [333, 190]),
        prefill_case("prefill bf16 hd64 G8 window 100 + sinks", gen, bf, 64, 16, 2,
                     200, [37, 0], [200, 131], window=100, with_sink=True),
        prefill_case("prefill serving shape", gen, bf, 128, 32, 8, sp["S"],
                     sp["prefix"], sp["chunk"], timed=True),
        prefill_case("prefill speculative verify shape", gen, bf, 128, 32, 8,
                     **SERVING_VERIFY, timed=True),
        prefill_case("prefill embeddings: prefix 0, S 2048, 8 ragged rows", gen,
                     bf, 128, 32, 8, EMBED_LENS[0], [0] * 8, EMBED_LENS,
                     timed=True, cache_free=True),
        prefill_case("prefill embeddings f32: prefix 0, S 2048, 8 ragged rows",
                     gen, f32, 128, 32, 8, EMBED_LENS[0], [0] * 8, EMBED_LENS,
                     timed=True, cache_free=True),
        # gpt-oss-20b (phase 11): 64 q / 8 kv heads of 64, a 128-token
        # window on even layers, sinks on every layer
        decode_case("decode gpt-oss-20b: hd 64, G 8, window 128, sinks", gen, bf,
                    64, 64, 8, SERVING_DECODE, window=128, with_sink=True,
                    timed=True),
        prefill_case("prefill gpt-oss-20b: hd 64, G 8, window 128, sinks", gen, bf,
                     64, 64, 8, sp["S"], sp["prefix"], sp["chunk"], window=128,
                     with_sink=True, timed=True),
        grouped_gemm_case("moe decode: 8 rows x top-4 of 32 experts", gen,
                          (dec_sizes := routing_sizes(gen, 8)), timed=True,
                          invariance=True),
        grouped_gemm_case("moe prefill: 512 tokens x top-4 of 32 experts", gen,
                          (chunk_sizes := routing_sizes(gen, 512)), timed=True),
        grouped_gemm_case("moe empty groups", gen,
                          [0, 5, 0, 0, 3, 0, 24] + [0] * 25),
        grouped_gemm_case("moe one group holds every row", gen,
                          [0] * 31 + [2048]),
        grouped_gemm_case("moe down: decode rows with b_down", gen, dec_sizes,
                          bias=True),
        # gpt-oss-20b's router logits (`moe_router_logits`): one group,
        # N = 32 experts, less than a column tile (zero-filled loads and
        # skipped stores past N), K in 15 slices summed by a second launch
        grouped_gemm_case("moe router: 8 rows, one group, N 32", gen, [8],
                          timed=True, invariance=True, n=GG_E),
        grouped_gemm_case("moe router: 512 rows, one group, N 32", gen, [512],
                          timed=True, n=GG_E),
        grouped_gemm_case("moe router: 512 rows with its bias", gen, [512],
                          n=GG_E, bias=True),
        # the fused gate||up (`grouped_glu`) at gpt-oss-20b's shapes
        grouped_glu_case("moe glu decode: clamped GLU + biases", gen, dec_sizes,
                         "gpt_oss_glu", True, timed=True, invariance=True),
        grouped_glu_case("moe glu prefill: clamped GLU + biases", gen, chunk_sizes,
                         "gpt_oss_glu", True, timed=True),
        grouped_glu_case("moe glu decode: silu, no bias", gen, dec_sizes,
                         "silu", False),
        grouped_glu_case("moe glu one group holds every row", gen,
                         [0] * 31 + [2048], "gpt_oss_glu", True),
        # off the tile grid: 40 experts (the offsets scan crosses a warp's
        # 32), K 200 (a partial K tile; split-K slices of 3 and 1 tiles),
        # N 40 (a partial column box)
        grouped_gemm_case("moe off the grid: 40 experts, K 200, N 40, b_down",
                          gen, OFF_GRID_SIZES, n=40, k=200, bias=True),
        grouped_glu_case("moe glu off the grid: 40 experts, K 200, N 40", gen,
                         OFF_GRID_SIZES, "gpt_oss_glu", True, n=40, k=200),
    ]
    results.append(decode_width_case(gen))
    results += group_and_segment_cases(gen)
    # the KV re-page of disaggregated serving (phase 12's path)
    results += [
        kv_repage_case("kv_repage 2049 tokens, pages 16 -> 16", gen, 2049, 16, 16,
                       timed=True),
        kv_repage_case("kv_repage 2049 tokens, pages 16 -> 32", gen, 2049, 16, 32,
                       timed=True),
        kv_repage_case("kv_repage 77 tokens, pages 16 -> 16", gen, 77, 16, 16),
        kv_repage_case("kv_repage f32 -> bf16, 333 tokens, pages 16 -> 32", gen,
                       333, 16, 32, src_dtype=torch.float32),
    ]
    # the re-page between tp groups (phase 16's path): head windows
    results += [kv_repage_window_case(name, gen, **kw)
                for name, kw in REPAGE_WINDOW_CASES]
    results += tp_rank_cases(gen)
    # the ring prefill's block kernel and its finish (phase 20's path)
    results += ring_cases(gen)
    for r in results:
        emit({"phase": "kernel_check", **r})
        ok = (r["max_rel_err"] <= r["rtol"] and r["finite"]
              and r.get("zero_rows_ok", True) and r.get("padded_rows_zero", True))
        if not ok:
            fail(f"kernel disagrees with its plain version: {r}")
        if not r.get("bit_identical", True):
            fail(f"a kernel's output depends on its batch-mates or padding: {r}")
        if "invariance_tile_rows" in r and r["invariance_tile_rows"] == r["tile_rows"]:
            fail(f"the invariance check did not cross tile variants: {r}")
    return results


# The seeded sampler's noise: threefry bits on the card equal the CPU's
# exactly; the Gumbel floats agree within an absolute limit (a relative
# one means nothing for draws near 0; the two devices' log may differ in
# its last ulp).
GUMBEL_ATOL = 1e-5


def phase_sampling():
    from dynamo_tpu_torch.ops import sampling, threefry

    V = 128256  # Llama-3.1-8B's vocabulary
    checks = []
    for seed, counter in ((7, 0), (2**31 - 1, 37)):
        keys = {}
        for dev in ("cpu", "cuda"):
            k = threefry.fold_in(threefry.prng_key(torch.tensor([seed], device=dev)),
                                 torch.tensor([counter], device=dev))
            keys[dev] = threefry.split(k)[:, 0]
        bits = [threefry.random_bits32(keys[d], V).cpu() for d in ("cpu", "cuda")]
        gum = [threefry.gumbel(keys[d], V).cpu() for d in ("cpu", "cuda")]
        # the sampler's own draw (host keys, one merged hash on the device)
        noise = [torch.cat([g.cpu() for g in sampling.gumbel_noise(
            torch.tensor([seed], device=d), torch.tensor([counter], device=d),
            V, sampling.TOP_K_CAP)], 1) for d in ("cpu", "cuda")]
        checks.append({"seed": seed, "counter": counter,
                       "bits_equal": bool(torch.equal(bits[0], bits[1])),
                       "gumbel_max_abs_diff": max(
                           (gum[0] - gum[1]).abs().max().item(),
                           (noise[0] - noise[1]).abs().max().item())})
    # cost per step: a batch of 8 rows, all sampled (6 unconstrained, one
    # top-k, one top-p), and the serving run's mix (one sampled row of 5)
    B = 8
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    logits = torch.randn((B, V), generator=gen, device="cuda") * 3
    params = sampling.SamplingParams.make([0.8] * B, [0] * (B - 2) + [40, 0],
                                          [1.0] * (B - 1) + [0.9], device="cuda")
    mix = sampling.SamplingParams.make([0.0] * 4 + [0.8], [0] * 5, [1.0] * 5,
                                       device="cuda")
    seeds = torch.arange(B, device="cuda")
    ctrs = torch.full((B,), 5, device="cuda")

    def host_ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    res = {"phase": "sampling", "vocab": V, "checks": checks,
           "gumbel_atol": GUMBEL_ATOL, "batch": B,
           "noise_ms_per_step": host_ms(lambda: sampling.gumbel_noise(
               seeds, ctrs, V, sampling.TOP_K_CAP)),
           "sample_ms_per_step": host_ms(lambda: sampling.sample_tokens(
               logits, params, seeds, ctrs)),
           "sample_ms_one_of_5_rows": host_ms(lambda: sampling.sample_tokens(
               logits[:5], mix, seeds[:5], ctrs[:5])),
           "card": card_line()}
    emit(res)
    for c in checks:
        if not c["bits_equal"] or c["gumbel_max_abs_diff"] > GUMBEL_ATOL:
            fail(f"threefry on the card differs from the CPU: {c}")


# --------------------------------------------------------------------------- #
# phase 4: serving
# --------------------------------------------------------------------------- #


def sharpen(model) -> None:
    """Random weights at the JAX package's scales (embedding std 0.02) give a
    32-layer Llama-3.1-8B whose greedy output ignores its input: it repeats
    one token, so neither a batched-vs-alone nor a kernel-vs-plain check on
    it can see an attention error.  Raise the embedding to std 1, so each
    position keeps its token in the residual stream, and the q and k
    projections by 1.5, so scores spread about 2.25 and a single key (the
    newest) moves the output.  By 2 the model turns chaotic: bf16 roundings
    flip which key wins and the kernel and plain paths part.  Phase 5 shows
    that the tokens vary and that planted attention faults move the
    logits.  A rope with an attention scale (yarn's, 1.35 at gpt-oss-20b's
    factor 32) multiplies q.k by its square, so q and k take 1.5 over it
    and scores spread the same 2.25: gpt-oss-20b with q and k at 1.5
    spreads them 4.1, and its kernel and plain paths then part by 1.8
    logit std against 0.21 at 1.5 / 1.35 (phase 11 (b) on an H100)."""
    from dynamo_tpu_torch.testing import sharpen as sharpen_weights

    sharpen_weights(model)


_GROUPS = (("segment_attention", ("segment_attention",)),
           ("attention_decode", ("pa_decode_",)),
           ("attention_prefill", ("pa_prefill_",)),
           ("moe", ("moe_grouped_", "moe_split_reduce")),
           ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "cublas")))


def device_breakdown(prof, wall_s: float) -> dict:
    """Device time and launches per kernel group from a `torch.profiler`
    trace, and the device's idle share of `wall_s` (one stream, so kernels
    do not overlap)."""
    groups, busy_us = {}, 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        low = evt.key.lower()
        name = next((g for g, keys in _GROUPS if any(k in low for k in keys)),
                    "other")
        grp = groups.setdefault(name, {"ms": 0.0, "launches": 0})
        grp["ms"] += evt.self_device_time_total / 1e3
        grp["launches"] += evt.count
        busy_us += evt.self_device_time_total
    return {"wall_s": wall_s, "device_busy_s": busy_us / 1e6,
            "idle_share": 1.0 - busy_us / 1e6 / wall_s, "groups": groups}


async def _collect(engine, req):
    t0 = time.perf_counter()
    toks, reason, t_first, t_last = [], None, None, None
    async for d in engine.generate(req):
        now = time.perf_counter()
        if d["token_ids"]:
            t_first = t_first or now
            t_last = now
        toks.extend(d["token_ids"])
        reason = d["finish_reason"]
    return {"tokens": toks, "finish_reason": reason,
            "ttft_ms": (t_first - t0) * 1e3 if t_first else None,
            "t_first": t_first, "t_last": t_last}


def serving_prompts(cfg):
    """The serving traffic of phases 4 and 7: a 1024-token shared prefix
    and five prompts {name: (tokens, temperature, seed)} of 64-2048
    tokens, two of them behind the shared prefix, one seeded."""
    g = torch.Generator().manual_seed(SEED + 1)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()

    shared = prompt(1024)
    return shared, {
        "A_64": (prompt(64), 0.0, None),
        "B_shared+200": (shared + prompt(200), 0.0, None),
        "C_2048": (prompt(2048), 0.0, None),
        "D_shared+500_seeded": (shared + prompt(500), 0.8, 7),
        "E_300": (prompt(300), 0.0, None),
    }


def warm_suffix(cfg):
    """16 tokens after the shared prefix for the warm-up request (the
    generator's next draws, as the first slice took them)."""
    g = torch.Generator().manual_seed(SEED + 1)
    for n in (1024, 64, 200, 2048, 500, 300):
        torch.randint(0, cfg.vocab_size, (n,), generator=g)
    return torch.randint(0, cfg.vocab_size, (16,), generator=g).tolist()


def _req(tokens, temperature=0.0, seed=None, max_tokens=32):
    so = {"temperature": temperature}
    if seed is not None:
        so["seed"] = seed
    return {"token_ids": tokens, "sampling_options": so,
            "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}


def phase_serving(model, cfg, quantization="none", phase="serving"):
    """Phase 4 (and phase 11's int8 arm, `quantization="int8"`: the engine
    quantizes `model` in place at construction)."""
    from torch.profiler import ProfilerActivity, profile

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.ops import cuda_attention as ca

    shared, prompts = serving_prompts(cfg)
    reqs = {name: _req(toks, temperature=t, seed=seed)
            for name, (toks, t, seed) in prompts.items()}
    ecfg = EngineConfig(page_size=16, num_pages=1024, max_num_seqs=8,
                        max_prefill_tokens=512, max_model_len=4096,
                        quantization=quantization)
    engine = TorchEngine(cfg, model, ecfg, device="cuda")

    async def run():
        # warm the shared prefix into the cache (and the kernels' first use)
        await _collect(engine, _req(shared + warm_suffix(cfg), max_tokens=4))
        cached0 = engine.metrics().prefix_cached_tokens_total
        torch.cuda.synchronize()
        ca.reset_launches()
        t0 = time.perf_counter()
        outs = await asyncio.gather(*[_collect(engine, r) for r in reqs.values()])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ca.LAUNCHES)
        cached = engine.metrics().prefix_cached_tokens_total - cached0
        # greedy requests repeated alone, with the prefix cache cleared so
        # their prefill chunks are the ones of the batched run
        # (traced: where the device time of a prefill + decode run goes)
        solo = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for name in ("A_64", "C_2048"):
                engine.clear_kv_blocks()
                solo[name] = (await _collect(engine, reqs[name]))["tokens"]
            torch.cuda.synchronize()
            solo_wall = time.perf_counter() - t1
        await engine.shutdown()
        return outs, wall, launches, cached, solo, device_breakdown(prof, solo_wall)

    outs, wall, launches, cached, solo, breakdown = asyncio.run(run())
    res = dict(zip(reqs, outs))
    for name, r in res.items():
        if r["finish_reason"] != "length" or len(r["tokens"]) != 32:
            fail(f"serving: {name} ended {r['finish_reason']} with "
                 f"{len(r['tokens'])} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r["tokens"]):
            fail(f"serving: {name} produced out-of-vocab tokens")
    if min(launches[k] for k in ATTENTION_KERNELS) <= 0:
        fail(f"serving did not launch every attention kernel: {launches}")
    if cached < 2 * len(shared):
        fail(f"prefix cache not hit: {cached} cached prompt tokens")
    same = {n: solo[n] == res[n]["tokens"] for n in solo}
    if not all(same.values()):
        fail(f"greedy request alone differs from its batched run: {same}")
    first = min(r["t_first"] for r in res.values())
    last = max(r["t_last"] for r in res.values())
    decoded = sum(len(r["tokens"]) - 1 for r in res.values())
    emit({
        "phase": phase, "model": cfg.name, "dtype": "bfloat16",
        "quantization": quantization,
        "layers": cfg.num_hidden_layers, "requests": len(res),
        "prompt_tokens": {n: len(reqs[n]["token_ids"]) for n in reqs},
        "ttft_ms": {n: r["ttft_ms"] for n, r in res.items()},
        "decode_tokens_per_s": decoded / (last - first),
        "itl_ms": {n: (r["t_last"] - r["t_first"]) / (len(r["tokens"]) - 1) * 1e3
                   for n, r in res.items()},
        "wall_s": wall, "launches": launches,
        "prefix_cached_tokens": cached, "solo_equal": same,
        "solo_trace": breakdown,
        "card": card_line(),
    })
    direct = {"ttft_ms": {n: r["ttft_ms"] for n, r in res.items()},
              "itl_ms": {n: (r["t_last"] - r["t_first"]) / (len(r["tokens"]) - 1) * 1e3
                         for n, r in res.items()},
              "decode_tokens_per_s": decoded / (last - first),
              "tokens": {n: r["tokens"] for n, r in res.items()}}
    return launches, direct


# --------------------------------------------------------------------------- #
# phase 5: kernel path vs plain path at full width
# --------------------------------------------------------------------------- #


def phase_paths(model, cfg):
    """One prompt through `forward_prefill` and greedy `forward_decode`
    steps on the kernels; then the same fed tokens through the plain
    attention, and through attention with planted faults that the check
    must catch."""
    import dynamo_tpu_torch.models.llama as llama
    from dynamo_tpu_torch.ops import cuda_attention as ca
    from dynamo_tpu_torch.ops import paged_attention as pa

    S, steps, page = 512, 8, 16
    g = torch.Generator().manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=g).cuda()
    maxp = -(-(S + steps) // page)
    table = torch.arange(1, maxp + 1, dtype=torch.int32, device="cuda")[None]
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    chunk = torch.full((1,), S, dtype=torch.int32, device="cuda")

    def run(attention=None, fed=None):
        saved = (llama.prefill_attention, llama.decode_attention)
        if attention is not None:
            llama.prefill_attention, llama.decode_attention = attention
        try:
            kv = llama.KVCache.create(cfg, maxp + 1, page, torch.bfloat16, "cuda")
            logits = [model.forward_prefill(kv, tokens, table, zero, chunk)]
            toks = [int(logits[0].argmax(-1))]
            for t in range(steps):
                tok = toks[-1] if fed is None else fed[t]
                pos = torch.tensor([S + t], device="cuda")
                logits.append(model.forward_decode(
                    kv, torch.tensor([tok], device="cuda"), pos, table))
                toks.append(int(logits[-1].argmax(-1)))
        finally:
            llama.prefill_attention, llama.decode_attention = saved
        return torch.stack(logits)[:, 0], toks

    kern_logits, kern_toks = run()
    plain_logits, plain_toks = run(
        (pa.prefill_attention_plain, pa.decode_attention_plain), kern_toks)
    sd = plain_logits.std(-1)

    def logit_err(logits):  # largest |difference| in plain-logit std units
        return ((logits - plain_logits).abs().amax(-1) / sd).max().item()

    def zeros(q, *args, **kw):
        return torch.zeros_like(q)

    def skip_newest(q, kp, vp, table_, lens, *args, **kw):
        return ca.decode_attention_cuda(q, kp, vp, table_, lens - 1, *args, **kw)

    def skip_first_page(q, kp, vp, table_, lens, *args, **kw):
        return ca.decode_attention_cuda(q, kp, vp, table_, lens,
                                        window=int(lens.max()) - page)

    faults = {"zero attention": (zeros, zeros),
              "decode skips the newest token": (ca.prefill_attention_cuda, skip_newest),
              "decode skips the first page": (ca.prefill_attention_cuda, skip_first_page)}
    fault_err = {n: logit_err(run(f, kern_toks)[0]) for n, f in faults.items()}
    # how far below the plain path's best its logit for the kernel's token lies
    picked = plain_logits.gather(
        1, torch.tensor(kern_toks, device=plain_logits.device)[:, None])[:, 0]
    tie_gap = ((plain_logits.amax(-1) - picked) / sd).tolist()
    res = {"phase": "kernel_vs_plain_path", "prompt": S, "decode_steps": steps,
           "max_logit_err_in_std": logit_err(kern_logits),
           "tol_in_std": LOGIT_TOL, "planted_fault_err_in_std": fault_err,
           "plain_logit_std": sd.mean().item(),
           "max_abs_logit_diff": (kern_logits - plain_logits).abs().max().item(),
           "tokens_kernel": kern_toks, "tokens_plain": plain_toks,
           "kernel_token_gap_in_std": tie_gap,
           "finite": bool(torch.isfinite(kern_logits).all())}
    emit(res)
    if not res["finite"] or res["max_logit_err_in_std"] > LOGIT_TOL:
        fail("kernel path logits disagree with the plain path")
    if max(tie_gap) > LOGIT_TOL:
        fail("kernel path greedy tokens differ from the plain path beyond a near-tie")
    if len(set(kern_toks)) == 1:
        fail("the model repeats one token: no check on it can see attention")
    for name, err in fault_err.items():
        if err <= LOGIT_TOL:
            fail(f"phase 5 cannot see a planted fault: {name}")


# --------------------------------------------------------------------------- #
# phase 6: the golden anchor on the card
# --------------------------------------------------------------------------- #

GOLDEN_DIR = os.path.join(ROOT, "tests", "fixtures", "torch_golden_llama_hd64")
# f32: the CPU test's limit (tests/test_torch_loader.py, as test_golden.py:
# |got - want| <= atol + rtol * |want|).  bf16: the weights and every
# activation round to 8 mantissa bits, so each logit moves by a few bf16
# roundings of the residual stream; the limit is a share of each step's
# golden-logit standard deviation, far below the gap that separates the
# greedy token from the runner-up in this checkpoint.
GOLDEN_TOL = {torch.float32: {"atol": 2e-4, "rtol": 2e-4},
              torch.bfloat16: {"std_share": 0.1}}


def golden_steps(model, cfg, prompt, feed, page=16):
    """Prefill logits, then one decode step per `feed` token, through the
    paged pool on the card (the path tests/test_torch_loader.py anchors
    on the CPU)."""
    from dynamo_tpu_torch.models import KVCache

    n_pages = (len(prompt) + len(feed)) // page + 2
    kv = KVCache.create(cfg, 1 + n_pages, page, model.dtype, "cuda")
    table = torch.arange(1, 1 + n_pages, dtype=torch.int32, device="cuda")[None]
    i32 = dict(dtype=torch.int32, device="cuda")
    S = len(prompt)
    outs = [model.forward_prefill(kv, torch.tensor([prompt], device="cuda"), table,
                                  torch.zeros(1, **i32), torch.tensor([S], **i32))[0]]
    for pos, tok in enumerate(feed, start=S):
        outs.append(model.forward_decode(kv, torch.tensor([tok], device="cuda"),
                                         torch.tensor([pos], device="cuda"), table)[0])
    return torch.stack(outs).float().cpu().numpy()


def phase_golden():
    """The hd-64 transformers checkpoint loaded through the port's loader
    onto the card, in f32 and bf16; both kernels run at head dim 64 with
    2 query heads per kv head.  Logits must meet GOLDEN_TOL against
    transformers' and the greedy continuation must be transformers'."""
    import numpy as np

    from dynamo_tpu_torch.models import ModelConfig
    from dynamo_tpu_torch.models.loader import load_params
    from dynamo_tpu_torch.ops import cuda_attention as ca

    cfg = ModelConfig.from_pretrained(GOLDEN_DIR)
    data = np.load(os.path.join(GOLDEN_DIR, "golden_logits.npz"))
    results, launches = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        model = load_params(GOLDEN_DIR, cfg, dtype=dtype, device="cuda")
        torch.cuda.synchronize()
        ca.reset_launches()
        for i in range(2):
            want = data[f"logits{i}"]
            greedy = data[f"greedy{i}"].tolist()
            got = golden_steps(model, cfg, data[f"prompt{i}"].tolist(), greedy[:-1])
            torch.cuda.synchronize()
            diff = np.abs(got - want)
            std = want.std(-1, keepdims=True)
            tol = GOLDEN_TOL[dtype]
            ok = (bool(np.all(diff <= tol["atol"] + tol["rtol"] * np.abs(want)))
                  if "atol" in tol else float((diff / std).max()) <= tol["std_share"])
            results.append({
                "dtype": str(dtype), "prompt": i, "steps": int(want.shape[0]),
                "max_abs_err": float(diff.max()),
                "max_err_in_std": float((diff / std).max()),
                "tolerance": tol, "within_tolerance": ok,
                "finite": bool(np.isfinite(got).all()),
                "greedy_equal": got.argmax(-1).tolist() == greedy,
                # how far below transformers' best its logit for our
                # token lies, in std (0 where the tokens agree)
                "greedy_gap_in_std": float(((want.max(-1) - np.take_along_axis(
                    want, got.argmax(-1)[:, None], -1)[:, 0]) / std[:, 0]).max()),
            })
        launches[str(dtype)] = dict(ca.LAUNCHES)
    emit({"phase": "golden", "checkpoint": "tests/fixtures/torch_golden_llama_hd64",
          "head_dim": cfg.head_dim_, "q_heads": cfg.num_attention_heads,
          "kv_heads": cfg.num_key_value_heads, "results": results,
          "launches": launches})
    for r in results:
        # f32: the greedy tokens are transformers'.  bf16: the fixture has
        # near-ties (prompt 1, step 3: the top two 0.004 std apart, below
        # bf16's resolution), so a token may differ only where transformers
        # put it within the bf16 limit of its best, as phase 5 rules
        greedy_ok = (r["greedy_equal"] if r["dtype"] == str(torch.float32)
                     else r["greedy_gap_in_std"] <= GOLDEN_TOL[torch.bfloat16]["std_share"])
        if not (r["within_tolerance"] and r["finite"] and greedy_ok):
            fail(f"golden anchor missed on the card: {r}")
    for dt, counts in launches.items():
        if min(counts[k] for k in ATTENTION_KERNELS) <= 0:
            fail(f"golden {dt} run did not launch every attention kernel: {counts}")
    # the path's counts: both dtypes together
    return {k: sum(c[k] for c in launches.values()) for k in ca.LAUNCHES}


# --------------------------------------------------------------------------- #
# phase 7: the full stack over HTTP
# --------------------------------------------------------------------------- #


# phase 7's timed SSE waves: straight into generate(), over HTTP through
# the frontend in this process, over HTTP through a frontend process
# one timed wave an arm since PR 15 (before: A B C C B A, each arm's two
# waves straddling the host clock's drift within a call)
WAVE_ORDER = ("direct", "http_in_process", "http_frontend_process")


def _spawn(procs, *args, env=None):
    p = subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, text=True)
    procs.append(p)
    return p


def _ready(p, prefix, what, timeout=600):
    """The first line of `p` that starts with `prefix` (fails if `p`
    exits first or `timeout` passes)."""
    from concurrent.futures import ThreadPoolExecutor

    def scan():
        seen = []
        for line in p.stdout:
            if line.startswith(prefix):
                return line.strip()
            seen.append(line)
        fail(f"{what} exited, printing {seen!r}")

    with ThreadPoolExecutor(1) as ex:
        return ex.submit(scan).result(timeout=timeout)


def _http(port, method, path, body=None, timeout=600):
    """(status, body bytes) of one request on its own connection."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _http_stream(port, path, body, timeout=600, on_frame=None):
    """One SSE request read frame by frame at the client: (status, text,
    finish_reason, send time, arrival time of each data frame).
    `on_frame(n)` is called after the n-th data frame arrives."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=json.dumps({**body, "stream": True}),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        text, finish, stamps = [], None, []
        while True:
            line = r.readline()
            if not line:
                break
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            if line == b"data: [DONE]":
                break
            stamps.append(time.perf_counter())
            ch = json.loads(line[6:])["choices"][0]
            text.append(ch["delta"].get("content", "") if "delta" in ch
                        else ch.get("text", ""))
            finish = ch.get("finish_reason") or finish
            if on_frame is not None:
                on_frame(len(stamps))
        r.read()
        return r.status, "".join(text), finish, t0, stamps
    finally:
        conn.close()


def _stream_wave(port, bodies):
    """Every body as an SSE /v1/completions request at once, one client
    thread each; [(status, text, finish_reason, t0, stamps)] in order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(bodies)) as ex:
        return list(ex.map(lambda b: _http_stream(port, "/v1/completions", b),
                           bodies))


def stream_client_main(argv) -> int:
    """``chip_smoke.py --stream-client PORT BODIES.json``: phase 7's SSE
    wave from a client process of its own, printed as one JSON line.
    With ``-`` for both, the client reads ``PORT BODIES.json`` from a line
    of its standard input (started early: its imports take seconds)."""
    if argv[:1] == ["-"]:
        argv = sys.stdin.readline().split()
    port, path = int(argv[0]), argv[1]
    with open(path) as f:
        bodies = json.load(f)
    print(json.dumps(_stream_wave(port, bodies)), flush=True)
    return 0


def _metric_sum(text: str, name: str) -> float:
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith(name + "{") or ln.startswith(name + " "))


def phase_http(model, cfg, direct):
    """The port's whole stack in this process: embedded control plane,
    worker over `TorchEngine`, model watcher, `HttpService` on a free port.
    Phase 4's prompts go in pre-tokenized over /v1/completions: once as a
    concurrent unary wave (the main path, launches counted); each alone,
    unary, SSE and straight into `generate()`, which must agree; then six
    timed SSE waves from a client process, in the order of WAVE_ORDER,
    with a frontend process (`python -m dynamo_tpu_torch.frontend`) for
    the third arm.  Last, two chat requests (greedy; seeded at temperature
    0.8, repeated from the same cold cache) under `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.frontend import HttpService, ModelManager, ModelWatcher
    from dynamo_tpu_torch.llm import ModelDeploymentCard, StreamPostprocessor
    from dynamo_tpu_torch.ops import cuda_attention as ca
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.worker import serve_engine

    # the stream clients of the two HTTP waves start now: their imports
    # take seconds, and they wait for their port on standard input
    clients = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--stream-client", "-"], cwd=ROOT,
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                text=True) for _ in range(2)]
    t_tok = time.perf_counter()
    tok = llama_tokenizer(cfg)
    t_tok = time.perf_counter() - t_tok
    if tok.vocab_size != cfg.vocab_size:
        fail(f"synthetic tokenizer has {tok.vocab_size} ids, not {cfg.vocab_size}")
    ecfg = EngineConfig(page_size=16, num_pages=1024, max_num_seqs=8,
                        max_prefill_tokens=512, max_model_len=4096)
    engine = TorchEngine(cfg, model, ecfg, eos_token_ids=tok.eos_token_ids,
                         device="cuda")
    name = cfg.name
    mdc = ModelDeploymentCard(name=name, tokenizer_json=tok.to_json_str(),
                              eos_token_ids=tok.eos_token_ids, context_length=4096)
    shared, prompts = serving_prompts(cfg)

    def completion(toks, t, seed):
        body = {"model": name, "prompt": toks, "max_tokens": 32, "temperature": t,
                "nvext": {"ignore_eos": True}}
        if seed is not None:
            body["seed"] = seed
        return body

    def chat(content, **so):
        return {"model": name, "max_tokens": 32, "nvext": {"ignore_eos": True},
                "messages": [{"role": "user", "content": content}], **so}

    greedy_chat = chat("Summarize paged attention in one line.", temperature=0)
    seeded_chat = chat("Name three uses of a KV cache.", temperature=0.8, seed=11)

    async def run():
        rt = await DistributedRuntime.detached()
        await serve_engine(rt, engine, mdc)
        watcher = await ModelWatcher(rt, ModelManager()).start()
        await asyncio.wait_for(watcher.wait_for_model(name), 120)
        http = await HttpService(watcher.manager, host="127.0.0.1", port=0).start()
        loop = asyncio.get_running_loop()
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=12)

        def call(fn, *a):
            return loop.run_in_executor(pool, fn, http.port, *a)

        warm = completion(shared + warm_suffix(cfg), 0.0, None) | {"max_tokens": 4}

        async def reset_cache(warm_prefix=True):
            """The same prefix-cache state before every wave: cleared, then
            the shared prefix warmed as phase 4 does.  A prompt the cache
            already holds prefills only its tail, a different bf16
            summation that can flip a near-tie of the 128k vocabulary."""
            for path, body in (("/clear_kv_blocks", None),
                               ("/v1/completions", warm))[:1 + warm_prefix]:
                status, _ = await call(_http, "POST", path, body)
                if status != 200:
                    fail(f"http: {path} answered {status}")

        bodies = [completion(*p) for p in prompts.values()]
        bodies_path = os.path.join(ROOT, "build", "http_stream_bodies.json")
        with open(bodies_path, "w") as f:
            json.dump(bodies, f)

        async def client_wave(port):
            """The SSE wave from a client process of its own, as users
            connect (client threads here would contend for this
            process's GIL with the engine's step thread); the client was
            started with the phase and is told its port now."""
            client = clients.pop(0)
            stdout, _ = await loop.run_in_executor(
                pool, lambda: client.communicate(f"{port} {bodies_path}\n",
                                                 timeout=600))
            if client.returncode != 0:
                fail(f"http: the stream client exited {client.returncode}")
            return json.loads(stdout.strip().splitlines()[-1])

        async def direct_wave():
            """The same wave straight into `generate()`, as phase 4 runs
            it: [(tokens, t0, arrival time of each token)]."""
            async def one(toks, t, seed):
                t0, stamps, got = time.perf_counter(), [], []
                async for d in engine.generate(_req(toks, temperature=t, seed=seed)):
                    if d["token_ids"]:
                        stamps.append(time.perf_counter())
                        got.extend(d["token_ids"])
                return got, t0, stamps
            return await asyncio.gather(*[one(*p) for p in prompts.values()])

        # the multi-process form: `python -m dynamo_tpu_torch.frontend` in
        # a process of its own on this control plane, so this process
        # keeps only the worker's side of the transport
        # one SSE frame a token: the waves count the frames (the CLI
        # merges deltas queued together under backpressure by default)
        front = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "dynamo_tpu_torch.frontend",
            "--control", rt.control_address, "--host", "127.0.0.1",
            "--port", "0", "--no-sse-coalesce", "--log-level", "warning",
            cwd=ROOT, stdout=asyncio.subprocess.PIPE)
        out = {}
        try:
            ready = (await asyncio.wait_for(front.stdout.readline(), 120)).decode()
            if not ready.startswith("READY http://"):
                fail(f"http: the frontend process printed {ready!r}")
            front_port = int(ready.strip().rsplit(":", 1)[1])
            for _ in range(600):  # until its watcher has the model
                st, body = await loop.run_in_executor(
                    pool, _http, front_port, "GET", "/v1/models")
                if st == 200 and name.encode() in body:
                    break
                await asyncio.sleep(0.1)
            # the main path: the unary wave through the in-process stack
            await reset_cache()
            torch.cuda.synchronize()
            ca.reset_launches()
            t0 = time.perf_counter()
            unary = await asyncio.gather(*[
                call(_http, "POST", "/v1/completions", b) for b in bodies])
            torch.cuda.synchronize()
            out["unary_wall_s"] = time.perf_counter() - t0
            out["launches"] = dict(ca.LAUNCHES)
            out["unary"] = [(st, json.loads(b)) for st, b in unary]
            # each prompt alone from the same cache state, unary, SSE and
            # straight into generate(): in a concurrent wave a prompt's
            # prefill chunks depend on what arrived with it
            out["solo"] = {}
            for pname, body in zip(prompts, bodies):
                await reset_cache()
                st, b = await call(_http, "POST", "/v1/completions", body)
                await reset_cache()
                sse = await call(_http_stream, "/v1/completions", body)
                await reset_cache()
                toks, t, seed = prompts[pname]
                got = await _collect(engine, _req(toks, temperature=t, seed=seed))
                out["solo"][pname] = (st, json.loads(b), sse, got["tokens"])
            # the timed waves, one an arm in WAVE_ORDER
            out["waves"] = []
            for arm in WAVE_ORDER:
                await reset_cache()
                if arm == "direct":
                    res = await direct_wave()
                else:
                    res = await client_wave(
                        http.port if arm == "http_in_process" else front_port)
                out["waves"].append((arm, res))
            out["routes"] = {p: await call(_http, "GET", p)
                             for p in ("/v1/models", "/health", "/metrics")}
            front.terminate()
            await asyncio.wait_for(front.wait(), 60)
            # last: leaving the profiler processes its trace on this
            # event loop, which then answers nothing for seconds
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t2 = time.perf_counter()
                await reset_cache(warm_prefix=False)
                chats = await asyncio.gather(
                    call(_http, "POST", "/v1/chat/completions", greedy_chat),
                    call(_http, "POST", "/v1/chat/completions", seeded_chat))
                # the seeded request again, alone, from the same cold cache
                await reset_cache(warm_prefix=False)
                again = await call(_http, "POST", "/v1/chat/completions", seeded_chat)
                torch.cuda.synchronize()
                out["chat_wall_s"] = time.perf_counter() - t2
            out["chats"] = [(st, json.loads(b)) for st, b in list(chats) + [again]]
            out["prof"] = prof
        finally:
            if front.returncode is None:
                front.terminate()
                await asyncio.wait_for(front.wait(), 60)
            pool.shutdown(wait=False)
            await http.stop()
            await watcher.stop()
            await rt.shutdown(graceful=False)
            await engine.shutdown()
        return out

    out = asyncio.run(run())
    out["chat_trace"] = device_breakdown(out.pop("prof"), out["chat_wall_s"])
    rows = {}
    for pname, (st, body) in zip(prompts, out["unary"]):
        if st != 200:
            fail(f"http: {pname} answered {st}")
        rows[pname] = {"finish": body["choices"][0]["finish_reason"],
                       "completion_tokens": body["usage"]["completion_tokens"]}
    for pname, (st, body, sse, toks) in out["solo"].items():
        text, finish = body["choices"][0]["text"], body["choices"][0]["finish_reason"]
        post = StreamPostprocessor(tok, prompts[pname][0])
        direct_text = "".join(post.push_tokens([t]) for t in toks) + post.flush()
        rows[pname].update({
            "solo_unary_status": st, "solo_sse_status": sse[0],
            "sse_equals_unary": (sse[1], sse[2]) == (text, finish),
            "equals_direct_generate": direct_text == text})
        if st != 200 or sse[0] != 200:
            fail(f"http: {pname} alone answered {st} / {sse[0]}")
        if not rows[pname]["sse_equals_unary"]:
            fail(f"http: {pname} SSE text differs from its unary text: "
                 f"{sse[1]!r} vs {text!r}")
        if not rows[pname]["equals_direct_generate"]:
            fail(f"http: {pname} text differs from generate() detokenized: "
                 f"{text!r} vs {direct_text!r}")
    for pname, r in rows.items():
        if r["finish"] != "length" or r["completion_tokens"] != 32:
            fail(f"http: {pname} ended {r['finish']} with {r['completion_tokens']} tokens")
    waves = []
    for arm, res in out["waves"]:
        per = {}
        for pname, item in zip(prompts, res):
            if arm == "direct":
                toks, t0, stamps = item
            else:
                sst, _, sfinish, t0, stamps = item
                if sst != 200 or sfinish != "length":
                    fail(f"http: {pname} SSE ({arm}) answered {sst}, {sfinish}")
            if len(stamps) != 32:
                fail(f"http: {pname} ({arm}) streamed {len(stamps)} of 32 tokens")
            per[pname] = {"ttft_ms": (stamps[0] - t0) * 1e3,
                          "itl_ms": (stamps[-1] - stamps[0]) / (len(stamps) - 1) * 1e3,
                          "tokens": len(stamps), "t_first": stamps[0],
                          "t_last": stamps[-1]}
        first = min(v["t_first"] for v in per.values())
        last = max(v["t_last"] for v in per.values())
        waves.append({
            "arm": arm,
            "ttft_ms": {n: v["ttft_ms"] for n, v in per.items()},
            "itl_ms": {n: v["itl_ms"] for n, v in per.items()},
            "mean_itl_ms": sum(v["itl_ms"] for v in per.values()) / len(per),
            "decode_tokens_per_s": sum(v["tokens"] - 1 for v in per.values())
            / (last - first),
        })
    arms = {}
    for w in waves:
        a = arms.setdefault(w["arm"], {"mean_itl_ms": [], "decode_tokens_per_s": [],
                                        "mean_ttft_ms": []})
        a["mean_itl_ms"].append(w["mean_itl_ms"])
        a["decode_tokens_per_s"].append(w["decode_tokens_per_s"])
        a["mean_ttft_ms"].append(sum(w["ttft_ms"].values()) / len(w["ttft_ms"]))
    chats = out["chats"]
    if any(st != 200 for st, _ in chats):
        fail(f"http: chat answered {[st for st, _ in chats]}")
    chat_text = [b["choices"][0]["message"]["content"] for _, b in chats]
    if chat_text[1] != chat_text[2]:
        fail("http: the seeded chat request is not reproducible")
    routes = out["routes"]
    models = json.loads(routes["/v1/models"][1])
    health = json.loads(routes["/health"][1])
    metrics = routes["/metrics"][1].decode()
    if (any(st != 200 for st, _ in routes.values())
            or [m["id"] for m in models["data"]] != [name]
            or health.get("status") != "healthy"
            or "dynamo_frontend_requests_total" not in metrics):
        fail(f"http: a route answered wrongly: { {p: r[0] for p, r in routes.items()} }")
    trace = out["chat_trace"]["groups"]
    traced = {g: trace.get(g, {}).get("launches", 0)
              for g in ("attention_decode", "attention_prefill")}
    if min(traced.values()) <= 0:
        fail(f"http: the profiler did not see both attention kernels: {traced}")
    launches = out["launches"]
    if min(launches[k] for k in ATTENTION_KERNELS) <= 0:
        fail(f"http traffic did not launch every attention kernel: {launches}")
    # frontend CPU building and writing SSE frames, over every token the
    # in-process frontend streamed (unary answers write no frames)
    streamed = WAVE_ORDER.count("http_in_process") * sum(
        r["completion_tokens"] for r in rows.values())
    egress_s = _metric_sum(metrics, "dynamo_frontend_egress_cpu_seconds_total")
    res = {
        "phase": "http", "model": name, "dtype": "bfloat16",
        "layers": cfg.num_hidden_layers,
        "tokenizer": {"path": "build/llama3_synthetic_tokenizer.json",
                      "ids": tok.vocab_size, "build_s": t_tok},
        "requests": rows,
        "unary_wave_s": out["unary_wall_s"],
        "waves": waves,
        "frontend_egress_ms_per_token": egress_s / streamed * 1e3,
        "direct_generate_phase4": direct,
        "chat": {"seeded_repeats": True, "greedy_chars": len(chat_text[0]),
                 "trace": out["chat_trace"]},
        "launches": launches,
    }
    emit(res)
    print(json.dumps({"http_metrics": {
        "order": list(WAVE_ORDER), "arms": arms,
        "frontend_egress_ms_per_token": res["frontend_egress_ms_per_token"],
        "phase4_direct": direct}, "card": card_line()}), flush=True)
    # each prompt's tokens straight from generate() (alone, from the
    # warmed cache): phase 14's reference at this depth
    return launches, {"tokens": {p: v[3] for p, v in out["solo"].items()}}


# --------------------------------------------------------------------------- #
# phase 8: the engine's device loop
# --------------------------------------------------------------------------- #

# Four engines over the same weights and traffic: (a) the default one-step
# blocks, (b) 8-step blocks with the ladder 1/2/4 and chains of 2, (c) the
# same with the continuous loop and chunk rows (the loop runs at the
# ladder's top rung), (d) speculative decoding with k = 4.
DEVICE_LOOP_ARMS = {
    "a_steps1": dict(decode_steps=1),
    "b_steps8_ladder_chain2": dict(decode_steps=8, decode_block_ladder=[1, 2, 4],
                                   decode_chain=2),
    "c_continuous_chunk512": dict(decode_steps=8, decode_block_ladder=[1, 2, 4],
                                  decode_chain=2, decode_continuous=True,
                                  prefill_chunk_tokens=512),
    "d_spec_ngram4": dict(speculative_ngram_k=4),
}
# rows held token-identical across arms (a), (b), (c): greedy, and never fed
# through a chunk row or a verify
GREEDY_ROWS = ("A_64", "B_shared+200", "C_2048", "E_300", "G_repeat")
SEEDED_ROW = "D_shared+500_seeded"


LONG_ROW, LONG_TOKENS = "G_repeat", 96


def device_loop_requests(cfg):
    """Phase 4's five prompts (32 tokens each), a greedy prompt of repeated
    n-grams that decodes for longer (the drafts of arm (d) can match it),
    and the arrival F, sent once the five are done and a decode block of
    the long row is in flight: arm (c) then splices it into a running
    chain that no other row's stop ends."""
    shared, prompts = serving_prompts(cfg)
    g = torch.Generator().manual_seed(SEED + 4)
    pattern = torch.randint(0, cfg.vocab_size, (16,), generator=g).tolist()
    wave = {n: _req(t, temperature=temp, seed=s) for n, (t, temp, s) in prompts.items()}
    wave[LONG_ROW] = _req(pattern * 16, max_tokens=LONG_TOKENS)
    arrival = _req(torch.randint(0, cfg.vocab_size, (64,), generator=g).tolist())
    return shared, wave, arrival


def reference_logits(model, cfg, tokens):
    """f32 logits after `tokens` from the eager prefill path (512-token
    chunks into a scratch pool): the yardstick of a flip's margin."""
    from dynamo_tpu_torch.models import KVCache

    page = 16
    pages = -(-len(tokens) // page)
    kv = KVCache.create(cfg, pages + 1, page, torch.bfloat16, "cuda")
    table = torch.arange(1, pages + 1, dtype=torch.int32, device="cuda")[None]
    for lo in range(0, len(tokens), 512):
        chunk = tokens[lo:lo + 512]
        logits = model.forward_prefill(
            kv, torch.tensor([chunk], device="cuda"), table,
            torch.tensor([lo], dtype=torch.int32, device="cuda"),
            torch.tensor([len(chunk)], dtype=torch.int32, device="cuda"))
    return logits[0]


def first_flip(model, cfg, prompt, ref, got):
    """None when `got` equals `ref`; else where they part and the margin
    of the reference token over the other in logit std units."""
    if got == ref:
        return None
    j = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b),
             min(len(ref), len(got)))
    if j >= min(len(ref), len(got)):
        return {"index": j, "margin_std": None, "lengths": [len(ref), len(got)]}
    lg = reference_logits(model, cfg, prompt + ref[:j])
    margin = ((lg[ref[j]] - lg[got[j]]) / lg.std()).item()
    return {"index": j, "ref_token": ref[j], "arm_token": got[j],
            "margin_std": margin}


def phase_device_loop(model, cfg):
    """Each arm: an engine of its own; two warm-up passes that capture the
    graphs, a measured pass (TTFT, ITL, tokens/s; launches, captures and
    replays counted from zero), a check that one block's replay equals an
    uncaptured run bit for bit, and a traced pass for the device
    breakdown.  Every pass starts from the same prefix-cache state.  Then
    the arms' greedy rows against arm (a)."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.ops import cuda_attention as ca

    shared, wave, arrival = device_loop_requests(cfg)
    warm = _req(shared + warm_suffix(cfg), max_tokens=4)
    tokens, launches_by_arm = {}, {}

    for arm, over in DEVICE_LOOP_ARMS.items():
        ecfg = EngineConfig(page_size=16, num_pages=1024, max_num_seqs=8,
                            max_prefill_tokens=512, max_model_len=4096, **over)
        engine = TorchEngine(cfg, model, ecfg, device="cuda")
        if over.get("decode_continuous"):
            def in_flight(e):
                return e.get("continuous")
        else:
            def in_flight(e):
                return e["kind"] in ("decode", "spec")

        async def one_pass():
            engine.clear_kv_blocks()
            await _collect(engine, warm)
            torch.cuda.synchronize()
            engine.dispatch_trace = trace = []
            t0 = time.perf_counter()
            tasks = {n: asyncio.ensure_future(_collect(engine, r))
                     for n, r in wave.items()}
            await asyncio.gather(*[t for n, t in tasks.items() if n != LONG_ROW])
            seen = len(trace)
            while not any(in_flight(e) for e in trace[seen:]):
                if time.perf_counter() - t0 > 300 or tasks[LONG_ROW].done():
                    fail(f"device_loop {arm}: no decode block of the long "
                         "row in flight to send the arrival into")
                await asyncio.sleep(0.002)
            tasks["F_arrival"] = asyncio.ensure_future(_collect(engine, arrival))
            res = {n: await t for n, t in tasks.items()}
            torch.cuda.synchronize()
            engine.dispatch_trace = None
            return res, trace, time.perf_counter() - t0

        async def run():
            # warm-up, twice: when the arrival lands decides which (rung,
            # variant, width) keys a pass visits, and two passes see the
            # set the measured pass needs (the JAX tests warm twice too)
            await one_pass()
            await one_pass()
            g = engine.graphs
            captures0, replays0 = g.captures, g.replays
            ca.reset_launches()
            for k in g.replayed_launches:
                g.replayed_launches[k] = 0
            m0 = engine.metrics()
            res, trace, wall = await one_pass()
            measured = {
                "launches": dict(ca.LAUNCHES),
                "replayed_launches": dict(g.replayed_launches),
                "new_captures": g.captures - captures0,
                "replays": g.replays - replays0,
                "last_key": repr(g.last_key),
                "replay_equal": g.check_replay(
                    g.last_key, ["packed"] if g.last_key[0] == "spec"
                    else ["packed", "tok"]),
            }
            m1 = engine.metrics()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _, _, traced_wall = await one_pass()
            await engine.shutdown()
            return res, trace, wall, measured, m0, m1, device_breakdown(
                prof, traced_wall)

        res, trace, wall, measured, m0, m1, breakdown = asyncio.run(run())
        for name, r in res.items():
            want = LONG_TOKENS if name == LONG_ROW else 32
            if r["finish_reason"] != "length" or len(r["tokens"]) != want:
                fail(f"device_loop {arm}: {name} ended {r['finish_reason']} "
                     f"with {len(r['tokens'])} tokens")
            if not all(0 <= t < cfg.vocab_size for t in r["tokens"]):
                fail(f"device_loop {arm}: {name} produced out-of-vocab tokens")
        tokens[arm] = {n: r["tokens"] for n, r in res.items()}
        # tokens/s over phase 4's five prompts, as phase 4 counts it
        wave_rows = [r for n, r in res.items() if n not in ("F_arrival", LONG_ROW)]
        first = min(r["t_first"] for r in wave_rows)
        last = max(r["t_last"] for r in wave_rows)
        decoded = sum(len(r["tokens"]) - 1 for r in wave_rows)
        card = card_line()
        emit({"phase": "device_loop", "arm": arm, "config": over,
              "what": "latency", "requests": len(res), "wall_s": wall,
              "ttft_ms": {n: r["ttft_ms"] for n, r in res.items()},
              "itl_ms": {n: (r["t_last"] - r["t_first"]) / (len(r["tokens"]) - 1) * 1e3
                         for n, r in res.items()},
              "decode_tokens_per_s": decoded / (last - first),
              "dispatches": {k: sum(e["kind"] == k for e in trace)
                             for k in {e["kind"] for e in trace}},
              "card": card})
        emit({"phase": "device_loop", "arm": arm, "what": "trace",
              "traced_pass": breakdown, "card": card})
        emit({"phase": "device_loop", "arm": arm, "what": "graphs",
              **engine.graphs.stats(), "new_captures_in_measured_pass":
              measured["new_captures"], "replays_in_measured_pass":
              measured["replays"], "per_graph": engine.graphs.graph_stats()})
        delta = {k: v - getattr(m0, k) for k, v in vars(m1).items()
                 if k.startswith(("decode_cc_", "spec_")) and isinstance(v, int)}
        emit({"phase": "device_loop", "arm": arm, "what": "counters",
              "measured_pass": delta,
              "decode_cc_fallout_total": m1.decode_cc_fallout_total,
              "spec_acceptance_rate": m1.spec_acceptance_rate,
              "chunk_rows_fed_blocks": sum(e.get("chunk_rows", 0) > 0
                                           for e in trace),
              "rungs": engine.rung_histogram})
        emit({"phase": "device_loop", "arm": arm, "what": "launches",
              "launches": measured["launches"],
              "through_replays": measured["replayed_launches"],
              "replay_check": {"key": measured["last_key"],
                               "bit_equal": measured["replay_equal"]}})
        launches_by_arm[arm] = measured["launches"]
        rl = measured["replayed_launches"]
        if not all(measured["replay_equal"].values()):
            fail(f"device_loop {arm}: a replayed block differs from its "
                 f"uncaptured run: {measured['replay_equal']}")
        if measured["new_captures"]:
            fail(f"device_loop {arm}: {measured['new_captures']} graphs "
                 "captured after the warm-up pass")
        if rl["decode_attention"] <= 0 or measured["launches"]["prefill_attention"] <= 0:
            fail(f"device_loop {arm}: a kernel did not launch: {measured}")
        if arm.startswith("c_") and not (delta["decode_cc_blocks_total"] > 0 and any(
                e.get("chunk_rows", 0) > 0 for e in trace)):
            fail(f"device_loop {arm}: the arrival never rode the chain as chunk rows")
        if arm.startswith("d_") and not (delta["spec_dispatches_total"] > 0
                                         and rl["prefill_attention"] > 0):
            fail(f"device_loop {arm}: no verify block ran")
        del engine
        gc.collect()
        torch.cuda.empty_cache()

    # the greedy rows across arms
    ref = tokens["a_steps1"]
    prompts = {n: r["token_ids"] for n, r in wave.items()}
    prompts["F_arrival"] = arrival["token_ids"]
    equal, flips = {}, {}
    for arm in DEVICE_LOOP_ARMS:
        if arm == "a_steps1":
            continue
        for n in (*GREEDY_ROWS, "F_arrival", SEEDED_ROW):
            # (b) runs every row's arithmetic of (a); (c) too, but for the
            # arrival, which it feeds through chunk rows.  The seeded row
            # is held exactly there: its tokens ride the counter carried
            # between chained replays and the noise captured in the graphs
            exact = arm.startswith("b_") or (arm.startswith("c_")
                                             and n != "F_arrival")
            same = tokens[arm][n] == ref[n]
            equal[f"{arm}/{n}"] = same
            if same:
                continue
            if exact:
                fail(f"device_loop: {arm} {n} differs from arm (a) though it "
                     "ran the same arithmetic")
            if n == SEEDED_ROW:
                # (d) samples it from the verify's logits, a different
                # bf16 arithmetic; a sampled token has no greedy margin
                flips[f"{arm}/{n}"] = {"index": next(
                    (i for i, (a, b) in enumerate(zip(ref[n], tokens[arm][n]))
                     if a != b), None), "margin_std": None, "sampled": True}
                continue
            flip = first_flip(model, cfg, prompts[n], ref[n], tokens[arm][n])
            flips[f"{arm}/{n}"] = flip
            if flip["margin_std"] is None or abs(flip["margin_std"]) > LOGIT_TOL:
                fail(f"device_loop: {arm} {n} flips beyond a near-tie: {flip}")
    emit({"phase": "device_loop", "what": "greedy_rows_across_arms",
          "equal_to_a": equal, "flips": flips, "tol_in_std": LOGIT_TOL})
    spec_accepting(cfg)
    return launches_by_arm


def spec_accepting(cfg):
    """Arm (d) where its drafts are accepted, which random weights never
    allow: a 2-layer model at full width (phase 4's sharpened weights)
    whose LM head is its own embedding, scaled, with the columns of a few
    tokens rotated along a cycle, so greedy decoding after a prompt that
    ends on the cycle walks it and the n-gram drafts match.  A 3-cycle
    gives three accepted drafts a verify and rejects the fourth (its KV
    slot is written, then overwritten by the next verify); a 4-cycle
    accepts all four and samples the fifth token from the verify's last
    position.  Each request runs through a fresh one-step engine and a
    fresh k-4 speculative one: the same tokens, accepted drafts, verify
    graphs launching the prefill kernel, and the KV the verifies wrote --
    at every position both engines fed, in every layer -- equal to the KV
    the one-step decode wrote, within RTOL of the layer's largest value (a
    fresh engine hands its one sequence pages 1, 2, ... in order, so a
    position has the same slot in both pools).  Layer 1's KV comes from
    layer 0's attention, so it also reads back what earlier verifies
    wrote."""
    import dataclasses
    import math

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models import init_params
    from dynamo_tpu_torch.ops import cuda_attention as ca

    small = dataclasses.replace(cfg, num_hidden_layers=2)
    model = init_params(small, torch.Generator(device="cuda").manual_seed(SEED + 8),
                        dtype=torch.bfloat16, device="cuda")
    sharpen(model)
    g = torch.Generator().manual_seed(SEED + 9)
    ids = torch.randperm(cfg.vocab_size, generator=g).tolist()
    cycles = {3: ids[:3], 4: ids[3:7]}
    prompts = {n: ids[100 + 64 * n:164 + 64 * n] + [c[0]] for n, c in cycles.items()}
    with torch.no_grad():
        model.lm_head.copy_(model.embed.t() / math.sqrt(cfg.hidden_size))
        for c in cycles.values():  # token c[i] scores c[i+1] first
            model.lm_head[:, c[1:] + c[:1]] = model.lm_head[:, c].clone()

    def serve(over, prompt):
        ecfg = EngineConfig(page_size=16, num_pages=64, max_num_seqs=8,
                            max_prefill_tokens=512, max_model_len=4096, **over)
        engine = TorchEngine(small, model, ecfg, device="cuda")

        async def run():
            r = await _collect(engine, _req(prompt, max_tokens=64))
            await engine.shutdown()
            return r

        r = asyncio.run(run())
        torch.cuda.synchronize()
        m = engine.metrics()
        fed = len(prompt) + len(r["tokens"]) - 1  # positions both engines wrote
        kv = {n: t[:, 1:].reshape(small.num_hidden_layers, -1,
                                  *t.shape[3:])[:, :fed].float()
              for n, t in (("k", engine.kv.k), ("v", engine.kv.v))}
        return {"tokens": r["tokens"], "kv": kv, "fed": fed,
                "accepted": m.spec_accepted_tokens_total,
                "drafted": m.spec_draft_tokens_total,
                "verifies": m.spec_dispatches_total,
                "replayed_launches": dict(engine.graphs.replayed_launches)}

    results = []
    for n, prompt in prompts.items():
        one = serve(dict(decode_steps=1), prompt)
        spec = serve(dict(speculative_ngram_k=4), prompt)
        kv_err = {f"{k}{layer}": ((spec["kv"][k][layer] - one["kv"][k][layer]).abs().max()
                                  / one["kv"][k][layer].abs().max()).item()
                  for k in ("k", "v") for layer in range(small.num_hidden_layers)}
        res = {"phase": "device_loop", "what": "spec_accepting", "cycle": n,
               "tokens_equal": spec["tokens"] == one["tokens"],
               "distinct_tokens": len(set(one["tokens"])),
               "accepted": spec["accepted"], "drafted": spec["drafted"],
               "verifies": spec["verifies"], "positions_compared": one["fed"],
               "kv_max_rel_err": kv_err, "rtol": RTOL[torch.bfloat16],
               "replayed_launches": spec["replayed_launches"]}
        emit(res)
        results.append(res)
        del one, spec
    del model
    torch.cuda.empty_cache()
    for res in results:
        if not res["tokens_equal"]:
            fail(f"spec_accepting: the speculative tokens differ from one-step decode: {res}")
        if res["accepted"] <= 0 or res["replayed_launches"]["prefill_attention"] <= 0:
            fail(f"spec_accepting: no draft accepted through a verify graph: {res}")
        if max(res["kv_max_rel_err"].values()) > res["rtol"]:
            fail(f"spec_accepting: the KV the verifies wrote differs: {res}")
    return results


# --------------------------------------------------------------------------- #
# phase 9: KV off the device
# --------------------------------------------------------------------------- #

KV_ROOT = os.path.join(ROOT, "build", "kv_tiers")
TRANSFER_PAGES = 128  # a 2048-token prompt at page 16: 256 MiB of K+V at 8B
TRANSFER_ITERS = 4


def _gbps(nbytes, seconds):
    return nbytes / seconds / 1e9


def kv_transfers(cfg, model):
    """(a) Export 128 pages to host memory and import them into 128 other
    pages, then export those: equal bytes, same pool storage.  Times the
    engine's design (host blocks in page-locked memory: the park's one
    tensor per plane, and the offload drain's tensor per block) against
    ordinary host memory behind one pinned staging buffer per direction,
    each direction from a synchronised start to its last copy landing."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.kvbm.host_pool import fetch_blocks, to_host

    n = TRANSFER_PAGES
    engine = TorchEngine(cfg, model, EngineConfig(
        page_size=16, num_pages=2 * n + 1, max_num_seqs=1,
        max_prefill_tokens=512, max_model_len=4096), device="cuda")
    kv = engine.kv
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    for t in (kv.k, kv.v):
        t[:, 1:n + 1].copy_(torch.randn(t[:, 1:n + 1].shape, generator=g,
                                        device="cuda", dtype=t.dtype))
    ptrs = (kv.k.data_ptr(), kv.v.data_ptr())
    src, dst = list(range(1, n + 1)), list(range(n + 1, 2 * n + 1))
    nbytes = 2 * kv.k[:, :n].numel() * kv.k.element_size()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    shape = kv.k[:, :n].shape
    stage_d2h = torch.empty((2, *shape), dtype=kv.k.dtype, pin_memory=True)
    stage_h2d = torch.empty((2, *shape), dtype=kv.k.dtype, pin_memory=True)

    def d2h_staged():
        k, v = engine._export_dev(src)  # noqa: SLF001
        stage_d2h[0].copy_(k, non_blocking=True)
        stage_d2h[1].copy_(v, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        out = torch.empty(stage_d2h.shape, dtype=stage_d2h.dtype)  # ordinary
        out.copy_(stage_d2h)
        return out

    def h2d_staged(host):
        stage_h2d.copy_(host)
        dev = stage_h2d.to("cuda", non_blocking=True)
        engine._import_dev(dst, dev[0], dev[1])  # noqa: SLF001

    def d2h_blocks():
        return fetch_blocks(*engine._export_dev(src))  # noqa: SLF001

    times = {k: [] for k in ("d2h_pinned", "h2d_pinned", "d2h_pinned_blocks",
                             "h2d_pinned_blocks", "d2h_staged", "h2d_staged")}
    first = None
    for it in range(TRANSFER_ITERS):
        host, s = timed(lambda: to_host(list(engine._export_dev(src))))  # noqa: SLF001
        times["d2h_pinned"].append(s)
        if first is None:
            first = [h.clone() for h in host]
        _, s = timed(lambda: engine._import_dev(dst, *host))  # noqa: SLF001
        times["h2d_pinned"].append(s)
        again = to_host(list(engine._export_dev(dst)))  # noqa: SLF001
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            fail("kv_tiers: pages imported from pinned host memory differ "
                 "from their export")
        blocks, s = timed(d2h_blocks)
        times["d2h_pinned_blocks"].append(s)
        _, s = timed(lambda: engine._import_blocks(dst, *blocks))  # noqa: SLF001
        times["h2d_pinned_blocks"].append(s)
        staged, s = timed(d2h_staged)
        times["d2h_staged"].append(s)
        _, s = timed(lambda: h2d_staged(staged))
        times["h2d_staged"].append(s)
        again = to_host(list(engine._export_dev(dst)))  # noqa: SLF001
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            fail("kv_tiers: pages imported through the staged path or per "
                 "block differ from their export")
    if (kv.k.data_ptr(), kv.v.data_ptr()) != ptrs:
        fail("kv_tiers: an import reallocated the KV pool")
    # graph captures empty the device allocator's cache: does that drop
    # the page-locked host memory the caching host allocator holds too?
    del host, again, blocks
    torch.cuda.empty_cache()
    _, after_empty = timed(lambda: to_host(list(engine._export_dev(src))))  # noqa: SLF001
    del engine, kv
    # the first iteration pays the page-locked allocations; the rest reuse
    # the caching host allocator's blocks
    out = {"what": "transfers", "pages": n, "bytes": nbytes,
           "iters": TRANSFER_ITERS, "pool_storage_unchanged": True,
           "exports_equal": True}
    for k, ts in times.items():
        out[f"{k}_gbps_first"] = _gbps(nbytes, ts[0])
        out[f"{k}_gbps"] = _gbps(nbytes, sorted(ts[1:])[len(ts[1:]) // 2])
        out[f"{k}_ms"] = [t * 1e3 for t in ts]
    out["d2h_pinned_after_empty_cache_gbps"] = _gbps(nbytes, after_empty)
    return out


async def _storm(engine, victim, inter, after):
    """Send `inter` once `victim` has streamed `after` tokens.  Returns
    (victim result, interactive result, finish order)."""
    order, inter_task = [], None
    t0 = time.perf_counter()
    toks, reason, t_first = [], None, None

    async def run_inter():
        out = await _collect(engine, inter)
        order.append("interactive")
        return out

    async for d in engine.generate(victim):
        if d["token_ids"] and t_first is None:
            t_first = time.perf_counter()
        toks.extend(d["token_ids"])
        reason = d["finish_reason"]
        if inter_task is None and len(toks) >= after:
            inter_task = asyncio.ensure_future(run_inter())
    order.append("victim")
    if inter_task is None:
        fail("kv_tiers: the park victim never reached mid-decode")
    return ({"tokens": toks, "finish_reason": reason,
             "ttft_ms": (t_first - t0) * 1e3}, await inter_task, order)


PARK_ARMS = {
    "greedy": ({}, 0.0, None, 2),
    # the same again on the same engine: its graphs are captured and the
    # first park's page-locked memory is back in the caching host
    # allocator, so this park times the copy alone
    "greedy_again": ({}, 0.0, None, 2),
    "seeded": ({}, 0.8, 7, 2),
    # no prefix cache: the victim's full pages cannot be found again in
    # the device cache at resume, so all of them come back from the lot
    "greedy_full_import": (dict(enable_prefix_caching=False), 0.0, None, 2),
    # past the fused chain (1 + 2 blocks of 8), so the arrival lands in the
    # running continuous loop
    "continuous": (dict(decode_steps=8, decode_chain=2, decode_continuous=True),
                   0.0, None, 24),
}


def park_resume(cfg, model):
    """(b) One decode slot, one-step graphs: a batch victim (1224-token
    prompt, 64 tokens) mid-decode when a 64-token interactive request
    arrives, twice greedy, once seeded at 0.8, once greedy with no prefix
    cache (every page comes back from the lot), once in the continuous
    loop; each against an uncontended run of the same engine from the
    same (empty) cache."""
    import gc

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine

    g = torch.Generator().manual_seed(SEED + 10)
    victim_prompt = torch.randint(0, cfg.vocab_size, (1224,), generator=g).tolist()
    inter = _req(torch.randint(0, cfg.vocab_size, (64,), generator=g).tolist(),
                 max_tokens=16)
    results = []

    async def run(engine, victim, after):
        engine.clear_kv_blocks()
        oracle = await _collect(engine, victim)
        engine.clear_kv_blocks()
        m0 = engine.metrics()
        engine.dispatch_trace = trace = []
        got, inter_out, order = await _storm(engine, victim, inter, after)
        torch.cuda.synchronize()
        engine.dispatch_trace = None
        return oracle, got, inter_out, order, trace, m0, engine.metrics()

    async def arms():
        engines, out = {}, {}
        for arm, (over, temp, seed, after) in PARK_ARMS.items():
            key = tuple(sorted(over.items()))
            if key not in engines:
                engines[key] = TorchEngine(cfg, model, EngineConfig(
                    page_size=16, num_pages=1024, max_num_seqs=1,
                    max_prefill_tokens=512, max_model_len=4096, **over),
                    device="cuda")
            victim = _req(victim_prompt, temperature=temp, seed=seed,
                          max_tokens=64)
            victim["priority"] = "batch"
            out[arm] = (engines[key], *await run(engines[key], victim, after))
        for engine in engines.values():
            await engine.shutdown()
        return out

    for arm, (engine, oracle, got, inter_out, order, trace, m0,
              m1) in asyncio.run(arms()).items():
        parked = m1.preempted_total - m0.preempted_total
        resumed = m1.resumed_total - m0.resumed_total
        fallout = (m1.decode_cc_fallout_total.get("preempted", 0)
                   - m0.decode_cc_fallout_total.get("preempted", 0))
        moves = [{k: e[k] for k in ("kind", "pages", "ms", "cached") if k in e}
                 for e in trace if e["kind"] in ("park", "resume")]
        row = {"what": "park_resume", "arm": arm, "config": PARK_ARMS[arm][0],
               "victim_tokens_equal_oracle": got["tokens"] == oracle["tokens"],
               "preempted": parked, "resumed": resumed,
               "parked_seqs_after": m1.parked_seqs,
               "parked_pages_after": m1.parked_pages,
               "finish_order": order, "moves": moves,
               "interactive_ttft_ms": inter_out["ttft_ms"],
               "victim_ttft_ms": got["ttft_ms"],
               "fallout_preempted": fallout, "card": card_line()}
        emit({"phase": "kv_tiers", **row})
        results.append(row)
        if got["tokens"] != oracle["tokens"] or got["finish_reason"] != "length":
            fail(f"kv_tiers park {arm}: the resumed victim's tokens differ "
                 "from the uncontended run")
        if not parked >= 1 or parked != resumed:
            fail(f"kv_tiers park {arm}: preempted {parked}, resumed {resumed}")
        if m1.parked_seqs or m1.parked_pages or len(engine.parking):
            fail(f"kv_tiers park {arm}: the parking lot is not empty")
        if order != ["interactive", "victim"]:
            fail(f"kv_tiers park {arm}: finish order {order}")
        if arm == "continuous" and fallout < 1:
            fail("kv_tiers park continuous: no chain fell out with reason "
                 f"preempted: {m1.decode_cc_fallout_total}")
        if inter_out["finish_reason"] != "length" or len(inter_out["tokens"]) != 16:
            fail(f"kv_tiers park {arm}: the interactive request ended "
                 f"{inter_out['finish_reason']}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return results


TIER_PROMPT = 2049  # 128 full pages + 1 token
TIER_FILLERS = 3


def tier_prompts(cfg):
    """The tier phase's prompt, fillers and warm-up prompt, 2049 tokens
    each.  The prompt's 128 full pages (256 MiB of K+V at 8B) onboard, and
    the cold run's last prefill chunk is the same single token the cached
    runs compute, so every run does the same arithmetic and greedy tokens
    must be equal."""
    g = torch.Generator().manual_seed(SEED + 11)
    prompts = [torch.randint(0, cfg.vocab_size, (TIER_PROMPT,), generator=g).tolist()
               for _ in range(TIER_FILLERS + 2)]
    return prompts[0], prompts[1:-1], prompts[-1]


def kv_tier_runs(cfg, model):
    """(c) A 256-page pool: the prompt cold with no tier, then with a 2 GiB
    host tier and a disk tier: cold, device-cache hit, and after filler
    prompts evicted it, onboarded from host; then with a host tier of 4
    blocks, cold and onboarded from disk.  Every engine serves a warm-up
    prompt first.  Every offload must land."""
    import gc
    import shutil

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.kvbm import DiskTier, HostBlockPool, TieredKvCache

    prompt, fillers, warm_prompt = tier_prompts(cfg)
    target = _req(prompt, max_tokens=32)
    # captures the engine's decode graphs at the prompt's table width, so
    # no timed run pays a capture
    warm = _req(warm_prompt, max_tokens=4)
    shutil.rmtree(KV_ROOT, ignore_errors=True)
    block_bytes = 2 * cfg.num_hidden_layers * 16 * cfg.num_key_value_heads \
        * cfg.head_dim_ * 2

    def engine_with(tiered):
        return TorchEngine(cfg, model, EngineConfig(
            page_size=16, num_pages=256, max_num_seqs=8,
            max_prefill_tokens=512, max_model_len=4096), device="cuda",
            tiered=tiered)

    def itl_ms(r):
        return (r["t_last"] - r["t_first"]) / (len(r["tokens"]) - 1) * 1e3

    async def drained(tiered):
        t0 = time.perf_counter()
        while tiered.offload_backlog:
            if time.perf_counter() - t0 > 120:
                fail(f"kv_tiers: offloads stuck: {tiered.offload_backlog}")
            await asyncio.sleep(0.005)

    async def offload_off():
        engine = engine_with(None)
        await _collect(engine, warm)
        r = await _collect(engine, target)
        await engine.shutdown()
        return r

    async def tiers(host_bytes, disk_dir, with_hit):
        tiered = TieredKvCache(HostBlockPool(capacity_bytes=host_bytes),
                               DiskTier(disk_dir))
        engine = engine_with(tiered)
        committed = set()
        engine.add_event_sink(lambda ev: committed.update(ev.block_hashes)
                              if ev.kind == "stored" else None)
        await _collect(engine, warm)
        await drained(tiered)
        engine.dispatch_trace = trace = []
        runs = {}
        cached = engine.pool._cached  # noqa: SLF001 — hash → page
        before = set(cached)
        runs["cold"] = await _collect(engine, target)
        await drained(tiered)
        hashes = sorted(set(cached) - before, key=cached.get)  # the prompt's
        ref = engine.export_cached_blocks(hashes)
        if with_hit:
            runs["device_hit"] = await _collect(engine, target)
            await drained(tiered)
        for f in fillers:
            await _collect(engine, _req(f, max_tokens=1))
            await drained(tiered)
        if any(engine.pool.cached_page(h) is not None for h in hashes):
            fail("kv_tiers: the fillers left the prompt's pages cached")
        onboard0 = tiered.onboarded_blocks
        host_hits0 = tiered.host.hits
        disk_hits0 = tiered.disk.hits
        runs["onboard"] = await _collect(engine, target)
        await drained(tiered)
        back = engine.export_cached_blocks(ref[0])
        engine.dispatch_trace = None
        m = engine.metrics()
        await engine.shutdown()
        same = (back[0] == ref[0] and torch.equal(back[1], ref[1])
                and torch.equal(back[2], ref[2]))
        return {
            "runs": runs, "committed": len(committed),
            "offloaded": tiered.offloaded_blocks,
            "landed": sum(h in tiered.host or tiered.disk.has_verified(h)
                          for h in committed),
            "onboarded": tiered.onboarded_blocks - onboard0,
            "host_hits": tiered.host.hits - host_hits0,
            "disk_hits": tiered.disk.hits - disk_hits0,
            "disk_blocks": len(tiered.disk), "host_blocks": len(tiered.host),
            "bytes_equal": same, "kvbm_metrics": {
                k: v for k, v in vars(m).items() if k.startswith("kvbm_")},
            "onboard_moves": [{k: e[k] for k in ("pages", "ms")}
                              for e in trace if e["kind"] == "onboard"],
        }

    off = asyncio.run(offload_off())
    host = asyncio.run(tiers(2 << 30, os.path.join(KV_ROOT, "host_run"), True))
    disk = asyncio.run(tiers(4 * block_bytes, os.path.join(KV_ROOT, "disk_run"),
                             False))
    gc.collect()
    torch.cuda.empty_cache()
    tokens = {"cold_no_tier": off["tokens"],
              **{f"host_tier_{k}": r["tokens"] for k, r in host["runs"].items()},
              **{f"disk_tier_{k}": r["tokens"] for k, r in disk["runs"].items()}}
    ref_tokens = off["tokens"]
    row = {
        "what": "tiers", "prompt_tokens": TIER_PROMPT, "fillers": TIER_FILLERS,
        "ttft_ms": {"cold_no_tier": off["ttft_ms"],
                    **{f"host_tier_{k}": r["ttft_ms"] for k, r in host["runs"].items()},
                    **{f"disk_tier_{k}": r["ttft_ms"] for k, r in disk["runs"].items()}},
        "itl_ms": {"offload_off": itl_ms(off),
                   "offload_on": itl_ms(host["runs"]["cold"]),
                   "offload_on_disk_run": itl_ms(disk["runs"]["cold"])},
        "tokens_equal": {k: t == ref_tokens for k, t in tokens.items()},
        **{f"{name}_{k}": v for name, res in (("host", host), ("disk", disk))
           for k, v in res.items() if k != "runs"},
        "card": card_line(),
    }
    emit({"phase": "kv_tiers", **row})
    if not all(row["tokens_equal"].values()):
        fail(f"kv_tiers: tokens differ across runs: {row['tokens_equal']}")
    for name, res in (("host", host), ("disk", disk)):
        if res["onboarded"] < TIER_PROMPT // 16 - 1:
            fail(f"kv_tiers {name}: onboarded {res['onboarded']} blocks")
        if not (res["offloaded"] == res["committed"] == res["landed"]):
            fail(f"kv_tiers {name}: offloads dropped: committed "
                 f"{res['committed']}, offloaded {res['offloaded']}, landed "
                 f"{res['landed']}")
        if not res["bytes_equal"]:
            fail(f"kv_tiers {name}: onboarded blocks differ from the "
                 "blocks offloaded")
    if host["host_hits"] < TIER_PROMPT // 16 - 1:
        fail(f"kv_tiers: the host run onboarded from host {host['host_hits']} times")
    if disk["disk_hits"] < TIER_PROMPT // 16 - 1:
        fail(f"kv_tiers: the disk run read {disk['disk_hits']} blocks from disk")
    shutil.rmtree(KV_ROOT, ignore_errors=True)
    return row


def phase_kv_tiers(model, cfg):
    """Phase 9: (a) transfers, (b) park/resume, (c) host and disk tiers.
    Launches are counted over (b) and (c), the serving paths of the
    phase."""
    from dynamo_tpu_torch.ops import cuda_attention as ca

    t0 = time.perf_counter()
    transfers = kv_transfers(cfg, model)
    emit({"phase": "kv_tiers", **transfers, "card": card_line()})
    ca.reset_launches()
    park = park_resume(cfg, model)
    tier = kv_tier_runs(cfg, model)
    launches = dict(ca.LAUNCHES)
    if launches["decode_attention"] <= 0 or launches["prefill_attention"] <= 0:
        fail(f"kv_tiers: a kernel did not launch: {launches}")
    gb = {k: v for k, v in transfers.items() if k.endswith("_gbps")}
    emit({"phase": "kv_tiers", "what": "summary",
          "seconds": time.perf_counter() - t0, "transfer_gbps": gb,
          "park_ms": [m for r in park for m in r["moves"] if m["kind"] == "park"],
          "resume_ms": [m for r in park for m in r["moves"] if m["kind"] == "resume"],
          "interactive_ttft_ms": {r["arm"]: r["interactive_ttft_ms"] for r in park},
          "tier_ttft_ms": tier["ttft_ms"], "tier_itl_ms": tier["itl_ms"],
          "onboarded": {"host": tier["host_onboarded"],
                        "disk": tier["disk_onboarded"]},
          "launches": launches, "card": card_line()})
    return launches


# --------------------------------------------------------------------------- #
# phase 10: the KV-aware router
# --------------------------------------------------------------------------- #

ROUTER_PREFIX = 1024  # 64 pages, the part each returning prompt shares
ROUTER_SUFFIX = 64
ROUTER_PREFIXES = 2
ROUTER_FILLERS = 5  # 2048-token prompts, 128 pages each: past a 511-page pool
ROUTER_HOST_BYTES = 2 << 30  # 1024 blocks: the fillers' 640 and the prefix
ROUTER_TOKENS = 16
ROUTER_WAIT_S = 60


def router_prompts(cfg):
    """Four 1024-token prefixes, each with a first and a second 64-token
    suffix, the fillers and two warm-up prompts, drawn from the seed."""
    g = torch.Generator().manual_seed(SEED + 21)

    def draw(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()

    prefixes = [draw(ROUTER_PREFIX) for _ in range(ROUTER_PREFIXES)]
    first = [p + draw(ROUTER_SUFFIX) for p in prefixes]
    again = [p + draw(ROUTER_SUFFIX) for p in prefixes]
    fillers = [draw(2048) for _ in range(ROUTER_FILLERS)]
    return prefixes, first, again, fillers, [draw(64), draw(64)]


def phase_kv_router(model, cfg):
    """Phase 10: two engines over the same weights (B served first, A
    second), each with its own 512-page pool, served by `serve_engine`;
    the frontend in `--router-mode kv` as a process of its own, another
    in round_robin for the contrast, and an observer `KvRouter` in this
    process on the same event stream.  Pre-tokenized greedy SSE
    /v1/completions of 16 tokens:

    1. ROUTER_PREFIXES (two) 1024-token prefixes with a first suffix, one
       at a time, cold;
    2. once the observer indexes each prefix's 64 blocks on one worker,
       each prefix with a second suffix: it must go to its holder
       (`prefix_cached_tokens_total` up by 1024, the observer's decision
       with 64 blocks of overlap);
    3. the same two through the round-robin frontend;

    then the observer's count per worker must equal its pool's cached
    hashes, and fall to 0 after `clear_kv_blocks` through each worker's
    control op.  4. A gets a host tier and a `TierSummaryPublisher`;
    prefix 0 with its first suffix goes straight into A (cold again: the
    round 1 tokens), filler prompts evict it from A's device pool, and
    prefix 0 with its second suffix, through the KV frontend, must go to A
    (which the router's tie-break never picks) by tier overlap, onboard
    64 blocks and give round 2's tokens.

    Two arms, the same rounds and checks: the control plane embedded in
    this process (the main path; its launches are the path's), then in a
    process of its own (`python -m dynamo_tpu_torch.runtime`), which
    takes its serving of the KV-event stream off the engines' process.
    Returns {arm: launches}."""
    return {cp: kv_router_arm(model, cfg, cp) for cp in ("embedded", "process")}


# vocabulary size -> (the synthetic tokenizer's JSON, its eos ids), made
# once for phase 10's two arms
_ROUTER_TOKENIZER = {}


def kv_router_arm(model, cfg, control):
    """One arm of phase 10 (see there) with the control plane `control`:
    ``"embedded"`` in this process, or ``"process"``."""
    import gc
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.kvbm import (
        HostBlockPool,
        TieredKvCache,
        TierSummaryPublisher,
    )
    from dynamo_tpu_torch.llm import ModelDeploymentCard
    from dynamo_tpu_torch.ops import cuda_attention as ca
    from dynamo_tpu_torch.router import KvRouter
    from dynamo_tpu_torch.router.worker_key import pack_worker
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.tokens import compute_block_hash_for_seq
    from dynamo_tpu_torch.worker import serve_engine

    t_phase = time.perf_counter()
    device = model.embed.device
    # only the frontends tokenize: this process keeps the card's JSON and
    # drops the tokenizer's millions of objects, whose traversal by a full
    # garbage collection would otherwise stall the step threads; both arms
    # take the one JSON
    if cfg.vocab_size not in _ROUTER_TOKENIZER:
        tok = llama_tokenizer(cfg)
        _ROUTER_TOKENIZER[cfg.vocab_size] = (tok.to_json_str(),
                                             list(tok.eos_token_ids))
        del tok
        gc.collect()
    tok_json, eos = _ROUTER_TOKENIZER[cfg.vocab_size]
    pauses = []  # full collections during the rounds: (start, ms)

    def on_gc(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                pauses.append([time.perf_counter(), None])
            elif pauses and pauses[-1][1] is None:
                pauses[-1][1] = (time.perf_counter() - pauses[-1][0]) * 1e3

    name = cfg.name
    prefixes, first, again, fillers, warm = router_prompts(cfg)
    ecfg = EngineConfig(page_size=16, num_pages=512, max_num_seqs=8,
                        max_prefill_tokens=512, max_model_len=4096)
    engines = {n: TorchEngine(cfg, model, ecfg, eos_token_ids=eos,
                              device=device) for n in ("B", "A")}
    # which engine served what: the worker calls engine.generate
    log = []

    def record(n, engine):
        inner = engine.generate

        async def generate(request, context=None):
            toks, t0, info = [], time.perf_counter(), {}
            async for d in inner(request, context):
                if d["token_ids"] and not toks:
                    info["engine_ttft_ms"] = (time.perf_counter() - t0) * 1e3
                if "ttft" in d:
                    info["attribution_ms"] = d["ttft"]
                toks.extend(d["token_ids"])
                yield d
            log.append((n, list(request["token_ids"]), toks, info))

        engine.generate = generate

    for n, e in engines.items():
        record(n, e)

    def hashes(toks):
        return compute_block_hash_for_seq(toks, 16)

    def body(toks):
        return {"model": name, "prompt": toks, "max_tokens": ROUTER_TOKENS,
                "temperature": 0.0, "nvext": {"ignore_eos": True}}

    async def run():
        loop = asyncio.get_running_loop()
        pool = ThreadPoolExecutor(max_workers=4)
        out = {"checks": {}}
        checks = out["checks"]

        async def until(cond, what):
            t0 = time.perf_counter()
            while not cond():
                if time.perf_counter() - t0 > ROUTER_WAIT_S:
                    fail(f"kv_router ({control}): timed out waiting for {what}")
                await asyncio.sleep(0.02)

        cp_proc = None
        if control == "embedded":
            rt_b = await DistributedRuntime.detached()
        else:
            cp_proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "dynamo_tpu_torch.runtime", "--host",
                "127.0.0.1", "--port", "0", "--log-level", "warning",
                cwd=ROOT, stdout=asyncio.subprocess.PIPE)
            ready = (await asyncio.wait_for(cp_proc.stdout.readline(), 120)).decode()
            if not ready.startswith("READY "):
                fail(f"kv_router ({control}): the control plane process printed {ready!r}")
            rt_b = await DistributedRuntime.connect(ready.split()[1])
        rt_a = await DistributedRuntime.connect(rt_b.control_address)
        addr = rt_b.control_address
        mdc = dict(tokenizer_json=tok_json, eos_token_ids=eos,
                   context_length=4096)
        served = {"B": await serve_engine(rt_b, engines["B"],
                                          ModelDeploymentCard(name=name, **mdc)),
                  "A": await serve_engine(rt_a, engines["A"],
                                          ModelDeploymentCard(name=name, **mdc))}
        iid = {n: s.instance.instance_id for n, s in served.items()}
        wid = {n: pack_worker(i) for n, i in iid.items()}
        fronts = {}
        front_rt = await DistributedRuntime.connect(addr)
        client = await front_rt.namespace("dynamo").component("backend") \
            .endpoint("generate").client().start()
        observer = None
        try:
            for mode in ("kv", "round_robin"):
                # one SSE frame a token: `send` counts the frames
                fronts[mode] = await asyncio.create_subprocess_exec(
                    sys.executable, "-m", "dynamo_tpu_torch.frontend",
                    "--control", addr, "--host", "127.0.0.1", "--port", "0",
                    "--router-mode", mode, "--no-sse-coalesce",
                    "--log-level", "warning", cwd=ROOT,
                    stdout=asyncio.subprocess.PIPE)
            # the first decode of each engine captures its graphs
            for n, prompt in zip(engines, warm):
                await _collect(engines[n], _req(prompt, max_tokens=4))
            await client.wait_for_instances()
            await until(lambda: len(client.instances()) == 2, "both workers")
            observer = await KvRouter(front_rt, "dynamo", "backend", client,
                                      block_size=16).start()
            ports = {}
            for mode, proc in fronts.items():
                ready = (await asyncio.wait_for(proc.stdout.readline(), 180)).decode()
                if not ready.startswith("READY http://"):
                    fail(f"kv_router ({control}): the {mode} frontend printed {ready!r}")
                ports[mode] = int(ready.strip().rsplit(":", 1)[1])
                for _ in range(1800):
                    st, models = await loop.run_in_executor(
                        pool, _http, ports[mode], "GET", "/v1/models")
                    if st == 200 and name.encode() in models:
                        break
                    await asyncio.sleep(0.1)
                else:
                    fail(f"kv_router ({control}): the {mode} frontend never listed {name}")

            def idle():
                """Each worker's latest load publication taken while it
                idled: one taken inside a request counts its 68 pages as
                load, as much as the 64-block overlap."""
                return len(observer.worker_states) == 2 and all(
                    st.kv_usage == 0 for st in observer.worker_states.values())

            timing = {}  # what the serving engine saw of chosen requests

            async def send(mode, toks, what=None):
                """One SSE request: (serving engine, tokens, TTFT ms).
                With `what`, the engine's own TTFT, its attribution and
                its dispatches (KV moves with their ms) go to `timing`."""
                await until(idle, "idle load publications")
                await asyncio.sleep(0.3)  # the frontend's router reads them too
                n = len(log)
                for e in engines.values():
                    e.dispatch_trace = [] if what else None
                st, _, finish, t0, stamps = await loop.run_in_executor(
                    pool, _http_stream, ports[mode], "/v1/completions",
                    body(toks))
                if st != 200 or finish != "length" or len(stamps) != ROUTER_TOKENS:
                    fail(f"kv_router ({control}): {mode} answered {st}, {finish}, "
                         f"{len(stamps)} tokens")
                await until(lambda: len(log) > n, "the worker's log")
                who, prompt, got, info = log[n]
                if prompt != toks:
                    fail(f"kv_router ({control}): the log holds another prompt")
                if what:
                    trace = engines[who].dispatch_trace
                    t_first = trace[0]["t"] if trace else 0.0
                    timing[what] = {**info, "dispatches": [
                        {k: (round((v - t_first) * 1e3, 3) if k == "t" else v)
                         for k, v in e.items() if k in ("kind", "t", "ms",
                                                        "pages", "n_steps")}
                        for e in trace[:12]]}
                    for e in engines.values():
                        e.dispatch_trace = None
                return who, got, (stamps[0] - t0) * 1e3

            async def decide(toks):
                await observer.choose({"token_ids": toks, "request_id": "obs"})
                observer.mark_finished("obs")
                d = observer.last_decision
                return {"worker": next(n for n, w in wid.items()
                                       if w == d.worker_id),
                        "overlap_blocks": d.overlap_blocks,
                        "tier_overlap_blocks": d.tier_overlap_blocks,
                        "costs": {n: d.costs.get(w) for n, w in wid.items()}}

            cached = {n: (lambda e=e: e.metrics().prefix_cached_tokens_total)
                      for n, e in engines.items()}
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            gc.callbacks.append(on_gc)
            ca.reset_launches()
            # round 1: cold, one at a time
            r1 = [await send("kv", p) for p in first]
            holder = [who for who, _, _ in r1]
            for i, p in enumerate(prefixes):
                await until(lambda p=p, i=i: observer.index.find_matches(
                    hashes(p)) == {wid[holder[i]]: 64},
                    f"prefix {i}'s 64 blocks on one worker")
            # round 2: each prefix again, with a new suffix
            r2, decisions2 = [], []
            for i, p in enumerate(again):
                await until(idle, "idle load publications")
                decisions2.append(await decide(p))
                c0 = cached[holder[i]]()
                r2.append(await send("kv", p, what=f"round2_{i}" if i == 0 else None)
                          + (cached[holder[i]]() - c0,))
            checks["round2_to_holder"] = [
                who == holder[i] for i, (who, _, _, _) in enumerate(r2)]
            checks["round2_cached_tokens"] = [c for *_, c in r2]
            checks["round2_observer"] = decisions2
            # round 3: the same through the round-robin frontend
            r3 = []
            for i, p in enumerate(again):
                c0 = {n: f() for n, f in cached.items()}
                who, got, ttft = await send("round_robin", p)
                r3.append((who, got, ttft, cached[who]() - c0[who]))
            # the index mirrors each pool, and a clear empties it
            for n, e in engines.items():
                await until(lambda n=n, e=e: observer.index.num_blocks(wid[n])
                            == len(e.pool._cached),  # noqa: SLF001
                            f"{n}'s index count == its pool's")
            checks["index_equals_pool"] = {
                n: observer.index.num_blocks(wid[n]) for n in engines}
            checks["cleared_pages"] = {}
            for n in ("A", "B"):
                outs = [o async for o in client.direct(
                    {"control": "clear_kv_blocks"}, iid[n])]
                checks["cleared_pages"][n] = outs[0]["pages_cleared"]
                await until(lambda n=n: observer.index.num_blocks(wid[n]) == 0,
                            f"{n}'s index count to fall to 0")
            # round 4: A's host tier holds prefix 0, its device pool not
            tiered = TieredKvCache(HostBlockPool(capacity_bytes=ROUTER_HOST_BYTES))
            engines["A"].attach_connector(tiered)
            served["A"].tier_summary_publisher = TierSummaryPublisher(
                rt_a, tiered, "dynamo", "backend", worker_id=wid["A"],
                interval_s=0.2).start()

            async def drained():
                await until(lambda: tiered.offload_backlog == 0, "offloads")

            rewarm = await _collect(engines["A"], _req(first[0],
                                                       max_tokens=ROUTER_TOKENS))
            checks["rewarm_equals_round1"] = rewarm["tokens"] == r1[0][1]
            await drained()
            for f in fillers:
                await _collect(engines["A"], _req(f, max_tokens=1))
                await drained()
            h0 = hashes(prefixes[0])
            checks["prefix_on_device_after_fillers"] = engines["A"].pool.peek(h0)
            checks["prefix_in_host_tier"] = sum(h in tiered.host for h in h0)
            await until(lambda: observer.index.find_matches(h0).get(wid["A"], 0) == 0
                        and observer.tier_index.find_matches(h0).get(wid["A"], 0)
                        == 64, "A's tier summary")
            await until(idle, "idle load publications")
            checks["round4_observer"] = await decide(again[0])
            onboard0 = tiered.onboarded_blocks
            r4 = await send("kv", again[0], what="round4")
            checks["round4_onboarded"] = tiered.onboarded_blocks - onboard0
            launches = dict(ca.LAUNCHES)
            gc.callbacks.remove(on_gc)
            out.update(r1=r1, r2=r2, r3=r3, r4=r4, launches=launches,
                       host_blocks=len(tiered.host), timing=timing)
        finally:
            for proc in fronts.values():
                if proc.returncode is None:
                    proc.terminate()
                    await asyncio.wait_for(proc.wait(), 60)
            pool.shutdown(wait=False)
            if observer is not None:
                await observer.stop()
            await client.stop()
            await front_rt.shutdown(graceful=False)
            await rt_a.shutdown(graceful=False)
            await rt_b.shutdown(graceful=False)
            if cp_proc is not None:
                cp_proc.terminate()
                await asyncio.wait_for(cp_proc.wait(), 60)
            for e in engines.values():
                await e.shutdown()
        return out

    out = asyncio.run(run())
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = out["checks"]
    r1, r2, r3, r4 = out["r1"], out["r2"], out["r3"], out["r4"]
    rr_hit = [t for _, _, t, c in r3 if c >= ROUTER_PREFIX]
    rr_miss = [t for _, _, t, c in r3 if c < ROUTER_PREFIX]
    ttft = {"round1_kv_cold": [t for _, _, t in r1],
            "round2_kv_hit": [t for _, _, t, _ in r2],
            "round3_rr_hit": rr_hit, "round3_rr_miss": rr_miss,
            "round4_kv_tier_onboard": [r4[2]]}
    row = {
        "phase": "kv_router", "control_plane": control, "model": name,
        "layers": cfg.num_hidden_layers,
        "seconds": time.perf_counter() - t_phase,
        "holders_round1": [who for who, _, _ in r1],
        "round2_served": [who for who, *_ in r2],
        "round3_served": [who for who, *_ in r3],
        "hits": {"round2_kv": sum(checks["round2_to_holder"]),
                 "round3_round_robin": len(rr_hit), "of": ROUTER_PREFIXES},
        "round4_served": r4[0],
        "round4_tokens_equal_round2": r4[1] == r2[0][1],
        **checks, "engine_side": out["timing"],
        "full_gc_pauses_ms": [ms for _, ms in pauses],
        "launches": out["launches"],
        "card": card_line(),
    }
    emit(row)
    print(json.dumps({"kv_router_ttft_ms": ttft, "control_plane": control,
                      "hits": row["hits"],
                      "card": card_line()}), flush=True)
    if not all(checks["round2_to_holder"]):
        fail(f"kv_router ({control}): a returning prompt missed its holder: went to "
             f"{row['round2_served']}, held by {row['holders_round1']}")
    if min(checks["round2_cached_tokens"]) < ROUTER_PREFIX:
        fail(f"kv_router ({control}): round 2 cached {checks['round2_cached_tokens']} tokens")
    for i, d in enumerate(checks["round2_observer"]):
        if d["overlap_blocks"] < 64 or d["worker"] != row["holders_round1"][i]:
            fail(f"kv_router ({control}): the observer decided {d} for prefix {i}")
    for n, c in checks["cleared_pages"].items():
        if c != checks["index_equals_pool"][n]:
            fail(f"kv_router ({control}): {n} cleared {c} pages, its index counted "
                 f"{checks['index_equals_pool'][n]}")
    if not checks["rewarm_equals_round1"]:
        fail(f"kv_router ({control}): prefix 0 served cold on A differs from round 1")
    if checks["prefix_on_device_after_fillers"] or checks["prefix_in_host_tier"] != 64:
        fail(f"kv_router ({control}): after the fillers A's device holds "
             f"{checks['prefix_on_device_after_fillers']} and its host tier "
             f"{checks['prefix_in_host_tier']} of prefix 0's 64 blocks")
    d4 = checks["round4_observer"]
    if d4["worker"] != "A" or d4["tier_overlap_blocks"] < 63:
        fail(f"kv_router ({control}): round 4's observer decided {d4}")
    if r4[0] != "A" or checks["round4_onboarded"] < 63:
        fail(f"kv_router ({control}): round 4 went to {r4[0]} and onboarded "
             f"{checks['round4_onboarded']} blocks")
    if not row["round4_tokens_equal_round2"]:
        fail(f"kv_router ({control}): round 4's tokens differ from round 2's")
    launches = out["launches"]
    if launches["decode_attention"] <= 0 or launches["prefill_attention"] <= 0:
        fail(f"kv_router ({control}): a kernel did not launch: {launches}")
    return launches


# --------------------------------------------------------------------------- #
# phase 12: disaggregated prefill/decode
# --------------------------------------------------------------------------- #

DISAGG_TOKENS = 16
# a prefill worker killed in (b) must stay discovered while the greedy
# prompts are resent, so that the decode handler dials it, fails and
# prefills locally: its lease outlives the resends
DISAGG_PREFILL_LEASE_S = 120


def disagg_prompts(cfg):
    """{name: tokens}: one prompt that stays local (64 tokens: not past
    the router's 64-token threshold), two greedy ones of 1088 (68 pages
    of 16, 34 of 32) and 2048 tokens, and one seeded of 1088."""
    g = torch.Generator().manual_seed(SEED + 12)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()

    return {"local_64": prompt(64), "greedy_1088": prompt(1088),
            "greedy_2048": prompt(2048), "seeded_1088": prompt(1088),
            # warm-ups of each remote length (graph captures on both
            # workers), never sent again: a prompt the prefill worker has
            # cached would prefill only its tail there, other chunks than a
            # cold local prefill
            "warm_1088": prompt(1088), "warm_2048": prompt(2048),
            "warm_seeded_1088": prompt(1088),
            # sent together in (b): the prefill worker computes one while
            # the decode worker reads another's pages
            "concurrent_2048": prompt(2048), "concurrent_1088": prompt(1088),
            "concurrent_1088b": prompt(1088)}


def _token_major(pool, pages, n):
    """The first n tokens of `pages` of a pool, token-major [L, n, kv, hd]."""
    L, _, ps, kvh, hd = pool.shape
    idx = torch.tensor(pages, device=pool.device)
    return pool.index_select(1, idx).reshape(L, len(pages) * ps, kvh, hd)[:, :n]


def disagg_colocated(model, cfg):
    """(a) Two `TorchEngine`s on phase 4's model in this process, the
    prefill worker served on an embedded control plane and the decode
    engine behind `DisaggDecodeHandler`, with pages 16/16 and 16/32.  A
    transfer by hand first (the colocated lane, then the host lane for
    comparison): the destination pages must equal the source's tokens bit
    for bit, zeros past the prompt.  Then the greedy prompts through the
    handler against an aggregated engine with the decode side's pages.
    Returns the launches of the handler's serving, per page pair."""
    from dynamo_tpu_torch.disagg import (
        DisaggDecodeHandler,
        KvTransferClient,
        serve_prefill_worker,
    )
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.llm import ModelDeploymentCard
    from dynamo_tpu_torch.ops import cuda_attention as ca
    from dynamo_tpu_torch.runtime import Context, DistributedRuntime

    device = model.embed.device
    greedy = {n: p for n, p in disagg_prompts(cfg).items()
              if n.startswith("greedy")}

    def ecfg(ps):
        return EngineConfig(page_size=ps, num_pages=4096 // ps + 64,
                            max_num_seqs=8, max_prefill_tokens=512,
                            max_model_len=4096)

    async def served(gen):
        t0 = time.perf_counter()
        toks, t_first = [], None
        async for d in gen:
            if d.get("finish_reason") == "error":
                fail(f"disagg: a request errored: {d}")
            if d["token_ids"] and t_first is None:
                t_first = time.perf_counter()
            toks.extend(d["token_ids"])
        return toks, (t_first - t0) * 1e3

    async def arm(ps_d):
        out = {"pages": f"16 -> {ps_d}"}
        agg = TorchEngine(cfg, model, ecfg(ps_d), device=device)
        want, local_ttft = {}, {}
        for n, p in greedy.items():
            await served(agg.generate(_req(p, max_tokens=4)))  # captures
            agg.clear_kv_blocks()
            want[n], local_ttft[n] = await served(
                agg.generate(_req(p, max_tokens=DISAGG_TOKENS)))
            agg.clear_kv_blocks()
        await agg.shutdown()
        rt = await DistributedRuntime.detached()
        rt_d = await DistributedRuntime.connect(rt.control_address)
        pe = TorchEngine(cfg, model, ecfg(16), device=device)
        de = TorchEngine(cfg, model, ecfg(ps_d), device=device)
        source = (await serve_prefill_worker(
            rt, pe, ModelDeploymentCard(name=cfg.name))).transfer_source
        handler = DisaggDecodeHandler(de, rt_d)
        try:
            # -- one 2048-token transfer by hand on each lane ------------- #
            p = greedy["greedy_2048"]
            lanes = {}
            for lane in ("colocated", "host"):
                r = await pe.prefill_remote(_req(p), Context(), transfer_source=source)
                desc = r["kv_descriptor"]
                held = source._held[desc["transfer_id"]].pages
                src = [_token_major(t, held, len(p)) for t in (pe.kv.k, pe.kv.v)]
                ca.reset_launches()
                client = KvTransferClient(de, lanes=(lane,))
                pages, st = await client.fetch(desc)
                torch.cuda.synchronize()
                n = len(pages) * ps_d
                dst = [_token_major(t, pages, n) for t in (de.kv.k, de.kv.v)]
                exact = all(torch.equal(_bits(d[:, :len(p)]), _bits(s))
                            for d, s in zip(dst, src))
                zeros = all(not d[:, len(p):].any() for d in dst)
                lanes[lane] = {"lane": st.lane, "ms": st.ms, "bytes": st.bytes,
                               "gb_per_s": st.bytes / st.ms / 1e6,
                               "dest_pages": st.dest_pages,
                               "kv_repage_launches": ca.LAUNCHES["kv_repage"],
                               "bit_exact": exact, "zeros_past_prompt": zeros}
                if not (exact and zeros):
                    fail(f"disagg (a): the {lane} lane's pages differ from the "
                         f"source's tokens: {lanes[lane]}")
                await de.free_pages(pages)
            if lanes["colocated"]["kv_repage_launches"] != 1:
                fail(f"disagg (a): the colocated lane did not launch kv_repage "
                     f"once: {lanes}")
            out["transfer_2048"] = lanes
            # -- the greedy prompts through the handler ------------------- #
            got, ttft = {}, {}
            ca.reset_launches()
            for n, p in greedy.items():
                de.clear_kv_blocks()
                pe.clear_kv_blocks()
                got[n], ttft[n] = await served(handler.generate(
                    _req(p, max_tokens=DISAGG_TOKENS), Context()))
            torch.cuda.synchronize()
            out["launches"] = dict(ca.LAUNCHES)
            for _ in range(100):
                if source.held_pages == 0:
                    break
                await asyncio.sleep(0.01)
            m = vars(handler.metrics())
            out.update({
                "remote_ttft_ms": ttft, "local_ttft_ms": local_ttft,
                "lanes": {k: m[f"kv_transfer_{k}_count"]
                          for k in ("device", "ipc", "host")},
                "prefill_fallback_total": m["prefill_fallback_total"],
                "held_pages_after": source.held_pages,
                "flips": {n: first_flip(model, cfg, greedy[n], want[n], got[n])
                          for n in greedy},
            })
        finally:
            await handler.shutdown()
            await rt_d.shutdown(graceful=False)
            await rt.shutdown(graceful=False)
            await pe.shutdown()
        if out["lanes"]["device"] != len(greedy) or out["prefill_fallback_total"]:
            fail(f"disagg (a): not every prompt rode the colocated lane: {out}")
        if out["held_pages_after"]:
            fail(f"disagg (a): the prefill engine still holds pages: {out}")
        if out["launches"]["kv_repage"] != len(greedy):
            fail(f"disagg (a): kv_repage launches {out['launches']}")
        for n, f in out["flips"].items():
            if f is not None and (f["margin_std"] is None
                                  or abs(f["margin_std"]) > LOGIT_TOL):
                fail(f"disagg (a): {n} parts from the aggregated engine beyond "
                     f"a near-tie: {f}")
        return out

    res = {ps_d: asyncio.run(arm(ps_d)) for ps_d in (16, 32)}
    for ps_d, r in res.items():
        emit({"phase": "disagg", "what": "colocated", **r, "card": card_line()})
    return {f"16 -> {ps_d}": r["launches"] for ps_d, r in res.items()}


def disagg_processes(cfg, layers=None, device="cuda"):
    """(b) The normal entry points as processes: the control plane, `python
    -m dynamo_tpu_torch.worker --disagg-role prefill` and `--disagg-role
    decode` (the model from `--seed`), and the frontend.  Pre-tokenized
    SSE /v1/completions, each from a cleared decode cache: the 64-token
    prompt (local), the greedy prompts and the seeded one (remote, every
    one on the ipc lane, no fallback, the prefill pool released after).
    Then three fresh greedy prompts at once, so that the prefill worker
    computes one while the decode worker reads another's pages: each on
    the ipc lane, no fallback, the pool released, and the transfer time
    under that load.  Then the prefill worker is killed (its lease
    outlives the resends) and the greedy prompts go again: prefilled
    locally, counted as fallbacks, the same text.  Returns the decode
    worker's kernel launches over the remote round."""
    from concurrent.futures import ThreadPoolExecutor

    procs = []
    lane = "ipc" if device == "cuda" else "host"
    extra = (["--num-layers", str(layers)] if layers else []) + [
        "--device", device, "--log-level", "warning"]

    def spawn(*args, env=None):
        return _spawn(procs, *args, env=env)

    def ready(p, prefix, what, timeout=600):
        return _ready(p, prefix, f"disagg (b): {what}", timeout)

    def status(port):
        st, raw = _http(port, "GET", "/metrics.json")
        if st != 200:
            fail(f"disagg (b): /metrics.json answered {st}")
        return json.loads(raw)

    def released(port):
        """The prefill worker's status once its holds are gone (the
        release frame may trail the answer)."""
        for _ in range(100):
            st = status(port)
            if st.get("kv_transfer_held_pages", 1) == 0:
                break
            time.sleep(0.05)
        return st

    prompts = disagg_prompts(cfg)
    warm = [n for n in prompts if n.startswith("warm")]
    concurrent = [n for n in prompts if n.startswith("concurrent")]
    measured = [n for n in prompts if n not in warm + concurrent]

    def body(name):
        b = {"model": cfg.name, "prompt": prompts[name], "max_tokens": DISAGG_TOKENS,
             "temperature": 0.0, "nvext": {"ignore_eos": True}}
        if "seeded" in name:
            b.update(temperature=0.8, seed=11)
        return b

    def clear(port):
        st, _ = _http(port, "POST", "/clear_kv_blocks")
        if st != 200:
            fail(f"disagg (b): /clear_kv_blocks answered {st}")

    def send(port, name, cleared=True):
        if cleared:
            clear(port)
        st, text, finish, t0, stamps = _http_stream(port, "/v1/completions",
                                                    body(name))
        if st != 200 or finish != "length" or len(stamps) < 1:
            fail(f"disagg (b): {name} answered {st}, {finish!r}")
        return {"text": text, "ttft_ms": (stamps[0] - t0) * 1e3,
                "ms": (stamps[-1] - t0) * 1e3}

    t0 = time.perf_counter()
    out = {"lane": lane}
    try:
        cp = spawn("dynamo_tpu_torch.runtime", "--host", "127.0.0.1", "--port",
                   "0", "--log-level", "warning")
        addr = ready(cp, "READY ", "the control plane").split()[1]
        common = ["--control", addr, "--model", cfg.name, "--seed", str(SEED),
                  "--status-port", "0", *extra]
        prefill = spawn("dynamo_tpu_torch.worker", *common, "--disagg-role",
                        "prefill", env={**os.environ, "DYN_TPU_LEASE_TTL":
                                        str(DISAGG_PREFILL_LEASE_S)})
        decode = spawn("dynamo_tpu_torch.worker", *common, "--disagg-role", "decode")
        front = spawn("dynamo_tpu_torch.frontend", "--control", addr, "--host",
                      "127.0.0.1", "--port", "0", "--log-level", "warning")
        port = int(ready(front, "READY http://", "the frontend").rsplit(":", 1)[1])
        p_status = int(ready(prefill, "STATUS ", "the prefill worker").rsplit(":", 1)[1])
        d_status = int(ready(decode, "STATUS ", "the decode worker").rsplit(":", 1)[1])
        ready(prefill, "READY worker", "the prefill worker")
        ready(decode, "READY worker", "the decode worker")
        out["ready_s"] = time.perf_counter() - t0
        for _ in range(1200):
            st, models = _http(port, "GET", "/v1/models")
            if st == 200 and cfg.name.encode() in models:
                break
            time.sleep(0.1)
        else:
            fail(f"disagg (b): the frontend never listed {cfg.name}")
        # the first remote prefill of each length captures graphs on both
        # workers: warm them once, outside the measured rounds
        for name in warm:
            send(port, name)
        d0 = status(d_status)
        remote = {n: send(port, n) for n in measured}
        d1 = status(d_status)
        p1 = released(p_status)
        st, metrics_text = _http(d_status, "GET", "/metrics")
        n_remote = len(measured) - 1
        launches = {k: d1["kernel_launches"][k] - d0["kernel_launches"][k]
                    for k in d1["kernel_launches"]}
        moved = d1["kv_transfer_count"] - d0["kv_transfer_count"]
        out["remote_round"] = {
            "ttft_ms": {n: r["ttft_ms"] for n, r in remote.items()},
            "transfers": moved,
            "by_lane": {k: d1[f"kv_transfer_{k}_count"] - d0[f"kv_transfer_{k}_count"]
                        for k in ("device", "ipc", "host")},
            "lane_count_on_metrics": _metric_sum(
                metrics_text.decode(), f"dynamo_tpu_worker_kv_transfer_{lane}_count"),
            "transfer_ms_mean": (d1["kv_transfer_ms_total"] - d0["kv_transfer_ms_total"])
            / max(moved, 1),
            "transfer_gb_per_s": (d1["kv_transfer_bytes_total"]
                                  - d0["kv_transfer_bytes_total"])
            / max(d1["kv_transfer_ms_total"] - d0["kv_transfer_ms_total"], 1e-9) / 1e6,
            "prefill_fallback_total": d1["prefill_fallback_total"],
            "ipc_mapped": d1.get("kv_transfer_ipc_mapped"),
            "launches": launches,
            "prefill_held_pages_after": p1.get("kv_transfer_held_pages"),
            "prefill_kv_usage_after": p1.get("kv_usage"),
            "prefill_ipc_offered": p1.get("kv_transfer_ipc"),
        }
        # -- three prompts at once: transfers while the prefill runs ----- #
        clear(port)
        with ThreadPoolExecutor(len(concurrent)) as ex:
            together = dict(zip(concurrent, ex.map(
                lambda n: send(port, n, cleared=False), concurrent)))
        d2 = status(d_status)
        p2 = released(p_status)
        moved = d2["kv_transfer_count"] - d1["kv_transfer_count"]
        out["concurrent_round"] = {
            "ttft_ms": {n: r["ttft_ms"] for n, r in together.items()},
            "transfers": moved,
            "on_lane": d2[f"kv_transfer_{lane}_count"] - d1[f"kv_transfer_{lane}_count"],
            "transfer_ms_mean": (d2["kv_transfer_ms_total"] - d1["kv_transfer_ms_total"])
            / max(moved, 1),
            "prefill_fallback_total": d2["prefill_fallback_total"],
            "kv_repage_launches": d2["kernel_launches"]["kv_repage"]
            - d1["kernel_launches"]["kv_repage"],
            "prefill_held_pages_after": p2.get("kv_transfer_held_pages"),
            "prefill_kv_usage_after": p2.get("kv_usage"),
        }
        # -- the prefill worker dies; the greedy prompts prefill locally --- #
        prefill.kill()
        prefill.wait()
        local = {n: send(port, n) for n in measured + concurrent
                 if n.startswith(("greedy", "concurrent"))}
        d3 = status(d_status)
        out["fallback_round"] = {
            "ttft_ms": {n: r["ttft_ms"] for n, r in local.items()},
            "prefill_fallback_delta": d3["prefill_fallback_total"]
            - d2["prefill_fallback_total"],
            "transfers_delta": d3["kv_transfer_count"] - d2["kv_transfer_count"],
            "equal_to_remote": {n: local[n]["text"] == remote[n]["text"]
                                for n in local if n in remote},
            # prompts prefilled together on the prefill worker ran other
            # chunks than a lone local prefill, so a near-tie may flip
            # (phase 12 (a) holds the lanes to the model's margins)
            "concurrent_equal_to_local": {
                n: local[n]["text"] == together[n]["text"] for n in together},
        }
    finally:
        for p in reversed(procs):
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "disagg", "what": "worker_processes", "model": cfg.name,
          "layers": layers or cfg.num_hidden_layers, **out, "card": card_line()})
    r, c, f = out["remote_round"], out["concurrent_round"], out["fallback_round"]
    if r["transfers"] != n_remote or r["by_lane"][lane] != n_remote:
        fail(f"disagg (b): not every remote prefill rode the {lane} lane: {r}")
    if r["lane_count_on_metrics"] < n_remote:
        fail(f"disagg (b): /metrics shows {r['lane_count_on_metrics']} {lane} "
             f"transfers")
    if r["prefill_fallback_total"] != 0:
        fail(f"disagg (b): a handoff fell back before the prefill worker died: {r}")
    if r["prefill_held_pages_after"] != 0 or r["prefill_kv_usage_after"] != 0:
        fail(f"disagg (b): the prefill worker did not release its pages: {r}")
    if lane == "ipc" and r["launches"]["kv_repage"] != n_remote:
        fail(f"disagg (b): the decode worker's kv_repage launches {r['launches']}")
    if (c["transfers"] != len(concurrent) or c["on_lane"] != len(concurrent)
            or c["prefill_fallback_total"] != 0):
        fail(f"disagg (b): a concurrent prompt missed the {lane} lane: {c}")
    if c["prefill_held_pages_after"] != 0 or c["prefill_kv_usage_after"] != 0:
        fail(f"disagg (b): the prefill worker kept pages of the concurrent round: {c}")
    if lane == "ipc" and c["kv_repage_launches"] != len(concurrent):
        fail(f"disagg (b): kv_repage launches in the concurrent round: {c}")
    if f["prefill_fallback_delta"] != len(f["ttft_ms"]) or f["transfers_delta"]:
        fail(f"disagg (b): the resends did not fall back locally: {f}")
    if not all(f["equal_to_remote"].values()):
        fail(f"disagg (b): a locally prefilled resend differs: {f}")
    return r["launches"]


def phase_disagg(model, cfg):
    """Phase 12 (see the module docstring): (a) in process, then (b) as
    processes, with the card's cache emptied between them."""
    import gc

    t0 = time.perf_counter()
    colocated = disagg_colocated(model, cfg)
    # the worker processes load two more 8B copies: give the card back
    # what this process's engines held
    gc.collect()
    torch.cuda.empty_cache()
    # the worker processes draw the model at the view's depth
    ipc = disagg_processes(cfg, layers=cfg.num_hidden_layers)
    emit({"phase": "disagg", "what": "done", "seconds": time.perf_counter() - t0})
    return {**{f"disagg colocated {k} (phase 12 a)": v for k, v in colocated.items()},
            "disagg ipc, worker processes (phase 12 b, this slice's path)": ipc}


# --------------------------------------------------------------------------- #
# phase 11: model breadth at full width
# --------------------------------------------------------------------------- #

# (b): MoE routing is discrete and gpt-oss-20b's random router puts
# near-ties everywhere (top-k margins of 1e-3 router-logit std), so one
# bf16 rounding upstream flips an expert and the paths part for good.  The
# plain path therefore takes the kernel path's expert choices (its own
# router logits, gathered at the kernel's experts) and the router logits
# become an output held like the logits: within LOGIT_TOL of their std on
# every row of every layer.  Where the plain path's own top-k would have
# chosen otherwise, the flip and its margin are reported.
# (e): int8 logits against the bf16 model's, measured against a "noise
# twin": the bf16 model with every quantized weight moved by uniform noise
# of its own int8 step (per output channel: absmax / 127, the rounding
# error's distribution).  The int8 model's largest logit error must stay
# within INT8_NOISE_FACTOR of the twin's: int8 then errs no more than its
# rounding predicts.  A draw-to-draw spread of the twin's error within 2x
# is expected in a sharpened model; 3 leaves room for it.
INT8_NOISE_FACTOR = 3.0
# (e): `matmul_any` on the card (cuBLAS on bf16 operands with an f32
# output, then the scale) against x.float() @ dequantize(w) in f32 (TF32
# off): both sum the same exact products in f32 in another order, so each
# output row within phase 3's GG_RTOL of its largest value, the grouped
# GEMM's rule.  The order alone reads up to 1.3e-5 at K = 14336 (w_down,
# on an H100); a product rounded to bf16 before the scale errs by ~2^-9.
INT8_MM_RTOL = GG_RTOL
BREADTH_TOKENS = 32
BREADTH_ARMS = {"a_steps1": dict(decode_steps=1),
                "b_steps8": dict(decode_steps=8)}
BREADTH_GREEDY = ("A_64", "B_shared+300", "C_1536")


def weights_gb(model) -> float:
    """GB the model's weights hold on the card: its parameters and the
    int8 ``{"q", "s"}`` weights that replace some of them."""
    n = sum(p.numel() * p.element_size() for p in model.parameters())
    for mod in model.modules():
        for v in vars(mod).values():
            if isinstance(v, dict) and "q" in v:
                n += sum(t.numel() * t.element_size() for t in v.values())
    return n / 1e9


def path_run(model, cfg, tokens, steps, fed=None, page=16):
    """`forward_prefill` of tokens [1, S] on the card, then `steps`
    `forward_decode` steps fed their own greedy tokens (or `fed`);
    (f32 logits [steps + 1, V], greedy tokens)."""
    from dynamo_tpu_torch.models import KVCache

    S = tokens.shape[1]
    maxp = -(-(S + steps) // page)
    table = torch.arange(1, maxp + 1, dtype=torch.int32, device="cuda")[None]
    kv = KVCache.create(cfg, maxp + 1, page, torch.bfloat16, "cuda",
                        tp=model.tp)
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    chunk = torch.full((1,), S, dtype=torch.int32, device="cuda")
    logits = [model.forward_prefill(kv, tokens, table, zero, chunk)]
    toks = [int(logits[0].argmax(-1))]
    for t in range(steps):
        tok = toks[-1] if fed is None else fed[t]
        logits.append(model.forward_decode(
            kv, torch.tensor([tok], device="cuda"),
            torch.tensor([S + t], device="cuda"), table))
        toks.append(int(logits[-1].argmax(-1)))
    return torch.stack(logits)[:, 0], toks


def breadth_model():
    """(a) gpt-oss-20b at its catalog widths cut to CUT_LAYERS layers,
    random bf16 weights from a seed, sharpened as phase 4's model
    (embedding and q/k only)."""
    from dynamo_tpu_torch.models import GPT_OSS_20B, init_params

    cfg = GPT_OSS_20B.with_depth(CUT_LAYERS)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    model = init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    sharpen(model)
    torch.cuda.synchronize()
    emit({"phase": "breadth", "what": "model_init", "model": cfg.name,
          "layers": cfg.num_hidden_layers, "hidden": cfg.hidden_size,
          "heads": [cfg.num_attention_heads, cfg.num_key_value_heads],
          "head_dim": cfg.head_dim_, "experts": [cfg.num_experts,
                                                 cfg.num_experts_per_tok],
          "windows": cfg.layer_windows()[:2], "params_b": cfg.num_params() / 1e9,
          "seconds": time.perf_counter() - t0, "weights_gb": weights_gb(model),
          "card": card_line()})
    return model, cfg


def breadth_paths(model, cfg):
    """(b) one 512-token prompt (four windows long) through `forward_prefill`
    and 8 `forward_decode` steps on the kernels (both attention kernels,
    the grouped GEMM), then on the plain versions fed the kernel path's
    tokens and routed to the kernel path's experts, and with planted
    faults (their own routing): the window ignored, the sinks dropped, the
    prompt's last token routed to its 5th expert in place of its 1st.
    Phase 5's rule on the logits (within LOGIT_TOL std, greedy tokens
    equal or near-ties, every fault beyond LOGIT_TOL), and the router
    logits within LOGIT_TOL of their std.  Reports `chaos_witness`
    beside it."""
    import dynamo_tpu_torch.models.llama as llama
    from dynamo_tpu_torch.ops import cuda_attention as ca
    from dynamo_tpu_torch.ops import moe
    from dynamo_tpu_torch.ops import paged_attention as pa

    S, steps = 512, 8
    g = torch.Generator().manual_seed(SEED + 12)
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=g).cuda()
    orig_top_k = llama._top_k

    def recording(calls):
        """`_top_k` noting each call's (layer order) router logits and
        choice."""
        def top_k(logits, k):
            vals, idx = orig_top_k(logits, k)
            calls.append((logits.clone(), idx.clone()))
            return vals, idx
        return top_k

    def forced(calls, own):
        """`_top_k` taking the experts of `calls` (the kernel run), in
        call order, at this run's own router logits; notes this run's
        logits and its own choice in `own`."""
        it = iter(calls)

        def top_k(logits, k):
            _, idx = next(it)
            own.append((logits.clone(), orig_top_k(logits, k)[1]))
            return logits.gather(-1, idx), idx
        return top_k

    def swap_last_token(logits, k):
        vals, idx = orig_top_k(logits, k + 1)
        if logits.shape[0] == S:  # the prefill chunk: its last token
            idx = idx.clone()
            idx[-1, 0] = idx[-1, k]
            vals = logits.gather(-1, idx)
        return vals[..., :k], idx[..., :k]

    def run(attention=None, gemm=None, top_k=None, fed=None):
        """`gemm`: (grouped GEMM, fused gate||up) in the kernels' place."""
        saved = (llama.prefill_attention, llama.decode_attention,
                 llama.grouped_gemm, llama.grouped_glu, llama._top_k)
        if attention is not None:
            llama.prefill_attention, llama.decode_attention = attention
        if gemm is not None:
            llama.grouped_gemm, llama.grouped_glu = gemm
        if top_k is not None:
            llama._top_k = top_k
        try:
            return path_run(model, cfg, tokens, steps, fed)
        finally:
            (llama.prefill_attention, llama.decode_attention,
             llama.grouped_gemm, llama.grouped_glu, llama._top_k) = saved

    kern_calls, plain_calls = [], []
    ca.reset_launches()
    kern_logits, kern_toks = run(top_k=recording(kern_calls))
    launches = dict(ca.LAUNCHES)
    plain_logits, plain_toks = run(
        (pa.prefill_attention_plain, pa.decode_attention_plain),
        (moe.grouped_gemm_plain, moe.grouped_glu_plain),
        forced(kern_calls, plain_calls), kern_toks)
    sd = plain_logits.std(-1)
    step_err = ((kern_logits - plain_logits).abs().amax(-1) / sd).tolist()

    def logit_err(logits):
        return ((logits - plain_logits).abs().amax(-1) / sd).max().item()

    # router logits, every row of every layer, in each row's std units;
    # the plain path's own choices where they differ from the kernel's
    L = cfg.num_hidden_layers
    router_err, flips = 0.0, []
    for i, ((lk, ik), (lp, ip)) in enumerate(zip(kern_calls, plain_calls)):
        rsd = lp.std(-1)
        router_err = max(router_err, ((lk - lp).abs().amax(-1) / rsd).max().item())
        diff = (ik.sort(-1)[0] != ip.sort(-1)[0]).any(-1).nonzero()[:, 0].tolist()
        for r in diff:
            top = lp[r].sort(descending=True)[0]
            k = ik.shape[-1]
            flips.append({"step": i // L, "layer": i % L, "row": r,
                          "margin_std": ((top[k - 1] - top[k]) / rsd[r]).item()})

    def drop(which):
        def wrap(f):
            def inner(*a, window=None, sink=None):
                return f(*a, window=None if which == "window" else window,
                         sink=None if which == "sink" else sink)
            return inner
        return (wrap(ca.prefill_attention_cuda), wrap(ca.decode_attention_cuda))

    faults = {"window ignored": dict(attention=drop("window")),
              "sinks dropped": dict(attention=drop("sink")),
              "last prompt token's top-1 expert swapped": dict(top_k=swap_last_token)}
    fault_err = {n: logit_err(run(fed=kern_toks, **f)[0]) for n, f in faults.items()}
    witness = chaos_witness(model, run, recording, forced, plain_logits,
                            kern_calls, kern_toks)
    picked = plain_logits.gather(
        1, torch.tensor(kern_toks, device=plain_logits.device)[:, None])[:, 0]
    tie_gap = ((plain_logits.amax(-1) - picked) / sd).tolist()
    res = {"phase": "breadth", "what": "kernel_vs_plain_path", "model": cfg.name,
           "prompt": S, "decode_steps": steps,
           "max_logit_err_in_std": max(step_err), "step_err_in_std": step_err,
           "max_router_logit_err_in_std": router_err,
           "tol_in_std": LOGIT_TOL, "planted_fault_err_in_std": fault_err,
           "plain_logit_std": sd.mean().item(),
           "tokens_kernel": kern_toks, "tokens_plain": plain_toks,
           "kernel_token_gap_in_std": tie_gap,
           "routing_flips": len(flips),
           "routing_flip_max_margin_std": max((f["margin_std"] for f in flips),
                                              default=None),
           "routing_flips_first": flips[:8], "launches": launches,
           "chaos_witness": witness,
           "finite": bool(torch.isfinite(kern_logits).all())}
    emit(res)
    if not res["finite"]:
        fail("breadth: kernel path logits are not finite")
    if max(step_err) > LOGIT_TOL or router_err > LOGIT_TOL:
        fail(f"breadth: kernel path logits ({max(step_err):.3f} std) or router "
             f"logits ({router_err:.3f} std) disagree with the plain path")
    if max(tie_gap) > LOGIT_TOL:
        fail("breadth: kernel path greedy tokens differ from the plain path "
             "beyond a near-tie")
    if len(set(kern_toks)) == 1:
        fail("breadth: the model repeats one token")
    for name, err in fault_err.items():
        if err <= LOGIT_TOL:
            fail(f"breadth cannot see a planted fault: {name}")
    for key in ("decode_attention", "prefill_attention", *MOE_KERNELS):
        if launches[key] <= 0:
            fail(f"breadth: the kernel path did not launch {key}: {launches}")


def split_k_plain(xs, w, offs, bias=None):
    """The plain grouped GEMM with K summed in two halves: the same exact
    products in another f32 order, as the kernel's own order differs from
    the plain loop's, and no kernel; then the bias."""
    from dynamo_tpu_torch.ops import moe

    h = xs.shape[1] // 2
    out = (moe.grouped_gemm_plain(xs[:, :h], w[:, :h], offs)
           + moe.grouped_gemm_plain(xs[:, h:], w[:, h:], offs))
    if bias is not None:  # each row's expert's bias
        out = out + bias.float().repeat_interleave((offs[1:] - offs[:-1]).long(), 0)
    return out


def split_k_glu_plain(xs, w_gate, w_up, b_gate, b_up, offs, act):
    """`grouped_glu_plain` over `split_k_plain`'s sums."""
    from dynamo_tpu_torch.ops import moe

    return moe.moe_act(act, split_k_plain(xs, w_gate, offs, b_gate),
                       split_k_plain(xs, w_up, offs, b_up)).to(xs.dtype)


def chaos_witness(model, run, recording, forced, plain_logits, kern_calls,
                  kern_toks):
    """(b)'s kernel-free twin: the plain path against itself with only the
    f32 order of the expert sums changed (`split_k_plain`), both routed
    alike, at the sharpening (b) uses and at q/k x1.5 (before yarn's
    scale), where the kernel and plain paths part.  If the twin parts as
    far as the kernel path at x1.5, that parting is the model's
    amplification of rounding, not a kernel's fault.  Logit errors in
    plain-logit std units, the largest over the prefill and decode
    steps."""
    from dynamo_tpu_torch.ops import moe
    from dynamo_tpu_torch.ops import paged_attention as pa

    plain = (pa.prefill_attention_plain, pa.decode_attention_plain)

    def err(logits, ref):
        return ((logits - ref).abs().amax(-1) / ref.std(-1)).max().item()

    out = {"qk_scale": {"b": 1.5 / model.rope_scale, "x1.5": 1.5}}
    split = (split_k_plain, split_k_glu_plain)
    twin, _ = run(plain, split, forced(kern_calls, []), kern_toks)
    out["twin_err_in_std_b"] = err(twin, plain_logits)
    saved = [(layer.wq.clone(), layer.wk.clone()) for layer in model.layers]
    try:
        with torch.no_grad():
            for layer in model.layers:
                layer.wq.mul_(model.rope_scale)
                layer.wk.mul_(model.rope_scale)
        calls = []
        ref, toks = run(plain, (moe.grouped_gemm_plain, moe.grouped_glu_plain),
                        recording(calls))
        twin, _ = run(plain, split, forced(calls, []), toks)
        kern, _ = run(top_k=forced(calls, []), fed=toks)
        out["twin_err_in_std_x1.5"] = err(twin, ref)
        out["kernel_err_in_std_x1.5"] = err(kern, ref)
    finally:
        with torch.no_grad():
            for layer, (wq, wk) in zip(model.layers, saved):
                layer.wq.copy_(wq)
                layer.wk.copy_(wk)
    emit({"phase": "breadth", "what": "chaos_witness", **out, "card": card_line()})
    return out


def breadth_requests(cfg):
    """(c)'s traffic: a 512-token shared prefix, four prompts of 64-1536
    tokens (two behind the prefix, one seeded at 0.8), 32 tokens each,
    and a warm-up prompt on the prefix."""
    g = torch.Generator().manual_seed(SEED + 13)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()

    shared = prompt(512)
    reqs = {"A_64": _req(prompt(64), max_tokens=BREADTH_TOKENS),
            "B_shared+300": _req(shared + prompt(300), max_tokens=BREADTH_TOKENS),
            "C_1536": _req(prompt(1536), max_tokens=BREADTH_TOKENS),
            "D_shared+700_seeded": _req(shared + prompt(700), temperature=0.8,
                                        seed=7, max_tokens=BREADTH_TOKENS)}
    return shared, reqs, _req(shared + prompt(16), max_tokens=4)


def breadth_serving(model, cfg):
    """(c) `TorchEngine` over gpt-oss-20b, one-step blocks and 8-step
    blocks (both CUDA graphs): a warm-up wave (captures), the measured
    wave (launches counted; no new capture), the greedy A and C repeated
    alone from a cleared cache (traced) and equal to their batched run;
    greedy rows of the two arms equal or flipped at a near-tie.  Returns
    the launches of each arm's measured wave."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.ops import cuda_attention as ca
    from dynamo_tpu_torch.ops import moe

    shared, reqs, warm = breadth_requests(cfg)
    tokens, launches_by_arm = {}, {}
    for arm, over in BREADTH_ARMS.items():
        ecfg = EngineConfig(page_size=16, num_pages=1024, max_num_seqs=8,
                            max_prefill_tokens=512, max_model_len=4096, **over)
        engine = TorchEngine(cfg, model, ecfg, device="cuda")

        async def wave():
            engine.clear_kv_blocks()
            await _collect(engine, warm)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = await asyncio.gather(*[_collect(engine, r) for r in reqs.values()])
            torch.cuda.synchronize()
            return dict(zip(reqs, outs)), time.perf_counter() - t0

        async def run():
            await wave()
            captures0 = engine.graphs.captures
            ca.reset_launches()
            res, wall = await wave()
            launches = dict(ca.LAUNCHES)
            new_captures = engine.graphs.captures - captures0
            solo = {}
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                for n in ("A_64", "C_1536"):
                    engine.clear_kv_blocks()
                    solo[n] = (await _collect(engine, reqs[n]))["tokens"]
                torch.cuda.synchronize()
                solo_wall = time.perf_counter() - t1
            await engine.shutdown()
            return (res, wall, launches, new_captures, solo,
                    device_breakdown(prof, solo_wall))

        res, wall, launches, new_captures, solo, breakdown = asyncio.run(run())
        for n, r in res.items():
            if r["finish_reason"] != "length" or len(r["tokens"]) != BREADTH_TOKENS:
                fail(f"breadth {arm}: {n} ended {r['finish_reason']} with "
                     f"{len(r['tokens'])} tokens")
            if not all(0 <= t < cfg.vocab_size for t in r["tokens"]):
                fail(f"breadth {arm}: {n} produced out-of-vocab tokens")
        same = {n: solo[n] == res[n]["tokens"] for n in solo}
        first = min(r["t_first"] for r in res.values())
        last = max(r["t_last"] for r in res.values())
        decoded = sum(len(r["tokens"]) - 1 for r in res.values())
        emit({"phase": "breadth", "what": "serving", "arm": arm, "config": over,
              "model": cfg.name, "prompt_tokens": {n: len(r["token_ids"])
                                                   for n, r in reqs.items()},
              "ttft_ms": {n: r["ttft_ms"] for n, r in res.items()},
              "itl_ms": {n: (r["t_last"] - r["t_first"]) / (len(r["tokens"]) - 1) * 1e3
                         for n, r in res.items()},
              "decode_tokens_per_s": decoded / (last - first), "wall_s": wall,
              "launches": launches, "new_captures_in_measured_wave": new_captures,
              "graphs": engine.graphs.stats(), "solo_equal": same,
              "solo_trace": breakdown, "card": card_line()})
        if not all(same.values()):
            fail(f"breadth {arm}: a greedy request alone differs from its "
                 f"batched run (the MoE combine must not see batch-mates): {same}")
        if min(launches[k] for k in ("decode_attention", "prefill_attention",
                                     *MOE_KERNELS)) <= 0:
            fail(f"breadth {arm}: a kernel did not launch: {launches}")
        if new_captures:
            fail(f"breadth {arm}: {new_captures} graphs captured in the measured wave")
        tokens[arm] = {n: r["tokens"] for n, r in res.items()}
        launches_by_arm[arm] = launches
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    ref, got = tokens["a_steps1"], tokens["b_steps8"]
    flips = {n: first_flip(model, cfg, reqs[n]["token_ids"], ref[n], got[n])
             for n in BREADTH_GREEDY}
    emit({"phase": "breadth", "what": "greedy_rows_across_arms",
          "equal": {n: ref[n] == got[n] for n in reqs}, "flips": flips,
          "tol_in_std": LOGIT_TOL})
    for n, flip in flips.items():
        if flip and (flip["margin_std"] is None or abs(flip["margin_std"]) > LOGIT_TOL):
            fail(f"breadth: {n} of 8-step blocks flips beyond a near-tie: {flip}")
    return launches_by_arm, tokens["a_steps1"]


def breadth_worker_spawn(procs, cfg, layers=None):
    """(d)'s processes, started at the phase's start so the worker builds
    beside (a)-(c): the control plane, `python -m dynamo_tpu_torch.worker
    --model gpt-oss-20b` (random weights from a seed, a seeded 201088-id
    tokenizer; ``--num-layers`` `layers`) and the frontend.  Returns
    (worker, frontend, start time)."""
    t0 = time.perf_counter()
    cp = _spawn(procs, "dynamo_tpu_torch.runtime", "--host", "127.0.0.1",
                "--port", "0", "--log-level", "warning")
    addr = _ready(cp, "READY ", "breadth worker: the control plane").split()[1]
    worker = _spawn(procs, "dynamo_tpu_torch.worker", "--control", addr,
                    "--model", cfg.name, "--seed", str(SEED), "--log-level",
                    "warning", *(["--num-layers", str(layers)] if layers else []))
    front = _spawn(procs, "dynamo_tpu_torch.frontend", "--control", addr,
                   "--host", "127.0.0.1", "--port", "0", "--log-level", "warning")
    return worker, front, t0


def breadth_worker(cfg, spawned):
    """(d) the normal entry points as processes (`breadth_worker_spawn`'s):
    a greedy chat, a seeded one, and the greedy one again (equal), each
    from a cleared prefix cache."""
    def ready(p, prefix, what, timeout=600):
        # the worker prints its STATUS line first
        return _ready(p, prefix, f"breadth worker: {what}", timeout)

    def chat(content, **so):
        return {"model": cfg.name, "max_tokens": 16, "nvext": {"ignore_eos": True},
                "messages": [{"role": "user", "content": content}], **so}

    worker, front, t0 = spawned
    port = int(ready(front, "READY http://", "the frontend").rsplit(":", 1)[1])
    ready(worker, "READY worker", "the worker")
    t_ready = time.perf_counter() - t0
    for _ in range(1200):
        st, models = _http(port, "GET", "/v1/models")
        if st == 200 and cfg.name.encode() in models:
            break
        time.sleep(0.1)
    else:
        fail(f"breadth worker: the frontend never listed {cfg.name}")
    answers = []
    for body in (chat("Summarize paged attention in one line.", temperature=0),
                 chat("Name three uses of a KV cache.", temperature=0.8, seed=11),
                 chat("Summarize paged attention in one line.", temperature=0)):
        # each chat from a cold prefix cache: a cached prompt prefills
        # only its tail, other bf16 sums that can flip a near-tie
        st, _ = _http(port, "POST", "/clear_kv_blocks")
        if st != 200:
            fail(f"breadth worker: /clear_kv_blocks answered {st}")
        t1 = time.perf_counter()
        st, raw = _http(port, "POST", "/v1/chat/completions", body)
        if st != 200:
            fail(f"breadth worker: chat answered {st}: {raw[:300]!r}")
        out = json.loads(raw)
        answers.append({"ms": (time.perf_counter() - t1) * 1e3,
                        "finish_reason": out["choices"][0]["finish_reason"],
                        "completion_tokens": out["usage"]["completion_tokens"],
                        "text": out["choices"][0]["message"]["content"]})
    emit({"phase": "breadth", "what": "worker_http", "model": cfg.name,
          "ready_s": t_ready, "chats": answers,
          "greedy_repeat_equal": answers[0]["text"] == answers[2]["text"],
          "card": card_line()})
    for a in answers:
        if a["finish_reason"] != "length" or a["completion_tokens"] != 16:
            fail(f"breadth worker: a chat ended {a}")
    if answers[0]["text"] != answers[2]["text"]:
        fail("breadth worker: the greedy chat did not repeat")


def _int8_faults():
    """Planted int8 faults, each a `matmul_any(x, w)` in its place: the
    product rounded to bf16 before the scale; the scale taken along the
    input axis (square weights only; others computed right)."""
    from dynamo_tpu_torch.models.quantization import _mm_f32, matmul_any

    def rounded(x, w):
        return (x @ w["q"].to(x.dtype)).float() * w["s"]

    def input_axis(x, w):
        q, s = w["q"], w["s"]
        if q.shape[0] != q.shape[1]:
            return matmul_any(x, w)
        return _mm_f32((x.float() * s).to(x.dtype), q.to(x.dtype))

    return {"product rounded to bf16 before the scale": rounded,
            "scale along the input axis": input_axis}


def int8_matmul_checks(model):
    """`matmul_any` at Llama-3.1-8B's int8 projections (layer 0's seven and
    the head, as the engine quantized them) on random bf16 rows, 8 and
    512 of them, against x.float() @ dequantize_tensor(w, f32); the
    planted faults of `_int8_faults` must exceed INT8_MM_RTOL."""
    from dynamo_tpu_torch.models.quantization import (
        QUANT_KEYS,
        dequantize_tensor,
        is_quantized,
        matmul_any,
    )

    if torch.backends.cuda.matmul.allow_tf32:
        fail("breadth int8: TF32 is on, so the f32 reference is not f32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    layer = model.layers[0]
    weights = [(k, getattr(layer, k)) for k in QUANT_KEYS
               if is_quantized(getattr(layer, k, None))]
    weights.append(("lm_head", model.lm_head))
    faults = _int8_faults()
    cases = []
    for name, w in weights:
        ref_w = dequantize_tensor(w, torch.float32)
        for rows in (8, 512):
            x = torch.randn((rows, w["q"].shape[0]), generator=gen,
                            device="cuda").to(torch.bfloat16)
            ref = x.float() @ ref_w

            def rel(y):
                return ((y - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()

            cases.append({"weight": name, "shape": list(w["q"].shape), "rows": rows,
                          "max_rel_err": rel(matmul_any(x, w)),
                          "fault_rel_err": {f: rel(fn(x, w)) for f, fn in faults.items()
                                            if f != "scale along the input axis"
                                            or w["q"].shape[0] == w["q"].shape[1]}})
        del ref_w
    res = {"phase": "breadth", "what": "int8_matmul", "rtol": INT8_MM_RTOL,
           "max_rel_err": max(c["max_rel_err"] for c in cases), "cases": cases,
           "card": card_line()}
    emit(res)
    for c in cases:
        if not c["max_rel_err"] <= INT8_MM_RTOL:
            fail(f"breadth int8: matmul_any disagrees with the dequantized "
                 f"f32 product: {c}")
        for f, e in c["fault_rel_err"].items():
            if e <= INT8_MM_RTOL:
                fail(f"breadth int8: the check cannot see a planted fault: {f} {c}")
    return res


def breadth_int8(direct, layers=None):
    """(e) Llama-3.1-8B from phase 4's seed, served with
    `quantization="int8"` (the engine quantizes it in place): phase 4's
    prompts through `phase_serving` (greedy repeats alone equal), and
    phase 5's prompt's logits (prefill + 8 fed decode steps) against the
    bf16 model's, within INT8_NOISE_FACTOR of the noise twin's error;
    `int8_matmul_checks`, and what its planted faults read through the
    whole model."""
    import dynamo_tpu_torch.models.llama as llama
    from dynamo_tpu_torch.models import LLAMA_3_1_8B, init_params
    from dynamo_tpu_torch.models.quantization import QUANT_KEYS, matmul_any

    cfg = LLAMA_3_1_8B.with_depth(layers or LLAMA_3_1_8B.num_hidden_layers)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    sharpen(model)
    bf16_gb = weights_gb(model)
    g = torch.Generator().manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=g).cuda()
    ref_logits, ref_toks = path_run(model, cfg, tokens, 8)
    sd = ref_logits.std(-1)

    def err(logits):
        return ((logits - ref_logits).abs().amax(-1) / sd).max().item()

    # the noise twin, made in place and undone from a saved copy
    noise = torch.Generator(device="cuda").manual_seed(SEED + 14)
    with torch.no_grad():
        saved = []
        mats = [(layer, k) for layer in model.layers for k in QUANT_KEYS]
        mats.append((model, "lm_head"))
        for mod, key in mats:
            w = getattr(mod, key)
            saved.append(w.clone())
            step = w.float().abs().amax(0).clamp_min(1e-8) / 127.0
            u = torch.rand(w.shape, generator=noise, device="cuda") - 0.5
            w.copy_((w.float() + u * step).to(w.dtype))
        twin_logits, _ = path_run(model, cfg, tokens, 8, fed=ref_toks[:-1])
        for (mod, key), w in zip(mats, saved):
            getattr(mod, key).copy_(w)
        del saved
    torch.cuda.empty_cache()
    launches, served = phase_serving(model, cfg, quantization="int8",
                                     phase="breadth_int8_serving")
    int8_gb = weights_gb(model)
    q_logits, q_toks = path_run(model, cfg, tokens, 8, fed=ref_toks[:-1])
    int8_matmul_checks(model)
    # what the planted faults read through the whole model, against the
    # noise-twin rule (reported; the check above is what holds them)
    fault_err = {}
    for name, fn in _int8_faults().items():
        llama.matmul_any = fn
        try:
            fault_err[name] = err(path_run(model, cfg, tokens, 8,
                                           fed=ref_toks[:-1])[0])
        finally:
            llama.matmul_any = matmul_any
    res = {"phase": "breadth", "what": "int8", "model": cfg.name,
           "weights_gb": {"bfloat16": bf16_gb, "int8": int8_gb},
           "logit_err_in_std": err(q_logits),
           "noise_twin_err_in_std": err(twin_logits),
           "tol_factor_of_twin": INT8_NOISE_FACTOR,
           "planted_fault_err_in_std": fault_err,
           "tokens_bf16": ref_toks, "tokens_int8": q_toks,
           "itl_ms_int8": served["itl_ms"], "itl_ms_bf16_phase4": direct["itl_ms"],
           "tokens_per_s": {"int8": served["decode_tokens_per_s"],
                            "bf16_phase4": direct["decode_tokens_per_s"]},
           "launches": launches, "finite": bool(torch.isfinite(q_logits).all()),
           "card": card_line()}
    emit(res)
    if not res["finite"] or res["logit_err_in_std"] > (
            INT8_NOISE_FACTOR * res["noise_twin_err_in_std"]):
        fail(f"breadth int8: logits err {res['logit_err_in_std']:.3f} std beyond "
             f"{INT8_NOISE_FACTOR} x the noise twin's {res['noise_twin_err_in_std']:.3f}")
    return launches


def phase_breadth(direct):
    """Phase 11 (see the module docstring).  Runs with no other model on
    the card; returns the launches of each serving path and the one-step
    engine's tokens (phase 15 (c) compares with them)."""
    import gc

    from dynamo_tpu_torch.models import GPT_OSS_20B

    # (c)-(e) at SHALLOW_LAYERS layers, full width: (c) the first layers
    # of (a)'s model, (d) and (e) drawn at that depth; (d)'s worker builds
    # while (a)-(c) run
    procs = []
    try:
        spawned = breadth_worker_spawn(procs, GPT_OSS_20B, layers=SHALLOW_LAYERS)
        model, cfg = breadth_model()
        breadth_paths(model, cfg)
        serving, tokens = breadth_serving(*depth_view(model, cfg, SHALLOW_LAYERS))
        del model
        gc.collect()
        torch.cuda.empty_cache()
        breadth_worker(cfg, spawned)
    finally:
        _stop_all(procs)
    int8 = breadth_int8(direct, layers=SHALLOW_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    return serving, int8, tokens


# --------------------------------------------------------------------------- #


def package_versions() -> dict:
    """Versions of the packages this script and the port rely on; jinja2
    (the chat template) must be there: the port has no fallback."""
    from importlib.metadata import PackageNotFoundError, version

    out = {}
    for pkg in ("torch", "numpy", "jinja2"):
        try:
            out[pkg] = version(pkg)
        except PackageNotFoundError:
            fail(f"package {pkg} is missing on this machine; the port needs it")
    return out


# --------------------------------------------------------------------------- #
# phase 13: vision
# --------------------------------------------------------------------------- #

VL_MODEL = "qwen2.5-vl-7b"
LLAVA_DIR = os.path.join(ROOT, "tests", "fixtures", "golden_llava")
VL_TOKENS = 32
# the tower through the kernel against its plain version: every embedding
# within VL_TOWER_RTOL of the largest plain value (f32 on both sides; the
# sums run in another order over 32 layers)
VL_TOWER_RTOL = 1e-4


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    import struct
    import zlib

    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png_head(rgb) -> bytes:
    import struct

    h, w, _ = rgb.shape
    return b"\x89PNG\r\n\x1a\n" + _png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))


def _png_rows(rgb) -> bytes:
    import zlib

    return zlib.compress(b"".join(b"\x00" + row.tobytes() for row in rgb), 6)


def png_bytes(rgb) -> bytes:
    """A non-interlaced 8-bit RGB PNG of `rgb` [H, W, 3] uint8 (this
    machine has no PIL; the port's codec decodes it)."""
    return (_png_head(rgb) + _png_chunk(b"IDAT", _png_rows(rgb))
            + _png_chunk(b"IEND", b""))


def apng_bytes(frames) -> bytes:
    """An APNG of full-size RGB frames (dispose none, blend source)."""
    import struct

    h, w, _ = frames[0].shape
    out = [_png_head(frames[0]), _png_chunk(b"acTL", struct.pack(">II", len(frames), 0))]
    seq = 0
    for i, f in enumerate(frames):
        out.append(_png_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0,
                                                   1, 10, 0, 0)))
        seq += 1
        if i == 0:
            out.append(_png_chunk(b"IDAT", _png_rows(f)))
        else:
            out.append(_png_chunk(b"fdAT", struct.pack(">I", seq) + _png_rows(f)))
            seq += 1
    out.append(_png_chunk(b"IEND", b""))
    return b"".join(out)


def vl_image(seed, w, h):
    """A seeded picture: smooth colour fields with noise on top."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([np.sin(xx * rng.uniform(2, 9) + rng.uniform(0, 6)),
                     np.cos(yy * rng.uniform(2, 9) + rng.uniform(0, 6)),
                     np.sin((xx + yy) * rng.uniform(2, 9))], -1)
    img = (base * 0.5 + 0.5) * 200 + rng.integers(0, 55, (h, w, 3))
    return img.clip(0, 255).astype(np.uint8)


def data_uri(raw: bytes) -> str:
    import base64

    return "data:image/png;base64," + base64.b64encode(raw).decode()


def vl_chat(text, media=(), max_tokens=VL_TOKENS):
    """An OpenAI chat body: `media` ("image" | "video", data URI) parts
    before the text."""
    content = [{"type": f"{k}_url", f"{k}_url": {"url": u}} for k, u in media]
    content.append({"type": "text", "text": text})
    return {"model": VL_MODEL, "messages": [{"role": "user", "content": content}],
            "max_tokens": max_tokens, "temperature": 0.0,
            "nvext": {"ignore_eos": True}}


def vl_golden():
    """(a) The golden LLaVA anchor: its CLIP tower (2 heads of 16) on the
    card through the segment kernel, the LLM (head dim 16, below the
    paged kernels' 64) on the CPU; logits against transformers' at
    tests/test_golden.py's limits."""
    import numpy as np

    from dynamo_tpu_torch.models.llama import KVCache
    from dynamo_tpu_torch.models.vision import encode_images
    from dynamo_tpu_torch.models.vlm import load_vision_params, load_vlm
    from dynamo_tpu_torch.ops import cuda_attention as ca

    llm, cfg, _, vcfg = load_vlm(LLAVA_DIR, dtype=torch.float32, device="cpu")
    tower = load_vision_params(LLAVA_DIR, vcfg, device="cuda")
    data = np.load(os.path.join(LLAVA_DIR, "golden_logits.npz"))
    prompt, off = data["prompt"].tolist(), int(data["image_offset"])
    pixels = torch.from_numpy(data["pixels"].transpose(0, 2, 3, 1).copy()).cuda()
    torch.cuda.synchronize()
    ca.reset_launches()
    emb = encode_images(tower, pixels).cpu()
    launches = ca.LAUNCHES["segment_attention"]
    S, P = len(prompt), emb.shape[1]
    extra = torch.zeros((1, S, cfg.hidden_size))
    mask = torch.zeros((1, S), dtype=torch.bool)
    extra[0, off:off + P], mask[0, off:off + P] = emb[0], True
    pages = S // 8 + 2
    kv = KVCache.create(cfg, pages + 1, 8, torch.float32, "cpu")
    table = torch.arange(1, pages + 1, dtype=torch.int32)[None]
    got = llm.forward_prefill(kv, torch.tensor([prompt]), table,
                              torch.zeros(1, dtype=torch.int32),
                              torch.tensor([S], dtype=torch.int32), extra, mask)[0].numpy()
    want = data["last_logits"]
    tol = GOLDEN_TOL[torch.float32]
    res = {"what": "golden_llava", "segment_launches": launches,
           "max_abs_err": float(np.abs(got - want).max()),
           "within_tol": bool(np.all(np.abs(got - want)
                                     <= tol["atol"] + tol["rtol"] * np.abs(want))),
           "argmax_equal": int(got.argmax()) == int(want.argmax()), **tol}
    emit({"phase": "vision", **res})
    if not (res["within_tol"] and res["argmax_equal"]) or launches < 1:
        fail(f"vision (a): the golden LLaVA anchor disagrees: {res}")


def vl_embeds(engine, req):
    """The tower's embeddings of a preprocessed request: [(offset, [P, h])]."""
    import numpy as np

    from dynamo_tpu_torch.llm.multimodal import unpack_patches
    from dynamo_tpu_torch.models.qwen_vl import encode_patches

    tower = engine.vision[0]
    return [(off, encode_patches(tower, torch.from_numpy(np.array(a)), g))
            for off, (a, g) in zip(req["mm_offsets"],
                                   map(unpack_patches, req["mm_patches"]))]


def vl_last_logits(engine, req, embeds, after=()):
    """f32 logits after the prompt (+ `after` tokens), one prefill chunk
    with the media spliced in and the M-RoPE streams."""
    from dynamo_tpu_torch.llm.multimodal import unpack_patches
    from dynamo_tpu_torch.models.llama import KVCache
    from dynamo_tpu_torch.models.qwen_vl import mrope_positions_from_runs

    model, vcfg = engine.model, engine.vision[1]
    tokens = list(req["token_ids"]) + list(after)
    S = len(tokens)
    runs = [(off, unpack_patches(b)[1]) for off, b in zip(req["mm_offsets"],
                                                         req["mm_patches"])]
    pos, _ = mrope_positions_from_runs(S, runs, vcfg)
    extra = torch.zeros((1, S, engine.model_cfg.hidden_size), device="cuda")
    mask = torch.zeros((1, S), dtype=torch.bool, device="cuda")
    for off, e in embeds:
        extra[0, off:off + e.shape[0]], mask[0, off:off + e.shape[0]] = e, True
    pages = -(-S // 16)
    kv = KVCache.create(engine.model_cfg, pages + 1, 16, torch.bfloat16, "cuda")
    table = torch.arange(1, pages + 1, dtype=torch.int32, device="cuda")[None]
    return model.forward_prefill(
        kv, torch.tensor([tokens], device="cuda"), table,
        torch.zeros(1, dtype=torch.int32, device="cuda"),
        torch.tensor([S], dtype=torch.int32, device="cuda"), extra, mask,
        torch.from_numpy(pos[None]).cuda())[0]


def vl_paths(engine, req, other):
    """(b) The whole tower on the kernel against its plain version on a
    448x448 image, then the first token's logits of the kernel path (the
    tower and the paged attention kernels) against the plain path's; the
    same text under another image must move them."""
    import dynamo_tpu_torch.models.llama as llama
    import dynamo_tpu_torch.models.qwen_vl as qv
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import vision_attention as va

    saved = (qv.segment_attention, llama.prefill_attention)
    kern = vl_embeds(engine, req)
    kern_logits = vl_last_logits(engine, req, kern)
    other_logits = vl_last_logits(engine, other, vl_embeds(engine, other))
    qv.segment_attention = va.segment_attention_plain
    llama.prefill_attention = pa.prefill_attention_plain
    try:
        plain = vl_embeds(engine, req)
        plain_logits = vl_last_logits(engine, req, plain)
    finally:
        qv.segment_attention, llama.prefill_attention = saved
    ref = plain[0][1]
    sd = plain_logits.std().item()
    res = {"what": "kernel_vs_plain_path", "image": "448x448",
           "tower_tokens": int(ref.shape[0]),
           "tower_max_rel_err": ((kern[0][1] - ref).abs().max()
                                 / ref.abs().max()).item(),
           "tower_rtol": VL_TOWER_RTOL,
           "first_token_logit_err_in_std":
               (kern_logits - plain_logits).abs().max().item() / sd,
           "other_image_logit_move_in_std":
               (other_logits - kern_logits).abs().max().item() / sd,
           "tol_in_std": LOGIT_TOL, "plain_logit_std": sd}
    emit({"phase": "vision", **res})
    if res["tower_max_rel_err"] > VL_TOWER_RTOL:
        fail(f"vision (b): the tower's kernel path disagrees with its plain path: {res}")
    if res["first_token_logit_err_in_std"] > LOGIT_TOL:
        fail(f"vision (b): kernel-path logits disagree with the plain path: {res}")
    if res["other_image_logit_move_in_std"] <= LOGIT_TOL:
        fail(f"vision (b): another image does not move the logits: {res}")
    return plain_logits


def vl_tower_trace(engine, req):
    """(b) One tower run on the 1288x728 image under `torch.profiler`:
    its device ms in the segment kernel, the GEMMs and the rest.  The
    wrappers' count must show one segment launch a layer; the profiler
    must have seen the kernel (it may drop the window's first events)."""
    from torch.profiler import ProfilerActivity, profile

    from dynamo_tpu_torch.ops import cuda_attention as ca

    vl_embeds(engine, req)  # warm
    torch.cuda.synchronize()
    ca.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vl_embeds(engine, req)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ca.LAUNCHES["segment_attention"]
    res = device_breakdown(prof, wall)
    emit({"phase": "vision", "what": "tower_trace", "image": "1288x728",
          "patches": 4784, "segment_launches": launches, **res})
    if launches != engine.vision[1].depth:
        fail(f"vision (b): the tower made {launches} segment launches, not one a "
             f"layer")
    if res["groups"].get("segment_attention", {"ms": 0.0})["ms"] <= 0:
        fail(f"vision (b): the tower's trace holds no segment kernel: {res}")


def vl_engine_args(extra=()):
    from dynamo_tpu_torch.worker.__main__ import build_parser

    return build_parser().parse_args(
        ["--control", "127.0.0.1:0", "--model", VL_MODEL, "--seed", str(SEED),
         "--sharpen", "--num-pages", "1024", "--max-num-seqs", "8",
         "--num-layers", str(CUT_LAYERS), *extra])


def vl_requests(pre):
    """(name, preprocessed request) of phase 13 (c)'s traffic."""
    a, b = vl_image(1, 448, 448), vl_image(2, 1288, 728)
    c, d = vl_image(3, 448, 224), vl_image(4, 448, 448)
    video = [vl_image(10 + i, 224, 224) for i in range(4)]
    ask = "Describe what you see in one sentence."
    bodies = {
        "text": vl_chat("Write one line about the sea."),
        "img448": vl_chat(ask, [("image", data_uri(png_bytes(a)))]),
        "img1288x728": vl_chat(ask, [("image", data_uri(png_bytes(b)))]),
        "two_images": vl_chat("Compare the two pictures.",
                              [("image", data_uri(png_bytes(a))),
                               ("image", data_uri(png_bytes(c)))]),
        "video_4_frames": vl_chat("What happens in this clip?",
                                  [("video", data_uri(apng_bytes(video)))]),
        "img448_again": vl_chat(ask, [("image", data_uri(png_bytes(a)))]),
        "img448_other": vl_chat(ask, [("image", data_uri(png_bytes(d)))]),
    }
    reqs = {}
    for name, body in bodies.items():
        r = pre.preprocess_chat(body)
        r["sampling_options"] = {"temperature": 0.0}
        r["stop_conditions"] = {"max_tokens": VL_TOKENS, "ignore_eos": True}
        reqs[name] = r
    return bodies, reqs


def vl_first_flip(engine, req, ref, got):
    """Where two greedy rows part: the plain-prefill logits after the
    common prefix, and the second row's token's gap below the best in std
    units (a near-tie when within LOGIT_TOL)."""
    n = next(i for i, (x, y) in enumerate(zip(ref, got)) if x != y)
    logits = vl_last_logits(engine, req, vl_embeds(engine, req), ref[:n])
    gap = (logits.max() - logits[got[n]]).item() / logits.std().item()
    return {"step": n, "gap_in_std": gap}


def vl_serving(engine, mdc, tok):
    """(c) `TorchEngine` serving Qwen2.5-VL-7B: the one-step engine (the
    main path, its launches counted), then an 8-step engine on the same
    weights; returns (launches, direct texts by name, per-engine rows)."""
    import dataclasses

    from dynamo_tpu_torch.engine import TorchEngine
    from dynamo_tpu_torch.llm import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.backend import StreamPostprocessor
    from dynamo_tpu_torch.ops import cuda_attention as ca

    bodies, reqs = vl_requests(OpenAIPreprocessor(mdc, tok))
    first_wave = ["text", "img448", "img1288x728", "two_images", "video_4_frames"]
    offs = {n: r.get("mm_offsets", []) for n, r in reqs.items()}

    async def serve(eng, count):
        # warm-up: graph captures and the kernels' first use
        await _collect(eng, dict(reqs["text"]))
        eng.clear_kv_blocks()
        torch.cuda.synchronize()
        if count:
            ca.reset_launches()
        t0 = time.perf_counter()
        outs = dict(zip(first_wave, await asyncio.gather(
            *[_collect(eng, dict(reqs[n])) for n in first_wave])))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c0 = eng.metrics().prefix_cached_tokens_total
        outs["img448_again"] = await _collect(eng, dict(reqs["img448_again"]))
        c1 = eng.metrics().prefix_cached_tokens_total
        outs["img448_other"] = await _collect(eng, dict(reqs["img448_other"]))
        c2 = eng.metrics().prefix_cached_tokens_total
        torch.cuda.synchronize()
        launches = dict(ca.LAUNCHES)
        solo = None
        if count:
            # alone from a cold cache, as a worker process serves one chat
            eng.clear_kv_blocks()
            solo = await _collect(eng, dict(reqs["img448"]))
        await eng.shutdown()
        return outs, wall, launches, (c1 - c0, c2 - c1), solo

    arms = {}
    launches = None
    for arm, steps in (("a_steps1", 1), ("b_steps8", 8)):
        eng = engine if steps == 1 else TorchEngine(
            engine.model_cfg, engine.model,
            dataclasses.replace(engine.cfg, decode_steps=steps),
            eos_token_ids=engine.eos_token_ids, device="cuda", vision=engine.vision)
        outs, wall, got_launches, hits, solo = asyncio.run(serve(eng, steps == 1))
        if steps == 1:
            launches, solo_tokens = got_launches, solo["tokens"]
        for name, r in outs.items():
            if r["finish_reason"] != "length" or len(r["tokens"]) != VL_TOKENS:
                fail(f"vision (c) {arm}: {name} ended {r['finish_reason']} with "
                     f"{len(r['tokens'])} tokens")
        run_end = offs["img448"][0] + 256
        arms[arm] = {
            "wall_s": wall,
            "ttft_ms": {n: outs[n]["ttft_ms"] for n in outs},
            "decode_tokens_per_s": sum(VL_TOKENS - 1 for _ in first_wave) / max(
                max(outs[n]["t_last"] for n in first_wave)
                - min(outs[n]["t_first"] for n in first_wave), 1e-9),
            "prefix_hit_same_image": hits[0], "prefix_hit_other_image": hits[1],
            "tokens": {n: outs[n]["tokens"] for n in outs},
        }
        if hits[0] < run_end // 16 * 16:
            fail(f"vision (c) {arm}: the same image again hit {hits[0]} tokens, "
                 f"not its run (to {run_end})")
        if hits[1] != 0:
            fail(f"vision (c) {arm}: another image reused {hits[1]} cached tokens")
        if outs["img448_again"]["tokens"] != outs["img448"]["tokens"]:
            fail(f"vision (c) {arm}: the same image again gave other tokens")
    if min(launches[k] for k in (*ATTENTION_KERNELS, "segment_attention")) <= 0:
        fail(f"vision (c): the one-step engine did not launch every kernel: {launches}")
    ref, got = arms["a_steps1"]["tokens"], arms["b_steps8"]["tokens"]
    flips = {n: vl_first_flip(engine, reqs[n], ref[n], got[n])
             for n in ref if ref[n] != got[n]}
    res = {"what": "serving", "model": VL_MODEL,
           "prompt_tokens": {n: len(r["token_ids"]) for n, r in reqs.items()},
           "media_offsets": offs, "arms": {a: {k: v for k, v in d.items() if k != "tokens"}
                                           for a, d in arms.items()},
           "launches_one_step": launches, "rows_equal_across_engines":
               {n: ref[n] == got[n] for n in ref}, "flips": flips,
           "distinct_rows": len({tuple(t) for t in ref.values()})}
    emit({"phase": "vision", **res})
    for n, f in flips.items():
        if f["gap_in_std"] > LOGIT_TOL:
            fail(f"vision (c): {n} parts across engines beyond a near-tie: {f}")
    if res["distinct_rows"] < len(ref) - 1:  # img448_again repeats img448
        fail(f"vision (c): media do not move the greedy rows: {ref}")
    post = StreamPostprocessor(tok, reqs["img448"]["token_ids"])
    direct = {"img448": "".join(post.push_tokens([t]) for t in solo_tokens)
              + post.flush()}
    # phase 18's reference: the one-step rows and the solo img448 row
    rows = dict(ref, img448_solo=solo_tokens)
    return launches, bodies, direct, reqs, rows


def _stop_all(procs) -> None:
    """Terminate `procs` (last first) and wait for each, killing any that
    outlives 30 s."""
    for p in procs[::-1]:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def live_children() -> list:
    """This process's children that are still there (pid, state, command),
    read from /proc: what the phases before left behind.  Reported, not
    judged: a multiprocessing helper may rightly outlive a phase."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if int(ppid) == me:
            out.append({"pid": int(d), "state": state, "cmd": cmd[:160]})
    return out


def vl_spawn(procs):
    """(d)'s processes, started at the phase's start so their builds run
    beside (a)-(c): the control plane, an encode worker (`--disagg-role
    encode`, its LLM cut to one layer: it runs only the tower), a serving
    worker with `--encode-component encoder` (no tower), phase 18 (d)'s
    ``--tp 2`` worker (its tower on its leader; served as VG_MODEL_TP on
    the same control plane and frontend) and the frontend.  Returns
    (encode worker, serving worker, frontend, start time, tp worker)."""
    t0 = time.perf_counter()
    cp = _spawn(procs, "dynamo_tpu_torch.runtime", "--host", "127.0.0.1",
                "--port", "0", "--log-level", "warning")
    addr = _ready(cp, "READY ", "vision (d): the control plane").split()[1]
    common = ["--control", addr, "--model", VL_MODEL, "--seed", str(SEED),
              "--sharpen", "--status-port", "-1", "--log-level", "warning"]
    enc = _spawn(procs, "dynamo_tpu_torch.worker", *common, "--disagg-role",
                 "encode", "--num-layers", "1", "--num-pages", "64")
    srv = _spawn(procs, "dynamo_tpu_torch.worker", *common, "--encode-component",
                 "encoder", "--num-pages", "1024", "--max-num-seqs", "8",
                 "--num-layers", str(CUT_LAYERS))
    tpw = _spawn(procs, "dynamo_tpu_torch.worker", *common, "--model-name",
                 VG_MODEL_TP, "--tp", str(VG_TP), "--tp-devices",
                 ",".join(["cuda:0"] * VG_TP), "--num-pages", "1024",
                 "--max-num-seqs", "8", "--num-layers", str(CUT_LAYERS))
    front = _spawn(procs, "dynamo_tpu_torch.frontend", "--control", addr,
                   "--host", "127.0.0.1", "--port", "0", "--log-level", "warning")
    return enc, srv, front, t0, tpw


def vl_processes(bodies, direct, spawned):
    """(d) `vl_spawn`'s processes: a chat with a data: PNG over HTTP must
    give (c)'s text."""
    def ready(p, prefix, what, timeout=600):
        return _ready(p, prefix, f"vision (d): {what}", timeout)

    enc, srv, front, t0, _ = spawned
    port = int(ready(front, "READY http://", "the frontend").rsplit(":", 1)[1])
    ready(enc, "READY worker", "the encode worker")
    ready(srv, "READY worker", "the serving worker")
    ready_s = time.perf_counter() - t0
    for _ in range(1200):
        st, models = _http(port, "GET", "/v1/models")
        if st == 200 and VL_MODEL.encode() in models:
            break
        time.sleep(0.1)
    else:
        fail(f"vision (d): the frontend never listed {VL_MODEL}")
    t1 = time.perf_counter()
    st, raw = _http(port, "POST", "/v1/chat/completions", bodies["img448"])
    chat_ms = (time.perf_counter() - t1) * 1e3
    if st != 200:
        fail(f"vision (d): the chat answered {st}: {raw[:300]!r}")
    text = json.loads(raw)["choices"][0]["message"]["content"]
    res = {"what": "processes", "ready_s": ready_s, "chat_ms": chat_ms,
           "body_bytes": len(json.dumps(bodies["img448"])),
           "equals_direct": text == direct["img448"]}
    emit({"phase": "vision", **res})
    if not res["equals_direct"]:
        fail(f"vision (d): the HTTP chat's text differs from the direct run: "
             f"{text!r} vs {direct['img448']!r}")
    return port


def phase_vision(procs):
    """Phase 13 (see the module docstring).  Runs with no other model on
    the card; its processes go into `procs` (the caller stops them after
    phase 18, which uses the control plane, the frontend and the tp
    worker).  Returns (the launches of (c)'s one-step engine, phase 18's
    context: the one-step engine (shut down, its model and tower kept),
    the requests, the reference rows, the frontend's port, the tp
    worker)."""
    from dynamo_tpu_torch.llm import HuggingFaceTokenizer, OpenAIPreprocessor
    from dynamo_tpu_torch.worker.__main__ import build_engine

    t0 = time.perf_counter()
    spawned = vl_spawn(procs)
    vl_golden()
    engine, mdc = build_engine(vl_engine_args())
    # the tokenizer as the frontend loads it from the card
    tok = HuggingFaceTokenizer.from_json_str(
        mdc.tokenizer_json, eos_token_ids=list(mdc.eos_token_ids),
        bos_token_id=mdc.bos_token_id, chat_template=mdc.chat_template)
    emit({"phase": "vision", "what": "model_init", "model": VL_MODEL,
          "weights_gb": torch.cuda.memory_allocated() / 1e9})
    _, reqs = vl_requests(OpenAIPreprocessor(mdc, tok))
    vl_paths(engine, reqs["img448"], reqs["img448_other"])
    tower_ms = time_ms_host(lambda: vl_embeds(engine, reqs["img1288x728"]))
    emit({"phase": "vision", "what": "tower_ms", "image": "1288x728",
          "patches": 4784, "host_clock_ms": tower_ms})
    vl_tower_trace(engine, reqs["img1288x728"])
    launches, bodies, direct, reqs, rows = vl_serving(engine, mdc, tok)
    port = vl_processes(bodies, direct, spawned)
    # (d)'s encode and serving workers are done: their memory back
    _stop_all(list(spawned[:2]))
    emit({"phase": "vision", "what": "done", "seconds": time.perf_counter() - t0})
    return launches, {"engine": engine, "reqs": reqs, "bodies": bodies,
                      "rows": rows, "port": port, "tp_worker": spawned[4],
                      "t_spawn": spawned[3], "tok": tok}


# --------------------------------------------------------------------------- #
# phase 18: vision under groups
# --------------------------------------------------------------------------- #

VG_TP = 2
# (d)'s worker serves under this name beside phase 13's workers
VG_MODEL_TP = VL_MODEL + "-tp2"
VG_WAVE = ("text", "img448", "img1288x728", "two_images", "video_4_frames")
VG_MEDIA = VG_WAVE[1:]


def vg_note(what: str) -> None:
    print(f"vision_groups {what}", file=sys.stderr, flush=True)


def vg_group(ctx, dp, tp, part):
    """A dp x tp group of ranks sharing the card over gloo, on phase 13's
    model (the same seed, sharpened, drawn whole by each rank and
    sliced), its tower on the leader alone: phase 13's tower object."""
    import dataclasses

    from dynamo_tpu_torch.engine import TorchEngine
    from dynamo_tpu_torch.parallel import ParallelConfig, SeededShards

    flat = ctx["engine"]
    cfg = flat.model_cfg
    return TorchEngine(cfg, SeededShards(cfg, SEED, "bfloat16", sharpen=True),
                       dataclasses.replace(flat.cfg, kv_partition=part),
                       eos_token_ids=flat.eos_token_ids,
                       parallel=ParallelConfig(dp=dp, tp=tp),
                       devices=["cuda:0"] * (dp * tp), vision=flat.vision)


def vg_tokens_per_s(res, names):
    """Decode tokens/s of a wave: every request's tokens after its first,
    over the span from the first first token to the last token."""
    span = (max(res[n]["t_last"] for n in names)
            - min(res[n]["t_first"] for n in names))
    return sum(len(res[n]["tokens"]) - 1 for n in names) / max(span, 1e-9)


def vg_check(ctx, res, names):
    """(problems, flips): every request ended with its VL_TOKENS tokens,
    and each row equals phase 13's one-step row up to a near-tie (the gap
    measured by `vl_first_flip` on phase 13's flat model)."""
    problems = [f"{n} ended {res[n]['finish_reason']} with "
                f"{len(res[n]['tokens'])} tokens" for n in names
                if res[n]["finish_reason"] != "length"
                or len(res[n]["tokens"]) != VL_TOKENS]
    flips = {}
    for n in names if not problems else ():
        ref, got = ctx["rows"][n], res[n]["tokens"]
        if got != ref:
            flips[n] = f = vl_first_flip(ctx["engine"], ctx["reqs"][n], ref, got)
            if f["gap_in_std"] > LOGIT_TOL:
                problems.append(f"{n} parts from the flat row beyond a "
                                f"near-tie: {f}")
    return problems, flips


def vg_tp_and_encoded(ctx):
    """(a) A tp 2 group, the tower on the leader: the wave of five at once
    (the kernels warmed by phase 13 in this process) against phase 13's
    rows; each rank's launches;
    the plan's media bytes and host ms a chunk; the tower's ms on the
    leader.  (c) The same group without its tower (``vision=(None,
    vcfg)``), fed the embeddings `disagg.encode.encode_media` computes in
    process: the same wave, from a cleared cache, identical to (a)."""
    from dynamo_tpu_torch.disagg.encode import encode_media

    reqs = ctx["reqs"]
    t0 = time.perf_counter()
    group = vg_group(ctx, 1, VG_TP, False)
    build_s = time.perf_counter() - t0
    vg_note(f"(a) built in {build_s:.1f}s")

    async def wave(eng, batch):
        outs = await asyncio.gather(*[_collect(eng, dict(batch[n]))
                                      for n in VG_WAVE])
        return dict(zip(VG_WAVE, outs))

    async def run():
        try:
            before = await group.group_stats()
            plan0 = dict(group.media_plan)
            t1 = time.perf_counter()
            res = await wave(group, reqs)
            wall = time.perf_counter() - t1
            after = await group.group_stats()
            plan = {k: group.media_plan[k] - plan0[k] for k in plan0}
            tower_ms = time_ms_host(lambda: vl_embeds(group,
                                                      reqs["img1288x728"]))
            vg_note("(a) served; (c) encoding")
            embeds = {n: await encode_media(group, reqs[n]) for n in VG_MEDIA}
            fed = {}
            for n in VG_WAVE:
                r = {k: v for k, v in reqs[n].items() if k != "mm_patches"}
                if n in embeds:
                    r["mm_embeds"] = embeds[n]["mm_embeds"]
                    r["cache_salt"] = embeds[n]["cache_salt"]
                fed[n] = r
            group.clear_kv_blocks()
            tower = group.vision
            group.vision = (None, tower[1])
            try:
                res_c = await wave(group, fed)
            finally:
                group.vision = tower
            return res, wall, before, after, plan, tower_ms, res_c, \
                vars(group.metrics())
        finally:
            await group.shutdown()

    res, wall, before, after, plan, tower_ms, res_c, m = asyncio.run(run())
    problems, flips = vg_check(ctx, res, VG_WAVE)
    launches = _launch_delta(before, after)
    for r, got in launches.items():
        if min(got.get(k, 0) for k in ATTENTION_KERNELS) <= 0:
            problems.append(f"(a) rank {r} launched {got}")
    chunks = max(plan["chunks"], 1)
    out_a = {"phase": "vision_groups", "case": "a", "model": VL_MODEL,
             "layers": ctx["engine"].model_cfg.num_hidden_layers, "tp": VG_TP,
             "backend": m["tp_backend"], "build_s": build_s, "wall_s": wall,
             "greedy_equal": {n: res[n]["tokens"] == ctx["rows"][n]
                              for n in VG_WAVE},
             "flips": flips, "tol_in_std": LOGIT_TOL,
             "ttft_ms": {n: res[n]["ttft_ms"] for n in VG_WAVE},
             "decode_tokens_per_s": vg_tokens_per_s(res, VG_WAVE),
             "media_plan": {"chunks": plan["chunks"], "bytes": plan["bytes"],
                            "bytes_per_chunk": plan["bytes"] / chunks,
                            "ms_per_chunk": plan["ms"] / chunks,
                            "carrier": "the pickled prefill plan"},
             "tower_ms_on_leader": tower_ms, "plans": m["tp_plans_total"],
             "launches_by_rank": launches, "card": card_line()}
    emit(out_a)
    same = {n: res_c[n]["tokens"] == res[n]["tokens"] for n in VG_WAVE}
    out_c = {"phase": "vision_groups", "case": "c",
             "what": "the (a) group without its tower, fed encode_media's "
                     "embeddings", "identical_to_a": same,
             "finish": {n: res_c[n]["finish_reason"] for n in VG_WAVE}}
    emit(out_c)
    if not all(same.values()):
        problems.append(f"(c) differs from (a): {same}")
    return launches, problems


def vg_partitioned(ctx):
    """(b) dp 2 x tp 1, the pool partitioned: the wave sent one request
    after another's first token (so they admit onto both partitions),
    rows against phase 13's; then the first image again (a prefix hit of
    its run, on the partition that holds it) and another image under the
    same text (no hit).  Returns (launches by rank, problems, the
    result line)."""
    reqs = ctx["reqs"]
    t0 = time.perf_counter()
    group = vg_group(ctx, 2, 1, True)
    build_s = time.perf_counter() - t0
    vg_note(f"(b) built in {build_s:.1f}s")
    seqs = {}
    _finish_spy(group, seqs)

    async def run():
        try:
            before = await group.group_stats()
            tasks = []
            t1 = time.perf_counter()
            for n in VG_WAVE:
                first = asyncio.Event()
                tasks.append(asyncio.ensure_future(
                    _collect_as(group, dict(reqs[n]), n, first)))
                await first.wait()
            res = dict(zip(VG_WAVE, await asyncio.gather(*tasks)))
            wall = time.perf_counter() - t1
            after = await group.group_stats()
            hits = []
            for n in ("img448_again", "img448_other"):
                c0 = group.metrics().prefix_cached_tokens_total
                res[n] = await _collect_as(group, dict(reqs[n]), n)
                hits.append(group.metrics().prefix_cached_tokens_total - c0)
            reports = await group.group_reports()
            return res, wall, before, after, hits, reports
        finally:
            await group.shutdown()

    res, wall, before, after, hits, reports = asyncio.run(run())
    names = VG_WAVE + ("img448_again", "img448_other")
    problems, flips = vg_check(ctx, res, names)
    parts = {n: seqs[n][1] for n in names if n in seqs}
    media_parts = {parts.get(n) for n in VG_MEDIA}
    if media_parts != {0, 1}:
        problems.append(f"(b) the media rows did not land on both partitions: "
                        f"{parts}")
    run_end = reqs["img448"]["mm_offsets"][0] + 256
    if hits[0] < run_end // 16 * 16:
        problems.append(f"(b) the same image again hit {hits[0]} tokens, not "
                        f"its run (to {run_end})")
    if parts.get("img448_again") != parts.get("img448"):
        problems.append(f"(b) the same image again ran on partition "
                        f"{parts.get('img448_again')}, its pages on "
                        f"{parts.get('img448')}")
    if hits[1] != 0:
        problems.append(f"(b) another image reused {hits[1]} cached tokens")
    spliced = {r: sorted({i for _, rows in rep["media_rows"] for i in rows})
               for r, rep in reports.items()}
    for r, rep in reports.items():
        for n, rows in rep["media_rows"]:
            if not all(r * n <= i < (r + 1) * n for i in rows):
                problems.append(f"(b) replica {r} spliced rows {rows} of a "
                                f"{n}-row block")
    launches = _launch_delta(before, after)
    out = {"phase": "vision_groups", "case": "b", "dp": 2, "tp": 1,
           "kv_partition": True, "build_s": build_s, "wall_s": wall,
           "partitions": parts, "prefix_hit_same_image": hits[0],
           "prefix_hit_other_image": hits[1],
           "greedy_equal": {n: res[n]["tokens"] == ctx["rows"][n]
                            for n in names},
           "flips": flips, "tol_in_std": LOGIT_TOL,
           "ttft_ms": {n: res[n]["ttft_ms"] for n in names},
           "decode_tokens_per_s": vg_tokens_per_s(res, VG_WAVE),
           "media_rows_spliced": spliced, "launches_by_rank": launches,
           "tower_params_by_rank": {r: rep["tower_params"]
                                    for r, rep in reports.items()},
           "card": card_line()}
    if any(rep["tower_params"] for r, rep in reports.items() if r):
        problems.append(f"(b) a follower holds tower parameters: "
                        f"{out['tower_params_by_rank']}")
    return launches, problems, out


def vg_http(ctx):
    """(d) `python -m dynamo_tpu_torch.worker --tp 2` (spawned with phase
    13's processes) behind phase 13's frontend: phase 13 (d)'s image chat,
    streamed, with each token's string; its tokens phase 13's solo row up
    to a near-tie."""
    tpw, port = ctx["tp_worker"], ctx["port"]
    _ready(tpw, "READY worker", "vision groups (d): the tp 2 worker")
    ready_s = time.perf_counter() - ctx["t_spawn"]
    for _ in range(1200):
        st, models = _http(port, "GET", "/v1/models")
        if st == 200 and VG_MODEL_TP.encode() in models:
            break
        time.sleep(0.1)
    else:
        fail(f"vision groups (d): the frontend never listed {VG_MODEL_TP}")
    import http.client

    body = dict(ctx["bodies"]["img448"], model=VG_MODEL_TP, stream=True,
                logprobs=True)
    got, frames = [], []
    t1 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/v1/chat/completions", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        st = r.status
        for line in r:
            line = line.strip()
            if not line.startswith(b"data: ") or line == b"data: [DONE]":
                continue
            frames.append(time.perf_counter())
            for c in json.loads(line[6:]).get("choices", []):
                got.extend(t["token"] for t in
                           ((c.get("logprobs") or {}).get("content") or []))
    finally:
        conn.close()
    chat_ms = (time.perf_counter() - t1) * 1e3
    tok = ctx["tok"]
    want = ctx["rows"]["img448_solo"]
    res = {"phase": "vision_groups", "case": "d", "status": st,
           "model": VG_MODEL_TP, "ready_s": ready_s, "chat_ms": chat_ms,
           "frames": len(frames), "tokens": len(got),
           "equal": got == [tok.decode([t]) for t in want]}
    problems = []
    if st != 200 or len(got) != VL_TOKENS:
        problems.append(f"(d) the chat answered {st} with {len(got)} tokens")
    elif not res["equal"]:
        j = next(i for i, t in enumerate(want) if tok.decode([t]) != got[i])
        engine, req = ctx["engine"], ctx["reqs"]["img448"]
        lg = vl_last_logits(engine, req, vl_embeds(engine, req), want[:j])
        alt = next((t for t in lg.topk(64).indices.tolist()
                    if tok.decode([t]) == got[j]), None)
        res["flip"] = f = {"index": j, "gap_in_std": None if alt is None else
                           ((lg.max() - lg[alt]) / lg.std()).item()}
        if f["gap_in_std"] is None or f["gap_in_std"] > LOGIT_TOL:
            problems.append(f"(d) the streamed tokens part from the flat row "
                            f"beyond a near-tie: {f}")
    emit(res)
    return problems


def phase_vision_groups(ctx):
    """Phase 18 (see the module docstring), on phase 13's model, requests,
    rows and processes.  Returns {case: launches by rank}."""
    a, problems = vg_tp_and_encoded(ctx)
    b, problems_b, out_b = vg_partitioned(ctx)
    emit(out_b)
    problems += problems_b + vg_http(ctx)
    if problems:
        fail(f"vision groups: {problems}")
    return {"a": a, "b": b}


def vl_probe_main() -> int:
    """The mutation check's probe of media under dp: phase 18 (b) on
    Qwen2.5-VL-7B's full width (the whole tower) at VL_PROBE_LAYERS
    layers, against a flat engine of the same depth serving phase 13
    (c)'s requests one at a time; prints one JSON line with the problems
    it finds (none on the port as it is)."""
    from dynamo_tpu_torch.llm import HuggingFaceTokenizer, OpenAIPreprocessor
    from dynamo_tpu_torch.ops import _build
    from dynamo_tpu_torch.worker.__main__ import build_engine

    _build.build_all()
    engine, mdc = build_engine(vl_engine_args(["--num-layers",
                                               str(VL_PROBE_LAYERS)]))
    tok = HuggingFaceTokenizer.from_json_str(
        mdc.tokenizer_json, eos_token_ids=list(mdc.eos_token_ids),
        bos_token_id=mdc.bos_token_id, chat_template=mdc.chat_template)
    _, reqs = vl_requests(OpenAIPreprocessor(mdc, tok))
    names = VG_WAVE + ("img448_again", "img448_other")

    async def flat_rows():
        try:
            return {n: (await _collect(engine, dict(reqs[n])))["tokens"]
                    for n in names}
        finally:
            await engine.shutdown()

    rows = asyncio.run(flat_rows())
    _, problems, out = vg_partitioned({"engine": engine, "reqs": reqs,
                                       "rows": rows})
    print(json.dumps({"vl_probe": {"partitions": out["partitions"],
                                   "flips": out["flips"],
                                   "problems": problems}}), flush=True)
    return 0


VL_PROBE_LAYERS = 2


# --------------------------------------------------------------------------- #
# phase 14: embeddings, data-parallel ranks, request migration
# --------------------------------------------------------------------------- #

# (a): both paths' vectors are unit vectors, so |a - b| = sqrt(2 - 2 cos).
# A kernel-path vector passes when it lies within EMBED_TOL of the plain
# path's: four bf16 roundings (2^-8 each) of the pooled vector, the size
# of the rounding differences between two bf16 orders of the same layers
# (phase 5's "a few bf16 roundings"); the planted faults (the final norm
# dropped, the mean taken over padded positions, a prefix page attended)
# must move some vector beyond it.  A row alone and inside a 64-input
# batch are held to the same limit, and two different inputs must lie at
# least EMBED_APART limits apart.
EMBED_TOL = 4 * 2.0 ** -8
EMBED_APART = 10
EMBED_FAULTS = ("final norm dropped", "mean over padded positions",
                "a prefix page attended")
# (a)'s timed requests: inputs x tokens
EMBED_TIMED = {"1x512": (1, 512), "8x512": (8, 512), "64x128": (64, 128),
               "1x4096": (1, 4096)}
DP_TOKENS = 16
# (c)'s concurrent round: these of phase 4's prompts, on both ranks at once
DP_CONCURRENT, DP_CONCURRENT_TOKENS = ("A_64", "C_2048", "E_300"), 32
MIGRATE_PROMPT, MIGRATE_TOKENS, MIGRATE_KILL_AT = 1024, 64, 8


class _NoEmbedEngine:
    """A worker's engine without `embed` (its card lacks ``embedding``)."""

    async def generate(self, request, context=None):
        yield {"token_ids": [], "finish_reason": "stop"}


TOKENIZER_PATH = os.path.join(ROOT, "build", "llama3_synthetic_tokenizer.json")
# the thread `main` starts beside the kernels' build to write the tokenizer
_TOKENIZER_WRITER = []


def write_tokenizer(cfg) -> None:
    """Write the seeded tokenizer of `cfg`'s vocabulary to TOKENIZER_PATH."""
    from dynamo_tpu_torch.testing import synthetic_tokenizer_json

    os.makedirs(os.path.dirname(TOKENIZER_PATH), exist_ok=True)
    data = synthetic_tokenizer_json(cfg.vocab_size, SEED)
    with open(TOKENIZER_PATH + ".tmp", "w", encoding="utf-8") as f:
        f.write(data)
    os.replace(TOKENIZER_PATH + ".tmp", TOKENIZER_PATH)


def llama_tokenizer(cfg):
    """The seeded 128256-id tokenizer (`testing.synthetic_tokenizer`'s,
    with its eos and bos ids) from TOKENIZER_PATH, written first when no
    run of this script wrote it (`write_tokenizer`, which `main` starts
    beside the kernels' build)."""
    from dynamo_tpu_torch.llm import HuggingFaceTokenizer

    for t in _TOKENIZER_WRITER:
        t.join()
    if not os.path.exists(TOKENIZER_PATH):
        write_tokenizer(cfg)
    with open(TOKENIZER_PATH, encoding="utf-8") as f:
        tok = HuggingFaceTokenizer(f.read())
    if tok.vocab_size != cfg.vocab_size:
        fail(f"{TOKENIZER_PATH} has {tok.vocab_size} ids, not {cfg.vocab_size}")
    tok.eos_token_ids = [tok.token_to_id("<|end_of_text|>")]
    tok.bos_token_id = tok.token_to_id("<|begin_of_text|>")
    return tok


def embed_inputs(cfg, lens, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
            for n in lens]


def embed_variant(model, rows, fault):
    """`Llama.forward_embed` of `rows` (one call, padded to the longest) on
    the kernels with one planted fault of EMBED_FAULTS."""
    from dynamo_tpu_torch.ops import rms_norm
    from dynamo_tpu_torch.ops.rotary import rope_cos_sin

    c = model.cfg
    B, S = len(rows), max(len(r) for r in rows)
    tokens = torch.zeros((B, S), dtype=torch.long)
    for i, r in enumerate(rows):
        tokens[i, :len(r)] = torch.tensor(r)
    tokens = tokens.cuda()
    lens = torch.tensor([len(r) for r in rows], dtype=torch.int32, device="cuda")
    pre = 16 if fault == "a prefix page attended" else 0
    pool = torch.zeros((1, max(pre, 1), c.num_key_value_heads, c.head_dim_),
                       dtype=model.dtype, device="cuda")
    prefix = torch.full((B,), pre, dtype=torch.int32, device="cuda")
    table = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    positions = torch.arange(S, device="cuda")[None].expand(B, S)
    rope = (*rope_cos_sin(positions, model.inv_freq), model.rope_scale)
    with torch.no_grad():
        x = model.embed[tokens]
        for layer in model.layers:
            x = layer.prefill(x, (pool, pool), rope, table, prefix, lens, None)
        if fault != "final norm dropped":
            x = rms_norm(x, model.final_norm, c.rms_norm_eps)
        n = torch.full_like(lens, S) if fault == "mean over padded positions" else lens
        mask = (torch.arange(S, device="cuda")[None] < n[:, None]).float()
        pooled = (x.float() * mask[..., None]).sum(1) / n.float()[:, None]
        return (pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-9)).cpu()


def _dist(a, b):
    """Distances of rows of unit vectors (|a - b| = sqrt(2 - 2 cos))."""
    return (torch.as_tensor(a, dtype=torch.float32)
            - torch.as_tensor(b, dtype=torch.float32)).norm(dim=-1)


def embed_serving(model, cfg):
    """Phase 14 (a) and (b): `TorchEngine.embed` at the 8B's full width and
    depth, then /v1/embeddings through the in-process stack on the same
    engine.  Returns (a)'s launches."""
    from concurrent.futures import ThreadPoolExecutor

    import dynamo_tpu_torch.models.llama as llama
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.frontend import HttpService, ModelManager, ModelWatcher
    from dynamo_tpu_torch.llm import ModelDeploymentCard
    from dynamo_tpu_torch.ops import cuda_attention as ca
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.testing import tiny_tokenizer
    from dynamo_tpu_torch.worker import serve_engine

    # a group budget of 32 x 512 = 16384 padded tokens: (a)'s eight inputs
    # run in one call at phase 3's embeddings shape
    ecfg = EngineConfig(page_size=16, num_pages=64, max_num_seqs=32,
                        max_prefill_tokens=512, max_model_len=4096)
    engine = TorchEngine(cfg, model, ecfg, device="cuda")
    rows = embed_inputs(cfg, EMBED_LENS, SEED + 31)
    batch64 = embed_inputs(cfg, [128] * 64, SEED + 32)
    real_plain = pa.prefill_attention_plain
    plain_calls = [0]

    def counted(*a, **kw):
        plain_calls[0] += 1
        return real_plain(*a, **kw)

    tok = llama_tokenizer(cfg)
    name = cfg.name

    async def run():
        res = {"budget_tokens": engine.embed_token_budget}
        req = {"embed_token_ids": rows}
        await engine.embed(req)  # the shapes' first use
        torch.cuda.synchronize()
        pa.prefill_attention_plain = counted
        ca.reset_launches()
        try:
            got = await engine.embed(req)
            torch.cuda.synchronize()
        finally:
            pa.prefill_attention_plain = real_plain
        res["launches"] = dict(ca.LAUNCHES)
        res["plain_calls_on_kernel_path"] = plain_calls[0]
        kern = torch.tensor(got["embeddings"])
        saved, llama.prefill_attention = llama.prefill_attention, real_plain
        try:
            plain = torch.tensor((await engine.embed(req))["embeddings"])
        finally:
            llama.prefill_attention = saved
        res["prompt_tokens"] = got["prompt_tokens"]
        res["dist_to_plain"] = _dist(kern, plain).tolist()
        res["fault_dist_to_plain"] = {
            f: _dist(embed_variant(model, rows, f), plain).max().item()
            for f in EMBED_FAULTS}
        alone = (await engine.embed({"embed_token_ids": [batch64[17]]}))["embeddings"]
        inside = (await engine.embed({"embed_token_ids": batch64}))["embeddings"]
        res["alone_vs_64_batch"] = _dist(alone[0], inside[17]).item()
        res["alone_equals_64_batch"] = alone[0] == inside[17]
        pair = _dist(kern[:, None], kern[None]) + 2 * torch.eye(len(rows))
        res["closest_pair_dist"] = pair.min().item()
        res["finite"] = bool(torch.isfinite(kern).all())
        res["norms"] = [kern.norm(dim=-1).min().item(), kern.norm(dim=-1).max().item()]
        res["ms_per_request"] = {}
        for what, (n, L) in EMBED_TIMED.items():
            treq = {"embed_token_ids": embed_inputs(cfg, [L] * n, SEED + 33)}
            await engine.embed(treq)
            torch.cuda.synchronize()
            if what == "1x4096":
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            for _ in range(3):
                await engine.embed(treq)
            torch.cuda.synchronize()
            res["ms_per_request"][what] = (time.perf_counter() - t0) * 1e3 / 3
            if what == "1x4096":
                res["peak_gb_1x4096"] = (torch.cuda.max_memory_allocated() - base) / 1e9

        # (b) the same engine behind the in-process stack
        rt = await DistributedRuntime.detached()
        rt2 = await DistributedRuntime.connect(rt.control_address)
        mdc = ModelDeploymentCard(name=name, tokenizer_json=tok.to_json_str(),
                                  eos_token_ids=tok.eos_token_ids)
        await serve_engine(rt, engine, mdc)
        small = tiny_tokenizer()
        await serve_engine(rt2, _NoEmbedEngine(), ModelDeploymentCard(
            name=name + "-no-embed", tokenizer_json=small.to_json_str()))
        watcher = await ModelWatcher(rt, ModelManager()).start()
        for m in (name, name + "-no-embed"):
            await asyncio.wait_for(watcher.wait_for_model(m), 120)
        http = await HttpService(watcher.manager, host="127.0.0.1", port=0).start()
        loop = asyncio.get_running_loop()
        pool = ThreadPoolExecutor(max_workers=2)

        async def post(body):
            st, raw = await loop.run_in_executor(
                pool, _http, http.port, "POST", "/v1/embeddings", body)
            return st, json.loads(raw)

        try:
            st, body = await post({"model": name, "input": rows})
            vecs = [d["embedding"] for d in body.get("data", [])]
            res["http"] = {
                "status": st, "card_types": mdc.types,
                "equal_to_direct": vecs == got["embeddings"],
                "indices": [d["index"] for d in body.get("data", [])],
                "usage": body.get("usage"), "object": body.get("object"),
                "unknown_model": (await post({"model": "nope", "input": "x"}))[0],
                "model_without_embedding": (await post(
                    {"model": name + "-no-embed", "input": "x"}))[0],
                "too_many_inputs": (await post(
                    {"model": name, "input": [[1]] * 65}))[0]}
        finally:
            await http.stop()
            await watcher.stop()
            await rt2.shutdown(graceful=False)
            await rt.shutdown(graceful=False)
            await engine.shutdown()
        return res

    res = asyncio.run(run())
    emit({"phase": "embeddings", "model": cfg.name, "inputs": EMBED_LENS,
          "tol": EMBED_TOL, **res, "card": card_line()})
    if res["launches"]["prefill_attention"] <= 0:
        fail(f"embeddings: the prefill kernel did not launch: {res['launches']}")
    if res["plain_calls_on_kernel_path"]:
        fail("embeddings: the plain attention ran on the card")
    if not res["finite"] or res["prompt_tokens"] != sum(EMBED_LENS):
        fail(f"embeddings: bad vectors or token count: {res['prompt_tokens']}")
    if max(res["dist_to_plain"]) > EMBED_TOL:
        fail(f"embeddings: kernel path vs plain path {res['dist_to_plain']}")
    for f, d in res["fault_dist_to_plain"].items():
        if d <= EMBED_TOL:
            fail(f"embeddings: the check cannot see a planted fault: {f} ({d})")
    if res["alone_vs_64_batch"] > EMBED_TOL:
        fail(f"embeddings: a row alone and in a batch differ: {res['alone_vs_64_batch']}")
    if res["closest_pair_dist"] < EMBED_APART * EMBED_TOL:
        fail(f"embeddings: two inputs lie too close: {res['closest_pair_dist']}")
    h = res["http"]
    if not (h["status"] == 200 and h["equal_to_direct"]
            and h["indices"] == list(range(len(EMBED_LENS)))
            and h["usage"] == {"prompt_tokens": sum(EMBED_LENS),
                               "total_tokens": sum(EMBED_LENS)}
            and h["object"] == "list" and "embedding" in h["card_types"]
            and (h["unknown_model"], h["model_without_embedding"],
                 h["too_many_inputs"]) == (404, 400, 400)):
        fail(f"embeddings over HTTP: {h}")
    return res["launches"]


def dp_ranks_serving(model, cfg, direct):
    """Phase 14 (c): a `DpRankEngine` of two 512-page `TorchEngine`s on the
    8B's weights, served by `serve_engine` (per-rank KV events and
    metrics) with the worker's status server, behind a `python -m
    dynamo_tpu_torch.frontend --router-mode kv` process; an observer
    `KvRouter` here reads the same streams.  Phase 10's two 1024-token
    prefixes sent rank-less straight to the worker (the worker alternates
    ranks, so one prefix lands on each), then each with a new suffix
    through the kv frontend (each must go to the rank holding it, whose
    prefix-cache counter rises by the prefix); four rank-less requests of
    phase 4's greedy prompts (they alternate ranks and give phase 7's
    tokens up to a near-tie); the concurrent round (`dp_concurrent`); the
    status server's /metrics against the ranks' sums; an embed with
    ``dp_rank`` 1.  Returns the launches."""
    from concurrent.futures import ThreadPoolExecutor
    from types import SimpleNamespace

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.llm import ModelDeploymentCard
    from dynamo_tpu_torch.ops import cuda_attention as ca
    from dynamo_tpu_torch.router import KvRouter
    from dynamo_tpu_torch.router.worker_key import pack_worker
    from dynamo_tpu_torch.runtime import Context, DistributedRuntime
    from dynamo_tpu_torch.tokens import compute_block_hash_for_seq
    from dynamo_tpu_torch.worker import DpRankEngine, serve_engine
    from dynamo_tpu_torch.worker.__main__ import start_status_server

    tok = llama_tokenizer(cfg)
    name = cfg.name
    ecfg = EngineConfig(page_size=16, num_pages=512, max_num_seqs=8,
                        max_prefill_tokens=512, max_model_len=4096)
    ranks = [TorchEngine(cfg, model, ecfg, eos_token_ids=tok.eos_token_ids,
                         device="cuda") for _ in range(2)]
    dp = DpRankEngine(ranks)
    embeds_on = []
    for r, e in enumerate(ranks):
        async def embed(request, context=None, _r=r, _inner=e.embed):
            embeds_on.append(_r)
            return await _inner(request, context)
        e.embed = embed
    _, first, again, _, warm = router_prompts(cfg)
    _, prompts = serving_prompts(cfg)
    rankless_prompts = ["A_64", "E_300", "A_64", "E_300"]

    def served_by(before):
        after = [e.metrics().num_requests_total for e in ranks]
        moved = [r for r in range(2) if after[r] != before[r]]
        return moved[0] if len(moved) == 1 else moved

    async def run():
        loop = asyncio.get_running_loop()
        pool = ThreadPoolExecutor(max_workers=2)
        res = {}
        rt = await DistributedRuntime.detached()
        mdc = ModelDeploymentCard(name=name, tokenizer_json=tok.to_json_str(),
                                  eos_token_ids=tok.eos_token_ids)
        served = await serve_engine(rt, dp, mdc)
        inst = served.instance.instance_id
        keys = [pack_worker(inst, r) for r in range(2)]
        res["publishers"] = {
            "kv": [p.worker_id for p in served.kv_publisher],
            "metrics": [p.worker_id for p in served.metrics_publisher]}
        res["model_card"] = {"types": mdc.types,
                       "total_kv_blocks": mdc.runtime_config.total_kv_blocks,
                       "max_num_seqs": mdc.runtime_config.max_num_seqs}
        status = await start_status_server(dp, SimpleNamespace(
            status_port=0, namespace="dynamo", component="backend"))
        # one SSE frame a token: the rounds count the frames
        front = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "dynamo_tpu_torch.frontend", "--control",
            rt.control_address, "--host", "127.0.0.1", "--port", "0",
            "--router-mode", "kv", "--no-sse-coalesce", "--log-level",
            "warning", cwd=ROOT, stdout=asyncio.subprocess.PIPE)
        front_rt = await DistributedRuntime.connect(rt.control_address)
        client = await front_rt.namespace("dynamo").component("backend") \
            .endpoint("generate").client().start()
        observer = await KvRouter(front_rt, "dynamo", "backend", client,
                                  block_size=16).start()

        async def until(cond, what, limit=ROUTER_WAIT_S):
            t0 = time.perf_counter()
            while not cond():
                if time.perf_counter() - t0 > limit:
                    fail(f"dp ranks: timed out waiting for {what}")
                await asyncio.sleep(0.02)

        def idle():
            st = observer.worker_states
            return all(k in st and st[k].kv_usage == 0 for k in keys)

        try:
            for r, prompt in enumerate(warm):  # each rank's first graphs
                await _collect(ranks[r], _req(prompt, max_tokens=4))
            ready = (await asyncio.wait_for(front.stdout.readline(), 180)).decode()
            if not ready.startswith("READY http://"):
                fail(f"dp ranks: the frontend printed {ready!r}")
            port = int(ready.strip().rsplit(":", 1)[1])
            for _ in range(1800):
                st, models = await loop.run_in_executor(
                    pool, _http, port, "GET", "/v1/models")
                if st == 200 and name.encode() in models:
                    break
                await asyncio.sleep(0.1)
            else:
                fail(f"dp ranks: the frontend never listed {name}")

            async def rankless(toks, max_tokens=DP_TOKENS):
                """Straight to the worker with no dp_rank: (rank, tokens)."""
                before = [e.metrics().num_requests_total for e in ranks]
                got = []
                async for out in client.round_robin(
                        _req(toks, max_tokens=max_tokens), Context()):
                    got += out.get("token_ids", [])
                return served_by(before), got

            async def send(toks):
                await until(idle, "idle load publications of both ranks")
                await asyncio.sleep(0.3)  # the frontend's router reads them too
                before = [e.metrics().num_requests_total for e in ranks]
                cached = [e.metrics().prefix_cached_tokens_total for e in ranks]
                st, _, finish, t0, stamps = await loop.run_in_executor(
                    pool, _http_stream, port, "/v1/completions",
                    {"model": name, "prompt": toks, "max_tokens": DP_TOKENS,
                     "temperature": 0.0, "nvext": {"ignore_eos": True}})
                if st != 200 or finish != "length" or len(stamps) != DP_TOKENS:
                    fail(f"dp ranks: the kv frontend answered {st}, {finish}")
                await until(lambda: served_by(before) in (0, 1), "the rank's count")
                r = served_by(before)
                return r, ranks[r].metrics().prefix_cached_tokens_total - cached[r]

            ca.reset_launches()
            cold = [await rankless(p) for p in first]
            for (r, _), p in zip(cold, first):
                hashes = compute_block_hash_for_seq(p[:ROUTER_PREFIX], 16)
                await until(lambda: observer.index.find_matches(hashes).get(
                    keys[r], 0) >= len(hashes), "the prefix's blocks indexed")
            back = [await send(p) for p in again]
            res["kv_routed"] = {"cold_ranks": [r for r, _ in cold],
                                "return_ranks": [r for r, _ in back],
                                "return_cached_tokens": [c for _, c in back]}
            # rank-less requests straight to the worker: the ranks alternate
            res["rankless"] = []
            for n in rankless_prompts:
                r, got = await rankless(prompts[n][0], max_tokens=32)
                flip = first_flip(model, cfg, prompts[n][0],
                                  direct["tokens"][n], got)
                res["rankless"].append({"request": n, "rank": r, "flip": flip})
            res["concurrent"] = await dp_concurrent(
                model, cfg, ranks, client, inst, prompts, direct, until)
            launches = dict(ca.LAUNCHES)
            # the worker's /metrics: the aggregate of the ranks
            per = [vars(e.metrics()) for e in ranks]
            st, raw = await loop.run_in_executor(pool, _http, status.port,
                                                 "GET", "/metrics")
            text = raw.decode()
            res["metrics"] = {
                k: {"worker": _metric_sum(text, f"dynamo_tpu_worker_{k}"),
                    "sum_of_ranks": float(sum(m[k] for m in per))}
                for k in ("num_requests_total", "kv_total_pages",
                          "ttft_attributed_total", "kv_watermark_headroom_pages",
                          "decode_rung1_dispatches_total")}
            # an embed for rank 1 through the worker's endpoint
            out = [o async for o in client.direct(
                {"embed_token_ids": [first[0][:256]], "dp_rank": 1}, inst, Context())]
            res["embed_dp_rank_1"] = {"ranks": list(embeds_on),
                                      "vectors": len(out[0].get("embeddings", []))}
        finally:
            front.terminate()
            await front.wait()
            await observer.stop()
            await client.stop()
            await status.stop()
            await front_rt.shutdown(graceful=False)
            await rt.shutdown(graceful=False)
            await dp.shutdown()
        return res, launches

    res, launches = asyncio.run(run())
    emit({"phase": "dp_ranks", "model": cfg.name, "ranks": 2, **res,
          "launches": launches, "card": card_line()})
    kr = res["kv_routed"]
    if kr["return_ranks"] != kr["cold_ranks"]:
        fail(f"dp ranks: a returning prompt left its prefix's rank: {kr}")
    if min(kr["return_cached_tokens"]) < ROUTER_PREFIX:
        fail(f"dp ranks: a returning prompt missed its prefix: {kr}")
    if kr["cold_ranks"] not in ([0, 1] * (ROUTER_PREFIXES // 2),
                                [1, 0] * (ROUTER_PREFIXES // 2)):
        fail(f"dp ranks: rank-less prefixes did not alternate: {kr}")
    ranks_seen = [r["rank"] for r in res["rankless"]]
    if ranks_seen not in ([0, 1, 0, 1], [1, 0, 1, 0]):
        fail(f"dp ranks: rank-less requests did not alternate: {ranks_seen}")
    for r in res["rankless"]:
        f = r["flip"]
        if f is not None and (f["margin_std"] is None or f["margin_std"] > LOGIT_TOL):
            fail(f"dp ranks: {r['request']} differs from phase 4 beyond a near-tie: {f}")
    for k, v in res["metrics"].items():
        if v["worker"] != v["sum_of_ranks"]:
            fail(f"dp ranks: the worker's {k} is not the sum of the ranks: {v}")
    inst_keys = res["publishers"]
    if len(set(inst_keys["kv"])) != 2 or inst_keys["kv"] != inst_keys["metrics"]:
        fail(f"dp ranks: per-rank publishers {inst_keys}")
    mc = res["model_card"]
    if mc["total_kv_blocks"] != 2 * 511 or "embedding" not in mc["types"]:
        fail(f"dp ranks: the model card {mc}")
    if res["embed_dp_rank_1"] != {"ranks": [1], "vectors": 1}:
        fail(f"dp ranks: the embed for rank 1: {res['embed_dp_rank_1']}")
    if min(launches[k] for k in ATTENTION_KERNELS) <= 0:
        fail(f"dp ranks: not every attention kernel launched: {launches}")
    c = res["concurrent"]
    for r in c["requests"]:
        f = r["flip"]
        if r["tokens"] != DP_CONCURRENT_TOKENS or (f is not None and (
                f["margin_std"] is None or f["margin_std"] > LOGIT_TOL)):
            fail(f"dp ranks: concurrent {r} differs from phase 4 beyond a near-tie")
    if min(len(k) for k in c["new_graphs"]) == 0:
        fail(f"dp ranks: a rank captured no new graph in the concurrent round: {c}")
    for rank in c["new_graphs"]:
        for key, got in rank.items():
            want = c["expected_per_replay"].get(key)
            if want is not None and got != want:
                fail(f"dp ranks: graph {key} records {got} launches a replay, "
                     f"its block launches {want}")
    shared = set(c["new_graphs"][0]) & set(c["new_graphs"][1])
    if any(c["new_graphs"][0][k] != c["new_graphs"][1][k] for k in shared):
        fail(f"dp ranks: one key's graphs record different launches: {c}")
    if c["launches"] != c["expected_launches"]:
        fail(f"dp ranks: the concurrent round counted {c['launches']} launches, "
             f"its replays, warm-ups and eager passes make {c['expected_launches']}")
    return launches


async def dp_concurrent(model, cfg, ranks, client, inst, prompts, direct, until):
    """Phase 14 (c)'s concurrent round: phase 4's greedy prompts of
    DP_CONCURRENT sent to both ranks at once (``dp_rank`` explicit), with
    top logprobs (a decode variant no earlier request of the phase took)
    and a 2048-token row (a table width the ranks have not seen), so each
    rank captures new graphs while the other prefills, replays and
    captures.  Returns the tokens with their first flip from phase 4's, the
    new graphs' launches per replay with what their blocks launch, and the
    registry's launches over the round with what the ranks' replays, the
    new graphs' warm-up runs (one eager run of the block each) and eager
    prefill passes make."""
    from dynamo_tpu_torch.ops import cuda_attention as ca
    from dynamo_tpu_torch.runtime import Context

    L = cfg.num_hidden_layers
    before_keys = [set(e.graphs.keys) for e in ranks]
    for e in ranks:
        e.dispatch_trace = []
        for k in e.graphs.replayed_launches:
            e.graphs.replayed_launches[k] = 0
    start = dict(ca.LAUNCHES)

    async def one(rank, name):
        req = _req(prompts[name][0], max_tokens=DP_CONCURRENT_TOKENS)
        req["sampling_options"]["top_logprobs"] = 2
        req["dp_rank"] = rank
        got = []
        async for out in client.direct(req, inst, Context()):
            got += out.get("token_ids", [])
        return got

    sent = [(r, n) for n in DP_CONCURRENT for r in range(2)]
    outs = await asyncio.gather(*(one(r, n) for r, n in sent))
    await until(lambda: all(e.metrics().active_seqs == 0 for e in ranks),
                "both ranks idle")
    end = dict(ca.LAUNCHES)
    passes = [sum(d["kind"] in ("prefill", "mixed") for d in e.dispatch_trace)
              for e in ranks]
    for e in ranks:
        e.dispatch_trace = None
    new_graphs, expected_per_replay = [], {}
    for e, old in zip(ranks, before_keys):
        per = {s["key"]: s["launches_per_replay"] for s in e.graphs.graph_stats()}
        new = [k for k in e.graphs.keys if k not in old]
        new_graphs.append({repr(k): per[repr(k)] for k in new})
        for k in new:
            if k[0] == "decode":  # T steps, one decode attention a layer
                expected_per_replay[repr(k)] = {
                    n: (k[1] * L if n in ("decode_attention", "decode_merge")
                        else 0) for n in ca.LAUNCHES}
    expected = {n: sum(e.graphs.replayed_launches[n] for e in ranks)
                + sum(g[n] for rank in new_graphs for g in rank.values())
                + (L * sum(passes) if n == "prefill_attention" else 0)
                for n in ca.LAUNCHES}
    return {"requests": [
                {"request": n, "rank": r, "tokens": len(got),
                 "flip": first_flip(model, cfg, prompts[n][0],
                                    direct["tokens"][n], got)}
                for (r, n), got in zip(sent, outs)],
            "new_graphs": new_graphs, "expected_per_replay": expected_per_replay,
            "eager_prefill_passes": passes,
            "launches": {n: end[n] - start[n] for n in ca.LAUNCHES},
            "expected_launches": expected}


def text_flip(model, cfg, prompt, ref_text, got_text, n):
    """Where a greedy text `got_text` parts from `ref_text` (both `n`
    tokens after `prompt`): the reference tokens are regenerated on the
    eager prefill path from this process's copy of the weights and
    detokenized; returns the index of the first token whose text leaves
    the common prefix and the top-2 gap of the reference logits there in
    logit std (a near-tie when within LOGIT_TOL)."""
    tok = llama_tokenizer(cfg)
    common = 0
    while (common < min(len(ref_text), len(got_text))
           and ref_text[common] == got_text[common]):
        common += 1
    toks = []
    for j in range(n):
        lg = reference_logits(model, cfg, prompt + toks)
        nxt = int(lg.argmax())
        if len(tok.decode(toks + [nxt])) > common:  # token j leaves it
            top = lg.topk(2).values
            text = tok.decode(toks)
            return {"index": j, "common_chars": common,
                    "reproduces_reference": text == ref_text[:len(text)],
                    "top2_gap_std": ((top[0] - top[1]) / lg.std()).item()}
        toks.append(nxt)
    return {"index": None, "common_chars": common, "top2_gap_std": None}


def migration_spawn(procs, cfg, layers):
    """Phase 14 (d)'s processes, started at the phase's start so their
    builds run beside (a)-(c): the control plane, two `python -m
    dynamo_tpu_torch.worker` processes (the 8B from the same `--seed`,
    sharpened, full width cut to `layers` layers) and a round-robin
    frontend.  Returns (workers, frontend, start time)."""
    t0 = time.perf_counter()
    cp = _spawn(procs, "dynamo_tpu_torch.runtime", "--host", "127.0.0.1",
                "--port", "0", "--log-level", "warning")
    addr = _ready(cp, "READY ", "migration: the control plane").split()[1]
    common = ["--control", addr, "--model", cfg.name, "--seed", str(SEED),
              "--sharpen", "--num-layers", str(layers), "--num-pages", "256",
              "--status-port", "0", "--log-level", "warning"]
    workers = [_spawn(procs, "dynamo_tpu_torch.worker", *common)
               for _ in range(2)]
    # one SSE frame a token: the migrated stream's frames are counted
    front = _spawn(procs, "dynamo_tpu_torch.frontend", "--control", addr,
                   "--host", "127.0.0.1", "--port", "0", "--no-sse-coalesce",
                   "--log-level", "warning")
    return workers, front, t0


def migration_processes(cfg, layers, spawned):
    """Phase 14 (d) on `migration_spawn`'s processes, on the one card.  A
    greedy SSE request of MIGRATE_TOKENS on a 1024-token
    prompt, undisturbed; then again, with the worker serving it killed
    (SIGKILL) after its MIGRATE_KILL_AT-th token: the client must get every
    token, the undisturbed text (up to a near-tie), and the frontend's
    `dynamo_frontend_migrations_total` must read 1; a later request goes
    to the survivor."""
    cut = cfg.with_depth(layers)
    g = torch.Generator().manual_seed(SEED + 41)
    prompt = torch.randint(0, cfg.vocab_size, (MIGRATE_PROMPT,), generator=g).tolist()
    after = torch.randint(0, cfg.vocab_size, (64,), generator=g).tolist()
    body = {"model": cfg.name, "prompt": prompt, "max_tokens": MIGRATE_TOKENS,
            "temperature": 0.0, "nvext": {"ignore_eos": True}}
    out = {}
    workers, front, t0 = spawned
    port = int(_ready(front, "READY http://", "migration: the frontend")
               .rsplit(":", 1)[1])
    status = [int(_ready(w, "STATUS ", "migration: a worker").rsplit(":", 1)[1])
              for w in workers]
    for w in workers:
        _ready(w, "READY worker", "migration: a worker")
    out["ready_s"] = time.perf_counter() - t0

    def stats(i):
        st, raw = _http(status[i], "GET", "/metrics.json")
        if st != 200:
            fail(f"migration: a worker's /metrics.json answered {st}")
        return json.loads(raw)

    for _ in range(1200):  # both cards discovered
        st, models = _http(port, "GET", "/v1/models")
        if st == 200 and cfg.name.encode() in models:
            break
        time.sleep(0.1)
    else:
        fail(f"migration: the frontend never listed {cfg.name}")
    time.sleep(1.0)
    # one short request each (round robin): each worker's first graphs
    for _ in range(2):
        st, _, finish, _, _ = _http_stream(port, "/v1/completions",
                                           {**body, "prompt": after,
                                            "max_tokens": 4})
        if st != 200 or finish != "length":
            fail(f"migration: the warm-up answered {st}, {finish}")
    st, want, finish, _, stamps = _http_stream(port, "/v1/completions", body)
    if st != 200 or finish != "length" or len(stamps) != MIGRATE_TOKENS:
        fail(f"migration: the undisturbed run answered {st}, {finish}")
    killed = {}

    def on_frame(n):
        if n == MIGRATE_KILL_AT and not killed:
            serving = [i for i in range(2) if stats(i)["active_seqs"] > 0]
            if len(serving) != 1:
                fail(f"migration: serving workers {serving}")
            killed["worker"] = serving[0]
            killed["t"] = time.perf_counter()
            workers[serving[0]].kill()
            workers[serving[0]].wait()

    st, got, finish, t_send, stamps = _http_stream(
        port, "/v1/completions", body, on_frame=on_frame)
    survivor = 1 - killed["worker"]
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    out["migrated"] = {
        "status": st, "finish": finish, "tokens": len(stamps),
        "killed_worker": killed["worker"],
        "equal_to_undisturbed": got == want,
        "longest_gap_ms_at_kill": max(gaps[MIGRATE_KILL_AT - 1:]) * 1e3,
        "median_gap_ms": sorted(gaps)[len(gaps) // 2] * 1e3}
    if got != want:  # the margin on the workers' model, drawn here
        out["migrated"]["flip"] = text_flip(
            tp_flat_twin(cfg, layers)[0], cut, prompt, want, got,
            MIGRATE_TOKENS)
    n_before = stats(survivor)["num_requests_total"]
    st2, _, finish2, _, _ = _http_stream(port, "/v1/completions",
                                         {**body, "prompt": after,
                                          "max_tokens": 8})
    out["after_kill"] = {"status": st2, "finish": finish2,
                         "survivor_requests": stats(survivor)["num_requests_total"]
                         - n_before}
    st, raw = _http(port, "GET", "/metrics")
    text = raw.decode()
    out["migrations_total"] = _metric_sum(text, "dynamo_frontend_migrations_total")
    out["migration_exhausted_total"] = _metric_sum(
        text, "dynamo_frontend_migration_exhausted_total")
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "migration", "model": cfg.name, "layers": cfg.num_hidden_layers,
          "prompt_tokens": MIGRATE_PROMPT, **out, "card": card_line()})
    m = out["migrated"]
    if m["status"] != 200 or m["finish"] != "length" or m["tokens"] != MIGRATE_TOKENS:
        fail(f"migration: the migrated stream {m}")
    if not m["equal_to_undisturbed"]:
        f = m["flip"]
        if f["top2_gap_std"] is None or f["top2_gap_std"] > LOGIT_TOL:
            fail(f"migration: the migrated text differs beyond a near-tie: {f}")
    if out["migrations_total"] != 1 or out["migration_exhausted_total"]:
        fail(f"migration: the frontend counted {out['migrations_total']} migrations")
    a = out["after_kill"]
    if a["status"] != 200 or a["finish"] != "length" or a["survivor_requests"] != 1:
        fail(f"migration: the request after the kill {a}")


def phase_embed_dp_migration(model, cfg, direct):
    """Phase 14 (a)-(d); returns {path: launches} of (a) and (c)."""
    procs = []
    try:
        spawned = migration_spawn(procs, cfg, CUT_LAYERS)
        embed_launches = embed_serving(model, cfg)
        dp_launches = dp_ranks_serving(model, cfg, direct)
        torch.cuda.empty_cache()  # (d)'s workers need the room
        migration_processes(cfg, CUT_LAYERS, spawned)
    finally:
        _stop_all(procs)
    return {"embeddings direct (phase 14 a, this slice's path)": embed_launches,
            "dp ranks kv-routed (phase 14 c)": dp_launches}


# --------------------------------------------------------------------------- #
# phase 15: tensor parallelism over torch.distributed
# --------------------------------------------------------------------------- #

# the engine of phases 4 and 11, on every tp group of this phase
TP_ECFG = dict(page_size=16, num_pages=1024, max_num_seqs=8,
               max_prefill_tokens=512, max_model_len=4096)
# (b): Llama-3-70B's published widths, cut to this many layers (4 before
# PR 15)
TP_70B_LAYERS = 2
# the planted faults of (a), each in a copy of the port: (file, a text of
# it, its faulty replacement); each text occurs once
TP_FAULTS = {
    "no all-reduce after w_down": (
        "dynamo_tpu_torch/models/llama.py",
        "        return self._row_out(act.to(x.dtype), self.w_down)\n",
        "        return self._proj(act.to(x.dtype), self.w_down)\n"),
    "kv heads sharded in the wrong order": (
        "dynamo_tpu_torch/models/llama.py",
        "        t.copy_((shard(w, axis, rank, tp) * scale).to(dtype))\n",
        "        kv = (axis == 1 and t.shape[-1]\n"
        "              == cfg.num_key_value_heads // tp * cfg.head_dim_)\n"
        "        t.copy_((shard(w, axis, tp - 1 - rank if kv else rank, tp)\n"
        "                 * scale).to(dtype))\n"),
    "a follower skips one dispatch": (
        "dynamo_tpu_torch/engine/lockstep.py",
        "            engine.replay(desc, inputs)\n",
        "            engine.__dict__['_n'] = engine.__dict__.get('_n', 0) + (\n"
        "                kind == 'decode')\n"
        "            if engine._n != 3:\n"
        "                engine.replay(desc, inputs)\n"),
}
# the faults run on (a)'s model cut to this depth (full width), their
# model collectives timing out after this many seconds
TP_FAULT_LAYERS = 2
TP_FAULT_TIMEOUT_S = 3
# gloo all-reduces of CUDA tensors between two ranks on the card, at the
# shapes phase 15 (a) sums: a decode step's row-parallel output, a
# 512-token chunk's, and a decode step's logits
TP_COLLECTIVES = {"decode [8, 4096] f32": (8, 4096),
                  "prefill chunk [512, 4096] f32": (512, 4096),
                  "decode logits [8, 128256] f32": (8, 128256)}
TP_GREEDY = ("A_64", "B_shared+200", "C_2048", "E_300")
# the stage handoffs of phase 19 (a) as broadcasts between two ranks on the
# card (`collectives.stage_handoff`): a decode tick's activations of one
# microbatch (4 rows), a 512-token prefill tick's of one row, bf16
PP_HANDOFFS = {"decode tick [4, 4096] bf16": (4, 4096),
               "prefill tick [1, 512, 4096] bf16": (1, 512, 4096)}


def tp_serve(cfg, source, tp, reqs, warm, trace=()):
    """`TorchEngine(parallel=ParallelConfig(tp))` over `source`, its ranks
    sharing the card (gloo): a warm-up request, then every request at
    once; returns (results, wall s, build s, launches per rank over the
    wave, metrics).  With `trace`, the named requests are repeated alone
    from a cleared cache under `torch.profiler` on the leader: its device
    breakdown and its host time inside the all-reduces go into the
    metrics as ``trace``."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.ops import cuda_attention as ca
    from dynamo_tpu_torch.parallel import ParallelConfig

    ca.reset_launches()
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, source, EngineConfig(**TP_ECFG),
                         parallel=ParallelConfig(tp=tp),
                         devices=["cuda:0"] * tp)
    build_s = time.perf_counter() - t0

    async def run():
        try:
            await _collect(engine, warm)
            before = await engine.group_stats()
            t1 = time.perf_counter()
            outs = await asyncio.gather(*[_collect(engine, r)
                                          for r in reqs.values()])
            wall = time.perf_counter() - t1
            after = await engine.group_stats()
            m = vars(engine.metrics())
            if trace:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t2 = time.perf_counter()
                    for n in trace:
                        engine.clear_kv_blocks()
                        await _collect(engine, reqs[n])
                    torch.cuda.synchronize()
                    solo_wall = time.perf_counter() - t2
                m["trace"] = {**device_breakdown(prof, solo_wall),
                              "requests": list(trace), **allreduce_host(prof)}
        finally:
            await engine.shutdown()
        return outs, wall, before, after, m

    outs, wall, before, after, m = asyncio.run(run())
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    launches = {r: {k: n - before[r].get(k, 0) for k, n in after[r].items()}
                for r in sorted(after)}
    return dict(zip(reqs, outs)), wall, build_s, launches, m


def allreduce_host(prof) -> dict:
    """The leader's host events of the collectives (calls and seconds
    inside, by the profiler's name: a gloo all-reduce of a CUDA tensor
    returns once the sum is back on the device)."""
    return {"collectives_host": {
        evt.key: {"calls": evt.count, "s": evt.cpu_time_total / 1e6}
        for evt in prof.key_averages()
        if evt.device_type == torch.autograd.DeviceType.CPU
        and any(k in evt.key.lower() for k in ("allreduce", "all_reduce",
                                                "broadcast", "gloo"))}}


def _tp_bench_rank(rank, init, q, go):
    """One rank of `tp_collective_costs`: it joins the group, then waits
    for `go` before it measures."""
    import torch.distributed as dist

    from dynamo_tpu_torch.parallel import ParallelConfig, make_mesh
    from dynamo_tpu_torch.parallel.collectives import broadcast_bytes

    group = make_mesh(ParallelConfig(tp=2), ["cuda:0"] * 2, rank=rank,
                      init_method=init)
    out = {}
    try:
        if not go.wait(900):
            return
        for name, shape in TP_COLLECTIVES.items():
            t = torch.randn(shape, device="cuda")
            for _ in range(3):
                dist.all_reduce(t, group=group.dev_group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                dist.all_reduce(t, group=group.dev_group)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / 20
            out[name] = {"ms": ms, "bytes": t.numel() * 4,
                         "gb_per_s": t.numel() * 4 / ms / 1e6}
        for name, shape in PP_HANDOFFS.items():
            # as `stage_handoff` moves it: the tensor's bytes
            t = torch.randn(shape, device="cuda").to(torch.bfloat16)
            nbytes = t.numel() * t.element_size()
            for _ in range(3):
                broadcast_bytes(t, 0, group.dev_group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                broadcast_bytes(t, 0, group.dev_group)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / 20
            out[f"broadcast {name}"] = {"ms": ms, "bytes": nbytes,
                                        "gb_per_s": nbytes / ms / 1e6}
    finally:
        group.close()
    if rank == 0:
        q.put(out)


def tp_collective_ranks():
    """Start `tp_collective_costs`' two ranks (spawned processes, which
    import and join their group while the caller goes on); returns what
    `tp_collective_costs` takes."""
    import multiprocessing as mp

    from dynamo_tpu_torch.parallel.mesh import free_port

    ctx = mp.get_context("spawn")
    q, go = ctx.Queue(), ctx.Event()
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_tp_bench_rank, args=(r, init, q, go),
                         daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    return procs, q, go


def tp_collective_costs(ranks):
    """Host-clock ms of one gloo all-reduce of a CUDA tensor between two
    ranks sharing the card (`tp_collective_ranks`, told to measure now,
    with the card otherwise idle), at TP_COLLECTIVES' shapes: what a tp
    step pays on one card for each collective; and of one broadcast at
    PP_HANDOFFS' shapes, a pipeline's stage handoff (phase 19)."""
    procs, q, go = ranks
    go.set()
    try:
        out = q.get(timeout=300)
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.terminate()
    emit({"phase": "tp", "case": "collectives", "backend": "gloo",
          "ranks": 2, "devices": ["cuda:0"] * 2,
          "all_reduce": {k: v for k, v in out.items()
                         if not k.startswith("broadcast ")},
          "broadcast": {k[len("broadcast "):]: v for k, v in out.items()
                        if k.startswith("broadcast ")},
          "card": card_line()})
    return out


def tp_rows(res):
    first = min((r["t_first"] for r in res.values() if r["t_first"]), default=0)
    last = max((r["t_last"] for r in res.values() if r["t_last"]), default=0)
    decoded = sum(max(0, len(r["tokens"]) - 1) for r in res.values())
    return {"ttft_ms": {n: r["ttft_ms"] for n, r in res.items()},
            "decode_tokens_per_s": decoded / (last - first) if last > first else 0.0,
            "finish": {n: r["finish_reason"] for n, r in res.items()}}


def tp_check(get_model, cfg, reqs, ref, res, greedy, n_tokens):
    """(problems, flips): every request ended with its `n_tokens`, and the
    greedy rows equal `ref` up to near-ties (phase 8's rule, the margin
    measured on the flat model `get_model()` returns)."""
    problems = [f"{n} ended {r['finish_reason']} with {len(r['tokens'])} tokens"
                for n, r in res.items()
                if r["finish_reason"] != "length" or len(r["tokens"]) != n_tokens]
    flips = {}
    for n in greedy if not problems else ():
        if res[n]["tokens"] != ref[n]:
            flips[n] = f = first_flip(get_model(), cfg, reqs[n]["token_ids"],
                                      ref[n], res[n]["tokens"])
            if f["margin_std"] is None or abs(f["margin_std"]) > LOGIT_TOL:
                problems.append(f"{n} flips beyond a near-tie: {f}")
    return problems, flips


def tp_launch_gate(what, launches, kernels):
    for rank, got in launches.items():
        if min(got.get(k, 0) for k in kernels) <= 0:
            fail(f"tp {what}: rank {rank} did not launch every kernel: {got}")


def tp_flat_twin(cfg, layers, seed=SEED):
    """The flat model of `cfg` cut to `layers` layers (full width), drawn
    from `seed` and sharpened as the tp group's `SeededShards` draws it."""
    from dynamo_tpu_torch.models import init_params

    cut = cfg.with_depth(layers)
    model = init_params(cut, torch.Generator(device="cuda").manual_seed(seed),
                        dtype=torch.bfloat16, device="cuda")
    sharpen(model)
    return model, cut


def tp_flat_tokens(model, cfg, reqs, warm):
    """{name: result} of `reqs` at once on a flat engine (TP_ECFG) after
    the warm-up request."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine

    engine = TorchEngine(cfg, model, EngineConfig(**TP_ECFG), device="cuda")

    async def run():
        try:
            await _collect(engine, warm)
            return await asyncio.gather(*[_collect(engine, r)
                                          for r in reqs.values()])
        finally:
            await engine.shutdown()

    return dict(zip(reqs, asyncio.run(run())))


def tp_llama8b(model, cfg, direct):
    """(a) Llama-3.1-8B at full width on a tp group of 2 sharing the card,
    cut to CUT_LAYERS layers, against its flat twin at the same depth
    (phase 4's seed, drawn at that depth); and phase 4's engine through
    `ParallelConfig(tp=1)`, which must repeat phase 4's tokens bit for
    bit at full depth.  Returns the group's launches per rank and (the
    twin's config, its tokens) for the HTTP check."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.parallel import ParallelConfig, SeededShards

    shared, prompts = serving_prompts(cfg)
    reqs = {n: _req(t, temperature=temp, seed=sd)
            for n, (t, temp, sd) in prompts.items()}
    warm = _req(shared + warm_suffix(cfg), max_tokens=4)
    flat1 = TorchEngine(cfg, model, EngineConfig(**TP_ECFG), device="cuda",
                        parallel=ParallelConfig(tp=1))

    async def one():
        try:
            await _collect(flat1, warm)
            return await asyncio.gather(*[_collect(flat1, r) for r in reqs.values()])
        finally:
            await flat1.shutdown()

    tp1 = {n: r["tokens"] for n, r in zip(reqs, asyncio.run(one()))}
    del flat1
    torch.cuda.empty_cache()
    if tp1 != direct["tokens"]:
        fail(f"tp (a): ParallelConfig(tp=1) differs from phase 4: {tp1} vs "
             f"{direct['tokens']}")
    twin, cut = tp_flat_twin(cfg, CUT_LAYERS)
    flat = tp_flat_tokens(twin, cut, reqs, warm)
    ref = {n: r["tokens"] for n, r in flat.items()}
    src = SeededShards(cut, SEED, "bfloat16", sharpen=True)
    res, wall, build_s, launches, m = tp_serve(cut, src, 2, reqs, warm,
                                               trace=("A_64",))
    problems, flips = tp_check(lambda: twin, cut, reqs, ref, res, TP_GREEDY, 32)
    out = {"phase": "tp", "case": "a", "model": cfg.name,
           "layers": cut.num_hidden_layers, "tp": 2, "backend": m["tp_backend"],
           "devices": ["cuda:0"] * 2, "tp1_equal_bitwise": True,
           "tp1_layers": cfg.num_hidden_layers,
           "greedy_equal": {n: res[n]["tokens"] == ref[n] for n in TP_GREEDY},
           "seeded_equal": res["D_shared+500_seeded"]["tokens"]
           == ref["D_shared+500_seeded"], "flips": flips, "tol_in_std": LOGIT_TOL,
           **tp_rows(res), "wall_s": wall, "build_s": build_s,
           "plans": m["tp_plans_total"], "launches_by_rank": launches,
           "flat_decode_tokens_per_s": tp_rows(flat)["decode_tokens_per_s"],
           "solo_trace": m["trace"], "card": card_line()}
    emit(out)
    if problems:
        fail(f"tp (a): {problems}")
    tp_launch_gate("(a)", launches, ATTENTION_KERNELS)
    del twin
    torch.cuda.empty_cache()
    return launches, (cut, ref, tp_rows(flat))


def tp_llama70b():
    """(b) Llama-3-70B at its published widths, TP_70B_LAYERS layers
    (random weights from a seed, sharpened): a flat engine, then a tp group
    of 4 sharing the card, on phase 4's traffic.  Returns the flat model
    (the HTTP check's reference) and the launches per rank."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models import init_params
    from dynamo_tpu_torch.models.config import LLAMA_3_70B
    from dynamo_tpu_torch.parallel import SeededShards

    cfg = LLAMA_3_70B.with_depth(TP_70B_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    sharpen(model)
    shared, prompts = serving_prompts(cfg)
    reqs = {n: _req(t, temperature=temp, seed=sd)
            for n, (t, temp, sd) in prompts.items()}
    warm = _req(shared + warm_suffix(cfg), max_tokens=4)
    flat = TorchEngine(cfg, model, EngineConfig(**TP_ECFG), device="cuda")

    async def one():
        try:
            await _collect(flat, warm)
            t0 = time.perf_counter()
            outs = await asyncio.gather(*[_collect(flat, r) for r in reqs.values()])
            return outs, time.perf_counter() - t0
        finally:
            await flat.shutdown()

    outs, flat_wall = asyncio.run(one())
    flat_res = dict(zip(reqs, outs))
    ref = {n: r["tokens"] for n, r in flat_res.items()}
    del flat
    torch.cuda.empty_cache()
    src = SeededShards(cfg, SEED, "bfloat16", sharpen=True)
    res, wall, build_s, launches, m = tp_serve(cfg, src, 4, reqs, warm)
    problems, flips = tp_check(lambda: model, cfg, reqs, ref, res, TP_GREEDY, 32)
    emit({"phase": "tp", "case": "b", "model": cfg.name, "layers": cfg.num_hidden_layers,
          "hidden": cfg.hidden_size, "heads": [cfg.num_attention_heads,
                                               cfg.num_key_value_heads],
          "ffn": cfg.intermediate_size, "vocab": cfg.vocab_size,
          "weights_gb": weights_gb(model), "tp": 4, "backend": m["tp_backend"],
          "greedy_equal": {n: res[n]["tokens"] == ref[n] for n in TP_GREEDY},
          "seeded_equal": res["D_shared+500_seeded"]["tokens"]
          == ref["D_shared+500_seeded"], "flips": flips, "tol_in_std": LOGIT_TOL,
          **tp_rows(res), "wall_s": wall, "build_s": build_s,
          "flat": {**tp_rows(flat_res), "wall_s": flat_wall},
          "plans": m["tp_plans_total"], "launches_by_rank": launches,
          "card": card_line()})
    if problems:
        fail(f"tp (b): {problems}")
    tp_launch_gate("(b)", launches, ATTENTION_KERNELS)
    return model, cfg, ref, launches


def tp_gpt_oss():
    """(c) gpt-oss-20b at its catalog width cut to SHALLOW_LAYERS layers, on a
    tp group of 2 sharing the card (16 experts a rank): phase 11's
    requests served (tokens/s, every rank's launches), their tokens beside
    the flat twin's (the same depth from the same seed, served by a flat
    engine); then the check: phase 11 (b)'s 512-token prompt and 8 decode
    steps on the flat twin with its router's choices recorded, and on the
    tp group with those choices forced, logits within LOGIT_TOL std.

    The served tokens are reported, not held to the twin's: the random router
    puts top-k near-ties everywhere (phase 11 (b): margins of 1e-3
    router-logit std), so the last-bit differences of the ranks' f32 sums
    flip experts and move the logits by more than a near-tie, as another
    f32 order of the expert sums does on one card (phase 11's
    ``chaos_witness``).  Forcing the flat run's routing, as phase 11 (b)
    does for its kernel-vs-plain check, leaves the tp arithmetic to be
    checked."""
    import gc

    from dynamo_tpu_torch.models import GPT_OSS_20B
    from dynamo_tpu_torch.parallel import SeededShards

    model, cfg = tp_flat_twin(GPT_OSS_20B, SHALLOW_LAYERS, seed=SEED + 11)
    _, reqs, warm = breadth_requests(cfg)
    flat = tp_flat_tokens(model, cfg, reqs, warm)
    ref = {n: r["tokens"] for n, r in flat.items()}
    record = forced_record(model, cfg)
    src = SeededShards(cfg, SEED + 11, "bfloat16", sharpen=True)
    res, wall, build_s, launches, m = tp_serve(cfg, src, 2, reqs, warm)
    ended = [f"{n} ended {r['finish_reason']} with {len(r['tokens'])} tokens"
             for n, r in res.items() if r["finish_reason"] != "length"
             or len(r["tokens"]) != BREADTH_TOKENS]
    flips = {n: first_flip(model, cfg, reqs[n]["token_ids"], ref[n],
                           res[n]["tokens"])
             for n in BREADTH_GREEDY if not ended and res[n]["tokens"] != ref[n]}
    del model
    gc.collect()
    torch.cuda.empty_cache()  # the ranks need the card's room
    forced = tp_forced_routing(cfg, *record)
    emit({"phase": "tp", "case": "c", "model": cfg.name,
          "layers": cfg.num_hidden_layers, "tp": 2, "experts_per_rank":
          cfg.num_experts // 2, "backend": m["tp_backend"],
          "greedy_equal": {n: res[n]["tokens"] == ref[n] for n in BREADTH_GREEDY},
          "flips": flips, **tp_rows(res), "wall_s": wall, "build_s": build_s,
          "plans": m["tp_plans_total"], "launches_by_rank": launches,
          "flat_decode_tokens_per_s": tp_rows(flat)["decode_tokens_per_s"],
          "forced_routing": forced, "tol_in_std": LOGIT_TOL,
          "card": card_line()})
    if ended:
        fail(f"tp (c): {ended}")
    if forced["logit_err_in_std"] > LOGIT_TOL:
        fail(f"tp (c): with the flat run's routing the tp logits lie "
             f"{forced['logit_err_in_std']:.3f} std from the flat logits")
    tp_launch_gate("(c)", launches, ("decode_attention", "prefill_attention",
                                     *MOE_KERNELS))
    return launches


TP_FORCED_STEPS = 8


def _tp_forced_rank(rank, init, q, cfg, path, tokens, fed):
    """A rank of `tp_forced_routing`: its gpt-oss-20b shard, every router
    choice taken from the flat run's record at its own router logits."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.parallel import ParallelConfig, SeededShards, make_mesh

    group = make_mesh(ParallelConfig(tp=2), ["cuda:0"] * 2, rank=rank,
                      init_method=init)
    try:
        model = SeededShards(cfg, SEED + 11, "bfloat16", sharpen=True)(
            rank, 2, group.device)
        model.attach_group(group)
        calls = iter(torch.load(path))

        def top_k(logits, k):
            idx = next(calls).to(logits.device)
            return logits.gather(-1, idx), idx

        llama._top_k = top_k
        with torch.no_grad():
            logits, _ = path_run(model, cfg, tokens.cuda(), TP_FORCED_STEPS, fed)
        if rank == 0:  # by value: the rank may exit before it is read
            q.put(logits.float().cpu().numpy())
    finally:
        group.close()


def forced_record(model, cfg):
    """Phase 11 (b)'s prompt and TP_FORCED_STEPS greedy decode steps on the
    flat `model`, its router's choices saved to ``build/``: (prompt, flat
    logits, the tokens fed, the record's path, the router calls)."""
    from dynamo_tpu_torch.models import llama

    g = torch.Generator().manual_seed(SEED + 12)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=g)
    calls, orig = [], llama._top_k

    def record(logits, k):
        vals, idx = orig(logits, k)
        calls.append(idx.cpu())
        return vals, idx

    llama._top_k = record
    try:
        with torch.no_grad():
            ref, toks = path_run(model, cfg, tokens.cuda(), TP_FORCED_STEPS)
    finally:
        llama._top_k = orig
    path = os.path.join(ROOT, "build", "tp_routing.pt")
    torch.save(calls, path)
    return tokens, ref.cpu(), toks[:TP_FORCED_STEPS], path, len(calls)


def tp_forced_routing(cfg, tokens, ref, fed, path, n_calls):
    """`forced_record`'s run on a tp group of 2 sharing the card, every
    router choice forced to the record's and fed the same tokens: the
    largest logit difference in the flat logits' std."""
    import multiprocessing as mp

    from dynamo_tpu_torch.parallel.mesh import free_port

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_tp_forced_rank,
                         args=(r, init, q, cfg, path, tokens, fed))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = torch.from_numpy(q.get(timeout=600))
    finally:
        for p in procs:
            p.join(120)
            if p.is_alive():
                p.terminate()
    err = ((got - ref.float()).abs().amax(-1) / ref.float().std(-1)).tolist()
    return {"prompt_tokens": 512, "decode_steps": TP_FORCED_STEPS,
            "router_calls": n_calls, "logit_err_in_std": max(err),
            "logit_err_in_std_by_step": err}


def tp_http_spawn(procs, arms):
    """The processes of `tp_http`, every arm's worker building at once: the
    control plane, one `python -m
    dynamo_tpu_torch.worker --tp N` process per arm (its ranks sharing the
    card; the model from the same ``--seed``, ``--sharpen``) and one
    frontend routing by model name.  `arms`: (model name, tp,
    ``--num-layers``).  Returns (workers, frontend, start time)."""
    t0 = time.perf_counter()
    cp = _spawn(procs, "dynamo_tpu_torch.runtime", "--host", "127.0.0.1",
                "--port", "0", "--log-level", "warning")
    addr = _ready(cp, "READY ", "tp http: the control plane").split()[1]
    workers = []
    for name, tp, layers in arms:
        workers.append(_spawn(
            procs, "dynamo_tpu_torch.worker", "--control", addr, "--model",
            name, "--seed", str(SEED), "--sharpen", "--tp", str(tp),
            "--tp-devices", ",".join(["cuda:0"] * tp), "--num-pages", "256",
            "--num-layers", str(layers), "--status-port", "0", "--log-level",
            "warning"))
    front = _spawn(procs, "dynamo_tpu_torch.frontend", "--control", addr,
                   "--host", "127.0.0.1", "--port", "0", "--log-level",
                   "warning")
    return workers, front, t0


def tp_http(arms, spawned):
    """Phase 4's A_64, greedy, through `tp_http_spawn`'s processes, one
    request to each arm's worker by model name.  `arms`: (a callable
    giving the flat model, cfg, tp, the flat engine's tokens of A_64);
    each answer's tokens (their strings, from its logprobs) must be the
    flat tokens up to a near-tie measured on the flat model."""
    outs = []
    # (get_model, cfg, tp, want[, dp[, pp]])
    arms = [tuple(a) + (1,) * (6 - len(a)) for a in arms]
    workers, front, t0 = spawned
    port = int(_ready(front, "READY http://", "tp http: the frontend")
               .rsplit(":", 1)[1])
    status = [int(_ready(w, "STATUS ", "tp http: a worker").rsplit(":", 1)[1])
              for w in workers]
    for w in workers:
        _ready(w, "READY worker", "tp http: a worker")
    ready_s = time.perf_counter() - t0
    for _ in range(1200):
        st, models = _http(port, "GET", "/v1/models")
        if st == 200 and all(a[1].name.encode() in models for a in arms):
            break
        time.sleep(0.1)
    else:
        fail("tp http: the frontend never listed every model")
    for (_, cfg, tp, _, _, _), stat in zip(arms, status):
        _, prompts = serving_prompts(cfg)
        # logprobs 0: each token's string comes back beside the text
        body = {"model": cfg.name, "prompt": prompts["A_64"][0],
                "max_tokens": 32, "temperature": 0.0, "logprobs": 0,
                "nvext": {"ignore_eos": True}}
        t_send = time.perf_counter()
        st, raw = _http(port, "POST", "/v1/completions", body)
        choice = json.loads(raw)["choices"][0] if st == 200 else {}
        got = (choice.get("logprobs") or {}).get("tokens") or []
        ms = (time.perf_counter() - t_send) * 1e3
        st2, raw = _http(stat, "GET", "/metrics.json")
        stats = json.loads(raw) if st2 == 200 else {}
        outs.append({"status": st, "finish": choice.get("finish_reason"),
                     "got": got, "ms": ms,
                     "worker": {k: stats.get(k) for k in (
                         "tp", "dp", "pp", "kv_partition", "kv_total_pages",
                         "tp_backend", "tp_plans_total")}})
    for (get_model, cfg, tp, want, dp, pp), out in zip(arms, outs):
        _, prompts = serving_prompts(cfg)
        tok = llama_tokenizer(cfg)
        got = out.pop("got")
        out["equal"] = got == [tok.decode([t]) for t in want]
        if not out["equal"] and len(got) == len(want):
            out["flip"] = token_flip(get_model(), cfg, prompts["A_64"][0],
                                     want, got)
        emit({"phase": "tp", "case": f"http tp {tp}", "model": cfg.name,
              "layers": cfg.num_hidden_layers, "tokens": len(got),
              "ready_s": ready_s, **out, "card": card_line()})
        if out["status"] != 200 or out["finish"] != "length" or len(got) != 32:
            fail(f"tp http ({cfg.name}, tp {tp}): {out}")
        if (out["worker"]["tp"] != tp or (out["worker"]["dp"] or 1) != dp
                or (out["worker"]["pp"] or 1) != pp):
            fail(f"tp http: the worker reports {out['worker']}, want tp {tp} "
                 f"dp {dp} pp {pp}")
        if not out["equal"]:
            f = out["flip"]
            if f["margin_std"] is None or abs(f["margin_std"]) > LOGIT_TOL:
                fail(f"tp http ({cfg.name}): the tokens differ beyond a "
                     f"near-tie: {f}")


def token_flip(model, cfg, prompt, want, got_strs):
    """Where the tokens of an HTTP answer (each token's string, as its
    logprobs carry them) part from `want`: the margin of want's token over
    the best-scored token with the answer's string there, in logit std on
    `model`'s reference logits (None when no token of the top 64 has it)."""
    tok = llama_tokenizer(cfg)
    j = next(i for i, (a, b) in enumerate(zip(want, got_strs))
             if tok.decode([a]) != b)
    lg = reference_logits(model, cfg, prompt + want[:j])
    alt = next((t for t in lg.topk(64).indices.tolist()
                if tok.decode([t]) == got_strs[j]), None)
    return {"index": j, "ref_token": want[j], "arm_token": alt,
            "margin_std": None if alt is None
            else ((lg[want[j]] - lg[alt]) / lg.std()).item()}


def tp_fault_child(name: str) -> int:
    """One planted fault of (a), run in a copy of the port that carries it
    (see `tp_faults`): the flat engine and a tp group of 2 on (a)'s model
    cut to TP_FAULT_LAYERS layers, (a)'s check on their tokens; prints
    whether the check caught the fault."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models import LLAMA_3_1_8B, init_params
    from dynamo_tpu_torch.parallel import SeededShards

    cfg = LLAMA_3_1_8B.with_depth(TP_FAULT_LAYERS)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        dtype=torch.bfloat16, device="cuda")
    sharpen(model)
    shared, prompts = serving_prompts(cfg)
    reqs = {n: _req(t) for n, (t, _, _) in prompts.items()}
    warm = _req(shared + warm_suffix(cfg), max_tokens=4)
    flat = TorchEngine(cfg, model, EngineConfig(**TP_ECFG), device="cuda")

    async def one():
        try:
            await _collect(flat, warm)
            return await asyncio.gather(*[_collect(flat, r) for r in reqs.values()])
        finally:
            await flat.shutdown()

    ref = {n: r["tokens"] for n, r in zip(reqs, asyncio.run(one()))}
    flips = {}
    try:
        res = tp_serve(cfg, SeededShards(cfg, SEED, "bfloat16", sharpen=True), 2,
                       reqs, warm)[0]
        problems, flips = tp_check(lambda: model, cfg, reqs, ref, res,
                                   list(reqs), 32)
    except Exception as e:  # noqa: BLE001 — a run the fault breaks is caught
        problems = [f"{type(e).__name__}: {e}"]
    margins = [abs(f["margin_std"]) for f in flips.values()
               if f["margin_std"] is not None]
    print(json.dumps({"fault": name, "caught": bool(problems),
                      "rows_flipped": len(flips),
                      "largest_margin_std": max(margins, default=None),
                      "problems": problems[:2]}), flush=True)
    return 0


def tp_faults():
    """Each planted fault of TP_FAULTS in a copy of the port under
    ``build/tp_faults/`` (its kernels copied from this checkout's build),
    run as its own process (`tp_fault_child`), all at once; every fault
    must fail (a)'s check."""
    import gc
    import shutil

    from dynamo_tpu_torch.ops import _build

    gc.collect()
    torch.cuda.empty_cache()  # the children need the room
    base = os.path.join(ROOT, "build", "tp_faults")
    shutil.rmtree(base, ignore_errors=True)
    procs = {}
    t0 = time.perf_counter()
    for i, (name, (rel, text, bad)) in enumerate(TP_FAULTS.items()):
        root = os.path.join(base, str(i))
        shutil.copytree(os.path.join(ROOT, "dynamo_tpu_torch"),
                        os.path.join(root, "dynamo_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copytree(_build.BUILD_DIR, os.path.join(root, "build", "kernels"))
        path = os.path.join(root, rel)
        with open(path) as f:
            src = f.read()
        if src.count(text) != 1:
            fail(f"tp fault {name!r}: its text occurs {src.count(text)} times")
        with open(path, "w") as f:
            f.write(src.replace(text, bad))
        code = (f"import sys; sys.path.append({ROOT!r}); import chip_smoke; "
                f"sys.exit(chip_smoke.tp_fault_child({name!r}))")
        log = open(os.path.join(OUT_DIR, f"tp_fault_{i}.log"), "w")
        # the copy is the working directory, first on the child's path
        env = {**os.environ, "DYN_TORCH_TP_TIMEOUT_S": str(TP_FAULT_TIMEOUT_S)}
        procs[name] = (subprocess.Popen([sys.executable, "-c", code], cwd=root,
                                        env=env, stdout=subprocess.PIPE,
                                        stderr=log, text=True,
                                        start_new_session=True), log)
    results = {}
    for name, (p, log) in procs.items():
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            stdout, _ = p.communicate()
            results[name] = {"caught": True, "problems": ["hung past 600 s"]}
            continue
        finally:
            log.close()
        lines = [ln for ln in stdout.splitlines() if ln.startswith('{"fault"')]
        results[name] = (json.loads(lines[-1]) if lines and p.returncode == 0
                         else {"caught": None, "rc": p.returncode})
    emit({"phase": "tp", "case": "planted faults", "layers": TP_FAULT_LAYERS,
          "results": results, "seconds": time.perf_counter() - t0,
          "logs": "chiprun_out/tp_fault_*.log", "card": card_line()})
    for name, r in results.items():
        if r.get("caught") is not True:
            fail(f"tp: the planted fault {name!r} was not caught: {r}")


# --------------------------------------------------------------------------- #
# phase 16: KV moves under tensor parallelism
# --------------------------------------------------------------------------- #

# phase 4's 8B at full width cut to TPKV_LAYERS, the weights from phase
# 4's seed (sharpened); one decode slot, so an interactive arrival parks
# the batch victim (phase 9's storm)
TPKV_LAYERS = SHALLOW_LAYERS
TPKV_ECFG = dict(page_size=16, num_pages=512, max_num_seqs=1,
                 max_prefill_tokens=512, max_model_len=4096)
TPKV_TOKENS = 16
TPKV_HOST_BYTES = 1 << 30
# (b): the prefill worker's tp and the decode engine's, each case in a
# namespace of its own
TPKV_CASES = {"tp2_to_flat": (2, 1), "flat_to_tp2": (1, 2),
              "tp4_to_tp2": (4, 2)}


def tpkv_prompts(cfg):
    """(victim, interactive, {name: prompt}): phase 9's storm shapes (a
    1224-token batch victim, a 64-token arrival) and phase 12's two greedy
    disagg prompts, which (a) also onboards across the tiers."""
    g = torch.Generator().manual_seed(SEED + 16)
    victim = _req(torch.randint(0, cfg.vocab_size, (1224,), generator=g).tolist(),
                  max_tokens=32)
    victim["priority"] = "batch"
    inter = _req(torch.randint(0, cfg.vocab_size, (64,), generator=g).tolist(),
                 max_tokens=8)
    d = disagg_prompts(cfg)
    return victim, inter, {n: d[n] for n in ("greedy_1088", "greedy_2048")}


def tpkv_flip_problems(model, cfg, prompt, want, got, what):
    """[] when `got` equals `want` up to a near-tie (phase 15's rule: the
    first differing token's margin within LOGIT_TOL std on the flat
    model), else the problem; and the flip."""
    if got == want:
        return [], None
    f = first_flip(model, cfg, prompt, want, got)
    if f["margin_std"] is None or abs(f["margin_std"]) > LOGIT_TOL:
        return [f"{what} parts beyond a near-tie: {f}"], f
    return [], f


async def tpkv_window_check(engine, lane, desc, pages):
    """Every destination rank's imported `pages` (read back through the
    group's ``kv_read`` plan, not its gather) against the matching head
    window of the source's pages (every source rank's pools mapped into
    this process through `lane`), byte for byte; and the elements past
    the prompt that are not zero (a decode after the import writes
    there)."""
    from dynamo_tpu_torch.disagg.device_transfer import rank_entries

    entry, n = desc["cuda_ipc"], int(desc["prompt_len"])
    srcs = [lane.pools(e) for e in rank_entries(entry)]
    src = [torch.cat([_token_major(s[i], entry["pages"], n) for s in srcs],
                     dim=2).cpu() for i in (0, 1)]
    ranks = await engine._device_op(lambda: engine.rank_pages(pages))
    differ, tail = 0, 0
    for r, planes in enumerate(ranks):
        for got, want in zip(planes, src):
            L, _, ps, h, hd = got.shape
            t = got.reshape(L, len(pages) * ps, h, hd)
            differ += int((_bits(t[:, :n]) != _bits(want[:, :, r * h:(r + 1) * h])).sum())
            tail += int(t[:, n:].ne(0).sum())
    return {"ranks": len(ranks), "source_ranks": len(srcs),
            "differing_elements": differ, "nonzero_past_prompt": tail}


def window_probe(engine):
    """(c) The byte check of (b) on a transfer made in this process: two
    source pools of a tp 2 layout (4 of the 8B's 8 kv heads each, random,
    under an injected opener instead of CUDA IPC) imported into `engine`
    through `import_ipc` (its windowed launches), then `tpkv_window_check`.
    A re-page that reads the wrong heads leaves differing elements."""
    from dynamo_tpu_torch.disagg.device_transfer import IpcLane

    L, _, ps, n_kv, hd = engine.kv.k.shape
    n_kv *= engine.tp
    prompt_len = 333
    gen = torch.Generator(device="cuda").manual_seed(SEED + 161)
    pools = [tuple((torch.randn((L, 40, ps, n_kv // 2, hd), generator=gen,
                                device="cuda") * KV_STD).to(engine.kv.k.dtype)
                   for _ in range(2)) for _ in range(2)]
    entry = {"ranks": [{"rank": r, "lease": 0, "k": {"share": [0, bytes([r])]}}
                       for r in range(2)],
             "pages": list(range(3, 3 + -(-prompt_len // ps))), "event": None}
    lane = IpcLane(engine.device, opener=lambda e, dev: pools[e["rank"]],
                   event_opener=lambda handle, dev: None)

    async def run():
        pages = await engine.alloc_pages(-(-prompt_len // engine.cfg.page_size))
        try:
            await engine._device_op(lambda: engine.import_ipc(
                entry, pages, prompt_len, lane))
            return await tpkv_window_check(engine, lane, {
                "cuda_ipc": entry, "prompt_len": prompt_len}, pages)
        finally:
            await engine.free_pages(pages)

    return run()


def window_probe_main() -> int:
    """`window_probe` on a flat engine over the 8B's full width at one
    layer, printed as one JSON line (the mutation check runs it in a
    copy of the port whose re-page carries a planted fault)."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models import LLAMA_3_1_8B, init_params
    from dynamo_tpu_torch.ops import _build

    _build.build_all()
    cfg = LLAMA_3_1_8B.with_depth(1)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        dtype=torch.bfloat16, device="cuda")
    engine = TorchEngine(cfg, model, EngineConfig(**TPKV_ECFG), device="cuda")

    async def run():
        try:
            return await window_probe(engine)
        finally:
            await engine.shutdown()

    print(json.dumps({"window_probe": asyncio.run(run())}), flush=True)
    return 0


def _close_handler(handler) -> "asyncio.Future":
    """A `DisaggDecodeHandler`'s own tasks and clients, its engine left
    serving (`shutdown` would stop the engine too)."""
    async def close():
        if handler._layout_watch is not None:  # noqa: SLF001
            handler._layout_watch.cancel()  # noqa: SLF001
            await asyncio.gather(handler._layout_watch,  # noqa: SLF001
                                 return_exceptions=True)
        await handler.prefill_client.stop()

    return close()


async def _rank_launches(engine):
    from dynamo_tpu_torch.ops._launches import LAUNCHES

    if engine.tp == 1:
        return {0: dict(LAUNCHES)}
    return await engine.group_stats()


def _launch_delta(before, after):
    return {r: {k: n - before[r].get(k, 0) for k, n in after[r].items()}
            for r in sorted(after)}


async def tpkv_park_tiers(cfg, model, flat, tp, prompts, victim, inter):
    """(a) on the flat engine and the tp 2 group (same weights, same depth):
    each prompt's cold tokens; the storm (the victim parked for the
    arrival and resumed, against its uncontended run, bit for bit); the
    tp group's export against its ranks' pools laid side by side; then a
    host tier on each engine over ONE host pool: the flat engine writes
    the 1088-token prompt's blocks and the tp group onboards them, the tp
    group writes the 2048-token prompt's and the flat engine onboards
    them, each against the onboarding engine's own cold tokens up to
    near-ties."""
    from dynamo_tpu_torch.kvbm import HostBlockPool, TieredKvCache

    out, problems = {"cold": {}, "park": {}}, []
    engines = {"flat": flat, "tp2": tp}
    for name, eng in engines.items():
        out["cold"][name] = {}
        for pn, p in prompts.items():
            eng.clear_kv_blocks()
            r = await _collect(eng, _req(p, max_tokens=TPKV_TOKENS))
            out["cold"][name][pn] = r["tokens"]
        eng.clear_kv_blocks()
        alone = await _collect(eng, victim)
        eng.clear_kv_blocks()
        m0 = eng.metrics()
        eng.dispatch_trace = trace = []
        got, inter_out, order = await _storm(eng, victim, inter, 2)
        eng.dispatch_trace = None
        m1 = eng.metrics()
        row = {"victim_tokens_equal_alone": got["tokens"] == alone["tokens"],
               "preempted": m1.preempted_total - m0.preempted_total,
               "resumed": m1.resumed_total - m0.resumed_total,
               "lot_after": [len(eng.parking), eng.parking.pages_held],
               "finish_order": order,
               "moves": [{k: e[k] for k in ("kind", "pages", "ms", "cached")
                          if k in e} for e in trace
                         if e["kind"] in ("park", "resume")]}
        out["park"][name] = row
        if not (row["victim_tokens_equal_alone"] and row["preempted"] >= 1
                and row["preempted"] == row["resumed"]
                and row["lot_after"] == [0, 0]
                and order == ["interactive", "victim"]):
            problems.append(f"park on {name}: {row}")
    # the gather in rank order against each rank's own pool
    pages = list(range(1, 129))

    def export_op():
        k, v = tp._export_dev(pages)
        return k.cpu(), v.cpu(), tp.rank_pages(pages)

    k, v, ranks = await tp._device_op(export_op)
    side = [torch.cat([r[i] for r in ranks], dim=3) for i in (0, 1)]
    out["export"] = {
        "pages": len(pages), "heads": k.shape[3], "ranks": len(ranks),
        "equal_to_ranks_side_by_side": all(
            torch.equal(_bits(a), _bits(b)) for a, b in zip((k, v), side)),
        "nonzero": bool(k.abs().sum() > 0)}
    if not (out["export"]["equal_to_ranks_side_by_side"] and out["export"]["nonzero"]
            and k.shape[3] == cfg.num_key_value_heads):
        problems.append(f"export: {out['export']}")
    # one host pool under a tier of each engine
    host = HostBlockPool(capacity_bytes=TPKV_HOST_BYTES)
    tiers = {"flat": TieredKvCache(host), "tp2": TieredKvCache(host)}
    for name, eng in engines.items():
        eng.attach_connector(tiers[name])

    async def drained(tier):
        for _ in range(2000):
            if not tier.offload_backlog:
                return
            await asyncio.sleep(0.01)
        problems.append("tiers: an offload never drained")

    writes = {"greedy_1088": ("flat", "tp2"), "greedy_2048": ("tp2", "flat")}
    for pn, (writer, reader) in writes.items():
        eng = engines[writer]
        eng.clear_kv_blocks()
        await _collect(eng, _req(prompts[pn], max_tokens=TPKV_TOKENS))
        await drained(tiers[writer])
    out["tiers"] = {}
    for pn, (writer, reader) in writes.items():
        eng, tier = engines[reader], tiers[reader]
        eng.clear_kv_blocks()
        before = tier.onboarded_blocks
        eng.dispatch_trace = trace = []
        r = await _collect(eng, _req(prompts[pn], max_tokens=TPKV_TOKENS))
        eng.dispatch_trace = None
        onboard = [e for e in trace if e["kind"] == "onboard"]
        want = out["cold"][reader][pn]
        bad, flip = tpkv_flip_problems(model, cfg, prompts[pn], want, r["tokens"],
                                       f"tiers {writer} -> {reader} {pn}")
        problems += bad
        full = len(prompts[pn]) // TPKV_ECFG["page_size"]
        row = {"written_by": writer, "onboarded_by": reader,
               "onboarded_blocks": tier.onboarded_blocks - before,
               "onboard_ms": sum(e["ms"] for e in onboard),
               "onboard_pages": sum(e["pages"] for e in onboard),
               "ttft_ms": r["ttft_ms"], "equal_to_cold": r["tokens"] == want,
               "flip": flip}
        out["tiers"][pn] = row
        if row["onboarded_blocks"] < full - 1:
            problems.append(f"tiers {pn}: onboarded {row['onboarded_blocks']} "
                            f"of {full} blocks")
    heads = {host.get(h).k.shape[2] for h in host.summary()}
    out["host_blocks"] = {"blocks": len(host), "heads": sorted(heads)}
    if heads != {cfg.num_key_value_heads}:
        problems.append(f"tiers: host blocks of {heads} heads")
    return out, problems


async def tpkv_disagg(cfg, model, flat, tp, prompts, cold, addr, workers):
    """(b) Each case's prefill worker process (tp_s) hands phase 12's two
    greedy prompts to this process's decode engine (tp_d) behind a
    `DisaggDecodeHandler` over the CUDA IPC lane: every transfer on the
    lane, no fallback, each destination rank's pages equal to the head
    window of the source's (`tpkv_window_check`), tokens equal to the
    decode engine's own cold run up to near-ties, every rank's kv_repage
    launches counted."""
    from dynamo_tpu_torch.disagg import DisaggDecodeHandler
    from dynamo_tpu_torch.runtime import Context, DistributedRuntime

    loop = asyncio.get_running_loop()
    rt = await DistributedRuntime.connect(addr)
    out, problems, launches = {}, [], {}
    try:
        for case, (tp_s, tp_d) in TPKV_CASES.items():
            eng, dname = (flat, "flat") if tp_d == 1 else (tp, "tp2")
            t0 = time.perf_counter()
            await loop.run_in_executor(None, _ready, workers[case],
                                       "READY worker",
                                       f"tp kv (b) {case}: the prefill worker")
            wait_s = time.perf_counter() - t0
            handler = DisaggDecodeHandler(eng, rt, namespace=f"tpkv_{case}")
            moved, checks, real_fetch = [], [], handler.transfer_client.fetch

            async def fetch(desc, timeout=60.0, _moved=moved, _real=real_fetch):
                pages, stats = await _real(desc, timeout=timeout)
                _moved.append((desc, pages))
                return pages, stats

            handler.transfer_client.fetch = fetch
            try:
                before = await _rank_launches(eng)
                row = {"prefill_tp": tp_s, "decode_tp": tp_d,
                       "worker_wait_s": wait_s, "ttft_ms": {}, "flips": {}}
                for pn, p in prompts.items():
                    eng.clear_kv_blocks()
                    t1 = time.perf_counter()
                    toks, t_first = [], None
                    async for d in handler.generate(
                            _req(p, max_tokens=TPKV_TOKENS), Context()):
                        if d.get("finish_reason") == "error":
                            problems.append(f"{case} {pn}: {d}")
                            break
                        if d["token_ids"] and t_first is None:
                            t_first = time.perf_counter()
                        toks.extend(d["token_ids"])
                    row["ttft_ms"][pn] = ((t_first or t1) - t1) * 1e3
                    # the prompt's imported pages, read back once the
                    # request is done (its decode wrote past the prompt
                    # only; nothing else ran on either side since)
                    while moved:
                        desc, pages = moved.pop(0)
                        checks.append(await tpkv_window_check(
                            eng, handler.transfer_client.ipc, desc, pages))
                    bad, row["flips"][pn] = tpkv_flip_problems(
                        model, cfg, p, cold[dname][pn], toks, f"{case} {pn}")
                    problems += bad
                after = await _rank_launches(eng)
                m = vars(handler.metrics())
            finally:
                await _close_handler(handler)
            launches[case] = _launch_delta(before, after)
            n_windows = max(1, tp_s // tp_d)
            row.update({
                "ipc_transfers": m["kv_transfer_ipc_count"],
                "transfers": m["kv_transfer_count"],
                "transfer_ms_mean": m["kv_transfer_ms_total"]
                / max(m["kv_transfer_count"], 1),
                "prefill_fallback_total": m["prefill_fallback_total"],
                "window_checks": checks,
                "kv_repage_by_rank": {r: c.get("kv_repage", 0)
                                      for r, c in launches[case].items()}})
            out[case] = row
            n = len(prompts)
            if (row["ipc_transfers"] != n or row["prefill_fallback_total"]
                    or len(checks) != n):
                problems.append(f"{case}: not every prompt rode the ipc lane: {row}")
            for c in checks:
                if (c["differing_elements"] or c["ranks"] != tp_d
                        or c["source_ranks"] != tp_s):
                    problems.append(f"{case}: imported pages differ from the "
                                    f"source's head window: {c}")
            if any(v != n * n_windows for v in row["kv_repage_by_rank"].values()):
                problems.append(f"{case}: kv_repage launches by rank "
                                f"{row['kv_repage_by_rank']}, want {n * n_windows} each")
    finally:
        await rt.shutdown(graceful=False)
    return out, problems, launches


def phase_tp_kv_moves():
    """Phase 16 (see the module docstring).  Returns the kernel launches of
    each rank on (a) and on each case of (b)."""
    import gc

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models import LLAMA_3_1_8B, init_params
    from dynamo_tpu_torch.parallel import ParallelConfig, SeededShards

    cfg = LLAMA_3_1_8B.with_depth(TPKV_LAYERS)
    victim, inter, prompts = tpkv_prompts(cfg)
    procs, t0 = [], time.perf_counter()
    try:
        # (b)'s prefill workers build while (a) runs
        cp = _spawn(procs, "dynamo_tpu_torch.runtime", "--host", "127.0.0.1",
                    "--port", "0", "--log-level", "warning")
        addr = _ready(cp, "READY ", "tp kv (b): the control plane").split()[1]
        workers = {}
        for case, (tp_s, _) in TPKV_CASES.items():
            args = ["dynamo_tpu_torch.worker", "--control", addr,
                    "--model", cfg.name, "--seed", str(SEED), "--sharpen",
                    "--num-layers", str(TPKV_LAYERS), "--disagg-role", "prefill",
                    "--namespace", f"tpkv_{case}", "--num-pages", "300",
                    "--max-num-seqs", "2", "--status-port", "-1",
                    "--log-level", "warning"]
            if tp_s > 1:
                args += ["--tp", str(tp_s), "--tp-devices",
                         ",".join(["cuda:0"] * tp_s)]
            workers[case] = _spawn(procs, *args, env={
                **os.environ, "DYN_TPU_LEASE_TTL": str(DISAGG_PREFILL_LEASE_S)})
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                            dtype=torch.bfloat16, device="cuda")
        sharpen(model)
        ecfg = EngineConfig(**TPKV_ECFG)

        async def run():
            from dynamo_tpu_torch.ops import cuda_attention as ca

            ca.reset_launches()
            t1 = time.perf_counter()
            flat = TorchEngine(cfg, model, ecfg, device="cuda")
            tp = TorchEngine(cfg, SeededShards(cfg, SEED, "bfloat16", sharpen=True),
                             ecfg, parallel=ParallelConfig(tp=2),
                             devices=["cuda:0"] * 2)
            build_s = time.perf_counter() - t1
            try:
                before = await _rank_launches(tp)
                a, problems = await tpkv_park_tiers(cfg, model, flat, tp, prompts,
                                                    victim, inter)
                a_launches = _launch_delta(before, await _rank_launches(tp))
                b, b_problems, b_launches = await tpkv_disagg(
                    cfg, model, flat, tp, prompts, a["cold"], addr, workers)
                c = await window_probe(flat)
            finally:
                await tp.shutdown()
                await flat.shutdown()
            return build_s, a, a_launches, b, b_launches, c, problems + b_problems

        build_s, a, a_launches, b, b_launches, c, problems = asyncio.run(run())
    finally:
        for p in reversed(procs):
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "tp_kv", "case": "a", "model": cfg.name, "layers": TPKV_LAYERS,
          "tp": 2, "build_s": build_s, **a, "launches_by_rank": a_launches,
          "card": card_line()})
    emit({"phase": "tp_kv", "case": "b", "model": cfg.name, "layers": TPKV_LAYERS,
          "cases": b, "card": card_line()})
    emit({"phase": "tp_kv", "case": "c", "window_probe": c,
          "seconds": time.perf_counter() - t0, "card": card_line()})
    if problems:
        fail(f"tp kv: {problems}")
    if c["differing_elements"] or c["nonzero_past_prompt"]:
        fail(f"tp kv (c): the probe's imported pages differ: {c}")
    tp_launch_gate("kv (a)", a_launches, ATTENTION_KERNELS)
    return {"a": a_launches, **b_launches}


# --------------------------------------------------------------------------- #
# phase 17: meshed data parallelism on the one card
# --------------------------------------------------------------------------- #

# (b) and (c)'s partitioned group: two decode slots and 160 pages a
# partition, so (b)'s staggered wave holds more pages at once than one
# partition has, and (c)'s storm parks on one slot's pressure
MESH_PART_ECFG = dict(TP_ECFG, num_pages=160, max_num_seqs=2)
MESH_TOKENS = 16
MESH_NS = "mesh_disagg"


def mesh_spawn(procs, cfg):
    """The processes of phase 17, built while (a)-(c) run in this
    process: a control plane, (c)'s flat prefill worker (``--disagg-role
    prefill``) and (d)'s ``worker --dp 2 --tp 2 --kv-partition`` (its 4
    ranks sharing the card) behind a frontend.  Returns (the control
    plane's address, the prefill worker, (d)'s (workers, frontend, start
    time))."""
    t0 = time.perf_counter()
    cp = _spawn(procs, "dynamo_tpu_torch.runtime", "--host", "127.0.0.1",
                "--port", "0", "--log-level", "warning")
    addr = _ready(cp, "READY ", "mesh: the control plane").split()[1]
    common = ["--control", addr, "--model", cfg.name, "--seed", str(SEED),
              "--sharpen", "--num-layers", str(CUT_LAYERS), "--log-level",
              "warning"]
    prefill = _spawn(procs, "dynamo_tpu_torch.worker", *common,
                     "--disagg-role", "prefill", "--namespace", MESH_NS,
                     "--num-pages", "300", "--max-num-seqs", "2",
                     "--status-port", "-1", env={
                         **os.environ,
                         "DYN_TPU_LEASE_TTL": str(DISAGG_PREFILL_LEASE_S)})
    worker = _spawn(procs, "dynamo_tpu_torch.worker", *common, "--dp", "2",
                    "--tp", "2", "--kv-partition", "--tp-devices",
                    ",".join(["cuda:0"] * 4), "--num-pages", "256",
                    "--status-port", "0")
    front = _spawn(procs, "dynamo_tpu_torch.frontend", "--control", addr,
                   "--host", "127.0.0.1", "--port", "0", "--log-level",
                   "warning")
    return addr, prefill, ([worker], front, t0)


def _mesh_note(what: str) -> None:
    """A progress line of phase 17 on stderr (the JSON lines stay on
    stdout): where a slow or stuck step stands."""
    print(f"mesh {time.perf_counter() - _T0:.1f}s {what}", file=sys.stderr,
          flush=True)


def _finish_spy(engine, into):
    """{request id: (pages, partition)} as each sequence ends."""
    real = engine.scheduler._finish  # noqa: SLF001

    def spy(seq, reason):
        into[seq.request_id] = (list(seq.pages), seq.kv_rank)
        return real(seq, reason)

    engine.scheduler._finish = spy  # noqa: SLF001


async def _collect_as(engine, req, rid, first=None, ctx=None):
    """`_collect` under the request id `rid` (or the context `ctx`),
    setting `first` at the first token."""
    from dynamo_tpu_torch.runtime import Context

    t0 = time.perf_counter()
    toks, reason, t_first, t_last = [], None, None, None
    async for d in engine.generate(req, ctx or Context(rid)):
        now = time.perf_counter()
        if d["token_ids"]:
            t_first = t_first or now
            t_last = now
            if first is not None:
                first.set()
        toks.extend(d["token_ids"])
        reason = d["finish_reason"]
    return {"tokens": toks, "finish_reason": reason,
            "ttft_ms": (t_first - t0) * 1e3 if t_first else None,
            "t_first": t_first, "t_last": t_last}


def mesh_requests(cfg):
    shared, prompts = serving_prompts(cfg)
    reqs = {n: _req(t, temperature=temp, seed=sd)
            for n, (t, temp, sd) in prompts.items()}
    return reqs, _req(shared + warm_suffix(cfg), max_tokens=4)


def mesh_replicated(cfg, ref, twin):
    """(a) dp 2 x tp 1, the pool replicated: the warm-up, then phase 4's
    five requests at once; their greedy rows against the flat twin's up
    to near-ties, and both replicas' pools byte-equal on every page the
    wave used (read through ``kv_read``)."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.ops import cuda_attention as ca
    from dynamo_tpu_torch.parallel import ParallelConfig, SeededShards

    reqs, warm = mesh_requests(cfg)
    ca.reset_launches()
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, SeededShards(cfg, SEED, "bfloat16", sharpen=True),
                         EngineConfig(**TP_ECFG),
                         parallel=ParallelConfig(dp=2, tp=1),
                         devices=["cuda:0"] * 2)
    build_s = time.perf_counter() - t0
    seqs = {}
    _finish_spy(engine, seqs)

    async def run():
        try:
            await _collect(engine, warm)
            before = await engine.group_stats()
            t1 = time.perf_counter()
            outs = await asyncio.gather(*[_collect_as(engine, r, n)
                                          for n, r in reqs.items()])
            wall = time.perf_counter() - t1
            after = await engine.group_stats()
            used = sorted({p for pages, _ in seqs.values() for p in pages} - {0})
            t2 = time.perf_counter()
            reads = await engine._device_op(lambda: engine.rank_pages(used))
            read_s = time.perf_counter() - t2
            return outs, wall, before, after, used, reads, read_s, \
                vars(engine.metrics())
        finally:
            await engine.shutdown()

    outs, wall, before, after, used, reads, read_s, m = asyncio.run(run())
    res = dict(zip(reqs, outs))
    problems, flips = tp_check(twin, cfg, reqs, ref, res, TP_GREEDY, 32)
    differ = sum(int((_bits(a) != _bits(b)).sum())
                 for a, b in zip(reads[0], reads[1]))
    nonzero = bool(reads[0][0].abs().sum() > 0)
    if differ or not nonzero:
        problems.append(f"the replicas' pools differ on {differ} elements "
                        f"(nonzero {nonzero})")
    out = {"phase": "mesh", "case": "a", "model": cfg.name,
           "layers": cfg.num_hidden_layers, "dp": 2, "tp": 1,
           "kv_partition": False, "backend": m["tp_backend"],
           "greedy_equal": {n: res[n]["tokens"] == ref[n] for n in TP_GREEDY},
           "flips": flips, "tol_in_std": LOGIT_TOL, **tp_rows(res),
           "wall_s": wall, "build_s": build_s, "plans": m["tp_plans_total"],
           "pool_pages_compared": len(used), "pool_differing_elements": differ,
           "pool_read_s": read_s, "launches_by_rank": _launch_delta(before, after),
           "card": card_line()}
    return out, problems


async def _with_anchor(engine, anchor, body):
    """`body()` while `anchor` decodes (started first; body starts at its
    first token, and the anchor stops when body is done); returns body's
    result."""
    from dynamo_tpu_torch.runtime import Context

    first, ctx = asyncio.Event(), Context("anchor")
    task = asyncio.ensure_future(_collect_as(engine, anchor, "anchor", first,
                                             ctx))
    await first.wait()
    try:
        return await body()
    finally:
        ctx.stop_generating()
        out = await task
        if out["finish_reason"] == "length":
            fail(f"mesh (c): the anchor ended before the storm ({out})")


async def mesh_wave(engine, reqs, ref, twin, cfg):
    """(b) The five requests, each sent once the previous one streams
    (so each admits onto the partition with more free pages): tokens
    against the twin's; every sequence's pages on its partition; the
    pages held at once against one partition's."""
    seqs, held = {}, []
    _finish_spy(engine, seqs)
    real = engine.scheduler.schedule
    usable = engine.cfg.num_pages - 1

    def spy():
        plan = real()
        held.append(engine.pool.ranks * usable - engine.pool.available_pages)
        return plan

    engine.scheduler.schedule = spy
    try:
        before = await engine.group_stats()
        t0 = time.perf_counter()
        tasks = []
        for n, r in reqs.items():
            first = asyncio.Event()
            tasks.append(asyncio.ensure_future(_collect_as(engine, r, n, first)))
            await first.wait()
            _mesh_note(f"(b) {n} streams")
        outs = await asyncio.gather(*tasks)
        wall = time.perf_counter() - t0
        after = await engine.group_stats()
    finally:
        engine.scheduler.schedule = real
    res = dict(zip(reqs, outs))
    problems, flips = tp_check(twin, cfg, reqs, ref, res, TP_GREEDY, 32)
    per_part = [0] * engine.dp
    for n, (pages, rank) in seqs.items():
        if n not in reqs:
            continue
        per_part[rank] += len(pages)
        if {p // engine.cfg.num_pages for p in pages} != {rank}:
            problems.append(f"(b) {n}'s pages {pages} leave partition {rank}")
    # the small sequences' pages hold KV on their partition's ranks only
    presence = {}
    for n in ("A_64", "E_300"):
        pages, rank = seqs[n]
        reads = await engine._device_op(lambda p=pages: engine.rank_pages(p))
        per = engine.tp * engine.pp  # a replica's ranks
        mine = reads[rank * per:(rank + 1) * per]
        other = reads[(1 - rank) * per:(2 - rank) * per]
        presence[n] = {
            "partition": rank, "pages": len(pages),
            "owner_nonzero": all(bool(k.abs().sum() > 0) for k, _ in mine),
            "other_equal": any(torch.equal(_bits(a[0]), _bits(b[0]))
                               for a, b in zip(mine, other))}
        if not presence[n]["owner_nonzero"] or presence[n]["other_equal"]:
            problems.append(f"(b) {n}: {presence[n]}")
    peak = max(held)
    if peak <= usable or len({r for _, r in seqs.values()}) < 2:
        problems.append(f"(b) the wave held at most {peak} pages "
                        f"(one partition: {usable}) on partitions "
                        f"{sorted({r for _, r in seqs.values()})}")
    return {"greedy_equal": {n: res[n]["tokens"] == ref[n] for n in TP_GREEDY},
            "flips": flips, **tp_rows(res), "wall_s": wall,
            "partition_of": {n: seqs[n][1] for n in reqs},
            "pages_per_partition": per_part, "peak_pages_held": peak,
            "partition_pages": usable, "presence": presence,
            "launches_by_rank": _launch_delta(before, after)}, problems


async def mesh_park_tier(engine, cfg, reqs, twin, what="(c)", keep_tier=False):
    """On a partitioned group: the storm (a 1224-token batch victim
    admitted beside a 2048-token interactive anchor that holds partition
    0, parked for a 64-token arrival on its partition and resumed) against
    the same run without the arrival, bit for bit; a host tier: a
    1088-token prompt's blocks onboarded into the partition that admits
    it again, against its cold tokens.  Returns (out, problems, the
    prompt, its cold run); with `keep_tier`, out["tier_pages"] holds the
    onboarded request's pages."""
    from dynamo_tpu_torch.kvbm import HostBlockPool, TieredKvCache

    victim, inter, dprompts = tpkv_prompts(cfg)
    anchor = _req(reqs["C_2048"]["token_ids"], max_tokens=96)
    out, problems = {}, []
    # park and resume on the victim's partition
    parked = []
    park = engine.scheduler.park_fn

    def spy_park(seq):
        ok = park(seq)
        if ok:
            parked.append(seq.kv_rank)
        return ok

    engine.scheduler.park_fn = spy_park
    engine.clear_kv_blocks()
    alone = await _with_anchor(engine, anchor, lambda: _collect(engine, victim))
    _mesh_note(f"{what} the victim beside the anchor")
    engine.clear_kv_blocks()
    m0 = engine.metrics()
    engine.dispatch_trace = trace = []
    got, _, order = await _with_anchor(
        engine, anchor, lambda: _storm(engine, victim, inter, 2))
    engine.dispatch_trace = None
    _mesh_note(f"{what} the storm")
    m1 = engine.metrics()
    out["park"] = {
        "victim_tokens_equal_alone": got["tokens"] == alone["tokens"],
        "parked_on_partition": parked, "finish_order": order,
        "preempted": m1.preempted_total - m0.preempted_total,
        "resumed": m1.resumed_total - m0.resumed_total,
        "lot_after": [len(engine.parking), engine.parking.pages_held],
        "moves": [{k: e[k] for k in ("kind", "pages", "ms", "cached") if k in e}
                  for e in trace if e["kind"] in ("park", "resume")]}
    p = out["park"]
    if not (p["victim_tokens_equal_alone"] and p["preempted"] >= 1
            and p["preempted"] == p["resumed"] and p["lot_after"] == [0, 0]
            and order == ["interactive", "victim"] and parked == [1]):
        problems.append(f"{what} park: {p}")
    # a host tier: blocks onboarded into the admitting partition
    tier = TieredKvCache(HostBlockPool(capacity_bytes=TPKV_HOST_BYTES))
    engine.attach_connector(tier)
    prompt = dprompts["greedy_1088"]
    seqs = {}
    _finish_spy(engine, seqs)
    engine.clear_kv_blocks()
    cold = await _collect_as(engine, _req(prompt, max_tokens=MESH_TOKENS), "cold")
    for _ in range(2000):
        if not tier.offload_backlog:
            break
        await asyncio.sleep(0.01)
    engine.clear_kv_blocks()
    engine.dispatch_trace = trace = []
    b0 = tier.onboarded_blocks
    again = await _collect_as(engine, _req(prompt, max_tokens=MESH_TOKENS), "again")
    engine.dispatch_trace = None
    _mesh_note(f"{what} the tier")
    onboard = [e for e in trace if e["kind"] == "onboard"]
    bad, flip = tpkv_flip_problems(twin(), cfg, prompt, cold["tokens"],
                                   again["tokens"], f"{what} onboarded") \
        if again["tokens"] != cold["tokens"] else ([], None)
    problems += bad
    pages, rank = seqs["again"]
    full = len(prompt) // engine.cfg.page_size
    out["tiers"] = {"onboarded_blocks": tier.onboarded_blocks - b0,
                    "onboard_ms": sum(e["ms"] for e in onboard),
                    "onboard_pages": sum(e["pages"] for e in onboard),
                    "partition": rank, "ttft_ms": again["ttft_ms"],
                    "cold_ttft_ms": cold["ttft_ms"],
                    "equal_to_cold": again["tokens"] == cold["tokens"],
                    "flip": flip}
    if (out["tiers"]["onboarded_blocks"] < full - 1
            or {q // engine.cfg.num_pages for q in pages} != {rank}):
        problems.append(f"{what} tiers: {out['tiers']}")
    if keep_tier:
        out["tier_pages"] = pages
    return out, problems, prompt, cold


async def mesh_moves(engine, cfg, reqs, twin, addr, prefill_worker):
    """(c) On (b)'s group: `mesh_park_tier`, then one remote prefill of
    its 1088-token prompt from the flat prefill worker over the CUDA IPC
    lane, the imported pages byte-equal to the source's on the admitting
    replica's ranks only, its tokens against the same cold run.  (A
    2048-token import would leave its partition fewer free pages than the
    admission check asks of a first chunk, a check the copied scheduler
    makes of imported sequences too: the adopted request would wait.)"""
    from dynamo_tpu_torch.disagg import DisaggDecodeHandler
    from dynamo_tpu_torch.runtime import Context, DistributedRuntime

    before = await engine.group_stats()
    out, problems, prompt, cold = await mesh_park_tier(engine, cfg, reqs, twin)
    # one remote prefill over the CUDA IPC lane into the admitting partition
    loop = asyncio.get_running_loop()
    rt = await DistributedRuntime.connect(addr)
    try:
        await loop.run_in_executor(None, _ready, prefill_worker, "READY worker",
                                   "mesh (c): the prefill worker")
        _mesh_note("(c) the prefill worker is ready")
        handler = DisaggDecodeHandler(engine, rt, namespace=MESH_NS)
        moved, real_fetch = [], handler.transfer_client.fetch

        async def fetch(desc, timeout=60.0):
            got_pages, stats = await real_fetch(desc, timeout=timeout)
            moved.append((desc, got_pages))
            return got_pages, stats

        handler.transfer_client.fetch = fetch
        try:
            engine.clear_kv_blocks()
            t1 = time.perf_counter()
            toks, t_first = [], None
            async for d in handler.generate(_req(prompt, max_tokens=MESH_TOKENS),
                                            Context()):
                if d.get("finish_reason") == "error":
                    problems.append(f"(c) remote prefill: {d}")
                    break
                if d["token_ids"] and t_first is None:
                    t_first = time.perf_counter()
                toks.extend(d["token_ids"])
            checks = [await dp_window_check(engine, handler.transfer_client.ipc,
                                            desc, pg) for desc, pg in moved]
            m = vars(handler.metrics())
        finally:
            await _close_handler(handler)
    finally:
        await rt.shutdown(graceful=False)
    bad, flip = tpkv_flip_problems(twin(), cfg, prompt, cold["tokens"], toks,
                                   "(c) remote") \
        if toks != cold["tokens"] else ([], None)
    problems += bad
    out["remote"] = {"ttft_ms": ((t_first or t1) - t1) * 1e3,
                     "cold_ttft_ms": cold["ttft_ms"],
                     "ipc_transfers": m["kv_transfer_ipc_count"],
                     "prefill_fallback_total": m["prefill_fallback_total"],
                     "transfer_ms": m["kv_transfer_ms_total"],
                     "window_checks": checks, "equal_to_cold": toks == cold["tokens"],
                     "flip": flip}
    if (m["kv_transfer_ipc_count"] != 1 or m["prefill_fallback_total"]
            or len(checks) != 1 or checks[0]["differing_elements"]
            or checks[0]["other_replica_equal"]):
        problems.append(f"(c) remote: {out['remote']}")
    out["launches_by_rank"] = _launch_delta(before, await engine.group_stats())
    return out, problems


async def dp_window_check(engine, lane, desc, pages):
    """`tpkv_window_check` on a partitioned group: the imported pages
    against the source's on the ranks of the replica whose partition
    holds them, byte for byte; the other replica's ranks hold other data
    at those local ids."""
    from dynamo_tpu_torch.disagg.device_transfer import rank_entries

    entry, n = desc["cuda_ipc"], int(desc["prompt_len"])
    srcs = [lane.pools(e) for e in rank_entries(entry)]
    src = [torch.cat([_token_major(s[i], entry["pages"], n) for s in srcs],
                     dim=2).cpu() for i in (0, 1)]
    owner = pages[0] // engine.cfg.num_pages
    reads = await engine._device_op(lambda: engine.rank_pages(pages))
    tp = engine.tp
    differ, other_equal = 0, False
    for d in range(engine.dp):
        for t in range(tp):
            for got, want in zip(reads[d * tp + t], src):
                L, _, ps, h, hd = got.shape
                x = got.reshape(L, len(pages) * ps, h, hd)[:, :n]
                same = int((_bits(x) != _bits(want[:, :, t * h:(t + 1) * h])).sum())
                if d == owner:
                    differ += same
                else:
                    other_equal |= same == 0
    return {"owner": owner, "ranks": tp, "source_ranks": len(srcs),
            "differing_elements": differ, "other_replica_equal": other_equal}


def phase_mesh_dp(cut, ref, flat_rows):
    """Phase 17 (see the module docstring).  `cut`, `ref`: phase 15 (a)'s
    flat twin's config (the 8B at CUT_LAYERS layers) and its greedy
    tokens of phase 4's requests; `flat_rows` its tokens/s and TTFT.
    Returns each group's launches per rank."""
    import gc

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.parallel import ParallelConfig, SeededShards

    cfg = cut
    reqs, warm = mesh_requests(cfg)
    twin_cache = []

    def twin():
        if not twin_cache:
            twin_cache.append(tp_flat_twin(cfg, CUT_LAYERS)[0])
        return twin_cache[0]

    procs, launches, problems = [], {}, []
    try:
        addr, prefill_worker, http_spawned = mesh_spawn(procs, cfg)
        a, bad = mesh_replicated(cfg, ref, twin)
        _mesh_note("(a) done")
        problems += bad
        emit({**a, "flat_twin": flat_rows})
        launches["a"] = a["launches_by_rank"]
        t0 = time.perf_counter()
        engine = TorchEngine(cfg, SeededShards(cfg, SEED, "bfloat16",
                                               sharpen=True),
                             EngineConfig(**MESH_PART_ECFG, kv_partition=True),
                             parallel=ParallelConfig(dp=2, tp=2),
                             devices=["cuda:0"] * 4)
        build_s = time.perf_counter() - t0
        _mesh_note(f"(b) built in {build_s:.1f}s")

        async def run():
            try:
                await _collect(engine, warm)
                _mesh_note("(b) warmed")
                b, b_bad = await mesh_wave(engine, reqs, ref, twin, cfg)
                _mesh_note("(b) wave done")
                c, c_bad = await mesh_moves(engine, cfg, reqs, twin, addr,
                                            prefill_worker)
                _mesh_note("(c) done")
                return b, c, b_bad + c_bad, vars(engine.metrics())
            finally:
                await engine.shutdown()

        b, c, bad, m = asyncio.run(run())
        problems += bad
        emit({"phase": "mesh", "case": "b", "model": cfg.name,
              "layers": cfg.num_hidden_layers, "dp": 2, "tp": 2,
              "kv_partition": True, "build_s": build_s,
              "kv_total_pages": m["kv_total_pages"], "plans": m["tp_plans_total"],
              **b, "flat_twin": flat_rows, "card": card_line()})
        emit({"phase": "mesh", "case": "c", **c, "card": card_line()})
        launches["b"], launches["c"] = b["launches_by_rank"], c["launches_by_rank"]
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        # (d) the worker CLI's partitioned dp 2 x tp 2 group over HTTP
        tp_http([(twin, cfg, 2, ref["A_64"], 2)], http_spawned)
        _mesh_note("(d) done")
    finally:
        _stop_all(procs)
    if problems:
        fail(f"mesh: {problems}")
    for case in ("a", "b", "c"):
        tp_launch_gate(f"mesh ({case})", launches[case], ATTENTION_KERNELS)
    return launches


def dp_probe_main() -> int:
    """The mutation check's probe of a partitioned dispatch: a dp 2 group
    over the 8B's full width at one layer, partitioned, two staggered
    requests (the second on partition 1) against a flat engine on the
    same weights; prints one JSON line with the problems it finds (none
    on the port as it is)."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models import LLAMA_3_1_8B
    from dynamo_tpu_torch.ops import _build
    from dynamo_tpu_torch.parallel import ParallelConfig, SeededShards

    _build.build_all()
    cfg = LLAMA_3_1_8B.with_depth(1)
    _, prompts = serving_prompts(cfg)
    reqs = {n: _req(prompts[n][0], max_tokens=MESH_TOKENS)
            for n in ("E_300", "A_64")}
    src = SeededShards(cfg, SEED, "bfloat16", sharpen=True)
    flat_model = src(0, 1, torch.device("cuda"))
    flat = TorchEngine(cfg, flat_model, EngineConfig(**MESH_PART_ECFG),
                       device="cuda")

    async def run_flat():
        try:
            return {n: (await _collect(flat, r))["tokens"]
                    for n, r in reqs.items()}
        finally:
            await flat.shutdown()

    want = asyncio.run(run_flat())
    group = TorchEngine(cfg, src, EngineConfig(**MESH_PART_ECFG, kv_partition=True),
                        parallel=ParallelConfig(dp=2), devices=["cuda:0"] * 2)
    seqs = {}
    _finish_spy(group, seqs)

    async def run_group():
        try:
            tasks = []
            for n, r in reqs.items():
                first = asyncio.Event()
                tasks.append(asyncio.ensure_future(
                    _collect_as(group, r, n, first)))
                await first.wait()
            return {n: o["tokens"] for n, o in
                    zip(reqs, await asyncio.gather(*tasks))}
        finally:
            await group.shutdown()

    got = asyncio.run(run_group())
    problems, flips = [], {}
    for n in reqs:
        if got[n] != want[n]:
            flips[n] = f = first_flip(flat_model, cfg, reqs[n]["token_ids"],
                                      want[n], got[n])
            if f["margin_std"] is None or abs(f["margin_std"]) > LOGIT_TOL:
                problems.append(f"{n} (partition {seqs[n][1]}) flips beyond "
                                f"a near-tie: {f}")
    print(json.dumps({"dp_probe": {
        "partitions": {n: seqs[n][1] for n in reqs}, "flips": flips,
        "problems": problems}}), flush=True)
    return 0


# --------------------------------------------------------------------------- #
# phase 19: pipeline parallelism
# --------------------------------------------------------------------------- #

# phase 15's engine with 4-step decode blocks: each decode dispatch is a
# ring of 4 steps, the last stage handing 3 tokens a row back to stage 0
PP_ECFG = dict(TP_ECFG, decode_steps=4)
# (b): Llama-3-70B's published widths at this many layers, 2 a stage
PP_70B_LAYERS = 4
PP_PENALTY = {"frequency_penalty": 0.5, "presence_penalty": 0.25}
PP_MODEL = "pp2"  # (d)'s worker serves the cut 8B under this name's suffix


def _pp_note(what: str) -> None:
    """A progress line of phase 19 on stderr."""
    print(f"pipeline {time.perf_counter() - _T0:.1f}s {what}", file=sys.stderr,
          flush=True)


def pp_requests(cfg):
    """Phase 4's five requests and its warm-up, plus a penalized and a
    top-logprobs (3) request on prompts of their own."""
    reqs, warm = mesh_requests(cfg)
    g = torch.Generator().manual_seed(SEED + 19)
    pen, top = (torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
                for n in (200, 96))
    reqs["F_penalized"] = _req(pen)
    reqs["F_penalized"]["sampling_options"].update(PP_PENALTY)
    reqs["G_top3"] = _req(top)
    reqs["G_top3"]["sampling_options"].update(logprobs=True, top_logprobs=3)
    return reqs, warm


async def _collect_tops(engine, req):
    """`_collect` with each token's top logprobs."""
    t0 = time.perf_counter()
    toks, tops, reason, t_first, t_last = [], [], None, None, None
    async for d in engine.generate(req):
        now = time.perf_counter()
        if d["token_ids"]:
            t_first = t_first or now
            t_last = now
        toks.extend(d["token_ids"])
        tops += d.get("top_logprobs") or []
        reason = d["finish_reason"]
    return {"tokens": toks, "tops": tops, "finish_reason": reason,
            "ttft_ms": (t_first - t0) * 1e3 if t_first else None,
            "t_first": t_first, "t_last": t_last}


def pp_wave(engine, reqs, warm, stats=True):
    """The warm-up, then every request at once (each with its top
    logprobs); returns (results, wall s, each rank's report before and
    after the wave (None without `stats`), the leader's dispatches)."""

    async def run():
        try:
            await _collect(engine, warm)
            before = await engine.group_reports() if stats else None
            engine.dispatch_trace = trace = []
            t0 = time.perf_counter()
            outs = await asyncio.gather(*[_collect_tops(engine, r)
                                          for r in reqs.values()])
            wall = time.perf_counter() - t0
            engine.dispatch_trace = None
            after = await engine.group_reports() if stats else None
            return outs, wall, before, after, trace
        finally:
            await engine.shutdown()

    outs, wall, before, after, trace = asyncio.run(run())
    return dict(zip(reqs, outs)), wall, before, after, trace


def pp_penalized_flip(model, cfg, req, ref, got):
    """`first_flip` of a penalized row: the margin on the reference logits
    less the penalties of the tokens before the flip."""
    if got == ref:
        return None
    j = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b),
             min(len(ref), len(got)))
    if j >= min(len(ref), len(got)):
        return {"index": j, "margin_std": None}
    lg = reference_logits(model, cfg, req["token_ids"] + ref[:j]).float()
    counts = torch.zeros_like(lg)
    for t in ref[:j]:
        counts[t] += 1
    so = req["sampling_options"]
    lg = (lg - so["frequency_penalty"] * counts
          - so["presence_penalty"] * (counts > 0).float())
    return {"index": j, "ref_token": ref[j], "arm_token": got[j],
            "margin_std": ((lg[ref[j]] - lg[got[j]]) / lg.std()).item()}


def pp_check(get_model, cfg, reqs, ref, res, n_tokens=32):
    """(problems, flips): every request ended with its `n_tokens`; the
    greedy rows (the top-logprobs row among them) equal `ref` up to
    near-ties (phase 15's rule), the penalized row too with the
    penalties in its margin; the seeded row is reported."""
    greedy = [n for n in TP_GREEDY + ("G_top3",) if n in res]
    problems, flips = tp_check(get_model, cfg, reqs, ref, res, greedy, n_tokens)
    n = "F_penalized"
    if n in res and not problems and res[n]["tokens"] != ref[n]:
        flips[n] = f = pp_penalized_flip(get_model(), cfg, reqs[n], ref[n],
                                         res[n]["tokens"])
        if f["margin_std"] is None or abs(f["margin_std"]) > LOGIT_TOL:
            problems.append(f"{n} flips beyond a near-tie: {f}")
    return problems, flips


def pp_top_diff(ref, got):
    """The G_top3 row against the reference's: whether its top ids agree at
    every token before the first flip, and the largest logprob gap
    there."""
    agree, gap = True, 0.0
    for t, (a, b) in enumerate(zip(ref["tops"], got["tops"])):
        if ref["tokens"][t] != got["tokens"][t]:
            break
        agree &= [i for i, _ in a] == [i for i, _ in b]
        gap = max([gap] + [abs(x - y) for (_, x), (_, y) in zip(a, b)])
    return {"ids_agree_before_flip": agree, "max_logprob_gap": gap,
            "tokens_with_tops": len(got["tops"])}


def pp_report(what, res, wall, before, after, trace, ref_rows):
    """The per-stage line of a group's wave: tokens/s and TTFT beside the
    reference's, each rank's stage, launches of the attention kernels and
    handoffs (sends, bytes) over the wave, and per dispatch."""
    dispatches = sum(1 for e in trace if e["kind"] in ("prefill", "decode"))
    ranks = {}
    for r in sorted(after):
        a, b = after[r], before[r]
        sends = a["handoffs"]["sends"] - b["handoffs"]["sends"]
        nbytes = a["handoffs"]["bytes"] - b["handoffs"]["bytes"]
        ranks[r] = {"stage": a["stage"],
                    "launches": {k: a["launches"].get(k, 0)
                                 - b["launches"].get(k, 0)
                                 for k in ATTENTION_KERNELS},
                    "handoffs": sends, "handoff_bytes": nbytes,
                    "handoffs_per_dispatch": sends / max(dispatches, 1),
                    "handoff_bytes_per_dispatch": nbytes / max(dispatches, 1)}
    return {**tp_rows(res), "wall_s": wall, "dispatches": dispatches,
            "reference": ref_rows, "ranks": ranks, "what": what}


def pp_spawn(procs, cfg):
    """(d)'s processes, built while (a)-(c) run: a control plane, ``python
    -m dynamo_tpu_torch.worker --pp 2 --tp 2`` (4 ranks sharing the card,
    the 8B at CUT_LAYERS layers, served as ``<name>-pp2``) and a
    frontend."""
    t0 = time.perf_counter()
    cp = _spawn(procs, "dynamo_tpu_torch.runtime", "--host", "127.0.0.1",
                "--port", "0", "--log-level", "warning")
    addr = _ready(cp, "READY ", "pipeline: the control plane").split()[1]
    worker = _spawn(procs, "dynamo_tpu_torch.worker", "--control", addr,
                    "--model", cfg.name, "--model-name",
                    f"{cfg.name}-{PP_MODEL}", "--seed", str(SEED), "--sharpen",
                    "--num-layers", str(CUT_LAYERS), "--pp", "2", "--tp", "2",
                    "--tp-devices", ",".join(["cuda:0"] * 4), "--num-pages",
                    "256", "--decode-steps", "4", "--status-port", "0",
                    "--log-level", "warning")
    front = _spawn(procs, "dynamo_tpu_torch.frontend", "--control", addr,
                   "--host", "127.0.0.1", "--port", "0", "--log-level",
                   "warning")
    return [worker], front, t0


def pp_llama8b(model, cfg, direct=None):
    """(a) Phase 4's 8B at full width and depth (32 layers).  The
    reference rows come from the flat engine's own decode path (TP_ECFG,
    its graphs): the penalized and top-logprobs requests, and phase 4's
    wave too when `direct` (phase 4's rows of it) is None.  A second
    engine on the same model, through the pipeline path at one stage
    (`_staged`, eager), serves phase 4's wave (the warm-up, then the
    five at once), bit-equal to the reference's five.  Then a pp 2 x tp 1 group (16 layers a stage,
    the ranks sharing the card over gloo, PP_ECFG's 4-step rings) on all
    seven at once against the reference up to near-ties.  Returns
    (problems, each rank's launches)."""
    import gc

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.parallel import ParallelConfig, SeededShards

    reqs, warm = pp_requests(cfg)
    five = {n: r for n, r in reqs.items() if n in serving_prompts(cfg)[1]}
    extra = {n: r for n, r in reqs.items() if n not in five}
    problems = []

    async def run(engine, wave, first=None):
        """`first` (the warm-up, then each request of `first` at once,
        timed), then each request of `wave` at once."""
        try:
            a, wall = {}, None
            if first:
                await _collect(engine, warm)
                t0 = time.perf_counter()
                a = await asyncio.gather(*[_collect_tops(engine, r)
                                           for r in first.values()])
                wall = time.perf_counter() - t0
            b = await asyncio.gather(*[_collect_tops(engine, r)
                                       for r in wave.values()])
            return dict(zip(first or {}, a)), wall, dict(zip(wave, b))
        finally:
            await engine.shutdown()

    flat = TorchEngine(cfg, model, EngineConfig(**TP_ECFG), device="cuda")
    flat_five, _, res_flat = asyncio.run(
        run(flat, extra, five if direct is None else None))
    del flat
    _pp_note("(a) flat")
    ref = {**({n: direct["tokens"][n] for n in five} if direct is not None
              else {n: r["tokens"] for n, r in flat_five.items()}),
           **{n: r["tokens"] for n, r in res_flat.items()}}
    one = TorchEngine(cfg, model, EngineConfig(**TP_ECFG), device="cuda")
    one._staged = True  # noqa: SLF001 -- the pipeline path at one stage
    res_five, wall_one, _ = asyncio.run(run(one, {}, five))
    del one
    _pp_note("(a) one stage")
    one_stage = {n: r["tokens"] == ref[n] for n, r in res_five.items()}
    if not all(one_stage.values()):
        problems.append(f"(a) one stage differs from the flat rows: "
                        f"{one_stage}")
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, SeededShards(cfg, SEED, "bfloat16", sharpen=True),
                         EngineConfig(**PP_ECFG), parallel=ParallelConfig(pp=2),
                         devices=["cuda:0"] * 2)
    build_s = time.perf_counter() - t0
    res, wall, before, after, trace = pp_wave(engine, reqs, warm)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    _pp_note("(a) pp 2")
    bad, flips = pp_check(lambda: model, cfg, reqs, ref, res)
    problems += bad
    flat_rows = ({"phase4_graphs": {k: direct[k] for k in
                                    ("ttft_ms", "decode_tokens_per_s")}}
                 if direct is not None else {})
    rep = pp_report("pp 2 x tp 1", res, wall, before, after, trace,
                    {**flat_rows, "one_stage_eager": {**tp_rows(res_five),
                                                      "wall_s": wall_one}})
    emit({"phase": "pipeline", "case": "a", "model": cfg.name,
          "layers": cfg.num_hidden_layers, "pp": 2, "tp": 1,
          "decode_steps": PP_ECFG["decode_steps"], "build_s": build_s,
          "one_stage_bit_equal_flat": one_stage,
          "greedy_equal": {n: res[n]["tokens"] == ref[n] for n in res},
          "flips": flips, "tol_in_std": LOGIT_TOL,
          "top3": pp_top_diff(res_flat["G_top3"], res["G_top3"]),
          **rep, "card": card_line()})
    return problems, {r: v["launches"] for r, v in rep["ranks"].items()}


def pp_llama70b():
    """(b) Llama-3-70B's published widths at PP_70B_LAYERS layers on a pp 2
    x tp 2 group (4 ranks sharing the card) against its flat twin at the
    same depth (the flat engine's own decode path; the model is kept for
    the flips' margins), phase 4's five requests."""
    import gc

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models.config import LLAMA_3_70B
    from dynamo_tpu_torch.parallel import ParallelConfig, SeededShards

    twin, cfg = tp_flat_twin(LLAMA_3_70B, PP_70B_LAYERS)
    reqs, warm = mesh_requests(cfg)
    flat = TorchEngine(cfg, twin, EngineConfig(**PP_ECFG), device="cuda")
    res_flat, _, _, _, _ = pp_wave(flat, reqs, warm, stats=False)
    del flat
    _pp_note("(b) flat twin")
    ref = {n: r["tokens"] for n, r in res_flat.items()}
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, SeededShards(cfg, SEED, "bfloat16", sharpen=True),
                         EngineConfig(**PP_ECFG),
                         parallel=ParallelConfig(pp=2, tp=2),
                         devices=["cuda:0"] * 4)
    build_s = time.perf_counter() - t0
    res, wall, before, after, trace = pp_wave(engine, reqs, warm)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    _pp_note("(b) pp 2 x tp 2")
    bad, flips = pp_check(lambda: twin, cfg, reqs, ref, res)
    del twin
    gc.collect()
    torch.cuda.empty_cache()
    rep = pp_report("pp 2 x tp 2", res, wall, before, after, trace,
                    tp_rows(res_flat))
    emit({"phase": "pipeline", "case": "b", "model": cfg.name,
          "layers": cfg.num_hidden_layers, "pp": 2, "tp": 2,
          "build_s": build_s,
          "greedy_equal": {n: res[n]["tokens"] == ref[n] for n in TP_GREEDY},
          "flips": flips, "tol_in_std": LOGIT_TOL, **rep, "card": card_line()})
    return bad, {r: v["launches"] for r, v in rep["ranks"].items()}


async def pp_flat_pages(engine, prompt, n_tokens):
    """The pages (every layer, every head) holding `prompt`'s first
    `n_tokens` positions after a cold run of it alone on `engine`."""
    seqs = {}
    _finish_spy(engine, seqs)
    engine.clear_kv_blocks()
    await _collect_as(engine, _req(prompt, max_tokens=1), "pages")
    pages, _ = seqs["pages"]
    return await engine.export_pages(pages[:n_tokens // engine.cfg.page_size])


def pp_partitioned(cut, ref, twin):
    """(c) dp 2 x pp 2, the pool partitioned (phase 17's 160 pages a
    partition, two decode slots), the 8B at CUT_LAYERS layers: phase 17
    (b)'s wave (each request sent once the previous one streams), then
    `mesh_park_tier` (a batch victim parked and resumed on partition 1, a
    host tier's blocks onboarded into the admitting partition); the
    onboarded pages (every layer of every stage, exported from the group)
    byte-equal to the flat twin's pages of the same prompt."""
    import gc

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.parallel import ParallelConfig, SeededShards

    cfg = cut
    reqs, warm = mesh_requests(cfg)
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, SeededShards(cfg, SEED, "bfloat16", sharpen=True),
                         EngineConfig(**MESH_PART_ECFG, kv_partition=True),
                         parallel=ParallelConfig(dp=2, pp=2),
                         devices=["cuda:0"] * 4)
    build_s = time.perf_counter() - t0

    async def run():
        try:
            await _collect(engine, warm)
            b, b_bad = await mesh_wave(engine, reqs, ref, twin, cfg)
            _pp_note("(c) wave")
            before = await engine.group_stats()
            c, c_bad, prompt, _ = await mesh_park_tier(
                engine, cfg, reqs, twin, what="pipeline (c)", keep_tier=True)
            c["launches_by_rank"] = _launch_delta(before,
                                                  await engine.group_stats())
            n = (len(prompt) // engine.cfg.page_size - 1) * engine.cfg.page_size
            pages = c.pop("tier_pages")
            got = await engine.export_pages(pages[:n // engine.cfg.page_size])
            return b, c, b_bad + c_bad, prompt, n, got, vars(engine.metrics())
        finally:
            await engine.shutdown()

    b, c, problems, prompt, n, got, m = asyncio.run(run())
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    _pp_note("(c) park and tier")
    flat = TorchEngine(cfg, twin(), EngineConfig(**TP_ECFG), device="cuda")

    async def flat_pages():
        try:
            return await pp_flat_pages(flat, prompt, n)
        finally:
            await flat.shutdown()

    want = asyncio.run(flat_pages())
    del flat
    differ = sum(int((_bits(a) != _bits(b_)).sum()) for a, b_ in zip(got, want))
    c["onboarded_pages_vs_flat_twin"] = {
        "tokens": n, "layers": int(got[0].shape[0]),
        "differing_elements": differ}
    if differ or got[0].shape != want[0].shape:
        problems.append(f"(c) the onboarded pages differ from the flat twin's "
                        f"on {differ} elements")
    emit({"phase": "pipeline", "case": "c", "model": cfg.name,
          "layers": cfg.num_hidden_layers, "dp": 2, "pp": 2, "tp": 1,
          "kv_partition": True, "build_s": build_s,
          "kv_total_pages": m["kv_total_pages"], "plans": m["tp_plans_total"],
          **b, "moves": c, "card": card_line()})
    return problems, b["launches_by_rank"], c["launches_by_rank"]


def phase_pipeline(cfg, direct, cut, ref):
    """Phase 19 (see the module docstring).  `cfg`, `direct`: phase 4's
    8B at full depth (drawn again here from the script's seed) and its
    rows; `cut`, `ref`: phase 15 (a)'s flat twin's config (the 8B at
    CUT_LAYERS layers) and its greedy tokens of phase 4's requests.
    Returns each group's launches per rank."""
    procs = []
    try:
        spawned = pp_spawn(procs, cut)
        return _pipeline_arms(cfg, direct, cut, ref, spawned)
    finally:
        _stop_all(procs)


def _pipeline_arms(cfg, direct, cut, ref, spawned):
    """Phase 19's (a)-(d), `spawned` being (d)'s processes."""
    import dataclasses
    import gc

    from dynamo_tpu_torch.models import init_params

    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        dtype=torch.bfloat16, device="cuda")
    sharpen(model)
    problems, launches = [], {}
    bad, launches["a"] = pp_llama8b(model, cfg, direct)
    problems += bad
    del model
    gc.collect()
    torch.cuda.empty_cache()
    bad, launches["b"] = pp_llama70b()
    problems += bad
    twin_cache = []

    def twin():
        if not twin_cache:
            twin_cache.append(tp_flat_twin(cut, CUT_LAYERS)[0])
        return twin_cache[0]

    bad, launches["c_wave"], launches["c_moves"] = pp_partitioned(cut, ref, twin)
    problems += bad
    # (d) the worker CLI's pp 2 x tp 2 group over HTTP
    named = dataclasses.replace(cut, name=f"{cut.name}-{PP_MODEL}")
    tp_http([(twin, named, 2, ref["A_64"], 1, 2)], spawned)
    _pp_note("(d) done")
    del twin_cache[:]
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        fail(f"pipeline: {problems}")
    for case, got in launches.items():
        tp_launch_gate(f"pipeline ({case})", got, ATTENTION_KERNELS)
    return launches


PP_PROBE_LAYERS = 4


def pp_probe_main() -> int:
    """The mutation check's probe of the decode ring: phase 19 (a) on the
    8B's full width at PP_PROBE_LAYERS layers (the flat engine's rows,
    one stage, a pp 2 group); prints one JSON line with the problems it
    finds (none on the port as it is)."""
    from dynamo_tpu_torch.models import LLAMA_3_1_8B, init_params
    from dynamo_tpu_torch.ops import _build

    _build.build_all()
    cfg = LLAMA_3_1_8B.with_depth(PP_PROBE_LAYERS)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        dtype=torch.bfloat16, device="cuda")
    sharpen(model)
    problems, _ = pp_llama8b(model, cfg)
    print(json.dumps({"pp_probe": {"layers": PP_PROBE_LAYERS,
                                   "problems": problems}}), flush=True)
    return 0


# --------------------------------------------------------------------------- #
# phase 20: sequence parallelism
# --------------------------------------------------------------------------- #

# whole prompts of up to 8192 tokens and the tokens they decode
SP_LEN = 8448
SP_ECFG = dict(TP_ECFG, max_prefill_tokens=SP_LEN, max_model_len=SP_LEN)
# (a)'s flat reference: the same pool, its prefill chunked at TP_ECFG's 512
SP_FLAT_ECFG = dict(TP_ECFG, max_model_len=SP_LEN)
SP_PROMPTS = {"L_8192": 8192, "M_4096": 4096, "S_1000": 1000}
SP_GREEDY = tuple(SP_PROMPTS)
SP_KERNELS = ("ring_block", "ring_finish", "decode_attention")
# (b): gpt-oss-20b's widths, a shared prefix and the tail that hits it
SP_PREFIX, SP_TAIL, SP_OSS_TOKENS = 2048, 512, 16
# (a)'s logits check: the tail after SP_PREFIX cached tokens, no multiple
# of 2 or 4 (the pass is padded), and its decode steps
SP_CHECK_TAIL = 2047
SP_OSS_ECFG = dict(TP_ECFG, max_prefill_tokens=4096, max_model_len=4096)
# (c): phase 17's partitions (160 pages), four of them, whole prompts and
# no prefix cache (a partitioned pool's prefix pages are owner-local)
SP_PART_ECFG = dict(MESH_PART_ECFG, max_prefill_tokens=4096,
                    enable_prefix_caching=False, max_num_seqs=4)
SP_REPORT_KERNELS = SP_KERNELS + ("prefill_attention", "moe_grouped_gemm",
                                  "moe_grouped_glu")


def _sp_note(what: str) -> None:
    """A progress line of phase 20 on stderr."""
    print(f"sequence_parallel {time.perf_counter() - _T0:.1f}s {what}",
          file=sys.stderr, flush=True)


def sp_requests(cfg):
    """(a)'s prompts of 8192, 4096 and 1000 tokens (greedy, 32 tokens
    each), a seeded 1000-token row, and a 64-token warm-up."""
    g = torch.Generator().manual_seed(SEED + 20)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()

    reqs = {n: _req(prompt(L)) for n, L in SP_PROMPTS.items()}
    reqs["T_seeded"] = _req(prompt(1000), temperature=0.8, seed=7)
    return reqs, _req(prompt(64), max_tokens=4)


def sp_rank_report(before, after, layers):
    """Each rank's slot, kernel launches, ring rotations (sends, bytes,
    host ms, and per layer) and sequence gathers between two reports."""
    out = {}
    for r in sorted(after):
        a, b = after[r], before[r]
        rot = {k: a["handoffs"][k] - b["handoffs"][k]
               for k in ("sends", "bytes", "ms")}
        gat = {k: a["gathers"][k] - b["gathers"][k]
               for k in ("calls", "bytes", "ms")}
        out[r] = {"sp_rank": a["sp_rank"],
                  "launches": {k: a["launches"].get(k, 0)
                               - b["launches"].get(k, 0)
                               for k in SP_REPORT_KERNELS},
                  "rotations": rot, "gathers": gat,
                  "rotation_ms_per_layer": rot["ms"] / layers,
                  "rotation_bytes_per_layer": rot["bytes"] / layers}
    return out


def sp_serve(engine, reqs, warm, stats=True, extra=None):
    """The warm-up, the first request alone (its TTFT), then the rest at
    once; then ``await extra(engine)`` when given.  Returns (results, the
    rest's wall s, the group's reports before and after the first and
    after the rest (None without `stats`), extra's result)."""

    async def run():
        try:
            await _collect(engine, warm)
            r0 = await engine.group_reports() if stats else None
            first = next(iter(reqs))
            one = await _collect(engine, reqs[first])
            r1 = await engine.group_reports() if stats else None
            t0 = time.perf_counter()
            rest = await asyncio.gather(*[_collect(engine, r)
                                          for n, r in reqs.items()
                                          if n != first])
            wall = time.perf_counter() - t0
            r2 = await engine.group_reports() if stats else None
            more = await extra(engine) if extra is not None else None
            return {first: one, **dict(zip(list(reqs)[1:], rest))}, wall, \
                (r0, r1, r2), more
        finally:
            await engine.shutdown()

    return asyncio.run(run())


async def sp_tier(engine, cfg, model):
    """A host tier on (a)'s group: the 1088-token prompt cold, its blocks
    offloaded, then served again with its blocks onboarded; its tokens
    against the cold run's (up to a near-tie)."""
    from dynamo_tpu_torch.kvbm import HostBlockPool, TieredKvCache

    prompt = tpkv_prompts(cfg)[2]["greedy_1088"]
    tier = TieredKvCache(HostBlockPool(capacity_bytes=TPKV_HOST_BYTES))
    engine.attach_connector(tier)
    engine.clear_kv_blocks()
    cold = await _collect(engine, _req(prompt, max_tokens=MESH_TOKENS))
    for _ in range(2000):
        if not tier.offload_backlog:
            break
        await asyncio.sleep(0.01)
    engine.clear_kv_blocks()
    b0 = tier.onboarded_blocks
    again = await _collect(engine, _req(prompt, max_tokens=MESH_TOKENS))
    problems, flip = ([], None)
    if again["tokens"] != cold["tokens"]:
        problems, flip = tpkv_flip_problems(model, cfg, prompt, cold["tokens"],
                                            again["tokens"], "(a) onboarded")
    out = {"onboarded_blocks": tier.onboarded_blocks - b0,
           "ttft_ms": again["ttft_ms"], "cold_ttft_ms": cold["ttft_ms"],
           "equal_to_cold": again["tokens"] == cold["tokens"], "flip": flip}
    if out["onboarded_blocks"] < len(prompt) // engine.cfg.page_size - 1:
        problems.append(f"(a) tier: {out}")
    return out, problems


def sp_logit_check(model, cfg, sp):
    """(a)'s logits through `forward_prefill_sp` itself (the served rows'
    tokens cannot see a wrong ring: the sharpened embedding outweighs
    attention in the argmax): the flat model's `sp_hit_path` (a
    SP_PREFIX-token prefix, then a SP_CHECK_TAIL-token tail that reads it
    from the pages, then SP_OSS_TOKENS decode steps) against the same
    path on an sp group of `sp` ranks fed the same tokens.  It runs the
    rope positions at the slot offsets, the prefix fold through the table,
    the padding, the pool writes the decode steps read, and the last
    position's sum over sp.  Returns (report, problems): the largest
    logit difference within LOGIT_TOL of the flat logits' std."""
    g = torch.Generator().manual_seed(SEED + 24)
    prefix = torch.randint(0, cfg.vocab_size, (SP_PREFIX,), generator=g).tolist()
    tail = torch.randint(0, cfg.vocab_size, (SP_CHECK_TAIL,),
                         generator=g).tolist()
    with torch.no_grad():
        ref, toks = sp_hit_path(model, cfg, prefix, tail, SP_OSS_TOKENS)
    out = sp_group_logits(cfg, sp, 1, SEED, prefix, tail, ref.cpu(),
                          toks[:SP_OSS_TOKENS])
    if out["logit_err_in_std"] <= LOGIT_TOL:
        return out, []
    return out, [f"(a) the logits through forward_prefill_sp on sp {sp} lie "
                 f"{out['logit_err_in_std']:.3f} std from the flat "
                 f"forward_prefill's (tolerance {LOGIT_TOL})"]


def sp_llama8b(model, cfg, layers_note="full depth", sp=2):
    """(a) Llama-3.1-8B's widths (at `cfg`'s depth) on an sp group (`sp`
    ranks sharing the card over gloo) against the flat engine on the same
    weights: the 8192-token prompt alone, then the 4096, 1000 and seeded
    rows at once; greedy rows equal up to near-ties; the 8192 prompt's
    TTFT beside the flat engine's chunked prefill; each rank's ring
    rotations and gathers per layer, ring and decode launches; then a
    host tier's onboard on the group; then `sp_logit_check`.  Returns
    (problems, launches per rank)."""
    import gc

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.parallel import ParallelConfig, SeededShards

    reqs, warm = sp_requests(cfg)
    flat = TorchEngine(cfg, model, EngineConfig(**SP_FLAT_ECFG), device="cuda")
    res_flat, wall_flat, _, _ = sp_serve(flat, reqs, warm, stats=False)
    del flat
    gc.collect()
    torch.cuda.empty_cache()
    _sp_note("(a) flat")
    ref = {n: r["tokens"] for n, r in res_flat.items()}
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, SeededShards(cfg, SEED, "bfloat16", sharpen=True),
                         EngineConfig(**SP_ECFG), parallel=ParallelConfig(sp=sp),
                         devices=["cuda:0"] * sp)
    build_s = time.perf_counter() - t0
    res, wall, (r0, r1, r2), (tier, tier_bad) = sp_serve(
        engine, reqs, warm, extra=lambda e: sp_tier(e, cfg, model))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    _sp_note(f"(a) sp {sp}")
    logits, logits_bad = sp_logit_check(model, cfg, sp)
    _sp_note(f"(a) logits on sp {sp}")
    problems, flips = tp_check(lambda: model, cfg, reqs, ref, res, SP_GREEDY, 32)
    problems += tier_bad + logits_bad
    L = cfg.num_hidden_layers
    long_ranks = sp_rank_report(r0, r1, L)
    rest_ranks = sp_rank_report(r1, r2, L)
    emit({"phase": "sequence_parallel", "case": "a", "model": cfg.name,
          "layers": L, "depth": layers_note, "sp": sp, "tp": 1,
          "build_s": build_s, "greedy_equal": {n: res[n]["tokens"] == ref[n]
                                               for n in SP_GREEDY},
          "seeded_equal": res["T_seeded"]["tokens"] == ref["T_seeded"],
          "flips": flips, "tol_in_std": LOGIT_TOL,
          "ttft_8192_ms": res["L_8192"]["ttft_ms"],
          "flat_chunked_ttft_8192_ms": res_flat["L_8192"]["ttft_ms"],
          "flat_prefill_chunk": SP_FLAT_ECFG["max_prefill_tokens"],
          **tp_rows({n: r for n, r in res.items() if n != "L_8192"}),
          "flat_decode_tokens_per_s": tp_rows(
              {n: r for n, r in res_flat.items() if n != "L_8192"})[
                  "decode_tokens_per_s"],
          "wall_s": wall, "flat_wall_s": wall_flat,
          "ranks_8192": long_ranks, "ranks_rest": rest_ranks, "tier": tier,
          "logits": logits, "card": card_line()})
    launches = {r: {k: long_ranks[r]["launches"][k]
                    + rest_ranks[r]["launches"][k] for k in SP_REPORT_KERNELS}
                for r in long_ranks}
    return problems, launches


def sp_ring_check(slots, S=1024, prefixes=(0, 256)):
    """The ring as the engine runs it (`ring_attention_local`: its rounds,
    the prefix fold, the finish), `slots` slots simulated on the card
    (`SimRing` hands each round's block as the rotation would), at the
    8B's widths in bf16, against the plain prefill attention (the paged
    kernels' reference) in f32 of the same inputs over the whole chunk
    after the same cached prefix.  Returns (a report per prefix, problems): each row's error
    within the bf16 attention bar."""
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.parallel.ring_attention import (
        SimRing, ring_attention_local)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    H, n_kv, hd, page = RING_8B["H"], RING_8B["n_kv"], RING_8B["hd"], 16
    bf = torch.bfloat16

    def rnd(*shape, s):
        return (torch.randn(shape, generator=gen, device="cuda") * s).to(bf)

    out, problems = {}, []
    for pre in prefixes:
        q = rnd(1, S, H, hd, s=Q_STD)
        k, v = rnd(1, S, n_kv, hd, s=KV_STD), rnd(1, S, n_kv, hd, s=KV_STD)
        maxp = max(1, -(-pre // page))
        table, P = _table([maxp], maxp)
        table = table.cuda()
        kp, vp = _pool(gen, P, page, n_kv, hd, bf)
        plen = torch.full((1,), pre, dtype=torch.int32, device="cuda")
        chunk = torch.full((1,), S, dtype=torch.int32, device="cuda")
        ref = pa.prefill_attention_plain(q.float(), k.float(), v.float(),
                                         kp.float(), vp.float(), table, plen,
                                         chunk)
        Sl = S // slots
        cut = [slice(i * Sl, (i + 1) * Sl) for i in range(slots)]
        blocks = [torch.stack([k[:, c], v[:, c]]) for c in cut]
        got = torch.cat([ring_attention_local(
            q[:, c].contiguous(), k[:, c].contiguous(), v[:, c].contiguous(),
            SimRing(blocks, i), q_offset=plen,
            prefix=(kp, vp, table, plen) if pre else None)
            for i, c in enumerate(cut)], 1)
        torch.cuda.synchronize()
        out[pre] = err = _errors(got, ref, bf)
        if not err["max_rel_err"] <= err["rtol"]:
            problems.append(f"the ring over {slots} slots after a {pre}-token "
                            f"prefix disagrees with the plain prefill: {err}")
    return out, problems


def sp_hit_path(model, cfg, prefix, tail, steps, fed=None, group=None,
                page=16):
    """`prefix` prefilled at position 0, then `tail` after it (its prefix
    read from the pages it wrote), then `steps` decode steps fed their own
    greedy tokens (or `fed`): the flat model's `forward_prefill` (group
    None) or an sp rank's `forward_prefill_sp`.  Returns (f32 logits
    [2 + steps, V], greedy tokens)."""
    from dynamo_tpu_torch.models import KVCache
    from dynamo_tpu_torch.parallel.sp_prefill import forward_prefill_sp

    n = len(prefix) + len(tail) + steps
    maxp = -(-n // page)
    table = torch.arange(1, maxp + 1, dtype=torch.int32, device="cuda")[None]
    kv = KVCache.create(cfg, maxp + 1, page, torch.bfloat16, "cuda", tp=model.tp)

    def chunk(toks, start):
        p = torch.full((1,), start, dtype=torch.int32, device="cuda")
        c = torch.full((1,), len(toks), dtype=torch.int32, device="cuda")
        if group is None:
            t = torch.tensor([toks], device="cuda")
            return model.forward_prefill(kv, t, table, p, c)
        # padded to a multiple of sp, as the engine pads its pass
        t = torch.tensor([toks + [0] * (-len(toks) % group.sp)], device="cuda")
        return forward_prefill_sp(model, group, kv, t, table, p, c,
                                  prefix_pages=-(-start // page))

    logits = [chunk(prefix, 0), chunk(tail, len(prefix))]
    toks = [int(logits[-1].argmax(-1))]
    pos = len(prefix) + len(tail)
    for j in range(steps):
        tok = toks[-1] if fed is None else fed[j]
        logits.append(model.forward_decode(
            kv, torch.tensor([tok], device="cuda"),
            torch.tensor([pos + j], device="cuda"), table))
        toks.append(int(logits[-1].argmax(-1)))
    return torch.stack(logits)[:, 0], toks


def _sp_hit_rank(rank, init, q, cfg, sp, tp, seed, prefix, tail, fed, path):
    """A rank of an sp x tp group running `sp_hit_path` on its shard of
    `cfg` (drawn from `seed` and sharpened as the engines' shards are),
    fed `fed`; with `path`, every router choice forced to the flat run's
    record (a prefill call's rows cut to this slot's tokens)."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.parallel import ParallelConfig, SeededShards, make_mesh

    group = make_mesh(ParallelConfig(sp=sp, tp=tp), ["cuda:0"] * (sp * tp),
                      rank=rank, init_method=init)
    try:
        model = SeededShards(cfg, seed, "bfloat16", sharpen=True)(
            group.tp_rank, tp, group.device)
        model.attach_group(group)
        if path is not None:
            calls = iter(torch.load(path))

            def top_k(logits, k):
                idx = next(calls)
                if idx.shape[0] > 1:
                    n = idx.shape[0] // group.sp
                    idx = idx[group.sp_rank * n:(group.sp_rank + 1) * n]
                idx = idx.to(logits.device)
                return logits.gather(-1, idx), idx

            llama._top_k = top_k
        with torch.no_grad():
            logits, _ = sp_hit_path(model, cfg, prefix, tail, len(fed), fed,
                                    group)
        if rank == 0:  # by value: the rank may exit before it is read
            q.put(logits.float().cpu().numpy())
    finally:
        group.close()


def sp_forced_record(model, cfg, prefix, tail):
    """The flat model's `sp_hit_path` (SP_OSS_TOKENS greedy steps) with
    its router's choices saved to ``build/``: (flat logits, the tokens
    fed, the record's path, the router calls)."""
    from dynamo_tpu_torch.models import llama

    calls, orig = [], llama._top_k

    def record(logits, k):
        vals, idx = orig(logits, k)
        calls.append(idx.cpu())
        return vals, idx

    llama._top_k = record
    try:
        with torch.no_grad():
            ref, toks = sp_hit_path(model, cfg, prefix, tail, SP_OSS_TOKENS)
    finally:
        llama._top_k = orig
    path = os.path.join(ROOT, "build", "sp_routing.pt")
    torch.save(calls, path)
    return ref.cpu(), toks[:SP_OSS_TOKENS], path, len(calls)


def sp_group_logits(cfg, sp, tp, seed, prefix, tail, ref, fed, path=None):
    """`sp_hit_path` on an sp x tp group of processes sharing the card
    (forked from the groups' fork server, which has the port imported: a
    rank starts in about a second, not eight), fed the flat run's tokens
    (and with `path`, its router choices): the largest logit difference
    from the flat run's `ref` in the flat logits' std, at the tail's last
    position and each decode step."""
    from dynamo_tpu_torch.engine import lockstep
    from dynamo_tpu_torch.parallel.mesh import free_port

    ctx = lockstep._follower_context()  # noqa: SLF001
    q = ctx.Queue()
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_sp_hit_rank,
                         args=(r, init, q, cfg, sp, tp, seed, prefix, tail,
                               fed, path))
             for r in range(sp * tp)]
    for p in procs:
        p.start()
    try:
        got = torch.from_numpy(q.get(timeout=600))
    finally:
        for p in procs:
            p.join(120)
            if p.is_alive():
                p.terminate()
    err = ((got - ref.float()).abs().amax(-1) / ref.float().std(-1)).tolist()
    return {"prefix_tokens": len(prefix), "tail_tokens": len(tail),
            "decode_steps": len(fed), "sp": sp, "tp": tp,
            "logit_err_in_std": max(err), "logit_err_in_std_by_step": err}


def sp_gpt_oss():
    """(b) gpt-oss-20b's widths (64 q / 8 kv heads of 64, a 128-token
    window on alternate layers, sinks, 32 experts) at SHALLOW_LAYERS layers
    on an sp 2 x tp 2 group (four ranks sharing the card), the prefix
    cache on: a 2048-token prompt, then the prompt with a 512-token tail,
    which hits its cached prefix, so the ring starts at the prefix
    boundary.  The served tokens are reported beside the flat twin's; the
    check is the forced-routing one of phase 15 (c) (random routers put
    top-k near-ties everywhere): the flat path of the same prefix, hit and
    decode steps with its router's choices recorded, and the group's ranks
    with them forced, logits within LOGIT_TOL std.  Returns (problems,
    launches per rank)."""
    import gc

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models import GPT_OSS_20B
    from dynamo_tpu_torch.parallel import ParallelConfig, SeededShards

    model, cfg = tp_flat_twin(GPT_OSS_20B, SHALLOW_LAYERS, seed=SEED + 11)
    g = torch.Generator().manual_seed(SEED + 21)
    prefix = torch.randint(0, cfg.vocab_size, (SP_PREFIX,), generator=g).tolist()
    tail = torch.randint(0, cfg.vocab_size, (SP_TAIL,), generator=g).tolist()
    reqs = {"P_prefix": _req(prefix, max_tokens=SP_OSS_TOKENS),
            "H_hit": _req(prefix + tail, max_tokens=SP_OSS_TOKENS)}

    def serve(engine, stats):
        async def run():
            try:
                r0 = await engine.group_reports() if stats else None
                out = {}
                for n, r in reqs.items():  # in turn: the second hits
                    out[n] = await _collect(engine, r)
                r1 = await engine.group_reports() if stats else None
                return out, r0, r1, vars(engine.metrics())
            finally:
                await engine.shutdown()

        return asyncio.run(run())

    flat = TorchEngine(cfg, model, EngineConfig(**SP_OSS_ECFG), device="cuda")
    res_flat, _, _, m_flat = serve(flat, False)
    del flat
    record = sp_forced_record(model, cfg, prefix, tail)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    _sp_note("(b) flat twin")
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, SeededShards(cfg, SEED + 11, "bfloat16",
                                           sharpen=True),
                         EngineConfig(**SP_OSS_ECFG),
                         parallel=ParallelConfig(sp=2, tp=2),
                         devices=["cuda:0"] * 4)
    build_s = time.perf_counter() - t0
    res, r0, r1, m = serve(engine, True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    _sp_note("(b) sp 2 x tp 2")
    ref, fed, path, n_calls = record
    forced = dict(sp_group_logits(cfg, 2, 2, SEED + 11, prefix, tail, ref,
                                  fed, path), router_calls=n_calls)
    _sp_note("(b) forced routing")
    problems = [f"(b) {n} ended {r['finish_reason']} with {len(r['tokens'])} "
                f"tokens" for n, r in res.items()
                if r["finish_reason"] != "length"
                or len(r["tokens"]) != SP_OSS_TOKENS]
    hits = m["prefix_cached_tokens_total"]
    if hits < SP_PREFIX - SP_OSS_ECFG["page_size"]:
        problems.append(f"(b) the tail hit {hits} cached tokens")
    if forced["logit_err_in_std"] > LOGIT_TOL:
        problems.append(f"(b) with the flat run's routing the sp x tp logits "
                        f"lie {forced['logit_err_in_std']:.3f} std from the "
                        f"flat logits")
    ranks = sp_rank_report(r0, r1, cfg.num_hidden_layers)
    emit({"phase": "sequence_parallel", "case": "b", "model": cfg.name,
          "layers": cfg.num_hidden_layers, "sp": 2, "tp": 2,
          "build_s": build_s, "prefix_cached_tokens": hits,
          "flat_prefix_cached_tokens": m_flat["prefix_cached_tokens_total"],
          "tokens_equal_flat": {n: res[n]["tokens"] == res_flat[n]["tokens"]
                                for n in reqs},
          **tp_rows(res), "forced_routing": forced, "tol_in_std": LOGIT_TOL,
          "ranks": ranks, "card": card_line()})
    return problems, {r: v["launches"] for r, v in ranks.items()}


async def sp_park(engine, cfg):
    """On (c)'s partitioned group: three 2048-token interactive anchors
    spread over three partitions, a 1224-token batch victim on the
    fourth, parked for a 64-token arrival (the slots are full, and its
    partition has the most free pages) and resumed onto the same
    partition; its tokens against its uncontended run, and the pages the
    resume imported against the parked bytes, byte for byte."""
    from dynamo_tpu_torch.runtime import Context

    victim, inter, _ = tpkv_prompts(cfg)
    g = torch.Generator().manual_seed(SEED + 22)
    anchors = [_req(torch.randint(0, cfg.vocab_size, (2048,),
                                  generator=g).tolist(), max_tokens=400)
               for _ in range(engine.parts - 1)]
    engine.clear_kv_blocks()
    alone = await _collect(engine, victim)
    parked, kept, resumed = [], {}, []
    lot_park = engine.parking.park
    resume = engine.scheduler.resume_fn

    def spy_park(entry):
        ok = lot_park(entry)
        if ok:
            parked.append(entry.kv_rank)
            kept[entry.request_id] = entry
        return ok

    def spy_resume(seq):
        resume(seq)
        entry = kept.get(seq.request_id)
        if entry is not None:
            k, v = engine._export_dev(seq.pages[:entry.n_pages])  # noqa: SLF001
            resumed.append({
                "partition": seq.kv_rank, "pages": entry.n_pages,
                "differing_elements": int((_bits(k.cpu()) != _bits(entry.k)).sum()
                                          + (_bits(v.cpu()) != _bits(entry.v)).sum())})

    engine.parking.park = spy_park
    engine.scheduler.resume_fn = spy_resume
    ctxs = [Context(f"anchor{i}") for i in range(len(anchors))]
    tasks = []
    try:
        for a, ctx in zip(anchors, ctxs):
            first = asyncio.Event()
            tasks.append(asyncio.ensure_future(
                _collect_as(engine, a, None, first, ctx)))
            await first.wait()
        m0 = engine.metrics()
        got, _, order = await _storm(engine, victim, inter, 2)
        m1 = engine.metrics()
    finally:
        for ctx in ctxs:
            ctx.stop_generating()
        await asyncio.gather(*tasks)
        engine.parking.park = lot_park
        engine.scheduler.resume_fn = resume
    out = {"victim_tokens_equal_alone": got["tokens"] == alone["tokens"],
           "parked_on_partition": parked, "resumed": resumed,
           "finish_order": order,
           "preempted": m1.preempted_total - m0.preempted_total,
           "lot_after": [len(engine.parking), engine.parking.pages_held]}
    ok = (out["victim_tokens_equal_alone"] and len(parked) == 1
          and out["preempted"] == 1 and out["lot_after"] == [0, 0]
          and [r["partition"] for r in resumed] == parked
          and all(r["differing_elements"] == 0 for r in resumed))
    return out, [] if ok else [f"(c) park: {out}"]


def sp_partitioned(cut, ref, twin):
    """(c) dp 2 x sp 2, the pool partitioned over the four (replica, slot)
    pairs (160 pages each), the 8B at CUT_LAYERS layers: phase 4's five
    requests, each sent once the previous one streams, against the flat
    twin's tokens (phase 15 (a)'s) up to near-ties, each sequence's pages
    on its partition; then `sp_park`.  Returns (problems, launches per rank
    over the wave, over the park)."""
    import gc

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.parallel import ParallelConfig, SeededShards

    cfg = cut
    reqs, warm = mesh_requests(cfg)
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, SeededShards(cfg, SEED, "bfloat16", sharpen=True),
                         EngineConfig(**SP_PART_ECFG, kv_partition=True),
                         parallel=ParallelConfig(dp=2, sp=2),
                         devices=["cuda:0"] * 4)
    build_s = time.perf_counter() - t0

    async def run():
        try:
            await _collect(engine, warm)
            seqs = {}
            _finish_spy(engine, seqs)
            r0 = await engine.group_reports()
            tasks = []
            for n, r in reqs.items():
                first = asyncio.Event()
                tasks.append(asyncio.ensure_future(
                    _collect_as(engine, r, n, first)))
                await first.wait()
            outs = await asyncio.gather(*tasks)
            r1 = await engine.group_reports()
            park, bad = await sp_park(engine, cfg)
            r2 = await engine.group_reports()
            return dict(zip(reqs, outs)), seqs, park, bad, (r0, r1, r2), \
                vars(engine.metrics())
        finally:
            await engine.shutdown()

    res, seqs, park, problems, (r0, r1, r2), m = asyncio.run(run())
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    _sp_note("(c) dp 2 x sp 2 partitioned")
    bad, flips = tp_check(twin, cfg, reqs, ref, res, TP_GREEDY, 32)
    problems += bad
    parts = {}
    for n in reqs:
        pages, rank = seqs[n]
        parts[n] = rank
        if {p // SP_PART_ECFG["num_pages"] for p in pages} != {rank}:
            problems.append(f"(c) {n}'s pages leave partition {rank}")
    if len(set(parts.values())) < 2:
        problems.append(f"(c) the wave used one partition: {parts}")
    wave = sp_rank_report(r0, r1, cfg.num_hidden_layers)
    moves = sp_rank_report(r1, r2, cfg.num_hidden_layers)
    emit({"phase": "sequence_parallel", "case": "c", "model": cfg.name,
          "layers": cfg.num_hidden_layers, "dp": 2, "sp": 2, "tp": 1,
          "kv_partition": True, "build_s": build_s,
          "kv_total_pages": m["kv_total_pages"],
          "greedy_equal": {n: res[n]["tokens"] == ref[n] for n in TP_GREEDY},
          "flips": flips, "tol_in_std": LOGIT_TOL, **tp_rows(res),
          "partition_of": parts, "park": park, "ranks_wave": wave,
          "card": card_line()})
    return problems, {r: v["launches"] for r, v in wave.items()}, \
        {r: v["launches"] for r, v in moves.items()}


def phase_sequence_parallel(cfg, cut, ref):
    """Phase 20 (see the module docstring).  `cfg`: phase 4's 8B (drawn
    again here at full depth from the script's seed); `cut`, `ref`: phase
    15 (a)'s flat twin's config (CUT_LAYERS layers) and its greedy tokens
    of phase 4's requests.  Returns each group's launches per rank."""
    import gc

    from dynamo_tpu_torch.models import init_params

    ring, problems = sp_ring_check(2)
    emit({"phase": "sequence_parallel", "case": "ring", "slots": 2,
          "errors": ring, "card": card_line()})
    launches = {}
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        dtype=torch.bfloat16, device="cuda")
    sharpen(model)
    bad, launches["a"] = sp_llama8b(model, cfg)
    problems += bad
    del model
    gc.collect()
    torch.cuda.empty_cache()
    bad, launches["b"] = sp_gpt_oss()
    problems += bad
    twin_cache = []

    def twin():
        if not twin_cache:
            twin_cache.append(tp_flat_twin(cut, CUT_LAYERS)[0])
        return twin_cache[0]

    bad, launches["c_wave"], launches["c_park"] = sp_partitioned(cut, ref, twin)
    problems += bad
    del twin_cache[:]
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        fail(f"sequence parallel: {problems}")
    for case in ("a", "b", "c_wave"):
        tp_launch_gate(f"sequence parallel ({case})", launches[case],
                       ("ring_block", "decode_attention"))
    return launches


SP_PROBE_LAYERS = 4
# four slots: at two, a ring that hands slot i the block of (i + r) mod N
# is the right one ((i + r) = (i - r) mod 2)
SP_PROBE_SLOTS = 4


def sp_probe_main() -> int:
    """The mutation check's probe of the ring: `sp_ring_check` on
    SP_PROBE_SLOTS slots, then phase 20 (a) on the 8B's full width at
    SP_PROBE_LAYERS layers (the flat engine's rows against an sp
    SP_PROBE_SLOTS group's; the random 8B's sharpened embedding outweighs
    its attention in a served row's argmax, so its logits check through
    `forward_prefill_sp` is what sees the engine's ring); prints one JSON
    line with the problems it finds (none on the port as it is)."""
    from dynamo_tpu_torch.models import LLAMA_3_1_8B, init_params
    from dynamo_tpu_torch.ops import _build

    _build.build_all()
    ring, problems = sp_ring_check(SP_PROBE_SLOTS)
    cfg = LLAMA_3_1_8B.with_depth(SP_PROBE_LAYERS)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        dtype=torch.bfloat16, device="cuda")
    sharpen(model)
    bad, _ = sp_llama8b(model, cfg, f"{SP_PROBE_LAYERS} layers",
                        sp=SP_PROBE_SLOTS)
    print(json.dumps({"sp_probe": {"layers": SP_PROBE_LAYERS,
                                   "sp": SP_PROBE_SLOTS, "ring": ring,
                                   "problems": problems + bad}}), flush=True)
    return 0


def time_ms_host(fn, iters: int = 3) -> float:
    """Host-clock ms of fn() to a synchronize, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def main() -> int:
    import gc

    if sys.argv[1:2] == ["--stream-client"]:
        return stream_client_main(sys.argv[2:])
    if sys.argv[1:2] == ["--dp-probe"]:
        if not torch.cuda.is_available():
            fail("no CUDA device: the dp probe runs on a GPU")
        return dp_probe_main()
    if sys.argv[1:2] == ["--vl-probe"]:
        if not torch.cuda.is_available():
            fail("no CUDA device: the vision probe runs on a GPU")
        return vl_probe_main()
    if sys.argv[1:2] == ["--pp-probe"]:
        if not torch.cuda.is_available():
            fail("no CUDA device: the pipeline probe runs on a GPU")
        return pp_probe_main()
    if sys.argv[1:2] == ["--sp-probe"]:
        if not torch.cuda.is_available():
            fail("no CUDA device: the sequence-parallel probe runs on a GPU")
        return sp_probe_main()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    global _JSONL
    os.makedirs(OUT_DIR, exist_ok=True)
    _JSONL = open(os.path.join(OUT_DIR, "chip_smoke.jsonl"), "w")
    from dynamo_tpu_torch.models import LLAMA_3_1_8B, init_params
    from dynamo_tpu_torch.models.config import LLAMA_3_70B
    from dynamo_tpu_torch.ops import _build

    card = card_line()
    emit({"phase": "environment", "card": card, "packages": package_versions(),
          "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    # the tokenizer of phases 7, 10 and 14-19 is written beside the build
    # (a fresh one: a file left by another configuration would not do)
    if os.path.exists(TOKENIZER_PATH):
        os.remove(TOKENIZER_PATH)
    writer = threading.Thread(target=write_tokenizer, args=(LLAMA_3_1_8B,),
                              name="tokenizer-writer", daemon=True)
    writer.start()
    _TOKENIZER_WRITER.append(writer)
    _build.build_all()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for src, info in _build.build_info.items():
            f.write(f"== {src}\n{info['ptxas']}\n")
    PHASE_SECONDS["2 build"] = time.perf_counter() - t0
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {s: i["seconds"] for s, i in _build.build_info.items()},
          "ptxas_report": "chiprun_out/ptxas.txt"})

    checks = clocked("3 kernels", phase_kernels)
    clocked("3 sampling", phase_sampling)

    cfg = LLAMA_3_1_8B
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    sharpen(model)
    torch.cuda.synchronize()
    PHASE_SECONDS["4 model_init"] = time.perf_counter() - t0
    emit({"phase": "model_init", "model": cfg.name,
          "seconds": time.perf_counter() - t0,
          "weights_gb": torch.cuda.memory_allocated() / 1e9})
    serving_launches, direct = clocked("4 serving", phase_serving, model, cfg)
    clocked("5 paths", phase_paths, model, cfg)
    golden_launches = clocked("6 golden", phase_golden)
    # phases 7 and 14 on the first CUT_LAYERS layers (full width): phase
    # 14 (c) holds its ranks to phase 7's tokens of phase 4's prompts at
    # that depth
    http_launches, direct8 = clocked("7 http", phase_http,
                                     *depth_view(model, cfg), direct)
    loop_launches = clocked("8 device_loop", phase_device_loop,
                            *depth_view(model, cfg, LOOP_LAYERS))
    # phases 9, 10 and 12 on the first SHALLOW_LAYERS layers (full width)
    tier_launches = clocked("9 kv_tiers", phase_kv_tiers,
                            *depth_view(model, cfg, SHALLOW_LAYERS))
    router_launches = clocked("10 kv_router", phase_kv_router,
                              *depth_view(model, cfg, SHALLOW_LAYERS))
    disagg_launches = clocked("12 disagg", phase_disagg,
                              *depth_view(model, cfg, SHALLOW_LAYERS))
    phase14_launches = clocked("14 embed_dp_migration",
                               phase_embed_dp_migration,
                               *depth_view(model, cfg), direct8)
    # phase 15 (a): the 8B on a tp group of 2 and its planted faults
    # (its HTTP arm runs beside (b)'s, behind one frontend)
    tp_a, (cut8, ref8, flat8) = clocked("15a tp_llama8b", tp_llama8b, model,
                                        cfg, direct)
    # the collectives' ranks start while the faults run, then measure alone
    bench = tp_collective_ranks()
    clocked("15a tp_faults", tp_faults)
    clocked("15a tp_collective_costs", tp_collective_costs, bench)
    # phase 11 needs the card to itself: gpt-oss-20b's 42 GB of weights
    del model
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "breadth", "what": "card_freed",
          "allocated_gb": torch.cuda.memory_allocated() / 1e9})
    breadth_launches, int8_launches, _ = clocked(
        "11 breadth", phase_breadth, direct)
    procs = []
    try:
        vision_launches, vctx = clocked("13 vision", phase_vision, procs)
        # phase 18: phase 13's model, tower and rows under tp and dp groups
        vgroups = clocked("18 vision_groups", phase_vision_groups, vctx)
    finally:
        _stop_all(procs)
    del vctx
    gc.collect()
    torch.cuda.empty_cache()
    # phase 15 (b) and (c): Llama-3-70B's widths on 4 ranks (and over
    # HTTP), gpt-oss-20b on 2
    m70, cfg70, ref70, tp_b = clocked("15b tp_llama70b", tp_llama70b)
    # (b)'s flat model is redrawn only for a flip's margin (the same seed)
    del m70
    gc.collect()
    torch.cuda.empty_cache()
    procs = []
    try:
        # (a)'s and (b)'s HTTP workers build at once, after (b)'s groups
        # (beside them the card ran out of memory when (b) and (c) ran at
        # twice their depths), while (c) runs
        spawned = tp_http_spawn(procs, [(cfg.name, 2, CUT_LAYERS),
                                        (LLAMA_3_70B.name, 4, TP_70B_LAYERS)])
        tp_c = clocked("15c tp_gpt_oss", tp_gpt_oss)
        clocked("15ab tp_http", tp_http, [
            (lambda: tp_flat_twin(cfg, CUT_LAYERS)[0], cut8, 2, ref8["A_64"]),
            (lambda: tp_flat_twin(LLAMA_3_70B, TP_70B_LAYERS)[0], cfg70, 4,
             ref70["A_64"])], spawned)
    finally:
        _stop_all(procs)
    # phase 16: KV moves under tp (parking, tiers, disagg across tp)
    tpkv = clocked("16 tp_kv_moves", phase_tp_kv_moves)
    # phase 17: meshed dp (replicated and partitioned pools, KV moves)
    mesh = clocked("17 mesh_dp", phase_mesh_dp, cut8, ref8, flat8)
    emit({"phase": "children", "after": "17 mesh_dp", "alive": live_children()})
    # phase 19: pipeline parallelism; (a) on phase 4's flat model (drawn
    # again from its seed), (c) and (d) against phase 15 (a)'s flat twin
    pipe = clocked("19 pipeline", phase_pipeline, cfg, direct, cut8, ref8)
    emit({"phase": "children", "after": "19 pipeline", "alive": live_children()})
    # phase 20: sequence parallelism; (a) on phase 4's flat model (drawn
    # again from its seed), (c) against phase 15 (a)'s flat twin
    seqp = clocked("20 sequence_parallel", phase_sequence_parallel, cfg, cut8,
                   ref8)
    emit({"phase": "children", "after": "20 sequence_parallel",
          "alive": live_children()})
    by_path = {"serving (phase 4, generate)": serving_launches,
               "golden (phase 6)": golden_launches,
               "http (phase 7, the main path)": http_launches,
               **{f"device_loop {arm} (phase 8)": n
                  for arm, n in loop_launches.items()},
               "kv_tiers (phase 9)": tier_launches,
               **{f"kv_router, control plane {arm} (phase 10)": n
                  for arm, n in router_launches.items()},
               **{f"breadth gpt-oss-20b serving {arm} (phase 11, this slice's path)": n
                  for arm, n in breadth_launches.items()},
               "breadth int8 8B serving (phase 11)": int8_launches,
               **disagg_launches,
               **phase14_launches,
               "vision qwen2.5-vl-7b serving a_steps1 (phase 13, this slice's path)":
                   vision_launches,
               **{f"tp llama-3.1-8b tp 2 rank {r} (phase 15 a, this slice's path)": n
                  for r, n in tp_a.items()},
               **{f"tp llama-3-70b {TP_70B_LAYERS} layers tp 4 rank {r} (phase 15 b, "
                  f"this slice's path)": n
                  for r, n in tp_b.items()},
               **{f"tp gpt-oss-20b tp 2 rank {r} (phase 15 c, this slice's path)": n
                  for r, n in tp_c.items()},
               **{f"tp kv park + tiers llama-3.1-8b tp 2 rank {r} (phase 16 a, "
                  f"this slice's path)": n for r, n in tpkv["a"].items()},
               **{f"tp kv disagg {case} decode rank {r} (phase 16 b, this "
                  f"slice's path)": n
                  for case in TPKV_CASES for r, n in tpkv[case].items()},
               **{f"mesh {what} rank {r} (phase 17 {case}, this slice's path)": n
                  for case, what in (("a", "dp 2 x tp 1 replicated"),
                                     ("b", "dp 2 x tp 2 partitioned wave"),
                                     ("c", "dp 2 x tp 2 partitioned kv moves"))
                  for r, n in mesh[case].items()},
               **{f"vision groups qwen2.5-vl-7b {what} rank {r} (phase 18 "
                  f"{case}, this slice's path)": n
                  for case, what in (("a", "tp 2"),
                                     ("b", "dp 2 x tp 1 partitioned"))
                  for r, n in vgroups[case].items()},
               **{f"pipeline {what} rank {r} (phase 19 {case}, this slice's "
                  f"path)": n
                  for case, what in (
                      ("a", "llama-3.1-8b pp 2 x tp 1"),
                      ("b", f"llama-3-70b {PP_70B_LAYERS} layers pp 2 x tp 2"),
                      ("c_wave", "dp 2 x pp 2 partitioned wave"),
                      ("c_moves", "dp 2 x pp 2 partitioned kv moves"))
                  for r, n in pipe[case].items()},
               **{f"sequence parallel {what} rank {r} (phase 20 {case}, this "
                  f"slice's path)": n
                  for case, what in (
                      ("a", "llama-3.1-8b sp 2 x tp 1"),
                      ("b", f"gpt-oss-20b {SHALLOW_LAYERS} layers sp 2 x tp 2"),
                      ("c_wave", "dp 2 x sp 2 partitioned wave"),
                      ("c_park", "dp 2 x sp 2 partitioned park"))
                  for r, n in seqp[case].items()}}

    kernels = []
    for name, src_line in (("decode_attention", "dynamo_tpu/ops/pallas_attention.py:182"),
                           ("prefill_attention", "dynamo_tpu/ops/pallas_attention.py:407")):
        mine = [c for c in checks if c["kernel"] == name]
        timed = [c for c in mine if "ms" in c]
        serving = next(c for c in timed if "serving" in c["case"])
        keys = ("case", "ms", "host_paced_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by")
        entry = {
            "name": name, "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/paged_attention.cu",
            "replaces": src_line, "launches": http_launches[name],
            "launches_by_path": {p: c.get(name, 0) for p, c in by_path.items()},
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": serving["ms"], "plain_ms": serving["plain_ms"],
            "bound_ms": serving["bound_ms"], "bound_by": serving["bound_by"],
            "library_ms": serving["library_ms"], "timed_case": serving["case"],
            "timed_cases": [{k: c[k] for k in keys} for c in timed],
        }
        if name == "decode_attention":
            entry["merge_launches"] = http_launches["decode_merge"]
            entry["serving_grid_blocks"] = serving["grid_blocks"]
        else:  # the embeddings' call: prefix 0, a whole input in one chunk
            entry["embed_launches"] = phase14_launches[
                "embeddings direct (phase 14 a, this slice's path)"][name]
        kernels.append(entry)
    # the MoE kernels: their path is phase 11's gpt-oss serving; the
    # default engine (one-step blocks) is the main path's
    keys = ("case", "ms", "host_paced_ms", "plain_ms", "library_ms", "library",
            "bound_ms", "bound_by")
    for name, replaces, what in (
            ("moe_grouped_gemm", "dynamo_tpu/models/llama.py:374",
             "jax.lax.ragged_dot of the down product + b_down (:378) in "
             "_moe_ragged, and the router einsum of moe_router_logits (:305); "
             "XLA ops, not Pallas kernels"),
            ("moe_grouped_glu", "dynamo_tpu/models/llama.py:362",
             "the gate and up jax.lax.ragged_dot of _moe_ragged (:362, :366) + "
             "their biases (:370) + moe_act and the cast (:373); XLA ops, not "
             "Pallas kernels")):
        mine = [c for c in checks if c["kernel"] == name]
        timed = [c for c in mine if "ms" in c]
        step = next(c for c in timed if "decode" in c["case"])
        entry = {
            "name": name, "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/grouped_gemm.cu",
            "replaces": replaces, "replaces_what": what,
            "launches": breadth_launches["a_steps1"][name],
            "launches_by_path": {p: c.get(name, 0) for p, c in by_path.items()},
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": step["ms"], "plain_ms": step["plain_ms"],
            "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
            "library_ms": step["library_ms"], "timed_case": step["case"],
            "timed_cases": [{k: c[k] for k in keys} for c in timed],
        }
        if name == "moe_grouped_gemm":  # the router's calls end in a sum pass
            entry["split_reduce_launches"] = breadth_launches["a_steps1"]["moe_split_reduce"]
        kernels.append(entry)
    # the KV re-page: its path is phase 12 (b), the decode worker process
    # adopting remote prefills over the ipc lane
    mine = [c for c in checks if c["kernel"] == "kv_repage"]
    timed = [c for c in mine if "ms" in c]
    keys = ("case", "ms", "host_paced_ms", "plain_ms", "library_ms", "library",
            "bound_ms", "bound_by")
    main_path = "disagg ipc, worker processes (phase 12 b, this slice's path)"
    kernels.append({
        "name": "kv_repage", "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/kv_transfer.cu",
        "replaces": "dynamo_tpu/disagg/device_transfer.py:77",
        "replaces_what": "the XLA re-page of the device lane (from_pool's "
                         "gather, mask, cast and reshape, :77-113) and the "
                         "import scatter (_build_import_fn, "
                         "dynamo_tpu/engine/engine.py:444); XLA ops, not a "
                         "Pallas kernel",
        "launches": by_path[main_path]["kv_repage"],
        "launches_by_path": {p: c.get("kv_repage", 0) for p, c in by_path.items()},
        "max_abs_err": max(c["max_abs_err"] for c in mine),
        "ms": timed[0]["ms"], "plain_ms": timed[0]["plain_ms"],
        "bound_ms": timed[0]["bound_ms"], "bound_by": timed[0]["bound_by"],
        "library_ms": timed[0]["library_ms"], "timed_case": timed[0]["case"],
        "timed_cases": [{k: c[k] for k in keys} for c in timed],
    })
    # the segment attention: its path is phase 13 (c)'s one-step engine
    # serving Qwen2.5-VL-7B; the windowed layer (28 of the tower's 32) is
    # the timed case
    mine = [c for c in checks if c["kernel"] == "segment_attention"]
    timed = [c for c in mine if "ms" in c]
    head = next(c for c in timed if "windowed" in c["case"])
    keys = ("case", "ms", "host_paced_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "f32_bound_ms")
    kernels.append({
        "name": "segment_attention", "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/vision_attention.cu",
        "replaces": "dynamo_tpu/models/qwen_vl.py:304",
        "replaces_what": "the towers' masked attention, einsum + -1e9 mask + "
                         "softmax + einsum (qwen_vl.py:304-309, "
                         "vision.py:146-149); XLA ops, not a Pallas kernel",
        "launches": vision_launches["segment_attention"],
        "launches_by_path": {p: c.get("segment_attention", 0)
                             for p, c in by_path.items()},
        "max_abs_err": max(c["max_abs_err"] for c in mine),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "f32_bound_ms": head["f32_bound_ms"],
        "library_ms": head["library_ms"], "timed_case": head["case"],
        "library": "scaled_dot_product_attention with the boolean block mask",
        "timed_cases": [{k: c[k] for k in keys} for c in timed],
    })
    # the ring prefill's block kernel and its finish: their path is phase
    # 20 (a), the 8B's 8192-token prompt on sp 2 (each slot Sq = Sk = 4096)
    mine = [c for c in checks if c["kernel"] == "ring_attention"]
    timed = [c for c in mine if "ms" in c]
    head = next(c for c in timed if "diagonal round, Sq = Sk = 4096" in c["case"])
    keys = ("case", "ms", "host_paced_ms", "plain_ms", "library_ms",
            "library", "bound_ms", "bound_by", "finish_ms", "finish_bound_ms")
    ring_path = "sequence parallel llama-3.1-8b sp 2 x tp 1 rank 0 (phase 20 a, this slice's path)"
    kernels.append({
        "name": "ring_attention", "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/ring_attention.cu",
        "replaces": "dynamo_tpu/parallel/ring_attention.py:37",
        "replaces_what": "ring_attention_local's _block_attn (:37-57) and the "
                         "scan's flash merge and normalisation (:106-138); XLA "
                         "ops, not a Pallas kernel",
        "launches": by_path[ring_path]["ring_block"],
        "finish_launches": by_path[ring_path]["ring_finish"],
        "launches_by_path": {p: c.get("ring_block", 0) for p, c in by_path.items()},
        "max_abs_err": max(c["max_abs_err"] for c in mine),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "timed_case": head["case"],
        "library": "torch.ops.aten._scaled_dot_product_flash_attention (out "
                   "and log-sum-exp), kv heads repeated; with a window or in "
                   "f32, _scaled_dot_product_efficient_attention with the "
                   "round's mask as a bias and compute_log_sumexp",
        "timed_cases": [{k: c[k] for k in keys} for c in timed],
    })
    emit(timing_line())
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# the helpers whose seconds the timing line breaks out of their phase
_CLOCKED = ("kv_transfers", "park_resume", "kv_tier_runs", "kv_router_arm",
            "disagg_colocated", "disagg_processes", "embed_serving",
            "dp_ranks_serving", "migration_processes", "spec_accepting",
            "breadth_model", "breadth_paths", "breadth_serving",
            "breadth_worker", "breadth_int8", "vl_serving", "vl_processes",
            "tp_serve", "forced_record", "tp_forced_routing", "pp_llama8b",
            "pp_llama70b", "pp_partitioned", "sp_llama8b", "sp_gpt_oss",
            "sp_group_logits", "sp_partitioned")
for _name in _CLOCKED:
    globals()[_name] = _clock_helper(_name, globals()[_name])

if __name__ == "__main__":
    sys.exit(main())
