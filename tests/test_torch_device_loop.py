"""The engine's device loop of the port (dynamo_tpu_torch.engine: blocks.py,
graphs.py, TorchEngine) against the JAX package's JaxEngine, on the CPU.

On the CPU the block functions the CUDA graphs hold run eagerly over the
plain kernels, so these tests exercise the captured code.  Same tiny f32
weights (`init_params` moved through `params_from_jax`), same
EngineConfig, the prompts of tests/test_engine.py: every stream must be
token-identical to JaxEngine's, with greedy, seeded, penalized and
top-logprobs rows, for multi-step blocks, fixed chains, a block ladder,
mixed and fused prefill→decode dispatches, and the continuous loop with
stop tokens that latch mid-block and a prompt spliced mid-chain.  The one
documented exception is a seeded arrival spliced mid-chain
(tests/test_engine.py `test_chunked_prefill_splice_seeded_arrival`): its
chunk rows run [B, 1, D] matmuls where the split engine runs [B, T, D],
and a last-ulp difference can flip a temperature > 0 pick.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.engine import engine as jax_engine_mod
from dynamo_tpu.models import init_params as jax_init_params
from dynamo_tpu.models import tiny_config as jax_tiny_config
from dynamo_tpu.ops import sampling as js
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine import blocks
from dynamo_tpu_torch.models import params_from_jax, tiny_config
from dynamo_tpu_torch.ops import sampling as ts

ECFG = dict(page_size=8, num_pages=64, max_num_seqs=4, max_prefill_tokens=32,
            max_model_len=256)
CC = dict(decode_steps=4, decode_chain=2, decode_continuous=True)


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax_tiny_config(), jax.random.PRNGKey(0),
                           dtype=jnp.float32)


def torch_engine(jax_params, **over):
    cfg = tiny_config()
    model = params_from_jax(cfg, jax.tree.map(np.asarray, jax_params),
                            device="cpu")
    return TorchEngine(cfg, model, EngineConfig(**{**ECFG, **over}),
                       eos_token_ids=[], device="cpu")


def jax_engine(jax_params, **over):
    return JaxEngine(jax_tiny_config(), jax_params,
                     JaxEngineConfig(**{**ECFG, **over}), eos_token_ids=[],
                     kv_dtype=jnp.float32)


def req(tokens, max_tokens=8, temperature=0.0, **so):
    return {"token_ids": tokens,
            "sampling_options": {"temperature": temperature, **so},
            "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}


async def collect(engine, request):
    """(tokens, finish reason, top-logprob ids per token)."""
    out, reason, tops = [], None, []
    async for delta in engine.generate(request):
        out.extend(delta["token_ids"])
        reason = delta["finish_reason"]
        tops.extend([[i for i, _ in t] for t in delta.get("top_logprobs", [])])
    return out, reason, tops


def matrix_reqs():
    """Greedy, seeded, penalized + top-logprobs rows, and a greedy prompt
    long enough to take two prefill chunks."""
    rs = [req([1, 2, 3, 4, 5], max_tokens=13),
          req([9, 8, 7], max_tokens=13, temperature=0.9, seed=42),
          req([3] * 8, max_tokens=13, frequency_penalty=1.5, logprobs=True,
              top_logprobs=2),
          req([(5 * j) % 101 + 1 for j in range(40)], max_tokens=9)]
    return rs


async def both(jax_params, reqs, **over):
    """Run `reqs` concurrently through both engines; returns (port, JAX,
    port engine's dispatch trace, port metrics)."""
    eng = torch_engine(jax_params, **over)
    eng.dispatch_trace = trace = []
    got = await asyncio.gather(*[collect(eng, r) for r in reqs])
    await eng.shutdown()  # joins the step thread: deferred frees applied
    m = eng.metrics()
    released = eng.pool.free_pages + eng.pool.evictable_pages
    assert released == eng.pool.num_pages - 1
    jeng = jax_engine(jax_params, **over)
    want = await asyncio.gather(*[collect(jeng, r) for r in reqs])
    await jeng.shutdown()
    return list(got), list(want), trace, m


# -- sampling and packing against the JAX functions ------------------------- #


@pytest.mark.parametrize("greedy", [True, False])
def test_sample_tokens_maybe_greedy_bit_equal(greedy):
    rng = np.random.default_rng(3)
    B, V = 6, 300
    lg = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    temp = [0.0] * B if greedy else [0.0, 0.7, 1.0, 1.3, 0.9, 0.5]
    top_k = [0, 0, 5, 0, 0, 40]
    top_p = [1.0, 1.0, 1.0, 0.8, 0.5, 0.9]
    seeds = [0, 7, 2**31 - 1, 99, 123456, 3]
    ctr = [0, 1, 5, 37, 2, 9]
    want = js.sample_tokens_maybe_greedy(
        jnp.asarray(lg), js.SamplingParams.make(temp, top_k, top_p),
        jnp.asarray(seeds, jnp.uint32), jnp.asarray(ctr, jnp.int32), greedy)
    got = ts.sample_tokens_maybe_greedy(
        torch.from_numpy(lg), ts.SamplingParams.make(temp, top_k, top_p),
        torch.tensor(seeds), torch.tensor(ctr), greedy)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_top", [False, True])
def test_pack_layouts_equal_jax(with_top):
    """`pack_out` / `pack_out_cc` are `_pack_out` / `_pack_out_cc`: the
    same layout, the same token and id bits, logprobs within 1e-5."""
    rng = np.random.default_rng(5)
    B, V = 4, 64
    lg = rng.standard_normal((B, V)).astype(np.float32)
    out = rng.integers(0, V, B).astype(np.int32)
    act = np.array([1, 0, 1, 1], bool)
    logp = np.array(js.compute_logprobs(jnp.asarray(lg), jnp.asarray(out)))
    for jpack, junpack, tpack, tunpack, extra in (
            (jax_engine_mod._pack_out, jax_engine_mod._unpack_out,
             blocks.pack_out, blocks.unpack_out, ()),
            (jax_engine_mod._pack_out_cc, jax_engine_mod._unpack_out_cc,
             blocks.pack_out_cc, blocks.unpack_out_cc, (act,))):
        want = np.asarray(jpack(jnp.asarray(out), jnp.asarray(logp),
                                *[jnp.asarray(a) for a in extra],
                                jnp.asarray(lg) if with_top else None))
        got = tpack(torch.from_numpy(out).long(), torch.from_numpy(logp),
                    *[torch.from_numpy(a) for a in extra],
                    torch.from_numpy(lg) if with_top else None).numpy()
        assert got.shape == want.shape
        for g, w in zip(tunpack(got, B, with_top), junpack(want, B, with_top)):
            if w is None:
                assert g is None
            elif w.dtype.kind in "ib":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, atol=1e-5)


# -- engine token identity with JaxEngine ------------------------------------ #


@pytest.mark.parametrize("over", [
    dict(decode_steps=4),
    dict(decode_steps=4, decode_chain=2),
    dict(decode_steps=4, decode_block_ladder=[1, 2]),
], ids=["steps4", "steps4-chain2", "ladder"])
async def test_decode_blocks_match_jax_engine(jax_params, over):
    got, want, trace, m = await both(jax_params, matrix_reqs(), **over)
    assert got == want
    assert "decode" in {e["kind"] for e in trace}
    if "decode_block_ladder" in over:
        # the ladder ran more than one rung, each counted per dispatch
        rungs = {e["n_steps"] for e in trace if e["n_steps"]}
        assert len(rungs) > 1
        assert all(getattr(m, f"decode_rung{r}_dispatches_total") > 0
                   for r in rungs)


async def test_fused_prefill_decode_matches_unfused_and_jax(jax_params):
    """The fused chain (prefill tokens fed device-to-device into the decode
    graph's input) is output-invisible, and equal to JAX's fused engine."""
    rs = [req([(i * 17 + j) % 256 for j in range(5 + 6 * i)], max_tokens=7)
          for i in range(3)]
    over = dict(decode_steps=4, decode_chain=2)
    fused = []
    for r in rs:  # alone: every prefill is eligible for fusion
        eng = torch_engine(jax_params, **over)
        eng.dispatch_trace = trace = []
        fused.append(await collect(eng, r))
        assert trace[1]["kind"] == "fused"
        await eng.shutdown()
    unfused = torch_engine(jax_params, fuse_prefill_decode=False, **over)
    want = [await collect(unfused, r) for r in rs]
    await unfused.shutdown()
    jeng = jax_engine(jax_params, **over)
    jwant = [await collect(jeng, r) for r in rs]
    await jeng.shutdown()
    assert fused == want == jwant


async def test_mixed_dispatch_matches_jax_engine(jax_params):
    """A prompt arriving while decodes run is prefilled in a mixed
    dispatch (its chunk + a decode block of the shortest rung)."""
    eng = torch_engine(jax_params, decode_steps=4,
                       decode_block_ladder=[1, 4], max_prefill_tokens=16)
    eng.dispatch_trace = trace = []
    base = [asyncio.ensure_future(collect(eng, r)) for r in matrix_reqs()[:3]]
    while not any(e["kind"] == "decode" for e in trace):
        await asyncio.sleep(0.005)
    late = req([(7 * j) % 97 + 1 for j in range(40)], max_tokens=6)
    got = list(await asyncio.gather(*base, collect(eng, late)))
    await eng.shutdown()
    assert any(e["kind"] == "mixed" for e in trace), trace
    jeng = jax_engine(jax_params, decode_steps=4)
    want = [await collect(jeng, r) for r in matrix_reqs()[:3] + [late]]
    await jeng.shutdown()
    assert got == want


async def test_continuous_loop_matches_jax_engine(jax_params):
    got, want, trace, m = await both(jax_params, matrix_reqs(), **CC)
    assert got == want
    assert m.decode_cc_chains_total > 0
    assert m.decode_cc_blocks_total >= m.decode_cc_chains_total
    assert any(e.get("continuous") for e in trace)


async def test_continuous_stop_tokens_latch_mid_block(jax_params):
    """A stop id hit at step 3 of a 4-step block latches on the device:
    the stream ends there with "stop" in both engines; a multi-token stop
    sequence is found by the host and falls the chain out."""
    eng = torch_engine(jax_params, **CC)
    probe, _, _ = await collect(eng, req([5, 6, 7], max_tokens=20))
    stop_id = req([5, 6, 7], max_tokens=20)
    stop_id["stop_conditions"]["stop_token_ids"] = [probe[2]]
    stop_seq = req([5, 6, 7], max_tokens=20)
    stop_seq["stop_conditions"]["stop_sequences"] = [[probe[2], probe[3]]]
    rs = [stop_id, stop_seq,
          req([1, 2, 3, 4, 5], max_tokens=11, temperature=0.8, seed=5)]
    got = [await collect(eng, r) for r in rs]
    await eng.shutdown()  # joins the step thread: deferred frees applied
    released = eng.pool.free_pages + eng.pool.evictable_pages
    m = eng.metrics()
    assert got[0][:2] == (probe[:3], "stop")
    assert got[1][:2] == (probe[:4], "stop")
    assert released == eng.pool.num_pages - 1
    # (a chain still running when shutdown() joins it falls out "shutdown")
    assert set(m.decode_cc_fallout_total) <= {"stop", "pending_work", "admit",
                                              "shutdown"}
    jeng = jax_engine(jax_params, **CC)
    want = [await collect(jeng, r) for r in rs]
    await jeng.shutdown()
    assert got == want


async def _mid_chain(engine, base_reqs, arrival,
                     until=lambda e: e["kind"] == "decode"):
    """Start `base_reqs`, wait for a decode block in flight (`until`), then
    send `arrival`; every stream's result in submission order."""
    engine.dispatch_trace = trace = []
    base = [asyncio.ensure_future(collect(engine, r)) for r in base_reqs]
    while not any(until(e) for e in trace):
        await asyncio.sleep(0.005)
    late = await collect(engine, arrival)
    out = list(await asyncio.gather(*base))
    engine.dispatch_trace = None
    return out + [late], trace


def splice_reqs(seeded_arrival=False):
    """tests/test_engine.py `_splice_reqs`: greedy, seeded and
    penalized + top-logprobs rows, and a 24-token arrival whose chunk rows
    span several blocks and a page boundary."""
    rs = [req([1, 2, 3, 4, 5], max_tokens=24),
          req([9, 8, 7], max_tokens=24, temperature=0.9, seed=42),
          req([3] * 8, max_tokens=24, frequency_penalty=1.5, logprobs=True,
              top_logprobs=2)]
    if seeded_arrival:
        return rs, req([(5 * j) % 101 + 1 for j in range(11)], max_tokens=8,
                       temperature=0.7, seed=1234)
    return rs, req([(5 * j) % 101 + 1 for j in range(24)], max_tokens=8)


async def test_splice_admission_matches_jax_engine(jax_params):
    """A greedy prompt admitted mid-chain rides the running chain as chunk
    rows (no admission fall-out) and every stream equals JAX's."""
    base, arrival = splice_reqs()
    eng = torch_engine(jax_params, **CC)
    got, trace = await _mid_chain(eng, base, arrival)
    await eng.shutdown()  # joins the step thread: deferred frees applied
    m = eng.metrics()
    released = eng.pool.free_pages + eng.pool.evictable_pages
    assert max(e.get("chunk_rows", 0) for e in trace) > 0
    assert not {"admit", "admission"} & set(m.decode_cc_fallout_total)
    assert released == eng.pool.num_pages - 1
    jeng = jax_engine(jax_params, **CC)
    want, _ = await _mid_chain(jeng, base, arrival)
    await jeng.shutdown()
    assert got == want


async def test_splice_seeded_arrival(jax_params):
    """A seeded arrival spliced mid-chain: the co-resident rows equal
    JAX's, and the spliced stream is reproducible and has the split
    engine's shape (its picks may differ from the split engine's in the
    last ulp, the documented exception)."""
    base, arrival = splice_reqs(seeded_arrival=True)
    runs = []
    for _ in range(2):
        eng = torch_engine(jax_params, **CC)
        out, trace = await _mid_chain(eng, base, arrival)
        await eng.shutdown()
        assert max(e.get("chunk_rows", 0) for e in trace) > 0
        runs.append(out)
    assert runs[0] == runs[1]
    jeng = jax_engine(jax_params, **CC)
    want, _ = await _mid_chain(jeng, base, arrival)
    await jeng.shutdown()
    assert runs[0][:3] == want[:3]
    assert len(runs[0][3][0]) == len(want[3][0]) == 8
    assert runs[0][3][1] == want[3][1] == "length"


async def test_graph_keys_fixed_after_warmup(jax_params):
    """The runner's key set (one CUDA graph per key on the card) stops
    growing after two warm-up passes, across a rung sweep and mid-chain
    splices (tests/test_xla_ledger.py holds the JAX compiles the same
    way)."""
    eng = torch_engine(jax_params, decode_block_ladder=[1, 2, 4], **CC)
    base, arrival = splice_reqs()

    async def one_pass():
        # the loop runs at the ladder's top rung: send the arrival once a
        # continuous block is in flight
        out, trace = await _mid_chain(eng, base, arrival,
                                      until=lambda e: e.get("continuous"))
        assert max(e.get("chunk_rows", 0) for e in trace) > 0
        return out

    first = await one_pass()
    await one_pass()
    keys = list(eng.graph_keys)
    assert await one_pass() == first
    assert eng.graph_keys == keys
    assert len(eng.rung_histogram) > 1  # the ladder swept its rungs
    await eng.shutdown()


# -- entry points ------------------------------------------------------------ #


def test_worker_flags_match_jax_worker():
    """The worker's device-loop, overload and park flags build the JAX
    worker's EngineConfig fields, `--decode-chain continuous` included,
    and its KVBM flags parse to the JAX worker's values."""
    from dynamo_tpu.worker.__main__ import build_parser as jax_parser
    from dynamo_tpu.worker.__main__ import engine_config_from_args as jax_cfg
    from dynamo_tpu_torch.worker.__main__ import build_parser, engine_config_from_args

    fields = ("decode_steps", "decode_chain", "decode_continuous",
              "prefill_chunk_tokens", "decode_block_ladder",
              "speculative_ngram_k", "mixed_prefill_tokens",
              "default_priority", "overload_queue_depth",
              "overload_headroom_pages", "batch_deadline_s", "park_max_pages")
    kvbm = ("kvbm", "kvbm_leader", "kvbm_disk_root", "kvbm_host_bytes")
    for argv in (["--decode-steps", "8", "--decode-chain", "continuous",
                  "--prefill-chunk-tokens", "256"],
                 ["--decode-steps", "8", "--decode-chain", "3",
                  "--decode-block-ladder", "1,2,4", "--mixed-prefill-tokens", "64"],
                 ["--speculative-ngram-k", "4"],
                 ["--priority-class", "batch", "--overload-queue-depth", "8",
                  "--overload-headroom-pages", "16", "--batch-deadline-s", "2.5",
                  "--park-max-pages", "512"],
                 ["--kvbm", "--kvbm-leader", "2", "--kvbm-disk-root", "/tmp/g3",
                  "--kvbm-host-bytes", "4096"]):
        argv = ["--control", "127.0.0.1:1", *argv]
        ours, theirs = build_parser().parse_args(argv), jax_parser().parse_args(argv)
        got = engine_config_from_args(ours)
        want = jax_cfg(theirs)
        assert {f: getattr(got, f) for f in fields} == \
            {f: getattr(want, f) for f in fields}
        assert {f: getattr(ours, f) for f in kvbm} == \
            {f: getattr(theirs, f) for f in kvbm}


def test_worker_refuses_object_store_tier(monkeypatch):
    """`--kvbm-g4-bucket` names the object-store tier (G4), which the port
    now has: the worker no longer refuses the flag, and goes on to build
    its engine (which, with no CUDA device and no `--device cpu`,
    refuses)."""
    import torch

    from dynamo_tpu_torch.worker.__main__ import build_parser, main

    args = build_parser().parse_args(
        ["--control", "127.0.0.1:1", "--kvbm", "--kvbm-g4-bucket", "b"])
    assert args.kvbm_g4_bucket == "b"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--control", "127.0.0.1:1", "--kvbm", "--kvbm-g4-bucket", "b"])


def test_worker_metrics_match_jax_collector():
    """The worker's /metrics renders the engine's counters as the JAX
    package's EngineStatsCollector does: the fall-out reasons as one
    labelled counter, per-rung dispatches and spec counters as counters,
    the rest gauges."""
    from prometheus_client import CollectorRegistry, generate_latest
    from prometheus_client.parser import text_string_to_metric_families

    from dynamo_tpu.runtime.metrics import EngineStatsCollector
    from dynamo_tpu_torch.frontend.metrics import engine_stats_exposition

    stats = {"active_seqs": 2, "kv_usage": 0.25, "decode_cc_blocks_total": 7,
             "decode_cc_chains_total": 2,
             "decode_cc_fallout_total": {"stop": 3, "admit": 1, "preempted": 2,
                                         "offload": 5},
             "spec_draft_tokens_total": 12, "spec_acceptance_rate": 0.5,
             "decode_rung8_dispatches_total": 4,
             "preempted_total": 3, "resumed_total": 2, "parked_seqs": 1,
             "parked_pages": 77, "kvbm_host_blocks": 9,
             "kvbm_pending_offloads": 16, "kvbm_inflight_offloads": 32,
             "kvbm_offload_total": 140, "kvbm_onboard_total": 127,
             "kvbm_evict_total": 3, "kvbm_host_hits_total": 127,
             "kvbm_host_misses_total": 1, "kvbm_host_bytes": 1 << 28,
             "kvbm_host_capacity_bytes": 1 << 31, "kvbm_disk_blocks": 5,
             "kvbm_disk_hits_total": 4, "kvbm_disk_misses_total": 2,
             "kvbm_disk_bytes": 1 << 22}
    reg = CollectorRegistry()
    reg.register(EngineStatsCollector(lambda: stats, "dynamo", "backend"))

    def samples(text):
        return sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                      for f in text_string_to_metric_families(text)
                      for s in f.samples)

    got = samples(engine_stats_exposition(stats, "dynamo", "backend").decode())
    assert got == samples(generate_latest(reg).decode())
    assert ("dynamo_tpu_worker_decode_cc_fallout_total",
            (("dynamo_component", "backend"), ("dynamo_namespace", "dynamo"),
             ("reason", "stop")), 3.0) in got


async def test_worker_status_server_serves_engine_counters(jax_params):
    """`--status-port`: the worker's /metrics carries the continuous loop's
    counters after a chain ran."""
    import types
    import urllib.request

    from dynamo_tpu_torch.worker.__main__ import start_status_server

    eng = torch_engine(jax_params, **CC)
    await collect(eng, req([1, 2, 3], max_tokens=20))
    for _ in range(100):  # the chain records its fall-out after its last token
        if eng.metrics().decode_cc_fallout_total:
            break
        await asyncio.sleep(0.05)
    args = types.SimpleNamespace(status_port=0, namespace="dynamo",
                                 component="backend")
    status = await start_status_server(eng, args)

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{status.port}{path}") as r:
            return r.read().decode()

    try:
        text = await asyncio.get_running_loop().run_in_executor(None, get, "/metrics")
    finally:
        await status.stop()
        await eng.shutdown()
    assert "dynamo_tpu_worker_decode_cc_chains_total{" in text
    assert 'dynamo_tpu_worker_decode_cc_fallout_total{' in text
    assert 'reason="stop"' in text
