"""Data-parallel engine ranks in the port (`DpRankEngine`, `--dp-ranks`)
against the JAX package's, on the CPU:

- dispatch by ``dp_rank`` and round-robin, the structured error of a bad
  rank, for generate and embed;
- `metrics()` equal to the JAX `DpRankEngine`'s aggregation of the same
  per-rank snapshots (the rung union, the fall-out merge, the gauges);
  `clear_kv_blocks` as a sum and `cached_prefix_len` as a max;
- the KV-routed path end to end (the mirror of the JAX package's
  `tests/test_dp_ranks.py` e2e case): a 2-rank worker publishes per-rank
  KV events and metrics under packed keys, a repeat goes to the rank that
  cached it, a cold prompt to the other; the card's capacity is scaled by
  the ranks;
- the worker CLI: ranks that share one model, and the flags it refuses
  with the JAX worker's messages.
"""

import asyncio
import zlib

import numpy as np
import pytest
import torch

from dynamo_tpu.engine import ForwardPassMetrics as JaxMetrics
from dynamo_tpu.worker import DpRankEngine as JaxDpRankEngine
from dynamo_tpu_torch.engine import EngineConfig, ForwardPassMetrics, TorchEngine
from dynamo_tpu_torch.llm import ModelDeploymentCard
from dynamo_tpu_torch.models import init_params, tiny_config
from dynamo_tpu_torch.router import KvRouter
from dynamo_tpu_torch.router.worker_key import pack_worker, unpack_worker
from dynamo_tpu_torch.runtime import DistributedRuntime
from dynamo_tpu_torch.testing import tiny_tokenizer
from dynamo_tpu_torch.tokens import compute_block_hash_for_seq
from dynamo_tpu_torch.worker import DpRankEngine, serve_engine


def _ecfg(**over):
    base = dict(page_size=8, num_pages=64, max_num_seqs=4,
                max_prefill_tokens=64, max_model_len=128)
    base.update(over)
    return EngineConfig(**base)


@pytest.fixture(scope="module")
def tiny():
    tok = tiny_tokenizer()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    model = init_params(cfg, torch.Generator().manual_seed(1), torch.float32,
                        device="cpu")
    return tok, cfg, model


def _engines(tiny, n=2, **over):
    _, cfg, model = tiny
    return [TorchEngine(cfg, model, _ecfg(**over), eos_token_ids=[],
                        device="cpu") for _ in range(n)]


async def _gen(engine, prompt, dp_rank=None, max_tokens=4):
    req = {"token_ids": prompt, "sampling_options": {"temperature": 0.0},
           "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}
    if dp_rank is not None:
        req["dp_rank"] = dp_rank
    toks = []
    async for out in engine.generate(req):
        assert out.get("finish_reason") != "error", out
        toks += out["token_ids"]
    return toks


async def test_dispatch_bad_rank_clear_and_prefix(tiny):
    engines = _engines(tiny)
    dp = DpRankEngine(engines)
    assert dp.dp_ranks == 2
    p = list(range(1, 21))
    try:
        want = await _gen(engines[0], p)
        assert await _gen(dp, p, dp_rank=1) == want
        assert [e.metrics().num_requests_total for e in engines] == [1, 1]
        # rank-less requests round-robin across ranks
        await _gen(dp, [3, 4, 5])
        await _gen(dp, [3, 4, 5])
        assert [e.metrics().num_requests_total for e in engines] == [2, 2]
        for bad in (7, -1, "1"):
            out = [o async for o in dp.generate({
                "token_ids": p, "dp_rank": bad, "sampling_options": {},
                "stop_conditions": {"max_tokens": 2}})]
            assert out == [{"token_ids": [], "finish_reason": "error",
                            "error": f"dp_rank {bad!r} outside [0, 2)"}]
            assert await dp.embed({"embed_token_ids": [[1]], "dp_rank": bad}) == {
                "error": f"dp_rank {bad!r} outside [0, 2)"}
        # embed on a named rank runs there: its answer is that engine's
        req = {"embed_token_ids": [p, [9, 9]], "dp_rank": 1}
        assert await dp.embed(req) == await engines[1].embed(req)
        assert dp.metrics().num_requests_total == 4
        # the prompt is cached on both ranks (one page of 8 short of it)
        assert dp.cached_prefix_len(p + [1]) == max(
            e.cached_prefix_len(p + [1]) for e in engines) == 16
        total = dp.clear_kv_blocks()
        assert total > 0 and dp.clear_kv_blocks() == 0
        assert dp.cached_prefix_len(p + [1]) == 0
    finally:
        await dp.shutdown()


class _Snap:
    """A rank whose metrics() is a fixed snapshot."""

    def __init__(self, m):
        self.m = m

    def metrics(self):
        return self.m


def _snapshots(cls, seed):
    """Three ranks' snapshots; each value is drawn from (seed, rank, field
    name), so both packages' classes get the same value in a field they
    share."""
    out = []
    for r in range(3):
        kw = {}
        for name, f in cls.__dataclass_fields__.items():
            rng = np.random.default_rng([seed, r, zlib.crc32(name.encode())])
            if name == "decode_cc_fallout_total":
                kw[name] = {k: int(rng.integers(1, 9))
                            for k in ("admission", "preempted", f"r{r}")[:r + 1]}
            elif f.type in (float, "float"):
                kw[name] = float(rng.random())
            else:
                kw[name] = int(rng.integers(0, 100))
        m = cls(**kw)
        for rung in (1, 2, 4)[r:]:
            setattr(m, f"decode_rung{rung}_dispatches_total", 10 * r + rung)
        out.append(m)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_aggregate_as_jax(seed):
    port = DpRankEngine([_Snap(m) for m in _snapshots(ForwardPassMetrics, seed)])
    jaxd = JaxDpRankEngine([_Snap(m) for m in _snapshots(JaxMetrics, seed)])
    got, want = vars(port.metrics()), vars(jaxd.metrics())
    common = set(got) & set(want)
    assert {k for k in got if k.startswith("decode_rung")} == {
        "decode_rung1_dispatches_total", "decode_rung2_dispatches_total",
        "decode_rung4_dispatches_total"}
    assert set(got) - set(want) <= set(ForwardPassMetrics.__dataclass_fields__)
    assert {k: got[k] for k in common} == {k: want[k] for k in common}
    assert got["decode_cc_fallout_total"] == want["decode_cc_fallout_total"]


async def test_dp_rank_routing_e2e(tiny):
    """A 2-rank worker publishes per-rank KV events and metrics; the KV
    router indexes them under packed keys; a repeat sticks to the rank
    that cached it and a cold prompt goes to the other rank; the frontend
    edge's `dp_rank` lands on that rank."""
    tok, cfg, _ = tiny
    engines = _engines(tiny, enable_prefix_caching=True)
    dp = DpRankEngine(engines)
    rt_w = await DistributedRuntime.detached()
    mdc = ModelDeploymentCard(name="dp-model", tokenizer_json=tok.to_json_str())
    served = await serve_engine(rt_w, dp, mdc)
    assert isinstance(served.kv_publisher, list) and len(served.kv_publisher) == 2
    assert [p.worker_id for p in served.metrics_publisher] == [
        pack_worker(served.instance.instance_id, r) for r in (0, 1)]
    assert mdc.runtime_config.total_kv_blocks == 2 * engines[0].cfg.usable_pages
    assert mdc.runtime_config.max_num_seqs == 8
    assert "embedding" in mdc.types

    rt_f = await DistributedRuntime.connect(rt_w.control_address)
    ep = rt_f.namespace("dynamo").component("backend").endpoint("generate")
    client = await ep.client().start()
    await client.wait_for_instances()
    router = await KvRouter(rt_f, "dynamo", "backend", client, block_size=8).start()
    inst = served.instance.instance_id
    try:
        prompt_a = list(range(1, 33))  # 4 full blocks
        prompt_b = [(7 * j) % cfg.vocab_size for j in range(1, 33)]
        seq = [0]

        async def through_router(prompt, finish=True):
            seq[0] += 1
            req = {"token_ids": prompt, "request_id": f"r{seq[0]}",
                   "sampling_options": {"temperature": 0.0},
                   "stop_conditions": {"max_tokens": 2, "ignore_eos": True}}
            key = await router.choose(req)
            iid, rank = unpack_worker(key)
            assert iid == inst
            req["dp_rank"] = rank
            async for out in client.direct(req, iid):
                assert out.get("finish_reason") != "error", out
            if finish:
                router.mark_finished(req["request_id"])
            return rank

        rank_a = await through_router(prompt_a)
        assert engines[rank_a].metrics().num_requests_total == 1
        hashes = compute_block_hash_for_seq(prompt_a, 8)

        def settled():
            if router.index.find_matches(hashes).get(
                    pack_worker(inst, rank_a), 0) <= 0:
                return False
            states = router.worker_states
            return all(pack_worker(inst, r) in states
                       and states[pack_worker(inst, r)].kv_usage == 0.0
                       for r in (0, 1))

        for _ in range(200):
            if settled():
                break
            await asyncio.sleep(0.05)
        assert settled(), (router.worker_states, router.index.find_matches(hashes))
        before = engines[rank_a].metrics().prefix_cached_tokens_total
        rank_a2 = await through_router(prompt_a, finish=False)
        assert rank_a2 == rank_a
        assert engines[rank_a].metrics().prefix_cached_tokens_total > before
        rank_b = await through_router(prompt_b)
        assert rank_b != rank_a
        assert engines[rank_b].metrics().num_requests_total == 1
        router.mark_finished("r2")
    finally:
        await router.stop()
        await client.stop()
        await dp.shutdown()
        await rt_f.shutdown(graceful=False)
        await rt_w.shutdown(graceful=False)


def test_worker_cli_builds_ranks_on_one_model():
    from dynamo_tpu_torch.worker.__main__ import build_engine, build_parser, check_role

    args = build_parser().parse_args(["--control", "x:1", "--dp-ranks", "2",
                                      "--device", "cpu", "--num-pages", "32"])
    check_role(args)
    engine, mdc = build_engine(args)
    assert isinstance(engine, DpRankEngine) and engine.dp_ranks == 2
    a, b = engine.engines
    assert a.model is b.model and a.kv.k.data_ptr() != b.kv.k.data_ptr()
    assert a.cfg.num_pages == b.cfg.num_pages == 32


@pytest.mark.parametrize("argv,message", [
    (["--disagg-role", "decode"], "--dp-ranks > 1 is incompatible with --disagg-role"),
    (["--kvbm"], "--dp-ranks > 1 is incompatible with --kvbm"),
    (["--encode-component", "encoder"],
     "--dp-ranks > 1 is incompatible with --encode-component"),
])
def test_worker_refuses_dp_ranks_with(argv, message):
    from dynamo_tpu_torch.worker.__main__ import build_parser, check_role

    with pytest.raises(SystemExit) as e:
        check_role(build_parser().parse_args(
            ["--control", "x:1", "--dp-ranks", "2", *argv]))
    assert str(e.value) == message
    # one rank composes with each of them as before
    check_role(build_parser().parse_args(["--control", "x:1", "--device", "cpu",
                                          *argv]))


def test_jax_worker_refuses_with_the_same_messages():
    """The port's messages are the JAX worker's `check_args` ones."""
    from dynamo_tpu.worker.__main__ import build_parser as jax_parser
    from dynamo_tpu.worker.__main__ import check_args

    ap = jax_parser()
    for flag, extra in (("--disagg-role", ["--disagg-role", "decode"]),
                        ("--kvbm", ["--kvbm"])):
        args = ap.parse_args(["--control", "x:1", "--dp-ranks", "2", *extra])
        msgs = []
        ap.error = msgs.append
        check_args(ap, args)
        assert f"--dp-ranks > 1 is incompatible with {flag}" in msgs
