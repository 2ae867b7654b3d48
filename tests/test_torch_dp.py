"""Meshed data parallelism of the port: `TorchEngine(parallel=
ParallelConfig(dp=2, tp=1|2))`, its pool replicated over the replicas or
partitioned (``kv_partition``), on CPU gloo groups of 2 or 4 processes,
against `JaxEngine(parallel=ParallelConfig(dp, tp))` on the virtual CPU
mesh and JAX's single-device engine, on the same seeded f32 weights and
the prompts of `tests/test_torch_tp_engine.py`:

- greedy tokens equal in every layout (the MoE model, on the partitioned
  dp 2 x tp 2 group, is in `tests/test_torch_dp_kv.py`);
- every sequence on the same global page ids as in JAX, and its pages'
  K/V (the positions it wrote) within rtol = atol = 1e-5 of JAX's pool;
- a replicated pool byte-equal across the replicas (the trash page
  aside), a partitioned pool holding each sequence on its own partition
  only;
- the layouts' row blocks and the replicas' slot writes.

Each layout's engine is built and run once, in a module-scoped fixture
shared by its cases (one live group a process)."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import llama as jl
from dynamo_tpu.parallel import ParallelConfig as JaxParallelConfig
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.parallel import ParallelConfig, TreeShards
from dynamo_tpu_torch.parallel.sharding import save_tree
from dynamo_tpu_torch.testing import host_threads
from dynamo_tpu_torch.worker.__main__ import (
    build_parser,
    check_role,
    engine_config_from_args,
    parallel_from_args,
)

ECFG = dict(page_size=8, num_pages=64, max_num_seqs=8, max_prefill_tokens=32,
            max_model_len=128)
# layout -> (dp, tp, kv_partition)
LAYOUTS = {"dp2_tp1": (2, 1, False), "dp2_tp1_part": (2, 1, True),
           "dp2_tp2": (2, 2, False), "dp2_tp2_part": (2, 2, True)}
TOL = 1e-5


def _prompts(cfg):
    out = [[(i * 13 + j) % cfg.vocab_size for j in range(5 + 3 * i)]
           for i in range(3)]
    # one long prompt exercises chunked prefill (> max_prefill_tokens)
    out.append([(j * 7) % cfg.vocab_size for j in range(70)])
    return out


def _req(p, max_tokens=8):
    return {"token_ids": p, "sampling_options": {"temperature": 0.0},
            "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}


async def _collect(engine, prompts, waves=False):
    """Greedy tokens of each prompt.  With `waves` the second half starts
    once every prompt of the first half has its first token, so the
    first half holds pages of partition 0 and the second half admits onto
    partition 1 (admission picks the partition with more free pages; one
    wave lands wholly on partition 0)."""
    first = prompts[:len(prompts) // 2] if waves else prompts
    started = [asyncio.Event() for _ in first]

    async def one(p, ev=None):
        toks, reason = [], None
        async for out in engine.generate(_req(p)):
            toks += out["token_ids"]
            reason = out["finish_reason"]
            if ev is not None:
                ev.set()
        return toks if reason != "error" else "error"

    tasks = [asyncio.ensure_future(one(p, ev)) for p, ev in zip(first, started)]
    if waves:
        await asyncio.gather(*[ev.wait() for ev in started])
        tasks += [asyncio.ensure_future(one(p))
                  for p in prompts[len(first):]]
    return await asyncio.gather(*tasks)


def _record_pages(scheduler, into):
    """{prompt: (its pages, positions written)} as each sequence ends."""
    real = scheduler._finish

    def spy(seq, reason):
        into[tuple(seq.prompt)] = (list(seq.pages), seq.num_computed)
        return real(seq, reason)

    scheduler._finish = spy


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX config, JAX params, the port's config, the groups' source) of
    the tiny model, drawn once."""
    cfg_j, cfg_t = jcfg.tiny_config(), tcfg.tiny_config()
    params = jl.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    path = str(tmp_path_factory.mktemp("dp") / "tree.npz")
    save_tree(path, jax.tree.map(np.asarray, params))
    return cfg_j, params, cfg_t, TreeShards(cfg_t, path)


@pytest.fixture(scope="module")
def jax_runs(weights):
    """layout (None: the single-device engine) -> JAX's tokens, pages
    and pool K/V of each prompt."""
    done = {}

    def get(layout):
        if layout not in done:
            cfg_j, params, cfg_t, _ = weights
            kw = {}
            over = {}
            if layout is not None:
                dp, tp, part = LAYOUTS[layout]
                kw = {"parallel": JaxParallelConfig(dp=dp, tp=tp),
                      "devices": jax.devices()[:dp * tp]}
                over = {"kv_partition": part}
            eng = JaxEngine(cfg_j, params, JaxEngineConfig(**ECFG, **over),
                            kv_dtype=jnp.float32, **kw)
            pages = {}
            _record_pages(eng.scheduler, pages)

            async def run():
                try:
                    return await _collect(eng, _prompts(cfg_t),
                                          waves=bool(over.get("kv_partition")))
                finally:
                    await eng.shutdown()

            tokens = asyncio.run(run())
            k, v = np.asarray(eng.kv.k), np.asarray(eng.kv.v)
            prompts = _prompts(cfg_t)
            done[layout] = {"tokens": tokens,
                            "pages": [pages[tuple(p)] for p in prompts],
                            "kv": [(k[:, pages[tuple(p)][0]],
                                    v[:, pages[tuple(p)][0]]) for p in prompts]}
        return done[layout]

    return get


def _join_heads(parts):
    """One replica's ranks' (k, v) head slices joined in rank order."""
    return (torch.cat([k for k, _ in parts], dim=3).numpy(),
            torch.cat([v for _, v in parts], dim=3).numpy())


@pytest.fixture(scope="module")
def port_runs(weights):
    """layout -> the port's tokens, pages, each sequence's pages read on
    every rank, and (replicated) every rank's whole pool."""
    done = {}

    def get(layout):
        if layout in done:
            return done[layout]
        _, _, cfg_t, source = weights
        dp, tp, part = LAYOUTS[layout]
        with host_threads(1):  # the followers take the leader's count
            engine = TorchEngine(cfg_t, source,
                                 EngineConfig(**ECFG, kv_partition=part),
                                 parallel=ParallelConfig(dp=dp, tp=tp),
                                 devices=["cpu"] * (dp * tp))
        pages = {}
        _record_pages(engine.scheduler, pages)
        prompts = _prompts(cfg_t)

        async def run():
            try:
                tokens = await _collect(engine, prompts, waves=part)
                reads = [await engine._device_op(
                    lambda p=p: engine.rank_pages(pages[tuple(p)][0]))
                    for p in prompts]
                whole = None
                if not part:
                    whole = await engine._device_op(lambda: engine.rank_pages(
                        range(1, ECFG["num_pages"])))
                return tokens, reads, whole, engine.metrics()
            finally:
                await engine.shutdown()

        with host_threads(1):
            tokens, reads, whole, m = asyncio.run(run())
        done[layout] = {"tokens": tokens,
                        "pages": [pages[tuple(p)] for p in prompts],
                        "reads": reads, "whole": whole, "metrics": m}
        return done[layout]

    return get


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dp_tokens_match_jax(layout, jax_runs, port_runs):
    got = port_runs(layout)
    assert got["tokens"] == jax_runs(layout)["tokens"]
    assert got["tokens"] == jax_runs(None)["tokens"]
    m = got["metrics"]
    assert (m.dp, m.tp, m.kv_partition) == LAYOUTS[layout]
    ranks = 2 if LAYOUTS[layout][2] else 1
    assert m.kv_total_pages == ranks * (ECFG["num_pages"] - 1)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dp_pages_match_jax(layout, jax_runs, port_runs):
    """The same global page ids a sequence, and the same positions."""
    got, want = port_runs(layout), jax_runs(layout)
    assert got["pages"] == want["pages"]
    if LAYOUTS[layout][2]:
        # the partitioned pool spread the prompts over both partitions
        ranks = {p[0] // ECFG["num_pages"] for p, _ in got["pages"]}
        assert ranks == {0, 1}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dp_kv_matches_jax(layout, jax_runs, port_runs):
    """Each sequence's written positions, read on its replica's ranks
    (every replica for a replicated pool) and joined over their heads,
    are within 1e-5 of JAX's pool."""
    got, want = port_runs(layout), jax_runs(layout)
    dp, tp, part = LAYOUTS[layout]
    ps = ECFG["page_size"]
    for (pages, n), reads, (jk, jv) in zip(got["pages"], got["reads"],
                                           want["kv"]):
        replicas = [pages[0] // ECFG["num_pages"]] if part else range(dp)
        for d in replicas:
            k, v = _join_heads(reads[d * tp:(d + 1) * tp])
            for mine, ref in ((k, jk), (v, jv)):
                flat = mine.reshape(mine.shape[0], -1, *mine.shape[3:])[:, :n]
                rflat = ref.reshape(ref.shape[0], -1, *ref.shape[3:])[:, :n]
                np.testing.assert_allclose(flat, rflat, rtol=TOL, atol=TOL)
        assert len(pages) >= -(-n // ps)


@pytest.mark.parametrize("layout", ["dp2_tp1", "dp2_tp2"])
def test_replicated_pools_byte_equal(layout, port_runs):
    """Every replica's pool, rank by rank, equals replica 0's byte for
    byte on every page but the trash page."""
    got = port_runs(layout)
    dp, tp, _ = LAYOUTS[layout]
    whole = got["whole"]
    for d in range(1, dp):
        for t in range(tp):
            for a, b in zip(whole[t], whole[d * tp + t]):
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert any(bool(k.abs().sum()) for k, _ in whole)  # pages were written


def test_partitioned_pool_holds_each_sequence_on_its_partition(port_runs):
    """On a partitioned pool a sequence's pages are written on its
    partition's replica only: the other replica holds nothing at those
    local ids that matches them."""
    got = port_runs("dp2_tp1_part")
    for (pages, n), reads in zip(got["pages"], got["reads"]):
        owner = pages[0] // ECFG["num_pages"]
        assert {p // ECFG["num_pages"] for p in pages} == {owner}
        mine, other = reads[owner][0], reads[1 - owner][0]
        assert not torch.equal(mine, other)


# -- the row layouts ----------------------------------------------------------- #


class _Seq:
    def __init__(self, rank, name):
        self.kv_rank = rank
        self.name = name
        self.pages = []


def _layout_engine(dp, part, max_num_seqs=4, pp=1):
    """An engine object with just what the row layouts read."""
    eng = object.__new__(TorchEngine)
    eng.dp = dp
    eng.pp = pp
    eng.sp = 1
    eng._pooled = part
    eng.cfg = EngineConfig(page_size=8, num_pages=16, max_num_seqs=max_num_seqs,
                           max_model_len=64)
    return eng


@pytest.mark.parametrize("dp, part, pp, want", [
    (2, False, 1, ["a", "b", "c", None]),
    (3, False, 1, ["a", "b", "c", None, None, None]),
    (2, True, 1, ["b", None, None, None, "a", "c", None, None]),
    # a pipeline's blocks split into pp microbatches: 4 rows round to
    # dp x pp = 6, a partition's block of 4 to 6 at pp 3
    (3, False, 2, ["a", "b", "c", None, None, None]),
    (2, True, 3, ["b"] + [None] * 5 + ["a", "c"] + [None] * 4),
], ids=["replicated_dp2", "replicated_dp3", "partitioned_dp2",
        "replicated_dp3_pp2", "partitioned_dp2_pp3"])
def test_decode_rows_are_uniform_replica_blocks(dp, part, pp, want):
    eng = _layout_engine(dp, part, pp=pp)
    seqs = [_Seq(1, "a"), _Seq(0, "b"), _Seq(1, "c")]
    rows = eng._decode_rows(seqs)
    assert [s.name if s else None for s in rows] == want


def test_replica_writes_cover_each_block():
    """The slots a dispatch wrote, a replica's rows at a time: positions
    from each row's start, past the trash page and the context cap."""
    eng = _layout_engine(2, False)
    table = np.array([[3, 4], [0, 0], [5, 0], [6, 7]], np.int32)
    writes = eng._replica_writes(table, np.array([6, 0, 0, 15]), 3)
    (p0, s0), (p1, s1) = writes
    assert list(zip(p0, s0)) == [(3, 6), (3, 7), (4, 0)]
    # row 3's positions 16 and 17 fall past its table: not written there
    assert list(zip(p1, s1)) == [(5, 0), (5, 1), (5, 2), (7, 7)]


def test_join_packed_puts_each_section_of_the_blocks_side_by_side():
    """Two replicas' packed results (T steps, 2 rows each, with top
    logprobs) joined equal the packed result of all four rows."""
    from dynamo_tpu_torch.engine import blocks

    T, b, W = 3, 2, blocks.out_widths(True)
    rows = torch.arange(T * 2 * b * sum(W), dtype=torch.float32)
    whole = rows.reshape(T, 2 * b * sum(W))
    # block r holds rows r*b .. r*b+b-1 of every section
    parts, off = [[], []], 0
    for w in W:
        sec = whole[:, off * 2 * b:(off + w) * 2 * b]
        for r in range(2):
            parts[r].append(sec[:, r * b * w:(r + 1) * b * w])
        off += w
    parts = [torch.cat(p, dim=-1) for p in parts]
    assert torch.equal(blocks.join_packed(parts, W), whole)


def test_kv_pool_axes_match_jax_kv_cache_pspec():
    """The pool's layout over the mesh: kv heads over tp, pages over dp
    when partitioned (JAX `kv_cache_pspec(pool_axes=("dp",))`), else
    replicated over dp."""
    from dynamo_tpu.models.llama import kv_cache_pspec
    from dynamo_tpu_torch.parallel.sharding import kv_pool_axes

    for pooled, spec in ((True, kv_cache_pspec(pool_axes=("dp",)).k),
                         (False, kv_cache_pspec().k)):
        want = {i: (a[0] if isinstance(a, tuple) else a)
                for i, a in enumerate(tuple(spec)) if a is not None}
        got = {i: a for i, a in kv_pool_axes(pooled).items() if a is not None}
        assert got == want


def _worker_args(*flags):
    return build_parser().parse_args(["--control", "127.0.0.1:1", *flags])


def _vision_group():
    """A dp 2 group with a tiny CLIP tower builds, the tower on its leader
    alone (vision under dp is served: tests/test_torch_tp_vision.py)."""
    from dynamo_tpu_torch.models import vision as tv
    from dynamo_tpu_torch.parallel import SeededShards
    from dynamo_tpu_torch.testing import host_threads

    cfg = tcfg.tiny_config()
    vcfg = tv.tiny_vision_config(out_hidden_size=cfg.hidden_size)
    tower = tv.init_vision_params(vcfg, torch.Generator().manual_seed(1),
                                  device="cpu")

    async def reports(eng):
        try:
            return await eng.group_reports()
        finally:
            await eng.shutdown()

    with host_threads(1):
        eng = TorchEngine(cfg, SeededShards(cfg, 0, "float32"),
                          EngineConfig(**ECFG), parallel=ParallelConfig(dp=2),
                          devices=["cpu"] * 2, vision=(tower, vcfg))
        got = asyncio.run(reports(eng))
    assert [got[r]["tower_params"] > 0 for r in (0, 1)] == [True, False]


def _pp_group():
    """A dp 2 x pp 2 group builds, each replica's ranks on stages 0 and 1
    (pipelines are served: tests/test_torch_pp.py)."""
    from dynamo_tpu_torch.parallel import SeededShards

    cfg = tcfg.tiny_config()

    async def reports(eng):
        try:
            return await eng.group_reports()
        finally:
            await eng.shutdown()

    with host_threads(1):
        eng = TorchEngine(cfg, SeededShards(cfg, 0, "float32"),
                          EngineConfig(**ECFG), devices=["cpu"] * 4,
                          parallel=ParallelConfig(dp=2, pp=2))
        got = asyncio.run(reports(eng))
    assert [got[r]["stage"] for r in range(4)] == [0, 1, 0, 1]


@pytest.mark.parametrize("call, error, match", [
    # a partitioned pool needs replicas to partition over (JAX's message)
    (lambda: TorchEngine(tcfg.tiny_config(), None,
                         EngineConfig(**ECFG, kv_partition=True), device="cpu"),
     ValueError, r"kv_partition requires a serving mesh"),
    # served since the tower moved to the leader (no error: it builds)
    (_vision_group, None, None),
    (lambda: check_role(_worker_args("--dp", "2", "--dp-ranks", "2")),
     SystemExit, r"--dp > 1 with --dp-ranks .*ROADMAP 2.2b.4"),
    (lambda: parallel_from_args(_worker_args("--dp", "2", "--tp", "2",
                                             "--tp-devices", "cpu,cpu,cpu")),
     ValueError, "names 3 devices; a group of dp=2 x tp=2 has 4 ranks"),
    # served since pp was ported (no error: it builds)
    (_pp_group, None, None),
], ids=["kv_partition_without_dp", "vision_under_dp", "dp_ranks_with_dp",
        "devices_of_another_group", "dp_with_pp"])
def test_dp_refusals(call, error, match):
    """What a dp group still refuses, each before a follower is spawned;
    a case without an error is served now and must build."""
    if error is None:
        call()
        return
    with pytest.raises(error, match=match):
        call()


def test_worker_takes_dp_and_kv_partition():
    args = _worker_args("--dp", "2", "--tp", "2", "--kv-partition",
                        "--device", "cpu")
    check_role(args)
    pcfg, devs = parallel_from_args(args)
    assert (pcfg.dp, pcfg.tp, devs) == (2, 2, ["cpu"] * 4)
    assert engine_config_from_args(args).kv_partition
    pcfg, devs = parallel_from_args(_worker_args("--dp", "2", "--device", "cpu"))
    assert (pcfg.dp, pcfg.tp, devs) == (2, 1, ["cpu"] * 2)
