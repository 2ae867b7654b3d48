"""Sequence parallelism of the port: the ring (`parallel/ring_attention.py`
on the plain versions of `ops/ring_attention.py`) against JAX
`ring_attention_local` under `shard_map`, and `TorchEngine(parallel=
ParallelConfig(dp, sp, tp))` on CPU gloo groups of 2 and 4 processes
against `JaxEngine(parallel=ParallelConfig(dp, sp, tp))` on the virtual
CPU mesh, on the same seeded f32 weights (`tiny_config`):

- the ring, function by function, within 1e-5 of JAX's: causal and not,
  per-row offsets, a cached prefix read through the page table, windows,
  sinks, and a chunk padded to a multiple of sp (its valid rows equal the
  unpadded attention);
- `ring_shift` on an odd ring (sp 3) over gloo: no deadlock, every slot
  gets its predecessor's block;
- layouts sp2, sp4, sp2_tp2, dp2_sp2 and dp2_sp2_part (``kv_partition``):
  greedy, seeded and penalized tokens equal JAX's on the same layout and
  JAX's single-device engine's, top-logprobs ids equal and their values
  within 1e-4, the same page ids, each replica's pool within 1e-5 of
  JAX's, the replicas of a replicated pool byte-equal;
- prefix hits and sliding windows with sinks (JAX
  `tests/test_sp_extended.py`), the tiny MoE at sp 2 x tp 2 (JAX
  `test_engine_sp_tp_moe`), embeddings on an sp group;
- the rank layout against JAX's ``(dp, sp, tp)`` mesh, the worker's
  ``--sp`` and every refusal, matched to JAX's messages where JAX has
  one.

Each layout's engine is built and run once, in a module-scoped fixture
shared by its cases (one live group a process)."""

import asyncio
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import llama as jl
from dynamo_tpu.parallel import ParallelConfig as JaxParallelConfig
from dynamo_tpu.parallel._compat import shard_map
from dynamo_tpu.parallel.ring_attention import ring_attention_local as jax_ring
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.parallel import ParallelConfig, TreeShards
from dynamo_tpu_torch.parallel.ring_attention import SimRing, ring_attention_local
from dynamo_tpu_torch.parallel.sharding import save_tree
from dynamo_tpu_torch.testing import host_threads

RING_TOL = 1e-5
# whole prompts (no chunking under sp): the step budget holds a whole
# prompt; 4-step decode blocks chained 2 deep
ECFG = dict(page_size=8, num_pages=64, max_num_seqs=8, max_prefill_tokens=128,
            max_model_len=128, decode_steps=4, decode_chain=2)
# a partitioned pool decodes a step a dispatch (tests/test_torch_dp.py) and
# runs no prefix cache under sp (JAX's rule)
PART_ECFG = {**ECFG, "decode_steps": 1, "decode_chain": 1,
             "enable_prefix_caching": False}
# layout -> (dp, sp, tp, kv_partition)
LAYOUTS = {"sp2": (1, 2, 1, False), "sp4": (1, 4, 1, False),
           "sp2_tp2": (1, 2, 2, False), "dp2_sp2": (2, 2, 1, False),
           "dp2_sp2_part": (2, 2, 1, True)}
TOL = 1e-5
TOP_TOL = 1e-4
EMBED_ATOL = 1e-5  # `tests/test_torch_embed.py` F32_ATOL
EMBED_ROWS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], list(range(20, 60))]


# -- the ring, function by function ------------------------------------------ #


def _jax_ring_out(q, k, v, n, causal, q_offset=None, window=None, sink=None,
                  prefix_k=None, prefix_v=None, prefix_lens=None):
    """JAX `ring_attention_local` under `shard_map` over an sp mesh of n
    virtual CPU devices; [B, S, H, D] as numpy."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    seq = P(None, "sp", None, None)
    rep = P()
    args, specs = [q, k, v], [seq, seq, seq]
    extra = {"q_offset": q_offset, "sink": sink, "prefix_k": prefix_k,
             "prefix_v": prefix_v, "prefix_lens": prefix_lens}
    names = [nm for nm, a in extra.items() if a is not None]
    args += [extra[nm] for nm in names]
    specs += [rep] * len(names)

    def body(q, k, v, *rest):
        kw = dict(zip(names, rest))
        return jax_ring(q, k, v, axis_name="sp", causal=causal,
                        window=window, **kw)

    fn = shard_map(body, mesh=mesh, in_specs=tuple(specs), out_specs=seq)
    return np.asarray(fn(*[jnp.asarray(a) for a in args]))


def _port_ring_out(q, k, v, n, causal, q_offset=None, window=None, sink=None,
                   prefix=None):
    """The port's ring over n simulated slots (`SimRing`): each slot's
    output joined along the sequence."""
    S = q.shape[1] // n
    cut = [slice(i * S, (i + 1) * S) for i in range(n)]
    blocks = [torch.stack([k[:, c], v[:, c]]) for c in cut]
    outs = [ring_attention_local(q[:, c], k[:, c], v[:, c], SimRing(blocks, i),
                                 causal=causal, q_offset=q_offset,
                                 window=window, sink=sink, prefix=prefix)
            for i, c in enumerate(cut)]
    return torch.cat(outs, 1).numpy()


RING_CASES = {
    "causal": dict(n=2, causal=True),
    "non_causal": dict(n=2, causal=False),
    "odd_ring": dict(n=3, causal=True),
    "offsets": dict(n=2, causal=True, offsets=True),
    "prefix": dict(n=2, causal=True, prefix=True),
    "window": dict(n=4, causal=True, window=5),
    "window_sinks_prefix": dict(n=2, causal=True, window=7, sink=True,
                                prefix=True),
}


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_matches_jax(case):
    kw = RING_CASES[case]
    n = kw["n"]
    rng = np.random.default_rng(7)
    B, S, H, n_kv, D, page = 2, 12, 4, 2, 16, 4
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, n_kv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, n_kv, D)).astype(np.float32)
    jkw, pkw = {}, {}
    if kw.get("offsets") or kw.get("prefix"):
        off = np.array([5, 11], np.int32)
        jkw["q_offset"] = off
        pkw["q_offset"] = torch.from_numpy(off)
    if kw.get("prefix"):
        W = 3  # pages of the longest prefix
        pool_k = rng.standard_normal((8, page, n_kv, D)).astype(np.float32)
        pool_v = rng.standard_normal((8, page, n_kv, D)).astype(np.float32)
        table = np.array([[3, 1, 0], [2, 5, 7]], np.int32)
        plens = jkw["q_offset"]
        jkw.update(prefix_k=pool_k[table].reshape(B, W * page, n_kv, D),
                   prefix_v=pool_v[table].reshape(B, W * page, n_kv, D),
                   prefix_lens=plens)
        pkw["prefix"] = (torch.from_numpy(pool_k), torch.from_numpy(pool_v),
                         torch.from_numpy(table), torch.from_numpy(plens))
    if kw.get("window"):
        jkw["window"] = pkw["window"] = kw["window"]
    if kw.get("sink"):
        sink = rng.standard_normal((H,)).astype(np.float32)
        jkw["sink"] = sink
        pkw["sink"] = torch.from_numpy(sink)
    want = _jax_ring_out(q, k, v, n, kw["causal"], **jkw)
    got = _port_ring_out(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), n, kw["causal"], **pkw)
    np.testing.assert_allclose(got, want, rtol=RING_TOL, atol=RING_TOL)


def test_ring_padded_chunk_matches_unpadded_attention():
    """A 7-token chunk padded to 8 on sp 2 (and to 9 on sp 3): its valid
    rows equal the plain prefill attention of the 7 tokens (the padding
    keys sit past every valid query, so causality keeps them out)."""
    from dynamo_tpu_torch.ops.paged_attention import prefill_attention

    rng = np.random.default_rng(3)
    L, H, n_kv, D = 7, 4, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((1, L, h, D))
                                .astype(np.float32)) for h in (H, n_kv, n_kv))
    zero_pool = torch.zeros((1, 4, n_kv, D))
    want = prefill_attention(q, k, v, zero_pool, zero_pool,
                             torch.zeros((1, 1), dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32),
                             torch.full((1,), L, dtype=torch.int32)).numpy()
    for n in (2, 3):
        S = -(-L // n) * n
        pad = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, S - L), value=9.0)
               for t in (q, k, v)]
        got = _port_ring_out(*pad, n, True)
        np.testing.assert_allclose(got[:, :L], want, rtol=RING_TOL,
                                   atol=RING_TOL)


def _shift_rank(rank, init, q):
    """A slot of an sp 3 ring: rotate a block tagged with this slot three
    times; report what arrived each time."""
    from dynamo_tpu_torch.parallel.collectives import ring_shift
    from dynamo_tpu_torch.parallel.mesh import TpGroup

    g = TpGroup(rank, 3, torch.device("cpu"), "gloo", init, sp=3)
    try:
        blk = torch.full((2, 5), float(rank))
        seen = []
        for _ in range(3):
            nxt = torch.empty_like(blk)
            ring_shift(g, blk, nxt)
            blk = nxt
            seen.append(int(blk[0, 0]))
        q.put((rank, seen, g.handoffs["sends"]))
    finally:
        g.close()


def test_ring_shift_odd_ring_no_deadlock():
    from dynamo_tpu_torch.parallel.mesh import free_port

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_shift_rank, args=(r, init, q))
             for r in range(3)]
    for p in procs:
        p.start()
    try:
        got = dict((r, (seen, sends)) for r, seen, sends in
                   (q.get(timeout=120) for _ in range(3)))
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.terminate()
    for r in range(3):
        # round j brings the block of slot (r - j - 1) mod 3
        assert got[r] == ([(r - 1) % 3, (r - 2) % 3, r], 3)


# -- the engine against JAX's sp engine ----------------------------------------- #


def _prompts(cfg):
    out = [[(i * 13 + j) % cfg.vocab_size for j in range(5 + 3 * i)]
           for i in range(3)]
    # a long prompt, one whole chunk, of odd length (padded under sp)
    out.append([(j * 7) % cfg.vocab_size for j in range(71)])
    return out


def _requests(cfg):
    """name -> request: the greedy prompts, a seeded, a penalized and a
    top-logprobs one."""
    ps = _prompts(cfg)
    side = [(5 * j) % 89 + 1 for j in range(14)]

    def r(p, **so):
        return {"token_ids": p, "sampling_options": {"temperature": 0.0, **so},
                "stop_conditions": {"max_tokens": 8, "ignore_eos": True}}

    out = {f"greedy{i}": r(p) for i, p in enumerate(ps)}
    out["seeded"] = r(side, temperature=0.8, seed=7)
    out["penalized"] = r(side[::-1], frequency_penalty=0.5)
    out["top"] = r([(3 * j) % 83 + 1 for j in range(11)], logprobs=True,
                   top_logprobs=3)
    return out


async def _collect(engine, reqs, waves=False):
    """{name: (tokens, tops)}; with `waves` the second half starts once
    every request of the first has its first token (both partitions of a
    partitioned pool hold sequences)."""
    names = list(reqs)
    first = names[:len(names) // 2] if waves else names
    started = {n: asyncio.Event() for n in first}

    async def one(n):
        toks, tops = [], []
        async for d in engine.generate(reqs[n]):
            assert d.get("finish_reason") != "error", d
            toks += d["token_ids"]
            tops += d.get("top_logprobs") or []
            if n in started:
                started[n].set()
        return toks, tops

    tasks = {n: asyncio.ensure_future(one(n)) for n in first}
    if waves:
        await asyncio.gather(*[e.wait() for e in started.values()])
        tasks.update({n: asyncio.ensure_future(one(n))
                      for n in names[len(first):]})
    return {n: await t for n, t in tasks.items()}


def _record_pages(scheduler, into):
    real = scheduler._finish

    def spy(seq, reason):
        into[tuple(seq.prompt)] = (list(seq.pages), seq.num_computed)
        return real(seq, reason)

    scheduler._finish = spy


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """{arm: (JAX config, JAX params, the port's config, the groups'
    source)}: the tiny model, its sliding-window-with-sinks twin, and the
    tiny MoE model."""
    out = {}
    arms = (("dense", lambda m: m.tiny_config()),
            ("swa_sinks", lambda m: m.tiny_config(
                sliding_window=16, attention_sinks=True,
                layer_types=["sliding_attention", "full_attention"],
                model_type="gpt_oss", name="tiny-oss")),
            ("moe", lambda m: m.tiny_moe_config()))
    for arm, make in arms:
        cfg_j, cfg_t = make(jcfg), make(tcfg)
        params = jl.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
        path = str(tmp_path_factory.mktemp(arm) / "tree.npz")
        save_tree(path, jax.tree.map(np.asarray, params))
        out[arm] = (cfg_j, params, cfg_t, TreeShards(cfg_t, path))
    return out


def _jax_engine(cfg_j, params, layout, ecfg=None):
    kw, part = {}, False
    if layout is not None:
        dp, sp, tp, part = LAYOUTS[layout]
        kw = {"parallel": JaxParallelConfig(dp=dp, sp=sp, tp=tp),
              "devices": jax.devices()[:dp * sp * tp]}
    ecfg = ecfg or (PART_ECFG if part else ECFG)
    return JaxEngine(cfg_j, params, JaxEngineConfig(**ecfg, kv_partition=part),
                     eos_token_ids=[], kv_dtype=jnp.float32, **kw)


@pytest.fixture(scope="module")
def jax_runs(weights):
    """layout (None: the single-device engine) -> JAX's results, pages,
    pool K/V of each greedy prompt, and embeddings."""
    done = {}

    def get(layout):
        if layout not in done:
            cfg_j, params, cfg_t, _ = weights["dense"]
            eng = _jax_engine(cfg_j, params, layout)
            pages = {}
            _record_pages(eng.scheduler, pages)
            part = layout is not None and LAYOUTS[layout][3]

            async def run():
                try:
                    res = await _collect(eng, _requests(cfg_t), waves=part)
                    emb = await eng.embed({"embed_token_ids": EMBED_ROWS})
                    return res, emb
                finally:
                    await eng.shutdown()

            res, emb = asyncio.run(run())
            k, v = np.asarray(eng.kv.k), np.asarray(eng.kv.v)
            prompts = _prompts(cfg_t)
            done[layout] = {
                "res": res, "embed": np.asarray(emb["embeddings"]),
                "pages": [pages[tuple(p)] for p in prompts],
                "kv": [(k[:, pages[tuple(p)][0]], v[:, pages[tuple(p)][0]])
                       for p in prompts]}
        return done[layout]

    return get


def _join_heads(parts, tp):
    """One partition's ranks' (k, v) slices joined over their heads."""
    return [torch.cat([parts[t][i] for t in range(tp)], dim=3).numpy()
            for i in (0, 1)]


@pytest.fixture(scope="module")
def port_runs(weights):
    """layout -> the port's results, pages, each greedy prompt's pages as
    every rank holds them, embeddings, metrics and the group's reports."""
    done = {}

    def get(layout):
        if layout in done:
            return done[layout]
        _, _, cfg_t, source = weights["dense"]
        dp, sp, tp, part = LAYOUTS[layout]
        with host_threads(1):  # the followers take the leader's count
            engine = TorchEngine(cfg_t, source, EngineConfig(
                                 **(PART_ECFG if part else ECFG),
                                 kv_partition=part),
                                 eos_token_ids=[],
                                 parallel=ParallelConfig(dp=dp, sp=sp, tp=tp),
                                 devices=["cpu"] * (dp * sp * tp))
        pages = {}
        _record_pages(engine.scheduler, pages)
        prompts = _prompts(cfg_t)

        async def run():
            try:
                res = await _collect(engine, _requests(cfg_t), waves=part)
                reads = [await engine._device_op(
                    lambda p=p: engine.rank_pages(pages[tuple(p)][0]))
                    for p in prompts]
                emb = await engine.embed({"embed_token_ids": EMBED_ROWS})
                reports = await engine.group_reports()
                return res, reads, emb, reports, engine.metrics()
            finally:
                await engine.shutdown()

        with host_threads(1):
            res, reads, emb, reports, m = asyncio.run(run())
        done[layout] = {"res": res, "reads": reads, "metrics": m,
                        "embed": np.asarray(emb["embeddings"]),
                        "reports": reports,
                        "pages": [pages[tuple(p)] for p in prompts]}
        return done[layout]

    return get


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sp_tokens_match_jax(layout, jax_runs, port_runs):
    """Greedy, seeded and penalized tokens equal JAX's on the same layout
    and JAX's single-device engine's."""
    got = {n: t for n, (t, _) in port_runs(layout)["res"].items()}
    for ref in (jax_runs(layout), jax_runs(None)):
        assert got == {n: t for n, (t, _) in ref["res"].items()}
    m = port_runs(layout)["metrics"]
    dp, sp, tp, part = LAYOUTS[layout]
    assert (m.dp, m.sp, m.tp, m.kv_partition) == (dp, sp, tp, part)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sp_top_logprobs_match_jax(layout, jax_runs, port_runs):
    got = port_runs(layout)["res"]["top"][1]
    want = jax_runs(layout)["res"]["top"][1]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w]
        for (_, lg), (_, lw) in zip(g, w):
            assert abs(lg - lw) < TOP_TOL


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sp_pages_match_jax(layout, jax_runs, port_runs):
    """The same global page ids a sequence, and the same positions."""
    got, want = port_runs(layout), jax_runs(layout)
    assert got["pages"] == want["pages"]
    if LAYOUTS[layout][3]:
        ranks = {p[0] // ECFG["num_pages"] for p, _ in got["pages"]}
        assert len(ranks) > 1


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sp_kv_matches_jax_and_replicas_agree(layout, jax_runs, port_runs):
    """Each greedy prompt's written positions, read on every rank: every
    (replica, slot) of a replicated pool holds JAX's pool within 1e-5 and
    the same bytes as the others; a partitioned pool's owner partition
    holds JAX's."""
    got, want = port_runs(layout), jax_runs(layout)
    dp, sp, tp, part = LAYOUTS[layout]
    for (pages, n), reads, (jk, jv) in zip(got["pages"], got["reads"],
                                           want["kv"]):
        parts = ([pages[0] // ECFG["num_pages"]] if part
                 else range(dp * sp))
        first = None
        for d in parts:
            k, v = _join_heads(reads[d * tp:(d + 1) * tp], tp)
            for mine, ref in ((k, jk), (v, jv)):
                flat = mine.reshape(mine.shape[0], -1, *mine.shape[3:])[:, :n]
                rflat = ref.reshape(ref.shape[0], -1, *ref.shape[3:])[:, :n]
                np.testing.assert_allclose(flat, rflat, rtol=TOL, atol=TOL)
            if first is None:
                first = (k, v)
            else:  # the replicas hold the same bytes
                assert all(np.array_equal(a.view(np.uint8), b.view(np.uint8))
                           for a, b in zip(first, (k, v)))


@pytest.mark.parametrize("layout", ["sp2", "sp2_tp2", "dp2_sp2"])
def test_sp_embed_matches_jax(layout, jax_runs, port_runs):
    np.testing.assert_allclose(port_runs(layout)["embed"],
                               jax_runs(layout)["embed"], atol=EMBED_ATOL,
                               rtol=0)


@pytest.mark.parametrize("layout", ["sp2", "sp4", "sp2_tp2", "dp2_sp2_part"])
def test_every_slot_rings_and_gathers(layout, port_runs):
    """Every rank reports its sequence slot, rotated K/V blocks around the
    ring and gathered the chunk for the pool write (the kernels' launch
    counts are the card's: the plain versions count nothing)."""
    dp, sp, tp, _ = LAYOUTS[layout]
    reports = port_runs(layout)["reports"]
    assert sorted(reports) == list(range(dp * sp * tp))
    for rank, rep in reports.items():
        assert rep["sp_rank"] == rank // tp % sp
        assert rep["handoffs"]["sends"] > 0
        assert rep["gathers"]["calls"] > 0


# -- prefix hits, windows with sinks, MoE (JAX tests/test_sp_extended.py) ---- #

EXT_ECFG = dict(page_size=8, num_pages=96, max_num_seqs=8,
                max_prefill_tokens=8 * 128, prefill_batch_size=2,
                max_model_len=128)
EXT_PROMPTS = [[(7 * j) % 101 + 1 for j in range(30)], [1, 2, 3, 4, 5],
               [(3 * j) % 97 + 1 for j in range(45)], [9, 8, 7, 6]]
SHARED = [(11 * j) % 89 + 1 for j in range(32)]
TAILS = [[5, 6, 7], [42] * 9]


def _greedy(tokens, n=6):
    return {"token_ids": tokens, "sampling_options": {"temperature": 0.0},
            "stop_conditions": {"max_tokens": n, "ignore_eos": True}}


async def _tokens(engine, req):
    out = []
    async for d in engine.generate(req):
        assert d.get("finish_reason") != "error", d
        out.extend(d["token_ids"])
    return out


async def _ext_run(engine, prefix_cache):
    """The extended tests' traffic: the four prompts at once, then (with
    the prefix cache) the shared prompt alone and its two extensions at
    once, with the cache hits they found."""
    try:
        out = {"plain": await asyncio.gather(*[_tokens(engine, _greedy(p))
                                               for p in EXT_PROMPTS])}
        if prefix_cache:
            await _tokens(engine, _greedy(SHARED))
            out["hits"] = await asyncio.gather(
                *[_tokens(engine, _greedy(SHARED + t)) for t in TAILS])
            if isinstance(engine, TorchEngine):
                out["cached"] = engine.metrics().prefix_cached_tokens_total
        return out
    finally:
        await engine.shutdown()


EXT_ARMS = {"prefix_cache": ("dense", 2, 1, True),
            "swa_sinks_prefix": ("swa_sinks", 2, 1, True),
            "moe_sp2_tp2": ("moe", 2, 2, False)}


@pytest.mark.parametrize("arm", sorted(EXT_ARMS))
def test_sp_extended_matches_jax(arm, weights):
    """Prefix hits (the ring starting at the prefix boundary), SWA with
    sinks and the tiny MoE at sp 2 x tp 2: the port's sp group against
    JAX's engine on the same layout and JAX's single-device engine."""
    model, sp, tp, cache = EXT_ARMS[arm]
    cfg_j, params, cfg_t, source = weights[model]
    ecfg = dict(EXT_ECFG, enable_prefix_caching=cache)
    outs = []
    for parallel in (None, JaxParallelConfig(sp=sp, tp=tp)):
        kw = {} if parallel is None else {
            "parallel": parallel, "devices": jax.devices()[:sp * tp]}
        eng = JaxEngine(cfg_j, params, JaxEngineConfig(**ecfg),
                        eos_token_ids=[], kv_dtype=jnp.float32, **kw)
        outs.append(asyncio.run(_ext_run(eng, cache)))
    with host_threads(1):
        port = TorchEngine(cfg_t, source, EngineConfig(**ecfg), eos_token_ids=[],
                           parallel=ParallelConfig(sp=sp, tp=tp),
                           devices=["cpu"] * (sp * tp))
        got = asyncio.run(_ext_run(port, cache))
    for want in outs:
        assert got["plain"] == want["plain"]
        if cache:
            assert got["hits"] == want["hits"]
    if cache:
        assert got["cached"] > 0


# -- the layout, the worker, the refusals --------------------------------------- #


def test_rank_layout_is_jax_mesh_dp_sp_tp():
    """Rank (d * sp + i) * tp + t sits where JAX's `make_mesh` puts device
    r: ``np.array(devices).reshape(dp, sp, tp)``; the pool's partition of
    (d, i) is d * sp + i."""
    from dynamo_tpu.parallel import make_mesh as jax_make_mesh
    from dynamo_tpu_torch.parallel.mesh import TpGroup

    pcfg = JaxParallelConfig(dp=2, sp=2, tp=2)
    mesh = jax_make_mesh(pcfg, jax.devices()[:8])
    ids = np.vectorize(lambda dev: dev.id)(mesh.devices)
    names = list(mesh.axis_names)
    g = object.__new__(TpGroup)
    g.dp, g.pp, g.sp, g.tp = 2, 1, 2, 2
    for d in range(2):
        for i in range(2):
            for t in range(2):
                idx = {"dp": d, "sp": i, "tp": t}
                want = ids[tuple(idx.get(n, 0) for n in names)]
                assert g.rank_of(d, i, t) == want - jax.devices()[0].id
                assert g.part_rank(d * 2 + i, t) == g.rank_of(d, i, t)


def _worker_args(*flags):
    from dynamo_tpu_torch.worker.__main__ import build_parser

    return build_parser().parse_args(["--control", "127.0.0.1:1", *flags])


def test_worker_takes_sp():
    from dynamo_tpu_torch.worker.__main__ import check_role, parallel_from_args

    args = _worker_args("--sp", "2", "--tp", "2", "--dp", "2",
                        "--kv-partition", "--device", "cpu")
    check_role(args)
    pcfg, devs = parallel_from_args(args)
    assert (pcfg.dp, pcfg.sp, pcfg.tp, devs) == (2, 2, 2, ["cpu"] * 8)


def _port(cfg, ecfg=None, **pkw):
    return lambda: TorchEngine(cfg, None, EngineConfig(**(ecfg or ECFG)),
                               parallel=ParallelConfig(**pkw),
                               devices=["cpu"] * ParallelConfig(**pkw).world)


def _jax(cfg_j, ecfg=None, **pkw):
    def build():
        params = jl.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
        n = JaxParallelConfig(**pkw).world
        JaxEngine(cfg_j, params, JaxEngineConfig(**(ecfg or ECFG)),
                  kv_dtype=jnp.float32, parallel=JaxParallelConfig(**pkw),
                  devices=jax.devices()[:n])
    return build


_MOE3 = dict(num_experts=3, num_experts_per_tok=2)
# name -> (the port's engine, JAX's engine or None, the message both give)
REFUSALS = {
    "prefix_cache_with_partition": (
        _port(tcfg.tiny_config(), dict(ECFG, kv_partition=True), dp=2, sp=2),
        _jax(jcfg.tiny_config(), dict(ECFG, kv_partition=True), dp=2, sp=2),
        r"sp > 1 with kv_partition requires enable_prefix_caching=False"),
    "chunked_prefill": (
        _port(tcfg.tiny_config(), dict(ECFG, max_prefill_tokens=64), sp=2),
        _jax(jcfg.tiny_config(), dict(ECFG, max_prefill_tokens=64), sp=2),
        r"sp > 1 requires max_prefill_tokens >= max_model_len \* "
        r"prefill_batch_size"),
    "chunk_buckets": (
        _port(tcfg.tiny_config(), dict(ECFG, chunk_buckets=[8, 10, 128]), sp=4),
        _jax(jcfg.tiny_config(), dict(ECFG, chunk_buckets=[8, 10, 128]), sp=4),
        r"chunk buckets \[10\] not divisible by sp=4"),
    "moe_capacity": (
        _port(tcfg.tiny_moe_config(moe_impl="capacity"), sp=2, tp=2),
        _jax(jcfg.tiny_moe_config(moe_impl="capacity"), sp=2, tp=2),
        r"sp×tp MoE requires moe_impl='ragged'"),
    "moe_uneven_experts": (
        _port(tcfg.tiny_moe_config(**_MOE3), sp=2, tp=2),
        _jax(jcfg.tiny_moe_config(**_MOE3), sp=2, tp=2),
        r"sp×tp MoE requires moe_impl='ragged'\|'a2a' and num_experts "
        r"divisible by tp"),
    "uneven_tp": (
        _port(tcfg.tiny_config(vocab_size=255), sp=2, tp=2),
        _jax(jcfg.tiny_config(vocab_size=255), sp=2, tp=2),
        r"tp=2 must evenly divide vocab_size for sp×tp prefill"),
    "moe_a2a": (
        _port(tcfg.tiny_moe_config(moe_impl="a2a"), sp=2, tp=2), None,
        r"moe_impl='a2a'.*ROADMAP 2.5"),
    "mrope": (
        _port(tcfg.tiny_config(mrope_section=(2, 3, 3)), sp=2), None,
        r"vision tower or M-RoPE.*ROADMAP 2.8"),
    "pp_with_sp": (
        lambda: ParallelConfig(pp=2, sp=2).validate(4),
        lambda: JaxParallelConfig(pp=2, sp=2).validate(4),
        r"pp composes with dp and tp"),
    "dp_ranks_with_sp": (
        lambda: __import__("dynamo_tpu_torch.worker.__main__", fromlist=["x"])
        .check_role(_worker_args("--sp", "2", "--dp-ranks", "2")), None,
        r"--sp > 1 with --dp-ranks .*ROADMAP 2.2b.4"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_sp_refusals(name):
    """What sp refuses, each before a follower is spawned, with JAX's
    message where JAX refuses it too."""
    port, jax_call, match = REFUSALS[name]
    error = SystemExit if name == "dp_ranks_with_sp" else ValueError
    with pytest.raises(error, match=match):
        port()
    if jax_call is not None:
        with pytest.raises((ValueError, NotImplementedError), match=match):
            jax_call()


def test_sp_turns_speculation_off():
    """No speculative verify under sp (JAX `engine.py:3497`)."""
    eng = object.__new__(TorchEngine)
    eng.sp, eng._pooled, eng._staged = 2, False, False
    eng.cfg = EngineConfig(page_size=8, num_pages=16, max_model_len=64,
                           max_prefill_tokens=64, speculative_ngram_k=2)
    assert not eng._spec_ok([])
