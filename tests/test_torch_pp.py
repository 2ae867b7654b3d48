"""Pipeline parallelism of the port: `TorchEngine(parallel=
ParallelConfig(pp, dp, tp))` on CPU gloo groups of 2 or 4 processes,
against `JaxEngine(parallel=ParallelConfig(pp, dp, tp))` on the virtual
CPU mesh (`dynamo_tpu/parallel/pp_engine.py`) and JAX's single-device
engine, layout for layout, on the same seeded f32 weights (`tiny_config`
at 4 layers, so pp 4 holds a layer a stage):

- greedy, seeded and frequency-penalized tokens equal (JAX
  `tests/test_pp_engine.py`), top-logprobs ids equal and their values
  within 1e-4;
- every sequence on the same global page ids as in JAX, and each
  stage's pool layers (its ranks' heads joined) within rtol = atol =
  1e-5 of the JAX pool's layers;
- embeddings within `tests/test_torch_embed.py`'s f32 tolerance of JAX's
  pp engine's;
- the tiny MoE model under pp 2 greedy-equal to JAX's pp engine;
- the rank layout against JAX's ``(dp, pp, tp)`` mesh, and each stage's
  parameters against JAX `shard_params_pp`'s device shards;
- the worker's ``--pp`` and what pp still refuses.

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
from dynamo_tpu_torch.parallel.sharding import save_tree, shard_params
from dynamo_tpu_torch.testing import host_threads

LAYERS = 4
# 4-step decode blocks chained 2 deep: each dispatch's ring runs 8 steps,
# the last stage handing every token but the last back to stage 0
ECFG = dict(page_size=8, num_pages=64, max_num_seqs=8, max_prefill_tokens=32,
            max_model_len=128, decode_steps=4, decode_chain=2)
# the partitioned layout decodes a step a dispatch, as `tests/
# test_torch_dp.py`: its first wave then still runs when the second
# admits, so every engine puts the same sequences on each partition
PART_ECFG = {**ECFG, "decode_steps": 1, "decode_chain": 1}
# layout -> (pp, dp, tp, kv_partition)
LAYOUTS = {"pp2": (2, 1, 1, False), "pp4": (4, 1, 1, False),
           "pp2_tp2": (2, 1, 2, False), "dp2_pp2": (2, 2, 1, False),
           "dp2_pp2_part": (2, 2, 1, True)}
TOL = 1e-5
TOP_TOL = 1e-4  # JAX `tests/test_pp_engine.py:120`
EMBED_ATOL = 1e-5  # `tests/test_torch_embed.py` F32_ATOL
EMBED_ROWS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], list(range(20, 60))]


def _prompts(cfg):
    out = [[(i * 13 + j) % cfg.vocab_size for j in range(5 + 3 * i)]
           for i in range(3)]
    # one long prompt exercises chunked prefill (> max_prefill_tokens)
    out.append([(j * 7) % cfg.vocab_size for j in range(70)])
    return out


def _requests(cfg):
    """name -> request: the greedy prompts, a seeded, a penalized and a
    top-logprobs one (JAX `tests/test_pp_engine.py`)."""
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
    """{name: (tokens, tops)}.  With `waves` the second half starts once
    every request of the first has its first token, so a partitioned
    pool holds both partitions (`tests/test_torch_dp.py`)."""
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
        tasks.update({n: asyncio.ensure_future(one(n)) for n in names[len(first):]})
    return {n: await t for n, t in tasks.items()}


def _record_pages(scheduler, into):
    """{prompt: (its pages, positions written)} as each sequence ends."""
    real = scheduler._finish

    def spy(seq, reason):
        into[tuple(seq.prompt)] = (list(seq.pages), seq.num_computed)
        return real(seq, reason)

    scheduler._finish = spy


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """{arm: (JAX config, JAX params, the port's config, the groups'
    source)} of the 4-layer tiny model and the tiny MoE model."""
    out = {}
    for arm, make in (("dense", lambda m: m.tiny_config(num_hidden_layers=LAYERS)),
                      ("moe", lambda m: m.tiny_moe_config())):
        cfg_j, cfg_t = make(jcfg), make(tcfg)
        params = jl.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
        path = str(tmp_path_factory.mktemp(arm) / "tree.npz")
        save_tree(path, jax.tree.map(np.asarray, params))
        out[arm] = (cfg_j, params, cfg_t, TreeShards(cfg_t, path))
    return out


def _jax_engine(cfg_j, params, layout, part=False):
    kw = {}
    if layout is not None:
        pp, dp, tp, part = LAYOUTS[layout]
        kw = {"parallel": JaxParallelConfig(dp=dp, pp=pp, tp=tp),
              "devices": jax.devices()[:dp * pp * tp]}
    return JaxEngine(cfg_j, params, JaxEngineConfig(
        **(PART_ECFG if part else ECFG), kv_partition=part),
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


def _join(parts, pp, tp):
    """One replica's ranks' (k, v) slices (rank order: stage-major, then
    tensor rank) joined: heads within a stage, then layers in stage
    order."""
    out = []
    for i in (0, 1):
        stages = [torch.cat([parts[s * tp + t][i] for t in range(tp)], dim=3)
                  for s in range(pp)]
        out.append(torch.cat(stages, dim=0).numpy())
    return out


@pytest.fixture(scope="module")
def port_runs(weights):
    """layout -> the port's results, pages, each greedy prompt's pages as
    every rank holds them, embeddings, metrics and the group's reports."""
    done = {}

    def get(layout):
        if layout in done:
            return done[layout]
        _, _, cfg_t, source = weights["dense"]
        pp, dp, tp, part = LAYOUTS[layout]
        with host_threads(1):  # the followers take the leader's count
            engine = TorchEngine(cfg_t, source, EngineConfig(
                                 **(PART_ECFG if part else ECFG),
                                 kv_partition=part),
                                 eos_token_ids=[],
                                 parallel=ParallelConfig(dp=dp, pp=pp, tp=tp),
                                 devices=["cpu"] * (dp * pp * tp))
        pages = {}
        _record_pages(engine.scheduler, pages)
        prompts = _prompts(cfg_t)

        async def run():
            try:
                res = await _collect(engine, _requests(cfg_t), waves=part)
                reads = [await engine._device_op(
                    lambda p=p: engine.rank_pages(pages[tuple(p)][0]))
                    for p in prompts]
                exports = [await engine.export_pages(pages[tuple(p)][0])
                           for p in prompts]
                emb = await engine.embed({"embed_token_ids": EMBED_ROWS})
                reports = await engine.group_reports()
                return res, reads, exports, emb, reports, engine.metrics()
            finally:
                await engine.shutdown()

        with host_threads(1):
            res, reads, exports, emb, reports, m = asyncio.run(run())
        done[layout] = {"res": res, "reads": reads, "metrics": m,
                        "exports": exports,
                        "embed": np.asarray(emb["embeddings"]),
                        "reports": reports,
                        "pages": [pages[tuple(p)] for p in prompts]}
        return done[layout]

    return get


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pp_tokens_match_jax(layout, jax_runs, port_runs):
    """Greedy, seeded and penalized tokens equal JAX's on the same layout
    and JAX's single-device engine's."""
    got = {n: t for n, (t, _) in port_runs(layout)["res"].items()}
    for ref in (jax_runs(layout), jax_runs(None)):
        assert got == {n: t for n, (t, _) in ref["res"].items()}
    m = port_runs(layout)["metrics"]
    pp, dp, tp, part = LAYOUTS[layout]
    assert (m.pp, m.dp, m.tp, m.kv_partition) == (pp, dp, tp, part)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pp_top_logprobs_match_jax(layout, jax_runs, port_runs):
    got = port_runs(layout)["res"]["top"][1]
    want = jax_runs(layout)["res"]["top"][1]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w]
        for (_, lg), (_, lw) in zip(g, w):
            assert abs(lg - lw) < TOP_TOL


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pp_pages_match_jax(layout, jax_runs, port_runs):
    """The same global page ids a sequence, and the same positions."""
    got, want = port_runs(layout), jax_runs(layout)
    assert got["pages"] == want["pages"]
    if LAYOUTS[layout][3]:
        ranks = {p[0] // ECFG["num_pages"] for p, _ in got["pages"]}
        assert ranks == {0, 1}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pp_kv_matches_jax(layout, jax_runs, port_runs):
    """Each greedy prompt's written positions, read on every rank of its
    replica (every replica of a replicated pool), each stage holding its
    own L/pp layers: joined over heads and stages they are within 1e-5
    of JAX's pool."""
    got, want = port_runs(layout), jax_runs(layout)
    pp, dp, tp, part = LAYOUTS[layout]
    per = pp * tp
    for (pages, n), reads, (jk, jv) in zip(got["pages"], got["reads"],
                                           want["kv"]):
        assert reads[0][0].shape[0] == LAYERS // pp  # a stage's layers
        replicas = [pages[0] // ECFG["num_pages"]] if part else range(dp)
        for d in replicas:
            k, v = _join(reads[d * per:(d + 1) * per], pp, tp)
            for mine, ref in ((k, jk), (v, jv)):
                flat = mine.reshape(mine.shape[0], -1, *mine.shape[3:])[:, :n]
                rflat = ref.reshape(ref.shape[0], -1, *ref.shape[3:])[:, :n]
                np.testing.assert_allclose(flat, rflat, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pp_export_joins_every_stage(layout, port_runs):
    """A ``kv_export`` of each greedy prompt's pages (every stage's layers
    joined over the pp group after the heads over tp, from the pages'
    replica) equals the ranks' own pools laid side by side, byte for
    byte: every layer and every head of the flat layout."""
    got = port_runs(layout)
    pp, dp, tp, part = LAYOUTS[layout]
    per = pp * tp
    for (pages, _), reads, (k, v) in zip(got["pages"], got["reads"],
                                         got["exports"]):
        d = pages[0] // ECFG["num_pages"] if part else 0
        want = _join(reads[d * per:(d + 1) * per], pp, tp)
        assert k.shape[0] == LAYERS
        for mine, ref in ((k, want[0]), (v, want[1])):
            assert np.array_equal(mine.numpy().view(np.uint8),
                                  ref.view(np.uint8))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pp_embed_matches_jax(layout, jax_runs, port_runs):
    np.testing.assert_allclose(port_runs(layout)["embed"],
                               jax_runs(layout)["embed"], atol=EMBED_ATOL,
                               rtol=0)


@pytest.mark.parametrize("layout", ["pp2", "pp4", "dp2_pp2"])
def test_every_stage_launches_and_hands_off(layout, port_runs):
    """Every rank reports its stage, and every stage but the last sent
    activations (the last sent token ids back to stage 0)."""
    pp, dp, tp, _ = LAYOUTS[layout]
    reports = port_runs(layout)["reports"]
    assert sorted(reports) == list(range(pp * dp * tp))
    for rank, rep in reports.items():
        assert rep["stage"] == rank // tp % pp
        assert rep["handoffs"]["sends"] > 0


def test_pp_moe_matches_jax(weights):
    """The tiny MoE model (2 layers, 4 experts top-2) under pp 2: greedy
    tokens equal JAX's pp 2 engine's."""
    cfg_j, params, cfg_t, source = weights["moe"]
    reqs = {n: r for n, r in _requests(cfg_t).items() if n.startswith("greedy")}
    eng = _jax_engine(cfg_j, params, "pp2")

    async def run(engine):
        try:
            return await _collect(engine, reqs)
        finally:
            await engine.shutdown()

    want = asyncio.run(run(eng))
    with host_threads(1):
        port = TorchEngine(cfg_t, source, EngineConfig(**ECFG), eos_token_ids=[],
                           parallel=ParallelConfig(pp=2), devices=["cpu"] * 2)
        got = asyncio.run(run(port))
    assert got == want


# -- the layout and each stage's shard --------------------------------------- #


def test_rank_layout_is_jax_mesh_dp_pp_tp():
    """Rank (d * pp + s) * tp + t sits where JAX's `make_mesh` puts
    device r: ``np.array(devices).reshape(dp, pp, tp)``."""
    from dynamo_tpu.parallel import make_mesh as jax_make_mesh
    from dynamo_tpu_torch.parallel.mesh import TpGroup

    pcfg = JaxParallelConfig(dp=2, pp=2, tp=2)
    mesh = jax_make_mesh(pcfg, jax.devices()[:8])
    ids = np.vectorize(lambda dev: dev.id)(mesh.devices)
    names = list(mesh.axis_names)
    g = object.__new__(TpGroup)
    g.dp, g.pp, g.tp = 2, 2, 2
    for d in range(2):
        for s in range(2):
            for t in range(2):
                idx = {"dp": d, "pp": s, "tp": t}
                want = ids[tuple(idx.get(n, 0) for n in names)]
                assert g.rank_of(d, s, t) == want - jax.devices()[0].id


@pytest.mark.parametrize("stage", [0, 1])
def test_stage_shards_match_jax_shard_params_pp(weights, stage):
    """A stage's layer leaves (tensor rank t's slice) equal the device
    shard JAX `shard_params_pp` places on (stage, t): the stacked layer
    axis split over pp, each layer megatron-sharded over tp."""
    from dynamo_tpu.parallel import make_mesh as jax_make_mesh
    from dynamo_tpu.parallel.pp_engine import shard_params_pp

    cfg_j, params, cfg_t, _ = weights["dense"]
    pcfg = JaxParallelConfig(pp=2, tp=2)
    mesh = jax_make_mesh(pcfg, jax.devices()[:4])
    placed = shard_params_pp(params, cfg_j, mesh)
    tree = jax.tree.map(np.asarray, params)
    names = list(mesh.axis_names)
    for t in range(2):
        mine = shard_params(tree, cfg_t, t, 2, stage, 2)
        idx = {"pp": stage, "tp": t}
        dev = mesh.devices[tuple(idx.get(n, 0) for n in names)]
        for k, leaf in placed["layers"].items():
            shard = next(s for s in leaf.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(np.asarray(shard.data),
                                          mine["layers"][k])
        assert ("embed" in mine) == (stage == 0)
        assert ("final_norm" in mine) == (stage == 1)


def test_seeded_stages_draw_the_flat_model():
    """`SeededShards` at pp 2: each stage's layers are the flat model's
    (every layer drawn, the stage's kept), the embedding on stage 0, the
    head and final norm on the last stage."""
    from dynamo_tpu_torch.parallel import SeededShards

    cfg = tcfg.tiny_config(num_hidden_layers=LAYERS)
    src = SeededShards(cfg, 3, "float32")
    flat = src(0, 1, "cpu")
    for s in range(2):
        stage = src(0, 1, "cpu", stage=s, pp=2)
        assert len(stage.layers) == LAYERS // 2
        for i, layer in zip(stage.layer_range, stage.layers):
            for name, p in layer.named_parameters():
                assert torch.equal(p, dict(flat.layers[i].named_parameters())[name])
        assert (stage.embed is not None) == (s == 0)
        assert (stage.lm_head is not None) == (s == 1)
    assert torch.equal(src(0, 1, "cpu", stage=1, pp=2).lm_head, flat.lm_head)
    assert torch.equal(src(0, 1, "cpu", stage=0, pp=2).embed, flat.embed)


# -- the worker and the refusals --------------------------------------------- #


def _worker_args(*flags):
    from dynamo_tpu_torch.worker.__main__ import build_parser

    return build_parser().parse_args(["--control", "127.0.0.1:1", *flags])


def test_worker_takes_pp():
    from dynamo_tpu_torch.worker.__main__ import check_role, parallel_from_args

    args = _worker_args("--pp", "2", "--tp", "2", "--dp", "2",
                        "--kv-partition", "--device", "cpu")
    check_role(args)
    pcfg, devs = parallel_from_args(args)
    assert (pcfg.dp, pcfg.pp, pcfg.tp, devs) == (2, 2, 2, ["cpu"] * 8)


@pytest.mark.parametrize("call, error, match", [
    (lambda: TorchEngine(tcfg.tiny_config(num_hidden_layers=3), None,
                         EngineConfig(**ECFG), parallel=ParallelConfig(pp=2),
                         devices=["cpu"] * 2),
     ValueError, r"pp=2 must divide num_hidden_layers=3"),
    (lambda: TorchEngine(tcfg.tiny_config(), None, EngineConfig(**ECFG),
                         parallel=ParallelConfig(pp=2), devices=["cpu"] * 2,
                         vision=(None, object())),
     ValueError, r"vision tower or M-RoPE.*ROADMAP 2.8"),
    (lambda: TorchEngine(tcfg.tiny_config(mrope_section=(2, 3, 3)), None,
                         EngineConfig(**ECFG), parallel=ParallelConfig(pp=2),
                         devices=["cpu"] * 2),
     ValueError, r"ROADMAP 2.8"),
    (lambda: __import__("dynamo_tpu_torch.worker.__main__", fromlist=["x"])
     .check_role(_worker_args("--pp", "2", "--dp-ranks", "2")),
     SystemExit, r"--pp > 1 with --dp-ranks .*ROADMAP 2.2b.4"),
    (lambda: ParallelConfig(pp=2, sp=2).validate(4), ValueError, r"sp = 1"),
], ids=["layers_not_divided", "vision_tower", "mrope", "dp_ranks_with_pp",
        "pp_with_sp"])
def test_pp_refusals(call, error, match):
    """What pp refuses, each before a follower is spawned."""
    with pytest.raises(error, match=match):
        call()
