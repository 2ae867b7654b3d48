"""Vision under tensor and data parallelism: `TorchEngine(parallel=
ParallelConfig(dp, tp), vision=(tower, vcfg))` on CPU gloo groups of 2
and 4 processes against the JAX package's meshed `JaxEngine` on virtual
CPU devices, on the same f32 weights (the LLM through `TreeShards` of the
JAX tree, the towers through `vision_params_from_jax`) and the same
preprocessed requests (the JAX preprocessor's patch and pixel blobs):

- a tiny qwen2-vl model (M-RoPE, its vocabulary padded to 264 so it
  splits over tp 2, as `tests/test_qwen_vl.py:611`) with its tiny tower:
  an image, two images, a 2-frame video and text; a tiny LLaVA-style
  model with the CLIP tower of `tests/test_multimodal.py:369`: an image,
  two images and text;
- at tp 2, dp 2 (pool replicated), dp 2 partitioned and dp 2 x tp 2
  partitioned: greedy tokens identical to JAX's engine on the same mesh
  (both sides compute in f32 and take the argmax: exact equality is the
  tolerance);
- the tower on the leader alone (the followers report no tower
  parameters), each replica splicing only its own block's media rows,
  decode plans carrying every media row's rope delta, a media prefix hit
  on its partition only, an encode worker's embeddings on a tower-less
  leader giving the in-engine tower's tokens, ``tp=1`` bit for bit the
  flat engine, and the worker CLI building vision groups.

Each layout's group is built once, in module-scoped fixtures, and its
cases read the results.
"""

import asyncio
import base64
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.llm import ModelDeploymentCard as JaxCard
from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as JaxPre
from dynamo_tpu.models import init_params as jax_init_params
from dynamo_tpu.models import tiny_config as jax_tiny_config
from dynamo_tpu.models import qwen_vl as jq
from dynamo_tpu.models import vision as jv
from dynamo_tpu.parallel import ParallelConfig as JaxParallelConfig
from dynamo_tpu.testing import tiny_tokenizer as jax_tiny_tokenizer
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import params_from_jax, tiny_config
from dynamo_tpu_torch.models import qwen_vl as tq
from dynamo_tpu_torch.models import vision as tv
from dynamo_tpu_torch.parallel import ParallelConfig, TreeShards
from dynamo_tpu_torch.parallel.sharding import save_tree
from dynamo_tpu_torch.testing import host_threads

VOCAB = 264  # the tiny tokenizer's 261 ids, padded to split over tp 2
# four sequences a prefill pass within 48 tokens: media rows of both dp
# blocks in one pass, runs cut by chunk boundaries
ECFG = dict(page_size=8, num_pages=96, max_num_seqs=4, max_prefill_tokens=48,
            prefill_batch_size=4, max_model_len=192)
# layout -> (dp, tp, kv_partition)
LAYOUTS = {"tp2": (1, 2, False), "dp2": (2, 1, False),
           "dp2_part": (2, 1, True), "dp2_tp2_part": (2, 2, True)}
TOKENS = 6


def _png_uri(arr) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _apng_uri(frames) -> str:
    from PIL import Image

    ims = [Image.fromarray(f) for f in frames]
    buf = io.BytesIO()
    ims[0].save(buf, format="PNG", save_all=True, append_images=ims[1:])
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _img(seed, h=32, w=40):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _chat(pre, parts, max_tokens=TOKENS):
    content = []
    for p in parts:
        if isinstance(p, str):
            content.append({"type": "text", "text": p})
        else:
            kind, uri = p
            content.append({"type": f"{kind}_url", f"{kind}_url": {"url": uri}})
    out = pre.preprocess_chat({"messages": [{"role": "user", "content": content}]})
    out["sampling_options"] = {"temperature": 0.0}
    out["stop_conditions"] = {"max_tokens": max_tokens, "ignore_eos": True}
    return out


def _setup(kind, tmp):
    """The JAX and port halves of one tiny model with its tower."""
    tok = jax_tiny_tokenizer()
    image_id = tok.encode("<image>")[0]
    if kind == "qwen":
        over = dict(mrope_section=(2, 3, 3), model_type="qwen2_vl",
                    name="tiny-qwen-vl")
        jcfg = jax_tiny_config(vocab_size=VOCAB, **over)
        vcfg = jq.tiny_qwen_vl_vision_config(out_hidden_size=jcfg.hidden_size)
        vparams = jq.init_qwen_vl_vision_params(vcfg, jax.random.PRNGKey(7),
                                                dtype=jnp.float32)
        vcfg_t = tq.Qwen2VLVisionConfig(**vcfg.__dict__)
        card = dict(mm_arch="qwen2_vl", mm_config=dict(
            depth=2, embed_dim=32, num_heads=2, mlp_ratio=2.0, patch_size=4,
            temporal_patch_size=2, spatial_merge_size=2,
            hidden_size=jcfg.hidden_size, min_pixels=8 * 8,
            max_pixels=64 * 64))
    else:
        over = dict(name="tiny-llava")
        jcfg = jax_tiny_config(vocab_size=VOCAB, **over)
        vcfg = jv.tiny_vision_config(out_hidden_size=jcfg.hidden_size)
        vparams = jv.init_vision_params(vcfg, jax.random.PRNGKey(7),
                                        dtype=jnp.float32)
        vcfg_t = tv.VisionConfig(**vcfg.__dict__)
        card = dict(image_patches=vcfg.num_patches, image_size=vcfg.image_size)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    path = str(tmp / f"{kind}.npz")
    save_tree(path, tree)
    cfg_t = tiny_config(vocab_size=VOCAB, **over)
    mdc = JaxCard(name=jcfg.name, tokenizer_json=tok.to_json_str(),
                  eos_token_ids=[], image_token="<image>",
                  image_token_id=image_id, **card)
    pre = JaxPre(mdc, tok)
    a, b = _img(1), _img(2, 24, 48)
    reqs = {"image": _chat(pre, ["describe ", ("image", _png_uri(a)), " now"]),
            "two_images": _chat(pre, ["two ", ("image", _png_uri(a)), " and ",
                                      ("image", _png_uri(b)), "?"])}
    if kind == "qwen":
        video = [_img(10 + i, 24, 20) for i in range(2)]
        reqs["video_2_frames"] = _chat(pre, ["what happens? ",
                                             ("video", _apng_uri(video))])
    reqs["text"] = _chat(pre, ["just text, no media at all"])
    # a prefix hit and a miss on the partitioned pool
    extra = {"again": _chat(pre, ["describe ", ("image", _png_uri(a)), " now"]),
             "other": _chat(pre, ["describe ", ("image", _png_uri(_img(5))),
                                  " now"])}

    def tower():
        return tv.vision_params_from_jax(
            vcfg_t, jax.tree.map(np.asarray, vparams), device="cpu")

    return dict(kind=kind, jcfg=jcfg, params=params, vcfg=vcfg, vparams=vparams,
                cfg_t=cfg_t, vcfg_t=vcfg_t, tree=tree,
                source=TreeShards(cfg_t, path), tower=tower, reqs=reqs,
                extra=extra)


async def _collect(engine, req):
    out = []
    async for d in engine.generate(dict(req)):
        assert d.get("finish_reason") != "error", d
        out += d["token_ids"]
    return out


async def _wave(engine, reqs, part):
    """Every request's greedy tokens.  On a partitioned pool the second
    half starts once the first half has its first tokens, so it admits
    onto the other partition (ties go to partition 0)."""
    names = list(reqs)
    if not part:
        return dict(zip(names, await asyncio.gather(
            *[_collect(engine, reqs[n]) for n in names])))
    first, rest = names[:len(names) // 2], names[len(names) // 2:]
    started = {n: asyncio.Event() for n in first}

    async def one(n):
        toks = []
        async for d in engine.generate(dict(reqs[n])):
            assert d.get("finish_reason") != "error", d
            toks += d["token_ids"]
            if n in started:
                started[n].set()
        return toks

    tasks = {n: asyncio.ensure_future(one(n)) for n in first}
    await asyncio.gather(*[e.wait() for e in started.values()])
    tasks.update({n: asyncio.ensure_future(one(n)) for n in rest})
    return {n: await t for n, t in tasks.items()}


def _jax_run(s, layout):
    dp, tp, part = LAYOUTS[layout]
    eng = JaxEngine(s["jcfg"], s["params"],
                    JaxEngineConfig(**ECFG, kv_partition=part),
                    eos_token_ids=[], kv_dtype=jnp.float32,
                    vision=(s["vparams"], s["vcfg"]),
                    parallel=JaxParallelConfig(dp=dp, tp=tp),
                    devices=jax.devices()[:dp * tp])

    async def run():
        try:
            return await _wave(eng, s["reqs"], part)
        finally:
            await eng.shutdown()

    return asyncio.run(run())


def _finish_spy(engine, into):
    real = engine.scheduler._finish

    def spy(seq, reason):
        into[tuple(seq.prompt)] = (list(seq.pages), seq.kv_rank)
        return real(seq, reason)

    engine.scheduler._finish = spy


def _plan_spy(engine, kinds, into):
    real = engine._plan

    def spy(kind, **fields):
        if kind in kinds:
            into.append((kind, fields))
        return real(kind, **fields)

    engine._plan = spy


def _port_run(s, layout):
    """The group's tokens, every rank's report, its decode plans' rope
    offsets, the prefix hits of the partitioned layouts, and (tp 2) the
    tokens of a tower-less leader fed an encode worker's embeddings."""
    from dynamo_tpu_torch.disagg.encode import encode_media

    dp, tp, part = LAYOUTS[layout]
    eng = TorchEngine(s["cfg_t"], s["source"],
                      EngineConfig(**ECFG, kv_partition=part), eos_token_ids=[],
                      parallel=ParallelConfig(dp=dp, tp=tp),
                      devices=["cpu"] * (dp * tp),
                      vision=(s["tower"](), s["vcfg_t"]))
    seqs, plans = {}, []
    _finish_spy(eng, seqs)
    _plan_spy(eng, ("decode",), plans)
    out = {"layout": layout}

    async def run():
        try:
            out["tokens"] = await _wave(eng, s["reqs"], part)
            out["reports"] = await eng.group_reports()
            out["seqs"] = {n: seqs[tuple(r["token_ids"])]
                           for n, r in s["reqs"].items()}
            out["plans"] = plans
            if part:
                hits = []
                for req in s["extra"].values():
                    c0 = eng.metrics().prefix_cached_tokens_total
                    toks = await _collect(eng, req)
                    hits.append((toks, eng.metrics().prefix_cached_tokens_total
                                 - c0, seqs[tuple(req["token_ids"])]))
                out["hits"] = hits
            if layout == "tp2":
                # the encode worker's embeddings (computed by the leader's
                # own tower, in process), served by a leader that keeps
                # only the tower's geometry
                embeds = {n: await encode_media(eng, r)
                          for n, r in s["reqs"].items() if n != "text"}
                eng.clear_kv_blocks()
                eng.vision = (None, s["vcfg_t"])
                fed = {}
                for n, r in s["reqs"].items():
                    r = {k: v for k, v in r.items()
                         if k not in ("mm_pixels", "mm_patches")}
                    if n in embeds:
                        r["mm_embeds"] = embeds[n]["mm_embeds"]
                        r["cache_salt"] = embeds[n]["cache_salt"]
                    fed[n] = r
                out["fed"] = await _wave(eng, fed, part)
        finally:
            await eng.shutdown()

    asyncio.run(run())
    return out


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tpv")
    return {k: _setup(k, tmp) for k in ("qwen", "clip")}


@pytest.fixture(scope="module")
def runs(setups):
    """(tower, layout) -> {"jax": JAX's tokens, "port": `_port_run`}, each
    group built once (one live group a process)."""
    done = {}

    def get(kind, layout):
        if (kind, layout) not in done:
            s = setups[kind]
            jax_tokens = _jax_run(s, layout)
            # one thread a rank (the followers take the leader's count)
            with host_threads(1):
                done[kind, layout] = {"jax": jax_tokens,
                                      "port": _port_run(s, layout)}
        return done[kind, layout]

    return get


CASES = [(k, lay) for k in ("qwen", "clip") for lay in LAYOUTS]


@pytest.mark.parametrize("kind, layout", CASES,
                         ids=[f"{k}-{lay}" for k, lay in CASES])
def test_tokens_equal_jax_meshed_engine(kind, layout, runs):
    got = runs(kind, layout)
    assert got["port"]["tokens"] == got["jax"]
    toks = list(got["port"]["tokens"].values())
    assert all(len(t) == TOKENS for t in toks)
    assert len(set(map(tuple, toks))) == len(toks)  # media reach the model


@pytest.mark.parametrize("kind, layout", CASES,
                         ids=[f"{k}-{lay}" for k, lay in CASES])
def test_only_the_leader_holds_the_tower(kind, layout, runs):
    reports = runs(kind, layout)["port"]["reports"]
    dp, tp, _ = LAYOUTS[layout]
    assert sorted(reports) == list(range(dp * tp))
    assert reports[0]["tower_params"] > 0
    assert all(reports[r]["tower_params"] == 0 for r in range(1, dp * tp))


@pytest.mark.parametrize("kind, layout", CASES,
                         ids=[f"{k}-{lay}" for k, lay in CASES])
def test_each_replica_splices_only_its_blocks_media_rows(kind, layout, runs):
    """Every rank's record of its media splices: the layout rows of its
    replica's block only, on every tensor rank of the replica alike; the
    media rows of the wave land on every replica."""
    reports = runs(kind, layout)["port"]["reports"]
    dp, tp, _ = LAYOUTS[layout]
    for r, rep in reports.items():
        replica = r // tp
        for n, rows in rep["media_rows"]:
            assert rows and all(replica * n <= i < (replica + 1) * n
                                for i in rows), (r, n, rows)
        assert rep["media_rows"] == reports[replica * tp]["media_rows"]
    if dp > 1:
        assert all(reports[d * tp]["media_rows"] for d in range(dp))


def _jax_delta(s, req) -> int:
    """A request's M-RoPE delta, from the JAX package's positions."""
    from dynamo_tpu.llm.multimodal import unpack_patches

    runs = [(off, unpack_patches(b)[1])
            for off, b in zip(req["mm_offsets"], req["mm_patches"])]
    return int(jq.mrope_positions_from_runs(len(req["token_ids"]), runs,
                                            s["vcfg"])[1])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_decode_plans_carry_each_rows_rope_delta(layout, setups, runs):
    """The decode plans every rank replays carry the rope offsets of the
    media rows (their M-RoPE deltas, as the JAX package derives them), so
    every rank ropes a media row's decode at its position plus its delta;
    text and padding rows carry 0."""
    s = setups["qwen"]
    want = {_jax_delta(s, r) for n, r in s["reqs"].items() if n != "text"}
    assert want - {0}
    offs = [f["arrays"]["rope_off"] for _, f in runs("qwen", layout)["port"]["plans"]]
    assert offs and all(o.dtype == np.int64 for o in offs)
    assert {int(x) for o in offs for x in o} == want | {0}


def test_media_prefix_hit_stays_on_its_partition(runs):
    """The same image again hits its prompt's pages on the partition that
    holds them; another image under the same text hits nothing; both give
    the tokens of their first run (JAX's for the first)."""
    got = runs("qwen", "dp2_part")
    p0, r0 = got["port"]["seqs"]["image"]
    (t1, h1, (p1, r1)), (_, h2, _) = got["port"]["hits"]
    assert t1 == got["jax"]["image"]
    assert h1 >= ECFG["page_size"] and h2 == 0
    assert r1 == r0
    npp = ECFG["num_pages"]
    assert {p // npp for p in p0} == {r0} == {p // npp for p in p1}
    assert p1[:h1 // ECFG["page_size"]] == p0[:h1 // ECFG["page_size"]]


@pytest.mark.parametrize("kind", ["qwen", "clip"])
def test_encode_worker_embeddings_on_a_towerless_leader(kind, runs):
    got = runs(kind, "tp2")["port"]
    assert got["fed"] == got["tokens"]


def test_tp1_is_the_flat_engine_bit_for_bit(setups):
    """``ParallelConfig(tp=1)`` is no group: the same tokens and the same
    pool bytes as the flat engine."""
    s = setups["qwen"]
    pools = []
    toks = []
    for parallel in (None, ParallelConfig(tp=1)):
        model = params_from_jax(s["cfg_t"], s["tree"], device="cpu")
        eng = TorchEngine(s["cfg_t"], model, EngineConfig(**ECFG),
                          eos_token_ids=[], device="cpu", parallel=parallel,
                          vision=(s["tower"](), s["vcfg_t"]))
        assert eng.world == 1

        async def run():
            try:
                return await _wave(eng, s["reqs"], False)
            finally:
                await eng.shutdown()

        toks.append(asyncio.run(run()))
        pools.append((eng.kv.k.clone(), eng.kv.v.clone()))
    assert toks[0] == toks[1]
    for a, b in zip(*pools):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _tiny_checkpoint(path):
    """A 2-layer llama checkpoint (the HF layout: config.json and one
    safetensors file of seeded weights) whose vocabulary of 262 splits
    over tp 2, with the tiny tokenizer (its single-token ``<image>``)
    beside it."""
    import json

    from safetensors.numpy import save_file

    from dynamo_tpu_torch.testing import tiny_tokenizer_json

    V, h, f, L, nh, nkv, hd = 262, 64, 128, 2, 4, 2, 16
    rng = np.random.default_rng(0)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(
            np.float32)

    t = {"model.embed_tokens.weight": w(V, h), "lm_head.weight": w(V, h),
         "model.norm.weight": np.ones(h, np.float32)}
    for i in range(L):
        p = f"model.layers.{i}."
        t.update({p + "self_attn.q_proj.weight": w(nh * hd, h),
                  p + "self_attn.k_proj.weight": w(nkv * hd, h),
                  p + "self_attn.v_proj.weight": w(nkv * hd, h),
                  p + "self_attn.o_proj.weight": w(h, nh * hd),
                  p + "mlp.gate_proj.weight": w(f, h),
                  p + "mlp.up_proj.weight": w(f, h),
                  p + "mlp.down_proj.weight": w(h, f),
                  p + "input_layernorm.weight": np.ones(h, np.float32),
                  p + "post_attention_layernorm.weight": np.ones(h, np.float32)})
    save_file(t, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": V, "hidden_size": h, "intermediate_size": f,
        "num_hidden_layers": L, "num_attention_heads": nh,
        "num_key_value_heads": nkv, "head_dim": hd, "rms_norm_eps": 1e-6,
        "rope_theta": 10000.0, "max_position_embeddings": 512,
        "tie_word_embeddings": False, "torch_dtype": "float32"}))
    (path / "tokenizer.json").write_text(tiny_tokenizer_json())
    return str(path)


@pytest.mark.parametrize("flags", [
    ["--tp", "2"], ["--dp", "2", "--kv-partition"]], ids=["tp2", "dp2_part"])
def test_worker_builds_a_vision_group(flags, tmp_path):
    """``worker --tp 2 --vision tiny`` (a checkpoint whose vocabulary
    splits) and ``worker --dp 2 --kv-partition --vision tiny`` build their
    groups with the tower on the leader alone, and an image chat through
    the card's preprocessor gives the flat worker's tokens."""
    from dynamo_tpu_torch.llm import HuggingFaceTokenizer, OpenAIPreprocessor
    from dynamo_tpu_torch.worker.__main__ import (build_engine, build_parser,
                                                  check_role)

    model = _tiny_checkpoint(tmp_path) if flags[0] == "--tp" else "tiny"
    common = ["--control", "x:1", "--model", model, "--vision", "tiny",
              "--device", "cpu", "--dtype", "float32", "--num-pages", "32",
              "--max-model-len", "128"]
    chat = {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "look "},
        {"type": "image_url", "image_url": {"url": _png_uri(_img(3))}}]}]}
    got = {}
    for name, extra in (("flat", []), ("group", flags)):
        args = build_parser().parse_args(common + extra)
        check_role(args)
        with host_threads(1):
            engine, mdc = build_engine(args)
        tok = HuggingFaceTokenizer.from_json_str(
            mdc.tokenizer_json, eos_token_ids=list(mdc.eos_token_ids))
        req = OpenAIPreprocessor(mdc, tok).preprocess_chat(chat)
        req["sampling_options"] = {"temperature": 0.0}
        req["stop_conditions"] = {"max_tokens": 4, "ignore_eos": True}
        assert req.get("mm_pixels")

        async def run():
            try:
                toks = await _collect(engine, req)
                reports = (await engine.group_reports() if name == "group"
                           else None)
                return toks, reports
            finally:
                await engine.shutdown()

        with host_threads(1):
            got[name] = asyncio.run(run())
    toks, reports = got["group"]
    assert toks == got["flat"][0] and len(toks) == 4
    assert reports[0]["tower_params"] > 0
    assert [reports[r]["tower_params"] for r in range(1, len(reports))] == [0]
