"""Multimodal serving of the port (`TorchEngine(vision=...)`,
`engine/media.py`, the M-RoPE rope offset of the decode graphs) against
the JAX package's `JaxEngine(vision=...)` on the CPU.

Same tiny f32 weights on both sides (the LLM through `params_from_jax`,
the towers through `vision_params_from_jax`), same preprocessed requests
(the JAX preprocessor's patch and pixel blobs, from PNG and APNG data
URIs).  Every greedy stream must be token-identical to JaxEngine's: a
qwen-vl image whose run is cut by a chunk boundary, two images in one
prompt, a 4-frame video, text alone on the M-RoPE model, decode after the
image under one-step blocks, 8-step blocks with a ladder and chains, the
continuous loop and n-gram speculation; the same image again is a prefix
hit of at least its run and another image under the same text is not; a
CLIP (LLaVA-style) tower through mm_pixels.  Exact token equality is the
tolerance: both sides compute in f32 and greedy picks the argmax.
"""

import asyncio
import base64
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.llm import ModelDeploymentCard as JaxCard
from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as JaxPre
from dynamo_tpu.models import init_params as jax_init_params
from dynamo_tpu.models import tiny_config as jax_tiny_config
from dynamo_tpu.models import qwen_vl as jq
from dynamo_tpu.models import vision as jv
from dynamo_tpu.testing import tiny_tokenizer as jax_tiny_tokenizer
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import params_from_jax, tiny_config
from dynamo_tpu_torch.models import qwen_vl as tq
from dynamo_tpu_torch.models import vision as tv

ECFG = dict(page_size=8, num_pages=128, max_num_seqs=4, max_prefill_tokens=16,
            max_model_len=256)
ARMS = {
    "steps1": {},
    "steps8_ladder_chain": dict(decode_steps=8, decode_block_ladder=[1, 2, 4],
                                decode_chain=2),
    "continuous": dict(decode_steps=4, decode_chain=2, decode_continuous=True),
    "spec4": dict(speculative_ngram_k=4),
}


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


@pytest.fixture(scope="module")
def qwen():
    tok = jax_tiny_tokenizer()
    jcfg = jax_tiny_config(vocab_size=tok.vocab_size, mrope_section=(2, 3, 3),
                           model_type="qwen2_vl", name="tiny-qwen-vl")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    vcfg = jq.tiny_qwen_vl_vision_config(out_hidden_size=jcfg.hidden_size)
    vparams = jq.init_qwen_vl_vision_params(vcfg, jax.random.PRNGKey(7))
    mdc = JaxCard(name="tiny-qwen-vl", tokenizer_json=tok.to_json_str(),
                  eos_token_ids=[], image_token="<image>",
                  image_token_id=tok.encode("<image>")[0], mm_arch="qwen2_vl",
                  mm_config=dict(depth=2, embed_dim=32, num_heads=2, mlp_ratio=2.0,
                                 patch_size=4, temporal_patch_size=2,
                                 spatial_merge_size=2, hidden_size=64,
                                 min_pixels=8 * 8, max_pixels=64 * 64))
    return dict(pre=JaxPre(mdc, tok), jcfg=jcfg, params=params, vcfg=vcfg,
                vparams=vparams)


def _chat(pre, parts, max_tokens=10):
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


def _torch_engine(s, vision_cfg_t, **over):
    cfg = tiny_config(vocab_size=s["jcfg"].vocab_size,
                      mrope_section=s["jcfg"].mrope_section,
                      model_type=s["jcfg"].model_type, name=s["jcfg"].name)
    model = params_from_jax(cfg, jax.tree.map(np.asarray, s["params"]), device="cpu")
    tower = tv.vision_params_from_jax(vision_cfg_t,
                                      jax.tree.map(np.asarray, s["vparams"]),
                                      device="cpu")
    return TorchEngine(cfg, model, EngineConfig(**{**ECFG, **over}),
                       eos_token_ids=[], device="cpu",
                       vision=(tower, vision_cfg_t))


def _jax_engine(s, **over):
    return JaxEngine(s["jcfg"], s["params"], JaxEngineConfig(**{**ECFG, **over}),
                     eos_token_ids=[], kv_dtype=jnp.float32,
                     vision=(s["vparams"], s["vcfg"]))


async def _collect(engine, req):
    out = []
    async for d in engine.generate(dict(req)):
        assert d.get("finish_reason") != "error", d
        out += d["token_ids"]
    return out


async def _run(engine, batches):
    """Each batch concurrently, batches in order; the token lists."""
    got = []
    for batch in batches:
        got += await asyncio.gather(*[_collect(engine, r) for r in batch])
    m = engine.metrics()
    await engine.shutdown()
    return got, m


def _tq_cfg(vcfg):
    return tq.Qwen2VLVisionConfig(**vcfg.__dict__)


def _qwen_batches(pre):
    a, b = _img(1), _img(2)
    video = [_img(10 + i, 24, 20) for i in range(4)]
    return [
        [_chat(pre, ["describe ", ("image", _png_uri(a)), " now"]),
         _chat(pre, ["two ", ("image", _png_uri(a)), " and ",
                     ("image", _png_uri(_img(3, 24, 48))), "?"]),
         _chat(pre, ["what happens? ", ("video", _apng_uri(video))]),
         _chat(pre, ["just text, no media at all"])],
    ]


@pytest.mark.parametrize("arm", list(ARMS))
async def test_qwen_vl_tokens_equal_jax_engine(qwen, arm):
    batches = _qwen_batches(qwen["pre"])
    req = batches[0][0]
    assert len(req["token_ids"]) > ECFG["max_prefill_tokens"]  # the run is cut
    got, _ = await _run(_torch_engine(qwen, _tq_cfg(qwen["vcfg"]), **ARMS[arm]), batches)
    want, _ = await _run(_jax_engine(qwen, **ARMS[arm]), batches)
    assert got == want
    assert len(set(map(tuple, got))) == len(got)  # media reach the model


async def test_qwen_vl_prefix_hit_same_image_only(qwen):
    pre = qwen["pre"]
    first = _chat(pre, ["look: ", ("image", _png_uri(_img(1))), " and say"])
    same = _chat(pre, ["look: ", ("image", _png_uri(_img(1))), " and say"])
    other = _chat(pre, ["look: ", ("image", _png_uri(_img(5))), " and say"])
    assert same["token_ids"] == other["token_ids"]
    eng = _torch_engine(qwen, _tq_cfg(qwen["vcfg"]))
    t1 = await _collect(eng, first)
    c0 = eng.metrics().prefix_cached_tokens_total
    t2 = await _collect(eng, same)
    c1 = eng.metrics().prefix_cached_tokens_total
    t3 = await _collect(eng, other)
    c2 = eng.metrics().prefix_cached_tokens_total
    await eng.shutdown()
    off = first["mm_offsets"][0]
    run = len(first["token_ids"]) - off - len(" and say")
    assert t1 == t2 and t1 != t3
    assert c1 - c0 >= off + 1 and (c1 - c0) // ECFG["page_size"] >= (off + run) // ECFG["page_size"] - 1
    assert c2 == c1  # another image: no page of the first is reused
    jeng = _jax_engine(qwen)
    want = [await _collect(jeng, r) for r in (first, same, other)]
    await jeng.shutdown()
    assert [t1, t2, t3] == want


async def test_qwen_vl_rejects_bad_media(qwen):
    eng = _torch_engine(qwen, _tq_cfg(qwen["vcfg"]))
    req = _chat(qwen["pre"], ["x ", ("image", _png_uri(_img(1)))])
    bad = dict(req, mm_offsets=[len(req["token_ids"])])
    outs = [d async for d in eng.generate(bad)]
    assert outs[-1]["finish_reason"] == "error" and "offsets" in outs[-1]["error"]
    short = dict(req, mm_patches=[dict(req["mm_patches"][0], grid=[1, 2, 2])])
    outs = [d async for d in eng.generate(short)]
    assert outs[-1]["finish_reason"] == "error"
    await eng.shutdown()


@pytest.fixture(scope="module")
def clip():
    tok = jax_tiny_tokenizer()
    jcfg = jax_tiny_config(vocab_size=tok.vocab_size)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    vcfg = jv.tiny_vision_config(attention_bias=True, use_cls_token=True,
                                 pre_layernorm=True, projector_hidden=48,
                                 feature_layer=-2)
    vparams = jv.init_vision_params(vcfg, jax.random.PRNGKey(3))
    mdc = JaxCard(name="tiny-llava", tokenizer_json=tok.to_json_str(),
                  eos_token_ids=[], image_token="<image>",
                  image_token_id=tok.encode("<image>")[0], mm_arch="clip",
                  image_patches=vcfg.num_patches, image_size=vcfg.image_size)
    return dict(pre=JaxPre(mdc, tok), jcfg=jcfg, params=params, vcfg=vcfg,
                vparams=vparams)


@pytest.mark.parametrize("arm", ["steps1", "steps8_ladder_chain"])
async def test_clip_tokens_equal_jax_engine(clip, arm):
    pre = clip["pre"]
    batches = [[_chat(pre, ["see ", ("image", _png_uri(_img(1)))]),
                _chat(pre, ["both ", ("image", _png_uri(_img(2, 40, 24))),
                            ("image", _png_uri(_img(4)))]),
                _chat(pre, ["text only"])]]
    vcfg_t = tv.VisionConfig(**clip["vcfg"].__dict__)
    got, _ = await _run(_torch_engine(clip, vcfg_t, **ARMS[arm]), batches)
    want, _ = await _run(_jax_engine(clip, **ARMS[arm]), batches)
    assert got == want


@pytest.mark.parametrize("kind", ["qwen", "clip"])
async def test_encode_worker_offload_equals_in_engine_tower(qwen, clip, kind):
    """The EPD split: an encode worker serving only the tower and a serving
    engine with the tower's geometry alone behind `EncodeOffload` give the
    in-engine tower's tokens."""
    from dynamo_tpu_torch.disagg import EncodeOffload, serve_encode_worker
    from dynamo_tpu_torch.llm import ModelDeploymentCard
    from dynamo_tpu_torch.runtime import ControlPlaneServer, DistributedRuntime

    s = qwen if kind == "qwen" else clip
    vcfg_t = (_tq_cfg(s["vcfg"]) if kind == "qwen"
              else tv.VisionConfig(**s["vcfg"].__dict__))
    reqs = [_chat(s["pre"], ["look ", ("image", _png_uri(_img(1))), " then"]),
            _chat(s["pre"], ["two ", ("image", _png_uri(_img(2, 24, 48))),
                             ("image", _png_uri(_img(6)))])]
    direct = _torch_engine(s, vcfg_t)
    want = [await _collect(direct, r) for r in reqs]
    await direct.shutdown()
    control = await ControlPlaneServer().start()
    enc_rt = await DistributedRuntime.connect(control.address)
    srv_rt = await DistributedRuntime.connect(control.address)
    encoder = _torch_engine(s, vcfg_t)
    facade = await serve_encode_worker(enc_rt, encoder, ModelDeploymentCard(name="enc"))
    serving = _torch_engine(s, vcfg_t)
    serving.vision = (None, vcfg_t)  # geometry only: no tower here
    offload = EncodeOffload(serving, srv_rt)
    try:
        got = [await _collect(offload, r) for r in reqs]
        # without the encode worker's embeddings the engine cannot encode
        outs = [d async for d in serving.generate(dict(reqs[0]))]
        assert outs[-1]["finish_reason"] == "error"
    finally:
        await offload.shutdown()
        await facade.shutdown()
        await srv_rt.shutdown(graceful=False)
        await enc_rt.shutdown(graceful=False)
        await control.stop()
    assert got == want
