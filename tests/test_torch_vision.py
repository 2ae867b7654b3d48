"""The port's vision modules against the JAX package's, on the CPU, same
numpy inputs on both sides.

- M-RoPE: `apply_mrope` (f32 rotation within 1e-6) and the integer
  position streams of `mrope_positions` / `mrope_positions_from_runs`
  (exact) for an image, two images and a video, with the 2.0 (arange) and
  2.5 (tokens_per_second) temporal rules;
- the segment attention's plain version against the JAX towers' masked
  einsum (f32, 1e-5 of the largest value): frame segments, windows after
  the window permutation and its inverse (the 2.5 tower's layout), CLIP
  images;
- the towers: `encode_patches` for the tiny 2.0 and 2.5 towers and
  `encode_images` with and without the class token, pre-LayerNorm,
  projector and `feature_layer` -2 (f32, 1e-5 relative);
- loaders: `load_vlm` on tests/fixtures/golden_llava equals the JAX
  loader's params exactly, and its prefill logits meet transformers' at
  tests/test_golden.py's tolerances (2e-4); `load_qwen_vl` of both
  published layouts (2.0 and 2.5, written here from HF models) equals the
  JAX loader's params exactly;
- the preprocessors: the port's request dicts for a chat with a PNG (qwen
  patches and CLIP pixels) equal the JAX preprocessor's (PIL) byte for
  byte, salt and offsets included.
"""

import base64
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import qwen_vl as jq
from dynamo_tpu.models import vision as jv
from dynamo_tpu.ops.rotary import apply_mrope as jax_apply_mrope
from dynamo_tpu_torch.models import qwen_vl as tq
from dynamo_tpu_torch.models import vision as tv
from dynamo_tpu_torch.ops import vision_attention as va
from dynamo_tpu_torch.ops.rotary import apply_mrope, rope_frequencies

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAVA_DIR = os.path.join(ROOT, "tests", "fixtures", "golden_llava")
V25 = dict(intermediate_size=48, window_size=16, fullatt_block_indexes=(1,),
           rms_norm=True, tokens_per_second=2.0)


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _jitter(params, seed):
    """Nonzero biases and norms: the JAX init leaves them 0 / 1."""
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(treedef, [
        np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        for a in leaves])


# -- M-RoPE ----------------------------------------------------------------- #


def test_apply_mrope_matches_jax():
    rng = np.random.default_rng(0)
    B, S, H, hd = 2, 11, 3, 16
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = rng.integers(0, 50, (B, 3, S)).astype(np.int32)
    inv = rope_frequencies(hd, 1e6)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), inv, (2, 3, 3))
    want = jax_apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                           jnp.asarray(inv.numpy()), (2, 3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("rule", ["2.0", "2.5"])
@pytest.mark.parametrize("grids", [[(1, 6, 8)], [(1, 4, 4), (1, 8, 6)],
                                   [(2, 4, 6)], [(4, 6, 4), (1, 2, 2)]],
                         ids=["image", "two_images", "video", "video_and_image"])
def test_mrope_positions_match_jax(rule, grids):
    over = {"tokens_per_second": 2.0} if rule == "2.5" else {}
    cj = jq.tiny_qwen_vl_vision_config(**over)
    ct = tq.tiny_qwen_vl_vision_config(**over)
    IMG = 5
    ids, runs = [1, 2, 3], []
    for g in grids:
        runs.append((len(ids), g))
        ids += [IMG] * jq.merged_tokens(g, cj) + [7, 8]
    pos_j, d_j = jq.mrope_positions(ids, IMG, grids, cj)
    pos_t, d_t = tq.mrope_positions(ids, IMG, grids, ct)
    assert d_t == d_j and np.array_equal(pos_t, pos_j)
    pos_j, d_j = jq.mrope_positions_from_runs(len(ids) + 4, runs, cj)
    pos_t, d_t = tq.mrope_positions_from_runs(len(ids) + 4, runs, ct)
    assert d_t == d_j and np.array_equal(pos_t, pos_j)


# -- segment attention ------------------------------------------------------ #


def _jax_masked(q, k, v, seg_ids):
    """The JAX towers' form: einsum + additive -1e9 mask + softmax."""
    hd = q.shape[-1]
    mask = jnp.where(seg_ids[:, None] == seg_ids[None, :], 0.0, -1e9)[None]
    s = jnp.einsum("qhd,khd->hqk", q, k) * (hd ** -0.5)
    p = jax.nn.softmax(s + mask, axis=-1)
    return np.asarray(jnp.einsum("hqk,khd->qhd", p, v))


def _qkv(L, nh, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((L, nh, hd)).astype(np.float32) * s
            for s in (2.0, 1.0, 1.0)]


@pytest.mark.parametrize("layout", ["frames", "windows", "clip"])
def test_segment_attention_plain_matches_jax_mask(layout):
    if layout == "clip":
        cu, nh, hd = [0, 17, 34], 2, 16
        seg = np.repeat([0, 1], 17)
    else:
        cfg = tq.tiny_qwen_vl_vision_config(window_size=16)
        grid = (2, 10, 12)
        order, cu_frames, cu_win = tq.stream_layout(grid, cfg)
        nh, hd = 2, 16
        if layout == "frames":
            cu, seg = cu_frames, jq._frame_ids(grid)
        else:
            cu, seg = cu_win, jq._window_ids(grid, jq.tiny_qwen_vl_vision_config(
                window_size=16))
    L = cu[-1]
    q, k, v = _qkv(L, nh, hd, 3)
    want = _jax_masked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(seg))
    if layout == "windows":
        # the kernel's layout: the stream in window order, one segment a
        # window; the inverse permutation restores the JAX stream order
        perm = torch.from_numpy(order)
        got = va.segment_attention(*(torch.from_numpy(t)[perm] for t in (q, k, v)), cu)
        got = got[torch.from_numpy(np.argsort(order))].numpy()
        assert len(cu) - 1 > 2 * grid[0]  # several windows per frame
    else:
        got = va.segment_attention(*(torch.from_numpy(t) for t in (q, k, v)), cu).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_segment_tiles_cover_each_segment():
    tiles = va.segment_tiles([0, 5, 140, 141])
    assert tiles.tolist() == [[0, 5, 0, 5], [5, 69, 5, 140], [69, 133, 5, 140],
                              [133, 140, 5, 140], [140, 141, 140, 141]]
    with pytest.raises(ValueError):
        va.check_segments([0, 5, 5, 9], 9)


# -- towers ----------------------------------------------------------------- #


@pytest.mark.parametrize("tower", ["2.0", "2.5"])
def test_encode_patches_matches_jax(tower):
    over = V25 if tower == "2.5" else {}
    cj = jq.tiny_qwen_vl_vision_config(**over)
    ct = tq.tiny_qwen_vl_vision_config(**over)
    params = _jitter(jq.init_qwen_vl_vision_params(cj, jax.random.PRNGKey(1)), 2)
    port = tv.vision_params_from_jax(ct, params, device="cpu")
    rng = np.random.default_rng(0)
    for shape in [(1, 24, 16), (4, 16, 32), (1, 40, 40)]:
        frames = rng.random((*shape, 3), np.float32)
        pj, grid = jq.frames_to_patches(frames, cj)
        pt, grid_t = tq.frames_to_patches(frames, ct)
        assert grid_t == grid and np.array_equal(pt, pj)
        want = np.asarray(jq.encode_patches(params, cj, jnp.asarray(pj), grid))
        got = tq.encode_patches(port, torch.from_numpy(pt), grid).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("over", [
    {},
    dict(attention_bias=True, use_cls_token=True, pre_layernorm=True),
    dict(attention_bias=True, use_cls_token=True, pre_layernorm=True,
         projector_hidden=48, feature_layer=-2),
    dict(projector_hidden=40, hidden_act="gelu"),
], ids=["plain", "cls_preln", "llava", "projector_gelu"])
def test_encode_images_matches_jax(over):
    cj = jv.tiny_vision_config(**over)
    ct = tv.tiny_vision_config(**over)
    params = _jitter(jv.init_vision_params(cj, jax.random.PRNGKey(4)), 5)
    port = tv.vision_params_from_jax(ct, params, device="cpu")
    px = np.random.default_rng(1).random((3, 32, 32, 3), np.float32)
    want = np.asarray(jv.encode_images(params, cj, jnp.asarray(px)))
    got = tv.encode_images(port, torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


# -- loaders ---------------------------------------------------------------- #


def _assert_tower_equal(port, tree):
    for name, t in port.top._parameters.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(tree[name]), err_msg=name)
    for name in port.layers[0]._parameters:
        for i, lp in enumerate(port.layers):
            np.testing.assert_array_equal(lp.get(name).numpy(),
                                          np.asarray(tree["layers"][name][i]),
                                          err_msg=f"{name}[{i}]")


def _assert_llm_equal(llm, tree):
    np.testing.assert_array_equal(llm.embed.numpy(), np.asarray(tree["embed"]))
    np.testing.assert_array_equal(llm.final_norm.numpy(), np.asarray(tree["final_norm"]))
    if llm.lm_head is not None:
        np.testing.assert_array_equal(llm.lm_head.numpy(), np.asarray(tree["lm_head"]))
    for name, stacked in tree["layers"].items():
        for i, layer in enumerate(llm.layers):
            np.testing.assert_array_equal(getattr(layer, name).numpy(),
                                          np.asarray(stacked[i]), err_msg=name)


def test_load_vlm_golden_llava():
    from dynamo_tpu.models.vlm import load_vlm as jax_load_vlm
    from dynamo_tpu_torch.models.llama import KVCache
    from dynamo_tpu_torch.models.vlm import load_vlm

    jllm, jcfg, jvp, jvcfg = jax_load_vlm(LLAVA_DIR, dtype=jnp.float32)
    llm, cfg, tower, vcfg = load_vlm(LLAVA_DIR, dtype=torch.float32, device="cpu")
    assert vcfg.__dict__ == jvcfg.__dict__
    _assert_llm_equal(llm, jllm)
    _assert_tower_equal(tower, jvp)
    data = np.load(os.path.join(LLAVA_DIR, "golden_logits.npz"))
    prompt, off = data["prompt"].tolist(), int(data["image_offset"])
    emb = tv.encode_images(tower, torch.from_numpy(
        data["pixels"].transpose(0, 2, 3, 1).copy()))
    S, P = len(prompt), emb.shape[1]
    extra = torch.zeros((1, S, cfg.hidden_size))
    mask = torch.zeros((1, S), dtype=torch.bool)
    extra[0, off:off + P], mask[0, off:off + P] = emb[0], True
    pages = S // 8 + 2
    kv = KVCache.create(cfg, pages + 1, 8, torch.float32, "cpu")
    table = torch.arange(1, pages + 1, dtype=torch.int32)[None]
    got = llm.forward_prefill(kv, torch.tensor([prompt]), table,
                              torch.zeros(1, dtype=torch.int32),
                              torch.tensor([S], dtype=torch.int32), extra, mask)[0]
    want = data["last_logits"]
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
    assert int(got.argmax()) == int(want.argmax())


def _hf_qwen_vl(v25: bool):
    """A tiny HF Qwen2-VL (or 2.5-VL) with seeded random weights."""
    torch.manual_seed(3 if v25 else 2)
    common = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
                  image_token_id=5, video_token_id=6, vision_start_token_id=3,
                  vision_end_token_id=4,
                  rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]})
    if v25:
        from transformers.models.qwen2_5_vl import modeling_qwen2_5_vl as m
        from transformers.models.qwen2_5_vl.configuration_qwen2_5_vl import (
            Qwen2_5_VLConfig as Config)

        vision = dict(depth=2, hidden_size=32, out_hidden_size=64, num_heads=2,
                      intermediate_size=48, in_channels=3, patch_size=4,
                      temporal_patch_size=2, spatial_merge_size=2, window_size=16,
                      fullatt_block_indexes=[1])
        cls, mt = m.Qwen2_5_VLForConditionalGeneration, "qwen2_5_vl"
    else:
        from transformers.models.qwen2_vl import modeling_qwen2_vl as m
        from transformers.models.qwen2_vl.configuration_qwen2_vl import (
            Qwen2VLConfig as Config)

        vision = dict(depth=2, embed_dim=32, num_heads=2, mlp_ratio=2.0,
                      in_channels=3, patch_size=4, temporal_patch_size=2,
                      spatial_merge_size=2, hidden_size=64)
        cls, mt = m.Qwen2VLForConditionalGeneration, "qwen2_vl"
    hf_cfg = Config(**common, vision_config=vision)
    return cls(hf_cfg).eval().float(), hf_cfg, mt


@pytest.mark.parametrize("layout", ["published", "nested"])
@pytest.mark.parametrize("v25", [False, True], ids=["2.0", "2.5"])
def test_load_qwen_vl_round_trip(tmp_path, v25, layout):
    import json

    from safetensors.numpy import save_file

    from dynamo_tpu.models.vlm import load_qwen_vl as jax_load_qwen_vl
    from dynamo_tpu.testing import export_vl_state_dict
    from dynamo_tpu_torch.models.vlm import load_qwen_vl

    model, hf_cfg, mt = _hf_qwen_vl(v25)
    if layout == "published":
        tensors = export_vl_state_dict(model)
    else:
        tensors = {k: np.ascontiguousarray(v.detach().numpy(), np.float32)
                   for k, v in model.state_dict().items()}
    save_file(tensors, os.path.join(tmp_path, "model.safetensors"))
    d = hf_cfg.to_dict()
    d["model_type"] = mt
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump(d, f)
    jllm, jcfg, jvp, jvcfg = jax_load_qwen_vl(str(tmp_path), dtype=jnp.float32)
    llm, cfg, tower, vcfg = load_qwen_vl(str(tmp_path), dtype=torch.float32,
                                         device="cpu")
    assert cfg.mrope_section == jcfg.mrope_section == (2, 3, 3)
    assert vcfg.__dict__ == jvcfg.__dict__
    _assert_llm_equal(llm, jllm)
    _assert_tower_equal(tower, jvp)


def test_load_refusals(tmp_path):
    import json
    import shutil

    from dynamo_tpu_torch.models.vlm import load_vlm

    d = os.path.join(tmp_path, "llava")
    shutil.copytree(LLAVA_DIR, d)
    with open(os.path.join(d, "config.json")) as f:
        cfg = json.load(f)
    cfg["vision_feature_select_strategy"] = "full"
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match="vision_feature_select_strategy"):
        load_vlm(d, dtype=torch.float32, device="cpu")


# -- preprocessors ---------------------------------------------------------- #


def _png_uri(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


@pytest.mark.parametrize("arch", ["qwen2_vl", "clip"])
def test_preprocessor_requests_equal_jax(arch):
    from dynamo_tpu.llm import ModelDeploymentCard as JaxCard
    from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as JaxPre
    from dynamo_tpu.testing import tiny_tokenizer as jax_tok
    from dynamo_tpu_torch.llm import ModelDeploymentCard, OpenAIPreprocessor
    from dynamo_tpu_torch.testing import tiny_tokenizer

    tok = jax_tok()
    fields = dict(name="tiny-vl", tokenizer_json=tok.to_json_str(), eos_token_ids=[],
                  image_token="<image>", image_token_id=tok.encode("<image>")[0])
    if arch == "qwen2_vl":
        fields.update(mm_arch="qwen2_vl", mm_config=dict(
            depth=2, embed_dim=32, num_heads=2, patch_size=4, temporal_patch_size=2,
            spatial_merge_size=2, hidden_size=64, min_pixels=64, max_pixels=4096))
    else:
        fields.update(mm_arch="clip", image_patches=16, image_size=32)
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)  # resized both ways
    b = rng.integers(0, 256, (90, 20, 3), dtype=np.uint8)
    req = {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "look "},
        {"type": "image_url", "image_url": {"url": _png_uri(a)}},
        {"type": "text", "text": " and "},
        {"type": "image_url", "image_url": {"url": _png_uri(b)}}]}]}
    want = JaxPre(JaxCard(**fields), tok).preprocess_chat(req)
    got = OpenAIPreprocessor(ModelDeploymentCard(**fields),
                             tiny_tokenizer()).preprocess_chat(req)
    assert got["token_ids"] == want["token_ids"]
    for key in ("mm_offsets", "cache_salt", "mm_pixels", "mm_patches"):
        assert got.get(key) == want.get(key), key
