"""The port's checkpoint path on the CPU: its numpy safetensors reader
against the `safetensors` package, its `load_params` against the JAX
package's (mapped through `params_from_jax`, every tensor exactly equal,
single file and a two-shard index), and the golden anchor: the port's
paged forward on the committed transformers checkpoints within the
tolerance `tests/test_golden.py` holds the JAX forward to."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import ModelConfig as JaxModelConfig
from dynamo_tpu.models import init_params as jax_init_params
from dynamo_tpu.models import tiny_config as jax_tiny_config
from dynamo_tpu.models.loader import load_params as jax_load_params
from dynamo_tpu_torch.models import KVCache, ModelConfig, params_from_jax
from dynamo_tpu_torch.models.loader import load_params
from dynamo_tpu_torch.models.safetensors_np import load_file, safe_open

safetensors_np = pytest.importorskip("safetensors.numpy")

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
GOLDEN = {"golden_llama": os.path.join(FIXDIR, "golden_llama"),
          "torch_golden_llama_hd64": os.path.join(FIXDIR, "torch_golden_llama_hd64")}
ATOL, RTOL = 2e-4, 2e-4
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_reader_equals_safetensors(name):
    path = os.path.join(GOLDEN[name], "model.safetensors")
    want = safetensors_np.load_file(path)
    got = load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


def test_reader_widens_bf16_exactly(tmp_path):
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(5)
    tensors = {"a.bf16": torch.randn(3, 7, generator=g).to(torch.bfloat16),
               "b.f16": torch.randn(4, generator=g).to(torch.float16),
               "c.i64": torch.arange(-3, 9, dtype=torch.int64).reshape(3, 4),
               "d.i32": torch.arange(5, dtype=torch.int32)}
    path = str(tmp_path / "mixed.safetensors")
    save_file(tensors, path)
    with safe_open(path) as f:
        assert f.keys() == sorted(tensors)
        for k, t in tensors.items():
            got = f.get_tensor(k)
            want = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want), k


def _assert_model_equal(got, want):
    for (n, a), (m, b) in zip(got.named_parameters(), want.named_parameters()):
        assert n == m and a.dtype == b.dtype, (n, a.dtype, b.dtype)
        assert torch.equal(a, b), n


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_load_params_equals_jax(name, dtype):
    tdt, jdt = DTYPES[dtype]
    path = GOLDEN[name]
    tree = jax_load_params(path, JaxModelConfig.from_pretrained(path), dtype=jdt)
    cfg = ModelConfig.from_pretrained(path)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, tree), dtype=tdt,
                           device="cpu")
    got = load_params(path, cfg, dtype=tdt, device="cpu")
    _assert_model_equal(got, want)


def test_two_shard_index_equals_jax(tmp_path):
    """fp16 projections + fp32 norms split over two shards with an index,
    as published checkpoints ship (tests/test_loader_shards.py)."""
    from test_loader_shards import _config_json, _export_hf_llama

    jcfg = jax_tiny_config(tie_word_embeddings=False)
    tensors = _export_hf_llama(jcfg, jax_init_params(
        jcfg, jax.random.PRNGKey(3), dtype=jnp.float32))
    names = sorted(tensors)
    weight_map = {}
    for i in range(2):
        fname = f"model-{i + 1:05d}-of-00002.safetensors"
        safetensors_np.save_file({n: tensors[n] for n in names[i::2]},
                                 str(tmp_path / fname))
        weight_map.update({n: fname for n in names[i::2]})
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(_config_json(jcfg), f)
    for tdt, jdt in DTYPES.values():
        tree = jax_load_params(str(tmp_path), JaxModelConfig.from_pretrained(
            str(tmp_path)), dtype=jdt)
        cfg = ModelConfig.from_pretrained(str(tmp_path))
        want = params_from_jax(cfg, jax.tree.map(np.asarray, tree), dtype=tdt,
                               device="cpu")
        _assert_model_equal(load_params(str(tmp_path), cfg, dtype=tdt,
                                        device="cpu"), want)


def test_refuses_what_the_model_does_not_take(tmp_path):
    """A config that asks for tensors the checkpoint lacks (attention
    biases, sinks) is refused by both loaders, with the same error; an
    M-RoPE config needs no tensors of its own, and both take it (the port
    since the vision slice)."""
    path = GOLDEN["golden_llama"]
    with open(os.path.join(path, "config.json")) as f:
        d = json.load(f)
    for over, match in (({"attention_bias": True}, "declares attention_bias"),
                        ({"attention_sinks": True}, "declares attention_sinks")):
        with pytest.raises(ValueError, match=match):
            jax_load_params(path, JaxModelConfig.from_hf_config({**d, **over}),
                            dtype=jnp.float32)
        with pytest.raises(ValueError, match=match):
            load_params(path, ModelConfig.from_hf_config({**d, **over}),
                        dtype=torch.float32, device="cpu")
    mrope = {"rope_scaling": {"type": "mrope", "mrope_section": [2, 3, 3]}}
    jax_load_params(path, JaxModelConfig.from_hf_config({**d, **mrope}),
                    dtype=jnp.float32)
    model = load_params(path, ModelConfig.from_hf_config({**d, **mrope}),
                        dtype=torch.float32, device="cpu")
    assert model.cfg.mrope_section == (2, 3, 3) and model.mrope_sec is not None


def run_steps(model, cfg, prompt, feed, page_size=8):
    """Prefill logits, then one decode step per `feed` token, over the
    paged pool (the path `tests/test_golden.py` anchors)."""
    dev = model.device
    n_pages = (len(prompt) + len(feed)) // page_size + 2
    kv = KVCache.create(cfg, 1 + n_pages, page_size, model.dtype, dev)
    table = torch.arange(1, 1 + n_pages, dtype=torch.int32, device=dev)[None]
    S = len(prompt)
    i32 = dict(dtype=torch.int32, device=dev)
    outs = [model.forward_prefill(kv, torch.tensor([prompt], device=dev), table,
                                  torch.zeros(1, **i32), torch.tensor([S], **i32))[0]]
    for pos, tok in enumerate(feed, start=S):
        outs.append(model.forward_decode(kv, torch.tensor([tok], device=dev),
                                         torch.tensor([pos], device=dev), table)[0])
    return torch.stack(outs).float().cpu().numpy()


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_anchor(name):
    path = GOLDEN[name]
    cfg = ModelConfig.from_pretrained(path)
    model = load_params(path, cfg, dtype=torch.float32, device="cpu")
    data = np.load(os.path.join(path, "golden_logits.npz"))
    for i in range(2):
        golden = data[f"logits{i}"]
        greedy = data[f"greedy{i}"].tolist()
        got = run_steps(model, cfg, data[f"prompt{i}"].tolist(), greedy[:-1])
        assert got.shape == golden.shape
        np.testing.assert_allclose(got, golden, atol=ATOL, rtol=RTOL)
        assert got.argmax(-1).tolist() == golden.argmax(-1).tolist() == greedy
