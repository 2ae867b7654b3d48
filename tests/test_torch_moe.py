"""The port's MoE (dynamo_tpu_torch.models.llama `moe_act`,
`moe_router_logits`, `_moe_dense`, `_moe_ragged`, `_moe_capacity`, and
the grouped GEMM's plain version in `ops/moe.py`) against the JAX
package's functions on the same numpy inputs, on the CPU:

- `moe_act` (silu and gpt-oss's clamped GLU) and the f32 router logits
  within 1e-6;
- top-k ties resolved to the lower expert index, as `jax.lax.top_k`;
- each dispatch on `tiny_moe_config` and on a gpt-oss-like config against
  its JAX counterpart within 1e-5 (f32);
- `grouped_gemm_plain` against `jax.lax.ragged_dot` with empty groups,
  one group holding every row, and bf16 inputs (f32 sums of exact
  products: 1e-5 relative);
- a token's ragged output is bit-equal whatever its batch-mates are (at
  a fixed batch shape, as the engine pads its decode rows).

The grouped GEMM kernel itself runs only on the card; `chip_smoke.py`
phase 3 holds it against `grouped_gemm_plain` there.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.ops import moe as tmoe

GPT_OSS_LIKE = dict(vocab_size=256, hidden_size=64, intermediate_size=96,
                    num_hidden_layers=1, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=16, num_experts=8,
                    num_experts_per_tok=4, moe_act="gpt_oss_glu", moe_bias=True,
                    attention_bias=True, attention_out_bias=True,
                    attention_sinks=True, model_type="gpt_oss")
CFGS = {"tiny_moe": {}, "gpt_oss_like": GPT_OSS_LIKE}


def _cfgs(name, **over):
    if name == "tiny_moe":
        return jcfg.tiny_moe_config(**over), tcfg.tiny_moe_config(**over)
    kw = {**CFGS[name], **over}
    return jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)


def _layer(name, **over):
    """(JAX layer-0 params, port layer 0, both configs)."""
    cfg_j, cfg_t = _cfgs(name, **over)
    params = jl.init_params(cfg_j, jax.random.PRNGKey(1), dtype=jnp.float32)
    model = tl.params_from_jax(cfg_t, jax.tree.map(np.asarray, params),
                               device="cpu")
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    return lp, model.layers[0], cfg_j, cfg_t


def _x(cfg, B=2, S=7, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.hidden_size)).astype(np.float32)


@pytest.mark.parametrize("act", ["silu", "gpt_oss_glu"])
def test_moe_act_matches_jax(act):
    rng = np.random.default_rng(0)
    gate = (rng.normal(size=(5, 33)) * 6).astype(np.float32)
    up = (rng.normal(size=(5, 33)) * 6).astype(np.float32)
    cfg_j, cfg_t = _cfgs("tiny_moe", moe_act=act)
    want = jl.moe_act(cfg_j, jnp.asarray(gate), jnp.asarray(up))
    got = tl.moe_act(cfg_t, torch.from_numpy(gate), torch.from_numpy(up))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_router_logits_f32_match_jax(name):
    lp, layer, cfg_j, _ = _layer(name)
    x = _x(cfg_j)
    want = jl.moe_router_logits(lp, jnp.asarray(x), "bsh,he->bse")
    got = tl.moe_router_logits(layer, torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    # bf16 activations and router: still f32 logits of exact products
    xb = x.astype(ml_dtypes.bfloat16)
    want = jl.moe_router_logits(
        jax.tree.map(lambda a: a.astype(jnp.bfloat16), lp), jnp.asarray(xb),
        "bsh,he->bse")
    for key in ("router", "router_b"):
        t = getattr(layer, key)
        if t is not None:
            t.data = t.data.to(torch.bfloat16).float()
    got = tl.moe_router_logits(layer, torch.from_numpy(xb.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_top_k_ties_take_the_lower_index():
    logits = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 2.0],
                       [5.0, 5.0, 5.0, 5.0, 5.0, 5.0]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(logits), 3)
    gv, gi = tl._top_k(torch.from_numpy(logits), 3)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("impl", ["dense", "ragged", "capacity"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_moe_dispatch_matches_jax(name, impl):
    over = {"moe_capacity_factor": 1.0} if impl == "capacity" else {}
    lp, layer, cfg_j, cfg_t = _layer(name, **over)
    x = _x(cfg_j, B=3, S=11)
    want = getattr(jl, f"_moe_{impl}")(lp, jnp.asarray(x), cfg_j)
    got = getattr(tl, f"_moe_{impl}")(layer, torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    if impl != "capacity":  # a capacity of 1.0 drops assignments
        dense = tl._moe_dense(layer, torch.from_numpy(x), cfg_t)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5, rtol=1e-5)


def _ragged_case(sizes, K=40, N=24, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    A, E = sum(sizes), len(sizes)
    xs = rng.normal(size=(A, K)).astype(dtype)
    w = (rng.normal(size=(E, K, N)) / np.sqrt(K)).astype(dtype)
    return xs, w, np.asarray(sizes, np.int32)


def _as_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("sizes,dtype", [
    ([3, 0, 5, 1, 0, 7], np.float32),
    ([0, 0, 16, 0], np.float32),
    ([2, 9, 0, 4, 4], ml_dtypes.bfloat16),
], ids=["empty_groups", "one_group_holds_all", "bf16"])
def test_grouped_gemm_plain_matches_ragged_dot(sizes, dtype):
    xs, w, gs = _ragged_case(sizes, dtype=dtype)
    want = jax.lax.ragged_dot(jnp.asarray(xs), jnp.asarray(w), jnp.asarray(gs),
                              preferred_element_type=jnp.float32)
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(gs)]).astype(np.int32))
    got = tmoe.grouped_gemm(_as_torch(xs), _as_torch(w), offs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("offs", [[0, 3, 2], [0, 2, 3]],
                         ids=["decreasing", "rows_past_the_last_group"])
def test_grouped_gemm_plain_refuses_bad_offsets(offs):
    """Offsets must not decrease and must cover every row: the kernel
    leaves rows past offs[E] unwritten, so its plain version refuses them
    rather than zero them as ``ragged_dot`` does."""
    xs, w, _ = _ragged_case([2, 2])
    with pytest.raises(ValueError):
        tmoe.grouped_gemm_plain(torch.from_numpy(xs), torch.from_numpy(w),
                                torch.tensor(offs, dtype=torch.int32))


def test_grouped_gemm_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only; it never runs the
    plain loop in the kernel's place."""
    xs, w, _ = _ragged_case([2, 2])
    with pytest.raises(ValueError, match="CUDA"):
        tmoe.grouped_gemm_cuda(torch.from_numpy(xs), torch.from_numpy(w),
                               torch.tensor([0, 2, 4], dtype=torch.int32))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_ragged_token_alone_equals_token_in_batch(name):
    """A token's ragged output does not depend on its batch-mates (what
    the engine's padded decode rows rely on): at the batch shape the
    engine fixes (decode rows padded to max_num_seqs), replacing every
    other row -- and with it the routing, the group sizes and the tile
    the token's row lands in -- leaves the token's output bit-equal."""
    _, layer, cfg_j, cfg_t = _layer(name)
    x = torch.from_numpy(_x(cfg_j, B=12, S=1, seed=3))
    batch = tl._moe_ragged(layer, x, cfg_t)
    for b in range(12):
        mates = torch.from_numpy(_x(cfg_j, B=12, S=1, seed=10 + b))
        mates[b] = x[b]
        alone = tl._moe_ragged(layer, mates, cfg_t)
        assert torch.equal(alone[b], batch[b]), b
