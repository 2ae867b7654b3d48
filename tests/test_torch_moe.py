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
  products: 1e-5 relative), and with a bias against JAX's down product
  plus ``b_down[expert_sorted]``;
- `grouped_glu_plain` against ``moe_act(ragged_dot + b_gate, ragged_dot +
  b_up).astype(dt)``, as `_moe_ragged` computes it, for both activations,
  with and without biases: f32 within 1e-5, bf16 within one bf16 ulp of
  JAX's value (the two round f32 sums taken in other orders);
- the kernels' wrappers refusing CPU tensors, and their tiling rules
  depending on the weight's shape only;
- a token's ragged output is bit-equal whatever its batch-mates are (at
  a fixed batch shape, as the engine pads its decode rows).

The grouped kernels themselves run only on the card; `chip_smoke.py`
phase 3 holds them against `grouped_gemm_plain` and `grouped_glu_plain`
there.
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


def _ragged_jax(xs, w, gs, b=None):
    """JAX's grouped product as `_moe_ragged` takes it: ragged_dot in f32,
    then the bias of each row's expert."""
    out = jax.lax.ragged_dot(jnp.asarray(xs), jnp.asarray(w), jnp.asarray(gs),
                             preferred_element_type=jnp.float32)
    if b is not None:
        out = out + jnp.asarray(b)[jnp.repeat(jnp.arange(len(gs)), gs,
                                              total_repeat_length=xs.shape[0])]
    return out


def _offs(gs):
    return torch.from_numpy(np.concatenate([[0], np.cumsum(gs)]).astype(np.int32))


def _bf16_ulp(v):
    """One bf16 ulp at each value (2^-7 of its power of two)."""
    a = np.abs(v).astype(np.float64)
    return np.where(a > 0, np.exp2(np.floor(np.log2(np.maximum(a, 1e-30))) - 7), 0.0)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
def test_grouped_gemm_plain_with_bias_matches_jax_down(dtype):
    """The down product with ``b_down``: the bias of each row's expert
    added to the f32 sums, as JAX's ``ys + b_down[expert_sorted]``."""
    sizes = [3, 0, 5, 1, 0, 7]
    xs, w, gs = _ragged_case(sizes, dtype=dtype)
    b = np.random.default_rng(4).normal(size=(len(sizes), w.shape[2])).astype(dtype)
    want = _ragged_jax(xs, w, gs, b)
    got = tmoe.grouped_gemm(_as_torch(xs), _as_torch(w), _offs(gs), _as_torch(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("act", ["silu", "gpt_oss_glu"])
def test_grouped_glu_plain_matches_jax(act, bias, dtype):
    """The fused gate||up's plain version against JAX's two ragged_dots,
    their biases, `moe_act` and the cast.  The weights are scaled so the
    gpt-oss clamps (gate <= 7, |up| <= 7) bind on part of the values."""
    sizes = [4, 0, 9, 1, 0, 6]
    rng = np.random.default_rng(7)
    A, E, K, N = sum(sizes), len(sizes), 40, 24
    xs = rng.normal(size=(A, K)).astype(dtype)
    wg, wu = ((rng.normal(size=(E, K, N)) * 5 / np.sqrt(K)).astype(dtype)
              for _ in range(2))
    bg, bu = ((rng.normal(size=(E, N)).astype(dtype) if bias else None)
              for _ in range(2))
    gs = np.asarray(sizes, np.int32)
    cfg_j, _ = _cfgs("tiny_moe", moe_act=act)
    gate, up = _ragged_jax(xs, wg, gs, bg), _ragged_jax(xs, wu, gs, bu)
    assert float(jnp.max(gate)) > 7 and float(jnp.min(up)) < -7
    want = np.asarray(jl.moe_act(cfg_j, gate, up).astype(jnp.asarray(xs).dtype),
                      np.float32)
    t = (lambda a: None if a is None else _as_torch(a))
    got = tmoe.grouped_glu(_as_torch(xs), _as_torch(wg), _as_torch(wu), t(bg),
                           t(bu), _offs(gs), act)
    assert got.dtype == _as_torch(xs).dtype and got.shape == (A, N)
    got = got.float().numpy()
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want) + 1e-6)


def test_grouped_glu_cuda_wrapper_refuses_cpu_tensors():
    """The fused kernel's wrapper takes CUDA tensors only."""
    xs, w, _ = _ragged_case([2, 2])
    with pytest.raises(ValueError, match="CUDA"):
        tmoe.grouped_glu_cuda(torch.from_numpy(xs), torch.from_numpy(w),
                              torch.from_numpy(w), None, None,
                              torch.tensor([0, 2, 4], dtype=torch.int32), "silu")


@pytest.mark.parametrize("E,K,N,slices", [(1, 2880, 32, 15), (32, 2880, 2880, 1),
                                          (132, 64, 24, 1), (1, 200, 8, 2)],
                         ids=["router", "experts", "many_small_experts",
                              "tiny_router"])
def test_k_slices_depend_on_the_weight_only(E, K, N, slices):
    """Split-K where E * ceil(N / 128) output tiles cannot fill 132 SMs:
    slices of three 64-deep K tiles; the row count never enters, so a
    row's sum order is the same in every batch."""
    assert tmoe.k_slices(E, K, N) == slices


@pytest.mark.parametrize("A,E,rows", [(32, 32, 64), (1535, 32, 64), (1536, 32, 128),
                                      (8, 1, 64), (512, 1, 128)])
def test_tile_rows_per_average_group(A, E, rows):
    """64-row tiles at decode, 128 once the average group reaches 48 rows
    (an expert's weights then stream once per 128 rows)."""
    assert tmoe.tile_rows(A, E) == rows
