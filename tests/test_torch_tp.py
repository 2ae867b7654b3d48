"""Tensor parallelism of the port (`dynamo_tpu_torch/parallel/`, the
tp-aware `Llama`): the group's configuration and refusals, every leaf's
shard axis against JAX's `param_pspecs` / `quantize_pspecs` /
`kv_cache_pspec`, and a tp-2 forward on a CPU gloo group of two spawned
processes against JAX's sharded run on two virtual CPU devices
(`tests/test_parallel.py::test_tp_sharded_prefill_matches_single_device`,
rtol = atol = 2e-4 as there).  The engine over such a group is
`tests/test_torch_tp_engine.py`."""

import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.quantization import quantize_params as jax_quantize
from dynamo_tpu.models.quantization import quantize_pspecs
from dynamo_tpu.parallel import make_mesh as jax_make_mesh
from dynamo_tpu.parallel import shard_kv_cache, shard_params as jax_shard_params
from dynamo_tpu.parallel import ParallelConfig as JaxParallelConfig
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.parallel import (
    ParallelConfig,
    SeededShards,
    TreeShards,
    check_ported,
    kv_shard_heads,
    make_mesh,
    param_shard_axes,
    shard_params,
)
from dynamo_tpu_torch.parallel.mesh import choose_backend, free_port, group_devices
from dynamo_tpu_torch.parallel.sharding import (
    KV_HEAD_AXIS,
    TOP_AXES,
    quant_shard_axes,
    save_tree,
)

TP = 2
JOIN_S = 120
# a gpt-oss-shaped tiny config: q/k/v and o biases, sinks, sliding windows
# on alternate layers, 8 biased clamped-GLU experts (4 a rank)
GPT_OSS = dict(
    vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=4,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16,
    max_position_embeddings=512, sliding_window=8,
    layer_types=("sliding_attention", "full_attention") * 2,
    attention_bias=True, attention_out_bias=True, attention_sinks=True,
    num_experts=8, num_experts_per_tok=2, moe_act="gpt_oss_glu", moe_bias=True,
    model_type="gpt_oss", name="tiny-gpt-oss")
CONFIGS = {
    "dense": lambda m: m.tiny_config(),
    "moe": lambda m: m.tiny_moe_config(),
    "gpt_oss": lambda m: m.ModelConfig(**GPT_OSS),
}


def _configs(name):
    return CONFIGS[name](jcfg), CONFIGS[name](tcfg)


# --------------------------------------------------------------------------- #
# ParallelConfig and the group's refusals
# --------------------------------------------------------------------------- #


def test_parallel_config_validation():
    """`tests/test_parallel.py::test_mesh_construction`'s checks on the
    port's copy of the dataclass, and the degrees this slice serves."""
    pcfg = ParallelConfig(dp=2, tp=4)
    assert pcfg.world == 8
    pcfg.validate(8)
    with pytest.raises(ValueError):
        ParallelConfig(dp=3, tp=2).validate(8)
    with pytest.raises(ValueError):
        ParallelConfig(pp=2, sp=2).validate(4)
    check_ported(ParallelConfig(tp=4))
    assert [str(d) for d in group_devices(ParallelConfig(tp=2), ["cpu"] * 2)] \
        == ["cpu", "cpu"]
    assert choose_backend([torch.device("cpu")] * 2) == "gloo"
    shared = [torch.device("cuda", 0)] * 2
    assert choose_backend(shared) == "gloo"
    assert choose_backend([torch.device("cuda", 0),
                           torch.device("cuda", 1)]) == "nccl"


@pytest.mark.parametrize("call, match", [
    # dp and sp are served (tests/test_torch_dp.py, tests/test_torch_sp.py;
    # match None: no refusal)
    (lambda: check_ported(ParallelConfig(dp=2, sp=2)), None),
    (lambda: check_ported(ParallelConfig(sp=2)), None),
    # pp is served (tests/test_torch_pp.py); pp with sp is still refused
    (lambda: ParallelConfig(pp=2, sp=2).validate(4),
     "pp composes with dp and tp"),
    (lambda: check_ported(ParallelConfig(tp=0)), "tp must be"),
    (lambda: choose_backend([torch.device("cuda", 0)] * 2, "nccl"),
     "nccl refuses two ranks on one device"),
    (lambda: choose_backend([torch.device("cpu")] * 2, "nccl"), "CPU"),
    (lambda: group_devices(ParallelConfig(tp=2), ["cpu", "cuda:0"]),
     "all cpu or all cuda"),
    (lambda: group_devices(ParallelConfig(tp=2), ["cpu"] * 3), "!= available"),
], ids=["dp", "sp", "pp", "tp0", "nccl_shared_card", "nccl_cpu", "mixed",
        "count"])
def test_group_refusals(call, match):
    if match is None:
        call()
        return
    with pytest.raises(ValueError, match=match):
        call()


def test_no_silent_collapse_onto_the_cpu():
    """Without named devices a group wants one card a rank: on a machine
    without cards it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        group_devices(ParallelConfig(tp=2))


@pytest.mark.parametrize("over, tp_cfg, match", [
    ({"kv_partition": True}, None, "kv_partition"),
    ({"fuse_projections": True}, None, "fuse_projections"),
    ({}, {"vocab_size": 255}, "vocab_size"),
    ({}, {"num_key_value_heads": 1, "num_attention_heads": 4}, "kv heads"),
    ({}, {"num_experts": 3}, "num_experts"),
    ({}, {"num_experts": 4, "moe_impl": "dense"}, "ragged"),
], ids=["kv_partition", "fuse_projections", "vocab", "kv_heads",
        "experts", "moe_impl"])
def test_engine_refusals(over, tp_cfg, match):
    """Each refusal raises before a follower is spawned."""
    cfg = tcfg.tiny_config(**(tp_cfg or {}))
    ecfg = EngineConfig(page_size=8, num_pages=32, max_model_len=64, **over)
    with pytest.raises(ValueError, match=match):
        TorchEngine(cfg, SeededShards(cfg, 0, "float32"), ecfg,
                    parallel=ParallelConfig(tp=TP), devices=["cpu"] * TP)


@pytest.mark.parametrize("kw, match", [
    ({"vision": "tiny"}, "vision"),
])
def test_engine_refuses_vision(kw, match):
    """Vision is served under tp since the tower moved to the leader (the
    refusal this case held is gone): a tp group with a tiny CLIP tower
    builds, the tower on the leader alone.  Its media chats against JAX's
    meshed engine: tests/test_torch_tp_vision.py."""
    import asyncio

    from dynamo_tpu_torch.models import vision as tv
    from dynamo_tpu_torch.testing import host_threads

    cfg = tcfg.tiny_config()
    vcfg = tv.tiny_vision_config(out_hidden_size=cfg.hidden_size)
    tower = tv.init_vision_params(vcfg, torch.Generator().manual_seed(1),
                                  device="cpu")
    assert kw["vision"] == "tiny" and match == "vision"

    async def reports(eng):
        try:
            return await eng.group_reports()
        finally:
            await eng.shutdown()

    with host_threads(1):
        eng = TorchEngine(cfg, SeededShards(cfg, 0, "float32"),
                          EngineConfig(page_size=8, num_pages=32, max_model_len=64),
                          parallel=ParallelConfig(tp=TP), devices=["cpu"] * TP,
                          vision=(tower, vcfg))
        got = asyncio.run(reports(eng))
    assert got[0]["tower_params"] == sum(p.numel() for p in tower.parameters())
    assert got[1]["tower_params"] == 0


@pytest.mark.parametrize("flags, match", [
    (["--tp", "2", "--dp-ranks", "2"], "--dp-ranks"),
    (["--tp", "2", "--encode-component", "encoder"], None),
    (["--tp", "2", "--vision", "tiny"], None),
], ids=["dp_ranks", "encode_component", "vision"])
def test_worker_refuses_with_tp(flags, match):
    """--dp-ranks stays refused with --tp (ROADMAP 2.2b.4); media under tp
    (a tower on the leader, or an encode worker's embeddings) are taken
    since vision moved to the leader (match None: no refusal)."""
    from dynamo_tpu_torch.worker.__main__ import build_parser, check_role

    args = build_parser().parse_args(["--control", "127.0.0.1:1", *flags])
    if match is None:
        check_role(args)
        return
    with pytest.raises(SystemExit, match=match):
        check_role(args)


@pytest.mark.parametrize("flags", [["--dp", "2", "--sp", "2"], ["--sp", "2"],
                                   ["--pp", "2", "--sp", "2"]],
                         ids=["dp", "sp", "pp"])
def test_worker_refuses_other_axes(flags):
    """``--sp`` is served, with ``--dp`` too (tests/test_torch_sp.py); pp
    with sp stays refused, with JAX's message (``--dp`` and ``--pp`` are
    served: tests/test_torch_dp_kv.py, tests/test_torch_pp.py)."""
    from dynamo_tpu_torch.worker.__main__ import build_parser, parallel_from_args

    args = build_parser().parse_args(["--control", "127.0.0.1:1", *flags,
                                      "--device", "cpu"])
    if "--pp" not in flags:
        pcfg, devs = parallel_from_args(args)
        assert (pcfg.dp, pcfg.sp) == (args.dp, 2)
        assert devs == ["cpu"] * pcfg.world
        return
    with pytest.raises(ValueError, match="pp composes with dp and tp"):
        parallel_from_args(args)


def test_worker_tp_devices():
    from dynamo_tpu_torch.worker.__main__ import build_parser, parallel_from_args

    parse = build_parser().parse_args
    pcfg, devs = parallel_from_args(parse(["--control", "h:1", "--tp", "2",
                                           "--device", "cpu"]))
    assert pcfg.tp == 2 and devs == ["cpu", "cpu"]
    _, devs = parallel_from_args(parse(["--control", "h:1", "--tp", "2",
                                        "--tp-devices", "cuda:0,cuda:0"]))
    assert devs == ["cuda:0", "cuda:0"]
    assert parallel_from_args(parse(["--control", "h:1"])) == (None, None)


# --------------------------------------------------------------------------- #
# shard axes against JAX's partition specs
# --------------------------------------------------------------------------- #


def _tp_axis(spec) -> int:
    parts = tuple(spec)
    return parts.index("tp") if "tp" in parts else None


def _jax_params(cfg_j, seed=0):
    return jl.init_params(cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_shard_axes_match_jax_pspecs(name):
    """Every per-layer leaf's axis is JAX's (less its layer axis); the
    top-level leaves and the KV pool too; the shards of a JAX tree
    concatenate back to it."""
    cfg_j, cfg_t = _configs(name)
    specs = jl.param_pspecs(cfg_j)
    axes = param_shard_axes(cfg_t)
    assert set(axes) == set(specs["layers"])
    for key, spec in specs["layers"].items():
        ax = _tp_axis(spec)
        assert axes[key] == (None if ax is None else ax - 1), key
    for key in ("embed", "final_norm", "lm_head"):
        if key in specs:
            assert TOP_AXES[key] == _tp_axis(specs[key]), key
    assert _tp_axis(jl.kv_cache_pspec().k) == KV_HEAD_AXIS

    tree = jax.tree.map(np.asarray, _jax_params(cfg_j))
    shards = [shard_params(tree, cfg_t, r, TP) for r in range(TP)]
    for key, leaf in tree["layers"].items():
        ax = axes[key]
        parts = [s["layers"][key] for s in shards]
        back = parts[0] if ax is None else np.concatenate(parts, axis=ax + 1)
        np.testing.assert_array_equal(back, leaf)
    np.testing.assert_array_equal(
        np.concatenate([s["embed"] for s in shards], 0), tree["embed"])


@pytest.mark.parametrize("name", ["dense", "gpt_oss"])
def test_int8_shard_axes_match_quantize_pspecs(name):
    """int8 ``{"q", "s"}`` leaves (a tied model's added head included):
    q like its weight, s on the weight's output axis, as JAX's
    `quantize_pspecs`; the shards concatenate back."""
    cfg_j, cfg_t = _configs(name)
    qtree = jax_quantize(_jax_params(cfg_j))
    specs = quantize_pspecs(qtree, jl.param_pspecs(cfg_j))
    axes = param_shard_axes(cfg_t)
    tree = jax.tree.map(np.asarray, qtree)
    shards = [shard_params(tree, cfg_t, r, TP) for r in range(TP)]
    quantized = [k for k, v in tree["layers"].items() if isinstance(v, dict)]
    assert quantized
    for key in quantized:
        want = quant_shard_axes(axes[key], 2)
        for part in ("q", "s"):
            ax = _tp_axis(specs["layers"][key][part])
            assert want[part] == (None if ax is None else ax - 1), (key, part)
            pieces = [s["layers"][key][part] for s in shards]
            back = (pieces[0] if want[part] is None
                    else np.concatenate(pieces, axis=want[part] + 1))
            np.testing.assert_array_equal(back, tree["layers"][key][part])
    head = specs["lm_head"]
    assert _tp_axis(head["q"]) == 1 and _tp_axis(head["s"]) == 0
    for part, ax in (("q", 1), ("s", 0)):
        np.testing.assert_array_equal(
            np.concatenate([s["lm_head"][part] for s in shards], ax),
            tree["lm_head"][part])


def test_seeded_shards_are_the_flat_models_slices():
    """`init_params` at (rank, tp) keeps the flat model's values: its
    shards concatenate back to the seed's flat model."""
    cfg = tcfg.ModelConfig(**GPT_OSS)
    flat = tl.init_params(cfg, torch.Generator().manual_seed(5),
                          dtype=torch.float32, device="cpu")
    shards = [tl.init_params(cfg, torch.Generator().manual_seed(5),
                             dtype=torch.float32, device="cpu", rank=r, tp=TP)
              for r in range(TP)]
    axes = param_shard_axes(cfg)
    for i, layer in enumerate(flat.layers):
        for key, ax in axes.items():
            parts = [getattr(s.layers[i], key) for s in shards]
            back = parts[0] if ax is None else torch.cat(parts, ax)
            assert torch.equal(back, getattr(layer, key)), key
    assert torch.equal(torch.cat([s.embed for s in shards]), flat.embed)
    assert torch.equal(torch.cat([s.lm_head for s in shards], 1), flat.lm_head)
    # rank r holds the kv heads its q heads read: the columns of wk are
    # kv_shard_heads(r)'s heads, and its q heads' groups map onto them
    hd, nkv = cfg.head_dim_, cfg.num_key_value_heads
    group = cfg.num_attention_heads // nkv
    for r, s in enumerate(shards):
        heads = kv_shard_heads(nkv, r, TP)
        cols = torch.cat([flat.layers[0].wk[:, h * hd:(h + 1) * hd] for h in heads], 1)
        assert torch.equal(s.layers[0].wk, cols)
        q_heads = range(r * cfg.num_attention_heads // TP,
                        (r + 1) * cfg.num_attention_heads // TP)
        assert sorted({h // group for h in q_heads}) == list(heads)


# --------------------------------------------------------------------------- #
# a tp-2 forward on a gloo group against JAX's sharded forward
# --------------------------------------------------------------------------- #


def _rank_main(fn, rank, init, q, args):
    try:
        q.put((rank, fn(rank, init, *args)))
    except BaseException as e:  # noqa: BLE001 — the test reads the error
        q.put((rank, e))


def _on_ranks(fn, *args):
    """fn(rank, init_method, *args) on TP spawned processes of one gloo
    group; returns rank 0's result."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(fn, r, init, q, args),
                         daemon=True) for r in range(TP)]
    for p in procs:
        p.start()
    try:
        got = dict(q.get(timeout=JOIN_S) for _ in procs)
    finally:
        for p in procs:
            p.join(JOIN_S)
            if p.is_alive():
                p.terminate()
    assert not any(p.is_alive() for p in procs)
    for r, v in got.items():
        if isinstance(v, BaseException):
            raise AssertionError(f"rank {r} failed") from v
    return got[0]


def _forward_rank(rank, init, cfg, path, tokens, table, nxt, S):
    group = make_mesh(ParallelConfig(tp=TP), ["cpu"] * TP, rank=rank,
                      init_method=init)
    try:
        model = TreeShards(cfg, path)(rank, TP, group.device)
        model.attach_group(group)
        B = tokens.shape[0]
        kv = tl.KVCache.create(cfg, 1 + table.size, 8, torch.float32, "cpu",
                               tp=TP)
        t = torch.from_numpy
        logits = model.forward_prefill(
            kv, t(tokens), t(table), torch.zeros(B, dtype=torch.int32),
            torch.full((B,), S, dtype=torch.int32))
        out2 = model.forward_decode(kv, t(nxt), torch.full((B,), S), t(table))
        return logits.numpy(), out2.numpy()
    finally:
        group.close()


@pytest.mark.parametrize("name", ["dense", "gpt_oss"])
def test_tp_forward_matches_jax_sharded(name, tmp_path):
    """A chunk of 16 tokens, then one decode step, on a tp-2 group
    against JAX's forward on a (dp 1, tp 2) mesh of virtual CPU devices;
    the decode step's tokens are JAX's argmax on both sides."""
    cfg_j, cfg_t = _configs(name)
    params = _jax_params(cfg_j)
    B, S, page = 2, 16, 8
    pages = S // page + 1
    tokens = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                cfg_j.vocab_size)
    table = jnp.arange(1, 1 + B * pages, dtype=jnp.int32).reshape(B, pages)

    def run(p, kv):
        logits, kv = jl.forward_prefill(p, cfg_j, kv, tokens, table,
                                        jnp.zeros(B, jnp.int32),
                                        jnp.full((B,), S, jnp.int32))
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        out2, _ = jl.forward_decode(p, cfg_j, kv, nxt,
                                    jnp.full((B,), S, jnp.int32), table)
        return logits, out2, nxt

    mesh = jax_make_mesh(JaxParallelConfig(tp=TP), jax.devices()[:TP])
    with mesh:
        ref = jax.jit(run)(jax_shard_params(params, cfg_j, mesh),
                           shard_kv_cache(jl.KVCache.create(
                               cfg_j, 1 + B * pages, page, jnp.float32), mesh))
    ref_logits, ref2, nxt = (np.asarray(a) for a in ref)
    path = str(tmp_path / "tree.npz")
    save_tree(path, jax.tree.map(np.asarray, params))
    got_logits, got2 = _on_ranks(_forward_rank, cfg_t, path, np.asarray(tokens),
                                 np.asarray(table), nxt.astype(np.int64), S)
    np.testing.assert_allclose(got_logits, ref_logits, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got2, ref2, rtol=2e-4, atol=2e-4)



def test_shard_model_of_a_loaded_model():
    """`shard_model` (a checkpoint's `CheckpointShards`): the shards of a
    flat model concatenate back to it."""
    cfg = tcfg.tiny_config()
    flat = tl.init_params(cfg, torch.Generator().manual_seed(2),
                          dtype=torch.float32, device="cpu")
    shards = [tl.shard_model(flat, r, TP, "cpu") for r in range(TP)]
    for key, ax in param_shard_axes(cfg).items():
        parts = [getattr(s.layers[1], key) for s in shards]
        back = parts[0] if ax is None else torch.cat(parts, ax)
        assert torch.equal(back, getattr(flat.layers[1], key)), key
    assert torch.equal(torch.cat([s.embed for s in shards]), flat.embed)
    assert torch.equal(torch.cat([s.lm_head for s in shards], 1), flat.lm_head)
    assert all(s.tp == TP and s.comm.rank == r for r, s in enumerate(shards))
