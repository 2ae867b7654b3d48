"""Disaggregated serving across tensor-parallel groups, and the head
windows of the KV re-page, against the JAX package on the CPU.

- `kv_repage_plain` with a head window: for every (tp_s, tp_d) in
  {1, 2, 4}^2 over 8 kv heads, each destination rank's launches
  (`head_windows`: one per source rank it overlaps) leave its pages equal,
  byte for byte, to JAX `device_repage` of the full-head pool sliced to
  that rank's heads;
- a tp 2 prefill group hands prompts to a flat decode engine and a flat
  prefill engine to a tp 2 decode group, over the colocated lane (the
  source's full-head export re-paged on the destination) and the host
  lane (full-head chunks, each rank scattering its heads), and a tp 2
  prefill group's inline KV blob to a tp 2 decode group (the port's
  version of tests/test_device_transfer.py
  `test_colocated_device_lane_reshards_across_meshes`: one tp group
  lives in a process at a time, so tp 2 -> tp 2 runs the source group,
  then the destination group): tokens equal to the JAX package's local
  run of each prompt, with page sizes 8 -> 16;
- what stays refused under tp names its roadmap item, and the worker
  takes ``--tp`` with the disagg roles, ``--kvbm`` and parking.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.disagg.device_transfer import device_repage as jax_device_repage
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import init_params as jax_init_params
from dynamo_tpu.models import tiny_config as jax_tiny_config
from dynamo_tpu.models.llama import KVCache as JaxKVCache
from dynamo_tpu.runtime import Context as JaxContext
from dynamo_tpu_torch.disagg import KvTransferClient, KvTransferSource
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import params_from_jax, tiny_config
from dynamo_tpu_torch.ops import kv_transfer as kt
from dynamo_tpu_torch.parallel import ParallelConfig, SeededShards, TreeShards
from dynamo_tpu_torch.parallel import check_ported
from dynamo_tpu_torch.parallel.sharding import save_tree
from dynamo_tpu_torch.runtime import Context

TP = 2
L, N_KV, HD = 2, 8, 16


# -- the re-page at a head window ------------------------------------------- #


@pytest.mark.parametrize("tp_d", [1, 2, 4])
@pytest.mark.parametrize("tp_s", [1, 2, 4])
def test_windowed_repage_equals_jax_device_repage(tp_s, tp_d):
    rng = np.random.default_rng(10 * tp_s + tp_d)
    src_ps, dst_ps = (8, 16) if tp_s <= tp_d else (16, 8)
    prompt_len = 45
    n_src, n_dst = -(-prompt_len // src_ps), -(-prompt_len // dst_ps)
    P_s, P_d = n_src + 3, n_dst + 3
    k_full, v_full = (rng.standard_normal((L, P_s, src_ps, N_KV, HD))
                      .astype(np.float32) for _ in range(2))
    src_pages = [int(p) for p in rng.permutation(np.arange(1, P_s))[:n_src]]
    dst_pages = [int(p) for p in rng.permutation(np.arange(1, P_d))[:n_dst]]
    kj, vj = jax_device_repage(JaxKVCache(jnp.asarray(k_full), jnp.asarray(v_full)),
                               src_pages, src_ps, dst_ps, prompt_len,
                               jnp.float32)
    h_s, h_d = N_KV // tp_s, N_KV // tp_d
    # each source rank's pool holds its heads, as a tp_s group's ranks do
    src = [tuple(torch.from_numpy(np.ascontiguousarray(a[..., s * h_s:(s + 1) * h_s, :]))
                 for a in (k_full, v_full)) for s in range(tp_s)]
    for r in range(tp_d):
        dk = torch.full((L, P_d, dst_ps, h_d, HD), 7.0)
        dv = torch.full_like(dk, 7.0)
        windows = kt.head_windows(N_KV, tp_s, tp_d, r)
        assert len(windows) == max(1, tp_s // tp_d)
        assert sum(w[3] for w in windows) == h_d
        for s, src_head, dst_head, heads in windows:
            kt.kv_repage(*src[s], dk, dv, src_pages, dst_pages, prompt_len,
                         src_head=src_head, dst_head=dst_head, heads=heads)
        for got, want in ((dk, kj), (dv, vj)):
            np.testing.assert_array_equal(
                got[:, dst_pages].numpy(),
                np.asarray(want[:, :n_dst, :, r * h_d:(r + 1) * h_d]))
        rest = sorted(set(range(P_d)) - set(dst_pages))
        assert (dk[:, rest] == 7.0).all() and (dv[:, rest] == 7.0).all()


def test_repage_refuses_a_window_outside_the_rows():
    src = [torch.zeros(L, 4, 8, 4, HD) for _ in range(2)]
    dst = [torch.zeros(L, 4, 8, 2, HD) for _ in range(2)]
    with pytest.raises(ValueError, match="whole-row"):
        kt.kv_repage(*src, *dst, [1], [1], 5)
    with pytest.raises(ValueError, match="leaves the rows"):
        kt.kv_repage(*src, *dst, [1], [1], 5, src_head=3, dst_head=0, heads=2)
    with pytest.raises(ValueError, match="do not split"):
        kt.head_windows(8, 3, 2, 0)


# -- disagg across tp groups --------------------------------------------------- #


ECFG = dict(max_num_seqs=4, max_prefill_tokens=128, num_pages=128,
            max_model_len=256)
PROMPTS = [list(range(2, 39)), [(7 * j + 3) % 256 for j in range(70)]]
SRC_PS, DST_PS = 8, 16


def req(tokens, max_tokens=8):
    return {"token_ids": tokens, "sampling_options": {"temperature": 0.0},
            "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}


async def collect(gen):
    out = []
    async for d in gen:
        assert d.get("finish_reason") != "error", d
        out.extend(d.get("token_ids", []))
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(the port's flat model, the tp group's source, JAX's local tokens
    of each prompt)."""
    params = jax_init_params(jax_tiny_config(), jax.random.PRNGKey(0),
                             dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    path = str(tmp_path_factory.mktemp("tp_disagg") / "tree.npz")
    save_tree(path, tree)

    async def local():
        agg = JaxEngine(jax_tiny_config(), params,
                        JaxEngineConfig(page_size=DST_PS, **ECFG),
                        eos_token_ids=[], kv_dtype=jnp.float32)
        try:
            return [await collect(agg.generate(req(p), JaxContext()))
                    for p in PROMPTS]
        finally:
            await agg.shutdown()

    cfg = tiny_config()
    return (params_from_jax(cfg, tree, device="cpu"), TreeShards(cfg, path),
            asyncio.run(local()))


def engine(weights, tp, page_size):
    model, source, _ = weights
    ecfg = EngineConfig(page_size=page_size, **ECFG)
    if tp == 1:
        return TorchEngine(tiny_config(), model, ecfg, eos_token_ids=[],
                           device="cpu")
    return TorchEngine(tiny_config(), source, ecfg, eos_token_ids=[],
                       parallel=ParallelConfig(tp=tp), devices=["cpu"] * tp)


@pytest.mark.parametrize("lane", ["colocated", "host"])
@pytest.mark.parametrize("src_tp, dst_tp", [(2, 1), (1, 2)],
                         ids=["tp2_to_flat", "flat_to_tp2"])
async def test_disagg_across_tp_gives_jax_local_tokens(weights, src_tp, dst_tp,
                                                       lane):
    want = weights[2]
    src, dst = engine(weights, src_tp, SRC_PS), engine(weights, dst_tp, DST_PS)
    source = await KvTransferSource(src).start()
    client = KvTransferClient(dst, lanes=(lane,))
    got = []
    try:
        for p in PROMPTS:
            r = await src.prefill_remote(req(p), Context(),
                                         transfer_source=source)
            pages, stats = await client.fetch(r["kv_descriptor"])
            assert stats.lane == {"colocated": "device"}.get(lane, lane)
            got.append([r["token_ids"][0]] + (await collect(
                dst.generate_imported(req(p), r["token_ids"][0], pages,
                                      Context())))[1:])
        await asyncio.sleep(0.05)
        assert not source._held  # noqa: SLF001 — every hold released
    finally:
        await source.stop()
        await src.shutdown()
        await dst.shutdown()
    assert got == want


async def test_tp2_inline_kv_to_tp2_gives_jax_local_tokens(weights):
    """The source group's full-head blobs, then the destination group
    scattering each rank's heads (`generate_with_kv`)."""
    src = engine(weights, TP, SRC_PS)
    try:
        blobs = [await src.prefill_remote(req(p), Context()) for p in PROMPTS]
    finally:
        await src.shutdown()
    assert all(b["kv"]["shape"][3] == tiny_config().num_key_value_heads
               for b in blobs)
    dst = engine(weights, TP, SRC_PS)
    try:
        got = [await collect(dst.generate_with_kv(req(p), b["token_ids"][0],
                                                  b["kv"], Context()))
               for p, b in zip(PROMPTS, blobs)]
    finally:
        await dst.shutdown()
    assert got == weights[2]


# -- what stays refused, and what the worker now takes ------------------------- #


def _tp_engine(**over):
    cfg = tiny_config()
    return TorchEngine(cfg, SeededShards(cfg, 0, "float32"),
                       EngineConfig(page_size=8, num_pages=32, max_model_len=64,
                                    **over.pop("ecfg", {})),
                       parallel=ParallelConfig(tp=TP), devices=["cpu"] * TP,
                       **over)


def _vision_group():
    """A tp group with a tiny CLIP tower builds, the tower on its leader
    alone (vision under tp is served: tests/test_torch_tp_vision.py)."""
    from dynamo_tpu_torch.models import vision as tv
    from dynamo_tpu_torch.testing import host_threads

    vcfg = tv.tiny_vision_config(out_hidden_size=tiny_config().hidden_size)
    tower = tv.init_vision_params(vcfg, torch.Generator().manual_seed(1),
                                  device="cpu")

    async def reports(eng):
        try:
            return await eng.group_reports()
        finally:
            await eng.shutdown()

    with host_threads(1):
        got = asyncio.run(reports(_tp_engine(vision=(tower, vcfg))))
    assert [got[r]["tower_params"] > 0 for r in (0, 1)] == [True, False]


def _worker_check(*flags):
    from dynamo_tpu_torch.worker.__main__ import build_parser, check_role

    check_role(build_parser().parse_args(["--control", "127.0.0.1:1", *flags]))


@pytest.mark.parametrize("call, error, match", [
    # served since the tower moved to the leader (no error: it builds)
    (_vision_group, None, None),
    (lambda: _worker_check("--tp", "2", "--dp-ranks", "2"), SystemExit,
     "ROADMAP 2.2b.4"),
    # meshed dp is served (tests/test_torch_dp.py), and dp x sp x tp
    # (tests/test_torch_sp.py): no error
    (lambda: check_ported(ParallelConfig(dp=2, tp=2, sp=2)), None, None),
    # a partitioned pool needs dp replicas to partition over (JAX's message)
    (lambda: _tp_engine(ecfg={"kv_partition": True}), ValueError,
     r"kv_partition requires a serving mesh \(ParallelConfig with dp\*sp > 1\)"),
], ids=["vision", "dp_ranks", "meshed_dp", "kv_partition"])
def test_what_stays_refused_names_its_item(call, error, match):
    """Each refusal names its roadmap item; a case without an error is
    served now and must build."""
    if error is None:
        call()
        return
    with pytest.raises(error, match=match):
        call()


@pytest.mark.parametrize("flags", [
    ["--disagg-role", "prefill"], ["--disagg-role", "decode"], ["--kvbm"],
    ["--park-max-pages", "8"],
], ids=["prefill", "decode", "kvbm", "parking"])
def test_worker_takes_kv_moves_with_tp(flags):
    _worker_check("--tp", "2", "--device", "cpu", *flags)


@pytest.mark.parametrize("layers", [1, 8, 24])
def test_config_cut_to_a_depth_keeps_its_layer_types(layers):
    """`ModelConfig.with_depth` (the worker's ``--num-layers``) cuts the
    per-layer attention types with the layers: gpt-oss-20b's alternating
    windows at any depth are the full model's first ones."""
    from dynamo_tpu_torch.models import GPT_OSS_20B

    cut = GPT_OSS_20B.with_depth(layers)
    assert cut.num_hidden_layers == layers
    assert cut.layer_windows() == GPT_OSS_20B.layer_windows()[:layers]
    assert tiny_config().with_depth(1).layer_windows() == [0]
