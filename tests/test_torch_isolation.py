"""The port stands alone: importing dynamo_tpu_torch (every module), its
launchers and chip_smoke.py loads neither JAX nor the JAX package, nor any
of the packages the GPU machine lacks (aiohttp, msgpack, tokenizers,
safetensors, regex, prometheus_client, PIL); no module of the port imports
them; and the entry points refuse to run when there is no CUDA device and
the caller did not ask for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dynamo_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "dynamo_tpu", "aiohttp", "msgpack", "tokenizers",
             "safetensors", "regex", "prometheus_client", "PIL")
LAUNCHERS = ("run", "worker", "frontend", "runtime", "router")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_imports_load_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dynamo_tpu_torch\n"
        "for m in pkgutil.walk_packages(dynamo_tpu_torch.__path__, 'dynamo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in " + repr(LAUNCHERS) + ":\n"
        "    importlib.import_module(f'dynamo_tpu_torch.{m}.__main__')\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_source(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno, names)


def test_entry_points_refuse_without_cuda(monkeypatch):
    from dynamo_tpu_torch import resolve_device
    from dynamo_tpu_torch.engine import TorchEngine
    from dynamo_tpu_torch.models import (
        KVCache,
        Llama,
        ModelConfig,
        init_params,
        tiny_config,
    )
    from dynamo_tpu_torch.run.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    cfg = tiny_config()
    for make in (lambda: Llama(cfg, torch.float32),
                 lambda: KVCache.create(cfg, 4, 8, torch.float32),
                 lambda: init_params(cfg, torch.Generator(), torch.float32)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    model = init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                        device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(cfg, model)
    assert TorchEngine(cfg, model, device="cpu").device.type == "cpu"
    prompts = os.path.join(ROOT, "tests", "fixtures", "torch_prompts.jsonl")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--in", "batch", "--input-file", prompts])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--in", "http"])
    from dynamo_tpu_torch.models.loader import load_params
    from dynamo_tpu_torch.worker.__main__ import build_engine, build_parser

    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(build_parser().parse_args(["--control", "x:1"]))
    golden = os.path.join(ROOT, "tests", "fixtures", "torch_golden_llama_hd64")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_params(golden, ModelConfig.from_pretrained(golden), torch.float32)


DISAGG = ("router", "transfer", "device_transfer", "handler")


def test_disagg_modules_are_covered():
    """The disagg slice's modules are among the sources the import checks
    walk, and each imports none of the forbidden packages even lazily
    (inside a function): the AST walk above sees every import statement."""
    walked = {os.path.relpath(p, PKG) for p in _sources()}
    for mod in DISAGG + ("__init__",):
        assert os.path.join("disagg", f"{mod}.py") in walked
    assert os.path.join("ops", "kv_transfer.py") in walked
    assert os.path.exists(os.path.join(PKG, "csrc", "kv_transfer.cu"))


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_disagg_roles_refuse_without_cuda(monkeypatch, role):
    """`--disagg-role` builds its engine on the card like every role: with
    no card and no `--device cpu` the worker refuses before it connects."""
    from dynamo_tpu_torch.worker.__main__ import build_engine, build_parser, check_role

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = build_parser().parse_args(["--control", "x:1", "--disagg-role", role])
    check_role(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(args)
    cpu = build_parser().parse_args(["--control", "x:1", "--disagg-role", role,
                                     "--device", "cpu"])
    engine, mdc = build_engine(cpu)
    assert engine.device.type == "cpu" and mdc.disagg_role == role


@pytest.mark.parametrize("argv,match", [
    (["--disagg-role", "encode"], "vision"),
    (["--prefill-router", "router"], "--disagg-role decode"),
    (["--disagg-role", "prefill", "--prefill-router", "router"],
     "--disagg-role decode"),
    (["--disagg-role", "prefill", "--kvbm"], "--kvbm"),
])
def test_worker_refuses_roles_it_cannot_serve(argv, match):
    from dynamo_tpu_torch.worker.__main__ import build_parser, check_role

    with pytest.raises(SystemExit, match=match):
        check_role(build_parser().parse_args(["--control", "x:1", *argv]))


def test_prefill_role_on_a_card_refuses_expandable_segments(monkeypatch):
    """A prefill worker on a card serves its pages through CUDA IPC, which
    cannot export memory allocated with expandable segments: the worker
    refuses before it loads a model.  On the CPU the setting is moot."""
    from dynamo_tpu_torch.worker.__main__ import build_parser, check_role

    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    with pytest.raises(SystemExit, match="expandable_segments"):
        check_role(build_parser().parse_args(
            ["--control", "x:1", "--disagg-role", "prefill"]))
    check_role(build_parser().parse_args(
        ["--control", "x:1", "--disagg-role", "prefill", "--device", "cpu"]))
    check_role(build_parser().parse_args(
        ["--control", "x:1", "--disagg-role", "decode"]))


VISION = ("models/qwen_vl.py", "models/vision.py", "models/vlm.py",
          "ops/vision_attention.py", "llm/multimodal.py", "llm/image_codec.py",
          "engine/media.py", "disagg/encode.py")


def test_vision_modules_are_covered():
    """The vision slice's modules are among the sources the import checks
    walk (no JAX, no PIL: the codec decodes media), and its kernel source
    is in the build."""
    from dynamo_tpu_torch.ops import _build

    walked = {os.path.relpath(p, PKG) for p in _sources()}
    for mod in VISION:
        assert mod in walked, mod
    assert "vision_attention.cu" in _build.SOURCES
    assert os.path.exists(os.path.join(PKG, "csrc", "vision_attention.cu"))


def test_vision_entry_points_refuse_without_cuda(monkeypatch):
    """The towers, their loaders and an encode worker build on the card
    unless asked for the CPU; the segment kernel's wrapper takes CUDA
    tensors only."""
    from dynamo_tpu_torch.models import qwen_vl, vision, vlm
    from dynamo_tpu_torch.ops import vision_attention as va
    from dynamo_tpu_torch.worker.__main__ import build_engine, build_parser, check_role

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    qcfg = qwen_vl.tiny_qwen_vl_vision_config()
    ccfg = vision.tiny_vision_config()
    golden = os.path.join(ROOT, "tests", "fixtures", "golden_llava")
    for make in (lambda: qwen_vl.init_qwen_vl_vision_params(qcfg, torch.Generator()),
                 lambda: vision.init_vision_params(ccfg, torch.Generator()),
                 lambda: vlm.load_vlm(golden)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    q = torch.zeros((4, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        va.segment_attention_cuda(q, q, q, [0, 4])
    args = build_parser().parse_args(["--control", "x:1", "--disagg-role", "encode",
                                      "--vision", "tiny"])
    check_role(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(args)
    cpu = build_parser().parse_args(["--control", "x:1", "--disagg-role", "encode",
                                     "--vision", "tiny", "--device", "cpu"])
    engine, mdc = build_engine(cpu)
    assert engine.device.type == "cpu" and engine.vision[0] is not None
    assert mdc.image_token == "<image>" and mdc.image_patches == ccfg.num_patches
    with pytest.raises(SystemExit, match="vision tower"):
        check_role(build_parser().parse_args(["--control", "x:1",
                                              "--disagg-role", "encode"]))


SERVING = ("llm/migration.py", "worker/__init__.py", "worker/__main__.py",
           "frontend/openai_http.py", "frontend/service.py",
           "frontend/metrics.py", "llm/preprocessor.py", "models/llama.py",
           "engine/engine.py")


def test_embed_dp_and_migration_modules_are_covered():
    """The modules of embeddings, data-parallel ranks and migration are
    among the sources the import checks walk, so none of them loads JAX
    or the JAX package, even lazily."""
    walked = {os.path.relpath(p, PKG) for p in _sources()}
    for mod in SERVING:
        assert mod in walked, mod


def test_dp_ranks_refuse_without_cuda(monkeypatch):
    """`--dp-ranks` builds every rank on the card unless asked for the
    CPU."""
    from dynamo_tpu_torch.worker import DpRankEngine
    from dynamo_tpu_torch.worker.__main__ import build_engine, build_parser

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(build_parser().parse_args(["--control", "x:1",
                                                "--dp-ranks", "2"]))
    engine, _ = build_engine(build_parser().parse_args(
        ["--control", "x:1", "--dp-ranks", "2", "--device", "cpu",
         "--num-pages", "16"]))
    assert isinstance(engine, DpRankEngine)
    assert all(e.device.type == "cpu" for e in engine.engines)


PARALLEL = ("__init__", "mesh", "sharding", "collectives")

# run as a script: a spawned follower re-imports it as its main module, so
# the poisoned names below hold in the leader and in the follower
_TP_SCRIPT = '''
import sys
for name in {forbidden!r}:
    sys.modules[name] = None  # any import of it now raises ImportError


def main():
    import asyncio

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models import tiny_config
    from dynamo_tpu_torch.parallel import ParallelConfig, SeededShards

    cfg = tiny_config()
    engine = TorchEngine(
        cfg, SeededShards(cfg, 0, "float32"),
        EngineConfig(page_size=8, num_pages=32, max_model_len=64),
        parallel=ParallelConfig(tp=2), devices=["cpu", "cpu"])

    async def run():
        out = []
        try:
            async for d in engine.generate({{
                    "token_ids": [1, 2, 3],
                    "sampling_options": {{"temperature": 0.0}},
                    "stop_conditions": {{"max_tokens": 4, "ignore_eos": True}}}}):
                out += d["token_ids"]
            stats = await engine.group_stats()
        finally:
            await engine.shutdown()
        return out, sorted(stats)

    print(asyncio.run(run()))


if __name__ == "__main__":
    main()
'''


def test_parallel_modules_and_the_follower_import_no_jax(tmp_path):
    """The tp slice's modules are among the sources the import checks
    walk, and a tp group's leader and its spawned follower (the follower
    entry point, `engine.lockstep.follower_main`) serve with JAX and the
    JAX package made unimportable in both processes."""
    walked = {os.path.relpath(p, PKG) for p in _sources()}
    for mod in PARALLEL:
        assert os.path.join("parallel", f"{mod}.py") in walked
    assert os.path.join("engine", "lockstep.py") in walked
    script = tmp_path / "tp_no_jax.py"
    script.write_text(_TP_SCRIPT.format(forbidden=FORBIDDEN))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    tokens, ranks = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    assert len(tokens) == 4 and ranks == [0, 1]
