"""Test data of the port: the tiny byte-level tokenizer, a seeded
byte-level BPE tokenizer of any vocabulary size, `sharpen` for random
weights, and `host_threads` for CPU groups.

Both are written as ``tokenizer.json`` documents, so the HF `tokenizers`
runtime and the port's `llm.tokenizer` read the same bytes.
"""

from __future__ import annotations

import contextlib
import json
import random
from typing import Dict, List, Optional

import torch

from .llm.tokenizer import HuggingFaceTokenizer, bytes_to_unicode

TINY_SPECIALS = ("<|endoftext|>", "<|user|>", "<|assistant|>", "<|system|>")

# Llama-3's split pattern (its published tokenizer.json)
LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)


def _added(content: str, i: int) -> dict:
    return {"id": i, "content": content, "single_word": False, "lstrip": False,
            "rstrip": False, "normalized": False, "special": True}


def _bpe(vocab: dict, merges: List[List[str]], ignore_merges: bool) -> dict:
    return {"type": "BPE", "dropout": None, "unk_token": None,
            "continuing_subword_prefix": None, "end_of_word_suffix": None,
            "fuse_unk": False, "byte_fallback": False,
            "ignore_merges": ignore_merges, "vocab": vocab, "merges": merges}


_BYTELEVEL = {"type": "ByteLevel", "add_prefix_space": False,
              "trim_offsets": True, "use_regex": True}


def tiny_tokenizer_json() -> str:
    """The JAX package's tiny test tokenizer (`dynamo_tpu.testing.
    tiny_tokenizer`): a byte-level BPE trained to its 260-symbol floor
    (4 specials, then the 256-character byte alphabet in code-point
    order, no merges) plus ``<image>`` as id 260."""
    alphabet = sorted(bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(list(TINY_SPECIALS) + alphabet)}
    added = [_added(t, i) for i, t in enumerate(TINY_SPECIALS)]
    added.append(_added("<image>", len(vocab)))
    return json.dumps({
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": dict(_BYTELEVEL), "post_processor": None,
        "decoder": {**_BYTELEVEL, "add_prefix_space": True},
        "model": _bpe(vocab, [], False),
    }, ensure_ascii=False)


def tiny_tokenizer() -> HuggingFaceTokenizer:
    data = tiny_tokenizer_json()
    tok = HuggingFaceTokenizer(data)
    tok.eos_token_ids = [tok.token_to_id("<|endoftext|>")]
    return tok


def synthetic_tokenizer_json(vocab_size: int = 128256, seed: int = 0,
                             n_special: int = 256,
                             max_token_chars: int = 8,
                             specials: Optional[Dict[int, str]] = None) -> str:
    """A Llama-3-shaped byte-level BPE tokenizer of exactly `vocab_size`
    ids, drawn from `seed`: the 256 byte symbols, then seeded merges of
    two existing symbols (at most `max_token_chars` characters, each a
    new id), then `n_special` special tokens (``<|begin_of_text|>`` first,
    which the post-processor puts before every encoded sequence, then
    ``<|end_of_text|>``), of which `specials` names some by id (a media
    model's placeholders at their published ids; the special range then
    starts two below the lowest).
    Every id decodes.  Test data for models with random weights, not a
    tokenizer of any published model."""
    if specials:
        n_special = max(n_special, vocab_size - min(specials) + 2)
    rng = random.Random(seed)
    table = bytes_to_unicode()
    symbols = [table[b] for b in range(256)]
    vocab = {s: i for i, s in enumerate(symbols)}
    merges: List[List[str]] = []
    n_merges = vocab_size - n_special - 256
    if n_merges < 0:
        raise ValueError(f"vocab_size {vocab_size} < 256 bytes + {n_special} specials")
    while len(merges) < n_merges:
        # left: any symbol; right: a byte half the time, so common byte
        # runs grow into longer tokens as a trained vocabulary's do
        a = symbols[rng.randrange(len(symbols))]
        b = symbols[rng.randrange(256 if rng.random() < 0.5 else len(symbols))]
        new = a + b
        if len(new) > max_token_chars or new in vocab:
            continue
        vocab[new] = len(symbols)
        symbols.append(new)
        merges.append([a, b])
    base = len(vocab)
    names = ["<|begin_of_text|>", "<|end_of_text|>"] + [
        f"<|reserved_special_token_{k}|>" for k in range(n_special - 2)]
    for tid, name in (specials or {}).items():
        names[tid - base] = name
    added = [_added(t, base + k) for k, t in enumerate(names)]
    bos = names[0]
    return json.dumps({
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN},
             "behavior": "Isolated", "invert": False},
            {**_BYTELEVEL, "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {**_BYTELEVEL, "use_regex": False},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                      {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": bos, "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {bos: {"id": bos, "ids": [base],
                                      "tokens": [bos]}}}]},
        "decoder": {**_BYTELEVEL, "use_regex": True},
        "model": _bpe(vocab, merges, True),
    }, ensure_ascii=False)


def synthetic_tokenizer(vocab_size: int = 128256, seed: int = 0,
                        path: Optional[str] = None,
                        specials: Optional[Dict[int, str]] = None
                        ) -> HuggingFaceTokenizer:
    """`synthetic_tokenizer_json` loaded (and written to `path` when
    given); EOS is ``<|end_of_text|>``, BOS ``<|begin_of_text|>``."""
    data = synthetic_tokenizer_json(vocab_size, seed, specials=specials)
    if path:
        with open(path, "w", encoding="utf-8") as f:
            f.write(data)
    tok = HuggingFaceTokenizer(data)
    tok.eos_token_ids = [tok.token_to_id("<|end_of_text|>")]
    tok.bos_token_id = tok.token_to_id("<|begin_of_text|>")
    return tok


__all__ = ["LLAMA3_PATTERN", "MEDIA_SPECIALS", "sharpen", "synthetic_tokenizer",
           "synthetic_tokenizer_json", "tiny_tokenizer", "tiny_tokenizer_json"]


# the published special tokens of the canned media models, by id
MEDIA_SPECIALS = {
    "qwen2.5-vl-7b": {151652: "<|vision_start|>",
                      151653: "<|vision_end|>", 151655: "<|image_pad|>",
                      151656: "<|video_pad|>"},
}


@torch.no_grad()
def sharpen(model, tower=None, probe_seed: int = 0) -> None:
    """Random weights at the JAX package's scales give a deep model whose
    greedy output ignores its input.  Raise the embedding to std ~1 (x50)
    and the q and k projections by 1.5 over the rope's attention scale, so
    a single key moves the output (chip_smoke.py's `sharpen` says why); with a Qwen
    `tower`, also scale the merger's last projection so that image
    embeddings have the RMS of the sharpened token embeddings, measured on
    a seeded 56x56 probe image: otherwise an image would not move the
    logits.  Deterministic for a seed, so a worker process sharpened with
    ``--sharpen`` equals the same model sharpened in another process."""
    import numpy as np

    qk = 1.5 / model.rope_scale
    if model.embed is not None:  # a middle pipeline stage holds none
        model.embed.mul_(50.0)
    for layer in model.layers:
        layer.wq.mul_(qk)
        layer.wk.mul_(qk)
    if tower is None:
        return
    from .models.qwen_vl import encode_patches, frames_to_patches

    frames = np.random.default_rng(probe_seed).random((1, 56, 56, 3), np.float32)
    patches, grid = frames_to_patches(frames, tower.cfg)
    emb = encode_patches(tower, torch.from_numpy(patches), grid)
    rms = lambda t: t.float().pow(2).mean().sqrt()  # noqa: E731
    scale = (rms(model.embed) / rms(emb)).item()
    tower.p("merge_w2").mul_(scale)
    tower.p("merge_b2").mul_(scale)


@contextlib.contextmanager
def host_threads(n: int):
    """Run torch's host ops on `n` intra-op threads inside the block, the
    count before it restored after.  A dp x tp group's followers take
    their leader's count when they start (`engine.lockstep.start_group`),
    so a CPU group built inside ``host_threads(1)`` runs one thread a
    rank: its ranks share the host's cores, and idle intra-op threads
    spinning beside every gloo collective slowed each step several times
    over.  The count is process-wide (other libraries' OpenMP work in the
    process shares it), hence a block and not a setting."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)
