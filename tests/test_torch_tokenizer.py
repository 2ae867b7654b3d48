"""The port's pure-Python tokenizer (`dynamo_tpu_torch.llm.tokenizer`)
against the HF `tokenizers` runtime on the same tokenizer.json: the tiny
test tokenizer, the seeded 128256-id Llama-3-shaped tokenizer that
chip_smoke.py serves the 8B model with, and the hd-64 golden fixture's;
encode/decode on fixed and hypothesis-drawn Unicode text, and the
incremental detokenizer's deltas against the JAX package's."""

import json
import os
import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from tokenizers import Tokenizer

from dynamo_tpu.llm.tokenizer import HuggingFaceTokenizer as JaxTokenizer
from dynamo_tpu.llm.tokenizer import IncrementalDetokenizer as JaxDetok
from dynamo_tpu.testing import tiny_tokenizer as jax_tiny_tokenizer
from dynamo_tpu_torch.llm.tokenizer import (
    HuggingFaceTokenizer,
    IncrementalDetokenizer,
    translate_regex,
)
from dynamo_tpu_torch.testing import (
    synthetic_tokenizer_json,
    tiny_tokenizer,
    tiny_tokenizer_json,
)

HD64 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                    "torch_golden_llama_hd64")
SPECIALS = ["<|endoftext|>", "<|user|>", "<|assistant|>", "<image>",
            "<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_3|>"]
TEXTS = [
    "", "hello world, how are you today?",
    "The quick brown fox's jumps  \n\n over 12345 lazy dogs!!",
    "héllo 😀 <|begin_of_text|> x<|user|>y<|endoftext|>",
    "  spaces\t\ttabs\r\nnew\n", "日本語のテキスト、混在 text 1234567",
    "I'll we've THEY'RE don't 'S", "a" * 70, "́́abc", "x\x1c\x1dy\x85z",
    "👍🏽👨‍👩‍👧 ١٢٣ ⅷ ²³", "tab　ideo nbsp line",
]


@pytest.fixture(scope="module")
def pairs():
    """(name, HF runtime, port) over the same tokenizer.json."""
    out = []
    for name, data in (("tiny", tiny_tokenizer_json()),
                       ("synthetic", synthetic_tokenizer_json(128256, seed=1)),
                       ("hd64", open(os.path.join(HD64, "tokenizer.json"),
                                     encoding="utf-8").read())):
        out.append((name, Tokenizer.from_str(data), HuggingFaceTokenizer(data)))
    return out


def _check(pairs, text):
    for name, ref, mine in pairs:
        for special in (False, True):
            want = ref.encode(text, add_special_tokens=special).ids
            assert mine.encode(text, add_special_tokens=special) == want, (name, text)
            for skip in (True, False):
                assert mine.decode(want, skip_special_tokens=skip) == ref.decode(
                    want, skip_special_tokens=skip), (name, text)


def test_tiny_tokenizer_is_the_jax_one():
    jax_json = json.loads(jax_tiny_tokenizer().to_json_str())
    mine = json.loads(tiny_tokenizer_json())
    for key in ("added_tokens", "normalizer", "pre_tokenizer", "post_processor"):
        assert mine[key] == jax_json[key], key
    assert mine["model"]["vocab"] == jax_json["model"]["vocab"]
    assert mine["model"]["merges"] == jax_json["model"]["merges"] == []
    assert tiny_tokenizer().eos_token_ids == jax_tiny_tokenizer().eos_token_ids


def test_vocab_sizes_and_ids(pairs):
    for name, ref, mine in pairs:
        assert mine.vocab_size == ref.get_vocab_size(), name
        for tok in ("<|endoftext|>", "<|begin_of_text|>", "Ġthe", "a", "nope"):
            assert mine.token_to_id(tok) == ref.token_to_id(tok), (name, tok)
    assert [m.vocab_size for _, _, m in pairs] == [261, 128256, 261]


@pytest.mark.parametrize("text", TEXTS)
def test_fixed_texts(pairs, text):
    _check(pairs, text)


_PIECES = st.one_of(
    st.text(st.characters(categories=("Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc",
                                      "Nd", "Nl", "No", "Pc", "Pd", "Po", "Sm",
                                      "Sc", "So", "Zs"))),
    st.text(st.sampled_from(" \t\n\r\x0b\x0c\x85 　 ")),
    st.sampled_from(["😀", "👍🏽", "🇯🇵", "'s", "'LL", "  ", "\n\n"] + SPECIALS),
)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(st.lists(_PIECES, max_size=8).map("".join))
def test_hypothesis_text(pairs, text):
    _check(pairs, text)


def test_decode_random_ids(pairs):
    rng = random.Random(3)
    for name, ref, mine in pairs:
        n = ref.get_vocab_size()
        for _ in range(20):
            ids = [rng.randrange(n) for _ in range(rng.randrange(1, 60))]
            for skip in (True, False):
                assert mine.decode(ids, skip_special_tokens=skip) == ref.decode(
                    ids, skip_special_tokens=skip), name


def test_from_pretrained_matches_jax():
    ref, mine = JaxTokenizer.from_pretrained(HD64), HuggingFaceTokenizer.from_pretrained(HD64)
    assert (mine.eos_token_ids, mine.bos_token_id, mine.chat_template) == (
        ref.eos_token_ids, ref.bos_token_id, ref.chat_template)


def test_incremental_detokenizer_matches_jax():
    """Same deltas token by token, across multi-byte characters split over
    byte tokens and special tokens, with and without prompt context."""
    ref_tok, mine_tok = jax_tiny_tokenizer(), tiny_tokenizer()
    rng = random.Random(7)
    streams = [ref_tok.encode(t) for t in ("héllo 😀 wörld 日本", "a <|user|> b\n")]
    streams += [[rng.randrange(261) for _ in range(40)] for _ in range(5)]
    for ids in streams:
        for prompt in ([], ref_tok.encode(" prompt ü")):
            ref, mine = JaxDetok(ref_tok, prompt), IncrementalDetokenizer(mine_tok, prompt)
            assert [mine.push(t) for t in ids] == [ref.push(t) for t in ids]


def test_split_classes():
    """\\p{L}, \\p{N} and \\s become explicit Unicode ranges: Python's
    own \\s also takes U+001C..U+001F, which Oniguruma's does not."""
    import re

    letters = re.compile(translate_regex(r"\p{L}+"))
    assert letters.fullmatch("héllo日本ǅ") and not letters.search("_1²")
    space = re.compile(translate_regex(r"\s"))
    assert space.match("　") and space.match("\x85") and not space.match("\x1c")
    assert re.compile(translate_regex(r"[^\s\p{L}\p{N}]")).fullmatch("!")
    with pytest.raises(NotImplementedError):
        translate_regex(r"\w+")


def test_unported_parts_refused():
    data = json.loads(tiny_tokenizer_json())
    for key, value in (("normalizer", {"type": "NFC"}),
                       ("decoder", {"type": "WordPiece"}),
                       ("pre_tokenizer", {"type": "Whitespace"})):
        with pytest.raises(NotImplementedError, match="not ported"):
            HuggingFaceTokenizer(json.dumps({**data, key: value}))
