"""Tokenizer + incremental detokenization, in pure Python.

The port's copy of the JAX package's `llm/tokenizer.py`.  That module
wraps the HF `tokenizers` runtime; the GPU machine does not have it, so
this one reads ``tokenizer.json`` itself and implements the part of the
format the Llama family uses:

- model ``BPE`` (merges by rank, ``ignore_merges``), no dropout, no
  continuing-subword prefix or end-of-word suffix;
- pre-tokenizers ``ByteLevel`` (with or without its GPT-2 split regex),
  ``Split`` (regex or string, behaviour ``Isolated``) and ``Sequence`` of
  them;
- decoder ``ByteLevel``; post-processors ``ByteLevel``,
  ``TemplateProcessing`` (the BOS that Llama-3 adds) and ``Sequence``;
- added and special tokens (matched leftmost-longest before
  pre-tokenization, as the HF runtime does).

Anything else (another model, a normalizer, other split behaviours)
raises `NotImplementedError` when the tokenizer is loaded.

The split patterns use Oniguruma classes that Python's `re` lacks:
``\\p{L}``, ``\\p{N}`` (any ``\\p{..}`` category) and a Unicode ``\\s``.
They are rewritten into explicit code-point ranges built from
`unicodedata` categories: ``\\s`` is White_Space, i.e. the Zs, Zl and Zp
categories plus TAB..CR and NEL (Python's own ``\\s`` also takes
U+001C..U+001F, and ``[^\\W\\d_]`` is not ``\\p{L}``).  The ranges are
built once, at the first tokenizer load.
"""

from __future__ import annotations

import functools
import heapq
import json
import os
import re
import sys
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

# --------------------------------------------------------------------------- #
# byte-level alphabet and Unicode classes
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte → printable-character map."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@functools.lru_cache(maxsize=1)
def _unicode_to_bytes() -> Dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


_EXTRA_SPACE = (0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x85)


@functools.lru_cache(maxsize=1)
def _categories() -> Dict[str, List[Tuple[int, int]]]:
    """General category → sorted code-point ranges, over all of Unicode."""
    out: Dict[str, List[Tuple[int, int]]] = {}
    cur, start = None, 0
    for cp in range(sys.maxunicode + 2):
        cat = unicodedata.category(chr(cp)) if cp <= sys.maxunicode else None
        if cat != cur:
            if cur is not None:
                out.setdefault(cur, []).append((start, cp - 1))
            cur, start = cat, cp
    return out


@functools.lru_cache(maxsize=None)
def _class_ranges(name: str) -> Tuple[Tuple[int, int], ...]:
    """Ranges of ``\\p{name}`` (a category or category prefix such as L,
    N, Lu) or of ``space`` (White_Space)."""
    cats = _categories()
    if name == "space":
        ranges = [r for c in ("Zs", "Zl", "Zp") for r in cats.get(c, [])]
        ranges += [(cp, cp) for cp in _EXTRA_SPACE]
    else:
        picked = [c for c in cats if c.startswith(name)]
        if not picked or len(name) > 2:
            raise NotImplementedError(f"regex class \\p{{{name}}} not ported")
        ranges = [r for c in picked for r in cats[c]]
    ranges.sort()
    merged: List[Tuple[int, int]] = []
    for lo, hi in ranges:
        if merged and lo <= merged[-1][1] + 1:
            merged[-1] = (merged[-1][0], max(hi, merged[-1][1]))
        else:
            merged.append((lo, hi))
    return tuple(merged)


def _class_body(name: str) -> str:
    parts = []
    for lo, hi in _class_ranges(name):
        parts.append(f"\\U{lo:08x}" if lo == hi else f"\\U{lo:08x}-\\U{hi:08x}")
    return "".join(parts)


_PROP = re.compile(r"\\([pP])\{([A-Za-z_]+)\}")


def translate_regex(pattern: str) -> str:
    """An Oniguruma split pattern → an equivalent Python `re` pattern:
    ``\\p{X}``/``\\P{X}``, ``\\s``/``\\S`` become explicit ranges, inside
    and outside character classes."""
    out = []
    i, in_class = 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            m = _PROP.match(pattern, i)
            if m:
                neg, body = m.group(1) == "P", _class_body(m.group(2))
                if in_class:
                    if neg:
                        raise NotImplementedError("\\P{..} inside a class not ported")
                    out.append(body)
                else:
                    out.append(f"[{'^' if neg else ''}{body}]")
                i = m.end()
                continue
            nxt = pattern[i + 1]
            if nxt in "sS":
                body = _class_body("space")
                if in_class:
                    if nxt == "S":
                        raise NotImplementedError("\\S inside a class not ported")
                    out.append(body)
                else:
                    out.append(f"[{'^' if nxt == 'S' else ''}{body}]")
            elif nxt in "dDwWbB":
                raise NotImplementedError(f"regex escape \\{nxt} not ported")
            else:
                out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            i += 1
            if i < len(pattern) and pattern[i] == "^":
                out.append("^")
                i += 1
            if i < len(pattern) and pattern[i] == "]":  # literal ']' first
                out.append("\\]")
                i += 1
            continue
        if c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return "".join(out)


# GPT-2's split, which the ByteLevel pre-tokenizer applies when use_regex
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


@functools.lru_cache(maxsize=64)
def _compiled(pattern: str) -> "re.Pattern":
    return re.compile(translate_regex(pattern))


# --------------------------------------------------------------------------- #
# pipeline stages
# --------------------------------------------------------------------------- #


def _unported(what: str, spec) -> NotImplementedError:
    return NotImplementedError(f"tokenizer {what} {spec!r} not ported "
                               "(byte-level BPE only)")


def _split_isolated(regex: "re.Pattern", text: str) -> List[str]:
    """Matches and the gaps between them, in order (behaviour Isolated)."""
    out, last = [], 0
    for m in regex.finditer(text):
        if m.start() > last:
            out.append(text[last:m.start()])
        if m.end() > m.start():
            out.append(m.group())
        last = m.end()
    if last < len(text):
        out.append(text[last:])
    return out


class _PreTokenizer:
    """A list of steps, each mapping a piece of text to sub-pieces; the
    ByteLevel step also maps bytes to the byte-level alphabet."""

    def __init__(self, spec: Optional[dict]):
        self.steps = []
        for s in (spec.get("pretokenizers", []) if spec and spec.get("type") == "Sequence"
                  else [spec] if spec else []):
            kind = s.get("type")
            if kind == "ByteLevel":
                regex = _compiled(GPT2_PATTERN) if s.get("use_regex", True) else None
                self.steps.append(("bytelevel", regex, bool(s.get("add_prefix_space"))))
            elif kind == "Split":
                if s.get("behavior") != "Isolated" or s.get("invert"):
                    raise _unported("Split", s)
                pat = s["pattern"]
                regex = (_compiled(pat["Regex"]) if "Regex" in pat
                         else re.compile(re.escape(pat["String"])))
                self.steps.append(("split", regex, False))
            else:
                raise _unported("pre_tokenizer", s)
        self.byte_level = any(k == "bytelevel" for k, _, _ in self.steps)

    def __call__(self, text: str) -> List[str]:
        pieces = [text]
        table = bytes_to_unicode()
        for kind, regex, prefix in self.steps:
            nxt: List[str] = []
            for p in pieces:
                if kind == "split":
                    nxt.extend(_split_isolated(regex, p))
                    continue
                if prefix and not p.startswith(" "):
                    p = " " + p
                subs = _split_isolated(regex, p) if regex is not None else [p]
                nxt.extend("".join(table[b] for b in s.encode("utf-8"))
                           for s in subs)
            pieces = [p for p in nxt if p]
        return pieces


class _BPE:
    def __init__(self, spec: dict):
        if spec.get("type", "BPE") != "BPE":
            raise _unported("model", spec.get("type"))
        for key in ("continuing_subword_prefix", "end_of_word_suffix", "dropout"):
            if spec.get(key):
                raise _unported(f"BPE {key}", spec[key])
        if spec.get("byte_fallback"):
            raise _unported("BPE byte_fallback", True)
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.unk = spec.get("unk_token")
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges", [])):
            a, b = m if isinstance(m, list) else m.split(" ", 1)
            ia, ib, inew = self.vocab.get(a), self.vocab.get(b), self.vocab.get(a + b)
            if ia is None or ib is None or inew is None:
                raise ValueError(f"merge {a!r} {b!r} refers to tokens outside the vocab")
            self.merges[(ia, ib)] = (rank, inew)
        self._cache: Dict[str, List[int]] = {}

    def tokenize(self, word: str) -> List[int]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        if self.ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            ids = self._merge(word)
        if len(self._cache) < 100_000:
            self._cache[word] = ids
        return ids

    def _merge(self, word: str) -> List[int]:
        """HF's `Word::merge_all`: a heap of (rank, position) over adjacent
        pairs, lowest rank (then leftmost) merged first."""
        sym: List[int] = []
        for ch in word:
            i = self.vocab.get(ch)
            if i is None and self.unk is not None:
                i = self.vocab.get(self.unk)
            if i is not None:
                sym.append(i)
        n = len(sym)
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        merges = self.merges
        heap = []
        for p in range(n - 1):
            m = merges.get((sym[p], sym[p + 1]))
            if m is not None:
                heap.append((m[0], p, m[1]))
        heapq.heapify(heap)
        while heap:
            _, p, new = heapq.heappop(heap)
            if not alive[p] or nxt[p] >= n:
                continue
            q = nxt[p]
            m = merges.get((sym[p], sym[q]))
            if m is None or m[1] != new:
                continue  # an expired entry
            sym[p] = new
            alive[q] = False
            nxt[p] = nxt[q]
            if nxt[p] < n:
                prv[nxt[p]] = p
            if prv[p] >= 0:
                m = merges.get((sym[prv[p]], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[p], m[1]))
            if nxt[p] < n:
                m = merges.get((new, sym[nxt[p]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
        return [s for s, a in zip(sym, alive) if a]


def _post_bos(spec: Optional[dict]) -> List[int]:
    """Ids a post-processor puts before a single sequence (Llama-3's
    BOS); ByteLevel post-processing changes no ids."""
    if not spec:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [i for s in spec.get("processors", []) for i in _post_bos(s)]
    if kind == "ByteLevel":
        return []
    if kind == "TemplateProcessing":
        before = []
        single = spec.get("single", [])
        for k, piece in enumerate(single):
            if "Sequence" in piece:
                if any("Sequence" in p for p in single[k + 1:]) or any(
                        "SpecialToken" in p for p in single[k + 1:]):
                    raise _unported("post_processor template", single)
                return before
            sid = piece["SpecialToken"]["id"]
            before.extend(spec["special_tokens"][sid]["ids"])
        return before
    raise _unported("post_processor", kind)


# --------------------------------------------------------------------------- #
# public API
# --------------------------------------------------------------------------- #


class HuggingFaceTokenizer:
    """A ``tokenizer.json`` tokenizer with the JAX package's wrapper API."""

    def __init__(self, data: str, eos_token_ids: Optional[List[int]] = None,
                 bos_token_id: Optional[int] = None,
                 chat_template: Optional[str] = None):
        self._json = data
        spec = json.loads(data)
        if spec.get("normalizer"):
            raise _unported("normalizer", spec["normalizer"].get("type"))
        dec = spec.get("decoder")
        if dec and dec.get("type") != "ByteLevel":
            raise _unported("decoder", dec.get("type"))
        self._model = _BPE(spec["model"])
        self._pre = _PreTokenizer(spec.get("pre_tokenizer"))
        self._bos = _post_bos(spec.get("post_processor"))
        added = spec.get("added_tokens") or []
        for a in added:
            if a.get("single_word") or a.get("lstrip") or a.get("rstrip"):
                raise _unported("added token option", a)
        self._added: Dict[str, int] = {a["content"]: a["id"] for a in added}
        self._special = {a["id"] for a in added if a.get("special")}
        self._id_to_token: Dict[int, str] = {i: t for t, i in self._model.vocab.items()}
        self._id_to_token.update({i: t for t, i in self._added.items()})
        # raw-text matches first (normalized=False), then the rest, as HF
        self._added_passes = [
            re.compile("|".join(re.escape(c) for c in sorted(group, key=len, reverse=True)))
            for group in ([a["content"] for a in added if not a.get("normalized", True)],
                          [a["content"] for a in added if a.get("normalized", True)])
            if group
        ]
        self.eos_token_ids = eos_token_ids or []
        self.bos_token_id = bos_token_id
        self.chat_template = chat_template

    # -- construction -------------------------------------------------------- #

    @staticmethod
    def from_pretrained(path: str) -> "HuggingFaceTokenizer":
        """Load from an HF checkpoint dir (tokenizer.json + configs)."""
        with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
            tok = HuggingFaceTokenizer(f.read())
        cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            tok.chat_template = cfg.get("chat_template")

            def tok_id(entry):
                if entry is None:
                    return None
                content = entry["content"] if isinstance(entry, dict) else entry
                return tok.token_to_id(content)

            eid = tok_id(cfg.get("eos_token"))
            if eid is not None:
                tok.eos_token_ids.append(eid)
            tok.bos_token_id = tok_id(cfg.get("bos_token"))
        gen_path = os.path.join(path, "generation_config.json")
        if os.path.exists(gen_path):
            with open(gen_path) as f:
                g_eos = json.load(f).get("eos_token_id")
            if isinstance(g_eos, int):
                g_eos = [g_eos]
            for e in g_eos or []:
                if e not in tok.eos_token_ids:
                    tok.eos_token_ids.append(e)
        return tok

    @staticmethod
    def from_json_str(data: str, **kw) -> "HuggingFaceTokenizer":
        return HuggingFaceTokenizer(data, **kw)

    def to_json_str(self) -> str:
        return self._json

    # -- encode/decode ------------------------------------------------------- #

    def _split_added(self, text: str) -> List[Tuple[str, bool]]:
        """(segment, is_added_token) in order."""
        segs = [(text, False)]
        for regex in self._added_passes:
            nxt = []
            for s, added in segs:
                if added:
                    nxt.append((s, True))
                    continue
                last = 0
                for m in regex.finditer(s):
                    if m.start() > last:
                        nxt.append((s[last:m.start()], False))
                    nxt.append((m.group(), True))
                    last = m.end()
                if last < len(s):
                    nxt.append((s[last:], False))
            segs = nxt
        return [(s, a) for s, a in segs if s]

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = list(self._bos) if add_special_tokens else []
        for seg, added in self._split_added(text):
            if added:
                ids.append(self._added[seg])
                continue
            for piece in self._pre(seg):
                ids.extend(self._model.tokenize(piece))
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        inv = _unicode_to_bytes()
        out = bytearray()
        for i in ids:
            tok = self._id_to_token.get(int(i))
            if tok is None or (skip_special_tokens and int(i) in self._special):
                continue
            raw = [inv.get(ch) for ch in tok]
            out += bytes(raw) if None not in raw else tok.encode("utf-8")
        return out.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return len(set(self._model.vocab) | set(self._added))

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self._added:
            return self._added[token]
        return self._model.vocab.get(token)


class IncrementalDetokenizer:
    """Streaming token→text converter (a copy of the JAX package's: a
    sliding (prefix_offset, read_offset) window so multi-token characters
    emit whole)."""

    def __init__(self, tokenizer: HuggingFaceTokenizer,
                 prompt_ids: Optional[Sequence[int]] = None):
        self._tok = tokenizer
        # keep a short tail of prompt ids so the first generated token
        # detokenizes with correct left context (spaces etc.)
        tail = list(prompt_ids or [])[-6:]
        self.ids: List[int] = tail
        self.prefix_offset = 0
        self.read_offset = len(tail)

    def push(self, token_id: int) -> str:
        """Add one token; return the new text delta ('' if incomplete)."""
        self.ids.append(token_id)
        prefix = self._tok.decode(
            self.ids[self.prefix_offset:self.read_offset],
            skip_special_tokens=True,
        )
        full = self._tok.decode(self.ids[self.prefix_offset:],
                                skip_special_tokens=True)
        if full.endswith("�"):
            # incomplete utf-8 sequence — wait for more tokens
            return ""
        delta = full[len(prefix):]
        if delta:
            self.prefix_offset = self.read_offset
            self.read_offset = len(self.ids)
        return delta
