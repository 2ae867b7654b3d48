"""Multimodal requests in `TorchEngine`: the JAX engine's `_attach_mm`,
`_attach_mm_qwen`, `_encode_mm`, `_mm_arrays` and `_rope_array`.

- `attach` validates a request's media and fills the sequence's ``mm_*``
  fields: fixed-size pixels (``mm_pixels``, CLIP towers), dynamic-
  resolution patches with their grids (``mm_patches``, Qwen towers; the
  M-RoPE streams of the whole prompt and its ``rope_delta`` follow from
  the runs), or embeddings an encode worker computed (``mm_embeds``: one
  [N, P, h] blob for CLIP, or a list of [P_i, h] blobs with their grids for
  Qwen).  Errors come back as strings: the engine streams them.
- `encode_pending` runs the tower for the sequences of a prefill on the
  step thread (between dispatches), once per sequence.
- `prefill_extras` builds a chunk's ``extra_embeds`` / ``extra_mask`` and,
  for M-RoPE models, its three rope streams (a chunk may cut an image run;
  text rows of the batch get their sequential positions).
- `rope_offsets` is the per-row delta every decode, block, chain and
  verify graph takes as a static input.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..llm.multimodal import unpack_patches, unpack_pixels
from ..models.qwen_vl import (
    Qwen2VLVisionConfig,
    encode_patches,
    merged_tokens,
    mrope_positions_from_runs,
)
from ..models.vision import VisionConfig, encode_images


def has_media(seq) -> bool:
    return (seq.mm_pixels is not None or seq.mm_patches is not None
            or seq.mm_embeds is not None)


def _offset_ok(off, prompt_len: int, n: int) -> bool:
    return (isinstance(off, int) and not isinstance(off, bool)
            and 0 <= off <= prompt_len - n)


def _salt(seq, request: Dict[str, Any], digest) -> None:
    """The preprocessor's salt (the router scored overlap with it), else
    a hash of the media: same tokens and same media share pages, another
    image never does."""
    salt = request.get("cache_salt")
    seq.cache_salt = salt if isinstance(salt, str) and salt else digest.hexdigest()


def _runs_positions(engine, seq, runs) -> Optional[str]:
    """Disjoint runs → the prompt's M-RoPE streams and delta on `seq`."""
    vcfg = engine.vision[1] if engine.vision else None
    if not isinstance(vcfg, Qwen2VLVisionConfig):
        return "mm_patches requires a qwen2_vl vision tower"
    spans = sorted((off, off + merged_tokens(g, vcfg)) for off, g in runs)
    for (_, end), (nxt, _) in zip(spans, spans[1:]):
        if nxt < end:
            return "mm_offsets overlap"
    try:
        seq.mm_positions, seq.rope_delta = mrope_positions_from_runs(
            len(seq.prompt), runs, vcfg)
    except ValueError as e:
        return str(e)
    return None


def attach(engine, seq, request: Dict[str, Any]) -> Optional[str]:
    if request.get("mm_embeds") is not None:
        return _attach_embeds(engine, seq, request)
    if request.get("mm_patches"):
        return _attach_patches(engine, seq, request)
    if engine.vision is None or engine.vision[0] is None:
        return "this worker has no vision tower attached"
    vcfg = engine.vision[1]
    if not isinstance(vcfg, VisionConfig):
        return ("this worker's vision tower takes mm_patches "
                "(dynamic resolution), not mm_pixels")
    try:
        pixels = np.array(unpack_pixels(request["mm_pixels"]))
    except (KeyError, TypeError, ValueError):
        return "malformed mm_pixels payload"
    offsets = list(request.get("mm_offsets") or [])
    if pixels.ndim != 4 or pixels.shape[0] != len(offsets):
        return "mm_pixels/mm_offsets mismatch"
    if pixels.shape[1:] != (vcfg.image_size, vcfg.image_size, 3):
        return (f"image shape {pixels.shape[1:]} != tower input "
                f"({vcfg.image_size}, {vcfg.image_size}, 3)")
    if not all(_offset_ok(o, len(seq.prompt), vcfg.num_patches) for o in offsets):
        return "mm_offsets must be integer offsets inside the prompt"
    seq.mm_pixels, seq.mm_offsets = pixels, offsets
    _salt(seq, request, hashlib.blake2b(pixels.tobytes(), digest_size=8))
    return None


def _attach_patches(engine, seq, request) -> Optional[str]:
    if engine.vision is None or engine.vision[0] is None:
        return "this worker has no vision tower attached"
    vcfg = engine.vision[1]
    if not isinstance(vcfg, Qwen2VLVisionConfig):
        return "mm_patches requires a qwen2_vl vision tower"
    if not engine.model_cfg.mrope_section:
        return "mm_patches requires an mrope language model"
    offsets = list(request.get("mm_offsets") or [])
    blobs = request["mm_patches"]
    if len(blobs) != len(offsets):
        return "mm_patches/mm_offsets mismatch"
    patches, grids, runs = [], [], []
    h = hashlib.blake2b(digest_size=8)
    try:
        for blob, off in zip(blobs, offsets):
            arr, grid = unpack_patches(blob)
            t, gh, gw = grid
            if arr.ndim != 2 or arr.shape[1] != vcfg.patch_dim:
                return "patch width != tower patch_dim"
            m = vcfg.spatial_merge_size
            if arr.shape[0] != t * gh * gw or gh % m or gw % m:
                return "patch count does not match the grid"
            if not _offset_ok(off, len(seq.prompt), merged_tokens(grid, vcfg)):
                return "mm_offsets must be integer offsets inside the prompt"
            patches.append(np.array(arr))
            grids.append(grid)
            runs.append((off, grid))
            h.update(np.ascontiguousarray(arr).tobytes())
    except (KeyError, TypeError, ValueError):
        return "malformed mm_patches payload"
    err = _runs_positions(engine, seq, runs)
    if err:
        return err
    seq.mm_patches, seq.mm_grids, seq.mm_offsets = patches, grids, offsets
    _salt(seq, request, h)
    return None


def _attach_embeds(engine, seq, request) -> Optional[str]:
    """Embeddings an encode worker computed: this worker needs no tower
    (a Qwen model still needs the tower's geometry for its rope)."""
    e = request["mm_embeds"]
    hidden = engine.model_cfg.hidden_size
    offsets = list(request.get("mm_offsets") or [])
    h = hashlib.blake2b(digest_size=8)
    try:
        if isinstance(e, dict):  # CLIP: [N, P, h]
            arr = np.frombuffer(e["data"], np.float32).reshape(e["shape"]).copy()
            if arr.ndim != 3 or arr.shape[0] != len(offsets):
                return "mm_embeds/mm_offsets mismatch"
            embeds, grids = arr, None
            sizes = [arr.shape[1]] * len(offsets)
        else:  # Qwen: one [P_i, h] blob per medium, with its grid
            embeds = [np.frombuffer(b["data"], np.float32).reshape(b["shape"]).copy()
                      for b in e]
            grids = [tuple(int(g) for g in b["grid"]) for b in e]
            if len(embeds) != len(offsets) or any(a.ndim != 2 for a in embeds):
                return "mm_embeds/mm_offsets mismatch"
            sizes = [a.shape[0] for a in embeds]
            arr = embeds[0] if embeds else np.zeros((0, hidden), np.float32)
    except (KeyError, TypeError, ValueError):
        return "malformed mm_embeds payload"
    if arr.shape[-1] != hidden:
        return f"mm_embeds width {arr.shape[-1]} != model hidden size {hidden}"
    if not all(_offset_ok(o, len(seq.prompt), n) for o, n in zip(offsets, sizes)):
        return "mm_offsets must be integer offsets inside the prompt"
    if grids is not None:
        if not engine.model_cfg.mrope_section:
            return "per-medium mm_embeds require an mrope language model"
        err = _runs_positions(engine, seq, list(zip(offsets, grids)))
        if err:
            return err
        seq.mm_grids = grids
    for a in (embeds if grids is not None else [embeds]):
        h.update(a.tobytes())
    seq.mm_embeds, seq.mm_offsets = embeds, offsets
    _salt(seq, request, h)
    return None


def encode_pending(engine, seqs) -> None:
    """Run the tower for every sequence whose media are not encoded yet
    (step thread); the embeddings stay on the device."""
    for s in seqs:
        if s.mm_patches is not None:
            tower = engine.vision[0]
            s.mm_embeds = [encode_patches(tower, torch.from_numpy(a), g)
                           for a, g in zip(s.mm_patches, s.mm_grids)]
            s.mm_patches = None
        elif s.mm_pixels is not None:
            tower = engine.vision[0]
            s.mm_embeds = encode_images(tower, torch.from_numpy(s.mm_pixels).to(
                tower.device))
            s.mm_pixels = None


def prefill_extras(engine, items, S: int) -> Dict[str, torch.Tensor]:
    """A chunk's forward_prefill keywords: ``extra_embeds`` [B, S, h] and
    ``extra_mask`` [B, S] covering every media run the chunk intersects
    and, for M-RoPE models, ``mm_positions`` [B, 3, S].  Empty when no
    row carries media."""
    if not any(it.seq.mm_embeds is not None for it in items):
        return {}
    dev = engine.device
    B = len(items)
    h = engine.model_cfg.hidden_size
    extra = torch.zeros((B, S, h), dtype=torch.float32, device=dev)
    mask = np.zeros((B, S), bool)
    mrope = bool(engine.model_cfg.mrope_section)
    pos = np.zeros((B, 3, S), np.int64) if mrope else None
    for i, it in enumerate(items):
        s = it.seq
        lo, hi = it.chunk_start, it.chunk_start + it.chunk_len
        if mrope:
            if s.mm_positions is not None:
                w = min(hi, s.mm_positions.shape[1]) - lo
                pos[i, :, :max(w, 0)] = s.mm_positions[:, lo:lo + max(w, 0)]
            else:
                pos[i, :, :] = lo + np.arange(S)
        if s.mm_embeds is None:
            continue
        per = (list(s.mm_embeds) if isinstance(s.mm_embeds, list)
               else [s.mm_embeds[n] for n in range(s.mm_embeds.shape[0])])
        for emb, off in zip(per, s.mm_offsets):
            a, b = max(off, lo), min(off + emb.shape[0], hi)
            if b > a:
                extra[i, a - lo:b - lo] = torch.as_tensor(
                    emb[a - off:b - off], device=dev).float()
                mask[i, a - lo:b - lo] = True
    out = {"extra_embeds": extra,
           "extra_mask": torch.from_numpy(mask).to(dev)}
    if mrope:
        out["mm_positions"] = torch.from_numpy(pos).to(dev)
    return out


def rope_offsets(rows) -> np.ndarray:
    """[B] int64: each row's M-RoPE delta (0 for padding and text)."""
    return np.asarray([s.rope_delta if s is not None else 0 for s in rows],
                      np.int64)
