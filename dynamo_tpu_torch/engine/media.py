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
  step thread (between dispatches), once per sequence; in a dp x tp group
  only the leader holds a tower and runs it (JAX `_encode_mm` on the
  leader, `dynamo_tpu/engine/engine.py:2794-2796`).
- `chunk_media` collects a prefill pass's media (JAX `_mm_arrays`): for
  each row whose sequence carries media, the chunk's slice of each run
  (the masked positions only, in the model's dtype: the model casts the
  embeddings to its own dtype before splicing them, so this is exact),
  its mask and, for M-RoPE models, the row's three rope streams.
  `to_wire` / `from_wire` carry it on a group's prefill plan as raw bytes
  (`lockstep.plan_pack`), so every rank splices the leader's bits.
- `block_extras` puts a replica's block of those rows on its device as the
  forward's ``extra_embeds`` / ``extra_mask`` / ``mm_positions``: rows of
  other replicas' blocks are not its to splice (JAX shards the embeddings
  with the per-rank batch blocks, `engine.py:1544-1548`), and a block
  without a media row takes the text variant (its rows rope text-style,
  which equals M-RoPE with three equal streams bit for bit).
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


def _runs(s) -> List[tuple]:
    """(offset, [P, h] embeddings) of each medium of `s`, by offset."""
    per = (list(s.mm_embeds) if isinstance(s.mm_embeds, list)
           else [s.mm_embeds[n] for n in range(s.mm_embeds.shape[0])])
    return sorted(zip(s.mm_offsets, per), key=lambda r: r[0])


def chunk_media(engine, rows, S: int) -> Optional[Dict[str, Any]]:
    """The media of a prefill pass whose row layout is `rows` (PrefillItem
    or None) and chunk width `S`, or None when no row carries media:
    ``rows`` [M] the layout's media rows, ``mask`` [M, S] the positions
    their embeddings replace, ``embeds`` [mask.sum(), h] those embeddings
    in row-major mask order (on the engine's device, in the model's dtype)
    and, for an M-RoPE model, ``pos`` [M, 3, S] int32 the rows' rope
    streams."""
    idx = [i for i, it in enumerate(rows)
           if it is not None and it.seq.mm_embeds is not None]
    if not idx:
        return None
    dev, dtype = engine.device, engine.model.dtype
    mrope = bool(engine.model_cfg.mrope_section)
    mask = np.zeros((len(idx), S), bool)
    pos = np.zeros((len(idx), 3, S), np.int32) if mrope else None
    parts = []
    for j, i in enumerate(idx):
        it = rows[i]
        s, lo, hi = it.seq, it.chunk_start, it.chunk_start + it.chunk_len
        if mrope:
            if s.mm_positions is not None:
                w = max(min(hi, s.mm_positions.shape[1]) - lo, 0)
                pos[j, :, :w] = s.mm_positions[:, lo:lo + w]
            else:
                pos[j, :, :] = lo + np.arange(S)
        for off, emb in _runs(s):
            a, b = max(off, lo), min(off + emb.shape[0], hi)
            if b > a:
                parts.append(torch.as_tensor(emb[a - off:b - off],
                                             device=dev).to(dtype))
                mask[j, a - lo:b - lo] = True
    h = engine.model_cfg.hidden_size
    out = {"rows": np.asarray(idx, np.int64), "mask": mask,
           "embeds": (torch.cat(parts) if parts
                      else torch.zeros((0, h), dtype=dtype, device=dev))}
    if mrope:
        out["pos"] = pos
    return out


def to_wire(mm: Dict[str, Any]) -> Dict[str, Any]:
    """`chunk_media`'s result as host arrays for a plan: the embeddings as
    their raw bytes with dtype and shape (bf16 has no numpy dtype)."""
    e = mm["embeds"].contiguous()
    out = {"rows": mm["rows"], "mask": mm["mask"],
           "embeds": e.view(torch.uint8).cpu().numpy(),
           "dtype": str(e.dtype).split(".")[-1], "shape": list(e.shape)}
    if "pos" in mm:
        out["pos"] = mm["pos"]
    return out


def from_wire(engine, w: Dict[str, Any]) -> Dict[str, Any]:
    """A plan's media back on this rank's device, checked against what
    the plan's mask and this model need (a malformed payload raises:
    the follower refuses the plan)."""
    rows, mask = np.asarray(w["rows"]), np.asarray(w["mask"], bool)
    n, h = w["shape"]
    if w["dtype"] != str(engine.model.dtype).split(".")[-1]:
        raise ValueError(f"media embeddings in {w['dtype']}, the model "
                         f"computes in {engine.model.dtype}")
    if (mask.ndim != 2 or rows.shape != (mask.shape[0],)
            or n != int(mask.sum()) or h != engine.model_cfg.hidden_size):
        raise ValueError("a prefill plan's media rows, mask and embeddings "
                         "disagree")
    raw = torch.from_numpy(np.ascontiguousarray(w["embeds"]).reshape(-1))
    out = {"rows": rows, "mask": mask,
           "embeds": (raw.to(engine.device).view(engine.model.dtype)
                      .reshape(n, h) if n else
                      torch.zeros((0, h), dtype=engine.model.dtype,
                                  device=engine.device))}
    if "pos" in w:
        pos = np.asarray(w["pos"])
        if pos.shape != (mask.shape[0], 3, mask.shape[1]):
            raise ValueError("a prefill plan's rope streams do not match its "
                             "media rows")
        out["pos"] = pos
    return out


def block_extras(engine, mm: Optional[Dict[str, Any]], span, prefix
                 ) -> Dict[str, torch.Tensor]:
    """The forward_prefill keywords of one replica's block of a pass: the
    rows ``span`` = (first row, rows) of the layout, whose chunks start at
    ``prefix`` (the block's [n] device tensor).  ``extra_embeds`` [n, S, h]
    and ``extra_mask`` [n, S] splice in the block's media rows, and an
    M-RoPE model's ``mm_positions`` [n, 3, S] give them their streams
    (other rows of the block rope text-style: their sequential positions).
    Empty when the block holds no media row.  Records (the block's rows,
    the layout rows spliced) in ``engine.media_rows``."""
    if mm is None:
        return {}
    lo, n = span
    rows = mm["rows"]
    keep = (rows >= lo) & (rows < lo + n)
    if not keep.any():
        return {}
    engine.media_rows.append((n, [int(r) for r in rows[keep]]))
    S = mm["mask"].shape[1]
    counts = mm["mask"].sum(1)
    start = np.concatenate([[0], np.cumsum(counts)])
    first, last = np.flatnonzero(keep)[[0, -1]]
    dev = engine.device
    mask = np.zeros((n, S), bool)
    mask[rows[keep] - lo] = mm["mask"][keep]
    mask_d = torch.from_numpy(mask).to(dev)
    extra = torch.zeros((n, S, engine.model_cfg.hidden_size),
                        dtype=engine.model.dtype, device=dev)
    extra[mask_d] = mm["embeds"][start[first]:start[last + 1]]
    out = {"extra_embeds": extra, "extra_mask": mask_d}
    if "pos" in mm:
        pos = (prefix.long()[:, None, None]
               + torch.arange(S, device=dev)[None, None, :]).expand(
                   n, 3, S).clone()
        pos[torch.from_numpy(rows[keep] - lo).to(dev)] = torch.from_numpy(
            mm["pos"][keep].astype(np.int64)).to(dev)
        out["mm_positions"] = pos
    return out


def rope_offsets(rows) -> np.ndarray:
    """[B] int64: each row's M-RoPE delta (0 for padding and text)."""
    return np.asarray([s.rope_delta if s is not None else 0 for s in rows],
                      np.int64)
