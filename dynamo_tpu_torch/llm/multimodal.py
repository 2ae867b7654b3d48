"""Media input: loading, decoding and the wire format of multimodal
requests (the JAX package's `llm/multimodal.py`).

Media load from `data:` URIs, or from files under ``DYN_IMAGE_FILE_ROOT``
when the operator sets it (arbitrary egress and local paths stay off).
Decoding and resizing use the port's own codec (`image_codec.py`: PNG and
APNG, PIL's BILINEAR / BICUBIC resample, byte-equal to PIL); other formats
answer 400 naming the format.

Wire format (rides the engine request):
    "mm_pixels": {"shape": [N, H, W, 3], "data": <f32 bytes>}   (CLIP)
    "mm_patches": [{"shape": [L, patch_dim], "data": <f32 bytes>,
                    "grid": [t, h, w]}, ...]                    (Qwen)
    "mm_offsets": [token offset of each medium's run]
    "mm_embeds": {"shape": [N, P, h], "data"} or, per medium,
                 [{"shape": [P, h], "data", "grid"}, ...]       (encoded)
"""

from __future__ import annotations

import base64
import binascii
import os
from typing import Any, Dict, List, Tuple

import numpy as np

from . import image_codec
from .preprocessor import RequestError

# refuse absurd payloads before decoding them (decompression bombs)
MAX_IMAGE_BYTES = 32 << 20
MAX_VIDEO_FRAMES = 16


def _image_file_root() -> str:
    """Local-file media are off unless DYN_IMAGE_FILE_ROOT names a
    directory; only files under it are readable."""
    return os.environ.get("DYN_IMAGE_FILE_ROOT", "").strip()


def load_image_bytes(url: str) -> bytes:
    """data: URI (always) or a path under DYN_IMAGE_FILE_ROOT (opt-in) →
    the encoded bytes."""
    if url.startswith("data:"):
        try:
            header, payload = url.split(",", 1)
        except ValueError:
            raise RequestError("malformed data: URI") from None
        if ";base64" not in header:
            raise RequestError("data: URIs must be base64-encoded")
        try:
            raw = base64.b64decode(payload, validate=True)
        except (binascii.Error, ValueError):
            raise RequestError("invalid base64 image payload") from None
    elif url.startswith("file://") or url.startswith("/"):
        root = _image_file_root()
        if not root:
            raise RequestError("local image files are disabled (set DYN_IMAGE_FILE_ROOT)")
        path = url[len("file://"):] if url.startswith("file://") else url
        real = os.path.realpath(path)
        if not real.startswith(os.path.realpath(root) + os.sep):
            raise RequestError("image path outside DYN_IMAGE_FILE_ROOT")
        if not os.path.isfile(real):
            raise RequestError("image file not found")
        with open(real, "rb") as f:
            raw = f.read()
    else:
        raise RequestError("only data: URIs (and DYN_IMAGE_FILE_ROOT paths) are supported")
    if len(raw) > MAX_IMAGE_BYTES:
        raise RequestError("image exceeds the 32MB limit")
    return raw


def _frames(raw: bytes, max_frames: int = 0) -> List[np.ndarray]:
    try:
        return image_codec.decode_frames(raw, max_frames)
    except image_codec.ImageError as e:
        raise RequestError(f"cannot decode image: {e}") from None


def image_size(raw: bytes) -> Tuple[int, int]:
    """(width, height) of encoded media."""
    try:
        return image_codec.image_size(raw)
    except image_codec.ImageError as e:
        raise RequestError(f"cannot decode media: {e}") from None


def process_image(raw: bytes, image_size: int) -> np.ndarray:
    """Encoded bytes → [H, W, 3] float32 in [0, 1] at the tower's square
    input size (BILINEAR, as the CLIP path resizes)."""
    rgb = _frames(raw, 1)[0]
    out = image_codec.resize(rgb, image_size, image_size, "bilinear")
    return out.astype(np.float32) / 255.0


def process_frames(raw: bytes, height: int, width: int,
                   max_frames: int = MAX_VIDEO_FRAMES) -> np.ndarray:
    """An image or APNG → [T, H, W, 3] float32 in [0, 1], frames sampled
    uniformly down to `max_frames`, resized BICUBIC (the Qwen image
    processor's default)."""
    frames = _frames(raw, max_frames)
    if not frames:
        raise RequestError("media contains no frames")
    return np.stack([image_codec.resize(f, width, height, "bicubic")
                     for f in frames]).astype(np.float32) / 255.0


def extract_media(messages: List[Dict[str, Any]]) -> List[Dict[str, str]]:
    """image_url and video_url parts in reading order: [{"kind": "image" |
    "video", "url": ...}]."""
    media = []
    for m in messages:
        content = m.get("content")
        if not isinstance(content, list):
            continue
        for part in content:
            if not isinstance(part, dict):
                continue
            kind = part.get("type")
            if kind in ("image_url", "video_url"):
                url = (part.get(kind) or {}).get("url")
                if not url:
                    raise RequestError(f"{kind} part missing 'url'")
                media.append({"kind": kind.split("_")[0], "url": url})
    return media


def expand_media_tokens(token_ids: List[int], media_token_id: int,
                        counts: List[int]) -> Tuple[List[int], List[int]]:
    """Replace the i-th media placeholder with counts[i] copies; returns
    (expanded ids, start offset of each run)."""
    found = [i for i, t in enumerate(token_ids) if t == media_token_id]
    if len(found) != len(counts):
        raise RequestError(f"prompt contains {len(found)} media placeholder(s) "
                           f"for {len(counts)} media item(s)")
    out: List[int] = []
    offsets: List[int] = []
    prev = 0
    for idx, n in zip(found, counts):
        out.extend(token_ids[prev:idx])
        offsets.append(len(out))
        out.extend([media_token_id] * n)
        prev = idx + 1
    out.extend(token_ids[prev:])
    return out, offsets


def expand_image_tokens(token_ids: List[int], image_token_id: int,
                        n_images: int, patches_per_image: int):
    """`expand_media_tokens` with one fixed count (CLIP towers)."""
    return expand_media_tokens(token_ids, image_token_id,
                               [patches_per_image] * n_images)


def pack_pixels(pixels: np.ndarray) -> Dict[str, Any]:
    pixels = np.ascontiguousarray(pixels, np.float32)
    return {"shape": list(pixels.shape), "data": pixels.tobytes()}


def unpack_pixels(blob: Dict[str, Any]) -> np.ndarray:
    return np.frombuffer(blob["data"], np.float32).reshape(blob["shape"])


def pack_patches(patches: np.ndarray, grid) -> Dict[str, Any]:
    patches = np.ascontiguousarray(patches, np.float32)
    return {"shape": list(patches.shape), "data": patches.tobytes(),
            "grid": [int(g) for g in grid]}


def unpack_patches(blob: Dict[str, Any]) -> Tuple[np.ndarray, tuple]:
    arr = np.frombuffer(blob["data"], np.float32).reshape(blob["shape"])
    return arr, tuple(int(g) for g in blob["grid"])
