"""A host image codec in numpy and zlib: PNG and APNG decoding and PIL's
resampling, for machines without PIL.

The JAX package decodes and resizes media with PIL (`llm/multimodal.py`);
the port carries its own, and holds it byte-equal to PIL 12 in the tests:

- `decode_frames(raw)` → a list of [H, W, 3] uint8 RGB frames: PNG of
  8-bit grey, grey + alpha, RGB and RGBA and 1/2/4/8-bit palette,
  non-interlaced, filters 0-4, converted as PIL's ``convert("RGB")`` does
  (alpha dropped, the palette looked up); an APNG gives every frame of its
  animation, composited as PIL's ``seek`` does (dispose none, background
  and previous; blend source and over).  Anything else raises
  `ImageError` naming the format: interlaced PNG, 16-bit or sub-byte grey,
  JPEG, GIF and WebP.
- `resize(rgb, width, height, filter)` mirrors ``Image.resize`` with
  ``BILINEAR`` or ``BICUBIC`` (a = -0.5): a separable two-pass resample,
  horizontal then vertical, with the support widened by the scale when
  downsampling, coefficients in 22-bit fixed point, and a uint8 clip
  between the passes.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

PNG_SIG = b"\x89PNG\r\n\x1a\n"
MAX_PIXELS = 64 << 20  # refuse decompression bombs before inflating
PRECISION_BITS = 32 - 8 - 2  # PIL's fixed-point coefficients (Resample.c)


class ImageError(ValueError):
    """An image this codec does not decode (the message names why)."""


def sniff(raw: bytes) -> str:
    if raw.startswith(PNG_SIG):
        return "png"
    if raw.startswith(b"\xff\xd8\xff"):
        return "jpeg"
    if raw[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    if raw[:4] == b"RIFF" and raw[8:12] == b"WEBP":
        return "webp"
    return "unknown"


# -- PNG ------------------------------------------------------------------- #

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type → samples a pixel


def _chunks(raw: bytes):
    i = len(PNG_SIG)
    while i + 8 <= len(raw):
        n, kind = struct.unpack(">I4s", raw[i:i + 8])
        data = raw[i + 8:i + 8 + n]
        if len(data) != n:
            raise ImageError("truncated PNG chunk")
        yield kind, data
        i += 12 + n
        if kind == b"IEND":
            return
    raise ImageError("PNG without IEND")


def _unfilter(data: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth).  Pixel
    (r, x) depends on (r, x-1), (r-1, x) and (r-1, x-1), so the pixels of
    one anti-diagonal are independent: the rows are undone together, one
    diagonal at a time."""
    buf = np.frombuffer(data, np.uint8)
    if buf.size < h * (row_bytes + 1):
        raise ImageError("truncated PNG image data")
    buf = buf[:h * (row_bytes + 1)].reshape(h, row_bytes + 1)
    ftype = buf[:, 0].astype(np.int64)
    if ftype.max(initial=0) > 4:
        raise ImageError(f"unknown PNG filter {int(ftype.max())}")
    w = row_bytes // bpp
    filt = buf[:, 1:].reshape(h, w, bpp).astype(np.int64)
    out = np.zeros((h + 1, w + 1, bpp), np.int64)  # a zero row and column
    if not (ftype >= 3).any():  # no Average or Paeth row: whole rows at once
        for r in range(h):
            f, a = ftype[r], filt[r]
            if f == 1:
                a = np.cumsum(a, axis=0)
            elif f == 2:
                a = a + out[r, 1:]
            out[r + 1, 1:] = a & 255
        return out[1:, 1:].astype(np.uint8).reshape(h, row_bytes)
    rows = np.arange(h)
    for d in range(h + w - 1):
        r = rows[max(0, d - w + 1):min(h, d + 1)]
        x = d - r
        a = out[r + 1, x]          # left
        b = out[r, x + 1]          # up
        c = out[r, x]              # up-left
        f = ftype[r][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([f == 0, f == 1, f == 2, f == 3],
                         [0, a, b, (a + b) >> 1], paeth)
        out[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8).reshape(h, row_bytes)


class _Png:
    def __init__(self, raw: bytes):
        self.palette: Optional[np.ndarray] = None
        self.frames: List[dict] = []  # fcTL fields + data
        idat = []
        pending: Optional[dict] = None
        self.default_is_frame = False
        seen_idat = False
        for kind, data in _chunks(raw):
            if kind == b"IHDR":
                (self.w, self.h, self.depth, self.ctype, comp, filt,
                 self.interlace) = struct.unpack(">IIBBBBB", data)
            elif kind == b"PLTE":
                self.palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
            elif kind == b"fcTL":
                (_, fw, fh, fx, fy, _, _, dispose, blend) = struct.unpack(
                    ">IIIIIHHBB", data[:26])
                pending = {"w": fw, "h": fh, "x": fx, "y": fy,
                           "dispose": dispose, "blend": blend, "data": []}
                self.frames.append(pending)
                if not seen_idat:
                    self.default_is_frame = True
            elif kind == b"IDAT":
                seen_idat = True
                idat.append(data)
                if pending is not None and self.default_is_frame:
                    pending["data"].append(data)
            elif kind == b"fdAT":
                if pending is None:
                    raise ImageError("APNG fdAT before fcTL")
                pending["data"].append(data[4:])
        if not hasattr(self, "w"):
            raise ImageError("PNG without IHDR")
        if self.interlace:
            raise ImageError("interlaced PNG is not supported")
        if self.ctype not in _CHANNELS:
            raise ImageError(f"PNG colour type {self.ctype} is not supported")
        if self.ctype == 3:
            if self.depth not in (1, 2, 4, 8):
                raise ImageError(f"palette PNG of depth {self.depth}")
            if self.palette is None:
                raise ImageError("palette PNG without PLTE")
        elif self.depth != 8:
            raise ImageError(f"{self.depth}-bit PNG is not supported (8-bit only)")
        if self.w * self.h > MAX_PIXELS:
            raise ImageError("image exceeds the pixel limit")
        self.idat = b"".join(idat)

    def rgb(self, data: bytes, w: int, h: int) -> np.ndarray:
        """[h, w, 3] uint8 of one (sub)image's compressed data, and its
        alpha [h, w] (255 where the image has none)."""
        try:
            raw = zlib.decompress(data)
        except zlib.error as e:
            raise ImageError(f"corrupt PNG data: {e}") from None
        ch = _CHANNELS[self.ctype]
        bits = ch * self.depth
        row_bytes = (w * bits + 7) // 8
        px = _unfilter(raw, h, row_bytes, max(1, bits // 8))
        if self.ctype == 3:
            if self.depth < 8:
                px = np.unpackbits(px, axis=1)
                px = px.reshape(h, -1, self.depth)[:, :w]
                px = (px * (1 << np.arange(self.depth - 1, -1, -1))).sum(-1)
            idx = px.reshape(h, w).astype(np.int64)
            pal = np.zeros((256, 3), np.uint8)
            pal[:len(self.palette)] = self.palette
            return pal[idx], np.full((h, w), 255, np.uint8)
        px = px.reshape(h, w, ch)
        if ch <= 2:  # grey (+ alpha)
            rgb = np.repeat(px[..., :1], 3, axis=2)
        else:
            rgb = px[..., :3]
        alpha = px[..., -1] if ch in (2, 4) else np.full((h, w), 255, np.uint8)
        return np.ascontiguousarray(rgb), alpha


def _blend_over(dst: np.ndarray, src: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """PIL's ``paste(src, box, mask)``: every channel moves towards src
    by mask / 255 in PIL's integer rounding."""
    d, s = dst.astype(np.int64), src.astype(np.int64)
    m = mask.astype(np.int64)[..., None]
    t = d * (255 - m) + s * m + 128
    return (((t >> 8) + t) >> 8).astype(np.uint8)


def decode_frames(raw: bytes, max_frames: int = 0) -> List[np.ndarray]:
    """Encoded PNG / APNG bytes → RGB frames [H, W, 3] uint8 (all of an
    animation's, or `max_frames` sampled uniformly when it has more)."""
    kind = sniff(raw)
    if kind != "png":
        name = {"jpeg": "JPEG", "gif": "GIF", "webp": "WebP"}.get(kind)
        raise ImageError(f"{name} images are not supported (PNG and APNG only)"
                         if name else "unrecognised image format (PNG and APNG only)")
    png = _Png(raw)
    if not png.frames or not png.default_is_frame:
        rgb, _ = png.rgb(png.idat, png.w, png.h)
        return [rgb]
    n = len(png.frames)
    want = (range(n) if not max_frames or n <= max_frames else
            np.linspace(0, n - 1, max_frames).round().astype(int).tolist())
    want = set(int(i) for i in want)
    canvas = np.zeros((png.h, png.w, 3), np.uint8)
    out = []
    for i, fr in enumerate(png.frames):
        x, y, fw, fh = fr["x"], fr["y"], fr["w"], fr["h"]
        if x + fw > png.w or y + fh > png.h:
            raise ImageError("APNG frame outside the canvas")
        dispose = fr["dispose"]
        if i == 0 and dispose == 2:
            dispose = 1  # PIL: nothing to restore before the first frame
        prev = canvas.copy() if dispose == 2 else None
        rgb, alpha = png.rgb(b"".join(fr["data"]), fw, fh)
        region = canvas[y:y + fh, x:x + fw]
        if fr["blend"] == 1 and i > 0:
            canvas[y:y + fh, x:x + fw] = _blend_over(region, rgb, alpha)
        else:
            canvas[y:y + fh, x:x + fw] = rgb
        if i in want:
            out.append(canvas.copy())
        if dispose == 1:
            canvas[y:y + fh, x:x + fw] = 0
        elif dispose == 2:
            canvas = prev
    return out


# -- resampling (PIL's Resample.c) ----------------------------------------- #

def _bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x, a=-0.5):
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def _coeffs(in_size: int, out_size: int, kind: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(xmin [out], xmax [out], fixed-point weights [out, ksize]) of one
    axis (`precompute_coeffs` + `normalize_coeffs_8bpc`)."""
    fn, support = FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    j = np.arange(ksize)
    w = fn((j[None, :] + xmin[:, None] - center[:, None] + 0.5) * ss)
    w = np.where(j[None, :] < xmax[:, None], w, 0.0)
    ww = w.sum(axis=1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    k = w * (1 << PRECISION_BITS)
    k = np.where(w < 0, np.trunc(-0.5 + k), np.trunc(0.5 + k)).astype(np.int64)
    return xmin, xmax, k


def _pass(img: np.ndarray, out_size: int, kind: str) -> np.ndarray:
    """Resample axis 1 of img [rows, in, 3] uint8 to out_size."""
    xmin, _, k = _coeffs(img.shape[1], out_size, kind)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None, :], img.shape[1] - 1)
    out = np.empty((img.shape[0], out_size, img.shape[2]), np.uint8)
    step = max(1, (1 << 22) // (idx.size * img.shape[2]))  # bounded temporaries
    for r in range(0, img.shape[0], step):
        acc = np.einsum("rojc,oj->roc", img[r:r + step, idx, :].astype(np.int64), k)
        acc = (acc + (1 << (PRECISION_BITS - 1))) >> PRECISION_BITS
        out[r:r + step] = np.clip(acc, 0, 255)
    return out


def resize(rgb: np.ndarray, width: int, height: int, kind: str = "bicubic") -> np.ndarray:
    """[H, W, 3] uint8 → [height, width, 3] uint8, as PIL's
    ``Image.resize((width, height), BILINEAR | BICUBIC)``."""
    if kind not in FILTERS:
        raise ValueError(f"resample filter {kind!r} not in {sorted(FILTERS)}")
    H, W = rgb.shape[:2]
    out = rgb
    if width != W:
        out = _pass(out, width, kind)
    if height != H:
        out = _pass(out.transpose(1, 0, 2), height, kind).transpose(1, 0, 2)
    return np.ascontiguousarray(out)


def image_size(raw: bytes) -> Tuple[int, int]:
    """(width, height) from the header alone."""
    if sniff(raw) != "png":
        decode_frames(raw)  # raises, naming the format
    png = _Png(raw)
    return png.w, png.h
