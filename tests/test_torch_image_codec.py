"""The port's host image codec (`dynamo_tpu_torch/llm/image_codec.py`)
against PIL 12, which the JAX package decodes and resizes with.

Byte-equal, every case: PNGs of every colour type the codec takes (8-bit
grey, grey + alpha, RGB, RGBA, palettes of 1, 2, 4 and 8 bits) written with
each of the five row filters by hand and by PIL's own encoder; APNG frames
with every dispose and blend operation, full frames and sub-frames;
BILINEAR and BICUBIC resizes up and down.  Refused with a 400 naming the
format: JPEG, GIF, WebP, interlaced PNG and 16-bit PNG.
"""

import base64
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from dynamo_tpu_torch.llm import image_codec as ic
from dynamo_tpu_torch.llm.multimodal import process_frames, process_image
from dynamo_tpu_torch.llm.preprocessor import RequestError


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def encode_png(rows_bytes, w, h, ctype, depth, filters, palette=None,
               interlace=0):
    """A PNG whose row r is written with filter filters[r]."""
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpp = max(1, ch * depth // 8)
    prev = bytes(len(rows_bytes[0]))
    out = bytearray()
    for r, raw in enumerate(rows_bytes):
        f = filters[r % len(filters)]
        line = bytearray([f])
        for i, x in enumerate(raw):
            a = raw[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][f]
            line.append((x - pred) & 255)
        out += line
        prev = raw
    png = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        png += _chunk(b"PLTE", palette.tobytes())
    return png + _chunk(b"IDAT", zlib.compress(bytes(out))) + _chunk(b"IEND", b"")


def _pil_rgb(raw):
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


@pytest.mark.parametrize("ctype,depth", [(0, 8), (4, 8), (2, 8), (6, 8), (3, 8),
                                         (3, 4), (3, 2), (3, 1)])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_hand_filtered_png_equals_pil(ctype, depth, filters):
    rng = np.random.default_rng(ctype * 10 + depth)
    w, h = 23, 17
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    pal = None
    if ctype == 3:
        idx = rng.integers(0, 1 << depth, (h, w)).astype(np.uint8)
        bits = np.unpackbits(idx[..., None], axis=2)[..., 8 - depth:]
        rows = [np.packbits(bits[r].reshape(-1)).tobytes() for r in range(h)]
        pal = rng.integers(0, 256, (1 << depth, 3)).astype(np.uint8)
    else:
        px = rng.integers(0, 256, (h, w, ch)).astype(np.uint8)
        px[::4] //= 3  # some structure for the predictors
        rows = [px[r].tobytes() for r in range(h)]
    raw = encode_png(rows, w, h, ctype, depth, filters, pal)
    assert np.array_equal(ic.decode_frames(raw)[0], _pil_rgb(raw))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
@pytest.mark.parametrize("size", [(37, 23), (64, 64), (5, 90)])
def test_pil_written_png_equals_pil(mode, size):
    rng = np.random.default_rng(len(mode) * 100 + size[0])
    w, h = size
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 1}[mode]
    arr = rng.integers(0, 256, (h, w, ch)).astype(np.uint8)
    arr[::3] //= 4
    if mode == "P":
        im = Image.fromarray(arr[..., 0], "L").convert("P")
        im.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tobytes())
    else:
        im = Image.fromarray(arr[..., 0] if ch == 1 else arr, mode)
    buf = io.BytesIO()
    im.save(buf, format="PNG", optimize=bool(w % 2))
    raw = buf.getvalue()
    assert np.array_equal(ic.decode_frames(raw)[0], _pil_rgb(raw))
    assert ic.image_size(raw) == (w, h)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("disposal", [0, 1, 2])
@pytest.mark.parametrize("blend", [0, 1])
@pytest.mark.parametrize("sub", [False, True], ids=["full", "subframes"])
def test_apng_frames_equal_pil(mode, disposal, blend, sub):
    rng = np.random.default_rng(disposal * 4 + blend * 2 + sub)
    ch = len(mode)
    base = rng.integers(0, 256, (20, 30, ch)).astype(np.uint8)
    if ch == 4:
        base[..., 3] = rng.choice([0, 90, 255], (20, 30))
    frames = [base]
    for i in range(1, 5):
        a = base.copy() if sub else rng.integers(0, 256, (20, 30, ch)).astype(np.uint8)
        y, x = 2 + i, 3 + 2 * i
        a[y:y + 6, x:x + 9] = rng.integers(0, 256, (6, 9, ch))
        if ch == 4:
            a[..., 3] = np.where(a[..., 3] > 128, 255, a[..., 3])
        frames.append(a)
    ims = [Image.fromarray(f, mode) for f in frames]
    buf = io.BytesIO()
    ims[0].save(buf, format="PNG", save_all=True, append_images=ims[1:],
                disposal=disposal, blend=blend)
    raw = buf.getvalue()
    pil = Image.open(io.BytesIO(raw))
    want = []
    for i in range(pil.n_frames):
        pil.seek(i)
        want.append(np.asarray(pil.convert("RGB")))
    got = ic.decode_frames(raw)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    # uniform sampling down to 3 frames, as the video path asks
    assert [np.array_equal(g, want[i]) for g, i in
            zip(ic.decode_frames(raw, 3), (0, 2, 4))] == [True] * 3


@pytest.mark.parametrize("kind", ["bilinear", "bicubic"])
@pytest.mark.parametrize("src,dst", [((37, 23), (16, 16)), ((37, 23), (56, 28)),
                                     ((64, 48), (448, 252)), ((300, 200), (28, 14)),
                                     ((5, 90), (3, 7)), ((40, 32), (40, 64))])
def test_resize_equals_pil(kind, src, dst):
    rng = np.random.default_rng(src[0] * dst[0])
    arr = rng.integers(0, 256, (src[1], src[0], 3)).astype(np.uint8)
    arr[::5] //= 3
    flt = Image.BILINEAR if kind == "bilinear" else Image.BICUBIC
    want = np.asarray(Image.fromarray(arr).resize(dst, flt))
    assert np.array_equal(ic.resize(arr, dst[0], dst[1], kind), want)


def test_media_paths_equal_pil():
    """`process_image` (CLIP, BILINEAR to a square) and `process_frames`
    (Qwen, BICUBIC to the grid) give PIL's floats."""
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 256, (33, 47, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    raw = buf.getvalue()
    want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB").resize(
        (32, 32), Image.BILINEAR), np.float32) / 255.0
    assert np.array_equal(process_image(raw, 32), want)
    want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB").resize(
        (56, 28), Image.BICUBIC), np.float32) / 255.0
    assert np.array_equal(process_frames(raw, 28, 56, max_frames=1)[0], want)


def _saved(fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format=fmt, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("fmt,name", [("JPEG", "JPEG"), ("GIF", "GIF"),
                                      ("WEBP", "WebP")])
def test_other_formats_refused_by_name(fmt, name):
    raw = _saved(fmt)
    with pytest.raises(ic.ImageError, match=name):
        ic.decode_frames(raw)
    with pytest.raises(RequestError, match=name):
        process_image(raw, 32)


def test_interlaced_and_16bit_png_refused():
    rows = [bytes(6)] * 2
    with pytest.raises(ic.ImageError, match="interlaced"):
        ic.decode_frames(encode_png(rows, 2, 2, 2, 8, [0], interlace=1))
    with pytest.raises(ic.ImageError, match="16-bit"):
        ic.decode_frames(encode_png([bytes(12)] * 2, 2, 2, 2, 16, [0]))


def test_preprocessor_answers_400_for_jpeg():
    """A chat with a JPEG data URI is a RequestError (HTTP 400) naming the
    format, on a vision model's preprocessor."""
    from dynamo_tpu_torch.llm import ModelDeploymentCard, OpenAIPreprocessor
    from dynamo_tpu_torch.testing import tiny_tokenizer

    tok = tiny_tokenizer()
    pre = OpenAIPreprocessor(ModelDeploymentCard(
        name="v", tokenizer_json=tok.to_json_str(), image_token="<image>",
        image_token_id=tok.encode("<image>")[0], mm_arch="clip",
        image_patches=16, image_size=32), tok)
    uri = "data:image/jpeg;base64," + base64.b64encode(_saved("JPEG")).decode()
    with pytest.raises(RequestError, match="JPEG"):
        pre.preprocess_chat({"messages": [{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": uri}}]}]})
