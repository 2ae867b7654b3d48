"""The arithmetic of the segment attention kernel (`csrc/vision_attention.cu`)
emulated on the CPU, against the JAX towers' masked form.

The kernel runs both products of attention on the tensor cores in TF32
(10 mantissa bits) and keeps f32 accuracy by splitting each f32 operand
into x = hi + lo, hi = tf32(x) and lo = tf32(x - hi), and each product
into three passes, lo*hi + hi*lo + hi*hi, accumulated in f32 ("3xTF32").
Here TF32 is emulated through the f32 bit pattern (round to nearest, ties
away: what `cvt.rna.tf32.f32` does), with the kernel's order of work: q
pre-scaled by hd^-0.5 * log2(e) before the split, K's hi its raw f32 as the
tensor cores read it (the top 19 bits: truncated) and its lo rounded from
the exact rest, an exp2 softmax whose denominator sums the f32
probabilities, P and V split by rounding for P.V.

At phase 3's input scales (q std 2, k and v std 1) and the towers' head
dims, three passes stay within 1e-5 of the JAX form on every output row
(row-relative: the row's largest error over its largest value), and one
TF32 pass does not hold 1e-4: the reason the kernel takes three.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import qwen_vl as jq
from dynamo_tpu_torch.models import qwen_vl as tq
from test_torch_vision import _jax_masked

LOG2E = 1.4426950408889634


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (the low 13 bits of the pattern cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor cores read from an f32 register."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor, raw_hi: bool = False):
    hi = trunc_tf32(x) if raw_hi else tf32(x)
    return hi, tf32(x - hi)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor, passes: int,
                b_raw_hi: bool = False) -> torch.Tensor:
    """a @ b on emulated TF32 tensor cores: one pass (hi*hi) or three
    (lo*hi, hi*lo, hi*hi, small terms first), f32 sums.  Products of two
    TF32 values are exact in f32."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b, b_raw_hi)
    if passes == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def segment_attention_tf32(q, k, v, cu, passes: int) -> torch.Tensor:
    """The kernel's arithmetic per segment and head: [L, nh, hd] f32."""
    hd = q.shape[-1]
    out = torch.empty_like(q)
    qs = q * np.float32(LOG2E / math.sqrt(hd))  # pre-scaled before the split
    for a, b in zip(cu[:-1], cu[1:]):
        qh, kh, vh = (t[a:b].transpose(0, 1) for t in (qs, k, v))
        s = matmul_tf32(qh, kh.transpose(1, 2), passes, b_raw_hi=True)  # log2 units
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        o = matmul_tf32(p, vh, passes) / p.sum(-1, keepdim=True)
        out[a:b] = o.transpose(0, 1)
    return out


def _row_rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """Phase 3's measure: each output row's largest error over that row's
    largest reference value, at its worst."""
    d = np.abs(got - want).max(-1)
    return float((d / np.maximum(np.abs(want).max(-1), 1e-30)).max())


def _layout(name):
    """(cu_seqlens, JAX segment ids of the same stream, head dim, stream
    order) of a tiny Qwen tower's frames or windows, or one CLIP image."""
    if name == "clip":
        return [0, 577], np.zeros(577, np.int32), 64, None
    # 8 x 8 patches a window, as the 7B's 112-px windows of 14-px patches;
    # 20 x 28 patches a frame: a partial window row and column
    over = dict(window_size=32)
    grid = (1, 20, 28)
    order, cu_frames, cu_win = tq.stream_layout(grid, tq.tiny_qwen_vl_vision_config(**over))
    if name == "frames":
        return cu_frames, jq._frame_ids(grid), 80, None
    return cu_win, jq._window_ids(grid, jq.tiny_qwen_vl_vision_config(**over)), 80, order


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name in ("frames", "windows", "clip"):
        cu, seg, hd, order = _layout(name)
        L, nh = cu[-1], 2
        rng = np.random.default_rng(11)
        q, k, v = (rng.standard_normal((L, nh, hd)).astype(np.float32) * s
                   for s in (2.0, 1.0, 1.0))
        want = _jax_masked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(seg))
        if order is not None:  # the kernel's stream is in window order
            q, k, v = (t[order] for t in (q, k, v))
        got = {}
        for passes in (1, 3):
            o = segment_attention_tf32(*(torch.from_numpy(t) for t in (q, k, v)),
                                       cu, passes).numpy()
            got[passes] = o if order is None else o[np.argsort(order)]
        out[name] = (got, want, cu)
    return out


@pytest.mark.parametrize("layout", ["frames", "windows", "clip"])
def test_three_tf32_passes_hold_f32_tolerance(cases, layout):
    got, want, cu = cases[layout]
    if layout == "windows":
        assert len(cu) - 1 == 12 and max(np.diff(cu)) == 64  # 3 x 4 windows, some partial
    assert _row_rel_err(got[3], want) <= 1e-5


@pytest.mark.parametrize("layout", ["frames", "windows", "clip"])
def test_one_tf32_pass_breaks_phase3_tolerance(cases, layout):
    got, want, _ = cases[layout]
    assert _row_rel_err(got[1], want) > 1e-4


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -11 - 2.0 ** -23])
    assert tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                                -(1.0 + 2.0 ** -10), 1.0]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0)) * 3
    for raw_hi in (False, True):
        hi, lo = split(y, raw_hi)
        assert torch.equal(trunc_tf32(hi), hi) and torch.equal(tf32(lo), lo)
        assert ((hi + lo - y).abs() <= y.abs() * 2.0 ** -21).all()  # lo keeps 11 more bits
