"""Segment attention of the vision towers: every patch attends to the
patches of its own segment (a frame, a window, an image), for every head.

`segment_attention(q, k, v, cu_seqlens)` takes q, k, v [L, nh, hd] float32
and the segments as host offsets ``cu_seqlens`` [n_seg + 1] (contiguous
runs covering [0, L)), and returns [L, nh, hd] float32.  On a CUDA tensor
it launches the hand-written kernel `segment_attention_kernel`
(`csrc/vision_attention.cu`) and adds one to ``LAUNCHES
["segment_attention"]``; on a CPU tensor it runs the plain version.  It
replaces the towers' XLA ops (the masked einsum and softmax of
`dynamo_tpu/models/qwen_vl.py:280-309` and `models/vision.py:140-150`),
not a TPU kernel.

The products bound the kernel (a Qwen2.5-VL full layer is 117 GFLOP
against 98 MB), so they run on the tensor cores as TF32 `wgmma`.  TF32
keeps 10 mantissa bits, ~2e-3 of a row where the port holds f32 to 1e-4,
so every f32 operand is split into a TF32 hi and lo and every product
into three passes (lo.hi + hi.lo + hi.hi, f32 sums): the rows stay within
a few 1e-6 of the f32 result, and the bound is three TF32 passes at 495
TFLOP/s.  The layout is a host fact: the towers know their segments from
the image grid before they run, so the wrapper builds the kernel's tile
table on the host, once per layout (an LRU of the tables on the card),
and nothing waits on the device.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import numpy as np
import torch

from . import _build
from ._launches import count_launch

SOURCE = "vision_attention.cu"
TILE_ROWS = 64  # query rows of one kernel block, its consumer warpgroup's (BQ in the source)
HEAD_DIMS = tuple(range(16, 129, 16))

_P, _I = ctypes.c_void_p, ctypes.c_int


def _fn():
    fn = _build.load(SOURCE).seg_attention
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 4 + [ctypes.c_float, _P]
        fn.restype = ctypes.c_int
    return fn


def check_segments(cu_seqlens: Sequence[int], L: int) -> np.ndarray:
    """cu_seqlens as int64 offsets; raises unless they rise from 0 to L."""
    cu = np.asarray(cu_seqlens, np.int64)
    if cu.ndim != 1 or cu.size < 2 or cu[0] != 0 or cu[-1] != L:
        raise ValueError(f"cu_seqlens must run from 0 to {L}, got {cu.tolist()[:8]}")
    if np.any(np.diff(cu) <= 0):
        raise ValueError("cu_seqlens must be strictly increasing")
    return cu


def segment_tiles(cu_seqlens: Sequence[int]) -> np.ndarray:
    """The kernel's tile table [n_tiles, 4] int32: (q0, q1, k0, k1) for
    every run of up to TILE_ROWS query rows inside one segment."""
    cu = np.asarray(cu_seqlens, np.int64)
    rows = []
    for a, b in zip(cu[:-1].tolist(), cu[1:].tolist()):
        for q0 in range(a, b, TILE_ROWS):
            rows.append((q0, min(q0 + TILE_ROWS, b), a, b))
    return np.asarray(rows, np.int32).reshape(-1, 4)


@functools.lru_cache(maxsize=64)
def _tile_table(cu: tuple, device: torch.device) -> torch.Tensor:
    """The tile table of a layout on the card, uploaded once: a tower's
    layers share their image's layouts."""
    return torch.from_numpy(segment_tiles(cu)).to(device)


def segment_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            cu_seqlens: Sequence[int]) -> torch.Tensor:
    """Per-segment softmax attention in f32 (the plain version: the CPU
    tests' path and the card's yardstick)."""
    cu = check_segments(cu_seqlens, q.shape[0]).tolist()
    scale = q.shape[-1] ** -0.5
    out = torch.empty_like(q)
    for a, b in zip(cu[:-1], cu[1:]):
        qs, ks, vs = (t[a:b].transpose(0, 1).float() for t in (q, k, v))
        p = torch.softmax((qs @ ks.transpose(1, 2)) * scale, dim=-1)
        out[a:b] = (p @ vs).transpose(0, 1).to(q.dtype)
    return out


def segment_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           cu_seqlens: Sequence[int]) -> torch.Tensor:
    """The kernel on the card; raises on what it does not take."""
    if q.device.type != "cuda":
        raise ValueError("segment_attention_cuda takes CUDA tensors only")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {q.device}")
        if t.shape != q.shape or t.dim() != 3:
            raise ValueError(f"{name} must be [L, nh, hd] like q, got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    L, nh, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    tiles = _tile_table(tuple(check_segments(cu_seqlens, L).tolist()), q.device)
    out = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), tiles.data_ptr(),
                out.data_ptr(), tiles.shape[0], L, nh, hd, 1.0 / math.sqrt(hd),
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment attention launch failed: CUDA error {err}")
    count_launch("segment_attention")
    return out


def segment_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cu_seqlens: Sequence[int]) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    if q.device.type == "cpu":
        return segment_attention_plain(q, k, v, cu_seqlens)
    return segment_attention_cuda(q, k, v, cu_seqlens)
