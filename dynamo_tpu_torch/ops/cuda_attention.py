"""ctypes wrappers of the hand-written CUDA paged-attention kernels
(`csrc/paged_attention.cu`).

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take, allocates the output with `torch.empty`,
launches on `torch.cuda.current_stream()`, raises if the launch returned a
CUDA error, and adds one to its entry in `LAUNCHES` (`_launches.py`).  No wrapper falls back
to the plain version: the plain versions live in `paged_attention.py` and
are reached only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from ._launches import LAUNCHES, count_launch, reset_launches  # noqa: F401

# The split-KV decode grid is (n_kv, B, n_split).  A split is a fixed run
# of DECODE_SPLIT_KEYS keys (whole pages), never sized from the table
# width: the width is the longest row of the batch, so a row's splits --
# and the f32 sums of its output -- would change with its batch-mates,
# and greedy tokens with them.  256 keys give 16 splits (512 blocks) at
# the phase-3 ragged shape and 9 (576 blocks) at the serving shape, at
# least twice the H100's 132 SMs.
DECODE_SPLIT_KEYS = 256

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# q heads per kv head: any group from 1 to 8 (Qwen2's 7 and 6 included)
_GROUPS = tuple(range(1, 9))

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGS = {
    "pa_decode": [_P] * 9 + [_I] * 10 + [_F, _P],
    "pa_prefill": [_P] * 10 + [_I] * 9 + [_F, _P],
}


def _fn(name: str):
    lib = _build.load("paged_attention.cu")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _SIGS[name]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device,
           align: int = 4) -> None:
    """Device, dtype, rank and contiguity; `align` is 16 for the tensors
    the kernels read as 16-byte vectors (pools, k_new, v_new)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def check_heads(H: int, n_kv: int, hd: int) -> None:
    """Raise unless the kernels take q heads `H` over `n_kv` kv heads of
    `hd`: the shape check of every attention wrapper, which needs no
    card."""
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {_HEAD_DIMS}")
    if n_kv <= 0 or H % n_kv or H // n_kv not in _GROUPS:
        raise ValueError(f"q heads {H} / kv heads {n_kv} not in {_GROUPS}")


def _common(q, k_pages, v_pages, page_table, sink, H):
    if q.device.type != "cuda":
        raise ValueError("the CUDA attention kernels take CUDA tensors only")
    dtype = q.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype} (float32 or bfloat16)")
    dev = q.device
    _check("k_pages", k_pages, dtype, 4, dev, align=16)
    _check("v_pages", v_pages, dtype, 4, dev, align=16)
    if v_pages.shape != k_pages.shape:
        raise ValueError("k_pages and v_pages differ in shape")
    _check("page_table", page_table, torch.int32, 2, dev)
    P, page, n_kv, hd = k_pages.shape
    check_heads(H, n_kv, hd)
    if sink is not None:
        _check("sink", sink, torch.float32, 1, dev)
        if sink.shape[0] != H:
            raise ValueError(f"sink has {sink.shape[0]} entries, expected {H}")
    return page, n_kv, hd


def decode_split_pages(page: int) -> int:
    """Pages of a row each decode split covers: a constant of the page
    size."""
    return max(1, DECODE_SPLIT_KEYS // page)


def decode_num_splits(max_pages: int, page: int) -> int:
    """Splits of each row's keys in the decode kernel, from shapes alone
    (the table width, never seq_lens: reading those would sync the
    host)."""
    return -(-max_pages // decode_split_pages(page))


def _win(window: Optional[int]) -> int:
    return 0 if window is None else int(window)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def decode_attention_cuda(
    q: torch.Tensor,  # [B, H, hd]
    k_pages: torch.Tensor,  # [P, page, n_kv, hd] (new token already written)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages] int32
    seq_lens: torch.Tensor,  # [B] int32, incl. the new token
    window: Optional[int] = None,
    sink: Optional[torch.Tensor] = None,  # [H] f32
) -> torch.Tensor:
    """Paged flash-decode on the card: the split-KV pass over runs of
    `decode_split_pages` pages of each row, then the merge pass.
    Returns [B, H, hd]."""
    if q.dim() != 3:
        raise ValueError(f"q must be [B, H, hd], got {tuple(q.shape)}")
    B, H, hd_q = q.shape
    _check("q", q, q.dtype, 3, q.device, align=16)
    page, n_kv, hd = _common(q, k_pages, v_pages, page_table, sink, H)
    if hd_q != hd or page_table.shape[0] != B:
        raise ValueError("q / page_table shapes disagree with the pool")
    _check("seq_lens", seq_lens, torch.int32, 1, q.device)
    if seq_lens.shape[0] != B:
        raise ValueError("seq_lens must have one entry per row")
    maxp = page_table.shape[1]
    n_split = decode_num_splits(maxp, page)
    out = torch.empty_like(q)
    # per-split partial softmax state, written by the split pass and read
    # by the merge pass
    part_ml = torch.empty((B, H, n_split, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, H, n_split, hd), dtype=torch.float32, device=q.device)
    err = _fn("pa_decode")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(),
        sink.data_ptr() if sink is not None else None, out.data_ptr(),
        part_ml.data_ptr(), part_acc.data_ptr(),
        B, H, n_kv, hd, maxp, page, _win(window), n_split,
        decode_split_pages(page) * page, _DTYPES[q.dtype], 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "decode attention")
    count_launch("decode_attention")
    count_launch("decode_merge")
    return out


def prefill_attention_cuda(
    q: torch.Tensor,  # [B, S, H, hd]
    k_new: torch.Tensor,  # [B, S, n_kv, hd]
    v_new: torch.Tensor,
    k_pages: torch.Tensor,  # [P, page, n_kv, hd] (holding the prefix)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages] int32
    prefix_lens: torch.Tensor,  # [B] int32
    chunk_lens: torch.Tensor,  # [B] int32
    window: Optional[int] = None,
    sink: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chunked-prefill flash attention on the card (bf16 on the tensor
    cores, f32 on CUDA cores). Returns [B, S, H, hd]; rows at or past a
    row's chunk_len are zeros."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, hd], got {tuple(q.shape)}")
    B, S, H, hd_q = q.shape
    _check("q", q, q.dtype, 4, q.device, align=16)
    page, n_kv, hd = _common(q, k_pages, v_pages, page_table, sink, H)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        _check(name, t, q.dtype, 4, q.device, align=16)
        if tuple(t.shape) != (B, S, n_kv, hd):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {(B, S, n_kv, hd)}")
    if hd_q != hd or page_table.shape[0] != B:
        raise ValueError("q / page_table shapes disagree with the pool")
    for name, t in (("prefix_lens", prefix_lens), ("chunk_lens", chunk_lens)):
        _check(name, t, torch.int32, 1, q.device)
        if t.shape[0] != B:
            raise ValueError(f"{name} must have one entry per row")
    out = torch.empty_like(q)
    err = _fn("pa_prefill")(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        prefix_lens.data_ptr(), chunk_lens.data_ptr(),
        sink.data_ptr() if sink is not None else None, out.data_ptr(),
        B, S, H, n_kv, hd, page_table.shape[1], page, _win(window),
        _DTYPES[q.dtype], 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "prefill attention")
    count_launch("prefill_attention")
    return out
