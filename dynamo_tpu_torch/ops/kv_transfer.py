"""The KV re-page of disaggregated serving: a prompt's K and V from source
pages of one size into destination pages of another, cast to the
destination's dtype, zero past the prompt.

The port of the JAX package's device lane re-page (`device_repage`:
`from_pool`'s gather -> mask -> cast -> reshape,
dynamo_tpu/disagg/device_transfer.py:77-113) fused with the import scatter
that follows it (dynamo_tpu/engine/engine.py:444): `kv_repage` writes the
destination pool IN PLACE, since the captured decode graphs hold its
address.  Pools are [L, P, page, n_kv, hd]; destination page ``j`` of the
transfer takes the prompt's tokens ``j * ps_d ... (j + 1) * ps_d - 1``,
read through ``src_pages`` (the source's pages in prompt order).

Under tensor parallelism each rank's pool holds its own n_kv / tp heads,
and a move between pools of different tp takes a window of the row:
``heads`` heads from head ``src_head`` of the source row into head
``dst_head`` of the destination row (the destination's other heads are
left as they are).  `head_windows` lists the launches a destination rank
needs, one per source rank whose heads it overlaps.  Without a window the
whole row moves, which needs both pools to hold the same heads.

On CUDA tensors it launches `kv_repage_kernel` (`csrc/kv_transfer.cu`;
f32 and bf16 in and out): one launch for K and V, on the current stream,
and adds one to ``LAUNCHES["kv_repage"]`` (`_launches.py`).  The wrapper
checks device, dtype, shape, contiguity and alignment and raises on what
the kernel does not take or on a launch error; it never falls back to
`kv_repage_plain`, which is reached only for CPU tensors (and by
`chip_smoke.py`, which holds the kernel against it on the card).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import _build
from ._launches import count_launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = 8  # elements a kernel thread moves per step

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIG = [_P] * 6 + [_I] * 10 + [_L] * 2 + [_I] * 3 + [_P]


def _fn():
    fn = _build.load("kv_transfer.cu").kv_repage
    if fn.argtypes is None:
        fn.argtypes = _SIG
        fn.restype = ctypes.c_int
    return fn


def covering_pages(src_pages: Sequence[int], n_dst: int, ps_s: int,
                   ps_d: int) -> list:
    """`src_pages` padded with the trash page 0 to cover the n_dst * ps_d
    destination tokens (their tail lies past the prompt and is zeroed, so
    the padding is never read for data; it only keeps every index the
    kernel computes inside the list)."""
    need = -(-n_dst * ps_d // ps_s)
    return list(src_pages)[:need] + [0] * max(0, need - len(src_pages))


def head_windows(n_kv: int, tp_s: int, tp_d: int, rank_d: int) -> list:
    """The launches destination rank `rank_d` of a tp_d group takes to fill
    its heads from a tp_s group's pools: ``(source rank, src_head,
    dst_head, heads)`` per source rank it overlaps, in source-rank order.
    One launch when tp_s <= tp_d (a window of one source rank's row),
    tp_s / tp_d launches otherwise (each filling a window of its row)."""
    if n_kv % tp_s or n_kv % tp_d:
        raise ValueError(f"{n_kv} kv heads do not split over tp {tp_s} and "
                         f"tp {tp_d}")
    h_s, h_d = n_kv // tp_s, n_kv // tp_d
    lo, hi = rank_d * h_d, (rank_d + 1) * h_d
    out = []
    for s in range(lo // h_s, -(-hi // h_s)):
        a, b = max(lo, s * h_s), min(hi, (s + 1) * h_s)
        out.append((s, a - s * h_s, a - lo, b - a))
    return out


def _window(src_k: torch.Tensor, dst_k: torch.Tensor, src_head: int,
            dst_head: int, heads: Optional[int]) -> int:
    """The window's head count, checked against both pools."""
    kvh_s, kvh_d = src_k.shape[3], dst_k.shape[3]
    if heads is None:
        if (src_head, dst_head) != (0, 0) or kvh_s != kvh_d:
            raise ValueError(f"a whole-row re-page needs pools of equal heads "
                             f"({kvh_s} -> {kvh_d}); pass a window")
        heads = kvh_s
    if heads <= 0 or src_head < 0 or dst_head < 0:
        raise ValueError(f"bad head window: {heads} heads from {src_head} "
                         f"into {dst_head}")
    if src_head + heads > kvh_s or dst_head + heads > kvh_d:
        raise ValueError(f"the window of {heads} heads from head {src_head} "
                         f"into head {dst_head} leaves the rows ({kvh_s} -> "
                         f"{kvh_d} heads)")
    return heads


def repage_index(src_pages: Sequence[int], dst_pages: Sequence[int],
                 ps_s: int, ps_d: int, device) -> torch.Tensor:
    """The kernel's page ids on the device (int32): the covering source
    pages, then the destination pages.  Built per call by default; a
    caller launching the same transfer again (a timing loop) builds it
    once and passes it as `index`, since the host-to-device copy waits for
    the stream."""
    pages = covering_pages(src_pages, len(dst_pages), ps_s, ps_d)
    return torch.tensor(pages + list(dst_pages), dtype=torch.int32, device=device)


def kv_repage_plain(src_k: torch.Tensor, src_v: torch.Tensor,
                    dst_k: torch.Tensor, dst_v: torch.Tensor,
                    src_pages: Sequence[int], dst_pages: Sequence[int],
                    prompt_len: int, index: Optional[torch.Tensor] = None,
                    src_head: int = 0, dst_head: int = 0,
                    heads: Optional[int] = None) -> None:
    """The same function in PyTorch: `index_select` of the source pages,
    the window's heads (`narrow`), token-major reshape, the zero mask past
    `prompt_len`, the cast, and an in-place `index_copy_` into the window
    of the destination pages.  `index` and the window as for
    `kv_repage_cuda`."""
    n_dst = len(dst_pages)
    heads = _window(src_k, dst_k, src_head, dst_head, heads)
    if n_dst == 0:
        return
    ps_s, ps_d = src_k.shape[2], dst_k.shape[2]
    pages = covering_pages(src_pages, n_dst, ps_s, ps_d)
    if index is None:
        index = repage_index(src_pages, dst_pages, ps_s, ps_d, dst_k.device)
    sidx = index[:len(pages)].long().to(src_k.device)
    didx = index[len(pages):].long()
    target = n_dst * ps_d
    for src, dst in ((src_k, dst_k), (src_v, dst_v)):
        L, hd = src.shape[0], src.shape[4]
        toks = src.index_select(1, sidx).narrow(3, src_head, heads)
        toks = toks.reshape(L, len(pages) * ps_s, heads, hd)[:, :target]
        keep = torch.arange(target, device=src.device) < prompt_len
        toks = torch.where(keep[None, :, None, None], toks, torch.zeros_like(toks))
        dst.narrow(3, dst_head, heads).index_copy_(
            1, didx, toks.to(dst.dtype).reshape(L, n_dst, ps_d, heads, hd)
            .to(dst.device))


def _check_pool(name: str, t: torch.Tensor, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name} has dtype {t.dtype} (float32 or bfloat16)")
    if t.dim() != 5:
        raise ValueError(f"{name} must be [L, P, page, n_kv, hd], got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def kv_repage_cuda(src_k: torch.Tensor, src_v: torch.Tensor,
                   dst_k: torch.Tensor, dst_v: torch.Tensor,
                   src_pages: Sequence[int], dst_pages: Sequence[int],
                   prompt_len: int, index: Optional[torch.Tensor] = None,
                   src_head: int = 0, dst_head: int = 0,
                   heads: Optional[int] = None) -> None:
    dev = dst_k.device
    if dev.type != "cuda":
        raise ValueError("kv_repage_cuda takes CUDA tensors only")
    for name, t in (("src_k", src_k), ("src_v", src_v), ("dst_k", dst_k),
                    ("dst_v", dst_v)):
        _check_pool(name, t, dev)
    if src_v.shape != src_k.shape or src_v.dtype != src_k.dtype:
        raise ValueError("src_k and src_v differ")
    if dst_v.shape != dst_k.shape or dst_v.dtype != dst_k.dtype:
        raise ValueError("dst_k and dst_v differ")
    L, P_s, ps_s, kvh, hd = src_k.shape
    L_d, P_d, ps_d, kvh_d, hd_d = dst_k.shape
    if (L, hd) != (L_d, hd_d):
        raise ValueError(f"incompatible pools: {tuple(src_k.shape)} -> "
                         f"{tuple(dst_k.shape)}")
    heads = _window(src_k, dst_k, src_head, dst_head, heads)
    if any(n * hd % _VEC for n in (heads, src_head, dst_head)):
        raise ValueError(f"a window of {heads} heads of {hd} at heads "
                         f"{src_head} -> {dst_head} is not {_VEC}-element "
                         f"aligned")
    n_dst = len(dst_pages)
    if n_dst * ps_d < prompt_len or len(src_pages) * ps_s < prompt_len:
        raise ValueError(f"{len(src_pages)} source / {n_dst} destination pages "
                         f"do not hold a {prompt_len}-token prompt")
    pages = covering_pages(src_pages, n_dst, ps_s, ps_d)
    if any(not 0 <= p < P_s for p in pages):
        raise ValueError(f"a source page is outside [0, {P_s})")
    if any(not 0 <= p < P_d for p in dst_pages):
        raise ValueError(f"a destination page is outside [0, {P_d})")
    if n_dst == 0:
        return
    idx = (repage_index(src_pages, dst_pages, ps_s, ps_d, dev)
           if index is None else index)
    if (idx.device != dev or idx.dtype != torch.int32 or idx.dim() != 1
            or idx.numel() != len(pages) + n_dst):
        raise ValueError(f"index must be the {len(pages) + n_dst} int32 page "
                         f"ids of `repage_index` on {dev}")
    err = _fn()(src_k.data_ptr(), src_v.data_ptr(), dst_k.data_ptr(),
                dst_v.data_ptr(), idx.data_ptr(), idx[len(pages):].data_ptr(),
                L, n_dst, ps_s, ps_d, hd, kvh, kvh_d, src_head, dst_head,
                heads, P_s * ps_s * kvh * hd, P_d * ps_d * kvh_d * hd,
                int(prompt_len), _DTYPES[src_k.dtype], _DTYPES[dst_k.dtype],
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kv_repage launch failed: CUDA error {err}")
    count_launch("kv_repage")


def kv_repage(src_k: torch.Tensor, src_v: torch.Tensor, dst_k: torch.Tensor,
              dst_v: torch.Tensor, src_pages: Sequence[int],
              dst_pages: Sequence[int], prompt_len: int, src_head: int = 0,
              dst_head: int = 0, heads: Optional[int] = None) -> None:
    """Re-page `prompt_len` tokens from `src_pages` of (src_k, src_v) into
    `dst_pages` of (dst_k, dst_v), in place; destination tokens past the
    prompt become zeros.  With a window, only `heads` heads move, from
    head `src_head` of the source row into head `dst_head` of the
    destination row.  The kernel on CUDA, the plain version on the CPU."""
    win = dict(src_head=src_head, dst_head=dst_head, heads=heads)
    if dst_k.device.type == "cpu" and src_k.device.type == "cpu":
        return kv_repage_plain(src_k, src_v, dst_k, dst_v, src_pages,
                               dst_pages, prompt_len, **win)
    return kv_repage_cuda(src_k, src_v, dst_k, dst_v, src_pages, dst_pages,
                          prompt_len, **win)
