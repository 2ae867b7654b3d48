"""Ring attention's block op: one round of keys folded into a carried flash
accumulator, and the end of attention.

The JAX package's ring (`dynamo_tpu/parallel/ring_attention.py`) runs
`_block_attn` (f32 scores [B, H, Sq, Sk]) and JAX's flash merge in a scan
of XLA ops; no Pallas kernel computes it.  The port computes a round with
a hand-written kernel (`csrc/ring_attention.cu`) that updates the carry in
place, so no score matrix is ever stored:

- `ring_state`: the empty carry (m = -1e29, l = 0, o = 0, all f32; m, l
  [B, Sq, H] and o [B, Sq, H, hd], the layout of q: a kernel tile's rows
  are then one contiguous run of the carry);
- `ring_block`: fold a contiguous K/V block [B, Sk, n_kv, hd] whose key j
  of row b sits at position ``k_base[b] + j`` into the carry of queries at
  ``q_base[b] + s`` (causal and window masks by position);
- `ring_prefix`: fold the cached prefix, read through the page table in
  place: row b's keys t < ``prefix_lens[b]`` at positions t (window mask
  only);
- `ring_finish`: the sink logit joins the denominator, which is clamped
  at 1e-20, and o / l is cast to q's dtype.

On a CUDA tensor each launches its kernel (and adds one to its launch
count, `ring_block` or `ring_finish`); on a CPU tensor it runs the plain
version below, JAX's arithmetic in torch.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from ._launches import count_launch

NEG_INF = -1e30
M_FLOOR = -1e29  # JAX's floor of a block's max (a fully masked row)
L_FLOOR = 1e-20  # the ring's denominator clamp (the paged kernels' is 1e-30)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    "ring_block": [_P] * 10 + [_I] * 11 + [ctypes.c_float, _P],
    "ring_finish": [_P] * 5 + [_I] * 4 + [_P],
}


def ring_state(B: int, Sq: int, H: int, hd: int, device):
    """The empty carry (m, l, o) of `ring_block` (JAX's m0, l0, o0)."""
    m = torch.full((B, Sq, H), M_FLOOR, dtype=torch.float32, device=device)
    l = torch.zeros((B, Sq, H), dtype=torch.float32, device=device)
    o = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=device)
    return m, l, o


# -- plain versions (the CPU path and the card's reference) ----------------- #


def _positions(base: torch.Tensor, n: int) -> torch.Tensor:
    return base.long()[:, None] + torch.arange(n, device=base.device)[None, :]


def _fold_plain(q, k, v, m, l, o, mask) -> None:
    """JAX `_block_attn` and the flash merge of one block into the carry,
    in place; `mask` [B, Sq, Sk] bool.  One kv head at a time, so the f32
    scores held are [B, G, Sq, Sk] of one group."""
    B, Sq, H, hd = q.shape
    n_kv = k.shape[2]
    G = H // n_kv
    scale = 1.0 / math.sqrt(hd)
    for kh in range(n_kv):
        hs = slice(kh * G, (kh + 1) * G)
        s = torch.einsum("bqgd,bsd->bgqs", q[:, :, hs].float(),
                         k[:, :, kh].float()) * scale
        s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
        m_blk = s.amax(-1).clamp_min(M_FLOOR)  # [B, G, Sq]
        p = torch.exp(s - m_blk[..., None])
        l_blk = p.sum(-1)
        o_blk = torch.einsum("bgqs,bsd->bgqd", p, v[:, :, kh].float())
        m_acc = m[:, :, hs].transpose(1, 2)
        m_new = torch.maximum(m_acc, m_blk)
        a = torch.exp(m_acc - m_new)
        b = torch.exp(m_blk - m_new)
        l_new = l[:, :, hs].transpose(1, 2) * a + l_blk * b
        o_new = (o[:, :, hs].permute(0, 2, 1, 3) * a[..., None]
                 + o_blk * b[..., None])
        m[:, :, hs] = m_new.transpose(1, 2)
        l[:, :, hs] = l_new.transpose(1, 2)
        o[:, :, hs] = o_new.permute(0, 2, 1, 3)


def _mask(q_pos, k_pos, causal: bool, window: Optional[int]) -> torch.Tensor:
    qp, kp = q_pos[:, :, None], k_pos[:, None, :]
    mask = kp <= qp if causal else torch.ones_like(kp <= qp)
    if window:
        mask = mask & (kp > qp - window)
    return mask


def ring_block_plain(q, k, v, m, l, o, q_base, k_base, causal: bool = True,
                     window: Optional[int] = None) -> None:
    """One ring round in plain torch (JAX `_block_attn` + merge): q [B, Sq,
    H, hd], k, v [B, Sk, n_kv, hd]; the carry updated in place."""
    mask = _mask(_positions(q_base, q.shape[1]), _positions(k_base, k.shape[1]),
                 causal, window)
    _fold_plain(q, k, v, m, l, o, mask)


def ring_prefix_plain(q, k_pages, v_pages, table, prefix_lens, m, l, o,
                      q_base, window: Optional[int] = None) -> None:
    """The cached-prefix block in plain torch (JAX `ring_attention_local`'s
    prefix: keys gathered through the table, ``t < prefix_lens`` and the
    window); the carry updated in place."""
    B, W = table.shape
    page = k_pages.shape[1]
    idx = table.long()
    pk = k_pages[idx].reshape(B, W * page, *k_pages.shape[2:])
    pv = v_pages[idx].reshape(B, W * page, *v_pages.shape[2:])
    t = torch.arange(W * page, device=q.device)[None, :].expand(B, -1)
    mask = _mask(_positions(q_base, q.shape[1]), t, False, window)
    mask = mask & (t < prefix_lens.long()[:, None])[:, None, :]
    _fold_plain(q, pk, pv, m, l, o, mask)


def ring_finish_plain(m, l, o, sink: Optional[torch.Tensor], dtype):
    """The end of attention (JAX `ring_attention_local`'s tail): [B, Sq, H,
    hd] in `dtype`."""
    if sink is not None:
        s = sink.float()[None, None, :]
        m_f = torch.maximum(m, s)
        sc = torch.exp(m - m_f)
        l = l * sc + torch.exp(s - m_f)
        o = o * sc[..., None]
    return (o / l.clamp_min(L_FLOOR)[..., None]).to(dtype)


# -- the kernels ------------------------------------------------------------ #


def _fn(name: str):
    fn = getattr(_build.load("ring_attention.cu"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGS[name]
        fn.restype = ctypes.c_int
    return fn


def _need(name: str, t: torch.Tensor, dtype, shape=None, device=None,
          align: int = 16) -> None:
    """Device, dtype, shape and contiguity; `align` is 16 for the tensors
    the kernels read as 16-byte vectors (q, K, V), 4 for the rest."""
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _check_carry(q, m, l, o, n_kv: int) -> None:
    from .cuda_attention import check_heads

    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype} (float32 or bfloat16)")
    B, Sq, H, hd = q.shape
    _need("q", q, q.dtype, device=q.device)
    for name, t in (("m", m), ("l", l)):
        _need(name, t, torch.float32, (B, Sq, H), q.device, align=4)
    _need("o", o, torch.float32, (B, Sq, H, hd), q.device, align=8)
    check_heads(H, n_kv, hd)


def _launch(q, k, v, table, nkeys, q_base, k_base, m, l, o, skm, page, pool,
            causal, window) -> None:
    B, Sq, H, hd = q.shape
    err = _fn("ring_block")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if table is None else table.data_ptr(),
        None if nkeys is None else nkeys.data_ptr(), q_base.data_ptr(),
        None if k_base is None else k_base.data_ptr(), m.data_ptr(),
        l.data_ptr(), o.data_ptr(), B, Sq, H, k.shape[-2], hd, skm, page,
        int(pool), int(causal), 0 if window is None else int(window),
        _DTYPES[q.dtype], 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_block launch failed: CUDA error {err}")
    count_launch("ring_block")


def ring_block(q, k, v, m, l, o, q_base, k_base, causal: bool = True,
               window: Optional[int] = None) -> None:
    """Fold the block k, v [B, Sk, n_kv, hd] (key j of row b at position
    ``k_base[b] + j``) into the carry (m, l, o) of q [B, Sq, H, hd] at
    positions ``q_base[b] + s``, in place.  Plain torch on the CPU, the
    kernel on the card."""
    if q.device.type == "cpu":
        return ring_block_plain(q, k, v, m, l, o, q_base, k_base, causal,
                                window)
    _check_carry(q, m, l, o, k.shape[2])
    B, Sq, H, hd = q.shape
    for name, t in (("k", k), ("v", v)):
        _need(name, t, q.dtype, (B, k.shape[1], k.shape[2], hd), q.device)
    for name, t in (("q_base", q_base), ("k_base", k_base)):
        _need(name, t, torch.int32, (B,), q.device, align=4)
    _launch(q, k, v, None, None, q_base, k_base, m, l, o, k.shape[1], 1,
            False, causal, window)


def ring_prefix(q, k_pages, v_pages, table, prefix_lens, m, l, o, q_base,
                window: Optional[int] = None) -> None:
    """Fold the cached prefix (row b's keys t < ``prefix_lens[b]``, at
    positions t, through `table` [B, W] into the pool [P, page, n_kv, hd])
    into the carry of q, in place.  The kernel reads the pages where they
    lie."""
    if q.device.type == "cpu":
        return ring_prefix_plain(q, k_pages, v_pages, table, prefix_lens, m,
                                 l, o, q_base, window)
    _check_carry(q, m, l, o, k_pages.shape[2])
    B = q.shape[0]
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _need(name, t, q.dtype, k_pages.shape, q.device)
    if k_pages.shape[3] != q.shape[3]:
        raise ValueError("q and the pool differ in head_dim")
    _need("table", table, torch.int32, (B, table.shape[1]), q.device, align=4)
    for name, t in (("prefix_lens", prefix_lens), ("q_base", q_base)):
        _need(name, t, torch.int32, (B,), q.device, align=4)
    if table.shape[1] == 0:
        return
    _launch(q, k_pages, v_pages, table, prefix_lens, q_base, None, m, l, o,
            table.shape[1], k_pages.shape[1], True, False, window)


def ring_finish(m, l, o, sink: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """The carry's attention output [B, Sq, H, hd] in `dtype`: the sink
    joins the denominator (clamped at 1e-20)."""
    if o.device.type == "cpu":
        return ring_finish_plain(m, l, o, sink, dtype)
    if dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype} (float32 or bfloat16)")
    B, Sq, H, hd = o.shape
    for name, t in (("m", m), ("l", l)):
        _need(name, t, torch.float32, (B, Sq, H), o.device, align=4)
    _need("o", o, torch.float32, device=o.device, align=4)
    if hd not in (64, 128):
        raise ValueError(f"head_dim {hd} not in (64, 128)")
    if sink is not None:
        _need("sink", sink, torch.float32, (H,), o.device, align=4)
    out = torch.empty((B, Sq, H, hd), dtype=dtype, device=o.device)
    err = _fn("ring_finish")(
        m.data_ptr(), l.data_ptr(), o.data_ptr(),
        None if sink is None else sink.data_ptr(), out.data_ptr(),
        B * Sq * H, H, hd, _DTYPES[dtype],
        torch.cuda.current_stream(o.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_finish launch failed: CUDA error {err}")
    count_launch("ring_finish")
    return out
