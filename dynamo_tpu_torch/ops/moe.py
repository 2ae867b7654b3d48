"""The MoE grouped GEMM: the port's `jax.lax.ragged_dot`, with the bias
and `moe_act` of `_moe_ragged` fused in.

Rows of ``xs`` [A, K] are sorted by expert; expert e owns rows
``offs[e]:offs[e+1]`` (``offs`` [E+1] int32, ``offs[0] = 0``,
nondecreasing, ``offs[E] = A``) and multiplies them by ``w[e]`` ([E, K, N],
the JAX layout).

- `grouped_gemm(xs, w, offs, bias)`: f32 [A, N], as ``ragged_dot`` with
  ``preferred_element_type=f32``, plus ``bias[e]`` ([E, N]) in f32 when
  given (the down product's ``b_down``, the router's bias);
- `grouped_glu(xs, w_gate, w_up, b_gate, b_up, offs, act)`: [A, N] in
  xs's dtype, ``moe_act(act, gate + b_gate[e], up + b_up[e])`` in f32,
  rounded once: JAX's ``moe_act(...).astype(dt)``.

Unlike ``ragged_dot``, the groups must cover every row: the kernels leave
rows past ``offs[E]`` unwritten (the MoE dispatch always routes all of
them), and the plain versions refuse such offsets.

On CUDA tensors both launch the hand-written kernels
(`csrc/grouped_gemm.cu`, bf16 only): grids fixed by shapes, offsets read on
the device, so they run inside the decode CUDA graphs.  A tile is 64 rows,
or 128 where the rows per expert average 48 or more (`tile_rows`); weights whose
output tiles cannot fill the card sum K in a fixed number of slices
(`k_slices`, a function of the weight's shape only), so a row's sum order
never depends on A.  The wrappers check device, dtype, shape, contiguity
and alignment, raise on what the kernels do not take and on a launch error,
and add one to ``LAUNCHES["moe_grouped_gemm"]`` (and
``LAUNCHES["moe_split_reduce"]`` for a sum pass) or
``LAUNCHES["moe_grouped_glu"]`` (`_launches.py`).  They never fall back to
the plain versions, which are reached only for CPU tensors (and by
`chip_smoke.py`, which holds the kernels against them on the card).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._launches import LAUNCHES, count_launch, reset_launches  # noqa: F401
from .cuda_attention import _check

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {"moe_grouped_gemm": [_P] * 6 + [_I] * 6 + [_P],
         "moe_grouped_glu": [_P] * 7 + [_I] * 6 + [_P]}
# the kernels' activation codes
ACTS = {"silu": 0, "gpt_oss_glu": 1}
# the kernels' tile: 128 output columns, 64 of K a stage
TILE_N, TILE_K = 128, 64
# streaming multiprocessors of an H100 SXM: a weight whose E * ceil(N/128)
# output tiles number fewer is summed over K in slices (the rule is a
# constant, not the card's count, so a row's sum order is the same
# everywhere)
SMS = 132


def _fn(name: str):
    fn = getattr(_build.load("grouped_gemm.cu"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGS[name]
        fn.restype = ctypes.c_int
    return fn


def tile_rows(A: int, E: int) -> int:
    """Rows a tile: 128 (two warpgroups) once the rows per expert reach
    ~48 on average, so an expert's weights are streamed once per 128 rows;
    else 64.  Both issue the same products over the same K order."""
    return 128 if A >= 48 * E else 64


def k_slices(E: int, K: int, N: int) -> int:
    """Slices of K for a weight [E, K, N]: 1 when its output tiles can fill
    the card, else slices of 3 K tiles (the router's one group of 32
    columns: 15 slices at K 2880).  Depends on the weight's shape only."""
    if E * -(-N // TILE_N) >= SMS:
        return 1
    return -(-(-(-K // TILE_K)) // 3)


def moe_act(act: str, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """The JAX `moe_act` (float32 in/out).  "silu" is the mixtral family;
    "gpt_oss_glu" is HF GptOssExperts: gate clamped to <= 7, up to |7|,
    glu = gate*sigmoid(1.702*gate), out = (up+1)*glu."""
    if act == "gpt_oss_glu":
        limit = 7.0
        gate = torch.clamp(gate, max=limit)
        up = torch.clamp(up, -limit, limit)
        return (up + 1.0) * (gate * torch.sigmoid(1.702 * gate))
    if act != "silu":
        raise ValueError(f"moe_act must be silu|gpt_oss_glu, got {act!r}")
    return torch.nn.functional.silu(gate) * up


def _check_group(xs, w, offs, name="w"):
    dev = xs.device
    # TMA reads xs and w through tensor maps: 16-byte aligned bases and rows
    _check("xs", xs, torch.bfloat16, 2, dev, align=16)
    _check(name, w, torch.bfloat16, 3, dev, align=16)
    _check("offs", offs, torch.int32, 1, dev)
    A, K = xs.shape
    E, Kw, N = w.shape
    if Kw != K:
        raise ValueError(f"xs has K {K}, {name} has K {Kw}")
    if offs.shape[0] != E + 1:
        raise ValueError(f"offs has {offs.shape[0]} entries, expected E+1 = {E + 1}")
    if K % 8 or N % 8:
        raise ValueError(f"K {K} and N {N} must be multiples of 8")
    return A, E, K, N


def _check_bias(name, b, E, N, dev):
    if b is None:
        return 0
    _check(name, b, torch.bfloat16, 2, dev, align=16)
    if tuple(b.shape) != (E, N):
        raise ValueError(f"{name} has shape {tuple(b.shape)}, expected {(E, N)}")
    return b.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err < 0:
        raise RuntimeError(f"{what}: a TMA tensor map was refused (code {err})")
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def grouped_gemm_cuda(xs: torch.Tensor, w: torch.Tensor, offs: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel: xs [A, K] bf16, w [E, K, N] bf16, offs [E+1] int32 with
    offs[E] = A (rows past it are left unwritten), bias [E, N] bf16 or
    None, all on one CUDA device; K and N multiples of 8.  Returns f32
    [A, N]."""
    if xs.device.type != "cuda":
        raise ValueError("the grouped GEMM kernel takes CUDA tensors only")
    dev = xs.device
    A, E, K, N = _check_group(xs, w, offs)
    b = _check_bias("bias", bias, E, N, dev)
    out = torch.empty((A, N), dtype=torch.float32, device=dev)
    n_split = k_slices(E, K, N)
    part = (torch.empty((n_split, A, N), dtype=torch.float32, device=dev)
            if n_split > 1 and A else None)
    err = _fn("moe_grouped_gemm")(
        xs.data_ptr(), w.data_ptr(), b, offs.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else 0, A, E, K, N,
        tile_rows(A, E), n_split, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "grouped GEMM")
    count_launch("moe_grouped_gemm")
    if part is not None:
        count_launch("moe_split_reduce")
    return out


def grouped_glu_cuda(xs: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                     b_gate: Optional[torch.Tensor], b_up: Optional[torch.Tensor],
                     offs: torch.Tensor, act: str) -> torch.Tensor:
    """The fused kernel: gate and up of the same rows in one launch, the
    biases and `moe_act` in its epilogue; bf16 [A, N]."""
    if xs.device.type != "cuda":
        raise ValueError("the grouped GLU kernel takes CUDA tensors only")
    if act not in ACTS:
        raise ValueError(f"moe_act must be silu|gpt_oss_glu, got {act!r}")
    dev = xs.device
    A, E, K, N = _check_group(xs, w_gate, offs, "w_gate")
    if w_up.shape != w_gate.shape:
        raise ValueError(f"w_up {tuple(w_up.shape)} differs from w_gate "
                         f"{tuple(w_gate.shape)}")
    _check_group(xs, w_up, offs, "w_up")
    bg = _check_bias("b_gate", b_gate, E, N, dev)
    bu = _check_bias("b_up", b_up, E, N, dev)
    out = torch.empty((A, N), dtype=torch.bfloat16, device=dev)
    err = _fn("moe_grouped_glu")(
        xs.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), bg, bu,
        offs.data_ptr(), out.data_ptr(), A, E, K, N, tile_rows(A, E),
        ACTS[act], torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "grouped GLU")
    count_launch("moe_grouped_glu")
    return out


def _host_offsets(xs: torch.Tensor, offs: torch.Tensor):
    o = [int(v) for v in offs.tolist()]
    if o[0] != 0 or any(b < a for a, b in zip(o, o[1:])) or o[-1] != xs.shape[0]:
        raise ValueError(f"offsets must start at 0, not decrease and end "
                         f"at {xs.shape[0]} rows: {o}")
    return o


def grouped_gemm_plain(xs: torch.Tensor, w: torch.Tensor, offs: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: a loop over experts at host-known offsets, each
    group's product in f32 (exact products of bf16 values, f32 sums, as
    ``ragged_dot(..., preferred_element_type=f32)``), then its bias in f32.
    It takes what the kernel takes: offsets that cover every row
    (``offs[E] = A``)."""
    o = _host_offsets(xs, offs)
    out = torch.empty((xs.shape[0], w.shape[2]), dtype=torch.float32,
                      device=xs.device)
    for e in range(w.shape[0]):
        if o[e + 1] > o[e]:
            y = xs[o[e]:o[e + 1]].float() @ w[e].float()
            out[o[e]:o[e + 1]] = y if bias is None else y + bias[e].float()
    return out


def grouped_glu_plain(xs: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                      b_gate: Optional[torch.Tensor], b_up: Optional[torch.Tensor],
                      offs: torch.Tensor, act: str) -> torch.Tensor:
    """The plain version: the two plain products with their biases, then
    `moe_act` and the cast, as JAX's ``moe_act(gate + b_gate[...], up +
    b_up[...]).astype(dt)``."""
    gate = grouped_gemm_plain(xs, w_gate, offs, b_gate)
    up = grouped_gemm_plain(xs, w_up, offs, b_up)
    return moe_act(act, gate, up).to(xs.dtype)


def grouped_gemm(xs: torch.Tensor, w: torch.Tensor, offs: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`ragged_dot(xs, w, group_sizes)` (+ ``bias[e]``) with the groups given
    as prefix offsets on xs's device; f32 [A, N]."""
    if xs.is_cuda:
        return grouped_gemm_cuda(xs, w, offs, bias)
    return grouped_gemm_plain(xs, w, offs, bias)


def grouped_glu(xs: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                b_gate: Optional[torch.Tensor], b_up: Optional[torch.Tensor],
                offs: torch.Tensor, act: str) -> torch.Tensor:
    """The experts' gated first layer: ``moe_act(act, xs @ w_gate[e] +
    b_gate[e], xs @ w_up[e] + b_up[e])`` in xs's dtype, [A, N]."""
    if xs.is_cuda:
        return grouped_glu_cuda(xs, w_gate, w_up, b_gate, b_up, offs, act)
    return grouped_glu_plain(xs, w_gate, w_up, b_gate, b_up, offs, act)
