"""The MoE grouped GEMM: the port's `jax.lax.ragged_dot`.

Rows of ``xs`` [A, K] are sorted by expert; expert e owns rows
``offs[e]:offs[e+1]`` (``offs`` [E+1] int32, ``offs[0] = 0``,
nondecreasing, ``offs[E] = A``) and multiplies them by ``w[e]`` ([E, K, N],
the JAX layout).  The result is f32 [A, N], as ``ragged_dot`` with
``preferred_element_type=f32``.  Unlike ``ragged_dot``, the groups must
cover every row: the kernel leaves rows past ``offs[E]`` unwritten (the
MoE dispatch always routes all of them), and the plain version refuses
such offsets.

On a CUDA tensor `grouped_gemm` launches the hand-written kernel
(`csrc/grouped_gemm.cu`, bf16 only): its grid is fixed by shapes and it
reads the offsets on the device, so it runs inside the decode CUDA graphs.
The wrapper checks device, dtype, shape and contiguity, raises on what the
kernel does not take and on a launch error, and adds one to
``LAUNCHES["moe_grouped_gemm"]`` (`_launches.py`).  It never falls back to the plain
version, which is reached only for CPU tensors (and by `chip_smoke.py`,
which holds the kernel against it on the card).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._launches import LAUNCHES, reset_launches  # noqa: F401
from .cuda_attention import _check

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = [_P] * 4 + [_I] * 4 + [_P]


def _fn():
    fn = _build.load("grouped_gemm.cu").moe_grouped_gemm
    if fn.argtypes is None:
        fn.argtypes = _SIG
        fn.restype = ctypes.c_int
    return fn


def grouped_gemm_cuda(xs: torch.Tensor, w: torch.Tensor,
                      offs: torch.Tensor) -> torch.Tensor:
    """The kernel: xs [A, K] bf16, w [E, K, N] bf16, offs [E+1] int32 with
    offs[E] = A (rows past it are left unwritten), all on one CUDA device;
    K and N multiples of 8.  Returns f32 [A, N]."""
    if xs.device.type != "cuda":
        raise ValueError("the grouped GEMM kernel takes CUDA tensors only")
    dev = xs.device
    # the kernel reads xs and w as 16-byte vectors
    _check("xs", xs, torch.bfloat16, 2, dev, align=16)
    _check("w", w, torch.bfloat16, 3, dev, align=16)
    _check("offs", offs, torch.int32, 1, dev)
    A, K = xs.shape
    E, Kw, N = w.shape
    if Kw != K:
        raise ValueError(f"xs has K {K}, w has K {Kw}")
    if offs.shape[0] != E + 1:
        raise ValueError(f"offs has {offs.shape[0]} entries, expected E+1 = {E + 1}")
    if K % 8 or N % 8:
        raise ValueError(f"K {K} and N {N} must be multiples of 8")
    out = torch.empty((A, N), dtype=torch.float32, device=dev)
    err = _fn()(xs.data_ptr(), w.data_ptr(), offs.data_ptr(), out.data_ptr(),
                A, E, K, N, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped GEMM launch failed: CUDA error {err}")
    LAUNCHES["moe_grouped_gemm"] += 1
    return out


def grouped_gemm_plain(xs: torch.Tensor, w: torch.Tensor,
                       offs: torch.Tensor) -> torch.Tensor:
    """The plain version: a loop over experts at host-known offsets, each
    group's product in f32 (exact products of bf16 values, f32 sums, as
    ``ragged_dot(..., preferred_element_type=f32)``).  It takes what the
    kernel takes: offsets that cover every row (``offs[E] = A``)."""
    o = [int(v) for v in offs.tolist()]
    if o[0] != 0 or any(b < a for a, b in zip(o, o[1:])) or o[-1] != xs.shape[0]:
        raise ValueError(f"offsets must start at 0, not decrease and end "
                         f"at {xs.shape[0]} rows: {o}")
    out = torch.empty((xs.shape[0], w.shape[2]), dtype=torch.float32,
                      device=xs.device)
    for e in range(w.shape[0]):
        if o[e + 1] > o[e]:
            out[o[e]:o[e + 1]] = xs[o[e]:o[e + 1]].float() @ w[e].float()
    return out


def grouped_gemm(xs: torch.Tensor, w: torch.Tensor,
                 offs: torch.Tensor) -> torch.Tensor:
    """`ragged_dot(xs, w, group_sizes)` with the groups given as prefix
    offsets on xs's device; f32 [A, N]."""
    if xs.is_cuda:
        return grouped_gemm_cuda(xs, w, offs)
    return grouped_gemm_plain(xs, w, offs)
