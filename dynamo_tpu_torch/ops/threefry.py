"""Threefry-2x32 keys and draws, bit-equal to ``jax.random`` (threefry
implementation, ``jax_threefry_partitionable=True``), in plain PyTorch
integer ops on any device.

Threefry-2x32 is a published counter-based hash (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC 2011): 20 rounds of add, rotate
and xor over two 32-bit words, with a key injection every 4 rounds.  The
words live in ``int64`` tensors masked to 32 bits after every add and
shift, because CUDA's ``uint32`` support in PyTorch is partial.

Keys are ``[B, 2]`` int64 tensors holding two uint32 words, so a whole
batch is keyed and drawn at once.  The functions follow JAX 0.9's
``jax/_src/prng.py`` (``threefry_2x32``, ``_threefry_seed``,
``_threefry_fold_in``, ``_threefry_split_foldlike``,
``_threefry_random_bits_partitionable``) and ``jax/_src/random.py``
(``_uniform``, ``_gumbel`` with ``mode="low"``).
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = 1.1754943508222875e-38  # float32 tiny, the smallest normal


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 hash of the count words (x1, x2) under the key
    (k1, k2); all int64 holding uint32 values, broadcast together.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey`` of uint32 seeds [B] (any integer tensor;
    taken modulo 2**32): keys [B, 2] = (0, seed)."""
    s = seed.to(torch.int64) & MASK
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` per row: keys [B, 2], data [B] (uint32)."""
    d = data.to(torch.int64) & MASK
    y1, y2 = threefry2x32(key[:, 0], key[:, 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` per row: keys [B, 2] -> [B, num, 2]."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[:, 0:1], key[:, 1:2], torch.zeros_like(i), i)
    return torch.stack([b1, b2], dim=-1)


def random_bits32(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits for each of n positions per row ([B, n] int64): the
    partitionable form, ``bits1 ^ bits2`` of the hash of the two-word
    iota (hi, lo) of each position (n < 2**32, so hi is 0)."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[:, 0:1], key[:, 1:2], torch.zeros_like(i), i)
    return b1 ^ b2


def _uniform_of_bits(bits: torch.Tensor, minval: float,
                     maxval: float) -> torch.Tensor:
    """The top 23 bits become the mantissa of a float in [1, 2), minus 1,
    scaled to [minval, maxval) in float32."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # filled on the device (no host copy), so a CUDA graph can hold it
    lo = torch.full((), minval, dtype=torch.float32, device=bits.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` float32 [B, n] in [minval, maxval)."""
    return _uniform_of_bits(random_bits32(key, n), minval, maxval)


def _gumbel_of_bits(bits: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(_uniform_of_bits(bits, _TINY, 1.0)))


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` float32 [B, n] (mode "low"):
    -log(-log(u)) with u uniform in [tiny, 1)."""
    return _gumbel_of_bits(random_bits32(key, n))


def gumbel_parts(parts, device) -> list:
    """``gumbel(keys, n)`` for several (keys [b, 2], n) parts at once, as
    one hash over all their positions: the draws are the same, but an
    eager device runs one chain of elementwise launches instead of one per
    part.  Returns one [b, n] float32 tensor per part, on `device`."""
    k1, k2, pos, sizes = [], [], [], []
    for keys, n in parts:
        keys = keys.to(device)
        b = keys.shape[0]
        i = torch.arange(n, dtype=torch.int64, device=device)
        k1.append(keys[:, 0:1].expand(b, n).reshape(-1))
        k2.append(keys[:, 1:2].expand(b, n).reshape(-1))
        pos.append(i.expand(b, n).reshape(-1))
        sizes.append((b, n))
    pos = torch.cat(pos)
    b1, b2 = threefry2x32(torch.cat(k1), torch.cat(k2), torch.zeros_like(pos), pos)
    g = _gumbel_of_bits(b1 ^ b2)
    return [x.view(b, n) for x, (b, n) in
            zip(torch.split(g, [b * n for b, n in sizes]), sizes)]
