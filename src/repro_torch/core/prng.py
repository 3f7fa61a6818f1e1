"""Threefry-2x32 counter-based random numbers, bitwise equal to
``jax.random`` as the reference runs it (jax 0.9: 64-bit types off,
``jax_threefry_partitionable=True``).

The reference seeds one stream a request with ``jax.random.PRNGKey(seed)``
and draws each token with ``jax.random.categorical`` after a
``jax.random.split`` (``repro/serving/engine.py:119-145``).  This module is
the port's own copy of those functions, on torch tensors:

* :func:`threefry2x32` -- the hash: 20 rounds of add, rotate and xor on two
  32-bit words, a key injection every 4 rounds (``jax/_src/prng.py``:
  ``_threefry2x32_lowering``).
* :func:`prng_key` -- ``PRNGKey(seed)``.  With 64-bit types off jax turns a
  Python int into an int32 first, so the key is ``[0, seed mod 2**32]``
  (a seed of 2**40 + 7 gives ``[0, 7]``).
* :func:`split` -- the fold-like split: the hash of the counts ``(hi, lo)``
  of ``iota(num)`` as a 64-bit number, one key ``[bits1, bits2]`` a count.
* :func:`random_bits` -- 32-bit bits: ``bits1 ^ bits2`` of the hash of the
  shape's counts.
* :func:`uniform` -- 23 mantissa bits under exponent 0, ``(bits >> 9) |
  0x3f800000`` read as a float, minus 1, then scaled, shifted and floored
  at ``minval``.
* :func:`gumbel` -- the "low" mode: ``-log(-log(u))``, ``u`` uniform in
  ``[tiny, 1)``.
* :func:`categorical` -- ``argmax(gumbel + logits)`` over the last axis,
  ties to the first index, one key a row.

PyTorch's ``uint32`` has few operations on the CPU or CUDA, so the words
are held as int64 tensors with values in ``[0, 2**32)``: every add is
masked back to 32 bits, and shifts are taken on the masked value, which
makes them logical.  A key is a ``(..., 2)`` tensor of such words.
:func:`to_i32` and :func:`from_i32` convert to and from int32 tensors of
the same bits (the engine's key buffer, the CUDA kernel's words).
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
# jax/_src/prng.py: _threefry2x32_lowering's rotations and key parity
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
TINY = float(np.finfo(np.float32).tiny)


def to_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) as int32 tensors of the same bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def from_i32(bits: torch.Tensor) -> torch.Tensor:
    """int32 (or int64) bit patterns as int64 words in [0, 2**32)."""
    return bits.to(torch.int64) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(key: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the count words ``(x0, x1)`` under
    ``key`` (..., 2); the key broadcasts against the counts."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [(x0 + ks[0]) & M32, (x1 + ks[1]) & M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & M32
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & M32
    return x[0], x[1]


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: (2,) words."""
    low = int(np.int64(seed)) & M32   # out of int64 range raises, as in jax
    return torch.tensor([0, low], dtype=torch.int64)


def _counts(key: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (hi, lo) words of ``iota(n)`` as 64-bit counts, shaped to
    broadcast against ``key``'s leading axes."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return lo >> 32, lo & M32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) keys -> (..., num, 2)."""
    hi, lo = _counts(key, num)
    b1, b2 = threefry2x32(key[..., None, :], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits for each of ``n`` counts: (..., 2) -> (..., n)."""
    hi, lo = _counts(key, n)
    b1, b2 = threefry2x32(key[..., None, :], hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: (..., 2) -> (..., n).  The
    scale ``maxval - minval`` is taken in float32, as jax takes it."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in float32: (..., 2) -> (..., n)."""
    return -torch.log(-torch.log(uniform(key, n, TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis, one key a row:
    keys (..., 2), float32 logits (..., V) -> int64 indices (...)."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)


__all__ = ["threefry2x32", "prng_key", "split", "random_bits", "uniform",
           "gumbel", "categorical", "to_i32", "from_i32", "TINY"]
