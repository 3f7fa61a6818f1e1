"""The engine's token draw on Hopper (``csrc/sample.cu``), X3.

Replaces the reference's ``_split_rows`` and ``_sample_rows``
(``repro/serving/engine.py:119-145``): ``jax.random.split`` and
``jax.random.categorical`` over each row's logits, ``jnp`` code that XLA
compiles into the jitted step, not a Pallas kernel.  Each row of the step
carries its request's threefry key; every step splits it into a draw key
and a carry, the draw key feeds the Gumbel noise of a temperature > 0 row,
and a row that samples this step keeps the carry.

:func:`sample_tokens` sends CPU tensors to :func:`sample_tokens_plain`
(``core.prng`` in eager PyTorch: some 120 elementwise ops over B x V when
a row draws) and CUDA tensors to the kernel: one call of two launches (each
block scores a chunk of a row's vocabulary and keeps its first maximum; one
warp a row merges the chunks, writes the token and splits the key).  The
tokens and keys are the plain version's, bitwise: the scores are computed
with the same IEEE operations (``csrc/sample.cu`` has the design).  A call
counts one launch as ``sample_tokens``.  :func:`gumbel_noise` is the
kernel's debug entry: its noise for given draw keys, held bitwise against
``core.prng.gumbel``.

Bound on an H100 SXM: bytes, the fp32 logits read once, over 3.35 TB/s.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import prng
from repro_torch.kernels import _build

CHUNK = 4096     # columns a block of the first launch (csrc/sample.cu)
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] + [ctypes.c_void_p] * 3)
_NOISE_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]


def sample_tokens_plain(logits: torch.Tensor, temps: torch.Tensor,
                        keys: torch.Tensor, sample_mask: torch.Tensor,
                        draw: bool) -> torch.Tensor:
    """The reference's ``_split_rows`` then ``_sample_rows`` on one step:
    fp32 logits (B, V), temperatures (B,), int32 key words (B, 2), rows
    that sample this step (B,) bool; ``draw``: whether any row may draw
    (the reference's ``lax.cond``; every row is greedy without it).
    Returns (B,) int32 tokens; ``keys`` takes each sampling row's carry
    in place."""
    words = prng.split(prng.from_i32(keys))        # (B, 2 keys, 2 words)
    tokens = torch.argmax(logits, dim=-1)
    if draw:
        # a division by a tensor: a CUDA tensor divided by a Python number
        # is multiplied by its reciprocal, one ulp off
        scaled = logits / torch.clamp_min(temps, 1e-6)[:, None]
        drawn = prng.categorical(words[:, 0], scaled)
        tokens = torch.where(temps <= 0.0, tokens, drawn)
    keys.copy_(torch.where(sample_mask[:, None],
                           prng.to_i32(words[:, 1]), keys))
    return tokens.to(torch.int32)


def _check(logits, temps, keys, sample_mask) -> None:
    B, V = logits.shape
    dev = logits.device
    if dev.type != "cuda" or any(t.device != dev for t in (
            temps, keys, sample_mask)):
        raise ValueError("sample_tokens: every tensor must be on one CUDA "
                         "device")
    if (logits.dtype != torch.float32 or temps.dtype != torch.float32
            or keys.dtype != torch.int32 or sample_mask.dtype != torch.bool):
        raise TypeError("sample_tokens: float32 logits and temperatures, "
                        "int32 keys and a bool mask")
    if (tuple(temps.shape) != (B,) or tuple(keys.shape) != (B, 2)
            or tuple(sample_mask.shape) != (B,)):
        raise ValueError(
            f"sample_tokens: bad shapes logits{tuple(logits.shape)} "
            f"temps{tuple(temps.shape)} keys{tuple(keys.shape)} "
            f"mask{tuple(sample_mask.shape)}")
    if not (temps.is_contiguous() and keys.is_contiguous()
            and sample_mask.is_contiguous()) or logits.stride(1) != 1:
        raise ValueError("sample_tokens: contiguous temperatures, keys and "
                         "mask, and logits with contiguous columns")


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor,
                  keys: torch.Tensor, sample_mask: torch.Tensor,
                  draw: bool) -> torch.Tensor:
    """:func:`sample_tokens_plain`'s function: on the CPU that version,
    on a CUDA device the kernel (two launches, counted as one)."""
    if logits.device.type == "cpu":
        return sample_tokens_plain(logits, temps, keys, sample_mask, draw)
    _check(logits, temps, keys, sample_mask)
    B, V = logits.shape
    n_chunks = -(-V // CHUNK)
    tokens = torch.empty(B, dtype=torch.int32, device=logits.device)
    scratch = torch.empty(2 * B * n_chunks, dtype=torch.int32,
                          device=logits.device)
    lib = _build.library("sample", "sample_launch", _ARGTYPES)
    err = lib.sample_launch(
        logits.data_ptr(), logits.stride(0), B, V, temps.data_ptr(),
        keys.data_ptr(), sample_mask.data_ptr(), int(bool(draw)),
        tokens.data_ptr(), scratch.data_ptr(), _build.stream_of(logits))
    _build.check(err, "sample_tokens launch")
    _build.LAUNCHES["sample_tokens"] += 1
    return tokens


def gumbel_noise(keys: torch.Tensor, V: int) -> torch.Tensor:
    """The Gumbel noise (B, V) fp32 of int32 draw keys (B, 2): the
    kernel's own on a CUDA device (its debug entry, not counted),
    ``core.prng.gumbel`` on the CPU."""
    if keys.device.type == "cpu":
        return prng.gumbel(prng.from_i32(keys), V)
    if keys.dtype != torch.int32 or keys.dim() != 2 or keys.shape[1] != 2:
        raise TypeError("gumbel_noise: int32 keys (B, 2)")
    keys = keys.contiguous()
    B = keys.shape[0]
    noise = torch.empty(B, V, device=keys.device)
    lib = _build.library("sample", "sample_noise_launch", _NOISE_ARGTYPES)
    _build.check(lib.sample_noise_launch(keys.data_ptr(), B, V,
                                         noise.data_ptr(),
                                         _build.stream_of(keys)),
                 "gumbel_noise launch")
    return noise


__all__ = ["sample_tokens", "sample_tokens_plain", "gumbel_noise", "CHUNK"]
