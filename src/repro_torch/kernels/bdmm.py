"""One block-diagonal Monarch stage on Hopper (``csrc/bdmm.cu``).

Replaces ``repro/kernels/bdmm.py:bdmm`` (Pallas ``_bdmm_kernel``):
out[t, j, :] = x[t, j, :] @ W[j].T with fp32 accumulation and the output in
``x.dtype``; and ``bdmm_q`` (Pallas ``_bdmm_q_kernel``), the same stage over
int8 or nibble-packed int4 blocks with one fp32 scale per block, staged in
shared memory as ``float(v) * scale`` (one multiply, as
``core.quant.dequantize_factor``), so it is bitwise ``bdmm`` on the
dequantized blocks.  They are the staged branch of ``ops.monarch_mm`` /
``ops.monarch_mm_q``, taken when the fused kernel's token-tile intermediate
does not fit shared memory.

Bound on an H100 SXM: bytes (x, W and the output once each) over
3.35 TB/s, or 2*T*k*q*p FLOPs over 67 TFLOP/s fp32 without tensor cores,
whichever is larger.  The design reads each diagonal block into shared
memory once per token tile of ``DEFAULT_TILE_T`` rows and never touches the
off-diagonal zeros; it reads x through its strides, so the staged branch's
stride permutation between the two stages is an index, not a copy.

``bdmm`` (``bdmm_q``) launches the kernel for a CUDA tensor and uses the
plain version ``bdmm_plain`` (``bdmm_q_plain``) only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import dequantize_factor
from repro_torch.kernels import _build
from repro_torch.kernels.monarch import SMEM_BUDGET_BYTES

DEFAULT_TILE_T = 64


def smem_bytes(q: int, p: int, tile_t: int) -> int:
    """Shared memory one block of the kernel needs (csrc/bdmm.cu)."""
    return 4 * (q * (p + 1) + tile_t * p)


def bdmm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: fp32 products, output in
    ``x.dtype``."""
    return torch.einsum("tkp,kqp->tkq", x.float(), w.float()).to(x.dtype)


_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
             + [ctypes.c_void_p])


def bdmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (T, k, p) (any strides), w: (k, q, p) -> (T, k, q)."""
    T, k, p = x.shape
    k2, q, p2 = w.shape
    if (k2, p2) != (k, p):
        raise ValueError(f"bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    if x.device.type == "cpu":
        return bdmm_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("bdmm: x and w must share one CUDA device")
    if not w.is_contiguous():
        raise ValueError("bdmm: w must be contiguous")
    bT = min(DEFAULT_TILE_T, max(T, 1))
    if smem_bytes(q, p, bT) > SMEM_BUDGET_BYTES:
        raise ValueError(f"bdmm: block {q}x{p} does not fit shared memory")
    out = torch.empty((T, k, q), dtype=x.dtype, device=x.device)
    if T == 0:
        return out
    lib = _build.library("bdmm", "bdmm_launch", _ARGTYPES)
    sx = x.stride()
    err = lib.bdmm_launch(
        _build.ptr(x), _build.ptr(w), _build.ptr(out), T, k, q, p, bT,
        sx[0], sx[1], sx[2], _build.dtype_code(x, "bdmm x"),
        _build.dtype_code(w, "bdmm w"), _build.stream_of(x))
    _build.check(err, "bdmm launch")
    _build.LAUNCHES["bdmm"] += 1
    return out


def _q_bits(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> int:
    _, k, p = x.shape
    ok = (wq.dim() == 3 and wq.shape[0] == k
          and tuple(scale.shape) == (k, 1, 1))
    if ok and wq.shape[2] == p:
        return 8
    if ok and 2 * wq.shape[2] == p:
        return 4
    raise ValueError(f"bad quantized shapes x{tuple(x.shape)} "
                     f"wq{tuple(wq.shape)} scale{tuple(scale.shape)}")


def bdmm_q_plain(x: torch.Tensor, wq: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """The quantized kernel's arithmetic in plain PyTorch: dequantize the
    blocks to fp32, then :func:`bdmm_plain`."""
    _q_bits(x, wq, scale)
    return bdmm_plain(x, dequantize_factor(wq, scale,
                                           unpacked_dim=x.shape[-1]))


_Q_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
               + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
               + [ctypes.c_void_p])


def bdmm_q(x: torch.Tensor, wq: torch.Tensor,
           scale: torch.Tensor) -> torch.Tensor:
    """x: (T, k, p) (any strides), wq: (k, q, p) int8 or (k, q, p/2)
    nibble-packed int4, scale: (k, 1, 1) fp32 -> (T, k, q) in x's dtype."""
    T, k, p = x.shape
    bits = _q_bits(x, wq, scale)
    q = wq.shape[1]
    if x.device.type == "cpu":
        return bdmm_q_plain(x, wq, scale)
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (wq, scale)):
        raise ValueError("bdmm_q: x, wq and scale must share one CUDA "
                         "device")
    if not (wq.is_contiguous() and scale.is_contiguous()):
        raise ValueError("bdmm_q: wq and scale must be contiguous")
    if (wq.dtype, scale.dtype) != (torch.int8, torch.float32):
        raise TypeError("bdmm_q: wq int8, scale float32")
    bT = min(DEFAULT_TILE_T, max(T, 1))
    if smem_bytes(q, p, bT) > SMEM_BUDGET_BYTES:
        raise ValueError(f"bdmm_q: block {q}x{p} does not fit shared memory")
    out = torch.empty((T, k, q), dtype=x.dtype, device=x.device)
    if T == 0:
        return out
    lib = _build.library("bdmm", "bdmm_q_launch", _Q_ARGTYPES)
    sx = x.stride()
    err = lib.bdmm_q_launch(
        _build.ptr(x), _build.ptr(wq), _build.ptr(scale), _build.ptr(out), T,
        k, q, p, bT, sx[0], sx[1], sx[2], _build.dtype_code(x, "bdmm_q x"),
        bits, _build.stream_of(x))
    _build.check(err, "bdmm_q launch")
    _build.LAUNCHES["bdmm_q"] += 1
    return out


__all__ = ["bdmm", "bdmm_plain", "bdmm_q", "bdmm_q_plain", "smem_bytes"]
