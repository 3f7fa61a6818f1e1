"""One block-diagonal Monarch stage on Hopper (``csrc/bdmm.cu``).

Replaces ``repro/kernels/bdmm.py:bdmm`` (Pallas ``_bdmm_kernel``):
out[t, j, :] = x[t, j, :] @ W[j].T with fp32 accumulation and the output in
``x.dtype``.  It is the staged branch of ``ops.monarch_mm``, taken when the
fused kernel's token-tile intermediate does not fit shared memory.

Bound on an H100 SXM: bytes (x, W and the output once each) over
3.35 TB/s, or 2*T*k*q*p FLOPs over 67 TFLOP/s fp32 without tensor cores,
whichever is larger.  The design reads each diagonal block into shared
memory once per token tile of ``DEFAULT_TILE_T`` rows and never touches the
off-diagonal zeros; it reads x through its strides, so the staged branch's
stride permutation between the two stages is an index, not a copy.

``bdmm`` launches the kernel for a CUDA tensor and uses the plain version
``bdmm_plain`` only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

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


__all__ = ["bdmm", "bdmm_plain", "smem_bytes"]
