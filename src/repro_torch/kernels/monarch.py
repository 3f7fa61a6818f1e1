"""Fused two-stage Monarch product on Hopper (``csrc/monarch.cu``).

Replaces ``repro/kernels/monarch.py:monarch_fused`` (Pallas
``_monarch_kernel``): y = reshape(R-stage(P(L-stage(reshape(x))))) with the
intermediate kept on chip, fp32 accumulation, the intermediate rounded to
``x.dtype`` between the stages, and the output in ``x.dtype``.

Bound on an H100 SXM: the factors dominate the bytes at serving sizes
(gpt2-medium's three factor pairs are 0.26, 0.66 and 1.31 MB in fp32) and
the product is 2*T*(kqp + qsk) FLOPs, so it is bytes-bound below about
T = 40 tokens and operations-bound above it, against 3.35 TB/s and
67 TFLOP/s fp32 without tensor cores.  The design reads x and writes y
once, never writes the intermediate to device memory, and streams each
factor block through shared memory once per token tile; at small T a
single block does the whole product, so the first limit it meets is one
SM's share of the bandwidth, not the card's (see PERF.md).

``monarch_fused`` launches the kernel for a CUDA tensor and uses the plain
version ``monarch_fused_plain`` only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# a thread block may opt into 227 KB of dynamic shared memory on Hopper
SMEM_BUDGET_BYTES = 232448
DEFAULT_TILE_T = 8
MIN_TILE_T = 4


def fused_smem_bytes(L_shape, R_shape, tile_t: int) -> int:
    """Shared memory one block of the kernel needs (csrc/monarch.cu)."""
    k, q, p = L_shape
    _, s, _ = R_shape
    return 4 * (tile_t * k * q + max(q * (p + 1), s * (k + 1)) + tile_t * p)


@functools.lru_cache(maxsize=None)
def fused_tile(L_shape, R_shape) -> int:
    """Largest token tile (DEFAULT_TILE_T down to MIN_TILE_T, halving)
    whose working set fits shared memory; 0 when none does."""
    t = DEFAULT_TILE_T
    while t >= MIN_TILE_T:
        if fused_smem_bytes(L_shape, R_shape, t) <= SMEM_BUDGET_BYTES:
            return t
        t //= 2
    return 0


def fused_fits(L_shape, R_shape) -> bool:
    """Hopper's fit rule for the fused kernel: a ``MIN_TILE_T``-row token
    tile's intermediate plus one factor block fits a block's shared memory
    (the reference's 10 MiB VMEM budget does not apply here)."""
    return fused_tile(tuple(L_shape), tuple(R_shape)) > 0


def monarch_fused_plain(x: torch.Tensor, L: torch.Tensor,
                        R: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: fp32 products, the
    intermediate rounded to ``x.dtype``, the output in ``x.dtype``."""
    T, _ = x.shape
    k, q, p = L.shape
    _, s, _ = R.shape
    u = torch.einsum("tkp,kqp->tkq", x.float().reshape(T, k, p), L.float())
    u = u.to(x.dtype).float()
    y = torch.einsum("tqk,qsk->tqs", u.transpose(1, 2), R.float())
    return y.reshape(T, q * s).to(x.dtype)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def monarch_fused(x: torch.Tensor, L: torch.Tensor,
                  R: torch.Tensor) -> torch.Tensor:
    """x: (T, din) -> (T, dout) with din = k*p, dout = q*s."""
    T, din = x.shape
    k, q, p = L.shape
    q2, s, k2 = R.shape
    if (q2, k2) != (q, k) or k * p != din:
        raise ValueError(f"bad shapes x{tuple(x.shape)} L{tuple(L.shape)} "
                         f"R{tuple(R.shape)}")
    if x.device.type == "cpu":
        return monarch_fused_plain(x, L, R)
    if x.device.type != "cuda" or L.device != x.device or R.device != x.device:
        raise ValueError("monarch_fused: x, L and R must share one CUDA "
                         "device")
    if not (x.is_contiguous() and L.is_contiguous() and R.is_contiguous()):
        raise ValueError("monarch_fused: tensors must be contiguous")
    if L.dtype != R.dtype:
        raise TypeError("monarch_fused: L and R must share a dtype")
    bT = fused_tile(tuple(L.shape), tuple(R.shape))
    if not bT:
        raise ValueError(f"monarch_fused: factors L{tuple(L.shape)} "
                         f"R{tuple(R.shape)} do not fit shared memory")
    bT = min(bT, max(T, 1))
    y = torch.empty((T, q * s), dtype=x.dtype, device=x.device)
    if T == 0:
        return y
    lib = _build.library("monarch", "monarch_fused_launch", _ARGTYPES)
    err = lib.monarch_fused_launch(
        _build.ptr(x), _build.ptr(L), _build.ptr(R), _build.ptr(y),
        T, k, q, p, s, bT, _build.dtype_code(x, "monarch_fused x"),
        _build.dtype_code(L, "monarch_fused factors"), _build.stream_of(x))
    _build.check(err, "monarch_fused launch")
    _build.LAUNCHES["monarch_fused"] += 1
    return y


__all__ = ["monarch_fused", "monarch_fused_plain", "fused_fits",
           "fused_tile", "fused_smem_bytes", "SMEM_BUDGET_BYTES"]
