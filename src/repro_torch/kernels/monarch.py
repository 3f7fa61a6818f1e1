"""Fused two-stage Monarch product on Hopper (``csrc/monarch.cu``).

Replaces ``repro/kernels/monarch.py:monarch_fused`` (Pallas
``_monarch_kernel``): y = reshape(R-stage(P(L-stage(reshape(x))))) with the
intermediate kept on chip, fp32 accumulation, the intermediate rounded to
``x.dtype`` between the stages, and the output in ``x.dtype``; and
``monarch_fused_q`` (Pallas ``_monarch_q_kernel``), the same product over
int8 or nibble-packed int4 factors with one fp32 scale per diagonal block,
dequantized on chip.  The quantized kernel is the float kernel's template
with another factor reader: each block is staged in shared memory as
``float(v) * scale`` (``core.quant.dequantize_factor``'s one multiply), so
it is bitwise ``monarch_fused`` on the dequantized factors, has the same
shared-memory fit, and reads 1 or 0.5 bytes per weight instead of 4.

Bound on an H100 SXM: the factors dominate the bytes at serving sizes
(gpt2-medium's three factor pairs are 0.26, 0.66 and 1.31 MB in fp32) and
the product is 2*T*(kqp + qsk) FLOPs, so it is bytes-bound below about
T = 40 tokens and operations-bound above it, against 3.35 TB/s and
67 TFLOP/s fp32 without tensor cores.  The design reads x and writes y
once, never writes the intermediate to device memory, and streams each
factor block through shared memory once per token tile; at small T a
single block does the whole product, so the first limit it meets is one
SM's share of the bandwidth, not the card's (see PERF.md).

``monarch_fused`` (``monarch_fused_q``) launches the kernel for a CUDA
tensor and uses the plain version ``monarch_fused_plain``
(``monarch_fused_q_plain``) only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quant import dequantize_factor
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


def quant_dims(x_shape, Lq, Ls, Rq, Rs) -> tuple[int, int, int, int, int]:
    """(k, q, p, s, bits) of a quantized factor pair for activations of
    ``x_shape``; bits 4 when both factors are packed along their
    contraction axis.  Raises on a container the kernels do not take."""
    din = x_shape[-1]
    k, q = Ls.shape[0], Rs.shape[0]
    p, s = din // k, Rq.shape[1]
    ok = (k * p == din and Lq.dim() == 3 and Rq.dim() == 3
          and tuple(Lq.shape[:2]) == (k, q) and Rq.shape[0] == q
          and tuple(Ls.shape) == (k, 1, 1) and tuple(Rs.shape) == (q, 1, 1))
    if ok and (Lq.shape[2], Rq.shape[2]) == (p, k):
        return k, q, p, s, 8
    if ok and (2 * Lq.shape[2], 2 * Rq.shape[2]) == (p, k):
        return k, q, p, s, 4
    raise ValueError(f"bad quantized shapes x{tuple(x_shape)} "
                     f"Lq{tuple(Lq.shape)} Ls{tuple(Ls.shape)} "
                     f"Rq{tuple(Rq.shape)} Rs{tuple(Rs.shape)}")


def monarch_fused_q_plain(x: torch.Tensor, Lq: torch.Tensor,
                          Ls: torch.Tensor, Rq: torch.Tensor,
                          Rs: torch.Tensor) -> torch.Tensor:
    """The quantized kernel's arithmetic in plain PyTorch: dequantize both
    factors to fp32, then :func:`monarch_fused_plain`."""
    k, _, p, _, _ = quant_dims(x.shape, Lq, Ls, Rq, Rs)
    return monarch_fused_plain(x, dequantize_factor(Lq, Ls, unpacked_dim=p),
                               dequantize_factor(Rq, Rs, unpacked_dim=k))


_Q_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def monarch_fused_q(x: torch.Tensor, Lq: torch.Tensor, Ls: torch.Tensor,
                    Rq: torch.Tensor, Rs: torch.Tensor) -> torch.Tensor:
    """x: (T, k*p) -> (T, q*s) in x's dtype; Lq: (k, q, p[/2]) int8, Ls:
    (k, 1, 1) fp32, Rq: (q, s, k[/2]) int8, Rs: (q, 1, 1) fp32."""
    T, _ = x.shape
    k, q, p, s, bits = quant_dims(x.shape, Lq, Ls, Rq, Rs)
    if x.device.type == "cpu":
        return monarch_fused_q_plain(x, Lq, Ls, Rq, Rs)
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (Lq, Ls, Rq, Rs)):
        raise ValueError("monarch_fused_q: every tensor must be on one CUDA "
                         "device")
    if not all(t.is_contiguous() for t in (x, Lq, Ls, Rq, Rs)):
        raise ValueError("monarch_fused_q: tensors must be contiguous")
    if (Lq.dtype, Rq.dtype, Ls.dtype, Rs.dtype) != (
            torch.int8, torch.int8, torch.float32, torch.float32):
        raise TypeError("monarch_fused_q: factors int8, scales float32")
    bT = fused_tile((k, q, p), (q, s, k))
    if not bT:
        raise ValueError(f"monarch_fused_q: factors ({k}, {q}, {p}) / "
                         f"({q}, {s}, {k}) do not fit shared memory")
    bT = min(bT, max(T, 1))
    y = torch.empty((T, q * s), dtype=x.dtype, device=x.device)
    if T == 0:
        return y
    lib = _build.library("monarch", "monarch_fused_q_launch", _Q_ARGTYPES)
    err = lib.monarch_fused_q_launch(
        _build.ptr(x), _build.ptr(Lq), _build.ptr(Ls), _build.ptr(Rq),
        _build.ptr(Rs), _build.ptr(y), T, k, q, p, s, bT,
        _build.dtype_code(x, "monarch_fused_q x"), bits, _build.stream_of(x))
    _build.check(err, "monarch_fused_q launch")
    _build.LAUNCHES["monarch_fused_q"] += 1
    return y


__all__ = ["monarch_fused", "monarch_fused_plain", "monarch_fused_q",
           "monarch_fused_q_plain", "quant_dims", "fused_fits",
           "fused_tile", "fused_smem_bytes", "SMEM_BUDGET_BYTES"]
