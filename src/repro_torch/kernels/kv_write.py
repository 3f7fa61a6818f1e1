"""The int8 KV write on Hopper (``csrc/kv_write.cu``).

Replaces ``repro/core/quant.py:238`` ``quantize_kv_write``: jnp code that
XLA compiles into the reference's jitted engine step, not a Pallas kernel.
It scatters new K (or V) span rows into the int8 page pool and keeps the
per-(page, KV head) fp32 scales, rescaling stored rows where a scale
grows.  The port's plain version, ``core.quant.quantize_kv_write``, runs
about 40 eager ops a call, and an int8 pool calls it twice a layer.

:func:`quantize_kv_write` sends a CPU tensor to that plain version and a
CUDA tensor to the kernel: one call, which clears its scratch and issues
three launches in stream order (per-position scale candidates, per-page
scale update and rescale, the quantized rows' store; the source note has
the design).  Pages and scales come out bitwise the plain version's,
including where a page repeats in the rescale set and where several masked
positions write the sink's same row (the last one wins, as an index_put
on the CPU resolves it).  A call counts one launch as
``quantize_kv_write``.

Bound on an H100 SXM: bytes (the source note lists them) over 3.35 TB/s;
at decode, the latency of the call's four graph nodes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import quant
from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
             + [ctypes.c_void_p] * 3)


def scratch_words(B: int, S: int, K: int, KV: int, pg: int) -> int:
    """int32 words of one call's scratch (csrc/kv_write.cu: Scratch):
    E = B*K + 1 + B*S slots of KV candidate scales, a flag and ``pg``
    writers each, then one slot index a position."""
    E = B * K + 1 + B * S
    return E * (KV + 1 + pg) + B * S


def quantize_kv_write(pages: torch.Tensor, scales: torch.Tensor,
                      phys: torch.Tensor, off: torch.Tensor,
                      rows: torch.Tensor,
                      rescale_phys: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter span rows into int8 pages in place, keeping the scales;
    returns (pages, scales), the tensors given.  Shapes and meaning as
    ``core.quant.quantize_kv_write``: pages (P, page, KV, hd) int8, scales
    (P, KV) fp32, phys/off (B, S), rows (B, S, KV, hd), rescale_phys
    (B, K) (default: phys)."""
    if pages.device.type == "cpu":
        return quant.quantize_kv_write(pages, scales, phys, off, rows,
                                       rescale_phys)
    P, pg, KV, hd = pages.shape
    B, S = phys.shape
    rp = phys if rescale_phys is None else rescale_phys
    dev = pages.device
    if (tuple(scales.shape) != (P, KV) or tuple(off.shape) != (B, S)
            or tuple(rows.shape) != (B, S, KV, hd) or rp.dim() != 2
            or rp.shape[0] != B):
        raise ValueError(
            f"quantize_kv_write: bad shapes pages{tuple(pages.shape)} "
            f"scales{tuple(scales.shape)} phys{tuple(phys.shape)} "
            f"off{tuple(off.shape)} rows{tuple(rows.shape)} "
            f"rescale{tuple(rp.shape)}")
    if dev.type != "cuda" or any(t.device != dev for t in (
            scales, phys, off, rows, rp)):
        raise ValueError("quantize_kv_write: every tensor must be on one "
                         "CUDA device")
    if pages.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("quantize_kv_write: int8 pages and float32 scales")
    if not (pages.is_contiguous() and scales.is_contiguous()):
        raise ValueError("quantize_kv_write: pages and scales are written "
                         "in place and must be contiguous")
    if B * S == 0:
        return pages, scales
    code = _build.dtype_code(rows, "quantize_kv_write rows")
    if rows.stride(3) != 1 or rows.stride(2) != hd:
        rows = rows.contiguous()
    ph, of, rp = (t.to(torch.int64).contiguous() for t in (phys, off, rp))
    K = rp.shape[1]
    scratch = torch.empty(scratch_words(B, S, K, KV, pg), dtype=torch.int32,
                          device=dev)
    args = (ctypes.c_int * 8)(B, S, K, KV, hd, pg, P, code)
    lib = _build.library("kv_write", "kv_write_launch", _ARGTYPES)
    err = lib.kv_write_launch(
        pages.data_ptr(), scales.data_ptr(), ph.data_ptr(), of.data_ptr(),
        rp.data_ptr(), rows.data_ptr(), rows.stride(0), rows.stride(1),
        scratch.data_ptr(), args, _build.stream_of(pages))
    _build.check(err, "quantize_kv_write launch")
    _build.LAUNCHES["quantize_kv_write"] += 1
    return pages, scales


__all__ = ["quantize_kv_write", "scratch_words"]
