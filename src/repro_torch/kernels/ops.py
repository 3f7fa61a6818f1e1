"""Public wrappers around the Hopper kernels (port of
``repro/kernels/ops.py``).

``monarch_mm`` is what ``core.linear`` dispatches to when
``MonarchSpec.backend == "pallas"``: it flattens leading batch dims, runs
the fused two-stage kernel when a token tile's intermediate fits shared
memory (``kernels.monarch.fused_fits``), and otherwise the two ``bdmm``
stages with the folded permutation in between as a strided read.

``paged_dispatch`` is THE kernel-vs-dense decision for one paged-attention
span step, shared by ``models.layers._paged_attend`` and the engine's
dispatch counters.  Its fit rule is the span kernel's shared memory on
Hopper, which the span does not enter (the kernel tiles its queries); the
reject reason keeps the reference's name ``"vmem"`` so the engine counters
stay comparable across packages.  Tensor-parallel pools and quantized
pages, which the reference's decision also weighs, are not ported yet.

Which path a call takes depends only on shapes: a CUDA tensor launches the
kernel, a CPU tensor runs the kernel's plain version.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.bdmm import bdmm
from repro_torch.kernels.monarch import fused_fits, monarch_fused
from repro_torch.kernels.paged import span_fits as paged_span_fits


def monarch_mm(x: torch.Tensor, L: torch.Tensor,
               R: torch.Tensor) -> torch.Tensor:
    """y = x @ M for Monarch factors; x: (..., k*p) -> (..., q*s), in
    ``x.dtype``."""
    *batch, din = x.shape
    k, q, p = L.shape
    _, s, _ = R.shape
    xt = x.reshape(-1, din).contiguous()
    if fused_fits(tuple(L.shape), tuple(R.shape)):
        y = monarch_fused(xt, L, R)
    else:  # staged: two bdmm calls, the permutation is a strided read
        u = bdmm(xt.view(-1, k, p), L)                    # (T, k, q)
        ut = u.transpose(-1, -2)                          # (T, q, k) view
        y = bdmm(ut, R).reshape(-1, q * s)                # (T, q, s)
    return y.reshape(*batch, q * s)


def bdmm_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Public block-diagonal matmul: x (..., k, p) @ w (k, q, p)."""
    *batch, k, p = x.shape
    y = bdmm(x.reshape(-1, k, p), w)
    return y.reshape(*batch, k, w.shape[1])


# why a span step stayed on the dense-gather path ("kernel" = it didn't)
PAGED_DISPATCH_REASONS = ("kernel", "disabled", "softcap", "gqa_replicated",
                          "vmem")


@functools.lru_cache(maxsize=None)
def paged_dispatch(head_dim: int, page_size: int, *,
                   paged_kernel: bool = True, softcap: bool = False) -> str:
    """``"kernel"`` when the span kernel runs, else the reject reason (one
    of :data:`PAGED_DISPATCH_REASONS`): ``"disabled"`` — the config never
    asked for it; ``"softcap"`` — logit soft-capping has no kernel;
    ``"vmem"`` — not even a one-row query tile fits shared memory."""
    if not paged_kernel:
        return "disabled"
    if softcap:
        return "softcap"
    return "kernel" if paged_span_fits(head_dim, page_size) else "vmem"


__all__ = ["monarch_mm", "bdmm_mm", "paged_span_fits", "paged_dispatch",
           "PAGED_DISPATCH_REASONS"]
