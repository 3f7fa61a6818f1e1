"""Public wrappers around the Hopper kernels (port of
``repro/kernels/ops.py``).

``monarch_mm`` is what ``core.linear`` dispatches to when
``MonarchSpec.backend == "pallas"``: it flattens leading batch dims, runs
the fused two-stage kernel when a token tile's intermediate fits shared
memory (``kernels.monarch.fused_fits``), and otherwise the two ``bdmm``
stages with the folded permutation in between as a strided read.
``monarch_mm_q`` is the same dispatch over int8 / packed-int4 factors with
per-block scales (``core.quant``), through ``monarch_fused_q`` and
``bdmm_q``; its fit is the same rule on the UNPACKED shapes, since each
quantized kernel is its float twin's template with a dequantizing reader.

``paged_dispatch`` is THE kernel-vs-dense decision for one paged-attention
span step, shared by ``models.layers._paged_attend`` and the engine's
dispatch counters.  Its fit rule is the span kernel's shared memory on
Hopper, which the span does not enter (the kernel tiles its queries); the
reject reason keeps the reference's name ``"vmem"`` so the engine counters
stay comparable across packages.  Int8 pages need no argument of their
own: the rule sizes the kernel's shared memory for fp32 pages, and the
int8 instance stages a quarter of those bytes in the same layout.  Under
tensor parallelism the kernel runs per rank on its own heads (B7) when
the pool's KV heads are split as many ways as the
model; a pool left whole on every rank of a ``tp`` > 1 axis
(``pool_replicated``, ``sharding.params.TPPlan.pool_replicated``) takes
the dense gather with the reason ``"gqa_replicated"``, as in the
reference.  The per-rank head count does not enter the fit: the kernel
runs its blocks per query head, whatever their number.

Which path a call takes depends only on shapes: a CUDA tensor launches the
kernel, a CPU tensor runs the kernel's plain version.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.bdmm import bdmm, bdmm_q
from repro_torch.kernels.monarch import (fused_fits, monarch_fused,
                                         monarch_fused_q, quant_dims)
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


def monarch_mm_q(x: torch.Tensor, Lq: torch.Tensor, Ls: torch.Tensor,
                 Rq: torch.Tensor, Rs: torch.Tensor) -> torch.Tensor:
    """Quantized Monarch matmul: int8/int4 factors + per-block scales,
    dequantized on chip (fp32 accumulate).  x: (..., k*p) -> (..., q*s),
    in ``x.dtype``."""
    *batch, din = x.shape
    k, q, p, s, _ = quant_dims(x.shape, Lq, Ls, Rq, Rs)
    xt = x.reshape(-1, din).contiguous()
    if fused_fits((k, q, p), (q, s, k)):
        y = monarch_fused_q(xt, Lq, Ls, Rq, Rs)
    else:  # staged: two bdmm_q calls, the permutation is a strided read
        u = bdmm_q(xt.view(-1, k, p), Lq, Ls)              # (T, k, q)
        y = bdmm_q(u.transpose(-1, -2), Rq, Rs).reshape(-1, q * s)
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
                   paged_kernel: bool = True, softcap: bool = False,
                   pool_replicated: bool = False) -> str:
    """``"kernel"`` when the span kernel runs, else the reject reason (one
    of :data:`PAGED_DISPATCH_REASONS`): ``"disabled"`` — the config never
    asked for it; ``"softcap"`` — logit soft-capping has no kernel;
    ``"gqa_replicated"`` — a ``tp`` > 1 ``"model"`` axis over a pool whose
    KV heads are not split ``tp`` ways (``pool_replicated``), where only
    the dense gather runs on each rank's query heads; ``"vmem"`` — not
    even a one-row query tile fits shared memory.  It takes no
    ``quantized`` argument: the int8-page instance of the kernel needs no
    more shared memory than the float instance, so one rule decides
    both."""
    if not paged_kernel:
        return "disabled"
    if softcap:
        return "softcap"
    if pool_replicated:
        return "gqa_replicated"
    return "kernel" if paged_span_fits(head_dim, page_size) else "vmem"


__all__ = ["monarch_mm", "monarch_mm_q", "bdmm_mm", "paged_span_fits",
           "paged_dispatch", "PAGED_DISPATCH_REASONS"]
