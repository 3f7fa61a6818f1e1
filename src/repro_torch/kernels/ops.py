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

Both also take a mixture-of-experts layer's stacked experts (factors with
a leading expert axis, ``L.ndim == 4``; x (E, ..., k*p)), the reference's
``monarch_mm`` under ``jax.vmap``: a fused shape is ONE launch over the
expert axis (``monarch_fused_experts`` / ``monarch_fused_q_experts``); a
staged one (none of the published MoE configs' expert shapes; a
``:mxu`` or hand-sized one may) loops the experts, two ``bdmm`` /
``bdmm_q`` launches each, so 2E launches a projection.

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
                                         monarch_fused_experts,
                                         monarch_fused_q,
                                         monarch_fused_q_experts, quant_dims)
from repro_torch.kernels.paged import span_fits as paged_span_fits


def monarch_mm(x: torch.Tensor, L: torch.Tensor,
               R: torch.Tensor) -> torch.Tensor:
    """y = x @ M for Monarch factors; x: (..., k*p) -> (..., q*s), in
    ``x.dtype``.  Stacked experts: L (E, k, q, p), R (E, q, s, k), x (E,
    ..., k*p) -> (E, ..., q*s), expert e's rows through expert e's
    factors."""
    k, q, p = L.shape[-3:]
    experts = L.dim() == 4
    return _mm(x, (k, q, p, R.shape[-2]), experts,
               monarch_fused_experts if experts else monarch_fused, bdmm,
               (L,), (R,))


def monarch_mm_q(x: torch.Tensor, Lq: torch.Tensor, Ls: torch.Tensor,
                 Rq: torch.Tensor, Rs: torch.Tensor) -> torch.Tensor:
    """Quantized Monarch matmul: int8/int4 factors + per-block scales,
    dequantized on chip (fp32 accumulate).  x: (..., k*p) -> (..., q*s),
    in ``x.dtype``; stacked experts as in :func:`monarch_mm`."""
    k, q, p, s, _ = quant_dims(x.shape, Lq, Ls, Rq, Rs)
    experts = Lq.dim() == 4
    return _mm(x, (k, q, p, s), experts,
               monarch_fused_q_experts if experts else monarch_fused_q,
               bdmm_q, (Lq, Ls), (Rq, Rs))


def _mm(x: torch.Tensor, dims: tuple, experts: bool, fused, stage,
        Lw: tuple, Rw: tuple) -> torch.Tensor:
    """The dispatch of both: ``fused(xt, *Lw, *Rw)`` when the shape fits
    (one launch, over the expert axis too), else two ``stage`` calls a
    product, the permutation a strided read (per expert: 2E launches)."""
    k, q, p, s = dims
    lead = x.shape[:-1]
    xt = (x.reshape(lead[0], -1, k * p) if experts
          else x.reshape(-1, k * p)).contiguous()
    if fused_fits((k, q, p), (q, s, k)):
        y = fused(xt, *Lw, *Rw)
    elif experts:
        y = torch.stack([_staged(xt[e], stage, [w[e] for w in Lw],
                                 [w[e] for w in Rw], dims)
                         for e in range(xt.shape[0])])
    else:
        y = _staged(xt, stage, Lw, Rw, dims)
    return y.reshape(*lead, q * s)


def _staged(xt: torch.Tensor, stage, Lw, Rw, dims: tuple) -> torch.Tensor:
    """xt (T, k*p) -> (T, q*s) through two block-diagonal stages."""
    k, q, p, s = dims
    u = stage(xt.view(-1, k, p), *Lw)                 # (T, k, q)
    return stage(u.transpose(-1, -2), *Rw).reshape(-1, q * s)


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
