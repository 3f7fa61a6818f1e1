"""What explicit SPMD needs of ``repro.sharding.api``: the divisibility
guard and the collectives.

The reference tags activations with logical axis names (``logical``,
``axis_rules``) and lets GSPMD place them and insert the collectives.
Those tags have no counterpart here: each rank of the port holds its
shard already (``sharding.params.shard_params``), computes on local
shapes, and calls the few collectives below where the Megatron scheme
needs them — one ``all_reduce`` after each row-parallel linear and after
the vocab-parallel lookup, one ``all_gather`` of the vocab-parallel
logits, and one broadcast of rank 0's clock per engine step.

Device tensors go through ``mesh.group`` on the mesh's backend, which
takes them where they lie (gloo copies CUDA tensors through the host
inside the collective; NCCL reads them on the card).  Host values go
through ``mesh.host_group`` (gloo).  Sums run in fp32 whatever the
activations' dtype, so a bf16 model's partial sums round once, after the
reduction.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def divides(dim: int, tp: int) -> bool:
    """The reference's divisibility guard: a dim is split over a ``tp``-way
    axis only when ``tp`` divides it; otherwise it stays replicated (never
    uneven shards)."""
    return tp > 1 and dim % tp == 0


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise sum of every rank's ``x`` (fp32 accumulate), in
    ``x``'s dtype, on every rank."""
    y = x.float().contiguous()
    if y is x:
        y = y.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group)
    return y.to(x.dtype)


def all_gather_cat(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated on ``dim`` in rank order, on every
    rank (exact: no arithmetic)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.model)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim=dim)


def broadcast_time(value: float, mesh, src: int = 0) -> float:
    """Rank ``src``'s ``value`` (a host clock reading) on every rank."""
    t = torch.tensor([value], dtype=torch.float64)
    dist.broadcast(t, src=src, group=mesh.host_group)
    return float(t[0])


__all__ = ["divides", "all_reduce_sum", "all_gather_cat", "broadcast_time"]
