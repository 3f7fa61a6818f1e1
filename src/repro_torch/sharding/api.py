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

Device tensors go through ``mesh.group`` (the model group: the ranks
that share this rank's data index) on the mesh's backend, which takes
them where they lie (gloo copies CUDA tensors through the host inside
the collective; NCCL reads them on the card).  ``mesh.data_group`` (the
ranks that share this rank's model index) carries data parallelism and
FSDP.  Host values go through ``mesh.host_group`` (gloo, the whole
world).  Sums run in fp32 whatever the activations' dtype, so a bf16
model's partial sums round once, after the reduction.

Training differentiates through the collectives, so each has an
autograd counterpart whose backward is the collective the forward's
use implies (Megatron's pair and its relatives):

* :func:`reduce_from` -- all-reduce forward, identity backward: a
  row-parallel linear's partial output, the vocab-parallel lookup, the
  MoE sublayer's partial sums, whose consumers are the same on every
  rank (over the data group: a global statistic, a loss's sums);
* :func:`copy_to` -- identity forward, all-reduce backward: a whole
  activation entering a rank's own part of the work (a column-parallel
  input, a whole projection's output that each rank slices), or a
  parameter replicated over the data group;
* :func:`reduce_both` -- all-reduce forward and backward: a sum whose
  consumers differ by rank (the gated norm's statistic);
* :func:`gather_slice` -- all-gather forward, this rank's slice
  backward: the vocab-parallel logits;
* :func:`gather_scatter` -- all-gather forward, reduce-scatter (sum)
  backward: an FSDP parameter shard.

**Shape-only groups** (:class:`ShapeGroup`) stand in for a process group
where no world exists: the dry run (``launch.dryrun``) traces one rank
of a production mesh on ``meta`` tensors.  A collective over one refuses
any tensor that is not ``meta`` (so it can never stand in for a real
collective), runs every operation the real call runs around the
collective itself, and returns a ``meta`` tensor of the shape the real
call returns.  On either kind of group each collective is counted by
``(kind, axis, operand bytes)`` (:func:`collective_bytes`), in the
reference's HLO names: ``"all-reduce"`` (the fp32 operand), ``"all-gather"``
(this rank's part) and ``"reduce-scatter"`` (the whole fp32 operand).
"""

from __future__ import annotations

import collections
import dataclasses

import torch
import torch.distributed as dist

# device collectives issued through this module, by kind (a reading for
# the train step's collectives a step: ``collectives()``)
_COUNTS: collections.Counter = collections.Counter()
# and by (kind, axis, operand bytes): a bounded table however long a
# server runs
_RECORDS: collections.Counter = collections.Counter()
# the mesh axis of each joined process group (``launch.mesh``)
_AXES: dict = {}


@dataclasses.dataclass(frozen=True)
class ShapeGroup:
    """A process group's shape alone: its mesh axis, size, this rank's
    index on it and the backend a real group would run.  Collectives over
    it take ``meta`` tensors only (module docstring)."""

    axis: str
    size: int
    rank: int
    backend: str


def name_axis(group, axis: str) -> None:
    """Record that the joined process group ``group`` is the mesh's
    ``axis`` group (its collectives' records carry that name)."""
    _AXES[group] = axis


def _size(group) -> int:
    if isinstance(group, ShapeGroup):
        return group.size
    return dist.get_world_size(group)


def _rank(group) -> int:
    if isinstance(group, ShapeGroup):
        return group.rank
    return dist.get_rank(group)


def _backend(group) -> str:
    if isinstance(group, ShapeGroup):
        return group.backend
    return dist.get_backend(group)


def _guard(x: torch.Tensor, group) -> None:
    if isinstance(group, ShapeGroup) and x.device.type != "meta":
        raise RuntimeError(
            f"a shape-only {group.axis!r} group runs no collective: it "
            f"takes meta tensors only, got one on {x.device}")


def _issue(kind: str, group, operand: torch.Tensor) -> bool:
    """Count one collective; True where ``group`` is a joined group (the
    caller runs it), False for a shape-only one."""
    axis = group.axis if isinstance(group, ShapeGroup) else _AXES.get(group)
    _RECORDS[(kind, axis, operand.numel() * operand.element_size())] += 1
    return not isinstance(group, ShapeGroup)


def collectives() -> dict:
    """{kind: count} of the device collectives issued through this module
    since :func:`reset_collectives` (forward and backward)."""
    return dict(_COUNTS)


def reset_collectives() -> None:
    _COUNTS.clear()


def collective_bytes() -> dict:
    """{(kind, axis, operand bytes): count} of the device collectives
    issued through this module since :func:`reset_collective_bytes`; the
    axis is None for a group no mesh named."""
    return dict(_RECORDS)


def reset_collective_bytes() -> None:
    _RECORDS.clear()


def divides(dim: int, tp: int) -> bool:
    """The reference's divisibility guard: a dim is split over a ``tp``-way
    axis only when ``tp`` divides it; otherwise it stays replicated (never
    uneven shards)."""
    return tp > 1 and dim % tp == 0


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    _guard(x, group)
    _COUNTS["all_reduce"] += 1
    y = x.float().contiguous()
    if y is x:
        y = y.clone()
    if _issue("all-reduce", group, y):
        dist.all_reduce(y, op=_OPS[op], group=group)
    return y.to(x.dtype)


def reduce_stats(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The ranks' elementwise ``op`` ("sum" or "max") of ``x`` over
    ``group``, in fp32: a step's per-leaf statistics (the global norm's
    squares, the compression scale's max); no gradient."""
    return _reduce(x, group, op)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    _guard(x, group)
    _COUNTS["all_gather"] += 1
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    if _issue("all-gather", group, x):
        dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise sum of every rank's ``x`` over the model group (fp32
    accumulate), in ``x``'s dtype, on every rank."""
    return _reduce(x, mesh.group)


def all_gather_cat(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """Every model rank's ``x`` concatenated on ``dim`` in rank order, on
    every rank (exact: no arithmetic)."""
    return _gather(x, mesh.group, dim)


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    _guard(x, group)
    n = x.shape[dim] // _size(group)
    return x.narrow(dim, _rank(group) * n, n).contiguous()


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's slice on ``dim`` of the ranks' sum (fp32 accumulate).
    gloo has no reduce-scatter: it sums the whole and slices."""
    if _backend(group) != "nccl":
        return _slice(_reduce(x, group), group, dim)
    _guard(x, group)
    _COUNTS["reduce_scatter"] += 1
    y = x.float().movedim(dim, 0).contiguous()
    out = y.new_empty((y.shape[0] // _size(group), *y.shape[1:]))
    if _issue("reduce-scatter", group, y):
        dist.reduce_scatter_tensor(out, y, group=group)
    return out.movedim(0, dim).contiguous().to(x.dtype)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _ReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _GatherSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None


class _GatherScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


def _dim(x: torch.Tensor, dim: int) -> int:
    return dim % x.dim()


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' sum of ``x`` over ``group`` (all-reduce forward, fp32
    accumulate); the gradient passes through unchanged."""
    return _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient is the ranks' sum over ``group``."""
    return _CopyTo.apply(x, group)


def reduce_both(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' sum of ``x`` over ``group``; so is its gradient."""
    return _ReduceBoth.apply(x, group)


def gather_slice(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated on ``dim`` in rank order (exact);
    the gradient is this rank's slice of the whole one."""
    return _GatherSlice.apply(x, group, _dim(x, dim))


def gather_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated on ``dim`` in rank order (an FSDP
    parameter put back together); the gradient is this rank's slice of
    the ranks' summed gradients (reduce-scatter)."""
    return _GatherScatter.apply(x, group, _dim(x, dim))


def split_input(x: torch.Tensor, plan, split: bool) -> torch.Tensor:
    """``x`` marked with :func:`copy_to` over the plan's model group
    where ``split`` (the work it feeds is split over the ranks), else
    ``x``."""
    return copy_to(x, plan.mesh.group) if split else x


def broadcast_time(value: float, mesh, src: int = 0) -> float:
    """Rank ``src``'s ``value`` (a host clock reading) on every rank."""
    t = torch.tensor([value], dtype=torch.float64)
    dist.broadcast(t, src=src, group=mesh.host_group)
    return float(t[0])


def barrier(mesh) -> None:
    """Wait until every rank of the mesh reaches this call (host group)."""
    dist.barrier(group=mesh.host_group)


__all__ = ["divides", "all_reduce_sum", "all_gather_cat", "broadcast_time",
           "barrier", "reduce_from", "copy_to", "reduce_both",
           "gather_slice", "gather_scatter", "split_input", "reduce_stats",
           "collectives", "reset_collectives", "collective_bytes",
           "reset_collective_bytes", "ShapeGroup", "name_axis"]
