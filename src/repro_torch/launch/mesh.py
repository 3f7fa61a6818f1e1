"""The ``("data", "model")`` mesh of a data- and tensor-parallel run (port
of ``repro.launch.mesh``).

The reference is single-controller: one process sees every device and
``jax.make_mesh`` names them.  The port is SPMD over ``torch.distributed``:
every rank is a process of its own, and a :class:`Mesh` is one rank's view
of the world -- the axis sizes, its rank, its device and its process
groups.  World rank ``r`` sits at ``(r // model, r % model)``: its data
index and its model index.  The ranks of one data index form its model
group (``group``: tensor parallelism; rank ``m`` of it holds shard ``m`` of
every split tensor); the ranks of one model index form its data group
(``data_group``: data parallelism and FSDP).  At ``data = 1`` the model
group is the whole world.

The backend is always named by the caller, never picked: ``"gloo"`` for
CPU ranks and for several ranks that share one card (NCCL refuses two
ranks on one device), ``"nccl"`` for one card per rank.  Every collective
times out after :data:`COLLECTIVE_TIMEOUT`, so ranks whose plans diverge
fail instead of hanging.

:func:`run_ranks` starts a whole world on one host (the CPU tests, the
one-card smoke run): one spawned process per rank, joined before it
returns, and an error if any rank failed.

:func:`make_production_mesh` is the reference's ``(16, 16)`` mesh as one
rank sees it, with no world behind it: its groups are shape-only
(``sharding.api.ShapeGroup``) and its device ``meta``, so the dry run
(``launch.dryrun``) traces that rank's step without a card
(:func:`shape_mesh` builds the same at any axis sizes).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import DeviceLike, resolve_device
from repro_torch.sharding import api

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)
BACKENDS = ("gloo", "nccl")
PRODUCTION_MESH = (16, 16)          # the reference's single pod: data x model


def rank_device(device: DeviceLike = None) -> torch.device:
    """A rank's device: ``cuda`` unless the caller names the CPU
    (``repro_torch.resolve_device``), a CUDA device with its index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a ``("data", "model")`` mesh: ``rank`` is the
    world rank, at (:attr:`data_rank`, :attr:`model_rank`).

    ``device`` is resolved as every entry point's is: ``cuda`` unless the
    caller passes the CPU.  ``group`` (the model group) and
    ``data_group`` carry the device tensors' collectives on ``backend``;
    ``host_group`` (gloo, the whole world) carries host values such as the
    engine's clock, so they never wait on the device.  A mesh without
    groups (``group is None``) is a rank's shape alone: what a kernel
    wrapper or ``shard_params`` needs, but nothing can serve or train on
    it; :func:`make_host_mesh` joins the world."""

    model: int
    rank: int = 0
    data: int = 1
    device: DeviceLike = None
    backend: str = "gloo"
    group: Any = dataclasses.field(default=None, compare=False, repr=False)
    host_group: Any = dataclasses.field(default=None, compare=False,
                                        repr=False)
    data_group: Any = dataclasses.field(default=None, compare=False,
                                        repr=False)

    def __post_init__(self) -> None:
        if self.model < 1 or self.data < 1:
            raise ValueError(f"axis sizes must be >= 1, got data "
                             f"{self.data} x model {self.model}")
        if not 0 <= self.rank < self.model * self.data:
            raise ValueError(f"rank {self.rank} outside a {self.data} x "
                             f"{self.model} ('data', 'model') mesh")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{self.backend!r}")
        dev = rank_device(self.device)
        if self.backend == "nccl" and dev.type not in ("cuda", "meta"):
            raise ValueError("the nccl backend needs a CUDA device per rank")
        object.__setattr__(self, "device", dev)

    @property
    def model_rank(self) -> int:
        """This rank's index on the ``"model"`` axis (its shard)."""
        return self.rank % self.model

    @property
    def data_rank(self) -> int:
        """This rank's index on the ``"data"`` axis (its rows)."""
        return self.rank // self.model

    @property
    def world(self) -> int:
        return self.data * self.model


def _axis_groups(model: int, data: int, rank: int, backend: str):
    """(model group, data group) of world rank ``rank``: at ``data = 1``
    the world and None.  Every rank creates every group, in the same
    order (``dist.new_group`` is collective)."""
    if data == 1:
        return dist.group.WORLD, None
    mine = [None, None]
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)],
                           backend=backend, timeout=COLLECTIVE_TIMEOUT)
        if d == rank // model:
            mine[0] = g
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)],
                           backend=backend, timeout=COLLECTIVE_TIMEOUT)
        if m == rank % model:
            mine[1] = g
    return mine[0], mine[1]


def make_host_mesh(*, model: int, rank: int, backend: str,
                   store: dist.Store, device: DeviceLike = None,
                   data: int = 1) -> Mesh:
    """Join a ``data x model``-rank world as world rank ``rank`` and return
    its mesh.

    ``store`` is the rendezvous the ranks share (a ``FileStore``, or a
    ``TCPStore`` on ``localhost:<port>``); ``device`` is this rank's device
    (``cuda`` unless the caller asks for the CPU).  The default process
    group is created here, once per process, with
    :data:`COLLECTIVE_TIMEOUT`."""
    mesh = Mesh(model=model, rank=rank, data=data, device=device,
                backend=backend)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    if not dist.is_initialized():
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=model * data,
                                timeout=COLLECTIVE_TIMEOUT)
    if dist.get_world_size() != model * data or dist.get_rank() != rank:
        raise ValueError(
            f"process group is rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, mesh asks rank {rank} of a "
            f"{data} x {model} mesh")
    if dist.get_backend() != backend:
        raise ValueError(f"process group runs {dist.get_backend()}, mesh "
                         f"asks {backend}")
    group, data_group = _axis_groups(model, data, rank, backend)
    api.name_axis(group, "model")
    if data_group is not None:
        api.name_axis(data_group, "data")
    host = dist.group.WORLD if backend == "gloo" else dist.new_group(
        backend="gloo", timeout=COLLECTIVE_TIMEOUT)
    return dataclasses.replace(mesh, group=group, data_group=data_group,
                               host_group=host)


def shape_mesh(data: int, model: int, *, rank: int = 0,
               backend: str = "nccl") -> Mesh:
    """World rank ``rank``'s view of a ``data x model`` mesh with no world
    behind it: device ``meta``, the model group and (at ``data > 1``) the
    data group shape-only (``sharding.api.ShapeGroup``: axis, size, this
    rank's index, ``backend``), no host group.  A step traced on it runs
    every operation of that rank's step on meta tensors and records each
    collective instead of running it."""
    mesh = Mesh(model=model, rank=rank, data=data, device="meta",
                backend=backend)
    group = api.ShapeGroup("model", model, mesh.model_rank, backend)
    data_group = None if data == 1 else api.ShapeGroup(
        "data", data, mesh.data_rank, backend)
    return dataclasses.replace(mesh, group=group, data_group=data_group)


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0,
                         backend: str = "nccl") -> Mesh:
    """The reference's single-pod mesh, data 16 x model 16, as world rank
    ``rank`` sees it (:func:`shape_mesh`).  ``multi_pod`` (the reference's
    ``(2, 16, 16)`` with a ``"pod"`` axis) raises: that axis is not
    ported (ROADMAP.md §A)."""
    if multi_pod:
        raise NotImplementedError(
            "the multi-pod mesh's 'pod' axis is not ported yet "
            "(ROADMAP.md §A)")
    return shape_mesh(*PRODUCTION_MESH, rank=rank, backend=backend)


# ---------------------------------------------------------------------------
# A whole world on one host
# ---------------------------------------------------------------------------


def _rank_main(fn, rank: int, world: int, backend: str, device, store_path,
               out_path, args, data: int = 1) -> None:
    """A rank's process: an exception prints its traceback and exits 1
    (``multiprocessing`` does both)."""
    try:
        store = dist.FileStore(str(store_path), world)
        mesh = make_host_mesh(model=world // data, rank=rank,
                              backend=backend, store=store, device=device,
                              data=data)
        torch.save(fn(mesh, *args), out_path)
        # no rank tears its process group down while a peer still talks
        # to it (gloo can abort the process at exit otherwise)
        dist.barrier(group=mesh.host_group)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable[..., Any], world: int, *, backend: str,
              device: DeviceLike = None, args: Sequence = (),
              workdir: Optional[os.PathLike] = None,
              timeout_s: float = 600.0, data: int = 1,
              stop: Optional[threading.Event] = None) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` ranks, one spawned process
    each, over ``backend`` on ``device`` (every rank on the same device:
    the CPU, or one card shared by all), as a ``data x (world / data)``
    mesh (``data`` must divide ``world``).  Returns each rank's return value
    in rank order (through ``torch.save``, so tensors and plain Python
    values travel).  ``fn`` must be importable by name from a fresh
    process.  Every process is joined before this returns; if any rank
    exits non-zero or outlives ``timeout_s``, or ``stop`` is set (by a
    caller that runs the world in a thread of its own and gives up on it),
    the others are stopped and this raises."""
    if data < 1 or world % data:
        raise ValueError(f"data={data} does not divide the {world} ranks")
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        tmp = Path(tmp)
        outs = [tmp / f"rank{r}.pt" for r in range(world)]
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world, backend, device, tmp / "store", outs[r],
            tuple(args), data)) for r in range(world)]
        for p in procs:
            p.start()
        t_end = time.monotonic() + timeout_s
        timed_out = stopped = False
        try:
            # poll every rank, so one that fails stops the world at once
            # instead of after its peers' collective timeout
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > t_end:
                    timed_out = True
                    break
                if stop is not None and stop.is_set():
                    stopped = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(30)
                if p.is_alive():
                    p.kill()
                    p.join()
        failed = [f"rank {r} exited with {p.exitcode}"
                  for r, p in enumerate(procs) if p.exitcode != 0]
        if timed_out:
            failed.insert(0, f"timed out after {timeout_s} s")
        if stopped:
            failed.insert(0, "stopped by its caller")
        if failed:
            raise RuntimeError("tensor-parallel world failed: "
                               + "; ".join(failed))
        return [torch.load(o, weights_only=False) for o in outs]


__all__ = ["Mesh", "make_host_mesh", "rank_device", "run_ranks",
           "shape_mesh", "make_production_mesh", "PRODUCTION_MESH",
           "COLLECTIVE_TIMEOUT", "BACKENDS"]
