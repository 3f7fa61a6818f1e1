"""The ``("data", "model")`` mesh of a tensor-parallel run (port of
``repro.launch.mesh``).

The reference is single-controller: one process sees every device and
``jax.make_mesh`` names them.  The port is SPMD over ``torch.distributed``:
every rank is a process of its own, and a :class:`Mesh` is one rank's view
of the world — the axis sizes, its rank, its device and its process
groups.  Only ``data = 1`` is ported: the ``"model"`` axis spans the whole
world, so rank ``r`` holds shard ``r`` of every split tensor.

The backend is always named by the caller, never picked: ``"gloo"`` for
CPU ranks and for several ranks that share one card (NCCL refuses two
ranks on one device), ``"nccl"`` for one card per rank.  Every collective
times out after :data:`COLLECTIVE_TIMEOUT`, so ranks whose plans diverge
fail instead of hanging.

:func:`run_ranks` starts a whole world on one host (the CPU tests, the
one-card smoke run): one spawned process per rank, joined before it
returns, and an error if any rank failed.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import DeviceLike, resolve_device

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)
BACKENDS = ("gloo", "nccl")


def rank_device(device: DeviceLike = None) -> torch.device:
    """A rank's device: ``cuda`` unless the caller names the CPU
    (``repro_torch.resolve_device``), a CUDA device with its index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a ``("data", "model")`` mesh.

    ``device`` is resolved as every entry point's is: ``cuda`` unless the
    caller passes the CPU.  ``group`` carries the device tensors'
    collectives on ``backend``; ``host_group`` (gloo) carries host values
    such as the engine's clock, so they never wait on the device.  A mesh
    without groups (``group is None``) is a rank's shape alone: what a
    kernel wrapper or ``shard_params`` needs, but nothing can serve on it
    (the engine refuses it); :func:`make_host_mesh` joins the world."""

    model: int
    rank: int = 0
    data: int = 1
    device: DeviceLike = None
    backend: str = "gloo"
    group: Any = dataclasses.field(default=None, compare=False, repr=False)
    host_group: Any = dataclasses.field(default=None, compare=False,
                                        repr=False)

    def __post_init__(self) -> None:
        if self.data != 1:
            raise NotImplementedError(
                "a 'data' axis > 1 is not ported yet (data = 1 only)")
        if self.model < 1 or not 0 <= self.rank < self.model:
            raise ValueError(f"rank {self.rank} outside a {self.model}-way "
                             f"'model' axis")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{self.backend!r}")
        dev = rank_device(self.device)
        if self.backend == "nccl" and dev.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device per rank")
        object.__setattr__(self, "device", dev)


def make_host_mesh(*, model: int, rank: int, backend: str,
                   store: dist.Store, device: DeviceLike = None,
                   data: int = 1) -> Mesh:
    """Join a ``model``-rank world as ``rank`` and return its mesh.

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
            f"{dist.get_world_size()}, mesh asks rank {rank} of {model}")
    if dist.get_backend() != backend:
        raise ValueError(f"process group runs {dist.get_backend()}, mesh "
                         f"asks {backend}")
    group = dist.group.WORLD
    host = group if backend == "gloo" else dist.new_group(
        backend="gloo", timeout=COLLECTIVE_TIMEOUT)
    return dataclasses.replace(mesh, group=group, host_group=host)


# ---------------------------------------------------------------------------
# A whole world on one host
# ---------------------------------------------------------------------------


def _rank_main(fn, rank: int, world: int, backend: str, device, store_path,
               out_path, args) -> None:
    """A rank's process: an exception prints its traceback and exits 1
    (``multiprocessing`` does both)."""
    try:
        store = dist.FileStore(str(store_path), world)
        mesh = make_host_mesh(model=world, rank=rank, backend=backend,
                              store=store, device=device)
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
              timeout_s: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` ranks, one spawned process
    each, over ``backend`` on ``device`` (every rank on the same device:
    the CPU, or one card shared by all).  Returns each rank's return value
    in rank order (through ``torch.save``, so tensors and plain Python
    values travel).  ``fn`` must be importable by name from a fresh
    process.  Every process is joined before this returns; if any rank
    exits non-zero or outlives ``timeout_s``, the others are stopped and
    this raises."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        tmp = Path(tmp)
        outs = [tmp / f"rank{r}.pt" for r in range(world)]
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world, backend, device, tmp / "store", outs[r],
            tuple(args))) for r in range(world)]
        for p in procs:
            p.start()
        t_end = time.monotonic() + timeout_s
        timed_out = False
        try:
            # poll every rank, so one that fails stops the world at once
            # instead of after its peers' collective timeout
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > t_end:
                    timed_out = True
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
        if failed:
            raise RuntimeError("tensor-parallel world failed: "
                               + "; ".join(failed))
        return [torch.load(o, weights_only=False) for o in outs]


__all__ = ["Mesh", "make_host_mesh", "rank_device", "run_ranks",
           "COLLECTIVE_TIMEOUT", "BACKENDS"]
