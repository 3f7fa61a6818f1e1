"""Trainer: the training loop around ``make_train_step`` (port of
``repro.train.trainer``).

Wires together the train step (optionally microbatched and gradient
compressed), the data pipeline, checkpoint save and restore-with-resume
through the port's store (the reference's on-disk layout, so either
package resumes the other's run), heartbeats and straggler monitoring,
and the elastic-remesh decision point.  The step is eager on one device
(``cuda`` unless the caller passes ``device="cpu"``).

Under a ``("data", "model")`` mesh of more than one rank (``mesh=``, a
mesh that joined its world) every rank runs a Trainer: the state is its
shards, made as they are drawn (``make_train_step(mesh=)``), and each
data rank reads its host's stream (:meth:`Trainer.host_data`:
``host_count = data``, ``host_index`` its data index), as the
reference's pipeline is written.  The global batch is the hosts' rows
in data order; with ``accum_steps > 1`` the data ranks gather it and
each takes its ``shard_batch`` rows, so that microbatch ``i`` is the
global batch's ``i``-th block, as on one process.  Checkpoints keep the
reference's layout of whole leaves: each is put back together from every
rank's shard one leaf at a time and written by rank 0, and every rank
restores its own shards, so a run saved under a mesh resumes on one
process, and the reverse.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

import torch
import torch.distributed as dist

from repro_torch import DeviceLike, resolve_device, tree_map
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.data import DataConfig
from repro_torch.ft.coordinator import (HeartbeatRegistry, StragglerMonitor,
                                        plan_elastic_remesh)
from repro_torch.launch.steps import (batch_to, make_train_step,
                                     shard_batch, train_plan)
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, cosine_schedule, wsd_schedule
from repro_torch.optim.adamw import AdamWState, Optimizer
from repro_torch.sharding import api
from repro_torch.sharding.params import shard_leaf, unshard_leaf


def _leaf_path(pid: str) -> Optional[str]:
    """The parameter path of a train-state leaf id (``params__a__b``,
    ``opt__.mu__a__b``, ``ef__a__b`` -> ``a/b``); None for the
    optimizer's step, which every rank holds whole."""
    parts = pid.split("__")
    if parts[0] == "opt":
        if parts[1] == ".step":
            return None
        return "/".join(parts[2:])
    return "/".join(parts[1:])


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    peak_lr: float = 3e-4
    warmup: int = 10
    schedule: str = "cosine"          # "cosine" | "wsd" (MiniCPM)
    accum_steps: int = 1
    compress_grads: bool = False
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_last: int = 2
    seed: int = 0
    # fault tolerance knobs
    heartbeat_timeout_s: float = 300.0
    straggler_threshold: float = 1.5


class Trainer:
    def __init__(self, model_cfg: ModelConfig, tcfg: TrainerConfig,
                 mesh=None, device: DeviceLike = None):
        """``mesh``: a ``launch.mesh.Mesh`` (its device is the trainer's),
        or None.  A mesh of more than one rank must have joined its world
        (``launch.mesh.make_host_mesh``); every rank then builds its own
        Trainer (module docstring)."""
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = resolve_device(device)
        spmd = mesh if mesh is not None and mesh.world > 1 else None
        self._spmd = spmd
        if tcfg.schedule == "wsd":
            decay = max(tcfg.steps // 10, 1)
            lr = wsd_schedule(tcfg.peak_lr, tcfg.warmup,
                              stable=max(tcfg.steps - tcfg.warmup - decay, 1),
                              decay=decay)
        else:
            lr = cosine_schedule(tcfg.peak_lr, tcfg.warmup, tcfg.steps)
        self.optimizer: Optimizer = adamw(lr=lr)
        self.init_state, self.train_step = make_train_step(
            model_cfg, self.optimizer, accum_steps=tcfg.accum_steps,
            compress_grads=tcfg.compress_grads, mesh=spmd)
        self.plan = self.table = None
        if spmd is not None:
            self.plan, self.table = train_plan(model_cfg, spmd)
        self.heartbeats = HeartbeatRegistry(timeout_s=tcfg.heartbeat_timeout_s)
        self.stragglers = StragglerMonitor(threshold=tcfg.straggler_threshold)
        self.history: list[dict] = []

    # -- state ---------------------------------------------------------------

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    def host_data(self, dcfg: DataConfig) -> DataConfig:
        """This rank's stream of a global data config: its data index's
        host of ``mesh.data`` hosts (the whole stream on one process)."""
        if self._spmd is None:
            return dcfg
        return dataclasses.replace(dcfg, host_count=self.mesh.data,
                                   host_index=self.mesh.data_rank)

    def _step_rows(self, batch: dict) -> dict:
        """The rows this rank steps on, from its host's ``batch``: the
        host's rows themselves, or under a mesh with ``accum_steps > 1``
        its :func:`shard_batch` rows of the data hosts' global batch
        (gathered over the data group)."""
        accum = self.tcfg.accum_steps
        if self._spmd is None or accum == 1 or self.mesh.data == 1:
            return batch
        rows = batch_to(batch, self.device)
        whole = {k: api.gather_slice(v, self.mesh.data_group, 0)
                 for k, v in rows.items()}
        return shard_batch(whole, self.mesh, accum)

    def fresh_state(self):
        return self.init_state(self.tcfg.seed, device=self.device)

    def _whole_like(self) -> dict:
        """The whole train state as meta tensors (a restore's ``like``)."""
        meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"),
                        T.param_shapes(self.model_cfg))
        like = {"params": meta, "opt": AdamWState(
            step=torch.empty((), dtype=torch.int32, device="meta"),
            mu=meta, nu=meta)}
        if self.tcfg.compress_grads:
            like["ef"] = meta
        return like

    def _shard(self, pid: str, whole: torch.Tensor) -> torch.Tensor:
        path = _leaf_path(pid)
        if path is None:
            return whole
        return shard_leaf(whole, self.table[path], self.plan)

    def _whole(self, pid: str, shard: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's shard (all ranks call this, in
        the same leaf order), on the host."""
        path = _leaf_path(pid)
        local = shard.detach().cpu().contiguous()
        if path is None:
            return local
        parts = [torch.empty_like(local) for _ in range(self.mesh.world)]
        dist.all_gather(parts, local, group=self.mesh.host_group)
        return unshard_leaf(parts, self.table[path], self.plan)

    def save(self, step: int, state) -> None:
        if self._spmd is None:
            save_checkpoint(self.tcfg.ckpt_dir, step, state,
                            keep_last=self.tcfg.keep_last)
            return
        save_checkpoint(self.tcfg.ckpt_dir, step, state,
                        keep_last=self.tcfg.keep_last, whole=self._whole,
                        write=self.mesh.rank == 0)
        dist.barrier(group=self.mesh.host_group)

    def resume_or_init(self):
        """Restore the newest checkpoint if one exists (crash recovery);
        under a mesh every rank restores its own shards of it."""
        start = 0
        state = self.fresh_state()
        if self.tcfg.ckpt_dir:
            step = latest_step(self.tcfg.ckpt_dir)
            if step is not None:
                if self._spmd is None:
                    state, _ = restore_checkpoint(
                        self.tcfg.ckpt_dir, step, state, device=self.device)
                else:
                    state, _ = restore_checkpoint(
                        self.tcfg.ckpt_dir, step, self._whole_like(),
                        device=self.device, shard=self._shard)
                start = step
        return state, start

    # -- loop ----------------------------------------------------------------

    def run(self, batches: Iterator[dict],
            on_step: Optional[Callable[[int, dict], None]] = None):
        state, start = self.resume_or_init()
        rank = self.rank
        for step in range(start, self.tcfg.steps):
            batch = self._step_rows(next(batches))
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self.heartbeats.report(rank, step)
            self.stragglers.report(rank, dt)
            metrics.update(step=step, step_time_s=dt)
            self.history.append(metrics)
            if on_step:
                on_step(step, metrics)
            if (self.tcfg.log_every and step % self.tcfg.log_every == 0
                    and rank == 0):
                print(f"step {step:5d} loss {metrics['loss']:.4f} "
                      f"lr {metrics['lr']:.2e} {dt*1e3:.0f} ms", flush=True)
            if (self.tcfg.ckpt_dir and self.tcfg.ckpt_every
                    and (step + 1) % self.tcfg.ckpt_every == 0):
                self.save(step + 1, state)
            # fault-tolerance decision point (no-op while healthy)
            bad = sorted(set(self.heartbeats.failed_ranks())
                         | set(self.stragglers.stragglers()))
            if bad:
                plan = plan_elastic_remesh(
                    data_parallel=16, model_parallel=16, bad_ranks=bad,
                    resume_step=step)
                print(f"[ft] unhealthy ranks {bad}: plan={plan.action}",
                      flush=True)
        if self.tcfg.ckpt_dir:
            self.save(self.tcfg.steps, state)
        return state


__all__ = ["Trainer", "TrainerConfig"]
