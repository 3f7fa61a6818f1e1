"""Trainer: the training loop around ``make_train_step`` (port of
``repro.train.trainer``).

Wires together the train step (optionally microbatched and gradient
compressed), the data pipeline, checkpoint save and restore-with-resume
through the port's store (the reference's on-disk layout, so either
package resumes the other's run), heartbeats and straggler monitoring,
and the elastic-remesh decision point.  The step is eager on one device
(``cuda`` unless the caller passes ``device="cpu"``): the port has no
``"data"`` axis (``launch.mesh.Mesh`` refuses ``data > 1``) and does not
train under tensor parallelism.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.ft.coordinator import (HeartbeatRegistry, StragglerMonitor,
                                        plan_elastic_remesh)
from repro_torch.launch.steps import make_train_step
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, cosine_schedule, wsd_schedule
from repro_torch.optim.adamw import Optimizer


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
        """``mesh``: a ``launch.mesh.Mesh`` of one rank (its device is the
        trainer's), or None; a ``"model"`` axis > 1 raises."""
        if mesh is not None:
            if mesh.model > 1:
                raise NotImplementedError(
                    "training under tensor parallelism is not ported")
            device = mesh.device if device is None else device
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = resolve_device(device)
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
            compress_grads=tcfg.compress_grads)
        self.heartbeats = HeartbeatRegistry(timeout_s=tcfg.heartbeat_timeout_s)
        self.stragglers = StragglerMonitor(threshold=tcfg.straggler_threshold)
        self.history: list[dict] = []

    # -- state ---------------------------------------------------------------

    def fresh_state(self):
        return self.init_state(self.tcfg.seed, device=self.device)

    def resume_or_init(self):
        """Restore the newest checkpoint if one exists (crash recovery)."""
        start = 0
        state = self.fresh_state()
        if self.tcfg.ckpt_dir:
            step = latest_step(self.tcfg.ckpt_dir)
            if step is not None:
                state, _ = restore_checkpoint(self.tcfg.ckpt_dir, step, state,
                                              device=self.device)
                start = step
        return state, start

    # -- loop ----------------------------------------------------------------

    def run(self, batches: Iterator[dict],
            on_step: Optional[Callable[[int, dict], None]] = None):
        state, start = self.resume_or_init()
        rank = 0  # one process; per-host rank on a real cluster
        for step in range(start, self.tcfg.steps):
            batch = next(batches)
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
            if self.tcfg.log_every and step % self.tcfg.log_every == 0:
                print(f"step {step:5d} loss {metrics['loss']:.4f} "
                      f"lr {metrics['lr']:.2e} {dt*1e3:.0f} ms", flush=True)
            if (self.tcfg.ckpt_dir and self.tcfg.ckpt_every
                    and (step + 1) % self.tcfg.ckpt_every == 0):
                save_checkpoint(self.tcfg.ckpt_dir, step + 1, state,
                                keep_last=self.tcfg.keep_last)
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
            save_checkpoint(self.tcfg.ckpt_dir, self.tcfg.steps, state,
                            keep_last=self.tcfg.keep_last)
        return state


__all__ = ["Trainer", "TrainerConfig"]
