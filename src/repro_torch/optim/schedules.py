"""LR schedules: cosine and WSD (warmup-stable-decay, MiniCPM
arXiv:2404.06395), port of ``repro.optim.schedules``.

Each schedule is a function of the step, a tensor (any integer or float
dtype) or a Python number, computed in fp32 as the reference computes it:
the step cast to fp32, Python constants rounded to fp32 where they meet it.
"""

from __future__ import annotations

import math

import torch


def _step32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    def lr(step):
        step = _step32(step)
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr


def wsd_schedule(peak_lr: float, warmup: int, stable: int, decay: int,
                 floor: float = 0.01):
    """Warmup-Stable-Decay: ``warmup`` steps of linear warmup, ``stable``
    steps at the peak, ``decay`` steps of exponential decay to
    ``floor * peak_lr``."""
    log_floor = torch.log(torch.tensor(floor, dtype=torch.float32))

    def lr(step):
        step = _step32(step)
        warm = peak_lr * step / max(warmup, 1)
        in_decay = torch.clamp((step - warmup - stable) / max(decay, 1),
                               0.0, 1.0)
        decayed = peak_lr * torch.exp(log_floor.to(step.device) * in_decay)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable,
                                       torch.full_like(step, peak_lr),
                                       decayed))

    return lr


__all__ = ["cosine_schedule", "wsd_schedule"]
