"""Learning-rate and BN-momentum schedules as functions of the step.

Port of the JAX package's ``train/schedule.py``.  There both are traced
into the jitted step; here they are plain float functions evaluated on the
host once per step, so a checkpoint needs only the step to resume them.
"""
from __future__ import annotations

import math
from typing import Callable

from pvn3d_tpu_torch.config import TrainConfig


def cyclic_lr(step: int, base_lr: float, max_lr: float, step_size: int,
              mode: str = "triangular", gamma: float = 1.0) -> float:
    """Cyclic LR (reference: warmup_scheduler/scheduler.py:255-263):
    ``base + (max - base) * max(0, 1 - |it/ss - 2*cycle + 1|) *
    scale(cycle)``."""
    it = float(step)
    ss = float(step_size)
    cycle = math.floor(1.0 + it / (2.0 * ss))
    amp = max(0.0, 1.0 - abs(it / ss - 2.0 * cycle + 1.0))
    if mode == "triangular":
        scale = 1.0
    elif mode == "triangular2":
        scale = 1.0 / (2.0 ** (cycle - 1.0))
    elif mode == "exp_range":
        scale = gamma ** it
    else:
        raise ValueError(f"unknown cyclic mode {mode!r}")
    return base_lr + (max_lr - base_lr) * amp * scale


def bn_momentum_at(step: int, cfg: TrainConfig) -> float:
    """BN momentum decay (reference: train_ycb_pvn3d.py:477-484):
    ``max(0.9 * 0.5 ** floor(it * bs / 2e5), 1e-2)``; the reference's
    ``int()`` floors the exponent."""
    expo = math.floor(float(step) * cfg.mini_batch_size / cfg.bn_decay_step)
    return max(cfg.bn_momentum_init * cfg.bn_decay ** expo,
               cfg.bn_momentum_clip)


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate as a function of the optimizer's update count,
    which starts at 0."""
    def sched(step: int) -> float:
        return cyclic_lr(step, cfg.base_lr, cfg.max_lr, cfg.lr_step_size)
    return sched
