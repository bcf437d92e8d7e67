"""Train state: the step count, the model and its optimizer.

Port of the JAX package's ``train/state.py``.  The JAX state is an
immutable pytree that each step replaces; here the model's parameters and
BN buffers and the optimizer's moments are updated in place, and the
state object carries them between steps.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from pvn3d_tpu_torch.config import Config
from pvn3d_tpu_torch.train.schedule import lr_schedule
from pvn3d_tpu_torch.utils.device import disable_tf32, resolve_device
from pvn3d_tpu_torch.utils.weights import build_model


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def make_optimizer(cfg: Config, model: nn.Module) -> torch.optim.Optimizer:
    """Adam (reference: train_ycb_pvn3d.py:447) by the rule of
    ``optax.adam``: betas 0.9 / 0.999, eps 1e-8 outside the square root;
    ``weight_decay`` is coupled L2 added to the gradient before Adam.  The
    learning rate is set by the train step from ``lr_schedule`` before
    every update.  On a CUDA model the update is PyTorch's fused one."""
    params = list(model.parameters())
    return torch.optim.Adam(
        params, lr=lr_schedule(cfg.train)(0), betas=(0.9, 0.999), eps=1e-8,
        weight_decay=cfg.train.weight_decay,
        fused=bool(params) and params[0].device.type == "cuda")


def create_train_state(cfg: Config, seed: int = 0,
                       device: str | torch.device = "cuda") -> TrainState:
    """A model with seeded random weights (``utils.weights.build_model``)
    in train mode on ``device``, its optimizer, and step 0.  Runs on the
    card unless ``device="cpu"`` is asked for; raises when CUDA is asked
    for and missing."""
    dev = resolve_device(device)
    disable_tf32()
    model = build_model(cfg.model, seed).to(dev).train()
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, model))


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
