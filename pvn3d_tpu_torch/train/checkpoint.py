"""Checkpoint save and restore with ``torch.save`` / ``torch.load``.

Port of the JAX package's ``train/checkpoint.py`` (reference semantics,
train_ycb_pvn3d.py:102-146: a rolling latest checkpoint, a best copy on
val-loss improvement, resume from the latest).  One file per step,
``ckpt_{step}.pt`` holding ``{step, model, optimizer}`` state dicts;
writes are synchronous and atomic (temporary file, then rename).
"""
from __future__ import annotations

import json
import math
import os
import re
from typing import List, Optional

import torch

from pvn3d_tpu_torch.train.state import TrainState

_NAME = re.compile(r"ckpt_(\d+)\.pt$")


def _steps(directory: str) -> List[int]:
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(directory)) if m)


def _write(directory: str, step: int, state: TrainState) -> None:
    path = os.path.join(directory, f"ckpt_{step}.pt")
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"step": int(step), "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()}, tmp)
    os.replace(tmp, path)


def _prune(directory: str, keep: int) -> None:
    for step in _steps(directory)[:-keep]:
        os.remove(os.path.join(directory, f"ckpt_{step}.pt"))


class CheckpointManager:
    """Latest-N + best-1 retention, the reference's checkpoint layout
    (pvn3d.pth.tar rolling latest + pvn3d_best.pth.tar copy on val-loss
    improvement, train_ycb_pvn3d.py:121-129,384-392).

    The main directory prunes purely by recency (bounded disk, the latest
    step always restorable); the best checkpoint lives in ``best/``,
    written only when ``val_loss`` improves, with the best value so far in
    the ``best_val_loss.json`` sidecar so it carries across resumes.
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 keep_best: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_dir = None
        self._best = math.inf
        if keep_best:
            self.best_dir = os.path.join(self.directory, "best")
            os.makedirs(self.best_dir, exist_ok=True)
            self._best_file = os.path.join(self.best_dir,
                                           "best_val_loss.json")
            if os.path.exists(self._best_file):
                with open(self._best_file) as f:
                    self._best = float(json.load(f)["val_loss"])

    def save(self, step: int, state: TrainState,
             val_loss: Optional[float] = None) -> None:
        _write(self.directory, step, state)
        _prune(self.directory, self.max_to_keep)
        if (self.best_dir is not None and val_loss is not None
                and float(val_loss) < self._best):
            self._best = float(val_loss)
            _write(self.best_dir, step, state)
            _prune(self.best_dir, 1)
            with open(self._best_file, "w") as f:
                json.dump({"val_loss": self._best, "step": int(step)}, f)

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, state: TrainState) -> Optional[TrainState]:
        """Load the latest checkpoint into ``state`` (its model, optimizer
        and step, in place) and return it, or None when the directory is
        empty (fresh start)."""
        step = self.latest_step()
        if step is None:
            return None
        device = next(state.model.parameters()).device
        ckpt = torch.load(os.path.join(self.directory, f"ckpt_{step}.pt"),
                          map_location=device, weights_only=True)
        state.model.load_state_dict(ckpt["model"], strict=True)
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        return state

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing is held open."""
