"""The training loop: eval schedule, metric logging, checkpoints.

Port of the JAX package's ``train/trainer.py`` (the reference Trainer,
train_ycb_pvn3d.py:216-409): the step owns all scheduling (LR and BN
momentum are functions of the step count), the loop feeds batches, logs
interval means (CmdLineViz semantics, etw_pytorch_utils/viz.py:151-184)
and checkpoints on the reference's eval cadence.  Under a data-parallel
mesh every rank runs the loop on its rows; rank 0 alone logs and saves
while the others wait at a barrier.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Dict, Iterable, Optional

import torch

from pvn3d_tpu_torch.config import Config
from pvn3d_tpu_torch.parallel.mesh import Mesh
from pvn3d_tpu_torch.train.state import TrainState
from pvn3d_tpu_torch.train.step import global_metrics


def eval_frequency(it: int) -> int:
    """Reference is_to_eval cadence (train_ycb_pvn3d.py:319-333)."""
    for bound, freq in ((30000, 5000), (40000, 2000), (50000, 1200),
                        (60000, 800), (80000, 400)):
        if it < bound:
            return freq
    return 200


def is_to_eval(it: int) -> bool:
    return it % eval_frequency(it) == 0


class MeterLogger:
    """Interval-mean metric printer (CmdLineViz semantics).

    ``update`` buffers metric values without reading device scalars: a
    ``float()`` per scalar would make the host wait for the device on
    every step.  ``flush`` stacks what was buffered and reads it in one
    transfer per log interval.
    """

    def __init__(self, prefix: str = "train", printing: bool = True):
        self.prefix = prefix
        self.printing = printing
        self.buf = collections.defaultdict(list)
        self.t0 = time.time()

    def update(self, metrics: Dict) -> None:
        for k, v in metrics.items():
            self.buf[k].append(v)

    def flush(self, it: int) -> Dict[str, float]:
        keys = [k for k, v in self.buf.items() if v]
        means: Dict[str, float] = {}
        if keys:
            device = next((v.device for k in keys for v in self.buf[k]
                           if torch.is_tensor(v)), torch.device("cpu"))
            rows = torch.stack([
                torch.stack([torch.as_tensor(v, dtype=torch.float64,
                                             device=device)
                             for v in self.buf[k]]).mean() for k in keys])
            means = dict(zip(keys, rows.tolist()))
            dt = time.time() - self.t0
            msg = "  ".join(f"{k}={v:.4f}" for k, v in sorted(means.items()))
            if self.printing:
                print(f"[{self.prefix} it={it} {dt:.1f}s] {msg}", flush=True)
        self.buf.clear()
        self.t0 = time.time()
        return means


class Trainer:
    """``train_step`` / ``eval_step`` are what ``train.step.make_train_step``
    / ``make_eval_step`` return; they move each batch to their device.
    With a ``mesh`` whose group exists, every rank runs ``fit`` on its own
    rows: ``train_step`` must be the mesh's, the validation means are the
    global batches', and rank 0 alone prints and writes checkpoints."""

    def __init__(self, cfg: Config, state: TrainState, train_step: Callable,
                 eval_step: Optional[Callable] = None,
                 checkpoint_manager=None, seed: Optional[int] = None,
                 log_every: int = 50, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.state = state
        self.train_step = train_step
        self.eval_step = eval_step
        self.ckpt = checkpoint_manager
        self.seed = cfg.train.seed if seed is None else seed
        self.log_every = log_every
        self.mesh = mesh
        self.group = None if mesh is None else mesh.group
        self.lead = mesh is None or mesh.rank == 0

    def resume(self) -> int:
        """Restore the latest checkpoint if one exists (every rank loads
        the same file); returns the step."""
        if self.ckpt is not None:
            restored = self.ckpt.restore(self.state)
            if restored is not None:
                self.state = restored
                if self.lead:
                    print(f"resumed from step {self.state.step}", flush=True)
        return self.state.step

    def _save(self, it: int, val_loss=None) -> None:
        if self.lead:
            self.ckpt.save(it, self.state, val_loss=val_loss)
        if self.group is not None:
            torch.distributed.barrier(group=self.group)

    def eval_epoch(self, val_batches: Iterable) -> Dict[str, float]:
        """Mean val losses (reference: Trainer.eval_epoch, :261-290).
        Under a mesh each rank sums its batches' metrics and the sums and
        counts are all-reduced (``global_metrics``): the mean over the
        global batches, whatever number of batches each rank had."""
        logger = MeterLogger("val", printing=self.lead)
        count, sums = 0, {}
        for batch in val_batches:
            # A padded final batch's duplicate frames weigh the interval
            # mean slightly; dropping them would bias it more.
            _, metrics = self.eval_step(self.state, batch)
            if self.group is None:
                logger.update(metrics)
            else:
                sums = {k: sums.get(k, 0.0) + v for k, v in metrics.items()}
            count += 1
        if self.group is not None:
            logger.update(global_metrics(self.cfg, self.mesh, sums, count))
        means = logger.flush(self.state.step)
        means["n_batches"] = count
        return means

    def fit(self, train_batches: Iterable, val_batches_fn=None,
            max_steps: Optional[int] = None) -> None:
        logger = MeterLogger("train", printing=self.lead)
        it = self.state.step
        for batch in train_batches:
            self.state, metrics = self.train_step(self.state, batch,
                                                  self.seed)
            it += 1
            logger.update(metrics)
            if it % self.log_every == 0:
                logger.flush(it)
            if is_to_eval(it):
                val_loss = None
                if self.eval_step is not None and val_batches_fn is not None:
                    val = self.eval_epoch(val_batches_fn())
                    val_loss = val.get("loss")
                if self.ckpt is not None:
                    self._save(it, val_loss)
            if max_steps is not None and it >= max_steps:
                break
        logger.flush(it)
        if self.ckpt is not None:
            self._save(it)
            self.ckpt.wait()
