"""Worker process for the port's data-parallel CPU tests
(``tests/test_torch_parallel.py``); the counterpart of
``tests/_multihost_worker.py``, importing no JAX.

Each rank joins a gloo group through the port's
``initialize_distributed`` with a ``file://`` store in the test's
directory, reads the test's inputs (``inputs.pt``: configs, weights,
batches), runs every function of its scenario on its rows and writes the
results to ``rank{r}.pt`` for the test to compare.

Usage: python tests/_torch_parallel_worker.py <scenario> <rank> <world> <dir>
"""
import multiprocessing as mp
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TicketDataset:
    """``n`` items; item i is its ticket, one draw of ``rng`` (the
    datasets' augmentation stream) and the identity of the loader worker
    that built it (0 inline)."""

    def __init__(self, n: int = 10, seed: int = 0):
        self.n = n
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        ident = mp.current_process()._identity
        return {"ticket": np.int64(i), "draw": np.float64(self.rng.rand()),
                "wid": np.int64(ident[0] if ident else 0)}


class SkipDataset(TicketDataset):
    """A ``TicketDataset`` that returns None for the tickets in ``skip``,
    as a real dataset does for an unreadable frame."""

    def __init__(self, n: int = 10, seed: int = 0, skip=(3,)):
        super().__init__(n, seed)
        self.skip = frozenset(skip)

    def __getitem__(self, i):
        return None if i in self.skip else super().__getitem__(i)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


def rows(mesh, inp, d):
    """The batch helpers on this rank."""
    from pvn3d_tpu_torch.parallel.mesh import gather, local_rows, shard_batch
    out = {"rows": local_rows(mesh, 4)}
    try:
        local_rows(mesh, 3)
    except ValueError as e:
        out["indivisible"] = str(e)
    glob = {"pointcloud": np.arange(4 * 8 * 9, dtype=np.float32
                                    ).reshape(4, 8, 9),
            "labels": np.arange(4 * 8, dtype=np.int32).reshape(4, 8),
            "_n_valid": 3}
    mine = shard_batch(mesh, glob)
    out["shard"] = _numpy(mine)
    out["gathered"] = _numpy(gather(mesh, {
        "pointcloud": mine["pointcloud"],
        "mask": mine["labels"] % 3 == 0}))
    return out


def skip(mesh, inp, d):
    """A training loader whose dataset returns None for ticket 3 (rank
    1's row of the first global batch), each batch followed by a
    collective as a step's are: every rank must run all its steps."""
    import torch.distributed as dist
    from pvn3d_tpu_torch.data.loader import DataLoader
    tickets = []
    for b in DataLoader(SkipDataset, 4, steps=3, rank=mesh.rank, world=2):
        tickets.append(b["ticket"].tolist())
        dist.all_reduce(torch.ones(1), group=mesh.group)
    return tickets


def bn_rows(group, b, rows, nchw: bool, relu: bool = False) -> dict:
    """A train-mode BN forward and backward on ``rows`` of the inputs,
    channels last or NCHW (a channels_last map), synced over ``group``."""
    from pvn3d_tpu_torch.models.layers import BatchNorm
    layer = BatchNorm(6)
    layer.load_state_dict(b["state"])
    layer.train()
    layer.process_group = group
    x = torch.tensor(b["x"][rows], requires_grad=True)
    y = (layer.nchw(x.permute(0, 3, 1, 2), b["momentum"], relu=relu).permute(
        0, 2, 3, 1) if nchw else layer(x, b["momentum"], relu=relu))
    y.backward(torch.tensor(b["g"][rows]))
    return _numpy({"y": y, "gx": x.grad,
                   "gw": layer.weight.grad, "gb": layer.bias.grad,
                   "mean": layer.running_mean, "var": layer.running_var})


def bn(mesh, inp, d):
    """One synced train-mode BN forward and backward on this rank's rows,
    channels last and NCHW (keyed by ``nchw``), and with the ReLU fused
    (keyed by ``(nchw, "relu")``)."""
    sl = slice(mesh.rank * 2, (mesh.rank + 1) * 2)
    out = {}
    for nchw in (False, True):
        out[nchw] = bn_rows(mesh.group, inp["bn"], sl, nchw)
        out[nchw, "relu"] = bn_rows(mesh.group, inp["bn"], sl, nchw, True)
    return out


def _one_step(mesh, cfg, sd, batch, seed=0):
    from pvn3d_tpu_torch.models.pvn3d import PVN3D
    from pvn3d_tpu_torch.parallel.mesh import replicated, shard_batch
    from pvn3d_tpu_torch.train.state import TrainState, make_optimizer
    from pvn3d_tpu_torch.train.step import make_train_step
    model = PVN3D(cfg.model)
    model.load_state_dict(sd, strict=True)
    replicated(mesh, model.train())
    state = TrainState(0, model, make_optimizer(cfg, model))
    step = make_train_step(cfg, "cpu", mesh)
    state, metrics = step(state, shard_batch(mesh, batch), seed)
    return _numpy({
        "metrics": metrics,
        "grads": {k: p.grad for k, p in model.named_parameters()
                  if p.grad is not None},
        "state": model.state_dict()})


def step(mesh, inp, d):
    """One data-parallel train step (the JAX comparison's config)."""
    s = inp["step"]
    return _one_step(mesh, s["cfg"], s["sd"], s["batch"])


def accum(mesh, inp, d):
    """One data-parallel step at grad_accum 2."""
    s = inp["accum"]
    return _one_step(mesh, s["cfg"], s["sd"], s["batch"])


def fit(mesh, inp, d):
    """Trainer.fit for 2 steps with checkpoints, eval_epoch, then a fresh
    state resumed from the directory and one more step."""
    from pvn3d_tpu_torch.parallel.mesh import replicated, shard_batch
    from pvn3d_tpu_torch.train.checkpoint import CheckpointManager
    from pvn3d_tpu_torch.train.state import create_train_state
    from pvn3d_tpu_torch.train.step import make_eval_step, make_train_step
    from pvn3d_tpu_torch.train.trainer import Trainer
    s = inp["fit"]
    cfg, batches = s["cfg"], s["batches"]
    mine = [shard_batch(mesh, b) for b in batches]
    saves = []

    def trainer_at(seed):
        state = create_train_state(cfg, seed, "cpu")
        replicated(mesh, state.model)
        ckpt = CheckpointManager(os.path.join(d, "ckpt"))
        real = ckpt.save

        def counted(step, st, val_loss=None):
            saves.append(step)
            real(step, st, val_loss=val_loss)
        ckpt.save = counted
        return Trainer(cfg, state, make_train_step(cfg, "cpu", mesh),
                       make_eval_step(cfg, "cpu"), checkpoint_manager=ckpt,
                       log_every=1, mesh=mesh)

    first = trainer_at(0)
    first.fit(mine[:2], max_steps=2)
    val = first.eval_epoch(mine[:2])
    second = trainer_at(99)                 # other weights: replaced
    resumed = second.resume()
    second.fit(mine[2:3])
    return {"saves": saves, "resumed": resumed, "val": val,
            "step": second.state.step,
            "state": _numpy(second.state.model.state_dict())}


def serve(mesh, inp, d=None):
    """Prepared and raw requests; ``mesh`` None is the unsharded step.
    Records whether each forward took the sparse CNN tail."""
    from pvn3d_tpu_torch.inference.pipeline import (make_inference_step,
                                                    make_raw_inference_step)
    from pvn3d_tpu_torch.models.pvn3d import PVN3D
    s = inp["serve"]
    cfg = s["cfg"]
    model = PVN3D(cfg.model)
    model.load_state_dict(s["sd"], strict=True)
    tails = []
    model.cnn.model.register_forward_pre_hook(
        lambda m, a, kw: tails.append(kw.get("choose") is not None),
        with_kwargs=True)
    step = make_inference_step(cfg, model, *s["meshes"], device="cpu",
                               mesh=mesh)
    raw = make_raw_inference_step(cfg, model, *s["meshes"][:2],
                                  fill_depth=True, device="cpu", mesh=mesh)
    out = {"prepared": step(s["batch"]),
           "raw": raw(s["raw"], priorities=s["priorities"]),
           "raw_generator": raw(s["raw"],
                                torch.Generator().manual_seed(3))}
    out = _numpy(out)
    out["sparse_tail"] = tails
    return out


SCENARIOS = {"two": (rows, skip, bn, step, accum, fit),
             "four": (serve,)}


def main():
    scenario, rank, world, d = (sys.argv[1], int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4])
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    import torch.distributed as dist
    from pvn3d_tpu_torch.parallel.mesh import make_mesh
    from pvn3d_tpu_torch.parallel.multihost import initialize_distributed
    initialize_distributed(f"file://{os.path.join(d, 'store')}", world, rank,
                           device="cpu")
    mesh = make_mesh(device="cpu")
    assert (mesh.dp, mesh.rank) == (world, rank), mesh
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    out = {fn.__name__: fn(mesh, inp, d) for fn in SCENARIOS[scenario]}
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    dist.destroy_process_group()
    print(f"rank{rank} done", flush=True)


if __name__ == "__main__":
    main()
