"""Training entry point.

Port of the JAX package's ``apps/train.py`` (the reference CLIs,
pvn3d/train/train_{ycb,linemod}_pvn3d.py), with the same flags and
defaults but ``--device cuda|cpu`` for ``--platform``:

  python -m pvn3d_tpu_torch.apps.train --dataset ycb --data_root /path/ycb \\
      --checkpoint_dir runs/ycb
  python -m pvn3d_tpu_torch.apps.train --dataset linemod --cls ape \\
      --data_root /path/Linemod_preprocessed --checkpoint_dir runs/ape

Batches come from ``data/loader.py::DataLoader`` (spawned workers) through
``prefetch_to_device`` into ``train/trainer.py::Trainer.fit``.  With
``--device_preprocess`` the host only decodes and the card augments,
fills, samples and builds the targets (``data/device_frame.py::
build_train_batch_device``), from a generator per (seed, step).
``--pretrained_trunk`` seeds the image trunk from a local torchvision
ResNet-34 state dict (``utils/torch_convert.py``) before the first step.
It runs on the card unless ``--device cpu`` is given.  Flags whose
machinery the port lacks exit naming their ``ROADMAP.md`` item.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import functools

from pvn3d_tpu_torch.config import Config
from pvn3d_tpu_torch.train.trainer import Trainer

# Flags of the JAX app whose machinery the port lacks: (flag, item).
NOT_PORTED = {
    "remat": "--remat / --remat_policy: rematerialisation (ROADMAP.md "
             "queue A, item 13)",
    "distributed": "--distributed: multi-process training (ROADMAP.md "
                   "queue A, item 14)",
}


def check_ported(args) -> None:
    """Exit naming the ``ROADMAP.md`` item of the first flag set whose
    machinery the port lacks."""
    for flag, msg in NOT_PORTED.items():
        if getattr(args, flag, False) or (
                flag == "remat" and getattr(args, "remat_policy", "")):
            raise SystemExit(f"not ported: {msg}")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", choices=("ycb", "linemod"), default="ycb")
    p.add_argument("--cls", default="ape",
                   help="LineMOD object (reference: -cls)")
    p.add_argument("--data_root", required=True)
    p.add_argument("--checkpoint_dir", default="runs/default")
    p.add_argument("--batch_size", type=int, default=0,
                   help="global batch (0 = config default 24)")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--max_steps", type=int, default=0,
                   help="0 = full budget (25 epochs x 4000 iters)")
    p.add_argument("--no_fill_depth", action="store_true")
    p.add_argument("--device_preprocess", action="store_true",
                   help="ship raw decoded frames and run augmentation, "
                        "depth fill, normals, sampling and GT targets on "
                        "the device (data/device_frame.py)")
    p.add_argument("--remat", action="store_true",
                   help="not ported (ROADMAP.md queue A, item 13)")
    p.add_argument("--remat_policy", default="", choices=("", "full", "dots"),
                   help="not ported (ROADMAP.md queue A, item 13)")
    p.add_argument("--grad_accum", type=int, default=0,
                   help="micro-batches per optimizer step "
                        "(TrainConfig.grad_accum)")
    p.add_argument("--distributed", action="store_true",
                   help="not ported (ROADMAP.md queue A, item 14)")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--file_list", default="",
                   help="YCB: override the vendored split list (custom "
                        "subsets / smoke runs)")
    p.add_argument("--val_packed_dir", default="",
                   help="validate from npz shards (tools/preprocess_testset"
                        " --train_targets) instead of rebuilding test "
                        "frames per eval")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--pretrained_trunk", default="",
                   help="torchvision ResNet34 state dict (.pth) seeding "
                        "the image trunk (utils/torch_convert.py)")
    p.add_argument("--torch_ckpt", default="",
                   help="full reference PVN3D .pth.tar to start from "
                        "(utils/weights.py::load_torch_state_dict)")
    # Hyperparameter overrides (reference argparse, train_ycb_pvn3d.py:
    # 39-92; 0 / negative = keep the config default).
    p.add_argument("--base_lr", type=float, default=0.0)
    p.add_argument("--max_lr", type=float, default=0.0)
    p.add_argument("--weight_decay", type=float, default=-1.0)
    p.add_argument("--bn_momentum", type=float, default=0.0)
    p.add_argument("--bn_decay", type=float, default=0.0)
    p.add_argument("--decay_step", type=float, default=0.0)
    p.add_argument("--epochs", type=int, default=0)
    return p


def base_config(dataset: str, cls: str) -> Config:
    """The configuration an app runs: ``Config.ycb()`` or
    ``Config.linemod(cls)`` at full width (tests substitute a small
    one)."""
    return Config.linemod(cls) if dataset == "linemod" else Config.ycb()


def train_config(args) -> Config:
    """``base_config`` with the command line's TrainConfig overrides."""
    cfg = base_config(args.dataset, args.cls)
    overrides = {}
    if args.grad_accum > 1:
        overrides["grad_accum"] = args.grad_accum
    if args.base_lr > 0:
        overrides["base_lr"] = args.base_lr
    if args.max_lr > 0:
        overrides["max_lr"] = args.max_lr
    if args.weight_decay >= 0:
        overrides["weight_decay"] = args.weight_decay
    if args.bn_momentum > 0:
        overrides["bn_momentum_init"] = args.bn_momentum
    if args.bn_decay > 0:
        overrides["bn_decay"] = args.bn_decay
    if args.decay_step > 0:
        overrides["bn_decay_step"] = args.decay_step
    if args.epochs > 0:
        overrides["n_total_epoch"] = args.epochs
    if overrides:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **overrides))
    return cfg


def make_dataset_factory(args, split: str, cfg: Config):
    """A picklable dataset factory (a ``functools.partial`` of a dataset
    class) for spawned loader workers.  Frames carry the model's point
    budget and keypoint count; ``--icp`` (evaluate) keeps the full-res
    depth map for ICP's scene (eval_icp.py:224-291)."""
    from pvn3d_tpu_torch.data.frame import FrameSpec
    spec = FrameSpec(n_sample_points=cfg.model.n_sample_points,
                     n_keypoints=cfg.model.n_keypoints,
                     keep_depth=getattr(args, "icp", False),
                     device_preprocess=getattr(args, "device_preprocess",
                                               False))
    if args.dataset == "ycb":
        from pvn3d_tpu_torch.data.ycb import YCBDataset
        return functools.partial(YCBDataset, args.data_root, split=split,
                                 spec=spec, seed=args.seed,
                                 fill_depth=not args.no_fill_depth,
                                 file_list=getattr(args, "file_list", ""))
    if getattr(args, "occ", False):
        from pvn3d_tpu_torch.data.occlusion_linemod import \
            OcclusionLineMODDataset
        return functools.partial(
            OcclusionLineMODDataset, args.data_root, cls_type=args.cls,
            split=split, spec=spec, seed=args.seed,
            lm_root=getattr(args, "lm_root", "") or None)
    from pvn3d_tpu_torch.data.linemod import LineMODDataset
    return functools.partial(LineMODDataset, args.data_root,
                             cls_type=args.cls, split=split, spec=spec,
                             seed=args.seed)


# Raw-train fields the device build reads on the host.
RAW_HOST_KEYS = ("is_syn", "do_jitter")


class _PackedVal:
    def __init__(self, packed_dir: str, batch_size: int):
        self.packed_dir, self.batch_size = packed_dir, batch_size

    def __iter__(self):
        from pvn3d_tpu_torch.tools.preprocess_testset import \
            iter_packed_batches
        return iter_packed_batches(self.packed_dir, self.batch_size)


def main(argv=None) -> Trainer:
    """Train and return the ``Trainer`` (its ``state`` is the last
    step's)."""
    args = build_argparser().parse_args(argv)
    check_ported(args)
    from pvn3d_tpu_torch.data.loader import DataLoader, prefetch_to_device
    from pvn3d_tpu_torch.train.checkpoint import CheckpointManager
    from pvn3d_tpu_torch.train.state import create_train_state, param_count
    from pvn3d_tpu_torch.train.step import make_eval_step, make_train_step
    from pvn3d_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = train_config(args)
    batch_size = args.batch_size or cfg.train.mini_batch_size
    max_steps = args.max_steps or (
        cfg.train.n_total_epoch * cfg.train.num_mini_batch_per_epoch)

    state = create_train_state(cfg, cfg.train.seed, dev)
    if args.torch_ckpt:
        from pvn3d_tpu_torch.utils.weights import load_torch_state_dict
        state.model.load_state_dict(load_torch_state_dict(args.torch_ckpt),
                                    strict=True)
        print(f"loaded reference checkpoint {args.torch_ckpt}", flush=True)
    elif args.pretrained_trunk:
        from pvn3d_tpu_torch.utils.torch_convert import load_resnet34_into
        load_resnet34_into(state.model, args.pretrained_trunk)
        print(f"seeded image trunk from {args.pretrained_trunk}",
              flush=True)
    print(f"params: {param_count(state.model) / 1e6:.2f}M  device: {dev}  "
          f"batch: {batch_size}", flush=True)

    train_loader = DataLoader(
        make_dataset_factory(args, "train", cfg), batch_size,
        num_workers=args.workers, seed=args.seed, steps=max_steps)
    # Validation always consumes host-built frames (no augmentation).
    if args.val_packed_dir:
        probe = next(iter(_PackedVal(args.val_packed_dir, batch_size)), None)
        if probe is None or "kp_targ_ofst" not in probe:
            raise SystemExit(
                "--val_packed_dir shards lack the offset targets the val "
                "losses need — pack with preprocess_testset --train_targets")
        val_loader = _PackedVal(args.val_packed_dir, batch_size)
    else:
        val_args = copy.copy(args)
        val_args.device_preprocess = False
        val_loader = DataLoader(
            make_dataset_factory(val_args, "test", cfg), batch_size,
            num_workers=max(args.workers // 2, 0), seed=args.seed)

    train_step = make_train_step(cfg, dev)
    host_keys = ()
    if args.device_preprocess:
        from pvn3d_tpu_torch.data.device_frame import (
            build_train_batch_device, step_generator)
        host_keys = RAW_HOST_KEYS

        def train_step_raw(state, raw, seed, _base=train_step):
            batch = build_train_batch_device(
                raw, step_generator(seed, state.step),
                n_sample=cfg.model.n_sample_points,
                n_classes=cfg.model.n_classes,
                # LineMOD never fills depth (linemod_dataset.py get_item)
                fill=args.dataset == "ycb" and not args.no_fill_depth,
                dataset=args.dataset)
            return _base(state, batch, seed)

        train_step = train_step_raw

    trainer = Trainer(cfg, state, train_step, make_eval_step(cfg, dev),
                      checkpoint_manager=CheckpointManager(
                          args.checkpoint_dir),
                      log_every=args.log_every)
    trainer.resume()
    trainer.fit(prefetch_to_device(iter(train_loader), dev,
                                   host_keys=host_keys),
                lambda: prefetch_to_device(iter(val_loader), dev),
                max_steps=max_steps)
    return trainer


if __name__ == "__main__":
    main()
