"""No-data end-to-end accuracy check: train from scratch on the procedural
world, then recover poses with the full pipeline and report ADD/ADD-S AUC,
with and without ICP refinement.

  python -m pvn3d_tpu_torch.tools.synthetic_e2e [--steps 600] [--batch 4]
      [--icp] [--seed 0] [--tiny] [--device cuda|cpu]
      [--fps_groups G] [--eval_fps_groups G] [--query_mode M]
      [--eval_query_mode M] [--query_compute f32|bf16] [--query_recall R]

Port of the JAX package's ``benchmarks/synthetic_e2e.py``.  Passing means
every stage works together: model, losses, optimizer, BN statistics, seg
argmax, vote clustering, mask refinement, Umeyama fit, ICP, ADD metrics.
The world (``data.synthetic_world``) and its data stream are the JAX
tool's for the same ``--seed``; the weights start from the port's seeded
initialisation.  The neighbour and sampling modes take the JAX tool's
flags with its meanings: ``--fps_groups`` and ``--query_mode`` for
training and evaluation, ``--eval_fps_groups``, ``--eval_query_mode``,
``--query_compute`` and ``--query_recall`` for evaluation only (a
``--load_ckpt`` run evaluates a saved model under them).  Timing lines go
before the last line, which is the JAX tool's JSON record.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from pvn3d_tpu_torch.config import (Config, DatasetConfig, ICPConfig,
                                    ModelConfig, PointNet2Config,
                                    SALevelConfig, TrainConfig)


def tiny_config() -> Config:
    """The JAX tool's ``--tiny`` model (``__graft_entry__._tiny_config``:
    full architecture at tiny widths and shapes, 64x64 image, 512 points),
    float32: a run on the CPU in seconds.  ICP's scene cap and gate are
    scaled to the world's ~85 points a class."""
    pn2 = PointNet2Config(
        sa_levels=(
            SALevelConfig(128, (0.0175, 0.025), (8, 16),
                          ((8, 8, 16), (8, 8, 16))),
            SALevelConfig(64, (0.025, 0.05), (8, 16),
                          ((16, 16, 32), (16, 16, 32))),
            SALevelConfig(32, (0.05, 0.1), (8, 16),
                          ((32, 32, 32), (32, 32, 32))),
            SALevelConfig(16, (0.1, 0.2), (8, 16),
                          ((32, 32, 64), (32, 32, 64))),
        ),
        fp_mlps=((32, 32), (32, 32), (64, 64), (64, 64)),
    )
    model = ModelConfig(
        n_sample_points=512, image_height=64, image_width=64,
        pointnet2=pn2, seg_head=(64, 32), kp_head=(64, 32),
        ctr_head=(64, 32), compute_dtype="float32")
    return Config(dataset=DatasetConfig(), model=model,
                  train=TrainConfig(mini_batch_size=4),
                  icp=ICPConfig(max_scene_points=128, min_class_points=40))


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--eval_frames", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--n_points", type=int, default=0)
    p.add_argument("--cluster_cap", type=int, default=0,
                   help="override ClusterConfig.max_points_per_class for "
                        "eval (0 = config default 512)")
    p.add_argument("--icp", action="store_true",
                   help="also report AUC with ICP refinement (sampled "
                        "scene mode: the synthetic world has no full-res "
                        "depth map)")
    p.add_argument("--seed", type=int, default=0,
                   help="init + data-stream seed (the world is seed 0)")
    p.add_argument("--save_ckpt", default="",
                   help="save the trained model's state dict here")
    p.add_argument("--load_ckpt", default="",
                   help="skip training; load a --save_ckpt file")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--fps_groups", type=int, default=1,
                   help="grouped-FPS group count for training AND eval")
    p.add_argument("--eval_fps_groups", type=int, default=0,
                   help="override fps_groups for eval only (weights "
                        "trained exact, inference grouped)")
    p.add_argument("--query_mode", default="",
                   help="override PointNet2Config.query_mode for training "
                        "AND eval (auto, exact, approx, pallas)")
    p.add_argument("--eval_query_mode", default="",
                   help="override query_mode for eval only")
    p.add_argument("--query_compute", default="",
                   help="override PointNet2Config.query_compute for eval "
                        "(f32 or bf16)")
    p.add_argument("--query_recall", type=float, default=0.0,
                   help="override PointNet2Config.query_recall for eval "
                        "(0 = config default; no effect off a TPU)")
    return p


def with_pointnet2(cfg: Config, **over) -> Config:
    """``cfg`` with the PointNet2Config fields in ``over`` replaced."""
    if not over:
        return cfg
    model = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        model, pointnet2=dataclasses.replace(model.pointnet2, **over)))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Train (or load), evaluate, print and return the JSON record."""
    args = build_argparser().parse_args(argv)
    from pvn3d_tpu_torch.data.synthetic_world import SyntheticWorld
    from pvn3d_tpu_torch.inference.evaluator import (PoseEvaluator,
                                                     eval_frame_metrics)
    from pvn3d_tpu_torch.inference.pipeline import (make_icp_step,
                                                    make_inference_step)
    from pvn3d_tpu_torch.models.pvn3d import PVN3D
    from pvn3d_tpu_torch.train.state import create_train_state
    from pvn3d_tpu_torch.train.step import make_train_step
    from pvn3d_tpu_torch.utils.device import resolve_device
    dev = resolve_device(args.device)

    if args.tiny:
        cfg = tiny_config()
        h = w = 64
    else:
        cfg = Config.ycb()
        h, w = cfg.model.image_height, cfg.model.image_width
    n_points = args.n_points or cfg.model.n_sample_points
    cfg = dataclasses.replace(
        cfg, train=TrainConfig(base_lr=args.lr, max_lr=args.lr))
    train_over = {}
    if args.fps_groups > 1:
        train_over["fps_groups"] = args.fps_groups
    if args.query_mode:
        train_over["query_mode"] = args.query_mode
    cfg = with_pointnet2(cfg, **train_over)

    world = SyntheticWorld(n_classes=4,
                           n_keypoints=cfg.model.n_keypoints, seed=0)
    rng_np = np.random.RandomState(args.seed)
    kw = dict(n_points=n_points, height=h, width=w)
    # The JAX tool initialises from a first batch; drawing it keeps the
    # data stream the same.
    world.sample_batch(rng_np, args.batch, **kw)

    state = create_train_state(cfg, args.seed, dev)
    if args.load_ckpt:
        ckpt = torch.load(args.load_ckpt, map_location=dev,
                          weights_only=True)
        state.model.load_state_dict(ckpt["model"], strict=True)
        # Keep the data stream identical to a trained run: skip the same
        # number of training batches before eval.
        for _ in range(args.steps):
            world.sample_batch(rng_np, args.batch, **kw)
        print(f"loaded {args.load_ckpt}", flush=True)
    else:
        step = make_train_step(cfg, dev)
        _sync(dev)
        t0 = time.perf_counter()
        for it in range(args.steps):
            batch = world.sample_batch(rng_np, args.batch, **kw)
            # Dropout seed 1 every run, as the JAX tool's PRNGKey(1).
            state, metrics = step(state, batch, 1)
            if it % 100 == 0 or it == args.steps - 1:
                print(f"it={it} loss={float(metrics['loss']):.3f} "
                      f"acc={float(metrics['acc_rgbd']):.3f} "
                      f"kp={float(metrics['loss_kp']):.3f}", flush=True)
        _sync(dev)
        dt = time.perf_counter() - t0
        print(f"trained {args.steps} steps in {dt:.1f}s "
              f"({dt * 1e3 / max(args.steps, 1):.1f} ms a step, batch "
              f"{args.batch}, host data included)", flush=True)
    if args.save_ckpt:
        torch.save({"model": state.model.state_dict()}, args.save_ckpt)
        print(f"saved {args.save_ckpt}", flush=True)

    # Inference + metrics with the trained weights.
    if args.cluster_cap:
        cfg = dataclasses.replace(cfg, cluster=dataclasses.replace(
            cfg.cluster, max_points_per_class=args.cluster_cap))
    eval_over = {}
    if args.eval_fps_groups:
        eval_over["fps_groups"] = args.eval_fps_groups
    if args.eval_query_mode:
        eval_over["query_mode"] = args.eval_query_mode
    if args.query_compute:
        eval_over["query_compute"] = args.query_compute
    if args.query_recall:
        eval_over["query_recall"] = args.query_recall
    model = state.model
    if eval_over:
        cfg = with_pointnet2(cfg, **eval_over)
        model = PVN3D(cfg.model).to(dev)
        model.load_state_dict(state.model.state_dict(), strict=True)
    # Pad the world's class tables up to the model's class count (the
    # extra classes never occur in frames).
    n_cls = cfg.model.n_classes

    def pad_c(a):
        out = np.zeros((n_cls,) + a.shape[1:], a.dtype)
        out[:len(a)] = a
        return out
    radii = np.full(n_cls, 0.1, np.float32)
    mesh_pts = pad_c(world.stacked_pts)
    mesh_valid = pad_c(world.stacked_valid)
    infer = make_inference_step(cfg, model, pad_c(world.stacked_kps),
                                radii, mesh_pts, mesh_valid,
                                refine_mask=True, device=dev)
    icp_step = None
    if args.icp:
        icp_step = make_icp_step(cfg, mesh_pts, mesh_valid, dev)
        ev_icp = PoseEvaluator(n_cls=n_cls, sym_cls_ids=(), ds_type="syn")
        pts_t = torch.as_tensor(mesh_pts, device=dev)
        valid_t = torch.as_tensor(mesh_valid, device=dev)

    ev = PoseEvaluator(n_cls=n_cls, sym_cls_ids=(), ds_type="syn")
    seg_accs = []
    infer_s = icp_s = 0.0
    n_eval = 0
    for _ in range(max(args.eval_frames // args.batch, 1)):
        batch = world.sample_batch(rng_np, args.batch, **kw)
        _sync(dev)
        t0 = time.perf_counter()
        out = infer(batch)
        _sync(dev)
        infer_s += time.perf_counter() - t0
        n_eval += args.batch
        seg = out["seg"].cpu().numpy()
        seg_accs.append(float(np.mean(seg == batch["labels"])))
        for b in range(args.batch):
            ev.add_frame(batch["cls_ids"][b], out["add"][b].cpu().numpy(),
                         out["adds"][b].cpu().numpy())
        if icp_step is not None:
            t0 = time.perf_counter()
            refined = icp_step(batch["pointcloud"][..., :3], out["seg"],
                               out["poses"])
            _sync(dev)
            icp_s += time.perf_counter() - t0
            with torch.inference_mode():
                add_i, adds_i = eval_frame_metrics(
                    refined, torch.as_tensor(batch["cls_ids"], device=dev),
                    torch.as_tensor(batch["rts"], device=dev), pts_t,
                    valid_t)
            for b in range(args.batch):
                ev_icp.add_frame(batch["cls_ids"][b], add_i[b].cpu().numpy(),
                                 adds_i[b].cpu().numpy())
    print(f"eval: {n_eval} frames, {infer_s * 1e3 / n_eval:.1f} ms a frame "
          f"(batch {args.batch}: forward + poses + metrics)"
          + (f"; ICP (sampled scene) {icp_s * 1e3 / n_eval:.1f} ms a frame"
             if icp_step is not None else ""), flush=True)
    s = ev.summarize()
    result = {
        "metric": "synthetic_e2e_add_s_auc",
        "value": round(s["all_add_s_auc"], 2),
        "add_auc": round(s["all_add_auc"], 2),
        "adds_auc": round(s["all_adds_auc"], 2),
        "eval_seg_acc": round(float(np.mean(seg_accs)), 4),
        "steps": args.steps,
    }
    if icp_step is not None:
        # Reference reporting shape: AUC with vs without refinement
        # (eval_icp.py:325-357 prints add/adds per class +/- ICP).
        si = ev_icp.summarize()
        result["icp"] = {
            "add_s_auc": round(si["all_add_s_auc"], 2),
            "add_auc": round(si["all_add_auc"], 2),
            "adds_auc": round(si["all_adds_auc"], 2),
            "delta_add_auc": round(si["all_add_auc"] - s["all_add_auc"], 2),
            "delta_adds_auc": round(
                si["all_adds_auc"] - s["all_adds_auc"], 2),
            "scene_mode": "sampled",
        }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
