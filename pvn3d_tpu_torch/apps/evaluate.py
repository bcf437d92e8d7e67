"""Evaluation entry point: ADD / ADD-S / AUC over a test set.

Port of the JAX package's ``apps/evaluate.py`` (the reference's
``train_*_pvn3d -eval_net --test`` and ``eval_icp``), with the same flags
and defaults but ``--device cuda|cpu`` for ``--platform``:

  python -m pvn3d_tpu_torch.apps.evaluate --dataset ycb \\
      --data_root /path/ycb --checkpoint_dir runs/ycb [--icp]
  python -m pvn3d_tpu_torch.apps.evaluate --dataset linemod --cls ape \\
      --data_root /path/Linemod_preprocessed --checkpoint_dir runs/ape
  python -m pvn3d_tpu_torch.apps.evaluate --dataset linemod --cls ape \\
      --occ --data_root /path/OCCLUSION_LINEMOD \\
      --lm_root /path/Linemod_preprocessed --checkpoint_dir runs/ape

Frames come from the loader (host-built), from raw frames built on the
card (``--device_preprocess``: ``make_raw_inference_step``) or from
packed shards (``--packed_dir``).  ``--occ`` reads the Occlusion-LineMOD
test split (``data/occlusion_linemod.py``); a LineMOD object is scored
against its own mesh, ``models/obj_XX.ply`` of ``--lm_root`` (with
``--occ``) or ``--data_root``.  ``--icp`` refines the poses
(``make_icp_refine_fn``, the full-res depth scene where the batch holds
one).  The model runs the eval graph of ``models/pvn3d.py``: the sparse
CNN tail at batch 1, the dense one otherwise; ``--sparse_cnn`` /
``--dense_cnn`` force the tail, as the JAX app's do.  It runs on the card
unless ``--device cpu`` is given; flags whose machinery the port lacks
exit naming their ``ROADMAP.md`` item.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from pvn3d_tpu_torch import config as C
from pvn3d_tpu_torch.apps.train import (base_config, check_ported,
                                        make_dataset_factory)
from pvn3d_tpu_torch.inference.pipeline import accumulate_batches


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", choices=("ycb", "linemod"), default="ycb")
    p.add_argument("--cls", default="ape")
    p.add_argument("--data_root", required=True)
    p.add_argument("--checkpoint_dir", default="",
                   help="train/checkpoint.py run dir (or use --torch_ckpt)")
    p.add_argument("--torch_ckpt", default="",
                   help="evaluate a reference torch checkpoint (.pth.tar)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--icp", action="store_true",
                   help="refine poses with batched ICP (eval_icp parity)")
    p.add_argument("--occ", action="store_true",
                   help="evaluate the Occlusion-LineMOD split: --data_root "
                        "is an OCCLUSION_LINEMOD checkout (reference "
                        "-test_occ, train_linemod_pvn3d.py:97-99, whose "
                        "OCC_LM_Dataset is undefined upstream)")
    p.add_argument("--lm_root", default="",
                   help="with --occ: Linemod_preprocessed checkout for "
                        "object meshes (defaults to --data_root)")
    p.add_argument("--no_fill_depth", action="store_true")
    p.add_argument("--device_preprocess", action="store_true",
                   help="run depth completion / normals / point sampling "
                        "on the device (host workers only decode images)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sparse_cnn", action="store_true",
                   help="force the sparse CNN tail (the eval default at "
                        "batch 1; models/pspnet.py)")
    p.add_argument("--dense_cnn", action="store_true",
                   help="force the dense CNN tail + gather (the eval "
                        "default above batch 1)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--packed_dir", default="",
                   help="evaluate from npz shards (tools/preprocess_testset)"
                        " instead of raw frames")
    return p


def _load_model(args, cfg, dev):
    from pvn3d_tpu_torch.utils.weights import build_model
    if args.torch_ckpt:
        from pvn3d_tpu_torch.utils.weights import load_torch_state_dict
        model = build_model(cfg.model, 0)
        model.load_state_dict(load_torch_state_dict(args.torch_ckpt),
                              strict=True)
        print(f"evaluating reference checkpoint {args.torch_ckpt}",
              flush=True)
        return model
    from pvn3d_tpu_torch.train.checkpoint import CheckpointManager
    from pvn3d_tpu_torch.train.state import create_train_state
    state = create_train_state(cfg, 0, dev)
    state = CheckpointManager(args.checkpoint_dir).restore(state) or state
    print(f"evaluating from step {state.step}", flush=True)
    return state.model


def batch_generator(seed: int, i: int, dev: torch.device) -> torch.Generator:
    """Batch ``i``'s sampling generator on ``dev``, seeded from
    (seed, i) as the JAX app splits its key per batch."""
    s = int(np.random.SeedSequence((seed, i)).generate_state(1,
                                                              np.uint64)[0])
    return torch.Generator(device=dev).manual_seed(s)


def main(argv=None) -> dict:
    """Evaluate and return the summary (YCB AUCs, or LineMOD's
    0.1-diameter accuracy)."""
    args = build_argparser().parse_args(argv)
    check_ported(args)
    if not args.torch_ckpt and not args.checkpoint_dir:
        raise SystemExit("need --checkpoint_dir or --torch_ckpt")
    if args.occ and args.dataset != "linemod":
        raise SystemExit("--occ requires --dataset linemod")
    from pvn3d_tpu_torch.data.loader import DataLoader
    from pvn3d_tpu_torch.inference.evaluator import PoseEvaluator
    from pvn3d_tpu_torch.inference.pipeline import (make_inference_step,
                                                    make_raw_inference_step)
    from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,
                                              stacked_mesh_kps,
                                              stacked_mesh_points)
    from pvn3d_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    is_lm = args.dataset == "linemod"
    cfg = base_config(args.dataset, args.cls)
    n_cls = cfg.model.n_classes
    obj_id = C.LM_OBJ_DICT[args.cls] if is_lm else 0
    model = _load_model(args, cfg, dev)
    model.sparse_cnn = (True if args.sparse_cnn
                        else (False if args.dense_cnn else None))

    if is_lm:
        # Row 1 is this object: its keypoints and center, and its mesh
        # (models/obj_XX.ply of its own id; an occ checkout's meshes may
        # come from a Linemod_preprocessed one).
        from pvn3d_tpu_torch.utils.assets import get_ctr, get_kps
        row = np.concatenate([get_kps(args.cls, ds_type="linemod"),
                              get_ctr(args.cls, ds_type="linemod")[None]])
        kps = np.stack([np.zeros_like(row), row])
        radii = stacked_class_radii("linemod", 2)
        mesh_root = ((args.lm_root or args.data_root) if args.occ
                     else args.data_root)
        mesh_pts, mesh_valid = stacked_mesh_points(
            mesh_root, "linemod", n_cls=2, max_points=2000,
            cls_ids=[obj_id])
    else:
        kps = stacked_mesh_kps(n_cls)
        radii = stacked_class_radii("ycb", n_cls)
        mesh_pts, mesh_valid = stacked_mesh_points(
            args.data_root, "ycb", n_cls)

    if args.device_preprocess:
        raw_step = make_raw_inference_step(
            cfg, model, kps, radii, mesh_pts, mesh_valid,
            fill_depth=not is_lm and not args.no_fill_depth, device=dev)
        count = [0]

        def step(batch):
            count[0] += 1
            return raw_step(batch, generator=batch_generator(
                args.seed, count[0] - 1, dev))
    else:
        step = make_inference_step(cfg, model, kps, radii, mesh_pts,
                                   mesh_valid, device=dev)
    refine_fn = None
    if args.icp:
        from pvn3d_tpu_torch.inference.pipeline import make_icp_refine_fn
        refine_fn = make_icp_refine_fn(cfg, mesh_pts, mesh_valid,
                                       device=dev)
        if args.packed_dir:
            print("WARNING: --icp with --packed_dir: packed shards carry "
                  "no full-res depth; the ICP scene will be the sampled "
                  "cloud, not the eval_icp.py full-resolution scene",
                  flush=True)
    if args.packed_dir:
        from pvn3d_tpu_torch.tools.preprocess_testset import \
            iter_packed_batches
        loader = iter_packed_batches(args.packed_dir, args.batch_size)
    else:
        loader = DataLoader(make_dataset_factory(args, "test", cfg),
                            args.batch_size, num_workers=args.workers)

    ev = PoseEvaluator(n_cls=max(n_cls, obj_id + 1), ds_type=args.dataset)
    n_frames = accumulate_batches(
        step, loader, ev, ds_type=args.dataset, obj_id=obj_id,
        refine_fn=refine_fn, max_frames=args.max_frames)
    print(f"evaluated {n_frames} frames")
    if is_lm:
        return ev.summarize_linemod(obj_id, verbose=True)
    return ev.summarize(verbose=True)


if __name__ == "__main__":
    main()
