"""Demo: render predicted poses into test images (reference:
pvn3d/demo.py).

Port of the JAX package's ``apps/demo.py``, with the same flags but
``--device cuda|cpu`` for ``--platform``:

  python -m pvn3d_tpu_torch.apps.demo --dataset linemod --cls ape \\
      --data_root /path/Linemod_preprocessed --checkpoint_dir runs/ape \\
      --out_dir pose_vis --n_frames 20

Each test frame goes through ``make_inference_step`` and every present
class's mesh is projected under its predicted pose and scattered on the
image (``utils/viz.py``).  The JAX app writes ``{i}.jpg`` with
``cv2.imwrite``; the port has no JPEG encoder (no cv2 or PIL), so it
writes ``{i}.png`` with ``data/png.py::write_png`` in RGB order: the
picture the JPEG showed, pixel for pixel, without JPEG's loss.  YCB
frames are RGB and written as they are; LineMOD frames are BGR (the
dataset's order) and written with the channels flipped.  It runs on the
card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", choices=("ycb", "linemod"), default="ycb")
    p.add_argument("--cls", default="ape")
    p.add_argument("--data_root", required=True)
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--out_dir", default="pose_vis")
    p.add_argument("--n_frames", type=int, default=20)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--no_fill_depth", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    return p


def main(argv=None) -> list:
    """Write the overlays and return their paths."""
    args = build_argparser().parse_args(argv)
    from pvn3d_tpu_torch import config as C
    from pvn3d_tpu_torch.apps.train import base_config, make_dataset_factory
    from pvn3d_tpu_torch.data.loader import DataLoader
    from pvn3d_tpu_torch.data.png import write_png
    from pvn3d_tpu_torch.inference.pipeline import make_inference_step
    from pvn3d_tpu_torch.train.checkpoint import CheckpointManager
    from pvn3d_tpu_torch.train.state import create_train_state
    from pvn3d_tpu_torch.utils.assets import (get_ctr, get_kps,
                                              load_mesh_points,
                                              stacked_class_radii,
                                              stacked_mesh_kps)
    from pvn3d_tpu_torch.utils.device import resolve_device
    from pvn3d_tpu_torch.utils.viz import draw_pose_mesh

    dev = resolve_device(args.device)
    is_lm = args.dataset == "linemod"
    cfg = base_config(args.dataset, args.cls)
    n_cls = cfg.model.n_classes

    state = create_train_state(cfg, 0, dev)
    state = CheckpointManager(args.checkpoint_dir).restore(state) or state

    if is_lm:
        kp = get_kps(args.cls, ds_type="linemod")
        ctr = get_ctr(args.cls, ds_type="linemod").reshape(1, 3)
        kps = np.stack([np.zeros((len(kp) + 1, 3), np.float32),
                        np.concatenate([kp, ctr])])
        radii = stacked_class_radii("linemod", 2)
        meshes = {1: load_mesh_points(args.data_root,
                                      C.LM_OBJ_DICT[args.cls],
                                      ds_type="linemod")}
        k_mat = C.INTRINSICS["linemod"]
    else:
        kps = stacked_mesh_kps(n_cls)
        radii = stacked_class_radii("ycb", n_cls)
        meshes = {c: load_mesh_points(args.data_root, c, ds_type="ycb")
                  for c in range(1, n_cls)}
        k_mat = C.INTRINSICS["ycb_K1"]

    step = make_inference_step(cfg, state.model, kps, radii, device=dev)
    loader = DataLoader(make_dataset_factory(args, "test", cfg), 1,
                        num_workers=args.workers)
    os.makedirs(args.out_dir, exist_ok=True)

    paths = []
    for i, batch in enumerate(loader):
        if i >= args.n_frames:
            break
        out = step(batch)
        img = np.clip(batch["rgb"][0], 0, 255).astype(np.uint8).copy()
        poses = out["poses"][0].cpu().numpy()
        present = out["present"][0].cpu().numpy()
        for cls_id in range(1, poses.shape[0]):
            if not present[cls_id] or cls_id not in meshes:
                continue
            img = draw_pose_mesh(img, meshes[cls_id], poses[cls_id], k_mat,
                                 cls_id)
        path = os.path.join(args.out_dir, f"{i}.png")
        write_png(path, np.ascontiguousarray(img[..., ::-1] if is_lm
                                             else img))
        print(f"wrote {path}")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
