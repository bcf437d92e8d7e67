"""Generate per-object metadata for a new dataset from its meshes.

Port of the JAX package's ``tools/gen_obj_info.py`` (a capability match
for the reference's adaptation tooling, pvn3d/lib/utils/dataset_tools/
gen_obj_info.py + README.md:109-124): from a PLY mesh, write corners.txt
(8 bbox corners), radius.txt (half bbox diagonal), center.txt, and
farthest{,4,12,16,20}.txt FPS keypoints, the files the datasets and the
evaluation read back through ``pvn3d_tpu_torch.utils.assets``.  The PLY
is read by ``utils/assets.py::read_ply_vertices`` and the keypoints are
picked by ``native.farthest_point_sampling``; for the same mesh and seed
the files equal the JAX tool's byte for byte.

Usage:
  python -m pvn3d_tpu_torch.tools.gen_obj_info --ply obj.ply \
      --out assets/my_obj [--scale 1000] [--kp_counts 8,4,12,16,20]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from pvn3d_tpu_torch.native import farthest_point_sampling
from pvn3d_tpu_torch.utils.assets import read_ply_vertices


def corners_3d(p3ds: np.ndarray) -> np.ndarray:
    """8 bbox corners, x varying slowest and z fastest (reference:
    get_corners_3d, gen_obj_info.py:39-59)."""
    lo = p3ds.min(axis=0)
    hi = p3ds.max(axis=0)
    return np.array([[x, y, z] for x in (lo[0], hi[0])
                     for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
                    np.float32)


def bbox_radius(corners: np.ndarray) -> float:
    """Half bbox diagonal (reference: get_radius, gen_obj_info.py:63-65)."""
    return float(np.linalg.norm(corners.max(0) - corners.min(0)) / 2.0)


def bbox_center(corners: np.ndarray) -> np.ndarray:
    return (corners.max(0) + corners.min(0)) / 2.0


def write_txt(path: str, arr: np.ndarray) -> None:
    arr = np.atleast_2d(np.asarray(arr, np.float64))
    with open(path, "w") as f:
        for row in arr:
            f.write(" ".join(repr(float(v)) for v in row) + "\n")


def gen_one_mesh_info(ply_path: str, out_dir: str, scale: float = 1.0,
                      kp_counts=(8, 4, 12, 16, 20), seed: int = 0) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    p3ds = read_ply_vertices(ply_path) / scale
    corners = corners_3d(p3ds)
    write_txt(os.path.join(out_dir, "corners.txt"), corners)
    radius = bbox_radius(corners)
    with open(os.path.join(out_dir, "radius.txt"), "w") as f:
        f.write(f"{radius}\n")
    write_txt(os.path.join(out_dir, "center.txt"), bbox_center(corners))
    for n in kp_counts:
        name = "farthest.txt" if n == 8 else f"farthest{n}.txt"
        kps = farthest_point_sampling(p3ds, n, seed=seed)
        write_txt(os.path.join(out_dir, name), kps)
    return {"radius": radius, "n_points": len(p3ds)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ply", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--scale", type=float, default=1.0,
                   help="divide vertex coords (1000 for mm meshes)")
    p.add_argument("--kp_counts", default="8,4,12,16,20")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    counts = tuple(int(c) for c in args.kp_counts.split(","))
    info = gen_one_mesh_info(args.ply, args.out, scale=args.scale,
                             kp_counts=counts, seed=args.seed)
    print(info)


if __name__ == "__main__":
    main()
