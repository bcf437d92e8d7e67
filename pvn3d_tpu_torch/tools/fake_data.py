"""Write fake LineMOD-, Occlusion-LineMOD- and YCB-Video-layout
checkouts for smoke runs.

Port of the JAX package's ``tools/fake_data.py`` (``make_fake_linemod``,
``make_fake_occlusion_linemod``, ``make_fake_ycb``), written with
``data/png.py`` and without PIL or PyYAML: for the same arguments the
trees decode to the same arrays and metadata as the JAX tool's.
``gt.yml`` is written in real LineMOD's form (flow lists of numbers),
which ``data/lm_yaml.py`` and ``yaml.safe_load`` both read.  With
``n_renders`` > 0 the LineMOD tree also holds render and fuse items
(pickled dicts under ``renders/<obj>/`` and ``fuse/<obj>/``, listed in
their ``file_list.txt``), drawn from a stream of their own so the rest
of the tree is unchanged.

  python -m pvn3d_tpu_torch.tools.fake_data --root /tmp/fake --ycb \\
      --occ --n_frames 16 --n_renders 4
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from pvn3d_tpu_torch import config as C
from pvn3d_tpu_torch.data.png import write_png


def _write_gt_yml(path: str, meta: dict) -> None:
    with open(path, "w") as f:
        for frame, objs in meta.items():
            f.write(f"{frame}:\n")
            for obj in objs:
                lead = "- "
                for key in sorted(obj):
                    val = obj[key]
                    if isinstance(val, (list, tuple)):
                        val = "[" + ", ".join(repr(float(x))
                                              for x in val) + "]"
                    f.write(f"{lead}{key}: {val}\n")
                    lead = "  "


def _write_ply(path: str, pts: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "end_header\n")
        for p in pts:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def _fake_renders(lm_root: str, cls_id: int, n: int, seed: int,
                  h: int, w: int) -> None:
    """``n`` render and ``n`` fuse items of object ``cls_id``."""
    cls_type = C.LM_ID2OBJ[cls_id]
    rng = np.random.RandomState(seed + 1)
    k = C.INTRINSICS["linemod"]
    for kind in ("renders", "fuse"):
        out_dir = os.path.join(lm_root, kind, cls_type)
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for i in range(n):
            depth = np.zeros((h, w), np.float32)
            mask = np.zeros((h, w), np.uint8)
            r0 = 150 + (17 * i) % 130
            c0 = 200 + (23 * i) % 180
            depth[r0:r0 + 90, c0:c0 + 120] = 0.7 + 0.05 * i
            if kind == "fuse":
                # a fused scene: the object beside another one
                mask[r0:r0 + 90, c0:c0 + 120] = cls_id
                depth[40:120, 40:160] = 0.9
                mask[40:120, 40:160] = cls_id % 15 + 1
            else:
                mask[r0:r0 + 90, c0:c0 + 120] = 255
            rt = np.concatenate(
                [np.eye(3, dtype=np.float32),
                 [[0.01 * i], [0.02], [0.7 + 0.05 * i]]], axis=1)
            path = os.path.join(out_dir, f"{i}.pkl")
            with open(path, "wb") as f:
                pickle.dump({"depth": depth, "mask": mask, "K": k,
                             "RT": rt.astype(np.float32),
                             "rgb": (rng.rand(h, w, 3) * 255).astype(
                                 np.uint8),
                             "rnd_typ": "render" if kind == "renders"
                             else "fuse"}, f)
            paths.append(os.path.abspath(path))
        with open(os.path.join(out_dir, "file_list.txt"), "w") as f:
            f.write("\n".join(paths) + "\n")


def make_fake_linemod(root: str, n_frames: int = 6, cls_id: int = 1,
                      seed: int = 0, h: int = 480, w: int = 640,
                      n_renders: int = 0) -> str:
    """``Linemod_preprocessed/data/XX/{rgb,depth,mask}/NNNN.png``,
    ``gt.yml``, ``train.txt`` / ``test.txt`` and ``models/obj_XX.ply``
    under ``root``; returns the ``Linemod_preprocessed`` path."""
    lm_root = os.path.join(root, "Linemod_preprocessed")
    cls_root = os.path.join(lm_root, "data", "%02d" % cls_id)
    for sub in ("rgb", "depth", "mask"):
        os.makedirs(os.path.join(cls_root, sub), exist_ok=True)
    rng = np.random.RandomState(seed)
    meta = {}
    names = []
    for i in range(n_frames):
        name = f"{i:04d}"
        names.append(name)
        depth = np.full((h, w), 1000, np.uint16)          # 1.0 m in mm
        label = np.zeros((h, w), np.uint8)
        r0 = 160 + (11 * i) % 120
        c0 = 220 + (13 * i) % 160
        label[r0:r0 + 90, c0:c0 + 120] = 255
        depth[r0:r0 + 90, c0:c0 + 120] = 800              # 0.8 m object
        rgb = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        write_png(f"{cls_root}/rgb/{name}.png", rgb)
        write_png(f"{cls_root}/depth/{name}.png", depth)
        write_png(f"{cls_root}/mask/{name}.png", label)
        meta[i] = [{"obj_id": cls_id,
                    "cam_R_m2c": np.eye(3).ravel().tolist(),
                    "cam_t_m2c": [20.0 * i, 10.0, 800.0]}]
    _write_gt_yml(os.path.join(cls_root, "gt.yml"), meta)
    for split in ("train.txt", "test.txt"):
        with open(os.path.join(cls_root, split), "w") as f:
            f.write("\n".join(names) + "\n")

    os.makedirs(os.path.join(lm_root, "models"), exist_ok=True)
    pts = rng.uniform(-30, 30, (500, 3))                  # mm
    _write_ply(os.path.join(lm_root, "models", "obj_%02d.ply" % cls_id), pts)
    if n_renders:
        _fake_renders(lm_root, cls_id, n_renders, seed, h, w)
    return lm_root


def make_fake_occlusion_linemod(root: str, n_frames: int = 6,
                                cls_type: str = "ape", seed: int = 0,
                                h: int = 480, w: int = 640,
                                with_masks: bool = False) -> str:
    """OCCLUSION_LINEMOD-layout checkout (Brachmann):
    ``RGB-D/{rgb,depth}_noseg``, ``poses/<ObjName>/info_*.txt``,
    ``models/obj_XX.ply`` and, ``with_masks``, ``masks/<cls_type>/N.png``.
    Each object box has a 0.6 m occluder strip in front of its left
    20 columns; frame ``n_frames - 1`` is left unannotated (no info
    file).  Returns the ``OCCLUSION_LINEMOD`` path."""
    from pvn3d_tpu_torch.data.occlusion_linemod import OCC_POSE_DIRS
    occ_root = os.path.join(root, "OCCLUSION_LINEMOD")
    cls_id = C.LM_OBJ_DICT[cls_type]
    rgb_dir = os.path.join(occ_root, "RGB-D", "rgb_noseg")
    dep_dir = os.path.join(occ_root, "RGB-D", "depth_noseg")
    pose_dir = os.path.join(occ_root, "poses", OCC_POSE_DIRS[cls_type])
    for d in (rgb_dir, dep_dir, pose_dir):
        os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    k = C.INTRINSICS["linemod"]
    for i in range(n_frames):
        name = f"{i:05d}"
        depth = np.full((h, w), 1000, np.uint16)
        r0 = 160 + (11 * i) % 120
        c0 = 220 + (13 * i) % 160
        depth[r0:r0 + 90, c0:c0 + 120] = 800
        depth[r0:r0 + 90, c0:c0 + 20] = 600      # the occluder strip
        rgb = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        write_png(f"{rgb_dir}/color_{name}.png", rgb)
        write_png(f"{dep_dir}/depth_{name}.png", depth)
        if i == n_frames - 1:
            continue                             # unannotated frame
        # the center projects into the object box at depth 0.8 m
        cx = (c0 + 60 - k[0, 2]) * 0.8 / k[0, 0]
        cy = (r0 + 45 - k[1, 2]) * 0.8 / k[1, 1]
        with open(f"{pose_dir}/info_{name}.txt", "w") as f:
            f.write(f"image size\n{w} {h}\n{cls_type}\nrotation:\n"
                    "1 0 0\n0 1 0\n0 0 1\ncenter:\n"
                    f"{cx:.6f} {cy:.6f} 0.8\nextent:\n0.06 0.08 0.07\n")
        if with_masks:
            mdir = os.path.join(occ_root, "masks", cls_type)
            os.makedirs(mdir, exist_ok=True)
            label = np.zeros((h, w), np.uint8)
            label[r0:r0 + 90, c0 + 20:c0 + 120] = 255
            write_png(f"{mdir}/{i}.png", label)

    os.makedirs(os.path.join(occ_root, "models"), exist_ok=True)
    pts = rng.uniform(-30, 30, (500, 3))                  # mm
    _write_ply(os.path.join(occ_root, "models", "obj_%02d.ply" % cls_id),
               pts)
    return occ_root


def make_fake_ycb(root: str, n_frames: int = 4, seed: int = 0,
                  h: int = 480, w: int = 640,
                  cls_ids=(1, 5, 9, 14, 21), items=None,
                  mesh_ids=None) -> str:
    """YCB-Video-layout checkout: ``data/0001`` (real, even frames) and
    ``data_syn`` (odd frames) with sensor-dropout depth holes,
    multi-object labels, ``-meta.mat`` poses, ``models/<cls>/points.xyz``
    and ``image_list.txt`` (every item) for ``YCBDataset``'s
    ``file_list``.  ``items`` names the frames instead (``data/...`` real,
    ``data_syn/...`` synthetic), e.g. the first names of the vendored
    test list, which the evaluate app reads.  ``mesh_ids`` lists the
    classes given a mesh (default ``cls_ids``; the evaluate app reads all
    21).  Returns the ``ycb`` root."""
    import scipy.io as scio

    ycb_root = os.path.join(root, "ycb")
    if items is None:
        items = [f"data/0001/{i + 1:06d}" if i % 2 == 0
                 else f"data_syn/{i + 1:06d}" for i in range(n_frames)]
    rng = np.random.RandomState(seed)
    for i, item in enumerate(items):
        os.makedirs(os.path.dirname(os.path.join(ycb_root, item)),
                    exist_ok=True)
        depth = np.full((h, w), 10000, np.uint16)      # 1.0 m @ 1e4
        label = np.zeros((h, w), np.uint8)
        poses = np.zeros((3, 4, len(cls_ids)), np.float32)
        for j, cid in enumerate(cls_ids):
            r0 = 80 + 70 * j + (7 * i) % 30
            c0 = 60 + 100 * j + (11 * i) % 40
            label[r0:r0 + 60, c0:c0 + 80] = cid
            depth[r0:r0 + 60, c0:c0 + 80] = 8000
            poses[:, :, j] = np.concatenate(
                [np.eye(3, dtype=np.float32),
                 [[0.1 * j], [0.05 * j], [0.8]]], axis=1)
        # depth holes: the sensor-dropout pattern ip_basic fills
        for _ in range(40):
            hr = rng.randint(0, h - 12)
            hc = rng.randint(0, w - 12)
            depth[hr:hr + rng.randint(2, 12),
                  hc:hc + rng.randint(2, 12)] = 0
        rgb = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        write_png(f"{ycb_root}/{item}-color.png", rgb)
        write_png(f"{ycb_root}/{item}-depth.png", depth)
        write_png(f"{ycb_root}/{item}-label.png", label)
        scio.savemat(f"{ycb_root}/{item}-meta.mat", {
            "factor_depth": np.array([[10000.0]]),
            "cls_indexes": np.array([cls_ids], np.uint32).T,
            "poses": poses,
        })
    for cid in (cls_ids if mesh_ids is None else mesh_ids):
        mdir = os.path.join(ycb_root, "models", C.YCB_CLASSES[cid - 1])
        os.makedirs(mdir, exist_ok=True)
        pts = rng.uniform(-0.04, 0.04, (500, 3))
        np.savetxt(os.path.join(mdir, "points.xyz"), pts, fmt="%.6f")
    with open(os.path.join(ycb_root, "image_list.txt"), "w") as f:
        f.write("\n".join(items) + "\n")
    return ycb_root


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True)
    p.add_argument("--n_frames", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--occ", action="store_true",
                   help="also write an OCCLUSION_LINEMOD-layout checkout")
    p.add_argument("--ycb", action="store_true",
                   help="also write a YCB-Video-layout checkout")
    p.add_argument("--n_renders", type=int, default=0,
                   help="LineMOD render and fuse items of each kind")
    args = p.parse_args(argv)
    print(make_fake_linemod(args.root, args.n_frames, seed=args.seed,
                            n_renders=args.n_renders))
    if args.occ:
        print(make_fake_occlusion_linemod(args.root, args.n_frames,
                                          seed=args.seed))
    if args.ycb:
        print(make_fake_ycb(args.root, args.n_frames, seed=args.seed))


if __name__ == "__main__":
    main()
