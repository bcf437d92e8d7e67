"""Occlusion-LineMOD test split (host-side input pipeline).

Port of the JAX package's ``data/occlusion_linemod.py``.  The reference
advertises the split through ``-test_occ`` (pvn3d/train/
train_linemod_pvn3d.py:97-99), but the ``OCC_LM_Dataset`` it instantiates
(:441-443) is defined nowhere, so upstream the flag raises ``NameError``.
This module implements what the flag promises, against the standard
OCCLUSION_LINEMOD checkout (Brachmann et al., "Learning 6D Object Pose
Estimation using 3D Object Coordinates"):

    root/
      RGB-D/rgb_noseg/color_NNNNN.png     8-bit RGB
      RGB-D/depth_noseg/depth_NNNNN.png   16-bit depth (mm)
      poses/<ObjName>/info_NNNNN.txt      rotation (3x3) + center (m)
      masks/<cls_type>/NNNNN.png          optional instance masks

Frames whose info file is missing or unannotated (the object fully
occluded) give None.  Without a mask file the label map is synthesised
by projecting the object's mesh under the GT pose; labels only shape loss
targets and seg accuracy, never the predicted pose, so ADD is unaffected.
Images are read by ``data/png.py``; the same ``RandomState`` draws in the
same order as the JAX dataset.

Rotation and center are taken as they are (camera-from-model, center in
meters).  Some OCCLUSION_LINEMOD distributions use re-centered models
whose frame differs from the Linemod_preprocessed meshes by a per-object
offset: a constant large ADD of GT against GT signals that mismatch.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Optional

import numpy as np
from scipy import ndimage

from pvn3d_tpu_torch import config as C
from pvn3d_tpu_torch.data.frame import FrameSpec, build_frame
from pvn3d_tpu_torch.data.png import read_png
from pvn3d_tpu_torch.utils.assets import get_ctr, get_kps, load_mesh_points

# poses/<ObjName> directory capitalization used by the Brachmann checkout.
OCC_POSE_DIRS = {
    "ape": "Ape", "can": "Can", "cat": "Cat", "driller": "Driller",
    "duck": "Duck", "eggbox": "Eggbox", "glue": "Glue",
    "holepuncher": "Holepuncher",
}


def parse_occ_info(path: str) -> Optional[np.ndarray]:
    """``info_NNNNN.txt`` -> (3, 4) float32 RT, or None if unannotated.

    The file carries labeled blocks; only ``rotation:`` (9 floats) and
    ``center:`` (3 floats, meters) matter here.  Files for frames where
    the object is invisible are absent or truncated.
    """
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return None

    def floats_after(tag: str, n: int):
        m = re.search(tag + r":\s*((?:[-+0-9.eE\s]|nan)+)", text)
        if not m:
            return None
        vals = m.group(1).split()[:n]
        if len(vals) < n:
            return None
        try:
            arr = np.asarray([float(v) for v in vals], np.float32)
        except ValueError:
            return None
        return arr if np.all(np.isfinite(arr)) else None

    rot = floats_after("rotation", 9)
    ctr = floats_after("center", 3)
    if rot is None or ctr is None:
        return None
    return np.concatenate([rot.reshape(3, 3), ctr.reshape(3, 1)], axis=1)


class OcclusionLineMODDataset:
    """Test-only frames from an OCCLUSION_LINEMOD checkout.

    Args:
      root: the OCCLUSION_LINEMOD directory (layout above).
      cls_type: one of the 8 occ objects (``OCC_POSE_DIRS`` keys).
      lm_root: a Linemod_preprocessed checkout supplying the object mesh
        (``models/obj_XX.ply``) for label synthesis; defaults to ``root``
        (some checkouts bundle a compatible ``models/`` dir).
    """

    def __init__(self, root: str, cls_type: str = "ape",
                 split: str = "test", spec: Optional[FrameSpec] = None,
                 lm_root: Optional[str] = None, seed: int = 0):
        if split != "test":
            raise ValueError("Occlusion LineMOD is a test-only split "
                             f"(got split={split!r}); the reference's "
                             "-test_occ is eval-only too")
        if cls_type not in OCC_POSE_DIRS:
            raise ValueError(f"{cls_type!r} is not an Occlusion-LineMOD "
                             f"object: {sorted(OCC_POSE_DIRS)}")
        self.root = root
        self.cls_type = cls_type
        self.cls_id = C.LM_OBJ_DICT[cls_type]
        self.spec = spec or FrameSpec()
        self.rng = np.random.RandomState(seed)
        self.pose_dir = os.path.join(root, "poses", OCC_POSE_DIRS[cls_type])
        self.mask_dir = os.path.join(root, "masks", cls_type)
        rgbs = sorted(glob.glob(os.path.join(
            root, "RGB-D", "rgb_noseg", "color_*.png")))
        self.ids = [os.path.basename(p)[len("color_"):-len(".png")]
                    for p in rgbs]
        self._mesh = None
        self._lm_root = lm_root or root

    def __len__(self):
        return len(self.ids)

    def _mesh_points(self) -> np.ndarray:
        if self._mesh is None:
            self._mesh = load_mesh_points(
                self._lm_root, self.cls_id, ds_type="linemod")
        return self._mesh

    def _synth_label(self, rt: np.ndarray, depth: np.ndarray,
                     k: np.ndarray) -> np.ndarray:
        """Project the mesh with the GT pose into a binary label map.

        Occluders are carved out by the depth test (projected mesh depth
        within 2 cm of the measured depth), then pinholes between the
        projected vertices are closed by two dilations.
        """
        h, w = depth.shape
        pts = self._mesh_points() @ rt[:, :3].T + rt[:, 3]
        z = pts[:, 2]
        keep = z > 1e-6
        u = np.round(pts[keep, 0] / z[keep] * k[0, 0] + k[0, 2]).astype(int)
        v = np.round(pts[keep, 1] / z[keep] * k[1, 1] + k[1, 2]).astype(int)
        z = z[keep]
        ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        u, v, z = u[ok], v[ok], z[ok]
        meas = depth[v, u]
        vis = (meas > 1e-6) & (np.abs(meas - z) < 0.02)
        label = np.zeros((h, w), np.uint8)
        label[v[vis], u[vis]] = 1
        return ndimage.binary_dilation(label, iterations=2).astype(np.uint8)

    def get_item(self, frame_id: str):
        rt = parse_occ_info(
            os.path.join(self.pose_dir, f"info_{frame_id}.txt"))
        if rt is None:
            return None                       # object absent / unannotated
        try:
            rgb = read_png(os.path.join(
                self.root, "RGB-D", "rgb_noseg",
                f"color_{frame_id}.png"))[..., :3]
            depth = read_png(os.path.join(
                self.root, "RGB-D", "depth_noseg",
                f"depth_{frame_id}.png")).astype(np.float32)
        except (OSError, ValueError):
            return None
        depth = depth / 1000.0                # mm -> m

        mask_path = os.path.join(self.mask_dir, f"{int(frame_id)}.png")
        k = C.INTRINSICS["linemod"]
        if os.path.exists(mask_path):
            labels = (read_png(mask_path) > 0).astype(np.uint8)
            if labels.ndim > 2:
                labels = labels[..., 0]
        else:
            labels = self._synth_label(rt, depth, k)

        rgb = rgb[..., ::-1].astype(np.float32)   # BGR like LineMOD
        kp_type = ("farthest" if self.spec.n_keypoints == 8
                   else f"farthest{self.spec.n_keypoints}")
        kps = get_kps(self.cls_type, kp_type=kp_type, ds_type="linemod")
        ctr = get_ctr(self.cls_type, ds_type="linemod")
        instances = [(1, rt, kps, ctr)]
        return build_frame(rgb, depth, labels, k, 1.0,
                           instances, self.spec, self.rng)

    def __getitem__(self, idx: int):
        return self.get_item(self.ids[idx])
