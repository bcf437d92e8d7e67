"""LineMOD dataset (host-side input pipeline).

Port of the JAX package's ``data/linemod.py`` (the reference LM_Dataset,
pvn3d/datasets/linemod/linemod_dataset.py): per-object single-class
frames, real/render/fuse training mix (real_ratio 0.3, fuse 0.4 of the
remainder, :79-93), BGR channel order (:235 flips), mm->m poses from
gt.yml, no depth completion (cf. :243), binary labels.  Benchvise
(cls_id 2) selects its own meta entry from multi-object gt lists
(:216-220).  The same ``RandomState`` draws in the same order as the JAX
dataset.  PNGs are read by ``data/png.py`` and ``gt.yml`` by
``data/lm_yaml.py``; render and fuse items are pickles (standard
library).
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from pvn3d_tpu_torch import config as C
from pvn3d_tpu_torch.data import augment, lm_yaml
from pvn3d_tpu_torch.data.frame import FrameSpec, build_frame
from pvn3d_tpu_torch.data.png import read_png
from pvn3d_tpu_torch.utils.assets import get_ctr, get_kps


def _read_lines(path):
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def _load_image(path):
    return read_png(path)


class LineMODDataset:
    """Frames from a Linemod_preprocessed checkout."""

    def __init__(self, root: str, cls_type: str = "ape",
                 split: str = "train", spec: Optional[FrameSpec] = None,
                 seed: int = 0):
        self.root = root                       # .../Linemod_preprocessed
        self.cls_type = cls_type
        self.cls_id = C.LM_OBJ_DICT[cls_type]
        self.cls_root = os.path.join(root, "data", "%02d" % self.cls_id)
        self.split = split
        self.spec = spec or FrameSpec()
        self.rng = np.random.RandomState(seed)
        self.add_noise = split == "train"
        self.meta_lst = lm_yaml.load(os.path.join(self.cls_root, "gt.yml"))
        if split == "train":
            self.real_lst = _read_lines(
                os.path.join(self.cls_root, "train.txt"))
            rnd_list = os.path.join(root, "renders", cls_type,
                                    "file_list.txt")
            self.rnd_lst = (_read_lines(rnd_list)
                            if os.path.exists(rnd_list) else [])
            fuse_list = os.path.join(root, "fuse", cls_type, "file_list.txt")
            self.fuse_lst = (_read_lines(fuse_list)
                             if os.path.exists(fuse_list) else self.rnd_lst)
            self.all_lst = self.real_lst + self.rnd_lst + self.fuse_lst
        else:
            self.all_lst = _read_lines(
                os.path.join(self.cls_root, "test.txt"))

    def __len__(self):
        return len(self.all_lst)

    def _pick_train_item(self, real_ratio: float = 0.3) -> str:
        # reference: real_syn_gen (linemod_dataset.py:79-93).
        if self.rng.rand() < real_ratio or not self.rnd_lst:
            return self.real_lst[self.rng.randint(len(self.real_lst))]
        if self.rng.rand() < 0.4 and self.fuse_lst:
            return self.fuse_lst[self.rng.randint(len(self.fuse_lst))]
        return self.rnd_lst[self.rng.randint(len(self.rnd_lst))]

    def _meta_rt(self, item_name: str) -> np.ndarray:
        meta = self.meta_lst[int(item_name)]
        if self.cls_id == 2:
            meta = next(m for m in meta if m["obj_id"] == 2)
        else:
            meta = meta[0]
        r = np.asarray(meta["cam_R_m2c"], np.float32).reshape(3, 3)
        t = np.asarray(meta["cam_t_m2c"], np.float32) / 1000.0
        return np.concatenate([r, t[:, None]], axis=1)

    def get_item(self, item_name: str):
        try:
            if "pkl" in item_name:
                with open(item_name, "rb") as f:
                    data = pickle.load(f)
                depth = np.asarray(data["depth"], np.float32)
                rgb = np.asarray(data["rgb"])[..., :3]
                labels = np.asarray(data["mask"])
                k = np.asarray(data["K"], np.float32)
                rt = np.asarray(data["RT"], np.float32)
                rnd_typ = data["rnd_typ"]
                if rnd_typ == "fuse":
                    labels = (labels == self.cls_id).astype(np.uint8)
                else:
                    labels = (labels > 0).astype(np.uint8)
                cam_scale = 1.0
            else:
                depth = _load_image(os.path.join(
                    self.cls_root, "depth", f"{item_name}.png")
                ).astype(np.float32)
                labels = (_load_image(os.path.join(
                    self.cls_root, "mask", f"{item_name}.png")) > 0
                ).astype(np.uint8)
                rgb = _load_image(os.path.join(
                    self.cls_root, "rgb", f"{item_name}.png"))[..., :3]
                rt = self._meta_rt(item_name)
                rnd_typ = "real"
                k = C.INTRINSICS["linemod"]
                cam_scale = 1000.0
        except (OSError, ValueError, KeyError):
            return None
        if labels.ndim > 2:
            labels = labels[..., 0]

        if self.spec.device_preprocess and self.add_noise:
            # Raw-train mode (see YCBDataset._raw_train_item): the host
            # only decodes and composes the item; jitter (real frames),
            # the BGR flip, the render noise stack + background paste,
            # normals, sampling and GT targets run on the device
            # (data/device_frame.py::build_train_batch_device, BGR flip
            # for linemod).
            return self._raw_train_item(rgb, depth, labels, k, rt,
                                        cam_scale, rnd_typ)

        if self.add_noise and rnd_typ == "real":
            rgb = augment.color_jitter(self.rng, rgb.astype(np.uint8))
        # BGR order, matching the reference's ::-1 flip (:235).
        rgb = rgb[..., ::-1].astype(np.float32)

        if self.add_noise and rnd_typ == "render":
            rgb = augment.rgb_add_noise_lm(
                self.rng, np.clip(rgb, 0, 255).astype(np.uint8))
            rgb, depth = self._paste_real_background(rgb, labels, depth)
            if self.rng.rand() > 0.8:
                rgb = augment.rgb_add_noise_lm(
                    self.rng, np.clip(rgb, 0, 255).astype(np.uint8))
            rgb = rgb.astype(np.float32)

        kp_type = ("farthest" if self.spec.n_keypoints == 8
                   else f"farthest{self.spec.n_keypoints}")
        kps = get_kps(self.cls_type, kp_type=kp_type, ds_type="linemod")
        ctr = get_ctr(self.cls_type, ds_type="linemod")
        instances = [(1, rt, kps, ctr)]
        return build_frame(rgb, depth / cam_scale, labels, k, 1.0,
                           instances, self.spec, self.rng)

    def _raw_train_item(self, rgb, depth, labels, k, rt, cam_scale,
                        rnd_typ: str):
        """Raw arrays + instance metadata for the on-device training build.
        Depth ships metric; rgb ships as-decoded (RGB order) — the device
        build applies the BGR flip after the jitter, matching the host
        order (linemod_dataset.py:233-235)."""
        depth_m = depth.astype(np.float32) / cam_scale
        if int(np.count_nonzero(depth_m > 1e-6)) < self.spec.n_min_points:
            return None
        ni, nk = self.spec.max_instances, self.spec.n_keypoints
        kp_type = ("farthest" if nk == 8 else f"farthest{nk}")
        cls_ids = np.zeros((ni,), np.int32)
        rts = np.zeros((ni, 3, 4), np.float32)
        mesh_kps = np.zeros((ni, nk, 3), np.float32)
        mesh_ctrs = np.zeros((ni, 3), np.float32)
        cls_ids[0] = 1
        rts[0] = rt
        mesh_kps[0] = get_kps(self.cls_type, kp_type=kp_type,
                              ds_type="linemod")
        mesh_ctrs[0] = get_ctr(self.cls_type, ds_type="linemod")

        h, w = depth_m.shape
        back_rgb = np.zeros((h, w, 3), np.uint8)
        back_depth = np.zeros((h, w), np.float32)
        back_label = np.zeros((h, w), np.uint8)
        if rnd_typ == "render" and self.real_lst:
            real_item = self.real_lst[self.rng.randint(len(self.real_lst))]
            try:
                b_depth = _load_image(os.path.join(
                    self.cls_root, "depth", f"{real_item}.png"))
                b_label = _load_image(os.path.join(
                    self.cls_root, "mask", f"{real_item}.png"))
                b_rgb = _load_image(os.path.join(
                    self.cls_root, "rgb", f"{real_item}.png"))[..., :3]
            except (OSError, ValueError):
                pass
            else:
                if b_label.ndim > 2:
                    b_label = b_label[..., 0]
                back_rgb = np.ascontiguousarray(b_rgb, np.uint8)
                # real LineMOD depths are mm (cam_scale 1000)
                back_depth = b_depth.astype(np.float32) / 1000.0
                back_label = np.asarray(b_label > 0, np.uint8)

        return {
            "rgb": np.ascontiguousarray(rgb[..., :3], np.uint8),
            "depth": depth_m,
            "label_map": labels.astype(np.uint8),
            "cam_k": np.asarray(k, np.float32),
            "cls_ids": cls_ids, "rts": rts,
            "mesh_kps": mesh_kps, "mesh_ctrs": mesh_ctrs,
            "is_syn": np.bool_(rnd_typ == "render"),
            "do_jitter": np.bool_(rnd_typ == "real"),
            "back_rgb": back_rgb, "back_depth": back_depth,
            "back_label": back_label,
        }

    def _paste_real_background(self, rgb, labels, depth):
        if not self.real_lst:      # render-only list: nothing to paste
            return rgb, depth
        real_item = self.real_lst[self.rng.randint(len(self.real_lst))]
        try:
            back_depth = _load_image(os.path.join(
                self.cls_root, "depth", f"{real_item}.png"))
            back_label = _load_image(os.path.join(
                self.cls_root, "mask", f"{real_item}.png"))
            back_rgb = _load_image(os.path.join(
                self.cls_root, "rgb", f"{real_item}.png"))[..., :3]
        except (OSError, ValueError):
            return rgb, depth
        if back_label.ndim > 2:
            back_label = back_label[..., 0]
        back_rgb = back_rgb[..., ::-1]        # BGR like the foreground
        # Real LineMOD depth PNGs are millimeters; the render foreground
        # here is meters (pkl, cam_scale 1.0).  The reference pastes the
        # raw mm values into the metric map (linemod_dataset.py:166-187)
        # — a unit-mixing quirk that puts background pixels ~1000x too
        # far; the JAX package's host and raw-train paths, and these,
        # paste at the correct scale instead.
        back_depth = back_depth.astype(np.float32) / 1000.0
        return augment.add_real_back(
            rgb, labels, depth.astype(np.float32), depth > 1e-6,
            back_rgb, back_depth, back_label)

    def __getitem__(self, idx: int):
        if self.split == "train":
            while True:
                data = self.get_item(self._pick_train_item())
                if data is not None:
                    return data
        return self.get_item(self.all_lst[idx])
