"""YCB-Video dataset (host-side input pipeline).

Port of the JAX package's ``data/ycb.py`` (the reference YCB_Dataset,
pvn3d/datasets/ycb/ycb_dataset.py): 80/20 synthetic/real training mix,
color jitter + noise stack, synthetic-over-real-background pasting, depth
completion, depth-map normals (in place of PCL KSearch-50), 12288-point
sampling, GT offsets.  The same ``RandomState`` draws in the same order
as the JAX dataset, so a seed gives the same items.  PNGs are read by
``data/png.py``, ``-meta.mat`` by ``scipy.io.loadmat``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from pvn3d_tpu_torch import config as C
from pvn3d_tpu_torch.data import augment
from pvn3d_tpu_torch.data.depth_completion import fill_missing
from pvn3d_tpu_torch.data.frame import FrameSpec, build_frame
from pvn3d_tpu_torch.data.png import read_png
from pvn3d_tpu_torch.utils.assets import get_ctr, get_kps


def _read_lines(path):
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def _load_image(path):
    return read_png(path)


class YCBDataset:
    """Frames from a YCB-Video checkout (`root` = ycb dataset root with
    data/, data_syn/, models/ and the image lists vendored in assets)."""

    def __init__(self, root: str, split: str = "train",
                 spec: Optional[FrameSpec] = None, seed: int = 0,
                 fill_depth: bool = True, kp_type: str = "",
                 file_list: str = ""):
        """``file_list`` overrides the vendored split list (custom
        subsets / smoke runs)."""
        self.root = root
        self.split = split
        self.spec = spec or FrameSpec()
        self.rng = np.random.RandomState(seed)
        self.fill_depth = fill_depth
        # n_keypoints selects the keypoint file (reference:
        # ycb_dataset.py:263-267).
        self.kp_type = kp_type or (
            "farthest" if self.spec.n_keypoints == 8
            else f"farthest{self.spec.n_keypoints}")
        if file_list:
            self.all_lst = _read_lines(file_list)
        else:
            cfg_dir = os.path.join(C.ASSETS_DIR, "ycb_config")
            list_file = ("train_data_list.txt" if split == "train"
                         else "test_data_list.txt")
            self.all_lst = _read_lines(os.path.join(cfg_dir, list_file))
        self.real_lst = [i for i in self.all_lst if i.startswith("data/")]
        self.syn_lst = [i for i in self.all_lst if not i.startswith("data/")]
        self.add_noise = split == "train"

    def __len__(self):
        return len(self.all_lst)

    def _pick_train_item(self) -> str:
        # 80% synthetic / 20% real (reference: real_syn_gen,
        # ycb_dataset.py:64-73).  Single-population file lists (real-only
        # or syn-only smoke subsets, see ``file_list``) draw from
        # whichever list is non-empty.
        if not self.syn_lst or (self.rng.rand() > 0.8 and self.real_lst):
            return self.real_lst[self.rng.randint(len(self.real_lst))]
        return self.syn_lst[self.rng.randint(len(self.syn_lst))]

    def _intrinsics(self, item_name: str) -> np.ndarray:
        # Videos >= 60 use the second camera (reference:
        # ycb_dataset.py:186-189).
        if not item_name.startswith("data_syn") and int(item_name[5:9]) >= 60:
            return C.INTRINSICS["ycb_K2"]
        return C.INTRINSICS["ycb_K1"]

    def _load_raw(self, item_name: str):
        import scipy.io as scio
        depth = _load_image(
            os.path.join(self.root, item_name + "-depth.png"))
        labels = _load_image(
            os.path.join(self.root, item_name + "-label.png"))
        rgb = _load_image(
            os.path.join(self.root, item_name + "-color.png"))[..., :3]
        meta = scio.loadmat(os.path.join(self.root, item_name + "-meta.mat"))
        return rgb, depth, labels, meta

    def get_item(self, item_name: str):
        try:
            rgb, depth, labels, meta = self._load_raw(item_name)
        except (OSError, ValueError):
            return None
        k = self._intrinsics(item_name)
        cam_scale = float(meta["factor_depth"].ravel()[0])
        is_syn = "syn" in item_name

        if self.spec.device_preprocess and self.add_noise:
            # Raw-train mode: the host only decodes; augmentation, depth
            # fill, normals, sampling and GT targets run on the device
            # (data/device_frame.py::build_train_batch_device).
            return self._raw_train_item(rgb, depth, labels, meta, k,
                                        cam_scale, is_syn)

        if self.add_noise:
            rgb = augment.color_jitter(self.rng, rgb.astype(np.uint8))
        if self.add_noise and is_syn:
            rgb = augment.rgb_add_noise_ycb(self.rng, rgb)
            rgb, depth = self._paste_real_background(rgb, labels, depth)
            if self.rng.rand() > 0.8:
                rgb = augment.rgb_add_noise_ycb(self.rng, rgb)

        depth = depth.astype(np.float32)
        if self.fill_depth and not self.spec.device_preprocess:
            # raw mode defers ip_basic completion to the device
            # (ops/preprocess.py::fill_in_multiscale).
            depth = fill_missing(depth, cam_scale)

        instances = []
        cls_id_lst = meta["cls_indexes"].ravel().astype(np.int32)
        for i, cls_id in enumerate(cls_id_lst):
            rt = meta["poses"][:, :, i].astype(np.float32)  # (3, 4)
            kps = get_kps(int(cls_id), kp_type=self.kp_type, ds_type="ycb")
            ctr = get_ctr(int(cls_id), ds_type="ycb")
            instances.append((int(cls_id), rt, kps, ctr))

        return build_frame(rgb, depth / cam_scale, labels, k, 1.0,
                           instances, self.spec, self.rng)

    def _raw_train_item(self, rgb, depth, labels, meta, k, cam_scale,
                        is_syn: bool):
        """Raw arrays + padded instance metadata for the on-device training
        build.  Depths ship metric (already / factor_depth) so one
        cam_scale=1.0 serves every frame on the device."""
        depth_m = depth.astype(np.float32) / cam_scale
        if int(np.count_nonzero(depth_m > 1e-6)) < self.spec.n_min_points:
            return None
        ni, nk = self.spec.max_instances, self.spec.n_keypoints
        cls_ids = np.zeros((ni,), np.int32)
        rts = np.zeros((ni, 3, 4), np.float32)
        mesh_kps = np.zeros((ni, nk, 3), np.float32)
        mesh_ctrs = np.zeros((ni, 3), np.float32)
        ids = meta["cls_indexes"].ravel().astype(np.int32)[:ni]
        for i, cid in enumerate(ids):
            cls_ids[i] = cid
            rts[i] = meta["poses"][:, :, i].astype(np.float32)
            mesh_kps[i] = get_kps(int(cid), kp_type=self.kp_type,
                                  ds_type="ycb")
            mesh_ctrs[i] = get_ctr(int(cid), ds_type="ycb")

        h, w = depth_m.shape
        back_rgb = np.zeros((h, w, 3), np.uint8)
        back_depth = np.zeros((h, w), np.float32)
        back_label = np.zeros((h, w), np.uint8)
        if is_syn and self.real_lst:
            real_item = self.real_lst[self.rng.randint(len(self.real_lst))]
            try:
                b_rgb, b_depth, b_label, b_meta = self._load_raw(real_item)
            except (OSError, ValueError):
                pass
            else:
                b_scale = float(b_meta["factor_depth"].ravel()[0])
                back_rgb = b_rgb[..., :3]
                back_depth = b_depth.astype(np.float32) / b_scale
                back_label = b_label

        # Images and labels ship uint8 (the device build promotes):
        # float32 would triple the collate and IPC bytes.
        return {
            "rgb": np.ascontiguousarray(rgb[..., :3], np.uint8),
            "depth": depth_m,
            "label_map": labels.astype(np.uint8),
            "cam_k": np.asarray(k, np.float32),
            "cls_ids": cls_ids, "rts": rts,
            "mesh_kps": mesh_kps, "mesh_ctrs": mesh_ctrs,
            "is_syn": np.bool_(is_syn),
            "do_jitter": np.bool_(True),   # YCB jitters every train frame
            "back_rgb": np.ascontiguousarray(back_rgb, np.uint8),
            "back_depth": back_depth,
            "back_label": np.asarray(back_label, np.uint8),
        }

    def _paste_real_background(self, rgb, labels, depth):
        if not self.real_lst:      # syn-only file list: nothing to paste
            return rgb, depth
        real_item = self.real_lst[self.rng.randint(len(self.real_lst))]
        try:
            back_rgb, back_depth, back_label, _ = self._load_raw(real_item)
        except (OSError, ValueError):
            return rgb, depth
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
