"""A consistent procedural 6-DoF world for end-to-end system validation.

Unlike ``synthetic.py`` (shape-contract smoke batches), this module defines
a fixed set of canonical objects (mesh clouds + FPS-style keypoints) and
renders frames of them under random rigid poses, with exactly the GT
structure the real datasets produce.  (A copy of the JAX package's
``data/synthetic_world.py``: for the same seeds it gives the same meshes,
keypoints and frames, bit for bit.)  Training on these frames and then
running the perceive→vote→cluster→fit pipeline yields a true ADD learning
signal without any dataset on disk — the strongest available no-data proof
that the whole system (model, losses, clustering, fitting, metrics)
actually works together.

The model must learn from geometry alone (the rgb image is noise), so
foreground objects are distinctly-shaped point clusters: each class c is a
deformed ellipsoid with its own axis scales.
"""
from __future__ import annotations

import numpy as np

from pvn3d_tpu_torch.data.frame import collate


class SyntheticWorld:
    def __init__(self, n_classes: int = 4, n_keypoints: int = 8,
                 mesh_points: int = 256, seed: int = 0):
        """n_classes includes background class 0."""
        self.n_classes = n_classes
        self.n_keypoints = n_keypoints
        rng = np.random.RandomState(seed)
        self.meshes = []
        self.mesh_kps = [np.zeros((n_keypoints + 1, 3), np.float32)]
        self.mesh_pts = [np.zeros((mesh_points, 3), np.float32)]
        for c in range(1, n_classes):
            # Distinct ellipsoid-ish shells per class.
            scales = rng.uniform(0.02, 0.07, 3)
            u = rng.normal(0, 1, (mesh_points, 3))
            u /= np.linalg.norm(u, axis=1, keepdims=True)
            pts = (u * scales).astype(np.float32)
            self.mesh_pts.append(pts)
            # Spread keypoints: greedy farthest selection + center.
            kps = [pts[0]]
            d = np.linalg.norm(pts - pts[0], axis=1)
            for _ in range(n_keypoints - 1):
                i = int(np.argmax(d))
                kps.append(pts[i])
                d = np.minimum(d, np.linalg.norm(pts - pts[i], axis=1))
            kps = np.stack(kps)
            ctr = pts.mean(0, keepdims=True)
            self.mesh_kps.append(
                np.concatenate([kps, ctr]).astype(np.float32))
        self.stacked_kps = np.stack(self.mesh_kps)          # (C, K+1, 3)
        m = max(len(p) for p in self.mesh_pts)
        self.stacked_pts = np.stack(self.mesh_pts)          # (C, M, 3)
        self.stacked_valid = np.ones((n_classes, m), bool)
        self.stacked_valid[0] = False

    def random_pose(self, rng) -> np.ndarray:
        q = rng.normal(0, 1, 4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        t = np.array([rng.uniform(-0.25, 0.25), rng.uniform(-0.2, 0.2),
                      rng.uniform(0.8, 1.2)])
        return np.concatenate([r, t[:, None]], axis=1).astype(np.float32)

    def sample_frame(self, rng, n_points: int = 12288, height: int = 480,
                     width: int = 640, max_instances: int = 12,
                     noise: float = 0.002):
        n_obj = self.n_classes - 1
        per = n_points // (2 * n_obj)
        xyz_parts, label_parts = [], []
        cls_ids = np.zeros(max_instances, np.int32)
        rts = np.tile(np.eye(3, 4, dtype=np.float32), (max_instances, 1, 1))
        kp3ds = np.zeros((max_instances, self.n_keypoints, 3), np.float32)
        ctr3ds = np.zeros((max_instances, 3), np.float32)
        for i, c in enumerate(range(1, self.n_classes)):
            rt = self.random_pose(rng)
            sel = rng.randint(0, len(self.mesh_pts[c]), per)
            pts = self.mesh_pts[c][sel] @ rt[:, :3].T + rt[:, 3]
            pts = pts + rng.normal(0, noise, pts.shape)
            xyz_parts.append(pts.astype(np.float32))
            label_parts.append(np.full(per, c, np.int32))
            cls_ids[i] = c
            rts[i] = rt
            kps_cam = self.mesh_kps[c][:-1] @ rt[:, :3].T + rt[:, 3]
            kp3ds[i] = kps_cam
            ctr3ds[i] = self.mesh_kps[c][-1] @ rt[:, :3].T + rt[:, 3]
        n_bg = n_points - per * n_obj
        bg = np.stack([rng.uniform(-0.7, 0.7, n_bg),
                       rng.uniform(-0.5, 0.5, n_bg),
                       np.full(n_bg, 1.4) + rng.normal(0, 0.01, n_bg)],
                      axis=1).astype(np.float32)
        xyz = np.concatenate(xyz_parts + [bg])
        labels = np.concatenate(label_parts + [np.zeros(n_bg, np.int32)])
        perm = rng.permutation(n_points)
        xyz, labels = xyz[perm], labels[perm]

        kp_t = np.zeros((n_points, self.n_keypoints, 3), np.float32)
        ctr_t = np.zeros((n_points, 1, 3), np.float32)
        for i in range(n_obj):
            m = labels == cls_ids[i]
            kp_t[m] = xyz[m][:, None, :] - kp3ds[i][None]
            ctr_t[m, 0] = xyz[m] - ctr3ds[i][None]

        rgb = (rng.rand(height, width, 3) * 255).astype(np.float32)
        choose = rng.randint(0, height * width, n_points).astype(np.int32)
        feats = rng.rand(n_points, 6).astype(np.float32)
        return {
            "pointcloud": np.concatenate([xyz, feats], 1).astype(np.float32),
            "rgb": rgb, "choose": choose, "labels": labels,
            "kp_targ_ofst": kp_t, "ctr_targ_ofst": ctr_t,
            "cls_ids": cls_ids, "rts": rts,
            "kp_3ds": kp3ds[:, :, :], "ctr_3ds": ctr3ds,
        }

    def sample_batch(self, rng, batch_size: int, **kw):
        return collate([self.sample_frame(rng, **kw)
                        for _ in range(batch_size)])
