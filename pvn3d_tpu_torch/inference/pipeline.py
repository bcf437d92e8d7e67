"""The serving entry point: batch dict -> forward -> seg argmax -> poses.

Port of the JAX package's ``inference/pipeline.py::make_pose_fn`` and
``make_inference_step`` (without the metrics branch).  The JAX step is one
jitted XLA program; here it runs eagerly in ``torch.inference_mode`` on
one device, frame by frame for the pose stage.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pvn3d_tpu_torch.config import Config
from pvn3d_tpu_torch.inference.pose import FramePoses, cal_frame_poses
from pvn3d_tpu_torch.utils.device import disable_tf32, resolve_device


def make_pose_fn(cfg: Config, mesh_kps: np.ndarray, radii: np.ndarray,
                 refine_mask: Optional[bool] = None,
                 device: str | torch.device = "cuda"):
    """Batched votes -> poses: ``fn(pcld (B, N, 3), seg (B, N),
    ctr_of (B, 1, N, 3), kp_of (B, n_kps, N, 3)) -> FramePoses`` with a
    leading batch axis on every field."""
    dev = resolve_device(device)
    if refine_mask is None:
        refine_mask = cfg.dataset.name == "ycb"
    mesh_kps_t = torch.as_tensor(mesh_kps, dtype=torch.float32, device=dev)
    radii_t = torch.as_tensor(radii, dtype=torch.float32, device=dev)
    cl = cfg.cluster

    def pose_fn(pcld, seg, ctr_of, kp_of) -> FramePoses:
        frames = [cal_frame_poses(
            pcld[i], seg[i], ctr_of[i], kp_of[i], mesh_kps_t, radii_t,
            n_cls=cfg.model.n_classes, n_kps=cfg.model.n_keypoints,
            k=cl.max_points_per_class, bandwidth=cl.bandwidth,
            max_iter=cl.max_iter, use_ctr=cl.use_ctr,
            use_ctr_clus_filter=cl.use_ctr_clus_filter,
            refine_mask=refine_mask) for i in range(pcld.shape[0])]
        return FramePoses(*(torch.stack(f) for f in zip(*frames)))

    return pose_fn


def make_inference_step(cfg: Config, model: torch.nn.Module,
                        mesh_kps: np.ndarray, radii: np.ndarray,
                        refine_mask: Optional[bool] = None,
                        device: str | torch.device = "cuda"):
    """Full serving step: ``step(batch) -> {poses, present, kps, seg}``.

    ``batch`` holds ``pointcloud`` (B, N, 9), ``rgb`` (B, H, W, 3) and
    ``choose`` (B, N) as numpy arrays or tensors.  ``model`` is a
    ``models.pvn3d.PVN3D``; it is moved to ``device``.  The step runs on
    the card unless ``device="cpu"`` is asked for, and raises when CUDA is
    asked for and missing.  TF32 is switched off for convs and matmuls so
    float32 means float32 (``utils.device.disable_tf32``).
    """
    dev = resolve_device(device)
    disable_tf32()
    model = model.to(dev).eval()
    pose_fn = make_pose_fn(cfg, mesh_kps, radii, refine_mask, dev)

    @torch.inference_mode()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        pcld_full = torch.as_tensor(batch["pointcloud"], device=dev).float()
        out = model(pcld_full,
                    torch.as_tensor(batch["rgb"], device=dev).float(),
                    torch.as_tensor(batch["choose"], device=dev))
        seg = torch.argmax(out["seg_logits"], dim=-1).to(torch.int32)
        frame = pose_fn(pcld_full[..., :3], seg, out["ctr_offsets"],
                        out["kp_offsets"])
        return {"poses": frame.poses, "present": frame.present,
                "kps": frame.kps, "seg": seg}

    return step
