"""The serving entry points: frames -> forward -> seg argmax -> poses.

Port of the JAX package's ``inference/pipeline.py``: ``make_pose_fn``,
``make_inference_step`` (prepared batches), ``make_raw_inference_step``
(raw RGB-D sensor frames, built into network inputs on the device by
``data/device_frame.py``), each with the metrics branch, and the
evaluation loop ``accumulate_batches`` / ``evaluate_dataset``.  The ICP
steps are not ported yet.  The JAX step is one jitted XLA program; here
it runs eagerly in ``torch.inference_mode`` on one device, frame by frame
for the pose stage.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pvn3d_tpu_torch.config import Config
from pvn3d_tpu_torch.data.device_frame import build_inference_batch_device
from pvn3d_tpu_torch.inference.evaluator import (PoseEvaluator,
                                                 eval_frame_metrics)
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


def _make_serve(cfg: Config, model: torch.nn.Module, mesh_kps, radii,
                mesh_pts, mesh_valid, refine_mask, device):
    """What both serving steps share: the device (TF32 off), the model on
    it in eval mode, and ``serve(pointcloud, rgb, choose, batch)`` ->
    {poses, present, kps, seg}, plus per-instance add / adds against the
    batch's GT slots (``cls_ids``, ``rts``) when meshes are given."""
    dev = resolve_device(device)
    disable_tf32()
    model = model.to(dev).eval()
    pose_fn = make_pose_fn(cfg, mesh_kps, radii, refine_mask, dev)
    if mesh_pts is not None:
        pts = torch.as_tensor(mesh_pts, dtype=torch.float32, device=dev)
        valid = torch.as_tensor(mesh_valid, device=dev).bool()

    def serve(pointcloud, rgb, choose, batch) -> Dict[str, torch.Tensor]:
        out = model(pointcloud, rgb, choose)
        seg = torch.argmax(out["seg_logits"], dim=-1).to(torch.int32)
        frame = pose_fn(pointcloud[..., :3], seg, out["ctr_offsets"],
                        out["kp_offsets"])
        result = {"poses": frame.poses, "present": frame.present,
                  "kps": frame.kps, "seg": seg}
        if mesh_pts is not None and "cls_ids" in batch:
            result["add"], result["adds"] = eval_frame_metrics(
                frame.poses, torch.as_tensor(batch["cls_ids"], device=dev),
                torch.as_tensor(batch["rts"], device=dev), pts, valid)
        return result
    return dev, serve


def make_inference_step(cfg: Config, model: torch.nn.Module,
                        mesh_kps: np.ndarray, radii: np.ndarray,
                        mesh_pts: Optional[np.ndarray] = None,
                        mesh_valid: Optional[np.ndarray] = None,
                        refine_mask: Optional[bool] = None,
                        device: str | torch.device = "cuda"):
    """Full serving step: ``step(batch) -> {poses, present, kps, seg}``.

    ``batch`` holds ``pointcloud`` (B, N, 9), ``rgb`` (B, H, W, 3) and
    ``choose`` (B, N) as numpy arrays or tensors.  With ``mesh_pts``
    (n_cls, M, 3) and ``mesh_valid`` (n_cls, M) given and GT slots
    ``cls_ids`` (B, I) and ``rts`` (B, I, 3, 4) in the batch, the result
    also holds per-instance ``add`` and ``adds`` (B, I).  ``model`` is a
    ``models.pvn3d.PVN3D``; it is moved to ``device``.  The step runs on
    the card unless ``device="cpu"`` is asked for, and raises when CUDA is
    asked for and missing.  TF32 is switched off for convs and matmuls so
    float32 means float32 (``utils.device.disable_tf32``).
    """
    dev, serve = _make_serve(cfg, model, mesh_kps, radii, mesh_pts,
                             mesh_valid, refine_mask, device)

    @torch.inference_mode()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        return serve(torch.as_tensor(batch["pointcloud"], device=dev).float(),
                     torch.as_tensor(batch["rgb"], device=dev).float(),
                     torch.as_tensor(batch["choose"], device=dev), batch)

    return step


def make_raw_inference_step(cfg: Config, model: torch.nn.Module,
                            mesh_kps: np.ndarray, radii: np.ndarray,
                            mesh_pts: Optional[np.ndarray] = None,
                            mesh_valid: Optional[np.ndarray] = None,
                            fill_depth: bool = True, cam_scale: float = 1.0,
                            refine_mask: Optional[bool] = None,
                            device: str | torch.device = "cuda"):
    """Sensor-to-pose step: ``step(batch, generator=None, priorities=None)``
    with ``batch`` holding ``rgb`` (B, H, W, 3) 0-255, ``depth`` (B, H, W)
    in native units (``cam_scale`` per metre) and ``cam_k`` (B, 3, 3).

    Depth completion (``fill_depth``), normals, the point subsample and
    the feature assembly run on the device
    (``data.device_frame.build_inference_batch_device``, which takes the
    ``generator`` or the ``priorities``), then the forward and the pose
    stage as in ``make_inference_step``.  Returns poses, present, kps,
    seg, choose, pointcloud and depth_m, and add / adds when meshes are
    given and the batch holds GT slots.  Runs on the card unless
    ``device="cpu"``; raises when CUDA is asked for and missing.
    """
    dev, serve = _make_serve(cfg, model, mesh_kps, radii, mesh_pts,
                             mesh_valid, refine_mask, device)
    n_sample = cfg.model.n_sample_points

    @torch.inference_mode()
    def step(batch: Dict, generator: Optional[torch.Generator] = None,
             priorities: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        rgb = torch.as_tensor(batch["rgb"], device=dev).float()
        built = build_inference_batch_device(
            rgb, torch.as_tensor(batch["depth"], device=dev),
            torch.as_tensor(batch["cam_k"], device=dev), n_sample,
            cam_scale=cam_scale, fill=fill_depth, generator=generator,
            priorities=(None if priorities is None
                        else torch.as_tensor(priorities, device=dev)))
        result = serve(built["pointcloud"], rgb, built["choose"], batch)
        result.update(built)
        return result

    return step


def accumulate_batches(step, batches, ev: PoseEvaluator,
                       ds_type: str = "ycb", obj_id: int = 0,
                       max_frames: int = 0) -> int:
    """The evaluation loop: run ``step`` on each batch and feed the
    scored frames to ``ev``.  A batch's ``_n_valid`` says how many of its
    frames are real (a padded last batch); LineMOD frames store their one
    object as class 1 and are scored under ``obj_id``.  Returns the number
    of frames scored."""
    n_frames = 0
    for batch in batches:
        batch = dict(batch)
        n_valid = int(batch.pop("_n_valid", 0)) or None
        out = step(batch)
        if "add" not in out:
            continue
        cls_ids = np.asarray(batch["cls_ids"])
        add = out["add"].cpu().numpy()
        adds = out["adds"].cpu().numpy()
        if ds_type == "linemod":
            cls_ids = np.where(cls_ids > 0, obj_id, 0)
        for b in range(n_valid or cls_ids.shape[0]):
            ev.add_frame(cls_ids[b], add[b], adds[b])
        n_frames += n_valid or cls_ids.shape[0]
        if max_frames and n_frames >= max_frames:
            break
    return n_frames


def evaluate_dataset(cfg: Config, model: torch.nn.Module, batches,
                     mesh_kps, radii, mesh_pts, mesh_valid,
                     ds_type: str = "ycb", obj_id: int = 0,
                     verbose: bool = False,
                     device: str | torch.device = "cuda") -> Dict:
    """Run ``make_inference_step`` over ``batches`` and summarise: the
    YCB AUC protocol, or LineMOD's 0.1-diameter one for
    ``ds_type == "linemod"``."""
    step = make_inference_step(cfg, model, mesh_kps, radii, mesh_pts,
                               mesh_valid, device=device)
    ev = PoseEvaluator(n_cls=max(cfg.model.n_classes, obj_id + 1),
                       ds_type=ds_type)
    accumulate_batches(step, batches, ev, ds_type=ds_type, obj_id=obj_id)
    if ds_type == "linemod":
        return ev.summarize_linemod(obj_id, verbose=verbose)
    return ev.summarize(verbose=verbose)
