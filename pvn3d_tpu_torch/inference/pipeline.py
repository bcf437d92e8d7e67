"""The serving entry points: frames -> forward -> seg argmax -> poses.

Port of the JAX package's ``inference/pipeline.py``: ``make_pose_fn``,
``make_inference_step`` (prepared batches), ``make_raw_inference_step``
(raw RGB-D sensor frames, built into network inputs on the device by
``data/device_frame.py``), each with the metrics branch, and the
evaluation loop ``accumulate_batches`` / ``evaluate_dataset``, and the ICP
post-refinement ``make_icp_step`` / ``make_icp_refine_fn`` (reference:
eval_icp.py).  The JAX step is one jitted XLA program; here it runs
eagerly in ``torch.inference_mode`` on one device, frame by frame for the
pose stage and the ICP scenes, with every frame's ICP problems refined in
one batch.  Under a data-parallel mesh (``parallel/mesh.py``) both
serving steps run each rank's rows of the request and gather the global
result on every rank, as the JAX step does on a dp-sharded batch.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional

import numpy as np
import torch

from pvn3d_tpu_torch.config import Config
from pvn3d_tpu_torch.data.device_frame import (build_inference_batch_device,
                                               draw_priorities)
from pvn3d_tpu_torch.inference.evaluator import (PoseEvaluator,
                                                 eval_frame_metrics)
from pvn3d_tpu_torch.inference.icp import (fullres_class_clouds,
                                           refine_frame_poses)
from pvn3d_tpu_torch.inference.pose import (FramePoses, _select_class_points,
                                            cal_frame_poses)
from pvn3d_tpu_torch.parallel.mesh import (Mesh, gather, local_rows,
                                           shard_batch)
from pvn3d_tpu_torch.utils.device import disable_tf32, resolve_device
from pvn3d_tpu_torch.utils.profiling import annotate


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
        with annotate("pvn3d.pose_stage"):
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

    def serve(pointcloud, rgb, choose, batch,
              global_batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
        out = model(pointcloud, rgb, choose, global_batch=global_batch)
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
                        device: str | torch.device = "cuda",
                        mesh: Optional[Mesh] = None):
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

    With a ``mesh``, every rank calls ``step`` on the same global batch,
    runs its rows (``shard_batch``; the CNN tail is chosen on the global
    batch) and returns the global result (``gather``).
    """
    dev, serve = _make_serve(cfg, model, mesh_kps, radii, mesh_pts,
                             mesh_valid, refine_mask, device)
    calls = itertools.count()

    @torch.inference_mode()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        with annotate("pvn3d.request", next(calls)):
            n = None
            if mesh is not None:
                n = len(batch["pointcloud"])
                batch = shard_batch(mesh, batch)
            # Copies from host memory: each waits for the stream.
            with annotate("pvn3d.read.frame_upload"):
                inputs = [torch.as_tensor(batch[k], device=dev)
                          for k in ("pointcloud", "rgb", "choose")]
            out = serve(inputs[0].float(), inputs[1].float(), inputs[2],
                        batch, n)
            return out if mesh is None else gather(mesh, out)

    return step


def make_raw_inference_step(cfg: Config, model: torch.nn.Module,
                            mesh_kps: np.ndarray, radii: np.ndarray,
                            mesh_pts: Optional[np.ndarray] = None,
                            mesh_valid: Optional[np.ndarray] = None,
                            fill_depth: bool = True, cam_scale: float = 1.0,
                            refine_mask: Optional[bool] = None,
                            device: str | torch.device = "cuda",
                            mesh: Optional[Mesh] = None):
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

    With a ``mesh``, as ``make_inference_step``: the global
    ``priorities`` (drawn for the global batch when not given) are
    sharded with the batch.
    """
    dev, serve = _make_serve(cfg, model, mesh_kps, radii, mesh_pts,
                             mesh_valid, refine_mask, device)
    n_sample = cfg.model.n_sample_points
    calls = itertools.count()

    @torch.inference_mode()
    def step(batch: Dict, generator: Optional[torch.Generator] = None,
             priorities: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        with annotate("pvn3d.request", next(calls)):
            n = None
            if mesh is not None:
                n, h, w = batch["depth"].shape
                if priorities is None:
                    priorities = draw_priorities((n, h * w), dev, generator)
                priorities = torch.as_tensor(priorities)[local_rows(mesh, n)]
                batch = shard_batch(mesh, batch)
            # Copies from host memory: each waits for the stream.
            with annotate("pvn3d.read.frame_upload"):
                rgb = torch.as_tensor(batch["rgb"], device=dev).float()
                depth = torch.as_tensor(batch["depth"], device=dev)
                cam_k = torch.as_tensor(batch["cam_k"], device=dev)
                if priorities is not None:
                    priorities = torch.as_tensor(priorities, device=dev)
            with annotate("pvn3d.frame_build"):
                built = build_inference_batch_device(
                    rgb, depth, cam_k, n_sample, cam_scale=cam_scale,
                    fill=fill_depth, generator=generator,
                    priorities=priorities)
            result = serve(built["pointcloud"], rgb, built["choose"], batch,
                           n)
            result.update(built)
            return result if mesh is None else gather(mesh, result)

    return step


def make_icp_step(cfg: Config, mesh_pts: np.ndarray, mesh_valid: np.ndarray,
                  device: str | torch.device = "cuda"):
    """Batched ICP refinement of per-class poses against the
    predicted-class scene points (reference: eval_icp.py):
    ``step(pcld (B, N, 3), seg (B, N), poses (B, n_cls, 3, 4))`` in sampled
    mode, or with ``depth`` (B, H, W) in metres and ``cam_k`` (B, 3, 3)
    added in full-resolution mode -> refined poses (B, n_cls, 3, 4).

    Full-resolution mode is reference parity: the scene is the
    full-resolution depth cloud of the 1-NN-upsampled predicted mask,
    capped at ``icp.max_scene_points`` per class, with the
    ``>= min_class_points`` gate on the full-res count (eval_icp.py:
    224-291, :388-426, :146-151).  Sampled mode (no depth map) takes the class
    points of the sampled cloud.  Row 0 (background) passes through.  Runs
    on the card unless ``device="cpu"``; raises when CUDA is asked for and
    missing.
    """
    dev = resolve_device(device)
    disable_tf32()
    icp = cfg.icp
    n_cls = mesh_pts.shape[0]
    k = icp.max_scene_points
    pts = torch.as_tensor(mesh_pts[1:], dtype=torch.float32, device=dev)
    valid = torch.as_tensor(mesh_valid[1:], device=dev).bool()

    @torch.inference_mode()
    def step(pcld, seg, poses, depth=None, cam_k=None):
        pcld = torch.as_tensor(pcld, device=dev).float()
        seg = torch.as_tensor(seg, device=dev)
        poses = torch.as_tensor(poses, device=dev).float()
        b = pcld.shape[0]
        scenes = []
        for i in range(b):
            if depth is None:
                sel, sel_valid, _ = _select_class_points(seg[i], n_cls, k)
                scenes.append((pcld[i][sel], sel_valid, None))
            else:
                scenes.append(fullres_class_clouds(
                    torch.as_tensor(depth[i], device=dev),
                    torch.as_tensor(cam_k[i], device=dev), pcld[i], seg[i],
                    n_cls, k))
        scene, scene_valid, counts = zip(*scenes)
        # Every frame's problems in one batch: a stopped problem keeps its
        # pose, so the poses equal a loop per frame.
        refined, _, _ = refine_frame_poses(
            poses[:, 1:].reshape(-1, 3, 4), pts.repeat(b, 1, 1),
            valid.repeat(b, 1), torch.cat(scene), torch.cat(scene_valid),
            min_points=icp.min_class_points,
            cluster_bandwidth=icp.cluster_bandwidth,
            max_iter=icp.max_iter, tolerance=icp.tolerance,
            gate_counts=None if depth is None else torch.cat(counts))
        return torch.cat([poses[:, :1], refined.reshape(b, n_cls - 1, 3, 4)],
                         dim=1)

    return step


def make_icp_refine_fn(cfg: Config, mesh_pts: np.ndarray,
                       mesh_valid: np.ndarray, warn=None,
                       device: str | torch.device = "cuda"):
    """ICP post-refinement for ``accumulate_batches``: ``refine_fn(batch,
    out) -> (add, adds)`` recomputed from the refined poses.

    The scene in the reference's order (eval_icp.py:224-291): the filled
    depth ``depth_m`` of the raw step, else the batch's full-res
    ``depth`` (metres), else -- loudly, ``warn`` is called with the
    message once -- the sampled cloud, which is NOT reference parity.
    ``refine_fn.mode`` says which ("fullres" / "sampled")."""
    dev = resolve_device(device)
    icp_step = make_icp_step(cfg, mesh_pts, mesh_valid, dev)
    pts = torch.as_tensor(mesh_pts, dtype=torch.float32, device=dev)
    valid = torch.as_tensor(mesh_valid, device=dev).bool()
    warn = warn or (lambda msg: print(msg, flush=True))

    def refine_fn(batch, out):
        icp_args = ()
        if "depth_m" in out:
            icp_args = (out["depth_m"], batch["cam_k"])
        elif "depth" in batch:
            icp_args = (batch["depth"], batch["cam_k"])
        elif refine_fn.mode != "sampled":
            warn("WARNING: batch has no full-res depth map — ICP scene "
                 "falls back to the sampled point cloud (NOT eval_icp.py "
                 "parity; packed shards don't carry depth — evaluate from "
                 "raw frames for the reference-parity scene)")
        refine_fn.mode = "fullres" if icp_args else "sampled"
        pcld = out["pointcloud"] if "pointcloud" in out else batch[
            "pointcloud"]
        refined = icp_step(torch.as_tensor(pcld)[..., :3], out["seg"],
                           out["poses"], *icp_args)
        with torch.inference_mode():
            return eval_frame_metrics(
                refined, torch.as_tensor(batch["cls_ids"], device=dev),
                torch.as_tensor(batch["rts"], device=dev), pts, valid)

    refine_fn.mode = None
    return refine_fn


def accumulate_batches(step, batches, ev: PoseEvaluator,
                       ds_type: str = "ycb", obj_id: int = 0,
                       refine_fn=None, max_frames: int = 0) -> int:
    """The evaluation loop: run ``step`` on each batch, optionally replace
    its ADD / ADD-S by ``refine_fn(batch, out) -> (add, adds)`` (ICP,
    ``make_icp_refine_fn``), and feed the scored frames to ``ev``.  A
    batch's ``_n_valid`` says how many of its frames are real (a padded
    last batch); LineMOD frames store their one object as class 1 and are
    scored under ``obj_id``.  Returns the number of frames scored."""
    n_frames = 0
    for batch in batches:
        batch = dict(batch)
        n_valid = int(batch.pop("_n_valid", 0)) or None
        out = step(batch)
        if "add" not in out:
            continue
        if refine_fn is not None:
            out["add"], out["adds"] = refine_fn(batch, out)
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
