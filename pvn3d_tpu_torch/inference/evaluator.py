"""Pose scoring: per-frame ADD / ADD-S on the device, AUCs on the host.

Port of the JAX package's ``inference/evaluator.py`` (the reference's
TorchEval, pvn3d_eval_utils.py:239-343): ``eval_frame_metrics`` scores
every GT instance of a batch in one call, and ``PoseEvaluator``
accumulates the distances per class and summarises them with the VOC AP
AUC (YCB) or the 0.1-diameter protocol (LineMOD).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pvn3d_tpu_torch import config as C
from pvn3d_tpu_torch.geometry.metrics import (add_accuracy_at, cal_add,
                                              cal_adds, cal_auc)


def eval_frame_metrics(poses: torch.Tensor, gt_cls_ids: torch.Tensor,
                       gt_rts: torch.Tensor, mesh_pts: torch.Tensor,
                       mesh_valid: torch.Tensor, chunk: int = 512):
    """ADD / ADD-S of every GT instance (eval_metric,
    pvn3d_eval_utils.py:113-137): the predicted pose is taken by class id
    (the zero pose when the class was never predicted).

    Args:
      poses: (..., n_cls, 3, 4) predicted per-class poses.
      gt_cls_ids: (..., I) GT instance classes (0 = empty slot).
      gt_rts: (..., I, 3, 4) GT poses.
      mesh_pts: (n_cls, M, 3) padded per-class mesh clouds.
      mesh_valid: (n_cls, M) validity of the mesh points.

    Returns add, adds (..., I) float32 distances (meaningless at empty
    slots).
    """
    n_cls = poses.shape[-3]
    lead = gt_cls_ids.shape
    cls = gt_cls_ids.reshape(-1, lead[-1]).long()
    frames = torch.arange(cls.shape[0], device=cls.device)[:, None]
    pred = poses.reshape(-1, n_cls, 3, 4)[frames, cls]
    gt = gt_rts.reshape(cls.shape + (3, 4)).float()
    pts = mesh_pts[cls]
    msk = mesh_valid[cls]
    add = cal_add(pred, gt, pts, msk)
    adds = cal_adds(pred, gt, pts, msk, chunk=chunk)
    return add.reshape(lead), adds.reshape(lead)


class PoseEvaluator:
    """Host accumulator of per-class distance lists -> AUC summaries.

    As TorchEval: class 0 accumulates every instance (the PoseCNN "all
    objects" row), and symmetric classes use ADD-S for the ADD(-S) column.
    """

    def __init__(self, n_cls: int = 22,
                 sym_cls_ids: Optional[Sequence[int]] = None,
                 ds_type: str = "ycb"):
        self.n_cls = n_cls
        self.ds_type = ds_type
        if sym_cls_ids is None:
            sym_cls_ids = (C.YCB_SYM_CLS_IDS if ds_type == "ycb"
                           else C.LM_SYM_CLS_IDS)
        self.sym_cls_ids = set(int(s) for s in sym_cls_ids)
        self.cls_add_dis = [[] for _ in range(n_cls)]
        self.cls_adds_dis = [[] for _ in range(n_cls)]

    def add_frame(self, gt_cls_ids, add, adds) -> None:
        """Accumulate one frame's instance distances (0-slots skipped)."""
        for cls_id, a, s in zip(np.asarray(gt_cls_ids).ravel(),
                                np.asarray(add).ravel(),
                                np.asarray(adds).ravel()):
            cls_id = int(cls_id)
            if cls_id <= 0:
                continue
            self.cls_add_dis[cls_id].append(float(a))
            self.cls_adds_dis[cls_id].append(float(s))
            self.cls_add_dis[0].append(float(a))
            self.cls_adds_dis[0].append(float(s))

    def _add_s_dis(self, cls_id: int):
        return (self.cls_adds_dis[cls_id] if cls_id in self.sym_cls_ids
                else self.cls_add_dis[cls_id])

    def summarize(self, verbose: bool = False) -> Dict:
        """YCB protocol: per-class and PoseCNN all-object AUCs
        (TorchEval.cal_auc, pvn3d_eval_utils.py:249-296)."""
        add_s_all = []
        per_class = {}
        for cls_id in range(1, self.n_cls):
            add_s = self._add_s_dis(cls_id)
            add_s_all += add_s
            per_class[cls_id] = {
                "add_auc": cal_auc(self.cls_add_dis[cls_id]),
                "adds_auc": cal_auc(self.cls_adds_dis[cls_id]),
                "add_s_auc": cal_auc(add_s),
                "n": len(self.cls_add_dis[cls_id]),
            }
        # Means over the classes that appeared, so a run over a subset of
        # frames is not dragged down by classes it never saw.
        seen = [v for v in per_class.values() if v["n"] > 0]
        if not seen:
            seen = [{"add_auc": 0.0, "adds_auc": 0.0, "add_s_auc": 0.0}]
        summary = {
            "per_class": per_class,
            "mean_add_auc": float(np.mean([v["add_auc"] for v in seen])),
            "mean_adds_auc": float(np.mean([v["adds_auc"] for v in seen])),
            "mean_add_s_auc": float(np.mean(
                [v["add_s_auc"] for v in seen])),
            "all_add_auc": cal_auc(self.cls_add_dis[0]),
            "all_adds_auc": cal_auc(self.cls_adds_dis[0]),
            "all_add_s_auc": cal_auc(add_s_all),
        }
        if verbose:
            names = C.YCB_CLASSES if self.ds_type == "ycb" else None
            for cls_id, v in per_class.items():
                name = names[cls_id - 1] if names else str(cls_id)
                print(f"{name}: add {v['add_auc']:.2f} "
                      f"adds {v['adds_auc']:.2f} add(-s) {v['add_s_auc']:.2f}")
            print(f"All (PoseCNN): add {summary['all_add_auc']:.2f} "
                  f"adds {summary['all_adds_auc']:.2f} "
                  f"add(-s) {summary['all_add_s_auc']:.2f}")
        return summary

    def summarize_linemod(self, obj_id: int,
                          diameter_m: Optional[float] = None,
                          verbose: bool = False) -> Dict:
        """LineMOD protocol: AUC and the percentage of ADD(-S) below 0.1
        of the object's diameter (TorchEval.cal_lm_add,
        pvn3d_eval_utils.py:298-343)."""
        if diameter_m is None:
            from pvn3d_tpu_torch.utils.assets import lm_diameters
            diameter_m = lm_diameters()[obj_id] / 1000.0
        thresh = diameter_m * 0.1
        add = self.cls_add_dis[obj_id]
        adds = self.cls_adds_dis[obj_id]
        add_s = self._add_s_dis(obj_id)
        summary = {
            "obj_id": obj_id,
            "add_auc": cal_auc(add),
            "adds_auc": cal_auc(adds),
            "add_s_auc": cal_auc(add_s),
            "add_0.1d": add_accuracy_at(add, thresh),
            "adds_0.1d": add_accuracy_at(adds, thresh),
            "add_s_0.1d": add_accuracy_at(add_s, thresh),
            "n": len(add),
        }
        if verbose:
            print(f"obj {obj_id}: add auc {summary['add_auc']:.2f} "
                  f"add<0.1d {summary['add_0.1d']:.2f} "
                  f"adds<0.1d {summary['adds_0.1d']:.2f}")
        return summary
