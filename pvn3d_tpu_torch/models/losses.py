"""Training losses: focal segmentation loss + masked offset L1.

Port of the JAX package's ``models/losses.py`` (the reference's FocalLoss
/ OFLoss, pvn3d/lib/loss.py:13-89) as functions of tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 2.0, alpha=None) -> torch.Tensor:
    """Multi-class focal loss, mean-reduced:
    ``-(1 - p_t)^gamma * log p_t`` over all points (loss.py:22-42 with
    size_average=True).  ``logits`` (..., C) raw scores, ``labels`` (...)
    int class ids.  ``p_t`` carries no gradient, as in the reference."""
    logp = F.log_softmax(logits.float(), dim=-1)
    logpt = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    pt = logpt.detach().exp()
    if alpha is not None:
        at = torch.as_tensor(alpha, dtype=torch.float32,
                             device=logits.device)[labels.long()]
        logpt = logpt * at
    return (-((1.0 - pt) ** gamma) * logpt).mean()


def offset_l1_loss(pred_offsets: torch.Tensor, target_offsets: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """Masked L1 on per-point offsets (of_l1_loss, loss.py:45-73):
    ``|pred - target|`` over points with label > 0, summed over points and
    xyz and divided by the frame's foreground point count + 1e-3; the
    (B, n_kpts) matrix is then summed (train_ycb_pvn3d.py:176-181).

    ``pred_offsets`` (B, n_kpts, N, 3); ``target_offsets`` (B, N, n_kpts,
    3) as the datasets give them; ``labels`` (B, N)."""
    w = (labels > 1e-8).float()
    tgt = target_offsets.permute(0, 2, 1, 3)
    diff = (pred_offsets.float() - tgt.float()).abs() * w[:, None, :, None]
    per_kp = diff.sum(dim=(2, 3))
    denom = w.sum(dim=1)[:, None] + 1e-3
    return (per_kp / denom).sum()


def seg_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-point classification accuracy (train_ycb_pvn3d.py:186-189)."""
    return (torch.argmax(logits, dim=-1) == labels).float().mean()
