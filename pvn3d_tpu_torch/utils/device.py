"""Device choice for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.

    The port runs on the card unless the caller asks for the CPU: the
    default is ``"cuda"``, and a CUDA request without a card raises rather
    than falling back, so a run never silently measures the host.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pvn3d_tpu_torch: CUDA requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def disable_tf32() -> None:
    """Keep float32 convs and matmuls in full float32.

    cuDNN runs float32 convolutions in TF32 by default (about three
    decimal digits), the card's form of the bf16-matmul trap the JAX
    package documents; the port's float32 mode means float32.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
