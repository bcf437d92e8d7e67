"""Process bootstrap.

Port of the JAX package's ``parallel/multihost.py``.  There each host
feeds its rows of the global batch and
``jax.make_array_from_process_local_data`` assembles global arrays.  Here
one process drives one device (``torchrun --nproc_per_node=N``), the
process group is ``torch.distributed``'s (NCCL on the card, gloo on the
CPU), and a rank's batch is simply its rows of the global one
(``mesh.shard_batch``, or the loader's ``rank``/``world``).
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from pvn3d_tpu_torch.utils.device import resolve_device

# What torchrun sets for every rank.
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: str | torch.device = "cuda") -> None:
    """``torch.distributed.init_process_group`` (no-op when a group
    exists): NCCL for the card, gloo for ``device="cpu"``.

    With ``coordinator_address`` (an init URL, ``tcp://host:port`` or
    ``file:///path``; a bare ``host:port`` is taken as TCP) a real
    bootstrap of ``num_processes`` ranks is demanded and errors propagate.
    With no arguments it reads the torchrun environment
    (``TORCHRUN_ENV``); when none of it is set the run stays
    single-process, as the JAX helper does without a cluster.  On the
    card the rank's device becomes ``cuda:LOCAL_RANK`` (without
    ``LOCAL_RANK``, the process id modulo the machine's cards).  Raises
    when CUDA is asked for and missing.
    """
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is not None:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        rank, world = int(process_id), int(num_processes)
    elif any(k in os.environ for k in TORCHRUN_ENV):
        url = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        return
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=url, rank=rank,
                            world_size=world)
