"""The data-parallel process group, and what moves data over it.

Port of the JAX package's ``parallel/mesh.py``.  There, distribution is
one GSPMD program over a ``('dp', 'sp')`` device mesh: frames shard over
``dp``, XLA inserts the gradient all-reduce, and the batch-axis mean of
every BatchNorm reduces over the whole sharded axis.  PyTorch has no
global array, so here one process drives one device, ``Mesh`` describes
the process group (``dp`` ranks, this one's ``rank`` and ``device``), and
each collective is explicit: ``shard_batch`` takes this rank's rows,
``gather`` puts the global result together on every rank,
and ``all_reduce_gradients`` sums the gradients after the backward; the
BatchNorms all-reduce their statistics and their backward's channel sums
themselves (``ops/kernels/bn.py``).

``sp`` (intra-frame point sharding) is not ported: under GSPMD it changes
the layout and not the results; in PyTorch it would need a model-parallel
point branch and JAX's per-field partition table (``ROADMAP.md`` item
16).  Until then every array field splits by frame.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from pvn3d_tpu_torch.utils.device import resolve_device

# DistributedDataParallel's default bucket size.
BUCKET_BYTES = 25 * 2 ** 20


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``dp`` ranks of one process each; ``group`` is None when no process
    group exists (one process, and every collective is skipped)."""
    dp: int
    rank: int
    device: torch.device
    group: Optional[Any] = None


def make_mesh(dp: Optional[int] = None, sp: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """The mesh of the default process group, or of this process alone
    when none is initialised or the group has one rank (a collective
    over one rank changes nothing and costs a host round trip per BN).
    ``device`` is this rank's: a bare ``"cuda"`` means the current card
    (``initialize_distributed`` set it to ``cuda:LOCAL_RANK``)."""
    if sp != 1:
        raise NotImplementedError(
            f"sp={sp}: intra-frame point sharding is not ported (ROADMAP.md "
            f"queue A, item 16); use dp only")
    world = dist.get_world_size() if dist.is_initialized() else 1
    group = dist.group.WORLD if world > 1 else None
    if dp is None:
        dp = world
    if dp != world:
        raise ValueError(f"dp*sp = {dp}*{sp} != {world} processes")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank() if group is not None else 0
    return Mesh(dp=dp, rank=rank, device=dev, group=group)


def local_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows ``[r*b, (r+1)*b)`` of a global batch of ``n``."""
    if n % mesh.dp:
        raise ValueError(f"global batch {n} not divisible by {mesh.dp} "
                         f"processes")
    b = n // mesh.dp
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(mesh: Mesh, batch: Mapping[str, Any]) -> dict:
    """This rank's rows of a global batch dict, as tensors on its device;
    entries that are not arrays pass through."""
    return {k: torch.as_tensor(v[local_rows(mesh, len(v))],
                               device=mesh.device)
            if isinstance(v, (np.ndarray, torch.Tensor)) else v
            for k, v in batch.items()}


def replicated(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place;
    returns ``module``."""
    if mesh.group is not None:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0, group=mesh.group)
    return module


def gather(mesh: Mesh, out):
    """Every rank's rows of ``out`` (a tensor, or a dict of them)
    concatenated along dim 0, on every rank: the global result, as a
    JAX global array shows it.  Entries that are not tensors pass
    through.

    Each rank writes its rows into a zero buffer of the global shape and
    the buffers are summed: all_reduce is the one collective that every
    backend takes for CUDA tensors (gloo's CUDA path has broadcast and
    all_reduce only), and adding zeros is exact."""
    if mesh.group is None:
        return out
    if isinstance(out, Mapping):
        return {k: gather(mesh, v) for k, v in out.items()}
    if not torch.is_tensor(out):
        return out
    b = out.shape[0]
    wide = torch.uint8 if out.dtype == torch.bool else None
    full = out.new_zeros((b * mesh.dp,) + tuple(out.shape[1:]), dtype=wide)
    full[mesh.rank * b:(mesh.rank + 1) * b] = out
    dist.all_reduce(full, group=mesh.group)
    return full.to(out.dtype)


def all_reduce_gradients(mesh: Mesh, params: Iterable[torch.Tensor]) -> None:
    """Sum every parameter's ``.grad`` over the group in place (SUM, not
    DistributedDataParallel's mean: the caller scales the loss), flattened
    into buckets of ``BUCKET_BYTES``.  Every rank holds gradients for the
    same parameters, in the same order."""
    if mesh.group is None:
        return

    def reduce(bucket):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=mesh.group)
        for g, f in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(f.view_as(g))

    bucket, size = [], 0
    for g in (p.grad for p in params if p.grad is not None):
        if bucket and size + g.numel() * g.element_size() > BUCKET_BYTES:
            reduce(bucket)
            bucket, size = [], 0
        bucket.append(g)
        size += g.numel() * g.element_size()
    if bucket:
        reduce(bucket)
