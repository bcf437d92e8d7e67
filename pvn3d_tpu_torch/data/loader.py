"""Multi-process batched data loading, and prefetch to the device.

Port of the JAX package's ``data/loader.py`` (in place of the reference's
torch DataLoader with 60 workers, train_ycb_pvn3d.py:425-438): a small
process pool that builds samples, collated into numpy batches in the
parent.  Workers start by ``spawn`` (the parent holds a CUDA context, so
forking is unsafe), never touch CUDA, and run torch on one thread (the
host depth fill is torch on the CPU).

``prefetch_to_device`` moves batches to the card ahead of the step: each
host batch is pinned and copied with ``non_blocking=True`` on the
consuming stream, and its pinned buffers are held until that copy's
event has completed.
"""
from __future__ import annotations

import collections
import multiprocessing as mp
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from pvn3d_tpu_torch.data.frame import collate

_WORKER_DS = None
# Seeds of different ranks' workers lie this far apart.
RANK_STRIDE = 1 << 16


def worker_seed(seed: int, rank: int, wid: int) -> int:
    """The augmentation stream of worker ``wid`` (0: the parent) of rank
    ``rank``: ``seed + wid`` on rank 0, so ranks and workers draw apart."""
    return seed + wid + RANK_STRIDE * rank


def _init_worker(dataset_factory, seed, rank):
    global _WORKER_DS
    torch.set_num_threads(1)
    _WORKER_DS = dataset_factory()
    # Decorrelate augmentation streams across workers and ranks.
    ident = mp.current_process()._identity
    wid = ident[0] if ident else 0
    _WORKER_DS.rng = np.random.RandomState(worker_seed(seed, rank, wid))


def _fetch(idx):
    return _WORKER_DS[idx]


class DataLoader:
    """Iterate collated batch dicts from an index-able dataset.

    ``dataset_factory`` must be picklable (a top-level class or a
    ``functools.partial`` of one) so each worker can build its own
    dataset.  With ``num_workers=0`` everything runs inline.

    ``batch_size`` is the global batch.  Rank ``rank`` of ``world`` builds
    only its rows of each: tickets ``[i*B + r*b, i*B + (r+1)*b)`` with
    ``b = B / world``, and yields batches of ``b``; its workers (and, on a
    rank above 0, its inline dataset) draw from ``worker_seed``.
    """

    def __init__(self, dataset_factory, batch_size: int,
                 num_workers: int = 0, seed: int = 0,
                 steps: Optional[int] = None, rank: int = 0, world: int = 1):
        if batch_size % world:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{world} processes")
        self.factory = dataset_factory
        self.batch_size = batch_size
        self.local = batch_size // world
        self.rank = rank
        self.num_workers = num_workers
        self.seed = seed
        # Epoch mode (steps=None): the final n % batch_size samples are
        # padded by repeating the last sample to keep one batch shape; the
        # batch carries "_n_valid" (a plain int) so consumers score only
        # the real frames.  Training mode (steps) yields exactly ``steps``
        # full batches: a sample the dataset skips (None) is made up from
        # further tickets, so every rank runs the same number of steps.
        self.steps = steps

    def _tickets(self, rounds: range, n: int) -> Iterator[int]:
        """This rank's rows of the global batches ``rounds``.  Training
        stream: the index is only a ticket -- train-mode datasets sample
        their own item per call (the reference's real/syn generators,
        ycb_dataset.py:64-73).  Epoch stream: rows past the end repeat the
        last sample."""
        b, lo, B = self.local, self.rank * self.local, self.batch_size
        for i in rounds:
            for j in range(i * B + lo, i * B + lo + b):
                yield j % n if self.steps is not None else min(j, n - 1)

    def __iter__(self):
        ds = self.factory()
        n = len(ds)
        pool = None
        if self.num_workers <= 0:
            if self.rank:
                ds.rng = np.random.RandomState(
                    worker_seed(self.seed, self.rank, 0))

            def samples(tickets):
                return (ds[i] for i in tickets)
        else:
            pool = mp.get_context("spawn").Pool(
                self.num_workers, _init_worker,
                (self.factory, self.seed, self.rank))

            def samples(tickets):
                return pool.imap(_fetch, tickets)
        try:
            batch = []
            if self.steps is None:
                rounds = -(-n // self.batch_size)
                if self.local == self.batch_size:
                    tickets = iter(range(n))
                else:
                    tickets = self._tickets(range(rounds), n)
                for sample in samples(tickets):
                    if sample is None:
                        continue
                    batch.append(sample)
                    if len(batch) == self.local:
                        yield collate(batch)
                        batch = []
                if batch:
                    n_valid = len(batch)
                    batch += [batch[-1]] * (self.local - n_valid)
                    out = collate(batch)
                    out["_n_valid"] = n_valid
                    yield out
                return
            made, start = 0, 0
            while made < self.steps:
                # The global batches still missing, then as many more as
                # skipped samples leave missing.
                need = self.steps - made
                drawn = 0
                for sample in samples(self._tickets(
                        range(start, start + need), n)):
                    if sample is None:
                        continue
                    drawn += 1
                    batch.append(sample)
                    if len(batch) == self.local:
                        yield collate(batch)
                        batch = []
                        made += 1
                start += need
                if not drawn:
                    raise RuntimeError(
                        f"the dataset returned no sample for "
                        f"{need * self.local} tickets")
        finally:
            # Consumers may break out early (--max_frames): terminate so
            # the pool stops building the rest of the index stream.
            if pool is not None:
                pool.terminate()
                pool.join()


PREFETCH = 2    # batches in flight on the device


def prefetch_to_device(iterator: Iterable[dict], device,
                       host_keys=()) -> Iterator[dict]:
    """Keep ``PREFETCH`` batches in flight on ``device``.

    Each array of a host batch becomes a tensor on ``device``; the keys in
    ``host_keys`` and entries that are not arrays (``_n_valid``) stay as
    they are.  On a CUDA device each array is pinned and copied with
    ``non_blocking=True`` on the current (consuming) stream, and its
    pinned buffer is held until that copy's event has completed: the
    next batch may not reuse it mid-copy.
    """
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    in_flight = collections.deque()     # device batches, in order
    pinned = collections.deque()        # (event, host buffers)

    def release(block: bool):
        while pinned and (block or pinned[0][0].query()):
            ev, _ = pinned.popleft()
            if block:
                ev.synchronize()

    def put(batch: dict) -> dict:
        out, bufs = {}, []
        for k, v in batch.items():
            if k in host_keys or not isinstance(v, np.ndarray):
                out[k] = v
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            if cuda:
                t = t.pin_memory()
                bufs.append(t)
                out[k] = t.to(dev, non_blocking=True)
            else:
                out[k] = t
        if cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            pinned.append((ev, bufs))
        return out

    try:
        for batch in iterator:
            in_flight.append(put(batch))
            release(block=False)
            if len(in_flight) >= PREFETCH:
                yield in_flight.popleft()
        while in_flight:
            yield in_flight.popleft()
    finally:
        release(block=True)
