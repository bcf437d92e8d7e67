"""Pack a test split into .npz shards for fast evaluation.

Port of the JAX package's ``tools/preprocess_testset.py``; the shards are
the same ``.npz`` files, so either package reads the other's.  A
capability match for the reference's offline testset preprocessors
(pvn3d/datasets/{ycb,linemod}/preprocess_testset.py), which pickle the
per-frame tuples so eval skips the PCL/depth-completion cost (YCB training
even blocks until that pickle exists, train_ycb_pvn3d.py:419-423).  Here
frames pack into compressed npz shards of whole batches, loadable with
``iter_packed_batches`` — no pickle, no torch.

  python -m pvn3d_tpu_torch.tools.preprocess_testset --dataset ycb \
      --data_root /path/ycb --out packed/ycb_test --shard_size 64
  python -m pvn3d_tpu_torch.tools.preprocess_testset --dataset linemod \
      --cls ape --occ --data_root /path/OCCLUSION_LINEMOD \
      --lm_root /path/Linemod_preprocessed --out packed/occ_ape
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from pvn3d_tpu_torch.data.frame import collate


def pack_dataset(dataset, out_dir: str, shard_size: int = 64,
                 max_frames: int = 0, workers: int = 0,
                 train_targets: bool = False, compress: bool = False) -> int:
    """Pack ``dataset`` into npz shards.

    Eval-oriented by default: the per-point offset targets (train-only,
    ~10 MB/8 frames) are dropped unless ``train_targets``, integer-valued
    rgb stores as uint8 (exact — test-split pixels are raw 0-255 values),
    and shards are STORED rather than deflated (zlib decompression is
    slower to read back than the disk)."""
    os.makedirs(out_dir, exist_ok=True)
    buf, shard, n = [], 0, 0
    save = np.savez_compressed if compress else np.savez

    def flush():
        nonlocal buf, shard
        if not buf:
            return
        batch = collate(buf)
        if not train_targets:
            batch.pop("kp_targ_ofst", None)
            batch.pop("ctr_targ_ofst", None)
        rgb = batch.get("rgb")
        if rgb is not None and rgb.dtype == np.float32:
            u8 = rgb.astype(np.uint8)
            if np.array_equal(u8.astype(np.float32), rgb):
                batch["rgb"] = u8
        save(os.path.join(out_dir, f"shard_{shard:05d}.npz"), **batch)
        buf = []
        shard += 1

    if workers > 0:
        import multiprocessing.pool
        pool = multiprocessing.pool.ThreadPool(workers)
        stream = pool.imap(dataset.__getitem__, range(len(dataset)))
    else:
        stream = (dataset[i] for i in range(len(dataset)))
    for sample in stream:
        if sample is None:
            continue
        buf.append(sample)
        n += 1
        if len(buf) == shard_size:
            flush()
        if max_frames and n >= max_frames:
            break
    flush()
    return n


def iter_packed_batches(out_dir: str, batch_size: int = 0):
    """Yield batch dicts from packed shards (re-batched if requested).

    Remainder frames carry over into the next shard so nothing is
    dropped at shard boundaries; the final partial batch is padded by
    repeating its last frame and carries ``"_n_valid"`` (a plain int) so
    consumers score only the real frames at one batch shape.
    """
    carry = None
    for path in sorted(glob.glob(os.path.join(out_dir, "shard_*.npz"))):
        with np.load(path) as z:
            shard = {k: z[k] for k in z.files}
        if shard.get("rgb") is not None and shard["rgb"].dtype == np.uint8:
            shard["rgb"] = shard["rgb"].astype(np.float32)
        if not batch_size:
            yield shard
            continue
        if carry is not None:
            shard = {k: np.concatenate([carry[k], shard[k]])
                     for k in shard}
            carry = None
        n = len(next(iter(shard.values())))
        full = (n // batch_size) * batch_size
        for s in range(0, full, batch_size):
            yield {k: v[s:s + batch_size] for k, v in shard.items()}
        if n > full:
            carry = {k: v[full:] for k, v in shard.items()}
    if carry is not None:
        n_valid = len(next(iter(carry.values())))
        pad = batch_size - n_valid
        out = {k: np.concatenate([v] + [v[-1:]] * pad)
               for k, v in carry.items()}
        out["_n_valid"] = n_valid
        yield out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", choices=("ycb", "linemod"), default="ycb")
    p.add_argument("--cls", default="ape")
    p.add_argument("--data_root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--shard_size", type=int, default=64)
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--no_fill_depth", action="store_true")
    p.add_argument("--train_targets", action="store_true",
                   help="keep the per-point offset targets (train-only)")
    p.add_argument("--compress", action="store_true",
                   help="deflate shards (smaller, slower to read)")
    p.add_argument("--occ", action="store_true",
                   help="pack the Occlusion-LineMOD test split: "
                        "--data_root is an OCCLUSION_LINEMOD checkout "
                        "(evaluate the shards with apps.evaluate "
                        "--packed_dir)")
    p.add_argument("--lm_root", default="",
                   help="with --occ: Linemod_preprocessed checkout for "
                        "object meshes (defaults to --data_root)")
    args = p.parse_args(argv)
    if args.occ and args.dataset != "linemod":
        raise SystemExit("--occ requires --dataset linemod")
    if args.dataset == "ycb":
        from pvn3d_tpu_torch.data.ycb import YCBDataset
        ds = YCBDataset(args.data_root, split="test",
                        fill_depth=not args.no_fill_depth)
    elif args.occ:
        from pvn3d_tpu_torch.data.occlusion_linemod import \
            OcclusionLineMODDataset
        ds = OcclusionLineMODDataset(args.data_root, cls_type=args.cls,
                                     lm_root=args.lm_root or None)
    else:
        from pvn3d_tpu_torch.data.linemod import LineMODDataset
        ds = LineMODDataset(args.data_root, cls_type=args.cls, split="test")
    n = pack_dataset(ds, args.out, shard_size=args.shard_size,
                     max_frames=args.max_frames, workers=args.workers,
                     train_targets=args.train_targets,
                     compress=args.compress)
    print(f"packed {n} frames into {args.out}")


if __name__ == "__main__":
    main()
