"""Time PNG decoding (``data/png.py``) on the host.

Encodes a 480x640 RGB frame and a 480x640 16-bit depth frame, made from
a seed, two ways: every row with filter 0, as the port's ``write_png``
writes them, and each row with the filter whose bytes have the least
absolute sum as signed values, the heuristic of libpng's and PIL's
encoders (so mostly Paeth, Up and Average rows, as in the datasets'
files).  Decodes each file ``--repeat`` times with the ``data/png.py`` of
the checkout ``--root`` (this one by default), checks every decode
against the image, and prints a JSON line a file with the median and
the least time::

    python -m pvn3d_tpu_torch.tools.png_bench [--root CHECKOUT] [--label x]

Two checkouts compare in turns on one host (parent, change, change,
parent), each run with its own ``--root``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import struct
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load_png(root: str):
    """``data/png.py`` of the checkout ``root`` (it imports only numpy and
    the standard library)."""
    path = os.path.join(root, "pvn3d_tpu_torch", "data", "png.py")
    spec = importlib.util.spec_from_file_location("png_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def frames(seed: int = 0, h: int = 480, w: int = 640):
    """A camera-like RGB frame (smooth shading and sensor noise) and a
    depth frame in 0.1 mm (a tilted plane, noise and dropout holes)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    shade = 90 + 60 * np.sin(xx / 47.0) * np.cos(yy / 61.0)
    rgb = np.stack([shade + 40 * np.sin(xx / 13.0), shade,
                    shade + 0.1 * yy], -1) + rng.normal(0, 3, (h, w, 3))
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    depth = 8000 + 4 * xx + 6 * yy + rng.normal(0, 8, (h, w))
    for _ in range(40):
        r, c = rng.randint(0, h - 12), rng.randint(0, w - 12)
        depth[r:r + rng.randint(2, 12), c:c + rng.randint(2, 12)] = 0
    return {"rgb": rgb, "depth16": depth.astype(np.uint16)}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_adaptive(img: np.ndarray) -> bytes:
    """PNG bytes of an RGB uint8 or grey uint16 image, each row with the
    filter of least absolute signed sum."""
    h, w = img.shape[:2]
    if img.dtype == np.uint16:
        ctype, depth, bpp = 0, 16, 2
        rows = img.astype(">u2").view(np.uint8).reshape(h, -1)
    else:
        ctype, depth, bpp = 2, 8, 3
        rows = img.reshape(h, -1)
    x = rows.astype(np.int32)
    up = np.vstack([np.zeros_like(x[:1]), x[:-1]])
    left = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]
    ul = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
    preds = (0, left, up, (left + up) >> 1, _paeth(left, up, ul))
    filt = np.stack([(x - p) & 0xFF for p in preds]).astype(np.uint8)
    cost = np.abs(filt.view(np.int8).astype(np.int32)).sum(-1)
    kinds = cost.argmin(0)
    raw = np.concatenate([kinds[:, None].astype(np.uint8),
                          filt[kinds, np.arange(h)]], 1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def row_filters(data: bytes, png) -> list:
    """How many rows use each of the five filters."""
    idat = b"".join(b for k, b in png._chunks(data) if k == b"IDAT")
    w, h, depth, ctype = struct.unpack(">IIBB", data[16:26])
    row = w * {0: 1, 2: 3}[ctype] * depth // 8 + 1
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, row)
    return np.bincount(raw[:, 0], minlength=5).tolist()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=ROOT,
                   help="checkout whose data/png.py decodes")
    p.add_argument("--label", default="")
    p.add_argument("--repeat", type=int, default=9)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    png = _load_png(args.root)
    enc = _load_png(ROOT)
    for name, img in frames(args.seed).items():
        for filters, data in (("none", enc.encode_png(img)),
                              ("adaptive", encode_adaptive(img))):
            if not np.array_equal(png.decode_png(data), img):
                raise AssertionError(f"{name} ({filters}) decodes wrong")
            ms = []
            for _ in range(args.repeat):
                t0 = time.perf_counter()
                png.decode_png(data)
                ms.append((time.perf_counter() - t0) * 1e3)
            print(json.dumps({
                "label": args.label, "image": f"{name} {img.shape[1]}x"
                f"{img.shape[0]}", "filters": filters,
                "row_filters": row_filters(data, enc), "bytes": len(data),
                "ms_median": statistics.median(ms), "ms_min": min(ms),
                "repeat": args.repeat, "cpus": os.cpu_count()}), flush=True)


if __name__ == "__main__":
    main()
