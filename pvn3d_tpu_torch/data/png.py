"""PNG reading and writing on ``zlib`` and numpy.

The JAX package reads and writes the datasets' PNGs with PIL
(``data/ycb.py``, ``data/linemod.py``, ``tools/fake_data.py``).  This
module does the same with the standard library's ``zlib`` and numpy, and
returns what ``np.array(PIL.Image.open(path))`` returns:

- colour type 0 (grey) at 8 or 16 bits: (H, W) uint8 or uint16;
- 2 (RGB): (H, W, 3) uint8; 6 (RGB + alpha): (H, W, 4);
- 4 (grey + alpha): (H, W, 2);
- 3 (palette) at 8 bits: the (H, W) uint8 palette indices, as PIL's
  mode "P" gives them.

16-bit samples are big-endian in the file.  A valid file this module
does not decode (interlaced, or another bit depth) raises
``UnsupportedPNG``, a ``NotImplementedError``; a missing file raises
``OSError`` and a corrupt one ``ValueError``, so the datasets, which
skip missing and corrupt files as the JAX package's do, never skip an
unsupported one.  ``write_png`` writes grey (uint8 or uint16), grey +
alpha, RGB or RGBA arrays, every row with filter 0.

Decoding undoes the five scanline filters.  Average and Paeth predict
each byte from its left neighbour, so a row cannot be undone in one
vector step.  The bytes are undone along anti-diagonals instead: pixel x
of row r needs only pixels x-1 of row r and x-1, x of row r-1, so every
pixel with r + x = t is ready at step t, whatever each row's filter.
That is W + H - 1 vector steps a file, the same for every mix of filters
(``tools/png_bench.py`` times it).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# colour type -> the bit depths the PNG specification allows
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


class UnsupportedPNG(NotImplementedError):
    """A valid PNG file in a form this module does not decode."""


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk header")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG file has no IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filt: np.ndarray, kinds: np.ndarray, bpp: int,
                        width: int) -> np.ndarray:
    """Any mix of the five filters, by anti-diagonals of pixels."""
    h, w = filt.shape[0], width
    # Flat pixel rows; the reconstruction has one zero row above and one
    # zero pixel to the left, so pixel (r, x) sits at (r + 1)(w + 1) +
    # x + 1.  Along an anti-diagonal r + x = t both flat indices advance
    # by a constant step, so each step reads and writes strided views.
    f = filt.reshape(h * w, bpp).astype(np.int32)
    rec = np.zeros(((h + 1) * (w + 1), bpp), np.int32)
    k = kinds.astype(np.int32)[:, None]
    for t in range(w + h - 1):
        r0, r1 = max(0, t - w + 1), min(h - 1, t)
        at = r0 * w + t + w + 2
        cur = slice(at, r1 * w + t + w + 3, w)
        a = rec[at - 1:r1 * w + t + w + 2:w]               # left
        b = rec[at - w - 1:r1 * w + t + 2:w]               # above
        c = rec[at - w - 2:r1 * w + t + 1:w]               # above left
        kr = k[r0:r1 + 1]
        pred = np.where(kr == 1, a, np.where(kr == 2, b, np.where(
            kr == 3, (a + b) >> 1, np.where(kr == 4, _paeth(a, b, c), 0))))
        rec[cur] = (f[r0 * (w - 1) + t:r1 * (w - 1) + t + 1:max(w - 1, 1)]
                    + pred) & 0xFF
    rec = rec.reshape(h + 1, w + 1, bpp)
    return rec[1:, 1:].reshape(h, w * bpp).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of PNG file bytes ``data`` (see the module docstring)."""
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    width, height, depth, ctype, comp, filt_method, interlace = header
    if ctype not in _DEPTHS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"invalid PNG colour type {ctype} at bit depth "
                         f"{depth}")
    if comp != 0 or filt_method != 0 or interlace not in (0, 1):
        raise ValueError("invalid PNG compression, filter or interlace "
                         "method")
    if interlace:
        raise UnsupportedPNG("interlaced PNG files are not supported")
    if not (depth == 8 or (depth == 16 and ctype == 0)):
        raise UnsupportedPNG(f"PNG bit depth {depth} for colour type "
                             f"{ctype} is not supported")
    chans = _CHANNELS[ctype]
    bpp = chans * depth // 8
    row = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (row + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected "
                         f"{height * (row + 1)}")
    raw = raw.reshape(height, row + 1)
    kinds = raw[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(kinds.max())}")
    filt = raw[:, 1:]
    out = _unfilter(filt, kinds, bpp, width)
    if depth == 16:
        return out.reshape(height, width, 2).view(">u2")[..., 0].astype(
            np.uint16)
    out = out.reshape(height, width, chans)
    return out[..., 0] if chans == 1 else out


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of a (H, W) uint8 / uint16 grey image or an (H, W, C)
    uint8 image with C = 2 (grey + alpha), 3 (RGB) or 4 (RGBA)."""
    img = np.asarray(img)
    if img.ndim == 2 and img.dtype == np.uint16:
        ctype, depth = 0, 16
        rows = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    elif img.dtype == np.uint8 and (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] in (2, 3, 4))):
        ctype = 0 if img.ndim == 2 else {2: 4, 3: 2, 4: 6}[img.shape[2]]
        depth = 8
        rows = img.reshape(img.shape[0], -1)
    else:
        raise ValueError(f"cannot write a {img.dtype} array of shape "
                         f"{img.shape} as PNG")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
