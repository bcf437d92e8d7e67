"""The port's dataset path on the host against the JAX package's: the PNG
codec (against PIL) and the gt.yml reader (against PyYAML), the assets,
normals, depth fill, augmentation, frame build, loader, the YCB and
LineMOD datasets on fake trees, the test-set packer and the fake-tree
tool.

The JAX package computes with cv2, PIL and PyYAML, which the port does
without.  Where the port computes the same thing another way, each test
states the bound it holds:

- the depth fill is the port's torch ip_basic on the CPU against JAX's
  cv2 arm: atol 2e-3 m with > 99% of the pixels within 1e-4 m, the
  tolerance of the JAX package's own twin test (tests/test_preprocess.py);
- host augmentation draws from the same ``RandomState`` in the same order
  (its state after each call is equal) and its images lie within one grey
  level of cv2's on >= 99.9% of the pixels.  The port models cv2's
  vectorised uint8 HSV -> RGB, which truncates (equal but for 488 of the
  11.8M HSV triples, one level apart there); cv2 rounds the scalar tail
  of a row past a multiple of its vector width instead, so the test
  images are 128 pixels wide, as 640-pixel frames have no tail.  cv2
  filters kernels of >= 130 taps (the motion blur) by DFT, one level
  apart from a float64 correlation on a few pixels, and a one-level
  difference before the sharpen kernel grows by at most the kernel's
  absolute sum (17 at its sharpest, centre 9 over neighbours -1), so the
  largest difference is held at 17, not 1.  The Gaussian blur is cv2's
  8-bit fixed point, exactly.

JAX's fill and normals are pinned to their numpy arms where the native
C++ twin would run.
"""
import functools
import io
import os
import pickle
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
Image = pytest.importorskip("PIL.Image")
yaml = pytest.importorskip("yaml")
cv2 = pytest.importorskip("cv2")

from pvn3d_tpu.data import augment as jax_aug  # noqa: E402
from pvn3d_tpu.data import depth_completion as jax_dc  # noqa: E402
from pvn3d_tpu.data import frame as jax_frame  # noqa: E402
from pvn3d_tpu.data import linemod as jax_linemod  # noqa: E402
from pvn3d_tpu.data import loader as jax_loader  # noqa: E402
from pvn3d_tpu.data import normals as jax_normals  # noqa: E402
from pvn3d_tpu.data import ycb as jax_ycb  # noqa: E402
from pvn3d_tpu.tools import fake_data as jax_fake  # noqa: E402
from pvn3d_tpu.tools import preprocess_testset as jax_pack  # noqa: E402
from pvn3d_tpu.utils import assets as jax_assets  # noqa: E402

from pvn3d_tpu_torch.data import augment, frame, lm_yaml, png  # noqa: E402
from pvn3d_tpu_torch.data.depth_completion import fill_missing  # noqa: E402
from pvn3d_tpu_torch.data.linemod import LineMODDataset  # noqa: E402
from pvn3d_tpu_torch.data.loader import (DataLoader,  # noqa: E402
                                         prefetch_to_device)
from pvn3d_tpu_torch.data.normals import normals_from_depth_map  # noqa: E402
from pvn3d_tpu_torch.data.ycb import YCBDataset  # noqa: E402
from pvn3d_tpu_torch.tools import fake_data  # noqa: E402
from pvn3d_tpu_torch.tools import preprocess_testset as pack  # noqa: E402
from pvn3d_tpu_torch.utils import assets  # noqa: E402


def _pil_png(arr, mode=None) -> bytes:
    b = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(b, format="png")
    return b.getvalue()


def _pil_read(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.array(im)


def _grad(h, w):
    return (np.add.outer(np.arange(h) * 3, np.arange(w) * 5) % 256).astype(
        np.uint8)


def _arrays():
    rng = np.random.RandomState(0)
    g = _grad(37, 53)
    return {
        "grey": g,
        "grey16": (np.add.outer(np.arange(37) * 700, np.arange(53) * 9)
                   + rng.randint(0, 40, (37, 53))).astype(np.uint16),
        "rgb": np.stack([g, g[::-1], rng.randint(0, 256, g.shape)],
                        -1).astype(np.uint8),
        "rgba": rng.randint(0, 256, (37, 53, 4)).astype(np.uint8),
        "grey_alpha": np.stack([g, g[:, ::-1]], -1),
        "noise_rgb": rng.randint(0, 256, (31, 41, 3)).astype(np.uint8),
        "one_column": rng.randint(0, 256, (9, 1, 3)).astype(np.uint8),
        "one_row": rng.randint(0, 256, (1, 9)).astype(np.uint8),
    }


@pytest.mark.parametrize("name", sorted(_arrays()))
def test_png_reads_pil_files_bit_for_bit(name):
    """PIL's encoder picks each row's filter adaptively, so its files
    exercise all five filters."""
    arr = _arrays()[name]
    data = _pil_png(arr)
    got = png.decode_png(data)
    want = _pil_read(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(_arrays()))
def test_pil_reads_port_files_bit_for_bit(name):
    arr = _arrays()[name]
    np.testing.assert_array_equal(_pil_read(png.encode_png(arr)), arr)


def _filtered_png(img: np.ndarray, kinds) -> bytes:
    """An RGB PNG whose rows use the given filter types (a test encoder,
    straight from the PNG specification)."""
    h, w, c = img.shape
    x = img.astype(np.int32).reshape(h, w * c)
    rows = []
    for r in range(h):
        cur = x[r]
        prev = x[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        k = kinds[r % len(kinds)]
        if k == 0:
            pred = 0
        elif k == 1:
            pred = left
        elif k == 2:
            pred = prev
        elif k == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        rows.append(np.concatenate([[k], (cur - pred) & 0xFF]))
    raw = np.stack(rows).astype(np.uint8).tobytes()
    return _png_file(w, h, 8, 2, 0, raw)


def _png_file(w, h, depth, ctype, interlace, raw: bytes) -> bytes:
    """PNG bytes from an IHDR's fields and the unfiltered image data."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, interlace))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _adam7_png(img: np.ndarray) -> bytes:
    """An interlaced (Adam7) 8-bit grey or RGB PNG of ``img``, each
    pass's rows with filter 0: a valid file, which PIL reads."""
    h, w = img.shape[:2]
    raw = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        sub = img[y0::dy, x0::dx]
        if sub.size:
            rows = sub.reshape(sub.shape[0], -1)
            raw += np.concatenate([np.zeros((len(rows), 1), np.uint8),
                                   rows], 1).tobytes()
    return _png_file(w, h, 8, 0 if img.ndim == 2 else 2, 1, raw)


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,),
                                   (0, 1, 2, 3, 4), (4, 3, 1, 0, 2)])
def test_png_undoes_every_filter(kinds):
    img = np.random.RandomState(len(kinds)).randint(
        0, 256, (23, 17, 3)).astype(np.uint8)
    data = _filtered_png(img, kinds)
    np.testing.assert_array_equal(_pil_read(data), img)
    np.testing.assert_array_equal(png.decode_png(data), img)


def test_png_raises_outside_its_subset():
    data = bytearray(_pil_png(_grad(8, 8)))
    # IHDR's interlace byte is the last of its 13 bytes (offset 8+8+12).
    ihdr = bytes(data[16:29])
    interlaced = ihdr[:12] + b"\x01"
    data_i = (bytes(data[:8]) + struct.pack(">I", 13) + b"IHDR" + interlaced
              + struct.pack(">I", zlib.crc32(b"IHDR" + interlaced))
              + bytes(data[33:]))
    with pytest.raises(png.UnsupportedPNG, match="interlaced"):
        png.decode_png(data_i)
    bad = bytearray(data)
    bad[30] ^= 0xFF                       # inside the CRC of IHDR
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(bad))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="bit depth 3"):
        png.decode_png(_png_file(4, 4, 3, 0, 0, bytes(4 * 3)))


def _unsupported_files():
    img = np.random.RandomState(5).randint(0, 256, (13, 11, 3)).astype(
        np.uint8)
    return {
        "adam7_rgb": (_adam7_png(img), img),
        "adam7_grey": (_adam7_png(img[..., 0]), img[..., 0]),
        "grey_1bit": (_pil_png(img[..., 0] > 127), img[..., 0] > 127),
        "rgb_16bit": (_png_file(2, 1, 16, 2, 0, bytes(13)), None),
    }


@pytest.mark.parametrize("name", sorted(_unsupported_files()))
def test_png_raises_unsupported_for_valid_files_outside_its_subset(name):
    """Valid files the decoder does not read raise ``UnsupportedPNG``, a
    ``NotImplementedError`` and no ``ValueError``: the datasets skip
    corrupt files (``ValueError``) but not these."""
    data, img = _unsupported_files()[name]
    if img is not None:
        np.testing.assert_array_equal(_pil_read(data), img)
    with pytest.raises(png.UnsupportedPNG) as err:
        png.decode_png(data)
    assert isinstance(err.value, NotImplementedError)
    assert not isinstance(err.value, ValueError)


def test_png_bench_files_are_valid():
    """The timing tool's files: its adaptive encoder's rows use several
    filters, and PIL and the port read every file back exactly."""
    from pvn3d_tpu_torch.tools import png_bench
    for img in png_bench.frames(0, 48, 64).values():
        for data in (png.encode_png(img), png_bench.encode_adaptive(img)):
            np.testing.assert_array_equal(_pil_read(data), img)
            np.testing.assert_array_equal(png.decode_png(data), img)
        used = png_bench.row_filters(png_bench.encode_adaptive(img), png)
        assert sum(n > 0 for n in used) >= 2, used


REAL_GT_YML = """0:
- cam_R_m2c: [0.09630630, 0.99404401, 0.05100790, 0.57332098, -0.01350810, -0.81922001, -0.81365103, 0.10814000, -0.57120699]
  cam_t_m2c: [-105.35775150, -117.52119142, 1014.87701320]
  obj_bb: [244, 150, 44, 58]
  obj_id: 1
1:
- cam_R_m2c: [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
  cam_t_m2c: [1.5e+02, -2.0, 3.0]
  obj_bb: [1, 2, 3, 4]
  obj_id: 2
- cam_R_m2c: [0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, -1.0]
  cam_t_m2c: [7, 8, 9]
  obj_bb: [5, 6, 7, 8]
  obj_id: 9
"""


def test_gt_yml_reader_matches_pyyaml(tmp_path):
    """Both forms: real LineMOD's flow lists, and the block lists that
    ``yaml.safe_dump`` (the JAX fake tree) writes."""
    assert lm_yaml.loads(REAL_GT_YML) == yaml.safe_load(REAL_GT_YML)
    root = jax_fake.make_fake_linemod(str(tmp_path), n_frames=3, h=48,
                                      w=64)
    path = os.path.join(root, "data", "01", "gt.yml")
    with open(path) as f:
        want = yaml.safe_load(f)
    assert lm_yaml.load(path) == want
    meta = {i: [{"obj_id": 2, "vals": [1.0e-05, -3.5, 1e20, 0.0],
                 "name": "ape", "flag": True, "none": None}]
            for i in range(2)}
    text = yaml.safe_dump(meta)
    assert lm_yaml.loads(text) == yaml.safe_load(text) == meta


@pytest.mark.parametrize("text", ["a: &x 1", "a: *x", "a: {b: 1}",
                                  "a: 'q'", "a: [[1]]", "a: |\n  x",
                                  "a: !!int 1", "a:\n\t- 1"])
def test_gt_yml_reader_raises_outside_its_subset(text):
    with pytest.raises(ValueError):
        lm_yaml.loads(text)


def test_assets_match_jax():
    for ds, names in (("ycb", range(1, 22)),
                      ("linemod", jax_assets.C.LM_OBJ_DICT)):
        for c in names:
            for kp in ("farthest", "farthest4", "farthest12", "farthest16",
                       "farthest20"):
                np.testing.assert_array_equal(
                    assets.get_kps(c, kp, ds), jax_assets.get_kps(c, kp, ds))
            np.testing.assert_array_equal(assets.get_corners(c, ds),
                                          jax_assets.get_corners(c, ds))
            np.testing.assert_array_equal(assets.get_ctr(c, ds),
                                          jax_assets.get_ctr(c, ds))
    np.testing.assert_array_equal(assets.stacked_mesh_kps(),
                                  jax_assets.stacked_mesh_kps("ycb"))
    np.testing.assert_array_equal(
        assets.stacked_mesh_kps(2, "linemod", "farthest4"),
        jax_assets.stacked_mesh_kps("linemod", 2, "farthest4"))
    for ds in ("ycb", "linemod"):
        np.testing.assert_array_equal(assets.stacked_class_radii(ds, 2 if
                                      ds == "linemod" else 22),
                                      jax_assets.stacked_class_radii(
                                          ds, 2 if ds == "linemod" else 22))
    assert assets.lm_diameters() == jax_assets.lm_diameters()


def test_meshes_match_jax(tmp_path):
    ycb = jax_fake.make_fake_ycb(str(tmp_path), n_frames=1, h=48, w=64,
                                 cls_ids=(1, 2))
    lm = jax_fake.make_fake_linemod(str(tmp_path), n_frames=1, h=48, w=64)
    for c in (1, 2):
        np.testing.assert_array_equal(
            assets.load_mesh_points(ycb, c, "ycb", max_points=300, seed=3),
            jax_assets.load_mesh_points(ycb, c, "ycb", max_points=300,
                                        seed=3))
    np.testing.assert_array_equal(
        assets.load_mesh_points(lm, 1, "linemod"),
        jax_assets.load_mesh_points(lm, 1, "linemod"))
    for got, want in zip(assets.stacked_mesh_points(lm, "linemod", 2),
                         jax_assets.stacked_mesh_points(lm, "linemod", 2)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tag,end", [("binary_little_endian", "<"),
                                     ("binary_big_endian", ">"),
                                     ("ascii", "")])
def test_read_ply_vertices_matches_jax(tmp_path, tag, end):
    verts = np.array([[1.5, -2.25, 3.0], [0.125, 4.5, -6.0]], np.float32)
    hdr = (f"ply\nformat {tag} 1.0\nelement vertex 2\nproperty float x\n"
           "property float y\nproperty float z\nproperty uchar red\n"
           "end_header\n").encode()
    if end:
        dt = np.dtype([("x", end + "f4"), ("y", end + "f4"),
                       ("z", end + "f4"), ("red", "u1")])
        rec = np.zeros(2, dt)
        rec["x"], rec["y"], rec["z"] = verts.T
        body = rec.tobytes()
    else:
        body = "".join(f"{x} {y} {z} 7\n" for x, y, z in verts).encode()
    p = str(tmp_path / "m.ply")
    with open(p, "wb") as f:
        f.write(hdr + body)
    np.testing.assert_array_equal(assets.read_ply_vertices(p), verts)
    np.testing.assert_array_equal(jax_assets.read_ply_vertices(p), verts)


def _holey_depth(seed=0, h=120, w=160):
    rng = np.random.RandomState(seed)
    depth = np.full((h, w), 10000, np.uint16)
    depth[20:60, 30:90] = 8000
    depth[70:110, 100:150] = 25000
    for _ in range(25):
        r, c = rng.randint(0, h - 12), rng.randint(0, w - 12)
        depth[r:r + rng.randint(2, 12), c:c + rng.randint(2, 12)] = 0
    depth[:6, 40:60] = 0                        # columns empty at the top
    return depth.astype(np.float32)


def test_normals_match_jax_numpy_arm():
    d = _holey_depth(1) / 10000.0
    k = np.array([[572.4, 0, 80.0], [0, 573.5, 60.0], [0, 0, 1]],
                 np.float32)
    np.testing.assert_array_equal(
        normals_from_depth_map(d, k, impl="numpy"),
        jax_normals.normals_from_depth_map(d, k, impl="numpy"))
    np.testing.assert_array_equal(
        normals_from_depth_map(d * 1000, k, cam_scale=1000.0, smooth=0,
                               impl="numpy"),
        jax_normals.normals_from_depth_map(d * 1000, k, cam_scale=1000.0,
                                           smooth=0, impl="numpy"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fill_missing_matches_the_cv2_arm(seed):
    d = _holey_depth(seed)
    got = fill_missing(d, 10000.0, impl="torch")
    want = jax_dc.fill_missing(d, 10000.0, 1.0, impl="numpy")
    assert got.dtype == np.float32 and got.shape == want.shape
    err = np.abs(got - want) / 10000.0
    assert err.max() <= 2e-3
    assert (err <= 1e-4).mean() > 0.99
    # The default, the C++ twin, at the JAX package's twin tolerance.
    np.testing.assert_allclose(fill_missing(d, 10000.0) / 10000.0,
                               want / 10000.0, atol=1e-4)


def _image(seed, h=48, w=128):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    smooth = np.stack([(xx * 3 + yy * 2) % 256, (xx * 2 + 50) % 256,
                       (yy * 4) % 256], -1)
    noise = rng.randint(0, 256, (h, w, 3))
    return np.where(rng.rand(h, w, 1) < 0.5, smooth, noise).astype(np.uint8)


def test_hsv_conversions_match_cv2():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (400, 512, 3)).astype(np.uint8)
    for bgr, code in ((False, cv2.COLOR_RGB2HSV), (True, cv2.COLOR_BGR2HSV)):
        np.testing.assert_array_equal(augment.rgb_to_hsv_u8(img, bgr=bgr),
                                      cv2.cvtColor(img, code))
    hsv = np.stack([rng.randint(0, 180, (400, 512)),
                    rng.randint(0, 256, (400, 512)),
                    rng.randint(0, 256, (400, 512))], -1).astype(np.uint8)
    for bgr, code in ((False, cv2.COLOR_HSV2RGB), (True, cv2.COLOR_HSV2BGR)):
        d = np.abs(augment.hsv_to_rgb_u8(hsv, bgr=bgr).astype(int)
                   - cv2.cvtColor(hsv, code))
        assert d.max() <= 1 and (d > 0).any(-1).mean() < 1e-4


def test_motion_blur_kernels_match_cv2_line():
    """Every kernel the noise stacks can draw (angle 0-359, length
    1-15), rasterised as cv2.line draws them."""
    for ang in range(360):
        for length in range(1, 16):
            rad = np.deg2rad(ang)
            a = int(max(abs(np.cos(rad)), abs(np.sin(rad))) * length * 2)
            want = np.zeros((a, a), np.float32)
            c = a // 2
            cv2.line(want, (c, c), (int(np.cos(rad) * length + c),
                                    int(np.sin(rad) * length + c)), 1.0)
            s = want.sum()
            if s == 0:
                want[c, c] = 1.0
            else:
                want /= s
            np.testing.assert_array_equal(
                augment.motion_blur_kernel(ang, length), want)


def _close_to_cv2(got, want, max_diff=17):
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= max_diff, d.max()
    assert (d <= 1).mean() >= 0.999, (d <= 1).mean()


@pytest.mark.parametrize("fn", ["color_jitter", "rgb_add_noise_ycb",
                                "rgb_add_noise_lm"])
def test_host_augmentation_matches_jax(fn):
    """Same draws (equal RandomState after each call) and images within
    one grey level of the cv2 stack on >= 99.9% of pixels, over seeds
    that take every branch."""
    seen = 0
    for seed in range(12):
        img = _image(seed)
        r_port, r_jax = (np.random.RandomState(seed) for _ in range(2))
        got = getattr(augment, fn)(r_port, img)
        want = getattr(jax_aug, fn)(r_jax, img)
        assert str(r_port.get_state()) == str(r_jax.get_state())
        assert got.dtype == want.dtype == np.uint8
        _close_to_cv2(got, want)
        seen += 1
    assert seen == 12


def test_filters_match_cv2():
    img = _image(3, 90, 120)
    k = -np.ones((3, 3), np.float32)
    k[1, 1] = 10.7
    k /= k.sum()
    _close_to_cv2(augment.filter2d(img, k), cv2.filter2D(img, -1, k), 1)
    for ang, length in ((37, 15), (0, 4), (200, 9), (300, 13)):
        _close_to_cv2(augment.linear_motion_blur(img, ang, length),
                      jax_aug.linear_motion_blur(img, ang, length), 1)
    for ksz, sigma in ((3, 0.3), (5, 0.9), (3, 0.01), (5, 0.05),
                       (3, 0.99)):
        np.testing.assert_array_equal(
            augment.gaussian_blur(img, ksz, sigma),
            cv2.GaussianBlur(img, (ksz, ksz), sigma))


def test_add_real_back_is_exact():
    rng = np.random.RandomState(4)
    rgb = rng.rand(30, 40, 3).astype(np.float32) * 255
    labels = (rng.rand(30, 40) < 0.3).astype(np.uint8)
    depth = rng.rand(30, 40).astype(np.float32) * (rng.rand(30, 40) < 0.7)
    back_rgb = rng.randint(0, 256, (30, 40, 3)).astype(np.uint8)
    back_depth = rng.rand(30, 40).astype(np.float32)
    back_label = (rng.rand(30, 40) < 0.2).astype(np.uint8)
    args = (rgb, labels, depth, depth > 1e-6, back_rgb, back_depth,
            back_label)
    for got, want in zip(augment.add_real_back(*args),
                         jax_aug.add_real_back(*args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_valid,n_sample", [(100, 300), (900, 300),
                                              (300_000, 12288), (5000, 512)])
def test_sample_point_budget_matches_jax(n_valid, n_sample):
    a, b = np.random.RandomState(7), np.random.RandomState(7)
    np.testing.assert_array_equal(
        frame.sample_point_budget(n_valid, n_sample, a),
        jax_frame.sample_point_budget(n_valid, n_sample, b))
    assert str(a.get_state()) == str(b.get_state())


def _instances():
    from pvn3d_tpu.utils.assets import get_ctr, get_kps
    out = []
    for j, c in enumerate((1, 5, 9)):
        rt = np.concatenate([np.eye(3, dtype=np.float32)[[1, 0, 2]],
                             [[0.05 * j], [0.02], [0.9]]], axis=1)
        out.append((c, rt, get_kps(c), get_ctr(c)))
    return out


@pytest.mark.parametrize("spec", [
    dict(n_sample_points=512), dict(n_sample_points=4096, keep_depth=True),
    dict(n_sample_points=512, device_preprocess=True)])
def test_build_frame_matches_jax(spec, monkeypatch):
    monkeypatch.setattr(jax_frame, "normals_from_depth_map",
                        functools.partial(jax_normals.normals_from_depth_map,
                                          impl="numpy"))
    monkeypatch.setattr(frame, "normals_from_depth_map", functools.partial(
        normals_from_depth_map, impl="numpy"))
    rng = np.random.RandomState(2)
    depth = _holey_depth(2) / 10000.0
    label = np.zeros(depth.shape, np.uint8)
    label[20:60, 30:90] = 5
    label[70:110, 100:150] = 9
    rgb = rng.randint(0, 256, depth.shape + (3,)).astype(np.float32)
    k = np.array([[572.4, 0, 80.0], [0, 573.5, 60.0], [0, 0, 1]],
                 np.float32)
    a, b = np.random.RandomState(5), np.random.RandomState(5)
    got = frame.build_frame(rgb, depth, label, k, 1.0, _instances(),
                            frame.FrameSpec(**spec), a)
    want = jax_frame.build_frame(rgb, depth, label, k, 1.0, _instances(),
                                 jax_frame.FrameSpec(**spec), b)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    few = np.zeros_like(depth)
    few[:5, :5] = 1.0
    assert frame.build_frame(rgb, few, label, k, 1.0, _instances(),
                             frame.FrameSpec(**spec), a) is None


# ---------------------------------------------------------------------------
# Datasets on fake trees
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The JAX tool's YCB tree (2 real + 2 synthetic frames) and the
    port's LineMOD tree with render and fuse items (3 real, 2 + 2)."""
    root = str(tmp_path_factory.mktemp("trees"))
    ycb = jax_fake.make_fake_ycb(root, n_frames=4)
    lm = fake_data.make_fake_linemod(root, n_frames=3, n_renders=2)
    return ycb, lm


@pytest.fixture
def jax_numpy_arms(monkeypatch):
    """Both packages' host builds on their numpy normals; the JAX fill on
    cv2 (the port's default fill is its C++ twin, within 1e-4 of it)."""
    monkeypatch.setattr(jax_frame, "normals_from_depth_map",
                        functools.partial(jax_normals.normals_from_depth_map,
                                          impl="numpy"))
    monkeypatch.setattr(frame, "normals_from_depth_map", functools.partial(
        normals_from_depth_map, impl="numpy"))
    monkeypatch.setattr(jax_ycb, "fill_missing", functools.partial(
        jax_dc.fill_missing, impl="numpy"))


def _assert_samples_equal(got, want, exact=True):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        if exact:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _ycb(cls, ycb, split, **kw):
    spec = cls.__module__.startswith("pvn3d_tpu_torch")
    spec_cls = frame.FrameSpec if spec else jax_frame.FrameSpec
    return cls(ycb, split=split, file_list=os.path.join(ycb,
                                                        "image_list.txt"),
               spec=spec_cls(n_sample_points=2048, **kw.pop("spec", {})),
               **kw)


def test_ycb_test_split_equals_jax_without_fill(trees, jax_numpy_arms):
    ycb, _ = trees
    port = _ycb(YCBDataset, ycb, "test", fill_depth=False)
    ref = _ycb(jax_ycb.YCBDataset, ycb, "test", fill_depth=False)
    for i in range(len(ref)):
        _assert_samples_equal(port[i], ref[i])


def test_ycb_test_split_with_fill_matches_jax(trees, jax_numpy_arms):
    """The fill at its tolerance; everything but the filled cloud equal,
    and the port's normals equal JAX's numpy normals of the port's own
    filled depth."""
    ycb, _ = trees
    port = _ycb(YCBDataset, ycb, "test", spec={"keep_depth": True})
    ref = _ycb(jax_ycb.YCBDataset, ycb, "test", spec={"keep_depth": True})
    for i in (0, 1):
        got, want = port[i], ref[i]
        _assert_samples_equal(got, want, exact=False)
        for key in ("choose", "labels", "rgb", "cls_ids", "rts", "kp_3ds",
                    "ctr_3ds", "cam_k", "label_map"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        derr = np.abs(got["depth"] - want["depth"])
        assert derr.max() <= 2e-3 and (derr <= 1e-4).mean() > 0.99
        np.testing.assert_allclose(got["pointcloud"][:, :3],
                                   want["pointcloud"][:, :3], atol=2e-3)
        np.testing.assert_array_equal(got["pointcloud"][:, 3:6],
                                      want["pointcloud"][:, 3:6])
        nrm = jax_normals.normals_from_depth_map(
            got["depth"], got["cam_k"], impl="numpy").reshape(-1, 3)
        np.testing.assert_array_equal(got["pointcloud"][:, 6:],
                                      nrm[got["choose"]])
        for key in ("kp_targ_ofst", "ctr_targ_ofst"):
            np.testing.assert_allclose(got[key], want[key], atol=2e-3)


def test_ycb_train_split_matches_jax(trees, jax_numpy_arms):
    """Same items and draws (RandomState equal after every item); the
    augmented images within the host augmentation's bound, the rest
    equal (no fill, so the cloud is exact)."""
    ycb, _ = trees
    port = _ycb(YCBDataset, ycb, "train", fill_depth=False, seed=3)
    ref = _ycb(jax_ycb.YCBDataset, ycb, "train", fill_depth=False, seed=3)
    for i in range(6):
        got, want = port[i], ref[i]
        assert str(port.rng.get_state()) == str(ref.rng.get_state())
        for key in ("choose", "labels", "cls_ids", "rts", "kp_3ds",
                    "ctr_3ds", "kp_targ_ofst", "ctr_targ_ofst"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        np.testing.assert_array_equal(got["pointcloud"][:, [0, 1, 2, 6, 7,
                                                            8]],
                                      want["pointcloud"][:, [0, 1, 2, 6, 7,
                                                             8]])
        _close_to_cv2(got["rgb"], want["rgb"])


def test_ycb_raw_train_items_equal_jax(trees):
    ycb, _ = trees
    port = _ycb(YCBDataset, ycb, "train", seed=4,
                spec={"device_preprocess": True})
    ref = _ycb(jax_ycb.YCBDataset, ycb, "train", seed=4,
               spec={"device_preprocess": True})
    for i in range(4):
        _assert_samples_equal(port[i], ref[i])
        assert str(port.rng.get_state()) == str(ref.rng.get_state())


def _lm(cls, lm, split, **kw):
    spec_cls = (frame.FrameSpec if cls.__module__.startswith(
        "pvn3d_tpu_torch") else jax_frame.FrameSpec)
    return cls(lm, cls_type="ape", split=split,
               spec=spec_cls(n_sample_points=1024, **kw.pop("spec", {})),
               **kw)


def test_linemod_test_split_equals_jax(trees, jax_numpy_arms):
    _, lm = trees
    port, ref = _lm(LineMODDataset, lm, "test"), _lm(
        jax_linemod.LineMODDataset, lm, "test")
    assert port.meta_lst == ref.meta_lst
    for i in range(len(ref)):
        _assert_samples_equal(port[i], ref[i])


def test_linemod_train_split_matches_jax(trees, jax_numpy_arms):
    """Real, render and fuse items: the same draws; rgb within the
    augmentation's bound, the rest equal."""
    _, lm = trees
    port = _lm(LineMODDataset, lm, "train", seed=1)
    ref = _lm(jax_linemod.LineMODDataset, lm, "train", seed=1)
    assert port.all_lst == ref.all_lst and len(port.fuse_lst) == 2
    for i in range(8):
        got, want = port[i], ref[i]
        assert str(port.rng.get_state()) == str(ref.rng.get_state())
        for key in ("choose", "labels", "rts", "kp_targ_ofst"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        _close_to_cv2(np.clip(got["rgb"], 0, 255).astype(np.uint8),
                      np.clip(want["rgb"], 0, 255).astype(np.uint8))


def test_linemod_raw_train_items_equal_jax(trees):
    _, lm = trees
    port = _lm(LineMODDataset, lm, "train", seed=2,
               spec={"device_preprocess": True})
    ref = _lm(jax_linemod.LineMODDataset, lm, "train", seed=2,
              spec={"device_preprocess": True})
    kinds = set()
    for i in range(8):
        got, want = port[i], ref[i]
        _assert_samples_equal(got, want)
        kinds.add((bool(got["is_syn"]), bool(got["do_jitter"])))
    assert len(kinds) >= 2


@pytest.mark.parametrize("dataset,split", [
    ("ycb", "test"), ("ycb", "train"), ("linemod", "test"),
    ("linemod", "train")])
def test_interlaced_frame_raises_instead_of_being_skipped(tmp_path, dataset,
                                                          split):
    """A colour image in a form the decoder does not read stops the split:
    a test split would otherwise score fewer frames without a word, and a
    train split whose files all fail would draw forever."""
    if dataset == "ycb":
        root = fake_data.make_fake_ycb(str(tmp_path), n_frames=4, h=24,
                                       w=32, cls_ids=(1, 2))
        ds = YCBDataset(root, split=split, file_list=os.path.join(
            root, "image_list.txt"), spec=frame.FrameSpec(
                n_sample_points=64), fill_depth=False)
        names = _read_list(os.path.join(root, "image_list.txt"))
        paths = [os.path.join(root, n + "-color.png") for n in names]
    else:
        root = fake_data.make_fake_linemod(str(tmp_path), n_frames=3, h=24,
                                           w=32)
        ds = LineMODDataset(root, "ape", split=split,
                            spec=frame.FrameSpec(n_sample_points=64))
        rgb_dir = os.path.join(root, "data", "01", "rgb")
        paths = [os.path.join(rgb_dir, n) for n in os.listdir(rgb_dir)]
    for path in paths:
        img = png.read_png(path)
        with open(path, "wb") as f:
            f.write(_adam7_png(img))
    with pytest.raises(png.UnsupportedPNG, match="interlaced"):
        ds[0]


def _read_list(path):
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def test_fake_trees_decode_equal_to_jax(tmp_path):
    import scipy.io as scio
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_fake.make_fake_linemod(a, 2, h=96, w=128, seed=3)
    jax_fake.make_fake_ycb(a, 3, h=96, w=128, seed=3)
    fake_data.make_fake_linemod(b, 2, h=96, w=128, seed=3)
    fake_data.make_fake_ycb(b, 3, h=96, w=128, seed=3)
    n = 0
    for d, _, files in os.walk(a):
        for f in files:
            pa = os.path.join(d, f)
            pb = pa.replace(a, b)
            if f.endswith(".png"):
                with Image.open(pa) as im:
                    np.testing.assert_array_equal(png.read_png(pb),
                                                  np.array(im))
            elif f.endswith(".yml"):
                with open(pa) as fa, open(pb) as fb:
                    assert yaml.safe_load(fa) == yaml.safe_load(fb) == \
                        lm_yaml.load(pb)
            elif f.endswith(".mat"):
                ma, mb = scio.loadmat(pa), scio.loadmat(pb)
                for k in ("factor_depth", "cls_indexes", "poses"):
                    np.testing.assert_array_equal(ma[k], mb[k])
            else:
                with open(pa) as fa, open(pb) as fb:
                    assert fa.read() == fb.read(), f
            n += 1
    assert n == 28


def test_render_items_are_read_by_jax(trees):
    _, lm = trees
    ref = jax_linemod.LineMODDataset(lm, "ape", split="train",
                                     spec=jax_frame.FrameSpec(
                                         n_sample_points=512))
    for path in ref.rnd_lst + ref.fuse_lst:
        with open(path, "rb") as f:
            assert pickle.load(f)["rnd_typ"] in ("render", "fuse")
        assert ref.get_item(path) is not None


def test_loader_batches_match_jax_and_workers(trees, jax_numpy_arms):
    """Host-built test batches equal to the JAX loader's, with the last
    batch padded and its ``_n_valid`` as JAX's; and the same batches with
    0 and 2 spawned workers where a test item draws nothing (raw items:
    a worker reseeds its dataset's stream, so sampled items depend on
    which worker builds them, in both packages)."""
    ycb, _ = trees
    kw = dict(split="test", fill_depth=False,
              file_list=os.path.join(ycb, "image_list.txt"))
    port_f = functools.partial(YCBDataset, ycb, spec=frame.FrameSpec(
        n_sample_points=1024), **kw)
    jax_f = functools.partial(jax_ycb.YCBDataset, ycb,
                              spec=jax_frame.FrameSpec(n_sample_points=1024),
                              **kw)

    def equal(got, want):
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        assert got[-1]["_n_valid"] == want[-1]["_n_valid"] == 1

    equal(list(DataLoader(port_f, 3)), list(jax_loader.DataLoader(jax_f, 3)))
    raw_f = functools.partial(YCBDataset, ycb, spec=frame.FrameSpec(
        device_preprocess=True), **kw)
    equal(list(DataLoader(raw_f, 3, num_workers=2)),
          list(DataLoader(raw_f, 3)))


def test_prefetch_to_device_on_the_cpu():
    batches = [{"a": np.arange(6).reshape(2, 3) + i, "flag": np.ones(2,
                bool), "_n_valid": 1} for i in range(5)]
    out = list(prefetch_to_device(iter(batches), "cpu",
                                  host_keys=("flag",)))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert torch.equal(b["a"], torch.as_tensor(batches[i]["a"]))
        assert isinstance(b["flag"], np.ndarray) and b["_n_valid"] == 1


def test_packed_shards_read_by_both_packages(trees, tmp_path,
                                             jax_numpy_arms):
    """The port reads shards the JAX packer wrote and the JAX reader reads
    the port's; both equal the samples."""
    ycb, _ = trees
    kw = dict(split="test", fill_depth=False,
              file_list=os.path.join(ycb, "image_list.txt"))
    port_ds = YCBDataset(ycb, spec=frame.FrameSpec(n_sample_points=1024),
                         **kw)
    jax_ds = jax_ycb.YCBDataset(ycb, spec=jax_frame.FrameSpec(
        n_sample_points=1024), **kw)
    pa, pb = str(tmp_path / "port"), str(tmp_path / "jax")
    assert pack.pack_dataset(port_ds, pa, shard_size=3) == 4
    assert jax_pack.pack_dataset(jax_ds, pb, shard_size=3) == 4
    fresh = YCBDataset(ycb, spec=frame.FrameSpec(n_sample_points=1024),
                       **kw)
    samples = [fresh[i] for i in range(4)]
    for reader in (pack.iter_packed_batches, jax_pack.iter_packed_batches):
        for src in (pa, pb):
            got = list(reader(src, 2))
            assert len(got) == 2 and "kp_targ_ofst" not in got[0]
            for i, b in enumerate(got):
                for j in range(2):
                    s = samples[2 * i + j]
                    np.testing.assert_array_equal(b["pointcloud"][j],
                                                  s["pointcloud"])
                    np.testing.assert_array_equal(b["rgb"][j], s["rgb"])
    tail = list(pack.iter_packed_batches(pa, 3))
    want = list(jax_pack.iter_packed_batches(pb, 3))
    assert tail[-1]["_n_valid"] == want[-1]["_n_valid"] == 1
    with pytest.raises(SystemExit, match="--occ requires --dataset linemod"):
        pack.main(["--data_root", ycb, "--out", pa, "--occ"])
