"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each logs lines tagged with its name; the script stops at the first
that fails):

1. device    — the card's ``nvidia-smi`` name and power limit; no CUDA
               exits 1.
2. build     — all five CUDA kernels from ``pvn3d_tpu_torch/csrc`` (one
               ``nvcc`` per source, all at once) into ``build/kernels``.
3. kernels   — each kernel against its plain PyTorch version on the card
               at the shapes the serving path gives it (indices exact,
               floats within 1e-5), timed with CUDA events beside the
               plain version, a library call where one computes the same
               function (K2: cdist + where + topk; K3: cdist + topk +
               gather), and the bound the card's peak rates set; K1's time
               per step and K2's and K3's times per level are logged, each
               also as device time from a ``torch.profiler`` trace (the
               kernel without the host's launch cost); K3 forward logs
               each level's grid and bound.  K3's backward kernel is held
               bit for bit against its plain version at the training
               step's shapes (batch 4, fp3 .. fp0), run twice for
               determinism, and timed per level beside ``index_add_``, on
               depth-camera clouds and on the training batch's own clouds
               (``synthetic_batch``, whose clusters give lists of ~1800
               hits); K1, K2 and K3 forward are checked once more at
               batch 4 on both.  K4 is held bit for bit (twice) and
               timed per pass (H = 21, 21, 168 at K = 512: grid, valid
               points, events, device, bound, plain, and cdist + lt +
               sum + argmax as the library yardstick) on synthetic votes
               (every hypothesis 70% valid) and on the three passes' own
               inputs, captured from the pose stage on labelled votes.
4. edge      — the same comparison at shapes off the main paths, among
               them the edge cases of K1's cluster split, K2's 32-point
               runs, K3's lane split and tie order, and K3 backward's
               tiles, long lists and scalar instances, and K4's
               cluster shares, ties, tiles and empty hypotheses.
5. slice     — the serving path at full width (``Config.ycb()``:
               480x640, 12288 points, 22 classes) with seeded random
               weights: three requests through ``make_inference_step``
               with every launch count set to 0 just before and read just
               after; poses finite, some class present, every kernel
               launched.
6. raw       — raw RGB-D frames at full width (``synth_sensor_frame``,
               480x640) through ``make_raw_inference_step``: three
               requests with every launch count set to 0 just before and
               read just after (fps 1, query 4, interp 4, winner 3 a
               request, no backward); poses finite, some class present.
               The frame build's stages by CUDA events (fill, normals +
               cloud, sample + gather) and its launches and device time
               in a profiler trace; the card's frame build against the
               CPU's on the same frame and priorities (choose identical,
               xyz and filled depth within 1e-5, rgb exact, normals within
               1e-4 but for camera-facing flips by rounding); the metrics
               branch (ADD / ADD-S) on the card against the CPU within
               1e-5 m; then ``apps.serve.main`` in this process (20
               frames after 3 of warm-up), its JSON line logged.
7. reference — the same code on the card (kernels) and on the CPU
               (plain versions): a small frame's forward within 2e-3, and
               the full-width pose stage on labelled votes (several
               classes present) within 1e-4.
8. train     — the training path at full width (``Config.ycb()``, bf16,
               batch 4, ``grad_accum`` 1): ``create_train_state`` ->
               ``make_train_step`` -> ``Trainer.fit``, one warm-up step,
               then three steps with every launch count set to 0 just
               before and read just after (per step fps 1, query 4,
               interp 4, interp_bwd 4); loss finite and falling on the
               repeated batch, BN running statistics moved, gradients
               finite; step time and peak memory logged.  Then one step at
               ``grad_accum`` 2 (twice a step's launches) and one at
               batch 24 with the smallest ``grad_accum`` of 1, 2, 3, 4, 6
               that fits in memory (an out-of-memory below 6 is logged,
               not a failure).  Then one small float32 step on the card
               (kernels) and on the CPU (plain versions) from the same
               weights and batch: loss within 1e-4, gradient within 3e-2
               in global L2 (the float32 conditioning floor of a
               batch-statistics gradient is ~1e-2:
               ``tests/test_torch_train.py``); and the same backward with
               BN on its running statistics, every leaf within
               2e-3 * max|g|.
9. a JSON line per kernel (launches on the serving slice, the raw
   requests and the training steps, error, times, bound; K3 forward and
   backward also per level, the backward on both clouds; K4 also per pass
   on both inputs), the ``nvidia-smi`` line again, then the result line.

The last line is ``{"ok": true, "device": {...}}``; it is printed only when
every phase passed.  Times are the card's under its printed power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s
# outside the tensor cores, the rate every kernel here runs at.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
D2_FLOPS = 8          # 3 sub + 3 mul + 2 add per direct-form d^2


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, reps: int = 3, trials: int = 3) -> float:
    """Median over ``trials`` of the mean CUDA-event time of ``reps`` calls
    (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def device_ms(fn, reps: int = 5) -> float:
    """Device time per call of the kernels ``fn`` launches, from a
    ``torch.profiler`` trace: the kernel alone, without the host's launch
    cost that the CUDA-event time of a short kernel also holds."""
    from torch.autograd import DeviceType
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32 * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def depth_cloud(rng, n: int) -> np.ndarray:
    """A depth-camera-like cloud: n pixels of a 480x640 YCB camera
    (K1 intrinsics) back-projected from a table plane with three objects
    on it, so the finest SA radii (17.5 mm) collect neighbours."""
    from pvn3d_tpu_torch.config import INTRINSICS
    k = INTRINSICS["ycb_K1"]
    u = rng.randint(0, 640, n).astype(np.float32)
    v = rng.randint(0, 480, n).astype(np.float32)
    z = 0.9 + 0.15 * (v / 480.0)
    for cu, cv, r in ((220, 200, 60), (400, 260, 80), (320, 360, 50)):
        blob = ((u - cu) ** 2 + (v - cv) ** 2) < r * r
        z = np.where(blob, z - 0.08, z)
    x = (u - k[0, 2]) * z / k[0, 0]
    y = (v - k[1, 2]) * z / k[1, 1]
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", flush=True)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", f"{torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    return smi


def phase_build() -> None:
    from pvn3d_tpu_torch.ops.kernels import KERNELS
    from pvn3d_tpu_torch.ops.kernels.common import build_all
    t0 = time.perf_counter()
    logs = build_all(KERNELS)
    for k in KERNELS:
        k.load()
    dt = time.perf_counter() - t0
    for entry in logs:
        for line in entry.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                log("build", line.strip())
    log("build", f"{len(KERNELS)} kernels ready in {dt:.1f} s")


def _err(a, b) -> float:
    a = [a] if isinstance(a, torch.Tensor) else list(a)
    b = [b] if isinstance(b, torch.Tensor) else list(b)
    return max(float((x.double() - y.double()).abs().max()) if x.numel()
               else 0.0 for x, y in zip(a, b))


def _index_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _level_record(per_level, err, tol, replaces):
    """A kernel's JSON record from its per-level records: times summed over
    the levels, the bound of the summed bytes and operations."""
    def total(key):
        vals = [lv[key] for lv in per_level]
        return None if any(v is None for v in vals) else sum(vals)
    rec = dict(shapes=[f"{lv['level']} n={lv['n']} m={lv['m']} C={lv['C']}"
                       for lv in per_level],
               max_abs_err=err, tol=tol, ms=total("ms"),
               device_ms=total("device_ms"), plain_ms=total("plain_ms"),
               library_ms=total("library_ms"),
               bound=bound_ms(total("n_bytes"), total("flops")),
               replaces=replaces, levels=per_level)
    if "index_add_ms" in per_level[0]:
        rec["index_add_ms"] = total("index_add_ms")
    return rec


def _backward_levels(rng, levels4, known_c, cloud):
    """K3 backward at batch 4 on one set of level clouds: each level held
    bit for bit against its plain version, twice, and timed by events and
    on the device beside the updates + ``index_add_`` composition and the
    ``index_add_`` call alone.  Returns (per-level records, max error)."""
    from pvn3d_tpu_torch.ops.kernels import interp
    dev = levels4[0].device
    tb = levels4[0].shape[0]
    per_level = []
    err = 0.0
    for li in range(3, -1, -1):
        unk, kn = levels4[li], levels4[li + 1]
        nu, nk, c = unk.shape[1], kn.shape[1], known_c[li]
        feats = torch.tensor(rng.randn(tb, nk, c).astype(np.float32),
                             device=dev)
        fwd = interp.three_interpolate_fused(unk, kn, feats)
        fwd_plain = interp.three_interpolate_plain(unk, kn, feats)
        if (not torch.equal(fwd[2], fwd_plain[2])
                or _err(fwd[:2], fwd_plain[:2]) > 1e-5):
            raise AssertionError(f"K3 interp fp{li} at batch 4 ({cloud}) "
                                 f"differs")
        _, dist, idx = fwd
        g_out = torch.tensor(rng.randn(tb, nu, c).astype(np.float32),
                             device=dev)

        def kernel():
            return interp.three_interpolate_backward(g_out, idx, dist, nk)
        got = kernel()
        want = interp.three_interpolate_backward_plain(g_out, idx, dist, nk)
        if not torch.equal(got, want):
            raise AssertionError(
                f"K3 interp_bwd fp{li} ({cloud}): differs from plain by "
                f"{_err(got, want)}")
        if not torch.equal(got, kernel()):
            raise AssertionError(f"K3 interp_bwd fp{li} ({cloud}): two runs "
                                 f"differ")
        err = max(err, _err(got, want))
        rows = (idx.long() + (torch.arange(tb, device=dev) * nk)[:, None,
                                                                None]
                ).reshape(-1)

        def updates():
            w = 1.0 / (dist + 1e-8)
            w = w / w.sum(-1, keepdim=True)
            return (w[..., None] * g_out[:, :, None, :]).reshape(-1, c)

        def library():
            # The library composition: the (B * 3n, C) updates, then one
            # index_add_ into the (B * m, C) rows (atomics, no fixed order).
            return torch.zeros(tb * nk, c, device=dev).index_add_(
                0, rows, updates())
        lib_err = _err(library().reshape(tb, nk, c), got)
        if lib_err > 1e-4 * max(1.0, float(got.abs().max())):
            raise AssertionError(f"K3 interp_bwd fp{li} ({cloud}): "
                                 f"index_add_ disagrees by {lib_err}")
        upd = updates()
        n_bytes = tb * (nu * c + nk * c) * 4 + tb * nu * 24
        lvl = dict(level=f"fp{li}", B=tb, n=nu, m=nk, C=c,
                   ms=time_ms(kernel), device_ms=device_ms(kernel),
                   plain_ms=time_ms(lambda: interp.
                                    three_interpolate_backward_plain(
                                        g_out, idx, dist, nk), reps=1),
                   library_ms=time_ms(library),
                   index_add_ms=time_ms(lambda: torch.zeros(
                       tb * nk, c, device=dev).index_add_(0, rows, upd)),
                   longest_list=int(torch.bincount(rows).max()),
                   n_bytes=n_bytes, flops=0.0)
        lvl["bound_ms"], lvl["bound_by"] = bound_ms(n_bytes, 0.0)
        per_level.append(lvl)
        log("kernels", f"K3 interp_bwd fp{li} B={tb} n={nu} m={nk} C={c} "
            f"({cloud}): equal to plain bit for bit, twice; "
            f"{lvl['ms']:.4f} ms, on the device {lvl['device_ms']:.4f} ms, "
            f"bound {lvl['bound_ms']:.4f} ms; updates+index_add_ "
            f"{lvl['library_ms']:.4f} ms (the call alone "
            f"{lvl['index_add_ms']:.4f}); longest list "
            f"{lvl['longest_list']} hits")
    return per_level, err


def _winner_passes():
    """K4's three passes on synthetic votes (every hypothesis 70% valid)
    and on the pose stage's own inputs on labelled votes, as
    ``tools/k4_passes.py`` makes them: each held bit for bit against its
    plain version, twice, and timed by events and on the device beside the
    plain version and a library composition (cdist + lt + masks + sum +
    argmax + gather, timed only: its distances are not the direct form).
    Returns (per-pass records, max error)."""
    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.ops.kernels import winner
    from pvn3d_tpu_torch.tools.k4_passes import (pose_stage_passes,
                                                 synthetic_passes)
    dev = torch.device("cuda")
    cl = Config.ycb().cluster
    k, bw = cl.max_points_per_class, cl.bandwidth
    inputs = ([("synthetic",) + p for p in synthetic_passes(dev)]
              + [("pose",) + p for p in pose_stage_passes(dev)])
    per_pass = []
    err = 0.0
    for kind, name, pts, msk in inputs:
        h = pts.shape[0]

        def kernel():
            return winner.winner_stats(pts, msk, bw)
        got = kernel()
        want = winner.winner_stats_plain(pts, msk, bw)
        if not _index_equal(got, want):
            raise AssertionError(f"K4 winner {kind} {name}: kernel differs "
                                 f"from plain")
        if not _index_equal(got, kernel()):
            raise AssertionError(f"K4 winner {kind} {name}: two runs differ")
        err = max(err, _err(got, want))

        def library():
            inb = ((torch.cdist(pts, pts) < bw) & msk[:, None, :]
                   & msk[:, :, None])
            num = inb.sum(-1, dtype=torch.int32)
            w = num.argmax(-1)
            rows = torch.arange(h, device=dev)
            return w, inb[rows, w], num[rows, w]
        # Only valid points count toward a seed or join the winner's row:
        # v^2 pair tests for the counts plus v for the row, per hypothesis.
        v = msk.sum(1).double()
        flops = float((v * v + v).sum()) * (D2_FLOPS + 1)
        n_bytes = h * k * 14 + h * 8
        p = {"input": kind, "pass": name, "H": h, "K": k, "clusters": h,
             "ctas": h * winner.CLUSTER, "threads": winner.cta_threads(h),
             "valid": int(v.sum()),
             "hypotheses_with_points": int((v > 0).sum()),
             "ms": time_ms(kernel), "device_ms": device_ms(kernel),
             "plain_ms": time_ms(lambda: winner.winner_stats_plain(
                 pts, msk, bw), reps=1),
             "library_ms": time_ms(library), "n_bytes": n_bytes,
             "flops": flops}
        p["bound_ms"], p["bound_by"] = bound_ms(n_bytes, flops)
        per_pass.append(p)
        log("kernels", f"K4 winner {name} H={h} ({kind}): grid {h} clusters "
            f"x {winner.CLUSTER} CTAs of {p['threads']} threads, "
            f"{p['valid']} valid points in {p['hypotheses_with_points']} "
            f"hypotheses; equal bit for bit, twice; {p['ms']:.4f} ms, on the "
            f"device {p['device_ms']:.4f} ms, bound {p['bound_ms']:.4f} ms "
            f"({p['bound_by']}); plain {p['plain_ms']:.3f}, "
            f"cdist+lt+sum+argmax {p['library_ms']:.4f}")
    return per_pass, err


def phase_kernels(rng):
    """Every kernel against its plain version at the serving path's
    shapes.  Returns {name: record} with the timing and error fields."""
    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.ops.kernels import fps, interp, query, winner
    cfg = Config.ycb().model
    pcfg = cfg.pointnet2
    dev = torch.device("cuda")
    xyz = torch.tensor(depth_cloud(rng, cfg.n_sample_points)[None],
                       device=dev)
    rec = {}

    # K1: one launch per frame, SA level 0 (levels 1-3 slice its prefix).
    m0 = pcfg.sa_levels[0].npoint
    got = fps.fps(xyz, m0)
    want = fps.fps_plain(xyz, m0)
    if not torch.equal(got, want):
        raise AssertionError("K1 fps: kernel indices differ from plain")
    n = xyz.shape[1]
    rec["fps"] = dict(
        shapes=[f"xyz (1, {n}, 3) -> (1, {m0})"],
        max_abs_err=_err(got, want), tol="indices exact",
        ms=time_ms(lambda: fps.fps(xyz, m0)),
        plain_ms=time_ms(lambda: fps.fps_plain(xyz, m0), reps=1),
        library_ms=None,
        bound=bound_ms(n * 12 + m0 * 4, (m0 - 1) * n * (D2_FLOPS + 1)),
        replaces="pvn3d_tpu/ops/pallas/fps.py:150")
    fps_dev = device_ms(lambda: fps.fps(xyz, m0))
    log("kernels", f"K1 fps {rec['fps']['shapes'][0]}: indices equal, "
        f"{rec['fps']['ms']:.3f} ms = "
        f"{rec['fps']['ms'] * 1e3 / (m0 - 1):.3f} us per step; on the "
        f"device {fps_dev:.3f} ms = {fps_dev * 1e3 / (m0 - 1):.3f} us per "
        f"step (plain {rec['fps']['plain_ms']:.3f})")

    # Level point sets as the serving path builds them (fps_prefix).
    levels = [xyz]
    pts = xyz[0, got[0].long()][None]
    for lvl in pcfg.sa_levels:
        levels.append(pts[:, :lvl.npoint].contiguous())

    # K2: four launches per frame, two scales each.
    ms = plain = lib = 0.0
    n_bytes = flops = 0.0
    shapes = []
    err = 0.0
    for li, lvl in enumerate(pcfg.sa_levels):
        src, cen = levels[li], levels[li + 1]
        got = query.ball_query(lvl.radii, lvl.nsamples, src, cen)
        want = query.ball_query_plain(lvl.radii, lvl.nsamples, src, cen)
        if not _index_equal(got, want):
            raise AssertionError(f"K2 query L{li}: kernel differs from plain")
        err = max(err, _err(got, want))
        level_ms = time_ms(lambda: query.ball_query(lvl.radii, lvl.nsamples,
                                                    src, cen))
        ms += level_ms
        plain += time_ms(lambda: query.ball_query_plain(
            lvl.radii, lvl.nsamples, src, cen), reps=1)
        npts, m = src.shape[1], cen.shape[1]

        def library():
            # One unchunked composition: distances, hit indices (misses
            # score N), the ns smallest, then the first-hit fill.
            d = torch.cdist(cen, src)
            iota = torch.arange(npts, device=dev)
            res = []
            for r, ns in zip(lvl.radii, lvl.nsamples):
                score = torch.where(d < r, iota, npts)
                vals = torch.topk(score, ns, dim=-1, largest=False).values
                found = vals < npts
                first = torch.where(found[..., 0], vals[..., 0], 0)
                res.append(torch.where(found, vals, first[..., None]))
            return res
        level_lib = time_ms(library)
        lib += level_lib
        level_dev = device_ms(lambda: query.ball_query(
            lvl.radii, lvl.nsamples, src, cen))
        log("kernels", f"K2 query L{li} N={npts} m={m}: {level_ms:.4f} ms, "
            f"on the device {level_dev:.4f} ms (cdist+where+topk "
            f"{level_lib:.4f})")
        # Pairs the scan must test: per centroid, up to the index of the
        # last slot of the scale that fills last (all N if one never fills).
        tests = torch.zeros(m, dtype=torch.float64, device=dev)
        for o, ns in zip(got, lvl.nsamples):
            hits = (o[0] != o[0, :, :1]).sum(1) + 1
            full = hits >= ns
            stop = torch.where(full, o[0, :, -1].double() + 1,
                               float(npts))
            tests = torch.maximum(tests, stop)
        flops += float(tests.sum()) * (D2_FLOPS + len(lvl.radii))
        n_bytes += npts * 12 + m * 12 + m * sum(lvl.nsamples) * 4
        shapes.append(f"L{li} N={npts} m={m} r={lvl.radii}")
    rec["query"] = dict(shapes=shapes, max_abs_err=err, tol="indices exact",
                        ms=ms, plain_ms=plain, library_ms=lib,
                        bound=bound_ms(n_bytes, flops),
                        replaces="pvn3d_tpu/ops/pallas/query.py:118")
    log("kernels", f"K2 query x4 levels: indices equal, {ms:.3f} ms "
        f"(plain {plain:.3f}, cdist+where+topk {lib:.3f})")

    # K3: four launches per frame (fp3 .. fp0), known features of the
    # dense graph's widths; each level timed, traced and bounded alone.
    widths = [sum(m[-1] for m in lvl.mlps) for lvl in pcfg.sa_levels]
    known_c = [cfg.pointnet2.fp_mlps[i + 1][-1] if i < 3 else widths[3]
               for i in range(4)]
    per_level = []
    err = 0.0
    for li in range(3, -1, -1):
        unk, kn = levels[li], levels[li + 1]
        nu, nk, c = unk.shape[1], kn.shape[1], known_c[li]
        feats = torch.tensor(rng.randn(1, nk, c).astype(np.float32),
                             device=dev)
        got = interp.three_interpolate_fused(unk, kn, feats)
        want = interp.three_interpolate_plain(unk, kn, feats)
        if not torch.equal(got[2], want[2]):
            raise AssertionError(f"K3 interp fp{li}: indices differ")
        e = _err(got[:2], want[:2])
        if e > 1e-5:
            raise AssertionError(f"K3 interp fp{li}: max abs err {e}")
        err = max(err, e)

        def kernel():
            return interp.three_interpolate_fused(unk, kn, feats)

        def library():
            d, i = torch.topk(torch.cdist(unk, kn), 3, largest=False)
            w = 1.0 / (d + 1e-8)
            w = w / w.sum(-1, keepdim=True)
            g = feats[0][i[0]]
            return (g * w[0, :, :, None]).sum(1)
        rows, warps, blocks = interp.forward_grid(1, nu)
        n_bytes = nu * 12 + nk * 12 + nk * c * 4 + nu * c * 4 + nu * 24
        flops = nu * nk * (D2_FLOPS + 1) + nu * c * 5
        lvl = dict(level=f"fp{li}", n=nu, m=nk, C=c, blocks=blocks,
                   rows_per_warp=rows, warps_per_block=warps,
                   ms=time_ms(kernel), device_ms=device_ms(kernel),
                   plain_ms=time_ms(lambda: interp.three_interpolate_plain(
                       unk, kn, feats), reps=1),
                   library_ms=time_ms(library), n_bytes=n_bytes,
                   flops=flops)
        lvl["bound_ms"], lvl["bound_by"] = bound_ms(n_bytes, flops)
        per_level.append(lvl)
        log("kernels", f"K3 interp fp{li} n={nu} m={nk} C={c}: grid "
            f"{blocks} blocks of {warps} warps, {rows} row(s) a warp; idx "
            f"equal, max err {e:.2e}; {lvl['ms']:.4f} ms, on the device "
            f"{lvl['device_ms']:.4f} ms, bound {lvl['bound_ms']:.4f} ms "
            f"({lvl['bound_by']}); plain {lvl['plain_ms']:.3f}, "
            f"cdist+topk+gather {lvl['library_ms']:.4f}")
    rec["interp"] = _level_record(
        per_level, err, "indices exact, out/dist 1e-5",
        "pvn3d_tpu/ops/pallas/interp.py:162")
    log("kernels", f"K3 interp x4 levels: {rec['interp']['ms']:.4f} ms, on "
        f"the device {rec['interp']['device_ms']:.4f} ms (plain "
        f"{rec['interp']['plain_ms']:.3f}, cdist+topk+gather "
        f"{rec['interp']['library_ms']:.4f})")

    # The training step's shapes: batch 4.  K1, K2 and K3 forward checked
    # once there; K3 backward held, timed and bounded there (4 launches a
    # micro-batch, fp3 .. fp0, cotangent random), on depth-camera clouds
    # and on the training batch's own clouds (synthetic_batch at batch 4:
    # tight object clusters, so a few rows collect far longer lists).
    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    tb = 4
    clouds = {
        "depth": np.stack([depth_cloud(rng, cfg.n_sample_points)
                           for _ in range(tb)]),
        "train": synthetic_batch(Config.ycb(), batch_size=tb,
                                 seed=0)["pointcloud"][..., :3].copy(),
    }
    for cloud, pts_np in clouds.items():
        xyz4 = torch.tensor(pts_np, device=dev)
        got4 = fps.fps(xyz4, m0)
        if not torch.equal(got4, fps.fps_plain(xyz4, m0)):
            raise AssertionError(f"K1 fps at batch 4 ({cloud}): indices "
                                 f"differ from plain")
        pts4 = torch.gather(xyz4, 1,
                            got4.long()[..., None].expand(-1, -1, 3))
        levels4 = [xyz4] + [pts4[:, :lvl.npoint].contiguous()
                            for lvl in pcfg.sa_levels]
        for li, lvl in enumerate(pcfg.sa_levels):
            src, cen = levels4[li], levels4[li + 1]
            if not _index_equal(
                    query.ball_query(lvl.radii, lvl.nsamples, src, cen),
                    query.ball_query_plain(lvl.radii, lvl.nsamples, src,
                                           cen)):
                raise AssertionError(f"K2 query L{li} at batch 4 ({cloud}) "
                                     f"differs")
        per_level, err = _backward_levels(rng, levels4, known_c, cloud)
        rec["interp_bwd" if cloud == "depth" else "interp_bwd_train"] = \
            _level_record(per_level, err, "bit for bit",
                          "pvn3d_tpu/ops/pallas/interp.py:180")
    for cloud, key in (("depth", "interp_bwd"), ("train", "interp_bwd_train")):
        r = rec[key]
        log("kernels", f"K3 interp_bwd x4 levels at batch {tb}, {cloud} "
            f"clouds: equal, {r['ms']:.4f} ms, on the device "
            f"{r['device_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms (plain "
            f"{r['plain_ms']:.3f}, updates+index_add_ {r['library_ms']:.4f}, "
            f"index_add_ alone {r['index_add_ms']:.4f}); longest list "
            f"{max(lv['longest_list'] for lv in r['levels'])} hits")
    on_train = rec["interp_bwd_train"]["device_ms"]
    on_depth = rec["interp_bwd"]["device_ms"]
    log("kernels", f"K3 interp_bwd on the training batch's clouds / depth "
        f"clouds, device time: {on_train:.4f} / {on_depth:.4f} = "
        f"{on_train / on_depth:.2f}x; K1, K2, K3 forward equal their plain "
        f"versions at batch {tb} on both")

    # K4: three launches per frame, H = 21, 21, 168 at K = 512, on two
    # inputs: synthetic votes (every hypothesis 70% valid: the most work a
    # pass can get) and the pose stage's own inputs on labelled votes (only
    # the classes present have valid points).
    per_pass, err = _winner_passes()
    synthetic = [p for p in per_pass if p["input"] == "synthetic"]
    rec["winner"] = dict(
        shapes=["H=21,21,168 K=512 bw=0.08"], max_abs_err=err,
        tol="bit for bit", ms=sum(p["ms"] for p in synthetic),
        device_ms=sum(p["device_ms"] for p in synthetic),
        plain_ms=sum(p["plain_ms"] for p in synthetic),
        library_ms=sum(p["library_ms"] for p in synthetic),
        bound=bound_ms(sum(p["n_bytes"] for p in synthetic),
                       sum(p["flops"] for p in synthetic)),
        replaces="pvn3d_tpu/ops/pallas/winner.py:70", passes=per_pass)
    for kind in ("synthetic", "pose"):
        ps = [p for p in per_pass if p["input"] == kind]
        log("kernels", f"K4 winner x3 passes, {kind} inputs: equal, "
            f"{sum(p['ms'] for p in ps):.4f} ms, on the device "
            f"{sum(p['device_ms'] for p in ps):.4f} ms, bound "
            f"{sum(p['bound_ms'] for p in ps):.4f} ms (plain "
            f"{sum(p['plain_ms'] for p in ps):.3f}, cdist+lt+sum+argmax "
            f"{sum(p['library_ms'] for p in ps):.4f})")
    return rec


def phase_edge_cases(rng) -> None:
    """Each kernel against its plain version at shapes off the serving
    path.  K1: batch 3; a 20000-point row (past the register path, the
    scratch path); N not a multiple of the cluster's point stride; N below
    one CTA's share; duplicated points beside skipped ones, so real points
    reach min-d^2 0; an all-skipped row in a batch of 3.  K2: more than ns
    hits in one 32-point run; hits straddling indices 31/32; N not a
    multiple of 32; one scale full while the other never fills; empty
    balls; B = 2 with 3 scales.  K3: m in {1, 2, 3}; m = 77, not a
    multiple of 32; n = 12289, not a multiple of the rows a block takes;
    C = 0 and C = 1024; C = 35 and C = 36 with features 4 bytes off a
    16-byte boundary (the scalar instance); exact distance ties split
    across the lanes of the search.  K3 backward (each also run twice):
    m < 3 (every slot of every unknown point names row 0: a list of 3n),
    C = 0, C = 33 (no float4 path), B = 2, every unknown point sharing one
    nearest neighbour (a list of n), n not a multiple of 32, m = 77 at
    C = 1024, one row taking all 3n = 36864 entries across 36 tiles (and at
    C = 33), m = 2000 at n = 50 (rows nothing points at), m = 20000
    (counters in global memory), B = 4 with a different list shape per
    batch row, a misaligned cotangent with long lists, a strided bf16
    cotangent through autograd.  K4 (each also run twice; the inputs of
    ``tests/test_torch_winner.py``): H = 21 at K = 512 with 70% valid,
    count ties straddling the CTAs' shares of the seeds, valid points only
    in the last eighth of the row, an all-invalid hypothesis, K = 1 and
    K = 7 (CTAs with no seed), K = 1500, K = 2500 (past one 2048-point
    stage, a row valid only in the second tile), bandwidth 0 with seed 0
    invalid, duplicated points on a grid at the bandwidth; and K = 4500
    (three tiles), K = 1001 (scalar label stores)."""
    from pvn3d_tpu_torch.ops.kernels import fps, interp, query, winner
    dev = torch.device("cuda")

    def cloud(*shape, scale=0.3):
        return torch.tensor((rng.rand(*shape).astype(np.float32) - 0.5)
                            * scale, device=dev)
    fps_rows = {}
    for b, n, m in ((3, 700, 96), (2, 20000, 128), (1, 5, 9),
                    (1, 9001, 512), (2, 200, 64)):
        xyz = cloud(b, n, 3, scale=4.0)
        xyz[:, 1:3] = 0.0
        fps_rows[f"B={b} N={n} m={m}"] = (xyz, m)
    dup = cloud(1, 500, 3, scale=4.0).repeat(1, 4, 1)
    dup[:, ::7] = 0.0
    fps_rows["500 points x4 copies, every 7th skipped, m=700"] = (dup, 700)
    rows = cloud(3, 1000, 3, scale=4.0)
    rows[1] *= 0.005          # |p|^2 <= 1e-3: every point skipped
    fps_rows["all-skipped row 1 of B=3"] = (rows, 64)
    for name, (xyz, m) in fps_rows.items():
        if not torch.equal(fps.fps(xyz, m), fps.fps_plain(xyz, m)):
            raise AssertionError(f"edge fps {name}")
    if not bool((fps.fps(rows, 64)[1] == 0).all()):
        raise AssertionError("edge fps: all-skipped row is not all 0")
    cases = len(fps_rows)

    def near_origin(b, n, near):
        """n points far from the origin except indices ``near``, which lie
        within 5 mm of it."""
        xyz = 5.0 + cloud(b, n, 3)
        xyz[:, near] = cloud(b, len(near), 3, scale=0.01)
        return xyz
    dense = cloud(2, 3000, 3)
    far = torch.cat([dense[:, :200], torch.full((2, 8, 3), 9.0, device=dev)],
                    dim=1)
    query_cases = {
        ">ns hits in one 32-point run": (
            near_origin(1, 256, list(range(32)) + list(range(64, 80))),
            cloud(1, 5, 3, scale=0.01), (0.05, 0.1), (8, 40)),
        "hits straddling 31/32": (
            near_origin(2, 100, list(range(28, 38))),
            cloud(2, 6, 3, scale=0.01), (0.05, 0.1), (4, 16)),
        "N=1013, m=77": (cloud(1, 1013, 3), cloud(1, 77, 3), (0.05, 0.1),
                         (16, 32)),
        "one scale full, one never": (dense, dense[:, :50], (0.5, 1e-4),
                                      (8, 32)),
        "B=2, 3 scales, empty balls": (dense, far, (0.02, 0.05, 0.1),
                                       (8, 16, 64)),
        "one scale, ns=100, empty balls": (dense, far, (0.3,), (100,)),
    }
    for name, (xyz, cen, radii, ns) in query_cases.items():
        if not _index_equal(query.ball_query(radii, ns, xyz, cen),
                            query.ball_query_plain(radii, ns, xyz, cen)):
            raise AssertionError(f"edge query {name}")
    cases += len(query_cases)
    def misaligned(*shape):
        """A contiguous float32 tensor whose data starts 4 bytes past a
        16-byte boundary (the kernels' scalar instances)."""
        n_el = int(np.prod(shape))
        return torch.randn(n_el + 1, device=dev)[1:].view(*shape)

    def tie_cloud(b, n, m):
        """Integer-grid points: exact distance ties everywhere, and known
        points duplicated at indices that fall to other lanes of the
        search (j, j + 1, j + 5, j + 33) and to the same lane (j + 32)."""
        known = torch.tensor(rng.randint(-2, 3, (b, m, 3)).astype(
            np.float32), device=dev)
        for src, dst in ((0, 1), (2, 7), (3, 36), (4, 37), (0, 32)):
            known[:, dst] = known[:, src]
        unknown = torch.tensor(rng.randint(-4, 5, (b, n, 3)).astype(
            np.float32) * 0.5, device=dev)
        return unknown, known
    tie_u, tie_k = tie_cloud(2, 700, 100)
    fwd_cases = {
        "m=2": (cloud(2, 500, 3), cloud(2, 2, 3), torch.randn(
            2, 2, 7, device=dev)),
        "C=0": (cloud(2, 300, 3), cloud(2, 1500, 3), torch.randn(
            2, 1500, 0, device=dev)),
        "m=3, C=33": (cloud(2, 1000, 3), cloud(2, 3, 3), torch.randn(
            2, 3, 33, device=dev)),
        "m=1": (cloud(2, 300, 3), cloud(2, 1, 3), torch.randn(
            2, 1, 16, device=dev)),
        "m=77 (not a multiple of 32)": (cloud(2, 640, 3), cloud(2, 77, 3),
                                        torch.randn(2, 77, 64, device=dev)),
        "n=12289 (not a multiple of rows per block)": (
            cloud(1, 12289, 3), cloud(1, 2048, 3),
            torch.randn(1, 2048, 256, device=dev)),
        "n=511, C=1024": (cloud(1, 511, 3), cloud(1, 128, 3), torch.randn(
            1, 128, 1024, device=dev)),
        "C=36, misaligned features": (cloud(2, 900, 3), cloud(2, 200, 3),
                                      misaligned(2, 200, 36)),
        "C=35, misaligned features": (cloud(1, 700, 3), cloud(1, 90, 3),
                                      misaligned(1, 90, 35)),
        "exact distance ties split across lanes": (
            tie_u, tie_k, torch.randn(2, 100, 8, device=dev)),
    }
    for name, (u, k, f) in fwd_cases.items():
        got = interp.three_interpolate_fused(u, k, f)
        want = interp.three_interpolate_plain(u, k, f)
        if not torch.equal(got[2], want[2]) or _err(got[:2], want[:2]) > 1e-5:
            raise AssertionError(f"edge interp {name}")
        cases += 1
    got = interp.three_interpolate_fused(tie_u, tie_k, torch.randn(
        2, 100, 8, device=dev))
    if not bool((got[1][..., 0] == got[1][..., 1]).any()):
        raise AssertionError("edge interp: the tie cloud has no tie")
    # K3 backward.  (b, n, m, C, kind): "cloud" takes idx and dist from the
    # forward on a random cloud, "shared" puts every unknown point nearest
    # to row 0 (a list of n), "one" points every entry at row m - 1 (a list
    # of 3n), "rows" gives each batch row its own list shape.
    bwd_cases = {
        "m=1, list of 3n": (2, 333, 1, 16, "cloud"),
        "m=2": (2, 500, 2, 7, "cloud"),
        "C=0": (2, 300, 40, 0, "cloud"),
        "C=33, n=1000": (2, 1000, 3, 33, "cloud"),
        "one shared neighbour, n=1001": (2, 1001, 77, 64, "shared"),
        "n=45 (under two runs), C=4": (1, 45, 9, 4, "cloud"),
        "m=77 (not a multiple of 32), C=1024": (2, 1500, 77, 1024, "cloud"),
        "one row takes all 3n = 36864 entries (36 tiles)": (
            1, 12288, 50, 256, "one"),
        "one row takes all 3n, C=33": (2, 4096, 40, 33, "one"),
        "m=2000, n=50: rows nothing points at": (1, 50, 2000, 256, "cloud"),
        "m=20000 (counters in global memory)": (2, 3000, 20000, 8, "cloud"),
        "B=4, a list shape per batch row": (4, 4096, 64, 256, "rows"),
    }
    for name, (b, n, m, c, kind) in bwd_cases.items():
        k = cloud(b, m, 3)
        u = cloud(b, n, 3)
        if kind == "shared":
            u = k[:, :1] + u * 1e-3       # every point nearest to row 0
        f = torch.randn(b, m, c, device=dev)
        _, dist, idx = interp.three_interpolate_fused(u, k, f)
        if kind == "one":
            idx = torch.full_like(idx, m - 1)
        elif kind == "rows":
            # Row 0 random, row 1 one list of 3n, row 2 equal blocks of
            # consecutive points, row 3 geometric (a few long lists).
            idx = torch.stack([
                torch.randint(0, m, (n, 3), device=dev),
                torch.full((n, 3), 5, device=dev),
                (torch.arange(n, device=dev) * m // n)[:, None].expand(n, 3),
                torch.tensor(np.minimum(rng.geometric(0.05, (n, 3)) - 1,
                                        m - 1), device=dev),
            ]).int().contiguous()
        g = torch.randn(b, n, c, device=dev)
        got = interp.three_interpolate_backward(g, idx, dist, m)
        if not torch.equal(got, interp.three_interpolate_backward_plain(
                g, idx, dist, m)):
            raise AssertionError(f"edge interp_bwd {name}")
        if not torch.equal(got, interp.three_interpolate_backward(
                g, idx, dist, m)):
            raise AssertionError(f"edge interp_bwd {name}: two runs differ")
        if kind == "shared" and int((idx[..., 0] == 0).sum()) != b * n:
            raise AssertionError(f"edge interp_bwd {name}: not one list")
        cases += 1
    # A misaligned cotangent with long lists (the scalar instance of both
    # roles of the sum).
    idx = torch.full((1, 2000, 3), 3, dtype=torch.int32, device=dev)
    idx[:, ::7] = 1
    dist = torch.rand(1, 2000, 3, device=dev)
    g = misaligned(1, 2000, 64)
    got = interp.three_interpolate_backward(g, idx, dist, 10)
    if not torch.equal(got, interp.three_interpolate_backward_plain(
            g, idx, dist, 10)):
        raise AssertionError("edge interp_bwd misaligned cotangent")
    cases += 1
    # Through autograd, with the cotangent autograd hands over: bf16 and
    # strided (a transposed view), made float32 contiguous by the wrapper.
    k, u = cloud(2, 50, 3), cloud(2, 700, 3)
    f = torch.randn(2, 50, 24, device=dev, requires_grad=True)
    out, dist, idx = interp.three_interpolate_fused(u, k, f)
    g = torch.randn(2, 24, 700, device=dev).to(torch.bfloat16).transpose(1, 2)
    out.backward(g)
    if not torch.equal(f.grad, interp.three_interpolate_backward_plain(
            g, idx, dist, 50)):
        raise AssertionError("edge interp_bwd through autograd")
    cases += 1
    for name, (pts, msk, bw) in _winner_cases().items():
        pts, msk = torch.tensor(pts, device=dev), torch.tensor(msk, device=dev)
        got = winner.winner_stats(pts, msk, bw)
        if not _index_equal(got, winner.winner_stats_plain(pts, msk, bw)):
            raise AssertionError(f"edge winner {name}")
        if not _index_equal(got, winner.winner_stats(pts, msk, bw)):
            raise AssertionError(f"edge winner {name}: two runs differ")
        cases += 1
    log("edge", f"{cases} off-path shapes: every kernel equals its plain "
        f"version")


def _winner_votes(rng, h, k, valid=0.7):
    modes = rng.randn(h, 3, 3).astype(np.float32) * 0.1
    pick = rng.randint(0, 3, (h, k))
    pts = (modes[np.arange(h)[:, None], pick]
           + rng.randn(h, k, 3).astype(np.float32) * 0.03)
    return pts.astype(np.float32), rng.rand(h, k) < valid


def _winner_cases():
    """K4's edge cases, the inputs of ``tests/test_torch_winner.py``:
    {name: (points (H, K, 3), mask (H, K), bandwidth)} as numpy arrays."""
    cases = {}
    for name in ("H=21 K=512 70% valid", "count ties straddling CTA shares",
                 "valid points only in the last slice",
                 "an all-invalid hypothesis", "K=1", "K=7", "K=1500",
                 "K=2500, past the stage", "bandwidth 0",
                 "duplicated points"):
        rng = np.random.RandomState(len(name))
        bw = 0.08
        if name == "H=21 K=512 70% valid":
            pts, msk = _winner_votes(rng, 21, 512)
        elif name == "count ties straddling CTA shares":
            # One point repeated at indices in the shares of CTAs 0, 1, 3
            # and 7 (row 0) or of two CTAs (row 1, every third invalid).
            pts = rng.randn(2, 512, 3).astype(np.float32) * 10.0
            for row, idx in enumerate(((63, 64, 200, 450),
                                       (61, 66, 301, 500))):
                pts[row, list(idx)] = pts[row, idx[0]]
            msk = np.ones((2, 512), bool)
            msk[1, ::3] = False
            msk[1, [61, 66, 301, 500]] = True
        elif name == "valid points only in the last slice":
            pts, _ = _winner_votes(rng, 4, 512)
            msk = np.zeros((4, 512), bool)
            msk[:, 448:] = rng.rand(4, 64) < 0.8
        elif name == "an all-invalid hypothesis":
            pts, msk = _winner_votes(rng, 3, 512)
            msk[1] = False
        elif name == "K=1":
            pts, msk = _winner_votes(rng, 4, 1, valid=0.5)
            msk[0], msk[1] = True, False
        elif name == "K=7":
            pts, msk = _winner_votes(rng, 5, 7, valid=0.6)
            msk[2] = False
        elif name == "K=1500":
            pts, msk = _winner_votes(rng, 3, 1500)
        elif name == "K=2500, past the stage":
            pts, msk = _winner_votes(rng, 3, 2500)
            msk[1, :2048] = False
        elif name == "bandwidth 0":
            pts, msk = _winner_votes(rng, 3, 512)
            msk[:, 0] = False
            bw = 0.0
        else:   # duplicated points (d^2 = 0) on a grid at the bandwidth
            grid = rng.randint(-3, 4, (4, 128, 3)).astype(np.float32) * 0.04
            pts = np.concatenate([grid] * 4, axis=1)
            msk = rng.rand(4, 512) < 0.7
        cases[name] = (pts.astype(np.float32), msk, bw)
    # Beyond the test file: three tiles with a partial last one, and a row
    # whose labels take the scalar stores (K not a multiple of 4).
    rng = np.random.RandomState(99)
    cases["K=4500, three tiles"] = _winner_votes(rng, 2, 4500) + (0.08,)
    cases["K=1001, scalar label stores"] = _winner_votes(rng, 9, 1001) + (
        0.08,)
    return cases


def phase_slice(seed: int = 0):
    """Three full-width requests through the serving entry point on the
    card.  Returns the launch counts of that run."""
    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    from pvn3d_tpu_torch.inference.pipeline import make_inference_step
    from pvn3d_tpu_torch.ops.kernels import KERNELS
    from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,
                                              stacked_mesh_kps)
    from pvn3d_tpu_torch.utils.weights import build_model
    cfg = Config.ycb()
    model = build_model(cfg.model, seed)
    step = make_inference_step(cfg, model, stacked_mesh_kps(),
                               stacked_class_radii())
    step(synthetic_batch(cfg, batch_size=1, seed=1000))   # warm-up
    torch.cuda.synchronize()

    for k in KERNELS:
        k.launches = 0
    lat = []
    outs = []
    for i in range(3):
        batch = synthetic_batch(cfg, batch_size=1, seed=i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = {k.name: k.launches for k in KERNELS}

    n_cls = cfg.model.n_classes
    for i, out in enumerate(outs):
        poses, present = out["poses"], out["present"]
        if poses.shape != (1, n_cls, 3, 4) or present.shape != (1, n_cls):
            raise AssertionError(f"request {i}: shapes {poses.shape} "
                                 f"{present.shape}")
        if not bool(torch.isfinite(poses).all()):
            raise AssertionError(f"request {i}: non-finite poses")
        if not bool(present.any()):
            raise AssertionError(f"request {i}: no class present")
    want = {"fps": 3, "query": 12, "interp": 12, "winner": 9}
    if launches["interp_bwd"] != 0:
        raise AssertionError("serving launched the backward kernel")
    for name, n in want.items():
        if launches[name] < n:
            raise AssertionError(f"{name}: {launches[name]} launches on the "
                                 f"slice, expected >= {n}")
    log("slice", "3 requests, 480x640 + 12288 points, 22 classes: latency ms "
        + ", ".join(f"{t:.2f}" for t in lat) + "; present classes "
        + ", ".join(str(int(o["present"].sum())) for o in outs)
        + f"; launches {launches}")

    # Where a request's time goes: the forward alone, then the pose stage
    # alone on the forward's outputs (median of three, card clocks).
    dev = torch.device("cuda")
    batch = synthetic_batch(cfg, batch_size=1, seed=0)
    args = [torch.as_tensor(batch[k], device=dev)
            for k in ("pointcloud", "rgb", "choose")]
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(*args), reps=1)
        res = model(*args)
        seg = torch.argmax(res["seg_logits"], -1).to(torch.int32)
        from pvn3d_tpu_torch.inference.pipeline import make_pose_fn
        pose_fn = make_pose_fn(cfg, stacked_mesh_kps(), stacked_class_radii())
        pose_ms = time_ms(lambda: pose_fn(args[0][..., :3], seg,
                                          res["ctr_offsets"],
                                          res["kp_offsets"]), reps=1)
    log("slice", f"forward {fwd_ms:.2f} ms, votes->poses {pose_ms:.2f} ms "
        f"(median of 3)")
    return launches, lat


def _frame_build_close(got, want, k):
    """The card's frame build against the CPU's on the same frame and
    priorities (the tolerances of tests/test_torch_raw.py): choose
    identical, xyz and the filled depth within 1e-5, rgb exact, and the
    normals within 1e-4 of the CPU's normals of the card's filled depth
    but for camera-facing flips decided by rounding (|n.p| < 1e-6, at most
    0.1% of the points).  Returns the worst errors."""
    from pvn3d_tpu_torch.ops.preprocess import normals_from_depth_map
    g = {key: v.cpu() for key, v in got.items()}
    if not torch.equal(g["choose"], want["choose"]):
        raise AssertionError("raw: card and CPU chose other pixels")
    pc, wpc = g["pointcloud"], want["pointcloud"]
    xyz_err = _err(pc[..., :3], wpc[..., :3])
    depth_err = _err(g["depth_m"], want["depth_m"])
    nrm = normals_from_depth_map(g["depth_m"], k.cpu())
    idx = g["choose"].long()[..., None].expand(-1, -1, 3)
    nrm = torch.gather(nrm.reshape(nrm.shape[0], -1, 3), 1, idx)
    off = (pc[..., 6:] - nrm).abs().amax(-1) > 1e-4
    ndotp = (nrm * pc[..., :3]).sum(-1).abs()
    flips = int(off.sum())
    if (xyz_err > 1e-5 or depth_err > 1e-5
            or not torch.equal(pc[..., 3:6], wpc[..., 3:6])
            or bool((ndotp[off] >= 1e-6).any())
            or flips > 1e-3 * off.numel()):
        raise AssertionError(f"raw: frame build card vs CPU: xyz {xyz_err}, "
                             f"depth {depth_err}, normal flips {flips}")
    return xyz_err, depth_err, flips, _err(pc[..., 6:], nrm)


def phase_raw(smi: str, seed: int = 0):
    """Raw RGB-D frames through ``make_raw_inference_step`` on the card at
    full width: three requests with every launch count set to 0 just
    before and read just after (fps 1, query 4, interp 4, winner 3 a
    request, no backward); the frame build's stages by CUDA events and its
    launches and device time from a profiler trace; the frame build held
    against the CPU's on the same full-size frame and priorities; the
    metrics branch on the card against the CPU; then the serving app in
    this process.  Returns the launch counts of the three requests."""
    import contextlib
    import io

    from pvn3d_tpu_torch.apps import serve
    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.data.device_frame import (
        build_inference_batch_device, draw_priorities, gather_points,
        select_pixels)
    from pvn3d_tpu_torch.data.synthetic import synth_sensor_frame
    from pvn3d_tpu_torch.geometry.cloud import depth_to_cloud_map
    from pvn3d_tpu_torch.inference.evaluator import eval_frame_metrics
    from pvn3d_tpu_torch.inference.pipeline import make_raw_inference_step
    from pvn3d_tpu_torch.ops.kernels import KERNELS
    from pvn3d_tpu_torch.ops.preprocess import (fill_missing,
                                                normals_from_depth_map)
    from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,
                                              stacked_mesh_kps)
    from pvn3d_tpu_torch.utils.weights import build_model
    dev = torch.device("cuda")
    cfg = Config.ycb()
    mc = cfg.model
    h, w, n = mc.image_height, mc.image_width, mc.n_sample_points
    rng = np.random.RandomState(seed)
    n_cls, n_mesh = mc.n_classes, 2000
    mesh_pts = rng.uniform(-0.06, 0.06, (n_cls, n_mesh, 3)).astype(
        np.float32)
    mesh_valid = np.ones((n_cls, n_mesh), bool)
    mesh_valid[:, 1500:] = rng.rand(n_cls, n_mesh - 1500) < 0.5
    step = make_raw_inference_step(cfg, build_model(mc, seed),
                                   stacked_mesh_kps(), stacked_class_radii(),
                                   mesh_pts, mesh_valid)

    def request(i):
        rgb, depth, k = synth_sensor_frame(h, w, seed=i)
        return {"rgb": rgb, "depth": depth, "cam_k": k}

    def gen(i):
        return torch.Generator(device=dev).manual_seed(i)
    step(request(1000), gen(1000))                           # warm-up
    torch.cuda.synchronize()
    for kern in KERNELS:
        kern.launches = 0
    lat, outs = [], []
    for i in range(3):
        batch = request(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(batch, gen(i))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = {kern.name: kern.launches for kern in KERNELS}
    want = {"fps": 3, "query": 12, "interp": 12, "interp_bwd": 0,
            "winner": 9}
    if launches != want:
        raise AssertionError(f"raw: launches {launches} over 3 requests, "
                             f"expected {want}")
    for i, out in enumerate(outs):
        if (out["poses"].shape != (1, n_cls, 3, 4)
                or out["pointcloud"].shape != (1, n, 9)
                or out["choose"].shape != (1, n)):
            raise AssertionError(f"raw request {i}: shapes")
        if not bool(torch.isfinite(out["poses"]).all()):
            raise AssertionError(f"raw request {i}: non-finite poses")
        if not bool(out["present"].any()):
            raise AssertionError(f"raw request {i}: no class present")
    log("raw", f"3 raw requests, {h}x{w} RGB-D -> {n} points, {n_cls} "
        f"classes: latency ms " + ", ".join(f"{t:.2f}" for t in lat)
        + "; present classes "
        + ", ".join(str(int(o["present"].sum())) for o in outs)
        + f"; launches {launches} [{smi}]")

    # The frame build's stages on one full-size frame (CUDA events,
    # median of 3), its launches and device time in a profiler trace.
    batch = request(0)
    rgb = torch.as_tensor(batch["rgb"], device=dev)
    depth = torch.as_tensor(batch["depth"], device=dev)
    k = torch.as_tensor(batch["cam_k"], device=dev)
    pri = draw_priorities((1, h * w), dev, gen(7))
    depth_m = fill_missing(depth)
    cloud_map, valid = depth_to_cloud_map(depth_m, k)
    nrm = normals_from_depth_map(depth_m, k)

    def sample():
        p = draw_priorities((1, h * w), dev, gen(7))
        choose = select_pixels(valid.reshape(1, -1), p, n)
        return gather_points(choose, cloud_map, rgb, nrm)

    def build():
        return build_inference_batch_device(rgb, depth, k, n, generator=gen(7))
    stage = {"fill": time_ms(lambda: fill_missing(depth)),
             "normals + cloud": time_ms(lambda: (
                 depth_to_cloud_map(depth_m, k),
                 normals_from_depth_map(depth_m, k))),
             "sample + gather": time_ms(sample),
             "whole build": time_ms(build)}
    from torch.autograd import DeviceType
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        build()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    build_launches = sum(e.count for e in ev)
    build_dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    log("raw", f"frame build, one {h}x{w} frame, CUDA events ms (median of "
        "3): " + ", ".join(f"{key} {v:.3f}" for key, v in stage.items())
        + f"; device {build_dev_ms:.3f} ms in {build_launches} kernel and "
        f"copy launches (profiler) [{smi}]")
    # One whole raw request in a trace: wall clock, device busy, launches.
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(request(4), gen(4))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    log("raw", f"one raw request in a trace: wall {wall:.2f} ms, device busy "
        f"{sum(e.self_device_time_total for e in ev) / 1e3:.3f} ms in "
        f"{sum(e.count for e in ev)} kernel and copy launches")

    # The card's frame build against the CPU plain path: same frame, same
    # priorities.
    got = build_inference_batch_device(rgb, depth, k, n, priorities=pri)
    cpu = build_inference_batch_device(
        torch.as_tensor(batch["rgb"]), torch.as_tensor(batch["depth"]),
        torch.as_tensor(batch["cam_k"]), n, priorities=pri.cpu())
    xyz_err, depth_err, flips, nrm_err = _frame_build_close(got, cpu, k)
    log("raw", f"frame build card vs CPU, same frame and priorities: choose "
        f"identical, xyz max err {xyz_err:.2e}, filled depth {depth_err:.2e},"
        f" normals {nrm_err:.2e} against the CPU's of the card's depth "
        f"({flips} flips by rounding)")

    # The metrics branch: a request with GT slots scored on the card, and
    # the same poses scored on the CPU.
    batch = request(3)
    gt = np.tile(np.eye(3, 4, dtype=np.float32), (1, 4, 1, 1))
    gt[..., 3] = rng.uniform(-0.2, 0.2, (1, 4, 3))
    gt[..., 2, 3] += 1.0
    batch.update(cls_ids=np.array([[1, 6, 13, 0]], np.int32), rts=gt)
    out = step(batch, gen(3))
    add, adds = eval_frame_metrics(
        out["poses"].cpu(), torch.as_tensor(batch["cls_ids"]),
        torch.as_tensor(gt), torch.as_tensor(mesh_pts),
        torch.as_tensor(mesh_valid))
    m_err = max(_err(out["add"].cpu(), add), _err(out["adds"].cpu(), adds))
    if m_err > 1e-5 or not bool(torch.isfinite(out["adds"]).all()):
        raise AssertionError(f"raw: metrics card vs CPU {m_err}")
    log("raw", f"metrics branch (22 meshes of {n_mesh} points, 4 GT slots):"
        f" add {out['add'].cpu().numpy().round(4).tolist()}, adds "
        f"{out['adds'].cpu().numpy().round(4).tolist()} m; card vs CPU max "
        f"err {m_err:.2e}")

    # The serving app, in this process, at full width on the card.
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = serve.main(["--frames", "20", "--warmup", "3"])
    lat = rec["latency_ms"]
    if not (rec["value"] > 0 and 0 < lat["p50"] <= lat["p99"]):
        raise AssertionError(f"raw: serve {rec}")
    log("raw", f"serve: {json.dumps(rec)} [{smi}]")
    return launches


def phase_train(smi: str, seed: int = 0):
    """The training path on the card.  Returns the launch counts of its
    three counted steps."""
    import dataclasses
    import gc

    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    from pvn3d_tpu_torch.ops.kernels import KERNELS
    from pvn3d_tpu_torch.train.state import (create_train_state,
                                             param_count)
    from pvn3d_tpu_torch.train.step import make_train_step, to_device
    from pvn3d_tpu_torch.train.trainer import Trainer
    dev = torch.device("cuda")
    cfg = Config.ycb()
    n_batch, n_steps = 4, 3
    state = create_train_state(cfg, seed)
    step = make_train_step(cfg)
    batch = to_device(synthetic_batch(cfg, batch_size=n_batch, seed=seed),
                      dev)
    step(state, batch)                                   # warm-up
    torch.cuda.synchronize()
    stats0 = {k: v.clone() for k, v in state.model.named_buffers()
              if "running_" in k}

    losses, times = [], []

    def timed_step(st, b, step_seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, metrics = step(st, b, step_seed)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        return st, metrics
    trainer = Trainer(cfg, state, timed_step, log_every=1)
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    trainer.fit([batch] * n_steps, max_steps=state.step + n_steps)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    want = {"fps": 1, "query": 4, "interp": 4, "interp_bwd": 4, "winner": 0}
    for name, per_step in want.items():
        if launches[name] != per_step * n_steps:
            raise AssertionError(
                f"{name}: {launches[name]} launches over {n_steps} training "
                f"steps, expected {per_step} a step")
    if len(losses) != n_steps or not np.isfinite(losses).all():
        raise AssertionError(f"train: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall on a repeated "
                             f"batch: {losses}")
    moved = sum(not torch.equal(v, stats0[k])
                for k, v in state.model.named_buffers() if k in stats0)
    if moved != len(stats0):
        raise AssertionError(f"train: {moved} of {len(stats0)} BN running "
                             f"statistics moved")
    for name, p in state.model.named_parameters():
        if p.grad is None:
            if "final_seg" not in name:    # the auxiliary head is in no loss
                raise AssertionError(f"train: no gradient for {name}")
        elif not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"train: non-finite gradient for {name}")
    log("train", f"{n_steps} steps through Trainer.fit at batch {n_batch}, "
        f"480x640 + 12288 points, 22 classes, bf16, "
        f"{param_count(state.model)} parameters: step ms "
        + ", ".join(f"{t:.1f}" for t in times) + "; loss "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f"; peak memory {peak_gb:.2f} GiB; launches {launches}; all "
        f"{len(stats0)} BN running statistics moved, gradients finite "
        f"[{smi}]")

    # grad_accum 2 on the same batch: two micro-batches of 2, so twice a
    # step's launches and one optimizer update.
    accum_step = make_train_step(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, grad_accum=2)))
    for k in KERNELS:
        k.launches = 0
    _, metrics = accum_step(state, batch)
    accum_loss = float(metrics["loss"])
    accum_launches = {k.name: k.launches for k in KERNELS}
    if accum_launches != {name: 2 * n for name, n in want.items()}:
        raise AssertionError(f"train: grad_accum 2 launched "
                             f"{accum_launches}")
    if not np.isfinite(accum_loss) or not accum_loss < losses[0]:
        raise AssertionError(f"train: grad_accum 2 loss {accum_loss}")
    log("train", f"one more step at grad_accum 2 (micro-batches of 2): "
        f"loss {accum_loss:.4f}, launches {accum_launches}")
    fit_batch_24(cfg, state, smi, seed + 1)
    del state, trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    train_reference(seed)
    return launches


def fit_batch_24(cfg, state, smi: str, seed: int) -> None:
    """One training step at ``mini_batch_size`` 24 with the smallest
    ``grad_accum`` of 1, 2, 3, 4, 6 that fits in memory.  An out-of-memory
    below 6 is logged and the next tried; at 6 (micro-batch 4, which the
    steps before ran) it is a failure."""
    import dataclasses
    import gc

    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    from pvn3d_tpu_torch.train.step import make_train_step, to_device
    dev = torch.device("cuda")
    big = to_device(synthetic_batch(cfg, batch_size=24, seed=seed), dev)
    for accum in (1, 2, 3, 4, 6):
        cfg_a = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, grad_accum=accum))
        big_step = make_train_step(cfg_a)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        oom = None
        try:
            _, metrics = big_step(state, big)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            if accum == 6:
                raise
            oom = str(e).splitlines()[0]
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if oom is not None:
            state.optimizer.zero_grad(set_to_none=True)
            log("train", f"batch 24, grad_accum {accum} (micro-batch "
                f"{24 // accum}): out of memory at {peak:.2f} GiB allocated "
                f"({oom[:100]})")
            continue
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"train: batch 24 loss {loss}")
        log("train", f"batch 24, grad_accum {accum} (micro-batch "
            f"{24 // accum}): fits, peak memory {peak:.2f} GiB, first step "
            f"{ms:.1f} ms, loss {loss:.4f} [{smi}]")
        return


def train_reference(seed: int) -> None:
    """One small float32 backward on the card (kernels) and on the CPU
    (plain versions) from the same weights and batch, one block per ResNet
    stage and no dropout (what tests/test_torch_train.py holds against the
    JAX package), so the whole backward through the kernels is held end to
    end, twice: as a train step (batch-statistics BN, whose gradient is
    rough in float32 on any device: loss within 1e-4, gradient within 3e-2
    in global L2), and with BN on its running statistics, where the
    gradient is well conditioned (every leaf within 2e-3 * max|g|, 1e-4 in
    global L2; measured 4.5e-4 and 5.4e-6)."""
    import dataclasses

    from pvn3d_tpu_torch.config import Config, small_model_config
    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    from pvn3d_tpu_torch.train.state import create_train_state
    from pvn3d_tpu_torch.train.step import (compute_losses, make_train_step,
                                            to_device)
    mcfg = small_model_config()
    mcfg = dataclasses.replace(mcfg, cnn=dataclasses.replace(
        mcfg.cnn, dropout_psp=0.0, dropout_up=0.0,
        backbone_layers=(1, 1, 1, 1)))
    scfg = Config(model=mcfg)
    # synthetic_batch's own cloud: a cloud shrunk to fit the small radii
    # leaves level 0's grouped offsets with batch variances near the BN
    # epsilon, where E[x^2] - E[x]^2 is rounding noise on any device.
    small = synthetic_batch(scfg, batch_size=2, seed=seed + 2)

    def grads_of(model):
        return {k: p.grad.detach().cpu().double()
                for k, p in model.named_parameters() if p.grad is not None}

    def compare(got, want):
        """(global L2 relative error, worst leaf max-abs / max|g|); a conv
        bias in front of a BN has an exact gradient of 0 and is left out
        of the second."""
        num = sum(float(((got[k] - g) ** 2).sum()) for k, g in want.items())
        den = sum(float((g ** 2).sum()) for g in want.values())
        worst = max(float((got[k] - g).abs().max() / (g.abs().max() + 1e-12))
                    for k, g in want.items() if not k.endswith("conv.1.bias"))
        return (num / den) ** 0.5, worst

    train, running, loss = {}, {}, {}
    for d in ("cuda", "cpu"):
        st = create_train_state(scfg, seed, device=d)
        st.model.eval()
        tb = to_device(small, torch.device(d))
        compute_losses(scfg, st.model(tb["pointcloud"], tb["rgb"],
                                      tb["choose"]), tb)["loss"].backward()
        running[d] = grads_of(st.model)
        _, metrics = make_train_step(scfg, device=d)(st, small)
        loss[d] = float(metrics["loss"])
        train[d] = grads_of(st.model)
    loss_err = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    train_err, train_worst = compare(train["cuda"], train["cpu"])
    run_err, run_worst = compare(running["cuda"], running["cpu"])
    if (loss_err > 1e-4 or train_err > 3e-2 or run_err > 1e-4
            or run_worst > 2e-3):
        raise AssertionError(
            f"train-reference: loss err {loss_err}, train-step gradient err "
            f"{train_err}, running-statistics gradient err {run_err} "
            f"(worst leaf {run_worst})")
    log("train", f"train-reference, small float32 model, card (kernels) vs "
        f"CPU (plain): train step loss {loss['cuda']:.6f} vs "
        f"{loss['cpu']:.6f} (rel {loss_err:.2e}), gradient global L2 rel "
        f"{train_err:.2e} (worst leaf max-abs / max|g| {train_worst:.2e}); "
        f"on running statistics gradient global L2 rel {run_err:.2e}, "
        f"worst leaf {run_worst:.2e}")


def phase_reference(seed: int = 1):
    """The same code on the card (kernels) and on the CPU (plain
    versions): a small frame's forward, same weights, within 2e-3 with
    > 99.9% seg agreement; and the full-width pose stage on labelled votes
    (three classes present) within 1e-4, timed on the card."""
    from pvn3d_tpu_torch.config import Config, small_model_config
    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    from pvn3d_tpu_torch.inference.pipeline import make_pose_fn
    from pvn3d_tpu_torch.tools.k4_passes import labelled_votes
    from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,
                                              stacked_mesh_kps)
    from pvn3d_tpu_torch.utils.weights import build_model
    mcfg = small_model_config()
    batch = synthetic_batch(Config(model=mcfg), batch_size=1, seed=seed)
    batch["pointcloud"][..., :3] = depth_cloud(
        np.random.RandomState(seed), mcfg.n_sample_points)[None] * 0.3
    res = {}
    for dev in ("cuda", "cpu"):
        model = build_model(mcfg, seed).to(dev)
        with torch.inference_mode():
            res[dev] = model(*(torch.as_tensor(batch[k], device=dev)
                               for k in ("pointcloud", "rgb", "choose")))
    err = max(float((res["cuda"][k].cpu() - res["cpu"][k]).abs().max())
              for k in ("seg_logits", "kp_offsets", "ctr_offsets"))
    agree = float((res["cuda"]["seg_logits"].argmax(-1).cpu()
                   == res["cpu"]["seg_logits"].argmax(-1)).float().mean())
    if err > 2e-3 or agree <= 0.999:
        raise AssertionError(f"reference: forward err {err}, seg agreement "
                             f"{agree}")

    cfg = Config.ycb()
    votes = labelled_votes(cfg, seed)
    frames = {}
    for dev in ("cuda", "cpu"):
        fn = make_pose_fn(cfg, stacked_mesh_kps(), stacked_class_radii(),
                          device=dev)
        args = [v.to(dev) for v in votes]
        with torch.inference_mode():
            frames[dev] = fn(*args)
            if dev == "cuda":
                pose_ms = time_ms(lambda: fn(*args), reps=1)
    present = frames["cpu"].present
    pose_err = float((frames["cuda"].poses.cpu()
                      - frames["cpu"].poses).abs().max())
    if (pose_err > 1e-4 or int(present.sum()) < 2
            or not torch.equal(frames["cuda"].present.cpu(), present)):
        raise AssertionError(f"reference: pose err {pose_err}, present "
                             f"{present.nonzero().flatten().tolist()}")
    log("reference", f"small frame card vs CPU plain: forward max err "
        f"{err:.2e}, seg agreement {agree:.4f}; full-width pose stage on "
        f"labelled votes ({int(present.sum())} classes): max err "
        f"{pose_err:.2e}, {pose_ms:.2f} ms on the card (median of 3)")


def main() -> int:
    smi = phase_device()
    phase_build()
    rng = np.random.RandomState(0)
    rec = phase_kernels(rng)
    phase_edge_cases(rng)
    launches, _ = phase_slice()
    raw_launches = phase_raw(smi)
    phase_reference()
    train_launches = phase_train(smi)
    from pvn3d_tpu_torch.ops.kernels import KERNELS
    line = []
    for k in KERNELS:
        r = rec[k.name]
        bound, by = r["bound"]
        # Launches: over the serving slice's three requests, the raw
        # path's three requests and the training path's three steps, each
        # counted from 0.
        total = (launches[k.name] + raw_launches[k.name]
                 + train_launches[k.name])
        if total < 1:
            raise AssertionError(f"{k.name}: launched on no main path")
        line.append({
            "name": k.name, "route": "cuda",
            "source": f"pvn3d_tpu_torch/csrc/{k.name}.cu",
            "replaces": r["replaces"],
            "launches": total,
            "launches_serving": launches[k.name],
            "launches_raw": raw_launches[k.name],
            "launches_training": train_launches[k.name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound, "bound_by": by,
            "library_ms": r["library_ms"]})
        if "levels" in r:
            # K3: the sums' parts, one record per level (fp3 .. fp0).
            line[-1]["device_ms"] = r["device_ms"]
            line[-1]["levels"] = r["levels"]
        if k.name == "winner":
            line[-1].update(device_ms=r["device_ms"], passes=r["passes"])
        if k.name == "interp_bwd":
            t = rec["interp_bwd_train"]
            line[-1].update(index_add_ms=r["index_add_ms"],
                            device_ms_train=t["device_ms"], ms_train=t["ms"],
                            levels_train=t["levels"])
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
