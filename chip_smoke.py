"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each logs lines tagged with its name; the script stops at the first
that fails):

1. device    — the card's ``nvidia-smi`` name and power limit; no CUDA
               exits 1.
2. build     — all six CUDA sources from ``pvn3d_tpu_torch/csrc`` (one
               ``nvcc`` per source, all at once) into ``build/kernels``;
               nine kernel instances and the five BatchNorm entry points,
               each with its own launch count.
3. kernels   — each kernel against its plain PyTorch version on the card
               at the shapes the serving path gives it (indices exact,
               floats within 1e-5), timed with CUDA events beside the
               plain version, a library call where one computes the same
               function (K2: cdist + where + topk; K3: cdist + topk +
               gather), and the bound the card's peak rates set; K1's time
               per step and K2's and K3's times per level are logged, each
               also as device time from a ``torch.profiler`` trace kept
               only when each launch has its device record (the kernel
               without the host's launch cost); K3 forward logs
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
6. eval_graph — the eval graph at full width, batch 1, seeded random
               weights, bf16 and float32: one request through the
               default graph (the sparse CNN tail, the fused upsample
               stages, the split heads, the SA/FP precompute) and through
               the literal one (``sparse_cnn=False``, the four fields
               off); the outputs within 0.05 (bf16) / 1e-4 (float32) x
               max(1, |ref|) of the literal graph's and the seg argmax
               agreeing on > 95% / 99.9% (the tolerances of
               tests/test_torch_eval_graph.py), the pose difference
               logged; in bf16 the two graphs' request latency (host
               clock, 50 requests each, alternating in ABBA order:
               median, p10, p90), each one's forward (events), device
               time and launches (a CUDA-only trace); then K3 at the
               eval graph's widths (fp3 .. fp0 blending W0 =
               512/512/256/128 channels) against its plain version,
               timed and bounded per level.
7. raw       — raw RGB-D frames at full width (``synth_sensor_frame``,
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
8. icp       — ICP after a raw request at full width (seeded random
               weights, 22 meshes of 2000 points): the raw step's filled
               depth through ``make_icp_step`` in full-resolution mode,
               then the same frame in sampled mode, each timed (events,
               median of 3) and traced (device time and kernel and copy
               launches from complete traces of CUDA activity alone, host
               reads from one of CPU activity alone), with its iterations
               and the classes that passed the gate; the request and the
               two ICP calls counted from 0 (fps 1, query 4, interp 4,
               winner 3 + 2);
               the 1-NN propagation alone; K4 at the prefilter's shape
               (H = 21, K = 2000, bandwidth 0.06) held bit for bit against
               its plain version on its own inputs (captured by wrapping
               ``winner_stats``) and timed beside a cdist composition;
               ``icp_refine`` on the card against the CPU on the captured
               scene (largest pose difference, printed) and on 21
               well-posed problems (within 1e-3), the propagation against
               the CPU on every 16th pixel (every mismatch at a near-tie),
               and one SVD and one det traced alone; then
               ``tools/synthetic_e2e.py`` for 20 steps at batch 4 with
               ``--icp``, its JSON record complete and finite, and K4 held
               bit for bit and timed on its prefilter calls (a trained
               network's classes, captured as above).
9. reference — the same code on the card (kernels) and on the CPU
               (plain versions): a small frame's forward within 2e-3, and
               the full-width pose stage on labelled votes (several
               classes present) within 1e-4.
10. train    — the training path at full width (``Config.ycb()``, bf16,
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
               BN on its running statistics (the literal eval graph, as
               that test holds it), every leaf within 2e-3 * max|g|.
11. modes    — the JAX package's neighbour and sampling modes: K2's
               capacity (query_mode "pallas"), expanded ("approx") and
               bf16 instances bit for bit against their plain versions at
               the four serving levels (and on an adversarial cloud whose
               indices j, j+128, j+256 coincide, where the capacity result
               must differ from the exact one on some rows, and at 12
               off-path shapes), timed there beside the exact instance
               (events, device, bound, plain, cdist+where+topk); K3's
               expanded instance (interp_mode "exact" / "approx") at the
               four FP levels; grouped FPS (G = 2, 4) against plain FPS on
               the same slabs and against the CPU; then three full-width
               requests in each deployment mode (query_mode "pallas";
               "approx" with interp_mode "exact"; fps_groups 4;
               query_compute "bf16"), every count set to 0 just before
               and read just after, each mode's kernel instances launched,
               median latency beside the exact mode's; and each mode on a
               small frame card against CPU (forward 2e-3, poses 1e-4).
12. disk     — the dataset path through the apps at full width, from
               trees written here by ``tools/fake_data.py`` (under
               ``build/disk``): a YCB tree at 480x640 (8 real frames named
               as the vendored test list's first, 8 synthetic) and a
               LineMOD tree for ape (4 real, 2 render, 2 fuse items).
               ``apps.train.main`` takes 3 steps at batch 4 on YCB with
               host frames from 0 and 2 spawned workers and with
               ``--device_preprocess``, then 2 on LineMOD, each saving a
               checkpoint (launches exactly fps 1, query 4, interp 4,
               interp_bwd 4 a step); the host build's frames/s at 0 and
               2 workers; ``apps.evaluate.main`` on the YCB test split
               from the first checkpoint with host frames,
               ``--device_preprocess``, ``--icp`` and ``--packed_dir``
               (after ``tools/preprocess_testset.py`` packed it), then on
               LineMOD (K1-K4 each launched, K4 more often with
               ``--icp``), frames/s for each; every run counted from 0.
               Then a loader test frame card vs CPU (float32, the
               checkpoint's weights: forward 2e-3, pose stage 1e-4) and
               the first ``--device_preprocess`` training batch built on
               the card and on the CPU from the same raw batch and
               generator (choose, labels, GT slots equal; cloud and
               targets 1e-5).  Its 3 steps and 8 frames check the path
               and are too few for rates: those come from the phase
               alone at 20 steps and 32 frames (``phase_disk(smi,
               steps=20, frames=32)``).
13. native   — the host's C++ twins (``pvn3d_tpu_torch/native``, built
               by g++ from the checkout into ``build/native``): on a
               synthetic 480x640 frame the fill twin against the torch
               fill (within 2e-3, 1e-5 off the 2-pixel border) and the
               normals twin against the numpy normals (the same zero
               pixels, cos >= 0.999), each timed (median of 5), the FPS
               twin's indices equal to the numpy version's; then the
               host frame build's stages apart (decode, augmentation,
               fill, normals, sampling) and the loader's frames/s at 0
               workers, with the twins and with the plain versions, on
               [disk]'s YCB tree.
14. apps     — the apps' and tools' surface, on 480x640 trees written
               here (under ``build/apps``): ``apps.evaluate --occ`` for
               ape at batch 4 on an Occlusion-LineMOD tree (4 annotated
               frames and an unannotated one) with synthesised labels,
               with masks and with ``--device_preprocess``, and with
               ``--packed_dir`` after ``tools/preprocess_testset.py
               --occ`` packed it (frames/s, ADD, launches each; K1-K4
               launched); ``apps.demo`` on the YCB and LineMOD trees, 2
               frames each, from a checkpoint of seeded weights whose
               poses land in view (the PNGs decode to full frames that
               differ from the frames read by the overlays);
               ``apps.train --pretrained_trunk`` for 2 steps at batch 4
               on LineMOD from a torchvision-named dict written here
               (the trunk equals the dict when the first step starts;
               launches exactly fps 1, query 4, interp 4, interp_bwd 4 a
               step); ``tools.check_dataset --render_dir`` on both trees
               (0 violations), ``tools.gen_obj_info`` on a PLY,
               ``knn_normals`` on a 12288-point cloud on the card against
               the CPU (|n.n'| >= 1 - 1e-6); ``utils.profiling.
               device_loop_stats`` around a full-width request (iters 5,
               trials 3) beside [slice]'s latencies, and one ``trace()``
               of two requests whose Chrome trace names K1-K4.  Its 4 occ
               and 2 demo frames check the paths and are too few for
               rates: those come from the phase alone at 32 and 8
               (``phase_apps(smi, lat, occ_frames=32, demo_frames=8)``).
15. parallel — data parallelism at full width, in two parts.  A world-1
               NCCL group in this process (``initialize_distributed``
               with a file store under ``build/parallel``; ``make_mesh``
               takes a group of one rank for none, so the phase builds
               the mesh that holds it): the mesh's
               train step (synced BN, the summed gradient all-reduce, the
               global metrics; ``Config.ycb()``, bf16, batch 4) in turns
               with the plain step from the same weights and batch, three
               of each: the loss and the running statistics bit for bit,
               the gradient within ``SAME_GRAD_L2`` (3e-2) in global L2
               beside two plain steps' distance,
               the parameters bit for bit where two plain steps are (else
               within 2 lr + 1e-6: the card's backward holds atomic
               scatter-adds and Adam moves a rounding-noise entry by lr),
               launches fps
               1, query 4, interp 4, interp_bwd 4 a step, the step times,
               and one mesh step's and one plain step's CUDA-only trace
               (the NCCL kernels' share; the device records a late trace
               lost, logged).  Then two ranks spawned on this card
               (``chip_smoke.py --parallel-rank R 2 SEED``) over gloo
               (NCCL refuses two ranks on one card), float32, dropout 0:
               each rank's step on 2 of a global batch of 4 against one
               process's step on the 4 (the ranks' losses equal; the loss
               within 1e-5 relative, the gradient within 3e-2 in global
               L2 beside two plain steps' distance, the parameters within
               2 lr + 1e-6 + 1e-5 |p|: float32 reduction order and the
               conditioning of a batch-statistics backward), then a
               dp-sharded request of 4 frames (2 a
               rank) against the unsharded one (poses 2e-4, seg equal:
               the tolerances of tests/test_sharded_inference.py); each
               rank's launches are read from its output.
16. remat    — one full-width bf16 step at batch 4 from one state with
               ``remat`` off, "full" and "dots" (and off again, the
               run-to-run floor): the loss within 1e-6 / 3e-5 relative,
               the gradient (dropout on: the replayed masks) within
               ``SAME_GRAD_L2`` in global L2 beside two plain steps',
               the parameters within 1e-6 / 1e-5 (plus 2 lr + 1e-6 where
               two plain steps differ), the running statistics equal to the
               plain step's (moved once), launches fps 2, query 8, interp
               8, interp_bwd 4 a rematerialised step; the torch version;
               then one step at batch 24 in each mode (after one
               untimed), its time and peak memory.
17. bn       — the train-mode BatchNorm pair (``csrc/bn.cu``, five entry
               points) against its plain branch on the card at the
               batch-24 step's shapes, bf16: the stem (24, 64, 240, 320)
               and layer 4 (24, 512, 60, 80) in channels_last and NCHW
               memory, ``up_3`` (24, 64, 480, 640) NCHW and channels_last,
               an SA scale (24, 2048, 32, 128) and a head's rows
               (24 * 12288 by 1024 and by 128), each with and without the
               fused ReLU: statistics, values, running statistics, dx,
               dweight and dbias (the dx of elements whose ReLU mask the
               two sides' roundings flip counted apart), three launches a
               forward and three a backward; events and device ms of each
               pass beside its bytes bound at 3.35 TB/s, the plain
               branch's, the autograd of the plain tensor code it
               replaced, and ``F.batch_norm``'s (cuDNN, the library
               yardstick).  Then a batch-24 ``Config.ycb()`` step (and
               ``remat`` "full" and "dots") through the kernels against
               the same step with the plain branch forced, from one state
               and batch made on the CPU: the losses of three steps, the
               first gradients' median leaf and the parameters' change
               within the benchmark's train limits (0.003, 0.03, 0.2),
               80 statistics and normalise launches a forward and 80
               backward sets a step (twice the forward's under remat),
               the layouts the BNs saw, step time and peak memory of each.
18. a JSON line per kernel and kernel instance (launches on the serving
   slice, [eval_graph]'s requests, the raw requests, the ICP request, the training steps, the
   mode requests, the [disk] runs and the [apps] runs (``launches_apps``),
   the [parallel] and [remat] runs (``launches_parallel``),
   error, times, bound; K2's
   instances and K3 forward and backward also per level, the backward on
   both clouds, K3 forward also at the eval graph's widths
   (``eval_graph``); K4 also per pass on both inputs and at the ICP
   shape),
   the ``nvidia-smi`` line again, then the result line.

The last line is ``{"ok": true, "device": {...}}``; it is printed only when
every phase passed.  Times are the card's under its printed power limit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
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


# CUDA runtime calls that launch a kernel.
_LAUNCH_CALLS = ("LaunchKernel", "LaunchCooperativeKernel")
# Marker kernels launched at the start and at the end of each trace, not
# counted: the launches whose device records a trace loses.
_MARKERS = 16


def _cuda_trace(fn, reps: int = 1, names=()) -> dict:
    """``reps`` calls of ``fn`` in one ``torch.profiler`` trace of CUDA
    activity alone: the device time in ms, the kernel and the copy/memset
    launches, the runtime's synchronisations (the trace's own closing one
    not counted), the kernels whose names hold each of ``names`` and their
    device time (``named_ms``), and whether the trace is complete: each
    kernel launch of ``fn`` that the runtime recorded has its device
    record, matched by correlation id
    (copies are not held so: a memset of no bytes leaves no record).  On
    an H100 a trace loses device records, never runtime calls: once
    earlier phases have run, those of its first launches (which the
    markers take: up to 9 in [modes] on an H100), those of its last
    launches (which the closing markers take: 4 of a 29,393-launch
    sampled ICP call), at times up to 6% of a 31,000-launch call's, and,
    in a trace that also records the CPU, more (K4's ctypes launch among
    them)."""
    from torch._C._autograd import DeviceType
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(_MARKERS):
            torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        for _ in range(_MARKERS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    ev = prof.profiler.kineto_results.events()
    dev = [e for e in ev if e.device_type() == DeviceType.CUDA
           and "spin_kernel" not in e.name()]
    recorded = {e.correlation_id() for e in dev}
    calls = sorted((e for e in ev if e.device_type() != DeviceType.CUDA
                    and any(n in e.name() for n in _LAUNCH_CALLS)),
                   key=lambda e: e.start_ns())[_MARKERS:-_MARKERS]
    copies = sum(e.name().startswith(("Memcpy", "Memset")) for e in dev)
    syncs = sum("Synchronize" in e.name() for e in ev
                if e.device_type() != DeviceType.CUDA)
    by_corr = {e.correlation_id(): e.name() for e in dev}
    lost_at = [(i, c.name(), by_corr.get(calls[i - 1].correlation_id(), "")
                [:70] if i else "") for i, c in enumerate(calls)
               if c.correlation_id() not in recorded][:6]
    return {"device_ms": sum(e.duration_ns() for e in dev) / 1e6,
            "lost_at": lost_at,
            "kernels": len(dev) - copies, "copies": copies,
            "syncs": syncs - 1,
            "named": {n: sum(n in e.name() for e in dev) for n in names},
            "named_ms": {n: sum(e.duration_ns() for e in dev
                                if n in e.name()) / 1e6 for n in names},
            "lost": sum(e.correlation_id() not in recorded for e in calls),
            "complete": len(dev) - copies == len(calls) and all(
                e.correlation_id() in recorded for e in calls)}


def _complete_traces(fn, reps: int = 1, names=(), want: int = 1,
                     attempts: int = 6) -> list:
    """``want`` complete traces (``_cuda_trace``) of ``fn``, of at most
    ``attempts`` taken; raises when fewer were complete."""
    runs = []
    for _ in range(attempts):
        r = _cuda_trace(fn, reps, names)
        runs += [r] if r["complete"] else []
        if len(runs) == want:
            return runs
    raise AssertionError(f"profiler: {len(runs)} of {attempts} traces held "
                         f"a device record for each launch; the last {r}")


def device_ms(fn, reps: int = 5) -> float:
    """Device time per call of the kernels ``fn`` launches, from a complete
    ``torch.profiler`` trace of CUDA activity alone: the kernel alone,
    without the host's launch cost that the CUDA-event time of a short
    kernel also holds.  Raises when the trace shows no device time."""
    ms = _complete_traces(fn, reps)[0]["device_ms"] / reps
    if ms <= 0.0:
        raise AssertionError("device_ms: the trace holds no device time for "
                             "a call that launches a kernel")
    return ms


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
    from pvn3d_tpu_torch.ops.kernels import BN_KERNELS, KERNELS
    from pvn3d_tpu_torch.ops.kernels.common import build_all
    t0 = time.perf_counter()
    kernels = KERNELS + BN_KERNELS
    logs = build_all(kernels)
    for k in kernels:
        k.load()
    dt = time.perf_counter() - t0
    for entry in logs:
        for line in entry.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                log("build", line.strip())
    sources = len({k.source for k in kernels})
    log("build", f"{len(kernels)} kernel instances of {sources} sources "
        f"ready in {dt:.1f} s")


def _expected_launches(**counts) -> dict:
    """Every kernel instance's launch count: ``counts``, 0 for the rest."""
    from pvn3d_tpu_torch.ops.kernels import KERNELS
    return {k.name: counts.get(k.name, 0) for k in KERNELS}


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


def _k2_library(lvl, src, cen):
    """K2's library composition, one unchunked call chain: distances, hit
    indices (misses score N), the ns smallest, then the first-hit fill."""
    d = torch.cdist(cen, src)
    npts = src.shape[1]
    iota = torch.arange(npts, device=src.device)
    res = []
    for r, ns in zip(lvl.radii, lvl.nsamples):
        score = torch.where(d < r, iota, npts)
        vals = torch.topk(score, ns, dim=-1, largest=False).values
        found = vals < npts
        first = torch.where(found[..., 0], vals[..., 0], 0)
        res.append(torch.where(found, vals, first[..., None]))
    return res


def _k2_tests(outs, nsamples, npts) -> float:
    """Pairs K2's scan must test on this run's data: per centroid, up to
    the index of the last slot of the scale that fills last (all N if one
    never fills)."""
    tests = torch.zeros(outs[0].shape[:2], dtype=torch.float64,
                        device=outs[0].device)
    for o, ns in zip(outs, nsamples):
        hits = (o != o[..., :1]).sum(-1) + 1
        stop = torch.where(hits >= ns, o[..., -1].double() + 1, float(npts))
        tests = torch.maximum(tests, stop)
    return float(tests.sum())


def _k3_forward_levels(rng, levels, known_c, phase: str):
    """K3 forward at batch 1 on the serving path's level clouds
    (``levels``: xyz, then each SA level's points) with random known
    features of widths ``known_c`` (fp0 .. fp3), fp3 first: each level
    held against its plain version (indices exact, out/dist within 1e-5),
    timed by events and on the device beside its plain version and
    cdist + topk + gather, with its grid and bound.  Returns (per-level
    records, max error)."""
    from pvn3d_tpu_torch.ops.kernels import interp
    dev = levels[0].device
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
            raise AssertionError(f"K3 interp fp{li} C={c}: indices differ")
        e = _err(got[:2], want[:2])
        if e > 1e-5:
            raise AssertionError(f"K3 interp fp{li} C={c}: max abs err {e}")
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
        log(phase, f"K3 interp fp{li} n={nu} m={nk} C={c}: grid "
            f"{blocks} blocks of {warps} warps, {rows} row(s) a warp; idx "
            f"equal, max err {e:.2e}; {lvl['ms']:.4f} ms, on the device "
            f"{lvl['device_ms']:.4f} ms, bound {lvl['bound_ms']:.4f} ms "
            f"({lvl['bound_by']}); plain {lvl['plain_ms']:.3f}, "
            f"cdist+topk+gather {lvl['library_ms']:.4f}")
    return per_level, err


def phase_kernels(rng):
    """Every kernel against its plain version at the serving path's
    shapes.  Returns {name: record} with the timing and error fields."""
    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.ops.kernels import fps, query
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

        level_lib = time_ms(lambda: _k2_library(lvl, src, cen))
        lib += level_lib
        level_dev = device_ms(lambda: query.ball_query(
            lvl.radii, lvl.nsamples, src, cen))
        log("kernels", f"K2 query L{li} N={npts} m={m}: {level_ms:.4f} ms, "
            f"on the device {level_dev:.4f} ms (cdist+where+topk "
            f"{level_lib:.4f})")
        flops += _k2_tests(got, lvl.nsamples, npts) * (D2_FLOPS
                                                        + len(lvl.radii))
        n_bytes += npts * 12 + m * 12 + m * sum(lvl.nsamples) * 4
        shapes.append(f"L{li} N={npts} m={m} r={lvl.radii}")
    rec["query"] = dict(shapes=shapes, max_abs_err=err, tol="indices exact",
                        ms=ms, plain_ms=plain, library_ms=lib,
                        bound=bound_ms(n_bytes, flops),
                        replaces="pvn3d_tpu/ops/pallas/query.py:118")
    log("kernels", f"K2 query x4 levels: indices equal, {ms:.3f} ms "
        f"(plain {plain:.3f}, cdist+where+topk {lib:.3f})")

    # K3: four launches per frame (fp3 .. fp0), known features of the
    # literal graph's widths (the training path's); the eval graph's
    # widths are held in [eval_graph].  Each level timed, traced and
    # bounded alone.
    widths = [sum(m[-1] for m in lvl.mlps) for lvl in pcfg.sa_levels]
    known_c = [cfg.pointnet2.fp_mlps[i + 1][-1] if i < 3 else widths[3]
               for i in range(4)]
    per_level, err = _k3_forward_levels(rng, levels, known_c, "kernels")
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


def literal_model_config(mcfg):
    """``mcfg`` with the four eval restructures off (the sparse CNN tail
    at batch 1, the fused upsample, the split heads, the SA/FP
    precompute): its eval graph is the literal dense one."""
    import dataclasses
    return dataclasses.replace(
        mcfg, sparse_cnn_eval=False, head_split_global=False,
        cnn=dataclasses.replace(mcfg.cnn, fuse_upsample=False),
        pointnet2=dataclasses.replace(mcfg.pointnet2,
                                      sa_precompute_first=False,
                                      fp_precompute_first=False))


# [eval_graph] tolerances, those of tests/test_torch_eval_graph.py: each
# output within tol * max(1, |ref|) of the literal graph's, the seg
# argmax agreeing on more than the share given.
EVAL_GRAPH_TOL = {"float32": (1e-4, 0.999), "bfloat16": (0.05, 0.95)}
# [eval_graph]'s latency window: requests a graph, the two interleaved.
EVAL_GRAPH_REQUESTS = 50


def phase_eval_graph(smi: str, rng, seed: int = 0):
    """The eval graph at full width (``Config.ycb()``, seeded random
    weights, batch 1): one request through the default graph (the sparse
    CNN tail, the fused upsample, the split heads, the SA/FP precompute)
    and through the literal one (``sparse_cnn=False``, the four fields
    off), in bf16 and float32.  Logs the outputs' largest differences,
    the seg argmax agreement and the poses' difference, and fails above
    ``EVAL_GRAPH_TOL``; in bf16 the two graphs' request latency (host
    clock, ``EVAL_GRAPH_REQUESTS`` each, alternating ABBA so that drift of
    the shared host falls on both), each one's device time and launches
    (a CUDA-only trace); then K3 at the eval graph's widths (fp3 .. fp0
    blending W0 channels) against its plain version.  Returns (K3's record there, the launch counts of
    the requests, each counted from 0)."""
    import dataclasses

    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    from pvn3d_tpu_torch.inference.pipeline import make_inference_step
    from pvn3d_tpu_torch.models.pvn3d import PVN3D
    from pvn3d_tpu_torch.ops.kernels import KERNELS, fps
    from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,
                                              stacked_mesh_kps)
    from pvn3d_tpu_torch.utils.weights import build_model
    dev = torch.device("cuda")
    base = Config.ycb()
    batch = synthetic_batch(base, batch_size=1, seed=7)
    args = [torch.as_tensor(batch[k], device=dev)
            for k in ("pointcloud", "rgb", "choose")]
    kps, radii = stacked_mesh_kps(), stacked_class_radii()
    launches = {k.name: 0 for k in KERNELS}
    for dtype in ("bfloat16", "float32"):
        mcfg = dataclasses.replace(base.model, compute_dtype=dtype)
        auto = build_model(mcfg, seed)
        literal = PVN3D(literal_model_config(mcfg), sparse_cnn=False)
        literal.load_state_dict(auto.state_dict(), strict=True)
        graphs = {"auto": auto, "literal": literal}
        steps = {name: make_inference_step(
            dataclasses.replace(base, model=m.cfg), m, kps, radii,
            device=dev) for name, m in graphs.items()}
        with torch.inference_mode():
            outs = {name: m(*args) for name, m in graphs.items()}
        if tuple(outs["auto"]["rgb_seg"].shape) != (
                1, mcfg.n_sample_points, mcfg.n_classes):
            raise AssertionError(f"eval_graph: the auto graph's rgb_seg is "
                                 f"{tuple(outs['auto']['rgb_seg'].shape)},"
                                 f" not the sparse tail's")
        tol, min_agree = EVAL_GRAPH_TOL[dtype]
        diffs = {}
        for key in ("seg_logits", "kp_offsets", "ctr_offsets"):
            a, b = outs["auto"][key], outs["literal"][key]
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"eval_graph {dtype}: {key} not finite")
            scale = max(1.0, float(b.abs().max()))
            diffs[key] = (float((a - b).abs().max()), scale)
        agree = float((outs["auto"]["seg_logits"].argmax(-1)
                       == outs["literal"]["seg_logits"].argmax(-1)
                       ).float().mean())
        res = {name: step(batch) for name, step in steps.items()}
        both = res["auto"]["present"] & res["literal"]["present"]
        pose_diff = float((res["auto"]["poses"] - res["literal"]["poses"])
                          [both].abs().max()) if bool(both.any()) else 0.0
        present = (int(res["auto"]["present"].sum()),
                   int(res["literal"]["present"].sum()))
        log("eval_graph", f"{dtype}, 480x640 + 12288 points, batch 1, auto "
            f"graph vs literal: max abs diff " + ", ".join(
                f"{k} {d:.3e} (|ref| {sc:.3g})" for k, (d, sc) in
                diffs.items())
            + f"; seg argmax agreement {agree:.5f}; present classes "
            f"{present[0]} / {present[1]}, pose max abs diff on the "
            f"{int(both.sum())} present in both {pose_diff:.3e} "
            f"(random weights: logged, not held) [{smi}]")
        bad = [k for k, (d, sc) in diffs.items() if d > tol * sc]
        if bad or agree <= min_agree:
            raise AssertionError(f"eval_graph {dtype}: {bad} above "
                                 f"{tol} * max(1, |ref|), or agreement "
                                 f"{agree} <= {min_agree}")
        if dtype != "bfloat16":
            continue
        lat = {name: [] for name in steps}
        for i in range(EVAL_GRAPH_REQUESTS):
            order = ("auto", "literal") if i % 2 == 0 else ("literal",
                                                            "auto")
            for name in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps[name](batch)
                torch.cuda.synchronize()
                lat[name].append((time.perf_counter() - t0) * 1e3)
        for name, step in steps.items():
            _, counts = _counted(lambda: step(batch))
            for k, v in counts.items():
                launches[k] += v
            q = np.percentile(lat[name], [10, 50, 90])
            trace = _device_trace(lambda: step(batch), min_kernels=10)
            with torch.inference_mode():
                fwd = time_ms(lambda: graphs[name](*args), reps=1)
            log("eval_graph", f"bf16 {name} graph: request median "
                f"{q[1]:.2f} ms, p10 {q[0]:.2f}, p90 {q[2]:.2f} (host "
                f"clock, {len(lat[name])} requests alternating with the "
                f"other graph's), forward alone {fwd:.2f} ms (events); on "
                f"the device {trace['device_ms']:.2f} ms, "
                f"{trace['kernels']} kernel and {trace['copies']} copy "
                f"launches; K1-K4 launches "
                f"{ {k: v for k, v in counts.items() if v} } [{smi}]")
        del graphs, steps, auto, literal, outs
        torch.cuda.empty_cache()

    # K3 on the eval graph's main path: each FP level blends its first
    # layer's output, W0 channels.
    pcfg = base.model.pointnet2
    xyz = args[0][..., :3].contiguous()
    m0 = pcfg.sa_levels[0].npoint
    pts = xyz[0, fps.fps(xyz, m0)[0].long()][None]
    levels = [xyz] + [pts[:, :lvl.npoint].contiguous()
                      for lvl in pcfg.sa_levels]
    w0 = [pcfg.fp_mlps[i][0] for i in range(4)]
    per_level, err = _k3_forward_levels(rng, levels, w0, "eval_graph")
    rec = _level_record(per_level, err, "indices exact, out/dist 1e-5",
                        "pvn3d_tpu/ops/pallas/interp.py:162")
    log("eval_graph", f"K3 interp x4 levels at C = "
        f"{'/'.join(str(w0[i]) for i in range(3, -1, -1))} (fp3 .. fp0): "
        f"{rec['ms']:.4f} ms, on the device {rec['device_ms']:.4f} ms, "
        f"bound {rec['bound'][0]:.4f} ms (plain {rec['plain_ms']:.3f}, "
        f"cdist+topk+gather {rec['library_ms']:.4f}) [{smi}]")
    return rec, launches


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


def raw_meshes(rng, n_cls: int, n_mesh: int = 2000):
    """Meshes of the YCB size for the raw and ICP phases: ``n_cls`` point
    sets of ``n_mesh`` points in a 12 cm cube, the first 1500 valid and
    the rest half valid."""
    mesh_pts = rng.uniform(-0.06, 0.06, (n_cls, n_mesh, 3)).astype(
        np.float32)
    mesh_valid = np.ones((n_cls, n_mesh), bool)
    mesh_valid[:, 1500:] = rng.rand(n_cls, n_mesh - 1500) < 0.5
    return mesh_pts, mesh_valid


def phase_raw(smi: str, seed: int = 0):
    """Raw RGB-D frames through ``make_raw_inference_step`` on the card at
    full width: three requests with every launch count set to 0 just
    before and read just after (fps 1, query 4, interp 4, winner 3 a
    request, no backward); the frame build's stages by CUDA events and its
    launches and device time from a profiler trace; the frame build held
    against the CPU's on the same full-size frame and priorities; the
    metrics branch on the card against the CPU; then the serving app in
    this process.  Returns the launch counts of the three requests."""
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
    n_cls = mc.n_classes
    mesh_pts, mesh_valid = raw_meshes(rng, n_cls)
    n_mesh = mesh_pts.shape[1]
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
    want = _expected_launches(fps=3, query=12, interp=12, winner=9)
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
    tr = _complete_traces(build)[0]
    build_launches = tr["kernels"] + tr["copies"]
    build_dev_ms = tr["device_ms"]
    log("raw", f"frame build, one {h}x{w} frame, CUDA events ms (median of "
        "3): " + ", ".join(f"{key} {v:.3f}" for key, v in stage.items())
        + f"; device {build_dev_ms:.3f} ms in {build_launches} kernel and "
        f"copy launches (profiler) [{smi}]")
    # One whole raw request in a trace: wall clock, device busy, launches
    # (the wall clock of the complete trace's call, the last one taken).
    walls = []

    def traced_request():
        t0 = time.perf_counter()
        step(request(4), gen(4))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    tr = _complete_traces(traced_request)[0]
    log("raw", f"one raw request in a trace: wall {walls[-1]:.2f} ms, device "
        f"busy {tr['device_ms']:.3f} ms in {tr['kernels'] + tr['copies']} "
        f"kernel and copy launches")

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


@contextlib.contextmanager
def _capture(module, name: str, calls: list):
    """Record (args, kwargs, result) of every call of ``module.name`` while
    the block runs, then put the function back."""
    real = getattr(module, name)

    def wrapper(*a, **k):
        out = real(*a, **k)
        calls.append((a, k, out))
        return out
    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def _device_trace(fn, expect=None, min_kernels: int = 1):
    """The device side of a call of ``fn``: after a warm-up call, two
    complete traces of one call each (``_complete_traces``).  Returns the
    device busy ms (mean of the two), the kernel and copy/memset launches
    and the synchronisations.  Raises unless the two agree on the launches
    and hold at least ``min_kernels`` kernels, positive device time where
    they hold one, and for each kernel name part in ``expect`` that many
    launches of kernels so named."""
    fn()
    a, b = _complete_traces(fn, names=tuple(expect or ()), want=2)
    if ((a["kernels"], a["copies"]) != (b["kernels"], b["copies"])
            or a["kernels"] < min_kernels or a["named"] != (expect or {})
            or b["named"] != a["named"]
            or (a["kernels"] and min(a["device_ms"], b["device_ms"]) <= 0)):
        raise AssertionError(f"device trace: {a} and {b}, expected at "
                             f"least {min_kernels} kernels and {expect}")
    return {"device_ms": (a["device_ms"] + b["device_ms"]) / 2,
            "kernels": a["kernels"], "copies": a["copies"],
            "syncs": a["syncs"]}


def _host_reads(fn) -> int:
    """Host reads of a device scalar (``aten::_local_scalar_dense``) in one
    call of ``fn``, from a profiler trace of CPU activity alone (run after
    the phase's device traces)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key == "aten::_local_scalar_dense")


def _k4_record(winner, pts, msk, bw, got, launches: int, dev) -> dict:
    """K4 on captured inputs: equal to its plain version bit for bit (the
    captured result and a new launch), its event, device, plain and
    ``cdist`` yardstick times, and the bound of the valid pairs."""
    hyp, kk = msk.shape

    def kernel():
        return winner.winner_stats(pts, msk, bw)
    want = winner.winner_stats_plain(pts, msk, bw)
    if not (_index_equal(got, want) and _index_equal(kernel(), want)):
        raise AssertionError(f"K4 winner at H={hyp} K={kk} differs from "
                             f"plain")

    def library():
        inb = ((torch.cdist(pts, pts) < bw) & msk[:, None, :]
               & msk[:, :, None])
        num = inb.sum(-1, dtype=torch.int32)
        wn = num.argmax(-1)
        rows = torch.arange(hyp, device=dev)
        return wn, inb[rows, wn], num[rows, wn]
    v = msk.sum(1).double()
    rec = {"shape": f"H={hyp} K={kk} bw={bw}", "launches": launches,
           "max_abs_err": _err(got, want), "tol": "bit for bit",
           "valid": int(v.sum()), "hypotheses_with_points": int((v > 0).sum()),
           "threads": winner.cta_threads(hyp),
           "ms": time_ms(kernel), "device_ms": device_ms(kernel),
           "plain_ms": time_ms(lambda: winner.winner_stats_plain(pts, msk, bw),
                               reps=1),
           "library_ms": time_ms(library)}
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        hyp * kk * 14 + hyp * 8, float((v * v + v).sum()) * (D2_FLOPS + 1))
    return rec


def _near_ties(pts, samples, sample_labels, got, want):
    """Of the pixels whose labels ``got`` and ``want`` differ, the share
    whose nearest samples with those two labels lie within float32
    rounding of each other in float64 d^2 (8 ulps of |p|^2 + |s|^2)."""
    bad = np.flatnonzero(got != want)
    if bad.size == 0:
        return 0, 1.0
    p = pts[bad].astype(np.float64)
    s = samples.astype(np.float64)
    d2 = ((p[:, None, :] - s[None]) ** 2).sum(-1)
    near = 0
    for row, i in enumerate(bad):
        a = d2[row][sample_labels == got[i]].min()
        b = d2[row][sample_labels == want[i]].min()
        ulp = 8 * np.finfo(np.float32).eps * (
            (p[row] ** 2).sum() + (s[d2[row].argmin()] ** 2).sum())
        near += abs(a - b) <= ulp
    return bad.size, near / bad.size


def _well_posed_icp(icp, mesh_pts, mesh_valid, seed: int):
    """``icp_refine`` on the card and on the CPU over one problem per
    foreground mesh: the mesh seen from a random pose ~1 m away with 2 mm
    noise, started ~3 degrees and 1 cm off.  Returns the largest pose
    difference card vs CPU, the largest difference from the GT, and both
    iteration counts."""
    from pvn3d_tpu_torch.data.synthetic_world import SyntheticWorld
    rng = np.random.RandomState(seed + 2)
    world = SyntheticWorld(n_classes=2)
    mesh, valid = mesh_pts[1:], mesh_valid[1:]
    gt = np.stack([world.random_pose(rng) for _ in range(len(mesh))])
    scene = (np.einsum("bij,bnj->bni", gt[..., :3], mesh)
             + gt[:, None, :, 3] + rng.normal(0, 0.002, mesh.shape))
    init = gt.copy()
    for i in range(len(gt)):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        a = 0.05
        r = np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * (k @ k)
        init[i, :, :3] = gt[i, :, :3] @ r
        init[i, :, 3] += rng.uniform(-0.01, 0.01, 3)
    args = [np.asarray(x, dtype) for x, dtype in (
        (mesh, np.float32), (valid, bool), (scene, np.float32),
        (valid, bool), (init, np.float32))]
    out = {}
    for d in ("cuda", "cpu"):
        out[d] = icp.icp_refine(*(torch.as_tensor(a, device=d)
                                  for a in args), tolerance=1e-6)
    diff = float((out["cuda"][0].cpu() - out["cpu"][0]).abs().max())
    from_gt = float((out["cpu"][0] - torch.as_tensor(gt)).abs().max())
    return diff, from_gt, (int(out["cuda"][2][0]), int(out["cpu"][2][0]))


def phase_icp(smi: str, seed: int = 0):
    """ICP after a raw request at full width: full-resolution ICP on the
    raw step's filled depth, then sampled ICP on the same frame, each
    timed (events, median of 3) and traced (device time, kernel and copy
    launches from traces of CUDA activity alone; host reads from one of
    CPU activity alone, taken last), with its iterations and the classes
    that passed the gate, and the 1-NN propagation alone; K4 held bit for
    bit against its plain version on the prefilter's own inputs (captured
    by wrapping ``winner_stats``) and timed at that shape; ``icp_refine``
    (on the captured scene and on well-posed problems) and the propagation
    on the card against the CPU; one SVD and one det traced; then the
    accuracy tool for 20 steps with ``--icp``, its prefilter calls (a
    trained network's classes) captured and held and timed as above.
    Returns (launches of one raw request with both ICP modes, counted from
    0; K4's records at the ICP shape)."""
    import gc

    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.data.synthetic import synth_sensor_frame
    from pvn3d_tpu_torch.inference import icp
    from pvn3d_tpu_torch.inference import pipeline
    from pvn3d_tpu_torch.ops.kernels import KERNELS, winner
    from pvn3d_tpu_torch.tools import synthetic_e2e
    from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,
                                              stacked_mesh_kps)
    from pvn3d_tpu_torch.utils.weights import build_model
    dev = torch.device("cuda")
    cfg = Config.ycb()
    mc = cfg.model
    h, w = mc.image_height, mc.image_width
    n_cls = mc.n_classes
    mesh_pts, mesh_valid = raw_meshes(np.random.RandomState(seed), n_cls)
    raw = pipeline.make_raw_inference_step(
        cfg, build_model(mc, seed), stacked_mesh_kps(),
        stacked_class_radii(), device=dev)
    icp_step = pipeline.make_icp_step(cfg, mesh_pts, mesh_valid)
    rgb, depth, k = synth_sensor_frame(h, w, seed=1)
    batch = {"rgb": rgb, "depth": depth, "cam_k": k}

    def request():
        return raw(batch, torch.Generator(device=dev).manual_seed(1))

    def args_of(out, mode):
        base = (out["pointcloud"][..., :3], out["seg"], out["poses"])
        return base + ((out["depth_m"], k) if mode == "fullres" else ())
    out = request()                                        # warm-up
    for mode in ("fullres", "sampled"):
        icp_step(*args_of(out, mode))
    torch.cuda.synchronize()

    # The counted run: one raw request, then ICP in both modes, each
    # counted from 0.
    for kern in KERNELS:
        kern.launches = 0
    out = request()
    torch.cuda.synchronize()
    req_launches = {kern.name: kern.launches for kern in KERNELS}
    for kern in KERNELS:
        kern.launches = 0
    wins = []
    with _capture(icp, "winner_stats", wins):
        refined = {"fullres": icp_step(*args_of(out, "fullres"))}
    refined["sampled"] = icp_step(*args_of(out, "sampled"))
    torch.cuda.synchronize()
    icp_launches = {kern.name: kern.launches for kern in KERNELS}
    launches = {n: req_launches[n] + icp_launches[n] for n in req_launches}
    want = _expected_launches(fps=1, query=4, interp=4, winner=3)
    want_icp = _expected_launches(winner=2)
    if req_launches != want or icp_launches != want_icp:
        raise AssertionError(f"icp: launches {req_launches} for the "
                             f"request and {icp_launches} for ICP, expected "
                             f"{want} and {want_icp}")
    for m, r in refined.items():
        if (r.shape != (1, n_cls, 3, 4) or not bool(torch.isfinite(r).all())
                or not torch.equal(r[:, 0], out["poses"][:, 0])):
            raise AssertionError(f"icp {m}: refined poses {r.shape}")
    log("icp", f"one raw request, then full-res and sampled ICP, each "
        f"counted from 0: launches {req_launches} and {icp_launches}")

    # K4 at the ICP shape, on the prefilter's own inputs.
    (pts, msk, bw), _, wgot = wins[0]
    k4 = _k4_record(winner, pts, msk, bw, wgot, icp_launches["winner"], dev)
    log("icp", f"K4 winner at the ICP shape {k4['shape']}: grid "
        f"{msk.shape[0]} clusters x {winner.CLUSTER} CTAs of {k4['threads']} "
        f"threads, {k4['valid']} valid points in "
        f"{k4['hypotheses_with_points']} hypotheses; equal to plain bit for "
        f"bit; {k4['ms']:.4f} ms, on the device {k4['device_ms']:.4f} ms, "
        f"bound {k4['bound_ms']:.4f} ms ({k4['bound_by']}); plain "
        f"{k4['plain_ms']:.3f}, cdist+lt+sum+argmax {k4['library_ms']:.4f} "
        f"[{smi}]")

    min_pts = cfg.icp.min_class_points
    per_mode, captured = {}, {}
    for mode in ("fullres", "sampled"):
        a = args_of(out, mode)
        refines, frames, props = [], [], []
        with _capture(icp, "icp_refine", refines), \
                _capture(pipeline, "refine_frame_poses", frames), \
                _capture(icp, "propagate_labels_fullres", props):
            icp_step(*a)
        torch.cuda.synchronize()
        fa, fk, _ = frames[0]
        counts = fk["gate_counts"]
        if counts is None:
            counts = fa[4].sum(-1)
        rec = {"ms": time_ms(lambda: icp_step(*a), reps=1),
               "n_iter": int(refines[0][2][2][0]),
               "gate_passed": int((counts >= min_pts).sum()),
               "classes_with_points": int((counts > 0).sum())}
        rec.update(_device_trace(lambda: icp_step(*a),
                                 expect={"winner_kernel": 1}))
        per_mode[mode] = rec
        captured[mode] = (refines[0], props)
        log("icp", f"{mode} ICP, one {h}x{w} raw frame, {n_cls - 1} "
            f"classes x {cfg.icp.max_scene_points} scene points x "
            f"{mesh_pts.shape[1]} mesh points: "
            f"{rec['ms']:.2f} ms (events, median of 3), device "
            f"{rec['device_ms']:.3f} ms in {rec['kernels']} kernel and "
            f"{rec['copies']} copy launches, {rec['syncs']} "
            f"synchronisations; {rec['n_iter']} iterations; "
            f"{rec['gate_passed']} of {rec['classes_with_points']} classes "
            f"with points passed the gate (>= {min_pts}) [{smi}]")

    # The 1-NN propagation alone, on its own inputs (full-res mode): at
    # least an addmm and an argmin a chunk.
    pa, _, plabels = captured["fullres"][1][0]
    prop = lambda: icp.propagate_labels_fullres(*pa)      # noqa: E731
    prop_ms = time_ms(prop, reps=1)
    prop_tr = _device_trace(prop, min_kernels=2 * -(-pa[0].shape[0] // 4096))
    log("icp", f"1-NN propagation {pa[0].shape[0]} pixels x "
        f"{pa[2].shape[0]} samples (chunks of 4096): {prop_ms:.3f} ms "
        f"(events), device "
        f"{prop_tr['device_ms']:.3f} ms in {prop_tr['kernels']} kernel "
        f"launches [{smi}]")
    # ... on the card against the CPU, on every 16th pixel.
    cloud, valid, samples, slabels = (t.cpu() for t in pa)
    sub = slice(None, None, 16)
    cpu_labels = icp.propagate_labels_fullres(cloud[sub], valid[sub],
                                              samples, slabels).numpy()
    card_labels = plabels.cpu().numpy()[sub]
    n_bad, near = _near_ties(cloud[sub].numpy(), samples.numpy(),
                             slabels.numpy(), card_labels, cpu_labels)
    if near < 1.0:
        raise AssertionError(f"icp: propagation card vs CPU: {n_bad} "
                             f"mismatches, {near:.3f} at near-ties")
    log("icp", f"propagation card vs CPU on {card_labels.size} pixels "
        f"(every 16th): {n_bad} label mismatches, {near:.3f} of them at "
        f"near-ties")

    # icp_refine on the card against the CPU, on the full-res scene.
    (ra, rk, (card_poses, card_err, card_iter)) = captured["fullres"][0]
    cpu_poses, cpu_err, cpu_iter = icp.icp_refine(
        *(t.cpu() for t in ra), **rk)
    has = ra[3].cpu().any(-1)
    pose_diff = float((card_poses.cpu() - cpu_poses)[has].abs().max()) \
        if bool(has.any()) else 0.0
    if not (bool(torch.isfinite(card_poses).all())
            and bool(torch.isfinite(cpu_poses).all())):
        raise AssertionError("icp: non-finite refined poses")
    log("icp", f"icp_refine card vs CPU on the full-res scene "
        f"({int(has.sum())} problems with points, random-weight initial "
        f"poses): largest pose difference {pose_diff:.3e}, mean error card "
        f"{card_err.cpu()[has].numpy().round(6).tolist()} vs CPU "
        f"{cpu_err[has].numpy().round(6).tolist()} m, iterations "
        f"{int(card_iter[0])} vs {int(cpu_iter[0])}")
    wp_diff, wp_gt, wp_iter = _well_posed_icp(icp, mesh_pts, mesh_valid,
                                              seed)
    if not (wp_diff < 1e-3 and wp_gt < 2e-2):
        raise AssertionError(f"icp: well-posed ICP card vs CPU {wp_diff}, "
                             f"from the GT {wp_gt}")
    log("icp", f"icp_refine card vs CPU on {n_cls - 1} well-posed problems "
        f"(each mesh 1 m away, 2 mm noise, started ~3 degrees and 1 cm "
        f"off; tolerance 1e-6): largest pose difference {wp_diff:.3e}, "
        f"largest from the GT {wp_gt:.3e}, iterations card / CPU "
        f"{wp_iter[0]} / {wp_iter[1]}")
    # Where ICP's synchronisations come from: one batched SVD and one det
    # of the fit's 21 3x3 matrices, alone.
    h3 = torch.randn(n_cls - 1, 3, 3, device=dev)
    lin = {"svd": lambda: torch.linalg.svd(h3),
           "det": lambda: torch.linalg.det(h3)}
    lin_tr = {n: _device_trace(f, min_kernels=0) for n, f in lin.items()}

    # The accuracy tool, short, at full width; its prefilter calls carry a
    # trained network's classes.
    buf, tool_wins = io.StringIO(), []
    with contextlib.redirect_stdout(buf), \
            _capture(icp, "winner_stats", tool_wins):
        res = synthetic_e2e.main(["--steps", "20", "--batch", "4",
                                  "--eval_frames", "4", "--icp"])
    for line in buf.getvalue().splitlines():
        log("icp", f"synthetic_e2e: {line}")
    keys = {"metric", "value", "add_auc", "adds_auc", "eval_seg_acc",
            "steps", "icp"}
    icp_keys = {"add_s_auc", "add_auc", "adds_auc", "delta_add_auc",
                "delta_adds_auc", "scene_mode"}
    nums = [v for kk_, v in res.items() if kk_ not in ("metric", "icp")]
    nums += [v for kk_, v in res["icp"].items() if kk_ != "scene_mode"]
    if (set(res) != keys or set(res["icp"]) != icp_keys
            or not all(np.isfinite(nums))):
        raise AssertionError(f"icp: synthetic_e2e record {res}")
    if not tool_wins:
        raise AssertionError("icp: the tool's ICP ran no prefilter")
    trained = [_k4_record(winner, *ta, tout, 1, dev)
               for ta, _, tout in tool_wins]
    for t in trained:
        log("icp", f"K4 winner on the tool's prefilter inputs (20 trained "
            f"steps) {t['shape']}: {t['valid']} valid points in "
            f"{t['hypotheses_with_points']} hypotheses; equal to plain bit "
            f"for bit; {t['ms']:.4f} ms, on the device "
            f"{t['device_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}); plain {t['plain_ms']:.3f}, "
            f"cdist+lt+sum+argmax {t['library_ms']:.4f} [{smi}]")

    # Host reads last, in traces of CPU activity alone: one loop read an
    # iteration and one at its end, plus the SVD's.
    for mode, rec in per_mode.items():
        a = args_of(out, mode)
        rec["host_reads"] = _host_reads(lambda: icp_step(*a))
        if rec["host_reads"] < rec["n_iter"] + 1:
            raise AssertionError(f"icp {mode}: {rec['host_reads']} host reads "
                                 f"for {rec['n_iter']} iterations")
        log("icp", f"{mode} ICP: {rec['host_reads']} host reads for "
            f"{rec['n_iter']} iterations")
    for n, f in lin.items():
        t = lin_tr[n]
        log("icp", f"one torch.linalg.{n} of {n_cls - 1} 3x3 matrices: "
            f"{_host_reads(f)} host reads, {t['syncs']} synchronisations, "
            f"{t['kernels']} kernels and {t['copies']} copies, "
            f"{t['device_ms']:.4f} ms device")
    # The traces' and the tool's garbage is collected here, not inside the
    # next phase's timed steps.
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(k4, modes=per_mode, trained=trained,
                          propagation_ms=prop_ms,
                          propagation_device_ms=prop_tr["device_ms"],
                          icp_refine_card_vs_cpu=pose_diff)


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
    if accum_launches != _expected_launches(
            **{name: 2 * n for name, n in want.items()}):
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
    # The eval restructures off: train mode never takes them, and the
    # running-statistics backward is held on the literal graph, as
    # tests/test_torch_train.py holds it against the JAX package.
    mcfg = literal_model_config(small_model_config())
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


# The JAX package's deployment modes that [modes] drives at full width,
# and the kernel instances each must launch.
DEPLOY_MODES = {
    "query_mode=pallas": (dict(query_mode="pallas"),
                          ("query_capacity", "interp")),
    "query_mode=approx, interp_mode=exact": (
        dict(query_mode="approx", interp_mode="exact"),
        ("query_expanded", "interp_expanded")),
    "fps_groups=4": (dict(fps_groups=4), ("fps", "query", "interp")),
    "query_compute=bf16": (dict(query_compute="bf16"), ("query_bf16",)),
}


def _with_pointnet2(model_cfg, **over):
    import dataclasses
    return dataclasses.replace(model_cfg, pointnet2=dataclasses.replace(
        model_cfg.pointnet2, **over))


# What each K2 instance replaces: the Pallas kernel, or the XLA arm of
# ball_query_multi (its bf16 cast at :109).
_K2_REPLACES = {"query": "pvn3d_tpu/ops/pallas/query.py:118",
                "query_capacity": "pvn3d_tpu/ops/pallas/query.py:118",
                "query_expanded": "pvn3d_tpu/ops/grouping.py:88",
                "query_bf16": "pvn3d_tpu/ops/grouping.py:109"}


def _k2_variant(name, lvl, src, cen, capacity):
    """(kernel call, plain call) of K2 instance ``name`` at one level."""
    from pvn3d_tpu_torch.ops.kernels import query
    r, ns = lvl.radii, lvl.nsamples
    if name == "query_capacity":
        return (lambda: query.ball_query(r, ns, src, cen, expanded=True,
                                         capacity=capacity),
                lambda: query.ball_query_capacity_plain(r, ns, src, cen,
                                                        capacity))
    kw = {"query": {}, "query_expanded": {"expanded": True},
          "query_bf16": {"bf16": True}}[name]
    return (lambda: query.ball_query(r, ns, src, cen, **kw),
            lambda: query.ball_query_plain(r, ns, src, cen, **kw))


def _k2_modes_levels(levels, pcfg, smi):
    """K2's capacity, expanded and bf16 instances (bf16 in both d^2
    forms) held bit for bit against their plain versions at the four
    serving levels, and timed there beside the exact instance (events,
    device, bound, plain, cdist+where+topk).  Returns {name: record}."""
    from pvn3d_tpu_torch.ops.kernels import query
    cap = pcfg.query_capacity
    rec = {}
    for name in ("query", "query_capacity", "query_expanded", "query_bf16"):
        per_level = []
        for li, lvl in enumerate(pcfg.sa_levels):
            src, cen = levels[li], levels[li + 1]
            kernel, plain = _k2_variant(name, lvl, src, cen, cap)
            got = kernel()
            if not _index_equal(got, plain()):
                raise AssertionError(f"modes: K2 {name} L{li}: kernel "
                                     f"differs from plain")
            if name == "query_bf16":
                r, ns = lvl.radii, lvl.nsamples
                if not _index_equal(
                        query.ball_query(r, ns, src, cen, expanded=True,
                                         bf16=True),
                        query.ball_query_plain(r, ns, src, cen,
                                               expanded=True, bf16=True)):
                    raise AssertionError(f"modes: K2 bf16 expanded L{li}: "
                                         f"kernel differs from plain")
            npts, m = src.shape[1], cen.shape[1]
            n_bytes = npts * 12 + m * 12 + m * sum(lvl.nsamples) * 4
            flops = _k2_tests(got, lvl.nsamples, npts) * (D2_FLOPS
                                                          + len(lvl.radii))
            lv = dict(level=f"L{li}", n=npts, m=m, C=0,
                      ms=time_ms(kernel), device_ms=device_ms(kernel),
                      plain_ms=time_ms(plain, reps=1),
                      library_ms=time_ms(lambda: _k2_library(lvl, src,
                                                             cen)),
                      n_bytes=n_bytes, flops=flops)
            lv["bound_ms"], lv["bound_by"] = bound_ms(n_bytes, flops)
            per_level.append(lv)
        rec[name] = _level_record(per_level, 0.0, "indices exact",
                                  _K2_REPLACES[name])
    for li in range(len(pcfg.sa_levels)):
        ex = rec["query"]["levels"][li]
        cp = rec["query_capacity"]["levels"][li]
        log("modes", f"K2 L{li} N={ex['n']} m={ex['m']}: capacity "
            f"{cap} {cp['ms']:.4f} ms, on the device {cp['device_ms']:.4f} "
            f"ms, bound {cp['bound_ms']:.4f} ms ({cp['bound_by']}) | exact "
            f"{ex['ms']:.4f} ms, on the device {ex['device_ms']:.4f} ms, "
            f"bound {ex['bound_ms']:.4f} ms | expanded "
            f"{rec['query_expanded']['levels'][li]['device_ms']:.4f}, bf16 "
            f"{rec['query_bf16']['levels'][li]['device_ms']:.4f} ms on the "
            f"device; cdist+where+topk {ex['library_ms']:.4f} ms ({smi})")
    for name, r in rec.items():
        log("modes", f"K2 {name} x4 levels: equal to plain; {r['ms']:.4f} "
            f"ms, on the device {r['device_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}); plain "
            f"{r['plain_ms']:.3f}, cdist+where+topk {r['library_ms']:.4f}")
    return rec


def _k2_modes_edges(rng, levels, pcfg):
    """The capacity instance on an adversarial cloud (indices j, j + 128
    and j + 256 co-located, so capacity 2 drops hits) and every K2
    instance at shapes off the serving path."""
    from pvn3d_tpu_torch.ops.kernels import fps, query
    dev = levels[0].device
    lvl0 = pcfg.sa_levels[0]
    adv = levels[0].clone()
    for b0 in range(0, adv.shape[1] - 383, 384):
        adv[:, b0 + 128:b0 + 256] = adv[:, b0:b0 + 128]
        adv[:, b0 + 256:b0 + 384] = adv[:, b0:b0 + 128]
    cen = adv[:, fps.fps(adv, lvl0.npoint)[0].long()]
    r, ns, cap = lvl0.radii, lvl0.nsamples, pcfg.query_capacity
    got = query.ball_query(r, ns, adv, cen, expanded=True, capacity=cap)
    if not _index_equal(got, query.ball_query_capacity_plain(r, ns, adv, cen,
                                                             cap)):
        raise AssertionError("modes: K2 capacity on the adversarial cloud "
                             "differs from plain")
    exact = query.ball_query(r, ns, adv, cen)
    differ = [int((g != e).any(-1).sum()) for g, e in zip(got, exact)]
    if not all(d > 0 for d in differ):
        raise AssertionError(f"modes: the adversarial cloud's capacity "
                             f"result equals the exact one ({differ})")
    log("modes", f"adversarial cloud N={adv.shape[1]} (j, j+128, j+256 "
        f"co-located), m={cen.shape[1]}: capacity {cap} equals plain; rows "
        f"differing from the exact K2 per scale {differ}")

    def cloud(b, n, scale=0.3):
        return torch.tensor((rng.rand(b, n, 3).astype(np.float32) - 0.5)
                            * scale, device=dev)
    depth = levels[0]
    cases = [  # (points, centroids, radii, nsamples, capacity)
        ("N=1000, m=77", cloud(1, 1000), (0.05, 0.1), (16, 32), 2, 77),
        ("B=2 N=4097, m=1001", cloud(2, 4097), (0.03, 0.06), (16, 32), 1,
         1001),
        ("N=130, m=5, ns=64", cloud(1, 130), (0.2,), (64,), 3, 5),
        ("depth N=12288, m=333", depth, lvl0.radii, lvl0.nsamples, 3, 333),
        ("N=129, 3 scales", cloud(1, 129), (0.1, 0.2, 0.4), (8, 16, 64), 2,
         7),
        ("B=2 N=640, r=0.5 (every point hits)", cloud(2, 640), (0.5,),
         (64,), 1, 64),
        ("N=12000, m=2048", cloud(1, 12000, 0.6), (0.0175, 0.025), (16, 32),
         2, 2048),
        ("N=32 < ns", cloud(1, 32), (1.0,), (64,), 2, 3),
        ("B=2 N=3000, 4 scales", cloud(2, 3000), (0.05, 0.1, 0.2, 0.3),
         (4, 8, 16, 64), 3, 513),
        ("r=0: empty balls", cloud(1, 2048), (0.0,), (16,), 2, 2),
        ("N=777, ns=48", cloud(1, 777), (0.08,), (48,), 1, 100),
        ("N=6000, ns=64", cloud(1, 6000), (0.02, 0.04), (32, 64), 2, 1500),
    ]
    for name, pts, radii, nss, c, m in cases:
        cen = pts[:, :m] + 0.001
        checks = {
            "capacity": (query.ball_query(radii, nss, pts, cen,
                                          expanded=True, capacity=c),
                         query.ball_query_capacity_plain(radii, nss, pts,
                                                         cen, c)),
            "expanded": (query.ball_query(radii, nss, pts, cen,
                                          expanded=True),
                         query.ball_query_plain(radii, nss, pts, cen,
                                                expanded=True)),
            "bf16": (query.ball_query(radii, nss, pts, cen, bf16=True),
                     query.ball_query_plain(radii, nss, pts, cen,
                                            bf16=True)),
            "bf16 expanded": (query.ball_query(radii, nss, pts, cen,
                                               expanded=True, bf16=True),
                              query.ball_query_plain(radii, nss, pts, cen,
                                                     expanded=True,
                                                     bf16=True)),
        }
        for kind, (a, b) in checks.items():
            if not _index_equal(a, b):
                raise AssertionError(f"modes: K2 {kind} {name} (capacity "
                                     f"{c}) differs from plain")
    log("modes", f"{len(cases)} off-path shapes (N not a multiple of 128, "
        f"m not a multiple of 4, ns up to 64, capacity 1-3, 1-4 scales): "
        f"K2 capacity, expanded, bf16 and bf16 expanded equal their plain "
        f"versions")


def _k3_expanded_levels(rng, levels, known_c, smi):
    """K3's expanded instance at the four FP levels: held against its
    plain version as the fused one is, timed beside it."""
    from pvn3d_tpu_torch.ops.kernels import interp
    dev = levels[0].device
    per_level = []
    err = 0.0
    for li in range(3, -1, -1):
        unk, kn = levels[li], levels[li + 1]
        nu, nk, c = unk.shape[1], kn.shape[1], known_c[li]
        feats = torch.tensor(rng.randn(1, nk, c).astype(np.float32),
                             device=dev)
        got = interp.three_interpolate_fused(unk, kn, feats, expanded=True)
        want = interp.three_interpolate_plain(unk, kn, feats, expanded=True)
        if not torch.equal(got[2], want[2]):
            raise AssertionError(f"modes: K3 expanded fp{li}: indices "
                                 f"differ")
        e = _err(got[:2], want[:2])
        if e > 1e-5:
            raise AssertionError(f"modes: K3 expanded fp{li}: max abs err "
                                 f"{e}")
        err = max(err, e)
        same = float((got[2] == interp.three_interpolate_fused(
            unk, kn, feats)[2]).all(-1).float().mean())

        def kernel():
            return interp.three_interpolate_fused(unk, kn, feats,
                                                  expanded=True)

        def library():
            d, i = torch.topk(torch.cdist(unk, kn), 3, largest=False)
            w = 1.0 / (d + 1e-8)
            w = w / w.sum(-1, keepdim=True)
            return (feats[0][i[0]] * w[0, :, :, None]).sum(1)
        n_bytes = nu * 12 + nk * 12 + nk * c * 4 + nu * c * 4 + nu * 24
        flops = nu * nk * (D2_FLOPS + 1) + nu * c * 5
        lvl = dict(level=f"fp{li}", n=nu, m=nk, C=c, ms=time_ms(kernel),
                   device_ms=device_ms(kernel),
                   fused_device_ms=device_ms(
                       lambda: interp.three_interpolate_fused(unk, kn,
                                                              feats)),
                   plain_ms=time_ms(lambda: interp.three_interpolate_plain(
                       unk, kn, feats, expanded=True), reps=1),
                   library_ms=time_ms(library), n_bytes=n_bytes,
                   flops=flops, rows_same_as_direct=same)
        lvl["bound_ms"], lvl["bound_by"] = bound_ms(n_bytes, flops)
        per_level.append(lvl)
        log("modes", f"K3 expanded fp{li} n={nu} m={nk} C={c}: idx equal, "
            f"max err {e:.2e}; {lvl['ms']:.4f} ms, on the device "
            f"{lvl['device_ms']:.4f} ms (direct form "
            f"{lvl['fused_device_ms']:.4f}), bound {lvl['bound_ms']:.4f} ms "
            f"({lvl['bound_by']}); plain {lvl['plain_ms']:.3f}, "
            f"cdist+topk+gather {lvl['library_ms']:.4f}; rows with the "
            f"direct form's neighbours {same:.4f} ({smi})")
    return _level_record(per_level, err, "indices exact, out/dist 1e-5",
                         "pvn3d_tpu/ops/interpolate.py:23")


def _grouped_fps(xyz, m0, smi):
    """Grouped FPS (G = 2, 4): K1 on the slabs against plain FPS on the
    same slabs, the whole grouped sample on the card against the CPU, and
    its time beside exact FPS."""
    from pvn3d_tpu_torch.ops import sampling
    from pvn3d_tpu_torch.ops.kernels import fps
    n = xyz.shape[1]
    exact_ms = time_ms(lambda: fps.fps(xyz, m0))
    exact_dev = device_ms(lambda: fps.fps(xyz, m0))
    for g in (2, 4):
        spread = xyz.amax(1) - xyz.amin(1)
        ax = torch.argmax(spread, dim=1)
        key = torch.gather(xyz, 2, ax[:, None, None].expand(-1, n, 1))[..., 0]
        order = torch.sort(key, dim=1, stable=True).indices
        slabs = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3)
                             ).reshape(g, n // g, 3).contiguous()
        if not torch.equal(fps.fps(slabs, m0 // g),
                           fps.fps_plain(slabs, m0 // g)):
            raise AssertionError(f"modes: K1 on {g} slabs differs from "
                                 f"plain")
        got = sampling.furthest_point_sample(xyz, m0, groups=g)
        want = sampling.furthest_point_sample(xyz.cpu(), m0, groups=g)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"modes: grouped FPS G={g} on the card "
                                 f"differs from the CPU")
        ms = time_ms(lambda: sampling.furthest_point_sample(xyz, m0,
                                                            groups=g))
        # K1 alone: traces of the whole sample (sort, gathers, copies)
        # taken after the earlier phases lose their first device records.
        k1_ms = device_ms(lambda: fps.fps(slabs, m0 // g))
        log("modes", f"grouped FPS G={g}: K1 on ({g}, {n // g}, 3) slabs "
            f"equals plain, the sample equals the CPU's; {ms:.3f} ms "
            f"(sort + K1 + gathers; K1 on the device {k1_ms:.3f}) against "
            f"exact FPS {exact_ms:.3f} ms, on the device {exact_dev:.3f} "
            f"({smi})")


def _request_card_vs_cpu(over, seed: int = 1):
    """A small float32 frame through ``make_inference_step`` in a mode on
    the card (kernels) and on the CPU (plain versions), same weights and
    frame: (forward max err, seg agreement, pose max err, present)."""
    from pvn3d_tpu_torch.config import Config, small_model_config
    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    from pvn3d_tpu_torch.inference.pipeline import make_inference_step
    from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,
                                              stacked_mesh_kps)
    from pvn3d_tpu_torch.utils.weights import build_model
    mcfg = _with_pointnet2(small_model_config(), **over)
    cfg = Config(model=mcfg)
    batch = synthetic_batch(cfg, batch_size=1, seed=seed)
    batch["pointcloud"][..., :3] = depth_cloud(
        np.random.RandomState(seed), mcfg.n_sample_points)[None] * 0.3
    fwd, req = {}, {}
    for dev in ("cuda", "cpu"):
        model = build_model(mcfg, seed).to(dev)
        with torch.inference_mode():
            fwd[dev] = model(*(torch.as_tensor(batch[k], device=dev)
                               for k in ("pointcloud", "rgb", "choose")))
        step = make_inference_step(cfg, model, stacked_mesh_kps(),
                                   stacked_class_radii(), device=dev)
        req[dev] = step(batch)
    err = max(float((fwd["cuda"][k].cpu() - fwd["cpu"][k]).abs().max())
              for k in ("seg_logits", "kp_offsets", "ctr_offsets"))
    agree = float((fwd["cuda"]["seg_logits"].argmax(-1).cpu()
                   == fwd["cpu"]["seg_logits"].argmax(-1)).float().mean())
    present = req["cpu"]["present"]
    if not torch.equal(req["cuda"]["present"].cpu(), present):
        raise AssertionError(f"modes {over}: present differs card vs CPU")
    pose_err = float((req["cuda"]["poses"].cpu()
                      - req["cpu"]["poses"]).abs().max())
    return err, agree, pose_err, int(present.sum())


def phase_modes(smi: str, seed: int = 0):
    """The JAX package's neighbour and sampling modes on the card.  K2's
    capacity, expanded and bf16 instances and K3's expanded one held bit
    for bit against their plain versions at the serving levels (and K2's
    on an adversarial cloud and 12 off-path shapes), grouped FPS against
    plain FPS on the same slabs, times beside the default instances; then
    one full-width request in each deployment mode (``Config.ycb()``,
    seeded random weights, three requests, every count set to 0 just
    before and read just after, each mode's instances launched) beside the
    exact mode's, and each mode card against CPU on a small frame
    (forward 2e-3, poses 1e-4).  Returns (records, launches)."""
    import dataclasses
    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    from pvn3d_tpu_torch.inference.pipeline import make_inference_step
    from pvn3d_tpu_torch.models.pvn3d import PVN3D
    from pvn3d_tpu_torch.ops.kernels import KERNELS, fps
    from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,
                                              stacked_mesh_kps)
    from pvn3d_tpu_torch.utils.weights import build_model
    rng = np.random.RandomState(seed + 7)
    cfg = Config.ycb()
    pcfg = cfg.model.pointnet2
    dev = torch.device("cuda")
    xyz = torch.tensor(depth_cloud(rng, cfg.model.n_sample_points)[None],
                       device=dev)
    m0 = pcfg.sa_levels[0].npoint
    pts = xyz[0, fps.fps(xyz, m0)[0].long()][None]
    levels = [xyz] + [pts[:, :lvl.npoint].contiguous()
                      for lvl in pcfg.sa_levels]
    rec = _k2_modes_levels(levels, pcfg, smi)
    _k2_modes_edges(rng, levels, pcfg)
    widths = [sum(m[-1] for m in lvl.mlps) for lvl in pcfg.sa_levels]
    known_c = [pcfg.fp_mlps[i + 1][-1] if i < 3 else widths[3]
               for i in range(4)]
    rec["interp_expanded"] = _k3_expanded_levels(rng, levels, known_c, smi)
    _grouped_fps(xyz, m0, smi)

    base = build_model(cfg.model, seed)
    state = base.state_dict()
    mesh_kps, radii = stacked_mesh_kps(), stacked_class_radii()
    batches = [synthetic_batch(cfg, batch_size=1, seed=100 + i)
               for i in range(3)]
    launches = {k.name: 0 for k in KERNELS}
    lat = {}
    for name, (over, instances) in [("exact", ({}, ()))] + list(
            DEPLOY_MODES.items()):
        mcfg = dataclasses.replace(cfg, model=_with_pointnet2(cfg.model,
                                                              **over))
        model = PVN3D(mcfg.model)
        model.load_state_dict(state, strict=True)
        step = make_inference_step(mcfg, model, mesh_kps, radii)
        step(batches[0])                                    # warm-up
        torch.cuda.synchronize()
        for k in KERNELS:
            k.launches = 0
        times = []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if not bool(torch.isfinite(out["poses"]).all()):
                raise AssertionError(f"modes {name}: non-finite poses")
        counts = {k.name: k.launches for k in KERNELS}
        for inst in instances:
            if counts[inst] < 3:
                raise AssertionError(f"modes {name}: {inst} launched "
                                     f"{counts[inst]} times in 3 requests")
        if name != "exact":
            for k, v in counts.items():
                launches[k] += v
        lat[name] = statistics.median(times)
        log("modes", f"{name}: 3 full-width requests, median "
            f"{lat[name]:.2f} ms (exact mode "
            f"{lat.get('exact', lat[name]):.2f} ms in this call); launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        del model, step
    for name, (over, _) in DEPLOY_MODES.items():
        err, agree, pose_err, present = _request_card_vs_cpu(over)
        if err > 2e-3 or agree <= 0.999 or pose_err > 1e-4:
            raise AssertionError(f"modes {name}: card vs CPU forward err "
                                 f"{err}, seg agreement {agree}, pose err "
                                 f"{pose_err}")
        log("modes", f"{name}: small frame card vs CPU plain: forward max "
            f"err {err:.2e}, seg agreement {agree:.4f}, poses max err "
            f"{pose_err:.2e} ({present} classes present)")
    rec["latency_ms"] = lat
    return rec, launches


# The [disk] phase's trees and runs live in the checkout's build/
# directory (git ignores it).
DISK_DIR = os.path.join(ROOT, "build", "disk")


class _TimedTrainer:
    """A ``Trainer`` factory that records each step's host-clock time
    (synchronised before and after) and the interval between step ends
    (the loader's wait included)."""

    def __init__(self, base):
        self.base, self.step_ms, self.interval_ms = base, [], []

    def __call__(self, cfg, state, train_step, *a, **kw):
        last = [None]

        def timed(st, batch, seed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = train_step(st, batch, seed)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            self.step_ms.append((t1 - t0) * 1e3)
            if last[0] is not None:
                self.interval_ms.append((t1 - last[0]) * 1e3)
            last[0] = t1
            return out
        return self.base(cfg, state, timed, *a, **kw)


def _counted(fn):
    """Run ``fn`` with every launch count set to 0 just before; returns
    (its result, the counts read just after)."""
    from pvn3d_tpu_torch.ops.kernels import KERNELS
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.name: k.launches for k in KERNELS}


def _disk_trees(n_test: int):
    """A YCB tree at 480x640 (``n_test`` real frames named as the vendored
    test list's first, 8 synthetic; a mesh for each of the 21 classes)
    and a LineMOD tree for one object (4 real frames, 2 render and 2 fuse
    items), written by the port's tool."""
    import shutil

    from pvn3d_tpu_torch.config import ASSETS_DIR
    from pvn3d_tpu_torch.tools.fake_data import (make_fake_linemod,
                                                 make_fake_ycb)
    shutil.rmtree(DISK_DIR, ignore_errors=True)
    with open(os.path.join(ASSETS_DIR, "ycb_config",
                           "test_data_list.txt")) as f:
        test_items = [ln.strip() for ln in f if ln.strip()][:n_test]
    items = test_items + [f"data_syn/{i:06d}" for i in range(1, 9)]
    t0 = time.perf_counter()
    ycb = make_fake_ycb(DISK_DIR, items=items, mesh_ids=range(1, 22))
    lm = make_fake_linemod(DISK_DIR, n_frames=4, n_renders=2)
    log("disk", f"trees written in {time.perf_counter() - t0:.1f} s: YCB "
        f"{len(items)} frames ({n_test} real as the test list's first, 8 "
        f"synthetic), LineMOD 4 real + 2 render + 2 fuse")
    return ycb, lm


def _interval_summary(ms) -> str:
    ms = sorted(ms)
    return (f"median {ms[len(ms) // 2]:.1f} ms, mean "
            f"{sum(ms) / len(ms):.1f} over {len(ms)} intervals")


def _disk_train(smi, ycb, lm, steps: int):
    """The train app: ``steps`` steps at batch 4 on the YCB tree with
    host frames from 0 and 2 workers and with --device_preprocess, then 2
    on the LineMOD tree; each saves a checkpoint.  Returns the summed
    launch counts and the first YCB run's checkpoint directory."""
    from pvn3d_tpu_torch.apps import train as train_app
    from pvn3d_tpu_torch.train.trainer import Trainer
    runs = {
        "ycb host, 0 workers": ["--workers", "0"],
        "ycb host, 2 workers": ["--workers", "2"],
        "ycb --device_preprocess": ["--workers", "0",
                                    "--device_preprocess"],
        "linemod host, 0 workers": ["--workers", "0"],
    }
    total, ckpt = {}, None
    for i, (name, extra) in enumerate(runs.items()):
        lm_run = name.startswith("linemod")
        n_steps = 2 if lm_run else steps
        run_dir = os.path.join(DISK_DIR, f"run{i}")
        argv = (["--dataset", "linemod", "--cls", "ape", "--data_root", lm]
                if lm_run else
                ["--data_root", ycb, "--file_list",
                 os.path.join(ycb, "image_list.txt")])
        argv += ["--checkpoint_dir", run_dir, "--batch_size", "4",
                 "--max_steps", str(n_steps), "--log_every", "1"] + extra
        timer = _TimedTrainer(Trainer)
        train_app.Trainer = timer
        try:
            t0 = time.perf_counter()
            trainer, launches = _counted(lambda: train_app.main(argv))
            wall = time.perf_counter() - t0
        finally:
            train_app.Trainer = Trainer
        want = _expected_launches(fps=n_steps, query=4 * n_steps,
                                  interp=4 * n_steps,
                                  interp_bwd=4 * n_steps)
        if launches != want:
            raise AssertionError(f"disk: train {name}: launches {launches}, "
                                 f"expected {want}")
        if trainer.state.step != n_steps or not os.path.exists(
                os.path.join(run_dir, f"ckpt_{n_steps}.pt")):
            raise AssertionError(f"disk: train {name}: no checkpoint at "
                                 f"step {n_steps}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        log("disk", f"train {name}: {n_steps} steps at batch 4, step ms "
            + ", ".join(f"{t:.1f}" for t in timer.step_ms)
            + "; between step ends ms "
            + ", ".join(f"{t:.1f}" for t in timer.interval_ms)
            + f" ({_interval_summary(timer.interval_ms)}); run {wall:.1f} "
            f"s; launches {launches} [{smi}]")
        ckpt = ckpt or run_dir
    return total, ckpt


def _disk_loader_rate(smi, ycb, steps: int):
    """Frames a second of the host build (YCB train frames, augmentation
    and fill included) at 0 and 2 workers, over the ``steps - 1``
    batches of 4 after the first."""
    from pvn3d_tpu_torch.apps.train import make_dataset_factory, train_config
    from pvn3d_tpu_torch.apps.train import build_argparser as train_args
    from pvn3d_tpu_torch.data.loader import DataLoader
    args = train_args().parse_args(["--data_root", ycb, "--file_list",
                                    os.path.join(ycb, "image_list.txt")])
    factory = make_dataset_factory(args, "train", train_config(args))
    rates = {}
    for workers in (0, 2):
        it = iter(DataLoader(factory, 4, num_workers=workers, steps=steps))
        next(it)
        t0 = time.perf_counter()
        n = sum(len(b["labels"]) for b in it)
        rates[workers] = n / (time.perf_counter() - t0)
    log("disk", f"loader, YCB train frames built on the host: "
        f"{rates[0]:.2f} frames/s at 0 workers, {rates[2]:.2f} at 2, over "
        f"{4 * (steps - 1)} frames after the first batch [{smi}]")
    return rates


def _disk_evaluate(smi, ycb, lm, ckpt, lm_ckpt, frames: int):
    """The evaluate app on the YCB test split's ``frames`` frames from the
    first checkpoint: host frames, --device_preprocess, --icp, and
    --packed_dir after the packer packed the split; then once on
    LineMOD.  Returns the summed launch counts."""
    from pvn3d_tpu_torch.apps import evaluate as eval_app
    from pvn3d_tpu_torch.data.ycb import YCBDataset
    from pvn3d_tpu_torch.tools.preprocess_testset import pack_dataset
    packed = os.path.join(DISK_DIR, "packed")
    t0 = time.perf_counter()
    n_packed = pack_dataset(YCBDataset(ycb, split="test"), packed,
                            shard_size=4, max_frames=frames, workers=2)
    log("disk", f"packed {n_packed} test frames in "
        f"{time.perf_counter() - t0:.1f} s")
    base = ["--data_root", ycb, "--checkpoint_dir", ckpt, "--batch_size",
            "4", "--max_frames", str(frames), "--workers", "0"]
    runs = {"ycb host": base, "ycb --device_preprocess":
            base + ["--device_preprocess"], "ycb --icp": base + ["--icp"],
            "ycb --packed_dir": base + ["--packed_dir", packed],
            "linemod host": ["--dataset", "linemod", "--cls", "ape",
                             "--data_root", lm, "--checkpoint_dir", lm_ckpt,
                             "--batch_size", "4", "--workers", "0"]}
    acc = eval_app.accumulate_batches
    total, counts = {}, {}
    for name, argv in runs.items():
        timed = {}

        def accumulate(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = acc(*a, **kw)
            torch.cuda.synchronize()
            timed["s"], timed["n"] = time.perf_counter() - t0, n
            return n
        eval_app.accumulate_batches = accumulate
        printed = io.StringIO()
        try:
            with contextlib.redirect_stdout(printed):
                summary, launches = _counted(lambda: eval_app.main(argv))
        finally:
            eval_app.accumulate_batches = acc
        want = 4 if name.startswith("linemod") else frames
        if timed.get("n") != want:
            raise AssertionError(f"disk: evaluate {name}: {timed.get('n')} "
                                 f"frames scored, expected {want}")
        if any(launches[k] < 1 for k in ("fps", "query", "interp",
                                         "winner")):
            raise AssertionError(f"disk: evaluate {name}: launches "
                                 f"{launches}")
        counts[name] = launches
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        said = [ln for ln in printed.getvalue().splitlines()
                if ln.startswith(("evaluating", "evaluated", "All", "obj",
                                  "WARNING"))]
        log("disk", f"evaluate {name}: {timed['n']} frames in "
            f"{timed['s']:.2f} s ({timed['n'] / timed['s']:.2f} frames/s, "
            f"loader included); the app said {said}; launches {launches} "
            f"[{smi}]")
    if not counts["ycb --icp"]["winner"] > counts["ycb host"]["winner"]:
        raise AssertionError("disk: --icp launched K4 no more often than "
                             "the run without it")
    return total


def _disk_card_vs_cpu(ycb, ckpt):
    """One evaluation batch from the loader through the card and the CPU
    plain path with the checkpoint's weights (float32): the forward of
    its first frame within 2e-3 and the pose stage on the card's votes
    within 1e-4.  Then the first --device_preprocess training batch built
    on the card and on the CPU from the same raw batch and generator:
    choose, labels and the GT slots equal, the cloud and the targets
    within 1e-5, rgb within 1e-2 and the normals within 1e-4 but for
    camera-facing flips (at most 0.1% of the points)."""
    import dataclasses

    from pvn3d_tpu_torch.apps.train import (build_argparser, base_config,
                                            make_dataset_factory)
    from pvn3d_tpu_torch.data.device_frame import (build_train_batch_device,
                                                   step_generator)
    from pvn3d_tpu_torch.data.loader import DataLoader
    from pvn3d_tpu_torch.inference.pipeline import make_pose_fn
    from pvn3d_tpu_torch.train.checkpoint import CheckpointManager
    from pvn3d_tpu_torch.train.state import create_train_state
    from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,
                                              stacked_mesh_kps)
    cfg = base_config("ycb", "ape")
    f32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))
    sd = CheckpointManager(ckpt).restore(
        create_train_state(cfg, 0, "cuda")).model.state_dict()
    args = build_argparser().parse_args(["--data_root", ycb])
    batch = next(iter(DataLoader(make_dataset_factory(args, "test", cfg),
                                 4)))
    out = {}
    for dev in ("cuda", "cpu"):
        model = create_train_state(f32, 0, dev).model
        model.load_state_dict(sd)
        model.eval()
        with torch.inference_mode():
            out[dev] = model(*(torch.as_tensor(batch[k][:1], device=dev)
                               for k in ("pointcloud", "rgb", "choose")))
    err = max(_err(out["cuda"][k].cpu(), out["cpu"][k])
              for k in ("seg_logits", "kp_offsets", "ctr_offsets"))
    agree = float((out["cuda"]["seg_logits"].argmax(-1).cpu()
                   == out["cpu"]["seg_logits"].argmax(-1)).float().mean())
    if err > 2e-3 or agree <= 0.999:
        raise AssertionError(f"disk: loader frame card vs CPU: forward "
                             f"{err}, seg agreement {agree}")
    seg = out["cuda"]["seg_logits"].argmax(-1).to(torch.int32)
    votes = (torch.as_tensor(batch["pointcloud"][:1, :, :3]), seg.cpu(),
             out["cuda"]["ctr_offsets"].cpu(),
             out["cuda"]["kp_offsets"].cpu())
    poses = {}
    for dev in ("cuda", "cpu"):
        fn = make_pose_fn(cfg, stacked_mesh_kps(), stacked_class_radii(),
                          device=dev)
        with torch.inference_mode():
            poses[dev] = fn(*(v.to(dev) for v in votes))
    pose_err = _err(poses["cuda"].poses.cpu(), poses["cpu"].poses)
    present = int(poses["cpu"].present.sum())
    if pose_err > 1e-4 or not torch.equal(poses["cuda"].present.cpu(),
                                          poses["cpu"].present):
        raise AssertionError(f"disk: loader frame card vs CPU: poses "
                             f"{pose_err}")
    log("disk", f"loader test frame card vs CPU plain (float32, the "
        f"checkpoint's weights): forward max err {err:.2e}, seg agreement "
        f"{agree:.4f}; pose stage on the card's votes max err "
        f"{pose_err:.2e} ({present} classes present)")

    args = build_argparser().parse_args(
        ["--data_root", ycb, "--file_list",
         os.path.join(ycb, "image_list.txt"), "--device_preprocess"])
    raw = next(iter(DataLoader(make_dataset_factory(args, "train", cfg), 4,
                               steps=1)))
    built = {}
    for dev in ("cuda", "cpu"):
        r = {k: (v if k in ("is_syn", "do_jitter")
                 else torch.as_tensor(v, device=dev))
             for k, v in raw.items()}
        with torch.inference_mode():
            built[dev] = {k: v.cpu() for k, v in build_train_batch_device(
                r, step_generator(cfg.train.seed, 0),
                n_sample=cfg.model.n_sample_points,
                n_classes=cfg.model.n_classes).items()}
    g, c = built["cuda"], built["cpu"]
    for k in ("choose", "labels", "cls_ids"):
        if not torch.equal(g[k], c[k]):
            raise AssertionError(f"disk: raw-train build card vs CPU: {k} "
                                 f"differs")
    xyz = _err(g["pointcloud"][..., :3], c["pointcloud"][..., :3])
    tgt = max(_err(g[k], c[k]) for k in ("kp_targ_ofst", "ctr_targ_ofst",
                                          "kp_3ds", "ctr_3ds", "rts"))
    rgb = _err(g["pointcloud"][..., 3:6], c["pointcloud"][..., 3:6])
    nrm_off = (g["pointcloud"][..., 6:] - c["pointcloud"][..., 6:]
               ).abs().amax(-1) > 1e-4
    flips = int(nrm_off.sum())
    if xyz > 1e-5 or tgt > 1e-5 or rgb > 1e-2 or flips > 1e-3 * \
            nrm_off.numel():
        raise AssertionError(f"disk: raw-train build card vs CPU: xyz {xyz}"
                             f", targets {tgt}, rgb {rgb}, normals off "
                             f"{flips}")
    log("disk", f"first --device_preprocess training batch card vs CPU "
        f"(is_syn {raw['is_syn'].tolist()}): choose, labels, GT slots "
        f"equal; xyz {xyz:.2e}, targets {tgt:.2e}, rgb {rgb:.2e}, normals "
        f"beyond 1e-4 at {flips} of {nrm_off.numel()} points")


def phase_disk(smi: str, steps: int = 3, frames: int = 8):
    """Train and evaluate through the apps from trees written here (see
    the module docstring).  Returns the launch counts of its runs.

    ``steps`` YCB training steps a mode and ``frames`` test frames an
    evaluation mode (see the module docstring)."""
    import gc
    ycb, lm = _disk_trees(frames)
    train_launches, ckpt = _disk_train(smi, ycb, lm, steps)
    _disk_loader_rate(smi, ycb, steps)
    eval_launches = _disk_evaluate(smi, ycb, lm, ckpt,
                                   os.path.join(DISK_DIR, "run3"), frames)
    _disk_card_vs_cpu(ycb, ckpt)
    gc.collect()
    torch.cuda.empty_cache()
    return {k: train_launches[k] + eval_launches[k] for k in train_launches}


# The [apps] phase's trees, checkpoints, renders and traces (under the
# checkout's git-ignored build/ directory).
APPS_DIR = os.path.join(ROOT, "build", "apps")
# Substrings of the four TPU kernels' CUDA names in a profiler trace.
_TRACE_NAMES = {"K1": "fps_kernel", "K2": "ball_query_kernel",
                "K3": "three_interp_kernel", "K4": "winner_kernel"}


def _add_counts(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def _apps_trees(occ_frames: int, demo_frames: int):
    """480x640 trees written by the port's tool: YCB (``demo_frames``
    real frames named as the vendored test list's first, a mesh for each
    of the 21 classes), LineMOD ape (``demo_frames`` real frames), and
    Occlusion-LineMOD ape in both variants, labels synthesised from the
    mesh and masks on disk (``occ_frames`` annotated frames each and an
    unannotated last one)."""
    import shutil

    from pvn3d_tpu_torch.config import ASSETS_DIR
    from pvn3d_tpu_torch.tools.fake_data import (make_fake_linemod,
                                                 make_fake_occlusion_linemod,
                                                 make_fake_ycb)
    shutil.rmtree(APPS_DIR, ignore_errors=True)
    with open(os.path.join(ASSETS_DIR, "ycb_config",
                           "test_data_list.txt")) as f:
        items = [ln.strip() for ln in f if ln.strip()][:demo_frames]
    t0 = time.perf_counter()
    trees = {
        "ycb": make_fake_ycb(APPS_DIR, items=items, mesh_ids=range(1, 22)),
        "linemod": make_fake_linemod(APPS_DIR, n_frames=demo_frames),
        "occ": make_fake_occlusion_linemod(
            os.path.join(APPS_DIR, "occ_synth"), n_frames=occ_frames + 1),
        "occ masks": make_fake_occlusion_linemod(
            os.path.join(APPS_DIR, "occ_masks"), n_frames=occ_frames + 1,
            with_masks=True)}
    log("apps", f"trees written in {time.perf_counter() - t0:.1f} s: YCB "
        f"{demo_frames} test frames, LineMOD {demo_frames}, "
        f"Occlusion-LineMOD {occ_frames} annotated + 1 not, with "
        f"synthesised labels and with masks")
    return trees


# Fewest frames of a run whose wall time [apps] reports as a rate; the
# smoke run's 4 occ and 2 demo frames are path checks.
RATE_FRAMES = 8


def _rate(n: int, seconds: float) -> str:
    """``n`` frames in ``seconds`` as frames/s, or, below
    ``RATE_FRAMES``, as a path check only: a few frames are one batch,
    whose reading is mostly the first call's or the warm process's."""
    if n < RATE_FRAMES:
        return (f"{n} frames in {seconds:.2f} s (a path check, too few "
                f"frames for a rate)")
    return f"{n} frames in {seconds:.2f} s ({n / seconds:.2f} frames/s)"


def _apps_occ(smi, trees, total, frames):
    """``apps.evaluate --occ`` at batch 4 on both occ variants (host
    frames) and with --device_preprocess, then the packer's --occ and
    --packed_dir on its shards, ``frames`` annotated frames each: wall
    time, ADD and launches a run."""
    from pvn3d_tpu_torch.apps import evaluate as eval_app
    from pvn3d_tpu_torch.inference import evaluator
    from pvn3d_tpu_torch.tools import preprocess_testset
    ckpt = os.path.join(APPS_DIR, "occ_run")
    packed = os.path.join(APPS_DIR, "occ_packed")
    base = ["--dataset", "linemod", "--cls", "ape", "--occ",
            "--checkpoint_dir", ckpt, "--batch_size", "4", "--workers", "0"]
    runs = {"synthesised labels": ["--data_root", trees["occ"]],
            "masks": ["--data_root", trees["occ masks"]],
            "--device_preprocess": ["--data_root", trees["occ"],
                                    "--device_preprocess"],
            "--packed_dir": ["--data_root", trees["occ"], "--packed_dir",
                             packed]}
    acc, made = eval_app.accumulate_batches, []

    class Capture(evaluator.PoseEvaluator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    real_ev = evaluator.PoseEvaluator
    for name, extra in runs.items():
        if name == "--packed_dir":
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                preprocess_testset.main(
                    ["--dataset", "linemod", "--cls", "ape", "--occ",
                     "--data_root", trees["occ"], "--out", packed,
                     "--shard_size", "4", "--workers", "0"])
            log("apps", f"packer --occ: {frames} frames packed in "
                f"{time.perf_counter() - t0:.1f} s")
        timed = {}

        def accumulate(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = acc(*a, **kw)
            torch.cuda.synchronize()
            timed["s"], timed["n"] = time.perf_counter() - t0, n
            return n
        eval_app.accumulate_batches = accumulate
        evaluator.PoseEvaluator = Capture
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                summary, launches = _counted(
                    lambda: eval_app.main(base + extra))
        finally:
            eval_app.accumulate_batches = acc
            evaluator.PoseEvaluator = real_ev
        add = np.asarray(made[-1].cls_add_dis[1])
        if timed.get("n") != frames or summary["n"] != frames or \
                not np.isfinite(add).all():
            raise AssertionError(f"apps: evaluate --occ {name}: "
                                 f"{timed.get('n')} frames, summary "
                                 f"{summary}")
        if any(launches[k] < 1 for k in ("fps", "query", "interp",
                                         "winner")):
            raise AssertionError(f"apps: evaluate --occ {name}: launches "
                                 f"{launches}")
        _add_counts(total, launches)
        log("apps", f"evaluate --occ ({name}), loader included: "
            f"{_rate(frames, timed['s'])}; ADD "
            f"mean {add.mean():.4f} m, AUC {summary['add_auc']:.2f}, "
            f"<0.1d {summary['add_0.1d']:.2f} (random weights); launches "
            f"{launches} [{smi}]")


def _overlay_checkpoint(cfg, run_dir: str) -> None:
    """A checkpoint of seeded random weights whose poses land in view:
    the keypoint and center heads' output layers scaled by 1e-4 (votes
    centimetres from their points, not metres) and class 1's seg logit
    raised by 50, so class 1 is present at its cloud."""
    from pvn3d_tpu_torch.train.checkpoint import CheckpointManager
    from pvn3d_tpu_torch.train.state import create_train_state
    state = create_train_state(cfg, 0, "cuda")
    with torch.no_grad():
        for name in ("KpOF_layer", "CtrOf_layer", "SEG_layer"):
            head = getattr(state.model, name)
            out = getattr(head, str(head.n_hidden)).conv
            if name == "SEG_layer":
                out.bias[1] += 50.0
            else:
                out.weight.mul_(1e-4)
                out.bias.mul_(1e-4)
    CheckpointManager(run_dir).save(0, state)


def _apps_demo(smi, trees, total, frames):
    """``apps.demo`` on the YCB and LineMOD trees, ``frames`` frames each:
    the PNGs decode to full frames and differ from the frames read by the
    drawn overlays."""
    from pvn3d_tpu_torch.apps import demo
    from pvn3d_tpu_torch.apps.train import base_config
    from pvn3d_tpu_torch.config import ASSETS_DIR
    from pvn3d_tpu_torch.data.png import read_png
    with open(os.path.join(ASSETS_DIR, "ycb_config",
                           "test_data_list.txt")) as f:
        items = [ln.strip() for ln in f if ln.strip()][:frames]
    sources = {
        "ycb": [os.path.join(trees["ycb"], f"{it}-color.png")
                for it in items],
        "linemod": [os.path.join(trees["linemod"], "data", "01", "rgb",
                                 f"{i:04d}.png") for i in range(frames)]}
    for dataset, srcs in sources.items():
        run = os.path.join(APPS_DIR, f"demo_run_{dataset}")
        _overlay_checkpoint(base_config(dataset, "ape"), run)
        out = os.path.join(APPS_DIR, f"demo_{dataset}")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            paths, launches = _counted(lambda: demo.main(
                ["--dataset", dataset, "--cls", "ape", "--data_root",
                 trees[dataset], "--checkpoint_dir", run, "--out_dir", out,
                 "--n_frames", str(frames), "--workers", "0"]))
        wall = time.perf_counter() - t0
        drawn = []
        for path, src in zip(paths, srcs):
            img, frame = read_png(path), read_png(src)
            if img.shape != (480, 640, 3) or img.dtype != np.uint8:
                raise AssertionError(f"apps: demo {path}: {img.shape} "
                                     f"{img.dtype}")
            drawn.append(int((img != frame[..., :3]).any(-1).sum()))
        if len(paths) != frames or min(drawn) < 1:
            raise AssertionError(f"apps: demo {dataset}: {len(paths)} "
                                 f"images, overlay pixels {drawn}")
        if any(launches[k] < frames for k in ("fps", "query", "interp",
                                              "winner")):
            raise AssertionError(f"apps: demo {dataset}: launches "
                                 f"{launches}")
        _add_counts(total, launches)
        log("apps", f"demo {dataset}, model, meshes and loader included: "
            f"{_rate(frames, wall)}; overlay pixels {drawn}; launches "
            f"{launches} [{smi}]")


def _torchvision_dict(path: str) -> dict:
    """A state dict with torchvision's resnet34 key names and shapes
    (the port's trunk keys without their prefix, plus the classifier and
    BN counters torchvision saves), seeded, written to ``path``."""
    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.utils.torch_convert import TRUNK_PREFIX
    from pvn3d_tpu_torch.utils.weights import build_model
    rng = np.random.RandomState(34)
    sd = {}
    for k, v in build_model(Config.linemod("ape").model, 0).state_dict(
            ).items():
        if not k.startswith(TRUNK_PREFIX):
            continue
        key = k[len(TRUNK_PREFIX):]
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(5)
        elif key.endswith("running_var"):
            sd[key] = torch.tensor(rng.rand(*v.shape) + 0.5,
                                   dtype=torch.float32)
        else:
            sd[key] = torch.tensor(rng.randn(*v.shape) * 0.05,
                                   dtype=torch.float32)
    sd["fc.weight"] = torch.zeros(1000, 512)
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, path)
    return sd


def _apps_trunk(smi, trees, total):
    """``apps.train --pretrained_trunk`` for 2 steps at batch 4 on the
    LineMOD tree: the trunk equals the dict when the first step starts
    and the steps launch K1-K3 and K3's backward."""
    from pvn3d_tpu_torch.apps import train as train_app
    from pvn3d_tpu_torch.utils.torch_convert import TRUNK_PREFIX
    path = os.path.join(APPS_DIR, "resnet34.pth")
    sd = _torchvision_dict(path)
    seen = {}
    real = train_app.Trainer

    def trainer(cfg, state, train_step, *a, **kw):
        def first(st, batch, seed):
            if not seen:
                torch.cuda.synchronize()
                seen.update({k: v.detach().cpu().clone() for k, v in
                             st.model.state_dict().items()
                             if k.startswith(TRUNK_PREFIX)})
            return train_step(st, batch, seed)
        return real(cfg, state, first, *a, **kw)
    train_app.Trainer = trainer
    printed = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            out, launches = _counted(lambda: train_app.main(
                ["--dataset", "linemod", "--cls", "ape", "--data_root",
                 trees["linemod"], "--checkpoint_dir",
                 os.path.join(APPS_DIR, "trunk_run"), "--pretrained_trunk",
                 path, "--batch_size", "4", "--max_steps", "2",
                 "--workers", "0", "--log_every", "1"]))
        wall = time.perf_counter() - t0
    finally:
        train_app.Trainer = real
    off = [k for k, v in sd.items() if not k.startswith("fc.")
           and "num_batches" not in k
           and not torch.equal(seen[TRUNK_PREFIX + k], v)]
    if off or out.state.step != 2:
        raise AssertionError(f"apps: --pretrained_trunk: step "
                             f"{out.state.step}, trunk tensors unlike the "
                             f"dict at the first step: {off[:4]}")
    want = _expected_launches(fps=2, query=8, interp=8, interp_bwd=8)
    if launches != want:
        raise AssertionError(f"apps: --pretrained_trunk: launches "
                             f"{launches}, expected {want}")
    _add_counts(total, launches)
    losses = [ln for ln in printed.getvalue().splitlines()
              if ln.startswith("[train")]
    log("apps", f"train --pretrained_trunk: {len(sd) - 2} trunk tensors "
        f"equal the dict at step 0; 2 steps at batch 4 in {wall:.1f} s; "
        f"{losses}; launches {launches} [{smi}]")


def _apps_tools(smi, trees):
    """``tools.check_dataset`` with --render_dir on the YCB and LineMOD
    trees (0 violations), ``tools.gen_obj_info`` on a fake PLY, and
    ``knn_normals`` on a 12288-point cloud on the card against the
    CPU."""
    from pvn3d_tpu_torch.data.normals import knn_normals
    from pvn3d_tpu_torch.data.png import read_png
    from pvn3d_tpu_torch.tools import check_dataset, gen_obj_info
    from pvn3d_tpu_torch.tools.fake_data import _write_ply
    for dataset, argv in (("ycb", ["--data_root", trees["ycb"]]),
                          ("linemod", ["--dataset", "linemod", "--cls",
                                       "ape", "--data_root",
                                       trees["linemod"]])):
        renders = os.path.join(APPS_DIR, f"check_{dataset}")
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            bad = check_dataset.main(argv + ["--split", "test",
                                             "--n_frames", "2",
                                             "--render_dir", renders])
        names = sorted(os.listdir(renders))
        shapes = {read_png(os.path.join(renders, n)).shape for n in names}
        if bad != 0 or len(names) != 2 or shapes != {(480, 640, 3)}:
            raise AssertionError(f"apps: check_dataset {dataset}: {bad} "
                                 f"bad, renders {names} {shapes}: "
                                 f"{printed.getvalue()}")
        log("apps", f"check_dataset {dataset}: "
            f"{printed.getvalue().splitlines()[-1]}, {len(names)} renders, "
            f"{time.perf_counter() - t0:.1f} s")

    ply = os.path.join(APPS_DIR, "obj.ply")
    pts = np.random.RandomState(11).uniform(-40, 40, (2000, 3))
    _write_ply(ply, pts)
    info_dir = os.path.join(APPS_DIR, "obj_info")
    info = gen_obj_info.gen_one_mesh_info(ply, info_dir, scale=1000.0)
    kps = np.loadtxt(os.path.join(info_dir, "farthest.txt"))
    near = np.abs(kps[:, None] - pts[None] / 1000.0).sum(-1).min(1)
    if sorted(os.listdir(info_dir)) != sorted(
            ["center.txt", "corners.txt", "radius.txt", "farthest.txt",
             "farthest4.txt", "farthest12.txt", "farthest16.txt",
             "farthest20.txt"]) or kps.shape != (8, 3) or near.max() > 1e-6:
        raise AssertionError(f"apps: gen_obj_info: {os.listdir(info_dir)}")
    log("apps", f"gen_obj_info: {info}, 8 files")

    cloud = depth_cloud(np.random.RandomState(12), 12288)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = knn_normals(cloud, k=50)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = knn_normals(cloud, k=50, device="cpu")
    cpu_s = time.perf_counter() - t0
    dots = (card.astype(np.float64) * cpu).sum(1)
    if dots.min() < 1 - 1e-6:
        raise AssertionError(f"apps: knn_normals card vs CPU: min |n.n'| "
                             f"{dots.min()}")
    log("apps", f"knn_normals, 12288 points, k 50: card {card_s:.2f} s, "
        f"CPU {cpu_s:.2f} s (host clock, first call); min n.n' card vs "
        f"CPU {dots.min():.9f} [{smi}]")


def _apps_profiling(smi, slice_lat, total):
    """``utils.profiling.device_loop_stats`` around one full-width serving
    request (iters 5, trials 3), then one ``trace()`` of two requests
    between marker kernels, whose Chrome trace must name K1-K4."""
    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    from pvn3d_tpu_torch.inference.pipeline import make_inference_step
    from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,
                                              stacked_mesh_kps)
    from pvn3d_tpu_torch.utils.profiling import (annotate,
                                                 device_loop_stats, trace)
    from pvn3d_tpu_torch.utils.weights import build_model
    cfg = Config.ycb()
    step = make_inference_step(cfg, build_model(cfg.model, 0),
                               stacked_mesh_kps(), stacked_class_radii())
    batch = synthetic_batch(cfg, batch_size=1, seed=0)
    stats, launches = _counted(lambda: device_loop_stats(
        lambda i: step(batch)["poses"].sum() + 0.0 * i, iters=5, trials=3))
    _add_counts(total, launches)
    log("apps", f"device_loop_stats of a full-width request (iters 5, "
        f"trials 3, CUDA events): {stats['s_per_iter'] * 1e3:.2f} ms a "
        f"request, trials {stats['trials_s']} s, stalls "
        f"{stats['rejected_stall_s']}, spread {stats['spread']}, suspect "
        f"{stats['suspect']}; [slice] by the host clock "
        + ", ".join(f"{t:.2f}" for t in slice_lat) + f" ms [{smi}]")

    logdir = os.path.join(APPS_DIR, "trace")

    def traced():
        with trace(logdir):
            for _ in range(_MARKERS):
                torch.cuda._sleep(1000)
            for _ in range(2):
                with annotate("request"):
                    step(batch)
            for _ in range(_MARKERS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
    _, launches = _counted(traced)
    _add_counts(total, launches)
    files = [os.path.join(logdir, f) for f in os.listdir(logdir)
             if f.endswith(".pt.trace.json")]
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    named = {k: sum(n in name for name in kernels)
             for k, n in _TRACE_NAMES.items()}
    requests = sum(e.get("name") == "request" for e in events)
    if len(files) != 1 or min(named.values()) < 1 or requests < 2:
        raise AssertionError(f"apps: trace(): files {files}, kernels named "
                             f"{named}, request ranges {requests}")
    log("apps", f"trace() of 2 requests: {os.path.basename(files[0])}, "
        f"{len(kernels)} kernel records, K1-K4 named {named}, request "
        f"ranges {requests}")


class _StageClock:
    """Host-clock time spent in named functions, summed per stage: each
    ``wrap`` replaces ``owner.name`` by a timed call until ``restore``."""

    def __init__(self):
        self.ms, self._undo = {}, []

    def wrap(self, owner, name: str, stage: str) -> None:
        fn = getattr(owner, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.ms[stage] = (self.ms.get(stage, 0.0)
                                  + (time.perf_counter() - t0) * 1e3)
        setattr(owner, name, timed)
        self._undo.append((owner, name, fn))

    def restore(self) -> None:
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        self._undo = []


def _median_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of ``reps`` calls after one warm-up call."""
    fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _host_stages(smi, ycb: str, plain: bool, steps: int = 3) -> dict:
    """YCB train frames built on the host at 0 workers (``steps`` batches
    of 4) with the stages timed apart: decode (PNG and .mat reads, the
    pasted backgrounds' too), augmentation, fill, normals, sampling (the
    rest of ``build_frame``: sampling, gathers, targets) and other.  With
    ``plain``, the fill and the normals take their plain versions (torch
    fill, numpy normals) instead of the C++ twins.  Returns ms a frame
    per stage and the frames/s over the batches after the first."""
    import functools

    from pvn3d_tpu_torch.apps.train import build_argparser as train_args
    from pvn3d_tpu_torch.apps.train import make_dataset_factory, train_config
    from pvn3d_tpu_torch.data import augment, frame, ycb as ycb_mod
    from pvn3d_tpu_torch.data.depth_completion import fill_missing
    from pvn3d_tpu_torch.data.loader import DataLoader
    from pvn3d_tpu_torch.data.normals import normals_from_depth_map
    clock = _StageClock()
    saved = (ycb_mod.fill_missing, frame.normals_from_depth_map)
    if plain:
        ycb_mod.fill_missing = functools.partial(fill_missing, impl="torch")
        frame.normals_from_depth_map = functools.partial(
            normals_from_depth_map, impl="numpy")
    try:
        clock.wrap(ycb_mod.YCBDataset, "get_item", "total")
        clock.wrap(ycb_mod.YCBDataset, "_load_raw", "decode")
        for fn in ("color_jitter", "rgb_add_noise_ycb", "add_real_back"):
            clock.wrap(augment, fn, "augmentation")
        clock.wrap(ycb_mod, "fill_missing", "fill")
        clock.wrap(frame, "normals_from_depth_map", "normals")
        clock.wrap(ycb_mod, "build_frame", "build_frame")
        args = train_args().parse_args(["--data_root", ycb, "--file_list",
                                        os.path.join(ycb, "image_list.txt")])
        factory = make_dataset_factory(args, "train", train_config(args))
        it = iter(DataLoader(factory, 4, num_workers=0, steps=steps))
        n = len(next(it)["labels"])
        t0 = time.perf_counter()
        rest = sum(len(b["labels"]) for b in it)
        rate = rest / (time.perf_counter() - t0)
        n += rest
    finally:
        clock.restore()
        ycb_mod.fill_missing, frame.normals_from_depth_map = saved
    ms = {k: v / n for k, v in clock.ms.items()}
    ms["sampling"] = ms.pop("build_frame") - ms.get("normals", 0.0)
    ms["other"] = ms["total"] - sum(ms.get(k, 0.0) for k in (
        "decode", "augmentation", "fill", "normals", "sampling"))
    label = "plain (torch fill, numpy normals)" if plain else "C++ twins"
    log("native", f"host build, YCB train frames at 0 workers, {label}: "
        f"{rate:.2f} frames/s over {rest} frames after the first batch; ms "
        f"a frame over {n}: " + ", ".join(
            f"{k} {ms.get(k, 0.0):.1f}" for k in (
                "decode", "augmentation", "fill", "normals", "sampling",
                "other", "total")) + f" [{smi}]")
    return {"frames_per_s": rate, "ms": ms}


def phase_native(smi: str, ycb: str = ""):
    """The host's C++ twins on the card machine's host: built from the
    checkout's sources (``g++ -O3 -fopenmp -shared -fPIC`` into
    ``build/native``); on a synthetic 480x640 sensor frame the fill twin
    against the torch fill and the normals twin against the numpy normals
    (ms a frame, median of 5; max abs difference, zero masks equal); the
    FPS twin's indices against the numpy plain version; then the host
    frame build's stages apart and the loader's frames/s at 0 workers,
    with the twins and with the plain versions (``_host_stages``), on the
    [disk] phase's YCB tree (written anew when it is missing)."""
    from pvn3d_tpu_torch import native
    from pvn3d_tpu_torch.data import depth_completion as dc
    from pvn3d_tpu_torch.data.normals import normals_from_depth_map
    from pvn3d_tpu_torch.data.synthetic import synth_sensor_frame
    t0 = time.perf_counter()
    for name in ("preprocess", "fps"):
        native.load_library(name)
    log("native", f"twins built and loaded in {time.perf_counter() - t0:.1f}"
        f" s ({native.CXX} {' '.join(native.CXX_FLAGS)}; "
        f"PVN3D_NATIVE_THREADS={os.environ.get('PVN3D_NATIVE_THREADS', '1')}"
        f", torch CPU threads {torch.get_num_threads()})")
    _, depth, k = synth_sensor_frame(480, 640, seed=3)
    depth_mm = depth[0] * 1000.0
    fill = {impl: dc.fill_missing(depth_mm, 1000.0, impl=impl) / 1000.0
            for impl in ("auto", "torch")}
    fill_ms = {impl: _median_ms(lambda: dc.fill_missing(
        depth_mm, 1000.0, impl=impl)) for impl in ("auto", "torch")}
    ferr = np.abs(fill["auto"] - fill["torch"])
    if ferr.max() > 2e-3 or ferr[2:-2, 2:-2].max() > 1e-5:
        raise AssertionError(f"native fill: twin vs torch {ferr.max()} "
                             f"(inside the border {ferr[2:-2, 2:-2].max()})")
    nrm = {impl: normals_from_depth_map(fill["auto"], k[0], impl=impl)
           for impl in ("auto", "numpy")}
    nrm_ms = {impl: _median_ms(lambda: normals_from_depth_map(
        fill["auto"], k[0], impl=impl)) for impl in ("auto", "numpy")}
    # At 480x640 the numpy version's float32 running-sum box blur (row
    # sums up to ~800 m) carries up to ~2e-2 of error into the normals, the
    # twin's double window sums ~1e-4 (against a float64 evaluation of the
    # same formula): held as JAX's twin test holds directions, the same
    # zero pixels and cos >= 0.999 on the others.
    nerr = float(np.abs(nrm["auto"] - nrm["numpy"]).max())
    zero = {i: (n == 0).all(-1) for i, n in nrm.items()}
    live = ~zero["auto"]
    cos = float((nrm["auto"] * nrm["numpy"]).sum(-1)[live].min())
    if not np.array_equal(zero["auto"], zero["numpy"]) or cos < 0.999:
        raise AssertionError(f"native normals: zero pixels differ, or "
                             f"min cos {cos} < 0.999 (max abs diff {nerr})")
    log("native", f"480x640 frame: fill twin {fill_ms['auto']:.2f} ms vs "
        f"torch {fill_ms['torch']:.2f} ms a frame (median of 5), max abs "
        f"diff {ferr.max():.3e} m ({ferr[2:-2, 2:-2].max():.3e} off the "
        f"2-pixel border); normals twin {nrm_ms['auto']:.2f} ms vs numpy "
        f"{nrm_ms['numpy']:.2f} ms, max abs diff {nerr:.3e}, min cos "
        f"{cos:.6f}, zero pixels equal [{smi}]")
    rng = np.random.RandomState(5)
    cloud = (rng.rand(20000, 3) * [0.2, 0.1, 0.05]).astype(np.float32)
    fps_ms = {}
    for impl in ("auto", "numpy"):
        for center in (False, True):
            got = native.fps_indices(cloud, 64, init_center=center,
                                     impl=impl)
            if impl == "numpy" and not np.array_equal(
                    got, native.fps_indices(cloud, 64, init_center=center)):
                raise AssertionError(f"native fps: twin indices differ "
                                     f"(init_center={center})")
        fps_ms[impl] = _median_ms(lambda: native.fps_indices(
            cloud, 64, impl=impl))
    log("native", f"FPS of 64 from 20000 points: twin indices equal numpy's"
        f" in both start modes; twin {fps_ms['auto']:.2f} ms vs numpy "
        f"{fps_ms['numpy']:.2f} ms [{smi}]")
    if not ycb or not os.path.isdir(ycb):
        ycb, _ = _disk_trees(8)
    rates = {plain: _host_stages(smi, ycb, plain) for plain in (False, True)}
    log("native", f"loader at 0 workers: {rates[False]['frames_per_s']:.2f} "
        f"frames/s with the twins, {rates[True]['frames_per_s']:.2f} with "
        f"the plain versions [{smi}]")
    return rates


def phase_apps(smi: str, slice_lat=(), occ_frames: int = 4,
               demo_frames: int = 2):
    """The apps' and tools' surface on trees written here (see the
    module docstring).  Returns the launch counts of its runs.

    ``occ_frames`` annotated frames an ``--occ`` evaluation and
    ``demo_frames`` a demo run (see the module docstring)."""
    import gc
    t0 = time.perf_counter()
    trees = _apps_trees(occ_frames, demo_frames)
    total = {}
    _apps_occ(smi, trees, total, occ_frames)
    _apps_demo(smi, trees, total, demo_frames)
    _apps_trunk(smi, trees, total)
    _apps_tools(smi, trees)
    _apps_profiling(smi, slice_lat, total)
    if any(total.get(k, 0) < 1 for k in ("fps", "query", "interp",
                                         "interp_bwd", "winner")):
        raise AssertionError(f"apps: launches {total}")
    log("apps", f"phase done in {time.perf_counter() - t0:.1f} s; "
        f"launches {total}")
    gc.collect()
    torch.cuda.empty_cache()
    from pvn3d_tpu_torch.ops.kernels import KERNELS
    return {k.name: total.get(k.name, 0) for k in KERNELS}


PARALLEL_DIR = os.path.join(ROOT, "build", "parallel")


def _snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _max_diff(a: dict, b: dict, running: bool = False) -> float:
    """The largest difference between two state dicts over the parameters
    (or, with ``running``, the BN running statistics)."""
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in a if ("running_" in k) == running
               and "num_batches" not in k)


def _timed_step(step, model, cfg, sd0, batch):
    """One step from the weights ``sd0`` and a fresh optimizer: (metrics,
    host ms to the step's end, the weights after, the step's gradients)."""
    from pvn3d_tpu_torch.train.state import TrainState, make_optimizer
    model.load_state_dict(sd0)
    state = TrainState(0, model, make_optimizer(cfg, model))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = step(state, batch)
    torch.cuda.synchronize()
    return (metrics, (time.perf_counter() - t0) * 1e3, _snapshot(model),
            {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None})


# Two gradients of the same arithmetic on the card (a mesh step of one
# rank, a rematerialised step, against the plain step) part only by the
# run-to-run rounding of the backward's atomic scatter-adds, which bf16
# activations round up to their own epsilon: two plain bf16 steps at full
# width part by ~8e-3 in global L2 on an H100 (two float32 ones by
# ~6e-6).  The bound is [train]'s card-against-CPU one: other dropout
# masks move the gradient by ~90% (the tiny CPU model), a seg term
# without its 1 / world by ~10%.
SAME_GRAD_L2 = 3e-2


def _grad_l2(got: dict, want: dict) -> float:
    """The global L2 distance of two gradient dicts, relative to
    ``want``'s; both must hold the same parameters."""
    if got.keys() != want.keys():
        raise AssertionError(f"gradients of {sorted(got.keys() ^ want.keys())}"
                             f" on one side only")
    num = sum(float((got[k] - w).double().pow(2).sum())
              for k, w in want.items())
    den = sum(float(w.double().pow(2).sum()) for w in want.values())
    return float(np.sqrt(num / den))


def _parallel_world_one(smi, seed: int):
    """[parallel] part 1: a world-1 NCCL group in this process; one
    full-width bf16 step at batch 4 through the mesh's step (synced BN,
    gradient all-reduce, global metrics) against the plain step from the
    same weights and batch.  Returns the mesh step's launch counts."""
    import torch.distributed as dist

    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    from pvn3d_tpu_torch.parallel.mesh import Mesh, make_mesh
    from pvn3d_tpu_torch.parallel.multihost import initialize_distributed
    from pvn3d_tpu_torch.train.schedule import lr_schedule
    from pvn3d_tpu_torch.train.state import TrainState, make_optimizer
    from pvn3d_tpu_torch.train.step import make_train_step, to_device
    from pvn3d_tpu_torch.utils.weights import build_model
    store = os.path.join(PARALLEL_DIR, "store1")
    initialize_distributed(f"file://{store}", 1, 0)
    try:
        # make_mesh takes a group of one rank for none (the plain step);
        # this mesh holds the group, so the step runs every collective.
        if make_mesh().group is not None:
            raise AssertionError("parallel: make_mesh kept a 1-rank group")
        mesh = Mesh(dp=1, rank=0, device=torch.device(
            "cuda", torch.cuda.current_device()), group=dist.group.WORLD)
        cfg = Config.ycb()
        model = build_model(cfg.model, seed).to(mesh.device).train()
        sd0 = _snapshot(model)
        batch = to_device(synthetic_batch(cfg, batch_size=4, seed=seed),
                          mesh.device)
        steps = {"plain": make_train_step(cfg),
                 "mesh": make_train_step(cfg, mesh=mesh)}
        for name in steps:                                    # warm-up
            _timed_step(steps[name], model, cfg, sd0, batch)
        runs = {"plain": [], "mesh": []}
        for name in ("plain", "mesh", "mesh", "plain", "plain", "mesh"):
            (m, t, sd, g), launches = _counted(
                lambda: _timed_step(steps[name], model, cfg, sd0, batch))
            runs[name].append((float(m["loss"]), sd, launches, t, g))
        want = _expected_launches(fps=1, query=4, interp=4, interp_bwd=4)
        if any(r[2] != want for r in runs["mesh"]):
            raise AssertionError(f"parallel: mesh steps launched "
                                 f"{[r[2] for r in runs['mesh']]}, "
                                 f"expected {want} each")
        (loss_p, sd_p, _, _, g_p), (loss_p2, sd_p2, _, _, g_p2) = \
            runs["plain"][:2]
        loss_m, sd_m, _, _, g_m = runs["mesh"][0]
        floor = _max_diff(sd_p, sd_p2)
        diff = _max_diff(sd_p, sd_m)
        g_floor, g_diff = _grad_l2(g_p2, g_p), _grad_l2(g_m, g_p)
        lr = lr_schedule(cfg.train)(0)
        # A bias in front of a BN has a gradient of rounding noise: where
        # the card's backward is not bit for bit run to run (atomic
        # scatter-adds), Adam moves such an entry by up to lr either way
        # (2 lr + 1e-6 apart: test_three_train_steps_match's bound).
        bound = 0.0 if floor == 0.0 else 2.0 * lr + 1e-6
        stats = _max_diff(sd_p, sd_m, running=True)
        if (not np.isfinite(loss_m) or loss_m != loss_p or loss_p2 != loss_p
                or diff > bound or stats != 0.0 or g_diff > SAME_GRAD_L2):
            raise AssertionError(
                f"parallel: world-1 mesh step: loss {loss_m!r} against "
                f"{loss_p!r} and {loss_p2!r}, gradient {g_diff:.3g} in "
                f"global L2 (plain against plain {g_floor:.3g}, bound "
                f"{SAME_GRAD_L2:g}), parameters {diff:.3g} apart "
                f"(plain against plain {floor:.3g}, bound {bound:.3g}), "
                f"running statistics {stats:.3g} apart")
        trace = {}
        for name in ("plain", "mesh"):
            model.load_state_dict(sd0)
            state = TrainState(0, model, make_optimizer(cfg, model))
            # One trace each, kept as it comes: after the earlier phases
            # a trace may lose a few launches' device records (logged).
            trace[name] = _cuda_trace(lambda: steps[name](state, batch), 1,
                                      names=("nccl",))
        tr = trace["mesh"]
        ms = {k: ", ".join(f"{r[3]:.1f}" for r in v) for k, v in runs.items()}
        log("parallel", f"world-1 NCCL group (file store), Config.ycb() "
            f"bf16 batch 4: the mesh step's loss {loss_m!r} equals the plain "
            f"step's bit for bit, running statistics equal bit for bit, "
            f"gradient {g_diff:.3g} in global L2 (plain against plain "
            f"{g_floor:.3g}), "
            f"parameters {diff:.3g} apart (plain against plain {floor:.3g}); "
            f"step ms mesh {ms['mesh']}, plain {ms['plain']} (in turns: "
            f"plain, mesh, mesh, plain, plain, mesh); one mesh "
            f"step's trace (CUDA only): device {tr['device_ms']:.2f} ms, "
            f"NCCL kernels {tr['named']['nccl']} taking "
            f"{tr['named_ms']['nccl']:.3f} ms "
            f"({100 * tr['named_ms']['nccl'] / tr['device_ms']:.2f}%), "
            f"{tr['kernels']} kernels and {tr['copies']} copies (a plain "
            f"step's: device {trace['plain']['device_ms']:.2f} ms, "
            f"{trace['plain']['kernels']} kernels and "
            f"{trace['plain']['copies']} copies; device records lost "
            f"{tr['lost']} and {trace['plain']['lost']}); launches a mesh "
            f"step "
            f"{runs['mesh'][0][2]} [{smi}]")
        total = {}
        for r in runs["mesh"]:
            _add_counts(total, r[2])
        return total
    finally:
        dist.destroy_process_group()


def parallel_rank(rank: int, world: int, seed: int) -> int:
    """[parallel] part 2, one rank (``python3 chip_smoke.py --parallel-rank
    R W SEED``): a data-parallel float32 step on its rows of a global
    batch of 4, then a dp-sharded request of 4 frames; rank 0 also runs
    the one-process step and request and compares.  Prints its record as
    one ``[parallel-rank]`` JSON line."""
    import dataclasses

    import torch.distributed as dist

    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    from pvn3d_tpu_torch.inference.pipeline import make_inference_step
    from pvn3d_tpu_torch.parallel.mesh import (make_mesh, replicated,
                                               shard_batch)
    from pvn3d_tpu_torch.train.schedule import lr_schedule
    from pvn3d_tpu_torch.train.step import make_train_step
    from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,
                                              stacked_mesh_kps)
    from pvn3d_tpu_torch.utils.weights import build_model
    torch.cuda.set_device(0)
    # NCCL refuses two ranks on one card ("Duplicate GPU detected"); gloo
    # takes CUDA tensors for broadcast and all_reduce (through the host),
    # which is all the mesh's collectives use.
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(PARALLEL_DIR, 'store2')}",
        rank=rank, world_size=world)
    mesh = make_mesh()
    c = Config.ycb()
    cfg = dataclasses.replace(c, model=dataclasses.replace(
        c.model, compute_dtype="float32", cnn=dataclasses.replace(
            c.model.cnn, dropout_psp=0.0, dropout_up=0.0)))
    model = build_model(cfg.model, seed).to(mesh.device).train()
    replicated(mesh, model)
    sd0 = _snapshot(model)
    batch = synthetic_batch(cfg, batch_size=4, seed=seed)
    (m, _, sd_m, grads), launches = _counted(lambda: _timed_step(
        make_train_step(cfg, mesh=mesh), model, cfg, sd0,
        shard_batch(mesh, batch)))
    rec = {"rank": rank, "loss": float(m["loss"]),
           "launches_train": launches}
    if rank == 0:
        plain = make_train_step(cfg)
        floor = _timed_step(plain, model, cfg, sd0, batch)[3]
        m1, _, sd_1, g_1 = _timed_step(plain, model, cfg, sd0, batch)
        lr = lr_schedule(cfg.train)(0)
        rec.update(
            loss_1=float(m1["loss"]),
            loss_rel=abs(rec["loss"] - float(m1["loss"]))
            / abs(float(m1["loss"])),
            grad_l2=_grad_l2(grads, g_1), grad_l2_plain=_grad_l2(floor, g_1),
            params_outside=sum(int(((sd_m[k] - v).abs() > 2.0 * lr + 1e-6
                                    + 1e-5 * v.abs()).sum())
                               for k, v in sd_1.items()
                               if v.is_floating_point() and "running_"
                               not in k),
            params_max=_max_diff(sd_m, sd_1))
    model.load_state_dict(sd0)
    request = synthetic_batch(cfg, batch_size=4, seed=seed + 1)
    meshes = (stacked_mesh_kps(), stacked_class_radii())
    out, rec["launches_serve"] = _counted(lambda: make_inference_step(
        cfg, model, *meshes, mesh=mesh)(request))
    if rank == 0:
        want = make_inference_step(cfg, model, *meshes)(request)
        rec["poses_err"] = _err(out["poses"], want["poses"])
        rec["seg_equal"] = bool(torch.equal(out["seg"], want["seg"]))
        rec["present_equal"] = bool(torch.equal(out["present"],
                                                want["present"]))
    rec["poses_shape"] = list(out["poses"].shape)
    dist.destroy_process_group()
    print("[parallel-rank] " + json.dumps(rec), flush=True)
    return 0


def _parallel_two_ranks(smi, seed: int):
    """[parallel] part 2: two ranks spawned on this card over gloo.
    Returns the ranks' launch counts, summed."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank",
         str(r), "2", str(seed)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"parallel: rank {r} exited "
                                 f"{p.returncode}:\n{out[-6000:]}")
    recs = [json.loads(ln.split("[parallel-rank] ", 1)[1])
            for out in outs for ln in out.splitlines()
            if ln.startswith("[parallel-rank] ")]
    if len(recs) != 2:
        raise AssertionError(f"parallel: {len(recs)} rank records")
    r0, r1 = sorted(recs, key=lambda r: r["rank"])
    total = {}
    want = _expected_launches(fps=1, query=4, interp=4, interp_bwd=4)
    for r in (r0, r1):
        if r["launches_train"] != want:
            raise AssertionError(f"parallel: rank {r['rank']} step "
                                 f"launched {r['launches_train']}")
        if any(r["launches_serve"][k] < 1
               for k in ("fps", "query", "interp", "winner")):
            raise AssertionError(f"parallel: rank {r['rank']} request "
                                 f"launched {r['launches_serve']}")
        _add_counts(total, r["launches_train"])
        _add_counts(total, r["launches_serve"])
        if r["poses_shape"][0] != 4:
            raise AssertionError(f"parallel: gathered poses {r}")
    # float32 reduction order: two half-batch BN means against one whole
    # (the loss within 1e-5 relative); the gradient within 3e-2 in global
    # L2, the float32 conditioning of a batch-statistics backward that
    # [train]'s card-against-CPU check allows (two plain steps on the card
    # part by ~1e-2 already: atomic scatter-adds); parameters within
    # 2 lr + 1e-6 + 1e-5 |p| (Adam moves a rounding-noise entry by lr).
    if (r0["loss"] != r1["loss"] or r0["loss_rel"] > 1e-5
            or r0["grad_l2"] > 3e-2 or r0["params_outside"]
            or r0["poses_err"] > 2e-4 or not r0["seg_equal"]):
        raise AssertionError(f"parallel: two ranks against one process: "
                             f"{r0}; rank 1 loss {r1['loss']!r}")
    log("parallel", f"two ranks on one card over gloo (spawned, "
        f"{time.perf_counter() - t0:.1f} s), Config.ycb() float32, dropout "
        f"0: each rank 2 of a global batch of 4; both ranks' loss "
        f"{r0['loss']!r}; against the one-process batch-4 step "
        f"{r0['loss_1']!r}: loss {r0['loss_rel']:.3g} relative, gradient "
        f"{r0['grad_l2']:.3g} in global L2 (two plain steps "
        f"{r0['grad_l2_plain']:.3g}), parameters {r0['params_max']:.3g}"
        f" apart at most; dp-sharded request of 4 frames (2 a rank): poses "
        f"{r0['poses_err']:.3g} from the unsharded request's, seg equal "
        f"{r0['seg_equal']}, present equal {r0['present_equal']}; "
        f"launches rank 0 step {r0['launches_train']}, request "
        f"{r0['launches_serve']}; rank 1 step {r1['launches_train']}, "
        f"request {r1['launches_serve']} [{smi}]")
    return total


def phase_parallel(smi: str, seed: int = 0) -> dict:
    """[parallel] (see the module docstring).  Returns the launch counts
    of its counted runs."""
    import gc
    import shutil
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)      # the file stores
    os.makedirs(PARALLEL_DIR)
    total = _parallel_world_one(smi, seed)
    gc.collect()
    torch.cuda.empty_cache()
    _add_counts(total, _parallel_two_ranks(smi, seed))
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    return total


def phase_remat(smi: str, seed: int = 0) -> dict:
    """[remat] (see the module docstring).  Returns the launch counts of
    its counted batch-4 steps."""
    import dataclasses
    import gc

    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    from pvn3d_tpu_torch.train.schedule import lr_schedule
    from pvn3d_tpu_torch.train.step import make_train_step, to_device
    from pvn3d_tpu_torch.utils.weights import build_model
    dev = torch.device("cuda")
    cfg = Config.ycb()
    modes = {"off": (False, "full"), "full": (True, "full"),
             "dots": (True, "dots")}
    cfgs = {name: dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, remat=r, remat_policy=p)) for name, (r, p) in modes.items()}
    model = build_model(cfg.model, seed).to(dev).train()
    sd0 = _snapshot(model)
    batch = to_device(synthetic_batch(cfg, batch_size=4, seed=seed), dev)
    steps = {name: make_train_step(c) for name, c in cfgs.items()}
    for name in steps:                                        # warm-up
        _timed_step(steps[name], model, cfgs[name], sd0, batch)
    runs, total = {}, {}
    for name in ("off", "full", "dots", "off2"):
        key = name.rstrip("2")
        (m, t, sd, g), launches = _counted(lambda: _timed_step(
            steps[key], model, cfgs[key], sd0, batch))
        runs[name] = (float(m["loss"]), sd, t, launches, g)
        if name != "off2":
            _add_counts(total, launches)
    loss0, sd_off, _, _, g_off = runs["off"]
    floor = _max_diff(sd_off, runs["off2"][1])
    g_floor = _grad_l2(runs["off2"][4], g_off)
    lr = lr_schedule(cfg.train)(0)
    parts = []
    for name, loss_rtol, atol in (("full", 1e-6, 1e-6), ("dots", 3e-5, 1e-5)):
        loss, sd, t, launches, g = runs[name]
        g_diff = _grad_l2(g, g_off)
        want = _expected_launches(fps=2, query=8, interp=8, interp_bwd=4)
        if launches != want:
            raise AssertionError(f"remat {name}: launched {launches}, "
                                 f"expected {want}")
        diff = _max_diff(sd_off, sd)
        # Where the plain step is not bit for bit run to run (atomic
        # scatter-adds in the backward), Adam moves a rounding-noise entry
        # by up to lr either way: the bound then takes 2 lr.
        bound = atol if floor == 0.0 else atol + 2.0 * lr + 1e-6
        if (abs(loss - loss0) > loss_rtol * abs(loss0) or diff > bound
                or _max_diff(sd_off, sd, running=True) != 0.0
                or g_diff > SAME_GRAD_L2):
            raise AssertionError(
                f"remat {name}: loss {loss!r} against {loss0!r}, gradient "
                f"{g_diff:.3g} in global L2 (bound {SAME_GRAD_L2:g}; plain "
                f"against plain {g_floor:.3g}), parameters "
                f"{diff:.3g} apart (bound {bound:.3g}; plain against plain "
                f"{floor:.3g}), running statistics "
                f"{_max_diff(sd_off, sd, running=True):.3g} apart")
        rel = abs(loss - loss0) / abs(loss0)
        parts.append(f"{name}: loss {loss!r} ({rel:.3g} relative), "
                     f"gradient {g_diff:.3g} in global L2, "
                     f"parameters {diff:.3g} apart, running "
                     f"statistics equal, step {t:.1f} ms, launches "
                     f"{launches}")
    log("remat", f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"Config.ycb() bf16 batch 4 from one state: off: loss {loss0!r}, "
        f"step {runs['off'][2]:.1f} ms, launches {runs['off'][3]}; "
        + "; ".join(parts) + f"; plain against plain: parameters "
        f"{floor:.3g}, gradient {g_floor:.3g} [{smi}]")
    # The batch-4 runs' weights and gradients would sit under the batch-24
    # peaks.
    del batch, runs, sd_off, g_off, sd, g
    big = to_device(synthetic_batch(cfg, batch_size=24, seed=seed + 1), dev)
    for name in modes:
        for timed in (False, True):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            try:
                m, t, _, _ = _timed_step(steps[name], model, cfgs[name],
                                         sd0, big)
            except torch.cuda.OutOfMemoryError as e:
                model.zero_grad(set_to_none=True)
                log("remat", f"batch 24, remat {name}: out of memory at "
                    f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
                    f"({str(e).splitlines()[0][:100]})")
                break
            if timed:
                if not np.isfinite(float(m["loss"])):
                    raise AssertionError(f"remat {name}: batch 24 loss "
                                         f"{float(m['loss'])}")
                log("remat", f"batch 24, remat {name}: step {t:.1f} ms, "
                    f"peak memory "
                    f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
                    f"loss {float(m['loss']):.4f} [{smi}]")
    del big, model
    gc.collect()
    torch.cuda.empty_cache()
    return total


# The train-mode BatchNorms of the batch-24 step, bf16: (name, shape, memory
# format); NCHW maps in both formats (the stem's input arrives in
# channels_last memory, the upsamples' from the resize's products).
BN_SHAPES = (
    ("stem", (24, 64, 240, 320), "channels_last"),
    ("stem", (24, 64, 240, 320), "nchw"),
    ("layer4", (24, 512, 60, 80), "channels_last"),
    ("layer4", (24, 512, 60, 80), "nchw"),
    ("up_3", (24, 64, 480, 640), "nchw"),
    ("up_3", (24, 64, 480, 640), "channels_last"),
    ("sa", (24, 2048, 32, 128), "rows"),
    ("head_1024", (24 * 12288, 1024), "rows"),
    ("head_128", (24 * 12288, 128), "rows"))
BN_EPS = 1e-5
# The benchmark's train limits (perfbench/limits/train.json).
TRAIN_LIMITS = {"loss_gap": 0.003, "grad_gap": 0.03, "update_gap": 0.2}


def _bn_replaced(x, w, b, nchw, relu, dy):
    """The plain tensor code the BatchNorm function replaced, forward and
    autograd's backward (the timing yardstick of the old path)."""
    axes = (0, 2, 3) if nchw else tuple(range(x.dim() - 1))
    xg = x.detach().requires_grad_(True)
    xf = xg.float()
    mean = xf.mean(dim=axes)
    var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + BN_EPS) * w
    if nchw:
        mean, inv, b = mean[:, None, None], inv[:, None, None], \
            b[:, None, None]
    y = ((xg.float() - mean) * inv + b).to(x.dtype)
    y = torch.relu(y) if relu else y
    if dy is not None:
        torch.autograd.grad(y, xg, dy)
    return y


def _bn_library(x, w, b, rm, rv, nchw, relu, dy):
    """cuDNN's train-mode batch norm through ``F.batch_norm`` (channels
    last as (rows, C)), forward and, with ``dy``, autograd's backward."""
    import torch.nn.functional as F
    xg = x.detach().requires_grad_(dy is not None)
    x4 = xg if nchw else xg.view(-1, x.shape[-1])
    y = F.batch_norm(x4, rm, rv, w, b, True, 0.1, BN_EPS)
    y = torch.relu(y) if relu else y
    if dy is not None:
        torch.autograd.grad(y, xg, dy.view_as(y))
    return y


def _bn_close(got, want, rel: float, flip=None) -> tuple:
    """(largest |got - want| over elements outside ``flip``, elements
    beyond rel * |want| + 0.01 rel * max|want| of tolerance)."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    if flip is not None:
        d = torch.where(flip, 0.0, d)
    tol = rel * want.abs() + 1e-2 * rel * float(want.abs().max())
    return float(d.max()), int((d > tol).sum())


def _bn_case(name, shape, fmt, relu, seed):
    """One BN shape on the card: kernels against the plain branch, then
    each pass timed.  Returns the case's record."""
    from pvn3d_tpu_torch.ops.kernels import bn as kbn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    nchw = fmt != "rows"
    c = shape[1] if nchw else shape[-1]

    def make(scale, shift):
        t = (torch.randn(shape, generator=gen, device=dev) * scale
             + shift).to(torch.bfloat16)
        return (t.to(memory_format=torch.channels_last)
                if fmt == "channels_last" else t)
    x, dy = make(2.0, 0.5), make(1.0, 0.0)
    w = torch.rand(c, generator=gen, device=dev) + 0.5
    b = torch.randn(c, generator=gen, device=dev)
    rm0 = torch.randn(c, generator=gen, device=dev)
    rv0 = torch.rand(c, generator=gen, device=dev) + 0.5
    before = {k.name: k.launches for k in kbn.KERNELS}
    rm, rv = rm0.clone(), rv0.clone()
    y, st, n = kbn._forward_cuda(x, w, b, rm, rv, nchw, 0.1, BN_EPS, relu,
                                 True, None)
    dx, dw, db = kbn._backward_cuda(x, dy, b, st, nchw, relu, None, n)
    torch.cuda.synchronize()
    launches = {k.name: k.launches - before[k.name] for k in kbn.KERNELS}
    want = {"bn_stats": 1, "bn_finish": 2, "bn_apply": 1,
            "bn_bwd_reduce": 1, "bn_bwd_apply": 1}
    if launches != want:
        raise AssertionError(f"bn {name}: launched {launches}")
    if y.stride() != x.stride() or dx.stride() != x.stride():
        raise AssertionError(f"bn {name}: strides {y.stride()} / "
                             f"{dx.stride()} against {x.stride()}")
    rmp, rvp = rm0.clone(), rv0.clone()
    yp, stp, _ = kbn.forward_plain(x, w, b, rmp, rvp, nchw, 0.1, BN_EPS,
                                   relu, True, None)
    dxp, dwp, dbp = kbn.backward_plain(x, dy, b, stp, nchw, relu, None, n)
    std = torch.sqrt(1.0 / stp[1] ** 2)
    stats_err = max(float(((st[0] - stp[0]).abs() / std).max()),
                    float(((st[1] - stp[1]).abs() / stp[1]).max()),
                    float((st[3] != stp[3]).sum()))
    # A ReLU whose input rounds to 0 on one side only passes dy there.
    flip = (y > 0) != (yp > 0) if relu else None
    n_flip = 0 if flip is None else int(flip.sum())
    y_err, y_bad = _bn_close(y, yp, 2 ** -7)
    dx_err, dx_bad = _bn_close(dx, dxp, 2 ** -6, flip)
    dw_err = float((dw - dwp).norm() / dwp.norm())
    db_err = float((db - dbp).norm() / dbp.norm())
    run_err = max(float((rm - rmp).abs().max()),
                  float(((rv - rvp).abs() / rvp).max()))
    if (stats_err > 1e-4 or y_bad or dx_bad or dw_err > 1e-3
            or db_err > 1e-3 or run_err > 1e-5
            or n_flip > 1e-5 * x.numel()):
        raise AssertionError(
            f"bn {name} {fmt} relu={relu}: statistics {stats_err:.3g}, y "
            f"{y_err:.3g} ({y_bad} beyond), dx {dx_err:.3g} ({dx_bad} "
            f"beyond, {n_flip} ReLU flips), dweight {dw_err:.3g}, dbias "
            f"{db_err:.3g}, running {run_err:.3g}")
    del yp, dxp, stp
    es = x.element_size()
    fwd_bytes, bwd_bytes = 3 * es * x.numel(), 5 * es * x.numel()

    def fwd():
        kbn._forward_cuda(x, w, b, rm, rv, nchw, 0.1, BN_EPS, relu, False,
                          None)

    def bwd():
        kbn._backward_cuda(x, dy, b, st, nchw, relu, None, n)
    rec = dict(
        name=name, shape=list(shape), format=fmt, relu=relu,
        layout="rows" if kbn.layout_of(x, nchw)[0] == kbn.ROWS else "nchw",
        grid=dataclasses.asdict(kbn._grid_of(x, nchw)),
        stats_err=stats_err, y_err=y_err, dx_err=dx_err, relu_flips=n_flip,
        dweight_err=dw_err, dbias_err=db_err, running_err=run_err,
        fwd_ms=time_ms(fwd), bwd_ms=time_ms(bwd),
        fwd_device_ms=device_ms(fwd, reps=3),
        bwd_device_ms=device_ms(bwd, reps=3),
        fwd_bound_ms=bound_ms(fwd_bytes, 0)[0],
        bwd_bound_ms=bound_ms(bwd_bytes, 0)[0],
        plain_fwd_ms=time_ms(lambda: kbn.forward_plain(
            x, w, b, rm, rv, nchw, 0.1, BN_EPS, relu, False, None)),
        plain_bwd_ms=time_ms(lambda: kbn.backward_plain(
            x, dy, b, st, nchw, relu, None, n)),
        replaced_fwd_ms=time_ms(lambda: _bn_replaced(x, w, b, nchw, relu,
                                                     None)),
        replaced_fwd_bwd_ms=time_ms(lambda: _bn_replaced(x, w, b, nchw,
                                                         relu, dy)),
        library_fwd_ms=time_ms(lambda: _bn_library(x, w, b, rm, rv, nchw,
                                                   relu, None)),
        library_fwd_bwd_ms=time_ms(lambda: _bn_library(x, w, b, rm, rv,
                                                       nchw, relu, dy)))
    rec["fwd_roofline"] = rec["fwd_bound_ms"] / rec["fwd_device_ms"]
    rec["bwd_roofline"] = rec["bwd_bound_ms"] / rec["bwd_device_ms"]
    return rec


def _bn_census():
    """Wraps ``layout_of`` to count the (method, layout, shape) of each
    train-mode BN call; returns the counter and the undo."""
    import collections

    from pvn3d_tpu_torch.ops.kernels import bn as kbn
    seen = collections.Counter()
    real = kbn.layout_of

    def counted(x, nchw):
        out = real(x, nchw)
        seen[("nchw" if nchw else "last", "rows" if out[0] == kbn.ROWS
              else "nchw", tuple(x.shape))] += 1
        return out
    kbn.layout_of = counted
    return seen, lambda: setattr(kbn, "layout_of", real)


@contextlib.contextmanager
def _bn_plain_forced():
    """The BatchNorm function's plain branch on CUDA tensors."""
    from pvn3d_tpu_torch.ops.kernels import bn as kbn
    saved = kbn._forward_cuda, kbn._backward_cuda
    kbn._forward_cuda, kbn._backward_cuda = (kbn.forward_plain,
                                             kbn.backward_plain)
    try:
        yield
    finally:
        kbn._forward_cuda, kbn._backward_cuda = saved


def _bn_steps(cfg, sd0, batch, n_steps: int):
    """``n_steps`` steps from ``sd0`` with a fresh optimizer: the losses,
    the first step's gradient norms and the parameters' change norms by
    leaf, the BN launches of the first step, its host ms and the peak
    memory."""
    import gc

    from pvn3d_tpu_torch.ops.kernels import BN_KERNELS
    from pvn3d_tpu_torch.train.state import TrainState, make_optimizer
    from pvn3d_tpu_torch.train.step import make_train_step
    from pvn3d_tpu_torch.utils.weights import build_model
    model = build_model(cfg.model, 0).to("cuda").train()
    model.load_state_dict(sd0)
    state = TrainState(0, model, make_optimizer(cfg, model))
    step = make_train_step(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, grads, launches, ms = [], None, None, None
    for i in range(n_steps):
        before = {k.name: k.launches for k in BN_KERNELS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        torch.cuda.synchronize()
        if i == 0:
            ms = (time.perf_counter() - t0) * 1e3
            launches = {k.name: k.launches - before[k.name]
                        for k in BN_KERNELS}
            grads = {k: float(p.grad.double().norm())
                     for k, p in model.named_parameters()
                     if p.grad is not None}
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    update = {k: float((p.detach().double() - sd0[k].double()).norm())
              for k, p in model.named_parameters()}
    del state, model, step
    return losses, grads, update, launches, ms, peak


def _bn_gaps(got, want) -> dict:
    """The benchmark's three train checks (``perfbench/drivers/train.py::
    compare``) between two runs of ``_bn_steps``: the worst relative gap
    of the losses; of the leaves whose first gradient is at least a
    thousandth of the median leaf's, the median gap of first-gradient
    norms and the worst gap of the parameters' change norms, each against
    the leaf's or the median leaf's norm, whichever is larger."""
    med = statistics.median(want[1].values())
    counted = [k for k, v in want[1].items() if v >= 1e-3 * med]

    def gaps(p, r):
        m = statistics.median(r[k] for k in counted)
        return [abs(p[k] - r[k]) / max(r[k], m) for k in counted]
    return {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(got[0], want[0])),
            "grad_gap": statistics.median(gaps(got[1], want[1])),
            "update_gap": max(gaps(got[2], want[2]))}


def phase_bn(smi: str, seed: int = 0, shapes=BN_SHAPES) -> dict:
    """[bn] (see the module docstring) on ``shapes`` (a subset of
    ``BN_SHAPES`` for a quicker look).  Returns the record of the JSON
    line."""
    import dataclasses as dc
    import gc

    from pvn3d_tpu_torch.config import Config
    from pvn3d_tpu_torch.data.synthetic import synthetic_batch
    from pvn3d_tpu_torch.models.layers import BatchNorm
    from pvn3d_tpu_torch.train.step import to_device
    from pvn3d_tpu_torch.utils.weights import build_model
    cases = []
    for i, (name, shape, fmt) in enumerate(shapes):
        for relu in (False, True):
            rec = _bn_case(name, shape, fmt, relu, seed + 2 * i + relu)
            cases.append(rec)
            log("bn", json.dumps(rec))
            gc.collect()
            torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = Config.ycb()
    model = build_model(cfg.model, seed)               # on the CPU
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    sd0 = {k: v.to(dev) for k, v in model.state_dict().items()}
    del model
    batch = to_device(synthetic_batch(cfg, batch_size=24, seed=seed), dev)
    per_fwd = {"bn_stats": n_bn, "bn_apply": n_bn, "bn_bwd_reduce": n_bn,
               "bn_bwd_apply": n_bn, "bn_finish": 2 * n_bn}
    steps = {}
    for mode, remat, policy in (("off", False, "full"),
                                ("full", True, "full"),
                                ("dots", True, "dots")):
        c = dc.replace(cfg, train=dc.replace(cfg.train, remat=remat,
                                             remat_policy=policy))
        seen, undo = _bn_census()
        try:
            kern = _bn_steps(c, sd0, batch, 3)
        finally:
            undo()
        with _bn_plain_forced():
            plain = _bn_steps(c, sd0, batch, 3)
        gaps = _bn_gaps(kern, plain)
        want = dict(per_fwd)
        if remat:
            for name in ("bn_stats", "bn_apply", "bn_finish"):
                want[name] += n_bn
        if kern[3] != want or any(v > TRAIN_LIMITS[g] for g, v in
                                  gaps.items()):
            raise AssertionError(
                f"bn step remat={mode}: launches {kern[3]} (expected "
                f"{want}), gaps {gaps} (limits {TRAIN_LIMITS})")
        steps[mode] = {"gaps": gaps, "losses": kern[0],
                       "plain_losses": plain[0], "launches": kern[3],
                       "step_ms": kern[4], "plain_step_ms": plain[4],
                       "peak_gib": kern[5], "plain_peak_gib": plain[5],
                       "layouts": sorted(f"{k[0]}:{k[1]}:{list(k[2])}x{v}"
                                         for k, v in seen.items())}
        log("bn", f"batch 24, remat {mode}: " + json.dumps(steps[mode])
            + f" [{smi}]")
        del kern, plain
        gc.collect()
        torch.cuda.empty_cache()
    return {"cases": cases, "steps": steps, "n_bn": n_bn}


def main() -> int:
    smi = phase_device()
    phase_build()
    rng = np.random.RandomState(0)
    rec = phase_kernels(rng)
    phase_edge_cases(rng)
    launches, slice_lat = phase_slice()
    k3_eval, eval_launches = phase_eval_graph(smi, rng)
    raw_launches = phase_raw(smi)
    icp_launches, k4_icp = phase_icp(smi)
    phase_reference()
    train_launches = phase_train(smi)
    modes_rec, modes_launches = phase_modes(smi)
    rec.update({k: v for k, v in modes_rec.items() if k != "query"})
    disk_launches = phase_disk(smi)
    phase_native(smi, os.path.join(DISK_DIR, "ycb"))
    apps_launches = phase_apps(smi, slice_lat)
    parallel_launches = phase_parallel(smi)
    _add_counts(parallel_launches, phase_remat(smi))
    bn = phase_bn(smi)
    from pvn3d_tpu_torch.ops.kernels import KERNELS
    line = []
    for k in KERNELS:
        r = rec[k.name]
        bound, by = r["bound"]
        # Launches: over the serving slice's three requests, [eval_graph]'s
        # two (the default graph's and the literal one's), the raw
        # path's three requests, one raw request with ICP in both modes,
        # the training path's three steps, three requests in each of
        # the [modes] phase's deployment modes, the [disk] phase's app
        # runs and the [apps] phase's, and the [parallel] and [remat]
        # phases' steps and requests, each counted from 0.
        total = (launches[k.name] + eval_launches[k.name]
                 + raw_launches[k.name]
                 + icp_launches[k.name] + train_launches[k.name]
                 + modes_launches[k.name] + disk_launches[k.name]
                 + apps_launches[k.name]
                 + parallel_launches.get(k.name, 0))
        if total < 1:
            raise AssertionError(f"{k.name}: launched on no main path")
        line.append({
            "name": k.name, "route": "cuda",
            "source": os.path.relpath(k.source, ROOT),
            "replaces": r["replaces"],
            "launches": total,
            "launches_serving": launches[k.name],
            "launches_eval_graph": eval_launches[k.name],
            "launches_raw": raw_launches[k.name],
            "launches_icp": icp_launches[k.name],
            "launches_training": train_launches[k.name],
            "launches_modes": modes_launches[k.name],
            "launches_disk": disk_launches[k.name],
            "launches_apps": apps_launches[k.name],
            "launches_parallel": parallel_launches.get(k.name, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound, "bound_by": by,
            "library_ms": r["library_ms"]})
        if "levels" in r:
            # K2's mode instances and K3: the sums' parts, one record per
            # level (L0 .. L3, fp3 .. fp0).
            line[-1]["device_ms"] = r["device_ms"]
            line[-1]["levels"] = r["levels"]
        if k.name == "winner":
            # K4 also at the ICP prefilter's shape (H = 21, K = 2000).
            line[-1].update(device_ms=r["device_ms"], passes=r["passes"],
                            icp=k4_icp, max_abs_err=max(
                                r["max_abs_err"], k4_icp["max_abs_err"]))
        if k.name == "interp":
            # K3 at the eval graph's widths (fp3 .. fp0 blend W0 channels),
            # the serving path's shapes since the FP restructure.
            eb, eby = k3_eval["bound"]
            line[-1]["eval_graph"] = {
                "ms": k3_eval["ms"], "device_ms": k3_eval["device_ms"],
                "plain_ms": k3_eval["plain_ms"],
                "library_ms": k3_eval["library_ms"], "bound_ms": eb,
                "bound_by": eby, "max_abs_err": k3_eval["max_abs_err"],
                "levels": k3_eval["levels"]}
        if k.name == "interp_bwd":
            t = rec["interp_bwd_train"]
            line[-1].update(index_add_ms=r["index_add_ms"],
                            device_ms_train=t["device_ms"], ms_train=t["ms"],
                            levels_train=t["levels"])
    print(json.dumps({"kernels": line, "bn": bn}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(*map(int, sys.argv[2:5])))
    sys.exit(main())
