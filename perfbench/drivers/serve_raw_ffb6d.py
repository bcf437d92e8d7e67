"""FFB6D serving raw RGB-D frames in ``serve_raw``'s closed loop: one
client at batch 1, each request one frame's host numpy arrays through
``inference.pipeline.make_raw_inference_step`` with the port's ``FFB6D``,
ending when the poses are on the host.

``correct``: once the window has closed, the pool frame of the longest
request and others drawn from the seed, each with what its last request
produced, against ``perfbench/reference/ffb6d.py``: the frame build from
the raw frame (the sampled points' channels and the index's strided
cloud maps, ``build_err``; the chosen pixels in their random order,
``choose_diff``), the neighbour index (``index_diff``: the share of rows
over the 22 searches whose neighbour set differs from the exact search on
the request's own points and maps), the forward on the request's build
with the reference's index (``seg_rel``, ``vote_rel`` as ``serve_raw``),
and the pose stage on that request's labels and votes (``pose_err``,
``present_diff``).

The spans: ``pb.image_branch``, ``pb.point_branch`` and ``pb.heads``
around the model's image stages, point stages and heads,
``pb.frame_build`` and ``pb.pose_stage`` as ``serve_raw`` opens them, and
the kernel wrappers, the k-NN search's (``k.knn``) among them.  MFU
divides FFB6D's own literal-graph FLOPs (``perfbench/work_ffb6d.py``).
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from perfbench import scenes, spec, stats, tracing, work_ffb6d
from perfbench.drivers import common, serve_raw
from pvn3d_tpu_torch.config import (ClusterConfig, Config, DatasetConfig,
                                    FFB6DConfig, ICPConfig, TrainConfig)
from pvn3d_tpu_torch.models.ffb6d import FFB6D

_METHODS = (("image_stage", "image_branch"), ("image_last", "image_branch"),
            ("point_input", "point_branch"), ("point_encode", "point_branch"),
            ("point_decode", "point_branch"), ("heads", "heads"))
INDEX_SETS = ("nei", "interp", "r2p_ds", "p2r_ds", "r2p_up", "p2r_up")


def program_config(config: Dict) -> Config:
    """The port's ``Config`` with an ``FFB6DConfig`` model, holding every
    number of the configuration file's ``program`` tree."""
    p = config["program"]
    cfg = Config(**{name: spec._build(tp, p[name]) for name, tp in (
        ("dataset", DatasetConfig), ("model", FFB6DConfig),
        ("train", TrainConfig), ("cluster", ClusterConfig),
        ("icp", ICPConfig))})
    if json.loads(json.dumps(dataclasses.asdict(cfg))) != p:
        raise SystemExit(f"configuration {config['name']}: the port's "
                         f"Config does not hold the file's numbers")
    return cfg


def port_model(cfg, seed: int, device):
    """The port's ``FFB6D`` holding the seed's weights (made on
    ``device``), and those weights."""
    with torch.device("meta"):
        model = FFB6D(cfg.model)
    sd = scenes.state_dict(model, seed, device)
    model = model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return model, sd


def _wrap_method(spans: tracing.Spans, obj, attr: str, layer: str) -> None:
    """A span around each call of ``obj.attr`` (an instance attribute
    that shadows the method until ``spans.remove()``)."""
    orig = getattr(obj, attr)

    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(spans._name(layer)):
            return orig(*args, **kwargs)
    object.__setattr__(obj, attr, wrapper)
    spans._undo.append(lambda: object.__delattr__(obj, attr))


def _index_rows(got, want):
    """(rows whose neighbour set differs, rows) of one search."""
    got = got.long().reshape(got.shape[0], got.shape[1], -1)
    want = want.long().reshape(got.shape)
    diff = (got.sort(-1).values != want.sort(-1).values).any(-1)
    return float(diff.sum()), float(diff.numel())


def _build(config: Dict, frame: Dict, prio, device, low_precision=False):
    from perfbench.reference import ffb6d as rffb6d
    rgb = torch.as_tensor(frame["rgb"], device=device).float()
    cloud, choose, cloud_map = rffb6d.build(
        rgb, torch.as_tensor(frame["depth"].astype(np.int32), device=device),
        torch.as_tensor(frame["cam_k"], device=device), prio,
        config["program"]["model"]["n_sample_points"], config["cam_scale"],
        config["fill_depth"], low_precision)
    model = config["program"]["model"]
    maps = rffb6d.strided_maps(cloud_map, sorted(
        set(model["ds_strides"]) | set(model["up_strides"])))
    return rgb, cloud, choose, maps


@torch.no_grad()
def control(config: Dict, sd, frame: Dict, prio, device) -> Dict:
    """The control's request: the reference in the program's place, one
    precision below the configuration's (the network's operands in float8,
    the build's depth map and the pose stage's inputs in bfloat16), its
    index by the reference's search on its own build."""
    from perfbench.reference import ffb6d as rffb6d
    model = config["program"]["model"]
    rgb, cloud, choose, maps = _build(config, frame, prio, device, True)
    idx = rffb6d.index(cloud[..., :3], maps, model)
    idx["maps"] = maps
    fwd = rffb6d.FFB6DReference(model, sd, low_precision=True).forward(
        cloud, rgb, choose, idx)
    seg = fwd["seg_logits"].argmax(-1)
    lowp = [t.to(torch.bfloat16).float() for t in
            (cloud[0, :, :3], fwd["ctr_offsets"][0], fwd["kp_offsets"][0])]
    poses, present = serve_raw._reference_poses(config, lowp[0], seg[0],
                                                *lowp[1:], device)
    return {"pointcloud": cloud, "choose": choose, "seg": seg,
            "poses": poses[None].cpu(), "present": present[None].cpu(),
            "fwd": fwd, "index": idx}


@torch.no_grad()
def compare(config: Dict, sd, frame: Dict, prio: torch.Tensor, served: Dict,
            device) -> Dict[str, float]:
    """One served request against the reference: the numbers the check
    compares.  ``served`` holds the step's result (its ``index`` among
    it) and the forward's outputs (``fwd``)."""
    from perfbench.reference import ffb6d as rffb6d
    model = config["program"]["model"]
    rgb, cloud, choose, maps = _build(config, frame, prio, device)
    got = served["index"]
    build_err = (served["pointcloud"].float() - cloud).abs().max()
    for s, m in maps.items():
        build_err = torch.maximum(build_err, (got["maps"][s] - m).abs().max())
    out = {"build_err": float(build_err),
           "choose_diff": float((served["choose"].long() != choose).sum())}
    ref_idx = rffb6d.index(got["xyz"][0], got["maps"], model)
    bad = rows = 0.0
    for name in INDEX_SETS:
        for a, b in zip(got[name], ref_idx[name]):
            d, n = _index_rows(a, b)
            bad, rows = bad + d, rows + n
    out["index_diff"] = bad / rows
    ref = rffb6d.FFB6DReference(model, sd).forward(
        served["pointcloud"], rgb, served["choose"], ref_idx)
    fwd = served["fwd"]
    # The seg logits' gap over the scale the last layer's output has
    # without cancellation, |W| |h| / sqrt(fan-in), as serve_raw.
    w = sd[f"rgbd_seg_layer.{len(model['seg_head'])}.conv.weight"]
    scale2 = (float((w.float() ** 2).sum())
              * float((ref["seg_hidden"] ** 2).sum()) / w[0].numel())
    out["seg_rel"] = (float(((fwd["seg_logits"].float()
                              - ref["seg_logits"]) ** 2).sum()), scale2)
    out["vote_rel"] = serve_raw._sq(
        torch.cat([fwd["kp_offsets"], fwd["ctr_offsets"]], 1),
        torch.cat([ref["kp_offsets"], ref["ctr_offsets"]], 1))
    poses, present = serve_raw._reference_poses(
        config, served["pointcloud"][0, :, :3].float(), served["seg"][0],
        fwd["ctr_offsets"][0], fwd["kp_offsets"][0], device)
    served_present = served["present"][0].to(device)
    both = present & served_present
    gap = (served["poses"][0].to(device) - poses).abs().amax(dim=(1, 2))
    out["pose_err"] = float(torch.where(both, gap, 0.0).max())
    out["present_diff"] = float((present != served_present).sum())
    return out


class Server(serve_raw.Server):
    """``serve_raw.Server`` with the port's FFB6D, its spans, the index
    kept with each pool frame's last result, and FFB6D's check."""

    def __init__(self, cell: Dict, seed: int, device):
        from pvn3d_tpu_torch.inference import pipeline
        config = cell["config"]
        self.config = config
        self.mix = cell["traffic"]
        self.device = device
        cfg = program_config(config)
        work = self.mix.get("work_seed", seed)
        self.model, self.sd = port_model(cfg, work, device)
        self.spans = tracing.Spans()
        self.step = None
        self._cfg = cfg
        self._pipeline = pipeline
        self.frames = scenes.raw_frames(work, self.mix, config, device)
        m = config["program"]["model"]
        self.prio = scenes.priorities(work, len(self.frames),
                                      m["image_height"] * m["image_width"],
                                      device)
        self.order = np.random.default_rng([seed, 4])
        self.served: Dict[int, Dict] = {}
        self.longest = (0.0, None)
        self._fwd = None
        self.model.register_forward_hook(
            lambda _m, _a, o: setattr(self, "_fwd", o))

    def make_step(self, traced: bool) -> None:
        config = self.config
        if traced:
            for attr, layer in _METHODS:
                _wrap_method(self.spans, self.model, attr, layer)
            self.spans.function("pvn3d_tpu_torch.inference.pipeline",
                                "build_inference_batch_device", "frame_build")
            self.spans.function("pvn3d_tpu_torch.inference.pipeline",
                                "make_pose_fn", "make_pose_fn",
                                wrap_result=self.spans.closure("pose_stage"))
            common.wrap_kernels(self.spans)
            self.spans.function(
                "pvn3d_tpu_torch.ops.kernels.knn", "knn", "k.knn",
                work=lambda a, kw, out: (
                    lambda q=tuple(a[0].shape), c=tuple(a[1].shape), k=a[2]:
                    work_ffb6d.knn_work(q, c, k)))
        self.step = self._pipeline.make_raw_inference_step(
            self._cfg, self.model, np.asarray(config["mesh_kps"], np.float32),
            np.asarray(config["radii"], np.float32),
            fill_depth=config["fill_depth"], cam_scale=config["cam_scale"],
            refine_mask=config["refine_mask"], device=self.device)

    def request(self, j: int) -> float:
        t0 = time.perf_counter()
        out = self.step(self.frames[j], priorities=self.prio[j:j + 1])
        poses = out["poses"].cpu()
        present = out["present"].cpu()
        t1 = time.perf_counter()
        self.served[j] = {"pointcloud": out["pointcloud"],
                          "choose": out["choose"], "seg": out["seg"],
                          "poses": poses, "present": present,
                          "fwd": self._fwd, "index": out["index"]}
        self.longest = max(self.longest, (t1 - t0, j))
        return t1 - t0

    def check(self, seed: int, limits: Dict, served=None):
        """``serve_raw.Server.check``'s sample and reductions with FFB6D's
        ``compare``: ``seg_rel`` and ``vote_rel`` over the whole sample,
        the others the worst frame's; ``served`` (frame index -> a served
        request) stands in for the program's last requests (the
        control's)."""
        served_by = served or (lambda j: self.served[j])
        rng = np.random.default_rng([seed, 5])
        longest = self.longest[1]
        rest = [j for j in sorted(self.served) if j != longest]
        pick = [longest] + list(rng.choice(
            rest, min(self.mix["check_frames"] - 1, len(rest)),
            replace=False))
        worst: Dict[str, float] = {}
        sums: Dict[str, list] = {}
        for j in pick:
            nums = compare(self.config, self.sd, self.frames[j],
                           self.prio[j:j + 1], served_by(j), self.device)
            for k, v in nums.items():
                if isinstance(v, tuple):
                    acc = sums.setdefault(k, [0.0, 0.0])
                    acc[0] += v[0]
                    acc[1] += v[1]
                else:
                    worst[k] = max(worst.get(k, 0.0), v)
        for k, (gap, ref) in sums.items():
            worst[k] = (gap / max(ref, 1e-30)) ** 0.5
        return common.checks(worst, limits)


def traced_result(out: Dict, cell: Dict, prof, spans: tracing.Spans,
                  unit_s: float) -> None:
    """``common.traced_result`` with FFB6D's literal-graph FLOPs."""
    reading = common.Reading(
        tracing.Trace(prof, spans), 1,
        work_ffb6d.forward_flops(cell["config"]["program"]["model"]), spans,
        1, unit_s)
    for name in spans.missing:
        print(f"perfbench: span target {name} not found; its metrics are "
              f"left out", flush=True)
    out["metrics"] = {}
    for m in cell["per_layer"]:
        v = spec.reader(m["name"])(reading)
        if v is None:
            print(f"perfbench: {m['name']}: nothing to read in this run",
                  flush=True)
        else:
            out["metrics"][m["name"]] = v
    out["device"].update(busy_s=reading.busy_s(),
                         window_s=reading.window_s())
    out["breakdown"] = reading.trace.breakdown()


def run(cell: Dict, args, t_start: float, device=None) -> Dict:
    device = device or torch.device("cuda")
    torch.manual_seed(args.seed)
    common.setup_log(t_start, "imports")
    srv = Server(cell, args.seed, device)
    common.setup_log(t_start, "weights and frames")
    srv.make_step(False)
    for _ in range(srv.mix["warmup"]):
        srv.request(srv.next_frame())
    common.sync(device)
    setup_s = time.perf_counter() - t_start
    common.setup_log(t_start, "warm-up")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    lat = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        lat.append(srv.request(srv.next_frame()))
    ms = [x * 1e3 for x in lat]
    tenth = len(ms) // 10
    print("perfbench: p50 ms by tenth of the window: " + " ".join(
        f"{stats.percentile(ms[i:i + tenth], 50):.2f}"
        for i in range(0, 10 * tenth, tenth or 1)), file=sys.stderr,
        flush=True)
    traced = bool(args.trace)
    if traced:
        srv.make_step(True)
        srv.request(srv.next_frame())

        def units(span):
            for _ in range(srv.mix["traced"]):
                with span():
                    srv.request(srv.next_frame())
        prof = common.profile(units, device)
    peak = common.peak_bytes(device)
    served = len(lat) + (srv.mix["traced"] + 1 if traced else 0)
    out = {"attempted": served, "failed": 0,
           "device": common.device_record(device, 1, peak)}
    if traced:
        traced_result(out, cell, prof, srv.spans, sum(lat) / len(lat))
        del prof
    else:
        out["metrics"] = {"serve_p50_ms": stats.percentile(ms, 50),
                          "serve_p95_ms": stats.percentile(ms, 95),
                          "setup_s": setup_s}
    srv.free_program()
    out["checks"], out["correct"] = srv.check(args.seed, cell["limits"])
    return out
