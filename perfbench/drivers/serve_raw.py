"""Serving raw RGB-D frames in a closed loop: one client at batch 1, each
request one frame's host numpy arrays (uint8 RGB, uint16 depth, the
camera K) through ``inference.pipeline.make_raw_inference_step``, ending
when the poses are on the host.  A request's latency runs from the call
to the poses on the host; the next request starts after it.

``correct``: once the window has closed, the pool frame of the longest
request and others drawn from the seed, each with what its last request
produced, against ``perfbench/reference``: the frame build from the raw
frame (points and normals, ``build_err``; the chosen pixels,
``choose_diff``), the forward on the build the request used
(``seg_rel``: the L2 gap of the seg logits against the float32
reference's, over the scale of the seg head's last layer; ``vote_rel``:
the relative L2 of the keypoint and centre offsets together; both over
the whole sample), and the pose
stage on that request's labels and votes (``pose_err``,
``present_diff``).
"""
from __future__ import annotations

import sys
import time
from typing import Dict

import numpy as np
import torch

from perfbench import scenes, spec, stats, tracing
from perfbench.drivers import common

_MODULES = (("cnn.model", "image_branch"), ("pointnet2", "point_branch"),
            ("rgbd_feat", "heads"), ("SEG_layer", "heads"),
            ("KpOF_layer", "heads"), ("CtrOf_layer", "heads"))


def _sq(got: torch.Tensor, want: torch.Tensor):
    """Squared L2 of the gap and of the reference: a relative L2 is taken
    over the whole sample."""
    return (float(((got.float() - want.float()) ** 2).sum()),
            float((want.float() ** 2).sum()))


def _reference_poses(config: Dict, pcld, seg, ctr_of, kp_of, device):
    from perfbench.reference import pose as rpose
    model = config["program"]["model"]
    cl = config["program"]["cluster"]
    return rpose.cal_frame_poses(
        pcld, seg, ctr_of, kp_of,
        torch.tensor(config["mesh_kps"], device=device),
        torch.tensor(config["radii"], device=device),
        n_cls=model["n_classes"], n_kps=model["n_keypoints"],
        k=cl["max_points_per_class"], bandwidth=cl["bandwidth"],
        max_iter=cl["max_iter"], use_ctr=cl["use_ctr"],
        use_ctr_clus_filter=cl["use_ctr_clus_filter"],
        refine_mask=config["refine_mask"])


def _build(config: Dict, frame: Dict, prio, device, low_precision=False):
    from perfbench.reference import frame as rframe
    rgb = torch.as_tensor(frame["rgb"], device=device).float()
    cloud, choose = rframe.build(
        rgb, torch.as_tensor(frame["depth"].astype(np.int32), device=device),
        torch.as_tensor(frame["cam_k"], device=device), prio,
        config["program"]["model"]["n_sample_points"], config["cam_scale"],
        config["fill_depth"], low_precision)
    return rgb, cloud, choose


@torch.no_grad()
def control(config: Dict, sd, frame: Dict, prio, device) -> Dict:
    """The control's request: the reference in the program's place, one
    precision below the configuration's (the network's operands in float8,
    the build's depth map and the pose stage's inputs in bfloat16), as
    ``Server.request`` keeps a served request."""
    from perfbench.reference.model import Reference
    rgb, cloud, choose = _build(config, frame, prio, device, True)
    fwd = Reference(config["program"]["model"], sd,
                    low_precision=True).forward(cloud, rgb, choose)
    seg = fwd["seg_logits"].argmax(-1)
    lowp = [t.to(torch.bfloat16).float() for t in
            (cloud[0, :, :3], fwd["ctr_offsets"][0], fwd["kp_offsets"][0])]
    poses, present = _reference_poses(config, lowp[0], seg[0], *lowp[1:],
                                      device)
    return {"pointcloud": cloud, "choose": choose, "seg": seg,
            "poses": poses[None].cpu(), "present": present[None].cpu(),
            "fwd": fwd}


@torch.no_grad()
def compare(config: Dict, sd, frame: Dict, prio: torch.Tensor, served: Dict,
            device) -> Dict[str, float]:
    """One served request against the reference: the numbers the check
    compares.  ``served`` holds the step's result and the forward's
    outputs (``fwd``)."""
    from perfbench.reference.model import Reference
    rgb, cloud, choose = _build(config, frame, prio, device)
    out = {"build_err": float((served["pointcloud"].float() - cloud)
                              .abs().max()),
           "choose_diff": float((served["choose"].long() != choose).sum())}
    ref = Reference(config["program"]["model"], sd).forward(
        served["pointcloud"], rgb, served["choose"])
    fwd = served["fwd"]
    # The seg logits' gap over the scale the last layer's output has
    # without cancellation, |W| |h| / sqrt(fan-in): with 2 classes a draw
    # of weights can leave the logits small beside the terms they sum.
    w = sd[f"SEG_layer.{len(config['program']['model']['seg_head'])}"
           ".conv.weight"]
    scale2 = (float((w.float() ** 2).sum())
              * float((ref["seg_hidden"] ** 2).sum()) / w[0].numel())
    out["seg_rel"] = (float(((fwd["seg_logits"].float()
                              - ref["seg_logits"]) ** 2).sum()), scale2)
    out["vote_rel"] = _sq(
        torch.cat([fwd["kp_offsets"], fwd["ctr_offsets"]], 1),
        torch.cat([ref["kp_offsets"], ref["ctr_offsets"]], 1))
    poses, present = _reference_poses(
        config, served["pointcloud"][0, :, :3].float(), served["seg"][0],
        fwd["ctr_offsets"][0], fwd["kp_offsets"][0], device)
    served_present = served["present"][0].to(device)
    both = present & served_present
    gap = (served["poses"][0].to(device) - poses).abs().amax(dim=(1, 2))
    out["pose_err"] = float(torch.where(both, gap, 0.0).max())
    out["present_diff"] = float((present != served_present).sum())
    return out


class Server:
    """The port's raw serving step on the seed's weights and frame pool,
    keeping each pool frame's last result for the check."""

    def __init__(self, cell: Dict, seed: int, device):
        from pvn3d_tpu_torch.inference import pipeline
        config = cell["config"]
        self.config = config
        self.mix = cell["traffic"]
        self.device = device
        cfg = spec.program_config(config)
        # What the requests are (weights, frames, sampling priorities):
        # drawn from the mix's ``work_seed`` where it names one, so that
        # every run serves the same work in its own seeded order; else from
        # the run's seed.  The order and the check's sample are the run's.
        work = self.mix.get("work_seed", seed)
        self.model, self.sd = common.port_model(cfg, work, device)
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
        self.longest = (0.0, None)      # (seconds, frame) of the window
        self._fwd = None
        self.model.register_forward_hook(
            lambda _m, _a, o: setattr(self, "_fwd", o))

    def make_step(self, traced: bool) -> None:
        """The serving step; with ``traced`` the spans are installed
        before it is made, so its pose closure is wrapped too."""
        config = self.config
        if traced:
            for path, layer in _MODULES:
                self.spans.module(self.model, path, layer)
            self.spans.function("pvn3d_tpu_torch.inference.pipeline",
                                "build_inference_batch_device", "frame_build")
            self.spans.function("pvn3d_tpu_torch.inference.pipeline",
                                "make_pose_fn", "make_pose_fn",
                                wrap_result=self.spans.closure("pose_stage"))
            common.wrap_kernels(self.spans)
        self.step = self._pipeline.make_raw_inference_step(
            self._cfg, self.model, np.asarray(config["mesh_kps"], np.float32),
            np.asarray(config["radii"], np.float32),
            fill_depth=config["fill_depth"], cam_scale=config["cam_scale"],
            refine_mask=config["refine_mask"], device=self.device)

    def next_frame(self) -> int:
        return int(self.order.integers(len(self.frames)))

    def request(self, j: int) -> float:
        t0 = time.perf_counter()
        out = self.step(self.frames[j], priorities=self.prio[j:j + 1])
        poses = out["poses"].cpu()
        present = out["present"].cpu()
        t1 = time.perf_counter()
        self.served[j] = {"pointcloud": out["pointcloud"],
                          "choose": out["choose"], "seg": out["seg"],
                          "poses": poses, "present": present,
                          "fwd": self._fwd}
        self.longest = max(self.longest, (t1 - t0, j))
        return t1 - t0

    def check(self, seed: int, limits: Dict, served=None):
        """The sample's numbers: ``seg_rel`` and ``vote_rel`` over the
        whole sample (the root of the summed numerators over the summed
        denominators), the others the worst frame's.  The sample is the
        frame of the longest request and others drawn from the seed;
        ``served`` (frame index -> a served request) stands in for the
        program's last requests (the control's)."""
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

    def free_program(self) -> None:
        """Drop the port's step and model (the check keeps the results)."""
        self.spans.remove()
        self.step = None
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


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
    # The median moves with the host's load within a run as between runs
    # (PERF.md section 2): logged by tenths of the window.
    tenth = len(ms) // 10
    print("perfbench: p50 ms by tenth of the window: " + " ".join(
        f"{stats.percentile(ms[i:i + tenth], 50):.2f}"
        for i in range(0, 10 * tenth, tenth or 1)), file=sys.stderr,
        flush=True)
    traced = bool(args.trace)
    if traced:
        # After the window, a step made with the spans installed; its first
        # request is not traced.
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
        common.traced_result(out, cell, prof, srv.spans, 1,
                             unit_s=sum(lat) / len(lat))
        del prof
    else:
        out["metrics"] = {"serve_p50_ms": stats.percentile(ms, 50),
                          "serve_p95_ms": stats.percentile(ms, 95),
                          "setup_s": setup_s}
    srv.free_program()
    out["checks"], out["correct"] = srv.check(args.seed, cell["limits"])
    return out
