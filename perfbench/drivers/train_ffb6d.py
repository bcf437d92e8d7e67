"""FFB6D training steps back to back: ``train/step.py::make_train_step``
on a ``TrainState`` holding the port's ``FFB6D`` at the mix's global
batch, from a pool of batches already on the card, with no host read
between steps.  ``drivers/train.py``'s loop, for one card: set-up builds
the state, runs the first batch once with every BN frozen for the check
(which builds the kernels), drives the state through three steps on the
pool's first three batches and times the last two to fix the window's
step count; the rate is the frames of all the window's steps over the
window, which ends with a synchronise after the last.  A traced run
first times as many untraced steps back to back as it traces: its idle
share and MFU divide by their mean, as serving's divide by the untraced
latency, since the profiler's cost on the host, which launches a step in
about the time the card runs it, would otherwise read as idle card.

Every step builds FFB6D's neighbour index on the card from its batch's
points and ``cloud_map`` (the model's ``frame_inputs``, the 22 k-NN
searches of each frame), runs the train-mode forward (the dense image
tail, train-mode BN, the dropouts), the backward through the gathers of
RandLA-Net and the seven fusion stages, and fused Adam.

The batches are seeded table scenes made on the card (``scenes``, below:
``perfbench/scenes.py::raw_frames``'s plane with boxes and domes, each
object labelled and given keypoints): the cloud map of the depth, holes
at the origin, and the frame's valid pixels sampled in a random order,
with their colours, normals and offset targets, as the loader's device
prefetch leaves a batch.

``correct``, after the window with the program's state freed, against
the float32 reference of ``perfbench/reference/ffb6d_train.py`` on its
own brute-force index of each batch, with the program's dropout masks:

* ``drivers/train.py``'s numbers over the first three steps by plain
  Adam (``loss_gap``, ``grad_gap``, ``update_gap``).  Train-mode BN
  amplifies any rounding at random weights, so these read the same for
  the bf16 program and the float8 control: they catch a step that
  drops frames or leaves the state as it was, not a loss of precision;
* the first batch once more, before any step, with every BN on its
  running statistics (the rest as the step runs it: the dense tail, the
  dropouts, the gathers' backward) and gradients by autograd:
  ``frozen_bn_out_rel``, the worst of the three heads' L2 gaps, each over
  the scale its last layer's output has without cancellation,
  |W| |h| / sqrt(fan-in) on the reference's hidden layer (a draw of
  weights can leave a head's few outputs, the centre's three, small
  beside the terms they sum), and ``frozen_bn_grad_rel``, the median
  leaf's gap of gradients (leaves as ``grad_gap`` counts them, each
  against its own or the median leaf's norm).  Nothing there amplifies
  rounding, so these move with precision;
* ``index_diff``: the share of the 22 searches' rows, over the three
  checked batches, whose neighbour set differs from the reference's.

The limits file names the numbers compared; the others are printed on
standard error beside them and decide nothing.  MFU divides FFB6D's
literal-graph FLOPs a frame, the dense image tail at every pixel
(``perfbench/work_ffb6d.py::forward_flops``).
"""
from __future__ import annotations

import sys
import time
import statistics
from typing import Dict, List

import torch

from perfbench import scenes as pscenes
from perfbench import spec, stats, tracing, work_ffb6d
from perfbench.drivers import common, serve_raw_ffb6d, train
from perfbench.reference import ffb6d as rffb6d
from perfbench.reference import frame as rframe
from perfbench.reference.ffb6d_train import FFB6DTrainReference, loss

# The outputs the frozen-BN check compares, each with its head and the
# head's list of hidden widths in the model's configuration.
OUTPUTS = ("seg_logits", "kp_offsets", "ctr_offsets")
HEADS = {"seg_logits": ("seg", "rgbd_seg_layer", "seg_head"),
         "kp_offsets": ("kp", "kp_ofst_layer", "kp_head"),
         "ctr_offsets": ("ctr", "ctr_ofst_layer", "ctr_head")}


def _camera(config: Dict, h: int, w: int, device) -> torch.Tensor:
    """The configuration's camera scaled to an (h, w) image."""
    k = torch.tensor(config["camera_k"], dtype=torch.float32, device=device)
    sx, sy = w / 640.0, h / 480.0
    return k * torch.tensor([[sx, 1.0, sx], [1.0, sy, sy], [1.0, 1.0, 1.0]],
                            device=device)


def scenes(seed: int, mix: Dict, config: Dict, device) -> List[Dict]:
    """The mix's pool of global batches on ``device``, each frame a table
    plane with ``objects`` boxes or domes of random classes: pointcloud
    (B, N, 9) [xyz | rgb 0-255 | normal] of N valid pixels in a random
    order, rgb (B, H, W, 3) 0-255, choose (B, N), cloud_map (B, H, W, 3),
    labels (B, N), kp_targ_ofst (B, N, n_kps, 3) and ctr_targ_ofst
    (B, N, 1, 3), each point minus its object's keypoints and centre."""
    model = config["program"]["model"]
    b, n = mix["batch"], model["n_sample_points"]
    h, w = model["image_height"], model["image_width"]
    n_kps, n_cls, n_obj = model["n_keypoints"], model["n_classes"], \
        mix["objects"]
    g = pscenes._generator(seed, 6, device)
    cam = _camera(config, h, w, device)[None].expand(b, 3, 3)

    def uni(shape, lo, hi):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo
    cols = torch.arange(w, device=device, dtype=torch.float32)[None, None]
    rows = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    scale = w / 640.0
    pool = []
    for _ in range(mix["pool"]):
        tilt = uni((b, 2, 1, 1), -mix["tilt_m"], mix["tilt_m"])
        d = (uni((b, 1, 1), *mix["plane_m"]) + tilt[:, 0] * (cols / w - 0.5)
             + tilt[:, 1] * (rows / h - 0.5))
        rgb = torch.randint(60, 200, (b, h, w, 3), generator=g,
                            device=device).float()
        label = torch.zeros((b, h, w), dtype=torch.int64, device=device)
        cls = torch.randint(1, n_cls, (b, n_obj), generator=g, device=device)
        for o in range(n_obj):
            cu = uni((b, 1, 1), 0.15, 0.85) * w
            cv = uni((b, 1, 1), 0.15, 0.85) * h
            hu = uni((b, 1, 1), *mix["half_size_px"]) * scale
            hv = uni((b, 1, 1), *mix["half_size_px"]) * scale
            height = uni((b, 1, 1), *mix["height_m"])
            colour = torch.randint(0, 256, (b, 1, 1, 3), generator=g,
                                   device=device).float()
            box = uni((b, 1, 1), 0.0, 1.0) < 0.5          # else a dome
            r2 = ((cols - cu) / hu) ** 2 + ((rows - cv) / hv) ** 2
            in_box = ((cols - cu).abs() < hu) & ((rows - cv).abs() < hv)
            top = d - height * torch.where(
                box, 1.0, torch.sqrt(torch.clamp(1.0 - r2, min=0.0)))
            front = torch.where(box, in_box, r2 < 1.0) & (top < d)
            d = torch.where(front, top, d)
            label = torch.where(front, cls[:, o, None, None], label)
            rgb = torch.where(front[..., None], colour, rgb)
        d = d + mix["noise_m"] * torch.randn((b, h, w), generator=g,
                                             device=device)
        d = torch.where(uni((b, h, w), 0.0, 1.0) < mix["dropout"], 0.0, d)
        rgb = torch.clamp(rgb + 8.0 * torch.randn(rgb.shape, generator=g,
                                                  device=device), 0, 255)
        cloud_map, valid = rframe.depth_to_cloud_map(d, cam)
        cloud_map = torch.where(valid[..., None], cloud_map, 0.0)
        nrm = rframe.normals_from_depth_map(d, cam)
        score = torch.where(valid.reshape(b, -1),
                            uni((b, h * w), 1e-4, 1.0), -1.0)
        choose = torch.topk(score, n, dim=1).indices          # random order

        def at(m):
            return torch.gather(m.reshape(b, h * w, -1), 1, choose[..., None]
                                .expand(-1, -1, m.shape[-1]))
        xyz = at(cloud_map)
        labels = at(label[..., None])[..., 0]
        ctr_t = torch.zeros((b, n, 1, 3), device=device)
        kp_t = torch.zeros((b, n, n_kps, 3), device=device)
        for o in range(n_obj):
            mine = (labels == cls[:, o, None])[..., None]
            count = mine.sum(1).clamp(min=1)
            centre = (xyz * mine).sum(1) / count                 # (B, 3)
            kps = centre[:, None] + uni((b, n_kps, 3), -0.05, 0.05)
            ctr_t = torch.where(mine[..., None], (xyz - centre[:, None])
                                [:, :, None], ctr_t)
            kp_t = torch.where(mine[..., None],
                               xyz[:, :, None] - kps[:, None], kp_t)
        pool.append({
            "pointcloud": torch.cat([xyz, at(rgb), at(nrm)], -1),
            "rgb": rgb, "choose": choose.to(torch.int32),
            "cloud_map": cloud_map, "labels": labels.to(torch.int32),
            "kp_targ_ofst": kp_t, "ctr_targ_ofst": ctr_t})
    return pool


class Trainer(train.Trainer):
    """``drivers/train.py``'s trainer with the port's FFB6D, its spans and
    the scene pool."""

    def __init__(self, cell: Dict, args, device):
        from pvn3d_tpu_torch.train.state import TrainState, make_optimizer
        from pvn3d_tpu_torch.train.step import make_train_step
        self.cell, self.args, self.device, self.mesh = cell, args, device, None
        self.config = cell["config"]
        self.mix = cell["traffic"]
        if self.mix["world"] != 1:
            raise SystemExit("train_ffb6d runs on one card (world 1)")
        cfg = serve_raw_ffb6d.program_config(self.config)
        model, self.sd = serve_raw_ffb6d.port_model(cfg, args.seed, device)
        self.cfg = cfg
        self.names = [k for k, _ in model.named_parameters()]
        self.state = TrainState(0, model.train(), make_optimizer(cfg, model))
        self.world = 1
        self.pool = scenes(args.seed, self.mix, self.config, device)
        self.local = self.pool
        self.spans = tracing.Spans()
        self.step_fn = make_train_step(cfg, device)

    def trace_spans(self):
        self.spans.module(self.state.model, "", "forward")
        self.spans.function(
            "pvn3d_tpu_torch.ops.kernels.knn", "knn", "k.knn",
            work=lambda a, kw, out: (
                lambda q=tuple(a[0].shape), c=tuple(a[1].shape), k=a[2]:
                work_ffb6d.knn_work(q, c, k)))

    def frozen_bn(self, batch: Dict):
        """``batch`` through the program's model, before any step, with
        every BN on its running statistics and the rest as the step runs
        it: the outputs, each leaf's gradient of the step's loss, and the
        dropout draws."""
        from pvn3d_tpu_torch.models.layers import BatchNorm
        from pvn3d_tpu_torch.train.step import compute_losses, model_inputs
        model = self.state.model
        bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
        params = dict(model.named_parameters())
        rec = train.DropoutRecord()
        rec.install()
        for m in bns:
            m.eval()
        try:
            gen = torch.Generator(device=self.device).manual_seed(
                self.args.seed)
            out = model(batch["pointcloud"], batch["rgb"], batch["choose"],
                        generator=gen, **model_inputs(model, batch))
            total = compute_losses(self.cfg, out, batch)["loss"]
            grads = torch.autograd.grad(total, list(params.values()),
                                        allow_unused=True)
        finally:
            for m in bns:
                m.train()
            rec.remove()
        return ({k: out[k].detach() for k in OUTPUTS},
                {k: torch.zeros_like(p) if g is None else g.float()
                 for (k, p), g in zip(params.items(), grads)}), rec.draws

    def indices(self) -> List[Dict]:
        """The neighbour index the step builds of each checked batch."""
        from pvn3d_tpu_torch.train.step import model_inputs
        with torch.no_grad():
            return [model_inputs(self.state.model, b)["index"]
                    for b in self.pool[:3]]


def reference_index(batch: Dict, model: Dict) -> Dict:
    """The reference's brute-force index of a batch's points and cloud
    map."""
    strides = sorted(set(model["ds_strides"]) | set(model["up_strides"]))
    with torch.no_grad():
        return rffb6d.index(batch["pointcloud"][..., :3],
                            rffb6d.strided_maps(batch["cloud_map"].float(),
                                                strides), model)


def draw_masks(draws, device) -> List[torch.Tensor]:
    """The masks of one forward's dropout draws, drawn again from each
    draw's generator state."""
    masks = []
    for state, shape, rate in draws:
        g = torch.Generator(device=device)
        g.set_state(state)
        masks.append((torch.rand(shape, device=device, generator=g)
                      < 1.0 - rate).float())
    return masks


def _params(sd, names: List[str]) -> Dict[str, torch.Tensor]:
    return {k: sd[k].detach().clone().float().requires_grad_(True)
            for k in names}


def reference_steps(config: Dict, sd, names: List[str], batches, indices,
                    masks, low_precision: bool = False):
    """``drivers/train.py::reference_steps`` with FFB6D's float32
    reference on each batch's ``indices``: three steps of plain Adam from
    ``sd``; losses, the first gradient's leaf norms, the three steps'
    change's leaf norms."""
    t = config["program"]["train"]
    model = config["program"]["model"]
    params = _params(sd, names)
    state = dict(sd)
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, g1 = [], None
    for step in range(3):
        state.update(params)
        b = batches[step]
        ref = FFB6DTrainReference(model, state, low_precision=low_precision)
        out = ref.forward(b["pointcloud"], b["rgb"], b["choose"],
                          indices[step], masks[step])
        total = loss(out, b, t)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params.values(), torch.autograd.grad(
                     total, list(params.values()), allow_unused=True))]
        losses.append(float(total.detach()))
        lr = train._cyclic_lr(step, t)
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                g = g + t["weight_decay"] * p
                m[k].mul_(train.BETA1).add_(g, alpha=1 - train.BETA1)
                v[k].mul_(train.BETA2).addcmul_(g, g, value=1 - train.BETA2)
                mh = m[k] / (1 - train.BETA1 ** (step + 1))
                vh = v[k] / (1 - train.BETA2 ** (step + 1))
                p.sub_(lr * mh / (vh.sqrt() + train.EPS))
            if step == 0:
                g1 = {k: float(g.norm()) for k, g in zip(params, grads)}
        del out, total, grads
    change = {k: float((params[k].detach() - sd[k]).norm()) for k in names}
    return losses, g1, change


def head_scales(model: Dict, sd, out: Dict) -> Dict[str, float]:
    """Each output's scale without cancellation, |W| |h| / sqrt(fan-in),
    of its head's last layer ``W`` on the reference's last hidden layer
    ``h`` (the serving cells' scale of ``seg_rel``)."""
    scales = {}
    for k, (short, layer, widths) in HEADS.items():
        w = sd[f"{layer}.{len(model[widths])}.conv.weight"].float()
        h = out[f"{short}_hidden"].detach().float()
        scales[k] = (float((w ** 2).sum()) * float((h ** 2).sum())
                     / w[0].numel()) ** 0.5
    return scales


def reference_frozen(config: Dict, sd, names: List[str], batch: Dict, idx,
                     masks, low_precision: bool = False):
    """The reference's twin of ``Trainer.frozen_bn`` from ``sd``: the
    outputs and each leaf's gradient of the loss, every BN on its running
    statistics, and each output's scale (``head_scales``)."""
    model = config["program"]["model"]
    params = _params(sd, names)
    ref = FFB6DTrainReference(model, dict(sd, **params),
                              low_precision=low_precision, batch_stats=False)
    out = ref.forward(batch["pointcloud"], batch["rgb"], batch["choose"],
                      idx, masks)
    grads = torch.autograd.grad(loss(out, batch, config["program"]["train"]),
                                list(params.values()), allow_unused=True)
    return ({k: out[k].detach() for k in OUTPUTS},
            {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)},
            head_scales(model, sd, out))


def frozen_gaps(program, reference) -> Dict[str, float]:
    """``frozen_bn_out_rel``: the worst output's L2 gap over its scale
    (the reference's third item); ``frozen_bn_grad_rel``: the median
    counted leaf's L2 gap of gradients against its reference norm or the
    median leaf's, whichever is larger.  ``program`` is the outputs and
    gradients of ``Trainer.frozen_bn``, or a reference's in its place."""
    (po, pg), (ro, rg, scales) = program[:2], reference
    norms = {k: float(g.norm()) for k, g in rg.items()}
    counted = train.counted_leaves(norms)
    med = statistics.median(norms[k] for k in counted)
    return {"frozen_bn_out_rel": max(
                float((po[k].float() - ro[k]).norm()) / scales[k]
                for k in OUTPUTS),
            "frozen_bn_grad_rel": statistics.median(
                float((pg[k].float() - rg[k]).norm()) / max(norms[k], med)
                for k in counted)}


def index_diff(got: List[Dict], want: List[Dict]) -> float:
    """The share of rows, over the batches' 22 searches, whose neighbour
    set differs."""
    bad = rows = 0.0
    for g, w in zip(got, want):
        for name in serve_raw_ffb6d.INDEX_SETS:
            for a, b in zip(g[name], w[name]):
                d, n = serve_raw_ffb6d._index_rows(a, b)
                bad, rows = bad + d, rows + n
    return bad / rows


def compare(program: Dict, reference: Dict) -> Dict[str, float]:
    """Every number of the check from each side's ``steps`` (losses,
    first-gradient and change leaf norms), ``frozen`` (outputs and
    gradients with BN frozen) and ``index`` (the checked batches')."""
    out = train.compare(program["steps"], reference["steps"])
    out.update(frozen_gaps(program["frozen"], reference["frozen"]))
    out["index_diff"] = index_diff(program["index"], reference["index"])
    return out


def check(program: Dict, reference: Dict, limits: Dict):
    """``compare``'s numbers: those ``limits`` holds beside their limits
    and whether all hold, as ``common.checks``; the others are printed on
    standard error."""
    numbers = compare(program, reference)
    for k in sorted(set(numbers) - set(limits)):
        print(f"perfbench: {k} {numbers[k]!r} (read, not compared)",
              file=sys.stderr)
    return common.checks({k: v for k, v in numbers.items() if k in limits},
                         limits)


def reference_side(config: Dict, sd, names: List[str], pool: List[Dict],
                   step_draws, frozen_draws, device,
                   low_precision: bool = False) -> Dict:
    """The reference's ``steps``, ``frozen`` and ``index`` on the pool's
    first three batches, with the program's dropout masks (``step_draws``
    of its three steps, ``frozen_draws`` of its frozen-BN pass)."""
    model = config["program"]["model"]
    idx = [reference_index(b, model) for b in pool[:3]]
    masks = train.reference_masks([step_draws], device, len(
        pool[0]["pointcloud"]))
    return {"steps": reference_steps(config, sd, names, pool, idx, masks,
                                     low_precision),
            "frozen": reference_frozen(config, sd, names, pool[0], idx[0],
                                       draw_masks(frozen_draws, device),
                                       low_precision),
            "index": idx}


def traced_result(out: Dict, cell: Dict, prof, spans: tracing.Spans,
                  unit_s: float) -> None:
    """``common.traced_result`` with FFB6D's literal-graph FLOPs, the mix's
    frames a step, and ``unit_s``, the seconds a step takes untraced, as
    the denominator of the idle share and the MFU."""
    reading = common.Reading(
        tracing.Trace(prof, spans), cell["traffic"]["batch"],
        work_ffb6d.forward_flops(cell["config"]["program"]["model"]), spans,
        unit_s=unit_s)
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
    tr = Trainer(cell, args, device)
    common.setup_log(t_start, "weights, batches and state")
    frozen, frozen_draws = tr.frozen_bn(tr.pool[0])
    common.setup_log(t_start, "the first batch with BN frozen")
    rec = train.DropoutRecord()
    rec.install()
    steps, secs = tr.first_steps()
    rec.on = False
    rec.remove()
    traced = bool(args.trace)
    n_steps = (cell["traffic"]["traced"] if traced
               else max(1, round(args.seconds / max(secs))))
    if traced:
        common.sync(device)
        t0 = time.perf_counter()
        for i in range(n_steps):
            tr.step(3 + i)
        common.sync(device)
        unit_s = (time.perf_counter() - t0) / n_steps
        tr.trace_spans()
    common.sync(device)
    setup_s = time.perf_counter() - t_start
    common.setup_log(t_start, "three steps")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    if traced:
        def units(span):
            for i in range(n_steps):
                with span():
                    tr.step(3 + i)
        prof = common.profile(units, device)
    else:
        for i in range(n_steps):
            tr.step(3 + i)
        common.sync(device)
    window = time.perf_counter() - t0
    frames = n_steps * cell["traffic"]["batch"]
    out = {"attempted": n_steps, "failed": 0,
           "device": common.device_record(device, 1,
                                          common.peak_bytes(device))}
    if traced:
        traced_result(out, cell, prof, tr.spans, unit_s)
        del prof
    else:
        out["metrics"] = {"train_frames_per_s": stats.rate(frames, window),
                          "setup_s": setup_s}
    program = {"steps": steps, "frozen": frozen, "index": tr.indices()}
    tr.free_program()
    ref = reference_side(tr.config, tr.sd, tr.names, tr.pool, rec.draws,
                         frozen_draws, device)
    out["checks"], out["correct"] = check(program, ref, cell["limits"])
    return out
