"""FFB6D on the port's training path, held against the benchmark's plain
reference (``perfbench/reference/ffb6d_train.py``: the literal published
graph in train mode, float32, brute-force searches, autograd's
gradients) on seeded random weights, at a small size: a 64x80 frame and
1280 points at the published widths, float32, batch 2.

One ``make_train_step`` step against the reference (loss, every leaf's
gradient, Adam's update); ``gather_rows``' backward against autograd's of
plain indexing; the neighbour index of a batch against its frames'; the
dropout masks the benchmark records against those the step applied; the
serving path's gathers; the ranges a step opens; and ``apps/train.py
--model ffb6d`` on a fake YCB tree."""
import dataclasses
import json
import statistics
import types

import numpy as np
import pytest
import torch

from perfbench.drivers import train as ptrain
from perfbench.reference import ffb6d as rffb6d
from perfbench.reference.ffb6d_train import FFB6DTrainReference, loss
from pvn3d_tpu_torch.apps import train as train_app
from pvn3d_tpu_torch.config import (Config, DatasetConfig,
                                    small_ffb6d_config)
from pvn3d_tpu_torch.data.ffb6d_index import build_index
from pvn3d_tpu_torch.data.synthetic import (synth_sensor_frame,
                                            synthetic_batch)
from pvn3d_tpu_torch.inference.pipeline import make_raw_inference_step
from pvn3d_tpu_torch.models import ffb6d as ffb6d_module
from pvn3d_tpu_torch.models import layers
from pvn3d_tpu_torch.models import pvn3d as pvn3d_module
from pvn3d_tpu_torch.models import randla
from pvn3d_tpu_torch.models.layers import BatchNorm
from pvn3d_tpu_torch.tools.fake_data import make_fake_ycb
from pvn3d_tpu_torch.train import schedule
from pvn3d_tpu_torch.train.state import create_train_state
from pvn3d_tpu_torch.train.step import (compute_losses, make_train_step,
                                        model_inputs, to_device)
from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,
                                          stacked_mesh_kps)

torch.set_num_threads(2)

BATCH = 2
SEED = 3


def _cfg(**model_kw) -> Config:
    mc = dataclasses.replace(small_ffb6d_config(), **model_kw)
    return Config(dataset=DatasetConfig(name="ycb",
                                        n_sample_points=mc.n_sample_points),
                  model=mc)


def _model_dict(cfg: Config) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg.model)))


def _train_dict(cfg: Config) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg.train)))


class _Masks:
    """Records each dropout draw of the step (the generator's state, the
    shape and rate, and the mask it applied)."""

    def __init__(self, monkeypatch):
        self.draws, self.applied = [], []
        real = ffb6d_module.dropout

        def dropout(x, rate, training, generator=None):
            if training and rate:
                self.draws.append((generator.get_state(), tuple(x.shape),
                                   rate))
                g = torch.Generator().set_state(generator.get_state())
                self.applied.append(torch.rand(x.shape, generator=g)
                                    < 1.0 - rate)
            return real(x, rate, training, generator)
        monkeypatch.setattr(ffb6d_module, "dropout", dropout)


def _step(cfg: Config, dtype: torch.dtype = torch.float32) -> dict:
    """One training step of ``cfg``'s FFB6D on a synthetic batch, its
    parameters and floating inputs in ``dtype``: the weights before it,
    the batch, the dropout draws, the gradients, the parameters after it
    and the loss."""
    state = create_train_state(cfg, SEED, "cpu")
    state.model.to(dtype)
    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in to_device(synthetic_batch(
                 cfg, batch_size=BATCH, seed=SEED), "cpu").items()}
    mp = pytest.MonkeyPatch()
    masks = _Masks(mp)
    try:
        state, metrics = make_train_step(cfg, "cpu")(state, batch, seed=SEED)
    finally:
        mp.undo()
    params = dict(state.model.named_parameters())
    return {"cfg": cfg, "sd": sd, "batch": to_device(batch, "cpu"),
            "masks": masks, "loss": float(metrics["loss"]),
            "grads": {k: p.grad.detach().clone() for k, p in params.items()},
            "after": {k: p.detach().clone() for k, p in params.items()},
            "state": state}


@pytest.fixture(scope="module")
def stepped():
    return _step(_cfg())


def _reference(stepped, train=True, masks=True):
    """The reference's loss and gradients on the step's batch, weights
    and dropout masks (``train``), or with BN on the running statistics
    and, with ``masks``, the step's dropout masks (else none)."""
    cfg, sd, b = stepped["cfg"], stepped["sd"], stepped["batch"]
    model = _model_dict(cfg)
    names = list(stepped["grads"])
    params = {k: sd[k].clone().requires_grad_(True) for k in names}
    state = dict(sd, **params)
    maps = rffb6d.strided_maps(b["cloud_map"], sorted(
        set(model["ds_strides"]) | set(model["up_strides"])))
    idx = rffb6d.index(b["pointcloud"][..., :3], maps, model)
    ref = FFB6DTrainReference(model, state, checkpoint=False,
                              batch_stats=train)
    drawn = []
    if masks:
        drawn = ptrain.reference_masks([stepped["masks"].draws * 3], "cpu",
                                       BATCH)[0]
    else:
        ref._drop = lambda x, rate: x
    out = ref.forward(b["pointcloud"], b["rgb"], b["choose"], idx, drawn)
    total = loss(out, b, _train_dict(cfg))
    grads = torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    return float(total.detach()), {
        k: torch.zeros_like(params[k]) if g is None else g
        for k, g in zip(names, grads)}


def _leaf_gaps(got, ref):
    """Each leaf's gap of gradients over its reference norm or the median
    leaf's, whichever is larger."""
    norms = {k: float(g.norm()) for k, g in ref.items()}
    med = statistics.median(norms.values())
    assert med > 0
    return {k: float((got[k] - g).norm()) / max(norms[k], med)
            for k, g in ref.items()}


@pytest.fixture(scope="module")
def reference(stepped):
    return _reference(stepped)


def test_step_loss_matches_the_reference(stepped, reference):
    assert stepped["loss"] == pytest.approx(reference[0], rel=1e-5)


def test_step_gradients_match_the_reference(stepped, reference):
    """The train-mode step's gradients, as the benchmark's check reads
    them: the median leaf's gap and the whole gradient's.  Train-mode BN
    amplifies rounding at random weights (the gradient explosion of deep
    batch-normalised networks at initialisation): weights moved by 1e-10
    of themselves move the float64 reference's gradient by ~3e-7 on the
    median leaf, a gain of ~3000 that no single group of BNs carries
    (frozen, the image branch's, the fusion's or the heads' each cut it
    tenfold, RandLA-Net's not), with no BN channel degenerate (every
    variance above 3e-3, |mean| / std at most 30).  So the reference in
    float32 and in float64 part by 1-2% on the median leaf and up to 4%
    on a leaf, as the program and the float32 reference do, and a leaf
    is held tightly only with BN on running statistics (below)."""
    gaps = _leaf_gaps(stepped["grads"], reference[1])
    assert statistics.median(gaps.values()) < 0.05
    whole = sum(float(g.norm()) ** 2 for g in reference[1].values()) ** 0.5
    diff = sum(float((stepped["grads"][k] - g).norm()) ** 2
               for k, g in reference[1].items()) ** 0.5
    assert diff < 0.05 * whole


def test_train_mode_step_in_float64_matches_the_reference(monkeypatch):
    """The train-mode step (batch statistics at RandLA-Net's narrow rows,
    the step's dropout masks, the dense tail, the gathers' own backward)
    with the program and the reference both in float64: the loss within
    1e-12 and every leaf within 1e-7 of its reference norm or of the
    median leaf's, whichever is larger (both read ~1e-11).  Every cast to
    float32 becomes one to float64: FFB6D's compute dtype,
    ``Tensor.float``, the default dtype and the numpy matrices of PSP's
    pooling and resizes.  Those matrices alone in float32 (a 1e-8
    rounding) move the median leaf by 7e-4: train-mode BN's amplification
    at random weights, which the float32 comparison above reads."""
    shim = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                    if not k.startswith("__")})
    shim.float32 = np.float64
    monkeypatch.setattr(layers, "np", shim)
    monkeypatch.setitem(pvn3d_module._DTYPES, "float64", torch.float64)
    monkeypatch.setattr(torch.Tensor, "float", lambda t: t.double())
    default = torch.get_default_dtype()
    layers.separable_tensor.cache_clear()
    torch.set_default_dtype(torch.float64)
    try:
        stepped = _step(_cfg(compute_dtype="float64"), torch.float64)
        assert {g.dtype for g in stepped["grads"].values()} == {
            torch.float64}
        ref_loss, ref = _reference(stepped)
    finally:
        torch.set_default_dtype(default)
        layers.separable_tensor.cache_clear()
    assert stepped["loss"] == pytest.approx(ref_loss, rel=1e-12)
    gaps = _leaf_gaps(stepped["grads"], ref)
    bad = {k: v for k, v in gaps.items() if v > 1e-7}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:5]


def test_backward_with_running_statistics_matches_the_reference(stepped):
    """The same backward (the gathers' own, the amax pools, the fusion,
    the dense tail, RandLA) with BN on the running statistics and no
    dropout: every leaf within 1e-4 of its reference norm or of the
    median leaf's, whichever is larger."""
    cfg = stepped["cfg"]
    model = ffb6d_module.FFB6D(dataclasses.replace(
        cfg.model, cnn=dataclasses.replace(cfg.model.cnn,
                                           fuse_upsample=False)))
    model.load_state_dict(stepped["sd"])
    b = stepped["batch"]
    out = model(b["pointcloud"], b["rgb"], b["choose"],
                **model_inputs(model, b))
    total = compute_losses(cfg, out, b)["loss"]
    total.backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    ref_loss, ref = _reference(stepped, train=False, masks=False)
    assert float(total.detach()) == pytest.approx(ref_loss, rel=1e-5)
    gaps = _leaf_gaps(got, ref)
    bad = {k: v for k, v in gaps.items() if v > 1e-4}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:5]


def test_train_mode_backward_with_frozen_bn_matches_the_reference(
        stepped):
    """The train step's own paths (the dense tail, the dropouts with the
    step's masks, the gathers' backward, the fusion, RandLA) with every BN
    on its running statistics, as the benchmark's frozen-BN check runs
    them: the loss within 1e-5, the median leaf within 5e-4 and every
    leaf within 2e-3 of its reference norm or of the median leaf's,
    whichever is larger.  Not 1e-4 on every leaf: on this batch the
    float32 reference itself parts from its float64 twin by up to 8.6e-4
    on 49 of 355 leaves (the image branch's first stages), a near-tie of
    the forward that one rounding decides; the program's dropout scales
    by ``mask / keep`` where the reference divides by ``1 - rate``, and
    with the summation order of 1 to 8 threads it reads up to 4.95e-4 on
    a leaf and 8.1e-5 on the median (on seed 5 every leaf agrees within
    2e-6).  A dropout that leaves out its ``1 / keep`` reads 0.08 on the
    median leaf and 0.51 on the worst."""
    cfg = stepped["cfg"]
    model = ffb6d_module.FFB6D(cfg.model)
    model.load_state_dict(stepped["sd"])
    model.train()
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.eval()
    b = stepped["batch"]
    state, shape, rate = stepped["masks"].draws[0]
    g = torch.Generator().set_state(state)
    out = model(b["pointcloud"], b["rgb"], b["choose"], generator=g,
                **model_inputs(model, b))
    total = compute_losses(cfg, out, b)["loss"]
    total.backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    ref_loss, ref = _reference(stepped, train=False)
    assert float(total.detach()) == pytest.approx(ref_loss, rel=1e-5)
    gaps = _leaf_gaps(got, ref)
    assert statistics.median(gaps.values()) < 5e-4
    bad = {k: v for k, v in gaps.items() if v > 2e-3}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:5]


# RandLA-Net's train-mode BN rows at the small configuration, batch 2:
# fc0 (8 channels), a level-0 local spatial encoding (16 neighbours, 16
# channels), a level-0 block's output (64), a level-3 encoding.
RANDLA_ROWS = [(2, 1280, 8), (2, 1280, 16, 16), (2, 1280, 64),
               (2, 20, 16, 128)]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", RANDLA_ROWS,
                         ids=["fc0", "locse", "l0", "l3"])
def test_batch_statistics_bn_at_randla_rows_matches_float64(shape, relu):
    """The BN function's batch-statistics forward and backward (its plain
    branch, the CPU's) at RandLA-Net's narrow rows against float64
    autograd of the same formula: values, dx, dweight and dbias within
    1e-5 of their scale."""
    g = torch.Generator().manual_seed(len(shape) * 10 + shape[-1])
    x = torch.randn(shape, generator=g) * 2.0 + 0.5
    dy = torch.randn(shape, generator=g)
    c = shape[-1]
    layer = BatchNorm(c).train()
    with torch.no_grad():
        layer.weight.copy_(torch.rand(c, generator=g) + 0.5)
        layer.bias.copy_(torch.randn(c, generator=g))
    xa = x.clone().requires_grad_(True)
    ya = layer(xa, 0.1, relu=relu)
    ya.backward(dy)
    xd = x.double().requires_grad_(True)
    w = layer.weight.detach().double().requires_grad_(True)
    bias = layer.bias.detach().double().requires_grad_(True)
    axes = tuple(range(x.dim() - 1))
    mean = xd.mean(dim=axes)
    var = ((xd - mean) ** 2).mean(dim=axes)
    yd = (xd - mean) * torch.rsqrt(var + layer.eps) * w + bias
    yd = torch.relu(yd) if relu else yd
    yd.backward(dy.double())
    for got, want in ((ya.detach(), yd.detach()), (xa.grad, xd.grad),
                      (layer.weight.grad, w.grad),
                      (layer.bias.grad, bias.grad)):
        scale = float(want.abs().max())
        torch.testing.assert_close(got.double(), want, rtol=0,
                                   atol=1e-5 * scale)


def test_step_applies_adams_first_update(stepped):
    """After one step each parameter moved by Adam's first update of its
    own gradient, ``lr * g / (|g| + eps)`` at the schedule's first rate,
    and the BN statistics moved."""
    lr = schedule.lr_schedule(stepped["cfg"].train)(0)
    for k, g in stepped["grads"].items():
        want = stepped["sd"][k] - lr * g / (g.abs() + 1e-8)
        torch.testing.assert_close(stepped["after"][k], want, rtol=0,
                                   atol=1e-7)
    moved = [k for k, v in stepped["state"].model.state_dict().items()
             if k.endswith("running_mean")
             and not torch.equal(v, stepped["sd"][k])]
    n_bn = sum(isinstance(m, BatchNorm)
               for m in stepped["state"].model.modules())
    assert len(moved) == n_bn


def test_recorded_masks_reproduce_the_step(stepped):
    """The benchmark's record (each draw's generator state, shape and
    rate) regenerates the three masks the step applied, bit for bit."""
    rec = stepped["masks"]
    assert [d[1][1] for d in rec.draws] == [1024, 256, 64]
    again = ptrain.reference_masks([rec.draws * 3], "cpu", BATCH)[0]
    for got, want in zip(again, rec.applied):
        assert torch.equal(got.bool(), want)


@pytest.mark.parametrize("b,dup", [(1, False), (3, True)])
def test_gather_rows_function_matches_plain_indexing(b, dup):
    """Forward bit for bit; backward within 1e-6 of autograd's on plain
    indexing, with repeated indices (a row gathered many times)."""
    g = torch.Generator().manual_seed(b)
    feats = torch.randn(b, 50, 7, generator=g)
    hi = 5 if dup else 50
    idx = torch.randint(0, hi, (b, 40, 16), generator=g, dtype=torch.int32)
    grad = torch.randn(b, 40, 16, 7, generator=g)
    a = feats.clone().requires_grad_(True)
    out = randla.gather_rows(a, idx)
    out.backward(grad)
    p = feats.clone().requires_grad_(True)
    plain = p[torch.arange(b)[:, None, None], idx.long()]
    plain.backward(grad)
    assert torch.equal(out, plain)
    torch.testing.assert_close(a.grad, p.grad, rtol=0, atol=1e-6)


def test_gather_backward_is_the_custom_function(monkeypatch):
    """Where a gradient is recorded the gathers go through ``GatherRows``;
    under ``no_grad`` they keep the plain gather."""
    calls = []
    real = randla.GatherRows.apply
    monkeypatch.setattr(randla.GatherRows, "apply",
                        lambda *a: calls.append(1) or real(*a))
    feats = torch.randn(2, 9, 3, requires_grad=True)
    idx = torch.zeros(2, 4, dtype=torch.int32)
    randla.gather_rows(feats, idx)
    assert calls == [1]
    with torch.no_grad():
        randla.gather_rows(feats, idx)
    randla.gather_rows(feats.detach(), idx)
    assert calls == [1]


def test_serving_gathers_take_no_custom_function(monkeypatch):
    """A raw request through the serving step runs no ``GatherRows``."""
    def refuse(*_a):
        raise AssertionError("GatherRows on the serving path")
    monkeypatch.setattr(randla.GatherRows, "apply", refuse)
    cfg = _cfg()
    mc = cfg.model
    h, w = mc.image_height, mc.image_width
    rgb, depth, k = synth_sensor_frame(h, w, seed=1)
    k = k.copy()
    k[:, 0, 2], k[:, 1, 2] = w / 2, h / 2
    k[:, :2, :2] *= 0.2
    step = make_raw_inference_step(
        cfg, ffb6d_module.FFB6D(mc), stacked_mesh_kps(),
        stacked_class_radii(), device="cpu")
    out = step({"rgb": rgb, "depth": depth, "cam_k": k},
               generator=torch.Generator().manual_seed(0))
    assert out["poses"].shape[0] == 1


def test_index_of_a_batch_is_its_frames(stepped):
    """The neighbour index of the batch of 2 equals each frame's own."""
    b, mc = stepped["batch"], stepped["cfg"].model
    xyz, cmap = b["pointcloud"][..., :3], b["cloud_map"]
    both = build_index(xyz, cmap, mc)
    one = [build_index(xyz[i:i + 1], cmap[i:i + 1], mc) for i in range(2)]
    for name in ("nei", "sub", "interp", "r2p_ds", "p2r_ds", "r2p_up",
                 "p2r_up", "xyz"):
        for j, t in enumerate(both[name]):
            assert torch.equal(t, torch.cat([one[0][name][j],
                                             one[1][name][j]])), (name, j)
    for s, m in both["maps"].items():
        assert torch.equal(m, torch.cat([one[0]["maps"][s],
                                         one[1]["maps"][s]]))


# Ranges one FFB6D training step opens at the small configuration: one
# index; 7 fusion stages; fc0, 4 RandLA blocks and 4 decoder convs; 7
# image stages and the dense tail; 109 train-mode BNs, each with its
# backward; 31 gathers with a gradient (3 a RandLA block, 1 a decoder
# conv, 2 a fusion stage, the tail's).
STEP_RANGES = {"pvn3d.neighbour_index": 1, "pvn3d.fusion": 7,
               "pvn3d.point_branch": 9, "pvn3d.image_branch": 8,
               "pvn3d.heads": 1, "pvn3d.forward": 1, "pvn3d.backward": 1,
               "pvn3d.optimizer": 1, "pvn3d.bn": 109,
               "pvn3d.batchnorm_backward": 109,
               "pvn3d.gather_backward": 31}


def test_a_step_opens_its_ranges_inside_it():
    cfg = _cfg()
    state = create_train_state(cfg, 0, "cpu")
    assert sum(isinstance(m, BatchNorm)
               for m in state.model.modules()) == STEP_RANGES["pvn3d.bn"]
    batch = synthetic_batch(cfg, batch_size=BATCH, seed=0)
    step = make_train_step(cfg, "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, batch)
    events = prof.events()
    tops = [e for e in events if e.name.startswith("pvn3d.step#")]
    assert len(tops) == 1
    top = tops[0]
    counts = {}
    for e in events:
        if e.name.startswith("pvn3d.") and e is not top:
            # Autograd's thread runs the backward ranges, inside the
            # step's time.
            assert (top.time_range.start <= e.time_range.start
                    and e.time_range.end <= top.time_range.end), e.name
            counts[e.name] = counts.get(e.name, 0) + 1
    got = {k: counts.get(k, 0) for k in STEP_RANGES}
    assert got == STEP_RANGES


def test_train_app_trains_ffb6d_on_a_fake_tree(tmp_path, monkeypatch,
                                               capsys):
    """``apps/train.py --model ffb6d`` for 2 steps on the CPU: the
    frames carry the cloud map and a random sample, the loss has every
    term, and a checkpoint is written."""
    cfg = _cfg(image_height=120, image_width=160)
    monkeypatch.setattr(train_app, "ffb6d_base_config", lambda d: cfg)
    items = ["data/0048/000001", "data/0048/000036", "data_syn/000001",
             "data_syn/000002"]
    root = make_fake_ycb(str(tmp_path), h=120, w=160, cls_ids=(1, 2),
                         items=items, mesh_ids=range(1, 22))
    trainer = train_app.main([
        "--model", "ffb6d", "--data_root", root, "--file_list",
        root + "/image_list.txt", "--checkpoint_dir", str(tmp_path / "run"),
        "--device", "cpu", "--max_steps", "2", "--batch_size", "2",
        "--workers", "0", "--log_every", "1"])
    assert trainer.state.step == 2
    assert isinstance(trainer.state.model, ffb6d_module.FFB6D)
    logs = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[train it=")]
    assert len(logs) == 2
    for ln in logs:
        terms = dict(kv.split("=") for kv in ln.split("]")[1].split())
        assert all(np.isfinite(float(v)) for v in terms.values())
        assert float(terms["loss_kp"]) > 0 and float(terms["loss_ctr"]) > 0
    assert list((tmp_path / "run").iterdir())


def test_train_app_refuses_what_ffb6d_does_not_take(tmp_path):
    for extra in (["--device_preprocess"], ["--dataset", "linemod"]):
        with pytest.raises(SystemExit):
            train_app.main(["--model", "ffb6d", "--data_root",
                            str(tmp_path), "--device", "cpu"] + extra)
