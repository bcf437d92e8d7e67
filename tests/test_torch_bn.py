"""Train-mode BatchNorm as one autograd function
(``ops/kernels/bn.py::BatchNormTrain``): its plain branch, the one CPU
tensors take, against autograd of the plain tensor code the port ran
before it (kept here as the oracle), and the Python the card's branch
runs before its launches (layouts, grids, arguments), on 'meta' tensors
standing in for CUDA ones.  The kernels themselves are held against the
plain branch on the card (``chip_smoke.py`` [bn])."""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import torch.nn.functional as F  # noqa: E402

from pvn3d_tpu_torch.models.layers import BatchNorm  # noqa: E402
from pvn3d_tpu_torch.ops.kernels import BN_KERNELS, KERNELS  # noqa: E402
from pvn3d_tpu_torch.ops.kernels import bn as kbn  # noqa: E402

C = 6
EPS = 1e-5


def _oracle(x, weight, bias, running_mean, running_var, nchw, momentum,
            relu, update_running=True):
    """The port's train-mode BatchNorm before the autograd function: plain
    tensor code that autograd differentiates, the ReLU at the caller."""
    axes = (0, 2, 3) if nchw else tuple(range(x.dim() - 1))
    xf = x.float()
    mean = xf.mean(dim=axes)
    meansq = (xf * xf).mean(dim=axes)
    n = x.numel() // mean.numel()
    var = torch.clamp(meansq - mean * mean, min=0.0)
    if update_running:
        with torch.no_grad():
            m = float(momentum)
            running_mean.mul_(1.0 - m).add_(m * mean)
            running_var.mul_(1.0 - m).add_(m * (var * (n / max(n - 1, 1))))
    inv = torch.rsqrt(var + EPS) * weight
    if nchw:
        y = ((x.float() - mean[:, None, None]) * inv[:, None, None]
             + bias[:, None, None])
    else:
        y = (x.float() - mean) * inv + bias
    y = y.to(x.dtype)
    return F.relu(y) if relu else y


def _inputs(layout, dtype, clamp=None, seed=0):
    """x (4, 5, 7, C) channels last, or (4, C, 5, 7) NCHW in the default
    or channels_last memory format; channel 2 constant (``clamp`` "zero":
    E[x^2] - E[x]^2 is exactly 0) or of large mean and a variance that
    rounds negative (``clamp`` "negative")."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, 5, 7, C) * 2.0 + 1.5).astype(np.float32)
    if clamp == "zero":
        x[..., 2] = 3.0
    elif clamp == "negative":
        # A draw whose E[x^2] - E[x]^2 rounds negative in every layout.
        x[..., 2] = 300.0 + np.random.RandomState(1).randn(4, 5, 7).astype(
            np.float32) * 1e-3
    g = rng.randn(*x.shape).astype(np.float32)
    x, g = torch.tensor(x).to(dtype), torch.tensor(g).to(dtype)
    if layout != "rows":
        x, g = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        if layout == "nchw":
            x, g = x.contiguous(), g.contiguous()
    params = {"weight": torch.tensor(rng.rand(C).astype(np.float32) + 0.5),
              "bias": torch.tensor(rng.randn(C).astype(np.float32)),
              "running_mean": torch.tensor(rng.randn(C).astype(np.float32)),
              "running_var": torch.tensor(rng.rand(C).astype(np.float32)
                                          + 0.5)}
    return x, g, params


def _run(layout, dtype, relu, momentum=0.1, update_running=True, clamp=None):
    """The module (the function's plain branch) and the oracle on the same
    inputs: outputs, dx, dweight, dbias, running mean and variance."""
    x, g, params = _inputs(layout, dtype, clamp)
    nchw = layout != "rows"
    layer = BatchNorm(C)
    with torch.no_grad():
        for k, v in params.items():
            getattr(layer, k).copy_(v)
    layer.train()
    layer.update_running = update_running
    xa = x.clone().requires_grad_(True)
    ya = (layer.nchw(xa, momentum, relu=relu) if nchw
          else layer(xa, momentum, relu=relu))
    assert type(ya.grad_fn).__name__ == "BatchNormTrainBackward"
    ya.backward(g)
    got = (ya.detach(), xa.grad, layer.weight.grad, layer.bias.grad,
           layer.running_mean, layer.running_var)

    w = params["weight"].clone().requires_grad_(True)
    b = params["bias"].clone().requires_grad_(True)
    rm, rv = params["running_mean"].clone(), params["running_var"].clone()
    xb = x.clone().requires_grad_(True)
    yb = _oracle(xb, w, b, rm, rv, nchw, momentum, relu, update_running)
    yb.backward(g)
    want = (yb.detach(), xb.grad, w.grad, b.grad, rm, rv)
    return got, want, params


def _hold(got, want, dtype, keep=slice(None)):
    """Values and running statistics equal (the same operations); the
    gradients within float32 summation order, and dx in bfloat16 within an
    ulp (the oracle rounds the two paths' gradients to bfloat16 before it
    adds them, the function once)."""
    y, dx, dw, db, rm, rv = got
    wy, wdx, wdw, wdb, wrm, wrv = want
    assert y.dtype == wy.dtype and dx.dtype == wdx.dtype == dtype
    assert y.stride() == wy.stride() and dx.stride() == wdx.stride()
    ch = (Ellipsis, keep) if y.shape[-1] == C else (slice(None), keep)
    assert torch.equal(y[ch], wy[ch])
    assert torch.equal(rm, wrm) and torch.equal(rv[keep], wrv[keep])
    if dtype == torch.float32:
        torch.testing.assert_close(dx[ch], wdx[ch], rtol=1e-5, atol=1e-5)
    else:
        scale = float(wdx[ch].float().abs().max())
        torch.testing.assert_close(dx[ch].float(), wdx[ch].float(),
                                   rtol=2 ** -7, atol=2 ** -7 * scale)
    torch.testing.assert_close(dw[keep], wdw[keep], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(db, wdb, rtol=1e-5, atol=1e-4)


LAYOUTS = ["rows", "nchw", "channels_last"]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_branch_matches_autograd_of_the_plain_code(layout, dtype,
                                                         relu):
    """Values, dx, dweight, dbias and running statistics in every layout
    and dtype, with the ReLU fused and not."""
    got, want, _ = _run(layout, dtype, relu)
    _hold(got, want, dtype)


@pytest.mark.parametrize("clamp", ["zero", "negative"])
@pytest.mark.parametrize("layout", ["rows", "nchw"])
def test_clamped_variance_channel(layout, clamp):
    """A channel whose E[x^2] - E[x]^2 is 0 keeps the variance term of the
    gradient (the clamp passes at its bound); one that rounds negative
    drops it, as the clamp's gradient does.  The large-mean channel's
    statistics are rounding noise, so its values are compared where the
    oracle's are defined by the same operations (all of them: equal) and
    its gradients alike."""
    x, _, params = _inputs(layout, torch.float32, clamp)
    nchw = layout != "rows"
    axes = (0, 2, 3) if nchw else (0, 1, 2)
    xf = x.float()
    _, st, _ = kbn.forward_plain(
        x, params["weight"], params["bias"], params["running_mean"].clone(),
        params["running_var"].clone(), nchw, 0.1, EPS, False, True, None)
    raw = (xf * xf).mean(dim=axes)[2] - xf.mean(dim=axes)[2] ** 2
    assert float(st[3, 2]) == (1.0 if clamp == "zero" else 0.0)
    assert (float(raw) == 0.0) == (clamp == "zero")
    got, want, _ = _run(layout, torch.float32, relu=True, clamp=clamp)
    _hold(got, want, torch.float32)


@pytest.mark.parametrize("layout", ["rows", "nchw"])
def test_update_running_false_leaves_running_statistics(layout):
    """A rematerialised forward's BN: the same outputs and gradients, the
    running statistics untouched."""
    got, want, params = _run(layout, torch.bfloat16, relu=True,
                             update_running=False)
    _hold(got, want, torch.bfloat16)
    assert torch.equal(got[4], params["running_mean"])
    assert torch.equal(got[5], params["running_var"])


@pytest.mark.parametrize("momentum", [0.01, 0.5, 0.9])
def test_per_call_momentum(momentum):
    """The momentum is an argument of each call (the step's schedule)."""
    got, want, params = _run("rows", torch.float32, relu=False,
                             momentum=momentum)
    _hold(got, want, torch.float32)
    assert not torch.equal(got[4], params["running_mean"])


def test_eval_mode_is_the_plain_code_and_saves_nothing():
    """Eval mode reads the running statistics in plain tensor code, as
    before the function; the fused ReLU is a ReLU after it."""
    x, _, params = _inputs("nchw", torch.bfloat16)
    layer = BatchNorm(C)
    with torch.no_grad():
        for k, v in params.items():
            getattr(layer, k).copy_(v)
    layer.eval()
    inv = (torch.rsqrt(layer.running_var + layer.eps)
           * layer.weight)[:, None, None]
    want = ((x.float() - layer.running_mean[:, None, None]) * inv
            + layer.bias[:, None, None]).to(x.dtype)
    with torch.no_grad():
        assert torch.equal(layer.nchw(x), want)
        assert torch.equal(layer.nchw(x, relu=True), F.relu(want))
    assert torch.equal(layer.running_mean, params["running_mean"])


def test_spans_name_forward_and_backward_apart():
    """The forward runs inside ``pvn3d.bn``; the backward opens
    ``pvn3d.batchnorm_backward``, which does not start with
    ``pvn3d.bn``: the forward's reader sums every range named so."""
    x, g, _ = _inputs("rows", torch.float32)
    layer = BatchNorm(C).train()
    x.requires_grad_(True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        layer(x, 0.1, relu=True).backward(g)
    names = [e.name for e in prof.events()]
    assert names.count("pvn3d.bn") == 1
    assert names.count("pvn3d.batchnorm_backward") == 1
    assert not "pvn3d.batchnorm_backward".startswith("pvn3d.bn")


# ------------------------------------------------ the card's branch's Python

@pytest.mark.parametrize("shape,nchw,want", [
    ((24, 12288, 1024), False, (kbn.ROWS, 24 * 12288, 1024, 1)),
    ((24, 2048, 32, 128), False, (kbn.ROWS, 24 * 2048 * 32, 128, 1)),
    ((24, 64, 480, 640), True, (kbn.NCHW, 24, 64, 480 * 640))])
def test_layout_of_contiguous_inputs(shape, nchw, want):
    x = torch.empty(shape, device="meta")
    assert kbn.layout_of(x, nchw) == want


def test_layout_of_channels_last_map_is_rows():
    x = torch.empty((24, 64, 240, 320), device="meta").to(
        memory_format=torch.channels_last)
    assert kbn.layout_of(x, True) == (kbn.ROWS, 24 * 240 * 320, 64, 1)


@pytest.mark.parametrize("nchw", [False, True])
def test_layout_of_raises_on_other_strides(nchw):
    x = torch.empty((4, 8, 6, 5), device="meta")
    bad = x.transpose(1, 2) if nchw else x.transpose(0, 1)
    with pytest.raises(ValueError, match="BatchNorm"):
        kbn.layout_of(bad, nchw)


@pytest.mark.parametrize("layout,outer,c,inner,elem,aligned", [
    (kbn.ROWS, 24 * 12288, 1024, 1, 2, True),
    (kbn.ROWS, 24 * 12288, 128, 1, 2, True),
    (kbn.ROWS, 24 * 240 * 320, 64, 1, 2, True),
    (kbn.ROWS, 24 * 12288, 4096, 1, 4, True),
    (kbn.ROWS, 100, 6, 1, 2, True),
    (kbn.ROWS, 100, 64, 1, 2, False),
    (kbn.ROWS, 3, 512, 1, 4, True),
    (kbn.NCHW, 24, 64, 480 * 640, 2, True),
    (kbn.NCHW, 24, 512, 60 * 80, 4, True),
    (kbn.NCHW, 2, 6, 35, 4, True)])
def test_grid_covers_the_work(layout, outer, c, inner, elem, aligned):
    """The grid the wrapper derives from the shape: 16-byte vectors when
    the channel count (rows) or plane (NCHW) and the pointers allow, every
    channel covered by one group of at most 256 threads, about eight
    blocks an SM of a 132-SM card and no more blocks than the work."""
    g = kbn.grid(layout, outer, c, inner, elem, aligned, 132)
    full = 16 // elem
    if layout == kbn.ROWS:
        assert g.vec == (full if c % full == 0 and aligned else 1)
        assert g.tcols * g.grid_y * g.vec >= c
        assert (g.grid_y - 1) * g.tcols * g.vec < c
        assert g.threads == g.tcols * g.rl <= kbn.THREADS
        assert g.grid_x <= max(1, -(-outer // g.rl))
    else:
        assert g.vec == (full if inner % full == 0 and aligned else 1)
        assert g.grid_y == c and g.threads == kbn.THREADS
        assert g.grid_x <= max(1, -(-(outer * inner // g.vec)
                                    // kbn.THREADS))
    assert g.grid_x >= 1
    assert g.grid_x * g.grid_y < kbn.BLOCKS_PER_SM * 132 + g.grid_y
    args = g.args(torch.bfloat16 if elem == 2 else torch.float32)
    assert len(args) == len(kbn._GRID)


def _meta_bn(monkeypatch, layout="rows", dtype=torch.bfloat16):
    monkeypatch.setattr(kbn, "require_cuda", lambda *t: t[0].device)
    monkeypatch.setattr(kbn, "_sms", lambda dev: 132)
    shape = (24, 64, 30, 40) if layout != "rows" else (24, 300, 64)
    x = torch.empty(shape, dtype=dtype, device="meta")
    if layout == "channels_last":
        x = x.to(memory_format=torch.channels_last)
    p = {k: torch.empty(64, device="meta") for k in
         ("weight", "bias", "running_mean", "running_var")}
    return x, p


@pytest.mark.parametrize("layout", LAYOUTS)
def test_device_branch_launches_three_a_pass(layout, monkeypatch):
    """A tensor off the CPU never takes the plain branch: the forward
    launches statistics, finish and normalise, the backward reduce,
    finish and dx, each with all its arguments but the stream (recorders
    on 'meta' tensors standing in for CUDA ones), and dx keeps x's
    memory format."""
    x, p = _meta_bn(monkeypatch, layout)
    calls = []
    for k in BN_KERNELS:
        monkeypatch.setattr(k, "launch", lambda dev, *a, k=k: calls.append(
            (k.name, len(a) == len(k.argtypes) - 1)))

    def no_plain(*a, **k):
        raise AssertionError("device tensors must not take the plain path")
    monkeypatch.setattr(kbn, "forward_plain", no_plain)
    monkeypatch.setattr(kbn, "backward_plain", no_plain)
    nchw = layout != "rows"
    x.requires_grad_(True)
    y = kbn.batch_norm_train(x, *p.values(), nchw=nchw, momentum=0.1,
                             eps=EPS, relu=True)
    assert [c[0] for c in calls] == ["bn_stats", "bn_finish", "bn_apply"]
    assert y.stride() == x.stride()
    (dx,) = torch.autograd.grad(y, x, torch.empty_like(y))
    assert [c[0] for c in calls[3:]] == ["bn_bwd_reduce", "bn_finish",
                                         "bn_bwd_apply"]
    assert all(ok for _, ok in calls)
    assert dx.stride() == x.stride()


def test_device_branch_raises_off_cuda_and_on_other_dtypes(monkeypatch):
    x = torch.empty((8, 64), device="meta")
    p = [torch.empty(64, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kbn.batch_norm_train(x, *p, nchw=False, momentum=0.1, eps=EPS)
    x, p = _meta_bn(monkeypatch, "rows", torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kbn.batch_norm_train(x, *p.values(), nchw=False, momentum=0.1,
                             eps=EPS)


def test_bn_kernels_share_one_source_and_count_apart():
    """Five entry points of ``bn.cu``, one library, five counters, none
    among the TPU kernels' ports."""
    assert [k.name for k in BN_KERNELS] == [
        "bn_stats", "bn_finish", "bn_apply", "bn_bwd_reduce",
        "bn_bwd_apply"]
    assert len({k.lib_path() for k in BN_KERNELS}) == 1
    assert not set(BN_KERNELS) & set(KERNELS)
    for k in BN_KERNELS:
        assert k.source.endswith("bn.cu") and isinstance(k.launches, int)
        assert all(t in (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float) for t in k.argtypes)
