"""The algorithm of the shift-loop kernel (``csrc/meanshift.cu``) as a
numpy model, against the port's plain version and the JAX package's
winner-mode ``mean_shift_fit``.

These tests hold the algorithm, not the CUDA: the kernel runs only on a
card, where ``chip_smoke.py`` holds it against its plain version at the
pose stage's shapes.

The model, per launch (one cluster of C = min(8, H) CTAs):
  - CTA r takes hypotheses r, r + C, r + 2C, ...; its W = min(32,
    ceil(H / C)) warps take those in turn (several a warp above 8 x 32
    hypotheses); each hypothesis's first S points are staged (S = K where
    ceil(H / C) rows of K float4 fit in the stage, else a multiple of 32);
  - a step of a hypothesis: lane l takes points j = l, l + 32, ... in
    order, skips each run of 32 points with no valid point, and adds
    w = exp((-0.5 d2) / bw2) * m, w x, w y, w z in float32 (d2 in the
    direct form); a fixed xor butterfly (16, 8, 4, 2, 1) sums the lanes;
    c' = sums / max(sum w, 1e-20), shift = |c' - c|;
  - groups of 4 steps; after a group it += 4, and the loop stops when
    it >= max_iter or every hypothesis's last shift is < stop.
"""
import collections
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pvn3d_tpu.inference import meanshift as jax_meanshift

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch.config import ClusterConfig, ICPConfig  # noqa: E402
from pvn3d_tpu_torch.inference.meanshift import (  # noqa: E402
    bandwidth_terms, mean_shift_fit)
from pvn3d_tpu_torch.ops.kernels import meanshift  # noqa: E402
from pvn3d_tpu_torch.ops.kernels.winner import winner_stats  # noqa: E402

_CLUSTER = 8
_WARPS = 32
_STAGE_BYTES = 232448 - 1024
_UNROLL = 4
_F = np.float32


def launch_shape(h, k):
    """(CTAs, warps a CTA, hypotheses a CTA, staged points a hypothesis),
    as ``shape_of`` in meanshift.cu."""
    cluster = min(h, _CLUSTER)
    per_cta = -(-h // cluster)
    warps = min(per_cta, _WARPS)
    stage = (k if per_cta * k * 16 <= _STAGE_BYTES
             else _STAGE_BYTES // 16 // per_cta // 32 * 32)
    return cluster, warps, per_cta, stage


def assignment(h, k):
    """{hypothesis: (CTA, warp, slot)} of a launch."""
    cluster, warps, _, _ = launch_shape(h, k)
    out = {}
    for r in range(cluster):
        nh = (h - r + cluster - 1) // cluster if r < h else 0
        for slot in range(nh):
            out.setdefault(r + slot * cluster, []).append(
                (r, slot % warps, slot))
    return out


def _sqdist(a, b):
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def _butterfly(v):
    """(H, 32, ...) lane partials -> (H, ...), every lane's sum checked
    equal: lane l adds lane l ^ off's value, for off = 16, 8, 4, 2, 1."""
    lanes = np.arange(32)
    off = 16
    while off:
        v = v + v[:, lanes ^ off]
        off //= 2
    assert (v == v[:, :1]).all()
    return v[:, 0]


def model_shift_to_stop(points, mask, win, bw2, stop, max_iter):
    """numpy model of the kernel: (H, K, 3) float32, (H, K) bool, (H,) ->
    (centres (H, 3), steps, the max shift after each group)."""
    h, k, _ = points.shape
    n_ch = -(-k // 32)
    pad = n_ch * 32 - k
    p = np.pad(points, ((0, 0), (0, pad), (0, 0))).reshape(h, n_ch, 32, 3)
    m = np.pad(mask, ((0, 0), (0, pad))).reshape(h, n_ch, 32)
    m_f = m.astype(_F)
    runs = m.any(axis=2)                          # (H, n_ch): a run is taken
    bw2 = _F(bw2)
    c = points[np.arange(h), win].astype(_F)
    it, group_max = 0, []
    while True:
        for _ in range(_UNROLL):
            d2 = _sqdist(p, c[:, None, None, :])
            w = np.exp((_F(-0.5) * d2) / bw2) * m_f
            terms = np.concatenate([w[..., None], w[..., None] * p], -1)
            acc = np.zeros((h, 32, 4), _F)
            for i in range(n_ch):                 # lane by lane, j = l + 32 i
                acc = np.where(runs[:, i, None, None], acc + terms[:, i], acc)
            s = _butterfly(acc)
            den = np.where(s[:, 0] < _F(1e-20), _F(1e-20), s[:, 0])
            new_c = s[:, 1:] / den[:, None]
            shift = np.sqrt(_sqdist(new_c, c))
            c = new_c
        it += _UNROLL
        group_max.append(float(shift.max()))
        if it >= max_iter or (shift < _F(stop)).all():
            break
    return c, it, group_max


def _votes(rng, h, k, valid=0.8, spread=0.02, modes=2):
    centre = rng.randn(h, modes, 3).astype(np.float32) * 0.1
    pick = rng.randint(0, modes, (h, k))
    pts = (centre[np.arange(h)[:, None], pick]
           + rng.randn(h, k, 3).astype(np.float32) * spread)
    return pts.astype(np.float32), rng.rand(h, k) < valid


def _prefix(rng, h, k, present):
    """The pose stage's masks: row r keeps its first count_r points, and
    the rows of absent classes none."""
    counts = np.where(rng.rand(h) < present, rng.randint(1, k + 1, h), 0)
    return np.arange(k)[None, :] < counts[:, None]


def _case(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    bw, max_iter = 0.08, 300
    if name == "H=21 K=512, the centre fits":
        pts, msk = _votes(rng, 21, 512)
        msk &= _prefix(rng, 21, 512, 0.3)
    elif name == "H=168 K=512, the keypoint fit":
        pts, _ = _votes(rng, 168, 512)
        msk = np.repeat(_prefix(rng, 21, 512, 0.25), 8, axis=0)
    elif name == "H=8 K=512, LineMOD's keypoints":
        pts, msk = _votes(rng, 8, 512, valid=1.0)
        msk &= _prefix(rng, 8, 512, 1.0)
    elif name == "H=1 K=512":
        pts, msk = _votes(rng, 1, 512)
    elif name == "empty hypotheses":
        pts, msk = _votes(rng, 6, 256)
        msk[[0, 3, 5]] = False
    elif name == "H=300, above one cluster's warps":
        pts, msk = _votes(rng, 300, 64)
        msk[::7] = False
    elif name == "K=7":
        pts, msk = _votes(rng, 5, 7, valid=0.7)
    elif name == "K=700, runs of invalid points":
        pts, msk = _votes(rng, 12, 700)
        msk[:, 64:160] = False
        msk[:, 300:333] = False
    else:   # "the max_iter cap": wide clusters, far from converged at 8
        pts, msk = _votes(rng, 21, 512, spread=0.05, modes=3)
        max_iter = 8
    return pts, msk, bw, max_iter


_CASES = ["H=21 K=512, the centre fits", "H=168 K=512, the keypoint fit",
          "H=8 K=512, LineMOD's keypoints", "H=1 K=512", "empty hypotheses",
          "H=300, above one cluster's warps", "K=7",
          "K=700, runs of invalid points", "the max_iter cap"]


@pytest.fixture
def jax_pallas_winner_counted(monkeypatch):
    """JAX's winner arm forced to its Pallas kernel (interpret mode, the
    direct-form d^2), and the step count of each ``while_loop`` it runs."""
    monkeypatch.setattr(jax_meanshift, "_winner_stats", functools.partial(
        jax_meanshift._winner_stats, impl="pallas"))
    real = jax.lax.while_loop
    steps = []

    def counted(cond, body, init):
        out = real(cond, body, init)
        jax.debug.callback(lambda it: steps.append(int(it)), out[1])
        return out
    monkeypatch.setattr(jax.lax, "while_loop", counted)
    jax.clear_caches()
    yield steps
    jax.clear_caches()


def _win(pts, msk, bw):
    win, _, _ = winner_stats(torch.tensor(pts), torch.tensor(msk), bw)
    return win.numpy()


@pytest.mark.parametrize("case", _CASES)
def test_model_equals_plain_and_jax(case, jax_pallas_winner_counted):
    """The model, ``shift_to_stop`` on CPU tensors (the plain version) and
    the JAX package's ``mean_shift_fit``: the same step count, centres
    within 1e-5; every group's max shift is clear of the stop's rounding
    window (2% of the stop), so the count is decided by a margin."""
    pts, msk, bw, max_iter = _case(case)
    bw2, stop = bandwidth_terms(bw)
    win = _win(pts, msk, bw)
    got, steps, group_max = model_shift_to_stop(pts, msk, win, bw2, stop,
                                                max_iter)
    assert all(abs(g - stop) > 0.02 * stop for g in group_max), group_max
    plain, plain_steps = meanshift.shift_to_stop(
        torch.tensor(pts), torch.tensor(msk), torch.tensor(win), bw2, stop,
        max_iter)
    assert int(plain_steps) == steps
    np.testing.assert_allclose(got, plain.numpy(), atol=1e-5, rtol=0)
    want, _, _ = jax_meanshift.mean_shift_fit(
        jnp.asarray(pts), jnp.asarray(msk), bw, max_iter=max_iter)
    assert jax_pallas_winner_counted == [steps]
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    # The port's fit is the plain loop after K4 on CPU tensors.
    fit, _, _ = mean_shift_fit(torch.tensor(pts), torch.tensor(msk), bw,
                               max_iter=max_iter)
    np.testing.assert_array_equal(fit.numpy(), plain.numpy())


def test_case_properties():
    """The cases test what they are named for."""
    pts, msk, bw, max_iter = _case("the max_iter cap")
    bw2, stop = bandwidth_terms(bw)
    _, steps, group_max = model_shift_to_stop(pts, msk, _win(pts, msk, bw),
                                              bw2, stop, max_iter)
    assert steps == 8 and group_max[-1] > stop
    pts, msk, bw, _ = _case("H=168 K=512, the keypoint fit")
    empty = ~msk.any(axis=1)
    assert 0.5 < empty.mean() < 1.0
    got, _, _ = model_shift_to_stop(pts, msk, _win(pts, msk, bw),
                                    *bandwidth_terms(bw), 300)
    assert (got[empty] == 0).all()
    pts, msk, _, _ = _case("K=700, runs of invalid points")
    assert not msk[:, 64:160].any() and msk[:, 160:192].any()
    assert launch_shape(300, 64)[2] > _WARPS


@pytest.mark.parametrize("max_iter,want", [(0, 4), (1, 4), (4, 4), (5, 8),
                                           (8, 8)])
def test_max_iter_rounds_up_to_a_group(max_iter, want):
    """The cap is checked after each group, as the JAX package's
    ``while_loop`` checks it: a group always runs whole."""
    pts, msk, bw, _ = _case("the max_iter cap")
    bw2, stop = bandwidth_terms(bw)
    win = _win(pts, msk, bw)
    _, steps, _ = model_shift_to_stop(pts, msk, win, bw2, stop, max_iter)
    _, plain_steps = meanshift.shift_to_stop(
        torch.tensor(pts), torch.tensor(msk), torch.tensor(win), bw2, stop,
        max_iter)
    assert steps == int(plain_steps) == want


@pytest.mark.parametrize("h,k", [(1, 512), (7, 3), (8, 512), (9, 100),
                                 (21, 512), (21, 2000), (168, 512),
                                 (168, 1500), (256, 64), (257, 64),
                                 (300, 512), (5000, 8)])
def test_every_hypothesis_has_one_warp_and_the_stage_fits(h, k):
    cluster, warps, per_cta, stage = launch_shape(h, k)
    seen = assignment(h, k)
    assert sorted(seen) == list(range(h))
    assert all(len(v) == 1 for v in seen.values())
    assert all(w < warps <= _WARPS for v in seen.values() for _, w, _ in v)
    assert max(s for v in seen.values() for _, _, s in v) < per_cta
    assert cluster <= _CLUSTER and cluster * per_cta >= h
    assert per_cta * stage * 16 <= _STAGE_BYTES
    assert stage == k or (stage % 32 == 0 and stage < k)
    per_warp = collections.Counter((r, w) for v in seen.values()
                                   for r, w, _ in v)
    assert (max(per_warp.values()) > 1) == (h > _CLUSTER * _WARPS)


def test_the_serving_shapes_stage_every_point():
    """The pose stage's fits (H = 1, 8, 21, 168 at K = 512) read each
    point from global memory once; a class's 8 keypoint rows fall to 8
    CTAs."""
    for h in (1, 8, 21, 168):
        assert launch_shape(h, 512)[3] == 512
    seen = assignment(168, 512)
    for cls in range(21):
        assert len({seen[cls * 8 + q][0][0] for q in range(8)}) == 8


@pytest.mark.parametrize("bandwidth", sorted(
    {ClusterConfig().bandwidth, ICPConfig().cluster_bandwidth, 0.05, 0.1,
     0.02, 0.0123, 0.5}))
def test_bandwidth_terms_round_as_the_device_did(bandwidth):
    """bw^2 and the stop threshold worked out on the host equal, bit for
    bit, what the float32 tensor arithmetic gave on the device."""
    bw2, stop = bandwidth_terms(bandwidth)
    t = torch.tensor(bandwidth, dtype=torch.float32)
    assert stop == float(t * 1e-3)
    assert bw2 == float(t * t)
    assert stop == float(jnp.float32(bandwidth) * 1e-3)


def test_cuda_path_raises_on_other_devices_and_bad_shapes():
    pts = torch.zeros((2, 4, 3), device="meta")
    msk = torch.zeros((2, 4), dtype=torch.bool, device="meta")
    win = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        meanshift.shift_to_stop(pts, msk, win, 0.0064, 8e-5, 300)


def test_device_loop_range_wraps_the_launch(monkeypatch):
    """On the card each launch runs inside a ``pvn3d.meanshift.device_loop``
    range (what ``meanshift_device_loops.serve`` counts); the launch is
    faked here on meta tensors, and a shape the kernel does not take
    raises before any launch."""
    launched = []
    monkeypatch.setattr(meanshift, "require_cuda", lambda *t: t[0].device)
    monkeypatch.setattr(meanshift.KERNEL, "launch",
                        lambda dev, *a: launched.append(a[3:8]))
    pts = torch.zeros((3, 5, 3), device="meta")
    msk = torch.zeros((3, 5), dtype=torch.bool, device="meta")
    win = torch.zeros((3,), dtype=torch.int32, device="meta")
    cpu = torch.profiler.ProfilerActivity.CPU
    with torch.profiler.profile(activities=[cpu]) as p:
        c, steps = meanshift.shift_to_stop(pts, msk, win, 0.0064, 8e-5, 300)
    assert launched == [(3, 5, 0.0064, 8e-5, 300)]
    assert c.shape == (3, 3) and steps.dtype == torch.int32
    names = [e.name for e in p.events()]
    assert names.count("pvn3d.meanshift.device_loop") == 1
    with pytest.raises(ValueError, match="H, K >= 1"):
        meanshift.shift_to_stop(pts[:, :0], msk[:, :0], win, 0.0064, 8e-5,
                                300)
    with pytest.raises(ValueError, match="H, K >= 1"):
        meanshift.shift_to_stop(pts, msk[:2], win, 0.0064, 8e-5, 300)
    assert len(launched) == 1
