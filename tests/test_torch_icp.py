"""The port's ICP refinement against the JAX package's: pose composition,
the weighted Umeyama fit, ``icp_refine``, the biggest-cluster prefilter,
the full-resolution label propagation and class clouds, the gate, and the
ICP steps of the pipeline in both scene modes, with the evaluation loop's
``refine_fn``.

ICP matches every scene point to its nearest mesh point by JAX's expanded
d^2, |s|^2 - 2 s.m + |m|^2.  At a metre from the camera its rounding is
~1e-7 m^2, so scene points whose two nearest mesh points lie that close
in d^2 can match either, and both packages compute that sum (and the SVD
after it) in a different order.  Such flips happen in most iterations, so
the two trajectories part at the 1e-6 level and meet again at the
optimum: poses are held within 1e-4 at the end.  The error and the
iteration count are held where they are not decided by that rounding:
the error where it lies above the expanded form's noise floor (a noisy
scene; a clean scene's optimum sits at the floor, ~1e-4 m at 1 m, in both
packages), the count where the stopping test is decided by a margin
(``tolerance`` 1e-5 and 1e-6).  At the default 1e-9 the float32 stop is
decided by that rounding in both packages; a float64 numpy ICP with the
same rule is the witness of where the loop should stop.

As in ``tests/test_torch_slice.py``, JAX's winner pass is forced to its
Pallas kernel in interpret mode (``jax_pallas_winner``), so both sides
decide the prefilter's cluster with the same direct-form arithmetic.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pvn3d_tpu import config as jax_config
from pvn3d_tpu.geometry import se3 as jax_se3
from pvn3d_tpu.geometry.cloud import depth_to_cloud_map as jax_cloud_map
from pvn3d_tpu.inference import icp as jax_icp
from pvn3d_tpu.inference import pipeline as jax_pipeline
from pvn3d_tpu.inference.evaluator import PoseEvaluator as JaxEvaluator

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch import config as port_config  # noqa: E402
from pvn3d_tpu_torch.geometry import se3  # noqa: E402
from pvn3d_tpu_torch.inference import icp  # noqa: E402
from pvn3d_tpu_torch.inference import pipeline  # noqa: E402
from pvn3d_tpu_torch.inference.evaluator import PoseEvaluator  # noqa: E402
from tests.test_icp import _problem  # noqa: E402
from tests.test_torch_metrics import (perturbed,  # noqa: E402
                                      random_rotations)
from tests.test_torch_slice import jax_pallas_winner  # noqa: E402,F401

T = torch.as_tensor


def _stack(probs):
    return [np.stack(x) for x in zip(*[p[:5] for p in probs])]


def test_compose_poses_matches_jax():
    rng = np.random.RandomState(0)
    a = np.concatenate([random_rotations(rng, 5),
                        rng.randn(5, 3, 1).astype(np.float32)], -1)
    b = np.concatenate([random_rotations(rng, 5),
                        rng.randn(5, 3, 1).astype(np.float32)], -1)
    got = icp.compose_poses(T(a), T(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_icp.compose_poses(a, b)),
                               atol=1e-6)
    pts = rng.randn(4, 3).astype(np.float32)
    lhs = se3.transform_points(T(got[0]), T(pts))
    rhs = se3.transform_points(T(a[0]), se3.transform_points(T(b[0]),
                                                             T(pts)))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-5)


@pytest.mark.parametrize("kind", ["uniform", "weighted", "zeros"])
def test_best_fit_transform_weights_match_jax(kind):
    """Weighted Umeyama: zero-weight rows ignored (they hold garbage
    here), weights normalised by max(sum, 1e-12); all-zero weights give
    the SVD's rotation of a zero matrix and a zero translation, in both
    packages.  Within 1e-5."""
    rng = np.random.RandomState(1)
    src = rng.uniform(-0.1, 0.1, (3, 40, 3)).astype(np.float32)
    gt = np.concatenate([random_rotations(rng, 3),
                         rng.uniform(-0.2, 0.2, (3, 3, 1))], -1
                        ).astype(np.float32)
    dst = np.einsum("bij,bnj->bni", gt[..., :3], src) + gt[:, None, :, 3]
    dst = dst.astype(np.float32)
    w = None
    if kind != "uniform":
        w = (rng.rand(3, 40) < 0.6).astype(np.float32) * (
            rng.rand(3, 40).astype(np.float32) + 0.5)
        dst = np.where(w[..., None] > 0, dst, 50.0).astype(np.float32)
        if kind == "zeros":
            w[1] = 0.0
    got = se3.best_fit_transform(T(src), T(dst),
                                 None if w is None else T(w)).numpy()
    want = np.asarray(jax_se3.best_fit_transform(src, dst, weights=w))
    np.testing.assert_allclose(got, want, atol=1e-5)
    if kind == "zeros":
        np.testing.assert_allclose(got[1, :, 3], 0.0, atol=1e-7)
        np.testing.assert_allclose(got[[0, 2]], gt[[0, 2]], atol=1e-4)


@pytest.mark.parametrize("jitter,tolerance,max_iter", [
    (0.0, 1e-5, 500), (0.002, 1e-6, 500), (0.002, 1e-9, 100)])
def test_icp_refine_matches_jax(jitter, tolerance, max_iter):
    """``tests/test_icp.py``'s problems (three, padded; clean or with 2 mm
    noise): poses within 1e-4 of JAX's and the same iteration count
    (stopping decided by a margin, or the cap); the error within 1e-5 on
    the noisy scenes, and under the 1e-4 m noise floor on the clean
    ones."""
    n = 3 if jitter == 0.0 else 2
    args = _stack([_problem(s, jitter=jitter) for s in range(n)])
    want = jax_icp.icp_refine(*args, max_iter=max_iter,
                              tolerance=tolerance)
    poses, err, n_iter = icp.icp_refine(*map(T, args), max_iter=max_iter,
                                        tolerance=tolerance)
    np.testing.assert_allclose(poses.numpy(), np.asarray(want[0]),
                               atol=1e-4)
    np.testing.assert_array_equal(n_iter.numpy(), np.asarray(want[2]))
    assert n_iter.dtype == torch.int32 and n_iter.shape == (n,)
    if jitter:
        np.testing.assert_allclose(err.numpy(), np.asarray(want[1]),
                                   atol=1e-5)
    else:
        assert float(err.max()) < 1e-4 and float(want[1].max()) < 1e-4
        assert int(n_iter[0]) < max_iter


def _icp_float64(mesh, mesh_valid, scene, scene_valid, init, max_iter=500,
                 tolerance=1e-9):
    """The loop of ``icp_refine`` in float64 numpy, one problem at a time:
    direct-form d^2, first argmin, a weighted Umeyama fit with the
    reflection fix, the same per-problem stopping rule and shared count.
    Returns (poses, n_iter)."""
    pose = init.astype(np.float64)
    prev, err = np.zeros(len(mesh)), np.zeros(len(mesh))
    active, n_iter = np.ones(len(mesh), bool), 0
    while n_iter < max_iter and active.any():
        for i in np.flatnonzero(active):
            m = mesh[i][mesh_valid[i]].astype(np.float64)
            s = scene[i].astype(np.float64)
            w = scene_valid[i].astype(np.float64)
            src = m @ pose[i, :, :3].T + pose[i, :, 3]
            d2 = ((s[:, None] - src[None]) ** 2).sum(-1)
            near = d2.argmin(1)
            err[i] = (np.sqrt(d2[np.arange(len(s)), near]) * w).sum() / max(
                w.sum(), 1e-9)
            wn = w / max(w.sum(), 1e-12)
            cs, cd = wn @ src[near], wn @ s
            u, _, vt = np.linalg.svd((src[near] - cs).T
                                     @ ((s - cd) * wn[:, None]))
            flip = np.diag([1.0, 1.0, np.sign(np.linalg.det(vt.T @ u.T))])
            r = vt.T @ flip @ u.T
            t = r @ pose[i, :, 3] + cd - r @ cs
            pose[i] = np.concatenate([r @ pose[i, :, :3], t[:, None]], 1)
        active &= np.abs(prev - err) >= np.maximum(tolerance, err * 1.2e-7)
        prev = err.copy()
        n_iter += 1
    return pose, n_iter


@pytest.mark.parametrize("jitter", [0.0, 0.002])
def test_default_tolerance_against_float64_witness(jitter):
    """At the default tolerance (1e-9) the shared iteration count is
    decided by float32 rounding: a float64 ICP with the same rule stops
    after ``n64`` (14) iterations; in float32 the error keeps moving by
    more than 1e-9 from near-tie flips, so the port runs on (clean scenes
    50, JAX 18; noisy ones to the cap, 500, in both packages).  Held: the
    port never stops before the witness, both packages' poses lie within
    1e-4 of the witness's, and the port's pose after ``n64`` iterations
    lies within 1e-5 of it: the iterations past the witness's stop bring
    it no closer, at up to ``max_iter / n64`` times the work
    (``ROADMAP.md`` queue C)."""
    n = 3 if jitter == 0.0 else 2
    args = _stack([_problem(s, jitter=jitter) for s in range(n)])
    want, n64 = _icp_float64(*args)
    assert n64 <= 20
    poses, _, n_iter = icp.icp_refine(*map(T, args))
    jax_poses, _, jax_n = jax_icp.icp_refine(*args)
    assert n64 <= int(n_iter[0]) <= 500 and n64 <= int(jax_n[0]) <= 500
    if jitter:
        assert int(n_iter[0]) == int(jax_n[0]) == 500
    np.testing.assert_allclose(poses.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(np.asarray(jax_poses), want, atol=1e-4)
    at_stop = icp.icp_refine(*map(T, args), max_iter=n64)[0]
    np.testing.assert_allclose(at_stop.numpy(), want, atol=1e-5)


def test_empty_problem_does_not_pin_batch():
    """A problem with no valid scene point goes inactive after one
    iteration: a mixed [empty, real] batch stops when the real problem
    alone does, and an all-empty batch after one iteration (JAX's
    ``test_empty_problem_does_not_pin_batch_at_max_iter``)."""
    mesh_p, mesh_v, scene_p, scene_v, init, _ = _problem(0)

    def run(valids):
        k = len(valids)
        return icp.icp_refine(
            T(np.stack([mesh_p] * k)), T(np.stack([mesh_v] * k)),
            T(np.stack([scene_p] * k)), T(np.stack(valids)),
            T(np.stack([init] * k)), max_iter=100)
    solo = run([scene_v])
    mixed = run([scene_v, np.zeros_like(scene_v)])
    assert int(mixed[2][0]) == int(solo[2][0]) < 100
    assert torch.equal(mixed[0][0], solo[0][0])
    empty = run([np.zeros_like(scene_v)])
    want = jax_icp.icp_refine(mesh_p[None], mesh_v[None], scene_p[None],
                              np.zeros_like(scene_v)[None], init[None],
                              max_iter=100)
    assert int(empty[2][0]) == int(want[2][0]) == 1
    assert float(empty[1][0]) == 0.0


@pytest.mark.parametrize("h,k", [(3, 300), (2, 2000)])
def test_biggest_cluster_mask_matches_jax(h, k, jax_pallas_winner):
    """The prefilter's labels equal JAX's bit for bit, at the ICP shape's
    K = 2000 and at a small one: two clusters and scatter per row, ~70%
    valid."""
    rng = np.random.RandomState(h)
    pts = rng.uniform(-0.3, 0.3, (h, k, 3)).astype(np.float32)
    for i in range(h):
        a, b = int(0.5 * k), int(0.75 * k)
        pts[i, :a] = rng.normal([0, 0, 1], 0.02, (a, 3))
        pts[i, a:b] = rng.normal([0.1, 0.05, 1.1], 0.02, (b - a, 3))
    pts = pts.astype(np.float32)
    valid = rng.rand(h, k) < 0.7
    got = icp.biggest_cluster_mask(T(pts), T(valid))
    want = np.asarray(jax_icp.biggest_cluster_mask(pts, valid,
                                                   bandwidth=0.06))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:, :k // 2].sum() > want[:, k // 2:].sum()


def test_biggest_cluster_mask_keeps_the_big_cluster():
    rng = np.random.RandomState(0)
    a = rng.normal([0, 0, 1], 0.01, (80, 3)).astype(np.float32)
    b = rng.normal([1, 1, 2], 0.01, (20, 3)).astype(np.float32)
    m = icp.biggest_cluster_mask(T(np.concatenate([a, b])[None]),
                                 torch.ones(1, 100, dtype=torch.bool))
    assert bool(m[0, :80].all()) and not bool(m[0, 80:].any())


def _propagate_both(cloud, valid, samples, labels, chunk):
    got = icp.propagate_labels_fullres(T(cloud), T(valid), T(samples),
                                       T(labels), chunk=chunk).numpy()
    want = np.asarray(jax_icp.propagate_labels_fullres(
        jnp.asarray(cloud), jnp.asarray(valid), jnp.asarray(samples),
        jnp.asarray(labels), chunk=chunk))
    return got, want


def test_propagate_labels_equal_on_separated_clouds():
    """Samples in separated blobs, pixels around them: equal labels, 0
    where invalid, over a last chunk shorter than the others."""
    rng = np.random.RandomState(0)
    centers = rng.uniform(-0.5, 0.5, (6, 3)).astype(np.float32)
    centers[:, 2] += 1.0
    samples = (np.repeat(centers, 30, 0)
               + rng.normal(0, 0.005, (180, 3))).astype(np.float32)
    labels = np.repeat(np.arange(1, 7), 30).astype(np.int32)
    cloud = (np.repeat(centers, 170, 0)
             + rng.normal(0, 0.01, (1020, 3))).astype(np.float32)
    valid = rng.rand(1020) > 0.1
    got, want = _propagate_both(cloud, valid, samples, labels, chunk=256)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and (got[~valid] == 0).all()
    assert (got[valid] == np.repeat(np.arange(1, 7), 170)[valid]).all()


def test_propagate_labels_differ_only_at_near_ties():
    """Random clouds a metre from the camera: every label that differs
    from JAX's comes from two samples whose float64 d^2 to the pixel agree
    within the expanded form's float32 rounding (8 ulps of |p|^2 +
    |s|^2)."""
    rng = np.random.RandomState(1)
    cloud = rng.uniform(-0.4, 0.4, (6000, 3)).astype(np.float32)
    cloud[:, 2] += 1.0
    samples = rng.uniform(-0.4, 0.4, (800, 3)).astype(np.float32)
    samples[:, 2] += 1.0
    labels = rng.randint(0, 22, 800).astype(np.int32)
    valid = np.ones(6000, bool)
    got, want = _propagate_both(cloud, valid, samples, labels, chunk=4096)
    c64, s64 = cloud.astype(np.float64), samples.astype(np.float64)
    d2 = ((c64[:, None, :] - s64[None]) ** 2).sum(-1)
    best = d2.argmin(1)
    ulp = 8 * np.finfo(np.float32).eps * (
        (c64 ** 2).sum(1) + (s64[best] ** 2).sum(1))
    # Each side picks a sample within rounding of the true nearest one.
    for lab in (got, want):
        ok = labels[best] == lab
        near = np.array([
            (d2[i][labels == lab[i]].min() - d2[i, best[i]]) <= ulp[i]
            for i in np.flatnonzero(~ok)], bool)
        assert near.all()
    assert (got == want).mean() > 0.99


def _render(seed, h=40, w=50, half=0.025, n_mesh=400):
    """A depth map of two small boxes (classes 1 and 2, random point
    meshes seen through a z-buffer) in front of a plane at 1.3 m, its
    intrinsics, label map, meshes and GT poses."""
    rng = np.random.RandomState(seed)
    cam_k = np.array([[300.0, 0, w / 2], [0, 300.0, h / 2], [0, 0, 1]],
                     np.float32)
    meshes = rng.uniform(-half, half, (2, n_mesh, 3)).astype(np.float32)
    gt = np.concatenate([random_rotations(rng, 2), np.array(
        [[[-0.05], [0.0], [1.0]], [[0.05], [0.01], [1.05]]])], -1
    ).astype(np.float32)
    depth = np.full((h, w), 1.3, np.float32)
    label_map = np.zeros((h, w), np.int32)
    for c in range(2):
        p = meshes[c] @ gt[c, :, :3].T + gt[c, :, 3]
        u = np.round(p[:, 0] / p[:, 2] * cam_k[0, 0] + cam_k[0, 2])
        v = np.round(p[:, 1] / p[:, 2] * cam_k[1, 1] + cam_k[1, 2])
        for i in np.argsort(-p[:, 2]):
            if 0 <= u[i] < w and 0 <= v[i] < h and p[i, 2] < depth[
                    int(v[i]), int(u[i])]:
                depth[int(v[i]), int(u[i])] = p[i, 2]
                label_map[int(v[i]), int(u[i])] = c + 1
    depth[rng.rand(h, w) < 0.05] = 0.0
    return depth, cam_k, label_map, meshes, gt


def _scene_frame(seed=0, n_points=2048):
    """``_render`` as a network's output would give it: every pixel as a
    sampled point (the first ones repeated up to ``n_points``), the label
    map as the predicted classes, 22-class meshes and initial poses a few
    degrees and centimetres off the GT."""
    depth, cam_k, label_map, meshes, gt = _render(seed)
    cloud = np.asarray(jax_cloud_map(jnp.asarray(depth), jnp.asarray(cam_k),
                                     1.0)[0]).reshape(-1, 3)
    sel = np.arange(n_points) % cloud.shape[0]
    pcld = cloud[sel][None]
    seg = label_map.reshape(-1)[sel][None].astype(np.int32)
    mesh_pts = np.zeros((22, meshes.shape[1], 3), np.float32)
    mesh_pts[1:3] = meshes
    mesh_valid = np.zeros((22, meshes.shape[1]), bool)
    mesh_valid[1:3] = True
    poses = np.zeros((1, 22, 3, 4), np.float32)
    poses[0, 1:3] = perturbed(np.random.RandomState(seed + 1), gt,
                              angle=0.05, shift=0.005)
    return dict(depth=depth[None], cam_k=cam_k[None], pcld=pcld, seg=seg,
                mesh_pts=mesh_pts, mesh_valid=mesh_valid, poses=poses,
                gt=gt, label_map=label_map[None])


def _jax_priorities(p):
    return np.array(jax.random.uniform(jax.random.PRNGKey(0), (p,),
                                       jnp.float32, 1e-3, 1.0))


@pytest.mark.parametrize("use_label_map", [False, True])
def test_fullres_class_clouds_match_jax(use_label_map):
    """With JAX's own priority draw passed in: scene clouds, validity and
    full-res counts identical, padded slots included, through the 1-NN
    propagation or the GT label map; class 3 and up empty."""
    f = _scene_frame()
    depth, cam_k = f["depth"][0], f["cam_k"][0]
    lm = f["label_map"][0] if use_label_map else None
    want = jax.jit(lambda d, k, sc, sl, m: jax_icp.fullres_class_clouds(
        d, k, sc, sl, 22, 150, label_map=m))(
        depth, cam_k, f["pcld"][0], f["seg"][0], lm)
    got = icp.fullres_class_clouds(
        T(depth), T(cam_k), T(f["pcld"][0]), T(f["seg"][0]), 22, 150,
        label_map=None if lm is None else T(lm),
        priorities=T(_jax_priorities(depth.size)))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    counts = got[2].numpy()
    assert min(counts[:2]) > 150 and (counts[2:] == 0).all()
    assert got[2].dtype == torch.int32


def test_fixed_priorities_are_one_draw():
    p = icp._fixed_priorities(1000, torch.device("cpu"))
    assert p is icp._fixed_priorities(1000, torch.device("cpu"))
    assert float(p.min()) >= 1e-3 and float(p.max()) < 1.0
    assert len(torch.unique(p)) > 990


@pytest.mark.parametrize("with_counts", [False, True])
def test_refine_frame_poses_gate(with_counts, jax_pallas_winner):
    """The gate on the valid count before the cluster filter, or on
    ``gate_counts``: the problem below ``min_points`` keeps its initial
    pose exactly, the other is refined as JAX refines it (within
    1e-4)."""
    probs = [_problem(s) for s in (0, 3)]
    mesh, mesh_v, scene, scene_v, init = _stack(probs)
    scene_v[1, 200:] = False                 # 200 of 300 points
    counts = np.array([600, 400], np.int32) if with_counts else None
    kw = dict(min_points=500 if with_counts else 250)
    want = jax_icp.refine_frame_poses(
        init, mesh, mesh_v, scene, scene_v, gate_counts=counts, **kw)
    got = icp.refine_frame_poses(
        *map(T, (init, mesh, mesh_v, scene, scene_v)),
        gate_counts=None if counts is None else T(counts), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4)
    np.testing.assert_array_equal(got[0][1].numpy(), init[1])
    assert np.abs(got[0][0].numpy() - init[0]).max() > 1e-3


def _icp_cfg(**icp_kw):
    """``small_model_config`` with the ICP scene cap and gate lowered so
    the rendered boxes (~190 valid pixels each) pass, subsampled, and the
    stopping tolerance raised to 1e-7 m: at 1e-9 these pixel-quantised
    scenes jitter by rounding up to the 500-iteration cap (the poses
    agree as well there, within 6e-6, in five times the time)."""
    kw = dict(max_scene_points=128, min_class_points=100, tolerance=1e-7)
    kw.update(icp_kw)
    port = port_config.Config(model=port_config.small_model_config(),
                              icp=port_config.ICPConfig(**kw))
    jcfg = jax_config.Config(icp=jax_config.ICPConfig(**kw))
    return port, jcfg


@pytest.mark.parametrize("mode", ["sampled", "fullres"])
def test_icp_step_matches_jax(mode, jax_pallas_winner, monkeypatch):
    """``make_icp_step`` against JAX's on a rendered two-box frame, in both
    scene modes (full-res with JAX's priority draw in place of the port's
    fixed one): background row and the
    empty classes unchanged, the two boxes refined toward the GT, poses
    within 1e-4."""
    f = _scene_frame()
    port_cfg, jcfg = _icp_cfg()
    extra = () if mode == "sampled" else (f["depth"], f["cam_k"])
    want = np.asarray(jax_pipeline.make_icp_step(
        jcfg, f["mesh_pts"], f["mesh_valid"])(
        f["pcld"], f["seg"], f["poses"], *extra))
    pri = T(_jax_priorities(f["depth"][0].size))
    monkeypatch.setattr(icp, "_fixed_priorities", lambda p, device: pri)
    step = pipeline.make_icp_step(port_cfg, f["mesh_pts"], f["mesh_valid"],
                                  device="cpu")
    got = step(f["pcld"], f["seg"], f["poses"], *extra)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_array_equal(got[0, 3:].numpy(), f["poses"][0, 3:])
    np.testing.assert_array_equal(got[0, 0].numpy(), f["poses"][0, 0])
    before = np.abs(f["poses"][0, 1:3] - f["gt"]).max()
    assert np.abs(got[0, 1:3].numpy() - f["gt"]).max() < before


def test_icp_step_batches_frames_as_one_loop_each():
    """Two frames refined in one batch (both against frame a's meshes)
    give each frame's poses of a call on that frame alone, bit for bit (a
    stopped problem keeps its pose; the cap, 40, ends the call either
    way)."""
    a, b = _scene_frame(0), _scene_frame(5)
    step = pipeline.make_icp_step(_icp_cfg(max_iter=40)[0], a["mesh_pts"],
                                  a["mesh_valid"], device="cpu")
    both = step(np.concatenate([a["pcld"], b["pcld"]]),
                np.concatenate([a["seg"], b["seg"]]),
                np.concatenate([a["poses"], b["poses"]]))
    assert torch.equal(both[:1], step(a["pcld"], a["seg"], a["poses"]))
    assert torch.equal(both[1:], step(b["pcld"], b["seg"], b["poses"]))


def _refine_inputs(f):
    """GT slots for the two boxes and an empty one.  The slots' poses lie
    centimetres off the rendered ones: refined poses land within ~0.1 mm
    of those, where ADD-S's expanded d^2 is rounding noise
    (``tests/test_torch_metrics.py``)."""
    cls_ids = np.array([[1, 2, 0]], np.int32)
    rts = np.tile(np.eye(3, 4, dtype=np.float32), (1, 3, 1, 1))
    rts[0, :2] = perturbed(np.random.RandomState(9), f["gt"], shift=0.03)
    return cls_ids, rts


def test_icp_refine_fn_matches_jax(jax_pallas_winner):
    """The scene in the reference's order, over a run of calls on one
    closure: the raw step's ``depth_m`` before the batch's ``depth`` (here
    a wrong one, to show it is not read), then the batch's ``depth``,
    then -- with the warning, once for two calls in a row -- the sampled
    cloud, then full-res again, and the warning again when the sampled
    cloud returns; ``mode`` says which; ADD / ADD-S of the refined poses
    within 1e-4 m of JAX's, the poses' tolerance.  The scene cap (300)
    exceeds every class's pixels, so the subset does not depend on the
    priorities; its order does (the port's fixed draw is not JAX's), and
    with it the sums' rounding."""
    f = _scene_frame()
    port_cfg, jcfg = _icp_cfg(max_scene_points=300)
    cls_ids, rts = _refine_inputs(f)
    base = {"pointcloud": f["pcld"], "cls_ids": cls_ids, "rts": rts,
            "cam_k": f["cam_k"]}
    scenes = {"depth_m": ({"depth": np.full_like(f["depth"], 0.5)},
                          {"depth_m": f["depth"]}),
              "depth": ({"depth": f["depth"]}, {}),
              "sampled": ({}, {})}
    warned, jwarned = [], []
    fn = pipeline.make_icp_refine_fn(port_cfg, f["mesh_pts"],
                                     f["mesh_valid"], warn=warned.append,
                                     device="cpu")
    jfn = jax_pipeline.make_icp_refine_fn(jcfg, f["mesh_pts"],
                                          f["mesh_valid"],
                                          warn=jwarned.append)
    assert fn.mode is None
    run = ["depth_m", "depth", "sampled", "sampled", "depth_m", "sampled"]
    for n, scene in enumerate(run):
        extra_batch, extra_out = scenes[scene]
        batch = dict(base, **extra_batch)
        out = dict({"poses": f["poses"], "seg": f["seg"]}, **extra_out)
        add, adds = fn(batch, {k: T(v) for k, v in out.items()})
        jadd, jadds = jfn(batch, {k: jnp.asarray(v) for k, v in out.items()})
        np.testing.assert_allclose(add.numpy(), np.asarray(jadd), atol=1e-4)
        np.testing.assert_allclose(adds.numpy(), np.asarray(jadds),
                                   atol=1e-4)
        assert fn.mode == jfn.mode == ("sampled" if scene == "sampled"
                                       else "fullres")
        assert warned == jwarned
        assert len(warned) == [0, 0, 1, 1, 1, 2][n]


def test_accumulate_batches_with_refine_fn_matches_jax(jax_pallas_winner):
    """The evaluation loop with ``refine_fn``: each batch's ADD / ADD-S
    replaced by the refined poses' before they reach the evaluator, as
    JAX's loop does; distances within 1e-4 m."""
    frames = [_scene_frame(0), _scene_frame(5)]
    port_cfg, jcfg = _icp_cfg(max_scene_points=300)
    batches = []
    for f in frames:
        cls_ids, rts = _refine_inputs(f)
        batches.append({"pointcloud": f["pcld"], "cls_ids": cls_ids,
                        "rts": rts, "cam_k": f["cam_k"],
                        "depth": f["depth"], "poses": f["poses"],
                        "seg": f["seg"]})

    def port_step(batch):
        return {"poses": T(batch["poses"]), "seg": T(batch["seg"]),
                "add": torch.zeros(1, 3), "adds": torch.zeros(1, 3)}

    def jax_step(batch):
        return {"poses": jnp.asarray(batch["poses"]),
                "seg": jnp.asarray(batch["seg"]),
                "add": jnp.zeros((1, 3)), "adds": jnp.zeros((1, 3))}
    mesh = (frames[0]["mesh_pts"], frames[0]["mesh_valid"])
    ev, jev = PoseEvaluator(n_cls=22), JaxEvaluator(n_cls=22)
    n = pipeline.accumulate_batches(
        port_step, batches, ev,
        refine_fn=pipeline.make_icp_refine_fn(port_cfg, *mesh,
                                              device="cpu"))
    assert n == jax_pipeline.accumulate_batches(
        jax_step, batches, jev,
        refine_fn=jax_pipeline.make_icp_refine_fn(jcfg, *mesh)) == 2
    for got, want in ((ev.cls_add_dis, jev.cls_add_dis),
                      (ev.cls_adds_dis, jev.cls_adds_dis)):
        assert [len(x) for x in got] == [len(x) for x in want]
        np.testing.assert_allclose(np.array(got[0]), np.array(want[0]),
                                   atol=1e-4)
    assert min(ev.cls_add_dis[0]) > 0.005
