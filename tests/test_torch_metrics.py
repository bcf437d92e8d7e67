"""The port's pose scoring against the JAX package's: ADD and ADD-S with
padded meshes, per-frame metrics over a batch of instances, the AUC
helpers, ``PoseEvaluator``'s YCB and LineMOD summaries, the evaluation
loop, and the metrics branch of ``make_inference_step`` end to end.

ADD / ADD-S are held within 1e-5 m.  ADD-S's expanded d^2 cancels when a
predicted point nearly coincides with a GT point, so the poses here
differ from the GT by centimetres, as a pose from a network does.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pvn3d_tpu import config as jax_config
from pvn3d_tpu.geometry import metrics as jax_metrics
from pvn3d_tpu.geometry import se3 as jax_se3
from pvn3d_tpu.inference import evaluator as jax_evaluator
from pvn3d_tpu.inference import pipeline as jax_pipeline
from pvn3d_tpu.models.pvn3d import PVN3D as JaxPVN3D

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from pvn3d_tpu_torch.geometry import metrics  # noqa: E402
from pvn3d_tpu_torch.geometry import se3  # noqa: E402
from pvn3d_tpu_torch.inference import evaluator  # noqa: E402
from pvn3d_tpu_torch.inference import pipeline  # noqa: E402
from pvn3d_tpu_torch.models.pvn3d import PVN3D  # noqa: E402
from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,  # noqa: E402
                                          stacked_mesh_kps)
from tests.test_torch_slice import jax_pallas_winner  # noqa: E402,F401
from tests.test_torch_weights import (jax_and_port_weights,  # noqa: E402
                                      small_model_cfg, to_port)


def random_rotations(rng, n):
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1)], 1).astype(np.float32)


def random_poses(rng, n):
    t = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    t[:, 2] += 1.0
    return np.concatenate([random_rotations(rng, n), t[..., None]], -1)


def perturbed(rng, poses, angle=0.1, shift=0.02):
    """Poses a few degrees and centimetres off ``poses``."""
    n = poses.shape[0]
    small = random_rotations(rng, n)
    eye = np.eye(3, dtype=np.float32)
    r = eye + angle * (small - eye)
    u, _, vt = np.linalg.svd(r)
    r = (u @ vt).astype(np.float32) @ poses[:, :, :3]
    t = poses[:, :, 3] + rng.uniform(-shift, shift, (n, 3))
    return np.concatenate([r, t[..., None]], -1).astype(np.float32)


def padded_meshes(rng, n, m=700, real=(400, 700)):
    pts = rng.uniform(-0.06, 0.06, (n, m, 3)).astype(np.float32)
    valid = np.zeros((n, m), bool)
    for i in range(n):
        valid[i, :rng.randint(*real)] = True
    return pts, valid


def test_transform_points_and_compose_rt():
    rng = np.random.RandomState(0)
    poses = random_poses(rng, 4)
    pts = rng.randn(4, 50, 3).astype(np.float32)
    got = se3.transform_points(torch.tensor(poses), torch.tensor(pts))
    want = jax_se3.transform_points(jnp.asarray(poses), jnp.asarray(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    rt = se3.compose_rt(torch.tensor(poses[:, :, :3]),
                        torch.tensor(poses[:, :, 3]))
    assert torch.equal(rt, torch.tensor(poses))


@pytest.mark.parametrize("masked", [True, False])
def test_cal_add_close(masked):
    rng = np.random.RandomState(1)
    gt = random_poses(rng, 6)
    pred = perturbed(rng, gt)
    pts, valid = padded_meshes(rng, 6)
    mask = valid if masked else None
    got = metrics.cal_add(torch.tensor(pred), torch.tensor(gt),
                          torch.tensor(pts),
                          None if mask is None else torch.tensor(mask))
    want = jax_metrics.cal_add(jnp.asarray(pred), jnp.asarray(gt),
                               jnp.asarray(pts),
                               None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert (got.numpy() > 1e-3).all()


@pytest.mark.parametrize("masked,chunk", [(True, 512), (True, 96),
                                          (False, 512)])
def test_cal_adds_close(masked, chunk):
    rng = np.random.RandomState(2)
    gt = random_poses(rng, 6)
    pred = perturbed(rng, gt)
    pts, valid = padded_meshes(rng, 6)
    mask = valid if masked else None
    got = metrics.cal_adds(torch.tensor(pred), torch.tensor(gt),
                           torch.tensor(pts),
                           None if mask is None else torch.tensor(mask),
                           chunk=chunk)
    want = jax_metrics.cal_adds(jnp.asarray(pred), jnp.asarray(gt),
                                jnp.asarray(pts),
                                None if mask is None else jnp.asarray(mask),
                                chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    add = metrics.cal_add(torch.tensor(pred), torch.tensor(gt),
                          torch.tensor(pts),
                          None if mask is None else torch.tensor(mask))
    assert (got <= add + 1e-6).all()


def test_cal_adds_ignores_padded_predicted_points():
    """A padded point placed on top of every GT point must not become
    anyone's nearest predicted point."""
    rng = np.random.RandomState(3)
    gt = random_poses(rng, 2)
    pred = perturbed(rng, gt, shift=0.05)
    pts, valid = padded_meshes(rng, 2, m=300, real=(200, 201))
    pts[:, 200:] = pts[:, :100]
    args = [torch.tensor(a) for a in (pred, gt, pts, valid)]
    got = metrics.cal_adds(*args)
    trimmed = metrics.cal_adds(*(torch.tensor(a) for a in (
        pred, gt, pts[:, :200])))
    np.testing.assert_allclose(got.numpy(), trimmed.numpy(), atol=1e-6)


def frame_inputs(rng, b=2, n_cls=22, n_inst=4):
    poses = np.zeros((b, n_cls, 3, 4), np.float32)
    cls_ids = np.zeros((b, n_inst), np.int32)
    rts = np.zeros((b, n_inst, 3, 4), np.float32)
    for i in range(b):
        ids = rng.choice(np.arange(1, n_cls), n_inst - 1, replace=False)
        cls_ids[i, :n_inst - 1] = ids          # last slot empty
        rts[i] = random_poses(rng, n_inst)
        poses[i, ids] = perturbed(rng, rts[i, :n_inst - 1])
    poses[0, cls_ids[0, 0]] = 0.0              # a class never predicted
    pts, valid = padded_meshes(rng, n_cls, m=600)
    return poses, cls_ids, rts, pts, valid


def test_eval_frame_metrics_close():
    poses, cls_ids, rts, pts, valid = frame_inputs(np.random.RandomState(4))
    add, adds = evaluator.eval_frame_metrics(
        *(torch.tensor(a) for a in (poses, cls_ids, rts, pts, valid)))
    fn = jax.vmap(lambda p, c, r: jax_evaluator.eval_frame_metrics(
        p, c, r, jnp.asarray(pts), jnp.asarray(valid)))
    want_add, want_adds = fn(jnp.asarray(poses), jnp.asarray(cls_ids),
                             jnp.asarray(rts))
    assert add.shape == adds.shape == cls_ids.shape
    real = cls_ids > 0
    np.testing.assert_allclose(add.numpy()[real], np.asarray(want_add)[real],
                               atol=1e-5)
    np.testing.assert_allclose(adds.numpy()[real],
                               np.asarray(want_adds)[real], atol=1e-5)
    one_add, one_adds = evaluator.eval_frame_metrics(
        *(torch.tensor(a) for a in (poses[1], cls_ids[1], rts[1], pts,
                                    valid)))
    assert torch.equal(one_add, add[1]) and torch.equal(one_adds, adds[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auc_helpers_equal(seed):
    rng = np.random.RandomState(seed)
    d = rng.exponential(0.03, 200)
    if seed == 2:
        d = d[:0]
    assert metrics.cal_auc(d) == jax_metrics.cal_auc(d)
    assert metrics.cal_auc(d, 0.05) == jax_metrics.cal_auc(d, 0.05)
    assert (metrics.add_accuracy_at(d, 0.02)
            == jax_metrics.add_accuracy_at(d, 0.02))
    rec, prec = np.sort(d), np.linspace(0.1, 1.0, len(d))
    assert metrics.voc_ap(rec, prec) == jax_metrics.voc_ap(rec, prec)


def evaluator_pair(ds_type, n_cls, rng, n_frames=12):
    """A JAX and a port evaluator fed the same distances."""
    ports = evaluator.PoseEvaluator(n_cls=n_cls, ds_type=ds_type)
    jaxs = jax_evaluator.PoseEvaluator(n_cls=n_cls, ds_type=ds_type)
    for _ in range(n_frames):
        cls_ids = rng.randint(0, n_cls, 5)
        add = rng.exponential(0.03, 5)
        adds = add * rng.uniform(0.3, 1.0, 5)
        ports.add_frame(cls_ids, add, adds)
        jaxs.add_frame(cls_ids, add, adds)
    return ports, jaxs


def test_pose_evaluator_ycb_equal():
    ports, jaxs = evaluator_pair("ycb", 22, np.random.RandomState(5))
    assert ports.summarize() == jaxs.summarize()
    assert ports.summarize()["per_class"][13]["n"] > 0


def test_pose_evaluator_linemod_equal():
    ports, jaxs = evaluator_pair("linemod", 16, np.random.RandomState(6))
    for obj_id in (1, 10, 15):
        assert (ports.summarize_linemod(obj_id)
                == jaxs.summarize_linemod(obj_id))
    assert (ports.summarize_linemod(2, diameter_m=0.2)
            == jaxs.summarize_linemod(2, diameter_m=0.2))


@pytest.mark.parametrize("ds_type", ["ycb", "linemod"])
def test_accumulate_batches_equal(ds_type):
    """The evaluation loop on canned step outputs: a padded last batch
    (``_n_valid``), LineMOD's class-1 slots scored under ``obj_id``, and
    ``max_frames``."""
    rng = np.random.RandomState(7)
    batches = []
    for i in range(4):
        b = {"cls_ids": rng.randint(0, 3, (3, 2)).astype(np.int32),
             "add": rng.exponential(0.03, (3, 2)).astype(np.float32),
             "adds": rng.exponential(0.02, (3, 2)).astype(np.float32)}
        if i == 3:
            b["_n_valid"] = 2
        batches.append(b)

    def port_step(batch):
        return {k: torch.tensor(batch[k]) for k in ("add", "adds")}

    def jax_step(batch):
        return {k: jnp.asarray(batch[k]) for k in ("add", "adds")}
    obj_id = 4 if ds_type == "linemod" else 0
    for max_frames in (0, 5):
        ports = evaluator.PoseEvaluator(n_cls=22, ds_type=ds_type)
        jaxs = jax_evaluator.PoseEvaluator(n_cls=22, ds_type=ds_type)
        n = pipeline.accumulate_batches(port_step, batches, ports, ds_type,
                                        obj_id, max_frames=max_frames)
        assert n == jax_pipeline.accumulate_batches(
            jax_step, batches, jaxs, ds_type, obj_id, max_frames=max_frames)
        assert ports.cls_add_dis == jaxs.cls_add_dis
        assert ports.cls_adds_dis == jaxs.cls_adds_dis
    assert n == 6 and "_n_valid" in batches[3]


@pytest.fixture(scope="module")
def scored():
    """Two synthetic batches scored by JAX's make_inference_step (forward
    + poses + metrics) and JAX's evaluation loop, on the weights the port
    gets too."""
    cfg = small_model_cfg()
    variables, port_sd, _ = jax_and_port_weights(cfg, seed=31)
    cluster = dataclasses.replace(jax_config.ClusterConfig(),
                                  max_points_per_class=128)
    jcfg = jax_config.Config(model=cfg, cluster=cluster)
    rng = np.random.RandomState(31)
    mesh_pts, mesh_valid = padded_meshes(rng, cfg.n_classes, m=500)
    port_cfg = to_port(jcfg)
    batches = []
    for seed in (1, 2):
        batch = synthetic_batch(port_cfg, batch_size=2, seed=seed)
        batch["rts"] = perturbed(rng, batch["rts"].reshape(-1, 3, 4),
                                 shift=0.05).reshape(batch["rts"].shape)
        batches.append(batch)
    batches[-1]["_n_valid"] = 1
    return jcfg, variables, port_sd, mesh_pts, mesh_valid, batches


def test_inference_step_metrics_match_jax(scored, jax_pallas_winner):
    jcfg, variables, port_sd, mesh_pts, mesh_valid, batches = scored
    mesh_kps, radii = stacked_mesh_kps(), stacked_class_radii()
    jstep = jax_pipeline.make_inference_step(
        jcfg, JaxPVN3D(cfg=jcfg.model, train=False, sparse_cnn=False),
        variables, mesh_kps, radii, mesh_pts, mesh_valid)
    model = PVN3D(to_port(jcfg.model), sparse_cnn=False)
    model.load_state_dict(port_sd, strict=True)
    step = pipeline.make_inference_step(to_port(jcfg), model, mesh_kps,
                                        radii, mesh_pts, mesh_valid,
                                        device="cpu")
    jev = jax_evaluator.PoseEvaluator(n_cls=22)
    ev = evaluator.PoseEvaluator(n_cls=22)
    jbatches = [{k: (v if k == "_n_valid" else jnp.asarray(v))
                 for k, v in b.items()} for b in batches]
    for b, jb in zip(batches, jbatches):
        got = step(b)
        want = jstep({k: v for k, v in jb.items() if k != "_n_valid"})
        np.testing.assert_allclose(got["poses"].numpy(),
                                   np.asarray(want["poses"]), atol=1e-4)
        for k in ("add", "adds"):
            assert got[k].shape == b["cls_ids"].shape
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=1e-5)
    # The evaluation loop over the same batches: the same frames scored,
    # the same distances within 1e-5 m, the same summary.
    n = jax_pipeline.accumulate_batches(jstep, jbatches, jev)
    assert pipeline.accumulate_batches(step, batches, ev) == n == 3
    for got, want in ((ev.cls_add_dis, jev.cls_add_dis),
                      (ev.cls_adds_dis, jev.cls_adds_dis)):
        assert [len(x) for x in got] == [len(x) for x in want]
        np.testing.assert_allclose(np.concatenate(got[1:]),
                                   np.concatenate(want[1:]), atol=1e-5)
    summary = pipeline.evaluate_dataset(
        to_port(jcfg), model, batches, mesh_kps, radii, mesh_pts,
        mesh_valid, device="cpu")
    want = jev.summarize()
    assert summary.keys() == want.keys()
    for k in ("mean_add_auc", "mean_adds_auc", "all_add_auc",
              "all_adds_auc", "all_add_s_auc"):
        assert summary[k] == pytest.approx(want[k], abs=0.05), k
    assert ({c: v["n"] for c, v in summary["per_class"].items()}
            == {c: v["n"] for c, v in want["per_class"].items()})
