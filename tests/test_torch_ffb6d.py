"""FFB6D on the port's serving path, held against the benchmark's plain
reference (``perfbench/reference/ffb6d.py``, the literal published graph
in float32 with brute-force searches) on seeded random weights, at a
small size: a 64x80 frame and 1280 points, so every level the forward
searches keeps at least 16 points and every width is the published one.

The k-NN search's plain twin is held against an independent brute force
(numpy, lexicographic (d^2, index) order); the CUDA kernel against the
plain twin where a card is present."""
import dataclasses

import numpy as np
import pytest
import torch

from perfbench.reference import ffb6d as rffb6d
from perfbench.reference import pose as rpose
from pvn3d_tpu_torch.apps import serve
from pvn3d_tpu_torch.config import (ClusterConfig, Config, DatasetConfig,
                                    ffb6d_config, small_ffb6d_config)
from pvn3d_tpu_torch.data.device_frame import build_inference_batch_device
from pvn3d_tpu_torch.data.ffb6d_index import build_index, searches
from pvn3d_tpu_torch.data.synthetic import synth_sensor_frame
from pvn3d_tpu_torch.inference.pipeline import (make_inference_step,
                                                make_raw_inference_step)
from pvn3d_tpu_torch.models.ffb6d import FFB6D
from pvn3d_tpu_torch.models.resnet import DilatedResNet
from pvn3d_tpu_torch.ops.kernels import KERNELS, KNN_KERNELS
from pvn3d_tpu_torch.ops.kernels import knn as knn_kernel
from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,
                                          stacked_mesh_kps)
from pvn3d_tpu_torch.utils.weights import build_model

torch.set_num_threads(2)

# Float32 forwards, program against reference: the same operations in
# other groupings (the split p2r product, the sparse tail's patch conv,
# channels-last products against NCHW convs) over a 60-layer graph whose
# random-weight outputs reach ~30; measured gaps are ~4e-5, 1e-5 of the
# largest output, so 1e-4 of it leaves room and still catches one wrong
# layer (a wrong layer moves the outputs by their own size).
REL_TOL = 1e-4


def _small_cfg() -> Config:
    mc = small_ffb6d_config()
    return Config(dataset=DatasetConfig(name="ycb",
                                        n_sample_points=mc.n_sample_points),
                  model=mc,
                  cluster=dataclasses.replace(ClusterConfig(),
                                              max_points_per_class=128))


def _frame(seed: int = 2, b: int = 1):
    """A raw frame at the small size, the YCB camera scaled to it."""
    mc = small_ffb6d_config()
    h, w = mc.image_height, mc.image_width
    frames = [synth_sensor_frame(h, w, seed=seed + i) for i in range(b)]
    rgb, depth, k = (np.concatenate(x) for x in zip(*frames))
    k = k.copy()
    k[:, 0, 2], k[:, 1, 2] = w / 2, h / 2
    k[:, :2, :2] *= 0.2
    prio = torch.rand((b, h * w), generator=torch.Generator().manual_seed(
        seed)) * (1 - 1e-4) + 1e-4
    return rgb, depth, k, prio


@pytest.fixture(scope="module")
def served():
    """One raw request through the serving step with FFB6D on the CPU,
    the forward's outputs and the model."""
    cfg = _small_cfg()
    model = build_model(cfg.model, 5)
    fwd = {}
    model.register_forward_hook(lambda _m, _a, o: fwd.update(o))
    rgb, depth, k, prio = _frame()
    step = make_raw_inference_step(cfg, model, stacked_mesh_kps(),
                                   stacked_class_radii(), device="cpu")
    out = step({"rgb": rgb, "depth": depth, "cam_k": k}, priorities=prio)
    return {"cfg": cfg, "model": model, "out": out, "fwd": dict(fwd),
            "frame": (rgb, depth, k, prio)}


# -- the k-NN search ---------------------------------------------------------

def _brute(query, cand, k):
    """numpy: each query's k first candidates in (d^2, index) order, d^2
    in the direct float32 form; C < k repeats the nearest."""
    q = query.astype(np.float32)
    c = cand.astype(np.float32)
    b, nq, _ = q.shape
    out = np.zeros((b, nq, k), np.int64)
    for bi in range(b):
        diff = q[bi][:, None, :] - c[bi][None, :, :]
        d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
            + diff[..., 2] * diff[..., 2]
        for i in range(nq):
            order = np.lexsort((np.arange(c.shape[1]), d2[i]))[:k]
            if len(order) < k:
                order = np.concatenate([order, np.repeat(order[:1],
                                                         k - len(order))])
            out[bi, i] = order
    return out


def _cases():
    rng = np.random.RandomState(0)
    grid = np.stack(np.meshgrid(np.arange(5), np.arange(5), np.arange(3),
                                indexing="ij"), -1).reshape(1, -1, 3)
    return {
        # Q and C not multiples of a block (128) or a tile (1024).
        "ragged": (rng.rand(2, 137, 3), rng.rand(2, 1043, 3)),
        # Integer grids: many candidates at equal distances.
        "ties": (grid[:, ::3] + 0.5 * (rng.rand(1, 25, 3) > 0.5),
                 np.concatenate([grid, grid[:, :7]], 1)),
        # Holes at the origin, as a cloud map has them.
        "holes": (rng.rand(1, 40, 3), np.concatenate(
            [np.zeros((1, 30, 3)), rng.rand(1, 50, 3)], 1)),
        # Fewer candidates than 16: the rest repeat the nearest.
        "padded": (rng.rand(1, 33, 3), rng.rand(1, 5, 3)),
    }


@pytest.mark.parametrize("case", ["ragged", "ties", "holes", "padded"])
@pytest.mark.parametrize("k", [1, 16])
def test_knn_plain_matches_brute_force(case, k):
    q, c = _cases()[case]
    got = knn_kernel.knn(torch.tensor(q, dtype=torch.float32),
                      torch.tensor(c, dtype=torch.float32), k)
    assert got.dtype == torch.int32 and got.shape == q.shape[:2] + (k,)
    np.testing.assert_array_equal(got.numpy(), _brute(q, c, k))


@pytest.mark.parametrize("k", [1, 16])
def test_knn_kernel_matches_plain_on_card(k):
    """The kernel, index for index, at each test case (on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    for q, c in _cases().values():
        q = torch.tensor(q, dtype=torch.float32, device="cuda")
        c = torch.tensor(c, dtype=torch.float32, device="cuda")
        want = knn_kernel.knn_plain(q, c, k)
        assert torch.equal(knn_kernel.knn(q, c, k), want)


def test_knn_wrapper_rules():
    q = torch.rand(1, 8, 3)
    with pytest.raises(ValueError, match="k must be"):
        knn_kernel.knn(q, q, 3)
    with pytest.raises(ValueError, match="takes"):
        knn_kernel.knn(q[..., :2], q, 1)
    with pytest.raises(ValueError, match="no candidates"):
        knn_kernel.knn(q, q[:, :0], 1)
    assert knn_kernel.knn(q[:, :0], q, 16).shape == (1, 0, 16)
    assert set(KNN_KERNELS).isdisjoint(KERNELS)
    assert [k.name for k in KNN_KERNELS] == ["knn"]


def test_knn_segments_fill_the_card():
    """A launch with few queries splits the candidates; one with enough
    queries, or too few candidates, does not."""
    assert knn_kernel.segments(1, 76800, 3200) == 1
    assert knn_kernel.segments(1, 3200, 76800) == 1
    s = knn_kernel.segments(1, 800, 76800)
    assert 1 < s and 100 * s >= 2 * 132 and 76800 // s >= 4096
    assert knn_kernel.segments(1, 200, 76800) > 1
    assert knn_kernel.segments(1, 50, 4800) == 1
    assert knn_kernel.segments(2, 800, 76800) < s


# -- the frame build and the index ---------------------------------------------

def test_ffb6d_sample_is_the_pvn3d_selection_in_priority_order():
    rgb, depth, k, prio = _frame()
    args = (torch.tensor(rgb), torch.tensor(depth), torch.tensor(k), 1280)
    pvn = build_inference_batch_device(*args, priorities=prio)
    ffb = build_inference_batch_device(*args, priorities=prio,
                                       priority_order=True)
    assert ffb["cloud_map"].shape == (1, 64, 80, 3)
    assert torch.equal(ffb["cloud_map"], pvn["cloud_map"])
    c_pvn, c_ffb = pvn["choose"][0].long(), ffb["choose"][0].long()
    assert torch.all(c_pvn[1:] > c_pvn[:-1])                 # ascending
    assert torch.equal(torch.sort(c_ffb).values, c_pvn)       # same set
    p = prio[0][c_ffb]
    assert torch.all(p[1:] <= p[:-1])                         # by priority
    order = torch.argsort(c_ffb)
    assert torch.equal(ffb["pointcloud"][0][order], pvn["pointcloud"][0])


def test_index_sets_equal_the_reference(served):
    """All 22 searches, index for index, against the reference's brute
    force on the request's own points and maps."""
    out = served["out"]
    idx = out["index"]
    mc = served["cfg"].model
    todo, _, _ = searches(idx["xyz"][0], torch.zeros(1, 64, 80, 3), mc)
    assert len(todo) == 22
    ref = rffb6d.index(idx["xyz"][0], idx["maps"], dataclasses.asdict(mc))
    n = 0
    for name in ("nei", "sub", "interp", "r2p_ds", "p2r_ds", "r2p_up",
                 "p2r_up"):
        assert len(idx[name]) == len(ref[name])
        for got, want in zip(idx[name], ref[name]):
            np.testing.assert_array_equal(got.long().numpy(), want.numpy())
            n += 1
    assert n == 22 + 4
    sizes = [t.shape[1] for t in idx["xyz"]]
    assert sizes == [1280, 320, 80, 20, 5]
    assert min(t.shape[1] for t in idx["nei"]) >= 16


def test_build_matches_the_reference_build(served):
    rgb, depth, k, prio = served["frame"]
    cloud, choose, cloud_map = rffb6d.build(
        torch.tensor(rgb), torch.tensor(depth), torch.tensor(k), prio, 1280,
        1.0, True)
    out = served["out"]
    np.testing.assert_array_equal(out["choose"].long().numpy(),
                                  choose.numpy())
    np.testing.assert_allclose(out["pointcloud"].numpy(), cloud.numpy(),
                               atol=1e-5)
    maps = rffb6d.strided_maps(cloud_map, (2, 4, 8))
    for s, m in maps.items():
        np.testing.assert_allclose(out["index"]["maps"][s].numpy(),
                                   m.numpy(), atol=1e-5)


# -- the forward -------------------------------------------------------------------

def _close(got, want, what):
    scale = float(want.abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= REL_TOL * scale, f"{what}: {err} against {scale}"


def _reference(served, low_precision=False):
    out = served["out"]
    mc = served["cfg"].model
    ref_idx = rffb6d.index(out["index"]["xyz"][0], out["index"]["maps"],
                           dataclasses.asdict(mc))
    return rffb6d.FFB6DReference(
        dataclasses.asdict(mc), served["model"].state_dict(),
        low_precision=low_precision).forward(
            out["pointcloud"], torch.tensor(served["frame"][0]),
            out["choose"], ref_idx)


@pytest.mark.parametrize("field", ["seg_logits", "kp_offsets",
                                   "ctr_offsets"])
def test_forward_matches_the_reference(served, field):
    ref = _reference(served)
    assert served["fwd"][field].shape == ref[field].shape
    _close(served["fwd"][field], ref[field], field)


def test_float8_control_is_outside_the_tolerance(served):
    """The reference one precision below (float8 operands) is not within
    the forward's tolerance: the tolerance separates precisions."""
    ref = _reference(served, low_precision=True)
    with pytest.raises(AssertionError):
        _close(served["fwd"]["seg_logits"], ref["seg_logits"], "seg")


def test_dense_tail_equals_sparse_tail(served):
    """``up_3`` + ``final`` at the chosen pixels equals the dense map
    gathered (batch 1, eval)."""
    model = served["model"]
    out = served["out"]
    args = (out["pointcloud"], torch.tensor(served["frame"][0]),
            out["choose"], out["index"])
    with torch.no_grad():
        sparse = model(*args)
        model.cfg = dataclasses.replace(model.cfg, sparse_cnn_eval=False)
        try:
            dense = model(*args)
        finally:
            model.cfg = dataclasses.replace(model.cfg, sparse_cnn_eval=True)
    for field in ("seg_logits", "kp_offsets", "ctr_offsets"):
        _close(sparse[field], dense[field], field)


def test_batch_of_two_is_two_frames():
    """A batch of 2 (the dense tail, batched gathers and searches) equals
    each frame alone."""
    cfg = _small_cfg()
    model = build_model(cfg.model, 7)
    rgb, depth, k, prio = _frame(seed=4, b=2)
    outs = []
    with torch.no_grad():
        for sl in (slice(0, 2), slice(0, 1), slice(1, 2)):
            built = build_inference_batch_device(
                torch.tensor(rgb[sl]), torch.tensor(depth[sl]),
                torch.tensor(k[sl]), 1280, priorities=prio[sl],
                priority_order=True)
            idx = build_index(built["pointcloud"][..., :3],
                              built["cloud_map"], cfg.model)
            outs.append(model(built["pointcloud"], torch.tensor(rgb[sl]),
                              built["choose"], idx, global_batch=2))
    for field in ("seg_logits", "kp_offsets", "ctr_offsets"):
        both = torch.cat([outs[1][field], outs[2][field]])
        _close(outs[0][field], both, field)


# -- the serving path --------------------------------------------------------------

def test_raw_step_poses_equal_the_reference_pose_stage(served):
    """The step's poses against the reference pose stage on the
    reference forward's labels and votes."""
    out = served["out"]
    ref = _reference(served)
    cfg = served["cfg"]
    seg = ref["seg_logits"].argmax(-1)[0]
    np.testing.assert_array_equal(out["seg"][0].numpy(), seg.numpy())
    cl = cfg.cluster
    poses, present = rpose.cal_frame_poses(
        out["pointcloud"][0, :, :3], seg, ref["ctr_offsets"][0],
        ref["kp_offsets"][0], torch.tensor(stacked_mesh_kps()),
        torch.tensor(stacked_class_radii()), n_cls=cfg.model.n_classes,
        n_kps=cfg.model.n_keypoints, k=cl.max_points_per_class,
        bandwidth=cl.bandwidth, max_iter=cl.max_iter, use_ctr=cl.use_ctr,
        use_ctr_clus_filter=cl.use_ctr_clus_filter, refine_mask=True)
    assert present.any()
    np.testing.assert_array_equal(out["present"][0].numpy(), present.numpy())
    got = out["poses"][0][present]
    np.testing.assert_allclose(got.numpy(), poses[present].numpy(),
                               atol=1e-4)


def test_prepared_batch_step_refuses_ffb6d():
    cfg = _small_cfg()
    with pytest.raises(ValueError, match="raw frames"):
        make_inference_step(cfg, FFB6D(cfg.model), stacked_mesh_kps(),
                            stacked_class_radii(), device="cpu")


def test_pvn3d_raw_step_keeps_its_ascending_sample_and_result():
    """PVN3D has no ``frame_inputs``: its raw step keeps the ascending
    sample and returns no cloud map and no index."""
    from pvn3d_tpu_torch.config import small_model_config
    mc = small_model_config()
    cfg = Config(model=mc)
    model = build_model(mc, 0)
    assert not hasattr(model, "frame_inputs")
    rgb, depth, k, prio = _frame()
    step = make_raw_inference_step(cfg, model, stacked_mesh_kps(),
                                   stacked_class_radii(), device="cpu")
    out = step({"rgb": rgb, "depth": depth, "cam_k": k}, priorities=prio)
    assert "cloud_map" not in out and "index" not in out
    choose = out["choose"][0].long()
    assert torch.all(choose[1:] > choose[:-1])


def test_serve_app_selects_ffb6d(capsys):
    rec = serve.main(["--model", "ffb6d", "--device", "cpu", "--frames",
                      "2", "--warmup", "1"], cfg=_small_cfg())
    assert rec["frames"] == 2 and rec["device"] == "cpu"
    assert rec["latency_ms"]["p50"] > 0


def test_config_tree():
    cfg = ffb6d_config()
    mc = cfg.model
    assert cfg.dataset.n_sample_points == mc.n_sample_points == 480 * 640 // 24
    assert mc.randla.d_out == (32, 64, 128, 256) and mc.randla.k_n == 16
    assert mc.cnn.embedding_dim == 64 and mc.cnn.up_channels == (256, 64, 64)
    assert Config.ycb().model.n_sample_points == 12288
    model = FFB6D(mc)
    widths = [layer.conv.weight.shape[:2] for layer in
              model.rndla.decoder_blocks]
    assert [tuple(w) for w in widths] == [(256, 768), (128, 384), (64, 192),
                                          (64, 128)]
    assert getattr(model.rgbd_seg_layer, "0").conv.weight.shape[1] == 128


def test_resnet_stages_compose_its_forward():
    net = DilatedResNet().eval()
    x = torch.randn(1, 3, 32, 40)
    with torch.no_grad():
        y = net.stem(x)
        for s in range(1, 5):
            y = net.stage(s, y)
        assert torch.equal(y, net(x))


# -- spans and reads -----------------------------------------------------------------

def test_a_request_holds_the_new_spans_and_makes_no_new_read():
    """One raw FFB6D request: ``pvn3d.neighbour_index`` once, both fusion
    directions of the seven stages in seven ``pvn3d.fusion`` ranges, the
    branch and head ranges; every host read (``aten::_local_scalar_dense``)
    lies in a ``pvn3d.read.<site>`` range, at sites PVN3D's request has."""
    cfg = _small_cfg()
    step = make_raw_inference_step(cfg, build_model(cfg.model, 0),
                                   stacked_mesh_kps(), stacked_class_radii(),
                                   device="cpu")
    rgb, depth, k, prio = _frame()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        step({"rgb": rgb, "depth": depth, "cam_k": k}, priorities=prio)
    events = p.events()

    def named(name):
        return [e for e in events if e.name == name]

    def within(e, outer):
        return (e.thread == outer.thread
                and outer.time_range.start <= e.time_range.start
                and e.time_range.end <= outer.time_range.end)
    top = [e for e in events if e.name.startswith("pvn3d.request#")]
    assert len(top) == 1
    assert len(named("pvn3d.neighbour_index")) == 1
    assert len(named("pvn3d.fusion")) == 7
    for stage in ("frame_build", "image_branch", "point_branch", "heads",
                  "pose_stage"):
        assert named(f"pvn3d.{stage}"), stage
    for e in events:
        if e.name.startswith("pvn3d."):
            assert within(e, top[0]), e.name
    reads = [e for e in events if e.name.startswith("pvn3d.read.")]
    for e in named("aten::_local_scalar_dense"):
        assert any(within(e, r) for r in reads)
    index = named("pvn3d.neighbour_index")[0]
    assert not any(within(r, index) for r in reads)
    for f in named("pvn3d.fusion"):
        assert not any(within(r, f) for r in reads)
    assert {r.name for r in reads} <= {
        "pvn3d.read.frame_upload",
        "pvn3d.read.class_cap", "pvn3d.read.meanshift_bandwidth",
        "pvn3d.read.meanshift_threshold", "pvn3d.read.meanshift_stop",
        "pvn3d.read.svd"}
