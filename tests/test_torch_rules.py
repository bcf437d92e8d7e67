"""Rules of the port: it imports nothing of JAX or the JAX package, its
entry points run on the card unless the CPU is asked for, and each kernel
wrapper takes its plain version only for CPU tensors — any other tensor
launches the kernel or raises."""
import ast
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch import config as port_config  # noqa: E402
from pvn3d_tpu_torch.inference.pipeline import (  # noqa: E402
    make_inference_step, make_pose_fn, make_raw_inference_step)
from pvn3d_tpu_torch.models.pvn3d import check_supported  # noqa: E402
from pvn3d_tpu_torch.ops.kernels import (KERNELS, common, fps,  # noqa: E402
                                         interp, query, winner)
from pvn3d_tpu_torch.train.state import create_train_state  # noqa: E402
from pvn3d_tpu_torch.train.step import (make_eval_step,  # noqa: E402
                                        make_train_step)
from pvn3d_tpu_torch.utils.device import resolve_device  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    pkg = os.path.join(ROOT, "pvn3d_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_no_jax_and_no_jax_package():
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "pvn3d_tpu"}
    seen = 0
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: {name}"
        seen += 1
    assert seen > 20


def test_port_names_no_tpu_generation():
    """The port states no TPU time, rate or size, so no source of it names
    a TPU generation (a bare "v4" stays allowed: PTX has ld.global.v4)."""
    generation = re.compile(r"v5[- ]?lite|\bv5e\b|\bv5p\b|TPU v(?=\d)",
                            re.IGNORECASE)
    pkg = os.path.join(ROOT, "pvn3d_tpu_torch")
    paths = [os.path.join(d, f) for d, _, files in os.walk(pkg)
             for f in files if f.endswith((".py", ".cu", ".cuh"))]
    paths.append(os.path.join(ROOT, "chip_smoke.py"))
    assert any(p.endswith(".cu") for p in paths)
    for path in paths:
        with open(path) as f:
            for no, line in enumerate(f, 1):
                assert not generation.search(line), f"{path}:{no}: {line}"


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config.Config.ycb()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_inference_step(cfg, torch.nn.Module(), np.zeros((22, 9, 3)),
                            np.ones(22))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_pose_fn(cfg, np.zeros((22, 9, 3)), np.ones(22))
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_step(cfg)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    assert callable(make_train_step(cfg, device="cpu"))


def test_raw_entry_point_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_raw_inference_step(port_config.Config.ycb(), torch.nn.Module(),
                                np.zeros((22, 9, 3)), np.ones(22))


def test_icp_entry_points_and_tool_raise_without_cuda(monkeypatch):
    from pvn3d_tpu_torch.inference.pipeline import (make_icp_refine_fn,
                                                    make_icp_step)
    from pvn3d_tpu_torch.tools import synthetic_e2e
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config.Config.ycb()
    mesh, valid = np.zeros((22, 9, 3), np.float32), np.ones((22, 9), bool)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_icp_step(cfg, mesh, valid)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_icp_refine_fn(cfg, mesh, valid)
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic_e2e.main(["--tiny", "--steps", "0"])
    assert callable(make_icp_step(cfg, mesh, valid, device="cpu"))


def _with_pointnet2(**kw):
    import dataclasses
    m = port_config.small_model_config()
    return dataclasses.replace(m, pointnet2=dataclasses.replace(
        m.pointnet2, **kw))


@pytest.mark.parametrize("field,value", [
    ("query_mode", "nearest"), ("interp_mode", "linear"),
    ("query_compute", "f16")])
def test_check_supported_rejects_inexact_neighbour_modes(field, value):
    """Every neighbour mode of the JAX package is ported; a mode string
    it does not know raises instead of running some other arm silently."""
    with pytest.raises(ValueError, match=field):
        check_supported(_with_pointnet2(**{field: value}))


@pytest.mark.parametrize("query_mode,interp_mode,query_compute", [
    ("auto", "auto", "f32"), ("exact", "exact", "f32"),
    ("auto", "pallas", "f32"), ("pallas", "auto", "f32"),
    ("pallas", "pallas", "bf16"), ("approx", "exact", "f32"),
    ("approx", "approx", "bf16"), ("exact", "approx", "bf16")])
def test_check_supported_accepts_exact_neighbour_modes(
        query_mode, interp_mode, query_compute):
    """Every (query_mode, interp_mode, query_compute) the JAX package
    runs builds a model."""
    from pvn3d_tpu_torch.models.pvn3d import PVN3D
    cfg = _with_pointnet2(query_mode=query_mode, interp_mode=interp_mode,
                          query_compute=query_compute)
    assert check_supported(cfg) == torch.float32
    assert PVN3D(cfg).cfg.pointnet2.query_mode == query_mode


def _inputs():
    """Per kernel of ``KERNELS``: its module, wrapper, the name of its
    plain version, positional arguments for both and the keyword
    arguments of each."""
    rng = np.random.RandomState(0)
    xyz = torch.tensor(rng.rand(1, 64, 3).astype(np.float32))
    feats = torch.tensor(rng.randn(1, 16, 4).astype(np.float32))
    mask = torch.tensor(rng.rand(2, 16) < 0.8)
    g_out = torch.tensor(rng.randn(1, 64, 4).astype(np.float32))
    idx = torch.tensor(rng.randint(0, 16, (1, 64, 3)).astype(np.int32))
    dist = torch.tensor(rng.rand(1, 64, 3).astype(np.float32))
    q_args = ((0.2,), (4,), xyz, xyz[:, :8])
    i_args = (xyz, xyz[:, :16], feats)
    return {
        "fps": (fps, fps.fps, "fps_plain", (xyz, 8), {}, {}),
        "query": (query, query.ball_query, "ball_query_plain", q_args, {},
                  {}),
        "query_expanded": (query, query.ball_query, "ball_query_plain",
                           q_args, {"expanded": True}, {"expanded": True}),
        "query_bf16": (query, query.ball_query, "ball_query_plain", q_args,
                       {"bf16": True}, {"bf16": True}),
        "query_capacity": (query, query.ball_query,
                           "ball_query_capacity_plain", q_args,
                           {"expanded": True, "capacity": 2},
                           {"capacity": 2}),
        "interp": (interp, interp.three_interpolate_fused,
                   "three_interpolate_plain", i_args, {}, {}),
        "interp_expanded": (interp, interp.three_interpolate_fused,
                            "three_interpolate_plain", i_args,
                            {"expanded": True}, {"expanded": True}),
        "interp_bwd": (interp, interp.three_interpolate_backward,
                       "three_interpolate_backward_plain",
                       (g_out, idx, dist, 16), {}, {}),
        "winner": (winner, winner.winner_stats, "winner_stats_plain",
                   (xyz[:, :32].reshape(2, 16, 3), mask, 0.08), {}, {}),
    }


_KERNEL_NAMES = [k.name for k in KERNELS]


def _kernel(name):
    return next(k for k in KERNELS if k.name == name)


def test_every_kernel_has_a_rules_case():
    assert sorted(_inputs()) == sorted(_KERNEL_NAMES)


@pytest.mark.parametrize("name", _KERNEL_NAMES)
def test_cpu_tensor_takes_plain_version(name, monkeypatch):
    mod, wrapper, plain_name, args, wkw, pkw = _inputs()[name]

    def no_launch(*a, **k):
        raise AssertionError("CPU tensors must not launch the kernel")
    for k in KERNELS:
        monkeypatch.setattr(k, "launch", no_launch)
    got = wrapper(*args, **wkw)
    want = getattr(mod, plain_name)(*args, **pkw)
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", _KERNEL_NAMES)
def test_device_tensor_launches_or_raises(name, monkeypatch):
    """A tensor off the CPU never reaches the plain version: the wrapper
    launches its kernel (here a recorder, on 'meta' tensors standing in
    for CUDA ones) or, for a device that is not CUDA, raises."""
    mod, wrapper, plain_name, args, wkw, _ = _inputs()[name]
    kernel = _kernel(name)
    meta = tuple(a.to("meta") if torch.is_tensor(a) else a for a in args)

    def no_plain(*a, **k):
        raise AssertionError("device tensors must not take the plain path")
    monkeypatch.setattr(mod, plain_name, no_plain)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wrapper(*meta, **wkw)

    calls = []
    monkeypatch.setattr(mod, "require_cuda", lambda *t: t[0].device)
    # Only this instance records; the wrapper reaching any other raises.
    monkeypatch.setattr(kernel, "launch",
                        lambda dev, *a: calls.append(len(a)))
    wrapper(*meta, **wkw)
    assert len(calls) == 1
    assert calls[0] == len(kernel.argtypes) - 1   # all but the stream


def test_backward_of_a_device_tensor_launches_the_backward_kernel(
        monkeypatch):
    """Under autograd the FP blend's gradient goes through
    ``ThreeInterpolateFused.backward`` to the backward kernel's wrapper,
    never through autograd of a gather."""
    seen = []
    real = interp.three_interpolate_backward

    def recording(*a, **k):
        seen.append(a[3])
        return real(*a, **k)
    monkeypatch.setattr(interp, "three_interpolate_backward", recording)
    _, _, _, (xyz, known, feats), _, _ = _inputs()["interp"]
    feats = feats.clone().requires_grad_(True)
    out, _, _ = interp.three_interpolate_fused(xyz, known, feats)
    assert type(out.grad_fn).__name__ == "ThreeInterpolateFusedBackward"
    out.sum().backward()
    assert seen == [16]


def test_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(common, "BUILD_DIR", str(tmp_path))
    kernel = common.CudaKernel("fps", "fps.cu", "fps_launch", [])

    def missing():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(common, "_nvcc", missing)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernel.load()
    monkeypatch.setattr(common, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="kernel build failed"):
        common.build_all([kernel])


def test_library_function_loads_the_kernel_library(monkeypatch):
    """``CudaKernel.library_function`` builds and loads the library first
    and returns the named C function from it (K4's CTA-size query), and
    the entry point's name stays a plain attribute beside it."""
    kernel = common.CudaKernel("winner", "winner.cu", "winner_launch", [])

    class Lib:
        winner_cta_threads = object()
    loaded = []

    def load():
        loaded.append(True)
        kernel._lib = Lib()
    monkeypatch.setattr(kernel, "load", load)
    fn = kernel.library_function("winner_cta_threads")
    assert loaded == [True] and fn is Lib.winner_cta_threads
    assert kernel.symbol == "winner_launch"
    assert winner.KERNEL.symbol == "winner_launch"


def test_every_kernel_has_its_source_and_counter():
    """Nine counters over five sources: an instance of a source is named
    after it (``query_capacity`` of ``query.cu``) and shares its
    library."""
    assert len(KERNELS) == 9 and len(set(_KERNEL_NAMES)) == 9
    assert len({k.source for k in KERNELS}) == 5
    for k in KERNELS:
        assert os.path.exists(k.source)
        stem = os.path.basename(k.source)[:-len(".cu")]
        assert k.name == stem or k.name.startswith(stem + "_")
        assert k.lib_path() == next(
            j for j in KERNELS if j.name == stem).lib_path()
        assert isinstance(k.launches, int)


def test_port_imports_no_cv2_pil_yaml_or_sklearn():
    """The card's machine has none of them: the port reads PNGs, gt.yml
    and depth by its own means (``data/png.py``, ``data/lm_yaml.py``,
    ``data/depth_completion.py``), draws overlays with ``utils/viz.py``
    and finds k nearest neighbours in torch; the trunk is seeded from a
    torchvision state dict on disk, never through torchvision.  Tests may
    import them."""
    banned = {"cv2", "PIL", "yaml", "sklearn", "torchvision"}
    seen = 0
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: {name}"
        seen += 1
    assert seen > 30


def test_apps_raise_without_cuda(monkeypatch, tmp_path):
    from pvn3d_tpu_torch.apps import evaluate, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--data_root", str(tmp_path), "--max_steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--data_root", str(tmp_path), "--checkpoint_dir",
                       str(tmp_path), "--device", "cuda"])


@pytest.mark.parametrize("app,flags,item", [
    ("train", ["--distributed"], "item 14"),
    ("train", ["--remat"], "item 13"),
    ("train", ["--remat_policy", "dots"], "item 13")])
def test_unported_flags_exit_naming_their_roadmap_item(app, flags, item,
                                                       tmp_path):
    """A JAX app flag whose machinery the port lacks exits before any
    work, naming its ROADMAP.md item, instead of being ignored."""
    from pvn3d_tpu_torch.apps import evaluate, train
    main = train.main if app == "train" else evaluate.main
    with pytest.raises(SystemExit, match=f"ROADMAP.md queue A, {item}\\)"):
        main(["--data_root", str(tmp_path), "--checkpoint_dir",
              str(tmp_path), "--device", "cpu"] + flags)


def test_not_ported_holds_only_the_missing_machinery():
    """``--occ`` (Occlusion-LineMOD), ``--pretrained_trunk`` (the
    torchvision trunk) and ``--sparse_cnn`` (the eval restructures) are
    ported; the apps refuse only the flags whose machinery is still
    missing."""
    from pvn3d_tpu_torch.apps import train
    assert sorted(train.NOT_PORTED) == ["distributed", "remat"]


@pytest.fixture(scope="module")
def tiny_ycb_tree(tmp_path_factory):
    from pvn3d_tpu_torch.tools.fake_data import make_fake_ycb
    with open(os.path.join(port_config.ASSETS_DIR, "ycb_config",
                           "test_data_list.txt")) as f:
        items = [ln.strip() for ln in f if ln.strip()][:2]
    return make_fake_ycb(str(tmp_path_factory.mktemp("tiny")), h=120,
                         w=160, cls_ids=(1,), items=items,
                         mesh_ids=range(1, 22))


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("flag", ["", "--sparse_cnn", "--dense_cnn"])
def test_evaluate_cnn_flags_take_the_jax_tail(flag, batch, tiny_ycb_tree,
                                              tmp_path, monkeypatch):
    """``evaluate --sparse_cnn`` / ``--dense_cnn`` run on a tiny fake tree
    on the CPU and take the CNN tail the JAX app's flags select
    (``pvn3d_tpu/apps/evaluate.py:106-109``): sparse when forced, dense
    when forced, else sparse exactly at batch 1."""
    from pvn3d_tpu_torch.apps import evaluate
    from pvn3d_tpu_torch.models.pspnet import PSPUpsample
    monkeypatch.setattr(evaluate, "base_config", lambda d, c: port_config
                        .Config(model=port_config.small_model_config()))
    calls = []
    sparse = PSPUpsample.sparse

    def counted(self, *a, **kw):
        calls.append(a[0].shape[0])
        return sparse(self, *a, **kw)
    monkeypatch.setattr(PSPUpsample, "sparse", counted)
    summary = evaluate.main(
        ["--data_root", tiny_ycb_tree, "--checkpoint_dir", str(tmp_path),
         "--device", "cpu", "--workers", "0", "--no_fill_depth",
         "--batch_size", str(batch)] + ([flag] if flag else []))
    assert summary["per_class"][1]["n"] == 2
    want_sparse = {"--sparse_cnn": True, "--dense_cnn": False}.get(
        flag, batch == 1)
    assert calls == ([batch] * (2 // batch) if want_sparse else [])
