"""The port's data parallelism on the CPU: ``parallel/`` (the mesh, the
batch rows, the bootstrap), the synced BatchNorm, the data-parallel train
step and Trainer, dp-sharded serving, and the loader's and the device
build's rows.

Ranks are subprocesses over gloo (``tests/_torch_parallel_worker.py``,
a ``file://`` store under ``tmp_path``, so parallel test workers cannot
collide on a port); two launches (2 ranks, 4 ranks) run every scenario
and the tests read their results.  They are held against the port's
one-process step on the global batch, JAX's step under a dp mesh, JAX's
BatchNorm on the concatenated batch and the unsharded serving steps (the
tolerances of ``tests/test_sharded_inference.py``).  Dropout is 0
wherever values are compared, as in ``tests/test_torch_train.py``.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pvn3d_tpu.models import layers as jax_layers
from pvn3d_tpu.parallel.mesh import make_mesh as jax_make_mesh

import __graft_entry__ as graft

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import torch.distributed as dist  # noqa: E402

from pvn3d_tpu_torch.data import device_frame  # noqa: E402
from pvn3d_tpu_torch.data.loader import DataLoader, worker_seed  # noqa: E402
from pvn3d_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from pvn3d_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from pvn3d_tpu_torch.parallel.multihost import (  # noqa: E402
    TORCHRUN_ENV, initialize_distributed)
from pvn3d_tpu_torch.train import schedule  # noqa: E402
from pvn3d_tpu_torch.train.state import (TrainState,  # noqa: E402
                                         create_train_state, make_optimizer)
from pvn3d_tpu_torch.train.step import (make_eval_step,  # noqa: E402
                                        make_train_step)
from pvn3d_tpu_torch.train.trainer import Trainer  # noqa: E402
from pvn3d_tpu_torch.utils.weights import (build_model,  # noqa: E402
                                           to_jax_variables)
from tests import _torch_parallel_worker as worker  # noqa: E402
from tests.test_torch_device_train import _raw_batch  # noqa: E402
from tests.test_torch_train import (_no_dropout,  # noqa: E402
                                    _port_model, _tiny_cfg, _train_cfgs,
                                    hold_train_gradient, jax_train_gradient)
from tests.test_torch_weights import to_port  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "_torch_parallel_worker.py")


def _start(scenario: str, world: int, d, inputs):
    """Start ``scenario`` on ``world`` worker ranks; returns ``wait()``,
    which gives their results and outputs."""
    torch.save(inputs, os.path.join(d, "inputs.pt"))
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, scenario, str(r), str(world), str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(world)]

    def wait():
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail("parallel worker timed out")
            outs.append(out)
            assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
        return [dict(torch.load(os.path.join(d, f"rank{r}.pt"),
                                weights_only=False), output=outs[r])
                for r in range(world)]
    return wait


def _bn_inputs():
    """``test_batchnorm_train_matches``'s inputs at batch 4 (2 rows a
    rank), channel 2 a large-mean, low-variance channel."""
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 5, 7, 6) * 2.0 + 1.5).astype(np.float32)
    x[..., 2] = 300.0 + rng.randn(4, 5, 7).astype(np.float32) * 1e-3
    return {"x": x, "g": rng.randn(*x.shape).astype(np.float32),
            "scale": rng.rand(6).astype(np.float32) + 0.5,
            "bias": rng.randn(6).astype(np.float32),
            "mean0": rng.randn(6).astype(np.float32),
            "var0": rng.rand(6).astype(np.float32) + 0.5, "momentum": 0.9}


def _bn_state(b):
    return {"weight": torch.tensor(b["scale"]),
            "bias": torch.tensor(b["bias"]),
            "running_mean": torch.tensor(b["mean0"]),
            "running_var": torch.tensor(b["var0"]),
            "num_batches_tracked": torch.tensor(0)}


def _plain_bn(b):
    from pvn3d_tpu_torch.models.layers import BatchNorm
    layer = BatchNorm(6)
    layer.load_state_dict(_bn_state(b))
    return layer.train()


@pytest.fixture(scope="module")
def sides():
    """``tests/test_torch_train.py``'s step inputs: the port's seeded
    weights (carried to JAX), a global batch of 2."""
    from pvn3d_tpu.data.synthetic import synthetic_batch as jax_batch
    jcfg, pcfg = _train_cfgs()
    port_sd = build_model(pcfg.model, seed=3).state_dict()
    return jcfg, pcfg, port_sd, jax_batch(jcfg, batch_size=2, seed=5)


def _accum_inputs():
    cfg = _no_dropout(_tiny_cfg(grad_accum=2))
    return cfg, build_model(cfg.model, seed=0).state_dict(), \
        synthetic_batch(cfg, batch_size=4, seed=1)


def _one_process_step(cfg, sd, batch, mesh=None):
    model = _port_model(cfg, sd)
    state = TrainState(0, model, make_optimizer(cfg, model))
    _, m = make_train_step(cfg, "cpu", mesh)(state, batch, 0)
    return m, model


def _jax_dp_gradient(sides):
    """JAX's loss, gradient and moved batch statistics under
    ``make_mesh(dp=2, sp=1)`` on the global batch: the step's before its
    update."""
    jcfg, pcfg, port_sd, batch = sides
    return jax_train_gradient(
        jcfg, to_jax_variables(port_sd), batch,
        schedule.bn_momentum_at(0, pcfg.train),
        mesh=jax_make_mesh(dp=2, sp=1, devices=jax.devices()[:2]))


@pytest.fixture(scope="module")
def two(tmp_path_factory, sides):
    """One 2-rank launch (rows, bn, step, accum, fit), and while it runs
    the references: one process's steps and JAX's dp-mesh step."""
    _, pcfg, port_sd, batch = sides
    b = _bn_inputs()
    b["state"] = _bn_state(b)
    cfg_a, sd_a, batch_a = _accum_inputs()
    fit_cfg = _tiny_cfg()
    inputs = {
        "bn": b,
        "step": {"cfg": pcfg, "sd": port_sd, "batch": batch},
        "accum": {"cfg": cfg_a, "sd": sd_a, "batch": batch_a},
        "fit": {"cfg": fit_cfg, "batches": [
            synthetic_batch(fit_cfg, batch_size=4, seed=s)
            for s in range(3)]}}
    d = str(tmp_path_factory.mktemp("two"))
    wait = _start("two", 2, d, inputs)
    order = [0, 2, 1, 3]      # the ranks' micro-batches: rows (0, 2), (1, 3)
    refs = {"step": _one_process_step(pcfg, port_sd, batch),
            "accum": _one_process_step(
                cfg_a, sd_a, {k: v[order] for k, v in batch_a.items()}),
            "jax": _jax_dp_gradient(sides)}
    return wait(), d, refs


def _serve_inputs():
    """``tests/test_sharded_inference.py``'s requests at batch 4 on the
    port's seeded weights."""
    cfg = to_port(graft._tiny_config())
    n_cls = cfg.model.n_classes
    rng = np.random.RandomState(0)
    meshes = (rng.uniform(-0.05, 0.05, (n_cls, cfg.model.n_keypoints + 1, 3)
                          ).astype(np.float32),
              np.ones(n_cls, np.float32) * 0.1,
              rng.uniform(-0.05, 0.05, (n_cls, 128, 3)).astype(np.float32),
              np.ones((n_cls, 128), bool))
    batch = synthetic_batch(cfg, batch_size=4,
                            n_points=cfg.model.n_sample_points,
                            height=64, width=64)
    depth = np.full((4, 64, 64), 1.0, np.float32)
    depth[:, 20:40, 20:44] = 0.8
    depth[:, 5:9, 5:9] = 0.0
    raw = {"rgb": (rng.rand(4, 64, 64, 3) * 255).astype(np.float32),
           "depth": depth,
           "cam_k": np.tile(np.array([[60.0, 0, 32], [0, 60.0, 32],
                                      [0, 0, 1]], np.float32), (4, 1, 1))}
    return {"cfg": cfg, "sd": build_model(cfg.model, seed=0).state_dict(),
            "meshes": meshes, "batch": batch, "raw": raw,
            "priorities": rng.uniform(1e-4, 1.0, (4, 64 * 64)
                                      ).astype(np.float32)}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """One 4-rank launch (serve), and the unsharded requests meanwhile."""
    inputs = {"serve": _serve_inputs()}
    wait = _start("four", 4, str(tmp_path_factory.mktemp("four")), inputs)
    want = worker.serve(None, inputs)
    return wait(), want, inputs


@pytest.fixture
def world_one(tmp_path):
    """A 1-rank gloo group in this process (a ``file://`` store), and a
    mesh that holds it: ``make_mesh`` itself takes a 1-rank group for
    none."""
    initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                           device="cpu")
    try:
        assert port_mesh.make_mesh(device="cpu").group is None
        yield port_mesh.Mesh(dp=1, rank=0, device=torch.device("cpu"),
                             group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- mesh and rows

def test_rows_and_helpers_over_two_ranks(two):
    """``local_rows``, ``shard_batch`` and ``gather`` at dp 2: the
    counterpart of ``test_global_batch_from_local_shards_correctly`` at
    dp only."""
    results = two[0]
    pc = np.arange(4 * 8 * 9, dtype=np.float32).reshape(4, 8, 9)
    labels = np.arange(4 * 8, dtype=np.int32).reshape(4, 8)
    for r, res in enumerate(results):
        got = res["rows"]
        mine = slice(2 * r, 2 * r + 2)
        assert got["rows"] == mine
        assert "not divisible by 2 processes" in got["indivisible"]
        np.testing.assert_array_equal(got["shard"]["pointcloud"], pc[mine])
        np.testing.assert_array_equal(got["shard"]["labels"], labels[mine])
        assert got["shard"]["_n_valid"] == 3            # not an array
        np.testing.assert_array_equal(got["gathered"]["pointcloud"], pc)
        np.testing.assert_array_equal(got["gathered"]["mask"],
                                      labels % 3 == 0)
        assert got["gathered"]["mask"].dtype == np.bool_


def test_single_process_mesh_is_the_whole_batch():
    mesh = port_mesh.make_mesh(device="cpu")
    assert (mesh.dp, mesh.rank, mesh.group) == (1, 0, None)
    assert port_mesh.local_rows(mesh, 24) == slice(0, 24)
    batch = {"pointcloud": np.ones((3, 5, 9), np.float32), "_n_valid": 2}
    out = port_mesh.shard_batch(mesh, batch)
    assert torch.is_tensor(out["pointcloud"]) and out["_n_valid"] == 2
    assert out["pointcloud"].shape == (3, 5, 9)
    t = torch.arange(6)
    assert port_mesh.gather(mesh, t) is t


def test_no_arg_initialize_stays_single_process(monkeypatch):
    """Without torchrun's environment, ``initialize_distributed()`` runs
    on in one process (JAX's helper tolerates a missing cluster)."""
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    initialize_distributed(device="cpu")
    assert not dist.is_initialized()
    assert port_mesh.make_mesh(device="cpu").dp == 1


def test_make_mesh_refuses_sp_and_a_wrong_dp():
    with pytest.raises(NotImplementedError, match="item 16"):
        port_mesh.make_mesh(sp=2, device="cpu")
    with pytest.raises(ValueError, match="2\\*1 != 1 processes"):
        port_mesh.make_mesh(dp=2, device="cpu")


# --------------------------------------------------------- synced BN

@pytest.mark.parametrize("nchw", [False, True])
def test_synced_batchnorm_matches_jax_on_the_concatenated_batch(two, nchw):
    """Two ranks' synced BN against JAX's BatchNorm on the whole batch:
    outputs, input gradients, the parameter gradients summed over the
    ranks, and the running statistics (unbiased by the global n = 280),
    at ``test_batchnorm_train_matches``' tolerances."""
    results = two[0]
    b = _bn_inputs()
    variables = {"params": {"scale": jnp.asarray(b["scale"]),
                            "bias": jnp.asarray(b["bias"])},
                 "batch_stats": {"mean": jnp.asarray(b["mean0"]),
                                 "var": jnp.asarray(b["var0"])}}
    mod = jax_layers.BatchNorm(use_running_average=False)

    def fn(xx, scale, bias):
        v = {"params": {"scale": scale, "bias": bias},
             "batch_stats": variables["batch_stats"]}
        y, mut = mod.apply(v, xx, b["momentum"], mutable=["batch_stats"])
        return y, mut["batch_stats"]
    want, vjp, want_stats = jax.vjp(
        fn, jnp.asarray(b["x"]), variables["params"]["scale"],
        variables["params"]["bias"], has_aux=True)
    want_gx, want_gw, want_gb = vjp(jnp.asarray(b["g"]))

    got = [res["bn"][nchw] for res in results]
    keep = [0, 1, 3, 4, 5]        # channel 2: see test_torch_train.py
    cat = {k: np.concatenate([g[k] for g in got]) for k in ("y", "gx")}
    np.testing.assert_allclose(cat["y"][..., keep],
                               np.asarray(want)[..., keep], atol=1e-5)
    np.testing.assert_allclose(cat["gx"][..., keep],
                               np.asarray(want_gx)[..., keep], atol=1e-5)
    np.testing.assert_allclose((got[0]["gw"] + got[1]["gw"])[keep],
                               np.asarray(want_gw)[keep], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got[0]["gb"] + got[1]["gb"],
                               np.asarray(want_gb), rtol=1e-5, atol=1e-4)
    for g in got:
        np.testing.assert_array_equal(g["mean"], got[0]["mean"])
        np.testing.assert_allclose(g["mean"], np.asarray(want_stats["mean"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g["var"][keep],
                                   np.asarray(want_stats["var"])[keep],
                                   rtol=1e-6, atol=1e-6)


def test_synced_batchnorm_at_world_one_is_bit_for_bit(world_one):
    """Under a 1-rank group the synced path (weights 1.0, one all-reduce)
    gives the plain BN's bits: outputs, gradients, running statistics."""
    b = _bn_inputs()
    runs = []
    for group in (None, world_one.group):
        layer = _plain_bn(b)
        layer.process_group = group
        x = torch.tensor(b["x"], requires_grad=True)
        y = layer(x, b["momentum"])
        y.backward(torch.tensor(b["g"]))
        runs.append((y.detach(), x.grad, layer.weight.grad,
                     layer.running_mean, layer.running_var))
    for a, c in zip(*runs):
        assert torch.equal(a, c)


# ------------------------------------------------- the data-parallel step

def _grad_l2(got, model):
    """Global L2 distance of a rank's gradients from ``model``'s,
    relative."""
    num = den = 0.0
    for k, p in model.named_parameters():
        if p.grad is None:
            assert k not in got
            continue
        w = p.grad.numpy()
        num += float(np.sum((got[k] - w) ** 2))
        den += float(np.sum(w ** 2))
    return np.sqrt(num / den)


def test_ddp_step_matches_the_one_process_step(two, sides):
    """Two ranks of one frame each against one process on the batch of 2:
    the summed gradient (seg scaled by 1 / world) is the global batch's.
    The ranks agree bit for bit on the loss and on every parameter and
    statistic.  Against one process, the BN statistics differ by the sum
    order (two half-batch means), which moves the loss by < 1e-6 relative
    and the gradient by the float32 conditioning of a batch-statistics
    backward: ``test_one_gradient_matches`` finds ~1e-2 in global L2
    between two correct implementations, and this pair differs by 2.6e-3.
    A wiring fault (the mean for the sum, a seg term not scaled by
    1 / world) is 30% or more."""
    results, _, refs = two
    pcfg = sides[1]
    want_m, model = refs["step"]
    r0, r1 = (res["step"] for res in results)
    for k in ("loss", "loss_seg", "loss_kp", "loss_ctr", "acc_rgbd"):
        assert r0["metrics"][k] == r1["metrics"][k], k
        np.testing.assert_allclose(r0["metrics"][k], float(want_m[k]),
                                   rtol=1e-6, err_msg=k)
    for k in r0["state"]:
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k],
                                      err_msg=k)
    assert _grad_l2(r0["grads"], model) <= 1e-2
    lr = schedule.lr_schedule(pcfg.train)(0)
    want_sd = model.state_dict()
    for k, v in r0["state"].items():
        np.testing.assert_allclose(v, want_sd[k].numpy(), rtol=1e-5,
                                   atol=2.0 * lr + 1e-6, err_msg=k)


def test_ddp_step_matches_jax_dp_mesh_step(two, sides):
    """Rank 0's step against JAX's under ``make_mesh(dp=2, sp=1)`` on the
    global batch: the loss components, rank 0's summed gradient (the seg
    term scaled by 1 / world) against JAX's gradient of the dp-mesh loss,
    and the moved running statistics, at ``test_one_gradient_matches``'
    tolerances."""
    results, _, refs = two
    _, pcfg, port_sd, _ = sides
    want_m, want_g, want_s = refs["jax"]
    got = results[0]["step"]
    for k in ("loss", "loss_seg", "loss_kp", "loss_ctr", "acc_rgbd"):
        np.testing.assert_allclose(got["metrics"][k], float(want_m[k]),
                                   rtol=1e-5, err_msg=k)
    model = _port_model(pcfg, port_sd)
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in got["state"].items()})
    for k, p in model.named_parameters():
        if k in got["grads"]:
            p.grad = torch.as_tensor(got["grads"][k])
    hold_train_gradient(model, want_g, want_s)


def test_grad_accum_over_ranks_matches_the_reordered_batch(two):
    """grad_accum 2 on 2 ranks (rows 0,1 and 2,3; micro-batches of one)
    against one process at grad_accum 2 on the batch as the ranks'
    micro-batches see it: micro 0 = rows (0, 2), micro 1 = rows (1, 3);
    the seg term scales by 1/(accum * world)."""
    results, _, refs = two
    cfg = _accum_inputs()[0]
    want_m, model = refs["accum"]
    r0, r1 = (res["accum"] for res in results)
    for k in ("loss", "loss_seg", "loss_kp", "loss_ctr", "acc_rgbd"):
        assert r0["metrics"][k] == r1["metrics"][k], k
        np.testing.assert_allclose(r0["metrics"][k], float(want_m[k]),
                                   rtol=1e-6, err_msg=k)
    assert _grad_l2(r0["grads"], model) <= 1e-2
    lr = schedule.lr_schedule(cfg.train)(0)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(r0["state"][k], v.numpy(), rtol=1e-5,
                                   atol=2.0 * lr + 1e-6, err_msg=k)


def test_world_one_group_step_is_bit_for_bit(world_one):
    """A step under a 1-rank group (synced BN, the gradient all-reduce,
    the global metrics) gives the plain step's bits."""
    cfg = _tiny_cfg()
    batch = synthetic_batch(cfg, batch_size=2, seed=0)
    sd = build_model(cfg.model, seed=0).state_dict()
    (m0, a), (m1, b) = (_one_process_step(cfg, sd, batch, mesh)
                        for mesh in (None, world_one))
    for k in ("loss", "loss_seg", "loss_kp", "loss_ctr", "acc_rgbd"):
        assert torch.equal(m0[k], m1[k]), k
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k


def test_trainer_over_two_ranks_saves_on_rank_zero_and_resumes(two):
    """``Trainer.fit`` on 2 ranks: rank 0 alone prints and writes; the
    file's keys are the bare module's; a fresh state on every rank
    resumes from it and both end equal; ``eval_epoch``'s means are the
    global batches'."""
    results, d, _ = two
    f0, f1 = (res["fit"] for res in results)
    assert f0["saves"] == [2, 3] and f1["saves"] == []
    assert f0["resumed"] == f1["resumed"] == 2
    assert f0["step"] == f1["step"] == 3
    for k in f0["state"]:
        np.testing.assert_array_equal(f0["state"][k], f1["state"][k])
    assert "[train it=1" in results[0]["output"]
    assert "[train it=" not in results[1]["output"]
    ckpt = torch.load(os.path.join(d, "ckpt", "ckpt_3.pt"),
                      weights_only=True)
    assert not any(k.startswith("module.") for k in ckpt["model"])
    assert sorted(ckpt["model"]) == sorted(f0["state"])
    assert f0["val"] == f1["val"] and f0["val"]["n_batches"] == 2

    # The same global batches in one process, from the rank's weights.
    cfg = _tiny_cfg()
    state = create_train_state(cfg, 0, "cpu")
    state.model.load_state_dict(torch.load(
        os.path.join(d, "ckpt", "ckpt_2.pt"), weights_only=True)["model"])
    want = Trainer(cfg, state, None, make_eval_step(cfg, "cpu")).eval_epoch(
        [synthetic_batch(cfg, batch_size=4, seed=s) for s in range(2)])
    for k in ("loss", "loss_seg", "loss_kp", "loss_ctr", "acc_rgbd"):
        np.testing.assert_allclose(f0["val"][k], want[k], rtol=1e-5,
                                   err_msg=k)


# ----------------------------------------------------- dp-sharded serving

@pytest.mark.parametrize("request_kind", ["prepared", "raw",
                                          "raw_generator"])
def test_dp_sharded_serving_matches_unsharded(four, request_kind):
    """4 ranks x 1 frame against the unsharded batch of 4 (poses 2e-4,
    seg equal: ``tests/test_sharded_inference.py``); every rank returns
    the global result; the CNN tail is chosen on the global batch (the
    dense one, as the batch of 4 takes), while a lone frame would take
    the sparse one."""
    results, want, inputs = four
    assert want["sparse_tail"] == [False] * 3
    for res in results:
        got = res["serve"]
        assert got["sparse_tail"] == [False] * 3
        g, w = got[request_kind], want[request_kind]
        assert set(g) == set(w)
        np.testing.assert_allclose(g["poses"], w["poses"], atol=2e-4)
        np.testing.assert_array_equal(g["seg"], w["seg"])
        np.testing.assert_array_equal(g["present"], w["present"])
        if request_kind == "prepared":
            np.testing.assert_allclose(g["add"], w["add"], atol=1e-4)
        else:
            np.testing.assert_array_equal(g["choose"], w["choose"])
    from pvn3d_tpu_torch.models.pvn3d import PVN3D
    assert PVN3D(inputs["serve"]["cfg"].model).uses_sparse_tail(1)


# ------------------------------------------- the loader and device build

@pytest.mark.parametrize("steps", [3, None])
def test_loader_rows_partition_each_global_batch(steps):
    """Rank r of 2 takes tickets [i*B + r*b, i*B + (r+1)*b) of every global
    batch B = 4; the ranks' rows make up the one-process stream (an epoch
    stream's rows past the end repeat the last item); world 1 is the
    one-process loader."""
    one = list(DataLoader(worker.TicketDataset, 4, steps=steps))
    ranks = [list(DataLoader(worker.TicketDataset, 4, steps=steps, rank=r,
                             world=2)) for r in range(2)]
    assert len(ranks[0]) == len(ranks[1]) == len(one) == 3
    for i, whole in enumerate(one):
        got = np.concatenate([ranks[0][i]["ticket"], ranks[1][i]["ticket"]])
        assert ranks[0][i]["ticket"].shape == (2,)
        if steps is None and i == 2:
            np.testing.assert_array_equal(got, [8, 9, 9, 9])
            assert whole["_n_valid"] == 2
        else:
            np.testing.assert_array_equal(got, whole["ticket"])
    with pytest.raises(ValueError, match="divisible"):
        DataLoader(worker.TicketDataset, 3, rank=0, world=2)


def test_loader_ranks_draw_apart():
    """Augmentation streams: rank 0 keeps the one-process draws (the
    dataset's own stream inline, ``seed + wid`` in a worker); a higher
    rank draws from ``worker_seed(seed, rank, wid)``, inline and in a
    spawned worker alike.  A worker's ``wid`` is its process identity,
    which counts every child this process has started, so the test reads
    it from the items."""
    def batches(rank, workers):
        return list(DataLoader(
            worker.TicketDataset, 4, num_workers=workers, seed=5, steps=2,
            rank=rank, world=2))

    def draws(got):
        return np.concatenate([b["draw"] for b in got])
    rs = np.random.RandomState
    np.testing.assert_array_equal(draws(batches(0, 0)), rs(0).rand(4))
    np.testing.assert_array_equal(draws(batches(1, 0)),
                                  rs(worker_seed(5, 1, 0)).rand(4))
    pooled = batches(1, 1)
    wid = int(pooled[0]["wid"][0])
    assert wid >= 1 and all((b["wid"] == wid).all() for b in pooled)
    np.testing.assert_array_equal(draws(pooled),
                                  rs(worker_seed(5, 1, wid)).rand(4))
    assert worker_seed(5, 0, 3) == 8
    assert len({worker_seed(5, r, w) for r in range(4)
                for w in range(8)}) == 32


def test_loader_makes_up_skipped_samples_on_every_rank(two):
    """A training loader yields exactly ``steps`` batches whatever its
    dataset skips (None): the rank that lost ticket 3 draws on from the
    next global batches' tickets, so both ranks run every step's
    collectives (the 2-rank launch would hang otherwise); the same
    through a worker pool and in one process."""
    r0, r1 = (res["skip"] for res in two[0])
    assert r0 == [[0, 1], [4, 5], [8, 9]]
    assert r1 == [[2, 6], [7, 0], [1, 4]]
    pooled = DataLoader(worker.SkipDataset, 4, num_workers=1, steps=3,
                        rank=1, world=2)
    assert [b["ticket"].tolist() for b in pooled] == r1
    assert [b["ticket"].tolist() for b in DataLoader(
        worker.SkipDataset, 4, steps=2)] == [[0, 1, 2, 4], [5, 6, 7, 8]]
    with pytest.raises(RuntimeError, match="no sample"):
        list(DataLoader(functools.partial(worker.SkipDataset,
                                          skip=range(10)), 4, steps=1))


def test_device_build_rows_equal_the_one_process_build():
    """Each rank draws the global batch's frame records and keeps its
    own: the ranks' rows together are the one-process build, bit for
    bit."""
    raw = {k: (v if k in ("is_syn", "do_jitter") else torch.as_tensor(v))
           for k, v in _raw_batch(4, seed=3).items()}
    raw["is_syn"] = np.array([True, False, True, False])

    def build(rows, rank, world):
        part = {k: v[rows] for k, v in raw.items()}
        return device_frame.build_train_batch_device(
            part, device_frame.step_generator(0, 7), n_sample=256,
            n_classes=22, rank=rank, world=world)
    whole = build(slice(0, 4), 0, 1)
    parts = [build(slice(2 * r, 2 * r + 2), r, 2) for r in range(2)]
    for k, v in whole.items():
        assert torch.equal(torch.cat([p[k] for p in parts]), v), k


# ----------------------------------------------------------- the app

@pytest.fixture(scope="module")
def ycb_tree(tmp_path_factory):
    from pvn3d_tpu_torch.tools.fake_data import make_fake_ycb
    return make_fake_ycb(str(tmp_path_factory.mktemp("ycb")), h=120, w=160,
                         cls_ids=(1, 2), items=["data_syn/000001",
                                                "data_syn/000002"],
                         mesh_ids=range(1, 22))


def test_train_app_distributed_with_remat(ycb_tree, tmp_path, monkeypatch,
                                          capsys):
    """``apps/train.py --distributed --remat --remat_policy dots`` on a
    fake YCB tree under a 1-rank gloo group: the app runs its mesh of one
    rank, which holds no group (the plain step), and the config holds the
    remat flags."""
    from pvn3d_tpu_torch.apps import train
    from pvn3d_tpu_torch.config import Config, small_model_config
    monkeypatch.setattr(train, "base_config",
                        lambda d, c: Config(model=small_model_config()))
    argv = ["--data_root", ycb_tree, "--file_list",
            os.path.join(ycb_tree, "image_list.txt"), "--checkpoint_dir",
            str(tmp_path / "run"), "--max_steps", "1", "--batch_size", "2",
            "--workers", "0", "--device", "cpu", "--log_every", "1",
            "--no_fill_depth", "--distributed", "--remat",
            "--remat_policy", "dots"]
    initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                           device="cpu")
    try:
        trainer = train.main(argv)
    finally:
        dist.destroy_process_group()
    assert trainer.state.step == 1
    assert (trainer.mesh.dp, trainer.mesh.group) == (1, None)
    t = trainer.cfg.train
    assert t.remat and t.remat_policy == "dots"
    out = capsys.readouterr().out
    assert "processes: 1" in out and out.count("[train it=") == 1
