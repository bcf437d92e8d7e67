"""The port's training path against the JAX package's on the CPU: train-mode
BN, losses, schedules, one full gradient, three training steps, gradient
accumulation, dropout, the trainer and its checkpoints.

Both packages run float32 on the same seeded numpy inputs and the same
weights (the port's seeded ones, carried to JAX by ``to_jax_variables``).
The JAX model takes ``interp_mode="pallas"``, so its FP levels run
``three_interpolate_fused`` (interpret mode off-TPU) and its custom VJP; the
port runs its kernels' plain versions.  Dropout is 0 wherever values are
compared: the two random generators cannot agree.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pvn3d_tpu import config as jax_config
from pvn3d_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from pvn3d_tpu.models import layers as jax_layers
from pvn3d_tpu.models import losses as jax_losses
from pvn3d_tpu.models.pvn3d import PVN3D as JaxPVN3D
from pvn3d_tpu.train import schedule as jax_schedule
from pvn3d_tpu.train.state import TrainState as JaxTrainState
from pvn3d_tpu.train.state import make_optimizer as jax_make_optimizer
from pvn3d_tpu.train.step import compute_losses as jax_compute_losses
from pvn3d_tpu.train.step import make_train_step as jax_make_train_step

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch import config as port_config  # noqa: E402
from pvn3d_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from pvn3d_tpu_torch.models import layers, losses  # noqa: E402
from pvn3d_tpu_torch.models.pvn3d import PVN3D  # noqa: E402
from pvn3d_tpu_torch.train import schedule  # noqa: E402
from pvn3d_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from pvn3d_tpu_torch.train.state import (TrainState,  # noqa: E402
                                         create_train_state, make_optimizer,
                                         param_count)
from pvn3d_tpu_torch.train.step import (compute_losses,  # noqa: E402
                                        make_eval_step, make_train_step)
from pvn3d_tpu_torch.train.trainer import (MeterLogger, Trainer,  # noqa: E402
                                           eval_frequency, is_to_eval)
from pvn3d_tpu_torch.utils.weights import (build_model,  # noqa: E402
                                           to_jax_variables)
from tests.test_torch_weights import small_model_cfg, to_port  # noqa: E402


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------- BN

@pytest.mark.parametrize("momentum", [0.9, 0.01])
@pytest.mark.parametrize("nchw", [False, True])
def test_batchnorm_train_matches(nchw, momentum):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 7, 6) * 2.0 + 1.5).astype(np.float32)
    # A large-mean, low-variance channel: E[x^2] - E[x]^2 cancels and may
    # round negative; the clamp keeps rsqrt finite.
    x[..., 2] = 300.0 + rng.randn(3, 5, 7).astype(np.float32) * 1e-3
    scale = rng.rand(6).astype(np.float32) + 0.5
    bias = rng.randn(6).astype(np.float32)
    mean0 = rng.randn(6).astype(np.float32)
    var0 = rng.rand(6).astype(np.float32) + 0.5
    g = rng.randn(*x.shape).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}
    mod = jax_layers.BatchNorm(use_running_average=False)

    def fn(xx):
        y, mut = mod.apply(variables, xx, momentum, mutable=["batch_stats"])
        return y, mut["batch_stats"]
    want, vjp, want_stats = jax.vjp(fn, jnp.asarray(x), has_aux=True)
    want_gx, = vjp(jnp.asarray(g))

    bn = layers.BatchNorm(6)
    bn.load_state_dict({"weight": torch.tensor(scale),
                        "bias": torch.tensor(bias),
                        "running_mean": torch.tensor(mean0),
                        "running_var": torch.tensor(var0),
                        "num_batches_tracked": torch.tensor(0)})
    bn.train()
    xt = torch.tensor(x, requires_grad=True)
    if nchw:
        got = bn.nchw(xt.permute(0, 3, 1, 2), momentum).permute(0, 2, 3, 1)
    else:
        got = bn(xt, momentum)
    got.backward(torch.tensor(g))
    # Channel 2's batch variance is cancellation noise on both sides (true
    # value 1e-6 against float32 steps of 8e-3 at 9e4), so its values are
    # not comparable: there the clamp is held (finite output, a batch
    # variance >= 0 in the running one); every other channel is compared.
    keep = [0, 1, 3, 4, 5]
    assert np.isfinite(got.detach().numpy()).all()
    assert np.isfinite(xt.grad.numpy()).all()
    assert float(bn.running_var[2]) >= (1.0 - momentum) * var0[2] - 1e-6
    np.testing.assert_allclose(got.detach().numpy()[..., keep],
                               np.asarray(want)[..., keep], atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(want_stats["mean"]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy()[keep],
                               np.asarray(want_stats["var"])[keep],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy()[..., keep],
                               np.asarray(want_gx)[..., keep], atol=1e-5)


def test_batchnorm_single_sample_keeps_variance_biased():
    """n = 1: the unbiasing factor is n / max(n - 1, 1) = 1."""
    x = np.array([[1.0, -2.0, 3.0]], np.float32)
    variables = {"params": {"scale": jnp.ones(3), "bias": jnp.zeros(3)},
                 "batch_stats": {"mean": jnp.zeros(3), "var": jnp.ones(3)}}
    want, mut = jax_layers.BatchNorm(use_running_average=False).apply(
        variables, jnp.asarray(x), 0.5, mutable=["batch_stats"])
    bn = layers.BatchNorm(3).train()
    got = bn(torch.tensor(x), 0.5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               atol=1e-6)


def test_batchnorm_eval_reads_running_statistics_only():
    bn = layers.BatchNorm(4)
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    bn.eval()
    y = bn(x, 0.9)
    assert all(torch.equal(before[k], v) for k, v in bn.state_dict().items())
    assert torch.equal(y, x * torch.rsqrt(torch.ones(4) + bn.eps))


# ------------------------------------------------------------ losses

def _loss_inputs(seed=0, b=3, n=40, c=5, k=4):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, c, (b, n)).astype(np.int32)
    labels[1] = 0                       # a frame with no foreground point
    return {
        "logits": rng.randn(b, n, c).astype(np.float32) * 2,
        "labels": labels,
        "pred": rng.randn(b, k, n, 3).astype(np.float32),
        "target": rng.randn(b, n, k, 3).astype(np.float32),
    }


def test_focal_loss_matches():
    d = _loss_inputs()
    want, want_g = jax.value_and_grad(
        lambda x: jax_losses.focal_loss(x, jnp.asarray(d["labels"]),
                                        gamma=2.0))(jnp.asarray(d["logits"]))
    x = torch.tensor(d["logits"], requires_grad=True)
    got = losses.focal_loss(x, torch.tensor(d["labels"]), gamma=2.0)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               atol=1e-7)
    alpha = np.linspace(0.5, 1.5, 5).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.focal_loss(x.detach(), torch.tensor(d["labels"]),
                                alpha=alpha)),
        float(jax_losses.focal_loss(jnp.asarray(d["logits"]),
                                    jnp.asarray(d["labels"]), alpha=alpha)),
        rtol=1e-6)


def test_offset_l1_loss_matches():
    d = _loss_inputs(1)
    want, want_g = jax.value_and_grad(
        lambda p: jax_losses.offset_l1_loss(
            p, jnp.asarray(d["target"]), jnp.asarray(d["labels"])))(
                jnp.asarray(d["pred"]))
    p = torch.tensor(d["pred"], requires_grad=True)
    got = losses.offset_l1_loss(p, torch.tensor(d["target"]),
                                torch.tensor(d["labels"]))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g),
                               atol=1e-7)
    assert float(p.grad[1].abs().max()) == 0.0   # the background frame


def test_seg_accuracy_matches():
    d = _loss_inputs(2)
    want = jax_losses.seg_accuracy(jnp.asarray(d["logits"]),
                                   jnp.asarray(d["labels"]))
    got = losses.seg_accuracy(torch.tensor(d["logits"]),
                              torch.tensor(d["labels"]))
    assert float(got) == float(want)


# --------------------------------------------------------- schedules

_STEPS = [0, 1, 7, 100, 8333, 8334, 16666, 16667, 20000, 33333, 50001,
          99999, 10 ** 6]


@pytest.mark.parametrize("mode,gamma", [("triangular", 1.0),
                                        ("triangular2", 1.0),
                                        ("exp_range", 0.99994)])
def test_cyclic_lr_matches(mode, gamma):
    base, mx, ss = 1e-5, 1e-3, 25 * 4000 // 6
    for it in _STEPS:
        want = float(jax_schedule.cyclic_lr(it, base, mx, ss, mode, gamma))
        got = schedule.cyclic_lr(it, base, mx, ss, mode, gamma)
        # float32 on the JAX side: it / ss carries ~1e-7 relative, which
        # the amplitude (max - base) / base = 99 magnifies near a trough;
        # in exp_range the float32 rounding of gamma (6e-8 relative) is
        # raised to the power it.
        rtol = 1e-6 + (it * 1.2e-7 if mode == "exp_range" else 0.0)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=2e-9)
    with pytest.raises(ValueError, match="cyclic mode"):
        schedule.cyclic_lr(0, base, mx, ss, "square")
    cfg = port_config.TrainConfig()
    assert schedule.lr_schedule(cfg)(0) == cfg.base_lr


def test_bn_momentum_matches():
    jcfg, pcfg = jax_config.TrainConfig(), port_config.TrainConfig()
    for it in _STEPS:
        want = float(jax_schedule.bn_momentum_at(it, jcfg))
        got = schedule.bn_momentum_at(it, pcfg)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    # The floor on the exponent: one step before and at the first halving.
    assert schedule.bn_momentum_at(8333, pcfg) == 0.9
    assert schedule.bn_momentum_at(8334, pcfg) == 0.45


# ------------------------------------- one gradient, three steps (JAX)

def _train_cfgs():
    """The small model at 64x64 with one block per ResNet stage, dropout 0;
    JAX on its Pallas interp arm (interpret mode off-TPU) and its exact
    ball query.  The full 16-block trunk in train mode at this size is
    ill-conditioned on either side alone (16 batch-statistics BNs over 128
    samples: an input change of 1e-6 moves its gradients by 10-20%, and
    1e-5 with one block per stage), so a gradient tolerance that means
    anything needs the shallow trunk; depth adds no new code path."""
    m = small_model_cfg()
    m = dataclasses.replace(
        m, image_height=64, image_width=64,
        cnn=dataclasses.replace(m.cnn, dropout_psp=0.0, dropout_up=0.0,
                                backbone_layers=(1, 1, 1, 1)),
        pointnet2=dataclasses.replace(m.pointnet2, query_mode="auto",
                                      interp_mode="pallas"))
    jcfg = jax_config.Config(model=m)
    return jcfg, to_port(jcfg)


@pytest.fixture(scope="module")
def sides():
    jcfg, pcfg = _train_cfgs()
    # The port's seeded weights, carried to JAX by to_jax_variables (the
    # inverse of from_jax_variables: tests/test_torch_weights.py).
    port_sd = build_model(pcfg.model, seed=3).state_dict()
    variables = to_jax_variables(port_sd)
    batch = jax_synthetic_batch(jcfg, batch_size=2, seed=5)
    return jcfg, pcfg, variables, port_sd, batch


def _port_model(pcfg, port_sd):
    model = PVN3D(pcfg.model)
    model.load_state_dict(port_sd, strict=True)
    return model.train()


def _is_head_hidden_bias(key: str) -> bool:
    return "_head']['dense" in key and key.endswith("['bias']")


def _port_grad_tree(model):
    """The ``.grad`` of every parameter as a JAX ``params`` tree; the
    auxiliary rgb_seg head is in no loss (no gradient here, zeros in
    JAX)."""
    named = dict(model.named_parameters())
    assert sorted(k for k, p in named.items() if p.grad is None) == [
        "cnn.model.final_seg.0.bias", "cnn.model.final_seg.0.weight"]
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in named.items()}
    grads.update(dict(model.named_buffers()))
    return _leaves(to_jax_variables(grads)["params"])


def _hold_eval_backward(jcfg, pcfg, variables, batch, model,
                        jax_sparse_cnn):
    """The loss and every gradient of the port's eval-mode ``model``
    against JAX's ``PVN3D(train=False, sparse_cnn=jax_sparse_cnn)`` (BN on
    its running statistics): every leaf within 4e-3 * max|g|, 2e-4 in
    global L2."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JaxPVN3D(cfg=jcfg.model, train=False, sparse_cnn=jax_sparse_cnn)
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])

    def loss_fn(params):
        out = jmodel.apply({"params": params, "batch_stats": stats},
                           jb["pointcloud"], jb["rgb"], jb["choose"])
        m = jax_compute_losses(jcfg, out, jb)
        return m["loss"], m
    (_, want_m), want_g = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, variables["params"]))

    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    m = compute_losses(pcfg, model(tb["pointcloud"], tb["rgb"],
                                   tb["choose"]), tb)
    m["loss"].backward()
    np.testing.assert_allclose(float(m["loss"].detach()),
                               float(want_m["loss"]), rtol=1e-5)
    got_g, want_g = _port_grad_tree(model), _leaves(want_g)
    assert set(got_g) == set(want_g)
    keys = [k for k in want_g if not _is_head_hidden_bias(k)]
    for key in keys:
        w = want_g[key]
        np.testing.assert_allclose(
            got_g[key], w, atol=4e-3 * np.abs(w).max() + 1e-6, err_msg=key)
    num = sum(float(np.sum((got_g[k] - want_g[k]) ** 2)) for k in keys)
    den = sum(float(np.sum(want_g[k] ** 2)) for k in keys)
    assert np.sqrt(num / den) <= 2e-4


def test_whole_backward_matches_on_running_statistics(sides):
    """The whole backward (K3's VJP in place, the max pool over padded
    groups with its ties, the gathers, PReLU, the resizes, convs, heads
    and losses) with BN on its running statistics on both sides, where the
    gradient is well conditioned: every leaf within 4e-3 * max|g|, 2e-4 in
    global L2 (measured 8.9e-4 and 1.8e-5).  Train-mode BN's own backward
    is held in ``test_batchnorm_train_matches``."""
    jcfg, pcfg, variables, port_sd, batch = sides
    # JAX's side runs its eval graph with the dense tail: the fused
    # upsample, the split heads and the SA/FP precompute.  The port's side
    # is its literal eval graph (none of them).  On this batch one sa2
    # channel's gradient sits on a max-pool / ReLU decision that input
    # rounding of 1.5e-7 moves by 1% of its leaf's max, and the SA
    # restructure's summation order in torch gives that rounding against
    # XLA's; the port's restructured backward is held against JAX's in
    # test_eval_graph_backward_matches_jax, on batches off that decision.
    pm = pcfg.model
    literal = dataclasses.replace(
        pm, head_split_global=False,
        cnn=dataclasses.replace(pm.cnn, fuse_upsample=False),
        pointnet2=dataclasses.replace(pm.pointnet2,
                                      sa_precompute_first=False,
                                      fp_precompute_first=False))
    model = _port_model(dataclasses.replace(pcfg, model=literal),
                        port_sd).eval()
    model.sparse_cnn = False
    _hold_eval_backward(jcfg, pcfg, variables, batch, model, False)


@pytest.mark.parametrize("batch_size,seed", [(1, 5), (2, 6)])
def test_eval_graph_backward_matches_jax(sides, batch_size, seed):
    """The backward of the port's default eval graph against JAX's
    ``PVN3D(sparse_cnn=None)``: at batch 1 the sparse CNN tail, at batch 2
    the dense one, both with the fused upsample, the split heads and the
    SA/FP precompute, at the tolerances of
    ``test_whole_backward_matches_on_running_statistics`` (measured at
    batch 1 4.5e-6 of a leaf's max and 3.2e-7 in L2; at batch 2 2.0e-4 and
    1.1e-5).  Batch 2 is drawn from seed 6, not the fixture's seed 5,
    whose sa2 max-pool decision the test above describes."""
    jcfg, pcfg, variables, port_sd, _ = sides
    batch = jax_synthetic_batch(jcfg, batch_size=batch_size, seed=seed)
    model = _port_model(pcfg, port_sd).eval()
    assert model.uses_sparse_tail(batch_size) == (batch_size == 1)
    _hold_eval_backward(jcfg, pcfg, variables, batch, model, None)


def jax_train_gradient(jcfg, variables, batch, bn_momentum=0.9, mesh=None,
                       remat_policy=None):
    """JAX's training-mode loss, metrics, gradient and moved batch
    statistics at ``variables`` (one train step's, before the update):
    on the whole batch, or with ``mesh`` on a batch sharded over it; with
    ``remat_policy`` the forward goes through ``jax.checkpoint`` under
    that policy, as the JAX step's ``remat`` does."""
    from pvn3d_tpu.parallel.mesh import replicated, shard_batch
    from pvn3d_tpu.train.step import _remat_policy
    jmodel = JaxPVN3D(cfg=jcfg.model, train=True)
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])

    def forward(params, pc, im, ch):
        return jmodel.apply(
            {"params": params, "batch_stats": stats}, pc, im, ch,
            bn_momentum, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
    if remat_policy is not None:
        forward = jax.checkpoint(forward,
                                 policy=_remat_policy(remat_policy))

    def loss_fn(params, jb):
        out, mut = forward(params, jb["pointcloud"], jb["rgb"],
                           jb["choose"])
        m = jax_compute_losses(jcfg, out, jb)
        return m["loss"], (mut["batch_stats"], m)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    if mesh is None:
        (_, (st, m)), g = fn(params, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    else:
        with mesh:
            (_, (st, m)), g = fn(jax.device_put(params, replicated(mesh)),
                                 shard_batch(mesh, batch))
    return m, _leaves(g), _leaves(st)


def hold_train_gradient(model, want_g, want_s):
    """``model``'s parameter gradients (its ``.grad``) and running
    statistics against JAX's (``jax_train_gradient``)."""
    got_g = _port_grad_tree(model)
    assert set(got_g) == set(want_g)
    # A bias in front of a BN (the JAX heads' hidden Dense biases, which
    # the port does not have, and the upsample convs' biases) has an exact
    # gradient of 0: rounding noise on both sides, not compared.
    keys = [k for k in want_g if not _is_head_hidden_bias(k)
            and not ("['cnn']['up" in k and k.endswith("['conv']['bias']"))]
    # The whole-model gradient at random weights is rough in float32 on
    # either side alone: BN's backward subtracts batch means of nearly
    # uniform cotangents, and ReLU, max-pool and L1-sign boundaries sit
    # behind it, so a 1e-6 input change moves the port's own gradient by
    # 0.3-5% of max|g|, and JAX's own two interp arms differ by 0.7% in
    # global L2 (1.6% in the worst leaf) on these inputs.  Measured here:
    # 1.2% global, 3.7% worst leaf.  The bounds sit above that floor; a
    # wiring fault (a missing term, a factor of 2, a wrong tie rule in the
    # max pool) is 50%+.  The pieces are held tightly on their own: BN
    # 1e-5, the losses 1e-7, K3's VJP 1e-6 (tests/test_torch_ops.py), and
    # the whole backward on running statistics 4e-3 (the test above).
    num = sum(float(np.sum((got_g[k] - want_g[k]) ** 2)) for k in keys)
    den = sum(float(np.sum(want_g[k] ** 2)) for k in keys)
    assert np.sqrt(num / den) <= 3e-2
    for key in keys:
        w = want_g[key]
        assert got_g[key].shape == w.shape, key
        assert (np.linalg.norm(got_g[key] - w)
                <= 0.2 * np.linalg.norm(w) + 1e-5), key

    got_s = _leaves(to_jax_variables(model.state_dict())["batch_stats"])
    # Forward rounding grows ~10x per branch (a 1e-6 input change moves
    # the outputs by 1e-5), so the deepest BN's batch variance agrees to
    # ~5e-5 relative, not to float32 epsilon.
    for key, w in want_s.items():
        np.testing.assert_allclose(got_s[key], w, rtol=2e-4, atol=1e-5,
                                   err_msg=key)


def test_one_gradient_matches(sides):
    jcfg, pcfg, variables, port_sd, batch = sides
    want_m, want_g, want_s = jax_train_gradient(jcfg, variables, batch)

    model = _port_model(pcfg, port_sd)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    out = model(tb["pointcloud"], tb["rgb"], tb["choose"], 0.9)
    m = compute_losses(pcfg, out, tb)
    m["loss"].backward()
    for k in ("loss", "loss_seg", "loss_kp", "loss_ctr", "acc_rgbd"):
        np.testing.assert_allclose(float(m[k].detach()), float(want_m[k]),
                                   rtol=1e-5, err_msg=k)
    hold_train_gradient(model, want_g, want_s)


def test_three_train_steps_match(sides):
    jcfg, pcfg, variables, port_sd, batch = sides
    jmodel = JaxPVN3D(cfg=jcfg.model, train=True)
    tx = jax_make_optimizer(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=tx.init(params))
    jstep = jax.jit(jax_make_train_step(jcfg, jmodel, tx))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    model = _port_model(pcfg, port_sd)
    pstate = TrainState(0, model, make_optimizer(pcfg, model))
    pstep = make_train_step(pcfg, device="cpu")

    lr_sum = 0.0
    for it in range(3):
        jstate, jm = jstep(jstate, jb, jax.random.PRNGKey(0))
        pstate, pm = pstep(pstate, batch, 0)
        # Step 0 runs the same weights.  After an update the two sides
        # differ where a gradient entry is rounding noise (see the
        # gradient test): Adam moves such an entry by lr either way, and
        # the losses part by up to ~2e-4 relative over the next steps.
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if it == 0 else 2e-3,
                                   err_msg=f"step {it}")
        np.testing.assert_allclose(pm["bn_momentum"],
                                   float(jm["bn_momentum"]), rtol=1e-6)
        lr_sum += schedule.lr_schedule(pcfg.train)(it)
    assert pstate.step == 3 and int(jstate.step) == 3

    got = to_jax_variables(model.state_dict())
    got_p, want_p = _leaves(got["params"]), _leaves(jstate.params)
    # Adam divides by sqrt(v): an entry whose gradient is rounding noise
    # moves by lr per step in a direction the noise picks, so two sides
    # may end up to 2 * sum(lr_t) apart there whatever the arithmetic.
    # Entries with a real gradient agree far better; the bound holds all.
    for key, w in want_p.items():
        if _is_head_hidden_bias(key):
            continue        # not a parameter of the port (see above)
        np.testing.assert_allclose(got_p[key], w, atol=2.0 * lr_sum + 1e-6,
                                   rtol=1e-5, err_msg=key)
    # The JAX running mean of a head's hidden BN carries the drifted bias:
    # compare mean - bias, which from_jax_variables folds the same way.
    got_s, want_s = _leaves(got["batch_stats"]), _leaves(jstate.batch_stats)
    for key, w in want_s.items():
        if "_head']['bn" in key and key.endswith("['mean']"):
            bias_key = key.replace("['bn", "['dense").replace(
                "['mean']", "['bias']")
            w = w - want_p[bias_key]
        # Three updates apart (see above), the running statistics of
        # the deepest layers differ by up to ~3e-3 relative.
        np.testing.assert_allclose(got_s[key], w, rtol=2e-2,
                                   atol=2e-2 * np.abs(w).max() + 1e-5,
                                   err_msg=key)


# ------------------------------------------ the port's own step rules

def _tiny_cfg(**train_kw) -> port_config.Config:
    """Full architecture at tiny widths (the JAX package's dry-run size)."""
    lv = port_config.SALevelConfig
    pn2 = port_config.PointNet2Config(
        sa_levels=(lv(128, (0.05, 0.1), (8, 16), ((8, 8, 16), (8, 8, 16))),
                   lv(64, (0.1, 0.2), (8, 16), ((16, 16, 32), (16, 16, 32))),
                   lv(32, (0.2, 0.3), (8, 16), ((32, 32, 32), (32, 32, 32))),
                   lv(16, (0.3, 0.4), (8, 16), ((32, 32, 64), (32, 32, 64)))),
        fp_mlps=((32, 128), (32, 32), (64, 64), (64, 64)))
    model = port_config.ModelConfig(
        n_sample_points=512, image_height=32, image_width=32,
        pointnet2=pn2, seg_head=(64, 32), kp_head=(64, 32),
        ctr_head=(64, 32), compute_dtype="float32",
        cnn=port_config.CNNConfig(backbone_layers=(1, 1, 1, 1)))
    return port_config.Config(
        model=model, train=port_config.TrainConfig(mini_batch_size=4,
                                                   **train_kw))


def _no_dropout(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, cnn=dataclasses.replace(cfg.model.cnn, dropout_psp=0.0,
                                           dropout_up=0.0)))


def test_grad_accum_matches_full_batch_on_duplicated_halves():
    """grad_accum=2 on a batch whose halves are identical gives the
    full-batch step: each micro-batch's BN statistics equal the full
    batch's, the seg term scales by 1/2 and the offset terms sum."""
    cfg = _no_dropout(_tiny_cfg())
    cfg_a = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, grad_accum=2))
    half = synthetic_batch(cfg, batch_size=2, seed=0)
    batch = {k: np.concatenate([v, v], axis=0) for k, v in half.items()}
    s1 = create_train_state(cfg, 0, "cpu")
    s2 = create_train_state(cfg_a, 0, "cpu")
    _, m1 = make_train_step(cfg, "cpu")(s1, batch)
    _, m2 = make_train_step(cfg_a, "cpu")(s2, batch)
    for k in ("loss", "loss_seg", "loss_kp", "loss_ctr", "acc_rgbd"):
        np.testing.assert_allclose(float(m1[k]), float(m2[k]), rtol=2e-5,
                                   err_msg=k)
    # As in the JAX package's test: exact analytically; the joint batch's
    # BN sums round differently than the halves', which flips a few ReLU
    # and max-pool boundary units, so isolated entries differ; a conv bias
    # in front of a BN has a gradient of rounding noise (~1e-6) alone.  A
    # wiring fault (sum for mean, a wrong seg scale) is a factor of 2.
    for (k, a), b in zip(s1.model.named_parameters(),
                         s2.model.parameters()):
        if a.grad is None:
            assert b.grad is None and "final_seg" in k
            continue
        na, nb = float(a.grad.norm()), float((a.grad - b.grad).norm())
        assert nb <= 0.05 * na + 1e-5, (k, na, nb)
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=k)


def test_grad_accum_rejects_indivisible_batch():
    cfg = _tiny_cfg(grad_accum=3)
    state = create_train_state(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(cfg, "cpu")(state,
                                    synthetic_batch(cfg, batch_size=2))


def _with_train(cfg, **kw):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              **kw))


@pytest.mark.parametrize("policy,loss_rtol,param_atol", [
    ("full", 1e-6, 1e-6), ("dots", 3e-5, 1e-5)])
def test_remat_matches_the_plain_step_and_jax_remat(sides, policy,
                                                    loss_rtol, param_atol):
    """A rematerialised step against the port's plain step (JAX's
    ``test_remat_matches_no_remat`` tolerances; the gradients equal bit
    for bit; the running statistics equal, so the recompute moved them no
    second time) and against JAX's ``remat`` gradient under the same
    policy (``test_one_gradient_matches``' tolerances)."""
    jcfg, pcfg, variables, port_sd, batch = sides
    runs = []
    for remat in (False, True):
        cfg = _with_train(pcfg, remat=remat, remat_policy=policy)
        model = _port_model(cfg, port_sd)
        state = TrainState(0, model, make_optimizer(cfg, model))
        _, m = make_train_step(cfg, "cpu")(state, batch, 0)
        runs.append((float(m["loss"]), model.state_dict(),
                     {k: p.grad for k, p in model.named_parameters()}))
    (loss0, sd0, g0), (loss1, sd1, g1) = runs
    np.testing.assert_allclose(loss1, loss0, rtol=loss_rtol)
    for k, g in g0.items():
        assert (g is None and g1[k] is None) or torch.equal(g1[k], g), k
    for k, v in sd0.items():
        if "running_" in k:
            assert torch.equal(sd1[k], v), k
            assert not torch.equal(v, port_sd[k]), k
        else:
            np.testing.assert_allclose(sd1[k].numpy(), v.numpy(),
                                       atol=param_atol, err_msg=k)

    # JAX's remat gradient: the loss, every gradient and the moved
    # statistics, at test_one_gradient_matches' tolerances.
    want_m, want_g, want_s = jax_train_gradient(
        jcfg, variables, batch, schedule.bn_momentum_at(0, pcfg.train),
        remat_policy=policy)
    np.testing.assert_allclose(loss1, float(want_m["loss"]), rtol=1e-5)
    hold_train_gradient(model, want_g, want_s)


def test_remat_replays_the_dropout_masks():
    """With dropout on, the recompute draws the first forward's masks
    (the dropout generator is set back; checkpoint replays only the
    default generators), so the gradients equal the plain step's; another
    seed's masks give other gradients."""
    cfg = _tiny_cfg()
    assert cfg.model.cnn.dropout_psp > 0 and cfg.model.cnn.dropout_up > 0
    batch = synthetic_batch(cfg, batch_size=2, seed=0)

    def grads(c, seed=0):
        state = create_train_state(c, 0, "cpu")
        make_train_step(c, "cpu")(state, batch, seed)
        return {k: p.grad for k, p in state.model.named_parameters()
                if p.grad is not None}
    want = grads(cfg)
    for policy in ("full", "dots"):
        got = grads(_with_train(cfg, remat=True, remat_policy=policy))
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (policy, k)
    other = grads(cfg, seed=1)
    assert not torch.equal(other["cnn.model.final.0.weight"],
                           want["cnn.model.final.0.weight"])


def test_dots_saves_exactly_the_conv_and_matmul_outputs(monkeypatch):
    """The "dots" policy marks MUST_SAVE exactly the forward's conv and
    matmul ops (JAX's dot_general + conv_general_dilated), counted
    through the policy against the ops a plain forward dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.checkpoint import CheckpointPolicy
    from pvn3d_tpu_torch.train import step as step_mod
    dots = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)
    seen, real = [], step_mod.dots_policy

    def recording(ctx, op, *args, **kwargs):
        decision = real(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            seen.append((op, decision))
        return decision
    monkeypatch.setattr(step_mod, "dots_policy", recording)
    cfg = _no_dropout(_tiny_cfg(remat=True, remat_policy="dots"))
    batch = synthetic_batch(cfg, batch_size=2, seed=0)
    state = create_train_state(cfg, 0, "cpu")
    make_train_step(cfg, "cpu")(state, batch)
    saved = [op for op, d in seen if d == CheckpointPolicy.MUST_SAVE]
    assert saved and all(op in dots for op in saved)
    assert all(d == CheckpointPolicy.PREFER_RECOMPUTE
               for op, d in seen if op not in dots)

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += func in dots
            return func(*args, **(kwargs or {}))
    model = create_train_state(cfg, 0, "cpu").model
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with Count():
        model(tb["pointcloud"], tb["rgb"], tb["choose"], 0.9)
    assert len(saved) == Count.n, (len(saved), Count.n)


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="unknown remat_policy 'convs'"):
        make_train_step(_tiny_cfg(remat=True, remat_policy="convs"), "cpu")


def test_weight_decay_is_coupled_l2():
    cfg = _tiny_cfg(weight_decay=0.1)
    state = create_train_state(cfg, 0, "cpu")
    group, = state.optimizer.param_groups
    assert group["weight_decay"] == 0.1 and group["eps"] == 1e-8
    assert tuple(group["betas"]) == (0.9, 0.999)
    assert type(state.optimizer) is torch.optim.Adam       # not AdamW
    assert param_count(state.model) == sum(
        v.numel() for k, v in state.model.state_dict().items()
        if "running_" not in k and "num_batches" not in k)


# ----------------------------------------------------------- dropout

def test_dropout_mask_follows_seed_and_step():
    cfg = _tiny_cfg()
    batch = synthetic_batch(cfg, batch_size=2, seed=0)
    step = make_train_step(cfg, "cpu")

    def first_loss(seed, start):
        state = create_train_state(cfg, 0, "cpu")
        state.step = start
        return float(step(state, batch, seed)[1]["loss"])
    a = first_loss(7, 0)
    assert first_loss(7, 0) == a                 # same (seed, step)
    assert first_loss(7, 1) != a                 # another step
    assert first_loss(8, 0) != a                 # another seed


def test_dropout_keep_rate_and_eval():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(200, 500)
    y = layers.dropout(x, 0.3, True, gen)
    kept = float((y != 0).float().mean())
    assert abs(kept - 0.7) < 0.01
    assert torch.allclose(y[y != 0], torch.tensor(1.0 / 0.7))
    state = gen.get_state()
    assert layers.dropout(x, 0.3, False, gen) is x       # eval: no draw
    assert torch.equal(gen.get_state(), state)
    assert layers.dropout(x, 0.0, True, gen) is x


def test_train_then_eval_gives_the_same_eval_forward():
    """Serving unchanged: ``.train()`` then ``.eval()`` (no step between)
    leaves the eval forward bit for bit what it was."""
    cfg = _tiny_cfg()
    state = create_train_state(cfg, 1, "cpu")
    model = state.model.eval()
    batch = synthetic_batch(cfg, batch_size=1, seed=2)
    args = [torch.as_tensor(batch[k])
            for k in ("pointcloud", "rgb", "choose")]
    with torch.inference_mode():
        before = model(*args)
    model.train()
    model.eval()
    with torch.inference_mode():
        after = model(*args)
    assert all(torch.equal(before[k], after[k]) for k in before)
    # A model built for serving starts in eval mode.
    assert not PVN3D(cfg.model).training


# ------------------------------------------- trainer and checkpoints

def test_eval_frequency_matches():
    from pvn3d_tpu.train.trainer import eval_frequency as jax_freq
    for it in (1, 29999, 30000, 39999, 40000, 50000, 60000, 79999, 80000,
               10 ** 6):
        assert eval_frequency(it) == jax_freq(it)
    assert is_to_eval(5000) and not is_to_eval(5001)


def test_meter_logger_reads_means(capsys):
    logger = MeterLogger("train")
    logger.update({"loss": torch.tensor(1.0), "bn_momentum": 0.9})
    logger.update({"loss": torch.tensor(3.0), "bn_momentum": 0.9})
    means = logger.flush(2)
    assert means == {"loss": 2.0, "bn_momentum": 0.9}
    assert "[train it=2" in capsys.readouterr().out
    assert logger.flush(3) == {}


def test_fit_learns_and_eval_step_shapes():
    cfg = _tiny_cfg()
    batch = synthetic_batch(cfg, batch_size=2, seed=0)
    state = create_train_state(cfg, 0, "cpu")
    stats0 = {k: v.clone() for k, v in state.model.named_buffers()}
    eval_step = make_eval_step(cfg, "cpu")
    _, m0 = eval_step(state, batch)
    seen = []
    step = make_train_step(cfg, "cpu")

    def recording(s, b, seed):
        s, m = step(s, b, seed)
        seen.append(float(m["loss"]))
        return s, m
    trainer = Trainer(cfg, state, recording, eval_step, log_every=1)
    trainer.fit([batch] * 5, max_steps=5)
    assert state.step == 5
    out, m = eval_step(state, batch)
    n = cfg.model.n_sample_points
    assert out["seg_logits"].shape == (2, n, cfg.model.n_classes)
    assert out["kp_offsets"].shape == (2, cfg.model.n_keypoints, n, 3)
    assert out["ctr_offsets"].shape == (2, 1, n, 3)
    assert state.model.training                  # eval_step restored it
    assert np.isfinite(seen).all() and np.isfinite(float(m["loss"]))
    assert len(seen) == 5 and seen[-1] < seen[0]   # a repeated batch
    moved = [k for k, v in state.model.named_buffers()
             if "running_" in k and not torch.equal(v, stats0[k])]
    assert len(moved) == len([k for k in stats0 if "running_" in k])
    means = trainer.eval_epoch([batch, batch])
    assert means["n_batches"] == 2 and np.isfinite(means["loss"])
    assert float(m0["loss"]) != means["loss"]


def test_resume_reproduces_the_uninterrupted_run(tmp_path):
    cfg = _tiny_cfg()
    batches = [synthetic_batch(cfg, batch_size=2, seed=s) for s in range(4)]

    def run(state, some, ckpt=None):
        losses_seen = []
        step = make_train_step(cfg, "cpu")

        def recording(s, b, seed):
            s, m = step(s, b, seed)
            losses_seen.append(float(m["loss"]))
            return s, m
        trainer = Trainer(cfg, state, recording, checkpoint_manager=ckpt,
                          log_every=100)
        trainer.resume()
        trainer.fit(some)
        return losses_seen

    whole = create_train_state(cfg, 0, "cpu")
    want = run(whole, batches)

    ckpt = CheckpointManager(str(tmp_path / "run"))
    assert ckpt.restore(create_train_state(cfg, 0, "cpu")) is None
    first = create_train_state(cfg, 0, "cpu")
    got = run(first, batches[:2], ckpt)
    assert ckpt.latest_step() == 2

    fresh = create_train_state(cfg, 99, "cpu")     # other weights: replaced
    got += run(fresh, batches[2:], CheckpointManager(str(tmp_path / "run")))
    assert fresh.step == 4
    assert got == want                              # exactly
    for (k, a), b in zip(whole.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_checkpoint_retention_and_best(tmp_path):
    cfg = _tiny_cfg()
    state = create_train_state(cfg, 0, "cpu")
    ckpt = CheckpointManager(str(tmp_path / "c"), max_to_keep=2)
    import json
    import os
    best = tmp_path / "c" / "best"
    for step, val in ((1, 5.0), (2, 6.0), (3, None), (4, 4.0), (5, 4.5)):
        state.step = step
        ckpt.save(step, state, val_loss=val)
        kept = sorted(f for f in os.listdir(best) if f.endswith(".pt"))
        want = {1: "ckpt_1.pt", 2: "ckpt_1.pt", 3: "ckpt_1.pt",
                4: "ckpt_4.pt", 5: "ckpt_4.pt"}[step]
        assert kept == [want], (step, kept)
    ckpt.wait()
    ckpt.close()
    files = sorted(f for f in os.listdir(tmp_path / "c") if f.endswith(".pt"))
    assert files == ["ckpt_4.pt", "ckpt_5.pt"]          # latest 2 by recency
    with open(best / "best_val_loss.json") as f:
        assert json.load(f) == {"val_loss": 4.0, "step": 4}
    # The best value carries across a new manager on the same directory.
    again = CheckpointManager(str(tmp_path / "c"), max_to_keep=2)
    again.save(6, state, val_loss=4.2)
    assert sorted(f for f in os.listdir(best) if f.endswith(".pt")) == [
        "ckpt_4.pt"]
    restored = again.restore(create_train_state(cfg, 5, "cpu"))
    assert restored.step == 6
    no_best = CheckpointManager(str(tmp_path / "d"), keep_best=False)
    no_best.save(1, state, val_loss=1.0)
    assert not os.path.exists(tmp_path / "d" / "best")
