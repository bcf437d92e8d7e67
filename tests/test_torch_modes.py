"""The JAX package's neighbour-selection and sampling modes in the port,
each held against its JAX arm on the CPU on the same seeded inputs:

* ``query_mode="pallas"``: K2's capacity instance (plain version here)
  against ``ball_query_pallas(..., interpret=True)``;
* ``query_mode="approx"`` and ``query_compute="bf16"``: K2's expanded and
  bf16 instances against ``ball_query_multi``;
* ``interp_mode="exact"`` / ``"approx"``: K3's expanded instance against
  the XLA ``three_nn`` + ``idw_weights`` + ``three_interpolate``;
* ``fps_groups``: grouped FPS against ``furthest_point_sample(groups=G)``;
* ``resolve_query_mode``, the whole small model in each mode (eval forward
  and train-mode losses), and the fusion widths of a config whose point
  branch is not 128 wide (``__graft_entry__._tiny_config``).

The expanded d^2 is ``(|a|^2 - 2 a.b) + |b|^2`` in both packages, but
XLA's CPU contracts the dot product and the norms into FMAs while the port
fixes one order without them (kernel and plain version agree bit for bit).
So a pair whose d^2 lies within a few ulp of r^2 (or of another candidate
in a 3-NN) may fall on either side between the two packages.  The index
tables are compared exactly except on rows holding such a pair (d^2
within 4 ulp * max(1, |p|^2), in float64), which are counted and printed,
never hidden by the choice of inputs.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pvn3d_tpu import config as jax_config
from pvn3d_tpu.models.pointnet2 import resolve_query_mode as jax_resolve
from pvn3d_tpu.models.pvn3d import PVN3D as JaxPVN3D
from pvn3d_tpu.ops.grouping import ball_query_multi as jax_ball_query
from pvn3d_tpu.ops.interpolate import idw_weights as jax_idw
from pvn3d_tpu.ops.interpolate import three_interpolate as jax_interp
from pvn3d_tpu.ops.interpolate import three_nn as jax_three_nn
from pvn3d_tpu.ops.pallas.query import ball_query_pallas
from pvn3d_tpu.ops.sampling import furthest_point_sample as jax_fps
from pvn3d_tpu.train.step import compute_losses as jax_compute_losses

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch.models.pointnet2 import (  # noqa: E402
    BACKEND, resolve_query_mode)
from pvn3d_tpu_torch.models.pvn3d import PVN3D, check_supported  # noqa: E402
from pvn3d_tpu_torch.ops import grouping, interpolate, sampling  # noqa: E402
from pvn3d_tpu_torch.ops.kernels import interp, query  # noqa: E402
from pvn3d_tpu_torch.train.step import compute_losses  # noqa: E402
from pvn3d_tpu_torch.utils.weights import (build_model,  # noqa: E402
                                           from_jax_variables,
                                           to_jax_variables)
from tests.test_torch_weights import (jax_and_port_weights,  # noqa: E402
                                      small_model_cfg, to_port)

ULP1 = 2.0 ** -23
RADII, NS = (0.05, 0.1), (16, 32)        # small_model_config's level 0


def _cloud(seed, b, n, scale=0.3, z=0.0):
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(b, n, 3).astype(np.float32) - 0.5) * scale
    xyz[..., 2] += z
    return xyz


def _window(a, b):
    """4 ulp * max(1, |p|^2) for every (row, column) pair, float64."""
    sa = (a.astype(np.float64) ** 2).sum(-1)[:, :, None]
    sb = (b.astype(np.float64) ** 2).sum(-1)[:, None, :]
    return 4 * ULP1 * np.maximum(1.0, np.maximum(sa, sb))


def _boundary_rows(xyz, cen, radii):
    """Per scale, the (B, m) rows holding a pair with d^2 within the
    window of r^2."""
    d2 = ((cen[:, :, None, :].astype(np.float64)
           - xyz[:, None, :, :]) ** 2).sum(-1)
    win = _window(cen, xyz)
    return [(np.abs(d2 - float(np.float32(r * r))) <= win).any(-1)
            for r in radii]


def _assert_tables(got, want, boundary, label):
    """Index tables equal outside the boundary rows; prints how many rows
    were boundary rows and how many of those differ."""
    n_bnd = n_diff = 0
    for s, (g, w, bnd) in enumerate(zip(got, want, boundary)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.int32
        np.testing.assert_array_equal(g[~bnd], w[~bnd],
                                      err_msg=f"{label} scale {s}")
        n_bnd += int(bnd.sum())
        n_diff += int((g != w).any(-1).sum())
        # A fault would show on most rows, far beyond the rounding cases.
        assert bnd.mean() < 0.05, f"{label}: {bnd.sum()} boundary rows"
    print(f"{label}: {n_bnd} boundary rows excluded, {n_diff} of them "
          f"differ")


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))


def _adversarial(seed, n=2048, triples=40):
    """A sparse cloud (few other points in any ball) in which point j,
    j + 128 and j + 256 coincide for ``triples`` j: capacity 2 keeps two
    of each triple, the exact query all three."""
    xyz = _cloud(seed, 1, n, scale=3.0)
    rng = np.random.RandomState(seed + 1)
    js = np.sort(rng.choice(128, triples, replace=False))
    xyz[0, js + 128] = xyz[0, js + 256] = xyz[0, js]
    return xyz, xyz[:, js], js


class TestCapacityQuery:
    @pytest.mark.parametrize("capacity", [1, 2, 3])
    def test_matches_pallas_kernel(self, capacity):
        """At the small model's level 0 (2048 points, 512 centroids),
        where capacity 2 binds on a uniform cloud."""
        xyz = _cloud(21, 1, 2048, z=1.0)
        cen = xyz[:, :512] + np.float32(0.001)
        got = query.ball_query(RADII, NS, torch.tensor(xyz),
                               torch.tensor(cen), expanded=True,
                               capacity=capacity)
        want = ball_query_pallas(RADII, NS, jnp.asarray(xyz),
                                 jnp.asarray(cen), capacity=capacity,
                                 interpret=True)
        bnd = _boundary_rows(xyz, cen, RADII)
        _assert_tables(got, want, bnd, f"capacity {capacity}")
        exact = query.ball_query(RADII, NS, torch.tensor(xyz),
                                 torch.tensor(cen))
        differ = sum(int((g != e).any(-1).sum())
                     for g, e in zip(got, exact))
        if capacity < 3:
            assert differ > 0, "the capacity never bound"

    def test_adversarial_cloud_differs_from_exact(self):
        """Co-located triples 128 apart: the port's "pallas" query equals
        the Pallas kernel's and differs from the exact one on rows."""
        xyz, cen, js = _adversarial(5)
        args = (torch.tensor(xyz), torch.tensor(cen))
        got = grouping.ball_query_multi(RADII, NS, *args, mode="pallas",
                                        capacity=2)
        want = ball_query_pallas(RADII, NS, jnp.asarray(xyz),
                                 jnp.asarray(cen), capacity=2,
                                 interpret=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        exact = grouping.ball_query_multi(RADII, NS, *args, mode="exact")
        differ = [int((g != e).any(-1).sum()) for g, e in zip(got, exact)]
        print(f"adversarial cloud: rows differing from exact {differ}")
        assert all(d == cen.shape[1] for d in differ)
        # Each centroid keeps j and j + 128 of its triple, never j + 256,
        # which the exact query takes.
        for g, e in zip(got, exact):
            g, e = g[0].numpy(), e[0].numpy()
            assert ((g == js[:, None]).any(1)
                    & (g == js[:, None] + 128).any(1)).all()
            assert not (g == js[:, None] + 256).any()
            assert (e == js[:, None] + 256).any(1).all()

    @pytest.mark.parametrize("n,m,ns,capacity", [
        (700, 97, (8, 64), 1), (300, 40, (64,), 3), (129, 5, (4, 8, 16), 2)])
    def test_off_path_shapes(self, n, m, ns, capacity):
        """N not a multiple of 128 (the last class row masked), more
        scales, ns up to 64, capacities 1-3."""
        xyz = _cloud(n, 2, n, scale=0.2)
        cen = xyz[:, :m] + np.float32(0.002)
        radii = (0.04, 0.08, 0.16)[:len(ns)]
        got = query.ball_query(radii, ns, torch.tensor(xyz),
                               torch.tensor(cen), expanded=True,
                               capacity=capacity)
        want = ball_query_pallas(radii, ns, jnp.asarray(xyz),
                                 jnp.asarray(cen), capacity=capacity,
                                 interpret=True)
        _assert_tables(got, want, _boundary_rows(xyz, cen, radii),
                       f"n={n} capacity {capacity}")

    def test_plain_is_the_class_rule(self):
        """The plain version against the rule written out in numpy: a hit
        at j is kept iff fewer than C earlier hits share j % 128."""
        xyz, cen, _ = _adversarial(9, n=600, triples=20)
        got = query.ball_query_capacity_plain((0.3,), (48,),
                                              torch.tensor(xyz),
                                              torch.tensor(cen), 2)[0]
        d2 = query.sqdist_expanded(torch.tensor(cen), torch.tensor(xyz))
        hit = (d2 < float(np.float32(0.09))).numpy()[0]
        for row in range(cen.shape[1]):
            seen = np.zeros(128, int)
            kept = []
            for j in np.flatnonzero(hit[row]):
                if seen[j % 128] < 2:
                    kept.append(j)
                seen[j % 128] += 1
            want = (kept + [kept[0]] * 48)[:48] if kept else [0] * 48
            np.testing.assert_array_equal(got[0, row].numpy(), want)


class TestExpandedAndBf16Query:
    @pytest.mark.parametrize("mode,compute", [("approx", "f32"),
                                              ("approx", "bf16"),
                                              ("exact", "bf16")])
    def test_matches_ball_query_multi(self, mode, compute):
        xyz = _cloud(31, 2, 2048, z=1.0)
        cen = xyz[:, ::4] + np.float32(0.001)
        got = grouping.ball_query_multi(RADII, NS, torch.tensor(xyz),
                                        torch.tensor(cen), mode=mode,
                                        compute_dtype=compute)
        want = jax_ball_query(RADII, NS, jnp.asarray(xyz), jnp.asarray(cen),
                              mode=mode, compute_dtype=compute)
        rx, rc = ((_bf16(xyz), _bf16(cen)) if compute == "bf16"
                  else (xyz, cen))
        if mode == "exact":
            # The direct form has no contraction to differ by.
            bnd = [np.zeros(cen.shape[:2], bool)] * 2
        else:
            bnd = _boundary_rows(rx, rc, RADII)
        _assert_tables(got, want, bnd, f"{mode} {compute}")
        if compute == "bf16":
            f32 = grouping.ball_query_multi(RADII, NS, torch.tensor(xyz),
                                            torch.tensor(cen), mode=mode)
            assert any(not torch.equal(a, b) for a, b in zip(got, f32))

    def test_pallas_ignores_compute(self):
        """As in JAX (grouping.py:102-106 returns before the bf16 cast)."""
        xyz = _cloud(32, 1, 700)
        args = (RADII, NS, torch.tensor(xyz), torch.tensor(xyz[:, :50]))
        a = grouping.ball_query_multi(*args, mode="pallas")
        b = grouping.ball_query_multi(*args, mode="pallas",
                                      compute_dtype="bf16")
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    @pytest.mark.parametrize("kw", [{"mode": "nearest"},
                                    {"compute_dtype": "f16"},
                                    {"mode": "pallas", "capacity": 0}])
    def test_unknown_settings_raise(self, kw):
        xyz = torch.tensor(_cloud(33, 1, 64))
        with pytest.raises(ValueError):
            grouping.ball_query_multi(RADII, NS, xyz, xyz[:, :8], **kw)


def _nn_boundary(u, k):
    """(B, n) rows whose four nearest known points hold two d^2 within
    the window of each other (the order of the 3 nearest may flip)."""
    d2 = ((u[:, :, None, :].astype(np.float64) - k[:, None, :, :]) ** 2
          ).sum(-1)
    win = _window(u, k)
    order = np.argsort(d2, axis=-1, kind="stable")[..., :4]
    near = np.take_along_axis(d2, order, -1)
    w = np.take_along_axis(win, order, -1).max(-1)
    return (np.diff(near, axis=-1) <= w[..., None]).any(-1)


class TestExpandedThreeNN:
    @pytest.mark.parametrize("mode", ["exact", "approx"])
    @pytest.mark.parametrize("n,m,c", [(2048, 512, 32), (300, 96, 8)])
    def test_matches_xla_three_nn(self, mode, n, m, c):
        rng = np.random.RandomState(n + m)
        u = _cloud(n, 2, n, z=1.0)
        k = _cloud(m + 1, 2, m, z=1.0)
        f = rng.randn(2, m, c).astype(np.float32)
        dist, idx = interpolate.three_nn(torch.tensor(u), torch.tensor(k),
                                         mode=mode)
        out, odist, oidx = interp.three_interpolate_fused(
            torch.tensor(u), torch.tensor(k), torch.tensor(f), expanded=True)
        assert torch.equal(oidx, idx) and torch.equal(odist, dist)
        jd, ji = jax_three_nn(jnp.asarray(u), jnp.asarray(k), mode=mode)
        bnd = _nn_boundary(u, k)
        print(f"three_nn {mode} n={n}: {int(bnd.sum())} boundary rows "
              f"excluded")
        assert bnd.mean() < 0.05
        np.testing.assert_array_equal(idx.numpy()[~bnd],
                                      np.asarray(ji)[~bnd])
        # Both take sqrt(max(d^2, 0)) of their own expanded d^2, which
        # agree within the window: hold d^2 to it.  The blend is held to
        # JAX's three_interpolate of the port's own neighbours and weights
        # (the weights 1/d amplify the d^2 rounding by 1/d^2 where a
        # neighbour is close).
        ok = ~bnd
        win = np.take_along_axis(_window(u, k), idx.numpy().astype(np.int64),
                                 -1)
        gap = np.abs(dist.numpy().astype(np.float64) ** 2
                     - np.asarray(jd).astype(np.float64) ** 2)
        assert (gap[ok] <= win[ok]).all()
        want = np.asarray(jax_interp(jnp.asarray(f), jnp.asarray(idx.numpy()),
                                     jax_idw(jnp.asarray(dist.numpy()))))
        np.testing.assert_allclose(out.numpy(), want, atol=1e-5)

    def test_expanded_differs_from_direct_form(self):
        """Coincident points: the direct form gives d = 0 exactly, the
        expanded form clamps its rounding at 0 before the sqrt."""
        k = _cloud(4, 1, 64, z=1.0)
        u = k[:, :16].copy()
        dd, _ = interpolate.three_nn(torch.tensor(u), torch.tensor(k))
        de, ie = interpolate.three_nn(torch.tensor(u), torch.tensor(k),
                                      mode="exact")
        assert (dd[..., 0] == 0).all()
        assert (de >= 0).all() and torch.isfinite(de).all()
        np.testing.assert_array_equal(ie[0, :, 0].numpy(), np.arange(16))
        with pytest.raises(ValueError):
            interpolate.three_nn(torch.tensor(u), torch.tensor(k),
                                 mode="nearest")

    def test_backward_is_shared(self):
        """The expanded instance's gradient is the shared backward of its
        own neighbours and weights."""
        rng = np.random.RandomState(6)
        u = torch.tensor(_cloud(6, 2, 80, z=1.0))
        k = torch.tensor(_cloud(7, 2, 20, z=1.0))
        f = torch.tensor(rng.randn(2, 20, 5).astype(np.float32),
                         requires_grad=True)
        g = torch.tensor(rng.randn(2, 80, 5).astype(np.float32))
        out, dist, idx = interp.three_interpolate_fused(u, k, f,
                                                        expanded=True)
        out.backward(g)
        want = interp.three_interpolate_backward_plain(g, idx, dist, 20)
        assert torch.equal(f.grad, want)


class TestGroupedFPS:
    @pytest.mark.parametrize("g,slab_sorted", [(2, False), (4, False),
                                               (4, True)])
    def test_matches_jax(self, g, slab_sorted):
        xyz = _cloud(40 + g, 2, 2048, z=1.0)
        got = sampling.furthest_point_sample(torch.tensor(xyz), 512,
                                             groups=g,
                                             slab_sorted=slab_sorted)
        want = jax_fps(jnp.asarray(xyz), 512, use_pallas=False, groups=g,
                       slab_sorted=slab_sorted)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_ties_in_spread_and_key(self):
        """A grid cloud: equal spreads on all axes (the first wins, as
        argmax) and runs of equal keys (the stable sort keeps index
        order), with duplicated points and skipped ones."""
        rng = np.random.RandomState(41)
        # Multiples of 1/8: every d^2 is exact in float32, so FPS's own
        # distance ties are ties in both packages, whatever their order.
        xyz = (rng.randint(0, 8, (2, 1024, 3)) * 0.125).astype(np.float32)
        xyz[:, :8] = 0.0
        got = sampling.furthest_point_sample(torch.tensor(xyz), 64, groups=4)
        want = jax_fps(jnp.asarray(xyz), 64, use_pallas=False, groups=4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["auto", "exact", "approx", "pallas"])
def test_resolve_query_mode_matches(mode):
    for train in (True, False):
        for backend in ("tpu", "cpu", "gpu", "cuda"):
            assert (resolve_query_mode(mode, train, backend)
                    == jax_resolve(mode, train, backend))
    # On the port's backend "auto" passes through to the exact query.
    assert resolve_query_mode("auto", True, BACKEND) == "auto"


# ------------------------------------------------- the whole small model

MODES = {
    "pallas": dict(query_mode="pallas", interp_mode="auto"),
    "approx+exact_interp": dict(query_mode="approx", interp_mode="exact"),
    "fps_groups4": dict(fps_groups=4),
    "bf16": dict(query_compute="bf16", interp_mode="approx"),
}


def _mode_cfg(base, name):
    return dataclasses.replace(base, pointnet2=dataclasses.replace(
        base.pointnet2, **MODES[name]))


@pytest.fixture(scope="module")
def small():
    """One seeded frame and one set of weights for every mode, as
    ``tests/test_torch_slice.py`` makes them."""
    base = small_model_cfg()
    variables, port_sd, _ = jax_and_port_weights(base, seed=12)
    rng = np.random.RandomState(12)
    n, h, w = base.n_sample_points, base.image_height, base.image_width
    xyz = (rng.rand(1, n, 3).astype(np.float32) - 0.5) * 0.3
    xyz[..., 2] += 1.0
    batch = [np.concatenate([xyz, rng.randn(1, n, 6).astype(np.float32)
                             * 0.5], -1),
             (rng.randn(1, h, w, 3) * 0.3).astype(np.float32),
             rng.choice(h * w, size=(1, n), replace=False).astype(np.int32)]
    model = PVN3D(to_port(base), sparse_cnn=False)
    model.load_state_dict(port_sd, strict=True)
    with torch.inference_mode():
        exact = model(*(torch.tensor(x) for x in batch))
    return base, variables, port_sd, batch, exact


@pytest.mark.parametrize("name", list(MODES))
def test_forward_matches_in_mode(small, name):
    """Eval forward in each deployment mode against JAX on the same
    weights and frame, within tests/test_torch_slice.py's tolerance (2e-3,
    seg agreement > 0.999); the mode changes the port's output (it is not
    ignored) wherever its neighbours differ from the exact ones."""
    base, variables, port_sd, batch, exact = small
    cfg = _mode_cfg(base, name)
    want = jax.jit(JaxPVN3D(cfg=cfg, train=False, sparse_cnn=False).apply)(
        variables, *(jnp.asarray(x) for x in batch))
    model = PVN3D(to_port(cfg), sparse_cnn=False)
    model.load_state_dict(port_sd, strict=True)
    with torch.inference_mode():
        got = model(*(torch.tensor(x) for x in batch))
    for k in ("seg_logits", "kp_offsets", "ctr_offsets"):
        ref = np.asarray(want[k])
        assert got[k].shape == ref.shape
        err = np.abs(got[k].numpy() - ref).max()
        assert err < 2e-3, f"{name} {k}: max abs err {err}"
    agree = (got["seg_logits"].numpy().argmax(-1)
             == np.asarray(want["seg_logits"]).argmax(-1)).mean()
    assert agree > 0.999
    if name != "approx+exact_interp":
        assert not torch.equal(got["seg_logits"], exact["seg_logits"])


@pytest.mark.parametrize("name", list(MODES))
def test_train_losses_match_in_mode(name):
    """Train mode (batch-statistics BN, ``resolve_query_mode`` with
    train=True) in each mode: the losses against JAX's on the same weights
    and batch, within tests/test_torch_train.py's 1e-5, on its shallow
    trunk without dropout."""
    from pvn3d_tpu.data.synthetic import synthetic_batch
    m = small_model_cfg()
    m = dataclasses.replace(
        m, image_height=64, image_width=64,
        cnn=dataclasses.replace(m.cnn, dropout_psp=0.0, dropout_up=0.0,
                                backbone_layers=(1, 1, 1, 1)))
    jcfg = jax_config.Config(model=_mode_cfg(m, name))
    pcfg = to_port(jcfg)
    port_sd = build_model(pcfg.model, seed=3).state_dict()
    variables = to_jax_variables(port_sd)
    batch = synthetic_batch(jcfg, batch_size=2, seed=5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out, _ = JaxPVN3D(cfg=jcfg.model, train=True).apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jb["pointcloud"],
        jb["rgb"], jb["choose"], 0.9, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)})
    want = jax_compute_losses(jcfg, out, jb)
    model = PVN3D(pcfg.model)
    model.load_state_dict(port_sd, strict=True)
    model.train()
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        got = compute_losses(pcfg, model(tb["pointcloud"], tb["rgb"],
                                         tb["choose"], 0.9), tb)
    for k in ("loss", "loss_seg", "loss_kp", "loss_ctr", "acc_rgbd"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=f"{name} {k}")


# ------------------------------------------------------ fusion widths

def test_fusion_widths_follow_the_branches():
    """``__graft_entry__._tiny_config`` (point branch 32 wide, so fusion
    1696 wide, not ``fusion_dim``'s 1792) builds, its weights map to and
    from the JAX tree leaf for leaf at those widths, and its forward
    matches JAX's."""
    import __graft_entry__ as graft
    jcfg = graft._tiny_config()
    mcfg = jcfg.model
    assert mcfg.pointnet2.fp_mlps[0][-1] == 32 and mcfg.fusion_dim == 1792
    pcfg = to_port(mcfg)
    check_supported(pcfg)
    port_sd = build_model(pcfg, seed=4).state_dict()
    assert port_sd["rgbd_feat.conv2_cld.weight"].shape == (256, 32, 1)
    assert port_sd["rgbd_feat.conv3.weight"].shape == (512, 160, 1)
    assert port_sd["SEG_layer.0.conv.weight"].shape[1] == 128 + 32 + 1536
    variables = to_jax_variables(port_sd)
    back = from_jax_variables(variables)
    assert set(back) == set(port_sd)
    for k, v in port_sd.items():
        assert torch.equal(back[k], v), k

    n, h, w = mcfg.n_sample_points, mcfg.image_height, mcfg.image_width
    rng = np.random.RandomState(7)
    xyz = (rng.rand(1, n, 3).astype(np.float32) - 0.5) * 0.3
    batch = [np.concatenate([xyz, rng.randn(1, n, 6).astype(np.float32)
                             * 0.5], -1),
             (rng.randn(1, h, w, 3) * 0.3).astype(np.float32),
             rng.choice(h * w, size=(1, n), replace=False).astype(np.int32)]
    jmodel = JaxPVN3D(cfg=mcfg, train=False, sparse_cnn=False)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *(jnp.asarray(x) for x in batch)))
    assert (jax.tree_util.tree_map(lambda a: a.shape, dict(shapes))
            == jax.tree_util.tree_map(np.shape, variables))
    want = jax.jit(jmodel.apply)(jax.tree_util.tree_map(jnp.asarray,
                                                        variables),
                                 *(jnp.asarray(x) for x in batch))
    model = PVN3D(pcfg, sparse_cnn=False)
    model.load_state_dict(port_sd, strict=True)
    with torch.inference_mode():
        got = model(*(torch.tensor(x) for x in batch))
    for k in ("seg_logits", "kp_offsets", "ctr_offsets"):
        ref = np.asarray(want[k])
        err = np.abs(got[k].numpy() - ref).max()
        assert err < 2e-3 * max(1.0, np.abs(ref).max()), f"{k}: {err}"


def test_tool_takes_the_mode_flags(tmp_path, monkeypatch):
    """``tools/synthetic_e2e.py``'s ``--tiny`` model is the JAX tool's,
    and its mode flags reach the configs they name: ``--fps_groups`` /
    ``--query_mode`` training and evaluation, the ``--eval_*``,
    ``--query_compute`` and ``--query_recall`` flags evaluation only."""
    import __graft_entry__ as graft
    from pvn3d_tpu_torch.inference import pipeline
    from pvn3d_tpu_torch.tools import synthetic_e2e
    from pvn3d_tpu_torch.train import state as train_state
    assert (dataclasses.asdict(synthetic_e2e.tiny_config().model)
            == dataclasses.asdict(graft._tiny_config().model))
    seen = {}

    def spy(name, fn):
        def wrapped(cfg, *a, **k):
            seen[name] = cfg.model.pointnet2
            return fn(cfg, *a, **k)
        return wrapped
    monkeypatch.setattr(train_state, "create_train_state",
                        spy("train", train_state.create_train_state))
    monkeypatch.setattr(pipeline, "make_inference_step",
                        spy("eval", pipeline.make_inference_step))
    ckpt = str(tmp_path / "tiny.pt")
    common = ["--tiny", "--device", "cpu", "--steps", "1", "--batch", "2",
              "--eval_frames", "2"]
    rec = synthetic_e2e.main(common + ["--fps_groups", "4", "--query_mode",
                                       "approx", "--save_ckpt", ckpt])
    assert rec["steps"] == 1
    for name in ("train", "eval"):
        assert (seen[name].fps_groups, seen[name].query_mode) == (4, "approx")
    rec = synthetic_e2e.main(common + [
        "--load_ckpt", ckpt, "--eval_query_mode", "pallas",
        "--eval_fps_groups", "2", "--query_compute", "bf16",
        "--query_recall", "0.95"])
    assert (seen["train"].fps_groups, seen["train"].query_mode,
            seen["train"].query_compute) == (1, "auto", "f32")
    ev = seen["eval"]
    assert (ev.fps_groups, ev.query_mode, ev.query_compute,
            ev.query_recall) == (2, "pallas", "bf16", 0.95)
    assert all(np.isfinite(v) for k, v in rec.items() if k != "metric")
