"""The port's kernel modules (plain versions on the CPU) against the JAX
package's point ops and Pallas kernels (interpret mode), on the same
seeded numpy inputs."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pvn3d_tpu.inference.meanshift import _winner_stats
from pvn3d_tpu.ops.grouping import ball_query_multi as jax_ball_query
from pvn3d_tpu.ops.grouping import group_points as jax_group_points
from pvn3d_tpu.ops.interpolate import idw_weights as jax_idw
from pvn3d_tpu.ops.interpolate import three_interpolate as jax_interp
from pvn3d_tpu.ops.interpolate import three_nn as jax_three_nn
from pvn3d_tpu.ops.pallas.fps import fps_pallas
from pvn3d_tpu.ops.pallas.interp import three_interpolate_fused as jax_fused
from pvn3d_tpu.ops.pallas.winner import winner_stats_fused
from pvn3d_tpu.ops.sampling import furthest_point_sample as jax_fps
from pvn3d_tpu.ops.sampling import gather_points as jax_gather_points

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch.ops import grouping, interpolate, sampling  # noqa: E402
from pvn3d_tpu_torch.ops.kernels import (fps, interp, query,  # noqa: E402
                                         winner)


def _cloud(seed, b, n, scale=0.3):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, n, 3).astype(np.float32) - 0.5) * scale


class TestFPS:
    @pytest.mark.parametrize("b,n,m", [(1, 2048, 512), (3, 700, 96)])
    def test_matches_xla_and_pallas(self, b, n, m):
        xyz = _cloud(b * n, b, n)
        got = fps.fps(torch.tensor(xyz), m).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_fps(
            jnp.asarray(xyz), m, use_pallas=False)))
        np.testing.assert_array_equal(got, np.asarray(fps_pallas(
            jnp.asarray(xyz), m, interpret=True)))

    def test_skip_points_never_picked(self):
        xyz = _cloud(1, 2, 300, scale=4.0)
        xyz[:, 100:200] = 0.0
        got = fps.fps(torch.tensor(xyz), 64).numpy()
        assert not np.any((got >= 100) & (got < 200))
        np.testing.assert_array_equal(got, np.asarray(fps_pallas(
            jnp.asarray(xyz), 64, interpret=True)))

    def test_all_skip_row_gives_zero(self):
        xyz = np.zeros((2, 64, 3), np.float32)
        xyz[1] = _cloud(2, 1, 64, scale=4.0)[0]
        got = fps.fps(torch.tensor(xyz), 8).numpy()
        assert (got[0] == 0).all()
        np.testing.assert_array_equal(got, np.asarray(jax_fps(
            jnp.asarray(xyz), 8, use_pallas=False)))

    @pytest.mark.parametrize("b,distinct,copies,m", [(1, 100, 3, 150),
                                                     (2, 64, 4, 96)])
    def test_duplicates_beside_skipped(self, b, distinct, copies, m):
        """More picks than distinct real points: real points reach min-d^2
        0 and must still beat the skipped points (|p|^2 <= 1e-3), lowest
        index first."""
        xyz = np.tile(_cloud(11 + b, b, distinct, scale=4.0), (1, copies, 1))
        xyz[:, ::7] = 0.0
        got = fps.fps(torch.tensor(xyz), m).numpy()
        assert not np.any(np.take_along_axis(
            np.abs(xyz).sum(-1), got[:, 1:].astype(np.int64), 1) == 0)
        np.testing.assert_array_equal(got, np.asarray(jax_fps(
            jnp.asarray(xyz), m, use_pallas=False)))
        np.testing.assert_array_equal(got, np.asarray(fps_pallas(
            jnp.asarray(xyz), m, interpret=True)))

    def test_sampling_module(self):
        xyz = _cloud(3, 2, 256)
        idx = sampling.furthest_point_sample(torch.tensor(xyz), 32)
        got = sampling.gather_points(torch.tensor(xyz), idx).numpy()
        want = jax_gather_points(jnp.asarray(xyz), jnp.asarray(idx.numpy()))
        np.testing.assert_array_equal(got, np.asarray(want))
        # Grouped FPS runs (tests/test_torch_modes.py holds it against the
        # JAX package's); a G that does not divide N and m raises as there.
        grouped = sampling.furthest_point_sample(torch.tensor(xyz), 32,
                                                 groups=4).numpy()
        np.testing.assert_array_equal(grouped, np.asarray(jax_fps(
            jnp.asarray(xyz), 32, use_pallas=False, groups=4)))
        with pytest.raises(ValueError, match="groups=3"):
            sampling.furthest_point_sample(torch.tensor(xyz), 32, groups=3)


class TestBallQuery:
    @pytest.mark.parametrize("radii,ns", [((0.05, 0.1), (16, 32)),
                                          ((0.02, 0.04, 0.2), (4, 8, 64))])
    def test_matches_exact(self, radii, ns):
        xyz = _cloud(7, 2, 2048)
        cen = xyz[:, ::5] + 0.001
        got = query.ball_query(radii, ns, torch.tensor(xyz),
                               torch.tensor(cen))
        want = jax_ball_query(radii, ns, jnp.asarray(xyz), jnp.asarray(cen),
                              mode="exact")
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_no_hit_and_fewer_points_than_ns(self):
        xyz = _cloud(8, 1, 20)
        cen = np.concatenate([xyz[:, :3], np.full((1, 2, 3), 50.0,
                                                  np.float32)], axis=1)
        got = grouping.ball_query_multi((1.0,), (32,), torch.tensor(xyz),
                                        torch.tensor(cen))[0].numpy()
        want = jax_ball_query((1.0,), (32,), jnp.asarray(xyz),
                              jnp.asarray(cen), mode="exact")[0]
        np.testing.assert_array_equal(got, np.asarray(want))
        assert (got[0, 3:] == 0).all()

    @pytest.mark.parametrize("near", [
        list(range(40)) + list(range(70, 90)),   # > ns hits in one run
        list(range(28, 38)),                     # hits straddle 31/32
    ], ids=["over_ns_in_one_run", "straddle_31_32"])
    def test_runs_of_32(self, near):
        """Hits packed into runs of 32 consecutive indices, as the
        kernel's warp tests them: more hits than ns inside one run, and
        hits either side of the 31/32 boundary."""
        rng = np.random.RandomState(len(near))
        xyz = 5.0 + rng.rand(2, 130, 3).astype(np.float32)
        xyz[:, near] = (rng.rand(2, len(near), 3).astype(np.float32)
                        - 0.5) * 0.01
        cen = (rng.rand(2, 6, 3).astype(np.float32) - 0.5) * 0.01
        radii, ns = (0.05, 0.1, 0.2), (4, 8, 48)
        got = query.ball_query(radii, ns, torch.tensor(xyz),
                               torch.tensor(cen))
        want = jax_ball_query(radii, ns, jnp.asarray(xyz), jnp.asarray(cen),
                              mode="exact")
        for g, w, k in zip(got, want, ns):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert (g[..., :min(k, len(near))].numpy()
                    == np.asarray(near[:k])).all()

    def test_group_points(self):
        rng = np.random.RandomState(9)
        pts = rng.randn(2, 50, 5).astype(np.float32)
        idx = rng.randint(0, 50, (2, 7, 4)).astype(np.int32)
        got = grouping.group_points(torch.tensor(pts), torch.tensor(idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jax_group_points(jnp.asarray(pts), jnp.asarray(idx))))


class TestInterp:
    @pytest.mark.parametrize("n,m,c", [(1024, 256, 64), (300, 96, 32)])
    def test_matches_exact_path(self, n, m, c):
        rng = np.random.RandomState(n)
        u = rng.randn(2, n, 3).astype(np.float32)
        k = rng.randn(2, m, 3).astype(np.float32)
        f = rng.randn(2, m, c).astype(np.float32)
        out, dist, idx = interp.three_interpolate_fused(
            torch.tensor(u), torch.tensor(k), torch.tensor(f))
        jd, ji = jax_three_nn(jnp.asarray(u), jnp.asarray(k), mode="exact")
        want = jax_interp(jnp.asarray(f), ji, jax_idw(jd))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_allclose(dist.numpy(), np.asarray(jd), atol=1e-5)
        # The XLA arm's expanded |u|^2-2uk+|k|^2 d^2 carries ~1e-7 absolute
        # cancellation error; 1/d weighting amplifies it by 1/d^2 where the
        # nearest point is close (tests/test_pallas.py:124-127 notes the
        # same).  Hold the blend to 1e-5 on the rows whose nearest known
        # point is >= 0.2 away, where that amplification stays below it.
        far = np.asarray(jd)[..., 0] >= 0.2
        assert far.mean() > 0.3
        np.testing.assert_allclose(out.numpy()[far], np.asarray(want)[far],
                                   atol=1e-5)

    def test_matches_pallas_kernel(self):
        rng = np.random.RandomState(4)
        u = rng.randn(1, 400, 3).astype(np.float32)
        k = rng.randn(1, 130, 3).astype(np.float32)
        f = rng.randn(1, 130, 48).astype(np.float32)
        out, dist, idx = interp.three_interpolate_fused(
            torch.tensor(u), torch.tensor(k), torch.tensor(f))
        jo, jd, ji = jax_fused(jnp.asarray(u), jnp.asarray(k),
                               jnp.asarray(f), 1e-8, True)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_allclose(dist.numpy(), np.asarray(jd), atol=1e-6)
        # The Pallas blend is a default-precision (bf16-operand) MXU
        # matmul; off TPU interpret mode may round the same way, so allow
        # bf16 rounding of the weights: 2^-8 relative on |f| <= ~4.
        np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=3e-2)

    def test_tie_order_and_fewer_than_three(self):
        k = np.zeros((1, 5, 3), np.float32)
        k[0, 1] = k[0, 3] = [1.0, 0, 0]
        k[0, 2] = [2.0, 0, 0]
        k[0, 4] = [3.0, 0, 0]
        u = np.asarray([[[1.0, 0, 0]]], np.float32)
        f = np.arange(5, dtype=np.float32).reshape(1, 5, 1)
        _, _, idx = interp.three_interpolate_fused(
            torch.tensor(u), torch.tensor(k), torch.tensor(f))
        np.testing.assert_array_equal(idx.numpy()[0, 0], [1, 3, 0])
        k2 = np.asarray([[[0.0, 0, 0], [1.0, 0, 0]]], np.float32)
        u2 = np.asarray([[[0.1, 0, 0], [0.9, 0, 0]]], np.float32)
        f2 = np.asarray([[[10.0], [20.0]]], np.float32)
        out, dist, idx = interp.three_interpolate_fused(
            torch.tensor(u2), torch.tensor(k2), torch.tensor(f2))
        jo, jd, ji = jax_fused(jnp.asarray(u2), jnp.asarray(k2),
                               jnp.asarray(f2), 1e-8, True)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        assert np.all(dist.numpy()[0, :, 2] > 1e10)
        np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=1e-3)

    def test_interpolate_module(self):
        rng = np.random.RandomState(5)
        u = rng.randn(2, 64, 3).astype(np.float32)
        k = rng.randn(2, 16, 3).astype(np.float32)
        f = rng.randn(2, 16, 8).astype(np.float32)
        dist, idx = interpolate.three_nn(torch.tensor(u), torch.tensor(k))
        jd, ji = jax_three_nn(jnp.asarray(u), jnp.asarray(k), mode="exact")
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        w = interpolate.idw_weights(dist)
        got = interpolate.three_interpolate(torch.tensor(f), idx, w)
        want = jax_interp(jnp.asarray(f), ji, jax_idw(jd))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _vjp_cases():
    rng = np.random.RandomState(11)
    generic = (rng.randn(2, 300, 3), rng.randn(2, 96, 3), 32)
    # Ties: known points doubled (equal distances order by index) and
    # unknown points that sit on known ones (d = 0, weight ~1).
    k = rng.randn(1, 20, 3)
    ties = (np.concatenate([k[:, :10], rng.randn(1, 50, 3)], 1),
            np.concatenate([k, k], 1), 8)
    few = (rng.randn(2, 33, 3), rng.randn(2, 2, 3), 5)     # m < 3
    one = (rng.randn(1, 40, 3), rng.randn(1, 1, 3), 4)     # all slots -> 0
    empty = (rng.randn(1, 24, 3), rng.randn(1, 9, 3), 0)   # C = 0
    return {"generic": generic, "ties": ties, "m=2": few, "m=1": one,
            "C=0": empty}


class TestInterpBackward:
    @pytest.mark.parametrize("case", ["generic", "ties", "m=2", "m=1",
                                      "C=0"])
    def test_vjp_matches_pallas_vjp(self, case):
        """``jax.vjp`` of the Pallas function (interpret mode, its custom
        VJP ``_fused_bwd``) against ``ThreeInterpolateFused`` on the same
        inputs and cotangent: g_features within 1e-6 relative, no gradient
        for the coordinates."""
        u, k, c = _vjp_cases()[case]
        u, k = u.astype(np.float32), k.astype(np.float32)
        rng = np.random.RandomState(5)
        f = rng.randn(k.shape[0], k.shape[1], c).astype(np.float32)
        g = rng.randn(u.shape[0], u.shape[1], c).astype(np.float32)

        ut, kt = (torch.tensor(u, requires_grad=True),
                  torch.tensor(k, requires_grad=True))
        ft = torch.tensor(f, requires_grad=True)
        out, dist, idx = interp.three_interpolate_fused(ut, kt, ft)
        assert out.requires_grad
        assert not dist.requires_grad and not idx.requires_grad
        out.backward(torch.tensor(g))
        assert ut.grad is None and kt.grad is None
        assert ft.grad.shape == ft.shape and ft.grad.dtype == torch.float32
        if c == 0:
            # A zero-width block is no Pallas program; the port's empty
            # gradient has the features' shape and that is all to hold.
            return

        (_, _, ji), vjp = jax.vjp(
            lambda uu, kk, ff: jax_fused(uu, kk, ff, 1e-8, True),
            jnp.asarray(u), jnp.asarray(k), jnp.asarray(f))
        zeros = (jnp.zeros(u.shape[:2] + (3,), jnp.float32),
                 np.zeros(u.shape[:2] + (3,), jax.dtypes.float0))
        gu, gk, gf = vjp((jnp.asarray(g),) + zeros)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        assert not np.asarray(gu).any() and not np.asarray(gk).any()
        want = np.asarray(gf)
        np.testing.assert_allclose(ft.grad.numpy(), want,
                                   atol=1e-6 * np.abs(want).max())
        if case == "m=1":
            # Every slot of every unknown point names known point 0.
            assert (idx.numpy() == 0).all()

    def test_plain_backward_sums_in_index_order(self):
        """The plain backward is the ordered sum the kernel repeats:
        row j = ((0 + t_1) + t_2) + ... over its hits in (i, k) order."""
        rng = np.random.RandomState(2)
        b, n, m, c = 2, 60, 7, 5
        g = rng.randn(b, n, c).astype(np.float32)
        idx = rng.randint(0, m, (b, n, 3)).astype(np.int32)
        dist = rng.rand(b, n, 3).astype(np.float32)
        got = interp.three_interpolate_backward_plain(
            torch.tensor(g), torch.tensor(idx), torch.tensor(dist), m).numpy()
        recip = np.float32(1.0) / (dist + np.float32(1e-8))
        w = recip / ((recip[..., 0:1] + recip[..., 1:2]) + recip[..., 2:3])
        want = np.zeros((b, m, c), np.float32)
        for bb in range(b):
            for i in range(n):
                for k in range(3):
                    want[bb, idx[bb, i, k]] += w[bb, i, k] * g[bb, i]
        np.testing.assert_array_equal(got, want)
        assert interp.three_interpolate_backward(
            torch.tensor(g), torch.tensor(idx), torch.tensor(dist),
            m).equal(torch.tensor(want))

    def test_backward_is_the_adjoint_of_the_forward(self):
        """The blend is linear in the features, so <g, A f> = <A^T g, f>
        and a finite difference along any direction is exact up to
        rounding: both hold the backward to the forward."""
        rng = np.random.RandomState(3)
        u = torch.tensor(rng.randn(2, 50, 3).astype(np.float32))
        k = torch.tensor(rng.randn(2, 12, 3).astype(np.float32))
        f = torch.tensor(rng.randn(2, 12, 6).astype(np.float32),
                         requires_grad=True)
        g = torch.tensor(rng.randn(2, 50, 6).astype(np.float32))
        out, _, _ = interp.three_interpolate_fused(u, k, f)
        out.backward(g)
        lhs = float((g.double() * out.detach().double()).sum())
        rhs = float((f.grad.double() * f.detach().double()).sum())
        np.testing.assert_allclose(lhs, rhs, rtol=1e-5)
        direction = torch.tensor(rng.randn(2, 12, 6).astype(np.float32))
        h = 0.5
        plus, _, _ = interp.three_interpolate_fused(
            u, k, f.detach() + h * direction)
        minus, _, _ = interp.three_interpolate_fused(
            u, k, f.detach() - h * direction)
        fd = float((g.double() * (plus - minus).double()).sum()) / (2 * h)
        np.testing.assert_allclose(
            float((f.grad.double() * direction.double()).sum()), fd,
            rtol=1e-5)

    def test_no_graph_without_grad(self):
        """Serving: under ``inference_mode``, or with features that ask
        for no gradient, the wrapper is the forward alone."""
        rng = np.random.RandomState(4)
        u = torch.tensor(rng.randn(1, 30, 3).astype(np.float32))
        k = torch.tensor(rng.randn(1, 8, 3).astype(np.float32))
        f = torch.tensor(rng.randn(1, 8, 4).astype(np.float32))
        out, _, _ = interp.three_interpolate_fused(u, k, f)
        assert out.grad_fn is None
        with torch.inference_mode():
            out2, _, _ = interp.three_interpolate_fused(
                u, k, f.clone().requires_grad_(True))
        assert out2.grad_fn is None and torch.equal(out, out2)
        bf = f.to(torch.bfloat16).requires_grad_(True)
        out3, _, _ = interp.three_interpolate_fused(u, k, bf)
        out3.sum().backward()
        assert bf.grad.dtype == torch.bfloat16


class TestWinner:
    @pytest.mark.parametrize("h,k", [(21, 512), (5, 200)])
    def test_matches_pallas_kernel(self, h, k):
        rng = np.random.RandomState(h * 100 + k)
        pts = 0.05 * rng.randn(h, k, 3).astype(np.float32)
        msk = rng.rand(h, k) < 0.8
        msk[1] = False                        # an all-invalid hypothesis
        got = winner.winner_stats(torch.tensor(pts), torch.tensor(msk), 0.08)
        want = winner_stats_fused(jnp.asarray(pts), jnp.asarray(msk), 0.08,
                                  interpret=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_matches_xla_outside_boundary_window(self):
        # The JAX XLA arm's expanded d^2 can flip pairs within f32 rounding
        # of the bandwidth; compare only hypotheses with no such pair
        # (tests/test_pallas.py:255-259).
        rng = np.random.RandomState(3)
        pts = 0.05 * rng.randn(8, 300, 3).astype(np.float32)
        msk = rng.rand(8, 300) < 0.8
        bw = 0.08
        d2 = np.sum((pts[:, :, None, :].astype(np.float64)
                     - pts[:, None, :, :]) ** 2, -1)
        clean = ~np.any(np.abs(d2 - bw * bw) < 1e-5 * bw * bw, axis=(1, 2))
        assert clean.any()
        got = winner.winner_stats(torch.tensor(pts), torch.tensor(msk), bw)
        want = _winner_stats(jnp.asarray(pts), jnp.asarray(msk), bw, 4,
                             impl="xla")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy()[clean],
                                          np.asarray(w)[clean])
