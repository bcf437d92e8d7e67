"""The algorithms K3's CUDA kernels follow, as numpy models, against the
port's plain versions and the JAX package's Pallas K3 (interpret mode).

These tests hold the algorithm, not the CUDA: the kernels in
``pvn3d_tpu_torch/csrc/interp.cu`` and ``interp_bwd.cu`` run only on a
card, where ``chip_smoke.py`` holds each against its plain version at the
serving and training shapes and at the edge shapes listed there.

(a) Forward search: lane l of a warp scans the known points j = l (mod 32)
    in index order with a running top-3 (strict '<'); a butterfly of 5
    xor-steps merges the 32 sorted lists under the (d^2, index) order,
    empty slots carrying (1e30, INT_MAX) until the end.
(b) Backward lists: the flattened idx is cut into tiles of 1024 entries;
    each tile's runs of 32 are ranked in order (a lane's rank = the tile's
    earlier entries with the same destination); per-tile counts are scanned
    down the tiles and across the destinations; each entry goes to
    start[j] + before_tile[j] + rank.  That is a stable counting sort, and
    summing each list in order is the backward.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pvn3d_tpu.ops.pallas.interp import three_interpolate_fused as jax_fused

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch.ops.kernels import interp  # noqa: E402

_EMPTY = np.float32(1e30)
_NONE = np.iinfo(np.int32).max
_LANES = 32


def _sqdist(u, k):
    """(R, 3), (m, 3) -> (R, m) float32 in the kernel's direct form."""
    d = u[:, None, :] - k[None, :, :]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def _before(da, ia, db, ib):
    return (da < db) | ((da == db) & (ia < ib))


def _merge(a_d, a_i, b_d, b_i):
    """Row-wise first three of two sorted 3-lists under (d^2, index), by
    the kernel's three take-the-smaller-head steps."""
    a_d, a_i, b_d, b_i = (x.copy() for x in (a_d, a_i, b_d, b_i))
    out_d = np.empty_like(a_d)
    out_i = np.empty_like(a_i)
    for s in range(3):
        take_b = _before(b_d[:, 0], b_i[:, 0], a_d[:, 0], a_i[:, 0])
        out_d[:, s] = np.where(take_b, b_d[:, 0], a_d[:, 0])
        out_i[:, s] = np.where(take_b, b_i[:, 0], a_i[:, 0])
        for src_d, src_i, shift in ((b_d, b_i, take_b), (a_d, a_i, ~take_b)):
            src_d[shift, :2] = src_d[shift, 1:].copy()
            src_i[shift, :2] = src_i[shift, 1:].copy()
    return out_d, out_i


def lane_split_three_nn(unknown, known):
    """numpy model of the forward kernel's search: (B, n, 3), (B, m, 3)
    float32 -> (d^2 (B, n, 3) float32, idx (B, n, 3) int32)."""
    b, n, _ = unknown.shape
    m = known.shape[1]
    out_d = np.empty((b, n, 3), np.float32)
    out_i = np.empty((b, n, 3), np.int32)
    for bb in range(b):
        d2 = _sqdist(unknown[bb], known[bb])
        # Per lane a running top-3, strict '<' in index order.
        top_d = np.full((n, _LANES, 3), _EMPTY, np.float32)
        top_i = np.full((n, _LANES, 3), _NONE, np.int64)
        for base in range(0, m, _LANES):
            for lane in range(min(_LANES, m - base)):
                j = base + lane
                d = d2[:, j]
                td, ti = top_d[:, lane], top_i[:, lane]
                lt2, lt1, lt0 = d < td[:, 2], d < td[:, 1], d < td[:, 0]
                new_d = np.stack([
                    np.where(lt0, d, td[:, 0]),
                    np.where(lt0, td[:, 0], np.where(lt1, d, td[:, 1])),
                    np.where(lt1, td[:, 1], np.where(lt2, d, td[:, 2]))], 1)
                new_i = np.stack([
                    np.where(lt0, j, ti[:, 0]),
                    np.where(lt0, ti[:, 0], np.where(lt1, j, ti[:, 1])),
                    np.where(lt1, ti[:, 1], np.where(lt2, j, ti[:, 2]))], 1)
                top_d[:, lane], top_i[:, lane] = new_d, new_i
        # Butterfly: lane l merges with lane l ^ off, every lane at once.
        lanes = np.arange(_LANES)
        for off in (16, 8, 4, 2, 1):
            part = lanes ^ off
            md, mi = _merge(top_d.reshape(-1, 3), top_i.reshape(-1, 3),
                            top_d[:, part].reshape(-1, 3),
                            top_i[:, part].reshape(-1, 3))
            top_d = md.reshape(n, _LANES, 3)
            top_i = mi.reshape(n, _LANES, 3)
        assert (top_d == top_d[:, :1]).all() and (top_i == top_i[:, :1]).all()
        out_d[bb] = top_d[:, 0]
        out_i[bb] = np.where(top_d[:, 0] >= _EMPTY, 0, top_i[:, 0])
    return out_d, out_i


def _tie_cloud(seed, b, n, m):
    """Integer-grid points: many exact distance ties, and known points
    duplicated at indices that fall to other lanes (j and j + 1, j + 5,
    j + 33) and to the same lane (j and j + 32)."""
    rng = np.random.RandomState(seed)
    known = rng.randint(-2, 3, (b, m, 3)).astype(np.float32)
    for src, dst in ((0, 1), (2, 7), (3, 36), (4, 37)):
        if dst < m:
            known[:, dst] = known[:, src]
    unknown = rng.randint(-4, 5, (b, n, 3)).astype(np.float32) * 0.5
    return unknown, known


_SEARCH_CASES = {
    "ties m=77": (0, 2, 96, 77),
    "ties m=130": (1, 1, 64, 130),
    "ties m=20 (< 32)": (2, 2, 64, 20),
    "ties m=2 (< 3)": (3, 2, 40, 2),
    "m=1": (4, 1, 30, 1),
}


@pytest.mark.parametrize("case", sorted(_SEARCH_CASES))
def test_lane_split_search_equals_plain_and_pallas(case):
    """(a) on tie-heavy clouds and with m < 32 and m < 3: the lane-split
    search with a butterfly merge equals ``three_nn_plain`` (d^2 and
    indices exactly) and the JAX package's Pallas K3 (indices exactly,
    distances within 1e-6)."""
    seed, b, n, m = _SEARCH_CASES[case]
    u, k = _tie_cloud(seed, b, n, m)
    d2, idx = lane_split_three_nn(u, k)
    want_d2, want_idx = interp.three_nn_plain(torch.tensor(u),
                                              torch.tensor(k))
    np.testing.assert_array_equal(idx, want_idx.numpy())
    np.testing.assert_array_equal(d2, want_d2.numpy())
    f = np.random.RandomState(seed).randn(b, m, 4).astype(np.float32)
    _, jd, ji = jax_fused(jnp.asarray(u), jnp.asarray(k), jnp.asarray(f),
                          1e-8, True)
    np.testing.assert_array_equal(idx, np.asarray(ji))
    np.testing.assert_allclose(np.sqrt(np.maximum(d2, 0)), np.asarray(jd),
                               rtol=1e-6)
    if m < 3:
        assert (d2[..., m:] == _EMPTY).all() and (idx[..., m:] == 0).all()
    else:
        # The cloud does put ties across lanes into the answers.
        assert (d2[..., 0] == d2[..., 1]).any()


def test_lane_split_search_random_cloud():
    """(a) on a generic random cloud (no ties), batch 2."""
    rng = np.random.RandomState(9)
    u = rng.randn(2, 120, 3).astype(np.float32)
    k = rng.randn(2, 200, 3).astype(np.float32)
    d2, idx = lane_split_three_nn(u, k)
    want_d2, want_idx = interp.three_nn_plain(torch.tensor(u),
                                              torch.tensor(k))
    np.testing.assert_array_equal(idx, want_idx.numpy())
    np.testing.assert_array_equal(d2, want_d2.numpy())


def tiled_counting_sort(flat, m, tile=interp.BWD_TILE):
    """numpy model of the backward kernel's list build: flat (B, 3n) int
    destinations -> (order (B, 3n): the entries p in list order, start
    (B, m + 1): each destination's first list slot)."""
    b, n3 = flat.shape
    tiles = -(-n3 // tile)
    order = np.full((b, n3), -1, np.int64)
    start = np.zeros((b, m + 1), np.int64)
    lower = np.tril(np.ones((_LANES, _LANES), bool), -1)
    for bb in range(b):
        counts = np.zeros((tiles, m), np.int64)
        rank = np.zeros(n3, np.int64)
        for t in range(tiles):
            ctr = np.zeros(m, np.int64)          # the tile's counter row
            for p0 in range(t * tile, min((t + 1) * tile, n3), _LANES):
                run = flat[bb, p0:p0 + _LANES]
                peers = run[None, :] == run[:, None]
                # A lane's rank: the counter, plus its lower peers (popc).
                rank[p0:p0 + len(run)] = ctr[run] + (
                    peers & lower[:len(run), :len(run)]).sum(1)
                np.add.at(ctr, np.unique(run),
                          np.unique(run, return_counts=True)[1])
            counts[t] = ctr
        before_tile = np.cumsum(counts, 0) - counts
        totals = counts.sum(0)
        start[bb, 1:] = np.cumsum(totals)
        p = np.arange(n3)
        j = flat[bb]
        pos = start[bb, j] + before_tile[p // tile, j] + rank
        order[bb, pos] = p
    return order, start


def list_backward(g_out, idx, dist, m, eps=1e-8):
    """The sum over the lists: row j = ((0 + w g) + w g) + ... in list
    order, float32 rounding at every step."""
    b, n, c = g_out.shape
    flat = idx.reshape(b, 3 * n).astype(np.int64)
    recip = np.float32(1.0) / (dist + np.float32(eps))
    w = (recip / ((recip[..., 0:1] + recip[..., 1:2]) + recip[..., 2:3]))
    w = w.reshape(b, 3 * n)
    order, start = tiled_counting_sort(flat, m)
    out = np.zeros((b, m, c), np.float32)
    for bb in range(b):
        for j in range(m):
            acc = np.zeros(c, np.float32)
            for p in order[bb, start[bb, j]:start[bb, j + 1]]:
                acc = acc + w[bb, p] * g_out[bb, p // 3]
            out[bb, j] = acc
    return out, order


def _bwd_case(name):
    rng = np.random.RandomState(len(name))
    if name == "random":
        b, n, m = 2, 500, 37
        idx = rng.randint(0, m, (b, n, 3))
    elif name == "m=1, one chain of 3n across tiles":
        b, n, m = 1, 700, 1
        idx = np.zeros((b, n, 3), np.int64)
    elif name == "one row takes all 3n, the rest get nothing":
        b, n, m = 1, 400, 50
        idx = np.full((b, n, 3), 17)
    elif name == "clustered, destinations nothing points at":
        b, n, m = 1, 600, 300
        idx = np.minimum(rng.geometric(0.2, (b, n, 3)) - 1, m - 1)
    else:   # B = 3, a different chain shape per batch row
        b, n, m = 3, 450, 40
        idx = np.stack([rng.randint(0, m, (n, 3)),
                        np.full((n, 3), 39),
                        np.minimum(rng.geometric(0.5, (n, 3)) - 1, m - 1)])
    c = 6
    g = rng.randn(b, n, c).astype(np.float32)
    dist = rng.rand(b, n, 3).astype(np.float32)
    return g, idx.astype(np.int32), dist, m


_BWD_CASES = ["random", "m=1, one chain of 3n across tiles",
              "one row takes all 3n, the rest get nothing",
              "clustered, destinations nothing points at",
              "B=3, three chain shapes"]


@pytest.mark.parametrize("case", _BWD_CASES)
def test_tiled_counting_sort_is_a_stable_sort(case):
    """(b) the list order equals a stable ``torch.sort`` of the flattened
    idx, and each destination's slice starts where the sort puts it."""
    _, idx, _, m = _bwd_case(case)
    b, n, _ = idx.shape
    flat = idx.reshape(b, 3 * n)
    order, start = tiled_counting_sort(flat.astype(np.int64), m)
    want = torch.sort(torch.tensor(flat).long(), dim=1, stable=True).indices
    np.testing.assert_array_equal(order, want.numpy())
    counts = np.stack([np.bincount(r, minlength=m) for r in flat])
    np.testing.assert_array_equal(np.diff(start, axis=1), counts)


@pytest.mark.parametrize("case", _BWD_CASES)
def test_list_backward_equals_plain_bit_for_bit(case):
    """(b) summing g_out over the lists in order equals
    ``three_interpolate_backward_plain`` bit for bit."""
    g, idx, dist, m = _bwd_case(case)
    got, _ = list_backward(g, idx, dist, m)
    want = interp.three_interpolate_backward_plain(
        torch.tensor(g), torch.tensor(idx), torch.tensor(dist), m)
    np.testing.assert_array_equal(got, want.numpy())


def test_list_backward_equals_pallas_vjp():
    """(b) against the JAX package: the list backward on the indices and
    distances the Pallas K3 returns equals ``jax.vjp`` of it (its custom
    VJP, an XLA scatter-add) within 1e-6 of the largest entry."""
    rng = np.random.RandomState(21)
    u = rng.randn(1, 300, 3).astype(np.float32)
    k = rng.randn(1, 40, 3).astype(np.float32)
    f = rng.randn(1, 40, 8).astype(np.float32)
    g = rng.randn(1, 300, 8).astype(np.float32)
    (_, jd, ji), vjp = jax.vjp(
        lambda ff: jax_fused(jnp.asarray(u), jnp.asarray(k), ff, 1e-8, True),
        jnp.asarray(f))
    zeros = (jnp.zeros((1, 300, 3), jnp.float32),
             np.zeros((1, 300, 3), jax.dtypes.float0))
    (want,) = vjp((jnp.asarray(g),) + zeros)
    got, _ = list_backward(g, np.asarray(ji), np.asarray(jd), 40)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())


def test_forward_grid_fills_the_card_at_batch_one():
    """Every serving level at batch 1 launches at least 132 blocks (one per
    SM of an H100), and the grid covers every row."""
    for n in (512, 1024, 2048, 12288):
        rows, warps, blocks = interp.forward_grid(1, n)
        assert rows in (1, 2, 4) and 1 <= warps <= 4
        assert blocks >= 132
        assert blocks * warps * rows >= n
    assert interp.forward_grid(1, 12288)[0] == 4
    assert interp.forward_grid(1, 512)[0] == 1


def test_backward_scratch_matches_the_tile_count():
    """The scratch holds two words per list entry, a rank per entry, two
    (B, tiles, m) tables, B * (m + 1) starts and B * (m + 1) words for the
    long lists and their count."""
    b, n, m = 4, 12288, 2048
    tiles = -(-3 * n // interp.BWD_TILE)
    assert tiles == 36
    assert interp.backward_scratch_words(b, n, m) == (
        2 * b * 3 * n + b * 3 * n + 2 * b * tiles * m + 2 * b * (m + 1))
    assert interp.backward_scratch_words(2, 0, 5) == 2 * 2 * 6
