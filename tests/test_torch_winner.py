"""The algorithm K4's CUDA kernel follows, as a numpy model, against the
port's plain version and the JAX package's winner kernels (the Pallas K4 in
interpret mode and the XLA arm).

These tests hold the algorithm, not the CUDA: the kernel in
``pvn3d_tpu_torch/csrc/winner.cu`` runs only on a card, where
``chip_smoke.py`` holds it against its plain version bit for bit on these
cases and at the serving shapes.

The model, per hypothesis (a cluster of 8 CTAs of T threads: 256 when all H
clusters of such CTAs are resident on the card at once, else 128):
  - the row is cut into tiles of 2048 indices; each tile's valid points are
    compacted in index order by rounds of 2 x 32-point runs per warp, each
    valid lane placed after the warps before it (ballot + popc);
  - CTA r takes the r-th of 8 equal shares of each tile's compacted seeds,
    in blocks of 2 seeds a thread; the lanes of a block (a power of two,
    at most 32 and at most T // blocks) split the compacted points (lane l
    takes j = l, l + lanes, ...) over every tile, and a shuffle butterfly
    sums their partial counts;
  - each seed's key is count << 32 | (0xffffffff - index); the CTA keeps
    its largest, and the cluster takes the largest of the 8;
  - count 0 means winner 0; no valid point means winner 0, count 0 and a
    zero row; each CTA writes its share of the labels.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from pvn3d_tpu.inference.meanshift import _winner_stats
from pvn3d_tpu.ops.pallas.winner import winner_stats_fused

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch.ops.kernels import winner  # noqa: E402

_CLUSTER = 8
_SEEDS = 2
_STAGE = 2048
# Clusters of 256-thread CTAs resident on the card at once: the kernel asks
# the card (cudaOccupancyMaxActiveClusters); a stand-in here, between the
# pose stage's 21 and 168 hypotheses (the results do not depend on it).
_RESIDENT_CLUSTERS = 32


def threads_per_cta(h):
    """The launch's choice of threads per CTA for h hypotheses."""
    return 256 if h <= _RESIDENT_CLUSTERS else 128


def _sqdist(a, b):
    """(S, 3), (P, 3) -> (S, P) float32 in the kernel's direct form."""
    d = a[:, None, :] - b[None, :, :]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def _bw2(bandwidth):
    return np.float32(float(bandwidth) * float(bandwidth))


def stage_tile(mask_row, base, lim, threads=128):
    """The staging rounds of a CTA of ``threads`` (each warp loads enough
    32-point runs for a round to cover 512 points): the row indices of the
    valid points among [base, base + lim), at the places the ballots give
    them."""
    out = np.full(lim, -1, np.int64)
    n = 0
    warps = threads // 32
    runs = max(2, 512 // threads)
    for r0 in range(0, lim, threads * runs):
        bal, cnt = [], []
        for w in range(warps):
            words = []
            for q in range(runs):
                t = r0 + (w * runs + q) * 32 + np.arange(32)
                ok = t < lim
                ok[ok] = mask_row[base + t[ok]]
                words.append(ok)
            bal.append(words)
            cnt.append(sum(int(b.sum()) for b in words))
        for w in range(warps):
            off = n + sum(cnt[:w])
            for q in range(runs):
                b = bal[w][q]
                lanes = np.flatnonzero(b)
                # popc(ballot & lanes below)
                pos = off + np.cumsum(b)[lanes] - 1
                out[pos] = base + r0 + (w * runs + q) * 32 + lanes
                off += int(b.sum())
        n += sum(cnt)
    return out[:n]


def _pack(count, index):
    return (int(count) << 32) | (0xFFFFFFFF - int(index))


def label_shares(k, aligned=True):
    """Each CTA's [j0, j1) of the label row: whole groups of four where the
    row is (k % 4 == 0 and aligned pointers), else ceil(k / 8)."""
    vec = aligned and k % 4 == 0
    share = 4 * -(-k // (4 * _CLUSTER)) if vec else -(-k // _CLUSTER)
    return [(min(k, r * share), min(k, min(k, r * share) + share))
            for r in range(_CLUSTER)]


def model_winner(points, mask, bandwidth):
    """numpy model of the kernel: (H, K, 3) float32, (H, K) bool ->
    (win (H,) int32, labels (H, K) bool, counts (H,) int32)."""
    h, k, _ = points.shape
    bw2 = _bw2(bandwidth)
    threads = threads_per_cta(h)
    cap = max(1, min(k, _STAGE))
    tiles = -(-k // cap)
    win = np.zeros(h, np.int32)
    labels = np.zeros((h, k), bool)
    counts = np.zeros(h, np.int32)
    for hh in range(h):
        a, am = points[hh], mask[hh]
        staged = [stage_tile(am, t * cap, min(cap, k - t * cap), threads)
                  for t in range(tiles)]
        if sum(len(s) for s in staged) == 0:
            continue                  # winner 0, count 0, a zero row
        keys = []
        for r in range(_CLUSTER):
            best = 0
            for sidx in staged:
                n_a = len(sidx)
                c0, c1 = n_a * r // _CLUSTER, n_a * (r + 1) // _CLUSTER
                blocks = -(-(c1 - c0) // _SEEDS)
                if blocks == 0:
                    continue
                lanes = 1
                while lanes < 32 and 2 * lanes * blocks <= threads:
                    lanes *= 2
                groups = threads // lanes
                for b0 in range(0, blocks, groups):
                    first = c0 + b0 * _SEEDS
                    seeds = sidx[first:first + min(groups * _SEEDS,
                                                   c1 - first)]
                    s_cnt = np.zeros(len(seeds), np.int64)
                    for pidx in staged:
                        inb = _sqdist(a[seeds], a[pidx]) < bw2
                        part = np.stack([inb[:, lane::lanes].sum(1)
                                         for lane in range(lanes)], 1)
                        # The butterfly: lane l adds lane l ^ off's sum.
                        off = lanes // 2
                        while off:
                            part = part + part[:, np.arange(lanes) ^ off]
                            off //= 2
                        assert (part == part[:, :1]).all()
                        s_cnt += part[:, 0]
                    for c, i in zip(s_cnt, seeds):
                        best = max(best, _pack(c, i))
            keys.append(best)
        key = max(keys)
        count = key >> 32
        w = 0 if count == 0 else 0xFFFFFFFF - (key & 0xFFFFFFFF)
        row = am & am[w] & (_sqdist(a[w:w + 1], a)[0] < bw2)
        for j0, j1 in label_shares(k):
            labels[hh, j0:j1] = row[j0:j1]
        win[hh], counts[hh] = w, count
    return win, labels, counts


def _votes(rng, h, k, valid=0.7):
    """Clustered votes as chip_smoke.py makes them: three tight modes per
    hypothesis plus scatter."""
    modes = rng.randn(h, 3, 3).astype(np.float32) * 0.1
    pick = rng.randint(0, 3, (h, k))
    pts = (modes[np.arange(h)[:, None], pick]
           + rng.randn(h, k, 3).astype(np.float32) * 0.03)
    return pts.astype(np.float32), rng.rand(h, k) < valid


def _case(name):
    rng = np.random.RandomState(len(name))
    bw = 0.08
    if name == "H=21 K=512 70% valid":
        pts, msk = _votes(rng, 21, 512)
    elif name == "count ties straddling CTA shares":
        # Far-apart points (count 1 each) but for one point repeated at
        # indices in the shares of CTAs 0, 1, 3 and 7: four seeds tied at
        # count 4.  Row 1: the same with every third point invalid.
        pts = rng.randn(2, 512, 3).astype(np.float32) * 10.0
        for row, idx in enumerate(((63, 64, 200, 450), (61, 66, 301, 500))):
            pts[row, list(idx)] = pts[row, idx[0]]
        msk = np.ones((2, 512), bool)
        msk[1, ::3] = False
        msk[1, [61, 66, 301, 500]] = True
    elif name == "valid points only in the last slice":
        pts, _ = _votes(rng, 4, 512)
        msk = np.zeros((4, 512), bool)
        msk[:, 448:] = rng.rand(4, 64) < 0.8
    elif name == "an all-invalid hypothesis":
        pts, msk = _votes(rng, 3, 512)
        msk[1] = False
    elif name == "K=1":
        pts, msk = _votes(rng, 4, 1, valid=0.5)
        msk[0], msk[1] = True, False
    elif name == "K=7":
        pts, msk = _votes(rng, 5, 7, valid=0.6)
        msk[2] = False
    elif name == "K=1500":
        pts, msk = _votes(rng, 3, 1500)
    elif name == "K=2500, past the stage":
        # Row 1: valid points only in the second tile.
        pts, msk = _votes(rng, 3, 2500)
        msk[1, :2048] = False
    elif name == "bandwidth 0":
        pts, msk = _votes(rng, 3, 512)
        msk[:, 0] = False
        bw = 0.0
    else:   # duplicated points (d^2 = 0) on a grid at the bandwidth
        grid = rng.randint(-3, 4, (4, 128, 3)).astype(np.float32) * 0.04
        pts = np.concatenate([grid] * 4, axis=1)
        msk = rng.rand(4, 512) < 0.7
    return pts.astype(np.float32), msk, bw


_CASES = ["H=21 K=512 70% valid", "count ties straddling CTA shares",
          "valid points only in the last slice", "an all-invalid hypothesis",
          "K=1", "K=7", "K=1500", "K=2500, past the stage", "bandwidth 0",
          "duplicated points"]


@pytest.mark.parametrize("k", [1, 7, 64, 512, 513, 2047, 2048, 2500, 5000])
def test_staging_compacts_in_index_order(k):
    rng = np.random.RandomState(k)
    mask = rng.rand(k) < 0.6
    cap = min(k, _STAGE)
    for threads in (128, 256):
        got = np.concatenate([
            stage_tile(mask, t * cap, min(cap, k - t * cap), threads)
            for t in range(-(-k // cap))])
        np.testing.assert_array_equal(got, np.flatnonzero(mask))


@pytest.mark.parametrize("threads", [128, 256])
def test_lanes_split_every_share(threads):
    """For every share size a CTA can get, the seed blocks of a pass and
    their lanes fit the CTA, lanes are a power of two within a warp, and
    the passes cover every block."""
    for seeds in range(1, 2 * 2048 // _CLUSTER + 2):
        blocks = -(-seeds // _SEEDS)
        lanes = 1
        while lanes < 32 and 2 * lanes * blocks <= threads:
            lanes *= 2
        groups = threads // lanes
        assert lanes & (lanes - 1) == 0 and 32 % lanes == 0
        assert min(blocks, groups) * lanes <= threads
        assert len(range(0, blocks, groups)) * groups >= blocks


@pytest.mark.parametrize("k", [1, 7, 12, 100, 512, 1500, 2500])
def test_label_shares_cover_the_row(k):
    for aligned in (True, False):
        covered = np.zeros(k, int)
        for j0, j1 in label_shares(k, aligned):
            covered[j0:j1] += 1
            if aligned and k % 4 == 0:
                assert j0 % 4 == 0 and j1 % 4 == 0
        np.testing.assert_array_equal(covered, 1)


@pytest.mark.parametrize("case", _CASES)
def test_model_equals_plain_and_pallas(case):
    """The model, ``winner_stats`` on CPU tensors (the plain version) and
    JAX's Pallas K4 (interpret mode) agree exactly: winner, labels,
    count."""
    pts, msk, bw = _case(case)
    got = model_winner(pts, msk, bw)
    plain = winner.winner_stats(torch.tensor(pts), torch.tensor(msk), bw)
    pallas = winner_stats_fused(jnp.asarray(pts), jnp.asarray(msk), bw,
                                interpret=True)
    for g, p, j in zip(got, plain, pallas):
        np.testing.assert_array_equal(g, p.numpy())
        np.testing.assert_array_equal(g, np.asarray(j))


def test_case_properties():
    """The cases test what they are named for."""
    pts, msk, bw = _case("count ties straddling CTA shares")
    win, _, counts = model_winner(pts, msk, bw)
    np.testing.assert_array_equal(win, [63, 61])
    np.testing.assert_array_equal(counts, [4, 4])
    # Row 1's tied seeds 61 and 66 sit in the shares of two CTAs.
    sidx = stage_tile(msk[1], 0, 512)
    pos = np.searchsorted(sidx, [61, 66])
    n = len(sidx)
    ranks = [next(r for r in range(_CLUSTER)
                  if n * r // _CLUSTER <= p < n * (r + 1) // _CLUSTER)
             for p in pos]
    assert ranks[0] != ranks[1]
    pts, msk, bw = _case("bandwidth 0")
    win, labels, counts = model_winner(pts, msk, bw)
    assert (win == 0).all() and (counts == 0).all() and not labels.any()
    assert not msk[:, 0].any()
    pts, msk, bw = _case("K=2500, past the stage")
    win, _, counts = model_winner(pts, msk, bw)
    assert win[1] >= 2048 and counts[1] > 0
    pts, msk, bw = _case("duplicated points")
    d2 = _sqdist(pts[0], pts[0])
    assert (d2[msk[0]][:, msk[0]] == 0).sum() > msk[0].sum()
    assert (d2 == _bw2(bw)).any()


@pytest.mark.parametrize("case", ["H=21 K=512 70% valid",
                                  "count ties straddling CTA shares",
                                  "valid points only in the last slice"])
def test_model_equals_xla_outside_boundary_window(case):
    """Against JAX's XLA arm, whose expanded d^2 can flip pairs within
    float32 rounding of the bandwidth: only hypotheses with no such pair
    are compared (as ``tests/test_torch_ops.py`` does)."""
    pts, msk, bw = _case(case)
    d2 = np.sum((pts[:, :, None, :].astype(np.float64)
                 - pts[:, None, :, :]) ** 2, -1)
    clean = ~np.any(np.abs(d2 - bw * bw) < 1e-5 * bw * bw, axis=(1, 2))
    assert clean.any()
    got = model_winner(pts, msk, bw)
    want = _winner_stats(jnp.asarray(pts), jnp.asarray(msk), bw, 4,
                         impl="xla")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[clean], np.asarray(w)[clean])
