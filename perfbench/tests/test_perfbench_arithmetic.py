"""The yardstick's arithmetic: percentiles and rates over every sample,
the literal graph's FLOPs, the kernels' work and least times,
and the shares the per-layer readers take from a trace."""
import statistics

import pytest
import torch

from perfbench import spec, stats, work
from perfbench.drivers import common


def test_tail_is_the_tail_of_all_requests():
    """A stall holds 6% of the requests in one burst: the 95th percentile
    of all requests lands on it, a median of per-chunk ones would not."""
    lat = [10.0] * 1000
    lat[300:360] = [500.0] * 60
    assert stats.percentile(lat, 50) == 10.0
    assert stats.percentile(lat, 95) == 500.0
    chunks = [stats.percentile(lat[i:i + 100], 95)
              for i in range(0, 1000, 100)]
    assert statistics.median(chunks) == 10.0
    assert stats.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5


def test_rate_counts_all_work_over_all_time():
    assert stats.rate(24 * 17, 10.2) == pytest.approx(40.0)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_of_busy_intervals():
    assert stats.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0


def _model(name="ycb"):
    cell = next(w["name"] for w in spec.benchmark()["workloads"]
                if w["config"] == name)
    return spec.cell(cell)["config"]["program"]["model"]


def test_heads_and_fusion_flops_by_hand():
    n = 12288
    heads = 0
    for widths, out in (((1024, 512, 128), 22), ((1024, 512, 256), 24),
                        ((1024, 512, 128), 3)):
        c = 1792
        for wd in widths + (out,):
            heads += 2 * n * c * wd
            c = wd
    fusion = 2 * n * (128 * 256 * 2 + 256 * 512 + 512 * 1024)
    assert work.fusion_heads_flops(_model()) == heads + fusion


def test_image_branch_flops_by_hand():
    conv = 2 * 240 * 320 * 3 * 64 * 49
    hw1, hw2 = 120 * 160, 60 * 80
    conv += 6 * 2 * hw1 * 64 * 64 * 9                       # layer1
    conv += 2 * hw2 * 9 * (64 * 128 + 7 * 128 * 128) + 2 * hw2 * 64 * 128
    conv += 2 * hw2 * 9 * (128 * 256 + 11 * 256 * 256) + 2 * hw2 * 128 * 256
    conv += 2 * hw2 * 9 * (256 * 512 + 5 * 512 * 512) + 2 * hw2 * 256 * 512
    conv += 2 * 512 * 512 * (1 + 4 + 9 + 36) + 2 * hw2 * 2560 * 1024
    conv += 2 * 9 * (4 * hw2 * 1024 * 256 + 16 * hw2 * 256 * 64
                     + 64 * hw2 * 64 * 64)
    conv += 2 * 64 * hw2 * 64 * (128 + 22)
    assert work.image_branch_flops(_model()) == conv


def test_forward_flops_of_the_published_graphs():
    assert work.forward_flops(_model()) / 1e9 == pytest.approx(594.6675,
                                                               abs=1e-3)
    lm = work.forward_flops(_model("linemod-ape"))
    assert work.forward_flops(_model()) - lm == pytest.approx(
        2 * 480 * 640 * 64 * 20 + 2 * 12288 * 128 * 20)


def test_kernel_work_on_known_shapes():
    xyz = torch.zeros(2, 100, 3)
    assert work.fps_work(xyz, 10, None) == (2 * (1200 + 40),
                                            2 * 9 * 100 * 9)
    n_bytes, flops = work.interp_work(torch.zeros(1, 8, 3),
                                      torch.zeros(1, 4, 3),
                                      torch.zeros(1, 4, 5))
    assert n_bytes == 8 * 12 + 4 * 12 + 4 * 5 * 4 + 8 * 5 * 4 + 8 * 24
    assert flops == 8 * 4 * 9 + 8 * 5 * 5
    mask = torch.tensor([[1, 1, 0], [0, 0, 0]], dtype=torch.bool)
    assert work.winner_work(torch.zeros(2, 3, 3), mask) == (
        2 * 3 * 14 + 16, (4 + 2) * 9.0)
    # K2: a centroid whose scale fills at index 5 tests 6 points, one that
    # never fills tests all 50.
    full = torch.tensor([[[1, 2, 3, 5]]], dtype=torch.int32)
    short = torch.tensor([[[7, 7, 7, 7]]], dtype=torch.int32)
    outs = [torch.cat([full, short], 1)]
    b, f = work.ball_query_work([0.1], [4], torch.zeros(1, 50, 3),
                                torch.zeros(1, 2, 3), outs)
    assert f == (6 + 50) * (work.D2_FLOPS + 1)
    assert b == 50 * 12 + 2 * 12 + 2 * 4 * 4


def test_least_time_takes_the_larger_bound():
    assert work.least_seconds(3.35e12, 0.0) == (1.0, "bytes")
    assert work.least_seconds(0.0, 67e12) == (1.0, "operations")


class _Trace:
    """A trace of two traced units of 1 s, a kernel call in each."""

    def __init__(self):
        self.spans = [
            {"name": "pb.unit#0", "layer": "unit", "tid": 1, "start": 0.0,
             "end": 1.0},
            {"name": "pb.unit#1", "layer": "unit", "tid": 1, "start": 1.0,
             "end": 2.0},
            {"name": "pb.k.fps#2", "layer": "k.fps", "tid": 1,
             "start": 0.1, "end": 0.2},
            {"name": "pb.k.fps#3", "layer": "k.fps", "tid": 1,
             "start": 1.1, "end": 1.2}]
        self.device = [{"name": "fps", "start": 0.15, "end": 0.65, "tid": 1,
                        "at": 0.12},
                       {"name": "fps", "start": 1.15, "end": 1.65, "tid": 1,
                        "at": 1.12}]

    def layer(self, layer):
        return [s for s in self.spans if s["layer"] == layer]

    def window(self):
        return 0.0, 2.0

    def busy_s(self):
        return stats.union_seconds([(d["start"], d["end"])
                                    for d in self.device])

    def device_in(self, rec):
        return sum(d["end"] - d["start"] for d in self.device
                   if rec["start"] <= d["at"] <= rec["end"])


def test_shares_read_from_a_trace():
    spans = type("S", (), {"calls": [
        {"span": "pb.k.fps#2", "work": lambda: (0.0, 67e12 * 0.1)},
        {"span": "pb.k.fps#3", "work": lambda: (3.35e12 * 0.05, 0.0)}]})()
    r = common.Reading(_Trace(), 1, 989e12 * 0.5, spans)
    assert r.idle_pct() == pytest.approx(50.0)
    assert r.mfu_pct(1.0) == pytest.approx(50.0)
    assert r.roofline_pct(["k.fps"]) == pytest.approx(15.0)
    assert r.roofline_pct(["k.winner"]) is None
    assert r.per_unit_ms(["k.fps"]) == pytest.approx(100.0)
    assert r.per_unit_ms(["image_branch"]) is None


def test_shares_over_the_untraced_unit_time():
    """Where the driver measured a unit's time untraced (here 0.8 s
    against 1 s traced), idle and MFU take it, not the traced window."""
    spans = type("S", (), {"calls": []})()
    r = common.Reading(_Trace(), 1, 989e12 * 0.5, spans, unit_s=0.8)
    assert r.idle_pct() == pytest.approx(100.0 * (1.0 - 0.5 / 0.8))
    assert r.mfu_pct(1.0) == pytest.approx(100.0 * 0.5 / 0.8)
    assert r.window_s() == pytest.approx(2.0)
