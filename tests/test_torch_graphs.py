"""The image branch's replayed CUDA graphs (``utils/graphs.py``) and the
constants that make it capturable (``models/layers.py::separable_tensor``),
on the CPU: the separable matrices are built once, equal to the numpy
functions', and usable by autograd after an inference-mode forward; the
gate leaves the CPU, train mode and autograd eager; ``_apply`` drops a
module's graphs; and a replay returns clones, never the graph's own
buffers.  The capture itself runs only on the card (``chip_smoke.py``
[image_graph])."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch.config import ffb6d_config  # noqa: E402
from pvn3d_tpu_torch.models import layers  # noqa: E402
from pvn3d_tpu_torch.models.ffb6d import FFB6D  # noqa: E402
from pvn3d_tpu_torch.models.pspnet import PSPNetEmbedding  # noqa: E402
from pvn3d_tpu_torch.utils import graphs  # noqa: E402

CPU = torch.device("cpu")
DTYPES = (torch.float32, torch.bfloat16)


def _branch(seed: int = 0) -> PSPNetEmbedding:
    torch.manual_seed(seed)
    return PSPNetEmbedding(n_classes=3, backbone_layers=(1, 1, 1, 1),
                           psp_out=32, up_channels=(16, 8, 8),
                           embedding_dim=8, fuse_up=True).eval()


def _rgb(b: int = 1, h: int = 32, w: int = 40) -> torch.Tensor:
    return torch.rand(b, h, w, 3, generator=torch.Generator().manual_seed(1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,src,dst,ac", [
    ("resize", 4, 60, False), ("resize", 8, 16, True),
    ("resize", 5, 5, True), ("shifted", 60, 120, True),
    ("pool", 60, 6, False), ("pool", 80, 3, False), ("pool", 7, 1, False)])
def test_separable_tensor_is_the_numpy_matrix_once(kind, src, dst, ac,
                                                    dtype):
    want = {"resize": lambda: layers._resize_matrix(src, dst, ac),
            "shifted": lambda: layers.shifted_resize_matrix(src, dst, ac),
            "pool": lambda: layers._adaptive_pool_matrix(src, dst)}[kind]()
    got = layers.separable_tensor(kind, src, dst, ac, dtype, CPU)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, torch.as_tensor(want).to(dtype))
    assert layers.separable_tensor(kind, src, dst, ac, dtype, CPU) is got
    assert not got.is_inference()


def test_separable_matrices_serve_autograd_after_inference():
    """An inference-mode forward makes the matrices; a train-mode forward
    and backward on the same shapes then use them."""
    layers.separable_tensor.cache_clear()
    model = _branch()
    with torch.inference_mode():
        model(_rgb())
    model.train()
    emb, seg = model(_rgb(b=2))
    (emb.float().square().mean() + seg.mean()).backward()
    grads = [p.grad for p in model.parameters() if p.requires_grad]
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)


@pytest.mark.parametrize("mode", ["eval_inference", "eval_no_grad",
                                  "train_no_grad", "eval_grad"])
def test_cpu_train_and_autograd_run_eagerly(mode):
    """The gate's rows that hold on the CPU: each runs ``fn`` as it is,
    records no key and counts nothing."""
    model = _branch()
    if mode.startswith("train"):
        model.train()
    calls = []

    def fn(x):
        calls.append(x)
        return x * 2

    x = torch.ones(3)
    before = (graphs.COUNTS.captures, graphs.COUNTS.replays)
    ctx = (torch.inference_mode() if mode == "eval_inference"
           else torch.enable_grad() if mode == "eval_grad"
           else torch.no_grad())
    with ctx:
        for _ in range(3):
            assert torch.equal(model.graphed(("s",), fn, x), x * 2)
    assert len(calls) == 3 and all(c is x for c in calls)
    assert not graphs.store(model).entries
    assert (graphs.COUNTS.captures, graphs.COUNTS.replays) == before


class _OnCard:
    """A stand-in input that reports itself on the card."""
    is_cuda = True


@pytest.mark.parametrize("on_card,training,grad,want", [
    (True, False, False, True),
    (False, False, False, False),
    (True, True, False, False),
    (True, False, True, False),
    (False, True, True, False)])
def test_gate_table(on_card, training, grad, want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    model = _branch().train(training)
    inp = (_OnCard() if on_card else torch.ones(1),)
    with torch.set_grad_enabled(grad):
        assert graphs.engages(model, inp) is want


def test_gate_leaves_a_call_inside_a_capture_eager(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with torch.no_grad():
        assert not graphs.engages(_branch(), (_OnCard(),))


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _planted(model, inputs, outputs):
    """A captured entry planted on ``model`` under the key of a call on
    ``inputs``."""
    fake = _FakeGraph()
    bufs = tuple(torch.zeros_like(t) for t in inputs)
    graphs.store(model).entries[graphs.graph_key(("s",), inputs)] = (
        graphs._Graph(fake, bufs, outputs))
    return fake, bufs


def _fake_capture(s, fn, inputs):
    """``graphs._capture`` on the CPU: ``fn`` run on copies of the inputs,
    a graph that only counts its replays."""
    bufs = tuple(t.clone() for t in inputs)
    graphs.COUNTS.captures += 1
    return graphs._Graph(_FakeGraph(), bufs, fn(*bufs))


def test_first_call_captures_and_later_calls_replay(monkeypatch):
    monkeypatch.setattr(graphs, "engages", lambda m, i: True)
    monkeypatch.setattr(graphs, "_capture", _fake_capture)
    model = _branch()
    c0, r0 = graphs.COUNTS.captures, graphs.COUNTS.replays
    counts = []
    with torch.no_grad():
        for x in (torch.ones(3), torch.full((3,), 2.0), torch.ones(4)):
            model.graphed(("s",), lambda t: t * 2, x)
            counts.append((graphs.COUNTS.captures - c0,
                           graphs.COUNTS.replays - r0))
    assert counts == [(1, 1), (1, 2), (2, 3)]
    entries = list(graphs.store(model).entries.values())
    assert [e.graph.replays for e in entries] == [2, 1]
    assert torch.equal(entries[0].inputs[0], torch.full((3,), 2.0))


@pytest.mark.parametrize("n_out", [1, 2])
def test_replay_returns_clones_of_the_graphs_outputs(n_out, monkeypatch):
    monkeypatch.setattr(graphs, "engages", lambda m, i: True)
    model = _branch()
    x = torch.arange(6.0)
    outs = tuple(torch.full((2, 3), float(k)).t() for k in range(n_out))
    held = outs[0] if n_out == 1 else outs
    fake, bufs = _planted(model, (x,), held)
    before = graphs.COUNTS.replays
    with torch.no_grad():
        got = model.graphed(("s",), lambda t: t, x)
    assert fake.replays == 1 and graphs.COUNTS.replays == before + 1
    assert torch.equal(bufs[0], x)                   # the input copied in
    got = (got,) if n_out == 1 else got
    for g, o in zip(got, outs):
        assert torch.equal(g, o) and g.stride() == o.stride()
        assert g.data_ptr() != o.data_ptr()
        o.add_(1.0)                                  # the next replay
        assert not torch.equal(g, o)


def test_keys_beyond_the_limit_drop_the_oldest(monkeypatch):
    monkeypatch.setattr(graphs, "engages", lambda m, i: True)
    monkeypatch.setattr(graphs, "_capture", _fake_capture)
    model = _branch()
    with torch.no_grad():
        for n in range(graphs.MAX_KEYS + 3):
            model.graphed(("s",), lambda t: t, torch.ones(n + 1))
    sizes = [k[1][0] for k in graphs.store(model).entries]
    assert sizes == [(n + 1,) for n in range(3, graphs.MAX_KEYS + 3)]


@pytest.mark.parametrize("move", ["to", "float", "cpu", "to_empty"])
def test_apply_drops_the_modules_graphs(move, monkeypatch):
    monkeypatch.setattr(graphs, "engages", lambda m, i: True)
    model = _branch()
    _planted(model, (torch.ones(2),), torch.ones(2))
    assert graphs.store(model).entries
    {"to": lambda: model.to(torch.float32), "float": model.float,
     "cpu": model.cpu,
     "to_empty": lambda: model.to_empty(device=CPU)}[move]()
    assert not graphs.store(model).entries


def test_a_parents_move_drops_the_branchs_graphs(monkeypatch):
    """``PVN3D.to`` reaches ``cnn.model._apply``; FFB6D holds its own."""
    monkeypatch.setattr(graphs, "engages", lambda m, i: True)
    parent = torch.nn.Module()
    parent.branch = _branch()
    _planted(parent.branch, (torch.ones(2),), torch.ones(2))
    parent.float()
    assert not graphs.store(parent.branch).entries
    cfg = ffb6d_config().model
    small = dataclasses.replace(
        cfg, cnn=dataclasses.replace(cfg.cnn, backbone_layers=(1, 1, 1, 1)))
    with torch.device("meta"):
        ffb6d = FFB6D(small)
    _planted(ffb6d, (torch.ones(2),), torch.ones(2))
    ffb6d.to_empty(device=CPU)
    assert not graphs.store(ffb6d).entries


def test_branch_outputs_on_the_cpu_are_the_eager_ones():
    """The graphed forward on the CPU is the eager forward, both tails."""
    model = _branch()
    rgb = _rgb()
    choose = torch.tensor([[0, 5, 39, 40, 1279]])
    with torch.inference_mode():
        for c in (None, choose):
            a = model(rgb, choose=c)
            b = model._forward(rgb, choose=c)
            for x, y in zip(a, b):
                assert torch.equal(x, y)
    assert np.isfinite(a[0].numpy()).all()
