"""The image branch's eval forward as a replayed CUDA graph.

In eval mode the image branch is a fixed sequence of launches on fixed
shapes: about a thousand cuDNN, cuBLAS and elementwise launches a frame,
which the host dispatches one by one while the device idles.  Captured
once, the sequence replays with one host launch, and the same kernels
run on the device.

``Graphed`` is a module mixin.  ``self.graphed(static, fn, *inputs)``
returns ``fn(*inputs)`` (a tensor or a tuple of tensors), as a replay
where it engages.  It engages when what it can observe allows it: every
input on the card, the module in eval mode, autograd off, and no capture
already under way on the stream.  Otherwise ``fn`` runs eagerly, as it
would without the mixin: on the CPU, in train mode and wherever a
gradient is recorded.

One graph per key: ``static`` (the arguments ``fn`` closes over that
change what it launches, e.g. a stage's index or the CNN tail) and each
input's shape, strides, dtype and device.  The first call of a key runs
``fn`` once eagerly on the capture stream (the warm-up, in which cuDNN
and cuBLAS choose their algorithms and handles and the lazily built
constants, ``models/layers.py::separable_tensor``, are made), captures
it on copies of its inputs and replays; later calls copy their inputs
into those buffers and replay.  Every output is cloned
before it is returned, so no tensor of a graph's memory outlives its
call, and a caller may keep outputs across later replays.

The graphs of one module share one memory pool: replays run one after
another on the current stream, and each graph's outputs are read (cloned)
before the next replay, so the memory a graph's intermediates share with
another graph's outputs is never read stale.  ``_apply`` (``.to``,
``.cuda``, ``.float()``, ``to_empty``) drops every graph of the module, as
it moves or replaces the parameters a graph reads; ``load_state_dict``
copies into them in place, so a replay reads the new weights.

``COUNTS`` counts captures and replays, as a kernel's ``launches`` counts
its launches; a traced run sees each as a ``pvn3d.image_graph.capture`` or
``pvn3d.image_graph.replay`` range.
"""
from __future__ import annotations

import collections
import weakref
from typing import Callable, Dict, Tuple, Union

import torch
from torch import nn

from pvn3d_tpu_torch.utils.profiling import annotate

Outputs = Union[torch.Tensor, Tuple[torch.Tensor, ...]]

# Keys whose graphs a module keeps, the least recently used dropped first:
# PVN3D's image branch takes one key a deployment (the sparse tail at
# batch 1, or one dense batch size), FFB6D's eight image stages eight, so
# 16 holds two input signatures of either.
MAX_KEYS = 16


class Counts:
    """Captures and replays since the process started (or a caller set
    them to 0)."""

    def __init__(self):
        self.captures = 0
        self.replays = 0


COUNTS = Counts()


class _Graph:
    """A captured graph with its input buffers and outputs (the graph's
    own memory)."""

    def __init__(self, graph, inputs: Tuple[torch.Tensor, ...],
                 outputs: Outputs):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs


class _Store:
    """A module's graphs (key -> ``_Graph``) and the memory pool they
    share."""

    def __init__(self):
        self.entries: "collections.OrderedDict" = collections.OrderedDict()
        self.pool = None


# Module -> its store, kept beside the module (not in it), so that copying
# or pickling a module copies no graph.
_STORES: "weakref.WeakKeyDictionary[nn.Module, _Store]" = (
    weakref.WeakKeyDictionary())
# Device -> the side stream captures run on.
_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def engages(module: nn.Module, inputs: Tuple[torch.Tensor, ...]) -> bool:
    """Whether a call of ``module`` on ``inputs`` runs as a graph."""
    return (not module.training and not torch.is_grad_enabled()
            and all(t.is_cuda for t in inputs)
            and not torch.cuda.is_current_stream_capturing())


def graph_key(static: tuple, inputs: Tuple[torch.Tensor, ...]) -> tuple:
    """The key of a call's graph: ``static`` and each input's shape,
    strides, dtype and device."""
    return (static,) + tuple((tuple(t.shape), t.stride(), t.dtype, t.device)
                             for t in inputs)


def store(module: nn.Module) -> _Store:
    """``module``'s graphs (made empty at first use)."""
    s = _STORES.get(module)
    if s is None:
        s = _STORES[module] = _Store()
    return s


def _clone(out: Outputs) -> Outputs:
    if isinstance(out, torch.Tensor):
        return out.clone()
    return tuple(t.clone() for t in out)


def _capture(s: _Store, fn: Callable[..., Outputs],
             inputs: Tuple[torch.Tensor, ...]) -> _Graph:
    dev = inputs[0].device
    with torch.inference_mode(False):
        # Normal tensors, so that a later call outside inference mode may
        # copy into them.
        static = tuple(t.clone() for t in inputs)
    with torch.cuda.device(dev):
        stream = _STREAMS.get(dev)
        if stream is None:
            stream = _STREAMS[dev] = torch.cuda.Stream(dev)
        if s.pool is None:
            s.pool = torch.cuda.graph_pool_handle()
        # One eager run on the capture stream first (the warm-up), so the
        # libraries' algorithms and per-stream state (cuBLAS's workspace)
        # and the lazily built constants exist before capture.
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            fn(*static)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=s.pool, stream=stream):
            outputs = fn(*static)
    COUNTS.captures += 1
    return _Graph(graph, static, outputs)


def _replay(entry: _Graph, inputs: Tuple[torch.Tensor, ...]) -> Outputs:
    for buf, t in zip(entry.inputs, inputs):
        buf.copy_(t)
    entry.graph.replay()
    COUNTS.replays += 1
    return _clone(entry.outputs)


class Graphed(nn.Module):
    """Mixin: ``graphed`` runs a forward as a replayed CUDA graph where
    it engages (the module docstring)."""

    def graphed(self, static: tuple, fn: Callable[..., Outputs],
                *inputs: torch.Tensor) -> Outputs:
        if not engages(self, inputs):
            return fn(*inputs)
        key = graph_key(static, inputs)
        s = store(self)
        entry = s.entries.get(key)
        if entry is None:
            with annotate("pvn3d.image_graph.capture"):
                entry = s.entries[key] = _capture(s, fn, inputs)
            if len(s.entries) > MAX_KEYS:
                s.entries.popitem(last=False)
        s.entries.move_to_end(key)
        with annotate("pvn3d.image_graph.replay"):
            return _replay(entry, inputs)

    def _apply(self, fn, *args, **kwargs):
        _STORES.pop(self, None)
        return super()._apply(fn, *args, **kwargs)
