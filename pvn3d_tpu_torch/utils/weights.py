"""Weights for the port: JAX variables mapped in, or seeded random ones.

``from_jax_variables`` is the inverse of the JAX package's
``utils/torch_convert.py::convert_pvn3d``: it maps a JAX
``{"params", "batch_stats"}`` tree (numpy arrays) onto the port's
``state_dict``, whose keys are the reference PyTorch checkpoint's
(``cnn.model.feats.*``, ``pointnet2.SA_modules.{i}.mlps.{j}.layer{k}.*``,
``rgbd_feat.*``, ``SEG_layer.*`` ...).  Conventions:

* Flax conv kernels ``(kh, kw, in, out)`` -> torch ``(out, in, kh, kw)``;
* Dense kernels ``(in, out)`` -> 1x1 conv weights ``(out, in, 1[, 1])``;
* BN ``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var``.

The reference's hidden head convs have no bias (a BN follows); the JAX
heads carry one (zero when converted from a reference checkpoint).  It is
folded into the BN's running mean, ``BN(x + b) = BN'(x)`` with
``mean' = mean - b``, which is exact for the zero bias of every converted
or freshly initialised JAX tree.

``to_jax_variables`` is the inverse of ``from_jax_variables`` (numpy
leaves, the hidden head biases as zeros), so a training step on each side
can be compared leaf by leaf in one layout; applied to the ``.grad`` of
every parameter it gives a gradient tree.  After training steps the JAX
heads' hidden biases are no longer zero (their exact gradient is zero, but
Adam turns rounding noise into steps of the learning rate) and the JAX
running mean carries them: compare those layers as ``mean - bias``, which
is what ``from_jax_variables`` yields.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from pvn3d_tpu_torch.config import FFB6DConfig, ModelConfig
from pvn3d_tpu_torch.models.layers import BatchNorm, PReLU
from pvn3d_tpu_torch.models.ffb6d import FFB6D
from pvn3d_tpu_torch.models.pvn3d import PVN3D


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _conv(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _dense(k, dims: int) -> torch.Tensor:
    w = np.ascontiguousarray(np.asarray(k, np.float32).T)
    return _t(w.reshape(w.shape + (1,) * (dims - 2)))


def _bn(sd: Dict, prefix: str, params: Mapping, stats: Mapping,
        fold_bias=None) -> None:
    mean = np.asarray(stats["mean"], np.float32)
    if fold_bias is not None:
        mean = mean - np.asarray(fold_bias, np.float32)
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(mean)
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _shared_mlp(sd: Dict, prefix: str, params: Mapping,
                stats: Mapping) -> None:
    k = 0
    while f"Dense_{k}" in params:
        sd[f"{prefix}.layer{k}.conv.weight"] = _dense(
            params[f"Dense_{k}"]["kernel"], 4)
        _bn(sd, f"{prefix}.layer{k}.normlayer.bn",
            params[f"BatchNorm_{k}"], stats[f"BatchNorm_{k}"])
        k += 1


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX PVN3D ``{"params", "batch_stats"}`` (numpy leaves) -> the port's
    ``state_dict`` (float32 CPU tensors, ``num_batches_tracked`` 0)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    tp, ts = p["cnn"]["trunk"], s["cnn"]["trunk"]
    pre = "cnn.model.feats"
    sd[f"{pre}.conv1.weight"] = _conv(tp["conv1"]["kernel"])
    _bn(sd, f"{pre}.bn1", tp["bn1"], ts["bn1"])
    for name in sorted(k for k in tp if k.startswith("layer")):
        stage, block = name[len("layer"):].split("_block")
        q = f"{pre}.layer{stage}.{block}"
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
            sd[f"{q}.{conv}.weight"] = _conv(tp[name][conv]["kernel"])
            _bn(sd, f"{q}.{bn}", tp[name][bn], ts[name][bn])
        if "down_conv" in tp[name]:
            sd[f"{q}.downsample.0.weight"] = _conv(
                tp[name]["down_conv"]["kernel"])
            _bn(sd, f"{q}.downsample.1", tp[name]["down_bn"],
                ts[name]["down_bn"])

    cp, cs = p["cnn"], s["cnn"]
    sizes = sorted(int(k[len("stage"):]) for k in cp["psp"]
                   if k.startswith("stage"))
    for i, size in enumerate(sizes):
        sd[f"cnn.model.psp.stages.{i}.1.weight"] = _conv(
            cp["psp"][f"stage{size}"]["kernel"])
    sd["cnn.model.psp.bottleneck.weight"] = _conv(
        cp["psp"]["bottleneck"]["kernel"])
    sd["cnn.model.psp.bottleneck.bias"] = _t(cp["psp"]["bottleneck"]["bias"])
    k = 1
    while f"up{k}" in cp:
        up = cp[f"up{k}"]
        sd[f"cnn.model.up_{k}.conv.1.weight"] = _conv(up["conv"]["kernel"])
        sd[f"cnn.model.up_{k}.conv.1.bias"] = _t(up["conv"]["bias"])
        _bn(sd, f"cnn.model.up_{k}.conv.2", up["bn"], cs[f"up{k}"]["bn"])
        sd[f"cnn.model.up_{k}.conv.3.weight"] = _t(
            np.reshape(up["prelu"]["alpha"], (1,)))
        k += 1
    for name in ("final", "final_seg"):
        sd[f"cnn.model.{name}.0.weight"] = _conv(cp[name]["kernel"])
        sd[f"cnn.model.{name}.0.bias"] = _t(cp[name]["bias"])

    pp, ps = p["pointnet2"], s["pointnet2"]
    i = 0
    while f"sa{i}" in pp:
        j = 0
        while f"mlp{j}" in pp[f"sa{i}"]:
            _shared_mlp(sd, f"pointnet2.SA_modules.{i}.mlps.{j}",
                        pp[f"sa{i}"][f"mlp{j}"], ps[f"sa{i}"][f"mlp{j}"])
            j += 1
        _shared_mlp(sd, f"pointnet2.FP_modules.{i}.mlp",
                    pp[f"fp{i}"]["mlp"], ps[f"fp{i}"]["mlp"])
        i += 1

    for name, dense in p["fusion"].items():
        sd[f"rgbd_feat.{name}.weight"] = _dense(dense["kernel"], 3)
        sd[f"rgbd_feat.{name}.bias"] = _t(dense["bias"])

    for torch_name, ours in (("SEG_layer", "seg_head"),
                             ("KpOF_layer", "kp_head"),
                             ("CtrOf_layer", "ctr_head")):
        hp, hs = p[ours], s[ours]
        k = 0
        while f"dense{k}" in hp:
            sd[f"{torch_name}.{k}.conv.weight"] = _dense(
                hp[f"dense{k}"]["kernel"], 3)
            _bn(sd, f"{torch_name}.{k}.normlayer.bn", hp[f"bn{k}"],
                hs[f"bn{k}"], fold_bias=hp[f"dense{k}"]["bias"])
            k += 1
        sd[f"{torch_name}.{k}.conv.weight"] = _dense(hp["out"]["kernel"], 3)
        sd[f"{torch_name}.{k}.conv.bias"] = _t(hp["out"]["bias"])
    return sd


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _conv_inv(w) -> np.ndarray:
    return np.transpose(_np(w), (2, 3, 1, 0))


def _dense_inv(w) -> np.ndarray:
    w = _np(w)
    return np.ascontiguousarray(w.reshape(w.shape[0], w.shape[1]).T)


def _bn_inv(sd: Mapping, prefix: str, params: Dict, stats: Dict) -> None:
    params["scale"] = _np(sd[f"{prefix}.weight"])
    params["bias"] = _np(sd[f"{prefix}.bias"])
    stats["mean"] = _np(sd[f"{prefix}.running_mean"])
    stats["var"] = _np(sd[f"{prefix}.running_var"])


def _shared_mlp_inv(sd: Mapping, prefix: str):
    params, stats, k = {}, {}, 0
    while f"{prefix}.layer{k}.conv.weight" in sd:
        params[f"Dense_{k}"] = {
            "kernel": _dense_inv(sd[f"{prefix}.layer{k}.conv.weight"])}
        params[f"BatchNorm_{k}"], stats[f"BatchNorm_{k}"] = {}, {}
        _bn_inv(sd, f"{prefix}.layer{k}.normlayer.bn",
                params[f"BatchNorm_{k}"], stats[f"BatchNorm_{k}"])
        k += 1
    return params, stats


def to_jax_variables(sd: Mapping, psp_sizes: Sequence[int] = (1, 2, 3, 6)
                     ) -> Dict[str, Dict]:
    """The port's ``state_dict`` (tensors or arrays) -> the JAX PVN3D
    ``{"params", "batch_stats"}`` tree with numpy leaves: the inverse of
    ``from_jax_variables``.  The JAX heads' hidden ``Dense`` biases, which
    the port does not have, come out as zeros."""
    p: Dict = {"cnn": {"trunk": {}, "psp": {}}, "pointnet2": {},
               "fusion": {}}
    s: Dict = {"cnn": {"trunk": {}}, "pointnet2": {}}

    tp, ts = p["cnn"]["trunk"], s["cnn"]["trunk"]
    pre = "cnn.model.feats"
    tp["conv1"] = {"kernel": _conv_inv(sd[f"{pre}.conv1.weight"])}
    tp["bn1"], ts["bn1"] = {}, {}
    _bn_inv(sd, f"{pre}.bn1", tp["bn1"], ts["bn1"])
    for stage in range(1, 5):
        block = 0
        while f"{pre}.layer{stage}.{block}.conv1.weight" in sd:
            q = f"{pre}.layer{stage}.{block}"
            bp, bs = {}, {}
            for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
                bp[conv] = {"kernel": _conv_inv(sd[f"{q}.{conv}.weight"])}
                bp[bn], bs[bn] = {}, {}
                _bn_inv(sd, f"{q}.{bn}", bp[bn], bs[bn])
            if f"{q}.downsample.0.weight" in sd:
                bp["down_conv"] = {
                    "kernel": _conv_inv(sd[f"{q}.downsample.0.weight"])}
                bp["down_bn"], bs["down_bn"] = {}, {}
                _bn_inv(sd, f"{q}.downsample.1", bp["down_bn"],
                        bs["down_bn"])
            tp[f"layer{stage}_block{block}"] = bp
            ts[f"layer{stage}_block{block}"] = bs
            block += 1

    cp, cs = p["cnn"], s["cnn"]
    for i, size in enumerate(sorted(psp_sizes)):
        cp["psp"][f"stage{size}"] = {
            "kernel": _conv_inv(sd[f"cnn.model.psp.stages.{i}.1.weight"])}
    cp["psp"]["bottleneck"] = {
        "kernel": _conv_inv(sd["cnn.model.psp.bottleneck.weight"]),
        "bias": _np(sd["cnn.model.psp.bottleneck.bias"])}
    k = 1
    while f"cnn.model.up_{k}.conv.1.weight" in sd:
        q = f"cnn.model.up_{k}.conv"
        up = {"conv": {"kernel": _conv_inv(sd[f"{q}.1.weight"]),
                       "bias": _np(sd[f"{q}.1.bias"])},
              "bn": {},
              "prelu": {"alpha": _np(sd[f"{q}.3.weight"]).reshape((1,))}}
        cs[f"up{k}"] = {"bn": {}}
        _bn_inv(sd, f"{q}.2", up["bn"], cs[f"up{k}"]["bn"])
        cp[f"up{k}"] = up
        k += 1
    for name in ("final", "final_seg"):
        cp[name] = {"kernel": _conv_inv(sd[f"cnn.model.{name}.0.weight"]),
                    "bias": _np(sd[f"cnn.model.{name}.0.bias"])}

    pp, ps = p["pointnet2"], s["pointnet2"]
    i = 0
    while f"pointnet2.FP_modules.{i}.mlp.layer0.conv.weight" in sd:
        pp[f"sa{i}"], ps[f"sa{i}"] = {}, {}
        j = 0
        while (f"pointnet2.SA_modules.{i}.mlps.{j}.layer0.conv.weight"
               in sd):
            pp[f"sa{i}"][f"mlp{j}"], ps[f"sa{i}"][f"mlp{j}"] = \
                _shared_mlp_inv(sd, f"pointnet2.SA_modules.{i}.mlps.{j}")
            j += 1
        mlp_p, mlp_s = _shared_mlp_inv(sd, f"pointnet2.FP_modules.{i}.mlp")
        pp[f"fp{i}"], ps[f"fp{i}"] = {"mlp": mlp_p}, {"mlp": mlp_s}
        i += 1

    for name in ("conv2_rgb", "conv2_cld", "conv3", "conv4"):
        p["fusion"][name] = {
            "kernel": _dense_inv(sd[f"rgbd_feat.{name}.weight"]),
            "bias": _np(sd[f"rgbd_feat.{name}.bias"])}

    for torch_name, ours in (("SEG_layer", "seg_head"),
                             ("KpOF_layer", "kp_head"),
                             ("CtrOf_layer", "ctr_head")):
        hp, hs = {}, {}
        k = 0
        while f"{torch_name}.{k}.normlayer.bn.weight" in sd:
            kernel = _dense_inv(sd[f"{torch_name}.{k}.conv.weight"])
            hp[f"dense{k}"] = {
                "kernel": kernel,
                "bias": np.zeros((kernel.shape[1],), np.float32)}
            hp[f"bn{k}"], hs[f"bn{k}"] = {}, {}
            _bn_inv(sd, f"{torch_name}.{k}.normlayer.bn", hp[f"bn{k}"],
                    hs[f"bn{k}"])
            k += 1
        hp["out"] = {"kernel": _dense_inv(sd[f"{torch_name}.{k}.conv.weight"]),
                     "bias": _np(sd[f"{torch_name}.{k}.conv.bias"])}
        p[ours], s[ours] = hp, hs
    return {"params": p, "batch_stats": s}


def seeded_state_dict(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Random weights for ``model`` from a numpy seed: conv and dense
    weights normal with std sqrt(1/fan_in) (so the deep trunk stays finite
    without trained BN statistics), other biases normal * 0.01, BN at
    identity, PReLU slopes 0.25."""
    rng = np.random.RandomState(seed)
    modules = dict(model.named_modules())
    out: Dict[str, torch.Tensor] = {}
    for name, t in model.state_dict().items():
        owner, leaf = name.rsplit(".", 1)
        mod = modules[owner]
        if isinstance(mod, BatchNorm):
            out[name] = torch.full_like(
                t, 1 if leaf in ("weight", "running_var") else 0)
        elif isinstance(mod, PReLU):
            out[name] = torch.full_like(t, 0.25)
        elif t.dim() > 1:
            fan_in = int(np.prod(t.shape[1:]))
            out[name] = torch.tensor(
                rng.randn(*t.shape).astype(np.float32)
                * np.float32(np.sqrt(1.0 / fan_in)))
        else:
            out[name] = torch.tensor(
                rng.randn(*t.shape).astype(np.float32) * np.float32(0.01))
    return out


def build_model(cfg: ModelConfig | FFB6DConfig, seed: int = 0) -> nn.Module:
    """A ``PVN3D`` for ``cfg`` (an ``FFB6D`` for an ``FFB6DConfig``) with
    ``seeded_state_dict`` weights, on the CPU (move it with
    ``.to(device)``)."""
    model = FFB6D(cfg) if isinstance(cfg, FFB6DConfig) else PVN3D(cfg)
    model.load_state_dict(seeded_state_dict(model, seed), strict=True)
    return model


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference PyTorch checkpoint's model state dict, on the CPU.

    Unwraps the reference tar layout (``model_state``,
    train_ycb_pvn3d.py:102-146) or a ``state_dict`` entry and strips the
    ``module.`` prefix of a DataParallel save.  The port's ``state_dict``
    keys are the reference's, so the result loads with
    ``model.load_state_dict(sd, strict=True)``, which checks every key and
    shape.  The file is unpickled in full (reference checkpoints hold
    numpy scalars beside the tensors): load only checkpoints you trust.
    """
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model_state" in obj:
        obj = obj["model_state"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k.replace("module.", "", 1) if k.startswith("module.") else k:
            torch.as_tensor(v) for k, v in obj.items()}
