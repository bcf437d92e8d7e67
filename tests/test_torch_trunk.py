"""The port's torchvision ResNet-34 trunk seeding (``utils/
torch_convert.py``) and the train app's ``--pretrained_trunk`` against
the JAX package's ``load_state_from_torch(trunk_only=True)``.

The same seeded torchvision-named dict (``tests/test_torch_convert.py::
_fake_resnet34_sd``, plus the classifier and BN counters torchvision
saves) seeds both packages' trunks: afterwards the port's whole state
dict equals the JAX tree mapped across (``from_jax_variables``) exactly,
and the trunk's forward on the same image agrees within 1e-4 of the
output's largest magnitude (float32; ``tests/test_torch_models.py``'s
image-branch tolerance).  No torchvision import and no download.
"""
import dataclasses
import os

import numpy as np
import pytest

import jax.numpy as jnp

from pvn3d_tpu.models.resnet import DilatedResNet as JaxResNet
from pvn3d_tpu.utils.torch_convert import load_state_from_torch

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch.apps import train  # noqa: E402
from pvn3d_tpu_torch.config import Config  # noqa: E402
from pvn3d_tpu_torch.utils import torch_convert  # noqa: E402
from pvn3d_tpu_torch.utils.weights import (build_model,  # noqa: E402
                                           from_jax_variables)
from tests.test_torch_convert import _fake_resnet34_sd  # noqa: E402
from tests.test_torch_weights import (jax_and_port_weights,  # noqa: E402
                                      small_model_cfg, to_port)

PREFIX = "cnn.model.feats."


def _torchvision_sd(seed):
    """A torchvision resnet34 state dict's keys and shapes, seeded."""
    sd = _fake_resnet34_sd(np.random.RandomState(seed))
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = \
            torch.tensor(7)
    sd["fc.weight"] = torch.zeros(1000, 512)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


@dataclasses.dataclass(frozen=True)
class _JaxState:
    params: dict
    batch_stats: dict

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def test_trunk_matches_jax_after_loading_the_same_dict(tmp_path):
    cfg = small_model_cfg()
    variables, port_sd, _ = jax_and_port_weights(cfg, seed=3)
    path = str(tmp_path / "resnet34.pth")
    torch.save(_torchvision_sd(5), path)

    state = load_state_from_torch(_JaxState(**variables), path,
                                  trunk_only=True)
    model = build_model(to_port(cfg), 0)
    model.load_state_dict(port_sd)
    n = torch_convert.load_resnet34_into(model, path)
    assert n == len([k for k in model.state_dict() if k.startswith(PREFIX)
                     and not k.endswith("num_batches_tracked")])

    want_sd = from_jax_variables({"params": state.params,
                                  "batch_stats": state.batch_stats})
    got_sd = model.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for k, v in want_sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got_sd[k], v), k

    x = np.random.RandomState(6).randn(1, 64, 80, 3).astype(np.float32)
    trunk = {"params": state.params["cnn"]["trunk"],
             "batch_stats": state.batch_stats["cnn"]["trunk"]}
    want = np.asarray(JaxResNet(train=False).apply(trunk, jnp.asarray(x)))
    model.eval()
    with torch.no_grad():
        got = model.cnn.model.feats(torch.tensor(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 8, 10, 512)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def _trunk_model():
    return build_model(to_port(small_model_cfg()), 0)


@pytest.mark.parametrize("fault,error", [
    ("shape", ValueError), ("extra", KeyError), ("missing", KeyError),
    ("foreign_names", KeyError)])
def test_bad_dict_raises_and_copies_nothing(fault, error):
    model = _trunk_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sd = _torchvision_sd(1)
    if fault == "shape":
        sd["conv1.weight"] = torch.zeros(64, 4, 7, 7)
    elif fault == "extra":
        sd["layer4.3.conv1.weight"] = torch.zeros(512, 512, 3, 3)
    elif fault == "missing":
        del sd["layer2.0.downsample.1.running_mean"]
    else:
        sd = {"backbone." + k: v for k, v in sd.items()}
    with pytest.raises(error):
        torch_convert.load_resnet34_into(model, sd)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_converted_keys_drop_classifier_and_counters():
    out = torch_convert.convert_resnet34(_torchvision_sd(2))
    assert all(k.startswith(PREFIX) for k in out)
    assert not any("fc." in k or "num_batches" in k for k in out)
    assert out[PREFIX + "layer3.2.conv1.weight"].dtype == torch.float32


def test_train_pretrained_trunk_takes_a_step(tmp_path, monkeypatch,
                                             capsys):
    """``apps.train --pretrained_trunk``: the trunk equals the dict when
    the first step starts, and one step on the CPU moves it."""
    from pvn3d_tpu_torch.tools.fake_data import make_fake_ycb
    ycb = make_fake_ycb(str(tmp_path), n_frames=2, h=120, w=160,
                        cls_ids=(1, 2))
    monkeypatch.setattr(train, "base_config", lambda d, c: Config(
        model=to_port(small_model_cfg())))
    sd = _torchvision_sd(4)
    path = str(tmp_path / "resnet34.pth")
    torch.save(sd, path)
    seen = {}
    real = train.Trainer

    def trainer(cfg, state, train_step, *a, **kw):
        def first(st, batch, seed):
            if not seen:
                seen.update({k: v.clone() for k, v in
                             st.model.state_dict().items()
                             if k.startswith(PREFIX)})
            return train_step(st, batch, seed)
        return real(cfg, state, first, *a, **kw)
    monkeypatch.setattr(train, "Trainer", trainer)
    out = train.main(["--data_root", ycb, "--file_list",
                      os.path.join(ycb, "image_list.txt"),
                      "--checkpoint_dir", str(tmp_path / "run"),
                      "--pretrained_trunk", path, "--max_steps", "1",
                      "--batch_size", "2", "--workers", "0", "--device",
                      "cpu", "--log_every", "1"])
    assert out.state.step == 1
    assert f"seeded image trunk from {path}" in capsys.readouterr().out
    for k, v in sd.items():
        if not k.startswith("fc.") and "num_batches" not in k:
            assert torch.equal(seen[PREFIX + k], v), k
    after = out.state.model.state_dict()
    assert not torch.equal(after[PREFIX + "conv1.weight"],
                           sd["conv1.weight"])
