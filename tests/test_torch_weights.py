"""The port's config, assets, data and weight mapping against the JAX
package's.  Also holds the small configuration the other
``test_torch_*`` files share (the port's ``small_model_config`` as a JAX
``ModelConfig``)."""
import dataclasses

import numpy as np
import pytest

from pvn3d_tpu import config as jax_config
from pvn3d_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from pvn3d_tpu.utils.assets import stacked_class_radii as jax_radii
from pvn3d_tpu.utils.assets import stacked_mesh_kps as jax_mesh_kps
from pvn3d_tpu.utils.torch_convert import convert_pvn3d

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pvn3d_tpu_torch import config as port_config  # noqa: E402
from pvn3d_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from pvn3d_tpu_torch.models.pvn3d import PVN3D  # noqa: E402
from pvn3d_tpu_torch.utils.assets import (stacked_class_radii,  # noqa: E402
                                          stacked_mesh_kps)
from pvn3d_tpu_torch.utils.weights import (build_model,  # noqa: E402
                                           from_jax_variables,
                                           seeded_state_dict,
                                           to_jax_variables)
from tests.test_torch_convert import _fake_pvn3d_sd  # noqa: E402


def _convert(obj, module):
    """The same-named dataclass of ``module``, field by field."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(module, type(obj).__name__)
        return cls(**{f.name: _convert(getattr(obj, f.name), module)
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_convert(o, module) for o in obj)
    return obj


def to_port(obj):
    """The port's copy of a JAX config dataclass."""
    return _convert(obj, port_config)


def small_model_cfg(compute_dtype: str = "float32"):
    """``port_config.small_model_config`` as a JAX ``ModelConfig`` (64x80
    image, 2048 points, SA npoints 512/256/128/32, narrow heads) with the
    exact point ops named explicitly."""
    cfg = _convert(port_config.small_model_config(), jax_config)
    return dataclasses.replace(
        cfg, compute_dtype=compute_dtype,
        pointnet2=dataclasses.replace(cfg.pointnet2, query_mode="exact",
                                      interp_mode="exact"))


def jax_and_port_weights(cfg, seed: int):
    """Random reference-checkpoint weights as a JAX variable tree and as
    the port's state_dict mapped from it."""
    sd = _fake_pvn3d_sd(np.random.RandomState(seed), cfg)
    variables = convert_pvn3d({k: v.numpy() for k, v in sd.items()})
    return variables, from_jax_variables(variables), sd


def test_config_copy_matches():
    for name in ("ycb", "linemod"):
        a = dataclasses.asdict(getattr(jax_config.Config, name)())
        b = dataclasses.asdict(getattr(port_config.Config, name)())
        assert a == b
    assert (dataclasses.asdict(to_port(small_model_cfg()))
            == dataclasses.asdict(small_model_cfg()))


def test_assets_match():
    np.testing.assert_array_equal(stacked_mesh_kps(), jax_mesh_kps("ycb"))
    np.testing.assert_array_equal(stacked_class_radii(), jax_radii("ycb"))


def test_synthetic_batch_matches():
    jcfg = jax_config.Config.ycb()
    a = jax_synthetic_batch(jcfg, batch_size=2, n_points=256, height=16,
                            width=20, seed=3)
    b = synthetic_batch(port_config.Config.ycb(), batch_size=2,
                        n_points=256, height=16, width=20, seed=3)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_from_jax_variables_inverts_convert_pvn3d():
    """Reference checkpoint -> JAX tree (convert_pvn3d) -> the port's
    state_dict gives back every reference key and value exactly, and the
    full-width port model takes it strictly."""
    cfg = jax_config.ModelConfig()
    _, port_sd, ref_sd = jax_and_port_weights(cfg, seed=0)
    got = {k: v for k, v in port_sd.items()
           if not k.endswith("num_batches_tracked")}
    assert set(got) == set(ref_sd)
    for k, v in ref_sd.items():
        assert got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    model = PVN3D(to_port(cfg))
    assert set(model.state_dict()) == set(port_sd)
    model.load_state_dict(port_sd, strict=True)


def test_to_jax_variables_inverts_from_jax_variables():
    """JAX tree -> the port's state_dict -> JAX tree gives back every leaf
    exactly, in the same structure and shapes (the hidden head biases,
    zero in a converted tree, come back as zeros)."""
    import jax
    variables, port_sd, _ = jax_and_port_weights(small_model_cfg(), seed=6)
    back = to_jax_variables(port_sd)
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(variables)}
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_leaves_with_path(back)}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    again = from_jax_variables(back)
    assert all(torch.equal(again[k], port_sd[k]) for k in port_sd)


def test_head_bias_folds_into_bn_mean():
    """A nonzero hidden-layer bias of a JAX head (the reference has none)
    moves into the following BN's running mean."""
    cfg = small_model_cfg()
    variables, port_sd, _ = jax_and_port_weights(cfg, seed=1)
    bias = np.full((cfg.seg_head[0],), 0.5, np.float32)
    variables["params"]["seg_head"]["dense0"]["bias"] = bias
    sd = from_jax_variables(variables)
    np.testing.assert_allclose(
        sd["SEG_layer.0.normlayer.bn.running_mean"].numpy(),
        port_sd["SEG_layer.0.normlayer.bn.running_mean"].numpy() - 0.5)


def test_seeded_state_dict_is_deterministic():
    cfg = to_port(small_model_cfg())
    a = build_model(cfg, seed=4).state_dict()
    b = seeded_state_dict(PVN3D(cfg), seed=4)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = seeded_state_dict(PVN3D(cfg), seed=5)
    assert not torch.equal(a["rgbd_feat.conv3.weight"],
                           c["rgbd_feat.conv3.weight"])
