"""The port's weight specs (pointcloudattack_tpu_torch/train/weights.py)
against the JAX package's exporter (train/torch_port.py::export_checkpoint).

The port keeps its own numpy-only copy of the torch-name <-> flax-path
specs, so that it imports nothing of the JAX package.  For flax-initialised
PointNet, PointNet++ SSG and MSG variables (DGCNN's: tests/test_torch_dgcnn.py;
CurveNet's: tests/test_torch_curvenet.py; PU-Net's spec entry by entry here, its
exported weights in tests/test_torch_punet.py)
the copy must give the same keys, shapes and values as
``export_checkpoint``, exactly.  The exported dicts load strictly into the
port's models.
"""

import numpy as np
import jax
import pytest

from pointcloudattack_tpu import models as jmodels
from pointcloudattack_tpu.train.torch_port import export_checkpoint, export_pointnet, punet_spec as j_punet_spec
from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.train.weights import SPECS, punet_spec, state_dict_from_flax
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why

CASES = [
    ("PointNet", {}),
    ("PointNet", {"feature_transform": True}),
    ("PointNet++Ssg", {}),
    ("PointNet++Msg", {}),
]


@pytest.fixture(scope="module")
def variables():
    """Flax-initialised variables per (model, kwargs) case, made once."""
    out = {}
    for name, kw in CASES:
        jm = jmodels.make_model(name, 10, **kw)
        out[name, tuple(kw.items())] = jmodels.init_model(jm, jax.random.PRNGKey(0), num_points=32, batch=1)
    return out


@pytest.mark.parametrize("name,kw", CASES, ids=["pointnet", "pointnet_ft", "ssg", "msg"])
def test_spec_copy_matches_export_checkpoint(variables, name, kw):
    v = variables[name, tuple(kw.items())]
    want = export_pointnet(v, **kw) if kw else export_checkpoint(name, v)
    got = state_dict_from_flax(name, v, **kw)
    assert list(got) == list(want)
    for key, arr in want.items():
        assert tuple(got[key].shape) == arr.shape, key
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    if name != "PointNet":  # the 1x1 Conv2d layout
        conv = next(k for k in got if k.endswith("mlp_convs.0.weight"))
        assert got[conv].dim() == 4 and got[conv].shape[2:] == (1, 1)


@pytest.mark.parametrize("name,kw", CASES, ids=["pointnet", "pointnet_ft", "ssg", "msg"])
def test_exported_state_dict_loads_strictly(variables, name, kw):
    sd = state_dict_from_flax(name, variables[name, tuple(kw.items())], **kw)
    models.make_model(name, 10, **kw).load_state_dict(sd, strict=True)


def test_unknown_model_raises():
    assert sorted(SPECS) == ["CurveNet", "DGCNN", "PUNet", "PointNet", "PointNet++Msg", "PointNet++Ssg"]
    with pytest.raises(KeyError, match="no weight spec"):
        state_dict_from_flax("NoSuchModel", {})


@pytest.mark.parametrize("up_ratio", [4, 2])
def test_punet_spec_copy_matches_jax(up_ratio):
    """PU-Net's spec (the reference's pu_net.py names, every layer a Conv2d
    1x1) entry by entry as the JAX package's."""
    got, want = punet_spec(up_ratio).entries, j_punet_spec(up_ratio).entries
    assert [(e.torch_name, e.flax_path, e.spatial) for e in got] == [(e.torch_name, e.flax_path, e.spatial)
                                                                    for e in want]
    assert len(got) == 12 + 3 + 2 * up_ratio + 2
