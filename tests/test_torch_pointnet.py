"""Port of PointNet (pointcloudattack_tpu_torch/models) against the JAX model.

The JAX PointNet is initialised with flax, its BatchNorm statistics and
STN output layers are given seeded random values (so the BN fold and the
3x3 transform are exercised), and its variables are exported to the
reference state-dict layout with ``state_dict_from_flax``.  The port loads
them strictly and must give the same log-probs and the same input gradient
of the CW loss, at atol 1e-5, on the CPU (the plain chain version).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu import models as jmodels
from pointcloudattack_tpu.losses.adv import untargeted_logits_adv_loss as j_adv_loss
from pointcloudattack_tpu.losses.distance import l2_dist as j_l2_dist
from pointcloudattack_tpu.models.common import (
    PointMLP as JPointMLP,
    feature_transform_regularizer as j_ft_reg,
)
from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.losses.adv import untargeted_logits_adv_loss
from pointcloudattack_tpu_torch.losses.distance import l2_dist
from pointcloudattack_tpu_torch.models.common import (
    PointConv,
    PointMLP,
    feature_transform_regularizer,
)
from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
from pointcloudattack_tpu_torch.train.weights import state_dict_from_flax
from pointcloudattack_tpu_torch.utils.apply import make_model_fn

NUM_CLASSES, NUM_POINTS = 3, 64


def perturb(tree, rng, path=()):
    """numpy copy of flax variables with seeded BN statistics, BN affine
    and STN output layer (flax inits them to the identity and zeros)."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = perturb(v, rng, p)
            continue
        v = np.array(v, dtype=np.float32)  # a writable copy
        if k == "mean":
            v = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k == "var":
            v = (1.0 + 0.5 * rng.rand(*v.shape)).astype(np.float32)
        elif k == "scale":
            v = (1.0 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        elif k == "bias" and ("bn0" in p or "bn1" in p or "bn2" in p):
            v = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        elif "out" in p and ("stn" in p or "fstn" in p):
            v = (0.02 * rng.randn(*v.shape)).astype(np.float32)
        out[k] = v
    return out


def build_pair(feature_transform=False, seed=0):
    jm = jmodels.make_model("PointNet", NUM_CLASSES, feature_transform=feature_transform)
    v = jmodels.init_model(jm, jax.random.PRNGKey(seed), num_points=NUM_POINTS, batch=2)
    v = perturb(v, np.random.RandomState(seed))
    sd = state_dict_from_flax("PointNet", v, feature_transform=feature_transform)
    tm = models.make_model("PointNet", NUM_CLASSES, feature_transform=feature_transform)
    fn = make_model_fn(tm, sd, "cpu")
    jfn = jax.jit(lambda a: jm.apply(v, a, train=False)[0])
    return jfn, fn, tm


def clouds(seed, b=4):
    return np.random.RandomState(seed).randn(b, NUM_POINTS, 3).astype(np.float32) * 0.5


@pytest.mark.parametrize("feature_transform", [False, True])
def test_state_dict_loads_strictly_and_log_probs_match(feature_transform):
    jfn, fn, tm = build_pair(feature_transform)
    x = clouds(1)
    want = np.asarray(jfn(jnp.asarray(x)))
    got = fn(torch.from_numpy(x))
    assert not tm.training
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("feature_transform", [False, True])
def test_cw_loss_input_gradient_matches(feature_transform):
    jfn, fn, _ = build_pair(feature_transform, seed=1)
    ori = clouds(2)
    adv = ori + np.random.RandomState(3).randn(*ori.shape).astype(np.float32) * 0.01
    target = np.array([0, 1, 2, 0])
    w = np.float32(10.0)

    def jloss(a):
        lg = jfn(a)
        return jnp.sum(j_adv_loss(lg, jnp.asarray(target), 30.0) + j_l2_dist(a, jnp.asarray(ori)) * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(adv)))
    a = torch.from_numpy(adv).requires_grad_(True)
    loss = (untargeted_logits_adv_loss(fn(a), torch.from_numpy(target), 30.0)
            + l2_dist(a, torch.from_numpy(ori)) * float(w)).sum()
    loss.backward()
    np.testing.assert_allclose(a.grad.numpy(), want, rtol=0, atol=1e-5)


def test_cpu_forward_launches_no_kernel():
    _, fn, _ = build_pair()
    cm.reset_launches()
    a = torch.from_numpy(clouds(4)).requires_grad_(True)
    fn(a).sum().backward()
    assert cm.LAUNCHES == {"fwd": 0, "bwd": 0}


def _pointmlp_pair(rng):
    """A JAX PointMLP([64, 128], pool_max=True) and the port's over the
    same weights and BN state."""
    jm = JPointMLP([64, 128], pool_max=True)
    x0 = jnp.zeros((2, NUM_POINTS, 3))
    v = perturb(jm.init(jax.random.PRNGKey(4), x0), rng)
    pairs = []
    for i, (cin, cout) in enumerate([(3, 64), (64, 128)]):
        conv, bn = PointConv(cin, cout), torch.nn.BatchNorm1d(cout)
        d, p, s = v["params"][f"dense{i}"], v["params"][f"bn{i}"], v["batch_stats"][f"bn{i}"]
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(d["kernel"].T[:, :, None].copy()))
            conv.bias.copy_(torch.from_numpy(d["bias"]))
            bn.weight.copy_(torch.from_numpy(p["scale"]))
            bn.bias.copy_(torch.from_numpy(p["bias"]))
            bn.running_mean.copy_(torch.from_numpy(s["mean"]))
            bn.running_var.copy_(torch.from_numpy(s["var"]))
        pairs.append((conv, bn))
    return jm, v, PointMLP(pairs, pool_max=True)


@pytest.mark.parametrize("train", [False, True])
def test_point_mlp_matches_jax(train):
    """Eval (the fused chain's plain version) and train (unfused, batch
    statistics) against the JAX PointMLP; in train mode the running means
    move as flax's do (torch momentum 0.1 == flax momentum 0.9)."""
    jm, v, pm = _pointmlp_pair(np.random.RandomState(5))
    x = clouds(6)
    if train:
        want, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(v, jnp.asarray(x), train=False)
    got = pm(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    if train:
        for i, (_, bn) in enumerate(pm.pairs):
            np.testing.assert_allclose(
                bn.running_mean.numpy(), np.asarray(upd["batch_stats"][f"bn{i}"]["mean"]),
                rtol=0, atol=1e-6,
            )


def test_feature_transform_regularizer_matches():
    t = np.random.RandomState(7).randn(4, 3, 3).astype(np.float32)
    want = float(j_ft_reg(jnp.asarray(t)))
    got = float(feature_transform_regularizer(torch.from_numpy(t)))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


def test_make_model_draws_weights_from_the_generator():
    sds = [
        models.make_model("PointNet", NUM_CLASSES, generator=torch.Generator().manual_seed(s)).state_dict()
        for s in (0, 0, 1)
    ]
    assert all(torch.equal(sds[0][k], sds[1][k]) for k in sds[0])
    assert not torch.equal(sds[0]["feat.conv1.weight"], sds[2]["feat.conv1.weight"])
    # the STNs start at the identity transform, as the JAX model does
    assert torch.count_nonzero(sds[0]["feat.stn.fc3.weight"]) == 0
    with pytest.raises(KeyError):
        models.make_model("NoSuchModel", NUM_CLASSES)  # not a model
