"""The port's DGCNN (pointcloudattack_tpu_torch/models/dgcnn.py) against the
JAX model, on the CPU, at the published widths (EdgeConv 64-64-128-256,
emb 1024, head 512-256) with a small cloud and k: N=64, k=8.

The JAX model is initialised with flax, its BatchNorm statistics and affine
parameters are given seeded values (``perturb``), and its variables are
exported by the port's own spec copy (``state_dict_from_flax``) and loaded
strictly.  The port runs the plain versions of the kNN and gather kernels
(the fused gather + layer + max in eval mode); the JAX model its XLA path
(``graph_feature`` with the exact gather, then Dense, BN, LeakyReLU, max).

Tolerances: edge features exact (the same neighbours, gathered); EdgeConv
outputs and updated running means atol 1e-5; log-probs atol 1e-5; the
input gradient of the C&W loss atol 1e-5, rtol 1e-4 (sums over up to 512
channels in another order, each reaching a point through k neighbour
rows).  The kNN of the deeper stages runs on features the two sides
compute with rounding differences; the seeds give no near tie at any
stage's k-th neighbour, and a swapped neighbour would move the outputs far
beyond these tolerances.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu import models as jmodels
from pointcloudattack_tpu.attacks.cw import CWPerturbConfig as JCWPerturbConfig
from pointcloudattack_tpu.attacks.cw import build_cw_attack as j_build_cw_attack
from pointcloudattack_tpu.losses.adv import untargeted_logits_adv_loss as j_adv_loss
from pointcloudattack_tpu.losses.distance import l2_dist as j_l2_dist
from pointcloudattack_tpu.models.dgcnn import EdgeConv as JEdgeConv
from pointcloudattack_tpu.models.dgcnn import graph_feature as j_graph_feature
from pointcloudattack_tpu.train.torch_port import export_checkpoint, port_checkpoint
from pointcloudattack_tpu.utils.apply import make_model_fn as j_make_model_fn
from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.attacks.cw import CWPerturbConfig, build_cw_attack
from pointcloudattack_tpu_torch.losses.adv import untargeted_logits_adv_loss
from pointcloudattack_tpu_torch.losses.distance import l2_dist
from pointcloudattack_tpu_torch.models.common import PointConv
from pointcloudattack_tpu_torch.models.dgcnn import EdgeConv, graph_feature
from pointcloudattack_tpu_torch.ops import gather_chain as gc
from pointcloudattack_tpu_torch.ops import knn as knn_mod
from pointcloudattack_tpu_torch.train.weights import state_dict_from_flax
from pointcloudattack_tpu_torch.utils.apply import make_model_fn

from test_torch_pointnet import perturb
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why

NUM_CLASSES, N, K, B = 10, 64, 8, 2


def clouds(seed, b=B):
    return (np.random.RandomState(seed).randn(b, N, 3) * 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def dgcnn():
    """(jax model, flax variables with seeded statistics, jax model_fn,
    port model_fn)."""
    jm = jmodels.make_model("DGCNN", NUM_CLASSES, k=K)
    v = perturb(jmodels.init_model(jm, jax.random.PRNGKey(0), num_points=N, batch=B), np.random.RandomState(0))
    tm = models.make_model("DGCNN", NUM_CLASSES, k=K)
    fn = make_model_fn(tm, state_dict_from_flax("DGCNN", v), "cpu")
    return jm, v, j_make_model_fn(jm, v), fn


def test_weights_copy_matches_export_checkpoint(dgcnn):
    _, v, _, _ = dgcnn
    want = export_checkpoint("DGCNN", v)
    got = state_dict_from_flax("DGCNN", v)
    assert list(got) == list(want)
    for key, arr in want.items():
        assert tuple(got[key].shape) == arr.shape, key
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    assert got["conv1.0.weight"].shape == (64, 6, 1, 1) and got["conv5.0.weight"].shape == (1024, 512, 1)
    assert "conv1.0.bias" not in got and "linear1.bias" not in got and "linear2.bias" in got
    model = models.make_model("DGCNN", NUM_CLASSES)
    model.load_state_dict(got, strict=True)
    assert list(model.state_dict()) == list(got)
    assert models.OUTPUT_KIND["DGCNN"] == "log_probs"


@pytest.mark.parametrize("c,seed", [(3, 1), (64, 2)])
def test_graph_feature_matches_jax(c, seed):
    x = np.random.RandomState(seed).randn(B, N, c).astype(np.float32)
    got = graph_feature(torch.from_numpy(x), K).numpy()
    want = np.asarray(j_graph_feature(jnp.asarray(x), K, "exact"))
    assert got.shape == (B, N, K, 2 * c)
    np.testing.assert_array_equal(got, want)


def edgeconv_pair(c, out, seed):
    """A flax EdgeConv with seeded statistics and the port's EdgeConv over
    the same weights."""
    jm = JEdgeConv(out, K, gather_mode="exact")
    x = np.random.RandomState(seed).randn(B, N, c).astype(np.float32)
    v = perturb(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)), np.random.RandomState(seed))
    conv = PointConv(2 * c, out, spatial=2, bias=False)
    bn = torch.nn.BatchNorm1d(out)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.asarray(v["params"]["Dense_0"]["kernel"]).T[:, :, None, None]))
        bn.weight.copy_(torch.from_numpy(np.asarray(v["params"]["BatchNorm_0"]["scale"])))
        bn.bias.copy_(torch.from_numpy(np.asarray(v["params"]["BatchNorm_0"]["bias"])))
        bn.running_mean.copy_(torch.from_numpy(np.asarray(v["batch_stats"]["BatchNorm_0"]["mean"])))
        bn.running_var.copy_(torch.from_numpy(np.asarray(v["batch_stats"]["BatchNorm_0"]["var"])))
    return jm, v, EdgeConv(conv, bn, K), x


@pytest.mark.parametrize("c,out,seed", [(3, 64, 3), (64, 128, 4)])
def test_edgeconv_eval_matches_jax(c, out, seed):
    jm, v, edge, x = edgeconv_pair(c, out, seed)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    gc.reset_launches()
    knn_mod.reset_launches()
    got = edge(torch.from_numpy(x))
    assert gc.LAUNCHES["fwd"] == 0 and knn_mod.LAUNCHES["knn"] == 0  # plain versions on the CPU
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    # the fused route and the unfused layer agree
    unfused = edge.unfused(torch.from_numpy(x), knn_mod.knn(torch.from_numpy(x), K))
    np.testing.assert_allclose(got.detach().numpy(), unfused.detach().numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("c,out,seed", [(3, 64, 5), (64, 64, 6)])
def test_edgeconv_train_matches_jax(c, out, seed):
    """Train mode: batch statistics over the [B, N, k] edge rows, and the
    running mean moved as flax moves it (torch momentum 0.1 == flax 0.9)."""
    jm, v, edge, x = edgeconv_pair(c, out, seed)
    want, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = edge(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(edge.bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["BatchNorm_0"]["mean"]),
                               rtol=0, atol=1e-5)


def test_log_probs_match(dgcnn):
    _, _, jfn, fn = dgcnn
    x = clouds(1)
    got = fn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jfn(jnp.asarray(x))), rtol=0, atol=1e-5)


def test_cw_loss_input_gradient_matches(dgcnn):
    """The gradient reaches each point as a neighbour (dsrc) and as a
    center (dctr) of every EdgeConv stage."""
    _, _, jfn, fn = dgcnn
    ori = clouds(2)
    adv = ori + np.random.RandomState(3).randn(*ori.shape).astype(np.float32) * 0.01
    target = np.array([0, 1])

    def jloss(a):
        return jnp.sum(j_adv_loss(jfn(a), jnp.asarray(target), 30.0) + j_l2_dist(a, jnp.asarray(ori)) * 10.0)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(adv)))
    a = torch.from_numpy(adv).requires_grad_(True)
    gc.reset_launches()
    loss = (untargeted_logits_adv_loss(fn(a), torch.from_numpy(target), 30.0)
            + l2_dist(a, torch.from_numpy(ori)) * 10.0).sum()
    loss.backward()
    assert all(n == 0 for n in gc.LAUNCHES.values())
    np.testing.assert_allclose(a.grad.numpy(), want, rtol=1e-4, atol=1e-5)


def test_short_cw_attack_matches_jax(dgcnn):
    """1 x 5 C&W on a victim whose statistics come from the clouds (one
    train-mode pass, dropouts off), carried to flax with
    ``port_checkpoint``: ``success`` identical, ``best_dist`` rtol 1e-4,
    ``best_attack`` atol 1e-5."""
    jm, v, _, _ = dgcnn
    x = clouds(4, b=4)
    tm = models.make_model("DGCNN", NUM_CLASSES, k=K)
    tm.load_state_dict(state_dict_from_flax("DGCNN", v), strict=True)
    tm.train()
    tm.dp1.eval()
    tm.dp2.eval()
    for m in tm.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            m.momentum = 1.0
    with torch.no_grad():
        tm(torch.from_numpy(x))
    sd = {k: t.detach().clone() for k, t in tm.state_dict().items()}
    jfn = j_make_model_fn(jm, port_checkpoint("DGCNN", {k: t.numpy() for k, t in sd.items()}))
    fn = make_model_fn(models.make_model("DGCNN", NUM_CLASSES, k=K), sd, "cpu")
    target = np.asarray(jfn(jnp.asarray(x))).argmax(-1)  # the clean predictions
    kw = dict(binary_step=1, num_iter=5, kappa=30.0, budget=0.18, attack_lr=0.05)
    key = jax.random.PRNGKey(7)
    want = j_build_cw_attack(jfn, JCWPerturbConfig(**kw))(jnp.asarray(x), jnp.asarray(target), key)
    noise = np.stack([np.asarray(jax.random.normal(k, x.shape, jnp.float32)) for k in jax.random.split(key, 1)])
    got = build_cw_attack(fn, CWPerturbConfig(**kw))(
        torch.from_numpy(x), torch.from_numpy(target), init_noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    np.testing.assert_allclose(got.best_dist.numpy(), np.asarray(want.best_dist), rtol=1e-4)
    np.testing.assert_allclose(got.best_attack.numpy(), np.asarray(want.best_attack), rtol=0, atol=1e-5)
    # every success came from a gradient step: the clouds start at their clean prediction
    assert got.success.any() and float(got.best_dist[got.success].min()) > 1e-3
