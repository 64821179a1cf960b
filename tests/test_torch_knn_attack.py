"""The port's KNN attack and what it stands on (pointcloudattack_tpu_torch/
constraints/clip.py, losses/distance.py, losses/geometry.py,
attacks/knn.py, the ``attack knn`` CLI) against the JAX package, on the
CPU.

Tolerances: the clips and projections atol 1e-6 (a few f32 operations in
another order); the Chamfer and Hausdorff distances atol 1e-5 (the port
takes the TPU kernel's per-coordinate distance, the JAX CPU path
``xx - 2xy + yy``); ``nn1_idx`` exact.  The attacks run 10 iterations from
the JAX noise at N=1024, where the JAX package's Chamfer takes the row-min
path whose gradient reads only the argmin: on a victim with seeded
BatchNorm statistics, ``success`` identical and the adversarial clouds
within atol 1e-5; on one whose statistics come from the clouds, which
flips them, ``success`` identical (``test_knn_attack_flips_clouds_as_jax``
says why only that).
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu import models as jmodels
from pointcloudattack_tpu.attacks.knn import KNNAttackConfig as JKNNAttackConfig
from pointcloudattack_tpu.attacks.knn import build_knn_attack as j_build_knn_attack
from pointcloudattack_tpu.constraints import clip as jclip
from pointcloudattack_tpu.losses import distance as jdist
from pointcloudattack_tpu.losses.geometry import nn1_idx as j_nn1_idx
from pointcloudattack_tpu.train.torch_port import port_checkpoint
from pointcloudattack_tpu.utils.apply import make_model_fn as j_make_model_fn
from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.attacks.knn import KNNAttackConfig, build_knn_attack
from pointcloudattack_tpu_torch.cli.main import main as cli_main
from pointcloudattack_tpu_torch.constraints import clip
from pointcloudattack_tpu_torch.losses import distance
from pointcloudattack_tpu_torch.losses.geometry import nn1_idx
from pointcloudattack_tpu_torch.ops import chamfer
from pointcloudattack_tpu_torch.train.weights import state_dict_from_flax
from pointcloudattack_tpu_torch.utils.apply import make_model_fn

from test_torch_pointnet import perturb
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why

NUM_CLASSES = 10


def pair(seed, b=3, n=50, scale=0.1):
    rng = np.random.RandomState(seed)
    ori = rng.randn(b, n, 3).astype(np.float32)
    return (ori + rng.randn(b, n, 3).astype(np.float32) * scale), ori


def test_clip_points_l2_matches_jax():
    adv, ori = pair(0, scale=0.5)
    got = clip.clip_points_l2(torch.from_numpy(adv), torch.from_numpy(ori), 3.0).numpy()
    want = np.asarray(jclip.clip_points_l2(jnp.asarray(adv), jnp.asarray(ori), 3.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    moved = np.sqrt(((got - ori) ** 2).sum(axis=(1, 2)))
    assert moved.max() <= 3.0 * (1 + 1e-6) and (moved > 2.99).any()


def test_project_inner_points_matches_jax_with_anti_parallel_moves():
    adv, ori = pair(1)
    normal = np.random.RandomState(2).randn(*ori.shape).astype(np.float32)
    # points 0-4 move straight into the surface: their cross product is 0
    adv[:, :5] = ori[:, :5] - 0.3 * normal[:, :5]
    got = clip.project_inner_points(torch.from_numpy(adv), torch.from_numpy(ori), torch.from_numpy(normal)).numpy()
    want = np.asarray(jclip.project_inner_points(jnp.asarray(adv), jnp.asarray(ori), jnp.asarray(normal)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, :5], ori[:, :5])  # zeroed, not projected
    inner = ((adv - ori) * normal).sum(-1) < 0
    assert inner[:, 5:].any() and (~inner).any()
    np.testing.assert_array_equal(got[~inner], adv[~inner])  # outward moves untouched
    assert clip.project_inner_points(torch.from_numpy(adv), torch.from_numpy(ori), None) is not None


def test_project_inner_clip_linf_matches_jax():
    adv, ori = pair(3, scale=0.4)
    for nrm in (None, ori):
        got = clip.project_inner_clip_linf(torch.from_numpy(adv), torch.from_numpy(ori), 0.18,
                                           None if nrm is None else torch.from_numpy(nrm)).numpy()
        want = np.asarray(jclip.project_inner_clip_linf(jnp.asarray(adv), jnp.asarray(ori), 0.18,
                                                        None if nrm is None else jnp.asarray(nrm)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert np.sqrt(((got - ori) ** 2).sum(-1)).max() <= 0.18 * (1 + 1e-6)


@pytest.mark.parametrize("fn,methods", [
    ("chamfer_dist", ("adv2ori", "ori2adv", "both")),
    ("hausdorff_dist", ("adv2ori", "ori2adv", "both")),
    ("chamfer_both", (None,)),
    ("hausdorff_both", (None,)),
])
def test_distances_match_jax(fn, methods):
    adv, ori = pair(4, n=60)
    adv = adv[:, :45]  # the two clouds need not have the same size
    for method in methods:
        kw = {} if method is None else {"method": method}
        chamfer.reset_launches()
        got = getattr(distance, fn)(torch.from_numpy(adv), torch.from_numpy(ori), **kw)
        want = getattr(jdist, fn)(jnp.asarray(adv), jnp.asarray(ori), **kw)
        assert chamfer.LAUNCHES["min_rows"] == 0
        for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            assert tuple(g.shape) == (3,)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_chamfer_gradient_matches_jax():
    adv, ori = pair(5, n=40)

    def jloss(a):
        return jnp.sum(jdist.chamfer_dist(a, jnp.asarray(ori), "both"))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(adv)))
    a = torch.from_numpy(adv).requires_grad_(True)
    distance.chamfer_dist(a, torch.from_numpy(ori), "both").sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), want, rtol=0, atol=1e-5)


def test_nn1_idx_matches_jax():
    adv, ori = pair(6, n=80, scale=0.3)
    got = nn1_idx(torch.from_numpy(adv).requires_grad_(True), torch.from_numpy(ori))
    assert got.dtype == torch.int32 and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_nn1_idx(jnp.asarray(adv), jnp.asarray(ori))))


def clouds(seed, b, n=1024):
    return (np.random.RandomState(seed).randn(b, n, 3) * 0.5).astype(np.float32)


def victims(name, x, seed):
    """JAX and port model_fns over the same flax-initialised weights with
    seeded BatchNorm statistics (``perturb``): ``(jfn, fn)``; and the same
    with every BatchNorm's statistics from one train-mode pass over ``x``,
    carried back to flax with ``port_checkpoint``: ``(jfn_c, fn_c)``."""
    jm = jmodels.make_model(name, NUM_CLASSES)
    v = perturb(jmodels.init_model(jm, jax.random.PRNGKey(seed), num_points=x.shape[1], batch=2),
                np.random.RandomState(seed))
    sd = state_dict_from_flax(name, v)
    tm = models.make_model(name, NUM_CLASSES)
    tm.load_state_dict(sd, strict=True)
    tm.train()
    for m in tm.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            m.momentum = 1.0
        elif isinstance(m, torch.nn.Dropout):
            m.eval()
    with torch.no_grad():
        tm(torch.from_numpy(x))
    sd_c = {k: t.detach().clone() for k, t in tm.state_dict().items()}
    jv_c = port_checkpoint(name, {k: t.numpy() for k, t in sd_c.items()})
    port = lambda state: make_model_fn(models.make_model(name, NUM_CLASSES), state, "cpu")  # noqa: E731
    return (j_make_model_fn(jm, v), port(sd)), (j_make_model_fn(jm, jv_c), port(sd_c))


@pytest.fixture(scope="module", params=["PointNet", "PointNet++Ssg"], ids=["pointnet", "ssg"])
def victim(request):
    name = request.param
    x = clouds(9, 8)
    seeded, calibrated = victims(name, x, seed=1)
    return seeded, calibrated, x[: 4 if name == "PointNet" else 2]


def run_both(jfn, fn, x, **kw):
    """The JAX and the port attack from the same noise, against the clean
    predictions: ``(jax adv, jax success, adv, success)``."""
    target = np.asarray(jfn(jnp.asarray(x))).argmax(-1)
    key = jax.random.PRNGKey(3)
    cfg = dict(num_iter=10, kappa=30.0, budget=0.18, **kw)
    jadv, jsucc = j_build_knn_attack(jfn, JKNNAttackConfig(**cfg))(jnp.asarray(x), jnp.asarray(target), key)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    chamfer.reset_launches()
    adv, succ = build_knn_attack(fn, KNNAttackConfig(**cfg))(
        torch.from_numpy(x), torch.from_numpy(target), init_noise=torch.from_numpy(noise.copy()))
    assert chamfer.LAUNCHES["min_rows"] == 0
    assert np.sqrt(((adv.numpy() - x) ** 2).sum(-1)).max() <= 0.18 * (1 + 1e-5)
    return np.asarray(jadv), np.asarray(jsucc), adv.numpy(), succ.numpy()


@pytest.mark.parametrize("nn_refresh", [1, 5])
def test_build_knn_attack_matches_jax(victim, nn_refresh):
    """The seeded victim's logits barely follow the input, so no cloud
    flips in 10 steps, and every step's gradient is held through the
    iterates: within 1e-5 after 10 steps of about lr each."""
    (jfn, fn), _, x = victim
    jadv, jsucc, adv, succ = run_both(jfn, fn, x, nn_refresh=nn_refresh)
    np.testing.assert_array_equal(succ, jsucc)
    np.testing.assert_allclose(adv, jadv, rtol=0, atol=1e-5)
    assert np.abs(adv - x).max() > 5e-3  # the steps moved the points, 500x the tolerance


def test_knn_attack_flips_clouds_as_jax(victim):
    """With the statistics of the clouds the victim follows its input, and
    the attack flips clouds within 2 steps on both sides.  From there the
    iterates part (Adam turns a 1e-5 rounding difference of the adversarial
    gradient on a coordinate whose total gradient is near 0 into a step of
    the other sign), so only ``success`` is held."""
    _, (jfn, fn), x = victim
    _, jsucc, _, succ = run_both(jfn, fn, x)
    np.testing.assert_array_equal(succ, jsucc)
    assert succ.any()


def test_knn_attack_rejects_bad_settings():
    fn = lambda a: a.sum(1)  # noqa: E731
    with pytest.raises(ValueError, match="nn_refresh"):
        build_knn_attack(fn, KNNAttackConfig(nn_refresh=0))
    run = build_knn_attack(fn, KNNAttackConfig(num_iter=1))
    with pytest.raises(ValueError, match="init_noise"):
        run(torch.zeros(2, 8, 3), torch.zeros(2, dtype=torch.long), init_noise=torch.zeros(1, 2, 8, 3))


@pytest.mark.parametrize("model", ["PointNet", "DGCNN"])
def test_cli_attack_knn_on_cpu(tmp_path, capsys, model):
    out = tmp_path / "out"
    asr = cli_main([
        "attack", "knn", "--model", model, "--num_points", "64", "--num_classes", "3",
        "--num_iter", "3", "--attack_lr", "0.05", "--nn_refresh", "2", "--num_samples", "4",
        "--device", "cpu", "--output_dir", str(out), "--save_adv",
    ])
    printed = capsys.readouterr().out
    assert f"attack knn: ASR {asr:.3f}" in printed and "Chamfer " in printed
    summary = json.loads((out / "attack_knn_summary.json").read_text())
    assert summary["family"] == "knn" and summary["model"] == model and summary["n"] == 4
    assert 0 < summary["chamfer"] < summary["hausdorff"]
    assert len(list((out / "AdvData" / model).glob("knn_*_label*_pred*.txt"))) == 4
