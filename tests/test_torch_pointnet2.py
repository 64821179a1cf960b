"""Port of PointNet++ SSG and MSG (pointcloudattack_tpu_torch/models/
pointnet2.py) against the JAX models, on the CPU, at B=2, N=1024.

The JAX model is initialised with flax, its BatchNorm statistics are given
seeded random values (``perturb`` of tests/test_torch_pointnet.py), and its
variables are exported by the port's own spec copy
(``state_dict_from_flax``) and loaded strictly.  The port runs its plain
versions of the FPS and gather + chain kernels; the JAX side runs its
plain XLA path.  Tolerances: log-probs at atol 1e-5; the input gradient
of the CW loss at atol 1e-5 and rtol 1e-4 (it sums the cotangents of up to
a few hundred rows per point, each through f32 products of up to 259 terms
summed in another order, and a gradient component reaches 0.4).

A random victim with those statistics gives nearly the same logits for
every cloud, and a short attack flips none.  The CW test takes its victim's
set-abstraction statistics from one train-mode pass over the clouds (the
head's stay perturbed; taken from two clouds they would be degenerate) and
carries them to the JAX model with ``port_checkpoint``: then clouds flip
within three steps.  ``success`` must be identical and ``best_dist`` agree
at rtol 1e-4.  ``best_attack`` is not compared: Adam's first steps move a
coordinate by about +-lr whatever its gradient's size, so a gradient near 0
whose sign differs between the two sides moves a point of a cloud that
failed by up to 2*lr.
"""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu import models as jmodels
from pointcloudattack_tpu.attacks.cw import (
    CWPerturbConfig as JCWPerturbConfig,
    build_cw_attack as j_build_cw_attack,
)
from pointcloudattack_tpu.losses.adv import untargeted_logits_adv_loss as j_adv_loss
from pointcloudattack_tpu.losses.distance import l2_dist as j_l2_dist
from pointcloudattack_tpu.train.torch_port import port_checkpoint
from pointcloudattack_tpu.utils.apply import make_model_fn as j_make_model_fn
from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.attacks.cw import CWPerturbConfig, build_cw_attack
from pointcloudattack_tpu_torch.cli.main import main as cli_main
from pointcloudattack_tpu_torch.losses.adv import untargeted_logits_adv_loss
from pointcloudattack_tpu_torch.losses.distance import l2_dist
from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
from pointcloudattack_tpu_torch.ops import fps as fps_mod
from pointcloudattack_tpu_torch.ops import gather_chain as gc
from pointcloudattack_tpu_torch.train.weights import state_dict_from_flax
from pointcloudattack_tpu_torch.utils.apply import make_model_fn

from test_torch_pointnet import perturb

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import GRAD_CLEAN, GRAD_REL  # noqa: E402  (the card-against-CPU gradient bounds)
from torch_threads import threads  # noqa: E402

torch_threads = threads(2)  # tests/torch_threads.py says why

NUM_CLASSES, NUM_POINTS, B = 10, 1024, 2
NAMES = ["PointNet++Ssg", "PointNet++Msg"]


def clouds(seed, b=B):
    return (np.random.RandomState(seed).randn(b, NUM_POINTS, 3) * 0.5).astype(np.float32)


@pytest.fixture(scope="module", params=NAMES, ids=["ssg", "msg"])
def pair(request):
    """(name, jax model, flax variables, jax model_fn, port model_fn)."""
    name = request.param
    jm = jmodels.make_model(name, NUM_CLASSES)
    v = jmodels.init_model(jm, jax.random.PRNGKey(0), num_points=NUM_POINTS, batch=B)
    v = perturb(v, np.random.RandomState(0))
    tm = models.make_model(name, NUM_CLASSES)
    fn = make_model_fn(tm, state_dict_from_flax(name, v), "cpu")
    assert not tm.training
    return name, jm, v, j_make_model_fn(jm, v), fn


def test_log_probs_match(pair):
    _, _, _, jfn, fn = pair
    x = clouds(1)
    for m in (fps_mod, gc, cm):
        m.reset_launches()
    got = fn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jfn(jnp.asarray(x))), rtol=0, atol=1e-5)
    # the CPU runs the plain versions: no kernel launched
    assert fps_mod.LAUNCHES["fps"] == 0 and gc.LAUNCHES["fwd"] == 0 and cm.LAUNCHES["fwd"] == 0


def test_cw_loss_input_gradient_matches(pair):
    """The gradient reaches the input through the gathered rows (dsrc) and
    through the FPS centroids (dctr, then index_points)."""
    _, _, _, jfn, fn = pair
    ori = clouds(2)
    adv = ori + np.random.RandomState(3).randn(*ori.shape).astype(np.float32) * 0.01
    target = np.array([0, 1])
    w = np.float32(10.0)

    def jloss(a):
        lg = jfn(a)
        return jnp.sum(j_adv_loss(lg, jnp.asarray(target), 30.0) + j_l2_dist(a, jnp.asarray(ori)) * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(adv)))
    a = torch.from_numpy(adv).requires_grad_(True)
    loss = (untargeted_logits_adv_loss(fn(a), torch.from_numpy(target), 30.0)
            + l2_dist(a, torch.from_numpy(ori)) * float(w)).sum()
    loss.backward()
    assert gc.LAUNCHES["bwd"] == 0 and cm.LAUNCHES["bwd"] == 0
    np.testing.assert_allclose(a.grad.numpy(), want, rtol=1e-4, atol=1e-5)


def calibrated_victim(name, jm, v, x):
    """Port and JAX model_fns over the same weights, with set-abstraction
    BatchNorm statistics from one train-mode pass over ``x``."""
    tm = models.make_model(name, NUM_CLASSES)
    tm.load_state_dict(state_dict_from_flax(name, v), strict=True)
    tm.train()
    for m in tm.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            m.momentum = 1.0
    with torch.no_grad():
        tm(torch.from_numpy(x))
    sd = {k: t.detach().clone() for k, t in tm.state_dict().items()}
    for bn in ("bn1", "bn2"):  # the head keeps the perturbed statistics
        for stat in ("running_mean", "running_var"):
            sd[f"{bn}.{stat}"] = torch.from_numpy(np.asarray(v["batch_stats"]["head"][f"fc{bn[-1]}"]["bn0"][stat[8:]]))
    jv = port_checkpoint(name, {k: t.numpy() for k, t in sd.items()})
    return j_make_model_fn(jm, jv), make_model_fn(models.make_model(name, NUM_CLASSES), sd, "cpu")


def test_short_cw_attack_matches_jax(pair):
    name, jm, v, _, _ = pair
    x = clouds(1)
    jfn, fn = calibrated_victim(name, jm, v, x)
    target = np.asarray(jfn(jnp.asarray(x))).argmax(-1)  # the clean predictions
    kw = dict(binary_step=1, num_iter=3, kappa=30.0, budget=0.18, attack_lr=0.05)
    key = jax.random.PRNGKey(7)
    want = j_build_cw_attack(jfn, JCWPerturbConfig(**kw))(jnp.asarray(x), jnp.asarray(target), key)
    noise = np.stack([np.asarray(jax.random.normal(k, x.shape, jnp.float32))
                      for k in jax.random.split(key, kw["binary_step"])])
    got = build_cw_attack(fn, CWPerturbConfig(**kw))(
        torch.from_numpy(x), torch.from_numpy(target), init_noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    np.testing.assert_allclose(got.best_dist.numpy(), np.asarray(want.best_dist), rtol=1e-4)
    # every success came from a gradient step: the clouds start at their label
    assert got.success.any() and float(got.best_dist[got.success].min()) > 1e-3


def test_train_mode_updates_statistics_as_jax(pair):
    """Train mode (sample_and_group for SSG, unfused rows for MSG) moves the
    set abstractions' running means as flax does (torch momentum 0.1 ==
    flax momentum 0.9).  The running variances differ by design: torch
    keeps the unbiased one.  The head's statistics are left out: over a
    batch of two clouds its inputs come from batch-normalised features of
    tiny variance, which magnify f32 rounding (and bn2 follows a dropout)."""
    name, jm, v, _, _ = pair
    x = clouds(4)
    _, upd = jax.jit(lambda a: jm.apply(v, a, train=True, mutable=["batch_stats"],
                                        rngs={"dropout": jax.random.PRNGKey(0)}))(jnp.asarray(x))
    tm = models.make_model(name, NUM_CLASSES)
    tm.load_state_dict(state_dict_from_flax(name, v), strict=True)
    tm.train()
    with torch.no_grad():
        tm(torch.from_numpy(x))
    want = state_dict_from_flax(name, {"params": v["params"], "batch_stats": upd["batch_stats"]})
    sd = tm.state_dict()
    keys = [k for k in want if k.endswith("running_mean") and k.startswith("sa")]
    assert len(keys) == (9 if name == "PointNet++Ssg" else 21)
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=0, atol=1e-5, err_msg=k)


def test_make_model_draws_weights_from_the_generator():
    for name in NAMES:
        sds = [models.make_model(name, NUM_CLASSES, generator=torch.Generator().manual_seed(s)).state_dict()
               for s in (0, 0, 1)]
        assert all(torch.equal(sds[0][k], sds[1][k]) for k in sds[0])
        assert not torch.equal(sds[0]["fc1.weight"], sds[2]["fc1.weight"])
    assert models.OUTPUT_KIND["PointNet++Ssg"] == models.OUTPUT_KIND["PointNet++Msg"] == "log_probs"


def test_cli_attack_cw_takes_pointnet2(tmp_path, capsys):
    out = tmp_path / "out"
    asr = cli_main([
        "attack", "cw", "--model", "PointNet++Ssg", "--num_points", "128", "--num_classes", "3",
        "--binary_step", "1", "--num_iter", "2", "--num_samples", "2", "--device", "cpu",
        "--output_dir", str(out),
    ])
    assert f"attack cw: ASR {asr:.3f}" in capsys.readouterr().out
    assert (out / "attack_cw_summary.json").is_file()


@pytest.fixture(scope="module")
def seeded_ssg():
    """The port's SSG with seeded weights and the BatchNorm statistics of 8
    clouds, as chip_smoke.py makes its victim; and two of the clouds."""
    model = models.make_model("PointNet++Ssg", NUM_CLASSES, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(clouds(7, b=8))
    model.train()
    model.drop1.eval()
    model.drop2.eval()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            m.momentum = 1.0
    with torch.no_grad():
        model(x)
    return make_model_fn(model, None, "cpu"), x[:2]


@pytest.mark.parametrize("fault", ["no_dctr", "neg_dctr", "no_dsrc", "dctr_x1.001", "dsrc_x1.001"])
def test_gradient_parity_bound_sees_a_wrong_term(seeded_ssg, fault, monkeypatch):
    """A gather backward that dropped or negated dctr, or dropped dsrc,
    moves each cloud's loss gradient by far more than chip_smoke.py's
    bound on every pair; one that scales either by 1.001 moves it far
    beyond the level at which chip_smoke.py wants a share of the pairs."""
    fn, ori = seeded_ssg
    adv = ori + 0.01 * torch.from_numpy(np.random.RandomState(6).randn(*ori.shape).astype(np.float32))
    with torch.no_grad():
        target = fn(ori).argmax(-1)

    def grad():
        a = adv.clone().requires_grad_(True)
        loss = (untargeted_logits_adv_loss(fn(a), target, 30.0) + l2_dist(a, ori) * 10.0).sum()
        return torch.autograd.grad(loss, a)[0]

    want = grad()
    plain = gc.gather_chain_bwd_plain

    def faulty(*args):
        dsrc, dctr = plain(*args)
        if fault == "no_dsrc":
            return torch.zeros_like(dsrc), dctr
        if fault.endswith("x1.001"):
            return (dsrc * 1.001, dctr) if fault.startswith("dsrc") else (dsrc, dctr * 1.001)
        return dsrc, dctr * (0.0 if fault == "no_dctr" else -1.0)

    monkeypatch.setattr(gc, "gather_chain_bwd_plain", faulty)
    rel = (grad() - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)
    assert float(rel.min()) > (10 * GRAD_CLEAN if fault.endswith("x1.001") else 5 * GRAD_REL), rel
