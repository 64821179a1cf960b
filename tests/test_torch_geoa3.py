"""The port's GeoA3 attack (pointcloudattack_tpu_torch/attacks/geoa3.py,
losses/geometry.py's curvature terms, the ``attack geoa3`` CLI) against the
JAX package, on the CPU.

The JAX package on the CPU takes GeoA3's Chamfer bundle from ``xx - 2xy +
yy`` and its curvature from a normalised-offset composition; the port takes
the TPU kernels' exact forms.  With offsets of about 1e-3 a squared distance
of about 1e-6 carries an expansion error of about 1e-7, so the two
constraints differ by a few parts in 1e4.  So the JAX side here runs its own
TPU kernels in interpret mode (``min_sqdist_both`` and ``kappa_knn_mean``,
patched in for the test only), the forms the port follows: the constraint
then agrees within 1e-5 relative, its gradient within 1e-5 of the largest
entry (measured 1.6e-6: sums in another order).  Both attacks also take the same normals (the JAX package's): a
normal of a nearly collinear 3-point neighbourhood differs between the two
eigensolvers by up to 1e-2 (tests/test_torch_normals.py says why), which
moves its curvature term.

The attacks (B=2, N=256, 2 rounds x 5 iterations, from the JAX package's
own start offsets) are then held on: ``success``; the step whose iterate
each side keeps as ``best_attack`` (the same on both); ``best_loss`` within
rtol 1e-5; ``best_attack`` within 1e-5 at every point whose iterates never
parted by more than 1e-5.  Points do part: a coordinate whose gradient is
within rounding of 0 takes Adam's step of about lr in either direction (the
run's first parting must be of that kind, ``chip_smoke.round_partings``);
from it the curvature term and the victim's pooled features carry the
difference to other points; and the JAX package's own jitted victim
resolves a max-pool near tie unlike its eager forward (measured: their
gradients 0.5% apart at one input of the CE run), which parts a whole cloud
a few steps later.  At least ``HELD_SHARE`` of the points never part, so
the point-by-point check covers most of each run (measured: 0.68 of them
or more, the offset-projection run parting the most).
"""

import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu.attacks import geoa3 as JG
from pointcloudattack_tpu.geometry.normals import estimate_normal as j_estimate_normal
from pointcloudattack_tpu.losses import geometry as jgeo
from pointcloudattack_tpu.ops.pallas import chamfer_kernel as CK
from pointcloudattack_tpu.ops.pallas import kappa_kernel as KK
from pointcloudattack_tpu_torch.attacks import geoa3 as PG
from pointcloudattack_tpu_torch.cli.main import main as cli_main
from pointcloudattack_tpu_torch.losses import geometry
from pointcloudattack_tpu_torch.ops import chamfer, kappa, knn as knn_mod

from test_torch_knn_attack import victims

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its recording model_fn and its parting rule)

N, B, ROUNDS, ITERS = 256, 2, 2, 5
HELD_SHARE = 0.5


@contextlib.contextmanager
def jax_tpu_forms(normals=None):
    """The JAX package's GeoA3 through its TPU kernels in interpret mode
    and, with ``normals``, both attacks on those normals."""
    orig = KK.kappa_knn_mean
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CK, "_BOTH_INTERPRET", True)
        mp.setattr(CK, "use_both_kernel", lambda n, m: True)
        mp.setattr(KK, "use_kappa_kernel", lambda n, k: True)
        mp.setattr(KK, "kappa_knn_mean", lambda a, nrm, k: orig(a, nrm, k, True))
        if normals is not None:
            mp.setattr(JG, "estimate_normal", lambda pc, k=3: jnp.asarray(normals))
            mp.setattr(PG, "estimate_normal", lambda pc, k=3: torch.from_numpy(normals).to(pc.device))
        yield


@pytest.fixture(scope="module")
def setup():
    x = (np.random.RandomState(9).randn(8, N, 3) * 0.5).astype(np.float32)
    _, calibrated = victims("PointNet", x, seed=1)
    x = x[:B]
    return calibrated, x, np.array(j_estimate_normal(jnp.asarray(x)))


def start_offsets(key, shape):
    """The JAX attack's per-round start offsets: 1e-3 N(0, 1) from the
    first half of each round's key."""
    return np.stack([np.asarray(jax.random.normal(jax.random.split(k)[0], shape, jnp.float32)) * np.float32(1e-3)
                     for k in jax.random.split(key, ROUNDS)])


def test_constraint_loss_matches_jax(setup):
    _, x, nrm = setup
    off = (np.random.RandomState(2).randn(B, N, 3) * 1e-2).astype(np.float32)
    tx, tn = torch.from_numpy(x), torch.from_numpy(nrm)
    for kw in ({}, {"is_cd_single_side": True, "hd_loss_weight": 0.0},
               {"dis_loss_type": "L2", "curv_loss_weight": 2.0}):
        cfg, jcfg = PG.GeoA3Config(**kw), JG.GeoA3Config(**kw)
        k_ori = geometry.kappa_ori(tx, tn, cfg.curv_loss_knn)
        t = torch.from_numpy(off).requires_grad_(True)
        got = PG._constraint_loss(tx + t, tx, tn, k_ori, cfg)
        got.sum().backward()
        with jax_tpu_forms():
            jk = jgeo.kappa_ori(jnp.asarray(x), jnp.asarray(nrm), jcfg.curv_loss_knn)
            np.testing.assert_allclose(k_ori.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-7)
            jx = jnp.asarray(x)
            jloss = lambda o: JG._constraint_loss(jx + o, jx, jnp.asarray(nrm), jk, jcfg)  # noqa: E731
            want = np.asarray(jloss(jnp.asarray(off)))
            jg = np.asarray(jax.grad(lambda o: jnp.sum(jloss(o)))(jnp.asarray(off)))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=0)
        np.testing.assert_allclose(t.grad.numpy(), jg, rtol=0, atol=1e-5 * np.abs(jg).max())
        # the JAX package's own CPU forms: a few parts in 1e4 apart (the module docstring)
        plain = np.asarray(JG._constraint_loss(jnp.asarray(x + off), jnp.asarray(x), jnp.asarray(nrm),
                                               jgeo.kappa_ori(jnp.asarray(x), jnp.asarray(nrm), 16), jcfg))
        np.testing.assert_allclose(got.detach().numpy(), plain, rtol=1e-3, atol=0)


def test_curvature_terms_match_jax(setup):
    """``self_knn_idx``, ``kappa_adv`` (its own nearest clean points) and
    ``curvature_loss`` without a shared index, against the JAX package;
    the loss, a mean of squares of small kappa differences, within 1e-4
    relative."""
    _, x, nrm = setup
    adv = x + (np.random.RandomState(3).randn(*x.shape) * 1e-2).astype(np.float32)
    got = geometry.self_knn_idx(torch.from_numpy(adv), 16).numpy()
    want = np.asarray(jgeo.self_knn_idx(jnp.asarray(adv), 16))
    np.testing.assert_array_equal(np.sort(got, -1), np.sort(want, -1))
    tx, ta, tn = torch.from_numpy(x), torch.from_numpy(adv), torch.from_numpy(nrm)
    k_ori = geometry.kappa_ori(tx, tn, 16)
    k_adv, n_adv = geometry.kappa_adv(ta, tx, tn, 16)
    loss = geometry.curvature_loss(ta, tx, k_adv, k_ori)
    with jax_tpu_forms():
        jk_ori = jgeo.kappa_ori(jnp.asarray(x), jnp.asarray(nrm), 16)
        jk_adv, jn_adv = jgeo.kappa_adv(jnp.asarray(adv), jnp.asarray(x), jnp.asarray(nrm), 16)
        jloss = jgeo.curvature_loss(jnp.asarray(adv), jnp.asarray(x), jk_adv, jk_ori)
    np.testing.assert_array_equal(n_adv.numpy(), np.asarray(jn_adv))  # the same nearest clean points
    np.testing.assert_allclose(k_adv.numpy(), np.asarray(jk_adv), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-4, atol=0)


def run_both(setup, **kw):
    """Both attacks from the JAX package's start offsets, each step's input
    recorded on both sides (and the port's gradients)."""
    (jfn, fn), x, nrm = setup
    target = np.asarray(jfn(jnp.asarray(x))).argmax(-1)
    key = jax.random.PRNGKey(3)
    jits = []

    def jtap(a):
        jax.debug.callback(lambda v: jits.append(np.asarray(v)), a, ordered=True)
        return jfn(a)

    cfg = dict(binary_max_steps=ROUNDS, iter_max_steps=ITERS, **kw)
    with jax_tpu_forms(nrm):
        jattack = JG.build_geoa3_attack(jtap, JG.GeoA3Config(**cfg))
        jadv, jloss, jsucc = jattack(jnp.asarray(x), jnp.asarray(target), key)
        its, grads = [], []
        kappa.reset_launches()
        chamfer.reset_launches()
        adv, loss, succ = PG.build_geoa3_attack(chip_smoke.recording_fn(fn, its, grads), PG.GeoA3Config(**cfg))(
            torch.from_numpy(x), torch.from_numpy(target), init_offsets=torch.from_numpy(start_offsets(key, x.shape)))
    assert kappa.LAUNCHES == {"kappa_fwd": 0, "kappa_bwd": 0} and chamfer.LAUNCHES["both_fwd"] == 0
    # the JAX victim runs ITERS loss forwards and one final forward a round, then one at the end
    assert len(jits) == ROUNDS * (ITERS + 1) + 1 and len(its) == len(grads) == ROUNDS * ITERS
    jit_steps = np.stack([jits[r * (ITERS + 1) + i] for r in range(ROUNDS) for i in range(ITERS)])
    return (np.asarray(jadv), np.asarray(jloss), np.asarray(jsucc), jit_steps), \
        (adv.numpy(), loss.numpy(), succ.numpy(), torch.stack(its).numpy(), grads), x


def kept_step(steps, best):
    """Per cloud, the step whose input ``best`` is (-1: none, the clean cloud)."""
    eq = (steps == best[None]).reshape(len(steps), best.shape[0], -1).all(-1)
    return np.where(eq.any(0), eq.argmax(0), -1)


@pytest.mark.parametrize("kw", [
    {},
    {"cls_loss_type": "Margin", "confidence": 0.0},
    {"use_offset_proj": True, "cc_linf": 0.05, "use_lr_scheduler": True},
], ids=["ce", "margin", "proj-linf-lr"])
def test_build_geoa3_attack_matches_jax(setup, kw):
    (jadv, jloss, jsucc, jsteps), (adv, loss, succ, steps, grads), x = run_both(setup, **kw)
    np.testing.assert_array_equal(succ, jsucc)
    assert succ.any()  # the clouds flip: best tracking and the bisection run
    step, jstep = kept_step(steps, adv), kept_step(jsteps, jadv)
    np.testing.assert_array_equal(step, jstep)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=0)
    parted, lines, first_ok = chip_smoke.round_partings(torch.from_numpy(steps), torch.from_numpy(jsteps), grads, ITERS)
    parted = parted.numpy()
    assert first_ok, lines
    assert 1.0 - parted.mean() >= HELD_SHARE, lines
    np.testing.assert_allclose(adv[~parted], jadv[~parted], rtol=0, atol=1e-5)
    assert np.abs(adv - x).max() > 5e-3  # the steps moved the points, 500x the tolerance


def test_geoa3_refuses_what_is_not_ported():
    fn = lambda a: a.sum(1)  # noqa: E731
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PG.build_geoa3_attack(fn, PG.GeoA3Config(curv_knn_refresh=2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PG.build_geoa3_attack(fn, PG.GeoA3Config(use_jitter=True))
    with pytest.raises(ValueError, match="curv_knn_refresh"):
        PG.build_geoa3_attack(fn, PG.GeoA3Config(curv_knn_refresh=0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        geometry.kappa_adv(torch.zeros(1, 8, 3), torch.zeros(1, 8, 3), torch.zeros(1, 8, 3), 2,
                           self_idx=torch.zeros(1, 8, 2, dtype=torch.int32))
    run = PG.build_geoa3_attack(fn, PG.GeoA3Config(binary_max_steps=2, iter_max_steps=1))
    with pytest.raises(ValueError, match="init_offsets"):
        run(torch.zeros(2, 8, 3), torch.zeros(2, dtype=torch.long), init_offsets=torch.zeros(1, 2, 8, 3))


def test_cli_attack_geoa3_on_cpu(tmp_path, capsys):
    out = tmp_path / "out"
    knn_mod.reset_launches()
    asr = cli_main([
        "attack", "geoa3", "--model", "PointNet", "--num_points", "128", "--num_classes", "3",
        "--binary_step", "2", "--num_iter", "3", "--num_samples", "2", "--device", "cpu",
        "--output_dir", str(out), "--save_adv", "--use_offset_proj", "1", "--cls_loss_type", "Margin",
    ])
    assert knn_mod.LAUNCHES["knn"] == 0
    printed = capsys.readouterr().out
    assert f"attack geoa3: ASR {asr:.3f}" in printed and "Chamfer " in printed
    summary = json.loads((out / "attack_geoa3_summary.json").read_text())
    assert summary["family"] == "geoa3" and summary["model"] == "PointNet" and summary["n"] == 2
    assert len(list((out / "AdvData" / "PointNet").glob("geoa3_*_label*_pred*.txt"))) == 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli_main(["attack", "geoa3", "--num_points", "64", "--num_samples", "1", "--device", "cpu",
                  "--output_dir", str(out), "--curv_knn_refresh", "2"])
