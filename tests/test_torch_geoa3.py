"""The port's GeoA3 attack (pointcloudattack_tpu_torch/attacks/geoa3.py and
geoa3_partial.py, losses/geometry.py's curvature terms, the ``attack geoa3``
and ``attack geoa3-partial`` CLI) against the JAX package, on the CPU.

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

The same rules hold the cached curvature neighbour set (``curv_knn_refresh``
R > 1: R dividing the iterations, not dividing them, and above them, where
the set is frozen for the round; the JAX side on its interpret-mode
``kappa_knn_mean_from_idx``), the tangent-plane jitter (the port taking the
JAX package's own jitter, recorded as its attack draws it), and the partial
mode (the port taking the JAX package's own patch seeds and start offsets,
a patch refresh inside each round, once with the farthest-point subsample).
Under jitter the kept iterate is the bare cloud that the second forward
evaluates; in partial mode the cloud that the loss sees.
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
from pointcloudattack_tpu.attacks import geoa3_partial as JGP
from pointcloudattack_tpu.geometry.normals import estimate_normal as j_estimate_normal
from pointcloudattack_tpu.losses import geometry as jgeo
from pointcloudattack_tpu.ops.pallas import chamfer_kernel as CK
from pointcloudattack_tpu.ops.pallas import kappa_kernel as KK
from pointcloudattack_tpu_torch.attacks import geoa3 as PG
from pointcloudattack_tpu_torch.attacks import geoa3_partial as PGP
from pointcloudattack_tpu_torch.cli.main import main as cli_main
from pointcloudattack_tpu_torch.data.synthetic import make_synthetic_clouds
from pointcloudattack_tpu_torch.losses import geometry
from pointcloudattack_tpu_torch.ops import chamfer, kappa, knn as knn_mod

from test_torch_knn_attack import victims

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its recording model_fn and its parting rule)
from torch_threads import threads  # noqa: E402

torch_threads = threads(1)  # tests/torch_threads.py says why

N, B, ROUNDS, ITERS = 256, 2, 2, 5
HELD_SHARE = 0.5


@contextlib.contextmanager
def jax_tpu_forms(normals=None):
    """The JAX package's GeoA3 through its TPU kernels in interpret mode
    and, with ``normals``, both attacks (full and partial) on those
    normals."""
    orig, orig_idx = KK.kappa_knn_mean, KK.kappa_knn_mean_from_idx
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CK, "_BOTH_INTERPRET", True)
        mp.setattr(CK, "use_both_kernel", lambda n, m: True)
        mp.setattr(KK, "use_kappa_kernel", lambda n, k: True)
        mp.setattr(KK, "kappa_knn_mean", lambda a, nrm, k: orig(a, nrm, k, True))
        mp.setattr(KK, "kappa_knn_mean_from_idx", lambda a, nrm, idx, k: orig_idx(a, nrm, idx, k, True))
        if normals is not None:
            for mod in (JG, JGP):
                mp.setattr(mod, "estimate_normal", lambda pc, k=3: jnp.asarray(normals))
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
    stale = geometry.self_knn_idx(tx, 16).contiguous()  # the clean cloud's sets: stale at the offsets
    for kw, idx in (({}, None), ({"is_cd_single_side": True, "hd_loss_weight": 0.0}, None),
                    ({"dis_loss_type": "L2", "curv_loss_weight": 2.0}, None), ({}, stale)):
        cfg, jcfg = PG.GeoA3Config(**kw), JG.GeoA3Config(**kw)
        k_ori = geometry.kappa_ori(tx, tn, cfg.curv_loss_knn)
        t = torch.from_numpy(off).requires_grad_(True)
        got = PG._constraint_loss(tx + t, tx, tn, k_ori, cfg, self_idx=idx)
        got.sum().backward()
        jidx = None if idx is None else jnp.asarray(idx.numpy())
        with jax_tpu_forms():
            jk = jgeo.kappa_ori(jnp.asarray(x), jnp.asarray(nrm), jcfg.curv_loss_knn)
            np.testing.assert_allclose(k_ori.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-7)
            jx = jnp.asarray(x)
            jloss = lambda o: JG._constraint_loss(jx + o, jx, jnp.asarray(nrm), jk, jcfg, self_idx=jidx)  # noqa: E731
            want = np.asarray(jloss(jnp.asarray(off)))
            jg = np.asarray(jax.grad(lambda o: jnp.sum(jloss(o)))(jnp.asarray(off)))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=0)
        np.testing.assert_allclose(t.grad.numpy(), jg, rtol=0, atol=1e-5 * np.abs(jg).max())
        # the JAX package's own CPU forms: a few parts in 1e4 apart (the module docstring)
        plain = np.asarray(JG._constraint_loss(jnp.asarray(x + off), jnp.asarray(x), jnp.asarray(nrm),
                                               jgeo.kappa_ori(jnp.asarray(x), jnp.asarray(nrm), 16), jcfg,
                                               self_idx=jidx))
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


def partial_draws(key, b, n, rounds, iters, refresh):
    """The JAX partial attack's patch seeds ``[R, P, B]`` and start offsets
    ``[R, P, B, N, 3]`` (before the mask): round r from ``fold_in(key, r)``,
    the patch at iteration ``it`` from ``fold_in(k_patch, it)``."""
    seeds, offs = [], []
    for r in range(rounds):
        k_patch = jax.random.split(jax.random.fold_in(key, r))[0]
        ks = [jax.random.split(jax.random.fold_in(k_patch, it)) for it in range(0, iters, refresh)]
        seeds.append([np.asarray(jax.random.randint(k_pt, (b,), 0, n)) for k_pt, _ in ks])
        offs.append([np.asarray(jax.random.normal(k_off, (b, n, 3), jnp.float32)) * np.float32(1e-3)
                     for _, k_off in ks])
    return np.asarray(seeds, dtype=np.int64), np.asarray(offs, dtype=np.float32)


def run_both(setup, partial=False, iters=ITERS, **kw):
    """Both attacks (full or partial mode) from the JAX package's draws,
    every victim call's input recorded on both sides; returns each side's
    (adv, best_loss, success, steps, gradients), where ``steps`` holds each
    iteration's iterate of the kind the attack keeps and ``gradients`` the
    loss gradient at each iteration, and the clean clouds."""
    (jfn, fn), x, nrm = setup
    target = np.asarray(jfn(jnp.asarray(x))).argmax(-1)
    key = jax.random.PRNGKey(3)
    jits, jitter = [], []

    def jtap(a):
        jax.debug.callback(lambda v: jits.append(np.asarray(v)), a, ordered=True)
        return jfn(a)

    orig_jitter, orig_vg, jgrads = JG.estimate_perpendicular_jitter, jax.value_and_grad, []

    def value_and_grad(fn, **kw):  # records the JAX package's gradient at each iteration
        def run(v):
            out = orig_vg(fn, **kw)(v)
            jax.debug.callback(lambda g: jgrads.append(np.array(g)), out[1], ordered=True)
            return out
        return run

    def jax_jitter(pc, k, key_, sigma, clip):  # records the JAX package's own jitter
        out = orig_jitter(pc, k, key_, sigma=sigma, clip=clip)
        jax.debug.callback(lambda v: jitter.append(np.array(v)), out, ordered=True)
        return out

    cfg = dict(binary_max_steps=ROUNDS, iter_max_steps=iters, **kw)
    if partial:
        jbuild, jconf, build, conf = JGP.build_geoa3_partial_attack, JGP.GeoA3PartialConfig, \
            PGP.build_geoa3_partial_attack, PGP.GeoA3PartialConfig
        seeds, offs = partial_draws(key, B, N, ROUNDS, iters, kw["refresh_iters"])
        draws = dict(seed_idx=torch.from_numpy(seeds), init_offsets=torch.from_numpy(offs))
    else:
        jbuild, jconf, build, conf = JG.build_geoa3_attack, JG.GeoA3Config, PG.build_geoa3_attack, PG.GeoA3Config
        draws = dict(init_offsets=torch.from_numpy(start_offsets(key, x.shape)))
    calls, grads = [], []

    def port_fn(a):
        calls.append(a.detach().clone())
        if a.requires_grad:
            a.register_hook(lambda g: grads.append(g.detach().clone()))
        return fn(a)

    with jax_tpu_forms(nrm), pytest.MonkeyPatch.context() as mp:
        mp.setattr(JG, "estimate_perpendicular_jitter", jax_jitter)
        mp.setattr(jax, "value_and_grad", value_and_grad)
        jadv, jloss, jsucc = jbuild(jtap, jconf(**cfg))(jnp.asarray(x), jnp.asarray(target), key)
        jax.block_until_ready(jsucc)
        mp.setattr(jax, "value_and_grad", orig_vg)
        mp.setattr(PG, "estimate_perpendicular_jitter", lambda *a, **k: torch.from_numpy(jitter.pop(0)))
        kappa.reset_launches()
        chamfer.reset_launches()
        adv, loss, succ = build(port_fn, conf(**cfg))(torch.from_numpy(x), torch.from_numpy(target), **draws)
    assert kappa.LAUNCHES == {"kappa_fwd": 0, "kappa_bwd": 0, "kappa_idx_fwd": 0, "kappa_idx_bwd": 0}
    assert chamfer.LAUNCHES["both_fwd"] == 0 and not jitter
    # per iteration the loss forward, under jitter or a subsample also the evaluation; a final forward
    # a round, one at the end.  The JAX package's full mode with a cache runs whole periods of R, the
    # dead tail's victim calls included
    per = 2 if kw.get("use_jitter") or kw.get("subsample_npoint") else 1
    take = 1 if kw.get("use_jitter") else 0
    refresh = kw.get("curv_knn_refresh", 1)
    padded = -(-iters // refresh) * refresh if refresh > 1 and not partial else iters
    steps = []
    for rec, its in ((jits, padded), ([c.numpy() for c in calls], iters)):
        assert len(rec) == ROUNDS * (per * its + 1) + 1
        steps.append(np.stack([rec[r * (per * its + 1) + per * i + take] for r in range(ROUNDS)
                               for i in range(iters)]))
    assert len(grads) == ROUNDS * iters and len(jgrads) == ROUNDS * padded
    jgrads = [torch.from_numpy(jgrads[r * padded + i]) for r in range(ROUNDS) for i in range(iters)]
    return (np.asarray(jadv), np.asarray(jloss), np.asarray(jsucc), steps[0], jgrads), \
        (adv.numpy(), loss.numpy(), succ.numpy(), steps[1], grads), x


def kept_step(steps, best):
    """Per cloud, the step whose input ``best`` is (-1: none, the clean cloud)."""
    eq = (steps == best[None]).reshape(len(steps), best.shape[0], -1).all(-1)
    return np.where(eq.any(0), eq.argmax(0), -1)


def hold_attacks(both, iters=ITERS, apart=False, flips=True):
    """The module docstring's rules; ``apart``: a parting may also be
    explained by the two sides' gradients lying GRAD_APART apart;
    ``flips``: some cloud's final success (else only a kept iterate)."""
    (jadv, jloss, jsucc, jsteps, jgrads), (adv, loss, succ, steps, grads), x = both
    np.testing.assert_array_equal(succ, jsucc)
    assert succ.any() if flips else (loss < 1e10).any()  # best tracking and the bisection run
    step, jstep = kept_step(steps, adv), kept_step(jsteps, jadv)
    np.testing.assert_array_equal(step, jstep)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=0)
    parted, lines, first_ok = chip_smoke.round_partings(torch.from_numpy(steps), torch.from_numpy(jsteps), grads, iters,
                                                        g_cpu=jgrads if apart else None)
    parted = parted.numpy()
    assert first_ok, lines
    assert 1.0 - parted.mean() >= HELD_SHARE, lines
    np.testing.assert_allclose(adv[~parted], jadv[~parted], rtol=0, atol=1e-5)
    assert np.abs(adv - x).max() > 5e-3  # the steps moved the points, 500x the tolerance


@pytest.mark.parametrize("kw", [
    {},
    {"cls_loss_type": "Margin", "confidence": 0.0},
    {"use_offset_proj": True, "cc_linf": 0.05, "use_lr_scheduler": True},
], ids=["ce", "margin", "proj-linf-lr"])
def test_build_geoa3_attack_matches_jax(setup, kw):
    hold_attacks(run_both(setup, **kw))


@pytest.mark.parametrize("iters,kw", [
    (8, {"curv_knn_refresh": 4}),
    (5, {"curv_knn_refresh": 2}),
    (5, {"curv_knn_refresh": 4, "use_jitter": True, "jitter_refresh_iters": 3}),
    (5, {"curv_knn_refresh": 8}),
], ids=["r4", "r2-tail", "r4-jitter", "r8-frozen"])
def test_geoa3_cached_curvature_and_jitter_match_jax(setup, iters, kw):
    """R dividing the round's iterations, not dividing them (a dead tail on
    the JAX side), the jitter, and R above them (the set frozen a round).
    Under jitter a cloud parts at 16 points at once, with gradients far from
    0 there: the two sides' gradients lie more than GRAD_APART apart at
    them (the JAX package's gradients, recorded as its attack takes them),
    so the parting rule takes that explanation too, as parity-geoa3 on the
    card does."""
    hold_attacks(run_both(setup, iters=iters, **kw), iters, apart=kw.get("use_jitter", False))


@pytest.mark.parametrize("kw", [
    {"refresh_iters": 3},
    {"refresh_iters": 3, "curv_knn_refresh": 4, "subsample_npoint": 128},
], ids=["r1", "r4-subsample"])
def test_geoa3_partial_matches_jax(setup, kw):
    """A patch refresh at iterations 0 and 3 of each round: a new base, a
    new mask, Adam restarted.  With the subsample the evaluation on 128
    farthest points takes a cloud for flipped while the whole cloud is not,
    on both sides: a kept iterate, and no final success."""
    both = run_both(setup, partial=True, **kw)
    hold_attacks(both, flips="subsample_npoint" not in kw)
    (jadv, *_), (adv, *_), x = both
    assert ((np.abs(adv - x).max(-1) > 0).sum(-1) <= 2 * 16).all()  # at most two patches of 16 points moved


def test_geoa3_refuses_what_is_not_ported():
    """Every GeoA3 option is ported; what is still refused is what the JAX
    package refuses too: a refresh period below 1, draws of the wrong shape
    and a neighbour set without exactly k columns."""
    fn = lambda a: a.sum(1)  # noqa: E731
    for build, conf in ((PG.build_geoa3_attack, PG.GeoA3Config), (PGP.build_geoa3_partial_attack,
                                                                  PGP.GeoA3PartialConfig)):
        with pytest.raises(ValueError, match="curv_knn_refresh"):
            build(fn, conf(curv_knn_refresh=0))
    with pytest.raises(ValueError, match="exactly k columns"):
        geometry.kappa_adv(torch.zeros(1, 8, 3), torch.zeros(1, 8, 3), torch.zeros(1, 8, 3), 2,
                           self_idx=torch.zeros(1, 8, 3, dtype=torch.int32))
    run = PG.build_geoa3_attack(fn, PG.GeoA3Config(binary_max_steps=2, iter_max_steps=1))
    with pytest.raises(ValueError, match="init_offsets"):
        run(torch.zeros(2, 8, 3), torch.zeros(2, dtype=torch.long), init_offsets=torch.zeros(1, 2, 8, 3))
    run = PGP.build_geoa3_partial_attack(fn, PGP.GeoA3PartialConfig(binary_max_steps=2, iter_max_steps=5,
                                                                    refresh_iters=3))
    with pytest.raises(ValueError, match="seed_idx"):
        run(torch.zeros(2, 8, 3), torch.zeros(2, dtype=torch.long), seed_idx=torch.zeros(2, 1, 2, dtype=torch.long))


def cli_run(tmp_path, family, *extra):
    out = tmp_path / family
    asr = cli_main([
        "attack", family, "--model", "PointNet", "--num_points", "128", "--num_classes", "3",
        "--binary_step", "2", "--num_iter", "3", "--num_samples", "2", "--device", "cpu",
        "--output_dir", str(out), "--save_adv", *extra,
    ])
    return asr, out


def hold_cli(capsys, family, asr, out):
    printed = capsys.readouterr().out
    assert f"attack {family}: ASR {asr:.3f}" in printed and "Chamfer " in printed
    summary = json.loads((out / f"attack_{family}_summary.json").read_text())
    assert summary["family"] == family and summary["model"] == "PointNet" and summary["n"] == 2
    assert len(list((out / "AdvData" / "PointNet").glob(f"{family}_*_label*_pred*.txt"))) == 2


def test_cli_attack_geoa3_on_cpu(tmp_path, capsys):
    knn_mod.reset_launches()
    asr, out = cli_run(tmp_path, "geoa3", "--use_offset_proj", "1", "--cls_loss_type", "Margin")
    assert knn_mod.LAUNCHES["knn"] == 0
    hold_cli(capsys, "geoa3", asr, out)
    with pytest.raises(ValueError, match="curv_knn_refresh"):
        cli_main(["attack", "geoa3", "--num_points", "64", "--num_samples", "1", "--device", "cpu",
                  "--output_dir", str(out), "--curv_knn_refresh", "0"])


@pytest.mark.parametrize("family,extra", [
    ("geoa3", ("--curv_knn_refresh", "4", "--use_jitter", "1")),
    ("geoa3-partial", ("--curv_knn_refresh", "2", "--refresh_iters", "2", "--knn_range", "8",
                       "--subsample_npoint", "64")),
], ids=["geoa3-refresh-jitter", "geoa3-partial"])
def test_cli_attack_geoa3_refresh_jitter_and_partial_on_cpu(tmp_path, capsys, monkeypatch, family, extra):
    """The CLI hands its settings to the attack: the jitter and the cached
    curvature set (counted through the plain kNN), the patch size."""
    seen = []
    orig = geometry.self_knn_idx
    monkeypatch.setattr(PGP, "self_knn_idx", lambda pc, k: seen.append(k) or orig(pc, k))
    monkeypatch.setattr(PG, "self_knn_idx", lambda pc, k: seen.append(k) or orig(pc, k))
    jit = []
    orig_jit = PG.estimate_perpendicular_jitter
    monkeypatch.setattr(PG, "estimate_perpendicular_jitter", lambda *a, **k: jit.append(a[1]) or orig_jit(*a, **k))
    asr, out = cli_run(tmp_path, family, *extra)
    hold_cli(capsys, family, asr, out)
    assert seen == [16] * 2 * (1 if family == "geoa3" else 2)  # 2 rounds x 3 iterations: it 0 (and 2)
    assert jit == ([16, 16] if family == "geoa3" else [])  # at it 0 of each round
    if family == "geoa3-partial":
        adv = np.stack([np.loadtxt(f) for f in sorted((out / "AdvData" / "PointNet").glob("*.txt"))])
        clean, _ = make_synthetic_clouds(3, 16, 128, seed=0)
        moved = (np.abs(adv - clean[:2]) > 1e-5).any(-1).sum(-1)
        assert (moved <= 2 * 8).all()  # at most two patches of 8 points
