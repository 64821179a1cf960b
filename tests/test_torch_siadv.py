"""The port's SIadv family (pointcloudattack_tpu_torch/geometry/tangent.py,
attacks/siadv.py, the ``attack siadv|simba|simbapp|si-query`` CLI) against
the JAX package, on the CPU.

Tolerances:
- ``spin_axis_matrix`` (the pole branch included) and the round trip
  through the tangent frame: atol 1e-6 against the JAX package's; the
  frames orthonormal, and the round trip back at the points, within 1e-5
  (f32 rounds 1 - z^2).
- ``cw_margin_loss`` (both directions), ``cw_margin_loss_top5`` and
  ``success_rule`` (top-1 and top-5): exact, on logits with ties at the
  first and the fifth place.
- The attacks on PointNet (flax weights with seeded BatchNorm statistics,
  exported by ``state_dict_from_flax``) at N=64, each handed the JAX
  package's draws and order (SimBA's permutation, SimBA++'s categorical
  draws and step noise, SI-query's ranking): iFGM at ``normal_refresh`` 1
  and 2, SimBA, SimBA++ and SI-query: ``adv`` atol 1e-5; ``pred``,
  ``success`` and the per-cloud query counts exact.  One cloud's target is
  not its clean prediction, so SimBA and SimBA++ spend one query on it and
  SI-query probes it all the same.
- One CLI run per family at N=64, and the CLI's SystemExit cases.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu import models as jmodels
from pointcloudattack_tpu.attacks import siadv as jsiadv
from pointcloudattack_tpu.geometry import normals as jnormals
from pointcloudattack_tpu.geometry import tangent as jtangent
from pointcloudattack_tpu.utils.apply import make_model_fn as j_make_model_fn
from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.attacks import siadv
from pointcloudattack_tpu_torch.cli.main import main as cli_main
from pointcloudattack_tpu_torch.geometry import tangent
from pointcloudattack_tpu_torch.train.weights import state_dict_from_flax
from pointcloudattack_tpu_torch.utils.apply import make_model_fn

from test_torch_pointnet import perturb
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why

NUM_CLASSES, N = 10, 64


def test_spin_axis_matrix_and_round_trip_match_jax():
    rng = np.random.RandomState(0)
    nrm = rng.randn(3, 40, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[:, :4] = [[0, 0, 1], [0, 0, -1], [0.003, 0.004, np.sqrt(1 - 2.5e-5)], [0, 0.01, -np.sqrt(1 - 1e-4)]]
    at_pole = np.abs(nrm[..., 2] ** 2 - 1) < 1e-4
    assert at_pole[:, :3].all() and not at_pole[:, 3:].any()
    u = tangent.spin_axis_matrix(torch.from_numpy(nrm)).numpy()
    np.testing.assert_allclose(u, np.asarray(jtangent.spin_axis_matrix(jnp.asarray(nrm))), rtol=0, atol=1e-6)
    # orthonormal in f32 but for the two normals next to the pole (1 - z^2 = 2.5e-5 and 1e-4, each
    # rounded in f32), on either side of its branch
    frame = np.ones(at_pole.shape, bool)
    frame[:, 2:4] = False
    np.testing.assert_allclose(np.einsum("...ij,...kj->...ik", u, u)[frame],
                               np.broadcast_to(np.eye(3), u.shape)[frame], rtol=0, atol=1e-5)
    pts = rng.randn(3, 40, 3).astype(np.float32)
    new, uu, tr = tangent.to_tangent_frame(torch.from_numpy(pts), torch.from_numpy(nrm))
    jnew, _, jtr = jtangent.to_tangent_frame(jnp.asarray(pts), jnp.asarray(nrm))
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jtr), rtol=0, atol=1e-6)
    back = tangent.from_tangent_frame(new, uu, tr).numpy()
    np.testing.assert_allclose(back, np.asarray(jtangent.from_tangent_frame(jnew, jnp.asarray(u), jtr)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(back[frame], pts[frame], rtol=0, atol=1e-5)


def tied_logits():
    """Logits with ties at the top (rows 0, 1) and at the fifth place
    (rows 2-4), the target among the tied or beside them."""
    lg = np.array([
        [3, 3, 1, 0, 0, -1, 2, 2],
        [1, 5, 5, 5, 0, 0, 0, 0],
        [9, 8, 7, 6, 5, 5, 5, 0],
        [9, 8, 7, 6, 5, 5, 5, 0],
        [4, 4, 4, 4, 4, 4, 4, 4],
        [0, 1, 2, 3, 4, 5, 6, 7],
    ], dtype=np.float32)
    target = np.array([1, 3, 5, 4, 6, 2])
    return lg, target


@pytest.mark.parametrize("kappa", [0.0, -999.0, 2.0])
def test_losses_and_success_rule_match_jax_on_ties(kappa):
    lg, target = tied_logits()
    t, jt = torch.from_numpy(lg), jnp.asarray(lg)
    tg, jtg = torch.from_numpy(target), jnp.asarray(target)
    for tar in (True, False):
        np.testing.assert_array_equal(siadv.cw_margin_loss(t, tg, kappa, tar).numpy(),
                                      np.asarray(jsiadv.cw_margin_loss(jt, jtg, kappa, tar)))
    np.testing.assert_array_equal(siadv.cw_margin_loss_top5(t, tg, kappa).numpy(),
                                  np.asarray(jsiadv.cw_margin_loss_top5(jt, jtg, kappa)))
    for top5 in (False, True):
        got = siadv.success_rule(t, tg, top5).numpy()
        np.testing.assert_array_equal(got, np.asarray(jsiadv.success_rule(jt, jtg, top5)))
    # the fifth place tied three ways: lax.top_k keeps the lower indices
    np.testing.assert_array_equal(siadv.success_rule(t, tg, True).numpy()[2:5], [True, False, True])


@pytest.fixture(scope="module")
def victim():
    """(jax model_fn, port model_fn, clouds, targets): the targets are the
    JAX victim's clean predictions but for cloud 1, whose target is another
    class."""
    jm = jmodels.make_model("PointNet", NUM_CLASSES)
    v = perturb(jmodels.init_model(jm, jax.random.PRNGKey(5), num_points=N, batch=2), np.random.RandomState(5))
    jfn = j_make_model_fn(jm, v)
    fn = make_model_fn(models.make_model("PointNet", NUM_CLASSES), state_dict_from_flax("PointNet", v), "cpu")
    x = (np.random.RandomState(6).randn(4, N, 3) * 0.5).astype(np.float32)
    target = np.asarray(jfn(jnp.asarray(x))).argmax(-1)
    target[1] = (target[1] + 3) % NUM_CLASSES
    return jfn, fn, x, target


_j_normals = jax.jit(jnormals.estimate_normal, static_argnames="k")


def jax_normals(monkeypatch):
    """The port's attacks take the JAX package's normals of their own
    iterates, compiled as the attacks compile them: a normal of an
    ill-conditioned neighbourhood parts between two eigensolvers (by 1.4e-4
    between the JAX package's own eager and compiled runs here), and near
    the pole a small change of the normal turns the tangent frame (ROADMAP
    Queue 3 item 4; tests/test_torch_normals.py holds the port's own)."""
    def estimate_normal(pc, k):
        return torch.from_numpy(np.asarray(_j_normals(jnp.asarray(pc.detach().numpy()), k=k)).copy())

    monkeypatch.setattr(siadv, "estimate_normal", estimate_normal)


def held(got, want, queries=True):
    adv, pred, succ = (np.asarray(t) for t in got[:3])
    np.testing.assert_allclose(adv, np.asarray(want[0]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pred, np.asarray(want[1]))
    np.testing.assert_array_equal(succ, np.asarray(want[2]))
    if queries:
        np.testing.assert_array_equal(got.queries.numpy(), np.asarray(want[3]))
        assert got.queries.dtype == torch.int32 and got.iterations % siadv.QUERY_CHUNK == 0
    return adv, succ


@pytest.mark.parametrize("refresh", [1, 2])
def test_si_ifgm_matches_jax(victim, monkeypatch, refresh):
    jfn, fn, x, target = victim
    jax_normals(monkeypatch)
    cfg = dict(eps=0.18, step_size=0.07, max_steps=6, normal_refresh=refresh)
    want = jsiadv.build_si_ifgm(jfn, jfn, jsiadv.SIAdvConfig(**cfg))(jnp.asarray(x), jnp.asarray(target))
    got = siadv.build_si_ifgm(fn, fn, siadv.SIAdvConfig(**cfg))(torch.from_numpy(x), torch.from_numpy(target))
    adv, _ = held(got, want, queries=False)
    moved = np.linalg.norm(adv - x, axis=-1)
    assert moved.max() <= 0.18 * (1 + 1e-5) and moved.max() > 0.1


def test_si_ifgm_rejects_refresh_0():
    with pytest.raises(ValueError, match="normal_refresh"):
        siadv.build_si_ifgm(None, None, siadv.SIAdvConfig(normal_refresh=0))


def test_simba_matches_jax(victim, monkeypatch):
    jfn, fn, x, target = victim
    cfg = siadv.SIAdvConfig(eps=0.18, step_size=0.32, max_queries=150)
    key = jax.random.PRNGKey(7)
    want = jsiadv.build_simba(jfn, jsiadv.SIAdvConfig(**vars(cfg)))(jnp.asarray(x), jnp.asarray(target), key)
    order = torch.from_numpy(np.asarray(jax.random.permutation(key, 3 * N)).astype(np.int64))
    monkeypatch.setattr(siadv, "simba_order", lambda pts, gen: order)
    got = siadv.build_simba(fn, cfg)(torch.from_numpy(x), torch.from_numpy(target))
    held(got, want)
    assert int(got.queries[1]) == 1 and int(got.queries.max()) > 10


def test_simbapp_matches_jax(victim, monkeypatch):
    jfn, fn, x, target = victim
    cfg = siadv.SIAdvConfig(eps=0.18, step_size=0.32, max_queries=150)
    key = jax.random.PRNGKey(8)
    want = jsiadv.build_simbapp(jfn, jfn, jsiadv.SIAdvConfig(**vars(cfg)))(jnp.asarray(x), jnp.asarray(target), key)
    # the JAX package's draws (siadv.py: fold_in, split, categorical, normal) from its own logits
    @jax.jit
    def draws_of(p):
        grad = jax.grad(lambda q: jnp.sum(jsiadv.cw_margin_loss(jfn(q), jnp.asarray(target), kappa=-999.0)))(p)
        logits_cat = jnp.log(jnp.abs(grad).reshape(len(x), -1) + 1e-20)

        def draw(i):
            k_cat, k_noise = jax.random.split(jax.random.fold_in(key, i))
            return (jax.random.categorical(k_cat, logits_cat, axis=-1),
                    jax.random.normal(k_noise, (len(x),), jnp.float32))

        return jax.vmap(draw)(jnp.arange(150))

    choice, noise = (np.array(t) for t in draws_of(jnp.asarray(x)))
    seen = []

    def draws(lc, iters, gen):
        seen.append((tuple(lc.shape), iters))
        return torch.from_numpy(choice.astype(np.int64)), torch.from_numpy(noise)

    monkeypatch.setattr(siadv, "simbapp_draws", draws)
    got = siadv.build_simbapp(fn, fn, cfg)(torch.from_numpy(x), torch.from_numpy(target))
    assert seen == [((len(x), 3 * N), 150)]
    held(got, want)
    assert int(got.queries[1]) == 1


def test_simbapp_draws_follow_the_gradient():
    """The port's own draws: each cloud's choices fall where its
    categorical has mass, and the noise is standard normal."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.full((2, 30), -1e4)
    logits[0, 7], logits[1, 3:5] = 0.0, 0.0
    choice, noise = siadv.simbapp_draws(logits, 400, gen)
    assert tuple(choice.shape) == (400, 2) and tuple(noise.shape) == (400, 2)
    assert (choice[:, 0] == 7).all() and set(choice[:, 1].tolist()) == {3, 4}
    assert abs(float(noise.std()) - 1) < 0.1


def test_si_query_matches_jax(victim, monkeypatch):
    jfn, fn, x, target = victim
    cfg = siadv.SIAdvConfig(eps=0.18, step_size=0.32)
    want = jsiadv.build_si_query_attack(jfn, jfn, jsiadv.SIAdvConfig(**vars(cfg)))(jnp.asarray(x), jnp.asarray(target))
    @jax.jit
    def ranking(ori):
        """The JAX package's ranking (siadv.py:338-352)."""
        new0, u, tr = jtangent.to_tangent_frame(ori, jnormals.estimate_normal(ori, k=cfg.normal_k))

        def loss(p):
            back = jnp.clip(jtangent.from_tangent_frame(p, u, tr), ori - cfg.eps, ori + cfg.eps)
            return jnp.sum(jsiadv.cw_margin_loss(jfn(back), jnp.asarray(target), kappa=-999.0))

        g = jax.grad(loss)(new0).at[..., 2].set(0.0)
        return jnp.argsort(-jnp.sqrt(g[..., 0] ** 2 + g[..., 1] ** 2), axis=-1)

    jorder = np.asarray(ranking(jnp.asarray(x)))
    jax_normals(monkeypatch)
    own, rank_order = [], siadv.rank_order

    def order(rankings):
        own.append(rank_order(rankings))
        return torch.from_numpy(jorder.astype(np.int64))

    monkeypatch.setattr(siadv, "rank_order", order)
    got = siadv.build_si_query_attack(fn, fn, cfg)(torch.from_numpy(x), torch.from_numpy(target))
    held(got, want)
    np.testing.assert_array_equal(own[0].numpy(), jorder)  # the port's own ranking is the JAX package's
    assert int(got.queries[1]) >= 2  # a misclassified cloud is probed all the same


def surrogate(tmp_path):
    path = tmp_path / "surrogate.pth"
    torch.save(models.make_model("PointNet", 3, generator=torch.Generator().manual_seed(1)).state_dict(), path)
    return str(path)


@pytest.mark.parametrize("family,extra", [
    ("siadv", ["--num_iter", "2", "--step_size", "0.007"]),
    ("simba", ["--num_iter", "20", "--step_size", "0.32"]),
    ("simbapp", ["--num_iter", "20", "--step_size", "0.32", "--surrogate_model", "PointNet"]),
    ("si-query", ["--step_size", "0.32", "--attack_method", "target", "--top5_attack", "--num_classes", "10"]),
])
def test_cli_attack_siadv_families_on_cpu(tmp_path, capsys, family, extra):
    out = tmp_path / "out"
    if "--surrogate_model" in extra:
        extra = extra + ["--surrogate_checkpoint", surrogate(tmp_path)]
    if "--num_classes" not in extra:
        extra = extra + ["--num_classes", "3"]
    asr = cli_main(["attack", family, "--model", "PointNet", "--num_points", "64",
                    "--budget", "0.18", "--num_samples", "4", "--device", "cpu", "--output_dir", str(out), *extra])
    printed = capsys.readouterr().out
    assert f"attack {family}: ASR {asr:.3f}" in printed and "Chamfer " in printed
    summary = json.loads((out / f"attack_{family}_summary.json").read_text())
    assert summary["family"] == family and summary["n"] == 4
    if family == "siadv":
        assert "mean query cost" not in printed and "mean_query_cost" not in summary
    else:
        assert f"mean query cost: {summary['mean_query_cost']:.1f}" in printed
        assert summary["mean_query_cost"] >= 1


@pytest.mark.parametrize("argv,match", [
    (["siadv", "--surrogate_model", "PointNet"], "requires --surrogate_checkpoint"),
    (["simba", "--surrogate_model", "PointNet", "--surrogate_checkpoint", "x.pth"], "pure black-box"),
    (["cw", "--attack_method", "target"], "not ported for cw"),
])
def test_cli_siadv_exits(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        cli_main(["attack", *argv, "--num_points", "64", "--num_classes", "3", "--num_samples", "2",
                  "--device", "cpu", "--output_dir", str(tmp_path)])
