"""The port's AOF / TAOF attack (pointcloudattack_tpu_torch/attacks/aof.py)
and its ``attack aof|taof`` CLI against the JAX package, on the CPU.

Both attacks run 2 rounds x 10 iterations at N=128 on PointNet (flax weights
with seeded BatchNorm statistics, exported by ``state_dict_from_flax``), the
JAX package's basis patched into the port's ``spectral.lowpass_basis`` and
its start noise handed over.  Each side's victim calls are recorded, so the
two trajectories are compared iterate by iterate.

A cloud's trajectory may part from the JAX package's: the step's gradient
blends the full cloud's and the low-frequency part's, and where a
coordinate's blend cancels to within rounding of 0 the two sides' gradients
take opposite signs and Adam steps them about 2 lr apart; and where two
rows of a max pool, or a unit and 0 at a ReLU, lie within rounding of each
other, the two sides' inputs (1e-6 apart after a projection onto the
basis) pick other sides, and the cloud's gradients part by a few percent
(ROADMAP Queue 3 item 4).  So the test holds, at atol 1e-5, every iterate
of every cloud up to its first parting; a parting must come after a step at
which that cloud's two gradients had a coordinate of opposite signs (or 0
on one side only), or one further apart than GRAD_APART of the cloud's
largest |gradient| (at most 3e-7 where nothing switched), and never at a
round's first iterate.  On the
clouds that never part: ``success`` identical, ``best_dist`` rtol 1e-6 (one
ulp: a distance of iterates 1e-6 apart), ``adv`` atol 1e-5.  At least one
cloud of each case never parts, and in the AOF case one that never parts
succeeds with a kept iterate.  The cases: AOF; TAOF with the cross-entropy
loss and the two forwards batched; AOF with a dense basis a round (the
JAX attack compiles its own ``eigh`` there; the Chebyshev solver is held
in tests/test_torch_spectral.py).  The CLI runs each family at N=64 and checks the summary JSON
and the ``{family}_results.npz`` bundle.
"""

import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu import models as jmodels
from pointcloudattack_tpu.attacks import aof as jaof
from pointcloudattack_tpu.data.synthetic import make_synthetic_clouds
from pointcloudattack_tpu.geometry import spectral as jspectral
from pointcloudattack_tpu.utils.apply import make_model_fn as j_make_model_fn
from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.attacks.aof import AOFConfig, build_aof_attack
from pointcloudattack_tpu_torch.cli.main import main as cli_main
from pointcloudattack_tpu_torch.geometry import spectral
from pointcloudattack_tpu_torch.train.weights import state_dict_from_flax
from pointcloudattack_tpu_torch.utils.apply import make_model_fn

from test_torch_pointnet import perturb
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why

NUM_CLASSES, N, ROUNDS, ITERS, PART, GRAD_APART = 10, 128, 2, 10, 1e-5, 1e-4
SETTINGS = dict(binary_step=ROUNDS, num_iter=ITERS, kappa=30.0, budget=0.45, low_pass=16, knn_k=10)


@functools.partial(jax.jit, static_argnames="method")
def _j_basis(pc, method="auto"):
    return jspectral.lowpass_basis(pc, k=SETTINGS["knn_k"], m=SETTINGS["low_pass"], method=method)


@pytest.fixture(scope="module")
def victim():
    """(jax model_fn, port model_fn, clouds, the JAX victim's clean predictions)."""
    jm = jmodels.make_model("PointNet", NUM_CLASSES)
    v = perturb(jmodels.init_model(jm, jax.random.PRNGKey(1), num_points=N, batch=2), np.random.RandomState(1))
    jfn = j_make_model_fn(jm, v)
    fn = make_model_fn(models.make_model("PointNet", NUM_CLASSES), state_dict_from_flax("PointNet", v), "cpu")
    x = make_synthetic_clouds(8, 1, N, seed=1)[0][:4]
    return jfn, fn, x, np.asarray(jfn(jnp.asarray(x))).argmax(-1)


def run_both(victim, monkeypatch, **kw):
    """Both attacks from the same noise and basis, each victim call
    recorded: ``(jax out, port out, jax calls, port calls, port
    gradients, jax gradient fn)``."""
    jfn, fn, x, clean = victim
    cfg = {**SETTINGS, **kw}
    targeted = cfg.get("targeted", False)
    target = (clean + 1) % NUM_CLASSES if targeted else clean
    y_truth = clean if targeted else None
    key = jax.random.PRNGKey(2)
    keys = jax.random.split(key, ROUNDS)
    noise = np.stack([np.asarray(jax.random.normal(k, x.shape, jnp.float32)) for k in keys])
    jcalls, calls, grads = [], [], []

    def jrec(a):
        jax.debug.callback(lambda z: jcalls.append(np.asarray(z)), a, ordered=True)
        return jfn(a)

    def rec(a):
        calls.append(a.detach().numpy().copy())
        if a.requires_grad:
            a = a.view_as(a)  # the gradient of this use alone, not the leaf's sum
            a.register_hook(lambda g: grads.append(g.numpy().copy()))
        return fn(a)

    # the JAX package's bases, in the order the attack asks for them
    pcs = [x] if cfg.get("reuse_basis", True) else [x + n * 1e-7 for n in noise]
    bases = [np.array(_j_basis(jnp.asarray(p), cfg.get("spectral_method", "auto"))[1]) for p in pcs]
    if len(bases) == 1:  # the JAX attack takes it as it is (the solver is compiled once, in _j_basis)
        monkeypatch.setattr(jaof, "lowpass_basis", lambda pc, **_: (None, jnp.asarray(bases[0])))
    want = jaof.build_aof_attack(jrec, jaof.AOFConfig(**cfg))(
        jnp.asarray(x), jnp.asarray(target), key, None if y_truth is None else jnp.asarray(y_truth))
    bases = [torch.from_numpy(b_) for b_ in bases]
    monkeypatch.setattr(spectral, "lowpass_basis", lambda pc, **_: (None, bases.pop(0)))
    got = build_aof_attack(rec, AOFConfig(**cfg))(
        torch.from_numpy(x), torch.from_numpy(target), None if y_truth is None else torch.from_numpy(y_truth),
        init_noise=torch.from_numpy(noise))
    assert not bases

    both = jax.jit(jax.grad(_jax_loss(jfn, cfg, target), argnums=(0, 1)))

    def jgrad(full, lfc):
        """The JAX package's gradient of the blended loss with respect to
        each of the step's two inputs, summed: its step's gradient."""
        gf, gl = both(jnp.asarray(full), jnp.asarray(lfc))
        return np.asarray(gf) + np.asarray(gl)

    b = x.shape[0]
    split = lambda rec_: [h for r in rec_ for h in (np.split(r, 2) if r.shape[0] == 2 * b else [r])]  # noqa: E731
    return ([np.asarray(t) for t in want], [t.numpy() for t in got], split(jcalls), split(calls), split(grads),
            jgrad)


def _jax_loss(jfn, cfg, target):
    from pointcloudattack_tpu.losses.adv import (
        cross_entropy_adv_loss, logits_adv_loss, untargeted_logits_adv_loss)

    kappa, g = cfg["kappa"], 0.5
    if cfg.get("adv_func", "logits") == "logits":
        adv = (lambda lg, t: logits_adv_loss(lg, t, kappa)) if cfg.get("targeted") else \
            (lambda lg, t: untargeted_logits_adv_loss(lg, t, kappa))
    else:
        adv = cross_entropy_adv_loss if cfg.get("targeted") else (lambda lg, t: -cross_entropy_adv_loss(lg, t))
    t = jnp.asarray(target)
    return lambda full, lfc: jnp.sum((1.0 - g) * adv(jfn(full), t) + g * adv(jfn(lfc), t))


def hold(victim, monkeypatch, **kw):
    (jadv, jdist, jsucc), (adv, dist, succ), jcalls, calls, grads, jgrad = run_both(victim, monkeypatch, **kw)
    per_round = 2 * (ITERS + 1)
    assert len(jcalls) == len(calls) == ROUNDS * per_round + 1
    assert len(grads) == 2 * ROUNDS * ITERS
    b = adv.shape[0]
    never, jg = np.ones(b, bool), {}
    for r in range(ROUNDS):
        c0 = r * per_round
        j_it = np.stack([jcalls[c0 + 2 * i: c0 + 2 * i + 2] for i in range(ITERS + 1)])  # [T+1, 2, B, N, 3]
        p_it = np.stack([calls[c0 + 2 * i: c0 + 2 * i + 2] for i in range(ITERS + 1)])
        apart = np.abs(j_it - p_it).max(axis=(1, 3, 4)) > PART  # [T+1, B]
        for c in range(b):
            if not apart[:, c].any():
                continue
            never[c] = False
            s = int(apart[:, c].argmax())
            assert s > 0, f"round {r}: cloud {c} parted at the round's first iterate"
            # each step's gradient: the port's two input gradients summed, the JAX package's recomputed
            why = False
            for i in range(s):
                gi = r * ITERS + i
                g_port = grads[2 * gi][c] + grads[2 * gi + 1][c]
                if (r, i) not in jg:
                    jg[r, i] = jgrad(j_it[i, 0], j_it[i, 1])
                g_jax = jg[r, i][c]
                why |= bool(((g_port * g_jax < 0) | ((g_port == 0) != (g_jax == 0))).any())
                why |= bool(np.abs(g_port - g_jax).max() > GRAD_APART * np.abs(g_jax).max())
            assert why, f"round {r}: cloud {c} parted at step {s}, and nothing before explains it"
    assert never.any(), "every cloud parted"
    np.testing.assert_array_equal(succ[never], jsucc[never])
    np.testing.assert_allclose(dist[never], jdist[never], rtol=1e-6, atol=0)
    np.testing.assert_allclose(adv[never], jadv[never], rtol=0, atol=PART)
    return never, succ, dist


@pytest.mark.parametrize("kw", [
    {},
    {"targeted": True, "adv_func": "cross_entropy", "batched_forward": True},
    {"reuse_basis": False, "spectral_method": "dense"},
], ids=["aof", "taof-cross-entropy-batched", "aof-per-round-dense-basis"])
def test_aof_matches_jax(victim, monkeypatch, kw):
    never, succ, dist = hold(victim, monkeypatch, **kw)
    assert np.isfinite(dist).all()
    if not kw:  # best tracking on a cloud that never parts: it succeeds with a kept iterate
        assert (never & succ & (dist < 1e9)).any()


def test_aof_rejects_bad_settings():
    fn = lambda a: a.sum(1)  # noqa: E731
    with pytest.raises(ValueError, match="adv_func"):
        build_aof_attack(fn, AOFConfig(adv_func="hinge"))
    run = build_aof_attack(fn, AOFConfig(binary_step=1, num_iter=1))
    with pytest.raises(ValueError, match="init_noise"):
        run(torch.zeros(2, 8, 3), torch.zeros(2, dtype=torch.long), init_noise=torch.zeros(2, 2, 8, 3))


@pytest.mark.parametrize("family", ["aof", "taof"])
def test_cli_attack_aof_on_cpu(tmp_path, capsys, family):
    out = tmp_path / "out"
    extra = ["--attack_method", "target"] if family == "taof" else []
    asr = cli_main([
        "attack", family, "--model", "PointNet", "--num_points", "64", "--num_classes", "3",
        "--binary_step", "1", "--num_iter", "3", "--low_pass", "16", "--aof_gamma", "0.5", "--kappa", "0",
        "--budget", "0.45", "--num_samples", "4", "--device", "cpu", "--output_dir", str(out), *extra,
    ])
    printed = capsys.readouterr().out
    assert f"attack {family}: ASR {asr:.3f}" in printed and "Chamfer " in printed
    summary = json.loads((out / f"attack_{family}_summary.json").read_text())
    assert summary["family"] == family and summary["n"] == 4 and summary["device"] == "cpu"
    bundle = np.load(out / f"{family}_results.npz")
    assert bundle["test_pc"].shape == (4, 64, 3) and np.isfinite(bundle["test_pc"]).all()
    truth = make_synthetic_clouds(3, 16, 64, seed=0)[1][:4]
    np.testing.assert_array_equal(bundle["test_label"], truth)
    np.testing.assert_array_equal(bundle["target_label"], (truth + 1) % 3 if family == "taof" else truth)
