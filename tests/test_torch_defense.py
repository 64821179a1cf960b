"""The port's defenses and evaluation panels
(pointcloudattack_tpu_torch/defense/, attacks/evaluation.py, the CLI's
``--defense`` and ``--transfer_test``) against the JAX package, on the CPU.

Tolerances:
- ``sor_defense``: the keep mask and the output exact (the output is a
  gather), at several k, alpha and npoint, with an outlier, duplicate
  points and a pad past N; the input gradient of a weighted sum, atol 1e-6.
  JAX's own cases: the outlier removed, the cyclic pad, no drop on a
  sphere shell.
- ``srs_defense`` on the JAX package's draw: exact; its own draws: a subset
  without duplicates, the same on every call of ``with_defense``.
- ``with_defense`` for SOR, SRS (on JAX's draw) and DUP-Net (PU-Net at
  npoint 64 on exported flax variables) in front of a small PointNet:
  log-probs and the CW loss's input gradient, atol 1e-5.
- ``transfer_matrix``: the same rates as the JAX package's, untargeted and
  targeted.
- The CLI at N=64: ``si-query --defense dupnet`` on a saved PU-Net state
  dict, ``cw --defense sor|srs`` (1 x 2), the refusal without
  ``--defense_checkpoint`` and ``--transfer_test``.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu.attacks import evaluation as jeval
from pointcloudattack_tpu.defense import sor_defense as j_sor, srs_defense as j_srs
from pointcloudattack_tpu.losses.adv import untargeted_logits_adv_loss as j_adv_loss
from pointcloudattack_tpu.models.punet import PUNet as JPUNet
from pointcloudattack_tpu.ops.pairwise import self_sqdist as j_self_sqdist
from pointcloudattack_tpu_torch.attacks import evaluation
from pointcloudattack_tpu_torch.cli.main import main as cli_main
from pointcloudattack_tpu_torch.defense import sor, srs
from pointcloudattack_tpu_torch.losses.adv import untargeted_logits_adv_loss
from pointcloudattack_tpu_torch.models.punet import PUNet
from pointcloudattack_tpu_torch.train.weights import state_dict_from_flax

from test_torch_pointnet import build_pair
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why

N = 64


def sor_cloud(seed, b=3, n=128):
    pc = (np.random.RandomState(seed).randn(b, n, 3) * 0.1).astype(np.float32)
    pc[0, 3] = [2.0, 2.0, 2.0]  # an outlier
    pc[1, 10:14] = pc[1, 20]  # duplicates: distances of 0 beside the point itself
    return pc


def j_keep(pc, k, alpha):
    """The JAX package's keep mask, in its own ops (defense/sor.py:37-42)."""
    neg, _ = jax.lax.top_k(-j_self_sqdist(jnp.asarray(pc)), k + 1)
    value = jnp.mean(-neg[..., 1:], axis=-1)
    thr = jnp.mean(value, axis=-1, keepdims=True) + alpha * jnp.std(value, axis=-1, keepdims=True, ddof=1)
    return np.asarray(value <= thr)


@pytest.mark.parametrize("k,alpha,npoint", [(2, 1.1, 128), (2, 1.1, 100), (4, 0.5, 160), (1, 2.0, 128)])
def test_sor_keep_mask_and_output_match_jax(k, alpha, npoint):
    pc = sor_cloud(k)
    keep = sor.sor_keep(sor.knn_values(torch.from_numpy(pc), k), alpha).numpy()
    np.testing.assert_array_equal(keep, j_keep(pc, k, alpha))
    assert not keep[0, 3] and keep.sum(1).min() < 128  # the outlier dropped
    got = sor.sor_defense(torch.from_numpy(pc), k=k, alpha=alpha, npoint=npoint).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_sor(jnp.asarray(pc), k=k, alpha=alpha, npoint=npoint)))


def test_sor_jax_cases():
    """JAX's own tests (tests/test_defense.py) on the port."""
    rng = np.random.RandomState(21)
    pc = rng.randn(2, 128, 3).astype(np.float32) * 0.1
    pc[0, 0] = [50.0, 50.0, 50.0]
    out = sor.sor_defense(torch.from_numpy(pc), npoint=128).numpy()
    assert out.shape == (2, 128, 3) and not np.any(np.all(np.isclose(out[0], [50, 50, 50]), axis=-1))
    pc = rng.randn(1, 64, 3).astype(np.float32) * 0.1
    pc[0, 10] = [30.0, 0, 0]
    out = sor.sor_defense(torch.from_numpy(pc), npoint=64).numpy()
    kept = np.delete(pc[0], 10, axis=0)  # 63 survivors in order, then the first again
    np.testing.assert_array_equal(out[0, :63], kept)
    np.testing.assert_array_equal(out[0, 63], kept[0])
    pc = rng.randn(1, 128, 3).astype(np.float32)
    pc /= np.linalg.norm(pc, axis=-1, keepdims=True)
    out = sor.sor_defense(torch.from_numpy(pc), npoint=128).numpy()
    assert np.isclose(out[0][:, None], pc[0][None], atol=1e-6).all(-1).any(axis=1).mean() > 0.9


def test_sor_gradient_matches_jax():
    pc = sor_cloud(5)
    w = np.random.RandomState(6).randn(3, 100, 3).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(j_sor(a, npoint=100) * w))(jnp.asarray(pc)))
    a = torch.from_numpy(pc).requires_grad_(True)
    (sor.sor_defense(a, npoint=100) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), want, rtol=0, atol=1e-6)


def j_draw(key, b, n, drop):
    """The JAX package's SRS indices (defense/srs.py:29-32)."""
    keys = jax.random.split(key, b)
    return np.array(jax.vmap(lambda k: jax.random.permutation(k, n)[: n - drop])(keys))  # a writable copy


def test_srs_on_jax_draw_matches_and_its_own_draws_are_subsets(monkeypatch):
    pc = np.random.RandomState(7).randn(2, 128, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(j_srs(jnp.asarray(pc), key, drop_num=28))
    with monkeypatch.context() as m:
        m.setattr(srs, "srs_draw", lambda x, keep, generator=None: torch.from_numpy(j_draw(key, 2, 128, 28)))
        got = srs.srs_defense(torch.from_numpy(pc), drop_num=28).numpy()
    np.testing.assert_array_equal(got, want)
    idx = srs.srs_draw(torch.from_numpy(pc), 100, torch.Generator().manual_seed(0))
    assert idx.shape == (2, 100) and all(len(set(row.tolist())) == 100 for row in idx)
    assert int(idx.min()) >= 0 and int(idx.max()) < 128
    fn = evaluation.with_defense(lambda x: x, "srs", key=5, srs_drop_num=28)
    first, second = fn(torch.from_numpy(pc)), fn(torch.from_numpy(pc))
    np.testing.assert_array_equal(first.numpy(), second.numpy())  # every forward drops the same points
    assert first.shape == (2, 100, 3)
    other = evaluation.with_defense(lambda x: x, "srs", key=6, srs_drop_num=28)(torch.from_numpy(pc))
    assert not torch.equal(other, first)


@pytest.fixture(scope="module")
def victims():
    """(JAX PointNet fn, the port's) on the same weights, and PU-Net's
    flax variables at npoint N with the port's state dict."""
    jfn, fn, _ = build_pair(seed=2)
    jm = JPUNet(npoint=N, up_ratio=4)
    v = jax.device_get(jm.init(jax.random.PRNGKey(4), jnp.zeros((1, N, 3), jnp.float32)))
    rng = np.random.RandomState(8)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.05 * rng.randn(*a.shape)).astype(np.float32) if a.ndim == 1 else np.asarray(a), v)
    return jfn, fn, v, state_dict_from_flax("PUNet", v)


@pytest.mark.parametrize("defense", ["sor", "srs", "dupnet"])
def test_with_defense_matches_jax(victims, defense, monkeypatch):
    jfn, fn, v, sd = victims
    x = np.random.RandomState(9).randn(4, N, 3).astype(np.float32) * 0.3
    target = np.array([0, 1, 2, 0])
    key = jax.random.PRNGKey(11)
    jdef = jax.jit(jeval.with_defense(jfn, defense, key=key, npoint=N, dup_variables=v if defense == "dupnet" else None))
    if defense == "srs":
        draw = torch.from_numpy(j_draw(key, 4, N, N // 2))
        monkeypatch.setattr(srs, "srs_draw", lambda pc, keep, generator=None: draw)
    tdef = evaluation.with_defense(fn, defense, key=11, npoint=N, dup_variables=sd)
    want = np.asarray(jdef(jnp.asarray(x)))
    jgrad = np.asarray(jax.grad(lambda a: jnp.sum(j_adv_loss(jdef(a), jnp.asarray(target), 30.0)))(jnp.asarray(x)))
    a = torch.from_numpy(x).requires_grad_(True)
    got = tdef(a)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    untargeted_logits_adv_loss(got, torch.from_numpy(target), 30.0).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), jgrad, rtol=0, atol=1e-5)


def test_with_defense_unknown_raises():
    with pytest.raises(ValueError, match="unknown defense"):
        evaluation.with_defense(lambda x: x, "dup")


def test_transfer_matrix_matches_jax_and_shuffle_keeps_a_permutation_invariant_result():
    (jfn0, fn0, _), (jfn1, fn1, _) = build_pair(seed=0), build_pair(seed=1)
    x = np.random.RandomState(12).randn(6, N, 3).astype(np.float32) * 0.5
    target = np.array([0, 1, 2, 0, 1, 2])
    for targeted in (False, True):
        want = jeval.transfer_matrix({"a": jfn0, "b": jfn1, "b#2": jfn1}, jnp.asarray(x), jnp.asarray(target),
                                     targeted=targeted)
        got = evaluation.transfer_matrix({"a": fn0, "b": fn1, "b#2": fn1}, torch.from_numpy(x),
                                         torch.from_numpy(target), targeted=targeted)
        assert got == want
    # PointNet in eval mode is invariant to the points' order: the shuffle keeps each cloud's result
    rate = evaluation.shuffle_robustness(fn0, torch.from_numpy(x), torch.from_numpy(target),
                                         torch.Generator().manual_seed(0), num_trials=3)
    unshuffled = evaluation.transfer_matrix({"a": fn0}, torch.from_numpy(x), torch.from_numpy(target))["a"]
    assert rate == unshuffled and 0.0 < rate < 1.0


def cli(tmp_path, family, *extra):
    out = tmp_path / "out"
    asr = cli_main(["attack", family, "--model", "PointNet", "--num_points", str(N), "--num_classes", "3",
                    "--num_samples", "4", "--device", "cpu", "--output_dir", str(out), *extra])
    return asr, json.loads((out / f"attack_{family}_summary.json").read_text())


@pytest.mark.parametrize("family,extra", [("cw", ["--defense", "sor", "--binary_step", "1", "--num_iter", "2"]),
                                          ("cw", ["--defense", "srs", "--binary_step", "1", "--num_iter", "2"]),
                                          ("si-query", ["--defense", "dupnet", "--budget", "0.18", "--step_size",
                                                        "0.32"])],
                         ids=["cw-sor", "cw-srs", "si-query-dupnet"])
def test_cli_attack_behind_a_defense(tmp_path, capsys, family, extra):
    if "dupnet" in extra:
        model = PUNet(npoint=N)
        model.reset_parameters(torch.Generator().manual_seed(0))
        torch.save(model.state_dict(), tmp_path / "pu.pth")
        extra = extra + ["--defense_checkpoint", str(tmp_path / "pu.pth")]
    asr, summary = cli(tmp_path, family, *extra)
    printed = capsys.readouterr().out
    assert f"attack {family}: ASR {asr:.3f}" in printed and "shuffle-robust ASR" in printed
    assert summary["n"] == 4 and summary["device"] == "cpu" and "transfer_asr" not in summary


def test_cli_dupnet_needs_a_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="--defense dupnet requires --defense_checkpoint"):
        cli(tmp_path, "cw", "--defense", "dupnet")


def test_cli_transfer_panel(tmp_path, capsys):
    """Positional pairing, a ``#2`` for a repeated name, the warning for a
    member without a checkpoint, and the refusal of extra checkpoints."""
    _, fn, model = build_pair(seed=3)
    torch.save(model.state_dict(), tmp_path / "pn.pth")
    _, summary = cli(tmp_path, "cw", "--binary_step", "1", "--num_iter", "2", "--transfer_test", "--trans_model",
                     "PointNet,PointNet", "--trans_checkpoint", f"{tmp_path / 'pn.pth'},")
    err = capsys.readouterr().err
    assert sorted(summary["transfer_asr"]) == ["PointNet", "PointNet#2"]
    assert "'PointNet' has no --trans_checkpoint slot" in err and err.count("RANDOMLY INITIALIZED") == 1
    with pytest.raises(SystemExit, match="pairing is positional"):
        cli(tmp_path, "cw", "--binary_step", "1", "--num_iter", "2", "--transfer_test", "--trans_model", "PointNet",
            "--trans_checkpoint", f"{tmp_path / 'pn.pth'},{tmp_path / 'pn.pth'}")
