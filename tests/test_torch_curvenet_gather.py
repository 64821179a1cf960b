"""CurveNet on the gather route (``fused_gather``, pointcloudattack_tpu_torch/
models/curvenet.py) against the JAX model, on the CPU, at the published
widths with k=8, B=2, N=1024, the setting of tests/test_torch_curvenet.py.

The JAX package runs the same route (behind ``PCA_FUSED_GATHER``,
``models/curvenet.py:125-218``) through its Pallas gather kernels; here
they are swapped for their f32 oracles, ``reference_gather_chain_groupmax``
and ``reference_gather_chain_groupmean`` (the interpret mode truncates
matmul operands to bf16), with ``FUSED_MAXPOOL["gather"]`` and
``["interpret"]`` set for the gate, in this test process only.  In JAX's
CurveNet ``interpret`` reaches no other Pallas route: its grouped chain
kernels stay off (``fused_chain_on`` follows the per-family policy, off for
CurveNet) and no other module of it reads the flag.

Held: the fold's sources S and T equal JAX's expression within 1e-6; the
logits equal JAX's gather route within atol 1e-5, and the C&W loss's input
gradient within GRAD_CLEAN_UNSIGNED (1e-4) relative L2 per cloud
(measured 1.3e-7 and 9.0e-6 on the CPU).  An element-wise atol of 1e-5
fails the gradient at 11 of the 6144 coordinates of one cloud, by up to
7.2e-5: there a LeakyReLU input lies within rounding of 0 and takes slope
1 on one side and 0.2 on the other; JAX's activation signs are not handed
to the port (tests/test_torch_curvenet.py, ROADMAP Queue 3 item 3).
Against JAX's default XLA path, the logits within 2e-5 and the gradient
within 1e-4 relative L2: the fold's sum order (S and T sum three products
where the unfused layer sums nine; see the test).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu import models as jmodels
from pointcloudattack_tpu.losses.adv import untargeted_logits_adv_loss as j_adv_loss
from pointcloudattack_tpu.losses.distance import l2_dist as j_l2_dist
from pointcloudattack_tpu.models.common import FUSED_MAXPOOL
from pointcloudattack_tpu.ops.pallas import gather_chain_kernel as jgc
from pointcloudattack_tpu.utils.apply import make_model_fn as j_make_model_fn
from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.cli.main import main as cli_main
from pointcloudattack_tpu_torch.losses.adv import untargeted_logits_adv_loss
from pointcloudattack_tpu_torch.losses.distance import l2_dist
from pointcloudattack_tpu_torch.models import curvenet as cn
from pointcloudattack_tpu_torch.ops import gather_chain as gc
from pointcloudattack_tpu_torch.ops import group_chain as gch
from pointcloudattack_tpu_torch.train.weights import state_dict_from_flax
from pointcloudattack_tpu_torch.utils.apply import make_model_fn

from test_torch_curvenet import B, GRAD_CLEAN_UNSIGNED, K, NUM_CLASSES, clouds, feats, sub, walk_gaps
from test_torch_pointnet import perturb
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why


@pytest.fixture(scope="module")
def gather_pair():
    """(jax model, flax variables with seeded statistics, the port's CurveNet
    on the gather route with them loaded, its model_fn, and the port on the
    grouped route)."""
    jm = jmodels.make_model("CurveNet", NUM_CLASSES, k=K)
    v = perturb(jmodels.init_model(jm, jax.random.PRNGKey(0), num_points=1024, batch=B), np.random.RandomState(0))
    sd = state_dict_from_flax("CurveNet", v)
    tm = models.make_model("CurveNet", NUM_CLASSES, k=K, fused_gather=True)
    fn = make_model_fn(tm, sd, "cpu")
    grouped = make_model_fn(models.make_model("CurveNet", NUM_CLASSES, k=K, fused_gather=False), sd, "cpu")
    return jm, v, tm, fn, grouped


@pytest.fixture
def jax_gather_route(monkeypatch):
    """JAX's CurveNet on its gather route, the Pallas ops swapped for their
    f32 oracles (``interpret`` dropped)."""
    monkeypatch.setitem(FUSED_MAXPOOL, "gather", True)
    monkeypatch.setitem(FUSED_MAXPOOL, "interpret", True)
    monkeypatch.setattr(jgc, "gather_chain_groupmax",
                        lambda src, centers, idx, layers, layout, interpret=False, slope=0.0:
                        jgc.reference_gather_chain_groupmax(src, centers, idx, layers, layout, slope))
    monkeypatch.setattr(jgc, "gather_chain_groupmean",
                        lambda src, centers, idx, layers, layout, interpret=False, slope=0.0, pre_act=False:
                        jgc.reference_gather_chain_groupmean(src, centers, idx, layers, layout, slope, pre_act))


def jax_logits_and_grad(jm, v, x, target):
    """JAX's logits and the C&W loss's input gradient at ``x`` (its first
    cloud's loss weighed as the attack's first round)."""
    jfn = j_make_model_fn(jm, v)  # traced afresh under the current settings
    ori = jnp.asarray(x)

    def loss(a):
        return jnp.sum(j_adv_loss(jfn(a), jnp.asarray(target), 30.0) + j_l2_dist(a, ori) * 10.0)

    adv = jnp.asarray(x + np.random.RandomState(15).randn(*x.shape).astype(np.float32) * 0.01)
    return np.asarray(jfn(ori)), np.asarray(jax.grad(loss)(adv)), np.asarray(adv)


def port_logits_and_grad(fn, x, adv, target):
    with torch.no_grad():
        logits = fn(torch.from_numpy(x))
    a = torch.from_numpy(adv.copy()).requires_grad_(True)
    loss = (untargeted_logits_adv_loss(fn(a), torch.from_numpy(target), 30.0)
            + l2_dist(a, torch.from_numpy(x)) * 10.0).sum()
    (g,) = torch.autograd.grad(loss, a)
    return logits.numpy(), g.numpy()


@pytest.mark.parametrize("block,c", [("cic11", 16), ("cic42", 128)])
def test_fold_sources_match_jax_expression(gather_pair, block, c):
    """S = x + xyz @ ((Wn + Wd) * mul) and T = x - xyz @ ((Wc - Wd) * mul) -
    const from the same flax parameters, as JAX's route builds them
    (``models/curvenet.py:201-213``), within 1e-6."""
    _, v, tm, _, _ = gather_pair
    p = sub(v, block, "lpfa")
    w9 = jnp.asarray(p["params"]["xyz2feature"]["kernel"])
    pb, st = p["params"]["xyz2feature_bn"], p["batch_stats"]["xyz2feature_bn"]
    mul = jax.lax.rsqrt(jnp.asarray(st["var"]) + 1e-5) * jnp.asarray(pb["scale"])
    const = jnp.asarray(pb["bias"]) - jnp.asarray(st["mean"]) * mul
    a_n = (w9[3:6] + w9[6:9]) * mul[None, :]
    a_c = (w9[0:3] - w9[6:9]) * mul[None, :]
    x, xyz = feats(20, c), clouds(21)
    want_s = jnp.asarray(x) + jnp.asarray(xyz) @ a_n
    want_t = jnp.asarray(x) - jnp.asarray(xyz) @ a_c - const[None, None, :]
    s, t = getattr(tm, block).lpfa.fold(torch.from_numpy(x), torch.from_numpy(xyz))
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(want_s), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(want_t), rtol=0, atol=1e-6)


def test_gather_route_matches_jax_gather_route(gather_pair, jax_gather_route):
    """Logits within atol 1e-5 and the C&W loss's input gradient within
    GRAD_CLEAN_UNSIGNED relative L2 per cloud of JAX's own gather route run
    in f32 (the module docstring says why not element-wise); the port runs
    the plain versions of the gather op (no kernel launch) and none of the
    group op."""
    jm, v, _, fn, _ = gather_pair
    x, target = clouds(13), np.array([0, 1])
    want, want_g, adv = jax_logits_and_grad(jm, v, x, target)
    gc.reset_launches()
    gch.reset_launches()
    with walk_gaps() as (picks, gaps):
        got, got_g = port_logits_and_grad(fn, x, adv, target)
    assert all(n == 0 for n in gc.LAUNCHES.values()) and all(n == 0 for n in gch.LAUNCHES.values())
    assert len(picks) == 40  # the four walks' five steps, in the two forwards
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=f"smallest walk gap {gaps.min():.3e}")
    rel = np.linalg.norm((got_g - want_g).reshape(B, -1), axis=1) / np.linalg.norm(want_g.reshape(B, -1), axis=1)
    assert rel.max() <= GRAD_CLEAN_UNSIGNED, f"relative L2 per cloud {rel}; smallest walk gap {gaps.min():.3e}"


def test_gather_route_against_jax_default_path(gather_pair):
    """The same forward and gradient against JAX's default XLA path (the
    unfused LPFAs): logits within 2e-5 and the gradient within 1e-4
    relative L2, the fold's sum order and the activation signs near 0 (see
    the module docstring); the port's grouped route on the same input sits
    within 2e-5 of the gather route's logits too."""
    jm, v, _, fn, grouped = gather_pair
    x, target = clouds(13), np.array([0, 1])
    want, want_g, adv = jax_logits_and_grad(jm, v, x, target)
    got, got_g = port_logits_and_grad(fn, x, adv, target)
    ref, ref_g = port_logits_and_grad(grouped, x, adv, target)
    rel = float(np.linalg.norm(got_g - want_g) / np.linalg.norm(want_g))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert rel <= 1e-4, rel
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_gather_knob_picks_the_route(monkeypatch, tmp_path, capsys):
    """Only the ``fused_gather`` keyword picks the route: CurveNet is built
    on the grouped route unless it is set, whatever ``PCA_FUSED_GATHER`` (the
    JAX package's knob) says, and the CLI, which has no such option, runs
    the grouped route."""
    monkeypatch.setenv("PCA_FUSED_GATHER", "1")
    assert not models.make_model("CurveNet", 10).lpfa.fused_gather
    assert not models.make_model("CurveNet", 10).cic42.lpfa.fused_gather
    assert models.make_model("CurveNet", 10, fused_gather=True).cic42.lpfa.fused_gather
    calls = []
    orig = cn.gather_chain_groupmean
    monkeypatch.setattr(cn, "gather_chain_groupmean", lambda *a, **k: calls.append(1) or orig(*a, **k))
    asr = cli_main(["attack", "cw", "--model", "CurveNet", "--num_points", "1024", "--num_classes", "10",
                    "--binary_step", "1", "--num_iter", "2", "--num_samples", "1", "--device", "cpu",
                    "--output_dir", str(tmp_path)])
    assert "attack cw: ASR" in capsys.readouterr().out and 0.0 <= asr <= 1.0
    assert not calls
