"""The port's CurveNet (pointcloudattack_tpu_torch/models/curvenet.py)
against the JAX model, on the CPU, at its published widths (the
``default`` curve setting, 40-class head cut to 10 classes) with k=8, B=2,
N=1024 (the CIC blocks' ``npoint`` fix N at 1024 or more).

The JAX model is initialised with flax, its BatchNorm statistics and
affine parameters take seeded values (``perturb``), and its variables are
exported by the port's own spec copy (``state_dict_from_flax``) and loaded
strictly.  Each block is held to its flax counterpart over the same
variables, taken from the one model; the port runs the plain versions of
its kernels (group chain + max and + mean, kNN, FPS), the JAX model its
XLA path.

Tolerances: blocks atol 1e-5, logits atol 1e-4, the input gradient of the
C&W loss within 1e-4 relative L2 (f32 sums in another order through nine
blocks).  The walk's choices are hard: a step that picked another
neighbour would move a curve's feature by the distance between two
points' features, far past these tolerances, so equal curves mean equal
picks; the tests name the smallest top-2 gap of the port's picks, so that
a flip would be named and not absorbed into a tolerance.
"""

import contextlib
import sys
from pathlib import Path

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
from pointcloudattack_tpu.models import curvenet as jcn
from pointcloudattack_tpu.train import torch_port
from pointcloudattack_tpu.utils.apply import make_model_fn as j_make_model_fn
from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.attacks.cw import CWPerturbConfig, build_cw_attack
from pointcloudattack_tpu_torch.cli.main import main as cli_main
from pointcloudattack_tpu_torch.losses.adv import untargeted_logits_adv_loss
from pointcloudattack_tpu_torch.losses.distance import l2_dist
from pointcloudattack_tpu_torch.models import curvenet as cn
from pointcloudattack_tpu_torch.ops import group_chain as gch
from pointcloudattack_tpu_torch.ops.knn import knn_plain
from pointcloudattack_tpu_torch.train import weights
from pointcloudattack_tpu_torch.train.weights import state_dict_from_flax
from pointcloudattack_tpu_torch.utils.apply import make_model_fn

from test_torch_pointnet import perturb

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its choice replay and gradient rule)
from torch_threads import threads  # noqa: E402

torch_threads = threads(1)  # tests/torch_threads.py says why

NUM_CLASSES, N, K, B = 10, 1024, 8, 2
ATOL = 1e-5
TIE = 1e-5  # a replayed choice lies at most this far below the port's own best
# The port against JAX, JAX's discrete choices replayed but not its
# activation signs (JAX runs its LPFAs unfused on the CPU, activating before
# the pool, so its activations do not line up call for call with the
# port's): a LeakyReLU input within rounding of 0 takes slope 1 on one side
# and 0.2 on the other, so every (iterate, cloud) pair is held within
# GRAD_REL_UNSIGNED and a quarter of them (CLEAN_SHARE_UNSIGNED) within
# GRAD_CLEAN_UNSIGNED, not all within chip_smoke.GRAD_CLEAN (the card
# against the CPU, with the signs replayed too, holds GRAD_CLEAN in
# chip_smoke.py)
GRAD_REL_UNSIGNED, GRAD_CLEAN_UNSIGNED, CLEAN_SHARE_UNSIGNED = 5e-2, 1e-4, 0.25


def clouds(seed, b=B):
    return (np.random.RandomState(seed).randn(b, N, 3) * 0.5).astype(np.float32)


def feats(seed, c, b=B, n=N):
    return np.random.RandomState(seed).randn(b, n, c).astype(np.float32)


@pytest.fixture(scope="module")
def curvenet():
    """(jax model, flax variables with seeded statistics, the port's model
    with them loaded, in eval mode and frozen, and its model_fn)."""
    jm = jmodels.make_model("CurveNet", NUM_CLASSES, k=K)
    v = perturb(jmodels.init_model(jm, jax.random.PRNGKey(0), num_points=N, batch=B), np.random.RandomState(0))
    tm = models.make_model("CurveNet", NUM_CLASSES, k=K)
    fn = make_model_fn(tm, state_dict_from_flax("CurveNet", v), "cpu")
    return jm, v, tm, fn


def sub(v, *path):
    """The flax variables of the submodule at ``path``."""
    out = {}
    for col in ("params", "batch_stats"):
        node = v[col]
        for p in path:
            node = node.get(p, {})
        if node:
            out[col] = node
    return out


class Gaps(list):
    """Per call, each cloud's smallest gap ``[B]`` between the value a
    choice took and the next one."""

    def min(self) -> float:
        return float(torch.stack(self).min()) if self else float("inf")

    def max(self) -> float:
        return float(torch.stack(self).max())


@contextlib.contextmanager
def walk_gaps():
    """While open, records the port's walk picks and, for each call of
    ``hard_pick`` and ``curve_starts``, each cloud's smallest top-2 gap of
    the softmax a pick was taken from, or the gap between the last start's
    score and the next one's; yields (picks, gaps)."""
    orig_pick, orig_starts, picks, gaps = cn.hard_pick, cn.curve_starts, [], Gaps()

    def pick(y):
        top = y.detach().topk(2, dim=-1).values
        gaps.append((top[..., 0] - top[..., 1]).flatten(1).amin(1))
        p = orig_pick(y)
        picks.append(p)
        return p

    def starts(att, curve_num):
        s = att.detach().sort(dim=-1, descending=True).values
        gaps.append(s[:, curve_num - 1] - s[:, curve_num])
        return orig_starts(att, curve_num)

    cn.hard_pick, cn.curve_starts = pick, starts
    try:
        yield picks, gaps
    finally:
        cn.hard_pick, cn.curve_starts = orig_pick, orig_starts


def test_spec_copy_matches_export_checkpoint(curvenet):
    _, v, tm, _ = curvenet
    want = torch_port.export_checkpoint("CurveNet", v)
    got = state_dict_from_flax("CurveNet", v)
    assert list(got) == list(want)
    for key, arr in want.items():
        assert tuple(got[key].shape) == arr.shape, key
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    assert list(tm.state_dict()) == list(got)  # the modules register in the reference's order
    assert got["lpfa.mlp.0.0.weight"].shape == (32, 9, 1, 1)
    assert got["cic11.curvegrouping.walk.agent_mlp.0.weight"].shape == (1, 32, 1, 1)
    assert got["cic21.curveaggregation.line_conv_att.weight"].shape == (1, 32, 1, 1)
    assert got["conv0.0.weight"].shape == (1024, 512, 1) and "conv2.bias" in got and "conv1.bias" not in got
    assert "cic31.curvegrouping.att.weight" not in got and "cic12.shortcut.0.weight" not in got
    assert models.OUTPUT_KIND["CurveNet"] == "logits"


@pytest.mark.parametrize("setting", ["default", "long"])
def test_spec_entries_match_jax(setting):
    """Both settings: the same names, flax paths and kinds as the JAX
    package's spec, and a state dict of the port's model goes through the
    JAX porter and back unchanged."""
    mine = [(e.torch_name, e.flax_path, getattr(e, "spatial", None)) for e in weights.curvenet_spec(setting).entries]
    theirs = [(e.torch_name, e.flax_path, getattr(e, "spatial", None))
              for e in torch_port.curvenet_spec(setting).entries]
    assert mine == theirs
    tm = models.make_model("CurveNet", NUM_CLASSES, generator=torch.Generator().manual_seed(1), setting=setting)
    sd = tm.state_dict()
    back = state_dict_from_flax("CurveNet", torch_port.port_curvenet({k: t.numpy() for k, t in sd.items()},
                                                                     setting), setting=setting)
    assert list(back) == list(sd)
    for key, t in sd.items():
        assert torch.equal(back[key], t.to(back[key].dtype)), key


def test_initial_lpfa_matches_flax(curvenet):
    _, v, tm, _ = curvenet
    xyz = clouds(1)
    want = jcn.LPFA(32, K, mlp_num=1, initial=True).apply(sub(v, "lpfa"), None, jnp.asarray(xyz))
    gch.reset_launches()
    got = tm.lpfa(None, torch.from_numpy(xyz))
    assert all(n == 0 for n in gch.LAUNCHES.values())  # plain versions on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("block,c", [("cic11", 16), ("cic32", 64)])
def test_residual_lpfa_matches_flax(curvenet, block, c):
    _, v, tm, _ = curvenet
    n = 1024 if block == "cic11" else 256
    xyz, x = clouds(2)[:, :n], feats(3, c, n=n)
    idx = knn_plain(torch.from_numpy(xyz), K + 1)[:, :, :K]
    want = jcn.LPFA(c, K, mlp_num=1).apply(sub(v, block, "lpfa"), jnp.asarray(x), jnp.asarray(xyz),
                                           idx=jnp.asarray(idx.numpy()))
    got = getattr(tm, block).lpfa(torch.from_numpy(x), torch.from_numpy(xyz), idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("compat", [False, True], ids=["intended", "momentum_compat"])
def test_walk_matches_flax(curvenet, compat):
    _, v, tm, _ = curvenet
    xyz, x = clouds(4), feats(5, 16)
    adj = knn_plain(torch.from_numpy(xyz), K + 1)[:, :, 1:]
    start = cn.curve_starts(torch.from_numpy(np.random.RandomState(6).rand(B, N).astype(np.float32)), 100)
    want = jcn.Walk(K, 100, 5, momentum_compat=compat).apply(
        sub(v, "cic11", "curvegrouping", "walk"), jnp.asarray(xyz), jnp.asarray(x), jnp.asarray(adj.numpy()),
        jnp.asarray(start.numpy().astype(np.int32)))
    walk = tm.cic11.curvegrouping.walk
    walk.momentum_compat = compat
    try:
        with walk_gaps() as (picks, gaps):
            got = walk(torch.from_numpy(xyz), torch.from_numpy(x), adj, start)
    finally:
        walk.momentum_compat = False
    assert got.shape == (B, 100, 5, 16) and len(picks) == 5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL,
                               err_msg=f"smallest top-2 gap of the picks {gaps.min():.3e}")


def test_curve_aggregation_matches_flax(curvenet):
    _, v, tm, _ = curvenet
    x, curves = feats(7, 32), np.random.RandomState(8).randn(B, 100, 5, 32).astype(np.float32)
    want = jcn.CurveAggregation().apply(sub(v, "cic21", "curveaggregation"), jnp.asarray(x), jnp.asarray(curves))
    got = tm.cic21.curveaggregation(torch.from_numpy(x), torch.from_numpy(curves))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_masked_max_pool_matches_flax():
    xyz, x = clouds(9), feats(10, 16)
    want_xyz, want = jcn.MaskedMaxPool(256, 0.1, K).apply({}, jnp.asarray(xyz), jnp.asarray(x))
    got_xyz, got = cn.MaskedMaxPool(256, 0.1, K)(torch.from_numpy(xyz), torch.from_numpy(x))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("block,args,c", [
    ("cic11", (1024, 0.05, K, 32, 64, 2, 1, [100, 5]), 32),
    ("cic31", (256, 0.1, K, 128, 256, 2, 1, None), 128),
], ids=["curves", "subsampled"])
def test_cic_matches_flax(curvenet, block, args, c):
    _, v, tm, _ = curvenet
    xyz, x = clouds(11), feats(12, c)
    with walk_gaps() as (_, gaps):
        got_xyz, got = getattr(tm, block)(torch.from_numpy(xyz), torch.from_numpy(x))
    want_xyz, want = jcn.CIC(*args).apply(sub(v, block), jnp.asarray(xyz), jnp.asarray(x))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL,
                               err_msg=f"smallest gap of the walk's choices {gaps.min():.3e}")


def test_logits_and_walks_match(curvenet):
    """The whole model: logits atol 1e-4, and the curves of each of the
    four walks atol 1e-5 (equal picks)."""
    jm, v, tm, fn = curvenet
    x = clouds(13)
    want, inter = jm.apply(v, jnp.asarray(x), capture_intermediates=True, mutable=["intermediates"])
    curves = {}
    hooks = [getattr(tm, b).curvegrouping.walk.register_forward_hook(
        lambda m, a, out, b=b: curves.__setitem__(b, out)) for b in ("cic11", "cic12", "cic21", "cic22")]
    try:
        with walk_gaps() as (picks, gaps):
            got = fn(torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()
    assert len(picks) == 20
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    for b, t in curves.items():
        jc = np.asarray(inter["intermediates"][b]["curvegrouping"]["walk"]["__call__"][0])
        np.testing.assert_allclose(t.numpy(), jc, rtol=0, atol=ATOL,
                                   err_msg=f"{b}: smallest gap of the walk's choices {gaps.min():.3e}")


def test_cw_loss_input_gradient_matches(curvenet):
    _, v, _, fn = curvenet
    ori = clouds(14)
    adv = ori + np.random.RandomState(15).randn(*ori.shape).astype(np.float32) * 0.01
    target = np.array([0, 1])
    jfn = j_make_model_fn(jmodels.make_model("CurveNet", NUM_CLASSES, k=K), v)

    def jloss(a):
        return jnp.sum(j_adv_loss(jfn(a), jnp.asarray(target), 30.0) + j_l2_dist(a, jnp.asarray(ori)) * 10.0)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(adv)))
    a = torch.from_numpy(adv).requires_grad_(True)
    with walk_gaps() as (_, gaps):
        loss = (untargeted_logits_adv_loss(fn(a), torch.from_numpy(target), 30.0)
                + l2_dist(a, torch.from_numpy(ori)) * 10.0).sum()
    loss.backward()
    rel = float(np.linalg.norm(a.grad.numpy() - want) / np.linalg.norm(want))
    assert rel <= 1e-4, f"relative L2 {rel:.3e}; smallest gap of the walk's choices {gaps.min():.3e}"


def test_train_mode_batch_statistics_match(curvenet):
    """One train-mode forward from the same variables: every BatchNorm's
    running mean as flax moves it (atol 1e-5), and its count of updates:
    5 for a walk's agent_mlp, 4 for its momentum_mlp, 1 for the others.
    The running variance of the BatchNorms updated once is held too, after
    Bessel's correction: PyTorch (the reference's framework) moves it by
    the unbiased batch variance, flax by the biased one."""
    jm, v, _, _ = curvenet
    tm = models.make_model("CurveNet", NUM_CLASSES, k=K)
    tm.load_state_dict(state_dict_from_flax("CurveNet", v), strict=True)
    tm.train()
    tm.dp1.eval()
    rows, orig = {}, cn.batch_norm

    def counting(z, bn, train):
        rows[id(bn)] = z.numel() // z.shape[-1]
        return orig(z, bn, train)

    x = clouds(16)
    cn.batch_norm = counting
    try:
        with torch.no_grad():
            tm(torch.from_numpy(x))
    finally:
        cn.batch_norm = orig
    _, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
    want = torch_port.export_checkpoint("CurveNet", {"params": v["params"], "batch_stats": upd["batch_stats"]})
    before = state_dict_from_flax("CurveNet", v)
    for name, m in tm.named_modules():
        if not isinstance(m, torch.nn.BatchNorm1d):
            continue
        passes = 5 if "agent_mlp" in name else 4 if "momentum_mlp" in name else 1
        assert int(m.num_batches_tracked) == passes, name
        np.testing.assert_allclose(m.running_mean.numpy(), want[f"{name}.running_mean"], rtol=0, atol=ATOL,
                                   err_msg=name)
        if passes == 1:
            old, n = before[f"{name}.running_var"].numpy(), rows[id(m)]
            unbiased = 0.9 * old + (want[f"{name}.running_var"] - 0.9 * old) * n / (n - 1)
            np.testing.assert_allclose(m.running_var.numpy(), unbiased, rtol=1e-5, atol=ATOL, err_msg=name)


class _RecordingJnp:
    """``jax.numpy`` for the JAX CurveNet module, but ``max`` also records
    the mask of its winning rows (``jax.debug.callback``) into ``out``."""

    def __init__(self, out):
        self._out = out

    def __getattr__(self, name):
        return getattr(jnp, name)

    def max(self, a, axis=None, **kw):
        y = jnp.max(a, axis=axis, **kw)
        jax.debug.callback(lambda m: self._out.append(np.asarray(m)), a == jnp.expand_dims(y, axis), ordered=True)
        return y


@contextlib.contextmanager
def jax_choices(curve_num):
    """While open, the JAX CurveNet records its discrete choices in the
    order it runs them (``jax.debug.callback``, so under ``jit`` too): the
    walk's picks, the curve starts and every max pool's winning rows (the
    initial LPFA's, the masked max pools' and the head's); and the port's
    CPU choices take them in the same order (``chip_smoke.replay`` with
    ``chip_smoke.curvenet_hooks(signs=False)``), the initial LPFA's group
    max as the first winning row.  Yields the replay's stats."""
    queues = {"pick": [], "starts": [], "max": []}
    orig_st, orig_topk, orig_jnp = jcn.straight_through_softmax, jax.lax.top_k, jcn.jnp

    def st(logits, axis=-1):
        y = jax.nn.softmax(logits, axis=axis)
        jax.debug.callback(lambda p: queues["pick"].append(np.asarray(p)), jnp.argmax(y, axis=axis), ordered=True)
        return orig_st(logits, axis)

    def top_k(x, k):
        out = orig_topk(x, k)
        if k == curve_num:  # the curve starts; the kNN and the ball query take other k
            jax.debug.callback(lambda i: queues["starts"].append(np.asarray(i)), out[1], ordered=True)
        return out

    def take(kind):
        if kind == "group":
            return torch.from_numpy(queues["max"].pop(0)).int().argmax(2)
        return torch.from_numpy(queues[kind].pop(0).copy())

    jcn.straight_through_softmax, jax.lax.top_k, jcn.jnp = st, top_k, _RecordingJnp(queues["max"])
    try:
        with chip_smoke.replay(chip_smoke.curvenet_hooks(signs=False), take) as stats:
            yield stats
    finally:
        jcn.straight_through_softmax, jax.lax.top_k, jcn.jnp = orig_st, orig_topk, orig_jnp
    left = {k: len(v) for k, v in queues.items() if v}
    assert not left, f"JAX's choices the port never took: {left}"


def test_short_cw_attack_matches_jax(curvenet):
    """1 x 5 C&W on a victim whose statistics come from 8 clouds (one
    train-mode pass, dropout off), carried to flax with ``port_curvenet``,
    on two of them.

    Held: ``success`` identical, and at each of JAX's five iterates the
    loss gradient cloud by cloud, the port taking JAX's discrete choices
    (``jax_choices``: over 4 walks of 100 curves and the max pools the
    smallest top-2 gap of a choice falls to 1e-6 or below, where the two
    sides' rounding may take either), each at most TIE below the port's own
    best: every (iterate, cloud) within GRAD_REL_UNSIGNED (5e-2) relative L2
    and at least CLEAN_SHARE_UNSIGNED (0.25) of them within
    GRAD_CLEAN_UNSIGNED (1e-4).
    This victim's BatchNorms centre their inputs
    at 0, so some LeakyReLU inputs lie within rounding of 0 and take slope
    1 on one side and 0.2 on the other: 3.4e-6 to 2.5e-3 measured, half
    the pairs within 1e-4, where the seeded victim of the other tests holds
    1e-4 at its one input.  The two attacks' iterates are not held point by
    point: Adam turns a relative gradient difference d into a step
    difference of about lr * d, so the iterates part by more than 1e-5
    from the second step on (ROADMAP Queue 3)."""
    jm, v, _, _ = curvenet
    x8 = clouds(17, b=8)
    x = x8[:B]
    tm = models.make_model("CurveNet", NUM_CLASSES, k=K)
    tm.load_state_dict(state_dict_from_flax("CurveNet", v), strict=True)
    tm.train()
    tm.dp1.eval()
    for m in tm.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            m.momentum = 1.0
    with torch.no_grad():
        tm(torch.from_numpy(x8))
    sd = {k: t.detach().clone() for k, t in tm.state_dict().items()}
    jv = torch_port.port_curvenet({k: t.numpy() for k, t in sd.items()})
    fn = make_model_fn(models.make_model("CurveNet", NUM_CLASSES, k=K), sd, "cpu")
    with torch.no_grad():  # the clean predictions (the port's forward: JAX's would be a compile of its own)
        target = fn(torch.from_numpy(x)).argmax(-1).numpy()
    kw = dict(binary_step=1, num_iter=5, kappa=30.0, budget=0.18, attack_lr=0.05)
    key = jax.random.PRNGKey(7)
    noise = np.stack([np.asarray(jax.random.normal(k, x.shape, jnp.float32)) for k in jax.random.split(key, 1)])

    j_its, jfn = [], j_make_model_fn(jm, jv)

    def jfn_rec(a):  # JAX's iterates, in order (the last is the final evaluation)
        jax.debug.callback(lambda q: j_its.append(np.asarray(q)), a, ordered=True)
        return jfn(a)

    want = j_build_cw_attack(jfn_rec, JCWPerturbConfig(**kw))(jnp.asarray(x), jnp.asarray(target), key)
    jax.block_until_ready(want)
    got = build_cw_attack(fn, CWPerturbConfig(**kw))(
        torch.from_numpy(x), torch.from_numpy(target), init_noise=torch.from_numpy(noise))
    assert len(j_its) == 6
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    assert got.success.any() and float(got.best_dist[got.success].min()) > 1e-3

    # the gradient at each of JAX's iterates, the port on JAX's choices
    ori, t = jnp.asarray(x), jnp.asarray(target)
    rels = []
    with jax_choices(100) as stats:
        jm_fn = j_make_model_fn(jm, jv)  # traced afresh, with the callbacks
        jgrad = jax.jit(jax.grad(lambda a: jnp.sum(j_adv_loss(jm_fn(a), t, 30.0) + j_l2_dist(a, ori) * 10.0)))
        for i, it in enumerate(j_its[:5]):
            want_g = np.asarray(jgrad(jnp.asarray(it)))
            a = torch.from_numpy(it.copy()).requires_grad_(True)
            loss = (untargeted_logits_adv_loss(fn(a), torch.from_numpy(target), 30.0)
                    + l2_dist(a, torch.from_numpy(x)) * 10.0).sum()
            (g,) = torch.autograd.grad(loss, a)
            rel = np.linalg.norm((g.numpy() - want_g).reshape(B, -1), axis=1) / np.linalg.norm(
                want_g.reshape(B, -1), axis=1)
            rels.append(rel)
    rels = np.stack(rels)
    msg = f"gradient relative L2 per (iterate, cloud) {rels.tolist()}; {chip_smoke.choice_line(stats)}"
    assert rels.max() <= GRAD_REL_UNSIGNED and (rels <= GRAD_CLEAN_UNSIGNED).mean() >= CLEAN_SHARE_UNSIGNED, msg
    assert all(st["off"] <= TIE for st in stats.values()), chip_smoke.choice_line(stats)


@pytest.mark.parametrize("family", ["cw", "geoa3"])
def test_cli_attack_on_curvenet(tmp_path, capsys, family):
    asr = cli_main(["attack", family, "--model", "CurveNet", "--num_points", "1024", "--num_classes", "10",
                    "--binary_step", "1", "--num_iter", "2", "--num_samples", "1", "--device", "cpu",
                    "--output_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"attack {family}: ASR" in out and "Chamfer" in out
    assert 0.0 <= asr <= 1.0 and (tmp_path / f"attack_{family}_summary.json").is_file()
