"""PointNet++ SSG and MSG on the ball route (the ball query inside the
gather op, ``PointMLP.ball_group_max``, the eval-mode route of every
neighbourhood set abstraction, pointcloudattack_tpu_torch/models/pointnet2.py)
on the CPU, at B=2, N=1024, the setting of tests/test_torch_pointnet2.py.

The ball route picks the slots that ``query_ball_point`` picks and runs
the same rows through the same chain, so on the CPU (the plain versions)
its log-probs and the C&W loss's input gradient equal those of the index
route (``query_ball_point``, then ``gather_chain_groupmax``: ``index_route``
below, the reference it replaced) bit for bit.  Against the JAX models on
their default XLA path, as tests/test_torch_pointnet2.py holds them:
log-probs at atol 1e-5, the gradient at atol 1e-5 and rtol 1e-4.
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu import models as jmodels
from pointcloudattack_tpu.losses.adv import untargeted_logits_adv_loss as j_adv_loss
from pointcloudattack_tpu.losses.distance import l2_dist as j_l2_dist
from pointcloudattack_tpu.utils.apply import make_model_fn as j_make_model_fn
from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.cli.main import main as cli_main
from pointcloudattack_tpu_torch.losses.adv import untargeted_logits_adv_loss
from pointcloudattack_tpu_torch.losses.distance import l2_dist
from pointcloudattack_tpu_torch.models import common
from pointcloudattack_tpu_torch.models import pointnet2 as pn2
from pointcloudattack_tpu_torch.ops import gather_chain as gc
from pointcloudattack_tpu_torch.ops.ball_query import query_ball_point
from pointcloudattack_tpu_torch.train.weights import state_dict_from_flax
from pointcloudattack_tpu_torch.utils.apply import make_model_fn

from test_torch_pointnet import perturb
from test_torch_pointnet2 import B, NAMES, NUM_CLASSES, NUM_POINTS, clouds
from torch_threads import threads

torch_threads = threads(2)  # tests/torch_threads.py says why


@contextlib.contextmanager
def index_route():
    """While open, ``PointMLP.ball_group_max`` takes ``query_ball_point``'s
    slots and runs ``gather_chain_groupmax`` on them: the index route."""
    def group_max(self, src, centers, xyz, layout, radius, nsample):
        idx = query_ball_point(radius, nsample, xyz, centers[..., :3])
        y = gc.gather_chain_groupmax(src, centers, idx, self.fused_layers(), layout)
        return common.relu(y) if self.relu_last else y

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common.PointMLP, "ball_group_max", group_max)
        yield


@pytest.fixture(scope="module", params=NAMES, ids=["ssg", "msg"])
def routes(request):
    """(name, jax model_fn, the port's model_fn) over the same seeded flax
    variables."""
    name = request.param
    jm = jmodels.make_model(name, NUM_CLASSES)
    v = perturb(jmodels.init_model(jm, jax.random.PRNGKey(0), num_points=NUM_POINTS, batch=B),
                np.random.RandomState(0))
    sd = state_dict_from_flax(name, v)
    return name, j_make_model_fn(jm, v), make_model_fn(models.make_model(name, NUM_CLASSES), sd, "cpu")


def test_ball_route_log_probs(routes, monkeypatch):
    """Bit-equal to the index route's, within atol 1e-5 of JAX's; the ball
    route asks ``query_ball_point`` once per set abstraction and radius
    (through the plain ball op)."""
    name, jfn, fn = routes
    x = clouds(1)
    calls = []
    orig = gc.query_ball_point
    monkeypatch.setattr(gc, "query_ball_point", lambda *a, **k: calls.append(a[:2]) or orig(*a, **k))
    gc.reset_launches()
    got = fn(torch.from_numpy(x))
    assert all(n == 0 for n in gc.LAUNCHES.values())
    assert len(calls) == (2 if name == "PointNet++Ssg" else 6)
    with index_route():
        assert torch.equal(got, fn(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jfn(jnp.asarray(x))), rtol=0, atol=1e-5)


def test_ball_route_input_gradient(routes):
    """The C&W loss's input gradient: bit-equal to the index route's (the
    same slots through the same plain backward), within atol 1e-5 and rtol
    1e-4 of JAX's."""
    _, jfn, fn = routes
    ori = clouds(2)
    adv = ori + np.random.RandomState(3).randn(*ori.shape).astype(np.float32) * 0.01
    target = np.array([0, 1])

    def jloss(a):
        return jnp.sum(j_adv_loss(jfn(a), jnp.asarray(target), 30.0) + j_l2_dist(a, jnp.asarray(ori)) * 10.0)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(adv)))

    def grad():
        a = torch.from_numpy(adv).requires_grad_(True)
        loss = (untargeted_logits_adv_loss(fn(a), torch.from_numpy(target), 30.0)
                + l2_dist(a, torch.from_numpy(ori)) * 10.0).sum()
        return torch.autograd.grad(loss, a)[0]

    got = grad()
    with index_route():
        assert torch.equal(grad(), got)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_ball_route_is_eval_only(monkeypatch):
    """Train mode stays on the unfused path: the ball op is not called,
    ``query_ball_point`` picks the balls (MSG: once per radius on one
    shared distance matrix), and the statistics move as the index route
    moves them."""
    x = torch.from_numpy(clouds(4))
    out = {}
    for index in (False, True):
        tm = models.make_model("PointNet++Msg", NUM_CLASSES, generator=torch.Generator().manual_seed(0))
        tm.train()
        torch.manual_seed(0)  # the head's dropout masks
        with (index_route() if index else contextlib.nullcontext()), torch.no_grad():
            tm(x)
        out[index] = tm.state_dict()
    assert all(torch.equal(out[False][k], out[True][k]) for k in out[False])
    calls = []
    orig = pn2.query_ball_point
    monkeypatch.setattr(pn2, "query_ball_point", lambda *a, **k: calls.append(k.get("sqr")) or orig(*a, **k))
    monkeypatch.setattr(gc, "ball_gather_chain_groupmax", None)  # any call raises
    monkeypatch.setattr(common, "ball_gather_chain_groupmax", None)
    tm = models.make_model("PointNet++Msg", NUM_CLASSES, generator=torch.Generator().manual_seed(0))
    tm.train()
    with torch.no_grad():
        tm(x)
    assert len(calls) == 6 and all(sqr is not None for sqr in calls)


def test_ballq_knob_picks_the_route(monkeypatch, tmp_path, capsys):
    """No knob picks the route: with ``PCA_FUSED_BALLQ`` set to 0 (which the
    JAX package reads), the port's models take no route option and every
    eval-mode neighbourhood set abstraction, through the CLI too, runs the
    ball op and never ``query_ball_point`` on its own."""
    monkeypatch.setenv("PCA_FUSED_BALLQ", "0")
    for name in NAMES:
        with pytest.raises(TypeError):
            models.make_model(name, 10, fused_ballq=False)
    balls, lone = [], []
    orig_ball, orig_q = common.ball_gather_chain_groupmax, pn2.query_ball_point
    monkeypatch.setattr(common, "ball_gather_chain_groupmax", lambda *a, **k: balls.append(a[5]) or orig_ball(*a, **k))
    monkeypatch.setattr(pn2, "query_ball_point", lambda *a, **k: lone.append(a[0]) or orig_q(*a, **k))
    asr = cli_main(["attack", "cw", "--model", "PointNet++Ssg", "--num_points", "128", "--num_classes", "3",
                    "--binary_step", "1", "--num_iter", "2", "--num_samples", "2", "--device", "cpu",
                    "--output_dir", str(tmp_path)])
    assert f"attack cw: ASR {asr:.3f}" in capsys.readouterr().out
    assert balls and set(balls) == {0.2, 0.4} and not lone
