"""The ball route (pointcloudattack_tpu_torch/csrc/ball_hoist.cu, through
ops/ball_hoist.py: PointNet++'s set abstractions) against its plain
PyTorch versions, on the card; then both PointNet++ victims on it.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ball_hoist_cuda.py

Checks come from ``chip_smoke.py``'s ``check_ball``: the slots equal
``query_ball_point``'s bit for bit; the route against ``gather_chain.py``'s
plain versions under ``check_gather``'s rules (y atol 1e-4, every pick
within 1e-4 of the plain max, dsrc and dctr atol and rtol 1e-4 outside
the points and groups of a winning row with a hidden unit within 1e-5 of
0); each kernel against its own plain version (the products and the
stacks within those tolerances, the hidden signs equal beyond 1e-5 of 0,
the winners, the reverse lists and the pull bit for bit, two backwards
bit-equal).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.ops import ball_hoist as bh
from pointcloudattack_tpu_torch.ops import gather_chain as gc
from pointcloudattack_tpu_torch.utils.apply import make_model_fn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the cases and the checks)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# Every set abstraction of SSG and MSG at B=16, chip_smoke's edge cases (a
# ragged N, N < K, empty and overfull balls, a cloud on a 1/16 grid), a last
# layer of 256 over overfull balls of 128 slots, whose groups win more rows
# than the backward's tile of 64 holds, four layers of widths that no tile
# divides, and K=48, which leaves the forward's 128-row tile partly empty
# The input gradient of a PointNet++ victim on the ball route against the
# index route that takes its picks, relative L2 per cloud: what remains is
# rounding (at most 3.2e-7 on an H100, SSG and MSG), and a hidden unit
# within rounding of 0, whose side the ball route saves and the row kernel
# recomputes
VICTIM_GRAD_REL = 1e-6

BALL_CASES = {**{name: shape + (None,) for name, shape in chip_smoke.GATHER_SHAPES.items()},
              **chip_smoke.BALL_EDGE_SHAPES,
              "groups wider than a tile": (1024, 64, 1.0, 128, 0, "ssg", (32, 256), None),
              "four layers, odd widths": (512, 64, 0.4, 16, 5, "msg", (20, 36, 12, 40), None),
              "K=48": (512, 64, 0.4, 48, 0, "ssg", (32, 64), None)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BALL_CASES))
def test_ball_route_matches_plain_on_card(cuda_device, name):
    shape = BALL_CASES[name]
    src, ctr, _, layers, layout, dy = chip_smoke.gather_case(7, *shape)
    gc.reset_launches()
    bh.reset_launches()
    chip_smoke.check_ball(name, src, ctr, layers, layout, shape[2], shape[3], dy)
    # the route's forward, its forward again on the slots, the kernels' checks
    # and the route's backward once plus twice
    assert bh.LAUNCHES == {"slots_fwd": 1, "product_fwd": 3, "stack_fwd": 3,
                           **dict.fromkeys(chip_smoke.BALL_KEYS[3:], 4)}
    assert all(n == 0 for n in gc.LAUNCHES.values())  # no row kernel on the ball route


@pytest.mark.cuda
def test_ball_route_raises_on_what_it_does_not_take(cuda_device):
    src, ctr, _, layers, layout, _ = chip_smoke.gather_case(5, 256, 64, 0.2, 16, 0, "ssg", (16, 32))
    with pytest.raises(ValueError, match="xyz"):
        gc.ball_gather_chain_fwd(src, ctr, src[..., :2].contiguous(), layers, layout, 0.2, 16)
    with pytest.raises(ValueError, match="K <= 128"):
        gc.ball_gather_chain_fwd(src, ctr, src[..., :3].contiguous(), layers, layout, 0.2, 129)
    with pytest.raises(ValueError, match="2-4 layers"):
        gc.ball_gather_chain_fwd(src, ctr, src[..., :3].contiguous(), layers[:1], layout, 0.2, 16)


def victim_routes(name, device):
    """PointNet++ ``name`` (10 classes, random weights) on two seeded clouds,
    on the ball route twice and on the index route (``query_ball_point``,
    then the row kernel, patched in) once, the index route taking the ball
    route's picks at each set abstraction (the row kernel's forward still
    gives y; its backward runs on the ball route's am).  Returns, per run,
    (log-probs, input gradient, gather_chain launches, ball_hoist launches),
    and per set abstraction (ball y, ball am, row y, row am) of the row
    kernel's own forward."""
    from pointcloudattack_tpu_torch.models import common
    from pointcloudattack_tpu_torch.ops.ball_query import query_ball_point

    def index_route(self, src, centers, xyz, layout, radius, nsample):
        idx = query_ball_point(radius, nsample, xyz, centers[..., :3])
        y = gc.gather_chain_groupmax(src, centers, idx, self.fused_layers(), layout)
        return common.relu(y) if self.relu_last else y

    ball_forward, row_forward = bh.forward, gc._fwd_kernel
    picks, sas = [], []

    def recorded_forward(*args, **kw):
        out = ball_forward(*args, **kw)
        picks.append((out[0].clone(), out[1].clone()))
        return out

    def handed_forward(*args, **kw):
        y, am = row_forward(*args, **kw)
        y_ball, am_ball = picks[len(sas)]
        sas.append((y_ball, am_ball, y.clone(), am.clone()))
        return y, am_ball.clone()

    sd = models.make_model(name, 10, generator=torch.Generator().manual_seed(0)).state_dict()
    x = torch.from_numpy((np.random.RandomState(4).randn(2, 1024, 3) * 0.5).astype(np.float32)).to(device)
    fn = make_model_fn(models.make_model(name, 10), sd, device)
    runs = []
    for index, record in ((False, True), (False, False), (True, False)):
        with pytest.MonkeyPatch.context() as mp:
            if record:
                mp.setattr(bh, "forward", recorded_forward)
            if index:
                mp.setattr(common.PointMLP, "ball_group_max", index_route)
                mp.setattr(gc, "_fwd_kernel", handed_forward)
            a = x.clone().requires_grad_(True)
            gc.reset_launches()
            bh.reset_launches()
            logp = fn(a)
            (g,) = torch.autograd.grad(logp[:, 0].sum(), a)
        runs.append((logp.detach(), g, dict(gc.LAUNCHES), dict(bh.LAUNCHES)))
    return runs, sas


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["PointNet++Ssg", "PointNet++Msg"])
def test_ball_route_victim_matches_index_route(cuda_device, name):
    """Log-probs on the ball route within LOGP_ATOL of the index route's,
    with the launches moved from the row kernel to the ball route's; the
    input gradient bit-equal over two runs, and within VICTIM_GRAD_REL
    relative L2 per cloud of the index route's when that route takes the
    ball route's picks.  Where the row kernel's own pick parts from the
    ball route's, the pick is a near-tie: the two maxima lie within
    PICK_ATOL."""
    runs, sas = victim_routes(name, cuda_device)
    n_sa = 2 if name == "PointNet++Ssg" else 6
    (lp, g, gl, bl), (lp2, g2, _, _), (lp_i, g_i, gl_i, bl_i) = runs
    assert torch.equal(lp, lp2) and torch.equal(g, g2)
    assert float((lp - lp_i).abs().max()) <= chip_smoke.LOGP_ATOL
    assert gl_i == {**dict.fromkeys(gc.LAUNCHES, 0), "fwd": n_sa, "bwd": n_sa} and all(n == 0 for n in bl_i.values())
    assert all(n == 0 for n in gl.values()) and bl == dict.fromkeys(bh.LAUNCHES, n_sa)
    assert len(sas) == n_sa
    parted = [int((am_b != am_r).sum()) for _, am_b, _, am_r in sas]
    gap = max(float((y_b - y_r).abs().max()) for y_b, _, y_r, _ in sas)
    rel = [float((g[c] - g_i[c]).norm() / g_i[c].norm()) for c in range(g.shape[0])]
    assert gap <= chip_smoke.PICK_ATOL, (gap, parted)
    assert max(rel) <= VICTIM_GRAD_REL, (rel, parted, gap)
