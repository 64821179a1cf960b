"""The gather kernel's last two routes against their plain PyTorch
versions, on the card (pointcloudattack_tpu_torch/csrc/gather_chain.cu):
the ball query inside the kernel (the eval-mode route of PointNet++ SSG's
and MSG's set abstractions) and the gather + chain + mean with the rows'
activation and the LeakyReLU max (CurveNet's LPFAs with
``fused_gather=True``); then both victims on those routes.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gather_routes_cuda.py

Checks come from ``chip_smoke.py``: ``check_ball`` (the slots equal
``query_ball_point``'s bit for bit, y and the argmax equal the index
route's kernel on them bit for bit, then ``check_gather``'s rules),
``check_gather`` with a slope and ``check_gather_mean`` (``check_group``'s
rules: y atol 1e-4, dsrc and dctr atol and rtol 1e-4, the points and
groups of rows with an activated unit within 1e-5 of 0 left out); the
victims' log-probs on the ball route bit-equal to the index route's
(``query_ball_point``, then the gather kernel, patched in), and
CurveNet's logits on the gather route card against CPU, the CPU taking
the card's choices and activation signs (``replay``), within LOGP_ATOL.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.ops import gather_chain as gc
from pointcloudattack_tpu_torch.utils.apply import make_model_fn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the cases, the checks and the choice replay)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


BALL_CASES = {**{name: shape + (None,) for name, shape in chip_smoke.GATHER_SHAPES.items()},
              **chip_smoke.BALL_EDGE_SHAPES}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BALL_CASES))
def test_ball_kernel_matches_plain_on_card(cuda_device, name):
    """Every set abstraction of SSG and MSG at B=16, a ragged N, N < K,
    empty and overfull balls, and a cloud on a 1/16 grid (distances on the
    radius)."""
    shape = BALL_CASES[name]
    src, ctr, _, layers, layout, dy = chip_smoke.gather_case(7, *shape)
    gc.reset_launches()
    chip_smoke.check_ball(name, src, ctr, layers, layout, shape[2], shape[3], dy)
    # the ball kernel, then the index kernel on its slots twice and the backward on them once
    assert gc.LAUNCHES == {**dict.fromkeys(gc.LAUNCHES, 0), "ball_fwd": 1, "fwd": 2, "bwd": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,widths,slope,pre_act", [
    (1024, 16, (16,), 0.2, True),      # cic11
    (256, 64, (64,), 0.2, True),       # cic31
    (64, 128, (128,), 0.2, True),      # cic42
    (1000, 32, (32,), 0.2, True),      # a ragged N
    (256, 32, (64, 32), 0.2, True),    # two layers
    (200, 24, (40, 24, 8), 0.0, False),  # three layers, ReLU, no row activation
])
def test_gather_mean_kernel_matches_plain_on_card(cuda_device, n, c, widths, slope, pre_act):
    src, ctr, idx, layers, dy = chip_smoke.lpfa_gather_case(n + c, 2, n, c, 20, widths)
    gc.reset_launches()
    chip_smoke.check_gather_mean(f"N={n}", src, ctr, idx, layers, (("diff", 0, c, 0),), dy, slope, pre_act)
    assert gc.LAUNCHES == {**dict.fromkeys(gc.LAUNCHES, 0), "mean_fwd": 1, "mean_bwd": 1}


@pytest.mark.cuda
def test_gather_mean_takes_duplicate_indices(cuda_device):
    """Half of each group's rows repeat its first point: dsrc sums them."""
    src, ctr, idx, layers, dy = chip_smoke.lpfa_gather_case(3, 2, 512, 16, 20, (16,))
    idx[:, :, 10:] = idx[:, :, :1]
    chip_smoke.check_gather_mean("duplicates", src, ctr, idx.contiguous(), layers, (("diff", 0, 16, 0),), dy)


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(32,), (64, 32)])
def test_gather_max_slope_matches_plain_on_card(cuda_device, widths):
    """The initial LPFA's layout (center / pass / diff on the points
    themselves) with LeakyReLU 0.2 between the layers: one layer runs the
    one-layer route's kernels (ops/gather_hoist.py), two the row kernel."""
    from pointcloudattack_tpu_torch.ops import gather_hoist as gh

    src, _, idx, _, dy = chip_smoke.lpfa_gather_case(11, 2, 1024, 3, 20, widths)
    layers = chip_smoke.seeded_layers(np.random.RandomState(12), (9, *widths), cuda_device)
    gc.reset_launches()
    gh.reset_launches()
    chip_smoke.check_gather("slope 0.2", src, src, idx, layers, chip_smoke.CN_INITIAL_LAYOUT, dy, chip_smoke.CN_SLOPE)
    one = len(widths) == 1
    assert gc.LAUNCHES == {**dict.fromkeys(gc.LAUNCHES, 0), "fwd": int(not one), "bwd": int(not one)}
    assert gh.LAUNCHES == dict.fromkeys(gh.LAUNCHES, int(one))


@pytest.mark.cuda
def test_routes_raise_on_what_they_do_not_take(cuda_device):
    src, ctr, _, layers, _ = chip_smoke.lpfa_gather_case(5, 1, 128, 8, 20, (8,))
    idx = torch.randint(0, 128, (1, 128, 66), dtype=torch.int32, device=cuda_device)
    layout = (("diff", 0, 8, 0),)
    with pytest.raises(ValueError, match="K <= 64"):
        gc.gather_chain_mean_fwd(src, ctr, idx, layers, layout, 0.2, True)
    with pytest.raises(ValueError, match="slope"):
        gc.gather_chain_mean_fwd(src, ctr, idx[:, :, :20].contiguous(), layers, layout, 1.5, True)
    with pytest.raises(ValueError, match="xyz"):
        gc.ball_gather_chain_fwd(src, ctr, src[..., :2].contiguous(), layers, layout, 0.2, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["PointNet++Ssg", "PointNet++Msg"])
def test_ball_route_victim_equals_index_route(cuda_device, name):
    """Log-probs on the ball route bit-equal to the index route's (the same
    slots, rows and chain), with the launches moved from the gather kernel
    to the ball kernel, and the input gradient within 1e-6 relative L2
    (only the dsrc atomicAdds' order differs)."""
    from pointcloudattack_tpu_torch.models import common
    from pointcloudattack_tpu_torch.ops.ball_query import query_ball_point

    def index_route(self, src, centers, xyz, layout, radius, nsample):
        idx = query_ball_point(radius, nsample, xyz, centers[..., :3])
        y = gc.gather_chain_groupmax(src, centers, idx, self.fused_layers(), layout)
        return common.relu(y) if self.relu_last else y

    sd = models.make_model(name, 10, generator=torch.Generator().manual_seed(0)).state_dict()
    x = torch.from_numpy((np.random.RandomState(4).randn(2, 1024, 3) * 0.5).astype(np.float32)).cuda()
    fn = make_model_fn(models.make_model(name, 10), sd, cuda_device)
    out = {}
    for index in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            if index:
                mp.setattr(common.PointMLP, "ball_group_max", index_route)
            a = x.clone().requires_grad_(True)
            gc.reset_launches()
            logp = fn(a)
            (g,) = torch.autograd.grad(logp[:, 0].sum(), a)
        out[not index] = (logp.detach(), g, dict(gc.LAUNCHES))
    sas = 2 if name == "PointNet++Ssg" else 6
    assert torch.equal(out[False][0], out[True][0])
    assert out[False][2] == {**dict.fromkeys(gc.LAUNCHES, 0), "fwd": sas, "bwd": sas}
    assert out[True][2] == {**dict.fromkeys(gc.LAUNCHES, 0), "ball_fwd": sas, "ball_bwd": sas}
    rel = float((out[True][1] - out[False][1]).norm() / out[False][1].norm())
    assert rel <= 1e-6, rel


@pytest.mark.cuda
def test_curvenet_gather_route_card_matches_cpu(cuda_device):
    """CurveNet (published widths, 10 classes) with the BatchNorm statistics
    of 4 clouds on the gather route: its forward launches the gather kernels
    (the one-layer route's product and max once, the mean 8 times) and no
    group kernel; logits and the C&W loss gradient
    on the card against the CPU, the CPU taking the card's choices and
    activation signs, within LOGP_ATOL and GRAD_CLEAN."""
    from pointcloudattack_tpu_torch.ops import gather_hoist as gh
    from pointcloudattack_tpu_torch.ops import group_chain as gch

    clouds = torch.from_numpy((np.random.RandomState(3).randn(4, 1024, 3) * 0.5).astype(np.float32))
    model = models.make_model("CurveNet", 10, generator=torch.Generator().manual_seed(0))
    model.train()
    model.dp1.eval()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            m.momentum = 1.0
    with torch.no_grad():
        model(clouds)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    card = make_model_fn(models.make_model("CurveNet", 10, fused_gather=True), state, cuda_device)
    cpu = make_model_fn(models.make_model("CurveNet", 10, fused_gather=True), state, "cpu")
    x = clouds[:2].cuda()
    gc.reset_launches()
    gh.reset_launches()
    gch.reset_launches()
    with torch.no_grad():
        logits = card(x)
    assert bool(torch.isfinite(logits).all())
    assert gc.LAUNCHES == {**dict.fromkeys(gc.LAUNCHES, 0), "mean_fwd": 8}
    assert gh.LAUNCHES == {**dict.fromkeys(gh.LAUNCHES, 0), "product_fwd": 1, "max_fwd": 1}
    assert all(n == 0 for n in gch.LAUNCHES.values())
    adv = x + 0.01 * torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    res = chip_smoke.grad_parity(card, cpu, adv, x, torch.tensor([0, 1], device="cuda"), gather=True)
    assert float(res["lp"].max()) <= chip_smoke.LOGP_ATOL
    assert float(res["pick"].max()) <= chip_smoke.PICK_ATOL
    assert float(res["grad"].max()) <= chip_smoke.GRAD_CLEAN, res["grad"]
