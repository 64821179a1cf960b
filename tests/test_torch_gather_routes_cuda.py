"""The gather kernel's mean route against its plain PyTorch versions, on
the card (pointcloudattack_tpu_torch/csrc/gather_chain.cu): the gather +
chain + mean with the rows' activation and the LeakyReLU max (CurveNet's
LPFAs with ``fused_gather=True``); then CurveNet on that route.  The ball
route (PointNet++'s set abstractions) has its own file,
tests/test_torch_ball_hoist_cuda.py.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gather_routes_cuda.py

Checks come from ``chip_smoke.py``: ``check_gather`` with a slope and
``check_gather_mean`` (``check_group``'s rules: y atol 1e-4, dsrc and dctr
atol and rtol 1e-4, the points and groups of rows with an activated unit
within 1e-5 of 0 left out), and CurveNet's logits on the gather route card
against CPU, the CPU taking the card's choices and activation signs
(``replay``), within LOGP_ATOL.
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
