"""The grouped chain + max and chain + mean CUDA kernels against their
plain PyTorch versions, on the card (pointcloudattack_tpu_torch/csrc/
group_chain.cu), and CurveNet on the card against the CPU.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_curvenet_cuda.py

Checks come from ``chip_smoke.py``: ``check_group`` (y within Y_TOL, the
argmax equal but at near ties, card picks at most PICK_ATOL below the
plain max, dx within DX_TOL on the rows that carry a cotangent, rows with
an activated unit within EDGE of 0 left out); CurveNet's logits on the
card against the CPU, the CPU taking the card's discrete choices and
activation signs (``replay`` with ``curvenet_hooks``), within LOGP_ATOL;
the kernels' own pre-activations (``kernel_rows``, whose signs the replay
hands over) give the mean kernel's output bit for bit.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.ops import fps as fps_mod
from pointcloudattack_tpu_torch.ops import group_chain as gch
from pointcloudattack_tpu_torch.ops import knn as knn_mod
from pointcloudattack_tpu_torch.utils.apply import make_model_fn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the checks, the cases and the choice replay)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["max", "mean"])
@pytest.mark.parametrize("b,g,k,dims,slope", [
    (2, 1024, 20, (9, 32), 0.2),        # the initial LPFA
    (2, 64, 20, (128, 128), 0.2),       # the last residual LPFA
    (3, 1000, 20, (16, 16), 0.2),       # a ragged G: 3 groups a tile
    (2, 333, 7, (16, 24), 0.2),         # K=7: 9 groups, 63 of 64 rows
    (2, 256, 20, (32, 64, 32), 0.2),    # two layers
    (2, 100, 20, (12, 40, 24, 8), 0.0),  # three layers, ReLU
    (1, 5, 64, (9, 32), 0.2),           # K = 64: one group a tile
    (1, 7, 33, (3, 300), 0.2),          # K = 33 (TM = 8), a chunked output width
])
def test_group_kernels_match_plain_on_card(cuda_device, pool, b, g, k, dims, slope):
    x, layers, dy = chip_smoke.group_case(k * 7 + len(dims), b, g, k, dims, cuda_device)
    gch.reset_launches()
    chip_smoke.check_group(f"B={b} G={g} K={k}", pool, x, layers, dy, slope)
    assert gch.LAUNCHES[f"group_{pool}_fwd"] == 1 and gch.LAUNCHES[f"group_{pool}_bwd"] == 1


@pytest.mark.cuda
def test_group_max_ties_take_the_first_row(cuda_device):
    """Rows 3 and 11 of each group copy row 1: the kernel's argmax never
    names them, it equals the plain version's exactly, and dx puts the
    cotangent on the first row only."""
    x, layers, dy = chip_smoke.group_case(5, 2, 300, 20, (9, 32), cuda_device)
    x[:, :, 3] = x[:, :, 1]
    x[:, :, 11] = x[:, :, 1]
    y, am = gch.chain_groupmax_fwd(x, layers, 0.2)
    y_ref, am_ref = gch.chain_groupmax_plain(x, layers, 0.2)
    torch.cuda.synchronize()
    assert torch.equal(am, am_ref) and bool((am == 1).any())
    assert not bool(((am == 3) | (am == 11)).any())
    g = (dy * layers[-1][3]).contiguous()
    dx = gch.chain_groupmax_bwd(x, layers, am, g, 0.2)
    torch.testing.assert_close(dx, gch.chain_groupmax_bwd_plain(x, layers, am, g, 0.2), **chip_smoke.DX_TOL)
    assert not bool(dx[:, :, 3].any()) and not bool(dx[:, :, 11].any())


@pytest.mark.cuda
def test_group_kernels_raise_on_what_they_do_not_take(cuda_device):
    x, layers, _ = chip_smoke.group_case(6, 1, 4, 65, (9, 16), cuda_device)
    with pytest.raises(ValueError, match="K <= 64"):
        gch.chain_groupmean_fwd(x, layers, 0.2)
    with pytest.raises(ValueError, match="slope"):
        gch.chain_groupmax_fwd(x[:, :, :20].contiguous(), layers, -0.5)
    with pytest.raises(ValueError, match="float32"):
        gch.chain_groupmax_fwd(x[:, :, :20].double(), layers, 0.2)


@pytest.mark.cuda
def test_autograd_ops_launch_both_directions(cuda_device):
    x, layers, dy = chip_smoke.group_case(7, 2, 64, 20, (16, 16), cuda_device)
    xr = x.clone().requires_grad_(True)
    gch.reset_launches()
    for op in (gch.mlp_chain_groupmax, gch.mlp_chain_groupmean):
        (dx,) = torch.autograd.grad(op(xr, layers, 0.2), xr, dy)
        assert dx.shape == x.shape and bool(torch.isfinite(dx).all())
    assert gch.LAUNCHES == {"group_max_fwd": 1, "group_max_bwd": 1, "group_mean_fwd": 1, "group_mean_bwd": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("g,c", [(1024, 16), (256, 64), (64, 128)])
def test_kernel_rows_give_the_mean_kernels_output(cuda_device, g, c):
    """The max kernel over groups of one row gives the pre-activations the
    mean kernel sums: their activations summed in ascending k and divided
    by K (a true division: PyTorch divides a CUDA tensor by a Python number
    through its reciprocal) are its output bit for bit."""
    from pointcloudattack_tpu_torch.ops.chain_maxpool import act
    from pointcloudattack_tpu_torch.ops.pairwise import sum_neighbours

    x, layers, _ = chip_smoke.group_case(g + c, 2, g, 20, (c, c), cuda_device)
    z = chip_smoke.kernel_rows(x, layers, 0.2)
    y = gch.chain_groupmean_fwd(x, layers, 0.2)
    torch.cuda.synchronize()
    assert z.shape == (2, g, 20, c)
    s = sum_neighbours(act(z, 0.2))
    assert torch.equal(s / torch.full_like(s, 20), y)  # a true division, as the kernel's


@pytest.fixture
def curvenet_pair(cuda_device):
    """A seeded CurveNet (k=20, the published widths, 10 classes) with the
    BatchNorm statistics of 4 clouds, on the card and on the CPU, and two
    of the clouds."""
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
    card = make_model_fn(models.make_model("CurveNet", 10), state, cuda_device)
    cpu = make_model_fn(models.make_model("CurveNet", 10), state, "cpu")
    return card, cpu, clouds[:2]


@pytest.mark.cuda
def test_curvenet_forward_runs_the_kernels(curvenet_pair):
    card, _, x = curvenet_pair
    for mod in (gch, knn_mod, fps_mod):
        mod.reset_launches()
    with torch.no_grad():
        logits = card(x.cuda())
    torch.cuda.synchronize()
    assert logits.shape == (2, 10) and bool(torch.isfinite(logits).all())
    assert gch.LAUNCHES == {"group_max_fwd": 1, "group_max_bwd": 0, "group_mean_fwd": 8, "group_mean_bwd": 0}
    assert knn_mod.LAUNCHES["knn"] == 9 and fps_mod.LAUNCHES["fps"] == 2


@pytest.mark.cuda
def test_curvenet_card_matches_cpu(curvenet_pair):
    """Logits and the C&W loss gradient on the card against the CPU, the
    CPU taking the card's choices and activation signs: logits within
    LOGP_ATOL, the taken choices within PICK_ATOL of the CPU's own, the
    gradient within GRAD_CLEAN relative L2 (parity-curvenet measured at
    most 1.3e-6 over 20 pairs on an H100, against up to 2e-3 without the
    signs replayed)."""
    card, cpu, x = curvenet_pair
    adv = x.cuda() + 0.01 * torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                                        device="cuda")
    target = torch.tensor([0, 1], device="cuda")
    res = chip_smoke.grad_parity(card, cpu, adv, x.cuda(), target)
    assert float(res["lp"].max()) <= chip_smoke.LOGP_ATOL
    assert float(res["pick"].max()) <= chip_smoke.PICK_ATOL
    assert float(res["grad"].max()) <= chip_smoke.GRAD_CLEAN, res["grad"]
