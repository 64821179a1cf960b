"""The grouped chain + max and chain + mean CUDA kernels against their
plain PyTorch versions, on the card (pointcloudattack_tpu_torch/csrc/
group_chain.cu), and CurveNet on the card against the CPU.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_curvenet_cuda.py

Checks come from ``chip_smoke.py``: ``check_group`` (y within Y_TOL, the
argmax equal but at near ties, card picks at most PICK_ATOL below the
plain max, dx within DX_TOL on the rows that carry a cotangent, rows with
an activated unit within EDGE of 0 left out, two backwards bit-equal, and
for the one-layer mean no backward mask that differs from the forward's
sign, ``mask_flips``); the max backward at an argmax made to order
(``check_max_bwd``: a hub, no row winning twice); CurveNet's logits on the
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
    (8, 1024, 1, (9, 32), 0.2),         # K = 1 over 1024 groups (kernel_rows' groups of one row)
    (2, 1000, 20, (9, 32), 0.2),        # the initial LPFA's widths, a tile ending inside a cloud
    (1, 1024, 20, (9, 32), 0.2),        # B = 1
])
def test_group_kernels_match_plain_on_card(cuda_device, pool, b, g, k, dims, slope):
    x, layers, dy = chip_smoke.group_case(k * 7 + len(dims), b, g, k, dims, cuda_device)
    gch.reset_launches()
    chip_smoke.check_group(f"B={b} G={g} K={k}", pool, x, layers, dy, slope)
    # the backward twice (bit-equal), and for a one-layer mean once more a unit (mask_flips) and once with
    # the other product back
    masks = dims[-1] + 1 if pool == "mean" and len(dims) == 2 else 0
    assert gch.LAUNCHES[f"group_{pool}_fwd"] == 1 and gch.LAUNCHES[f"group_{pool}_bwd"] == 2 + masks


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,k,dims", [
    *[(chip_smoke.CN_B, ng, chip_smoke.CN_K, (c0, *w))
      for ng, c0, w, pool in chip_smoke.CURVENET_GROUP_SHAPES.values() if pool == "mean"],  # the eight LPFAs
    (8, 1000, 20, (16, 16)),   # a ragged G
    (4, 333, 7, (16, 24)),     # K=7, C0 != C
    (2, 50, 64, (32, 32)),     # K=64
    (3, 77, 3, (64, 64)),      # K=3: a 64-row tile straddles 22 groups
    (1, 3, 20, (128, 128)),    # fewer rows than one tile (60 of 64)
])
def test_group_mean1_backward_on_card(cuda_device, b, g, k, dims):
    """The one-layer mean backward (group_mean1_bwd_kernel) under
    check_group's rules: dx within DX_TOL of the plain version, its masks
    the forward's signs (mask_flips 0), two backwards bit-equal; the
    profiler sees that kernel and not the chain backward."""
    x, layers, dy = chip_smoke.group_case(g + k + dims[-1], b, g, k, dims, cuda_device)
    gch.reset_launches()
    chip_smoke.check_group(f"B={b} G={g} K={k}", "mean", x, layers, dy)
    assert gch.LAUNCHES["group_mean_bwd"] >= 2
    g_ = (dy * layers[-1][3] / k).contiguous()
    names = chip_smoke.device_ms(lambda: gch.chain_groupmean_bwd(x, layers, g_, 0.2), reps=2)
    assert any("group_mean1_bwd_kernel" in n for n in names) and not any("group_bwd_kernel" in n for n in names)


@pytest.mark.cuda
def test_group_mean_backward_of_two_layers_keeps_the_chain_kernel(cuda_device):
    x, layers, dy = chip_smoke.group_case(12, 2, 256, 20, (32, 64, 32), cuda_device)
    g_ = (dy * layers[-1][3] / 20).contiguous()
    names = chip_smoke.device_ms(lambda: gch.chain_groupmean_bwd(x, layers, g_, 0.2), reps=2)
    assert any("group_bwd_kernel" in n for n in names) and not any("group_mean1_bwd_kernel" in n for n in names)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 32, 64, 128])
def test_group_mean1_masks_are_the_forwards_signs_near_zero(cuda_device, c):
    """Rows scaled to 1e-3 and the BatchNorm shift to 0 put many units
    within rounding of 0: the backward's masks still equal the forward's
    signs unit for unit, and two backwards are bit-equal, with either
    product back."""
    x, layers, dy = chip_smoke.group_case(c, 2, 64, 20, (c, c), cuda_device)
    x = (x * 1e-3).contiguous()
    (w, b, mean, mul, beta), = layers
    layers = [(w, b, b.clone(), mul, torch.zeros_like(beta))]
    z = chip_smoke.kernel_rows(x, layers, 0.2)
    assert float((z.abs() < 1e-6).float().mean()) > 0.0
    assert chip_smoke.mask_flips(x, layers, 0.2) == 0
    g_ = (dy * mul / 20).contiguous()
    for tc in (True, False):  # either product back
        assert torch.equal(gch._mean1_bwd_kernel(x, layers, g_, 0.2, tc), gch._mean1_bwd_kernel(x, layers, g_, 0.2, tc))


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(chip_smoke.MAX_BWD_EDGE_CASES)))
def test_group_max1_backward_on_card(cuda_device, case):
    """The one-layer max backward (group_max1_bwd_kernel) at an argmax made
    to order (a hub, no row winning twice): dx within DX_TOL of plain, two
    backwards bit-equal; each call launches that kernel, once, and not the
    chain backward."""
    name, b, g, k, dims, kind = chip_smoke.MAX_BWD_EDGE_CASES[case]
    x, layers, am, g_ = chip_smoke.max_bwd_case(200 + case, b, g, k, dims, kind, cuda_device)
    gch.reset_launches()
    chip_smoke.check_max_bwd(name, x, layers, am, g_)
    assert gch.LAUNCHES["group_max_bwd"] == 2
    names = chip_smoke.device_ms(lambda: gch.chain_groupmax_bwd(x, layers, am, g_, 0.2), reps=2)
    assert any("group_max1_bwd_kernel" in n for n in names) and not any("group_bwd_kernel" in n for n in names)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["max", "mean"])
def test_group_forward_routes_by_layers(cuda_device, pool):
    """One layer runs the one-layer forward (group_fwd1_kernel), two the
    chain kernel (group_fwd_kernel); either is one launch a call."""
    fwd = gch.chain_groupmax_fwd if pool == "max" else gch.chain_groupmean_fwd
    for dims, want, other in (((9, 32), "group_fwd1_kernel", "group_fwd_kernel<"),
                              ((9, 32, 32), "group_fwd_kernel<", "group_fwd1_kernel")):
        x, layers, _ = chip_smoke.group_case(13, 2, 256, 20, dims, cuda_device)
        gch.reset_launches()
        names = chip_smoke.device_ms(lambda: fwd(x, layers, 0.2), reps=2)
        assert any(want in n for n in names) and not any(other in n for n in names), names
        assert gch.LAUNCHES[f"group_{pool}_fwd"] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["max", "mean"])
def test_one_layer_past_shared_memory_takes_the_chain_kernels(cuda_device, pool):
    """256 -> 256 at K = 20: W alone passes the shared memory of a block of
    each one-layer kernel, so the forward and the backward of either pool
    run the chain kernels, held to check_group's rules like any other
    shape; one launch a call."""
    from pointcloudattack_tpu_torch.ops import _build

    b, g, k, dims = 1, 40, 20, (256, 256)
    lib = _build.load_library()
    for smem in (lib.pca_group_fwd1_smem, lib.pca_group_mean1_smem, lib.pca_group_max1_smem):
        assert not gch.one_layer_kernel(lib, smem, k, dims)
    x, layers, dy = chip_smoke.group_case(14, b, g, k, dims, cuda_device)
    gch.reset_launches()
    chip_smoke.check_group(f"B={b} G={g} K={k}", pool, x, layers, dy)
    assert gch.LAUNCHES[f"group_{pool}_fwd"] == 1 and gch.LAUNCHES[f"group_{pool}_bwd"] == 2
    if pool == "max":
        y, am = gch.chain_groupmax_fwd(x, layers, 0.2)
        g_ = (dy * layers[-1][3]).contiguous()
        fwd, bwd = lambda: gch.chain_groupmax_fwd(x, layers, 0.2), lambda: gch.chain_groupmax_bwd(x, layers, am, g_, 0.2)
    else:
        g_ = (dy * layers[-1][3] / k).contiguous()
        fwd, bwd = lambda: gch.chain_groupmean_fwd(x, layers, 0.2), lambda: gch.chain_groupmean_bwd(x, layers, g_, 0.2)
    for fn, want in ((fwd, "group_fwd_kernel<"), (bwd, "group_bwd_kernel<")):
        names = chip_smoke.device_ms(fn, reps=2)
        assert any(want in n for n in names), names
        assert not any(one in n for n in names for one in ("fwd1_kernel", "mean1_bwd_kernel", "max1_bwd_kernel")), names


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
