"""The multi-layer group max kernels of pointcloudattack_tpu_torch/csrc/
group_chain.cu (the forward ``group_mfwd_kernel``; the backward's lists,
``group_mlists_kernel`` and ``group_mscan_kernel``, and rows,
``group_mrows_kernel``) against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_group_chain_cuda.py

Checks come from ``chip_smoke.py``: ``check_group`` (y within Y_TOL, the
argmax equal but at near ties, card picks at most PICK_ATOL below the
plain max, dx within DX_TOL on the winning rows, rows with a hidden unit
within EDGE of 0 left out, two backwards bit-equal) and
``check_mmax_stages`` (the lists bit-equal to their plain version, 0
hidden units whose backward mask differs from the forward's sign).
"""

import sys
from pathlib import Path

import pytest
import torch

from pointcloudattack_tpu_torch.ops import _build
from pointcloudattack_tpu_torch.ops import group_chain as gch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the checks and the cases)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


CASES = {  # name: (B, G, K, dims, slope, kind)
    "all rows equal": (2, 16, 32, (3, 32, 32, 64), 0.0, "equal"),  # every column ties: k = 0 wins
    "K=1": (2, 300, 1, (9, 32, 64), 0.2, None),
    "K=64": (1, 20, 64, (35, 64, 48, 96), 0.2, None),
    "ragged G": (3, 37, 32, (67, 64, 64, 128), 0.0, None),
    "slope 0.2": (2, 64, 32, (131, 128, 128, 256), 0.2, None),
    "a row wins every column": (2, 8, 16, (6, 16, 24), 0.0, "hub"),
    "sa3 widths": (2, 16, 32, (259, 256, 256, 512), 0.0, None),
    "one layer past the one-layer kernels": (1, 40, 32, (256, 256), 0.2, None),
}
HUB = 5


def mmax_case(name, device):
    b, g, k, dims, slope, kind = CASES[name]
    x, layers, dy = chip_smoke.group_case(k * 11 + len(dims), b, g, k, dims, device)
    if kind == "equal":
        x = x[:, :, :1].expand(x.shape).contiguous()
    if kind == "hub":  # W's first row and every later W positive, row HUB's first channel large
        x[..., 0] = -100.0
        x[:, :, HUB, 0] = 100.0
        (w, *rest), *more = layers
        w = w.clone()
        w[0] = w[0].abs() + 0.1
        layers = [(w, *rest)] + [(lw.abs(), *lr) for lw, *lr in more]
        layers = [(lw, lb, lm, lmu.abs(), lbe) for lw, lb, lm, lmu, lbe in layers]
    return x, layers, dy, slope


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_multilayer_max_matches_plain_on_card(cuda_device, name):
    """check_group's rules and check_mmax_stages' (where a hidden layer
    exists), one launch a call, and the profiler sees the multi-layer max
    kernels and not the chain kernels."""
    x, layers, dy, slope = mmax_case(name, cuda_device)
    k = x.shape[2]
    dims = [x.shape[-1]] + [layer[0].shape[1] for layer in layers]
    lib = _build.load_library()
    assert [gch.max_route(lib, k, dims, bwd) for bwd in (False, True)] == ["tc", "tc"]
    gch.reset_launches()
    _, am, g, _ = chip_smoke.check_group(name, "max", x, layers, dy, slope, tag="kernels-punet")
    assert gch.LAUNCHES["group_max_fwd"] == 1 and gch.LAUNCHES["group_max_bwd"] == 2
    _, am_card = gch.chain_groupmax_fwd(x, layers, slope)
    if CASES[name][5] == "equal":
        assert not bool(am_card.any())
    if CASES[name][5] == "hub":
        assert bool((am_card == HUB).all())
        dx = gch.chain_groupmax_bwd(x, layers, am_card, g, slope)
        assert not bool(torch.cat([dx[:, :, :HUB], dx[:, :, HUB + 1:]], 2).any())
    if len(layers) > 1:
        chip_smoke.check_mmax_stages("kernels-punet", name, x, layers, am_card, slope)
    fwd = chip_smoke.device_ms(lambda: gch.chain_groupmax_fwd(x, layers, slope), reps=2)
    bwd = chip_smoke.device_ms(lambda: gch.chain_groupmax_bwd(x, layers, am_card, g, slope), reps=2)
    assert any("group_mfwd_kernel" in n for n in fwd) and not any("group_fwd_kernel<" in n for n in fwd), fwd
    for want in ("group_mlists_kernel", "group_mscan_kernel", "group_mrows_kernel"):
        assert any(want in n for n in bwd), bwd
    assert not any("group_bwd_kernel<" in n for n in bwd), bwd


ONE_STEP = {  # name: (B, G, K, dims, slope): C_L <= 32, so the one-hot product back takes one ring step
    "FMA first layer, C_L 24": (2, 8, 16, (6, 16, 24), 0.0),
    "C_L 32": (2, 40, 32, (35, 64, 32), 0.2),
    "three layers, C_L 8": (1, 64, 8, (9, 32, 16, 8), 0.0),
    "ragged, C_L 16": (3, 37, 32, (67, 64, 64, 16), 0.0),
}
REPEATS = 50


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ONE_STEP))
def test_one_step_cotangent_reads_landed_masks(cuda_device, name):
    """Where the one-hot product back takes one ring step, the mask words of
    the last hidden layer, written at that step, must land before its
    epilogue reads them: check_group's rules once, 0 mask flips against the
    forward's signs, then REPEATS forward + backward pairs, each backward
    bit-equal to the first (a stale word would change dx)."""
    b, g_, k, dims, slope = ONE_STEP[name]
    x, layers, dy = chip_smoke.group_case(k * 13 + len(dims), b, g_, k, dims, cuda_device)
    lib = _build.load_library()
    assert [gch.max_route(lib, k, list(dims), bwd) for bwd in (False, True)] == ["tc", "tc"]
    _, am, g, _ = chip_smoke.check_group(name, "max", x, layers, dy, slope, tag="kernels-punet")
    chip_smoke.check_mmax_stages("kernels-punet", name, x, layers, am, slope)
    dx = gch.chain_groupmax_bwd(x, layers, am, g, slope)
    for i in range(REPEATS):
        gch.chain_groupmax_fwd(x, layers, slope)
        again = gch.chain_groupmax_bwd(x, layers, am, g, slope)
        assert torch.equal(again, dx), f"backward {i + 1} differs in {int((again != dx).sum())} entries"
        if i % 10 == 0:
            assert chip_smoke.mmax_mask_flips(x, layers, am, slope)[0] == 0


@pytest.mark.cuda
def test_multilayer_max_stages_match_plain(cuda_device):
    """The backward's two stages on the card against their plain versions:
    the lists bit for bit, the rows within DX_TOL, each twice bit-equal."""
    x, layers, dy, slope = mmax_case("ragged G", cuda_device)
    dims = [x.shape[-1]] + [layer[0].shape[1] for layer in layers]
    lib = _build.load_library()
    _, am = gch.chain_groupmax_plain(x, layers, slope)
    g = (dy * layers[-1][3]).contiguous()
    lists = gch._mmax_lists(am, x.shape[2], lib)
    plain = gch.group_winner_lists_plain(am, x.shape[2])
    assert all(torch.equal(a, b) for a, b in zip(lists, plain))
    dx = gch._mmax_rows(x, layers, am, lists, g, slope, dims, lib)
    assert torch.equal(dx, gch._mmax_rows(x, layers, am, lists, g, slope, dims, lib))
    torch.testing.assert_close(dx, gch.group_winners_bwd_plain(x, layers, am, plain, g, slope), **chip_smoke.DX_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("k,dims,route", [(20, (12, 40, 24, 8), "chain"), (24, (32, 64, 32), "chain"),
                                          (32, (9, 32), "one"), (16, (32, 64, 32), "tc")])
def test_max_route_follows_the_shapes(cuda_device, k, dims, route):
    """A K that is no power of two keeps the chain kernels; one layer that
    fits takes the one-layer kernels; any other max chain the multi-layer
    max kernels."""
    lib = _build.load_library()
    assert gch.max_route(lib, k, dims, False) == route and gch.max_route(lib, k, dims, True) == route


@pytest.mark.cuda
def test_autograd_through_the_multilayer_max(cuda_device):
    """mlp_chain_groupmax on a PU-Net-like chain: one forward and one
    backward launch, dx as the plain op's autograd gives it."""
    x, layers, dy, slope = mmax_case("ragged G", cuda_device)
    xr = x.clone().requires_grad_(True)
    gch.reset_launches()
    (dx,) = torch.autograd.grad(gch.mlp_chain_groupmax(xr, layers, slope), xr, dy)
    assert gch.LAUNCHES == {"group_max_fwd": 1, "group_max_bwd": 1, "group_mean_fwd": 0, "group_mean_bwd": 0}
    xc = x.detach().cpu().requires_grad_(True)
    lc = [tuple(t.cpu() for t in layer) for layer in layers]
    (want,) = torch.autograd.grad(gch.mlp_chain_groupmax(xc, lc, slope), xc, dy.cpu())
    torch.testing.assert_close(dx.cpu(), want, **chip_smoke.DX_TOL)
