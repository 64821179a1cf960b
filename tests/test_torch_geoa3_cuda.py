"""GeoA3's CUDA kernels against their plain PyTorch versions, on the card
(pointcloudattack_tpu_torch/csrc/kappa.cu and min_sqdist_both.cu), and GeoA3
on the card.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_geoa3_cuda.py

The checks come from ``chip_smoke.py``: the curvature's picks equal, kappa
within ``KAPPA_RTOL`` and its gradients within ``KAPPA_GRAD_ATOL``
(``check_kappa``); the two-direction bundle's mins and argmins bit for bit
and its gradients within ``BOTH_GRAD_ATOL`` (``check_both``), each against
the plain version on the CPU.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.attacks.geoa3 import GeoA3Config, build_geoa3_attack
from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
from pointcloudattack_tpu_torch.ops import chamfer, kappa
from pointcloudattack_tpu_torch.ops import knn as knn_mod
from pointcloudattack_tpu_torch.utils.apply import make_model_fn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the checks)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def rand(seed, *shape, scale=1.0, device="cuda"):
    return torch.from_numpy((np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)).to(device)


def unit(t):
    return (t / t.norm(dim=-1, keepdim=True)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,copies", [(8, 1024, 16, 1), (2, 1000, 16, 1), (3, 17, 16, 1), (2, 4096, 8, 1),
                                          (4, 512, 16, 2), (2, 256, 5, 4), (1, 130, 64, 1)])
def test_kappa_kernels_match_plain_on_card(cuda_device, b, n, k, copies, monkeypatch):
    """GeoA3's shape, a ragged N, k + 1 = N, the largest N, exact duplicates
    (every point 2 or 4 times: ties at distance 0) and the largest k."""
    monkeypatch.setattr(chip_smoke, "GEO_K", k)
    a = rand(n, b, n // copies, 3, scale=0.5)
    a = torch.cat([a] * copies, dim=1).contiguous()
    nrm = unit(rand(n + 1, b, n, 3))
    kappa.reset_launches()
    chip_smoke.check_kappa("test", f"{b}x{n} k={k} x{copies}", a, nrm, rand(n + 2, b, n))
    assert kappa.LAUNCHES == {"kappa_fwd": 1, "kappa_bwd": 1}


@pytest.mark.cuda
def test_kappa_autograd_on_card_matches_cpu(cuda_device):
    a = rand(0, 2, 300, 3, scale=0.5)
    nrm = unit(rand(1, 2, 300, 3))
    w = rand(2, 2, 300)
    grads = []
    for dev in ("cuda", "cpu"):
        ta = a.to(dev).clone().requires_grad_(True)
        tn = nrm.to(dev).clone().requires_grad_(True)
        (kappa.kappa_knn_mean(ta, tn, 16) * w.to(dev)).sum().backward()
        grads.append((ta.grad.cpu(), tn.grad.cpu()))
    for g, c in zip(*grads):
        torch.testing.assert_close(g, c, rtol=0.0, atol=chip_smoke.KAPPA_GRAD_ATOL)


@pytest.mark.cuda
def test_kappa_kernel_rejects_what_it_does_not_take(cuda_device):
    for n, k in ((4097, 16), (16, 16), (200, 65)):
        a = rand(0, 1, n, 3)
        with pytest.raises(ValueError, match="kappa kernel takes"):
            kappa.kappa_fwd(a, unit(rand(1, 1, n, 3)), k)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m,dup", [(8, 1024, 1024, False), (4, 1000, 1000, True), (2, 3000, 2500, False),
                                       (3, 5, 1, False), (2, 1, 700, False)])
def test_both_kernels_match_plain_on_card(cuda_device, b, n, m, dup):
    y = rand(m, b, m // 4 if dup else m, 3, scale=0.5)
    if dup:
        y = torch.cat([y] * 4, dim=1).contiguous()
    x = rand(n + 1, b, n, 3, scale=0.5)
    chamfer.reset_launches()
    chip_smoke.check_both("test", f"{b}x{n}x{m}", x, y, rand(n + 2, b, n), rand(m + 3, b, m))
    assert chamfer.LAUNCHES == {"min_rows": 0, "both_fwd": 1, "both_bwd": 1}


@pytest.mark.cuda
def test_geoa3_runs_on_the_kernels(cuda_device):
    model = models.make_model("PointNet", 40, generator=torch.Generator().manual_seed(0))
    fn = make_model_fn(model, None, cuda_device)
    x = rand(3, 4, 1024, 3, scale=0.5)
    rounds, iters = 2, 3
    for mod in (cm, chamfer, kappa, knn_mod):
        mod.reset_launches()
    adv, loss, succ = build_geoa3_attack(fn, GeoA3Config(binary_max_steps=rounds, iter_max_steps=iters))(
        x, torch.zeros(4, dtype=torch.long, device=cuda_device),
        generator=torch.Generator(device=cuda_device).manual_seed(0))
    steps = rounds * iters
    assert knn_mod.LAUNCHES["knn"] == 1
    assert kappa.LAUNCHES == {"kappa_fwd": 1 + steps, "kappa_bwd": steps}
    assert chamfer.LAUNCHES == {"min_rows": 0, "both_fwd": steps, "both_bwd": steps}
    assert cm.LAUNCHES == {"fwd": 2 * (steps + rounds + 1), "bwd": 2 * steps}
    assert adv.shape == x.shape and bool(torch.isfinite(adv).all()) and loss.shape == (4,)
