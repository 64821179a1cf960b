"""GeoA3's CUDA kernels against their plain PyTorch versions, on the card
(pointcloudattack_tpu_torch/csrc/kappa.cu and min_sqdist_both.cu), and GeoA3
on the card.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_geoa3_cuda.py

The checks come from ``chip_smoke.py``: the curvature's picks and kappa
bit-equal to the plain version's (also at the selection's edges: k = 1,
63 and 64, N = 4096, copies, a hub) and its gradients within
``KAPPA_GRAD_ATOL``, two
backwards bit-equal (``check_kappa``, and ``check_kappa_idx`` on a given
neighbour set; ``check_kappa_bwd``, the backward alone, against the plain
version that sums in the kernel's order, also on indices outside the
cloud); the
two-direction bundle's mins, argmins and gradients bit for bit, two
backwards bit-equal (``check_both``, also at ``BOTH_EDGE_CASES``: a hub, one
x point against 4096), each against the plain version on the CPU.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.attacks.geoa3 import GeoA3Config, build_geoa3_attack
from pointcloudattack_tpu_torch.attacks.geoa3_partial import GeoA3PartialConfig, build_geoa3_partial_attack
from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
from pointcloudattack_tpu_torch.ops import fps as fps_mod
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
    # the backward twice: the two must be bit-equal
    assert kappa.LAUNCHES == {"kappa_fwd": 1, "kappa_bwd": 2, "kappa_idx_fwd": 0, "kappa_idx_bwd": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,copies,hub", [
    (2, 1000, 1, 1, 0), (2, 1000, 16, 1, 0), (2, 1000, 63, 1, 0), (2, 1000, 64, 1, 0), (8, 1024, 16, 1, 0),
    (2, 4096, 16, 1, 0), (2, 4096, 63, 4, 0), (2, 4096, 16, 4, 0), (2, 1000, 16, 4, 0), (2, 1024, 16, 1, 300),
    (2, 1024, 1, 1, 300)])
def test_kappa_forward_bit_equal_on_card(cuda_device, b, n, k, copies, hub):
    """Row 8a's forward (select_common.cuh's selection): picks and kappa
    bit-equal to kappa_plain on the CPU at k = 1, 16, 63 (the last k the
    bound serves) and 64 (k + 1 = 65: the passes), N = 1000 and 4096, every
    point 4 times (ties at distance 0), and a hub of 300 copies of one point
    (more pairs under the bound than the gather holds)."""
    rng = np.random.RandomState(n + k + copies)
    pts = np.concatenate([rng.randn(b, n // copies, 3) * 0.5] * copies, axis=1)
    pts[:, :hub] = pts[:, :1]
    nrm = rng.randn(b, n, 3)
    a = torch.from_numpy(pts.astype(np.float32)).cuda()
    nrm = unit(torch.from_numpy(nrm.astype(np.float32)).cuda())
    kappa.reset_launches()
    kap, picks = kappa.kappa_fwd(a, nrm, k)
    torch.cuda.synchronize()
    assert kappa.LAUNCHES["kappa_fwd"] == 1
    kap_p, picks_p = kappa.kappa_plain(a.cpu(), nrm.cpu(), k)
    assert torch.equal(picks.cpu(), picks_p), int((picks.cpu() != picks_p).sum())
    assert torch.equal(kap.cpu(), kap_p), float((kap.cpu() - kap_p).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,case", [(8, 1024, 16, "stale"), (8, 1024, 16, "collide"), (2, 1000, 16, "stale"),
                                        (3, 17, 16, "stale"), (2, 4096, 8, "stale"), (1, 130, 64, "stale"),
                                        (2, 256, 5, "repeat")])
def test_kappa_from_idx_kernels_match_plain_on_card(cuda_device, b, n, k, case, monkeypatch):
    """GeoA3's shape on a stale set (the clean cloud's, on an iterate 1e-2
    away) and with exact collisions, a ragged N, k + 1 = N, the largest N and
    k, and an index repeated in a row (it adds once per slot)."""
    monkeypatch.setattr(chip_smoke, "GEO_K", k)
    data = rand(n, b, n, 3, scale=0.5)
    moved = (data + rand(n + 3, b, n, 3, scale=1e-2)).contiguous()
    idx, hit, _ = chip_smoke.stale_idx(moved, data)
    if case == "repeat":
        idx[:, :, 1] = idx[:, :, 0]
    nrm = unit(rand(n + 1, b, n, 3))
    kappa.reset_launches()
    chip_smoke.check_kappa_idx("test", f"{b}x{n} k={k} {case}", hit if case == "collide" else moved, nrm,
                               idx.contiguous(), rand(n + 2, b, n))
    assert kappa.LAUNCHES == {"kappa_fwd": 0, "kappa_bwd": 0, "kappa_idx_fwd": 1, "kappa_idx_bwd": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,case", [(8, 1024, 16, "hub"), (2, 1000, 16, "hub"), (8, 1024, 16, "outside"),
                                        (2, 256, 5, "outside"), (4, 512, 16, "duplicates"), (1, 130, 64, "hub")])
def test_kappa_backward_on_card_matches_list_order(cuda_device, b, n, k, case):
    """The backward alone against the list-ordered plain version on the
    CPU (``check_kappa_bwd``): a hub point that every row picks (its list
    N + edges long), indices outside the cloud beside exact collisions, and
    the selecting forward's picks on a cloud whose points each appear twice;
    two backwards bit-equal."""
    data = rand(n, b, n // 2 if case == "duplicates" else n, 3, scale=0.5)
    if case == "duplicates":
        data = torch.cat([data] * 2, dim=1).contiguous()
    moved = (data + rand(n + 3, b, n, 3, scale=1e-2)).contiguous()
    nrm = unit(rand(n + 1, b, n, 3))
    idx, hit, _ = chip_smoke.stale_idx(moved, data)
    idx = idx[..., :k].contiguous() if idx.shape[-1] >= k else knn_mod.knn(data, k + 1)[..., 1:].contiguous()
    a = moved
    if case == "hub":
        idx[:, :, min(4, k - 1)] = 7
    elif case == "outside":
        a = hit
        idx[0, ::5, 1], idx[-1, ::7, k - 1] = -1, n + 5
    else:
        a = data
        idx = kappa.kappa_fwd(data, nrm, k)[1]
    kappa.reset_launches()
    chip_smoke.check_kappa_bwd("test", f"{b}x{n} k={k} {case}", a, nrm, idx.contiguous(), rand(n + 2, b, n))
    assert kappa.LAUNCHES == {"kappa_fwd": 0, "kappa_bwd": 0, "kappa_idx_fwd": 0, "kappa_idx_bwd": 2}


@pytest.mark.cuda
def test_kappa_from_idx_autograd_on_card_matches_cpu(cuda_device):
    a = rand(0, 2, 300, 3, scale=0.5)
    nrm = unit(rand(1, 2, 300, 3))
    w = rand(2, 2, 300)
    idx = knn_mod.knn(a, 17)[..., 1:]  # not contiguous: the function makes it so
    grads = []
    for dev in ("cuda", "cpu"):
        ta = a.to(dev).clone().requires_grad_(True)
        tn = nrm.to(dev).clone().requires_grad_(True)
        (kappa.kappa_knn_mean_from_idx(ta, tn, idx.to(dev), 16) * w.to(dev)).sum().backward()
        grads.append((ta.grad.cpu(), tn.grad.cpu()))
    for g, c in zip(*grads):
        torch.testing.assert_close(g, c, rtol=0.0, atol=chip_smoke.KAPPA_GRAD_ATOL)


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
        with pytest.raises(ValueError, match="kappa kernel takes"):
            kappa.kappa_idx_fwd(a, unit(rand(1, 1, n, 3)), torch.zeros(1, n, k, dtype=torch.int32, device="cuda"), k)
    a, nrm = rand(0, 1, 64, 3), unit(rand(1, 1, 64, 3))
    for idx in (torch.zeros(1, 64, 8, dtype=torch.int64, device="cuda"), torch.zeros(1, 64, 8, dtype=torch.int32),
                torch.zeros(1, 64, 16, dtype=torch.int32, device="cuda")[..., ::2]):
        with pytest.raises(ValueError, match="from_idx kernel takes"):
            kappa.kappa_idx_fwd(a, nrm, idx, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m,kind", [(8, 1024, 1024, "random"), (4, 1000, 1000, "dup"), (2, 3000, 2500, "random"),
                                        (3, 5, 1, "random"), (2, 1, 700, "random"),
                                        *chip_smoke.BOTH_EDGE_CASES.values()])
def test_both_kernels_match_plain_on_card(cuda_device, b, n, m, kind):
    """Mins, argmins, dx and dy bit-equal to the plain version, and two
    backwards bit-equal; every y point 4 times (dup), a hub."""
    if kind == "hub":
        x, y = chip_smoke.both_case(n, b, n, m, kind, cuda_device)
    else:
        y = rand(m, b, m // 4 if kind == "dup" else m, 3, scale=0.5)
        if kind == "dup":
            y = torch.cat([y] * 4, dim=1).contiguous()
        x = rand(n + 1, b, n, 3, scale=0.5)
    chamfer.reset_launches()
    chip_smoke.check_both("test", f"{b}x{n}x{m} {kind}", x, y, rand(n + 2, b, n), rand(m + 3, b, m))
    assert chamfer.LAUNCHES == {"min_rows": 0, "both_fwd": 1, "both_bwd": 2}


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
    assert kappa.LAUNCHES == {"kappa_fwd": 1 + steps, "kappa_bwd": steps, "kappa_idx_fwd": 0, "kappa_idx_bwd": 0}
    assert chamfer.LAUNCHES == {"min_rows": 0, "both_fwd": steps, "both_bwd": steps}
    assert cm.LAUNCHES == {"fwd": 2 * (steps + rounds + 1), "bwd": 2 * steps, "bwd_lists": 2 * steps,
                           "bwd_rows": 2 * steps}
    assert adv.shape == x.shape and bool(torch.isfinite(adv).all()) and loss.shape == (4,)


@pytest.mark.cuda
@pytest.mark.parametrize("partial", [False, True], ids=["full-r2-jitter", "partial-r2-subsample"])
def test_geoa3_refresh_jitter_and_partial_run_on_the_kernels(cuda_device, partial):
    model = models.make_model("PointNet", 40, generator=torch.Generator().manual_seed(0))
    fn = make_model_fn(model, None, cuda_device)
    x = rand(3, 4, 1024, 3, scale=0.5)
    rounds, iters = 2, 5
    kw = dict(binary_max_steps=rounds, iter_max_steps=iters, curv_knn_refresh=2)
    if partial:
        attack = build_geoa3_partial_attack(fn, GeoA3PartialConfig(refresh_iters=3, subsample_npoint=512, **kw))
    else:
        attack = build_geoa3_attack(fn, GeoA3Config(use_jitter=True, jitter_refresh_iters=3, **kw))
    for mod in (cm, chamfer, kappa, knn_mod, fps_mod):
        mod.reset_launches()
    adv, loss, succ = attack(x, torch.zeros(4, dtype=torch.long, device=cuda_device),
                             generator=torch.Generator(device=cuda_device).manual_seed(0))
    steps = rounds * iters
    # the normals, a cached set at iterations 0, 2 and 4 of each round, and (full mode) the jitter's
    # covariance at iterations 0 and 3
    assert knn_mod.LAUNCHES["knn"] == 1 + rounds * 3 + (0 if partial else rounds * 2)
    assert kappa.LAUNCHES == {"kappa_fwd": 1, "kappa_bwd": 0, "kappa_idx_fwd": steps, "kappa_idx_bwd": steps}
    assert chamfer.LAUNCHES == {"min_rows": 0, "both_fwd": steps, "both_bwd": steps}
    # the loss forward and the evaluation's (of the bare cloud, or of the subsample) each iteration
    assert cm.LAUNCHES == {"fwd": 2 * (2 * steps + rounds + 1), "bwd": 2 * steps, "bwd_lists": 2 * steps,
                           "bwd_rows": 2 * steps}
    assert fps_mod.LAUNCHES["fps"] == (steps if partial else 0)
    assert adv.shape == x.shape and bool(torch.isfinite(adv).all()) and loss.shape == (4,)
