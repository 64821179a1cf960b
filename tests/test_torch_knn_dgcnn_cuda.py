"""The self-kNN and Chamfer row-min CUDA kernels against their plain
PyTorch versions, on the card (pointcloudattack_tpu_torch/csrc/knn.cu and
min_sqdist.cu), the one-layer gather max (gather_hoist.cu) at DGCNN's
EdgeConv shapes, and DGCNN and the KNN attack on the card.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_knn_dgcnn_cuda.py

Shapes and checks come from ``chip_smoke.py``: kNN indices bit for bit,
row mins and argmins bit for bit and ``dx`` bit for bit on rows with one
nearest point (``check_knn``, ``check_chamfer``); the one-layer gather max
under ``check_gather``'s rules.  DGCNN's log-probs on the card against the CPU,
the CPU taking the card's kNN indices and max-pool picks, within
``LOGP_ATOL``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.attacks.knn import KNNAttackConfig, build_knn_attack
from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
from pointcloudattack_tpu_torch.ops import chamfer
from pointcloudattack_tpu_torch.ops import gather_chain as gc
from pointcloudattack_tpu_torch.ops import gather_hoist as gh
from pointcloudattack_tpu_torch.ops import knn as knn_mod
from pointcloudattack_tpu_torch.utils.apply import make_model_fn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the path's shapes, their cases and the checks)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def features(seed, b, n, c, device):
    return torch.from_numpy(np.random.RandomState(seed).randn(b, n, c).astype(np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,k", [(16, 1024, 3, 20), (16, 1024, 64, 20), (16, 1024, 128, 20),
                                     (16, 1000, 64, 20), (2, 4096, 3, 16), (3, 37, 128, 37)])
def test_knn_kernel_matches_plain_on_card(cuda_device, b, n, c, k):
    """DGCNN's four stage widths, a ragged N, the largest N and k = N."""
    x = features(c, b, n, c, cuda_device)
    knn_mod.reset_launches()
    chip_smoke.check_knn("test", f"C={c}", x, k)
    assert knn_mod.LAUNCHES["knn"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 128])
def test_knn_kernel_breaks_ties_to_the_lower_index_on_card(cuda_device, c):
    x = features(7, 4, 256, c, cuda_device)
    dup = torch.cat([x] * 4, dim=1).contiguous()  # point i at i, i+256, i+512, i+768
    chip_smoke.check_knn("test", "ties", dup, 20)
    idx = knn_mod.knn(dup, 4)
    i = torch.arange(1024, device=cuda_device) % 256
    assert torch.equal(idx.long(), (i[:, None] + 256 * torch.arange(4, device=cuda_device)).expand(4, -1, -1))


@pytest.mark.cuda
def test_knn_kernel_rejects_what_it_does_not_take(cuda_device):
    for x, k in ((features(0, 1, 4097, 3, cuda_device), 4), (features(0, 1, 64, 129, cuda_device), 4),
                 (features(0, 1, 64, 3, cuda_device), 65)):
        with pytest.raises(ValueError, match="knn kernel takes"):
            knn_mod.knn(x, k)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m,dup", [(64, 1024, 1024, False), (4, 1000, 1000, True), (2, 3000, 2500, False),
                                       (3, 5, 1, False)])
def test_min_rows_kernel_matches_plain_on_card(cuda_device, b, n, m, dup):
    y = features(n, b, m // 4 if dup else m, 3, cuda_device)
    if dup:
        y = torch.cat([y] * 4, dim=1).contiguous()
    x = features(n + 1, b, n, 3, cuda_device)
    w = torch.rand((b, n), device=cuda_device)
    chamfer.reset_launches()
    chip_smoke.check_chamfer("test", f"{b}x{n}x{m}", x, y, w)
    assert chamfer.LAUNCHES["min_rows"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(chip_smoke.DGCNN_GATHER_SHAPES))
def test_gather_kernel_at_dgcnn_shapes_on_card(cuda_device, name):
    """K=20, G=N=1024, the center segment, one layer: the one-layer route's
    kernels, and no launch of the row kernel."""
    case = chip_smoke.gather_case(0, *chip_smoke.DGCNN_GATHER_SHAPES[name])
    gc.reset_launches()
    gh.reset_launches()
    chip_smoke.check_gather(name, *case)
    assert all(n == 0 for n in gc.LAUNCHES.values())
    assert gh.LAUNCHES == dict.fromkeys(gh.LAUNCHES, 1)


@pytest.mark.cuda
def test_dgcnn_forward_on_card_matches_cpu(cuda_device):
    model = models.make_model("DGCNN", 40, generator=torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    x = features(1, 2, 1024, 3, "cpu") * 0.5
    card_fn = make_model_fn(model, state, cuda_device)
    cpu_fn = make_model_fn(models.make_model("DGCNN", 40), state, "cpu")
    knn_mod.reset_launches()
    gh.reset_launches()
    with chip_smoke.replay({**chip_smoke.knn_hooks(), **chip_smoke.pick_hooks()}) as stats:
        card = card_fn(x.to(cuda_device))
        # each EdgeConv's product and max, and again where the pick hook reads the argmax
        assert knn_mod.LAUNCHES["knn"] == 4 and gh.LAUNCHES["product_fwd"] == 8 and gh.LAUNCHES["max_fwd"] == 8
        cpu = cpu_fn(x)
    diffs = [int(n.sum()) for n in stats["knn"]["other"]]  # index sets the CPU's own kNN would change
    assert len(diffs) == 4 and diffs[0] == 0  # the xyz stage: the same bits on both sides
    torch.testing.assert_close(card.cpu(), cpu, rtol=0.0, atol=chip_smoke.LOGP_ATOL)


@pytest.mark.cuda
def test_knn_attack_runs_on_the_kernels(cuda_device):
    model = models.make_model("PointNet", 40, generator=torch.Generator().manual_seed(0))
    fn = make_model_fn(model, None, cuda_device)
    x = features(2, 4, 1024, 3, cuda_device) * 0.5
    for r, chamfers in ((1, 3), (2, 0)):
        cm.reset_launches()
        chamfer.reset_launches()
        adv, succ = build_knn_attack(fn, KNNAttackConfig(num_iter=3, nn_refresh=r))(
            x, torch.zeros(4, dtype=torch.long, device=cuda_device),
            generator=torch.Generator(device=cuda_device).manual_seed(0))
        assert chamfer.LAUNCHES["min_rows"] == chamfers
        assert cm.LAUNCHES == {"fwd": 8, "bwd": 6}
        assert adv.shape == x.shape and bool(torch.isfinite(adv).all())
        assert float((adv - x).norm(dim=-1).max()) <= 0.18 * (1 + 1e-5)
