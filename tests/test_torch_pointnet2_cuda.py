"""The FPS and gather + chain + max CUDA kernels against their plain
PyTorch versions, on the card (pointcloudattack_tpu_torch/csrc/fps.cu and
gather_chain.cu), and the PointNet++ SSG forward on the card against the
CPU.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pointnet2_cuda.py

Tolerances: FPS indices bit for bit (both round every product and sum on
its own), at the path's shapes and chip_smoke.py's ``FPS_EDGE_CASES``.  Gather forward y atol 1e-4 / rtol 1e-5, and the argmax equal
except where a column's two best rows lie within 1e-4; dsrc and dctr atol
1e-4 / rtol 1e-4 (f32 sums of up to 323 terms in another order, and dsrc's
atomic adds in a varying order), except the points and groups of a winning
row with a hidden unit within 1e-5 of 0 (chip_smoke.py's ``check_gather``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.ops import ball_hoist as bh
from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
from pointcloudattack_tpu_torch.ops import fps as fps_mod
from pointcloudattack_tpu_torch.ops import gather_chain as gc
from pointcloudattack_tpu_torch.utils.apply import make_model_fn
from test_torch_chain_maxpool_cuda import make_layers, to_torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the path's gather shapes, their cases and the check)

Y_TOL = dict(rtol=1e-5, atol=1e-4)
D_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def check_gather(name, *case):
    """chip_smoke.py's check of the kernel against plain, with one launch
    each way."""
    gc.reset_launches()
    chip_smoke.check_gather(name, *case)
    assert gc.LAUNCHES == {**dict.fromkeys(gc.LAUNCHES, 0), "fwd": 1, "bwd": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(chip_smoke.GATHER_SHAPES))
def test_gather_kernel_matches_plain_on_card(cuda_device, name):
    """Every gather call of PointNet++ SSG and MSG at B=16."""
    check_gather(name, *chip_smoke.gather_case(0, *chip_smoke.GATHER_SHAPES[name]))


@pytest.mark.cuda
@pytest.mark.parametrize("k,g", [(20, 37), (6, 50), (96, 9)])
def test_gather_kernel_takes_ragged_groups_and_center_segments_on_card(cuda_device, k, g):
    """K that is no power of two, G that no tile divides, a K between two
    tiles, and a DGCNN-style layout whose centers are source rows."""
    rng = np.random.RandomState(k)
    b, n, c = 2, 300, 8
    src = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(cuda_device)
    centers = src[:, :g].contiguous()
    idx = torch.from_numpy(rng.randint(0, n, size=(b, g, k)).astype(np.int32)).to(cuda_device)
    layout = (("diff", 0, c, 0), ("center", 0, c))
    layers = to_torch(make_layers(rng, (2 * c, 32, 64)), cuda_device)
    dy = torch.from_numpy(rng.randn(b, g, 64).astype(np.float32)).to(cuda_device)
    check_gather(f"k{k}_g{g}", src, centers, idx, layers, layout, dy)


# the path's shapes and a ragged one, (B, N, npoint, kind), then chip_smoke.py's edge cases
FPS_CASES = {"N=1024 -> 512": (16, 1024, 512, "random"), "N=512 -> 128": (16, 512, 128, "random"),
             "N=1000 -> 77": (16, 1000, 77, "random"), **chip_smoke.FPS_EDGE_CASES}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FPS_CASES))
def test_fps_kernel_matches_plain_bitwise_on_card(cuda_device, name):
    """Picks bit-equal from index 0 and from a given start; on a random
    cloud also with every point 4 times, where each pick ties with its
    copies and the first n/4 picks are the originals."""
    b, n, npoint, kind = FPS_CASES[name]
    xyz, start = chip_smoke.fps_case(n, b, n, kind, cuda_device)
    if start is None:
        start = torch.from_numpy(np.random.RandomState(n + 1).randint(0, n, size=b).astype(np.int32)).to(cuda_device)
    for s in (None, start):
        fps_mod.reset_launches()
        chip_smoke.check_fps("test", name, xyz, npoint, s)
        assert fps_mod.LAUNCHES["fps"] == 1
    if kind == "random" and n >= 8:
        q = n // 4
        dup = torch.cat([xyz[:, :q]] * 4, dim=1).contiguous()
        chip_smoke.check_fps("test", f"{name}, every point 4 times", dup, min(npoint, 4 * q))
        assert int(fps_mod.farthest_point_sample(dup, q).max()) < q


@pytest.mark.cuda
@pytest.mark.parametrize("c0,n", [(259, 128), (643, 128)])
def test_chain_kernel_takes_the_group_all_widths_on_card(cuda_device, c0, n):
    """The group-all set abstraction's chain: SSG 259 and MSG 643 inputs."""
    from test_torch_chain_maxpool_cuda import inputs

    x, layers, dy = inputs(3, 16, n, (c0, 256, 512, 1024))
    xg, lg = torch.from_numpy(x).to(cuda_device), to_torch(layers, cuda_device)
    y, idx = cm.chain_maxpool_fwd(xg, lg)
    y_ref, idx_ref = cm.chain_maxpool_plain(xg, lg)
    torch.testing.assert_close(y, y_ref, **Y_TOL)
    g = (torch.from_numpy(dy).to(cuda_device) * lg[-1][3]).contiguous()
    torch.testing.assert_close(cm.chain_maxpool_bwd(xg, lg, idx_ref, g),
                               cm.chain_maxpool_bwd_plain(xg, lg, idx_ref, g), **D_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["PointNet++Ssg", "PointNet++Msg"])
def test_forward_on_card_matches_cpu(cuda_device, name):
    model = models.make_model(name, 40, generator=torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.from_numpy((np.random.RandomState(1).randn(2, 1024, 3) * 0.5).astype(np.float32))
    cpu = make_model_fn(models.make_model(name, 40), state, "cpu")(x)
    for m in (fps_mod, gc, cm, bh):
        m.reset_launches()
    card = make_model_fn(model, state, cuda_device)(x.to(cuda_device))
    assert fps_mod.LAUNCHES["fps"] == 2 and cm.LAUNCHES["fwd"] == 1
    sas = 2 if name == "PointNet++Ssg" else 6
    assert bh.LAUNCHES == {**dict.fromkeys(bh.LAUNCHES, 0), "slots_fwd": sas, "product_fwd": sas, "stack_fwd": sas}
    assert gc.LAUNCHES["fwd"] == 0
    torch.testing.assert_close(card.cpu(), cpu, rtol=1e-5, atol=1e-4)
