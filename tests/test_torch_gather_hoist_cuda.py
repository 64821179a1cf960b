"""The one-layer gather max route against its plain PyTorch versions, on the
card (pointcloudattack_tpu_torch/csrc/gather_hoist.cu, through
ops/gather_hoist.py): DGCNN's EdgeConvs and CurveNet's initial LPFA.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gather_hoist_cuda.py

Checks come from ``chip_smoke.py``: ``check_gather`` (the op against
``gather_chain.py``'s plain versions: y atol 1e-4, every pick within 1e-4
of the plain max, dsrc and dctr atol and rtol 1e-4) and ``check_hoist``
(each kernel against its own plain version: the products within those
tolerances, the max's y and am, the reverse lists and the pull bit for
bit, and two calls of the whole backward bit-equal).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pointcloudattack_tpu_torch import models
from pointcloudattack_tpu_torch.ops import gather_chain as gc
from pointcloudattack_tpu_torch.ops import gather_hoist as gh
from pointcloudattack_tpu_torch.utils.apply import make_model_fn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the cases and the checks)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def check(name, case):
    gc.reset_launches()
    gh.reset_launches()
    chip_smoke.check_gather(name, *case)
    assert gh.LAUNCHES == dict.fromkeys(gh.LAUNCHES, 1)
    chip_smoke.check_hoist(name, *case, tag="test")
    assert all(n == 0 for n in gc.LAUNCHES.values())  # no row kernel for one layer


@pytest.mark.cuda
@pytest.mark.parametrize("c,cout", [(3, 64), (64, 64), (64, 128), (128, 256)])
def test_edgeconv_shapes_match_plain_on_card(cuda_device, c, cout):
    """DGCNN's four EdgeConvs at B=2, N=1024, K=20."""
    check(f"C={c} -> {cout}", chip_smoke.hoist_case(c + cout, 2, 1024, c, cout))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(chip_smoke.HOIST_EDGE_CASES))
def test_edge_cases_match_plain_on_card(cuda_device, name):
    """A ragged N=1000, every point 4 times (exact ties), a hub point (a long
    reverse list) and a negative BatchNorm scale."""
    check(name, chip_smoke.hoist_case(*chip_smoke.HOIST_EDGE_CASES[name]))


@pytest.mark.cuda
def test_curvenet_initial_lpfa_matches_plain_on_card(cuda_device):
    """The initial LPFA's layout (center / pass / diff on the points
    themselves), 9 -> 32, B=2."""
    xyz, _, idx, _, dy = chip_smoke.lpfa_gather_case(21, 2, 1024, 3, 20, (32,))
    layers = chip_smoke.seeded_layers(np.random.RandomState(22), (9, 32), cuda_device)
    check("initial LPFA", (xyz, xyz, idx, layers, chip_smoke.CN_INITIAL_LAYOUT, dy))


@pytest.mark.cuda
def test_route_raises_on_what_it_does_not_take(cuda_device):
    src, _, idx, layers, layout, _ = chip_smoke.hoist_case(3, 1, 256, 8, 16)
    with pytest.raises(ValueError, match="contiguous"):
        gc.gather_chain_fwd(src.double(), src.double(), idx, layers, layout)
    with pytest.raises(ValueError, match="shared memory"):
        gh.reverse_lists(torch.zeros((1, 4, 20), dtype=torch.int32, device=cuda_device), 60000)
    with pytest.raises(ValueError, match="row kernel"):
        gc._fwd_kernel(src, src, idx, layers, layout)


@pytest.mark.cuda
def test_dgcnn_runs_the_route_on_card(cuda_device):
    """DGCNN's forward and input backward launch the route's kernels at each
    EdgeConv and the row kernel never."""
    model = models.make_model("DGCNN", 40, generator=torch.Generator().manual_seed(0))
    fn = make_model_fn(model, None, cuda_device)
    x = torch.from_numpy((np.random.RandomState(1).randn(2, 1024, 3) * 0.5).astype(np.float32)).to(cuda_device)
    gc.reset_launches()
    gh.reset_launches()
    a = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(fn(a)[:, 0].sum(), a)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    assert gh.LAUNCHES == dict.fromkeys(gh.LAUNCHES, 4)
    assert all(n == 0 for n in gc.LAUNCHES.values())
