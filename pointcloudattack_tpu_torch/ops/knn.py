"""Exact self k-nearest neighbours.

Counterpart of ``pointcloudattack_tpu/ops/knn.py::knn`` and its TPU kernel
``ops/pallas/knn_kernel.py::knn_pallas``: for ``x [B, N, C]``, the indices
``[B, N, k]`` int32 of each point's ``k`` nearest points, self included, in
ascending squared distance with ties to the lower index (the stable order
of ``lax.top_k`` on the negated distances).

The distance is ``ops/pairwise.py::pairwise_sqdist`` of ``x`` with itself.
The CUDA kernel (``csrc/knn.cu``) computes the same bits and selects in the
same order, so the kernel and the plain version give the same indices.

On a CUDA tensor ``knn`` launches the kernel; on a CPU tensor it runs the
plain version.  Indices carry no gradient.
"""

from __future__ import annotations

import torch

from pointcloudattack_tpu_torch.ops import _build
from pointcloudattack_tpu_torch.ops.pairwise import pairwise_sqdist

# Kernel launches since the last reset.  Bumped only where the kernel is
# launched, never by the plain version.
LAUNCHES = {"knn": 0}

MAX_POINTS = 4096  # the kernel keeps 8 rows of N distances in shared memory
MAX_CHANNELS = 128


def reset_launches() -> None:
    LAUNCHES["knn"] = 0


def knn_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version: ``pairwise_sqdist(x, x)``, then a stable ascending
    sort cut to ``k`` (``torch.topk``'s tie order is not specified)."""
    d = pairwise_sqdist(x.float(), x.float())
    return torch.sort(d, dim=-1, stable=True).indices[..., :k].to(torch.int32)


def _knn_kernel(x: torch.Tensor, k: int) -> torch.Tensor:
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"knn kernel takes a contiguous float32 [B, N, C] tensor, got {x.dtype} "
                         f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    b, n, c = x.shape
    if not (1 <= b <= 65535 and 1 <= n <= MAX_POINTS and 1 <= c <= MAX_CHANNELS and 1 <= k <= n):
        raise ValueError(f"knn kernel takes 1 <= B <= 65535, N <= {MAX_POINTS}, C <= {MAX_CHANNELS} "
                         f"and 1 <= k <= N; got B={b}, N={n}, C={c}, k={k}")
    lib = _build.load_library()
    nrm = torch.empty((b, n), dtype=torch.float32, device=x.device)
    out = torch.empty((b, n, k), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pca_knn(x.device.index, x.data_ptr(), nrm.data_ptr(), b, n, c, k, out.data_ptr(), stream)
    _build.check(lib, rc, "knn launch")
    LAUNCHES["knn"] += 1
    return out


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x [B, N, C]`` -> ``[B, N, k]`` int32 neighbour indices
    (neighbour 0 is the point itself unless another lies at distance 0)."""
    x = x.detach()
    if x.is_cuda:
        return _knn_kernel(x.contiguous(), k)
    if x.device.type == "cpu":
        return knn_plain(x, k)
    raise ValueError(f"knn: no implementation for device {x.device}")
