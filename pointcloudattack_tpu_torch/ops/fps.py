"""Farthest point sampling.

Counterpart of ``pointcloudattack_tpu/ops/fps.py::farthest_point_sample``
and its TPU kernel ``ops/pallas/fps_kernel.py::fps_pallas``.  Starting from
``start`` (index 0 when none is given), each step records the current
point, lowers every point's running distance to the picked set with the
squared distance to it, and picks the point whose running distance is
largest, ties to the lowest index.

The squared distance is ``(dx*dx + dy*dy) + dz*dz`` with every product and
sum rounded on its own (no fused multiply-add), in the JAX order
(``fps.py:60``).  The CUDA kernel (``csrc/fps.cu``) computes the same bits,
so the kernel and the plain version pick the same indices, bit for bit.

On a CUDA tensor ``farthest_point_sample`` launches the kernel; on a CPU
tensor it runs the plain loop.  Indices carry no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from pointcloudattack_tpu_torch.ops import _build

# Kernel launches since the last reset.  Bumped only where the kernel is
# launched, never by the plain version.
LAUNCHES = {"fps": 0}

MAX_POINTS = 8192  # the kernel keeps the cloud and its distances in shared memory


def reset_launches() -> None:
    LAUNCHES["fps"] = 0


def fps_plain(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> torch.Tensor:
    """Plain version: ``xyz [B, N, 3]``, ``start [B]`` -> ``[B, npoint]``
    int32, as a Python loop over the steps."""
    b, n, _ = xyz.shape
    x, y, z = (xyz[..., c].float() for c in range(3))
    rows = torch.arange(b, device=xyz.device)
    dist = torch.full((b, n), float("inf"), dtype=torch.float32, device=xyz.device)
    far = start.long()
    out = []
    for _ in range(npoint):
        out.append(far)
        dx = x - x[rows, far][:, None]
        dy = y - y[rows, far][:, None]
        dz = z - z[rows, far][:, None]
        dist = torch.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        far = dist.argmax(dim=1)  # the first index among ties
    return torch.stack(out, dim=1).to(torch.int32)


def _fps_kernel(xyz: torch.Tensor, npoint: int, start: torch.Tensor | None) -> torch.Tensor:
    """The kernel on ``xyz``; ``start`` None starts every cloud at index 0
    (the kernel reads no start array)."""
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[2] != 3 or not xyz.is_contiguous():
        raise ValueError(
            f"fps kernel takes a contiguous float32 [B, N, 3] tensor, got {xyz.dtype} "
            f"{tuple(xyz.shape)} contiguous={xyz.is_contiguous()}"
        )
    b, n, _ = xyz.shape
    if not (1 <= b <= 65535 and 1 <= n <= MAX_POINTS and 1 <= npoint):
        raise ValueError(f"fps kernel takes 1 <= B <= 65535, 1 <= N <= {MAX_POINTS}, npoint >= 1; "
                         f"got B={b}, N={n}, npoint={npoint}")
    if start is not None:
        start = start.to(device=xyz.device, dtype=torch.int32).contiguous()
        if tuple(start.shape) != (b,):
            raise ValueError(f"fps: start must be [{b}], got {tuple(start.shape)}")
    lib = _build.load_library()
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream(xyz.device).cuda_stream
        rc = lib.pca_fps(xyz.device.index, xyz.data_ptr(), None if start is None else start.data_ptr(), b, n,
                         npoint, out.data_ptr(), stream)
    _build.check(lib, rc, "fps launch")
    LAUNCHES["fps"] += 1
    return out


def farthest_point_sample(
    xyz: torch.Tensor, npoint: int, start: torch.Tensor | None = None
) -> torch.Tensor:
    """``xyz [B, N, 3]`` -> ``[B, npoint]`` int32 indices.  ``start [B]``
    defaults to index 0, as every attack calls it."""
    xyz = xyz.detach()
    if xyz.is_cuda:
        return _fps_kernel(xyz.contiguous(), npoint, start)
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint, torch.zeros(xyz.shape[0], dtype=torch.int32) if start is None else start)
    raise ValueError(f"farthest_point_sample: no implementation for device {xyz.device}")
