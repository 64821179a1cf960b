"""Per-row nearest-neighbour squared distance, the core of Chamfer and
Hausdorff.

Counterpart of ``pointcloudattack_tpu/ops/pallas/chamfer_kernel.py::
min_sqdist_rows`` (its TPU kernel ``_min_rows_pallas_2d`` and its custom
VJP): for ``x [B, N, 3]`` and ``y [B, M, 3]``, ``mins [B, N]`` =
``min_j |x_i - y_j|^2`` and ``argmin [B, N]`` int32, the first ``j``
attaining it.

The distance is the TPU kernel's per-coordinate form,
``((x0-y0)^2 + (x1-y1)^2) + (x2-y2)^2``, each operation rounded on its own
(``chamfer_kernel.py:49-54``); the JAX package's CPU path uses
``xx - 2xy + yy`` instead, so the mins differ from it by rounding while the
argmins agree.  The CUDA kernel (``csrc/min_sqdist.cu``) computes the same
bits as the plain version below.

The gradient is the JAX custom VJP (``chamfer_kernel.py:383-393``), plain
PyTorch on both devices: ``dx = g * 2(x - y[argmin])`` and, when ``y``
needs a gradient, the negated rows scattered onto ``y``.

On a CUDA tensor the forward launches the kernel; on a CPU tensor it runs
the plain version.
"""

from __future__ import annotations

import torch

from pointcloudattack_tpu_torch.ops import _build
from pointcloudattack_tpu_torch.ops.gather import index_points
from pointcloudattack_tpu_torch.ops.pairwise import first_argmin

# Kernel launches since the last reset.  Bumped only where the kernel is
# launched, never by the plain version.
LAUNCHES = {"min_rows": 0}


def reset_launches() -> None:
    LAUNCHES["min_rows"] = 0


def min_rows_plain(x: torch.Tensor, y: torch.Tensor):
    """Plain forward: ``(mins [B, N] f32, argmin [B, N] int32)`` over the
    dense ``[B, N, M]`` matrix."""
    x, y = x.float(), y.float()
    d = None
    for c in range(3):
        diff = x[..., :, None, c] - y[..., None, :, c]
        d = diff * diff if d is None else d + diff * diff
    return first_argmin(d)


def _min_rows_kernel(x: torch.Tensor, y: torch.Tensor):
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[2] != 3 or not t.is_contiguous():
            raise ValueError(f"min_sqdist_rows kernel takes a contiguous float32 [B, *, 3] {name}, got "
                             f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
    if y.device != x.device or y.shape[0] != x.shape[0]:
        raise ValueError(f"min_sqdist_rows: x {tuple(x.shape)} on {x.device} and y {tuple(y.shape)} "
                         f"on {y.device} disagree")
    b, n, _ = x.shape
    m = y.shape[1]
    if not (1 <= b <= 65535 and n >= 1 and m >= 1):
        raise ValueError(f"min_sqdist_rows kernel takes 1 <= B <= 65535 and N, M >= 1; got {b}, {n}, {m}")
    lib = _build.load_library()
    mins = torch.empty((b, n), dtype=torch.float32, device=x.device)
    arg = torch.empty((b, n), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pca_min_rows(x.device.index, x.data_ptr(), y.data_ptr(), b, n, m, mins.data_ptr(),
                              arg.data_ptr(), stream)
    _build.check(lib, rc, "min_sqdist_rows launch")
    LAUNCHES["min_rows"] += 1
    return mins, arg


def min_rows_fwd(x: torch.Tensor, y: torch.Tensor):
    """``(mins, argmin)``: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if x.is_cuda:
        return _min_rows_kernel(x.contiguous(), y.contiguous())
    if x.device.type == "cpu":
        return min_rows_plain(x, y)
    raise ValueError(f"min_sqdist_rows: no implementation for device {x.device}")


class MinSqdistRows(torch.autograd.Function):
    """``(mins, argmin)``; the backward reads only the argmin."""

    @staticmethod
    def forward(ctx, x, y):
        mins, arg = min_rows_fwd(x.detach(), y.detach())
        ctx.save_for_backward(x, y, arg)
        ctx.mark_non_differentiable(arg)
        return mins, arg

    @staticmethod
    def backward(ctx, g_min, _g_arg):
        x, y, arg = ctx.saved_tensors
        nearest = index_points(y, arg)  # [B, N, 3]
        gx = g_min[..., None] * (2.0 * (x - nearest))
        gy = None
        if ctx.needs_input_grad[1]:
            b, m, _ = y.shape
            flat = (arg.long() + torch.arange(b, device=y.device)[:, None] * m).reshape(-1)
            gy = torch.zeros_like(y).view(-1, 3).index_add_(0, flat, -gx.reshape(-1, 3)).view(y.shape)
        return (gx if ctx.needs_input_grad[0] else None), gy


def min_sqdist_rows(x: torch.Tensor, y: torch.Tensor):
    """``x [B, N, 3]``, ``y [B, M, 3]`` -> ``(mins [B, N], argmin [B, N]
    int32)``; differentiable in ``mins``."""
    return MinSqdistRows.apply(x, y)
