"""Nearest-neighbour squared distances, the core of Chamfer and Hausdorff.

``min_sqdist_rows`` (one direction) and ``min_sqdist_both`` (both, below).

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
from pointcloudattack_tpu_torch.ops.gather import index_points, scatter_rows
from pointcloudattack_tpu_torch.ops.pairwise import first_argmin

# Kernel launches since the last reset.  Bumped only where the kernel is
# launched, never by the plain version.
LAUNCHES = {"min_rows": 0, "both_fwd": 0, "both_bwd": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def exact_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``[B, N, M]`` squared distances in the TPU kernels' per-coordinate
    form, each operation rounded on its own."""
    x, y = x.float(), y.float()
    d = None
    for c in range(3):
        diff = x[..., :, None, c] - y[..., None, :, c]
        d = diff * diff if d is None else d + diff * diff
    return d


def min_rows_plain(x: torch.Tensor, y: torch.Tensor):
    """Plain forward: ``(mins [B, N] f32, argmin [B, N] int32)`` over the
    dense ``[B, N, M]`` matrix."""
    return first_argmin(exact_sqdist(x, y))


def _check_pair(what: str, x: torch.Tensor, y: torch.Tensor) -> None:
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[2] != 3 or not t.is_contiguous():
            raise ValueError(f"{what} kernel takes a contiguous float32 [B, *, 3] {name}, got "
                             f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
    if y.device != x.device or y.shape[0] != x.shape[0]:
        raise ValueError(f"{what}: x {tuple(x.shape)} on {x.device} and y {tuple(y.shape)} "
                         f"on {y.device} disagree")
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    if not (1 <= b <= 65535 and n >= 1 and m >= 1):
        raise ValueError(f"{what} kernel takes 1 <= B <= 65535 and N, M >= 1; got {b}, {n}, {m}")


def _min_rows_kernel(x: torch.Tensor, y: torch.Tensor):
    _check_pair("min_sqdist_rows", x, y)
    b, n, _ = x.shape
    m = y.shape[1]
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
        gy = scatter_rows(torch.zeros_like(y), arg, -gx) if ctx.needs_input_grad[1] else None
        return (gx if ctx.needs_input_grad[0] else None), gy


def min_sqdist_rows(x: torch.Tensor, y: torch.Tensor):
    """``x [B, N, 3]``, ``y [B, M, 3]`` -> ``(mins [B, N], argmin [B, N]
    int32)``; differentiable in ``mins``."""
    return MinSqdistRows.apply(x, y)


# ---------------------------------------------------------------------------
# Both directions from one call: counterpart of ``chamfer_kernel.py::
# min_sqdist_both`` and its TPU kernels ``_both_fwd`` / ``_both_bwd``.  The
# forward gives the row and the column min with first-index argmins; the
# backward is the JAX custom VJP (``chamfer_kernel.py:321-338``): each side's
# own term ``2 g (p - nearest)`` minus the other side's terms scattered onto
# the points they matched.  The CUDA kernels (``csrc/min_sqdist_both.cu``)
# compute the plain versions' bits, the backward's sums in the order of
# ``index_add_`` on the CPU.  The forward's blocks fold each point's minimum
# into a 64-bit key per point with integer atomics, and the last block of a
# cloud writes ``col_min`` and ``col_arg`` and resets the keys: that scratch
# (``_both_scratch``) is kept per device and stream, filled once.

# (device index, stream) -> (keys int64 [>= B * M], all ones; done int32 [>= B], 0)
_SCRATCH: dict = {}


def _both_scratch(device: torch.device, stream: int, b: int, m: int):
    """The forward kernel's keys and per-cloud counts on ``stream``, large
    enough for ``b`` clouds of ``m`` points; the kernel leaves them as it
    found them, so they are filled only when made."""
    keys, done = _SCRATCH.get((device.index, stream), (None, None))
    if keys is None or keys.numel() < b * m or done.numel() < b:
        n = max(b * m, keys.numel() if keys is not None else 0)
        keys = torch.full((n,), -1, dtype=torch.int64, device=device)
        done = torch.zeros(max(b, done.numel() if done is not None else 0), dtype=torch.int32, device=device)
        _SCRATCH[(device.index, stream)] = (keys, done)
    return keys, done


def both_plain(x: torch.Tensor, y: torch.Tensor):
    """Plain forward: ``(row_min [B, N], row_arg [B, N], col_min [B, M],
    col_arg [B, M])``, the argmins int32 and first on ties."""
    d = exact_sqdist(x, y)
    return (*first_argmin(d), *first_argmin(d.transpose(-1, -2)))


def both_bwd_plain(x, y, rarg, carg, gr, gc):
    """Plain backward: ``(dx [B, N, 3], dy [B, M, 3])``."""
    gx_row = (2.0 * gr[..., None]) * (x - index_points(y, rarg))
    gy_col = (2.0 * gc[..., None]) * (y - index_points(x, carg))
    return scatter_rows(gx_row.clone(), carg, -gy_col), scatter_rows(gy_col.clone(), rarg, -gx_row)


def _both_fwd_kernel(x: torch.Tensor, y: torch.Tensor):
    _check_pair("min_sqdist_both", x, y)
    b, n, _ = x.shape
    m = y.shape[1]
    lib = _build.load_library()
    f32, i32 = dict(dtype=torch.float32, device=x.device), dict(dtype=torch.int32, device=x.device)
    rmin, rarg = torch.empty((b, n), **f32), torch.empty((b, n), **i32)
    cmin, carg = torch.empty((b, m), **f32), torch.empty((b, m), **i32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        keys, done = _both_scratch(x.device, stream, b, m)
        rc = lib.pca_min_both_fwd(x.device.index, x.data_ptr(), y.data_ptr(), b, n, m, rmin.data_ptr(),
                                  rarg.data_ptr(), cmin.data_ptr(), carg.data_ptr(), keys.data_ptr(),
                                  done.data_ptr(), stream)
    _build.check(lib, rc, "min_sqdist_both forward launch")
    LAUNCHES["both_fwd"] += 1
    return rmin, rarg, cmin, carg


def _both_bwd_kernel(x, y, rarg, carg, gr, gc):
    _check_pair("min_sqdist_both backward", x, y)
    b, n, _ = x.shape
    m = y.shape[1]
    for name, t, shape, dt in (("rarg", rarg, (b, n), torch.int32), ("carg", carg, (b, m), torch.int32),
                               ("gr", gr, (b, n), torch.float32), ("gc", gc, (b, m), torch.float32)):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"min_sqdist_both backward kernel takes a contiguous {dt} {list(shape)} {name} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    lib = _build.load_library()
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pca_min_both_bwd(x.device.index, x.data_ptr(), y.data_ptr(), rarg.data_ptr(), carg.data_ptr(),
                                  gr.data_ptr(), gc.data_ptr(), b, n, m, dx.data_ptr(), dy.data_ptr(), stream)
    _build.check(lib, rc, "min_sqdist_both backward launch")
    LAUNCHES["both_bwd"] += 1
    return dx, dy


def both_fwd(x: torch.Tensor, y: torch.Tensor):
    """``(row_min, row_arg, col_min, col_arg)``: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return _both_fwd_kernel(x.contiguous(), y.contiguous())
    if x.device.type == "cpu":
        return both_plain(x, y)
    raise ValueError(f"min_sqdist_both: no implementation for device {x.device}")


def both_bwd(x, y, rarg, carg, gr, gc):
    """``(dx, dy)``: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if x.is_cuda:
        return _both_bwd_kernel(x.contiguous(), y.contiguous(), rarg, carg, gr.float().contiguous(),
                                gc.float().contiguous())
    if x.device.type == "cpu":
        return both_bwd_plain(x.float(), y.float(), rarg, carg, gr.float(), gc.float())
    raise ValueError(f"min_sqdist_both: no implementation for device {x.device}")


class MinSqdistBoth(torch.autograd.Function):
    """``(row_min, col_min, row_arg)``; the backward reads both argmins."""

    @staticmethod
    def forward(ctx, x, y):
        rmin, rarg, cmin, carg = both_fwd(x.detach(), y.detach())
        ctx.save_for_backward(x, y, rarg, carg)
        ctx.mark_non_differentiable(rarg)
        return rmin, cmin, rarg

    @staticmethod
    def backward(ctx, gr, gc, _g_arg):
        x, y, rarg, carg = ctx.saved_tensors
        dx, dy = both_bwd(x.detach(), y.detach(), rarg, carg, gr, gc)
        return (dx if ctx.needs_input_grad[0] else None), (dy if ctx.needs_input_grad[1] else None)


def min_sqdist_both(x: torch.Tensor, y: torch.Tensor):
    """``x [B, N, 3]``, ``y [B, M, 3]`` -> ``(row_min [B, N], col_min [B, M],
    row_arg [B, N] int32)`` from one call; differentiable in both mins.  A
    tied minimum sends its cotangent to the first index."""
    return MinSqdistBoth.apply(x, y)
