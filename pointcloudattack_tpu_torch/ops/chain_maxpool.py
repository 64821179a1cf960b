"""Fused per-point Dense -> eval-BN (-> ReLU) chain with a max over points.

Counterpart of ``pointcloudattack_tpu/ops/pallas/dense_max_kernel.py``
(``mlp_chain_maxpool`` and its custom VJP).  For ``x [B, N, C0]`` and
``layers``, a sequence of ``(w [C_in, C_out], b, mean, mul, beta)`` with
``mul = rsqrt(var + eps) * scale`` the folded eval-mode BatchNorm scale,
every point runs

    z_l = (h_l @ w_l + b_l - mean_l) * mul_l + beta_l,  h_l+1 = relu(z_l)

with no ReLU after the last layer, and the output is ``y [B, C_L]``, the
max over the points, with ``idx [B, C_L]`` int32, the lowest point index
attaining it.  A trailing ReLU commutes with the max, so callers apply it
to ``y``.

On a CUDA tensor the forward and the input gradient run the hand-written
Hopper kernels of ``csrc/chain_maxpool.cu``; on a CPU tensor they run the
plain PyTorch versions below.  The backward has two stages, each with its
plain version: ``winner_lists`` (per cloud, the rows that win a column and
the columns each one won) and ``winners_bwd`` (the gradient of those rows;
every other row's is 0).  The kernels read each ``w`` as the ``[out, in]``
matrix a module holds, so the transposed view of a module's weight costs
no copy.  A CUDA tensor the kernels do not take raises: nothing falls
back.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from pointcloudattack_tpu_torch.ops import _build

Layer = Sequence[torch.Tensor]  # (w, b, mean, mul, beta)

# Kernel launches since the last reset, by direction.  Bumped only where a
# kernel is launched, never by the plain versions.
# "fwd" and "bwd" once for each call of the forward and the backward, the
# backward's stages once each too.
LAUNCHES = {"fwd": 0, "bwd": 0, "bwd_lists": 0, "bwd_rows": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the reference the kernel is held to)
# ---------------------------------------------------------------------------


def act(z: torch.Tensor, slope: float = 0.0) -> torch.Tensor:
    """The chain's activation ``max(z, slope * z)``: ReLU at slope 0,
    LeakyReLU(slope) otherwise, as the JAX package's ``_act``."""
    return torch.relu(z) if slope == 0.0 else torch.maximum(z, slope * z)


def act_bwd(dh: torch.Tensor, h: torch.Tensor, slope: float = 0.0) -> torch.Tensor:
    """The cotangent ``dh`` through ``act``, given its input or output ``h``
    (both are positive exactly where the input is), as ``_act_bwd``."""
    return torch.where(h > 0, dh, 0.0 if slope == 0.0 else slope * dh)


def chain_maxpool_plain(x: torch.Tensor, layers: Sequence[Layer]):
    """Plain forward: ``(y [B, C_L] f32, idx [B, C_L] int32)``.

    ``y`` is ``amax`` over the points, so autograd through it splits a
    tie's gradient evenly, as ``jnp.max`` does; ``idx`` takes the lowest
    row among ties, as ``jnp.argmax`` does.
    """
    z = x.float()
    for i, (w, b, mean, mul, beta) in enumerate(layers):
        if i:
            z = act(z)
        z = (z @ w + b - mean) * mul + beta
    y = z.amax(dim=1)
    n = z.shape[1]
    rows = torch.arange(n, device=z.device, dtype=torch.int32)[None, :, None]
    big = torch.full((), n, device=z.device, dtype=torch.int32)
    idx = torch.where(z == y[:, None, :], rows, big).amin(dim=1)
    return y, idx


def chain_maxpool_bwd_plain(
    x: torch.Tensor,
    layers: Sequence[Layer],
    idx: torch.Tensor,
    g: torch.Tensor,
) -> torch.Tensor:
    """Plain input gradient ``dx [B, N, C0]`` for ``g = dy * mul_L``.

    As ``_chain_bwd_kernel`` does: recompute the masks, put ``g[b, c]`` on
    row ``idx[b, c]`` of the last layer's matmul output, and run back
    through the layers.  The sparse cotangent goes through the last layer
    as a scatter of ``g[c] * W_L[:, c]`` onto the winning rows.
    """
    with torch.no_grad():
        h, hs = x.float(), []
        for w, b_, mean, mul, beta in layers[:-1]:
            h = act((h @ w + b_ - mean) * mul + beta)
            hs.append(h)
        b, n, _ = x.shape
        w_last = layers[-1][0].float()
        cm, cl = w_last.shape
        contrib = g.float()[:, :, None] * w_last.t()[None]  # [B, C_L, Cm]
        dh = x.new_zeros((b, n, cm), dtype=torch.float32).scatter_add_(
            1, idx.long()[:, :, None].expand(b, cl, cm), contrib
        )
        for i in range(len(layers) - 2, -1, -1):
            c = act_bwd(dh, hs[i]) * layers[i][3]
            dh = c @ layers[i][0].float().t()
        return dh


class Winners(NamedTuple):
    """The backward's lists, per cloud of ``idx [B, C_L]`` over ``n`` rows
    (``W = min(n, C_L)``), all int32: ``off [B + 1]``, the winning rows
    before each cloud (``off[B]`` all of them); ``wrow [B, W]``, each
    cloud's winning rows, ascending, then -1; ``cstart [B, W]``, where each
    winner's columns start in ``cols`` flattened, then -1; ``cols [B,
    C_L]``, each cloud's columns sorted stably by winning row."""

    off: torch.Tensor
    wrow: torch.Tensor
    cstart: torch.Tensor
    cols: torch.Tensor


def winner_lists_plain(idx: torch.Tensor, n: int) -> Winners:
    """Plain lists stage: a stable sort of each cloud's columns by row."""
    b, cl = idx.shape
    idx64 = idx.long()
    cols = torch.sort(idx64, dim=1, stable=True).indices
    hist = torch.zeros((b, n), dtype=torch.int64, device=idx.device).scatter_add_(1, idx64, torch.ones_like(idx64))
    win = hist > 0
    off = torch.zeros(b + 1, dtype=torch.int64, device=idx.device)
    off[1:] = win.sum(1).cumsum(0)
    rank = win.cumsum(1) - 1
    start = hist.cumsum(1) - hist + torch.arange(b, device=idx.device)[:, None] * cl
    wrow = torch.full((b, min(n, cl)), -1, dtype=torch.int64, device=idx.device)
    cstart = wrow.clone()
    bi, rows = win.nonzero(as_tuple=True)
    wrow[bi, rank[bi, rows]] = rows
    cstart[bi, rank[bi, rows]] = start[bi, rows]
    return Winners(off.int(), wrow.int(), cstart.int(), cols.int())


def _rows_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` for a subset of a product's rows, with the bits those rows
    get in the whole product (as the tests hold, at the chains' widths):
    under 16 rows MKL takes other kernels, which sum in another order, so
    a short ``a`` runs padded with zero rows."""
    m = a.shape[0]
    if m >= 16:
        return a @ w
    return (torch.cat([a, a.new_zeros((16 - m, a.shape[1]))]) @ w)[:m]


def winners_bwd_plain(x: torch.Tensor, layers: Sequence[Layer], lists: Winners, g: torch.Tensor) -> torch.Tensor:
    """Plain rows stage: ``chain_maxpool_bwd_plain``'s arithmetic on the
    listed rows only, scattered into zeros (the same bits)."""
    with torch.no_grad():
        b, n, c0 = x.shape
        cl = g.shape[1]
        bi, slot = (lists.wrow >= 0).nonzero(as_tuple=True)  # the packed order
        rows = lists.wrow[bi, slot].long()
        h, hs = x.float()[bi, rows], []
        for w, b_, mean, mul, beta in layers[:-1]:
            h = act((_rows_mm(h, w) + b_ - mean) * mul + beta)
            hs.append(h)
        w_last = layers[-1][0].float()
        entry = torch.arange(b * cl, device=x.device)
        owner = torch.searchsorted(lists.cstart[bi, slot].long(), entry, right=True) - 1
        col = lists.cols.reshape(-1).long()
        contrib = g.float()[entry // cl, col][:, None] * w_last.t()[col]  # [B * C_L, Cm]
        dh = x.new_zeros((rows.numel(), w_last.shape[0]), dtype=torch.float32).scatter_add_(
            0, owner[:, None].expand_as(contrib), contrib
        )
        for i in range(len(layers) - 2, -1, -1):
            c = act_bwd(dh, hs[i]) * layers[i][3]
            dh = _rows_mm(c, layers[i][0].float().t())
        dx = x.new_zeros((b, n, c0), dtype=torch.float32)
        dx[bi, rows] = dh
        return dx


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda(x: torch.Tensor, layers: Sequence[Layer]) -> list[int]:
    """Validate what the kernels take; returns dims [C0, C1, ..., C_L]."""
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(
            "chain_maxpool kernel takes a contiguous float32 [B, N, C0] "
            f"tensor, got {x.dtype} {tuple(x.shape)} "
            f"contiguous={x.is_contiguous()}"
        )
    if not 1 <= len(layers) <= 4:
        raise ValueError(f"chain_maxpool kernel takes 1-4 layers, got {len(layers)}")
    dims = [x.shape[2]]
    for i, layer in enumerate(layers):
        w, *vecs = layer
        if w.dim() != 2 or w.shape[0] != dims[-1]:
            raise ValueError(
                f"layer {i}: weight {tuple(w.shape)} does not take width {dims[-1]}"
            )
        dims.append(w.shape[1])
        for t in (w, *vecs):
            if t.device != x.device or t.dtype != torch.float32:
                raise ValueError(
                    f"layer {i}: parameters must be float32 on {x.device}, "
                    f"got {t.dtype} on {t.device}"
                )
        if not all(v.is_contiguous() for v in vecs):
            raise ValueError(f"layer {i}: b, mean, mul and beta must be contiguous")
        for v in vecs:
            if tuple(v.shape) != (dims[-1],):
                raise ValueError(
                    f"layer {i}: vector {tuple(v.shape)} != ({dims[-1]},)"
                )
    if max(dims[:-1]) > 1024:
        raise ValueError(f"chain_maxpool kernel takes widths <= 1024, got {dims}")
    if x.shape[0] < 1 or x.shape[0] > 65535 or x.shape[1] < 1:
        raise ValueError(f"chain_maxpool kernel: bad batch/points {tuple(x.shape)}")
    return dims


def _check_cotangent(x: torch.Tensor, dims: list[int], name: str, t: torch.Tensor, dtype) -> None:
    if (t.device != x.device or t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != (x.shape[0], dims[-1])):
        raise ValueError(
            f"chain_maxpool backward: {name} must be contiguous {dtype} "
            f"[{x.shape[0]}, {dims[-1]}] on {x.device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
        )


def _ptr_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _params(layers: Sequence[Layer]):
    """(pointer array, tensors to keep alive): per layer ``w`` as ``[out,
    in]`` row-major, then b, mean, mul, beta.  A transposed view of a
    module's weight is that already; any other ``w`` is copied."""
    keep = []
    for w, *vecs in layers:
        wt = w.t()
        keep += [wt if wt.is_contiguous() else wt.contiguous(), *vecs]
    return _ptr_array(keep), keep


def _stream(device: torch.device) -> int:
    """The current stream of ``device``; each C entry point sets its device itself."""
    return torch.cuda.current_stream(device).cuda_stream


# The forward's scratch (the hidden stage's output, the partial maxima), one
# buffer a device and stream, grown when a call needs more: kernels on one
# stream run in order, so a call may reuse what the last one used.  A fresh
# 36 MB buffer a call at PointNet's spine cost C&W on PointNet 10-20% of its
# time on an H100.
_WORKSPACE: dict = {}


def _workspace(device: torch.device, nbytes: int) -> torch.Tensor:
    key = (device.index, _stream(device))
    buf = _WORKSPACE.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _WORKSPACE[key] = torch.empty(nbytes, dtype=torch.uint8, device=device)
    return buf


def _fwd_kernel(x: torch.Tensor, layers: Sequence[Layer]):
    dims = _check_cuda(x, layers)
    lib = _build.load_library()
    b, n, _ = x.shape
    dims_arr = (ctypes.c_int * len(dims))(*dims)
    dims_p = ctypes.cast(dims_arr, ctypes.c_void_p)
    dev = x.device.index
    nbytes = lib.pca_chain_fwd_workspace(dev, b, n, len(layers), dims_p)
    if not nbytes:
        raise ValueError(f"chain_maxpool kernel: the chain {dims} needs too much shared memory")
    ws = _workspace(x.device, nbytes)
    y = torch.empty((b, dims[-1]), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, dims[-1]), dtype=torch.int32, device=x.device)
    params, _keep = _params(layers)
    rc = lib.pca_chain_fwd(dev, x.data_ptr(), b, n, len(layers), dims_p, ctypes.cast(params, ctypes.c_void_p),
                           ws.data_ptr(), y.data_ptr(), idx.data_ptr(), _stream(x.device))
    _build.check(lib, rc, "chain_maxpool forward launch")
    LAUNCHES["fwd"] += 1
    return y, idx


def _lists_kernel(idx: torch.Tensor, n: int) -> Winners:
    lib = _build.load_library()
    b, cl = idx.shape
    wcap = min(n, cl)
    buf = torch.empty(2 * (b + 1) + 2 * b * wcap + b * cl, dtype=torch.int32, device=idx.device)
    counts, off, wrow, cstart, cols = buf.split([b + 1, b + 1, b * wcap, b * wcap, b * cl])
    rc = lib.pca_chain_lists(idx.device.index, idx.data_ptr(), b, n, cl, counts.data_ptr(), off.data_ptr(),
                             wrow.data_ptr(), cstart.data_ptr(), cols.data_ptr(), _stream(idx.device))
    _build.check(lib, rc, "chain_maxpool lists launch")
    LAUNCHES["bwd_lists"] += 1
    return Winners(off, wrow.view(b, wcap), cstart.view(b, wcap), cols.view(b, cl))


def _rows_kernel(x: torch.Tensor, layers: Sequence[Layer], dims: list[int], lists: Winners, g: torch.Tensor):
    lib = _build.load_library()
    b, n, _ = x.shape
    dims_arr = (ctypes.c_int * len(dims))(*dims)
    params, _keep = _params(layers)
    dx = torch.empty_like(x)
    rc = lib.pca_chain_rows(x.device.index, x.data_ptr(), b, n, len(layers), ctypes.cast(dims_arr, ctypes.c_void_p),
                            ctypes.cast(params, ctypes.c_void_p), lists.off.data_ptr(), lists.wrow.data_ptr(),
                            lists.cstart.data_ptr(), lists.cols.data_ptr(), g.data_ptr(), dx.data_ptr(),
                            _stream(x.device))
    _build.check(lib, rc, "chain_maxpool rows launch")
    LAUNCHES["bwd_rows"] += 1
    return dx


def _bwd_kernel(x, layers, idx, g):
    dims = _check_cuda(x, layers)
    _check_cotangent(x, dims, "idx", idx, torch.int32)
    _check_cotangent(x, dims, "g", g, torch.float32)
    dx = _rows_kernel(x, layers, dims, _lists_kernel(idx, x.shape[1]), g)
    LAUNCHES["bwd"] += 1
    return dx


def _on(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for others."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"chain_maxpool {what}: no implementation for device {t.device}")


def chain_maxpool_fwd(x: torch.Tensor, layers: Sequence[Layer]):
    """``(y, idx)``: the kernels for a CUDA tensor, the plain version for a
    CPU tensor."""
    return _fwd_kernel(x, layers) if _on(x, "forward") else chain_maxpool_plain(x, layers)


def chain_maxpool_bwd(x, layers, idx, g):
    """``dx`` for ``g = dy * mul_L``: the lists and rows kernels for a CUDA
    tensor, the plain version for a CPU tensor."""
    return _bwd_kernel(x, layers, idx, g) if _on(x, "backward") else chain_maxpool_bwd_plain(x, layers, idx, g)


def winner_lists(idx: torch.Tensor, n: int) -> Winners:
    """The backward's lists stage on ``idx [B, C_L]`` int32 over ``n`` rows:
    the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if not _on(idx, "lists"):
        return winner_lists_plain(idx, n)
    if idx.dtype != torch.int32 or idx.dim() != 2 or not idx.is_contiguous():
        raise ValueError(f"chain_maxpool lists: idx must be contiguous int32 [B, C_L], got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    return _lists_kernel(idx, n)


def winners_bwd(x: torch.Tensor, layers: Sequence[Layer], lists: Winners, g: torch.Tensor) -> torch.Tensor:
    """The backward's rows stage: ``dx`` from ``lists`` (``winner_lists``)
    and ``g = dy * mul_L``; the kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if not _on(x, "rows"):
        return winners_bwd_plain(x, layers, lists, g)
    dims = _check_cuda(x, layers)
    _check_cotangent(x, dims, "g", g, torch.float32)
    b, wcap, cl = x.shape[0], min(x.shape[1], dims[-1]), dims[-1]
    want = {"off": (b + 1,), "wrow": (b, wcap), "cstart": (b, wcap), "cols": (b, cl)}
    for name, t in zip(Winners._fields, lists):
        if t.device != x.device or t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != want[name]:
            raise ValueError(f"chain_maxpool rows: {name} must be contiguous int32 {want[name]} on {x.device}")
    return _rows_kernel(x, layers, dims, lists, g)


# ---------------------------------------------------------------------------
# Differentiable op
# ---------------------------------------------------------------------------


def _group(flat) -> list[tuple]:
    return [tuple(flat[i : i + 5]) for i in range(0, len(flat), 5)]


class ChainMaxPool(torch.autograd.Function):
    """y = max over points of the chain.  The backward's dx comes from the
    kernels (or the plain backward on the CPU); parameter gradients come
    from autograd through the plain forward, and only when asked for, as
    the JAX VJP takes them from the unfused reference chain.  The weights
    go to the kernels as given: no copy."""

    @staticmethod
    def forward(ctx, x, *flat):
        y, idx = chain_maxpool_fwd(x, _group(flat))
        ctx.save_for_backward(x, idx, *flat)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, idx, *flat = ctx.saved_tensors
        dy = dy.float().contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            layers = _group(flat)
            g = (dy * layers[-1][3][None, :]).contiguous()
            dx = chain_maxpool_bwd(x, layers, idx, g).to(x.dtype)
        dflat = [None] * len(flat)
        want = [i for i, need in enumerate(ctx.needs_input_grad[1:]) if need]
        if want:
            with torch.enable_grad():
                ps = [p.detach().requires_grad_(i in want) for i, p in enumerate(flat)]
                y_ref, _ = chain_maxpool_plain(x.detach(), _group(ps))
                grads = torch.autograd.grad(y_ref, [ps[i] for i in want], dy)
            for i, gr in zip(want, grads):
                dflat[i] = gr
        return (dx, *dflat)


def mlp_chain_maxpool(x: torch.Tensor, layers: Sequence[Layer]) -> torch.Tensor:
    """Max over points of an L-layer per-point Dense+eval-BN(+ReLU) chain.

    ``x [B, N, C0] -> [B, C_L]`` f32; see the module docstring.
    """
    return ChainMaxPool.apply(x, *[t for layer in layers for t in layer])
