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
Hopper kernel of ``csrc/chain_maxpool.cu``; on a CPU tensor they run the
plain PyTorch versions below.  A CUDA tensor the kernel does not take
raises: nothing falls back.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from pointcloudattack_tpu_torch.ops import _build

Layer = Sequence[torch.Tensor]  # (w, b, mean, mul, beta)

# Kernel launches since the last reset, by direction.  Bumped only where a
# kernel is launched, never by the plain versions.
LAUNCHES = {"fwd": 0, "bwd": 0}


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


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda(x: torch.Tensor, layers: Sequence[Layer]) -> list[int]:
    """Validate what the kernel takes; returns dims [C0, C1, ..., C_L]."""
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
        # w may have any strides: the wrappers take the layout each kernel reads
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


def _pick_tm(lib: ctypes.CDLL, dims_arr, num_layers: int, bwd: bool) -> int:
    """Rows per thread: the largest whose shared memory fits one block."""
    cap = lib.pca_chain_max_smem()
    for tm in (8, 4, 2):
        if lib.pca_chain_smem(num_layers, ctypes.cast(dims_arr, ctypes.c_void_p), tm, int(bwd)) <= cap:
            return tm
    raise ValueError("chain_maxpool kernel: the chain's widths need too much shared memory")


def _ptr_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _fwd_kernel(x: torch.Tensor, layers: Sequence[Layer]):
    dims = _check_cuda(x, layers)
    lib = _build.load_library()
    num_layers = len(layers)
    dims_arr = (ctypes.c_int * len(dims))(*dims)
    tm = _pick_tm(lib, dims_arr, num_layers, bwd=False)
    b, n, _ = x.shape
    cl = dims[-1]
    ntiles = -(-n // (8 * tm))
    kw = dict(device=x.device)
    part_v = torch.empty((b, ntiles, cl), dtype=torch.float32, **kw)
    part_i = torch.empty((b, ntiles, cl), dtype=torch.int32, **kw)
    y = torch.empty((b, cl), dtype=torch.float32, **kw)
    idx = torch.empty((b, cl), dtype=torch.int32, **kw)
    # w [in, out] row-major; a no-op for a contiguous w
    ws = [layer[0].contiguous() for layer in layers]
    params = _ptr_array([t for w, layer in zip(ws, layers) for t in (w, *layer[1:])])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pca_chain_fwd(
            x.device.index, x.data_ptr(), b, n, num_layers,
            ctypes.cast(dims_arr, ctypes.c_void_p),
            ctypes.cast(params, ctypes.c_void_p),
            part_v.data_ptr(), part_i.data_ptr(), y.data_ptr(), idx.data_ptr(),
            tm, stream,
        )
    _build.check(lib, rc, "chain_maxpool forward launch")
    LAUNCHES["fwd"] += 1
    return y, idx


def _bwd_kernel(x, layers, idx, g, wts=None):
    dims = _check_cuda(x, layers)
    b, n, c0 = x.shape
    for name, t, dt in (("idx", idx, torch.int32), ("g", g, torch.float32)):
        if (t.device != x.device or t.dtype != dt or not t.is_contiguous()
                or tuple(t.shape) != (b, dims[-1])):
            raise ValueError(
                f"chain_maxpool backward: {name} must be contiguous {dt} "
                f"[{b}, {dims[-1]}] on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )
    lib = _build.load_library()
    num_layers = len(layers)
    dims_arr = (ctypes.c_int * len(dims))(*dims)
    tm = _pick_tm(lib, dims_arr, num_layers, bwd=True)
    # the recompute reads w [in, out] and the backward W^T [out, in], both
    # row-major; each is a no-op when the tensor is already in that layout
    ws = [layer[0].contiguous() for layer in layers]
    if wts is None:
        wts = [layer[0].t() for layer in layers]
    wts = [wt.contiguous() for wt in wts]
    if [tuple(wt.shape) for wt in wts] != [tuple(w.t().shape) for w in ws]:
        raise ValueError("chain_maxpool backward: wts must be the layers' W^T")
    dx = torch.empty((b, n, c0), dtype=torch.float32, device=x.device)
    params = _ptr_array([t for w, layer in zip(ws, layers) for t in (w, *layer[1:])])
    wt_arr = _ptr_array(wts)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pca_chain_bwd(
            x.device.index, x.data_ptr(), b, n, num_layers,
            ctypes.cast(dims_arr, ctypes.c_void_p),
            ctypes.cast(params, ctypes.c_void_p),
            ctypes.cast(wt_arr, ctypes.c_void_p),
            idx.data_ptr(), g.data_ptr(), dx.data_ptr(), tm, stream,
        )
    _build.check(lib, rc, "chain_maxpool backward launch")
    LAUNCHES["bwd"] += 1
    return dx


def chain_maxpool_fwd(x: torch.Tensor, layers: Sequence[Layer]):
    """``(y, idx)``: the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if x.is_cuda:
        return _fwd_kernel(x, layers)
    if x.device.type == "cpu":
        return chain_maxpool_plain(x, layers)
    raise ValueError(f"chain_maxpool: no implementation for device {x.device}")


def chain_maxpool_bwd(x, layers, idx, g, wts=None):
    """``dx`` for ``g = dy * mul_L``: the kernel for a CUDA tensor, the
    plain version for a CPU tensor.  ``wts``, the layers' ``W^T [out, in]``,
    spares the kernel a transposed copy when the caller holds them."""
    if x.is_cuda:
        return _bwd_kernel(x, layers, idx, g, wts)
    if x.device.type == "cpu":
        return chain_maxpool_bwd_plain(x, layers, idx, g)
    raise ValueError(f"chain_maxpool: no implementation for device {x.device}")


# ---------------------------------------------------------------------------
# Differentiable op
# ---------------------------------------------------------------------------


def _group(flat) -> list[tuple]:
    return [tuple(flat[i : i + 5]) for i in range(0, len(flat), 5)]


class ChainMaxPool(torch.autograd.Function):
    """y = max over points of the chain.  The backward's dx comes from the
    kernel (or the plain backward on the CPU); parameter gradients come
    from autograd through the plain forward, and only when asked for, as
    the JAX VJP takes them from the unfused reference chain.

    Each weight is made ``[in, out]`` contiguous once, in the forward, and
    kept for the backward; the weight as given supplies ``W^T``, which is
    free when it is the transposed view of a module's ``[out, in]`` weight.
    """

    @staticmethod
    def forward(ctx, x, *flat):
        ws = [w.contiguous() for w in flat[::5]]
        layers = [(w, *layer[1:]) for w, layer in zip(ws, _group(flat))]
        y, idx = chain_maxpool_fwd(x, layers)
        ctx.save_for_backward(x, idx, *ws, *flat)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, idx, *saved = ctx.saved_tensors
        nl = len(saved) // 6
        ws, flat = saved[:nl], saved[nl:]
        dy = dy.float().contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            layers = [(w, *layer[1:]) for w, layer in zip(ws, _group(flat))]
            g = (dy * layers[-1][3][None, :]).contiguous()
            wts = [w.t() for w in flat[::5]]
            dx = chain_maxpool_bwd(x, layers, idx, g, wts).to(x.dtype)
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
