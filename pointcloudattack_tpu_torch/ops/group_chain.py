"""Per-point Dense -> eval-BN -> LeakyReLU chain over grouped rows, with a
max or a mean over each group.

Counterpart of ``pointcloudattack_tpu/ops/pallas/dense_max_kernel.py``
(``mlp_chain_groupmax`` and ``mlp_chain_groupmean`` and their custom
VJPs).  For ``x [B, G, K, C0]`` and ``layers`` as in
``ops/chain_maxpool.py``, every row runs

    z_l = (h_l @ w_l + b_l - mean_l) * mul_l + beta_l,  h_l+1 = act(z_l)

with ``act(z) = max(z, slope * z)``.  ``mlp_chain_groupmax``: no
activation after the last layer; ``y [B, G, C_L]`` is the max over the
``K`` rows of each group, with ``am [B, G, C_L]`` int32 the lowest ``k``
attaining it (a trailing monotone activation commutes with the max, so
callers apply it to ``y``).  ``mlp_chain_groupmean``: every layer is
activated, and ``y`` is the sum of each group's rows in ascending ``k``,
divided by ``K``.

On a CUDA tensor the forwards and the input gradients run the kernels of
``csrc/group_chain.cu`` (``K`` up to 64 rows a group).  A one-layer chain
(CurveNet's LPFAs) runs kernels of its own there: the forward of either
pool, the mean's and the max's input gradients; two or more layers, or a
one-layer shape whose block would need more shared memory than the card
has, run the chain kernels.  The route follows the shapes alone.  On a CPU
tensor they run the plain PyTorch versions below.  A CUDA tensor the
kernels do not take raises: nothing falls back.  ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from pointcloudattack_tpu_torch.ops import _build
from pointcloudattack_tpu_torch.ops.chain_maxpool import Layer, _group, _ptr_array, act, act_bwd
from pointcloudattack_tpu_torch.ops.pairwise import sum_neighbours

# Kernel launches since the last reset, by pool and direction.  Bumped only
# where a kernel is launched, never by the plain versions.
LAUNCHES = {"group_max_fwd": 0, "group_max_bwd": 0, "group_mean_fwd": 0, "group_mean_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def _chain(x: torch.Tensor, layers: Sequence[Layer], slope: float):
    """The last layer's pre-activation ``z`` and the hidden layers' ones
    (their signs are the activations' masks)."""
    h, zs = x.float(), []
    for i, (w, b, mean, mul, beta) in enumerate(layers):
        z = (h @ w + b - mean) * mul + beta
        if i < len(layers) - 1:
            zs.append(z)
            h = act(z, slope)
    return z, zs


def _back(c: torch.Tensor, layers: Sequence[Layer], zs, slope: float) -> torch.Tensor:
    """``dx`` from ``c``, the cotangent at the last layer's matmul output,
    through the hidden pre-activations ``zs``' masks."""
    dh = c @ layers[-1][0].float().t()
    for i in range(len(layers) - 2, -1, -1):
        c = act_bwd(dh, zs[i], slope) * layers[i][3]
        dh = c @ layers[i][0].float().t()
    return dh


def chain_groupmax_plain(x: torch.Tensor, layers: Sequence[Layer], slope: float = 0.0):
    """Plain max forward: ``(y [B, G, C_L] f32, am [B, G, C_L] int32)``.

    ``y`` is ``amax`` over the rows, so autograd through it splits a tie's
    gradient evenly, as ``jnp.max`` does; ``am`` takes the lowest row.
    """
    z, _ = _chain(x, layers, slope)
    y = z.amax(dim=2)
    k = z.shape[2]
    rows = torch.arange(k, device=z.device, dtype=torch.int32)[:, None]
    big = torch.full((), k, device=z.device, dtype=torch.int32)
    am = torch.where(z == y[:, :, None, :], rows, big).amin(dim=2)
    return y, am


def chain_groupmax_bwd_plain(x, layers: Sequence[Layer], am, g, slope: float = 0.0) -> torch.Tensor:
    """Plain ``dx [B, G, K, C0]`` of the max for ``g = dy * mul_L``, as
    ``_group_bwd_kernel`` does: recompute the masks, put ``g[b, g, c]`` on
    row ``am[b, g, c]`` of the last layer's matmul output, run back."""
    with torch.no_grad():
        _, zs = _chain(x, layers, slope)
        k = x.shape[2]
        hit = am.long()[:, :, None, :] == torch.arange(k, device=x.device)[:, None]
        return _back(torch.where(hit, g.float()[:, :, None, :], 0.0), layers, zs, slope)


def chain_groupmean_plain(x: torch.Tensor, layers: Sequence[Layer], slope: float = 0.0) -> torch.Tensor:
    """Plain mean forward ``y [B, G, C_L]``: every layer activated, the rows
    summed in ascending ``k``, then divided by ``K``."""
    z, _ = _chain(x, layers, slope)
    return sum_neighbours(act(z, slope)) / x.shape[2]


def chain_groupmean_bwd_plain(x, layers: Sequence[Layer], g, slope: float = 0.0) -> torch.Tensor:
    """Plain ``dx [B, G, K, C0]`` of the mean for ``g = dy * mul_L / K``, as
    ``_group_mean_bwd_kernel`` does: ``g`` on every row of its group,
    through the last layer's activation, then run back."""
    with torch.no_grad():
        z, zs = _chain(x, layers, slope)
        c = act_bwd(g.float()[:, :, None, :].expand(z.shape), z, slope)
        return _back(c, layers, zs, slope)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

MAX_K = 64  # a group's rows must fit one tile of the kernel (8 * TM, TM <= 8)


def _check_cuda(x: torch.Tensor, layers: Sequence[Layer], slope: float) -> list[int]:
    """Validate what the kernels take; returns dims [C0, C1, ..., C_L]."""
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"group_chain kernel takes a contiguous float32 [B, G, K, C0] tensor, got "
                         f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    b, g, k, c0 = x.shape
    if not (1 <= b <= 65535 and g >= 1 and 1 <= k <= MAX_K):
        raise ValueError(f"group_chain kernel takes 1 <= B <= 65535, G >= 1 and 1 <= K <= {MAX_K}; "
                         f"got {tuple(x.shape)}")
    if not 0.0 <= slope <= 1.0:
        raise ValueError(f"group_chain kernel takes a slope in [0, 1], got {slope}")
    if not 1 <= len(layers) <= 4:
        raise ValueError(f"group_chain kernel takes 1-4 layers, got {len(layers)}")
    dims = [c0]
    for i, (w, *vecs) in enumerate(layers):
        if w.dim() != 2 or w.shape[0] != dims[-1]:
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} does not take width {dims[-1]}")
        dims.append(w.shape[1])
        for t in (w, *vecs):
            if t.device != x.device or t.dtype != torch.float32:
                raise ValueError(f"layer {i}: parameters must be float32 on {x.device}, "
                                 f"got {t.dtype} on {t.device}")
        if not all(v.is_contiguous() and tuple(v.shape) == (dims[-1],) for v in vecs):
            raise ValueError(f"layer {i}: b, mean, mul and beta must be contiguous ({dims[-1]},)")
    return dims


def _pick_tm(lib, dims_arr, num_layers: int, k: int, bwd: bool) -> int:
    """Rows per thread: the largest whose tile holds a whole group and
    whose shared memory fits one block."""
    cap = lib.pca_chain_max_smem()
    for tm in (8, 4, 2):
        if 8 * tm < k:
            break
        if lib.pca_group_smem(num_layers, ctypes.cast(dims_arr, ctypes.c_void_p), k, tm, int(bwd)) <= cap:
            return tm
    raise ValueError(f"group_chain kernel: no tile takes K={k} with these widths")


def _common(x, layers, dims, lib, bwd):
    dims_arr = (ctypes.c_int * len(dims))(*dims)
    b, g, k, _ = x.shape
    tm = _pick_tm(lib, dims_arr, len(layers), k, bwd)
    ws = [layer[0].contiguous() for layer in layers]
    params = _ptr_array([t for w, layer in zip(ws, layers) for t in (w, *layer[1:])])
    head = (x.device.index, x.data_ptr(), b, g, k, len(layers), ctypes.cast(dims_arr, ctypes.c_void_p),
            ctypes.cast(params, ctypes.c_void_p))
    # the caller holds the ctypes arrays (and ws) until the launch returns
    return tm, head, (dims_arr, params, ws)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def one_layer_kernel(lib, smem, k: int, dims: Sequence[int]) -> bool:
    """Whether a chain of ``dims`` over groups of ``k`` rows runs a
    one-layer kernel whose block needs ``smem(K, C0, C1)`` bytes of shared
    memory: one layer, and a block that fits the card.  Every other shape
    runs the chain kernels."""
    return len(dims) == 2 and smem(k, dims[0], dims[1]) <= lib.pca_chain_max_smem()


def _fwd_kernel(x, layers, slope: float, mean: bool):
    dims = _check_cuda(x, layers, slope)
    lib = _build.load_library()
    b, g, k, c0 = x.shape
    y = torch.empty((b, g, dims[-1]), dtype=torch.float32, device=x.device)
    am = torch.empty((b, g, dims[-1]) if not mean else (1,), dtype=torch.int32, device=x.device)
    kind = "mean" if mean else "max"
    if one_layer_kernel(lib, lib.pca_group_fwd1_smem, k, dims):
        w = layers[0][0].contiguous()
        params = _ptr_array([w, *layers[0][1:]])
        with torch.cuda.device(x.device):
            rc = lib.pca_group_fwd1(x.device.index, x.data_ptr(), b, g, k, c0, dims[1],
                                    ctypes.cast(params, ctypes.c_void_p), float(slope), int(mean), y.data_ptr(),
                                    am.data_ptr(), _stream(x))
        _build.check(lib, rc, f"group_chain one-layer {kind} forward launch")
    else:
        tm, head, keep = _common(x, layers, dims, lib, bwd=False)
        with torch.cuda.device(x.device):
            rc = lib.pca_group_fwd(*head, float(slope), int(mean), y.data_ptr(), am.data_ptr(), tm, _stream(x))
        _build.check(lib, rc, f"group_chain {kind} forward launch")
    LAUNCHES[f"group_{kind}_fwd"] += 1
    return y if mean else (y, am)


def _check_pooled(x, dims, checks) -> None:
    b, ng, _, _ = x.shape
    for name, t, dt in checks:
        if (t.device != x.device or t.dtype != dt or not t.is_contiguous()
                or tuple(t.shape) != (b, ng, dims[-1])):
            raise ValueError(f"group_chain backward: {name} must be contiguous {dt} [{b}, {ng}, {dims[-1]}] "
                             f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def mean1_tc(c0: int, cl: int) -> bool:
    """Whether the one-layer mean backward runs its product back as 3xTF32
    on the tensor cores (True) or in FP32 on the CUDA cores: FP32 where
    both widths are 16 or less, the widths at which it measured faster on
    an H100 (``chip_smoke.py``'s ``[kernels-curvenet]`` times both at
    CurveNet's eight widths)."""
    return max(c0, cl) > 16


def _mean1_bwd_kernel(x, layers, g, slope: float, tc: bool | None = None):
    """The one-layer mean's ``dx`` (``group_mean1_bwd_kernel``): W and the
    tile's g rows in shared memory, the rows tiled whatever the groups.
    ``tc``: the product back as 3xTF32 on the tensor cores or in FP32 on
    the CUDA cores; by default as ``mean1_tc`` chooses.  The checks call it
    to hold either product back; on a shape that ``one_layer_kernel``
    sends to the chain kernels its launch raises."""
    dims = _check_cuda(x, layers, slope)
    _check_pooled(x, dims, [("g", g, torch.float32)])
    return _mean1_bwd(x, layers, g, slope, dims, _build.load_library(), tc)


def _mean1_bwd(x, layers, g, slope: float, dims, lib, tc: bool | None = None):
    b, ng, k, c0 = x.shape
    if tc is None:
        tc = mean1_tc(c0, dims[1])
    w = layers[0][0].contiguous()
    params = _ptr_array([w, *layers[0][1:]])
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.pca_group_mean1_bwd(x.device.index, x.data_ptr(), b, ng, k, c0, dims[1],
                                     ctypes.cast(params, ctypes.c_void_p), float(slope), g.data_ptr(), dx.data_ptr(),
                                     int(tc), _stream(x))
    _build.check(lib, rc, "group_chain one-layer mean backward launch")
    LAUNCHES["group_mean_bwd"] += 1
    return dx


def _max1_bwd_kernel(x, layers, am, g, dims, lib):
    """The one-layer max's ``dx`` (``group_max1_bwd_kernel``): each
    column's cotangent through W onto its winning row, no rows read."""
    b, ng, k, c0 = x.shape
    w = layers[0][0].contiguous()
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.pca_group_max1_bwd(x.device.index, am.data_ptr(), g.data_ptr(), b, ng, k, c0, dims[1], w.data_ptr(),
                                    dx.data_ptr(), _stream(x))
    _build.check(lib, rc, "group_chain one-layer max backward launch")
    LAUNCHES["group_max_bwd"] += 1
    return dx


def _bwd_kernel(x, layers, am, g, slope: float, mean: bool, wts=None):
    dims = _check_cuda(x, layers, slope)
    _check_pooled(x, dims, [("g", g, torch.float32)] + ([] if mean else [("am", am, torch.int32)]))
    lib = _build.load_library()
    k = x.shape[2]
    if mean and one_layer_kernel(lib, lib.pca_group_mean1_smem, k, dims):
        return _mean1_bwd(x, layers, g, slope, dims, lib)
    if not mean and one_layer_kernel(lib, lib.pca_group_max1_smem, k, dims):
        return _max1_bwd_kernel(x, layers, am, g, dims, lib)
    tm, head, keep = _common(x, layers, dims, lib, bwd=True)
    if wts is None:
        wts = [layer[0].t() for layer in layers]
    wts = [wt.contiguous() for wt in wts]
    if [tuple(wt.shape) for wt in wts] != [(layer[0].shape[1], layer[0].shape[0]) for layer in layers]:
        raise ValueError("group_chain backward: wts must be the layers' W^T")
    wt_arr = _ptr_array(wts)
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    am_ptr = g.data_ptr() if mean else am.data_ptr()  # unread by the mean kernel
    with torch.cuda.device(x.device):
        rc = lib.pca_group_bwd(*head, ctypes.cast(wt_arr, ctypes.c_void_p), float(slope), int(mean), am_ptr,
                               g.data_ptr(), dx.data_ptr(), tm, _stream(x))
    kind = "mean" if mean else "max"
    _build.check(lib, rc, f"group_chain {kind} backward launch")
    LAUNCHES[f"group_{kind}_bwd"] += 1
    return dx


def _no_device(x):
    return ValueError(f"group_chain: no implementation for device {x.device}")


def chain_groupmax_fwd(x, layers, slope: float = 0.0):
    """``(y, am)``: the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if x.is_cuda:
        return _fwd_kernel(x, layers, slope, mean=False)
    if x.device.type == "cpu":
        return chain_groupmax_plain(x, layers, slope)
    raise _no_device(x)


def chain_groupmax_bwd(x, layers, am, g, slope: float = 0.0, wts=None):
    """``dx`` of the max for ``g = dy * mul_L``: the kernel for a CUDA
    tensor, the plain version for a CPU tensor.  ``wts``, the layers' ``W^T
    [out, in]``, spares the chain kernel a transposed copy when the caller
    holds them; the one-layer kernel reads W itself and ignores them."""
    if x.is_cuda:
        return _bwd_kernel(x, layers, am, g, slope, mean=False, wts=wts)
    if x.device.type == "cpu":
        return chain_groupmax_bwd_plain(x, layers, am, g, slope)
    raise _no_device(x)


def chain_groupmean_fwd(x, layers, slope: float = 0.0):
    """``y``: the kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if x.is_cuda:
        return _fwd_kernel(x, layers, slope, mean=True)
    if x.device.type == "cpu":
        return chain_groupmean_plain(x, layers, slope)
    raise _no_device(x)


def chain_groupmean_bwd(x, layers, g, slope: float = 0.0, wts=None):
    """``dx`` of the mean for ``g = dy * mul_L / K``: the kernel for a CUDA
    tensor, the plain version for a CPU tensor.  ``wts`` as in
    ``chain_groupmax_bwd``."""
    if x.is_cuda:
        return _bwd_kernel(x, layers, None, g, slope, mean=True, wts=wts)
    if x.device.type == "cpu":
        return chain_groupmean_bwd_plain(x, layers, g, slope)
    raise _no_device(x)


# ---------------------------------------------------------------------------
# Differentiable ops
# ---------------------------------------------------------------------------


class GroupChain(torch.autograd.Function):
    """y = max (``mean`` false) or mean (``mean`` true) over each group's
    rows of the chain.  The backward's ``dx`` comes from the kernel (or the
    plain backward on the CPU); parameter gradients come from autograd
    through the plain forward, and only when asked for, as the JAX VJPs
    take them from the unfused oracles."""

    @staticmethod
    def forward(ctx, x, slope, mean, *flat):
        ws = [w.contiguous() for w in flat[::5]]
        layers = [(w, *layer[1:]) for w, layer in zip(ws, _group(flat))]
        x = x.contiguous()
        if mean:
            y, am = chain_groupmean_fwd(x, layers, slope), None
        else:
            y, am = chain_groupmax_fwd(x, layers, slope)
        ctx.slope, ctx.mean = slope, mean
        ctx.save_for_backward(x, am, *ws, *flat)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, am, *saved = ctx.saved_tensors
        nl = len(saved) // 6
        ws, flat = saved[:nl], saved[nl:]
        slope, mean = ctx.slope, ctx.mean
        dy = dy.float().contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            layers = [(w, *layer[1:]) for w, layer in zip(ws, _group(flat))]
            g = dy * layers[-1][3]
            if mean:
                dx = chain_groupmean_bwd(x, layers, (g / x.shape[2]).contiguous(), slope)
            else:
                dx = chain_groupmax_bwd(x, layers, am, g.contiguous(), slope)
            dx = dx.to(x.dtype)
        dflat = [None] * len(flat)
        want = [i for i, need in enumerate(ctx.needs_input_grad[3:]) if need]
        if want:
            with torch.enable_grad():
                ps = [p.detach().requires_grad_(i in want) for i, p in enumerate(flat)]
                if mean:
                    y_ref = chain_groupmean_plain(x.detach(), _group(ps), slope)
                else:
                    y_ref, _ = chain_groupmax_plain(x.detach(), _group(ps), slope)
                grads = torch.autograd.grad(y_ref, [ps[i] for i in want], dy)
            for i, gr in zip(want, grads):
                dflat[i] = gr
        return (dx, None, None, *dflat)


def mlp_chain_groupmax(x: torch.Tensor, layers: Sequence[Layer], slope: float = 0.0) -> torch.Tensor:
    """Max over each group's rows of an L-layer chain, ``act`` between the
    layers and none after the last: ``x [B, G, K, C0] -> [B, G, C_L]``
    f32; see the module docstring."""
    return GroupChain.apply(x, float(slope), False, *[t for layer in layers for t in layer])


def mlp_chain_groupmean(x: torch.Tensor, layers: Sequence[Layer], slope: float = 0.0) -> torch.Tensor:
    """Mean over each group's rows of an L-layer chain with every layer
    activated: ``x [B, G, K, C0] -> [B, G, C_L]`` f32; see the module
    docstring."""
    return GroupChain.apply(x, float(slope), True, *[t for layer in layers for t in layer])
