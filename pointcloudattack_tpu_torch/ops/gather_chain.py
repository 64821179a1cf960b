"""Neighbour gather + per-point Dense -> eval-BN -> activation chain + a max
or a mean over each group's neighbours; and the max over radius balls.

Counterpart of ``pointcloudattack_tpu/ops/pallas/gather_chain_kernel.py``
(``gather_chain_groupmax``, ``gather_chain_groupmean``,
``ball_gather_chain_groupmax`` and their custom VJPs).  For ``src [B, N,
Cs]``, ``centers [B, G, Cc]`` and ``idx [B, G, K]``, each group's ``K``
rows are built from ``layout``, a tuple of segments taken in order:

    ("diff", lo, hi, ctr_lo)   src[idx, lo:hi] - centers[g, ctr_lo:ctr_lo+w]
    ("pass", lo, hi)           src[idx, lo:hi]
    ("center", lo, hi)         centers[g, lo:hi] on every row

then, with ``pre_act``, put through the activation ``max(z, slope * z)``
(ReLU at ``slope`` 0, LeakyReLU otherwise), and run through the chain of
``ops/chain_maxpool.py`` (``layers`` as there) with that activation
between layers.  The max pool applies none after the last layer and gives
``y [B, G, C_L]``, the max over the ``K`` rows, with ``am [B, G, C_L]``
int32, the lowest ``k`` attaining it.  The mean pool activates every
layer and gives ``y``, the sum of each group's rows in ascending ``k``
divided by ``K``.  The ball route takes ``xyz [B, N, 3]``, a radius and
``nsample`` in place of ``idx``: its slots are ``query_ball_point``'s
(``ops/ball_query.py``) around ``centers[..., :3]``, returned as ``idx``.
On a CUDA tensor it runs ``ops/ball_hoist.py`` (the first layer once a
point, the rest on the tensor cores, a backward over the winning rows
without atomics), which counts its own launches; on a CPU tensor the
plain versions below, the index route's on the same slots.  The ``[B, G,
K, C]`` rows never exist on the card: the index route's kernel
(``csrc/gather_chain.cu``) builds them in shared memory.  The index
route's max of one layer with no ``pre_act`` (DGCNN's EdgeConvs,
CurveNet's initial LPFA) runs the layer once a point instead, and its
backward without atomics: ``ops/gather_hoist.py``, which counts its own
launches.

On a CUDA tensor the forwards and the input gradients run the kernels; on
a CPU tensor they run the plain PyTorch versions below.  A CUDA tensor the
kernels do not take raises: nothing falls back.  ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from pointcloudattack_tpu_torch.ops import _build, ball_hoist, gather_hoist
from pointcloudattack_tpu_torch.ops.ball_query import query_ball_point
from pointcloudattack_tpu_torch.ops.chain_maxpool import Layer, _group, _ptr_array, act, act_bwd
from pointcloudattack_tpu_torch.ops.gather import index_points
from pointcloudattack_tpu_torch.ops.pairwise import sum_neighbours

Layout = tuple  # of ("diff", lo, hi, ctr_lo) | ("pass", lo, hi) | ("center", lo, hi)

_KINDS = {"diff": 0, "pass": 1, "center": 2}

# Kernel launches since the last reset, by route and direction: the index
# route's max of two or more layers or with pre_act ("fwd", "bwd") and its
# mean ("mean_fwd", "mean_bwd").  Bumped only where a kernel is launched,
# never by the plain versions.
LAUNCHES = {"fwd": 0, "bwd": 0, "mean_fwd": 0, "mean_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def layout_width(layout: Layout) -> int:
    """The width ``C0`` of the rows ``layout`` builds."""
    return sum(s[2] - s[1] for s in layout)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the reference the kernel is held to)
# ---------------------------------------------------------------------------


def gather_rows(src, centers, idx, layout: Layout) -> torch.Tensor:
    """The grouped rows ``[B, G, K, C0]`` (f32) that ``layout`` builds."""
    nbr = index_points(src.float(), idx)  # [B, G, K, Cs]
    segs = []
    for s in layout:
        w = s[2] - s[1]
        if s[0] == "diff":
            segs.append(nbr[..., s[1] : s[2]] - centers.float()[:, :, None, s[3] : s[3] + w])
        elif s[0] == "pass":
            segs.append(nbr[..., s[1] : s[2]])
        elif s[0] == "center":
            segs.append(centers.float()[:, :, None, s[1] : s[2]].expand(nbr.shape[:3] + (w,)))
        else:
            raise ValueError(f"unknown layout segment {s!r}")
    return torch.cat(segs, dim=-1)


def chain_input(src, centers, idx, layout: Layout, slope: float = 0.0, pre_act: bool = False) -> torch.Tensor:
    """The rows the chain takes: ``gather_rows``, through the activation
    with ``pre_act``."""
    rows = gather_rows(src, centers, idx, layout)
    return act(rows, slope) if pre_act else rows


def _chain(rows: torch.Tensor, layers: Sequence[Layer], slope: float = 0.0):
    """The chain's last pre-activation ``z`` and the hidden activated maps."""
    z, hs = rows, []
    for i, (w, b, mean, mul, beta) in enumerate(layers):
        if i:
            z = act(z, slope)
            hs.append(z)
        z = (z @ w + b - mean) * mul + beta
    return z, hs


def gather_chain_plain(src, centers, idx, layers: Sequence[Layer], layout: Layout, slope: float = 0.0,
                       pre_act: bool = False):
    """Plain max forward: ``(y [B, G, C_L] f32, am [B, G, C_L] int32)``.

    ``y`` is ``amax`` over the rows, so autograd through it splits a tie's
    gradient evenly, as ``jnp.max`` does; ``am`` takes the lowest row.
    """
    z, _ = _chain(chain_input(src, centers, idx, layout, slope, pre_act), layers, slope)  # [B, G, K, C_L]
    y = z.amax(dim=2)
    k = z.shape[2]
    rows = torch.arange(k, device=z.device, dtype=torch.int32)[:, None]
    big = torch.full((), k, device=z.device, dtype=torch.int32)
    am = torch.where(z == y[:, :, None, :], rows, big).amin(dim=2)
    return y, am


def gather_chain_mean_plain(src, centers, idx, layers: Sequence[Layer], layout: Layout, slope: float = 0.0,
                            pre_act: bool = False) -> torch.Tensor:
    """Plain mean forward ``y [B, G, C_L]``: every layer activated, each
    group's rows summed in ascending ``k``, then divided by ``K``."""
    z, _ = _chain(chain_input(src, centers, idx, layout, slope, pre_act), layers, slope)
    return sum_neighbours(act(z, slope)) / idx.shape[2]


def ball_gather_chain_plain(src, centers, xyz, layers: Sequence[Layer], layout: Layout, radius: float,
                            nsample: int, slope: float = 0.0):
    """Plain ball-route forward: ``query_ball_point`` around ``centers[...,
    :3]``, then ``gather_chain_plain``: ``(y, am, idx [B, G, nsample]
    int32)``."""
    idx = query_ball_point(radius, nsample, xyz, centers[..., :3])
    y, am = gather_chain_plain(src, centers, idx, layers, layout, slope)
    return y, am, idx


def _back(c, rows, hs, layers, slope: float, pre_act: bool) -> torch.Tensor:
    """The row cotangent ``[B, G, K, C0]`` from ``c``, the cotangent at the
    last layer's matmul output: through the layers and the hidden maps'
    masks, and with ``pre_act`` the rows' own."""
    dh = c @ layers[-1][0].float().t()
    for i in range(len(layers) - 2, -1, -1):
        c = act_bwd(dh, hs[i], slope) * layers[i][3]
        dh = c @ layers[i][0].float().t()
    return act_bwd(dh, rows, slope) if pre_act else dh


def _split(dh, src, centers, idx, layout: Layout):
    """Split the row cotangent by the layout: diff and pass columns scatter
    into ``dsrc`` by ``idx``, center columns sum over the rows into
    ``dctr``, diff columns too, with a minus sign."""
    b, n, cs = src.shape
    dsrc = torch.zeros((b * n, cs), dtype=torch.float32, device=src.device)
    dctr = torch.zeros(centers.shape, dtype=torch.float32, device=src.device)
    flat = (idx.long() + torch.arange(b, device=src.device)[:, None, None] * n).reshape(-1)
    off = 0
    for s in layout:
        w = s[2] - s[1]
        part = dh[..., off : off + w]
        if s[0] in ("diff", "pass"):
            dsrc[:, s[1] : s[2]].index_add_(0, flat, part.reshape(-1, w))
        if s[0] == "diff":
            dctr[..., s[3] : s[3] + w] -= part.sum(dim=2)
        elif s[0] == "center":
            dctr[..., s[1] : s[2]] += part.sum(dim=2)
        off += w
    return dsrc.view(b, n, cs), dctr


def gather_chain_bwd_plain(src, centers, idx, layers: Sequence[Layer], layout: Layout, am, g, slope: float = 0.0,
                           pre_act: bool = False):
    """Plain input gradients ``(dsrc [B, N, Cs], dctr [B, G, Cc])`` of the
    max for ``g = dy * mul_L``.

    As ``_gather_bwd_kernel`` does: recompute the rows and the masks, put
    ``g[b, g, c]`` on row ``am[b, g, c]`` of the last layer's matmul
    output, run back through the layers (and the rows' activation with
    ``pre_act``), and split the row cotangent by the layout (``_split``).
    """
    with torch.no_grad():
        rows = gather_rows(src, centers, idx, layout)
        _, hs = _chain(act(rows, slope) if pre_act else rows, layers, slope)
        k = rows.shape[2]
        hit = am.long()[:, :, None, :] == torch.arange(k, device=rows.device)[:, None]
        c = torch.where(hit, g.float()[:, :, None, :], 0.0)  # [B, G, K, C_L]
        return _split(_back(c, rows, hs, layers, slope, pre_act), src, centers, idx, layout)


def gather_chain_mean_bwd_plain(src, centers, idx, layers: Sequence[Layer], layout: Layout, g, slope: float = 0.0,
                                pre_act: bool = False):
    """Plain input gradients ``(dsrc, dctr)`` of the mean for ``g = dy *
    mul_L / K``, as ``_gather_bwd_kernel`` does with ``pool="mean"``: ``g``
    on every row of its group, through the last layer's activation, then
    back as the max's."""
    with torch.no_grad():
        rows = gather_rows(src, centers, idx, layout)
        z, hs = _chain(act(rows, slope) if pre_act else rows, layers, slope)
        c = act_bwd(g.float()[:, :, None, :].expand(z.shape), z, slope)
        return _split(_back(c, rows, hs, layers, slope, pre_act), src, centers, idx, layout)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

MAX_MEAN_K = 64  # the mean takes whole groups: K rows in one tile of 8 * TM, TM <= 8


def _check_cuda(src, centers, idx, layers, layout, slope, k) -> list[int]:
    """Validate what the kernel takes; returns dims [C0, C1, ..., C_L]."""
    named = [("src", src, torch.float32, 3), ("centers", centers, torch.float32, 3), ("idx", idx, torch.int32, 3)]
    for name, t, dt, rank in named:
        if t.dtype != dt or t.dim() != rank or not t.is_contiguous() or t.device != src.device:
            raise ValueError(
                f"gather_chain kernel takes a contiguous {dt} {name} of rank {rank} on "
                f"{src.device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"contiguous={t.is_contiguous()}"
            )
    b, g = centers.shape[:2]
    if src.shape[0] != b or tuple(idx.shape) != (b, g, k) or k < 1:
        raise ValueError(f"gather_chain: src {tuple(src.shape)}, centers {tuple(centers.shape)} and "
                         f"idx {tuple(idx.shape)} (K={k}) disagree")
    if not 0.0 <= slope <= 1.0:
        raise ValueError(f"gather_chain kernel takes a slope in [0, 1], got {slope}")
    if not 1 <= len(layout) <= 4:
        raise ValueError(f"gather_chain kernel takes 1-4 layout segments, got {layout!r}")
    if not 1 <= len(layers) <= 4:
        raise ValueError(f"gather_chain kernel takes 1-4 layers, got {len(layers)}")
    dims = [layout_width(layout)]
    for i, (w, *vecs) in enumerate(layers):
        if w.dim() != 2 or w.shape[0] != dims[-1]:
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} does not take width {dims[-1]}")
        dims.append(w.shape[1])
        for t in (w, *vecs):
            if t.device != src.device or t.dtype != torch.float32:
                raise ValueError(f"layer {i}: parameters must be float32 on {src.device}, "
                                 f"got {t.dtype} on {t.device}")
        if not all(v.is_contiguous() and tuple(v.shape) == (dims[-1],) for v in vecs):
            raise ValueError(f"layer {i}: b, mean, mul and beta must be contiguous ({dims[-1]},)")
    if max(dims[:-1]) > 1024:
        raise ValueError(f"gather_chain kernel takes widths <= 1024, got {dims}")
    return dims


def _layout_array(layout: Layout):
    flat = []
    for s in layout:
        flat += [_KINDS[s[0]], s[1], s[2], s[3] if s[0] == "diff" else 0]
    return (ctypes.c_int * len(flat))(*flat)


def _pick_tm(lib, dims_arr, num_layers: int, k: int, bwd: bool, mean: bool = False) -> int:
    """Rows per thread: the largest whose shared memory fits one block and
    whose tile keeps each warp's rows in one group (for the mean, a whole
    group in one tile)."""
    cap = lib.pca_chain_max_smem()
    for tm in (8, 4, 2):
        if (k <= 8 * tm and k % tm) or (mean and k > 8 * tm):
            continue
        if lib.pca_gather_smem(num_layers, ctypes.cast(dims_arr, ctypes.c_void_p), k, tm, int(bwd),
                               int(mean)) <= cap:
            return tm
    raise ValueError(f"gather_chain kernel: no tile takes K={k} with these widths"
                     + (f" (the mean takes K <= {MAX_MEAN_K}, an even K)" if mean else ""))


def _chunks(k: int, tm: int) -> int:
    """Tiles per group: a group of K > 8*tm rows spans several."""
    return -(-k // (8 * tm)) if k > 8 * tm else 1


def _common(src, centers, idx, layers, layout, slope, k, bwd, mean=False):
    dims = _check_cuda(src, centers, idx, layers, layout, slope, k)
    lib = _build.load_library()
    dims_arr = (ctypes.c_int * len(dims))(*dims)
    tm = _pick_tm(lib, dims_arr, len(layers), k, bwd, mean)
    ws = [layer[0].contiguous() for layer in layers]
    params = _ptr_array([t for w, layer in zip(ws, layers) for t in (w, *layer[1:])])
    b, n, cs = src.shape
    g = centers.shape[1]
    seg = _layout_array(layout)
    shape = (b, n, g, k, cs, centers.shape[2], len(layout), ctypes.cast(seg, ctypes.c_void_p),
             len(layers), ctypes.cast(dims_arr, ctypes.c_void_p), ctypes.cast(params, ctypes.c_void_p))
    # the caller holds the ctypes arrays (and ws) until the launch returns
    return lib, dims, tm, shape, (seg, dims_arr, params, ws)


def _outputs(b, g, k, cl, tm, mean, device):
    """y, am and the chunk partials of a forward."""
    chunks = 1 if mean else _chunks(k, tm)
    kw = dict(device=device)
    y = torch.empty((b, g, cl), dtype=torch.float32, **kw)
    am = torch.empty((b, g, cl) if not mean else (1,), dtype=torch.int32, **kw)
    part_v = torch.empty((b, g, chunks, cl) if chunks > 1 else (1,), dtype=torch.float32, **kw)
    part_i = torch.empty((b, g, chunks, cl) if chunks > 1 else (1,), dtype=torch.int32, **kw)
    return y, am, part_v, part_i


def _fwd_kernel(src, centers, idx, layers, layout, slope: float = 0.0, pre_act: bool = False, mean: bool = False):
    if not mean and gather_hoist.takes(layers, pre_act):
        raise ValueError("gather_chain: a one-layer max without pre_act runs gather_hoist, not the row kernel")
    k = idx.shape[2]
    lib, dims, tm, shape, keep = _common(src, centers, idx, layers, layout, slope, k, False, mean)
    y, am, part_v, part_i = _outputs(idx.shape[0], idx.shape[1], k, dims[-1], tm, mean, src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = lib.pca_gather_fwd(src.device.index, src.data_ptr(), centers.data_ptr(), idx.data_ptr(), *shape,
                                float(slope), int(pre_act), int(mean), part_v.data_ptr(), part_i.data_ptr(),
                                y.data_ptr(), am.data_ptr(), tm, stream)
    kind = "mean_fwd" if mean else "fwd"
    _build.check(lib, rc, f"gather_chain {kind} launch")
    LAUNCHES[kind] += 1
    return y if mean else (y, am)


def _bwd_kernel(src, centers, idx, layers, layout, am, g, wts=None, slope: float = 0.0, pre_act: bool = False,
                mean: bool = False):
    if not mean and gather_hoist.takes(layers, pre_act):
        raise ValueError("gather_chain: a one-layer max without pre_act runs gather_hoist, not the row kernel")
    k = idx.shape[2]
    lib, dims, tm, shape, keep = _common(src, centers, idx, layers, layout, slope, k, True, mean)
    b, ng, _ = idx.shape
    checks = [("g", g, torch.float32)] + ([] if mean else [("am", am, torch.int32)])
    for name, t, dt in checks:
        if (t.device != src.device or t.dtype != dt or not t.is_contiguous()
                or tuple(t.shape) != (b, ng, dims[-1])):
            raise ValueError(f"gather_chain backward: {name} must be contiguous {dt} "
                             f"[{b}, {ng}, {dims[-1]}] on {src.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if wts is None:
        wts = [layer[0].t() for layer in layers]
    wts = [wt.contiguous() for wt in wts]
    if [tuple(wt.shape) for wt in wts] != [(layer[0].shape[1], layer[0].shape[0]) for layer in layers]:
        raise ValueError("gather_chain backward: wts must be the layers' W^T")
    wt_arr = _ptr_array(wts)
    cc = centers.shape[2]
    chunks = _chunks(k, tm)
    kw = dict(device=src.device, dtype=torch.float32)
    dsrc = torch.zeros(src.shape, **kw)
    dctr = torch.empty(centers.shape, **kw)
    dctr_part = torch.empty((b, ng, chunks, cc) if chunks > 1 else (1,), **kw)
    am_ptr = g.data_ptr() if mean else am.data_ptr()  # unread by the mean
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = lib.pca_gather_bwd(src.device.index, src.data_ptr(), centers.data_ptr(), idx.data_ptr(), *shape,
                                ctypes.cast(wt_arr, ctypes.c_void_p), float(slope), int(pre_act), int(mean), am_ptr,
                                g.data_ptr(), dsrc.data_ptr(), dctr_part.data_ptr(), dctr.data_ptr(), tm, stream)
    kind = "mean_bwd" if mean else "bwd"
    _build.check(lib, rc, f"gather_chain {kind} launch")
    LAUNCHES[kind] += 1
    return dsrc, dctr


def _no_device(src):
    return ValueError(f"gather_chain: no implementation for device {src.device}")


def gather_chain_fwd(src, centers, idx, layers, layout: Layout, slope: float = 0.0, pre_act: bool = False):
    """The max forward ``(y, am)``: the kernels for CUDA tensors (one layer
    without ``pre_act``: ``gather_hoist``'s), the plain version for CPU
    tensors."""
    if src.is_cuda:
        if gather_hoist.takes(layers, pre_act):
            return gather_hoist.hoisted_fwd(src, centers, idx, layers[0], layout)
        return _fwd_kernel(src, centers, idx, layers, layout, slope, pre_act)
    if src.device.type == "cpu":
        return gather_chain_plain(src, centers, idx, layers, layout, slope, pre_act)
    raise _no_device(src)


def gather_chain_bwd(src, centers, idx, layers, layout: Layout, am, g, wts=None, slope: float = 0.0,
                     pre_act: bool = False):
    """``(dsrc, dctr)`` of the max for ``g = dy * mul_L``: the kernels for
    CUDA tensors (one layer without ``pre_act``: ``gather_hoist``'s, on any
    route; else the row kernel), the
    plain version for CPU tensors.  ``wts``, the layers' ``W^T [out, in]``,
    spares the row kernel a transposed copy when the caller holds them."""
    if src.is_cuda:
        if gather_hoist.takes(layers, pre_act):
            return gather_hoist.hoisted_bwd(src, centers, idx, layers[0], layout, am, g)
        return _bwd_kernel(src, centers, idx, layers, layout, am, g, wts, slope, pre_act, False)
    if src.device.type == "cpu":
        return gather_chain_bwd_plain(src, centers, idx, layers, layout, am, g, slope, pre_act)
    raise _no_device(src)


def gather_chain_mean_fwd(src, centers, idx, layers, layout: Layout, slope: float = 0.0, pre_act: bool = False):
    """The mean forward ``y``: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if src.is_cuda:
        return _fwd_kernel(src, centers, idx, layers, layout, slope, pre_act, mean=True)
    if src.device.type == "cpu":
        return gather_chain_mean_plain(src, centers, idx, layers, layout, slope, pre_act)
    raise _no_device(src)


def gather_chain_mean_bwd(src, centers, idx, layers, layout: Layout, g, wts=None, slope: float = 0.0,
                          pre_act: bool = False):
    """``(dsrc, dctr)`` of the mean for ``g = dy * mul_L / K``: the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if src.is_cuda:
        return _bwd_kernel(src, centers, idx, layers, layout, None, g, wts, slope, pre_act, True)
    if src.device.type == "cpu":
        return gather_chain_mean_bwd_plain(src, centers, idx, layers, layout, g, slope, pre_act)
    raise _no_device(src)


def ball_gather_chain_fwd(src, centers, xyz, layers, layout: Layout, radius: float, nsample: int,
                          slope: float = 0.0):
    """The ball route's forward ``(y, am, idx)``: ``ball_hoist``'s kernels
    for CUDA tensors, the plain version for CPU tensors."""
    if src.is_cuda:
        return ball_hoist.forward(src, centers, xyz, layers, layout, radius, nsample, slope)[:3]
    if src.device.type == "cpu":
        return ball_gather_chain_plain(src, centers, xyz, layers, layout, radius, nsample, slope)
    raise _no_device(src)


# ---------------------------------------------------------------------------
# Differentiable ops
# ---------------------------------------------------------------------------


def _layers(flat):
    """The layers of the flat parameters, each weight made contiguous."""
    return [(w.contiguous(), *layer[1:]) for w, layer in zip(flat[::5], _group(flat))]


def _save(ctx, mean, layout, slope, pre_act, first, src, centers, idx, am, layers, flat):
    """What the shared backward reads: the inputs, the selection, the argmax
    (None for the mean), the contiguous weights and the parameters, whose
    gradients start at input ``first``."""
    ctx.mean, ctx.layout, ctx.slope, ctx.pre_act, ctx.first = mean, layout, slope, pre_act, first
    ctx.save_for_backward(src, centers, idx, am, *[layer[0] for layer in layers], *flat)


def _backward(ctx, dy):
    """``(dsrc, dctr, dflat)``.  The input gradients come from the kernel (or
    the plain backward on the CPU); parameter gradients from autograd
    through the plain forward, and only when asked for, as the JAX VJP
    takes them from the unfused oracle."""
    src, centers, idx, am, *saved = ctx.saved_tensors
    nl = len(saved) // 6
    ws, flat = saved[:nl], saved[nl:]
    layout, slope, pre_act = ctx.layout, ctx.slope, ctx.pre_act
    dy = dy.float()
    dsrc = dctr = None
    if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
        layers = [(w, *layer[1:]) for w, layer in zip(ws, _group(flat))]
        wts = [w.t() for w in flat[::5]]
        g = dy * layers[-1][3]
        if ctx.mean:
            dsrc, dctr = gather_chain_mean_bwd(src, centers, idx, layers, layout, (g / idx.shape[2]).contiguous(),
                                               wts, slope, pre_act)
        else:
            dsrc, dctr = gather_chain_bwd(src, centers, idx, layers, layout, am, g.contiguous(), wts, slope,
                                          pre_act)
        dsrc = dsrc.to(src.dtype) if ctx.needs_input_grad[0] else None
        dctr = dctr.to(centers.dtype) if ctx.needs_input_grad[1] else None
    dflat = [None] * len(flat)
    want = [i for i, need in enumerate(ctx.needs_input_grad[ctx.first:]) if need]
    if want:
        with torch.enable_grad():
            ps = [p.detach().requires_grad_(i in want) for i, p in enumerate(flat)]
            args = (src.detach(), centers.detach(), idx, _group(ps), layout, slope, pre_act)
            y_ref = gather_chain_mean_plain(*args) if ctx.mean else gather_chain_plain(*args)[0]
            grads = torch.autograd.grad(y_ref, [ps[i] for i in want], dy)
        for i, gr in zip(want, grads):
            dflat[i] = gr
    return dsrc, dctr, dflat


class GatherChainMax(torch.autograd.Function):
    """y = max over each group's rows of the chain; ``idx`` takes no
    gradient."""

    @staticmethod
    def forward(ctx, src, centers, idx, layout, slope, *flat):
        src, centers, idx = src.contiguous(), centers.contiguous(), idx.contiguous()
        layers = _layers(flat)
        y, am = gather_chain_fwd(src, centers, idx, layers, layout, slope)
        _save(ctx, False, layout, slope, False, 5, src, centers, idx, am, layers, flat)
        return y

    @staticmethod
    def backward(ctx, dy):
        dsrc, dctr, dflat = _backward(ctx, dy)
        return (dsrc, dctr, None, None, None, *dflat)


class GatherChainMean(torch.autograd.Function):
    """y = mean over each group's rows of the chain (every layer activated,
    the rows too with ``pre_act``); ``idx`` takes no gradient."""

    @staticmethod
    def forward(ctx, src, centers, idx, layout, slope, pre_act, *flat):
        src, centers, idx = src.contiguous(), centers.contiguous(), idx.contiguous()
        layers = _layers(flat)
        y = gather_chain_mean_fwd(src, centers, idx, layers, layout, slope, pre_act)
        _save(ctx, True, layout, slope, pre_act, 6, src, centers, idx, None, layers, flat)
        return y

    @staticmethod
    def backward(ctx, dy):
        dsrc, dctr, dflat = _backward(ctx, dy)
        return (dsrc, dctr, None, None, None, None, *dflat)


class BallGatherChainMax(torch.autograd.Function):
    """y = max over each ball's rows of the chain, the slots chosen in the
    forward and kept for the backward; ``xyz`` takes no gradient, as ball
    membership is an integer selection (the JAX op gives it zeros).  On a
    CUDA tensor both directions run ``ball_hoist``'s kernels, the backward
    on the forward's picks and hidden signs; on a CPU tensor the plain
    versions.  Parameter gradients come from autograd through the plain
    forward, as ``_backward``'s."""

    @staticmethod
    def forward(ctx, src, centers, xyz, layout, radius, nsample, slope, *flat):
        src, centers, xyz = src.contiguous(), centers.contiguous(), xyz.detach().contiguous()
        layers = _group(flat)
        if src.is_cuda:
            y, am, idx, signs, folded = ball_hoist.forward(src, centers, xyz, layers, layout, radius, nsample, slope)
        elif src.device.type == "cpu":
            (y, am, idx), signs, folded = ball_gather_chain_plain(src, centers, xyz, layers, layout, radius, nsample,
                                                                  slope), None, (None, None)
        else:
            raise _no_device(src)
        ctx.layout, ctx.slope = layout, slope
        ctx.save_for_backward(src, centers, idx, am, signs, *folded, *flat)
        return y

    @staticmethod
    def backward(ctx, dy):
        src, centers, idx, am, signs, ws, wc, *flat = ctx.saved_tensors
        layout, slope = ctx.layout, ctx.slope
        layers = _group(flat)
        dsrc = dctr = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            g = (dy.float() * layers[-1][3]).contiguous()
            if src.is_cuda:
                dsrc, dctr = ball_hoist.hoisted_bwd(src, centers, idx, layers, layout, am, g, signs, slope, (ws, wc))
            else:
                dsrc, dctr = gather_chain_bwd_plain(src, centers, idx, layers, layout, am, g, slope)
            dsrc = dsrc.to(src.dtype) if ctx.needs_input_grad[0] else None
            dctr = dctr.to(centers.dtype) if ctx.needs_input_grad[1] else None
        dflat = [None] * len(flat)
        want = [i for i, need in enumerate(ctx.needs_input_grad[7:]) if need]
        if want:
            with torch.enable_grad():
                ps = [p.detach().requires_grad_(i in want) for i, p in enumerate(flat)]
                y_ref = gather_chain_plain(src.detach(), centers.detach(), idx, _group(ps), layout, slope)[0]
                grads = torch.autograd.grad(y_ref, [ps[i] for i in want], dy)
            for i, gr in zip(want, grads):
                dflat[i] = gr
        return (dsrc, dctr, None, None, None, None, None, *dflat)


def _flat(layers):
    return [t for layer in layers for t in layer]


def gather_chain_groupmax(src, centers, idx, layers: Sequence[Layer], layout: Layout,
                          slope: float = 0.0) -> torch.Tensor:
    """Gather + L-layer chain + max over each group's neighbours, ``act``
    between the layers: ``src [B, N, Cs]``, ``centers [B, G, Cc]``, ``idx
    [B, G, K]`` -> ``[B, G, C_L]`` f32; see the module docstring."""
    layout = tuple(tuple(s) for s in layout)
    return GatherChainMax.apply(src, centers, idx.to(torch.int32), layout, float(slope), *_flat(layers))


def gather_chain_groupmean(src, centers, idx, layers: Sequence[Layer], layout: Layout, slope: float = 0.0,
                           pre_act: bool = False) -> torch.Tensor:
    """Gather (+ the rows' activation with ``pre_act``) + L-layer chain with
    every layer activated + mean over each group's neighbours: ``[B, G,
    C_L]`` f32; see the module docstring."""
    layout = tuple(tuple(s) for s in layout)
    return GatherChainMean.apply(src, centers, idx.to(torch.int32), layout, float(slope), bool(pre_act),
                                 *_flat(layers))


def ball_gather_chain_groupmax(src, centers, xyz, layers: Sequence[Layer], layout: Layout, radius: float,
                               nsample: int, slope: float = 0.0) -> torch.Tensor:
    """Ball query + gather + L-layer chain + max: the fused twin of
    ``query_ball_point(radius, nsample, xyz, centers[..., :3])`` followed by
    ``gather_chain_groupmax``.  ``src [B, N, Cs]``, ``centers [B, G, Cc]``
    (Cc >= 3), ``xyz [B, N, 3]`` -> ``[B, G, C_L]`` f32."""
    layout = tuple(tuple(s) for s in layout)
    return BallGatherChainMax.apply(src, centers, xyz, layout, float(radius), int(nsample), float(slope),
                                    *_flat(layers))
