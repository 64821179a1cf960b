"""Neighbour gather + per-point Dense -> eval-BN (-> ReLU) chain + max over
each group's neighbours.

Counterpart of ``pointcloudattack_tpu/ops/pallas/gather_chain_kernel.py``
(``gather_chain_groupmax`` and its custom VJP).  For ``src [B, N, Cs]``,
``centers [B, G, Cc]`` and ``idx [B, G, K]``, each group's ``K`` rows are
built from ``layout``, a tuple of segments taken in order:

    ("diff", lo, hi, ctr_lo)   src[idx, lo:hi] - centers[g, ctr_lo:ctr_lo+w]
    ("pass", lo, hi)           src[idx, lo:hi]
    ("center", lo, hi)         centers[g, lo:hi] on every row

then run through the chain of ``ops/chain_maxpool.py`` (``layers`` as
there: ReLU between layers, none after the last), and the output is
``y [B, G, C_L]``, the max over the ``K`` rows, with ``am [B, G, C_L]``
int32, the lowest ``k`` attaining it.  The ``[B, G, K, C]`` rows never
exist on the card: the kernel (``csrc/gather_chain.cu``) builds them in
shared memory.

On a CUDA tensor the forward and the input gradients run the kernel; on a
CPU tensor they run the plain PyTorch versions below.  A CUDA tensor the
kernel does not take raises: nothing falls back.  ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from pointcloudattack_tpu_torch.ops import _build
from pointcloudattack_tpu_torch.ops.chain_maxpool import Layer, _group, _ptr_array
from pointcloudattack_tpu_torch.ops.gather import index_points

Layout = tuple  # of ("diff", lo, hi, ctr_lo) | ("pass", lo, hi) | ("center", lo, hi)

_KINDS = {"diff": 0, "pass": 1, "center": 2}

# Kernel launches since the last reset, by direction.  Bumped only where a
# kernel is launched, never by the plain versions.
LAUNCHES = {"fwd": 0, "bwd": 0}


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


def _chain(rows: torch.Tensor, layers: Sequence[Layer]):
    """The chain's last pre-activation ``z`` and the hidden post-ReLU maps."""
    z, hs = rows, []
    for i, (w, b, mean, mul, beta) in enumerate(layers):
        if i:
            z = torch.relu(z)
            hs.append(z)
        z = (z @ w + b - mean) * mul + beta
    return z, hs


def gather_chain_plain(src, centers, idx, layers: Sequence[Layer], layout: Layout):
    """Plain forward: ``(y [B, G, C_L] f32, am [B, G, C_L] int32)``.

    ``y`` is ``amax`` over the rows, so autograd through it splits a tie's
    gradient evenly, as ``jnp.max`` does; ``am`` takes the lowest row.
    """
    z, _ = _chain(gather_rows(src, centers, idx, layout), layers)  # [B, G, K, C_L]
    y = z.amax(dim=2)
    k = z.shape[2]
    rows = torch.arange(k, device=z.device, dtype=torch.int32)[:, None]
    big = torch.full((), k, device=z.device, dtype=torch.int32)
    am = torch.where(z == y[:, :, None, :], rows, big).amin(dim=2)
    return y, am


def gather_chain_bwd_plain(src, centers, idx, layers: Sequence[Layer], layout: Layout, am, g):
    """Plain input gradients ``(dsrc [B, N, Cs], dctr [B, G, Cc])`` for
    ``g = dy * mul_L``.

    As ``_gather_bwd_kernel`` does: recompute the rows and the masks, put
    ``g[b, g, c]`` on row ``am[b, g, c]`` of the last layer's matmul
    output, run back through the layers, and split the row cotangent by
    the layout: diff and pass columns scatter into ``dsrc`` by ``idx``,
    center columns sum over the rows into ``dctr``, diff columns too, with
    a minus sign.
    """
    with torch.no_grad():
        rows = gather_rows(src, centers, idx, layout)
        _, hs = _chain(rows, layers)
        k = rows.shape[2]
        hit = am.long()[:, :, None, :] == torch.arange(k, device=rows.device)[:, None]
        c = torch.where(hit, g.float()[:, :, None, :], 0.0)  # [B, G, K, C_L]
        dh = c @ layers[-1][0].float().t()
        for i in range(len(layers) - 2, -1, -1):
            c = torch.where(hs[i] > 0, dh, 0.0) * layers[i][3]
            dh = c @ layers[i][0].float().t()
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


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda(src, centers, idx, layers, layout) -> list[int]:
    """Validate what the kernel takes; returns dims [C0, C1, ..., C_L]."""
    for name, t, dt, rank in (("src", src, torch.float32, 3), ("centers", centers, torch.float32, 3),
                              ("idx", idx, torch.int32, 3)):
        if t.dtype != dt or t.dim() != rank or not t.is_contiguous() or t.device != src.device:
            raise ValueError(
                f"gather_chain kernel takes a contiguous {dt} {name} of rank {rank} on "
                f"{src.device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"contiguous={t.is_contiguous()}"
            )
    b, g, k = idx.shape
    if centers.shape[:2] != (b, g) or src.shape[0] != b:
        raise ValueError(f"gather_chain: src {tuple(src.shape)}, centers {tuple(centers.shape)} "
                         f"and idx {tuple(idx.shape)} disagree")
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


def _pick_tm(lib, dims_arr, num_layers: int, k: int, bwd: bool) -> int:
    """Rows per thread: the largest whose shared memory fits one block and
    whose tile keeps each warp's rows in one group."""
    cap = lib.pca_chain_max_smem()
    for tm in (8, 4, 2):
        if k <= 8 * tm and k % tm:
            continue
        if lib.pca_gather_smem(num_layers, ctypes.cast(dims_arr, ctypes.c_void_p), k, tm, int(bwd)) <= cap:
            return tm
    raise ValueError(f"gather_chain kernel: no tile takes K={k} with these widths")


def _chunks(k: int, tm: int) -> int:
    """Tiles per group: a group of K > 8*tm rows spans several."""
    return -(-k // (8 * tm)) if k > 8 * tm else 1


def _common(src, centers, idx, layers, layout, bwd):
    dims = _check_cuda(src, centers, idx, layers, layout)
    lib = _build.load_library()
    dims_arr = (ctypes.c_int * len(dims))(*dims)
    k = idx.shape[2]
    tm = _pick_tm(lib, dims_arr, len(layers), k, bwd)
    ws = [layer[0].contiguous() for layer in layers]
    params = _ptr_array([t for w, layer in zip(ws, layers) for t in (w, *layer[1:])])
    b, n, cs = src.shape
    _, g, _ = idx.shape
    seg = _layout_array(layout)
    head = (src.device.index, src.data_ptr(), centers.data_ptr(), idx.data_ptr(), b, n, g, k,
            cs, centers.shape[2], len(layout), ctypes.cast(seg, ctypes.c_void_p),
            len(layers), ctypes.cast(dims_arr, ctypes.c_void_p), ctypes.cast(params, ctypes.c_void_p))
    # the caller holds the ctypes arrays (and ws) until the launch returns
    return lib, dims, tm, head, (seg, dims_arr, params, ws)


def _fwd_kernel(src, centers, idx, layers, layout):
    lib, dims, tm, head, keep = _common(src, centers, idx, layers, layout, bwd=False)
    b, g, k = idx.shape
    cl = dims[-1]
    chunks = _chunks(k, tm)
    kw = dict(device=src.device)
    y = torch.empty((b, g, cl), dtype=torch.float32, **kw)
    am = torch.empty((b, g, cl), dtype=torch.int32, **kw)
    part_v = torch.empty((b, g, chunks, cl) if chunks > 1 else (1,), dtype=torch.float32, **kw)
    part_i = torch.empty((b, g, chunks, cl) if chunks > 1 else (1,), dtype=torch.int32, **kw)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = lib.pca_gather_fwd(*head, part_v.data_ptr(), part_i.data_ptr(), y.data_ptr(),
                                am.data_ptr(), tm, stream)
    _build.check(lib, rc, "gather_chain forward launch")
    LAUNCHES["fwd"] += 1
    return y, am


def _bwd_kernel(src, centers, idx, layers, layout, am, g, wts=None):
    lib, dims, tm, head, keep = _common(src, centers, idx, layers, layout, bwd=True)
    b, ng, k = idx.shape
    for name, t, dt in (("am", am, torch.int32), ("g", g, torch.float32)):
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
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = lib.pca_gather_bwd(*head, ctypes.cast(wt_arr, ctypes.c_void_p), am.data_ptr(),
                                g.data_ptr(), dsrc.data_ptr(), dctr_part.data_ptr(),
                                dctr.data_ptr(), tm, stream)
    _build.check(lib, rc, "gather_chain backward launch")
    LAUNCHES["bwd"] += 1
    return dsrc, dctr


def gather_chain_fwd(src, centers, idx, layers, layout: Layout):
    """``(y, am)``: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if src.is_cuda:
        return _fwd_kernel(src, centers, idx, layers, layout)
    if src.device.type == "cpu":
        return gather_chain_plain(src, centers, idx, layers, layout)
    raise ValueError(f"gather_chain: no implementation for device {src.device}")


def gather_chain_bwd(src, centers, idx, layers, layout: Layout, am, g, wts=None):
    """``(dsrc, dctr)`` for ``g = dy * mul_L``: the kernel for CUDA tensors,
    the plain version for CPU tensors.  ``wts``, the layers' ``W^T [out,
    in]``, spares the kernel a transposed copy when the caller holds them."""
    if src.is_cuda:
        return _bwd_kernel(src, centers, idx, layers, layout, am, g, wts)
    if src.device.type == "cpu":
        return gather_chain_bwd_plain(src, centers, idx, layers, layout, am, g)
    raise ValueError(f"gather_chain: no implementation for device {src.device}")


# ---------------------------------------------------------------------------
# Differentiable op
# ---------------------------------------------------------------------------


class GatherChainMax(torch.autograd.Function):
    """y = max over each group's rows of the chain.  The backward's ``dsrc``
    and ``dctr`` come from the kernel (or the plain backward on the CPU);
    ``idx`` takes no gradient.  Parameter gradients come from autograd
    through the plain forward, and only when asked for, as the JAX VJP
    takes them from the unfused reference."""

    @staticmethod
    def forward(ctx, src, centers, idx, layout, *flat):
        ws = [w.contiguous() for w in flat[::5]]
        layers = [(w, *layer[1:]) for w, layer in zip(ws, _group(flat))]
        src, centers, idx = src.contiguous(), centers.contiguous(), idx.contiguous()
        y, am = gather_chain_fwd(src, centers, idx, layers, layout)
        ctx.layout = layout
        ctx.save_for_backward(src, centers, idx, am, *ws, *flat)
        return y

    @staticmethod
    def backward(ctx, dy):
        src, centers, idx, am, *saved = ctx.saved_tensors
        nl = len(saved) // 6
        ws, flat = saved[:nl], saved[nl:]
        layout = ctx.layout
        dsrc = dctr = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            layers = [(w, *layer[1:]) for w, layer in zip(ws, _group(flat))]
            g = (dy.float() * layers[-1][3]).contiguous()
            wts = [w.t() for w in flat[::5]]
            dsrc, dctr = gather_chain_bwd(src, centers, idx, layers, layout, am, g, wts)
            dsrc = dsrc.to(src.dtype) if ctx.needs_input_grad[0] else None
            dctr = dctr.to(centers.dtype) if ctx.needs_input_grad[1] else None
        dflat = [None] * len(flat)
        want = [i for i, need in enumerate(ctx.needs_input_grad[4:]) if need]
        if want:
            with torch.enable_grad():
                ps = [p.detach().requires_grad_(i in want) for i, p in enumerate(flat)]
                y_ref, _ = gather_chain_plain(src.detach(), centers.detach(), idx, _group(ps), layout)
                grads = torch.autograd.grad(y_ref, [ps[i] for i in want], dy)
            for i, gr in zip(want, grads):
                dflat[i] = gr
        return (dsrc, dctr, None, None, *dflat)


def gather_chain_groupmax(src, centers, idx, layers: Sequence[Layer], layout: Layout) -> torch.Tensor:
    """Gather + L-layer chain + max over each group's neighbours.

    ``src [B, N, Cs]``, ``centers [B, G, Cc]``, ``idx [B, G, K]`` ->
    ``[B, G, C_L]`` f32; see the module docstring.
    """
    layout = tuple(tuple(s) for s in layout)
    return GatherChainMax.apply(src, centers, idx.to(torch.int32), layout,
                                *[t for layer in layers for t in layer])
