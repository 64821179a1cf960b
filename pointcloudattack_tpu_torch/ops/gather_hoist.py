"""Gather + one-layer chain + max over each group's neighbours, with the
layer run once a point and a backward without atomics.

The route of ``ops/gather_chain.py``'s max for a chain of one layer with
no activation on the built rows (DGCNN's EdgeConvs, CurveNet's initial
LPFA) on a CUDA tensor; the counterpart there of
``pointcloudattack_tpu/ops/pallas/gather_chain_kernel.py``'s
``_gather_fwd_pallas`` and ``_gather_bwd_pallas``.  The layer is affine
in the built row, and each of the row's segments is a slice of one source
point's features, of one center's, or their difference, so with
``W_src, W_ctr = split_weight(w, layout, Cs, Cc)``

    row(i, k) @ w = P[idx[i, k]] + Q[i],  P = src @ W_src,  Q = centers @ W_ctr

and the op is ``y[b, i, c] = max_k BN(P[b, idx[b, i, k], c] + Q[b, i,
c])`` with ``am`` the lowest ``k`` attaining it.  Its input gradients for
``g = dy * mul`` are ``dsrc = dP @ W_src^T`` and ``dctr = g @ W_ctr^T``,
where ``dP[b, j]`` sums ``g[b, i, c]`` over the entries ``(i, k)`` of
``j``'s reverse neighbour list (``idx[b, i, k] = j``, ascending) with
``am[b, i, c] == k``, in the list's order; a list holds each pair as
``(i << s) | k``, ``s = key_bits(K)``.  Five launches in all, each a
kernel of ``csrc/gather_hoist.cu``:

    forward   product (P and Q; one product of width 2 * C1 when the
              sources are the centers), max
    backward  lists, pull, product (dsrc and dctr)

Each wrapper runs its kernel on a CUDA tensor (counted in ``LAUNCHES``)
and its plain PyTorch version below on a CPU tensor; a CUDA tensor the
kernel does not take raises.  ``P[j] + Q[i]`` rounds otherwise than ``row
@ w``, so the route is held to ``gather_chain.py``'s plain versions
within rounding; the max, the lists and the pull are bit-equal to their
own plain versions on the same inputs.
"""

from __future__ import annotations

import ctypes

import torch

from pointcloudattack_tpu_torch.ops import _build
from pointcloudattack_tpu_torch.ops.gather import index_points

# Kernel launches since the last reset; bumped only where a kernel is
# launched, never by the plain versions.
LAUNCHES = {"product_fwd": 0, "max_fwd": 0, "lists_bwd": 0, "pull_bwd": 0, "product_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def takes(layers, pre_act: bool) -> bool:
    """Whether a gather max of these ``layers`` runs this route: one layer
    and no activation on the built rows."""
    return len(layers) == 1 and not pre_act


def key_bits(k: int) -> int:
    """The bits a reverse-list entry gives ``k`` in ``(i << s) | k``."""
    return (k - 1).bit_length()


def _fold(pieces, rows: int, like: torch.Tensor) -> torch.Tensor:
    """The sum of the signed weight rows ``pieces`` ((first row, sign,
    rows)) over a ``[rows, C1]`` matrix that starts at 0.  Where every piece
    covers it all, the first added piece starts the sum and the rest follow
    in order (``b - a`` for ``-a + b``, one operation fewer; a view of
    ``like`` for one added piece); else each adds into zeros in order."""
    if pieces and all(lo == 0 and part.shape[0] == rows for lo, _, part in pieces):
        first = next((i for i, (_, sign, _) in enumerate(pieces) if sign > 0), 0)
        acc = pieces[first][2] if pieces[first][1] > 0 else -pieces[first][2]
        for i, (_, sign, part) in enumerate(pieces):
            if i != first:
                acc = acc + part if sign > 0 else acc - part
        return acc
    out = like.new_zeros((rows, like.shape[1]))
    for lo, sign, part in pieces:
        if sign > 0:
            out[lo : lo + part.shape[0]] += part
        else:
            out[lo : lo + part.shape[0]] -= part
    return out


def split_weight(w: torch.Tensor, layout, cs: int, cc: int):
    """``(W_src [Cs, C1], W_ctr [Cc, C1])`` such that the row that
    ``layout`` builds from a source row ``s`` and a center ``t``, times
    ``w [C0, C1]``, is ``s @ W_src + t @ W_ctr``: each diff and pass
    segment's weight rows add into W_src at its source columns, each
    center segment's into W_ctr at its center columns, and each diff
    segment's subtract there, in the layout's order.  Either may be a view
    of ``w``."""
    w = w.float()
    if w.dim() != 2 or w.shape[0] != sum(s[2] - s[1] for s in layout):
        raise ValueError(f"weight {tuple(w.shape)} does not take the rows of layout {layout!r}")
    src_rows, ctr_rows = [], []
    off = 0
    for s in layout:
        n = s[2] - s[1]
        if s[0] not in ("diff", "pass", "center") or s[1] < 0 or n < 1:
            raise ValueError(f"bad layout segment {s!r}")
        part = w[off : off + n]
        if s[0] == "center":
            if s[2] > cc:
                raise ValueError(f"segment {s!r} exceeds the centers' {cc} columns")
            ctr_rows.append((s[1], 1, part))
        else:
            if s[2] > cs or (s[0] == "diff" and not 0 <= s[3] <= cc - n):
                raise ValueError(f"segment {s!r} exceeds the sources' {cs} or the centers' {cc} columns")
            src_rows.append((s[1], 1, part))
            if s[0] == "diff":
                ctr_rows.append((s[3], -1, part))
        off += n
    return _fold(src_rows, cs, w), _fold(ctr_rows, cc, w)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the references the kernels are held to)
# ---------------------------------------------------------------------------


def product_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a [R, Kd] @ w [Kd, M]``."""
    return a.float() @ w.float()


def max_plain(p, q, idx, bias, mean, mul, beta):
    """``(y, am)`` ``[B, G, C]``: the max over ``k`` of ``((P[idx] + Q) +
    bias - mean) * mul + beta`` (``p [B, N, C]``, ``q [B, G, C]``), each
    operation rounded on its own, and the lowest ``k`` attaining it."""
    z = index_points(p, idx) + q[:, :, None, :]
    z = (z + bias - mean) * mul + beta
    y = z.amax(dim=2)
    k = idx.shape[2]
    rows = torch.arange(k, device=z.device, dtype=torch.int32)[:, None]
    am = torch.where(z == y[:, :, None, :], rows, torch.full((), k, device=z.device, dtype=torch.int32)).amin(dim=2)
    return y, am


def lists_plain(idx: torch.Tensor, n: int):
    """Reverse neighbour lists of ``idx [B, G, K]`` over ``n`` points:
    ``(start [B, n + 1], list [B, G*K])`` int32, point ``j``'s pairs
    ``(i, k)`` (``idx[b, i, k] = j``) at ``list[b, start[b, j] : start[b,
    j + 1]]`` in ascending order, each as ``(i << key_bits(K)) | k``: a
    stable argsort."""
    b, _, k = idx.shape
    flat = idx.reshape(b, -1).long()
    order = torch.argsort(flat, dim=1, stable=True)
    counts = torch.zeros((b, n), dtype=torch.int64, device=idx.device).scatter_add_(1, flat, torch.ones_like(flat))
    start = torch.cat([counts.new_zeros((b, 1)), counts.cumsum(1)], 1)
    return start.to(torch.int32), ((order // k) << key_bits(k) | order % k).to(torch.int32)


def pull_plain(start, lst, am, g, k: int) -> torch.Tensor:
    """``dP [B, N, C]``: for each point, ``g[b, i, c]`` summed over its list
    where ``am[b, i, c] == k``, from 0 in the list's order (the kernel's
    order, so the same bits)."""
    b, n = start.shape[0], start.shape[1] - 1
    c, s = g.shape[-1], key_bits(k)
    first, counts = start[:, :-1].long(), (start[:, 1:] - start[:, :-1]).long()
    am, g = am.reshape(b, -1, c), g.float().reshape(b, -1, c)
    dp = torch.zeros((b, n, c), dtype=torch.float32, device=g.device)
    last = max(lst.shape[1] - 1, 0)
    for t in range(int(counts.max()) if counts.numel() else 0):
        ent = lst.gather(1, (first + t).clamp(max=last)).long()  # [B, N]
        rows = (ent >> s)[..., None].expand(b, n, c)
        hit = (t < counts)[..., None] & (am.gather(1, rows) == (ent & ((1 << s) - 1))[..., None])
        dp = dp + torch.where(hit, g.gather(1, rows), 0.0)
    return dp


# ---------------------------------------------------------------------------
# Kernel wrappers (each runs its plain version on a CPU tensor)
# ---------------------------------------------------------------------------


def _no_device(t):
    return ValueError(f"gather_hoist: no implementation for device {t.device}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _need(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"gather_hoist: {name} must be {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def products(pairs, counter: str, outs=None, launches=None):
    """``[a @ w for a, w in pairs]`` (one or two pairs, ``a [R, Kd]`` with
    unit column stride, ``w [Kd, M]`` of any strides, a transposed view
    too): one launch of the product kernel for CUDA tensors, counted under
    ``counter`` in ``launches`` (this module's ``LAUNCHES`` unless given;
    the ball route passes its own), written into ``outs`` (contiguous) when
    given, else into fresh tensors; the plain version for CPU tensors."""
    a0 = pairs[0][0]
    if a0.device.type == "cpu":
        return [product_plain(a, w) for a, w in pairs]
    if not a0.is_cuda:
        raise _no_device(a0)
    if not 1 <= len(pairs) <= 2:
        raise ValueError(f"the product kernel takes one or two products, got {len(pairs)}")
    args, res = [], []
    for i, (a, w) in enumerate(pairs):
        if (a.dtype != torch.float32 or w.dtype != torch.float32 or a.dim() != 2 or w.dim() != 2
                or a.stride(1) != 1 or a.shape[1] != w.shape[0] or a.device != a0.device or w.device != a0.device
                or min(a.shape) < 1 or w.shape[1] < 1):
            raise ValueError(f"the product kernel takes float32 a [R, Kd] (unit column stride) and w [Kd, M] "
                             f"on {a0.device}, got {a.dtype} {tuple(a.shape)} strides {a.stride()} and "
                             f"{w.dtype} {tuple(w.shape)} on {a.device}, {w.device}")
        out = outs[i] if outs else torch.empty((a.shape[0], w.shape[1]), dtype=torch.float32, device=a.device)
        _need(f"product output {i}", out, torch.float32, (a.shape[0], w.shape[1]), a.device)
        if not out.is_contiguous():
            raise ValueError(f"gather_hoist: product output {i} must be contiguous")
        args += [a.data_ptr(), w.data_ptr(), out.data_ptr(), a.shape[0], a.shape[1], w.shape[1], a.stride(0),
                 w.stride(0), w.stride(1)]
        res.append(out)
    if len(pairs) == 1:
        args += [None, None, None, 0, 0, 0, 0, 0, 0]
    lib = _build.load_library()
    with torch.cuda.device(a0.device):
        rc = lib.pca_hoist_product(a0.device.index, len(pairs), *args, _stream(a0))
    _build.check(lib, rc, "gather_hoist product launch")
    (LAUNCHES if launches is None else launches)[counter] += 1
    return res


def gather_max(p, q, idx, bias, mean, mul, beta):
    """``(y, am)`` of ``max_plain``: the max kernel for CUDA tensors (``p
    [B, N, C]`` and ``q [B, G, C]`` may be column slices of wider rows),
    the plain version for CPU tensors."""
    if p.device.type == "cpu":
        return max_plain(p, q, idx, bias, mean, mul, beta)
    if not p.is_cuda:
        raise _no_device(p)
    b, g, k = idx.shape
    n, c = p.shape[1], p.shape[2]
    for name, t, rows in (("p", p, n), ("q", q, g)):
        if (t.dtype != torch.float32 or t.dim() != 3 or tuple(t.shape) != (b, rows, c) or t.device != p.device
                or t.stride(2) != 1 or t.stride(0) != rows * t.stride(1)):
            raise ValueError(f"the max kernel takes float32 {name} [{b}, {rows}, {c}] on {p.device} with "
                             f"unit column stride and packed rows, got {t.dtype} {tuple(t.shape)} strides "
                             f"{t.stride()} on {t.device}")
    if idx.dtype != torch.int32 or not idx.is_contiguous() or idx.device != p.device:
        raise ValueError(f"the max kernel takes a contiguous int32 idx on {p.device}, got {idx.dtype} on {idx.device}")
    for name, v in (("bias", bias), ("mean", mean), ("mul", mul), ("beta", beta)):
        _need(name, v, torch.float32, (c,), p.device)
        if not v.is_contiguous():
            raise ValueError(f"the max kernel takes a contiguous {name}")
    y = torch.empty((b, g, c), dtype=torch.float32, device=p.device)
    am = torch.empty((b, g, c), dtype=torch.int32, device=p.device)
    lib = _build.load_library()
    with torch.cuda.device(p.device):
        rc = lib.pca_hoist_max(p.device.index, p.data_ptr(), p.stride(1), q.data_ptr(), q.stride(1), idx.data_ptr(),
                               bias.data_ptr(), mean.data_ptr(), mul.data_ptr(), beta.data_ptr(), b, n, g, k, c,
                               y.data_ptr(), am.data_ptr(), _stream(p))
    _build.check(lib, rc, "gather_hoist max launch")
    LAUNCHES["max_fwd"] += 1
    return y, am


def reverse_lists(idx: torch.Tensor, n: int):
    """``(start, list)`` of ``lists_plain``: the lists kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if idx.device.type == "cpu":
        return lists_plain(idx, n)
    if not idx.is_cuda:
        raise _no_device(idx)
    if idx.dtype != torch.int32 or idx.dim() != 3 or not idx.is_contiguous() or min(idx.shape) < 1:
        raise ValueError(f"the lists kernel takes a contiguous int32 idx [B, G, K], got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    lib = _build.load_library()
    parts = lib.pca_hoist_lists_parts(n)
    if parts < 1:
        raise ValueError(f"the lists kernel takes clouds whose counts fit one block's shared memory, got N={n}")
    b, g, k = idx.shape
    start = torch.empty((b, n + 1), dtype=torch.int32, device=idx.device)
    lst = torch.empty((b, g * k), dtype=torch.int32, device=idx.device)
    with torch.cuda.device(idx.device):
        rc = lib.pca_hoist_lists(idx.device.index, idx.data_ptr(), b, n, g, k, key_bits(k), parts, start.data_ptr(),
                                 lst.data_ptr(), _stream(idx))
    _build.check(lib, rc, "gather_hoist lists launch")
    LAUNCHES["lists_bwd"] += 1
    return start, lst


def pull(start, lst, am, g, k: int) -> torch.Tensor:
    """``dP`` of ``pull_plain``: the pull kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if g.device.type == "cpu":
        return pull_plain(start, lst, am, g, k)
    if not g.is_cuda:
        raise _no_device(g)
    b, ng, c = g.shape
    n = start.shape[1] - 1
    _need("g", g, torch.float32, (b, ng, c), g.device)
    _need("am", am, torch.int32, (b, ng, c), g.device)
    _need("start", start, torch.int32, (b, n + 1), g.device)
    _need("list", lst, torch.int32, (b, ng * k), g.device)
    if not all(t.is_contiguous() for t in (g, am, start, lst)):
        raise ValueError("the pull kernel takes contiguous g, am, start and list")
    dp = torch.empty((b, n, c), dtype=torch.float32, device=g.device)
    lib = _build.load_library()
    with torch.cuda.device(g.device):
        rc = lib.pca_hoist_pull(g.device.index, start.data_ptr(), lst.data_ptr(), am.data_ptr(), g.data_ptr(), b, n,
                                ng, k, key_bits(k), c, dp.data_ptr(), _stream(g))
    _build.check(lib, rc, "gather_hoist pull launch")
    LAUNCHES["pull_bwd"] += 1
    return dp


# ---------------------------------------------------------------------------
# The route: forward and input gradients
# ---------------------------------------------------------------------------


def _shared(src, centers) -> bool:
    """Whether the sources are the centers (DGCNN, CurveNet's initial LPFA)."""
    return src.shape == centers.shape and src.stride() == centers.stride() and src.data_ptr() == centers.data_ptr()


def _check(src, centers, idx, layer):
    b, n, cs = src.shape
    g, cc = centers.shape[1:]
    for name, t, dt in (("src", src, torch.float32), ("centers", centers, torch.float32), ("idx", idx, torch.int32)):
        if t.dtype != dt or t.dim() != 3 or not t.is_contiguous() or t.device != src.device:
            raise ValueError(f"gather_hoist takes a contiguous {dt} {name} of rank 3 on {src.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if centers.shape[0] != b or idx.shape[:2] != (b, g) or min(n, g, idx.shape[2]) < 1:
        raise ValueError(f"gather_hoist: src {tuple(src.shape)}, centers {tuple(centers.shape)} and idx "
                         f"{tuple(idx.shape)} disagree")
    if len(layer) != 5 or any(t.dtype != torch.float32 or t.device != src.device for t in layer):
        raise ValueError(f"gather_hoist takes one layer (w, b, mean, mul, beta) of float32 on {src.device}")


def hoisted_fwd(src, centers, idx, layer, layout):
    """``(y, am)`` of the one-layer gather max: two launches on the card,
    the plain versions composed on the CPU."""
    _check(src, centers, idx, layer)
    w, bias, mean, mul, beta = layer
    b, n, cs = src.shape
    g, cc = centers.shape[1:]
    c1 = w.shape[1]
    ws, wc = split_weight(w, layout, cs, cc)
    if _shared(src, centers):
        (pq,) = products([(src.view(b * n, cs), torch.cat([ws, wc], 1))], "product_fwd")
        pq = pq.view(b, n, 2 * c1)
        p, q = pq[..., :c1], pq[..., c1:]
    else:
        p, q = products([(src.view(b * n, cs), ws), (centers.view(b * g, cc), wc)], "product_fwd")
        p, q = p.view(b, n, c1), q.view(b, g, c1)
    return gather_max(p, q, idx, bias, mean, mul, beta)


def hoisted_bwd(src, centers, idx, layer, layout, am, g):
    """``(dsrc, dctr)`` of the one-layer gather max for ``g = dy * mul``:
    three launches on the card (lists, pull, product), the plain versions
    composed on the CPU; no atomics, so the same bits on every call."""
    _check(src, centers, idx, layer)
    b, n, cs = src.shape
    ng, cc = centers.shape[1:]
    c1 = layer[0].shape[1]
    ws, wc = split_weight(layer[0], layout, cs, cc)
    start, lst = reverse_lists(idx, n)
    dp = pull(start, lst, am, g, idx.shape[2])
    dsrc, dctr = products([(dp.view(b * n, c1), ws.t()), (g.reshape(b * ng, c1), wc.t())], "product_bwd")
    return dsrc.view(b, n, cs), dctr.view(b, ng, cc)
