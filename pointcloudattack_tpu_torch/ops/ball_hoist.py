"""The ball route of the gather + chain + max (PointNet++'s set
abstractions) with its first layer run once a point, the layers after it on
the tensor cores, and a backward over the winning rows only.

The route of ``ops/gather_chain.py``'s ``ball_gather_chain_groupmax`` on a
CUDA tensor; the counterpart there of
``pointcloudattack_tpu/ops/pallas/gather_chain_kernel.py``'s
``_gather_fwd_pallas`` and ``_gather_bwd_pallas`` on the ball route
(``_make_ball_gather_op``).  The semantics are ``gather_chain.py``'s: the
slots are ``query_ball_point``'s, the rows are built by the layout, the
chain runs with ReLU (or ``max(z, slope * z)``) between its layers and
nothing after the last, and ``y`` is the max over each group's ``K`` rows
with ``am`` the lowest ``k`` attaining it.

The first layer is affine in the built row, so with ``W_src, W_ctr =
split_weight(w_0, layout, Cs, Cc)`` (``ops/gather_hoist.py``)

    row(i, k) @ w_0 = P[idx[i, k]] + Q[i],  P = src @ W_src,  Q = centers @ W_ctr

and ``h_1 = act(BN(P[j] + Q[i]))`` is built per row from ``P`` and ``Q``.
The layers after it run as 3xTF32 products.  The forward saves each row's
hidden sign bits (``z_l > 0``, bit-packed: ``pack_signs``) for the backward,
which runs only over the rows that win a column (``winners``): the one-hot
cotangent through the last layer and the hidden layers back through those
signs give ``d1``, the cotangent of ``P[j] + Q[i]`` on each winning row;
``dP[j]`` sums ``d1`` over point ``j``'s winning rows (``reverse_lists``)
and ``dQ[i]`` over group ``i``'s, each in its list's order (``pull``); then
``dsrc = dP @ W_src^T`` and ``dctr = dQ @ W_ctr^T``.  Launches, each a
kernel of ``csrc/ball_hoist.cu`` (the winners stage two: the bitmaps and
offsets, then the rows placed) but the products, which run
``gather_hoist.products`` (the product kernel of ``csrc/gather_hoist.cu``),
each counted once in this module's ``LAUNCHES``:

    forward   slots, product (P and Q), stack
    backward  winners, stack, lists, pull (dP and dQ), product (dsrc and dctr)

Each wrapper runs its kernel on a CUDA tensor (counted in ``LAUNCHES``) and
its plain PyTorch version below on a CPU tensor; a CUDA tensor the kernel
does not take raises.  The plain versions repeat the kernels' algorithm:
the slots, the winners, the reverse lists and the pull are bit-equal to
them, the products and the stack equal within rounding (3xTF32 against f32
products).  On the CPU, ``ball_gather_chain_groupmax`` keeps
``gather_chain.py``'s plain versions (the rows built, then the chain), bit
for bit the index route's.  The wrappers' intermediate outputs live in
scratch kept per device and stream, and a second call of a wrapper reuses
its predecessor's; the outputs of ``forward`` and ``hoisted_bwd`` are
fresh tensors.
"""

from __future__ import annotations

import ctypes
from collections import namedtuple

import torch

from pointcloudattack_tpu_torch.ops import _build
from pointcloudattack_tpu_torch.ops.ball_query import ball_r2, query_ball_point
from pointcloudattack_tpu_torch.ops.chain_maxpool import _ptr_array, act
from pointcloudattack_tpu_torch.ops.gather import index_points
from pointcloudattack_tpu_torch.ops.gather_hoist import product_plain, products, split_weight

# Kernel launches since the last reset, a stage each; bumped only where a
# kernel is launched, never by the plain versions.
LAUNCHES = {"slots_fwd": 0, "product_fwd": 0, "stack_fwd": 0, "winners_bwd": 0, "stack_bwd": 0, "lists_bwd": 0,
            "pull_bwd": 0, "product_bwd": 0}

MAX_K = 128  # the forward's tile of 128 rows holds whole groups

# The winning rows: mask [B*G, ceil(K / 32)] int32 (bit k of group i: row
# (i, k) wins a column), off [B*G + 1] int32 (the winners before each
# group, then their total), wrow (the rows i * K + k, ascending; the first
# off[-1] entries hold them).
Winners = namedtuple("Winners", "mask off wrow")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sign_widths(layers) -> list[int]:
    """The widths of the hidden layers whose signs the forward keeps: every
    layer's output but the last."""
    return [layer[0].shape[1] for layer in layers[:-1]]


def pack_signs(sides) -> torch.Tensor:
    """``[..., W]`` int32: each hidden layer's ``[..., C]`` bool sides, 32 a
    word (unit ``32 w + i`` at bit ``i``), each layer from a new word."""
    words = []
    for s in sides:
        c = s.shape[-1]
        nw = -(-c // 32)
        bits = torch.nn.functional.pad(s.to(torch.int64), (0, 32 * nw - c)).view(*s.shape[:-1], nw, 32)
        words.append((bits << torch.arange(32, device=s.device)).sum(-1))
    w = torch.cat(words, -1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def unpack_signs(signs: torch.Tensor, widths) -> list[torch.Tensor]:
    """The inverse of ``pack_signs``: one ``[..., C]`` bool a width."""
    out, off = [], 0
    for c in widths:
        nw = -(-c // 32)
        words = signs[..., off : off + nw].to(torch.int64) & 0xFFFFFFFF
        bits = (words[..., None] >> torch.arange(32, device=signs.device)) & 1
        out.append(bits.reshape(*signs.shape[:-1], 32 * nw)[..., :c].bool())
        off += nw
    return out


def _bn(z, layer):
    _, b, mean, mul, beta = layer
    return ((z + b) - mean) * mul + beta


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the references the kernels are held to)
# ---------------------------------------------------------------------------


def slots_plain(xyz, centers, radius: float, k: int) -> torch.Tensor:
    """``query_ball_point(radius, k, xyz, centers[..., :3])``."""
    return query_ball_point(radius, k, xyz, centers[..., :3])


def stack_fwd_plain(p, q, idx, layers, slope: float = 0.0):
    """``(y, am, signs)`` of the chain over rows whose first layer's output
    is ``P[idx] + Q`` (``p [B, N, C1]``, ``q [B, G, C1]``): ``y`` the max
    over ``k``, ``am`` the lowest ``k`` attaining it, ``signs [B, G, K, W]``
    the hidden sides packed (``pack_signs``)."""
    z = index_points(p.float(), idx) + q.float()[:, :, None, :]
    sides = []
    for i, layer in enumerate(layers):
        if i:
            z = h @ layer[0].float()
        z = _bn(z, layer)
        if i == len(layers) - 1:
            break
        sides.append(z > 0)
        h = act(z, slope)
    y = z.amax(dim=2)
    k = idx.shape[2]
    rows = torch.arange(k, device=z.device, dtype=torch.int32)[:, None]
    am = torch.where(z == y[:, :, None, :], rows, torch.full((), k, device=z.device, dtype=torch.int32)).amin(dim=2)
    return y, am, pack_signs(sides)


def hoisted_fwd_plain(src, centers, idx, layers, layout, slope: float = 0.0):
    """``(P, Q, y, am, signs)`` of the route on the slots ``idx``."""
    b, n, cs = src.shape
    g, cc = centers.shape[1:]
    ws, wc = split_weight(layers[0][0], layout, cs, cc)
    p = product_plain(src.reshape(b * n, cs), ws).view(b, n, -1)
    q = product_plain(centers.reshape(b * g, cc), wc).view(b, g, -1)
    return (p, q, *stack_fwd_plain(p, q, idx, layers, slope))


def winners_plain(am: torch.Tensor, k: int) -> Winners:
    """The rows that win a column of ``am [B, G, C_L]``, as the winners
    kernel gives them (``wrow`` holds exactly ``off[-1]`` rows)."""
    bg = am.shape[0] * am.shape[1]
    hit = torch.zeros((bg, k), dtype=torch.bool, device=am.device)
    hit.scatter_(1, am.reshape(bg, -1).long(), True)
    counts = hit.sum(1)
    off = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
    wrow = hit.reshape(-1).nonzero().squeeze(1).to(torch.int32)
    return Winners(pack_signs([hit]), off, wrow)


def stack_bwd_plain(win: Winners, am, g, signs, layers, k: int, slope: float = 0.0) -> torch.Tensor:
    """``d1 [winners, C1]``: the cotangent of each winning row's ``P[j] +
    Q[i]`` for ``g = dy * mul_L``, through the forward's ``signs``."""
    total = int(win.off[-1])
    rows = win.wrow[:total].long()
    grp, kk = rows // k, rows % k
    cl = am.shape[-1]
    amf, gf = am.reshape(-1, cl), g.float().reshape(-1, cl)
    c = torch.where(amf[grp] == kk[:, None], gf[grp], 0.0)
    sides = unpack_signs(signs.reshape(-1, signs.shape[-1])[rows], sign_widths(layers))
    for i in range(len(layers) - 1, 0, -1):
        dh = c @ layers[i][0].float().t()
        c = torch.where(sides[i - 1], dh, slope * dh if slope else 0.0) * layers[i - 1][3]
    return c


def lists_plain(idx: torch.Tensor, win: Winners, n: int):
    """Each point's winning rows: ``(start [B, n + 1], list [winners])``
    int32, point ``j``'s winner indices (ascending) at ``list[off[b * G] +
    start[b, j] : off[b * G] + start[b, j + 1]]``: a stable sort of each
    cloud's winners by the point their slot gathered."""
    b, g, _ = idx.shape
    total = int(win.off[-1])
    rows = win.wrow[:total].long()
    cloud = rows // (g * idx.shape[2])
    key = cloud * n + idx.reshape(-1)[rows].long()
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=b * n).view(b, n)
    start = torch.cat([counts.new_zeros((b, 1)), counts.cumsum(1)], 1)
    return start.to(torch.int32), order.to(torch.int32)


def _sum_runs(d1, first, counts, ent):
    """Per run (``first``, ``counts``: [R]), the sum of ``d1[ent(first +
    t)]`` over ``t < counts``, from 0 in order: ``[R, C]``."""
    out = torch.zeros((first.shape[0], d1.shape[1]), dtype=torch.float32, device=d1.device)
    for t in range(int(counts.max()) if counts.numel() else 0):
        live = t < counts
        rows = ent(torch.where(live, first + t, 0))
        out = torch.where(live[:, None], out + d1[rows], out)
    return out


def pull_plain(start, lst, win: Winners, d1, n: int, g: int):
    """``(dP [B, n, C1], dQ [B, g, C1])``: each point's ``d1`` summed over its
    list and each group's over its winners, in order from 0 (the pull
    kernel's order, so the same bits)."""
    b = start.shape[0]
    off = win.off.long()
    base = off[torch.arange(b, device=off.device) * g]
    first = (start[:, :-1].long() + base[:, None]).reshape(-1)
    counts = (start[:, 1:] - start[:, :-1]).long().reshape(-1)
    lst = lst.long()
    dp = _sum_runs(d1, first, counts, lambda s: lst[s])
    dq = _sum_runs(d1, off[:-1], off[1:] - off[:-1], lambda s: s)
    return dp.view(b, n, -1), dq.view(b, g, -1)


def hoisted_bwd_plain(src, centers, idx, layers, layout, am, g, signs, slope: float = 0.0):
    """``(dsrc, dctr)`` of the route for ``g = dy * mul_L``, the plain
    versions composed."""
    b, n, cs = src.shape
    ng, cc = centers.shape[1:]
    ws, wc = split_weight(layers[0][0], layout, cs, cc)
    win = winners_plain(am, idx.shape[2])
    d1 = stack_bwd_plain(win, am, g, signs, layers, idx.shape[2], slope)
    start, lst = lists_plain(idx, win, n)
    dp, dq = pull_plain(start, lst, win, d1, n, ng)
    c1 = dp.shape[-1]
    dsrc = product_plain(dp.reshape(b * n, c1), ws.t())
    dctr = product_plain(dq.reshape(b * ng, c1), wc.t())
    return dsrc.view(b, n, cs), dctr.view(b, ng, cc)


# ---------------------------------------------------------------------------
# Kernel wrappers (each runs its plain version on a CPU tensor)
# ---------------------------------------------------------------------------

_SCRATCH: dict = {}  # (device, stream, name) -> a tensor grown as needed
_TICKETS: dict = {}  # (device, stream) -> the winners kernel's int32 ticket, 0 between launches


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _scratch(name: str, dtype, shape, device) -> torch.Tensor:
    """A ``shape`` view of the named scratch of ``device``'s current stream:
    kernels on one stream run in order, so a buffer serves every call."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream, name)
    numel = 1
    for s in shape:
        numel *= s
    buf = _SCRATCH.get(key)
    if buf is None or buf.dtype != dtype or buf.numel() < numel:
        buf = torch.empty(max(numel, 1), dtype=dtype, device=device)
        _SCRATCH[key] = buf
    return buf[:numel].view(shape)


def _ticket(device) -> torch.Tensor:
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _TICKETS[key]


def _no_device(t):
    return ValueError(f"ball_hoist: no implementation for device {t.device}")


def _on_cpu(t) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    tensor; raises for any other device."""
    if t.device.type == "cpu":
        return True
    if not t.is_cuda:
        raise _no_device(t)
    return False


def _need(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device or not t.is_contiguous():
        raise ValueError(f"ball_hoist: {name} must be a contiguous {dtype} {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check(lib, rc, what):
    _build.check(lib, rc, f"ball_hoist {what} launch")


def slots(xyz, centers, radius: float, k: int) -> torch.Tensor:
    """``idx [B, G, k]`` int32: ``query_ball_point``'s slots around
    ``centers[..., :3]``; the slots kernel for CUDA tensors."""
    if _on_cpu(xyz):
        return slots_plain(xyz, centers, radius, k)
    b, n = xyz.shape[:2]
    if (xyz.dtype != torch.float32 or not xyz.is_contiguous() or xyz.dim() != 3 or xyz.shape[2] != 3
            or centers.dtype != torch.float32 or not centers.is_contiguous() or centers.dim() != 3
            or centers.shape[0] != b or centers.shape[2] < 3 or centers.device != xyz.device or k < 1):
        raise ValueError(f"ball_hoist slots take a contiguous float32 xyz [B, N, 3] and centers [B, G, >= 3] on one "
                         f"device, got xyz {xyz.dtype} {tuple(xyz.shape)} on {xyz.device}, centers "
                         f"{centers.dtype} {tuple(centers.shape)} on {centers.device}, K={k}")
    g, cc = centers.shape[1:]
    idx = torch.empty((b, g, k), dtype=torch.int32, device=xyz.device)
    lib = _build.load_library()
    with torch.cuda.device(xyz.device):
        rc = lib.pca_ball_slots(xyz.device.index, xyz.data_ptr(), centers.data_ptr(), b, n, g, k, cc,
                                float(ball_r2(radius)), idx.data_ptr(), _stream(xyz))
    _check(lib, rc, "slots")
    LAUNCHES["slots_fwd"] += 1
    return idx


def _stack_args(lib, layers, device):
    """(dims, params, wstrides, keep) of the layers for the stack kernels;
    ``keep`` holds what the launch reads until it returns."""
    if not 2 <= len(layers) <= 4:
        raise ValueError(f"the ball route's stack takes 2-4 layers, got {len(layers)}")
    dims = [layers[0][0].shape[0]]
    tensors, strides = [], []
    for i, (w, *vecs) in enumerate(layers):
        if w.dim() != 2 or w.shape[0] != dims[-1]:
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} does not take width {dims[-1]}")
        dims.append(w.shape[1])
        for t in (w, *vecs):
            if t.device != device or t.dtype != torch.float32:
                raise ValueError(f"layer {i}: parameters must be float32 on {device}, got {t.dtype} on {t.device}")
        if not all(v.is_contiguous() and tuple(v.shape) == (dims[-1],) for v in vecs):
            raise ValueError(f"layer {i}: b, mean, mul and beta must be contiguous ({dims[-1]},)")
        tensors += [w, *vecs]
        strides += [w.stride(0), w.stride(1)]
    dims_arr = (ctypes.c_int * len(dims))(*dims)
    if lib.pca_ball_sign_words(len(layers), ctypes.cast(dims_arr, ctypes.c_void_p)) < 1:
        raise ValueError(f"the ball route's stack keeps at most 1024 hidden units' signs a row, got widths {dims}")
    params = _ptr_array(tensors)
    wstr = (ctypes.c_int * len(strides))(*strides)
    return dims, dims_arr, params, wstr


def stack_fwd(p, q, idx, layers, slope: float = 0.0):
    """``(y, am, signs)`` of ``stack_fwd_plain``: the stack kernel for CUDA
    tensors (``p [B, N, C1]`` and ``q [B, G, C1]`` with unit column stride
    and packed rows), the plain version for CPU tensors."""
    if _on_cpu(p):
        return stack_fwd_plain(p, q, idx, layers, slope)
    b, g, k = idx.shape
    n, c1 = p.shape[1], p.shape[2]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the ball route's stack takes K <= {MAX_K} slots a ball, got {k}")
    for name, t, rows in (("p", p, n), ("q", q, g)):
        if (t.dtype != torch.float32 or t.dim() != 3 or tuple(t.shape) != (b, rows, c1) or t.device != p.device
                or t.stride(2) != 1 or t.stride(0) != rows * t.stride(1)):
            raise ValueError(f"the stack kernel takes float32 {name} [{b}, {rows}, {c1}] on {p.device} with unit "
                             f"column stride and packed rows, got {t.dtype} {tuple(t.shape)} strides {t.stride()}")
    _need("idx", idx, torch.int32, (b, g, k), p.device)
    lib = _build.load_library()
    dims, dims_arr, params, wstr = _stack_args(lib, layers, p.device)
    if dims[1] != c1:
        raise ValueError(f"the first layer's width {dims[1]} differs from P's {c1}")
    words = lib.pca_ball_sign_words(len(layers), ctypes.cast(dims_arr, ctypes.c_void_p))
    y = torch.empty((b, g, dims[-1]), dtype=torch.float32, device=p.device)
    am = torch.empty((b, g, dims[-1]), dtype=torch.int32, device=p.device)
    signs = torch.empty((b, g, k, words), dtype=torch.int32, device=p.device)
    with torch.cuda.device(p.device):
        rc = lib.pca_ball_stack_fwd(p.device.index, p.data_ptr(), p.stride(1), q.data_ptr(), q.stride(1),
                                    idx.data_ptr(), b, n, g, k, len(layers), ctypes.cast(dims_arr, ctypes.c_void_p),
                                    ctypes.cast(params, ctypes.c_void_p), ctypes.cast(wstr, ctypes.c_void_p),
                                    float(slope), y.data_ptr(), am.data_ptr(), signs.data_ptr(), _stream(p))
    _check(lib, rc, "stack forward")
    LAUNCHES["stack_fwd"] += 1
    return y, am, signs


def winners(am: torch.Tensor, k: int) -> Winners:
    """``winners_plain``'s rows: the winners kernel for CUDA tensors (into
    scratch; ``wrow`` has room for every row, its first ``off[-1]`` hold
    the winners), the plain version for CPU tensors."""
    if _on_cpu(am):
        return winners_plain(am, k)
    if not 1 <= k <= MAX_K or am.dim() != 3:
        raise ValueError(f"the winners kernel takes am [B, G, C_L] and K <= {MAX_K}, got {tuple(am.shape)}, K={k}")
    b, g, cl = am.shape
    _need("am", am, torch.int32, (b, g, cl), am.device)
    dev, bg = am.device, b * g
    mask = _scratch("mask", torch.int32, (bg, -(-k // 32)), dev)
    counts = _scratch("counts", torch.int32, (bg,), dev)
    off = _scratch("off", torch.int32, (bg + 1,), dev)
    wrow = _scratch("wrow", torch.int32, (bg * k,), dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.pca_ball_winners(dev.index, am.data_ptr(), bg, k, cl, mask.data_ptr(), counts.data_ptr(),
                                  _ticket(dev).data_ptr(), off.data_ptr(), wrow.data_ptr(), _stream(am))
    _check(lib, rc, "winners")
    LAUNCHES["winners_bwd"] += 1
    return Winners(mask, off, wrow)


def stack_bwd(win: Winners, am, g, signs, layers, k: int, slope: float = 0.0) -> torch.Tensor:
    """``d1`` of ``stack_bwd_plain``: the backward stack kernel for CUDA
    tensors (into scratch with room for every row; its first ``off[-1]``
    rows hold the winners'), the plain version for CPU tensors."""
    if _on_cpu(g):
        return stack_bwd_plain(win, am, g, signs, layers, k, slope)
    b, ng, cl = am.shape
    dev, bg = g.device, b * ng
    _need("am", am, torch.int32, (b, ng, cl), dev)
    _need("g", g, torch.float32, (b, ng, cl), dev)
    lib = _build.load_library()
    dims, dims_arr, params, wstr = _stack_args(lib, layers, dev)
    words = lib.pca_ball_sign_words(len(layers), ctypes.cast(dims_arr, ctypes.c_void_p))
    _need("signs", signs, torch.int32, (b, ng, k, words), dev)
    if dims[-1] != cl:
        raise ValueError(f"the last layer's width {dims[-1]} differs from am's {cl}")
    d1 = _scratch("d1", torch.float32, (bg * min(k, cl), dims[1]), dev)
    with torch.cuda.device(dev):
        rc = lib.pca_ball_stack_bwd(dev.index, win.off.data_ptr(), win.wrow.data_ptr(), win.mask.data_ptr(),
                                    am.data_ptr(), g.data_ptr(), signs.data_ptr(), bg, k, len(layers),
                                    ctypes.cast(dims_arr, ctypes.c_void_p), ctypes.cast(params, ctypes.c_void_p),
                                    ctypes.cast(wstr, ctypes.c_void_p), float(slope), d1.data_ptr(), _stream(g))
    _check(lib, rc, "stack backward")
    LAUNCHES["stack_bwd"] += 1
    return d1


def reverse_lists(idx: torch.Tensor, win: Winners, n: int):
    """``(start, list)`` of ``lists_plain``: the lists kernel for CUDA
    tensors (into scratch), the plain version for CPU tensors."""
    if _on_cpu(idx):
        return lists_plain(idx, win, n)
    b, g, k = idx.shape
    _need("idx", idx, torch.int32, (b, g, k), idx.device)
    lib = _build.load_library()
    parts = lib.pca_ball_lists_parts(n)
    if parts < 1:
        raise ValueError(f"the lists kernel takes clouds whose counts fit one block's shared memory, got N={n}")
    start = _scratch("start", torch.int32, (b, n + 1), idx.device)
    lst = _scratch("list", torch.int32, (b * g * k,), idx.device)
    with torch.cuda.device(idx.device):
        rc = lib.pca_ball_lists(idx.device.index, idx.data_ptr(), win.off.data_ptr(), win.wrow.data_ptr(), b, n, g,
                                parts, start.data_ptr(), lst.data_ptr(), _stream(idx))
    _check(lib, rc, "lists")
    LAUNCHES["lists_bwd"] += 1
    return start, lst


def pull(start, lst, win: Winners, d1, n: int, g: int):
    """``(dP, dQ)`` of ``pull_plain``: the pull kernel for CUDA tensors
    (into scratch), the plain version for CPU tensors."""
    if _on_cpu(d1):
        return pull_plain(start, lst, win, d1, n, g)
    b, c = start.shape[0], d1.shape[1]
    _need("start", start, torch.int32, (b, n + 1), d1.device)
    dp = _scratch("dp", torch.float32, (b, n, c), d1.device)
    dq = _scratch("dq", torch.float32, (b, g, c), d1.device)
    lib = _build.load_library()
    with torch.cuda.device(d1.device):
        rc = lib.pca_ball_pull(d1.device.index, start.data_ptr(), lst.data_ptr(), win.off.data_ptr(), d1.data_ptr(),
                               b, n, g, c, dp.data_ptr(), dq.data_ptr(), _stream(d1))
    _check(lib, rc, "pull")
    LAUNCHES["pull_bwd"] += 1
    return dp, dq


# ---------------------------------------------------------------------------
# The route: forward and input gradients
# ---------------------------------------------------------------------------


def _check_route(src, centers, xyz=None):
    b, n, cs = src.shape
    named = [("src", src), ("centers", centers)] + ([("xyz", xyz)] if xyz is not None else [])
    for name, t in named:
        if t.dtype != torch.float32 or t.dim() != 3 or not t.is_contiguous() or t.device != src.device:
            raise ValueError(f"the ball route takes a contiguous float32 {name} of rank 3 on {src.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if centers.shape[0] != b or centers.shape[2] < 3 or (xyz is not None and tuple(xyz.shape) != (b, n, 3)):
        raise ValueError(f"the ball route takes src [B, N, Cs], centers [B, G, >= 3] and xyz [B, N, 3], got src "
                         f"{tuple(src.shape)}, centers {tuple(centers.shape)}, xyz "
                         f"{None if xyz is None else tuple(xyz.shape)}")


def hoisted_fwd(src, centers, idx, layers, layout, slope: float = 0.0):
    """``(y, am, signs, (W_src, W_ctr))`` of the route on the slots ``idx``:
    two launches on the card (product, stack), the plain versions composed
    on the CPU."""
    _check_route(src, centers)
    b, n, cs = src.shape
    g, cc = centers.shape[1:]
    ws, wc = split_weight(layers[0][0], layout, cs, cc)
    c1 = ws.shape[1]
    outs = None
    if src.is_cuda:
        outs = [_scratch("p", torch.float32, (b * n, c1), src.device), _scratch("q", torch.float32, (b * g, c1),
                                                                                 src.device)]
    p, q = products([(src.view(b * n, cs), ws), (centers.view(b * g, cc), wc)], "product_fwd", outs,
                    LAUNCHES)
    y, am, signs = stack_fwd(p.view(b, n, c1), q.view(b, g, c1), idx, layers, slope)
    return y, am, signs, (ws, wc)


def forward(src, centers, xyz, layers, layout, radius: float, nsample: int, slope: float = 0.0):
    """``(y, am, idx, signs, (W_src, W_ctr))`` of the ball route: three
    launches on the card (slots, product, stack)."""
    _check_route(src, centers, xyz)
    idx = slots(xyz, centers, radius, nsample)
    y, am, signs, folded = hoisted_fwd(src, centers, idx, layers, layout, slope)
    return y, am, idx, signs, folded


def hoisted_bwd(src, centers, idx, layers, layout, am, g, signs, slope: float = 0.0, folded=None):
    """``(dsrc, dctr)`` of the route for ``g = dy * mul_L`` from the
    forward's ``am`` and ``signs`` (``folded``: its ``(W_src, W_ctr)``):
    five launches on the card (winners, stack, lists, pull, product), the
    plain versions composed on the CPU; no atomics on floats, so the same
    bits on every call."""
    _check_route(src, centers)
    b, n, cs = src.shape
    ng, cc = centers.shape[1:]
    k = idx.shape[2]
    ws, wc = folded if folded is not None else split_weight(layers[0][0], layout, cs, cc)
    win = winners(am, k)
    d1 = stack_bwd(win, am, g, signs, layers, k, slope)
    start, lst = reverse_lists(idx, win, n)
    dp, dq = pull(start, lst, win, d1, n, ng)
    c1 = dp.shape[-1]
    dsrc, dctr = products([(dp.view(b * n, c1), ws.t()), (dq.view(b * ng, c1), wc.t())], "product_bwd",
                          launches=LAUNCHES)
    return dsrc.view(b, n, cs), dctr.view(b, ng, cc)
