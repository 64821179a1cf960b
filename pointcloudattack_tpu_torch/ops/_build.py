"""Build and load the package's CUDA kernels.

The sources under ``pointcloudattack_tpu_torch/csrc/`` are compiled with
``nvcc`` into one shared library with a plain C interface, at first use,
and loaded with ``ctypes``.  Each ``.cu`` source compiles in its own
``nvcc`` process, all started together, and one more links the objects
(35.2 s on an H100 machine, where one ``nvcc`` call compiling them one
after another took 76.9 s; ``chip_smoke.py`` times both).
The library lands in
``pointcloudattack_tpu_torch/_build/<hash>/libpca_kernels.so``, keyed on a
hash of the sources and the compiler flags, so an edited source rebuilds
and an unchanged one loads at once.  A missing ``nvcc`` or a failed build
raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libpca_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclass
class BuildInfo:
    """What the last :func:`load_library` call did."""

    path: str
    built: bool  # False when an existing library of the same hash loaded
    seconds: float
    log: str  # nvcc's output (ptxas register / shared-memory report)


_LIB: ctypes.CDLL | None = None
_INFO: BuildInfo | None = None


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "of pointcloudattack_tpu_torch cannot be built"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: list[str], proc: subprocess.Popen) -> str:
    out, err = proc.communicate()
    log = out + err
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{log}")
    return log


def _compile(out: Path) -> str:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, jobs = [], []
        for src in _sources():
            if src.suffix != ".cu":
                continue
            obj = str(Path(tmp) / (src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            objs.append(obj)
        try:
            log = "".join(_run(cmd, proc) for cmd, proc in jobs)
        finally:
            for _, proc in jobs:  # a failed source leaves no compiler running
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        so = str(Path(tmp) / LIB_NAME)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", so, *objs]
        log += _run(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        os.replace(so, out)  # atomic: a concurrent loader sees all or none
    return log


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pca_chain_max_smem.argtypes = []
    lib.pca_chain_max_smem.restype = ctypes.c_size_t
    lib.pca_error_string.argtypes = [ci]
    lib.pca_error_string.restype = ctypes.c_char_p
    # device, B, N, L, dims
    lib.pca_chain_fwd_workspace.argtypes = [ci, ci, ci, ci, vp]
    lib.pca_chain_fwd_workspace.restype = ctypes.c_size_t
    # device, x, B, N, L, dims, params, ws, y, idx, stream
    lib.pca_chain_fwd.argtypes = [ci, vp, ci, ci, ci, vp, vp, vp, vp, vp, vp]
    lib.pca_chain_fwd.restype = ci
    # device, idx, B, N, CL, counts, off, wrow, cstart, cols, stream
    lib.pca_chain_lists.argtypes = [ci, vp, ci, ci, ci, vp, vp, vp, vp, vp, vp]
    lib.pca_chain_lists.restype = ci
    # device, x, B, N, L, dims, params, off, wrow, cstart, cols, g, dx, stream
    lib.pca_chain_rows.argtypes = [ci, vp, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp]
    lib.pca_chain_rows.restype = ci
    # device, xyz, start, B, N, npoint, out, stream
    lib.pca_fps.argtypes = [ci, vp, vp, ci, ci, ci, vp, vp]
    lib.pca_fps.restype = ci
    # L, dims, K, tm, bwd, mean
    lib.pca_gather_smem.argtypes = [ci, vp, ci, ci, ci, ci]
    lib.pca_gather_smem.restype = ctypes.c_size_t
    # device, src, ctr, idx, B, N, G, K, Cs, Cc, nseg, seg, L, dims, params,
    # slope, pre_act, mean, part_v, part_i, y, am, tm, stream
    lib.pca_gather_fwd.argtypes = [ci, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp, ci, vp, vp,
                                   cf, ci, ci, vp, vp, vp, vp, ci, vp]
    lib.pca_gather_fwd.restype = ci
    # device, src, ctr, idx, B, N, G, K, Cs, Cc, nseg, seg, L, dims, params,
    # wts, slope, pre_act, mean, am, g, dsrc, dctr_part, dctr, tm, stream
    lib.pca_gather_bwd.argtypes = [ci, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp, ci, vp, vp,
                                   vp, cf, ci, ci, vp, vp, vp, vp, vp, ci, vp]
    lib.pca_gather_bwd.restype = ci
    # device, nprob, then (a, w, out, R, Kd, M, lda, wk, wn) twice, stream
    lib.pca_hoist_product.argtypes = [ci, ci, *[vp, vp, vp, ci, ci, ci, ci, ci, ci] * 2, vp]
    lib.pca_hoist_product.restype = ci
    # device, p, sp, q, sq, idx, bias, mean, mul, beta, B, N, G, K, C, y, am, stream
    lib.pca_hoist_max.argtypes = [ci, vp, ci, vp, ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp]
    lib.pca_hoist_max.restype = ci
    lib.pca_hoist_lists_parts.argtypes = [ci]
    lib.pca_hoist_lists_parts.restype = ci
    # device, idx, B, N, G, K, ks, parts, start, list, stream
    lib.pca_hoist_lists.argtypes = [ci, vp, ci, ci, ci, ci, ci, ci, vp, vp, vp]
    lib.pca_hoist_lists.restype = ci
    # device, start, list, am, g, B, N, G, K, ks, C, dp, stream
    lib.pca_hoist_pull.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, vp]
    lib.pca_hoist_pull.restype = ci
    # device, xyz, ctr, B, N, G, K, Cc, r2, idx, stream
    lib.pca_ball_slots.argtypes = [ci, vp, vp, ci, ci, ci, ci, ci, cf, vp, vp]
    lib.pca_ball_slots.restype = ci
    lib.pca_ball_sign_words.argtypes = [ci, vp]
    lib.pca_ball_sign_words.restype = ci
    # device, p, sp, q, sq, idx, B, N, G, K, L, dims, params, wstrides, slope, y, am, signs, stream
    lib.pca_ball_stack_fwd.argtypes = [ci, vp, ci, vp, ci, vp, ci, ci, ci, ci, ci, vp, vp, vp, cf, vp, vp, vp, vp]
    lib.pca_ball_stack_fwd.restype = ci
    # device, am, BG, K, CL, mask, counts, ticket, off, wrow, stream
    lib.pca_ball_winners.argtypes = [ci, vp, ci, ci, ci, vp, vp, vp, vp, vp, vp]
    lib.pca_ball_winners.restype = ci
    # device, off, wrow, mask, am, g, signs, BG, K, L, dims, params, wstrides, slope, d1, stream
    lib.pca_ball_stack_bwd.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp, cf, vp, vp]
    lib.pca_ball_stack_bwd.restype = ci
    lib.pca_ball_lists_parts.argtypes = [ci]
    lib.pca_ball_lists_parts.restype = ci
    # device, idx, off, wrow, B, N, G, parts, start, list, stream
    lib.pca_ball_lists.argtypes = [ci, vp, vp, vp, ci, ci, ci, ci, vp, vp, vp]
    lib.pca_ball_lists.restype = ci
    # device, start, list, off, d1, B, N, G, C, dp, dq, stream
    lib.pca_ball_pull.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, ci, vp, vp, vp]
    lib.pca_ball_pull.restype = ci
    # device, x, nrm, B, N, C, k, out, stream
    lib.pca_knn.argtypes = [ci, vp, vp, ci, ci, ci, ci, vp, vp]
    lib.pca_knn.restype = ci
    # device, x, y, B, N, M, mins, argmin, stream
    lib.pca_min_rows.argtypes = [ci, vp, vp, ci, ci, ci, vp, vp, vp]
    lib.pca_min_rows.restype = ci
    # device, x, y, B, N, M, rmin, rarg, cmin, carg, stream
    lib.pca_min_both_fwd.argtypes = [ci, vp, vp, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp]
    lib.pca_min_both_fwd.restype = ci
    # device, x, y, rarg, carg, gr, gc, B, N, M, dx, dy, stream
    lib.pca_min_both_bwd.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp]
    lib.pca_min_both_bwd.restype = ci
    # L, dims, K, tm, bwd
    lib.pca_group_smem.argtypes = [ci, vp, ci, ci, ci]
    lib.pca_group_smem.restype = ctypes.c_size_t
    # device, x, B, G, K, L, dims, params, slope, mean, y, am, tm, stream
    lib.pca_group_fwd.argtypes = [ci, vp, ci, ci, ci, ci, vp, vp, cf, ci, vp, vp, ci, vp]
    lib.pca_group_fwd.restype = ci
    # device, x, B, G, K, L, dims, params, wts, slope, mean, am, g, dx, tm, stream
    lib.pca_group_bwd.argtypes = [ci, vp, ci, ci, ci, ci, vp, vp, vp, cf, ci, vp, vp, vp, ci, vp]
    lib.pca_group_bwd.restype = ci
    # K, C0, CL
    lib.pca_group_mean1_smem.argtypes = [ci, ci, ci]
    lib.pca_group_mean1_smem.restype = ctypes.c_size_t
    # device, x, B, G, K, C0, CL, params, slope, g, dx, tc, stream
    lib.pca_group_mean1_bwd.argtypes = [ci, vp, ci, ci, ci, ci, ci, vp, cf, vp, vp, ci, vp]
    lib.pca_group_mean1_bwd.restype = ci
    # K, C0, CL
    lib.pca_group_fwd1_smem.argtypes = [ci, ci, ci]
    lib.pca_group_fwd1_smem.restype = ctypes.c_size_t
    # device, x, B, G, K, C0, CL, params, slope, mean, y, am, stream
    lib.pca_group_fwd1.argtypes = [ci, vp, ci, ci, ci, ci, ci, vp, cf, ci, vp, vp, vp]
    lib.pca_group_fwd1.restype = ci
    # K, C0, CL
    lib.pca_group_max1_smem.argtypes = [ci, ci, ci]
    lib.pca_group_max1_smem.restype = ctypes.c_size_t
    # device, am, g, B, G, K, C0, CL, w, dx, stream
    lib.pca_group_max1_bwd.argtypes = [ci, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp]
    lib.pca_group_max1_bwd.restype = ci
    # L, dims, K, bwd, tile, stages
    lib.pca_group_mmax_plan.argtypes = [ci, vp, ci, ci, vp, vp]
    lib.pca_group_mmax_plan.restype = ctypes.c_size_t
    # device, x, B, G, K, L, dims, params, slope, y, am, hz, stream
    lib.pca_group_mmax_fwd.argtypes = [ci, vp, ci, ci, ci, ci, vp, vp, cf, vp, vp, vp, vp]
    lib.pca_group_mmax_fwd.restype = ci
    # device, am, B, G, K, CL, counts, off, wrow, stream
    lib.pca_group_mmax_lists.argtypes = [ci, vp, ci, ci, ci, ci, vp, vp, vp, vp]
    lib.pca_group_mmax_lists.restype = ci
    # device, x, B, G, K, L, dims, params, slope, am, g, off, wrow, dx, mask_out, stream
    lib.pca_group_mmax_rows.argtypes = [ci, vp, ci, ci, ci, ci, vp, vp, cf, vp, vp, vp, vp, vp, vp, vp]
    lib.pca_group_mmax_rows.restype = ci
    # device, a, nrm, B, N, k, kap, picks, stream
    lib.pca_kappa_fwd.argtypes = [ci, vp, vp, ci, ci, ci, vp, vp, vp]
    lib.pca_kappa_fwd.restype = ci
    # device, a, nrm, idx, B, N, k, kap, stream
    lib.pca_kappa_idx_fwd.argtypes = [ci, vp, vp, vp, ci, ci, ci, vp, vp]
    lib.pca_kappa_idx_fwd.restype = ci
    # device, a, nrm, picks, dkap, B, N, k, start, list, dnrm, dadv, stream
    lib.pca_kappa_bwd.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp, vp, vp]
    lib.pca_kappa_bwd.restype = ci


def load_library() -> ctypes.CDLL:
    """The kernel library, built from the package's sources if needed."""
    global _LIB, _INFO
    if _LIB is not None:
        return _LIB
    out = BUILD_DIR / _source_hash() / LIB_NAME
    t0 = time.perf_counter()
    built, log = False, ""
    if not out.is_file():
        log = _compile(out)
        built = True
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    _INFO = BuildInfo(str(out), built, time.perf_counter() - t0, log)
    _LIB = lib
    return lib


def build_info() -> BuildInfo | None:
    """Details of the library load, or None before the first one."""
    return _INFO


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.pca_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
