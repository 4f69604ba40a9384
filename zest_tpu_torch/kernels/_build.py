"""Build and load the port's CUDA kernels.

Every source in ``zest_tpu_torch/csrc/*.cu`` compiles with ``nvcc`` for
``sm_90a`` to an object file, all at once in parallel processes, and the
objects link into ONE shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes). The
library lands in ``build/zest_tpu_torch/`` at the repository root, named by
a hash of the sources and flags: an edited source rebuilds, an unchanged one
loads the existing file. Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zest_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points: name -> argtypes (every one returns cudaGetLastError())
SIGNATURES = {
    # src, grid, out, D, h, w, C, P, stream
    "zt_plane_sweep_warp": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # vol, ndc, out, R rays, S samples, D, Hv, Wv, C, stream
    "zt_trilinear_sample": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # images, xy, out, V, N, H, W, stream
    "zt_color_gather": [_P, _P, _P, _I, _I, _I, _I, _P],
    # wpack, offsets(host int*), wt, P, F, V, width, depth, skip, stream
    "zt_fused_nerf_pack_tc32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # P, F, V, width, depth, skip -> floats of the float32 operand pack
    "zt_fused_nerf_pack_tc32_len": [_I, _I, _I, _I, _I, _I],
    # pts, feats, views, wpack, offsets(host int*), wt, out,
    # n, P, F, V, width, depth, skip, n_extra, stream
    "zt_fused_nerf_forward_tc32": [_P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # width, P, F, V -> bytes of dynamic shared memory per block
    "zt_fused_nerf_forward_tc32_smem": [_I, _I, _I, _I],
    # wpack, offsets(host int*), wbf16, P, F, V, width, depth, skip, stream
    "zt_fused_nerf_pack_tc": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # P, F, V, width, depth, skip -> elements of the bf16 pack
    "zt_fused_nerf_pack_tc_len": [_I, _I, _I, _I, _I, _I],
    # pts, feats, views, wpack, offsets(host int*), wbf16, out,
    # n, P, F, V, width, depth, skip, n_extra, stream
    "zt_fused_nerf_forward_tc": [_P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # width, P, F, V -> bytes of dynamic shared memory per block
    "zt_fused_nerf_forward_tc_smem": [_I, _I, _I, _I],
    # n, chunk, P, F, V, width, depth, skip, n_extra, floats (host long long*)
    "zt_fused_nerf_backward_scratch": [_I, _I, _I, _I, _I, _I, _I, _I, _I,
                                       _P],
    # rows, P, F, V, width, depth, skip, n_extra, at (host long long[9])
    "zt_fused_nerf_backward_layout": [_I, _I, _I, _I, _I, _I, _I, _I, _P],
    # pts, feats, views, g, wpack, offsets (host int*), wt, cond, z, feat,
    # hv, g_heads, out (or null), n, P, F, V, width, depth, skip, n_extra,
    # stream
    "zt_fused_nerf_recompute_tc32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                     _I, _P],
    # wpack, offsets (host int*), cond, z, hv, g_heads, dz, d_cond,
    # d_feature, d_hv, d_pts, d_feats, d_views, n, P, F, V, width, depth,
    # skip, n_extra, stream
    "zt_fused_nerf_input_grads_tc32": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _I, _I, _I, _P],
    # width -> bytes of dynamic shared memory per block of input_grads
    "zt_fused_nerf_input_grads_tc32_smem": [_I],
    # pts, feats, views, cond, z, feat, hv, dz, d_cond, d_feature, d_hv,
    # g_heads, offsets (host int*), d_pack,
    # n, P, F, V, width, depth, skip, n_extra, stream
    "zt_fused_nerf_weight_grads_tc32": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _I, _I, _I, _I, _P],
    # wpack, offsets(host int*), wbt, P, F, V, width, depth, skip, stream
    "zt_fused_nerf_pack_bwd_tc": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # P, F, V, width, depth, skip -> elements of the backward pack
    "zt_fused_nerf_pack_bwd_tc_len": [_I, _I, _I, _I, _I, _I],
    # n, chunk, P, F, V, width, depth, skip, n_extra, bytes (host long long*)
    "zt_fused_nerf_backward_tc_scratch": [_I, _I, _I, _I, _I, _I, _I, _I, _I,
                                          _P],
    # pts, feats, views, g, wpack, offsets (host int*), wbf16, wbt, scratch,
    # scratch_bytes, chunk, d_pts, d_feats, d_views, d_pack, out (or null),
    # keep, n, P, F, V, width, depth, skip, n_extra, stream
    "zt_fused_nerf_backward_tc": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I,
                                  _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _P],
    # n, chunk, P, F, V, width, depth, skip, n_extra, at (host long long[5])
    "zt_fused_nerf_backward_tc_layout": [_I, _I, _I, _I, _I, _I, _I, _I, _I,
                                         _P],
    # width, P, F, V -> bytes of dynamic shared memory per block of pass 1
    "zt_fused_nerf_backward_tc_smem": [_I, _I, _I, _I],
    # g, ndc, d_vol, n_points, g channels, D, Hv, Wv, stream
    "zt_trilinear_grad_volume": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # vol, ndc, g, d_ndc, n_points, D, Hv, Wv, stream
    "zt_trilinear_grad_coords": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # g, grid, d_src, D, h, w, C, Hp, Wp, stream
    "zt_plane_sweep_warp_backward": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # tab, idx, out, n, m, row_bytes, stream
    "zt_row_gather": [_P, _P, _P, _L, _L, _I, _P],
    # g, idx, acc, n, m, cw, elem_bytes, stream
    "zt_row_scatter_add": [_P, _P, _P, _L, _L, _I, _I, _P],
    # s, wc, b, c, rows, T, bf16, stream
    "zt_fold_codes": [_P, _P, _P, _P, _I, _I, _I, _P],
    # s, wc, d_c, d_s, d_wc, rows, T, bf16, stream
    "zt_fold_codes_grad": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def build() -> Path:
    """Compile the library if no build of the current sources exists.
    Returns its path; ``build_info`` records the time and the ptxas report."""
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libzest_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        log = out.with_suffix(".log")
        build_info.update(path=str(out), seconds=0.0,
                          ptxas=log.read_text() if log.exists() else "")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{s.stem}.o" for s in srcs]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(s)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(s.name, log) for s, p, log in zip(srcs, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name}:\n{log}" for name, log in failed))
        # link to a private name, then rename: a concurrent build never
        # loads a half-written library
        lib = Path(tmp) / out.name
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o",
                               str(lib), *map(str, objs)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(lib, out)
    log = "".join(logs) + proc.stderr + proc.stdout
    out.with_suffix(".log").write_text(log)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      ptxas=log)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.zt_error_string.argtypes = [ctypes.c_int]
        lib.zt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if err != 0:
        text = library().zt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {text} ({err})")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, as the raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_f32(name: str, *tensors) -> None:
    """Raise unless every tensor is float32, contiguous and on one CUDA card."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
