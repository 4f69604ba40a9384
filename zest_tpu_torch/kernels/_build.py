"""Build and load the port's CUDA kernels.

All sources in ``zest_tpu_torch/csrc/*.cu`` compile with ``nvcc`` for
``sm_90a`` into ONE shared library with a plain C interface, loaded with
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> argtypes (every one returns cudaGetLastError())
SIGNATURES = {
    # src, grid, out, D, h, w, C, P, stream
    "zt_plane_sweep_warp": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # vol, ndc, out, n_points, D, Hv, Wv, stream
    "zt_trilinear_sample": [_P, _P, _P, _I, _I, _I, _I, _P],
    # images, xy, out, V, N, H, W, stream
    "zt_color_gather": [_P, _P, _P, _I, _I, _I, _I, _P],
    # pts, feats, views, wpack, offsets(host int*), out,
    # n, P, F, V, width, depth, skip, n_extra, stream
    "zt_fused_nerf_forward": [_P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _P],
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
        build_info.update(path=str(out), seconds=0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build to a private name, then rename: a concurrent build never loads a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    log = proc.stderr + proc.stdout
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
