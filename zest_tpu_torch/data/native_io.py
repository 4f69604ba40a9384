"""ctypes bindings for the native image pipeline (``csrc/zest_io.cpp``),
counterpart of ``zest_tpu.data.native_io``.

The first use compiles the C++ with ``g++`` (libpng, libjpeg) into
``build/zest_tpu_torch/`` at the repository root, named by a hash of the
source and flags, and loads it with ctypes. Where it does not build (no
compiler, no libpng or libjpeg headers), the loaders use PIL:
``build_error()`` keeps the compiler's message.

``worth_using()`` decides as ``zest_tpu`` does: ``ZEST_NATIVE_IO=1`` forces
the native route, ``ZEST_NATIVE_IO=0`` forbids it, and otherwise it is used
on a host of two or more CPUs, where its threads decode a sample's views in
parallel (on one core PIL's SIMD loops are faster serially).
``last_route()`` says which route the last image load took, and why the
native one was not used.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "zest_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zest_tpu_torch"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-lpng", "-ljpeg", "-lpthread"]

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None
_route = ("none", "no image loaded yet")


def library_path() -> Path:
    """Where the built library lies: a hash of the source and the flags."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()
    return BUILD_DIR / f"libzest_io-{digest[:16]}.so"


def _build(so: Path) -> Optional[str]:
    """Compile to a temporary file and move it into place (so that
    processes building at once never load a half-written library). Returns
    None, or why it failed."""
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", tmp, *LIBS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        return f"g++: {e}"
    if res.returncode != 0:
        os.unlink(tmp)
        lines = [l for l in res.stderr.splitlines() if "error" in l]
        return "g++ failed: " + (lines[0] if lines else res.stderr.strip()
                                 [-300:])
    os.replace(tmp, so)
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None when it does not build
    or load (``build_error()`` says why). Tried once per process."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _error = _build(so)
            if _error is not None:
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            _error = f"loading {so.name}: {e}"
            return None
        lib.zest_decode_image.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                          ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_float)]
        lib.zest_decode_image.restype = ctypes.c_int
        lib.zest_load_images.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_float)]
        lib.zest_load_images.restype = ctypes.c_int
        _lib = lib
        return _lib


def build_error() -> Optional[str]:
    """Why the native library did not build or load, or None (also before
    the first try)."""
    return _error


def worth_using() -> bool:
    """``ZEST_NATIVE_IO=1`` or ``0`` decides; otherwise two or more CPUs."""
    flag = os.environ.get("ZEST_NATIVE_IO")
    if flag == "1":
        return True
    if flag == "0":
        return False
    return (os.cpu_count() or 1) >= 2


def unused_reason() -> Optional[str]:
    """None when a load should take the native route, else why not."""
    flag = os.environ.get("ZEST_NATIVE_IO")
    if not worth_using():
        return ("ZEST_NATIVE_IO=0" if flag == "0"
                else f"{os.cpu_count() or 1} CPU (PIL is faster on one)")
    if get_lib() is None:
        return f"the native library is unavailable ({_error})"
    return None


def note_route(route: str, why: Optional[str] = None) -> None:
    global _route
    _route = (route, why)


def last_route() -> tuple:
    """(route, why): "native" or "pil" for the last image load, and for
    "pil" why the native route was not taken."""
    return _route


def load_images_native(paths: Sequence, wh) -> Optional[np.ndarray]:
    """Decode and Lanczos-resize images -> [N, H, W, 3] float32 in [0, 1];
    None when the library is unavailable or any file fails."""
    lib = get_lib()
    if lib is None:
        return None
    w, h = int(wh[0]), int(wh[1])
    n = len(paths)
    out = np.empty((n, h, w, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib.zest_load_images(arr, n, w, h,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


def load_image_native(path, wh) -> Optional[np.ndarray]:
    batch = load_images_native([path], wh)
    return None if batch is None else batch[0]
