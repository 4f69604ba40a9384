"""Depth colormaps and PNG dumps (counterpart of
``zest_tpu.utils.visualize``), NumPy and the standard library only: the PNG
writer needs no imaging package."""
from __future__ import annotations

import binascii
import struct
import zlib

import numpy as np


def _jet(x):
    """Minimal JET colormap: x in [0, 1] -> rgb in [0, 1]."""
    x = np.clip(x, 0.0, 1.0)
    four = 4.0 * x
    r = np.clip(np.minimum(four - 1.5, -four + 4.5), 0, 1)
    g = np.clip(np.minimum(four - 0.5, -four + 3.5), 0, 1)
    b = np.clip(np.minimum(four + 0.5, -four + 2.5), 0, 1)
    return np.stack([r, g, b], -1)


def visualize_depth(depth, minmax=None):
    """[H, W] depth -> [H, W, 3] JET image, scaled from the smallest positive
    depth (or minmax) to the largest."""
    x = np.nan_to_num(np.asarray(depth, np.float32))
    if minmax is None:
        pos = x[x > 0]
        mi = pos.min() if pos.size else 0.0
        ma = x.max()
    else:
        mi, ma = minmax
    x = (x - mi) / (ma - mi + 1e-8)
    return _jet(x)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", binascii.crc32(kind + data)))


def save_image(path, img):
    """Save an [H, W, 3] or [H, W] float array in [0, 1] as an 8-bit RGB
    PNG (each value clipped, times 255, truncated)."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    H, W, _ = arr.shape
    # each row behind filter type 0 (none)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), arr.reshape(H, W * 3)],
                         axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
           + _png_chunk(b"IDAT", zlib.compress(raw.tobytes()))
           + _png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
