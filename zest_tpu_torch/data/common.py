"""What the host-side loaders share (counterpart of
``zest_tpu.data.common``): the ImageNet normalization, the motion-mask
coordinate pad, PIL resizes and the image decode with its two routes.
NumPy and PIL only, both imported where they are used.

An image loads through the native pipeline (``native_io``: decode and
Lanczos in C++, a thread per view) when ``native_io.worth_using()`` says so
and the library builds, else through PIL; ``native_io.last_route()`` says
which route the last load took and why the native one was not used.
"""
from __future__ import annotations

import numpy as np

# static length of the motion-mask coordinate list; a longer list keeps its
# first MOTION_COORDS_PAD rows (row-major), the only ones a step draws from
MOTION_COORDS_PAD = 16384

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def imagenet_normalize(img):
    """[H, W, 3] in [0, 1] -> ImageNet-normalized."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def pad_motion_coords(coords, pad_to: int = MOTION_COORDS_PAD):
    """An [M, 2] coordinate list cut or zero-padded to [pad_to, 2] ->
    (padded, count), count the valid rows (at least 1)."""
    count = min(len(coords), pad_to)
    out = np.zeros((pad_to, 2), np.float32)
    if count:
        out[:count] = coords[:count]
    return out, np.asarray(max(count, 1), np.int32)


def resize_image(img, wh, method="lanczos"):
    """Resize an [H, W] or [H, W, C] float array to ``wh`` (width, height)
    with PIL, one mode-"F" image per channel. method: 'lanczos' (images),
    'nearest' (masks, disparities), 'bilinear' (flow)."""
    from PIL import Image
    resample = {"lanczos": Image.LANCZOS, "nearest": Image.NEAREST,
                "bilinear": Image.BILINEAR}[method]
    arr = np.asarray(img)
    if arr.ndim == 2:
        return np.asarray(Image.fromarray(arr.astype(np.float32), mode="F")
                          .resize(wh, resample), np.float32)
    chans = [np.asarray(Image.fromarray(arr[..., c].astype(np.float32), mode="F")
                        .resize(wh, resample), np.float32)
             for c in range(arr.shape[-1])]
    return np.stack(chans, -1)


def load_image(path, wh):
    """A PNG or JPEG -> [H, W, 3] float32 in [0, 1], Lanczos-resized to
    ``wh``: natively when ``native_io`` is worth using and loads it, else
    with PIL (both quantize to 8 bits after the resize)."""
    from . import native_io
    why = native_io.unused_reason()
    if why is None:
        out = native_io.load_image_native(path, wh)
        if out is not None:
            native_io.note_route("native")
            return out
        why = "the native decode failed"
    from PIL import Image
    img = Image.open(path).convert("RGB").resize(wh, Image.LANCZOS)
    native_io.note_route("pil", why)
    return np.asarray(img, np.float32) / 255.0


def load_images(paths, wh):
    """``load_image`` of each path -> [N, H, W, 3]; natively, all of them in
    one call whose threads decode them in parallel."""
    from . import native_io
    if native_io.unused_reason() is None:
        out = native_io.load_images_native(paths, wh)
        if out is not None:
            native_io.note_route("native")
            return out
    return np.stack([load_image(p, wh) for p in paths])


def uv_grid(H, W):
    """[H, W, 2] absolute (x, y) pixel grid."""
    g = np.mgrid[0:H, 0:W].astype(np.float32)
    return np.stack([g[1], g[0]], -1)
