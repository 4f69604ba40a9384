"""Source-view color gather: CUDA kernel and its plain PyTorch twin.

Replaces ``zest_tpu/kernels/color_gather.py:_gather_pallas`` (the forward
``pallas_call`` behind ``gather_colors_banded``); the kernel is
``csrc/color_gather.cu`` and takes every view in one launch. The projection
and the in-bounds mask stay in ``render.build_color_features``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build


def gather_colors_plain(images, xy):
    """Twin: ``F.grid_sample`` (border, align_corners=True) per view.

    images [V, H, W, 3]; xy [V, N, 2] pixel coords. Returns [V, N, 3].
    """
    V, H, W, C = images.shape
    grid = xy / torch.tensor([(W - 1) * 0.5, (H - 1) * 0.5],
                             dtype=xy.dtype, device=xy.device) - 1.0
    out = F.grid_sample(images.permute(0, 3, 1, 2), grid[:, :, None, :],
                        mode="bilinear", padding_mode="border",
                        align_corners=True)                   # [V, C, N, 1]
    return out[..., 0].transpose(1, 2)


def gather_colors(images, xy):
    """Bilinear border-mode sample of images [V, H, W, 3] at xy [V, N, 2].

    CPU tensors take the twin; CUDA tensors launch the kernel or raise.
    """
    if images.device.type == "cpu":
        return gather_colors_plain(images, xy)
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"gather_colors: images must be [V, H, W, 3], got "
                         f"{tuple(images.shape)}")
    V, H, W, _ = images.shape
    if xy.dim() != 3 or xy.shape[0] != V or xy.shape[-1] != 2:
        raise ValueError(f"gather_colors: xy must be [{V}, N, 2], got "
                         f"{tuple(xy.shape)}")
    _build.require_cuda_f32("gather_colors", images, xy)
    N = xy.shape[1]
    out = torch.empty((V, N, 3), device=images.device, dtype=torch.float32)
    err = _build.library().zt_color_gather(
        images.data_ptr(), xy.data_ptr(), out.data_ptr(), V, N, H, W,
        _build.stream_ptr(images))
    _build.check(err, "gather_colors")
    gather_colors.launches += 1
    return out


gather_colors.launches = 0
