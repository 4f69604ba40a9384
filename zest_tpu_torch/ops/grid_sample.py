"""Bilinear / trilinear grid sampling, channels-last (counterpart of
``zest_tpu.ops.grid_sample``).

Plain PyTorch: ``F.grid_sample`` with ``align_corners=True``, keeping the JAX
package's channels-last signatures so the two packages compare like with like.
Grid value g in [-1, 1] maps to pixel (g + 1) / 2 * (size - 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(img, grid, padding_mode: str = "zeros"):
    """img [H, W, C]; grid [..., 2] as (x, y) in [-1, 1]. Returns [..., C]."""
    C = img.shape[-1]
    out = F.grid_sample(img.permute(2, 0, 1)[None], grid.reshape(1, -1, 1, 2),
                        mode="bilinear", padding_mode=padding_mode,
                        align_corners=True)                  # [1, C, M, 1]
    return out[0, :, :, 0].T.reshape(*grid.shape[:-1], C)


def grid_sample_3d(vol, grid, padding_mode: str = "zeros"):
    """vol [D, H, W, C]; grid [..., 3] as (x, y, z) in [-1, 1], x indexing W
    and z indexing D. Returns [..., C]."""
    C = vol.shape[-1]
    out = F.grid_sample(vol.permute(3, 0, 1, 2)[None],
                        grid.reshape(1, -1, 1, 1, 3), mode="bilinear",
                        padding_mode=padding_mode,
                        align_corners=True)                  # [1, C, M, 1, 1]
    return out[0, :, :, 0, 0].T.reshape(*grid.shape[:-1], C)
