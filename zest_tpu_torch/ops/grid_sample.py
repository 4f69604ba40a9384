"""Bilinear / trilinear grid sampling, channels-last (counterpart of
``zest_tpu.ops.grid_sample``).

Plain PyTorch: ``F.grid_sample`` with ``align_corners=True``, keeping the JAX
package's channels-last signatures so the two packages compare like with like.
Grid value g in [-1, 1] maps to pixel (g + 1) / 2 * (size - 1).
``grid_sample_3d_rows`` is the trilinear lookup as a row gather (K9) and a
float32 combine, for the flow-warped points at 16-bit precision.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.dma_gather import take_rows


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


def _axis_taps(v, n: int):
    """The two taps of unnormalized coordinates v along an axis of size n:
    (indices clipped into [0, n), weights zeroed where a tap is outside)."""
    v0 = torch.floor(v)
    f = v - v0
    w0 = torch.where((v0 >= 0) & (v0 <= n - 1), 1.0 - f, 0.0)
    w1 = torch.where((v0 + 1 >= 0) & (v0 + 1 <= n - 1), f, 0.0)
    i0 = v0.clamp(0, n - 1).to(torch.int32)
    i1 = (v0 + 1).clamp(0, n - 1).to(torch.int32)
    return (i0, i1), (w0, w1)


def trilinear_row_taps(grid, D: int, H: int, W: int):
    """The 8 corner taps of trilinear samples at grid [..., 3] ((x, y, z) in
    [-1, 1], align_corners=True) in a [D, H, W] volume: (row indices
    (z * H + y) * W + x, int32 [..., 8], and weights [..., 8], zero for a
    corner outside the volume), corner o = dz * 4 + dy * 2 + dx, zest_tpu's
    octant order."""
    x = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    z = (grid[..., 2] + 1.0) * 0.5 * (D - 1)
    ix, wx = _axis_taps(x, W)
    iy, wy = _axis_taps(y, H)
    iz, wz = _axis_taps(z, D)
    corners = [(dz, dy, dx) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    idx = torch.stack([(iz[dz] * H + iy[dy]) * W + ix[dx]
                       for dz, dy, dx in corners], -1)
    w = torch.stack([wz[dz] * wy[dy] * wx[dx] for dz, dy, dx in corners], -1)
    return idx, w


def grid_sample_3d_rows(vol, grid):
    """Trilinear sample of vol [D, H, W, C] at grid [..., 3] ((x, y, z) in
    [-1, 1], zeros padding, align_corners=True) → [..., C] float32.

    The volume is a table [D*H*W, C] of one row per cell (16 bytes for C = 8
    in bf16); ``take_rows`` gathers each point's 8 corner rows, and their
    float32 combination sum_o w_o * row_o is the result. The taps follow
    ``zest_tpu.ops.grid_sample._paired_taps``: floor, each corner's weight
    zeroed outside the volume, its index clipped into it. zest_tpu gathers
    from an octo-paired super-volume (8 corners per row, TPU gathers being
    per-row latency-bound); a row per cell gathers the same values. Autograd
    gives d_grid through the weights and d_vol through the gather's
    scatter-add; a bf16 volume takes its row gradients rounded to bf16, as
    zest_tpu's does.
    """
    D, H, W, C = vol.shape
    idx, w = trilinear_row_taps(grid, D, H, W)
    rows = take_rows(vol.reshape(D * H * W, C), idx)              # [..., 8, C]
    return torch.sum(w[..., None] * rows.float(), -2)
