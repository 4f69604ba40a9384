"""Plane-sweep homography warping (counterpart of ``zest_tpu.ops.homography``).

For every depth plane d and padded reference pixel (x, y), the source pixel is
p = R [x, y, 1]^T + T / d; the source features are sampled there bilinearly
with zeros padding (align_corners=True). The reference pixel grid covers the
padded extent (coords -pad .. H+pad-1) while the normalization to [-1, 1]
uses the unpadded size, so padded border pixels sample out of bounds.
"""
from __future__ import annotations

import torch

from .grid_sample import grid_sample_2d


def homography_grid(proj_mat, depth_values, feat_hw, pad: int = 0):
    """Source sampling grid for every (depth, padded ref pixel).

    Args: proj_mat [3, 4] = src_proj @ ref_proj_inv (feature space);
        depth_values [D]; feat_hw (H, W) unpadded.
    Returns: grid [D, H+2p, W+2p, 2] as normalized (x, y).
    """
    H, W = feat_hw
    dev = proj_mat.device
    ys = torch.arange(H + 2 * pad, dtype=torch.float32, device=dev) - pad
    xs = torch.arange(W + 2 * pad, dtype=torch.float32, device=dev) - pad
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    ref = torch.stack([gx, gy, torch.ones_like(gx)], -1)          # [Hp, Wp, 3]
    src = (ref @ proj_mat[:, :3].T)[None] \
        + proj_mat[:, 3] / depth_values[:, None, None, None]      # [D, Hp, Wp, 3]
    xy = src[..., :2] / src[..., 2:3]
    return torch.stack([xy[..., 0] / ((W - 1) / 2.0) - 1.0,
                        xy[..., 1] / ((H - 1) / 2.0) - 1.0], -1)


def homo_warp(src_feat, proj_mat, depth_values, pad: int = 0):
    """Warp src_feat [H, W, C] to every depth plane of the reference frustum.
    Returns (warped [D, H+2p, W+2p, C], grid [D, H+2p, W+2p, 2])."""
    H, W, _ = src_feat.shape
    grid = homography_grid(proj_mat, depth_values, (H, W), pad=pad)
    return grid_sample_2d(src_feat, grid, padding_mode="zeros"), grid


def identity_warp_cm(src_feat, n_planes: int, pad: int = 0):
    """Warp for an identity proj_mat in channel-major form: the grid is the
    reference pixel grid itself, so the warp is a zero pad broadcast over the
    planes, and the strict in-bounds mask drops the 1-pixel image border.

    The dynamic volume takes this path: its neighbour proj_mats are identity.
    Returns (warped [D, C, Hp*Wp], mask [D, 1, Hp*Wp]).
    """
    H, W, C = src_feat.shape
    padded = torch.nn.functional.pad(src_feat.permute(2, 0, 1),
                                     (pad, pad, pad, pad))     # [C, Hp, Wp]
    Hp, Wp = H + 2 * pad, W + 2 * pad
    dev = src_feat.device
    ys = torch.arange(Hp, device=dev) - pad
    xs = torch.arange(Wp, device=dev) - pad
    my = ((ys > 0) & (ys < H - 1)).to(src_feat.dtype)
    mx = ((xs > 0) & (xs < W - 1)).to(src_feat.dtype)
    mask = (my[:, None] * mx[None, :]).reshape(1, 1, Hp * Wp)
    return (padded.reshape(1, C, Hp * Wp).expand(n_planes, C, Hp * Wp),
            mask.expand(n_planes, 1, Hp * Wp))


def in_bounds_mask(grid):
    """Strict in-bounds mask of a normalized grid: both coords in (-1, 1)."""
    inside = (grid > -1.0) & (grid < 1.0)
    return (inside[..., 0] & inside[..., 1]).float()
