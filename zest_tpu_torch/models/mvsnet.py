"""MVS encoding volume: FeatureNet → plane-sweep cost volume → CostRegNet
(counterpart of ``zest_tpu.models.mvsnet``).

Reference behaviour kept on purpose:
- the raw cost volume has 9 + 32 channels: the reference RGB, the first two
  warped source RGBs, then the variance of the features. Later sources add
  to the variance only.
- D = 128 depth planes, linear in [near, far].
- the variance divides by the per-voxel count of in-bounds views.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.plane_sweep import homo_warp_cm
from ..ops.homography import homography_grid, identity_warp_cm, in_bounds_mask
from .cost_reg import CostRegNet
from .feature_net import FeatureNet

N_DEPTH_PLANES = 128


def depth_plane_values(near, far):
    """N_DEPTH_PLANES depth candidates linear in [near, far]."""
    t = torch.linspace(0.0, 1.0, N_DEPTH_PLANES, device=near.device)
    return near * (1.0 - t) + far * t


def build_cost_volume(imgs, feats, proj_mats, depth_values, pad: int = 0,
                      identity_src_warp: bool = False):
    """Variance-based plane-sweep cost volume.

    Args:
        imgs: [V, H, W, 3] ImageNet-normalized views (full resolution).
        feats: [V, h, w, C] features (h = H/4).
        proj_mats: [V, 3, 4] src_proj @ ref_proj_inv in feature space.
        depth_values: [D].
        identity_src_warp: every source proj_mat is the identity (the dynamic
            volume), so the warp is a pad and a broadcast.
    Returns: [D, h+2p, w+2p, 9 + C].
    """
    V, h, w, C = feats.shape
    D = depth_values.shape[0]
    hp, wp = h + 2 * pad, w + 2 * pad
    Px = hp * wp

    def cm(x_chw):                       # [c, h, w] -> padded [c, Px]
        return F.pad(x_chw, (pad, pad, pad, pad)).reshape(x_chw.shape[0], Px)

    # channel-major [D, C, Px]: the variance chain is elementwise and the warp
    # kernel writes this layout directly
    ref = cm(feats[0].permute(2, 0, 1)).expand(D, C, Px)
    volume_sum, volume_sq_sum = ref, ref ** 2
    mask_sum = torch.ones((D, 1, Px), dtype=feats.dtype, device=feats.device)

    # downsample to feature resolution without a low-pass (jax.image.resize
    # with antialias=False matches this)
    imgs_small = F.interpolate(imgs.permute(0, 3, 1, 2), size=(h, w),
                               mode="bilinear", align_corners=False,
                               antialias=False)                 # [V, 3, h, w]
    warped_rgb = [cm(imgs_small[0]).expand(D, 3, Px)]
    small_hwc = imgs_small.permute(0, 2, 3, 1)
    for i in range(1, V):
        if identity_src_warp:
            warped_feat, mask = identity_warp_cm(feats[i], D, pad=pad)
            if i <= 2:
                warped_rgb.append(identity_warp_cm(small_hwc[i], D, pad=pad)[0])
        else:
            # the first two sources carry their RGB through the same warp
            src = feats[i] if i > 2 else torch.cat([feats[i], small_hwc[i]], -1)
            grid = homography_grid(proj_mats[i], depth_values, (h, w), pad=pad)
            warped = homo_warp_cm(src.contiguous(), grid)       # [D, C(+3), Px]
            warped_feat = warped[:, :C]
            if i <= 2:
                warped_rgb.append(warped[:, C:])
            mask = in_bounds_mask(grid).reshape(D, 1, Px)
        mask_sum = mask_sum + mask
        volume_sum = volume_sum + warped_feat
        volume_sq_sum = volume_sq_sum + warped_feat ** 2
    while len(warped_rgb) < 3:      # fewer than 3 views: channels stay zero
        warped_rgb.append(torch.zeros_like(warped_rgb[0]))

    count = 1.0 / mask_sum
    variance = volume_sq_sum * count - (volume_sum * count) ** 2
    cost_cm = torch.cat(warped_rgb + [variance], 1)             # [D, 9+C, Px]
    return cost_cm.transpose(1, 2).reshape(D, hp, wp, 9 + C)


class MVSEncoder(nn.Module):
    """imgs [V, H, W, 3] + proj_mats [V, 3, 4] + near_far [2] →
    (volume [D, h+2p, w+2p, 8] channels-last, feats [V, h, w, 32], depths [D])."""

    def __init__(self, identity_src_warp: bool = False):
        super().__init__()
        self.identity_src_warp = identity_src_warp
        self.feature = FeatureNet()
        self.cost_reg_2 = CostRegNet(9 + 32)

    def forward(self, imgs, proj_mats, near_far, pad: int = 0):
        feats = self.feature(imgs.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        depth_values = depth_plane_values(near_far[0], near_far[1])
        cost = build_cost_volume(imgs, feats, proj_mats, depth_values, pad=pad,
                                 identity_src_warp=self.identity_src_warp)
        vol = self.cost_reg_2(cost.permute(3, 0, 1, 2)[None])[0]
        return vol.permute(1, 2, 3, 0).contiguous(), feats, depth_values
