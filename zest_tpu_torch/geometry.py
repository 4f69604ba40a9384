"""Camera / ray / NDC geometry on tensors (counterpart of ``zest_tpu.geometry``).

The JAX package pins ``Precision.HIGHEST`` on these matmuls because its default
rounds through bf16; here every product is plain float32, with TF32 left off
(``torch.backends.cuda.matmul.allow_tf32`` is False by default).

Convention: rays ``[R, 3]``, ray samples ``[R, S, 3]``.
"""
from __future__ import annotations

import torch


def pixel_dirs_cam(xs, ys, intrinsic):
    """Camera-space direction ``[(x-cx)/fx, (y-cy)/fy, 1]`` for pixel coords [R]."""
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    return torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(xs)], -1)


def get_rays(xs, ys, intrinsic, c2w):
    """World-space rays of one camera: (rays_o [3], rays_d [R, 3] unnormalized)."""
    dirs = pixel_dirs_cam(xs, ys, intrinsic)
    return c2w[:3, -1], dirs @ c2w[:3, :3].T


def points_along_rays(rays_o, rays_d, z_vals):
    """[R, S, 3] = o + z * d."""
    return rays_o[None, None, :] + z_vals[..., None] * rays_d[:, None, :]


def world_to_ndc(points, w2c_ref, intrinsic_ref, inv_scale, near, far,
                 pad: int = 0):
    """World points → reference-view NDC in [0, 1]^3, with the pad correction.

    Args:
        points: [..., 3]; w2c_ref: [4, 4];
        intrinsic_ref: [3, 3]; inv_scale: [2] = (W-1, H-1).
    Returns: [..., 3].
    """
    points = points @ w2c_ref[:3, :3].T + w2c_ref[:3, 3]
    pix = points @ intrinsic_ref.T
    xy = (pix[..., :2] / pix[..., 2:3]) / inv_scale
    z = (pix[..., 2:3] - near) / (far - near)
    if pad > 0:
        # the encoding volume covers the feature map (input / 4) plus pad
        wh_feat = (inv_scale + 1.0) / 4.0
        xy = xy * (wh_feat / (wh_feat + pad * 2)) + pad / (wh_feat + pad * 2)
    return torch.cat([xy, z], -1)


def depth2dist(z_vals, cos_angle):
    """Distances between adjacent samples, the last one 1e10, times |d|."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    return dists * cos_angle


def normalize_frame_idx(frame_t, num_frames):
    """Frame index normalized to [-1, 1]."""
    return frame_t / num_frames * 2.0 - 1.0
