"""Ray construction for the eval path (counterpart of ``zest_tpu.sampling``).

The target view is the LAST view of the batch; NDC is taken with respect to
the reference view 0. A stratified depth draw takes its jitter as a tensor, so
a test can feed this package and ``zest_tpu`` the same numbers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import geometry


class RayBatch(NamedTuple):
    """What the renderer needs for one batch of rays."""
    pts: torch.Tensor        # [R, S, 3] world-space sample points
    ndc: torch.Tensor        # [R, S, 3] NDC (ref view 0) sample points
    z_vals: torch.Tensor     # [R, S] depth candidates
    rays_d: torch.Tensor     # [R, 3] unnormalized ray directions
    color_gt: torch.Tensor   # [R, 3] target pixel colors
    depth_gt: torch.Tensor   # [R] target depth / disparity
    t_vals: torch.Tensor     # [S] normalized sample positions


def sample_pixels_grid(H: int, W: int, chunk: int = -1, idx: int = 0,
                       device=None):
    """Row-major full-image pixel grid, optionally one chunk of it.

    The last chunk is padded by repeats of the last pixel so every chunk has
    ``chunk`` rays; callers cut the assembled image back to H*W.
    Returns float32 (xs, ys).
    """
    n = torch.arange(H * W, device=device)
    if chunk > 0:
        n = torch.clamp(idx * chunk + torch.arange(chunk, device=device),
                        max=H * W - 1)
    return (n % W).float(), torch.div(n, W, rounding_mode="floor").float()


def depth_candidates(near, far, n_rays: int, n_samples: int,
                     jitter: Optional[torch.Tensor] = None):
    """Linear near–far candidates, jittered within their bins when ``jitter``
    (uniform [R, S] draws) is given. Returns (z_vals [R, S], t_vals [S])."""
    t_vals = torch.linspace(0.0, 1.0, n_samples, device=near.device)
    z = (near * (1.0 - t_vals) + far * t_vals).expand(n_rays, n_samples)
    if jitter is not None:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], -1)
        lower = torch.cat([z[..., :1], mids], -1)
        z = lower + (upper - lower) * jitter
    return z, t_vals


def build_rays(xs, ys, *, images, depths, w2cs, c2ws, intrinsics, near_fars,
               n_samples: int, pad: int = 0,
               jitter: Optional[torch.Tensor] = None) -> RayBatch:
    """A RayBatch for pixel coords (xs, ys) of the target (last) view.

    Args:
        images: [V, H, W, 3] unnormalized images (for the target colors).
        depths: [H, W]; w2cs/c2ws: [V, 4, 4]; intrinsics: [V, 3, 3];
        near_fars: [V, 2].
    """
    V, H, W, _ = images.shape
    inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32,
                             device=images.device)
    rays_o, rays_d = geometry.get_rays(xs, ys, intrinsics[-1], c2ws[-1])
    yi, xi = ys.long(), xs.long()
    z_vals, t_vals = depth_candidates(near_fars[-1, 0], near_fars[-1, 1],
                                      xs.shape[0], n_samples, jitter)
    pts = geometry.points_along_rays(rays_o, rays_d, z_vals)
    ndc = geometry.world_to_ndc(pts, w2cs[0], intrinsics[0], inv_scale,
                                near=near_fars[0, 0], far=near_fars[0, 1],
                                pad=pad)
    return RayBatch(pts=pts, ndc=ndc, z_vals=z_vals, rays_d=rays_d,
                    color_gt=images[-1][yi, xi], depth_gt=depths[yi, xi],
                    t_vals=t_vals)
