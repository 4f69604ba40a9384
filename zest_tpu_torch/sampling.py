"""Ray construction (counterpart of ``zest_tpu.sampling``).

The target view is the LAST view of the batch; NDC is taken with respect to
the reference view 0. Every random number of a training step (pixels,
motion-mask picks, depth jitter, density noise) is a tensor in ``Draws``, made
by ``sample_draws`` from an explicit ``torch.Generator``, so a test can feed
this package and ``zest_tpu`` the same numbers.
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
    flow_fwd_gt: Optional[torch.Tensor] = None   # [R, 2]
    flow_bwd_gt: Optional[torch.Tensor] = None   # [R, 2]
    mask_fwd_gt: Optional[torch.Tensor] = None   # [R]
    mask_bwd_gt: Optional[torch.Tensor] = None   # [R]


class Draws(NamedTuple):
    """The random numbers of one training step. R = len(xs) + len(motion_idx)
    rays of S samples; a noise entry is None when ``raw_noise_std`` is 0."""
    xs: torch.Tensor                    # [B] random pixel columns (float)
    ys: torch.Tensor                    # [B] random pixel rows (float)
    motion_idx: Optional[torch.Tensor]  # [E] rows of motion_coords, or None
    jitter: torch.Tensor                # [R, S] uniform depth jitter
    noise_static: Optional[torch.Tensor] = None    # [R, S] standard normals
    noise_dynamic: Optional[torch.Tensor] = None
    noise_prev: Optional[torch.Tensor] = None
    noise_post: Optional[torch.Tensor] = None
    noise_pp: Optional[torch.Tensor] = None

    def to(self, device) -> "Draws":
        return Draws(*(None if t is None else t.to(device) for t in self))


NOISE_FIELDS = ("noise_static", "noise_dynamic", "noise_prev", "noise_post",
                "noise_pp")


def sample_pixels_random(generator: torch.Generator, H: int, W: int,
                         n_rays: int):
    """Uniform random integer pixels. Returns float32 (xs, ys)."""
    dev = generator.device
    xs = torch.randint(0, W, (n_rays,), generator=generator, device=dev)
    ys = torch.randint(0, H, (n_rays,), generator=generator, device=dev)
    return xs.float(), ys.float()


def sample_pixels_patches(xb, yb, patch_size: int):
    """n patches of patch_size x patch_size pixels whose top-left corners
    are (xb, yb) [n] (integer offsets, drawn in [0, W - patch_size) and
    [0, H - patch_size)), each patch row-major. Returns float32 (xs, ys)."""
    d = torch.arange(patch_size, device=xb.device)
    ys = (yb[:, None, None] + d[None, :, None]).expand(-1, -1, patch_size)
    xs = (xb[:, None, None] + d[None, None, :]).expand(-1, patch_size, -1)
    return xs.reshape(-1).float(), ys.reshape(-1).float()


def _linspace(start: float, stop: float, num: int, device=None):
    """``jnp.linspace``'s float32 values: start (1 - i / (num - 1)) +
    stop i / (num - 1), the last one stop (``torch.linspace`` rounds other
    elements otherwise)."""
    step = torch.arange(num - 1, dtype=torch.float32, device=device) / \
        float(num - 1)
    out = start * (1.0 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, device=device)])


def graf_min_scale(step: int, scale_anneal: float, min_scale: float = 0.25,
                   max_scale: float = 1.0):
    """The least patch scale at ``step``: with ``scale_anneal`` > 0 it
    decays from max_scale as max_scale exp(-(step // 1000 * 3) anneal),
    held between min_scale and 0.9. A float32 0-d tensor."""
    if scale_anneal <= 0:
        return torch.tensor(min_scale, dtype=torch.float32)
    k_iter = torch.tensor(step // 1000 * 3, dtype=torch.float32)
    min_s = torch.clamp(max_scale * torch.exp(-k_iter * scale_anneal),
                        min=min_scale)
    return torch.clamp(min_s, max=0.9)


def sample_pixels_graf(draws, H: int, W: int, patch_size: int, step: int,
                       scale_anneal: float = -1.0, min_scale: float = 0.25,
                       max_scale: float = 1.0):
    """GRAF's patch: a patch_size x patch_size lattice over [-1, 1]^2,
    scaled by s in [min_s, max_scale) and shifted within the image, its
    coordinates truncated to pixels. ``draws`` [5] float32 holds the five
    random numbers: u_s, u_h, u_w in [0, 1) (the scale and the two offsets'
    sizes) and two bits (the offsets' signs). The lattice's first axis
    scales to y by (H - 1), its second to x by (W - 1), as the reference's
    coordinate mapping nets out. Returns float32 (xs, ys), row-major."""
    dev = draws.device
    min_s = graf_min_scale(step, scale_anneal, min_scale, max_scale).to(dev)
    u_s, u_h, u_w, f_h, f_w = draws.float()
    scale = torch.maximum(min_s, u_s * (max_scale - min_s) + min_s)
    lin = _linspace(-1.0, 1.0, patch_size, dev)
    max_offset = 1.0 - scale
    h = lin[None, :] * scale + u_h * max_offset * (f_h - 0.5) * 2
    w = lin[:, None] * scale + u_w * max_offset * (f_w - 0.5) * 2
    xs = torch.trunc((h + 1.0) * 0.5 * (W - 1)).expand(patch_size, -1)
    ys = torch.trunc((w + 1.0) * 0.5 * (H - 1)).expand(-1, patch_size)
    return xs.reshape(-1), ys.reshape(-1)


def sample_motion_pixels(motion_coords, idx):
    """The motion-mask pixels at rows idx of motion_coords [M, 2] (row, col).
    Returns float32 (xs, ys)."""
    hard = motion_coords[idx.long()]
    return hard[:, 1].float(), hard[:, 0].float()


def sample_pixels(generator: torch.Generator, cfg, H: int, W: int,
                  step: int = 0):
    """The step's pixels as ``cfg`` samples them: GRAF's patch of
    ``patch_size``^2 pixels with ``gan_type="graf"`` (whatever
    ``batch_size`` is), ``batch_size // patch_size^2`` square patches with
    another ``patch_size`` > 0, else ``batch_size`` random pixels.
    Returns float32 (xs, ys) on ``generator``'s device."""
    dev = generator.device
    P = cfg.patch_size
    if cfg.gan_type == "graf":
        u = torch.rand(3, generator=generator, device=dev)
        bits = torch.randint(0, 2, (2,), generator=generator, device=dev)
        return sample_pixels_graf(torch.cat([u, bits.float()]), H, W, P, step,
                                  cfg.scale_anneal)
    if P > 0:
        n = cfg.batch_size // (P * P)
        xb = torch.randint(0, W - P, (n,), generator=generator, device=dev)
        yb = torch.randint(0, H - P, (n,), generator=generator, device=dev)
        return sample_pixels_patches(xb, yb, P)
    return sample_pixels_random(generator, H, W, cfg.batch_size)


def sample_draws(generator: torch.Generator, cfg, H: int, W: int,
                 motion_count: int, extra_samples: bool,
                 step: int = 0) -> Draws:
    """Every random number of one training step, on ``generator``'s device:
    the step's pixels (``sample_pixels``; GRAF's patch scale reads
    ``step``), ``cfg.num_extra_samples`` motion-mask picks among the first
    ``motion_count`` coordinates when ``extra_samples`` (the step's phase)
    and ``cfg.train_sceneflow``, the depth jitter and, when
    ``cfg.raw_noise_std`` > 0, the density noise of the five passes (of the
    static field's alone without scene flow)."""
    dev = generator.device
    xs, ys = sample_pixels(generator, cfg, H, W, step)
    motion_idx = None
    n_rays = xs.shape[0]
    if extra_samples and cfg.train_sceneflow:
        motion_idx = torch.randint(0, max(int(motion_count), 1),
                                   (cfg.num_extra_samples,),
                                   generator=generator, device=dev)
        n_rays += cfg.num_extra_samples
    shape = (n_rays, cfg.N_samples)
    jitter = torch.rand(shape, generator=generator, device=dev)
    n_noise = len(NOISE_FIELDS) if cfg.train_sceneflow else 1
    noise = [torch.randn(shape, generator=generator, device=dev)
             if cfg.raw_noise_std > 0 and i < n_noise else None
             for i in range(len(NOISE_FIELDS))]
    return Draws(xs, ys, motion_idx, jitter, *noise)


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
               jitter: Optional[torch.Tensor] = None, flow_fwd=None,
               flow_bwd=None, mask_fwd=None, mask_bwd=None) -> RayBatch:
    """A RayBatch for pixel coords (xs, ys) of the target (last) view.

    Args:
        images: [V, H, W, 3] unnormalized images (for the target colors).
        depths: [H, W]; w2cs/c2ws: [V, 4, 4]; intrinsics: [V, 3, 3];
        near_fars: [V, 2]; flow_* [H, W, 2] and mask_* [H, W]: the target
        frame's optical flow and its masks, gathered when given.
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
    flows = {}
    if flow_fwd is not None:
        flows = dict(flow_fwd_gt=flow_fwd[yi, xi], flow_bwd_gt=flow_bwd[yi, xi],
                     mask_fwd_gt=mask_fwd[yi, xi], mask_bwd_gt=mask_bwd[yi, xi])
    return RayBatch(pts=pts, ndc=ndc, z_vals=z_vals, rays_d=rays_d,
                    color_gt=images[-1][yi, xi], depth_gt=depths[yi, xi],
                    t_vals=t_vals, **flows)
