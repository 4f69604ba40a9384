"""Two-field volume rendering, eval path (counterpart of ``zest_tpu.render``).

Field evaluation and conditioning features are injected as callables (see
``RenderModels``); ``system.ZestSystem`` binds them to the kernel wrappers.
``render_rays`` renders the static field and the dynamic field at time t and
composites them — the val return of ``zest_tpu.render.render_rays``. The
t±1 and chain passes belong to training and come with the training slice.

Conventions: rays [R, ...], samples S on the last axis of z-shaped tensors.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import geometry
from .kernels.color_gather import gather_colors
from .models.embedding import positional_encoding


def _exclusive_transmittance(one_minus_alpha):
    ones = torch.ones_like(one_minus_alpha[..., :1])
    return torch.cumprod(torch.cat([ones, one_minus_alpha + 1e-10], -1),
                         -1)[..., :-1]


def raw2alpha(sigma, dists):
    """α = 1 − exp(−σ·δ) and its compositing weights. sigma, dists [R, S]."""
    alpha = 1.0 - torch.exp(-sigma * dists)
    return alpha, alpha * _exclusive_transmittance(1.0 - alpha)


def raw2outputs(raw, z_vals, dists, white_bkgd: bool = False):
    """raw [R, S, 4] → (rgb_map [R, 3], disp_map [R], acc_map [R],
    weights [R, S], depth_map [R], alpha [R, S])."""
    rgb = torch.sigmoid(raw[..., :3])
    alpha, weights = raw2alpha(torch.relu(raw[..., 3]), dists)
    rgb_map = torch.sum(weights[..., None] * rgb, -2)
    depth_map = torch.sum(weights * z_vals, -1)
    acc_map = torch.sum(weights, -1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, disp_map, acc_map, weights, depth_map, alpha


def raw2outputs_blending(raw_dy, raw_rigid, raw_blend_w, z_vals, dists):
    """Static + dynamic compositing with predicted blend weights.

    Returns (rgb_map, depth_map, rgb_map_fg, depth_map_fg, weights_fg,
    weights_dy); fg is the dynamic field alone."""
    rgb_dy = torch.sigmoid(raw_dy[..., :3])
    rgb_rigid = torch.sigmoid(raw_rigid[..., :3])
    opacity_dy = torch.relu(raw_dy[..., 3])
    opacity_rigid = torch.relu(raw_rigid[..., 3])
    alpha_dy = (1.0 - torch.exp(-opacity_dy * dists)) * raw_blend_w
    alpha_rig = (1.0 - torch.exp(-opacity_rigid * dists)) * (1.0 - raw_blend_w)
    Ts = _exclusive_transmittance((1.0 - alpha_dy) * (1.0 - alpha_rig))
    weights_dy = Ts * alpha_dy
    weights_rig = Ts * alpha_rig
    rgb_map = torch.sum(weights_dy[..., None] * rgb_dy
                        + weights_rig[..., None] * rgb_rigid, -2)
    depth_map = torch.sum((weights_dy + weights_rig) * z_vals, -1)
    alpha_fg, weights_fg = raw2alpha(opacity_dy, dists)
    depth_map_fg = torch.sum(weights_fg * z_vals, -1)
    rgb_map_fg = torch.sum(weights_fg[..., None] * rgb_dy, -2)
    return rgb_map, depth_map, rgb_map_fg, depth_map_fg, weights_fg, weights_dy


def gen_dir_feature(w2c_ref, dirs_unit):
    """View directions rotated into the reference camera."""
    return dirs_unit @ w2c_ref[:3, :3].T


def build_color_features(pts_world, images, w2cs, intrinsics):
    """Per-source-view RGB and strict in-bounds mask at ray points.

    Each point is projected into each view (near 2, far 6, no pad), the
    unnormalized image is sampled bilinearly with border padding — all views
    in one kernel launch — and a mask of projections strictly inside the
    image is appended.

    Args: pts_world [R, S, 3]; images [V, H, W, 3]; w2cs [V, 4, 4];
        intrinsics [V, 3, 3].
    Returns: [R, S, V*4], per view [r, g, b, mask].
    """
    V, H, W, _ = images.shape
    R, S, _ = pts_world.shape
    inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32,
                             device=images.device)
    ndc_xy = torch.stack([
        geometry.world_to_ndc(pts_world, w2cs[v], intrinsics[v], inv_scale,
                              near=2.0, far=6.0, pad=0)[..., :2]
        for v in range(V)])                                     # [V, R, S, 2]
    xy = (ndc_xy * inv_scale).reshape(V, R * S, 2).contiguous()
    rgb = gather_colors(images.contiguous(), xy).reshape(V, R, S, 3)
    grid = ndc_xy * 2.0 - 1.0
    inside = (grid > -1.0) & (grid < 1.0)
    mask = (inside[..., 0] & inside[..., 1]).to(rgb.dtype)
    feats = torch.cat([rgb, mask[..., None]], -1)               # [V, R, S, 4]
    return feats.permute(1, 2, 0, 3).reshape(R, S, V * 4)


class RenderModels(NamedTuple):
    """Field evaluators and conditioning-feature callables for render_rays."""
    static_fn: Callable       # (pts_emb, feats, views) -> raw [R, S, 5]
    dynamic_fn: Callable      # (xyzt_emb, feats, views) -> raw [R, S, 12]
    static_feats: Callable    # (pts_world, ndc) -> [R, S, F]
    dynamic_vol: Callable     # (ndc) -> [R, S, 8]
    dynamic_col: Callable     # (pts_world) -> [R, S, 16]
    multires: int = 10
    multires_views: int = 4


def _embed_dirs(rays_d, w2c_ref, n_samples, multires_views):
    cos_angle = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    views = positional_encoding(gen_dir_feature(w2c_ref, rays_d / cos_angle),
                                multires_views)
    return views[:, None, :].expand(views.shape[0], n_samples, views.shape[-1])


def static_field_inputs(models: RenderModels, rays, im_w2c_ref):
    """The static field's (embedded points, features, embedded views) at a
    ray batch's points, each [R, S, ...]."""
    return (positional_encoding(rays.ndc, models.multires),
            models.static_feats(rays.pts, rays.ndc),
            _embed_dirs(rays.rays_d, im_w2c_ref, rays.pts.shape[1],
                        models.multires_views))


def dynamic_field_inputs(models: RenderModels, rays, nb_w2c_ref,
                         ref_frame_idx):
    """The dynamic field's (embedded points and time, features, embedded
    views) at a ray batch's points at the reference time, each [R, S, ...]."""
    t_ch = torch.full_like(rays.ndc[..., :1], 1.0) * ref_frame_idx
    return (positional_encoding(torch.cat([rays.ndc, t_ch], -1),
                                models.multires),
            torch.cat([models.dynamic_vol(rays.ndc),
                       models.dynamic_col(rays.pts)], -1),
            _embed_dirs(rays.rays_d, nb_w2c_ref, rays.pts.shape[1],
                        models.multires_views))


def render_rays(models: RenderModels, rays, *, im_w2c_ref, nb_w2c_ref,
                ref_frame_idx, white_bkgd: bool = False) -> dict:
    """Render one ray batch through the static field and the dynamic field at
    the reference time, and composite both.

    Returns the eval maps: rgb_map, depth_map (static), rgb_map_ref,
    depth_map_ref (blended), rgb_map_ref_dy, depth_map_ref_dy (dynamic
    alone) and weights_map_dd (the dynamic field's share of the weights).
    """
    cos_angle = torch.linalg.norm(rays.rays_d, dim=-1, keepdim=True)
    dists = geometry.depth2dist(rays.z_vals, cos_angle)

    raw_static = models.static_fn(*static_field_inputs(models, rays,
                                                       im_w2c_ref))
    raw_rgba, raw_blend_w = raw_static[..., :4], raw_static[..., 4]
    rgb_map, _, _, _, depth_map, _ = raw2outputs(raw_rgba, rays.z_vals, dists,
                                                 white_bkgd)

    raw_dy = models.dynamic_fn(*dynamic_field_inputs(models, rays, nb_w2c_ref,
                                                     ref_frame_idx))
    (rgb_map_ref, depth_map_ref, rgb_map_ref_dy, depth_map_ref_dy,
     _, weights_ref_dd) = raw2outputs_blending(raw_dy[..., :4], raw_rgba,
                                               raw_blend_w, rays.z_vals, dists)
    return {"rgb_map": rgb_map, "depth_map": depth_map,
            "rgb_map_ref": rgb_map_ref, "depth_map_ref": depth_map_ref,
            "rgb_map_ref_dy": rgb_map_ref_dy,
            "depth_map_ref_dy": depth_map_ref_dy,
            "weights_map_dd": torch.sum(weights_ref_dd, -1)}
