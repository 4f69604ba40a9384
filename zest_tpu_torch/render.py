"""Two-field volume rendering (counterpart of ``zest_tpu.render``).

Field evaluation and conditioning features are injected as callables (see
``RenderModels``); ``system.ZestSystem`` binds them to the kernel wrappers.
``render_rays`` renders the static field and the dynamic field at time t and
composites them — the val return of ``zest_tpu.render.render_rays``.
``render_rays_train`` is its training return: density noise from the step's
draws, the t-1 / t+1 re-render of the dynamic field at flow-warped points in
one stacked field call, the chain select and the optional chain pass.
Without a dynamic field (no scene flow) both return after the static field,
as ``zest_tpu``'s ``scene_flow=False`` does; a field without a volume gets
no features (None).

Conventions: rays [R, ...], samples S on the last axis of z-shaped tensors.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from . import geometry
from .kernels.color_gather import gather_colors
from .models.embedding import positional_encoding


# the maps of an eval render; without scene flow the first two
EVAL_KEYS = ("rgb_map", "depth_map", "rgb_map_ref", "depth_map_ref",
             "rgb_map_ref_dy", "depth_map_ref_dy", "weights_map_dd")
STATIC_EVAL_KEYS = EVAL_KEYS[:2]


def _exclusive_transmittance(one_minus_alpha):
    ones = torch.ones_like(one_minus_alpha[..., :1])
    return torch.cumprod(torch.cat([ones, one_minus_alpha + 1e-10], -1),
                         -1)[..., :-1]


def raw2alpha(sigma, dists):
    """α = 1 − exp(−σ·δ) and its compositing weights. sigma, dists [R, S]."""
    alpha = 1.0 - torch.exp(-sigma * dists)
    return alpha, alpha * _exclusive_transmittance(1.0 - alpha)


def _noisy(sigma, noise, raw_noise_std: float):
    """sigma plus the step's standard normals times raw_noise_std."""
    if noise is None or raw_noise_std <= 0.0:
        return sigma
    return sigma + noise * raw_noise_std


def raw2outputs(raw, z_vals, dists, white_bkgd: bool = False, noise=None,
                raw_noise_std: float = 0.0):
    """raw [R, S, 4] → (rgb_map [R, 3], disp_map [R], acc_map [R],
    weights [R, S], depth_map [R], alpha [R, S]); ``noise`` [R, S] standard
    normals scaled by raw_noise_std are added to the density."""
    rgb = torch.sigmoid(raw[..., :3])
    alpha, weights = raw2alpha(torch.relu(_noisy(raw[..., 3], noise,
                                                 raw_noise_std)), dists)
    rgb_map = torch.sum(weights[..., None] * rgb, -2)
    depth_map = torch.sum(weights * z_vals, -1)
    acc_map = torch.sum(weights, -1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, disp_map, acc_map, weights, depth_map, alpha


def raw2outputs_blending(raw_dy, raw_rigid, raw_blend_w, z_vals, dists,
                         noise=None, raw_noise_std: float = 0.0):
    """Static + dynamic compositing with predicted blend weights; the same
    density noise goes to both fields.

    Returns (rgb_map, depth_map, rgb_map_fg, depth_map_fg, weights_fg,
    weights_dy); fg is the dynamic field alone."""
    rgb_dy = torch.sigmoid(raw_dy[..., :3])
    rgb_rigid = torch.sigmoid(raw_rigid[..., :3])
    opacity_dy = torch.relu(_noisy(raw_dy[..., 3], noise, raw_noise_std))
    opacity_rigid = torch.relu(_noisy(raw_rigid[..., 3], noise, raw_noise_std))
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


def compute_2d_prob(weights_p_mix, raw_prob_ref2p):
    """Sum over samples of w * (1 - prob) per ray, the weights detached."""
    return torch.sum(weights_p_mix.detach() * (1.0 - raw_prob_ref2p), -1)


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


def append_color_volume(volume, images, w2cs, intrinsics, near_far,
                        pad: int = 0):
    """The encoding volume [D, Hv, Wv, 8] with each source view's RGB and
    strict in-bounds mask at every voxel centre appended → [D, Hv, Wv, 8 +
    4V] (``use_color_volume``): the static field's conditioning then is one
    lookup of this volume instead of a lookup and a colour gather per point.

    The voxel centres are ``linspace(0, 1)`` on each axis, taken to world
    space by ``geometry.ndc_to_world`` with the reference view (slot 0 of
    ``w2cs`` / ``intrinsics``), its ``near_far`` and ``pad``; their colours
    are ``build_color_features`` (one gather launch for all V views) of the
    float32 images [V, H, W, 3] and the first V poses.
    """
    D, Hv, Wv, _ = volume.shape
    V, H, W, _ = images.shape
    dev = volume.device
    inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32, device=dev)
    gz, gy, gx = torch.meshgrid(
        *(torch.linspace(0.0, 1.0, n, device=dev) for n in (D, Hv, Wv)),
        indexing="ij")
    pts = geometry.ndc_to_world(torch.stack([gx, gy, gz], -1), w2cs[0],
                                intrinsics[0], inv_scale, near_far[0],
                                near_far[1], pad)
    colors = build_color_features(pts.reshape(D * Hv, Wv, 3), images,
                                  w2cs[:V], intrinsics[:V])
    return torch.cat([volume, colors.reshape(D, Hv, Wv, V * 4)
                      .to(volume.dtype)], -1)


class RenderModels(NamedTuple):
    """Field evaluators and conditioning-feature callables for render_rays.
    Without scene flow dynamic_fn is None; a field without a volume has no
    feature callables (None)."""
    static_fn: Callable       # (pts_emb, feats, views) -> raw [R, S, 4 or 5]
    dynamic_fn: Optional[Callable] = None   # (xyzt_emb, feats, views) -> [R, S, 12]
    static_feats: Optional[Callable] = None  # (pts_world, ndc) -> [R, S, F]
    dynamic_vol: Optional[Callable] = None   # (ndc) -> [R, S, 8]
    dynamic_col: Optional[Callable] = None   # (pts_world) -> [R, S, 16]
    multires: int = 10
    multires_views: int = 4
    # the lookup at flow-warped points (t±1, the chain); None: dynamic_vol
    dynamic_vol_warped: Optional[Callable] = None


def _embed_dirs(rays_d, w2c_ref, n_samples, multires_views):
    """Embedded unit view directions, rotated into w2c_ref's camera when it
    is given, repeated over the samples."""
    cos_angle = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    dirs = rays_d / cos_angle
    if w2c_ref is not None:
        dirs = gen_dir_feature(w2c_ref, dirs)
    views = positional_encoding(dirs, multires_views)
    return views[:, None, :].expand(views.shape[0], n_samples, views.shape[-1])


def static_field_inputs(models: RenderModels, rays, im_w2c_ref):
    """The static field's (embedded points, features, embedded views) at a
    ray batch's points, each [R, S, ...]; the features None without a
    volume."""
    feats = None
    if models.static_feats is not None:
        feats = models.static_feats(rays.pts, rays.ndc)
    return (positional_encoding(rays.ndc, models.multires), feats,
            _embed_dirs(rays.rays_d, im_w2c_ref, rays.pts.shape[1],
                        models.multires_views))


def _dynamic_inputs(models: RenderModels, ndc, t_ch, col, views,
                    warped: bool = False):
    """The dynamic field's inputs at ndc [n, S, 3] and times t_ch [n, S, 1],
    with the color features col and embedded views of those rays; ``warped``
    points take ``dynamic_vol_warped`` where it is given. The features are
    None without a volume."""
    feats = None
    if models.dynamic_vol is not None:
        lookup = models.dynamic_vol
        if warped and models.dynamic_vol_warped is not None:
            lookup = models.dynamic_vol_warped
        feats = torch.cat([lookup(ndc), col], -1)
    return (positional_encoding(torch.cat([ndc, t_ch], -1), models.multires),
            feats, views)


def _dynamic_col(models: RenderModels, pts):
    return None if models.dynamic_col is None else models.dynamic_col(pts)


def dynamic_field_inputs(models: RenderModels, rays, nb_w2c_ref,
                         ref_frame_idx):
    """The dynamic field's (embedded points and time, features, embedded
    views) at a ray batch's points at the reference time, each [R, S, ...]."""
    t_ch = torch.full_like(rays.ndc[..., :1], 1.0) * ref_frame_idx
    return _dynamic_inputs(models, rays.ndc, t_ch,
                           _dynamic_col(models, rays.pts),
                           _embed_dirs(rays.rays_d, nb_w2c_ref,
                                       rays.pts.shape[1], models.multires_views))


def _render_static(models, rays, dists, im_w2c_ref, white_bkgd, draws,
                   raw_noise_std):
    """The static field alone: (its raw output [R, S, out_ch], outputs with
    rgb_map, depth_map and weights)."""
    raw_static = models.static_fn(*static_field_inputs(models, rays,
                                                       im_w2c_ref))
    rgb_map, _, _, weights, depth_map, _ = raw2outputs(
        raw_static[..., :4], rays.z_vals, dists, white_bkgd,
        getattr(draws, "noise_static", None), raw_noise_std)
    return raw_static, {"rgb_map": rgb_map, "depth_map": depth_map,
                        "weights": weights}


def _render_ref(models, rays, dists, im_w2c_ref, nb_w2c_ref, ref_frame_idx,
                white_bkgd, draws, raw_noise_std):
    """Static field, then the dynamic field at the reference time, and both
    composited. Returns (outputs, the dynamic field's raw output, the
    dynamic color features, the dynamic embedded views)."""
    raw_static, static_out = _render_static(models, rays, dists, im_w2c_ref,
                                            white_bkgd, draws, raw_noise_std)
    raw_rgba, raw_blend_w = raw_static[..., :4], raw_static[..., 4]

    col_dy = _dynamic_col(models, rays.pts)
    views_dy = _embed_dirs(rays.rays_d, nb_w2c_ref, rays.pts.shape[1],
                           models.multires_views)
    t_ch = torch.full_like(rays.ndc[..., :1], 1.0) * ref_frame_idx
    raw_dy = models.dynamic_fn(*_dynamic_inputs(models, rays.ndc, t_ch, col_dy,
                                                views_dy))
    (rgb_map_ref, depth_map_ref, rgb_map_ref_dy, depth_map_ref_dy,
     weights_ref_dy, weights_ref_dd) = raw2outputs_blending(
        raw_dy[..., :4], raw_rgba, raw_blend_w, rays.z_vals, dists,
        getattr(draws, "noise_dynamic", None), raw_noise_std)
    out = {**static_out, "rgb_map_ref": rgb_map_ref,
           "depth_map_ref": depth_map_ref, "rgb_map_ref_dy": rgb_map_ref_dy,
           "depth_map_ref_dy": depth_map_ref_dy,
           "weights_map_dd": torch.sum(weights_ref_dd, -1).detach(),
           "raw_blend_w": raw_blend_w,
           "weights_ref_dy": weights_ref_dy}
    return out, raw_dy, col_dy, views_dy


def render_rays(models: RenderModels, rays, *, im_w2c_ref, nb_w2c_ref,
                ref_frame_idx, white_bkgd: bool = False) -> dict:
    """Render one ray batch through the static field and the dynamic field at
    the reference time, and composite both.

    Returns the eval maps: rgb_map, depth_map (static), rgb_map_ref,
    depth_map_ref (blended), rgb_map_ref_dy, depth_map_ref_dy (dynamic
    alone) and weights_map_dd (the dynamic field's share of the weights);
    without a dynamic field the first two (``STATIC_EVAL_KEYS``).
    """
    cos_angle = torch.linalg.norm(rays.rays_d, dim=-1, keepdim=True)
    dists = geometry.depth2dist(rays.z_vals, cos_angle)
    if models.dynamic_fn is None:
        out = _render_static(models, rays, dists, im_w2c_ref, white_bkgd,
                             None, 0.0)[1]
        return {k: out[k] for k in STATIC_EVAL_KEYS}
    out, _, _, _ = _render_ref(models, rays, dists, im_w2c_ref, nb_w2c_ref,
                               ref_frame_idx, white_bkgd, None, 0.0)
    return {k: out[k] for k in EVAL_KEYS}


def render_rays_train(models: RenderModels, rays, draws, *, im_w2c_ref,
                      nb_w2c_ref, ref_frame_idx, num_frames, chain_bwd: bool,
                      chain_5frames: bool, raw_noise_std: float = 0.0,
                      white_bkgd: bool = False) -> dict:
    """The training render of one ray batch: ``render_rays``' passes with the
    density noise of ``draws`` (a ``sampling.Draws``), then the dynamic
    field again at the flow-warped points of t-1 and t+1 (one field call over
    the 2R stacked rays, the color features computed once and repeated),
    the chain points (t-2 when ``chain_bwd``, else t+2) and, when
    ``chain_5frames``, the dynamic field at them.

    Returns the outputs ``losses.sceneflow_losses`` reads, with the keys of
    ``zest_tpu.render.render_rays``; without a dynamic field the static
    field's rgb_map, depth_map and weights, its density noise
    ``draws.noise_static``.
    """
    R, S, _ = rays.pts.shape
    cos_angle = torch.linalg.norm(rays.rays_d, dim=-1, keepdim=True)
    dists = geometry.depth2dist(rays.z_vals, cos_angle)
    if models.dynamic_fn is None:
        return _render_static(models, rays, dists, im_w2c_ref, white_bkgd,
                              draws, raw_noise_std)[1]
    ret, raw_ref_t, col_dy, views_dy = _render_ref(
        models, rays, dists, im_w2c_ref, nb_w2c_ref, ref_frame_idx,
        white_bkgd, draws, raw_noise_std)
    raw_sf_ref2prev = raw_ref_t[..., 4:7]
    raw_sf_ref2post = raw_ref_t[..., 7:10]
    raw_prob_ref2prev = raw_ref_t[..., 10]
    raw_prob_ref2post = raw_ref_t[..., 11]
    ret.update({"raw_sf_ref2prev": raw_sf_ref2prev,
                "raw_sf_ref2post": raw_sf_ref2post, "raw_pts_ref": rays.ndc,
                "raw_prob_ref2prev": raw_prob_ref2prev,
                "raw_prob_ref2post": raw_prob_ref2post})

    # t-1 / t+1, stacked on the ray axis into one field call
    dt = 1.0 / num_frames * 2.0
    prev_ndc = rays.ndc + raw_sf_ref2prev
    post_ndc = rays.ndc + raw_sf_ref2post
    ones = torch.ones_like(rays.ndc[..., :1])
    t_pp = torch.cat([ones * (ref_frame_idx - dt), ones * (ref_frame_idx + dt)])
    raw_both = models.dynamic_fn(*_dynamic_inputs(
        models, torch.cat([prev_ndc, post_ndc]), t_pp,
        None if col_dy is None else torch.cat([col_dy, col_dy]),
        torch.cat([views_dy, views_dy]), warped=True))
    raw_prev, raw_post = raw_both[:R], raw_both[R:]

    rgb_map_prev_dy, _, _, weights_prev_dy, _, _ = raw2outputs(
        raw_prev[..., :4], rays.z_vals, dists, False, draws.noise_prev,
        raw_noise_std)
    rgb_map_post_dy, _, _, weights_post_dy, _, _ = raw2outputs(
        raw_post[..., :4], rays.z_vals, dists, False, draws.noise_post,
        raw_noise_std)
    ret.update({
        "raw_pts_prev": prev_ndc, "raw_sf_prev2ref": raw_prev[..., 7:10],
        "rgb_map_prev_dy": rgb_map_prev_dy,
        "raw_pts_post": post_ndc, "raw_sf_post2ref": raw_post[..., 4:7],
        "rgb_map_post_dy": rgb_map_post_dy,
        "prob_map_prev": compute_2d_prob(weights_prev_dy, raw_prob_ref2prev),
        "prob_map_post": compute_2d_prob(weights_post_dy, raw_prob_ref2post)})

    # the chain: t-2 through the t-1 points' backward flow, or t+2
    if chain_bwd:
        pp_ndc = prev_ndc + raw_prev[..., 4:7]
        pp_frame_idx = ref_frame_idx - 2.0 * dt
    else:
        pp_ndc = post_ndc + raw_post[..., 7:10]
        pp_frame_idx = ref_frame_idx + 2.0 * dt
    ret["raw_pts_pp"] = pp_ndc
    if chain_5frames:
        raw_pp = models.dynamic_fn(*_dynamic_inputs(
            models, pp_ndc, ones * pp_frame_idx, col_dy, views_dy, warped=True))
        ret["rgb_map_pp_dy"] = raw2outputs(
            raw_pp[..., :4], rays.z_vals, dists, False, draws.noise_pp,
            raw_noise_std)[0]
    return ret
