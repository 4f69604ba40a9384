"""The losses of a training step (counterpart of ``zest_tpu.losses``): the
patch regularizers (disparity smoothness, total variation, the interval
distortion), and ``sceneflow_losses`` with the terms it calls.

Pure functions of the training render (``render.render_rays_train``) and the
ray batch. The step and the chain direction are host integers and booleans
here, so the phase selections are Python branches where the JAX package
selects with ``jnp.where``; the values are the same.
"""
from __future__ import annotations

import torch

from . import geometry


def abs_(x):
    """|x| with the derivative +1 at x = 0, as ``jnp.abs`` takes it
    (``torch.abs`` takes 0 there). The difference shows wherever a
    compositing weight is exactly 0, which is common: the scene-flow
    minimality term is |weight * flow|."""
    return torch.where(x >= 0, x, -x)


def get_disparity_smoothness(disp, img):
    """Image-gradient-weighted disparity smoothness. disp [N, H, W, 1],
    img [N, H, W, 3] (channels last, as the patches are reshaped rays)."""
    def gx(t):
        return t[:, :, :-1, :] - t[:, :, 1:, :]

    def gy(t):
        return t[:, :-1, :, :] - t[:, 1:, :, :]

    wx = torch.exp(-torch.mean(abs_(gx(img)), 3, keepdim=True))
    wy = torch.exp(-torch.mean(abs_(gy(img)), 3, keepdim=True))
    return (torch.mean(abs_(gx(disp)) * wx)
            + torch.mean(abs_(gy(disp)) * wy))


def total_variation_loss(image):
    """Total variation of [N, H, W] patches."""
    return (torch.mean(abs_(image[:, :, :-1] - image[:, :, 1:]))
            + torch.mean(abs_(image[:, :-1, :] - image[:, 1:, :])))


def distortion_loss(ray_weights, t_vals):
    """Mip-NeRF 360's interval distortion, summed over the rays, in O(S):
    the midpoints are sorted, so the pairwise sum sum_ij w_i w_j |m_i - m_j|
    is 2 sum_i w_i (m_i A_(i-1) - B_(i-1)) with the prefix sums
    A_i = sum_(k<=i) w_k and B_i = sum_(k<=i) w_k m_k.
    ray_weights [R, S]; t_vals [S] (normalized sample positions)."""
    w = ray_weights[..., :-1]
    t_mids = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])
    a_prev = torch.cumsum(w, -1) - w
    b_prev = torch.cumsum(w * t_mids, -1) - w * t_mids
    weighted = 0.5 * (2.0 * torch.sum(w * (t_mids * a_prev - b_prev), -1))
    t_dists = t_vals[..., 1:] - t_vals[..., :-1]
    individual = (1.0 / 3.0) * torch.sum(w ** 2 * t_dists, -1)
    return torch.sum(weighted + individual)


def mse_masked(pred, gt, mask):
    """Masked MSE over the mask's count; mask repeats over pred's last axis."""
    mask_rep = torch.repeat_interleave(mask, pred.shape[-1] // mask.shape[-1],
                                       -1)
    return torch.sum(((pred - gt) ** 2) * mask_rep) / (torch.sum(mask_rep) + 1e-8)


def mae_masked(pred, gt, mask):
    """Masked MAE over the mask's count."""
    mask_rep = torch.repeat_interleave(mask, pred.shape[-1] // mask.shape[-1],
                                       -1)
    return torch.sum(abs_(pred - gt) * mask_rep) / (torch.sum(mask_rep) + 1e-8)


def _median(x):
    """The median as ``jnp.median`` takes it: the mean of the two middle
    values of an even count (``torch.median`` returns the lower one)."""
    return torch.quantile(x.reshape(-1), 0.5)


def compute_depth_loss(pred_depth, gt_depth):
    """Scale- and shift-invariant depth prior: median / mean-deviation
    whitening of both, then MSE."""
    t_pred = _median(pred_depth)
    s_pred = torch.mean(abs_(pred_depth - t_pred))
    t_gt = _median(gt_depth)
    s_gt = torch.mean(abs_(gt_depth - t_gt))
    pred_n = (pred_depth - t_pred) / (s_pred + 1e-8)
    gt_n = (gt_depth - t_gt) / (s_gt + 1e-8)
    return torch.mean((pred_n - gt_n) ** 2)


def compute_sf_smooth_loss(pts_1_ndc, pts_2_ndc, H, W, f):
    """Spatial smoothness of the scene flow in Euclidean space, without the
    farthest 5 % of the samples."""
    k = int(pts_1_ndc.shape[-2] * 0.95)
    sf = (geometry.ndc_to_euclidean(pts_1_ndc[..., :k, :], H, W, f)
          - geometry.ndc_to_euclidean(pts_2_ndc[..., :k, :], H, W, f))
    return torch.mean(abs_(sf[..., :-1, :] - sf[..., 1:, :]))


def compute_sf_lke_loss(pts_ref_ndc, pts_post_ndc, pts_prev_ndc, H, W, f):
    """Least kinetic energy: forward and backward flow agree, without the
    farthest 10 % of the samples."""
    k = int(pts_ref_ndc.shape[-2] * 0.9)
    p_ref, p_post, p_prev = (geometry.ndc_to_euclidean(p[..., :k, :], H, W, f)
                             for p in (pts_ref_ndc, pts_post_ndc, pts_prev_ndc))
    return 0.5 * torch.mean(((p_post - p_ref) - (p_ref - p_prev)) ** 2)


def entropy_loss_fn(raw_blend_w):
    """Blend-weight entropy: mean of -w log(w + 1e-8)."""
    return torch.mean(-raw_blend_w * torch.log(raw_blend_w + 1e-8))


def sceneflow_losses(cfg, results: dict, rays, *, step: int, frame_t,
                     total_frames, H, W, focal, fnb_w2cs, chain_bwd: bool,
                     chain_5frames: bool):
    """The 9-term scene-flow loss bundle.

    Args:
        cfg: ZestConfig (the lambdas and decay_iteration).
        results: ``render.render_rays_train``'s outputs.
        rays: sampling.RayBatch with the flow and mask ground truth.
        step: the host step; frame_t, total_frames: 0-d tensors.
        fnb_w2cs: [2, 4, 4] w2c of the t-1 / t+1 neighbour cameras.
    Returns: (total loss, dict of the weighted terms).
    """
    decay_it = cfg.decay_iteration_clamped
    rgb_gt = rays.color_gt
    logs = {}
    rgb_map_ref_dy = results["rgb_map_ref_dy"]
    rgb_map_post_dy = results["rgb_map_post_dy"]
    rgb_map_prev_dy = results["rgb_map_prev_dy"]
    prob_map_post = results["prob_map_post"][..., None]
    prob_map_prev = results["prob_map_prev"][..., None]
    weights_map_dd = results["weights_map_dd"][..., None].detach()

    # temporal photometric consistency
    if step <= decay_it * 1000:
        pho_loss = (torch.mean((rgb_map_ref_dy - rgb_gt) ** 2)
                    + mse_masked(rgb_map_post_dy, rgb_gt, prob_map_post)
                    + mse_masked(rgb_map_prev_dy, rgb_gt, prob_map_prev))
    else:
        pho_loss = (mse_masked(rgb_map_ref_dy, rgb_gt, weights_map_dd)
                    + mse_masked(rgb_map_post_dy, rgb_gt,
                                 prob_map_post * weights_map_dd)
                    + mse_masked(rgb_map_prev_dy, rgb_gt,
                                 prob_map_prev * weights_map_dd))
    if chain_5frames:
        pho_loss = pho_loss + mse_masked(results["rgb_map_pp_dy"], rgb_gt,
                                         weights_map_dd)
    logs["pho_loss"] = pho_loss

    prob_reg_loss = (torch.mean(abs_(results["raw_prob_ref2prev"]))
                     + torch.mean(abs_(results["raw_prob_ref2post"])))
    logs["prob_reg_loss"] = cfg.lambda_prob_reg * prob_reg_loss

    combined_loss = torch.mean((results["rgb_map_ref"] - rgb_gt) ** 2)
    logs["combined_loss"] = combined_loss

    # scene-flow cycle consistency
    weight_post = (1.0 - results["raw_prob_ref2post"])[..., None]
    weight_prev = (1.0 - results["raw_prob_ref2prev"])[..., None]
    sf_cycle_loss = (mse_masked(results["raw_sf_ref2post"],
                                -results["raw_sf_post2ref"], weight_post)
                     + mse_masked(results["raw_sf_ref2prev"],
                                  -results["raw_sf_prev2ref"], weight_prev))
    logs["sf_cycle_loss"] = cfg.lambda_cyc * sf_cycle_loss

    # rendered scene-flow minimality; the reference sums weights * flow over
    # the xyz axis, reproduced as it is
    w_dy = results["weights_ref_dy"][..., None]
    sf_min_loss = (
        torch.mean(abs_(torch.sum(w_dy * results["raw_sf_ref2prev"], -1)))
        + torch.mean(abs_(torch.sum(w_dy * results["raw_sf_ref2post"], -1))))
    logs["sf_min_loss"] = cfg.lambda_sf_reg * sf_min_loss

    pts_ref, pts_post = results["raw_pts_ref"], results["raw_pts_post"]
    pts_prev, pts_pp = results["raw_pts_prev"], results["raw_pts_pp"]
    sf_sp_loss = (compute_sf_smooth_loss(pts_ref, pts_post, H, W, focal)
                  + compute_sf_smooth_loss(pts_ref, pts_prev, H, W, focal))
    logs["sf_sp_loss"] = cfg.lambda_sf_smooth * sf_sp_loss

    sf_st_loss = compute_sf_lke_loss(pts_ref, pts_post, pts_prev, H, W, focal)
    if chain_bwd:
        sf_st_loss = sf_st_loss + compute_sf_lke_loss(pts_prev, pts_ref, pts_pp,
                                                      H, W, focal)
    else:
        sf_st_loss = sf_st_loss + compute_sf_lke_loss(pts_post, pts_pp, pts_ref,
                                                      H, W, focal)
    logs["sf_st_loss"] = cfg.lambda_sf_smooth * sf_st_loss

    entropy_loss = entropy_loss_fn(results["raw_blend_w"])
    logs["entropy_loss"] = cfg.lambda_blending_reg * entropy_loss

    # the data-driven priors decay tenfold every decay_it * 1000 steps
    decay = 10.0 ** (step // (decay_it * 1000))
    w_of = cfg.lambda_optical_flow / decay
    w_depth = cfg.lambda_sf_depth / decay

    render_of_fwd = geometry.projection_from_ndc(
        fnb_w2cs[1], H, W, focal, results["weights_ref_dy"], pts_post)
    render_of_bwd = geometry.projection_from_ndc(
        fnb_w2cs[0], H, W, focal, results["weights_ref_dy"], pts_prev)
    fwd_term = mae_masked(render_of_fwd, rays.flow_fwd_gt,
                          rays.mask_fwd_gt[..., None])
    bwd_term = mae_masked(render_of_bwd, rays.flow_bwd_gt,
                          rays.mask_bwd_gt[..., None])
    flow_loss = torch.where(frame_t == 0, fwd_term,
                            torch.where(frame_t == total_frames - 1, bwd_term,
                                        fwd_term + bwd_term))
    logs["flow_loss"] = w_of * flow_loss

    sf_depth_loss = compute_depth_loss(results["depth_map_ref_dy"],
                                       -rays.depth_gt)
    logs["sf_depth_loss"] = w_depth * sf_depth_loss

    total = (pho_loss + combined_loss
             + cfg.lambda_cyc * sf_cycle_loss
             + cfg.lambda_prob_reg * prob_reg_loss
             + cfg.lambda_sf_reg * sf_min_loss
             + cfg.lambda_sf_smooth * sf_sp_loss
             + cfg.lambda_sf_smooth * sf_st_loss
             + cfg.lambda_blending_reg * entropy_loss
             + w_of * flow_loss
             + w_depth * sf_depth_loss)
    return total, logs
