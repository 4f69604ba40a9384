"""zest_tpu_torch's scene-flow loss bundle against zest_tpu's on the CPU, term
by term, on the same render outputs (random, from a numpy seed) with an even
ray count, where the median of the depth prior averages the two middle
values. Also the gradients of the total with respect to every render output,
including the exact zeros of compositing weights (|x| takes the derivative
+1 at 0 in both).

Tolerance: rtol 1e-5 on the terms and 1e-5 of each gradient's largest
element — elementwise float32 arithmetic and means over 32 x 16 values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu.config import ZestConfig as JZestConfig
from zest_tpu.losses import sceneflow_losses as jsceneflow_losses
from zest_tpu.sampling import RayBatch as JRayBatch

from zest_tpu_torch import ZestConfig, presets
from zest_tpu_torch.losses import abs_, compute_depth_loss, sceneflow_losses
from zest_tpu_torch.sampling import RayBatch

R, S = 32, 16
CFG = presets.SMALL_TRAIN


def _inputs(seed):
    rng = np.random.default_rng(seed)
    u = lambda *shape: rng.uniform(size=shape).astype(np.float32)  # noqa: E731
    weights = u(R, S)
    weights[:, ::3] = 0.0                       # exact zeros, as renders have
    res = {
        "rgb_map": u(R, 3), "rgb_map_ref": u(R, 3), "rgb_map_ref_dy": u(R, 3),
        "rgb_map_prev_dy": u(R, 3), "rgb_map_post_dy": u(R, 3),
        "rgb_map_pp_dy": u(R, 3), "prob_map_prev": u(R), "prob_map_post": u(R),
        "weights_map_dd": u(R), "raw_prob_ref2prev": u(R, S),
        "raw_prob_ref2post": u(R, S), "raw_blend_w": u(R, S),
        "weights_ref_dy": weights, "depth_map_ref_dy": 2 + 4 * u(R),
        "raw_sf_ref2prev": u(R, S, 3) - 0.5, "raw_sf_ref2post": u(R, S, 3) - 0.5,
        "raw_sf_prev2ref": u(R, S, 3) - 0.5, "raw_sf_post2ref": u(R, S, 3) - 0.5,
        "raw_pts_ref": u(R, S, 3), "raw_pts_prev": u(R, S, 3),
        "raw_pts_post": u(R, S, 3), "raw_pts_pp": u(R, S, 3),
    }
    rays = dict(color_gt=u(R, 3), depth_gt=u(R), flow_fwd_gt=64 * u(R, 2),
                flow_bwd_gt=64 * u(R, 2), mask_fwd_gt=(u(R) > 0.2) * 1.0,
                mask_bwd_gt=np.ones(R, np.float32))
    w2c = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
    w2c[:, :3, 3] = [[0.02, -0.01, 0.0], [-0.03, 0.01, 0.01]]
    return res, rays, w2c


@pytest.mark.parametrize("step,frame_t,chain_bwd,chain_5frames", [
    (0, 3.0, True, False),
    (1, 0.0, False, False),          # the first frame: forward flow only
    (2500, 8.0, True, True),         # late photometric loss, priors decayed
    (2501, 5.0, False, True),
])
def test_sceneflow_losses_match_zest_tpu(step, frame_t, chain_bwd,
                                         chain_5frames):
    res, rays, w2c = _inputs(step + 1)
    kw = dict(step=step, H=32, W=64, chain_5frames=chain_5frames)
    jrays = JRayBatch(pts=None, ndc=None, z_vals=None, rays_d=None,
                      t_vals=None, **{k: jnp.asarray(v) for k, v in rays.items()})

    def jloss(r):
        return jsceneflow_losses(
            JZestConfig(**CFG), r, jrays, frame_t=jnp.asarray(frame_t),
            total_frames=jnp.asarray(9.0), focal=jnp.asarray(76.8),
            fnb_w2cs=jnp.asarray(w2c), chain_bwd=jnp.asarray(chain_bwd),
            **dict(kw, step=jnp.asarray(step)))

    (jtotal, jlogs), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in res.items()})

    tres = {k: torch.from_numpy(v).requires_grad_(True) for k, v in res.items()}
    trays = RayBatch(pts=None, ndc=None, z_vals=None, rays_d=None,
                     t_vals=None, **{k: torch.from_numpy(np.asarray(v, np.float32))
                                     for k, v in rays.items()})
    total, logs = sceneflow_losses(
        ZestConfig(**CFG), tres, trays, frame_t=torch.tensor(frame_t),
        total_frames=torch.tensor(9.0), focal=torch.tensor(76.8),
        fnb_w2cs=torch.from_numpy(w2c), chain_bwd=chain_bwd, **kw)
    assert set(logs) == set(jlogs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    grads = torch.autograd.grad(total, list(tres.values()), allow_unused=True)
    for (k, t), g in zip(tres.items(), grads):
        jg = np.asarray(jgrads[k])
        g = np.zeros_like(jg) if g is None else g.numpy()
        scale = max(float(np.abs(jg).max()), 1e-30)
        assert float(np.abs(g - jg).max()) <= 1e-5 * scale, k


def test_depth_prior_takes_the_mean_of_the_two_middle_values():
    x = torch.tensor([4.0, 1.0, 3.0, 2.0])          # median 2.5, not 2
    y = torch.tensor([1.0, 2.0, 3.0, 5.0])
    xn, yn = x.numpy() - 2.5, y.numpy() - 2.5
    ref = float(np.mean((xn / np.mean(np.abs(xn)) - yn / np.mean(np.abs(yn))) ** 2))
    np.testing.assert_allclose(float(compute_depth_loss(x, y)), ref, rtol=1e-6)


def test_abs_takes_the_derivative_one_at_zero():
    x = torch.tensor([-2.0, 0.0, -0.0, 3.0], requires_grad=True)
    abs_(x).sum().backward()
    assert x.grad.tolist() == [-1.0, 1.0, 1.0, 1.0]
    assert [float(jax.grad(jnp.abs)(v)) for v in (-2.0, 0.0, -0.0, 3.0)] \
        == x.grad.tolist()
