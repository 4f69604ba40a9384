"""The training slice's smaller parts against zest_tpu on the CPU: the flow
geometry, the samplers and the rays' ground-truth gathers, the step phases,
the optimizer (against optax, through clipping and the cosine schedule), the
draws, ``convert.from_jax_params`` on gradient trees, and the training
profiler's kernel groups.

Tolerances: the geometry and the rays rtol 1e-5 (float32 arithmetic in
another order); the optimizer's parameters 2.5e-7 absolute, two float32
ulps at 1, after three Adam steps of learning rate ~1e-3 (float32 rounding
of the moments and the schedule).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zest_tpu import geometry as jgeometry
from zest_tpu import sampling as jsampling
from zest_tpu.config import ZestConfig as JZestConfig
from zest_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from zest_tpu.system import ZestSystem as JZestSystem
from zest_tpu.system import phase_for_step as jphase_for_step

from zest_tpu_torch import ZestConfig, geometry, presets, sampling
from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.system import Optimizer, ZestSystem, phase_for_step, to_batch
from zest_tpu_torch.tools import profile_train


def test_flow_geometry_matches_zest_tpu():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.2, 1.2, size=(20, 16, 3)).astype(np.float32)
    w = rng.uniform(size=(20, 16)).astype(np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.03, -0.02, 0.01]
    w2c[:3, :3] = np.asarray(jnp.asarray([[0.99, -0.1, 0], [0.1, 0.99, 0],
                                          [0, 0, 1.0]]))
    args = (32.0, 64.0, 76.8)
    for jf, tf, ins in (
            (jgeometry.ndc_to_euclidean, geometry.ndc_to_euclidean, (pts, *args)),
            (jgeometry.perspective_projection, geometry.perspective_projection,
             (pts - [0, 0, 2], *args)),
            (jgeometry.projection_from_ndc, geometry.projection_from_ndc,
             (w2c, *args, w, pts))):
        ref = jf(*[jnp.asarray(a, jnp.float32) if isinstance(a, np.ndarray)
                   else a for a in ins])
        out = tf(*[torch.tensor(a, dtype=torch.float32)
                   if isinstance(a, np.ndarray) else a for a in ins])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5, err_msg=jf.__name__)
    R = jnp.asarray(w2c[:3, :3])
    T = jnp.asarray(w2c[:3, 3:])
    np.testing.assert_allclose(
        geometry.se3_transform_points(torch.from_numpy(pts),
                                      torch.from_numpy(w2c[:3, :3]),
                                      torch.from_numpy(w2c[:3, 3:])).numpy(),
        np.asarray(jgeometry.se3_transform_points(jnp.asarray(pts), R, T)),
        rtol=1e-6, atol=1e-6)


def test_training_rays_match_zest_tpu():
    """The random and motion-mask pixels, the jittered depths and the flow
    and mask gathers of ``build_rays``, from the same key."""
    sample = JSyntheticDataset(**presets.SMALL_SCENE)[presets.TARGET_FRAME]
    cfg = ZestConfig(**presets.SMALL_TRAIN)
    k_pix, k_extra, k_depth = jax.random.split(jax.random.PRNGKey(4), 3)
    xs, ys = jsampling.sample_pixels_random(k_pix, 32, 64, cfg.batch_size)
    idx = jax.random.randint(k_extra, (cfg.num_extra_samples,), 0,
                             int(sample["motion_count"]))
    hx, hy = jsampling.sample_motion_pixels(
        k_extra, jnp.asarray(sample["motion_coords"]),
        jnp.asarray(sample["motion_count"]), cfg.num_extra_samples)
    thx, thy = sampling.sample_motion_pixels(
        torch.from_numpy(sample["motion_coords"]), torch.tensor(np.asarray(idx)))
    assert np.array_equal(thx.numpy(), np.asarray(hx))
    assert np.array_equal(thy.numpy(), np.asarray(hy))
    xs_all, ys_all = jnp.concatenate([xs, hx]), jnp.concatenate([ys, hy])
    R = xs_all.shape[0]
    jitter = jax.random.uniform(k_depth, (R, cfg.N_samples))
    jb = {k: jnp.asarray(v) for k, v in sample.items()}
    imgs = jb["images"] * jnp.asarray([0.229, 0.224, 0.225]) + \
        jnp.asarray([0.485, 0.456, 0.406])
    keys = ("depths", "w2cs", "c2ws", "intrinsics", "near_fars", "flow_fwd",
            "flow_bwd", "mask_fwd", "mask_bwd")
    ref = jsampling.build_rays(k_depth, xs_all, ys_all, images=imgs,
                               n_samples=cfg.N_samples, pad=cfg.pad,
                               **{k: jb[k] for k in keys})
    tb = to_batch(sample, "cpu")
    out = sampling.build_rays(
        torch.tensor(np.asarray(xs_all)), torch.tensor(np.asarray(ys_all)),
        images=torch.from_numpy(np.asarray(imgs)), n_samples=cfg.N_samples,
        pad=cfg.pad, jitter=torch.tensor(np.asarray(jitter)),
        **{k: tb[k] for k in keys})
    for name in ("pts", "ndc", "z_vals", "rays_d", "color_gt", "depth_gt",
                 "flow_fwd_gt", "flow_bwd_gt", "mask_fwd_gt", "mask_bwd_gt"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("extra", [True, False])
@pytest.mark.parametrize("noise", [1.0, 0.0])
def test_sample_draws(extra, noise):
    cfg = ZestConfig(**dict(presets.SMALL_TRAIN, raw_noise_std=noise))
    a, b = (sampling.sample_draws(torch.Generator().manual_seed(3), cfg, 32, 64,
                                  100, extra) for _ in range(2))
    R = cfg.batch_size + (cfg.num_extra_samples if extra else 0)
    assert a.xs.shape == a.ys.shape == (cfg.batch_size,)
    assert bool((a.xs >= 0).all() & (a.xs < 64).all() & (a.ys < 32).all())
    assert (a.motion_idx is not None) == extra
    if extra:
        assert a.motion_idx.shape == (cfg.num_extra_samples,)
        assert int(a.motion_idx.max()) < 100
    assert a.jitter.shape == (R, cfg.N_samples)
    for name in sampling.NOISE_FIELDS:
        t = getattr(a, name)
        assert (t is None) == (noise == 0.0)
        if t is not None:
            assert t.shape == (R, cfg.N_samples)
    for x, y in zip(a, b):                       # the generator decides
        assert (x is None and y is None) or torch.equal(x, y)


def test_phases_match_zest_tpu():
    for preset in (presets.SMALL_TRAIN, presets.FLAGSHIP_TRAIN):
        cfg, jcfg = ZestConfig(**preset), JZestConfig(**preset)
        d = cfg.decay_iteration_clamped * 1000
        for step in (0, d - 1, d, 2 * d, 2 * d + 1):
            assert tuple(phase_for_step(cfg, step)) == \
                tuple(jphase_for_step(jcfg, step)), step


def test_optimizer_matches_optax():
    """Three steps through the schedule's epoch boundaries, the first with a
    gradient norm above the clip, the others below it."""
    cfg = ZestConfig(**dict(presets.SMALL_TRAIN, lrate=1e-3, num_epochs=4))
    jsys = JZestSystem(JZestConfig(**dict(presets.SMALL_TRAIN, lrate=1e-3,
                                          num_epochs=4)))
    steps_per_epoch = 1
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (3.0, 0.01, 0.1)]
    jopt = jsys.make_optimizer(steps_per_epoch)
    jp, jstate = params, jopt.init(params)
    opt = ZestSystem(cfg).make_optimizer(steps_per_epoch)
    assert isinstance(opt, Optimizer)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tstate = opt.init(tp)
    for g in grads:
        upd, jstate = jopt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tp, tstate = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                                tstate, tp)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=2.5e-7, err_msg=k)
    assert tstate["count"] == 3


def test_from_jax_params_converts_gradient_trees():
    """The converter is linear per leaf, so a JAX gradient tree converts as
    parameters do: conv0's inert input channels 41..47 drop, and the
    deconvolutions' spatial flip applies to their gradients too."""
    sample = JSyntheticDataset(**presets.SMALL_SCENE)[presets.TARGET_FRAME]
    jb = {k: jnp.asarray(v) for k, v in sample.items()}
    jsys = JZestSystem(JZestConfig(**presets.SMALL))
    # the tree's structure and shapes without compiling, filled from a seed
    rng = np.random.default_rng(0)
    p = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                     jax.eval_shape(jsys.init_params, jax.random.PRNGKey(0), jb))
    q = jax.tree.map(lambda a: np.asarray(a) * 0 + 1.5, p)
    combo = jax.tree.map(lambda a, b: 2.0 * a - 3.0 * b, p, q)
    cp, cq, cc = (from_jax_params(t) for t in (p, q, combo))
    for k in cc:
        torch.testing.assert_close(cc[k], 2.0 * cp[k] - 3.0 * cq[k], rtol=1e-6,
                                   atol=1e-6)
    enc = p["enc_static"]["params"]["cost_reg_2"]
    k0 = np.asarray(enc["conv0"]["conv"]["kernel"])       # [kd, kh, kw, 48, 8]
    g0 = cp["enc_static.cost_reg_2.conv0.conv.weight"]
    assert k0.shape[3] == 48 and g0.shape[1] == 41
    np.testing.assert_array_equal(g0.numpy(),
                                  np.transpose(k0, (4, 3, 0, 1, 2))[:, :41])
    dk = np.asarray(enc["conv7"]["deconv_kernel"])        # [kd, kh, kw, in, out]
    np.testing.assert_array_equal(
        cp["enc_static.cost_reg_2.conv7.0.weight"].numpy(),
        np.transpose(dk, (3, 4, 0, 1, 2))[:, :, ::-1, ::-1, ::-1])


@pytest.mark.parametrize("name,group", [
    ("(anonymous namespace)::transpose_pack_kernel(float const*, float*)",
     "K7 field backward, weight transpose"),
    ("void (anonymous namespace)::fused_nerf_bwd_kernel<256>(float const*)",
     "K7 field backward, pass 1"),
    ("(anonymous namespace)::wgrad_tc32_kernel(Jobs, float*, long long, "
     "long long)", "K7 field backward, pass 2 (weights)"),
    ("void fused_nerf_kernel<256>(float const*)", "K6 fused field"),
    ("trilinear_grad_volume_kernel", "K4 volume lookup d/d volume"),
    ("trilinear_grad_coords_kernel", "K5 volume lookup d/d coordinates"),
    ("trilinear_sample_kernel", "K3 volume lookup"),
    ("plane_sweep_warp_bwd_kernel", "K2 warp backward"),
    ("plane_sweep_warp_kernel", "K1 warp"),
    ("void cudnn::cnn::wgrad2d_grouped_direct_kernel<true>",
     "cuDNN conv / deconv + batch norm"),
])
def test_profile_train_groups(name, group):
    assert profile_train.group_of(name, profile_train.GROUPS) == group


def test_profile_train_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_train.main() == 2
