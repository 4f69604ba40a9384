"""zest_tpu_torch's training render (``render.render_rays_train``) against
zest_tpu's ``render_rays(val=False)`` on the CPU: both fields with the same
weights, the same conditioning functions, density noise 1.0 from the same
JAX key, in both chain directions and with the chain pass. Every output the
port returns is compared, and the gradient of a random projection of all of
them with respect to every field weight (which holds the stop-gradients at
the same places).

Tolerance: rtol 1e-4 / atol 1e-5 on the outputs (composites of 16 samples
of fields that agree to ~1e-6), and 1e-4 of each weight gradient's largest
element.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu import render as jrender
from zest_tpu.models.nerf import NeRFField as JNeRFField
from zest_tpu.ops.grid_sample import grid_sample_3d as jgrid_sample_3d
from zest_tpu.sampling import RayBatch as JRayBatch

from zest_tpu_torch import render
from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.kernels.trilinear import sample_volume
from zest_tpu_torch.models.nerf import NeRFField
from zest_tpu_torch.sampling import Draws, RayBatch

R, S, WIDTH = 24, 16, 32
F_STATIC, F_DYN, V = 8 + 12, 8 + 16, 27


def _fields():
    out = {}
    for name, static, P, F in (("nerf_static", True, 63, F_STATIC),
                               ("nerf_dynamic", False, 84, F_DYN)):
        jf = JNeRFField(depth=8, width=WIDTH, in_ch_pts=P, in_ch_views=V,
                        in_ch_feat=F, sceneflow=True, static=static,
                        use_mvs=True)
        v = jax.tree.map(np.asarray, jf.init(jax.random.PRNGKey(len(out)),
                                             jnp.zeros((1, P)),
                                             jnp.zeros((1, F)),
                                             jnp.zeros((1, V))))
        alpha = v["params"]["alpha_linear"]
        alpha["bias"] = alpha["bias"] + 1.0
        head = v["params"]["w_linear" if static else "sf_linear"]
        head["kernel"] = head["kernel"] * 0.3
        tf = NeRFField(8, WIDTH, P, V, F, static=static)
        tf.load_state_dict({k.removeprefix(name + "."): t for k, t in
                            from_jax_params({name: v}).items()})
        out[name] = (jf, v, tf)
    return out


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    rays_d = f32(rng.normal(size=(R, 3)) * 0.2 + [0, 0, 1])
    z = np.sort(rng.uniform(2.0, 6.0, size=(R, S)), -1)
    pts = f32(rng.normal(size=3) * 0.1 + z[..., None] * rays_d[:, None])
    ndc = f32(np.concatenate([rng.uniform(0.05, 0.95, size=(R, S, 2)),
                              (z[..., None] - 2.0) / 4.0], -1))
    rays = dict(pts=pts, ndc=ndc, z_vals=f32(z), rays_d=rays_d,
                color_gt=f32(rng.uniform(size=(R, 3))),
                depth_gt=f32(rng.uniform(size=R)), t_vals=f32(np.linspace(0, 1, S)))
    vols = [f32(rng.normal(size=(16, 10, 12, 8))) for _ in range(2)]
    w2c = np.eye(4, dtype=np.float32)
    return rays, vols, w2c


def _jmodels(fields, vols):
    (jfs, vs, _), (jfd, vd, _) = fields["nerf_static"], fields["nerf_dynamic"]
    sv, dv = map(jnp.asarray, vols)
    return jrender.RenderModels(
        static_fn=lambda p, f, v: jfs.apply(vs, p, f, v),
        dynamic_fn=lambda p, f, v: jfd.apply(vd, p, f, v),
        static_feats=lambda pts, ndc: jnp.concatenate(
            [jgrid_sample_3d(sv, ndc * 2 - 1), jnp.tile(jnp.sin(pts), 4)], -1),
        dynamic_vol=lambda ndc, banded=False: jgrid_sample_3d(dv, ndc * 2 - 1),
        dynamic_col=lambda pts: jnp.tile(jnp.cos(2 * pts), 6)[..., :16])


def _tmodels(fields, vols):
    tfs, tfd = fields["nerf_static"][2], fields["nerf_dynamic"][2]
    sv, dv = map(torch.from_numpy, vols)
    return render.RenderModels(
        static_fn=tfs, dynamic_fn=tfd,
        static_feats=lambda pts, ndc: torch.cat(
            [sample_volume(sv, ndc), torch.sin(pts).repeat(1, 1, 4)], -1),
        dynamic_vol=lambda ndc: sample_volume(dv, ndc),
        dynamic_col=lambda pts: torch.cos(2 * pts).repeat(1, 1, 6)[..., :16])


@pytest.mark.parametrize("chain_bwd,chain_5frames", [(True, False),
                                                     (False, True),
                                                     (True, True)])
def test_render_rays_train_matches_zest_tpu(chain_bwd, chain_5frames):
    fields = _fields()
    rays, vols, w2c = _scene()
    key = jax.random.PRNGKey(7)
    kw = dict(ref_frame_idx=-0.25, num_frames=9.0)
    jmodels = _jmodels(fields, vols)

    def jrun(variables):
        models = jmodels._replace(
            static_fn=lambda p, f, v: fields["nerf_static"][0].apply(
                variables["nerf_static"], p, f, v),
            dynamic_fn=lambda p, f, v: fields["nerf_dynamic"][0].apply(
                variables["nerf_dynamic"], p, f, v))
        return jrender.render_rays(
            models, JRayBatch(**{k: jnp.asarray(v) for k, v in rays.items()}),
            im_w2c_ref=jnp.asarray(w2c), nb_w2c_ref=jnp.asarray(w2c),
            scene_flow=True, chain_bwd=jnp.asarray(chain_bwd),
            chain_5frames=chain_5frames, raw_noise_std=1.0, rng=key,
            val=False, **kw)

    variables = {k: v[1] for k, v in fields.items()}
    jout = jax.jit(jrun)(variables)
    noise = [np.asarray(jax.random.normal(k, (R, S)))
             for k in jax.random.split(key, 5)]
    draws = Draws(None, None, None, None, *map(torch.tensor, noise))
    out = render.render_rays_train(
        _tmodels(fields, vols),
        RayBatch(**{k: torch.from_numpy(v) for k, v in rays.items()}), draws,
        im_w2c_ref=torch.from_numpy(w2c), nb_w2c_ref=torch.from_numpy(w2c),
        chain_bwd=chain_bwd, chain_5frames=chain_5frames, raw_noise_std=1.0,
        **kw)
    assert ("rgb_map_pp_dy" in out) == chain_5frames
    for k, v in out.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(jout[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert float(out["rgb_map_ref"].std()) > 1e-3

    # the gradient of a random projection of every output
    rng = np.random.default_rng(1)
    proj = {k: rng.normal(size=np.shape(jout[k])).astype(np.float32)
            for k in out}
    def jproj(v):
        o = jrun(v)
        return sum(jnp.vdot(o[k], proj[k]) for k in out)

    jg = jax.jit(jax.grad(jproj))(variables)
    loss = sum((v * torch.from_numpy(proj[k])).sum() for k, v in out.items())
    loss.backward()
    for name, (_, _, tf) in fields.items():
        ref = from_jax_params({name: jax.tree.map(np.asarray, jg[name])})
        for pname, p in tf.named_parameters():
            r = ref[f"{name}.{pname}"].numpy()
            err = float(np.abs(p.grad.numpy() - r).max())
            assert err <= 1e-4 * max(float(np.abs(r).max()), 1e-30), \
                (name, pname, err)
