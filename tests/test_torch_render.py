"""zest_tpu_torch compositing and conditioning features against zest_tpu on
the CPU; the volume-lookup twin against ``sample_volume_zbanded`` and the
color-gather twin against ``gather_colors_banded`` (Pallas, interpret mode,
with their band checks asserted so the kernel path is the one compared).

Tolerances: compositing sums at most 128 float32 terms, rtol = atol = 1e-5;
gathers blend 4-8 taps of the same floats, atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu import render as jrender
from zest_tpu.data.synthetic import SyntheticDataset
from zest_tpu.kernels import color_gather as jcolor
from zest_tpu.kernels import trilinear as jtri
from zest_tpu.system import unpreprocess as junpre

from zest_tpu_torch import render
from zest_tpu_torch.kernels.color_gather import gather_colors
from zest_tpu_torch.kernels.trilinear import sample_volume

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _raws(rng, R=40, S=32):
    z = np.sort(rng.uniform(2, 6, (R, S)), -1).astype(np.float32)
    dists = np.concatenate([np.diff(z, axis=-1), np.full((R, 1), 1e10)], -1)
    return (rng.normal(size=(R, S, 4)).astype(np.float32),
            rng.normal(size=(R, S, 4)).astype(np.float32),
            rng.uniform(size=(R, S)).astype(np.float32), z,
            dists.astype(np.float32))


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_raw2outputs(white_bkgd):
    raw, _, _, z, dists = _raws(np.random.default_rng(0))
    out = render.raw2outputs(_t(raw), _t(z), _t(dists), white_bkgd)
    ref = jrender.raw2outputs(jnp.asarray(raw), jnp.asarray(z),
                              jnp.asarray(dists), white_bkgd)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_raw2outputs_blending():
    raw_dy, raw_rigid, blend, z, dists = _raws(np.random.default_rng(1))
    out = render.raw2outputs_blending(_t(raw_dy), _t(raw_rigid), _t(blend),
                                      _t(z), _t(dists))
    ref = jrender.raw2outputs_blending(jnp.asarray(raw_dy),
                                       jnp.asarray(raw_rigid),
                                       jnp.asarray(blend), jnp.asarray(z),
                                       jnp.asarray(dists))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_gen_dir_feature():
    rng = np.random.default_rng(2)
    w2c = rng.normal(size=(4, 4)).astype(np.float32)
    d = rng.normal(size=(10, 3)).astype(np.float32)
    np.testing.assert_allclose(
        render.gen_dir_feature(_t(w2c), _t(d)).numpy(),
        np.asarray(jrender.gen_dir_feature(jnp.asarray(w2c), jnp.asarray(d))),
        **TOL)


def _band_ndc(rng, R=200, D=128):
    """Ray points whose z follows the depth planes (linspace + in-bin jitter),
    the structure zest_tpu's banded kernel needs; x, y spill past [0, 1]."""
    S = D
    z = (np.arange(S)[None] + rng.uniform(-0.4, 0.4, (R, S))) / (D - 1)
    xy = rng.uniform(-0.05, 1.05, (R, S, 2))
    return np.concatenate([xy, np.clip(z, 0, 1)[..., None]], -1) \
        .astype(np.float32)


def test_trilinear_twin_matches_pallas_kernel():
    rng = np.random.default_rng(3)
    vol = rng.normal(size=(128, 16, 24, 8)).astype(np.float32)
    ndc = _band_ndc(rng)
    *_, ok = jtri._precompute(jnp.asarray(ndc), 128, 16, 24, band=3)
    assert bool(ok)                      # the Pallas path, not its fallback
    ref = jtri.sample_volume_zbanded(jnp.asarray(vol), jnp.asarray(ndc), band=3,
                                     approx=False)
    out = sample_volume(_t(vol), _t(ndc))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the render path's lookup in zest_tpu, which the port calls directly
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jrender.sample_volume_features(
            jnp.asarray(vol), jnp.asarray(ndc))), **TOL)


def test_color_gather_twin_matches_pallas_kernel():
    rng = np.random.default_rng(4)
    H, W = 48, 64
    imgs = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    # per view 3 chunks of 128 points near one row each, some off the image
    xs = rng.uniform(-1.5, W + 0.5, size=(2, 3, 128))
    ys = np.array([5.0, 22.0, 40.0])[None, :, None] + \
        rng.uniform(-2.0, 2.0, size=(2, 3, 128))
    xy = np.stack([xs, ys], -1).reshape(2, -1, 2).astype(np.float32)
    out = gather_colors(_t(imgs), _t(xy))
    for v in range(2):
        *_, ok = jcolor._precompute(jnp.asarray(xy[v]), H, W, 16)
        assert bool(ok)
        ref = jcolor.gather_colors_banded(jnp.asarray(imgs[v]),
                                          jnp.asarray(xy[v]), band=16)
        np.testing.assert_allclose(out[v].numpy(), np.asarray(ref), **TOL)


def test_build_color_features():
    scene = SyntheticDataset(img_h=32, img_w=64, num_frames=9,
                             num_keyframes=3)[3]
    imgs = np.asarray(junpre(jnp.asarray(scene["images"][:-1])))
    rng = np.random.default_rng(5)
    # points along target rays, near the depth range of the scene
    pts = (rng.uniform(-1.5, 1.5, (64, 16, 3)) * [1, 0.5, 0]
           + [0, 0, 1] * rng.uniform(2, 6, (64, 16, 1))).astype(np.float32)
    out = render.build_color_features(_t(pts), _t(imgs),
                                      _t(scene["w2cs"][:-1]),
                                      _t(scene["intrinsics"][:-1]))
    ref = jrender.build_color_features(jnp.asarray(pts), jnp.asarray(imgs),
                                       jnp.asarray(scene["w2cs"][:-1]),
                                       jnp.asarray(scene["intrinsics"][:-1]))
    assert out.shape == (64, 16, 12)
    mask = out.numpy()[..., 3::4]
    assert 0 < mask.mean() < 1           # both inside and outside points
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
