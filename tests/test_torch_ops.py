"""zest_tpu_torch geometry, embedding, ray building, grid sampling and
homography against zest_tpu on the CPU.

Inputs come from a numpy seed and go to both packages. JAX runs with float32
matmuls (conftest pin); torch runs in float32 with TF32 off (the CPU default).
Tolerance: atol 1e-5 on geometry and gathers — both sides compute the same
float32 formulas, so they differ by a few rounding steps on O(1)-O(100)
values; rtol 1e-5 covers the pixel-scale coordinates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu import geometry as jgeo
from zest_tpu import sampling as jsamp
from zest_tpu.models.embedding import positional_encoding as jpe
from zest_tpu.ops import grid_sample as jgs
from zest_tpu.ops import homography as jhom
from zest_tpu.data.synthetic import SyntheticDataset
from zest_tpu.system import unpreprocess as junpre

from zest_tpu_torch import geometry, sampling
from zest_tpu_torch.models.embedding import positional_encoding
from zest_tpu_torch.ops import grid_sample, homography
from zest_tpu_torch.system import unpreprocess

ATOL, RTOL = 1e-5, 1e-5


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def scene():
    return SyntheticDataset(img_h=32, img_w=64, num_frames=9,
                            num_keyframes=3)[3]


@pytest.mark.parametrize("n_freqs,ch", [(10, 3), (4, 3), (10, 4), (0, 3)])
def test_positional_encoding(n_freqs, ch):
    x = np.random.default_rng(0).uniform(-1, 1, (5, 7, ch)).astype(np.float32)
    _close(positional_encoding(_t(x), n_freqs), jpe(jnp.asarray(x), n_freqs))


@pytest.mark.parametrize("pad", [0, 4])
def test_rays_and_ndc(scene, pad):
    rng = np.random.default_rng(1)
    xs = rng.uniform(0, 63, 50).astype(np.float32)
    ys = rng.uniform(0, 31, 50).astype(np.float32)
    intr, c2w, w2c = scene["intrinsics"][-1], scene["c2ws"][-1], scene["w2cs"][0]
    o, d = geometry.get_rays(_t(xs), _t(ys), _t(intr), _t(c2w))
    jo, jd = jgeo.get_rays(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(intr),
                           jnp.asarray(c2w))
    _close(o, jo)
    _close(d, jd)
    z = rng.uniform(2, 6, (50, 16)).astype(np.float32)
    pts = geometry.points_along_rays(o, d, _t(z))
    jpts = jgeo.points_along_rays(jo, jd, jnp.asarray(z))
    _close(pts, jpts)
    inv = np.array([63.0, 31.0], np.float32)
    ndc = geometry.world_to_ndc(pts, _t(w2c), _t(intr), _t(inv), 2.0, 6.0, pad)
    jndc = jgeo.world_to_ndc(jpts, jnp.asarray(w2c), jnp.asarray(intr),
                             jnp.asarray(inv), 2.0, 6.0, pad)
    _close(ndc, jndc)
    cos = torch.linalg.norm(d, dim=-1, keepdim=True)
    _close(geometry.depth2dist(_t(z), cos),
           jgeo.depth2dist(jnp.asarray(z), jnp.asarray(cos.numpy())))


def test_normalize_frame_idx_and_unpreprocess(scene):
    assert float(geometry.normalize_frame_idx(torch.tensor(3.0),
                                              torch.tensor(9.0))) == \
        pytest.approx(float(jgeo.normalize_frame_idx(3.0, 9.0)))
    _close(unpreprocess(_t(scene["images"])), junpre(jnp.asarray(scene["images"])))


@pytest.mark.parametrize("chunk,idx", [(-1, 0), (500, 0), (500, 4)])
def test_sample_pixels_grid(chunk, idx):
    xs, ys = sampling.sample_pixels_grid(32, 64, chunk, idx)
    jxs, jys = jsamp.sample_pixels_grid(32, 64, chunk, idx)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))


def test_depth_candidates_jitter_matches_stratified_draw():
    key = jax.random.PRNGKey(5)
    jz, jt = jsamp.depth_candidates(key, 2.0, 6.0, 20, 16, stratified=True)
    # the same uniform draws that zest_tpu makes inside, handed in as a tensor
    jitter = np.asarray(jax.random.uniform(key, (20, 16)))
    z, t = sampling.depth_candidates(torch.tensor(2.0), torch.tensor(6.0), 20,
                                     16, jitter=_t(jitter))
    _close(z, jz)
    _close(t, jt)


@pytest.mark.parametrize("pad", [0, 4])
def test_build_rays(scene, pad):
    imgs = np.asarray(junpre(jnp.asarray(scene["images"])))
    keys = ("depths", "w2cs", "c2ws", "intrinsics", "near_fars")
    xs, ys = sampling.sample_pixels_grid(32, 64, 700, 2)
    rays = sampling.build_rays(xs, ys, images=_t(imgs),
                               **{k: _t(scene[k]) for k in keys},
                               n_samples=16, pad=pad)
    jxs, jys = jsamp.sample_pixels_grid(32, 64, 700, 2)
    jrays = jsamp.build_rays(jax.random.PRNGKey(0), jxs, jys,
                             images=jnp.asarray(imgs),
                             **{k: jnp.asarray(scene[k]) for k in keys},
                             n_samples=16, pad=pad, stratified=False)
    for name in ("pts", "ndc", "z_vals", "rays_d", "color_gt", "depth_gt",
                 "t_vals"):
        _close(getattr(rays, name), getattr(jrays, name))


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_grid_sample_2d(mode):
    rng = np.random.default_rng(2)
    img = rng.normal(size=(9, 13, 5)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (4, 6, 2)).astype(np.float32)
    _close(grid_sample.grid_sample_2d(_t(img), _t(grid), mode),
           jgs.grid_sample_2d(jnp.asarray(img), jnp.asarray(grid), mode))


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_grid_sample_3d(mode):
    rng = np.random.default_rng(3)
    vol = rng.normal(size=(7, 9, 11, 8)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (5, 6, 3)).astype(np.float32)
    _close(grid_sample.grid_sample_3d(_t(vol), _t(grid), mode),
           jgs.grid_sample_3d(jnp.asarray(vol), jnp.asarray(grid), mode))


@pytest.mark.parametrize("pad", [0, 4])
def test_homography(scene, pad):
    rng = np.random.default_rng(4)
    feat = rng.normal(size=(8, 16, 6)).astype(np.float32)
    pm = scene["proj_mats"][2]
    depths = np.linspace(2.0, 6.0, 5, dtype=np.float32)
    grid = homography.homography_grid(_t(pm), _t(depths), (8, 16), pad)
    jgrid = jhom.homography_grid(jnp.asarray(pm), jnp.asarray(depths), (8, 16),
                                 pad)
    _close(grid, jgrid)
    warped, _ = homography.homo_warp(_t(feat), _t(pm), _t(depths), pad=pad)
    jwarped, _ = jhom.homo_warp(jnp.asarray(feat), jnp.asarray(pm),
                                jnp.asarray(depths), pad=pad)
    _close(warped, jwarped)
    _close(homography.in_bounds_mask(grid), jhom.in_bounds_mask(jgrid))
    w_cm, m_cm = homography.identity_warp_cm(_t(feat), 5, pad=pad)
    jw_cm, jm_cm = jhom.identity_warp_cm(jnp.asarray(feat), 5, pad=pad)
    _close(w_cm, jw_cm)
    _close(m_cm, jm_cm)
