"""``use_color_volume`` of zest_tpu_torch against zest_tpu's on the CPU.

- ``geometry.ndc_to_world`` against zest_tpu's, and through
  ``world_to_ndc`` back to where it started;
- ``render.append_color_volume`` (the volume with each source view's RGB
  and in-bounds mask at every voxel centre) against zest_tpu's on the
  small scene's keyframes;
- ``sample_volume_plain`` at C = 8 + 4V channels against zest_tpu's
  ``sample_volume_zbanded`` (Pallas, interpret mode, its band check
  asserted), and the gradient of the lookup with ``lead`` (the first 8
  channels only) against autograd through the whole volume;
- MVSNeRF's configuration with the colour volume
  (``presets.SMALL_MVSNERF`` with ``use_color_volume``: C = 8 + 4 * 3)
  through both packages' eval and training steps at float32 and at
  precision 16 (``test_torch_ablation_mvsnerf.Family``);
- the scene-flow system's (``presets.SMALL_COLORVOL``) parameter names and
  shapes against zest_tpu's ``init_params``;
- one SVS step (``presets.SMALL_SVS`` with the colour volume) against
  zest_tpu's (``test_torch_svs_step.GanCase``).

Tolerances: those of ``test_torch_ablation_mvsnerf.py``'s docstring
(``test_torch_svs_step.py``'s for the SVS step, with its own table of
zest_tpu's jit-vs-eager spread, ``JIT_EAGER_COLORVOL``: the colour
volume's step meets other rounding than the SVS step's, and its jitted
step is up to 1.05e-3 of pts_linears.5.bias's largest gradient from its
own eager evaluation, where the port is as far from the jitted one on
every field leaf; re-measured with ``python
tests/test_torch_color_volume.py``, a few minutes); geometry rtol 1e-5 (a
3x3 inverse and two products in float32); the lookups rtol = atol = 1e-5,
as ``test_torch_render.py`` holds the 8-channel one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu import geometry as jgeometry
from zest_tpu import render as jrender
from zest_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from zest_tpu.kernels import trilinear as jtri
from zest_tpu.system import unpreprocess as junpre
from test_torch_ablation_mvsnerf import (Family, _few_threads,  # noqa: F401
                                         check_eval, check_grads, check_logs,
                                         check_p16_eval, check_p16_step,
                                         check_updated, zest_tpu_shapes)
from test_torch_render import _band_ndc
from test_torch_svs_step import GRAF_LOGS, GanCase, check_disc
from test_torch_svs_step import check_gen_grads, jit_eager_spread
from test_torch_svs_step import check_logs as check_gan_logs

from zest_tpu_torch import ZestConfig, geometry, presets, render
from zest_tpu_torch.kernels.trilinear import sample_volume, sample_volume_plain
from zest_tpu_torch.models.lpips import make_random_lpips_npz
from zest_tpu_torch.system import ZestSystem

TOL = dict(rtol=1e-5, atol=1e-5)
# test_torch_svs_step.jit_eager_spread of the SVS step with the colour
# volume at step 0, of each leaf's own largest gradient, rounded up; the
# field leaves above half its FIELD_RTOL
JIT_EAGER_COLORVOL = {"nerf_static.pts_linears.5.bias": 1.1e-3,
                      "nerf_static.pts_linears.5.weight": 9.8e-4,
                      "nerf_static.pts_linears.4.bias": 4.0e-4,
                      "nerf_static.pts_linears.3.bias": 2.3e-4,
                      "nerf_static.pts_linears.4.weight": 2.2e-4,
                      "nerf_static.pts_linears.0.bias": 1.9e-4,
                      "nerf_static.pts_linears.2.bias": 1.9e-4,
                      "nerf_static.pts_linears.2.weight": 1.6e-4,
                      "nerf_static.pts_bias.weight": 1.4e-4,
                      "nerf_static.pts_linears.1.bias": 1.4e-4,
                      "nerf_static.pts_linears.3.weight": 1.3e-4,
                      "nerf_static.pts_bias.bias": 1.1e-4,
                      "nerf_static.pts_linears.1.weight": 7.3e-5,
                      "nerf_static.pts_linears.0.weight": 5.1e-5}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def sample():
    return JSyntheticDataset(**presets.SMALL_SCENE)[presets.TARGET_FRAME]


@pytest.mark.parametrize("pad", [0, 4])
def test_ndc_to_world_matches_zest_tpu_and_inverts_world_to_ndc(sample, pad):
    rng = np.random.default_rng(0)
    ndc = rng.uniform(0.0, 1.0, (7, 5, 3)).astype(np.float32)
    inv_scale = np.array([63.0, 31.0], np.float32)
    w2c, intr, nf = (sample[k][0] for k in ("w2cs", "intrinsics",
                                            "near_fars"))
    got = geometry.ndc_to_world(_t(ndc), _t(w2c), _t(intr), _t(inv_scale),
                                float(nf[0]), float(nf[1]), pad)
    ref = jgeometry.ndc_to_world(jnp.asarray(ndc), jnp.asarray(w2c),
                                 jnp.asarray(intr), jnp.asarray(inv_scale),
                                 near=float(nf[0]), far=float(nf[1]), pad=pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    back = geometry.world_to_ndc(got, _t(w2c), _t(intr), _t(inv_scale),
                                 float(nf[0]), float(nf[1]), pad)
    np.testing.assert_allclose(back.numpy(), ndc, rtol=1e-5, atol=1e-5)


def test_append_color_volume_matches_zest_tpu(sample):
    rng = np.random.default_rng(1)
    vol = rng.normal(size=(128, 16, 24, 8)).astype(np.float32)
    imgs = junpre(sample["images"][:-1])
    V, H, W, _ = imgs.shape
    args = [sample[k] for k in ("w2cs", "intrinsics")]
    got = render.append_color_volume(_t(vol), _t(imgs), *map(_t, args),
                                     _t(sample["near_fars"][0]), pad=4)
    ref = jrender.append_color_volume(
        jnp.asarray(vol), jnp.asarray(imgs), *map(jnp.asarray, args),
        jnp.asarray(sample["near_fars"][0]),
        jnp.array([W - 1, H - 1], jnp.float32), pad=4)
    assert got.shape == ref.shape == (128, 16, 24, 8 + 4 * V)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    mask = got[..., 11::4]
    # some voxel centres project into each view and some do not
    assert 0.0 < float(mask.mean()) < 1.0


@pytest.mark.parametrize("views", [3, 8])
def test_wide_lookup_twin_matches_pallas_kernel(views):
    rng = np.random.default_rng(3)
    vol = rng.normal(size=(128, 16, 24, 8 + 4 * views)).astype(np.float32)
    ndc = _band_ndc(rng)
    *_, ok = jtri._precompute(jnp.asarray(ndc), 128, 16, 24, band=3)
    assert bool(ok)
    ref = jtri.sample_volume_zbanded(jnp.asarray(vol), jnp.asarray(ndc),
                                     band=3, approx=False)
    np.testing.assert_allclose(sample_volume_plain(_t(vol), _t(ndc)).numpy(),
                               np.asarray(ref), **TOL)


def test_lookup_gradient_reaches_only_the_lead_channels():
    rng = np.random.default_rng(4)
    lead = _t(rng.normal(size=(8, 6, 10, 8))).requires_grad_(True)
    colors = _t(rng.uniform(size=(8, 6, 10, 12)))
    ndc = _t(rng.uniform(-0.1, 1.1, (20, 8, 3)))
    g = _t(rng.normal(size=(20, 8, 20)))
    whole = torch.cat([lead.detach(), colors], -1).requires_grad_(True)
    out = sample_volume(torch.cat([lead, colors], -1).detach(), ndc, lead)
    out.backward(g)
    sample_volume_plain(whole, ndc).backward(g)
    np.testing.assert_allclose(lead.grad.numpy(), whole.grad[..., :8].numpy(),
                               **TOL)


@pytest.fixture(scope="module")
def colorvol():
    return Family(dict(presets.SMALL_MVSNERF, use_color_volume=True))


@pytest.fixture(scope="module")
def colorvol16(colorvol):
    return Family(dict(presets.SMALL_MVSNERF_16, use_color_volume=True),
                  colorvol.params)


def test_colorvol_eval_matches_zest_tpu(colorvol):
    check_eval(*colorvol.eval(), ("rgb_map", "depth_map"))


def test_colorvol_train_step_matches_zest_tpu(colorvol):
    r = colorvol.step(0)
    check_logs(r)
    check_grads(r)
    check_updated(r)


def test_colorvol_p16_eval_and_step_match_zest_tpu(colorvol, colorvol16):
    ref16, out16 = colorvol16.eval()
    ref32, out32 = colorvol.eval()
    check_p16_eval(ref16, out16, ref32, ("rgb_map", "depth_map"))
    assert float(np.abs(out16["rgb_map"] - out32["rgb_map"]).max()) > 0.0
    check_p16_step(colorvol16.step(0), colorvol.step(0))


@pytest.mark.parametrize("preset", ["SMALL_COLORVOL", "SMALL_COLORVOL_16"])
def test_colorvol_system_builds_zest_tpus_parameters(preset, sample):
    """The scene-flow system with the colour volume: the static field reads
    8 + 4 * 3 features, as without it, and the parameters are zest_tpu's
    names and shapes through ``convert``."""
    config = getattr(presets, preset)
    system = ZestSystem(ZestConfig(**config))
    got = system.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        zest_tpu_shapes(config, sample)
    assert system.nerf_static.in_ch_feat == 8 + 4 * 3


def _svs_case(lpips_path):
    return GanCase(dict(presets.SMALL_SVS, use_color_volume=True),
                   presets.SMALL_SCENE, lpips_path)


@pytest.fixture(scope="module")
def svs_colorvol(tmp_path_factory):
    path = tmp_path_factory.mktemp("lpips") / "lpips.npz"
    make_random_lpips_npz(path, seed=0)
    return _svs_case(path)


def test_svs_step_with_the_colour_volume_matches_zest_tpu(svs_colorvol):
    r = svs_colorvol.step(0)
    check_gan_logs(r, GRAF_LOGS)
    check_gen_grads(r, JIT_EAGER_COLORVOL)
    check_updated(r)
    check_disc(r, svs_colorvol.tdisc)


if __name__ == "__main__":
    import tempfile
    jax.config.update("jax_default_matmul_precision", "float32")
    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as tmp:
        make_random_lpips_npz(f"{tmp}/lpips.npz", seed=0)
        case = _svs_case(f"{tmp}/lpips.npz")
        spread = jit_eager_spread(case)
        r = case.step(0)
        for k, v in sorted(spread.items(), key=lambda kv: -kv[1]):
            g = r["jgrads"][k]
            port = float((r["grads"][k] - g).abs().max() / g.abs().max())
            print(f"{k}: jit-eager {v:.2e}, port-jit {port:.2e}")
