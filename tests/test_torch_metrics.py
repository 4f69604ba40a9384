"""The port's image metrics and visualization helpers against zest_tpu's on
the CPU.

psnr and ssim take the same seeded float32 images through both packages
(rtol 1e-5: the same float32 arithmetic, summed in another order); float64
ssim is held to the kornia oracle's golden value of
``tests/test_round3.py`` (1e-12). The PNG writer, standard library only,
is read back with PIL beside zest_tpu's PIL writer: the same pixels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from zest_tpu import metrics as jmetrics
from zest_tpu.utils import visualize as jvisualize

from zest_tpu_torch import metrics
from zest_tpu_torch.utils import visualize

# kornia.metrics.ssim in float64 on the inputs of _ssim_inputs, from
# tests/test_round3.py
SSIM_GOLDEN = 0.9426351852969304


def _ssim_inputs():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(31, 47, 3))
    b = np.clip(a + 0.1 * rng.standard_normal((31, 47, 3)), 0, 1)
    return a, b


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(31, 47, 3), (32, 64, 3), (288, 512, 3)])
def test_psnr_and_ssim_match_zest_tpu(shape):
    a, b = _pair(shape, seed=shape[0])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    got_p, got_s = metrics.psnr(ta, tb), metrics.ssim(ta, tb, 5)
    assert got_p.dtype == got_s.dtype == torch.float32
    np.testing.assert_allclose(float(got_p), float(jmetrics.psnr(ja, jb)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got_s), float(jmetrics.ssim(ja, jb, 5)),
                               rtol=1e-5)


def test_ssim_window_matches_zest_tpu():
    np.testing.assert_allclose(metrics._ssim_window(5).numpy(),
                               np.asarray(jmetrics._ssim_window(5)),
                               rtol=1e-6)


def test_ssim_float64_matches_kornia_golden():
    a, b = _ssim_inputs()
    got = float(metrics.ssim(torch.from_numpy(a), torch.from_numpy(b), 5))
    assert abs(got - SSIM_GOLDEN) < 1e-12


def test_ssim_identical_images_is_one():
    a, _ = _pair((20, 24, 3), seed=1)
    t = torch.from_numpy(a).double()
    assert abs(float(metrics.ssim(t, t)) - 1.0) < 1e-12


@pytest.mark.parametrize("minmax", [None, (0.5, 3.0)])
def test_visualize_depth_matches_zest_tpu(minmax):
    rng = np.random.default_rng(2)
    depth = rng.uniform(0.0, 4.0, size=(17, 23)).astype(np.float32)
    depth[0, :5] = 0.0             # non-positive depths stay out of the min
    depth[1, 1] = np.nan
    np.testing.assert_array_equal(visualize.visualize_depth(depth, minmax),
                                  jvisualize.visualize_depth(depth, minmax))


@pytest.mark.parametrize("shape", [(13, 21), (13, 21, 3)])
def test_save_image_pixels_match_zest_tpu(tmp_path, shape):
    rng = np.random.default_rng(3)
    img = rng.uniform(-0.2, 1.2, size=shape).astype(np.float32)
    visualize.save_image(tmp_path / "port.png", img)
    jvisualize.save_image(tmp_path / "ref.png", img)
    got = Image.open(tmp_path / "port.png")
    ref = Image.open(tmp_path / "ref.png")
    assert got.mode == ref.mode == "RGB" and got.size == ref.size == (21, 13)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
