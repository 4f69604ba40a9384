"""The adversarial step with pix2pix's PatchGAN instead of GRAF's
discriminator, against zest_tpu's on the CPU: ``gan_type="n_layers"``
with its intermediate features (``getIntermFeat``: the feature-matching
term), the depth discriminator (``with_depth_loss``) and its update, the
depth reconstruction and total-variation terms, and the naive (binary
cross-entropy) GAN loss, on two 32x32 square patches of a 64x64 image
(2,048 rays), over MVSNeRF's generator at ``presets.SMALL_MVSNERF``'s
sizes (``presets.SMALL_PATCHGAN``). The helpers, the draws and the
tolerances are ``test_torch_svs_step.py``'s, with this case's own table of
zest_tpu's jit-vs-eager spread (``JIT_EAGER``: up to 6.3e-4 of a trunk
leaf's largest gradient here).
"""
import pytest

from zest_tpu_torch import presets
from zest_tpu_torch.models.lpips import make_random_lpips_npz
from test_torch_ablation_mvsnerf import _few_threads  # noqa: F401
from test_torch_svs_step import (GanCase, check_disc, check_gen_grads,
                                 check_logs, check_updated)

NLAYERS, NLAYERS_SCENE = presets.SMALL_PATCHGAN, presets.PATCHGAN_SCENE
# test_torch_svs_step.jit_eager_spread of this case at step 0
# (``python tests/test_torch_svs_step.py nlayers``), of each leaf's own
# largest gradient, rounded up; the field leaves above half FIELD_RTOL
JIT_EAGER = {"nerf_static.pts_bias.weight": 6.3e-4,
             "nerf_static.pts_linears.0.weight": 6.0e-4,
             "nerf_static.pts_linears.1.weight": 5.8e-4,
             "nerf_static.pts_linears.0.bias": 5.1e-4,
             "nerf_static.pts_linears.2.bias": 4.6e-4,
             "nerf_static.pts_linears.5.weight": 4.1e-4,
             "nerf_static.pts_linears.5.bias": 4.0e-4,
             "nerf_static.pts_bias.bias": 4.0e-4,
             "nerf_static.pts_linears.1.bias": 3.4e-4,
             "nerf_static.pts_linears.2.weight": 2.4e-4,
             "nerf_static.pts_linears.3.bias": 2.1e-4,
             "nerf_static.pts_linears.4.weight": 2.1e-4,
             "nerf_static.pts_linears.3.weight": 1.9e-4,
             "nerf_static.pts_linears.4.bias": 1.8e-4}


@pytest.fixture(scope="module")
def nlayers(tmp_path_factory):
    path = tmp_path_factory.mktemp("lpips") / "lpips.npz"
    make_random_lpips_npz(path, seed=0)
    return GanCase(NLAYERS, NLAYERS_SCENE, path)


def test_nlayers_gan_step_matches_zest_tpu(nlayers):
    r = nlayers.step(0)
    assert r["draws"].xs.shape == (2048,)
    check_logs(r, ["G_fake_loss", "G_rec_loss", "G_loss", "D_loss",
                   "D_fake_loss", "D_real_loss", "D_depth_loss", "train_loss",
                   "train_PSNR"])
    check_gen_grads(r, JIT_EAGER)
    check_updated(r)
    check_disc(r, nlayers.tdisc)
    assert r["vars"] == {} and set(r["depth_grads"]) == set(nlayers.tdepth)
