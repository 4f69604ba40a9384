"""zest_tpu_torch MVS encoder against zest_tpu on the CPU: FeatureNet,
CostRegNet, the cost volume and the whole MVSEncoder, with the same weights
carried over by ``convert.from_jax_params``; and the plane-sweep kernel's
twin against ``homo_warp_fast_cm`` (Pallas, interpret mode).

Tolerances: convolutions and BatchNorm sum hundreds of products in another
order on each side and renormalize to O(1) values, so they compare at
rtol = atol = 1e-4. The warp twin is a 4-tap gather of the same floats:
atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu.data.synthetic import SyntheticDataset
from zest_tpu.kernels.plane_sweep import homo_warp_fast_cm
from zest_tpu.models.cost_reg import CostRegNet as JCostRegNet
from zest_tpu.models.feature_net import FeatureNet as JFeatureNet
from zest_tpu.models.mvsnet import MVSEncoder as JMVSEncoder
from zest_tpu.models.mvsnet import build_cost_volume as jbuild_cost_volume

from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.kernels.plane_sweep import homo_warp_cm
from zest_tpu_torch.models.cost_reg import CostRegNet
from zest_tpu_torch.models.feature_net import FeatureNet
from zest_tpu_torch.models.mvsnet import MVSEncoder, build_cost_volume
from zest_tpu_torch.ops.homography import homography_grid

TOL = dict(rtol=1e-4, atol=1e-4)
PAD = 4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def scene():
    return SyntheticDataset(img_h=32, img_w=64, num_frames=9,
                            num_keyframes=3)[3]


@pytest.fixture(scope="module")
def enc_params(scene):
    """zest_tpu MVSEncoder params (static volume inputs) and their port."""
    init = jax.jit(lambda key, imgs, pms, nf: JMVSEncoder().init(
        key, imgs, pms, nf, pad=PAD))
    variables = init(jax.random.PRNGKey(0), jnp.asarray(scene["images"][:-1]),
                     jnp.asarray(scene["proj_mats"][:-1]),
                     jnp.asarray(scene["near_fars"][0]))
    variables = jax.tree.map(np.asarray, variables)
    sd = _strip(from_jax_params({"enc_static": variables}), "enc_static.")
    return variables, sd


def test_feature_net(scene, enc_params):
    variables, sd = enc_params
    imgs = scene["images"]
    ref = JFeatureNet().apply({"params": variables["params"]["feature"]},
                              jnp.asarray(imgs))
    net = FeatureNet()
    net.load_state_dict(_strip(sd, "feature."))
    with torch.no_grad():
        out = net(_t(imgs).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_cost_reg_net(enc_params):
    variables, sd = enc_params
    x = np.random.default_rng(0).normal(size=(16, 16, 24, 41)).astype(np.float32)
    # zest_tpu pads the cost volume to 48 channels with inert zeros
    ref = jax.jit(JCostRegNet().apply)(
        {"params": variables["params"]["cost_reg_2"]},
        jnp.pad(jnp.asarray(x), ((0, 0),) * 3 + ((0, 7),))[None])[0]
    net = CostRegNet()
    net.load_state_dict(_strip(sd, "cost_reg_2."))
    with torch.no_grad():
        out = net(_t(x).permute(3, 0, 1, 2)[None])[0].permute(1, 2, 3, 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("identity", [False, True])
def test_build_cost_volume(scene, identity):
    rng = np.random.default_rng(1)
    imgs = scene["nb_imgs"] if identity else scene["images"][:-1]
    pms = scene["nb_proj_mats"] if identity else scene["proj_mats"][:-1]
    feats = rng.normal(size=(imgs.shape[0], 8, 16, 32)).astype(np.float32)
    depths = np.linspace(2.0, 6.0, 16, dtype=np.float32)
    ref = jbuild_cost_volume(jnp.asarray(imgs), jnp.asarray(feats),
                             jnp.asarray(pms), jnp.asarray(depths), pad=PAD,
                             identity_src_warp=identity)
    out = build_cost_volume(_t(imgs), _t(feats), _t(pms), _t(depths), pad=PAD,
                            identity_src_warp=identity)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("identity", [False, True])
def test_mvs_encoder(scene, enc_params, identity):
    variables, sd = enc_params
    imgs = scene["nb_imgs"] if identity else scene["images"][:-1]
    pms = scene["nb_proj_mats"] if identity else scene["proj_mats"][:-1]
    near_far = scene["near_fars"][0]
    apply = jax.jit(lambda v, *a: JMVSEncoder(
        identity_src_warp=identity).apply(v, *a, pad=PAD))
    ref, ref_feats, ref_depths = apply(variables, jnp.asarray(imgs),
                                       jnp.asarray(pms), jnp.asarray(near_far))
    enc = MVSEncoder(identity_src_warp=identity)
    enc.load_state_dict(sd)
    with torch.no_grad():
        vol, feats, depths = enc(_t(imgs), _t(pms), _t(near_far), pad=PAD)
    assert vol.shape == (128, 8 + 2 * PAD, 16 + 2 * PAD, 8)
    np.testing.assert_allclose(vol.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref_feats), **TOL)
    np.testing.assert_allclose(depths.numpy(), np.asarray(ref_depths),
                               rtol=1e-6)


def test_plane_sweep_twin_matches_pallas_warp():
    """K1's twin (F.grid_sample on the port's grid) against the TPU kernel at
    feature width 128 — the only width where zest_tpu runs its Pallas path."""
    rng = np.random.default_rng(2)
    src = rng.normal(size=(8, 128, 8)).astype(np.float32)
    proj = np.array([[1, 0.01, 0.5, 0.3], [0.02, 1, -0.3, 0.2],
                     [1e-4, 0, 1, 0.01]], np.float32)
    depths = np.linspace(2.0, 6.0, 4, dtype=np.float32)
    ref, _ = homo_warp_fast_cm(jnp.asarray(src), jnp.asarray(proj),
                               jnp.asarray(depths), pad=2, band=8)
    grid = homography_grid(_t(proj), _t(depths), (8, 128), pad=2)
    out = homo_warp_cm(_t(src), grid)
    assert out.shape == (4, 8, 12 * 132)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
