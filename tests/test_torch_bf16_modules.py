"""The port's 16-bit modules against zest_tpu's on the CPU, with the same
weights (``convert.from_jax_params``) and seeded numpy inputs:

- the bf16-operand field (``NeRFField(bf16=True)``, the twin of the field
  kernels' bf16 mode) against ``fused_nerf_apply(..., approx=True)``
  (Pallas, interpret mode), forward and every gradient leaf;
- the bf16 encoders (FeatureNet, CostRegNet, the whole MVSEncoder, static
  and dynamic) against zest_tpu's with ``dtype=bfloat16``.

Tolerances:
- the field: both round the same operands to bf16 and sum in float32, so
  the forward agrees as float32 does (rtol 1e-4, atol 1e-5); a float32 sum
  in another order can flip the bf16 rounding of one activation (a change
  of 2^-8 of one operand), so every input gradient and every weight and
  bias gradient is held to 1e-3 of its own largest (the worst measured is
  7.4e-5);
- the encoders: bf16 rounds in other places on each side (zest_tpu sums a
  3D convolution's three z taps and the deconvolution's phases in bf16, the
  port rounds each convolution once), and BatchNorm renormalizes those
  differences to O(1) values: each output is held to twice zest_tpu's own
  difference between its 16- and 32-bit runs of the same module, plus
  1e-4 of the output's scale. A check that the port's 16-bit output differs
  from its 32-bit one shows the bf16 path is taken.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu.data.synthetic import SyntheticDataset
from zest_tpu.kernels.fused_mlp import fused_nerf_apply
from zest_tpu.models.cost_reg import CostRegNet as JCostRegNet
from zest_tpu.models.feature_net import FeatureNet as JFeatureNet
from zest_tpu.models.mvsnet import MVSEncoder as JMVSEncoder
from zest_tpu.models.nerf import NeRFField as JNeRFField

from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.models.cost_reg import CostRegNet
from zest_tpu_torch.models.feature_net import FeatureNet
from zest_tpu_torch.models.mvsnet import MVSEncoder
from zest_tpu_torch.models.nerf import NeRFField

BF = (jnp.bfloat16, torch.bfloat16)
PAD = 4
# (P, F, V) of the static (xyz) and dynamic (xyzt) fields at multires 10 / 4
LAYOUTS = {True: (63, 40, 27), False: (84, 24, 27)}


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.mark.parametrize("static", [True, False])
def test_bf16_field_matches_approx_kernel(static):
    P, F, V = LAYOUTS[static]
    jfield = JNeRFField(depth=8, width=64, in_ch_pts=P, in_ch_views=V,
                        in_ch_feat=F, sceneflow=True, static=static,
                        use_mvs=True)
    variables = jax.tree.map(np.asarray, jfield.init(
        jax.random.PRNGKey(1), jnp.zeros((1, P)), jnp.zeros((1, F)),
        jnp.zeros((1, V))))
    field = NeRFField(8, 64, P, V, F, static=static, bf16=True)
    field.load_state_dict(_strip(from_jax_params({"nerf_static": variables}),
                                 "nerf_static."))
    rng = np.random.default_rng(0 if static else 1)
    inputs = [rng.normal(size=(37, 16, c)).astype(np.float32) for c in (P, F, V)]
    g = rng.normal(size=(37, 16, field.out_ch)).astype(np.float32)

    out_ref, vjp = jax.vjp(
        lambda v, *x: fused_nerf_apply(jfield, v, *x, approx=True), variables,
        *map(jnp.asarray, inputs))
    d_vars, *d_ins = vjp(jnp.asarray(g))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    out = field(*ins)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               rtol=1e-4, atol=1e-5)
    for name, a, b in zip(("pts", "feats", "views"), ins, d_ins):
        b = np.asarray(b)
        assert np.abs(a.grad.numpy() - b).max() <= 1e-3 * np.abs(b).max(), name
    ref = _strip(from_jax_params({"nerf_static": jax.tree.map(np.asarray, d_vars)}),
                 "nerf_static.")
    for name, p in field.named_parameters():
        b = ref[name].numpy()
        assert np.abs(p.grad.numpy() - b).max() <= 1e-3 * np.abs(b).max(), name
    # the mode rounds: the float32 field gives another output
    field.bf16 = False
    with torch.no_grad():
        assert float((field(*map(torch.from_numpy, inputs)) - out).abs().max()) > 0


@pytest.fixture(scope="module")
def scene():
    return SyntheticDataset(img_h=32, img_w=64, num_frames=9,
                            num_keyframes=3)[3]


@pytest.fixture(scope="module")
def enc_params(scene):
    """zest_tpu MVSEncoder params (static volume inputs) and their port."""
    init = jax.jit(lambda key, imgs, pms, nf: JMVSEncoder().init(
        key, imgs, pms, nf, pad=PAD))
    variables = jax.tree.map(np.asarray, init(
        jax.random.PRNGKey(0), jnp.asarray(scene["images"][:-1]),
        jnp.asarray(scene["proj_mats"][:-1]), jnp.asarray(scene["near_fars"][0])))
    return variables, _strip(from_jax_params({"enc_static": variables}),
                             "enc_static.")


def _hold(out16, out32, ref16, ref32, name):
    """out16 within twice zest_tpu's own 16-vs-32 difference of ref16, and
    the port's 16-bit output not its 32-bit one."""
    spread = np.abs(ref16 - ref32).max()
    err = np.abs(out16 - ref16).max()
    assert err <= 2 * spread + 1e-4 * np.abs(ref16).max(), (name, err, spread)
    assert np.abs(out16 - out32).max() > 0, name


def test_bf16_feature_net(scene, enc_params):
    variables, sd = enc_params
    x = jnp.asarray(scene["images"])
    refs = {dt: _np(JFeatureNet(dtype=dt).apply(
        {"params": variables["params"]["feature"]}, x))
        for dt in (jnp.float32, jnp.bfloat16)}
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        net = FeatureNet(dt)
        net.load_state_dict(_strip(sd, "feature."))
        with torch.no_grad():
            out = net(_t(scene["images"]).permute(0, 3, 1, 2))
        assert out.dtype == dt
        outs[dt] = out.permute(0, 2, 3, 1).float().numpy()
    _hold(outs[torch.bfloat16], outs[torch.float32], refs[jnp.bfloat16],
          refs[jnp.float32], "feature net")


def test_bf16_cost_reg_net(enc_params):
    variables, sd = enc_params
    x = np.random.default_rng(3).normal(size=(16, 16, 24, 41)).astype(np.float32)
    xp = jnp.pad(jnp.asarray(x), ((0, 0),) * 3 + ((0, 7),))[None]
    refs = {dt: _np(jax.jit(JCostRegNet(dtype=dt).apply)(
        {"params": variables["params"]["cost_reg_2"]}, xp)[0])
        for dt in (jnp.float32, jnp.bfloat16)}
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        net = CostRegNet(dtype=dt)
        net.load_state_dict(_strip(sd, "cost_reg_2."))
        with torch.no_grad():
            out = net(_t(x).permute(3, 0, 1, 2)[None])[0]
        assert out.dtype == dt
        outs[dt] = out.permute(1, 2, 3, 0).float().numpy()
    _hold(outs[torch.bfloat16], outs[torch.float32], refs[jnp.bfloat16],
          refs[jnp.float32], "cost reg net")


@pytest.mark.parametrize("identity", [False, True])
def test_bf16_mvs_encoder(scene, enc_params, identity):
    variables, sd = enc_params
    imgs = scene["nb_imgs"] if identity else scene["images"][:-1]
    pms = scene["nb_proj_mats"] if identity else scene["proj_mats"][:-1]
    near_far = scene["near_fars"][0]
    refs = {}
    for dt in (jnp.float32, jnp.bfloat16):
        apply = jax.jit(lambda v, *a, dt=dt: JMVSEncoder(
            identity_src_warp=identity, dtype=dt).apply(v, *a, pad=PAD))
        vol, feats, _ = apply(variables, jnp.asarray(imgs), jnp.asarray(pms),
                              jnp.asarray(near_far))
        refs[dt] = (_np(vol), _np(feats))
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        enc = MVSEncoder(identity_src_warp=identity, dtype=dt)
        enc.load_state_dict(sd)
        with torch.no_grad():
            vol, feats, _ = enc(_t(imgs), _t(pms), _t(near_far), pad=PAD)
        assert vol.dtype == torch.float32 and feats.dtype == dt
        outs[dt] = (vol.numpy(), feats.float().numpy())
    for i, name in enumerate(("volume", "features")):
        _hold(outs[torch.bfloat16][i], outs[torch.float32][i],
              refs[jnp.bfloat16][i], refs[jnp.float32][i], name)
