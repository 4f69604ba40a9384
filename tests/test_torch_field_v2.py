"""The additive ``net_type="v2"`` field (the reference's ``Renderer_linear``)
of zest_tpu_torch against zest_tpu's on the CPU.

- The field alone against zest_tpu's Flax ``NeRFField(net_type="v2")`` on
  the same weights (``convert.from_jax_params``), in each head geometry:
  the output and every input and weight gradient.
- A v2 field has no bf16-operand mode and needs its volume: the port
  raises by name, and zest_tpu's field fails on the features that are
  None.
- MVSNeRF's configuration made v2 (``presets.SMALL_MVSNERF`` with
  ``net_type="v2"``: one plain field on the static volume of 3 source
  views; ``presets.SMALL_V2`` is the scene-flow twin that chip_smoke runs
  at full width) through both packages' eval and training steps, at
  float32 and at precision 16, with the helpers of
  ``test_torch_ablation_mvsnerf.py`` (``Family``).

Tolerances: those of ``test_torch_ablation_mvsnerf.py``'s docstring; the
field alone as ``test_torch_field_heads.py`` holds it (rtol 1e-4, atol
1e-5; gradients within 1e-4 of each one's largest).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu.models.nerf import NeRFField as JNeRFField
from test_torch_ablation_mvsnerf import (Family, _few_threads,  # noqa: F401
                                         check_eval, check_grads, check_logs,
                                         check_p16_eval, check_p16_step,
                                         check_updated)

from zest_tpu_torch import ZestConfig, presets
from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.models.nerf import NeRFField
from zest_tpu_torch.system import ZestSystem

TOL = dict(rtol=1e-4, atol=1e-5)
# geometry -> (sceneflow, static, (P, F, V))
GEOMETRIES = {"rgba": (False, True, (63, 20, 27)),
              "static": (True, True, (63, 40, 27)),
              "dynamic": (True, False, (84, 24, 27))}


def _fields(geometry, width=64):
    sceneflow, static, (P, F_, V) = GEOMETRIES[geometry]
    jfield = JNeRFField(depth=8, width=width, in_ch_pts=P, in_ch_views=V,
                        in_ch_feat=F_, sceneflow=sceneflow, static=static,
                        use_mvs=True, net_type="v2")
    variables = jax.tree.map(np.asarray, jfield.init(
        jax.random.PRNGKey(1), jnp.zeros((1, P)), jnp.zeros((1, F_)),
        jnp.zeros((1, V))))
    field = NeRFField(8, width, P, V, F_, static=static, sceneflow=sceneflow,
                      net_type="v2")
    field.load_state_dict({k.removeprefix("nerf_static."): v for k, v in
                           from_jax_params({"nerf_static": variables}).items()})
    return jfield, variables, field


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_v2_field_matches_flax_with_gradients(geometry):
    jfield, variables, field = _fields(geometry)
    assert not field.fused
    rng = np.random.default_rng(2)
    ins = [rng.normal(size=(300, c)).astype(np.float32)
           for c in GEOMETRIES[geometry][2]]
    g = rng.normal(size=(300, field.out_ch)).astype(np.float32)

    @jax.jit
    def forward_and_vjp(v, p, f, vw, cot):
        out, vjp = jax.vjp(jfield.apply, v, p, f, vw)
        return out, vjp(cot)

    ref, (d_vars, *d_ins) = forward_and_vjp(
        variables, *map(jnp.asarray, ins), jnp.asarray(g))
    tins = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    out = field(*tins)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    # the field's own activations: rgb in (0, 1), alpha >= 0
    rgba = out.detach()[:, :4]
    assert 0.0 < float(rgba[:, :3].min()) and float(rgba[:, :3].max()) < 1.0
    assert float(rgba[:, 3].min()) >= 0.0
    for a, b in zip(tins, d_ins):
        b = np.asarray(b)
        assert np.abs(a.grad.numpy() - b).max() <= 1e-4 * np.abs(b).max()
    ref_leaves = from_jax_params({"nerf_static": jax.tree.map(np.asarray,
                                                              d_vars)})
    for name, p in field.named_parameters():
        b = ref_leaves[f"nerf_static.{name}"].numpy()
        assert np.abs(p.grad.numpy() - b).max() <= 1e-4 * np.abs(b).max(), name


def test_v2_field_refuses_bf16_and_a_missing_volume():
    with pytest.raises(ValueError, match="bf16"):
        NeRFField(8, 64, 63, 27, 20, net_type="v2", bf16=True)
    with pytest.raises(ValueError, match="v2.*use_mvs"):
        NeRFField(8, 64, 63, 27, 20, net_type="v2", use_mvs=False)
    # zest_tpu's v2 field without features fails at its pts_bias
    jfield = JNeRFField(depth=2, width=8, in_ch_pts=3, in_ch_views=3,
                        in_ch_feat=4, sceneflow=False, use_mvs=False,
                        net_type="v2")
    with pytest.raises(AttributeError):
        jfield.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)), None,
                    jnp.zeros((1, 3)))


@pytest.mark.parametrize("preset", ["SMALL_V2", "SMALL_V2_16"])
def test_v2_system_has_plain_fields_only(preset):
    system = ZestSystem(ZestConfig(**getattr(presets, preset)))
    for field in (system.nerf_static, system.nerf_dynamic):
        assert field.net_type == "v2" and not field.fused and not field.bf16
    assert system.bf16 == preset.endswith("_16")


@pytest.fixture(scope="module")
def v2():
    return Family(dict(presets.SMALL_MVSNERF, net_type="v2"))


@pytest.fixture(scope="module")
def v2_16(v2):
    return Family(dict(presets.SMALL_MVSNERF_16, net_type="v2"), v2.params)


def test_v2_eval_matches_zest_tpu(v2):
    check_eval(*v2.eval(), ("rgb_map", "depth_map"))


def test_v2_train_step_matches_zest_tpu(v2):
    r = v2.step(0)
    check_logs(r)
    check_grads(r)
    check_updated(r)


def test_v2_p16_eval_and_step_match_zest_tpu(v2, v2_16):
    ref16, out16 = v2_16.eval()
    ref32, out32 = v2.eval()
    check_p16_eval(ref16, out16, ref32, ("rgb_map", "depth_map"))
    # the 16-bit path is taken: the volume and the images are rounded
    assert float(np.abs(out16["rgb_map"] - out32["rgb_map"]).max()) > 0.0
    check_p16_step(v2_16.step(0), v2.step(0))
