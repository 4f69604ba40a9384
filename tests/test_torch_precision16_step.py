"""The whole training step of zest_tpu_torch at 16-bit precision
(``presets.SMALL_TRAIN_16``) against zest_tpu's at ``precision=16`` on the
CPU, in both phases of a step (step 0: the motion-mask rays, no chain pass;
step 2001: the chain pass), from the same weights and draws as
``test_torch_train_step.py`` (its ``make_setup`` and ``jax_draws``).

bf16 rounds at other places in the two packages (zest_tpu sums a 3D
convolution's z taps in bf16, gathers the warped points' rows from an
octo-paired volume and scatters their gradients into it in bf16, rounds its
kernels' interpolation weights for the TPU's matrix unit), so the step is
held to zest_tpu's own spread: ``SPREAD`` is the difference between
zest_tpu's 16- and its 32-bit step on the same inputs, measured once per
quantity and written down here (rounded up to two digits), so that this
file compiles zest_tpu's step only at 16 bits. Tolerances:

- the loss and every log: twice its spread, plus 1e-4 of its value (the
  float32 step's tolerance);
- every field gradient leaf: twice the spread of its layer (the larger of
  the layer's weight and bias), plus 1e-3 of the field's largest gradient;
- every encoder gradient leaf: twice the largest spread of its encoder,
  plus 1e-3 of its largest gradient. A convolution's weight gradient ahead
  of a BatchNorm sums terms that the BatchNorm made cancel, so it is bf16
  noise: on ``enc_dy.cost_reg_2.conv11.0.weight`` the port's own 16-vs-32
  difference is 84 % of the leaf's largest and zest_tpu's 14 %, each
  package rounding its own way, and a leaf-by-leaf rule would compare two
  noises.

And the port's 16-bit loss differs from its 32-bit one: the bf16 path is
taken.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu.config import ZestConfig as JZestConfig
from zest_tpu.system import Phase as JPhase
from zest_tpu.system import ZestSystem as JZestSystem
from test_torch_train_step import KEY, PHASES, jax_draws, make_setup

from zest_tpu_torch import ZestConfig, presets
from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.system import TrainState, ZestSystem, to_batch

CFG = presets.SMALL_TRAIN_16
LOG_RTOL = 1e-4
MODULE_FLOOR = 1e-3
# each field's layers in this order; SPREAD gives one number per layer
LAYERS = {
    "nerf_static": ("pts_bias", *(f"pts_linears.{i}" for i in range(8)),
                    "w_linear", "alpha_linear", "feature_linear",
                    "views_linears.0", "rgb_linear"),
    "nerf_dynamic": ("pts_bias", *(f"pts_linears.{i}" for i in range(8)),
                     "sf_linear", "prob_linear", "alpha_linear",
                     "feature_linear", "views_linears.0", "rgb_linear")}
# zest_tpu's |16-bit - 32-bit| at this file's inputs: per log (and the
# loss), per encoder (its largest leaf), per field layer
SPREAD = {
    0: dict(
        logs=dict(loss=4.6e-05, combined_loss=4e-06, entropy_loss=3.9e-09,
                  flow_loss=6.3e-07, pho_loss=2.5e-06, prob_reg_loss=1.2e-06,
                  sceneflow_loss=4.6e-05, sf_cycle_loss=1.7e-08,
                  sf_depth_loss=2.5e-05, sf_min_loss=1.3e-07,
                  sf_sp_loss=1.5e-05, sf_st_loss=6.8e-06, train_PSNR=0.00043,
                  train_loss=4.6e-05),
        modules=dict(enc_static=2e-05, enc_dy=0.0037),
        nerf_static=(4.5e-06, 4e-10, 1.5e-09, 4.3e-09, 1.3e-08, 5.7e-08,
                     7.6e-07, 7.2e-07, 3.6e-06, 2.3e-06, 1.8e-06, 1.1e-05,
                     6.7e-05, 1.1e-05),
        nerf_dynamic=(0.00033, 7.3e-08, 1.6e-07, 8.5e-07, 2.2e-06, 8e-06,
                      3.7e-05, 0.00011, 0.00056, 0.016, 6.3e-06, 0.00017,
                      4.9e-05, 0.00027, 3e-05)),
    2001: dict(
        logs=dict(loss=1.2e-05, combined_loss=1.5e-06, entropy_loss=1.8e-09,
                  flow_loss=1.9e-09, pho_loss=8.3e-06, prob_reg_loss=9.4e-07,
                  sceneflow_loss=1.2e-05, sf_cycle_loss=1.4e-08,
                  sf_depth_loss=1.4e-07, sf_min_loss=2.6e-08,
                  sf_sp_loss=9.3e-06, sf_st_loss=1.1e-05, train_PSNR=0.00037,
                  train_loss=1.2e-05),
        modules=dict(enc_static=2.1e-05, enc_dy=0.0058),
        nerf_static=(2.6e-06, 1.9e-09, 8e-09, 4.5e-09, 1.6e-08, 6.4e-08,
                     3.8e-07, 1.9e-06, 4.6e-06, 2.8e-06, 1.8e-06, 4.4e-06,
                     3.5e-05, 8.6e-06),
        nerf_dynamic=(0.00022, 9.5e-08, 4.1e-07, 7.2e-07, 1.6e-06, 6.6e-06,
                      3.1e-05, 8.9e-05, 0.00048, 0.0023, 7.7e-06, 3.4e-06,
                      8.1e-06, 4e-05, 5.4e-05)),
}


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def _run(setup, step):
    """zest_tpu's 16-bit loss, logs and gradients at ``step`` (port
    layout) and the port's, at 16 and 32 bits; computed once per module."""
    if step in setup["cache"]:
        return setup["cache"][step]
    phase = PHASES[step]
    jphase = JPhase(*phase)
    jsys, jbatch = JZestSystem(JZestConfig(**CFG)), setup["jbatch"]
    rng = jax.random.fold_in(KEY, step)

    def loss_fn(p):
        ret, rays, aux = jsys.forward_train(p, jbatch, rng, jphase,
                                            jnp.asarray(step))
        return jsys.compute_losses(ret, rays, jbatch, jnp.asarray(step),
                                   jphase, aux["chain_bwd"])

    (jloss, jlogs), jgrads = jax.jit(jax.value_and_grad(loss_fn,
                                                        has_aux=True))(
        setup["params"])
    batch = to_batch(setup["sample"], "cpu")
    draws = jax_draws(JZestConfig(**CFG), KEY, step, phase, 32, 64,
                      int(setup["sample"]["motion_count"]))
    tparams = from_jax_params(setup["params"])
    system = ZestSystem(ZestConfig(**CFG))
    loss, logs, grads = system.loss_and_grads(tparams, batch, draws, phase,
                                              step)
    opt = system.make_optimizer(presets.STEPS_PER_EPOCH)
    state, logs2 = system.make_train_step(opt)(
        TrainState(tparams, opt.init(tparams), step), batch, draws, phase)
    loss32, _, _ = ZestSystem(ZestConfig(**presets.SMALL_TRAIN)).loss_and_grads(
        tparams, batch, draws, phase, step)
    out = dict(jloss=float(jloss), jlogs={k: float(v) for k, v in jlogs.items()},
               jgrads=from_jax_params(jax.tree.map(np.asarray, jgrads)),
               loss=float(loss), logs={k: float(v) for k, v in logs.items()},
               logs2={k: float(v) for k, v in logs2.items()}, grads=grads,
               loss32=float(loss32), params=tparams, new=state.params)
    setup["cache"][step] = out
    return out


@pytest.mark.parametrize("step", sorted(PHASES))
def test_p16_step_loss_and_logs_match(setup, step):
    r = _run(setup, step)
    spread = SPREAD[step]["logs"]
    assert set(r["logs"]) == set(r["jlogs"]) == set(spread) - {"loss"}
    for k, a, b in [("loss", r["loss"], r["jloss"])] + [
            (k, r["logs"][k], v) for k, v in r["jlogs"].items()]:
        assert np.isfinite(a) and abs(a - b) <= 2 * spread[k] + LOG_RTOL * abs(b), \
            (k, a, b, spread[k])
    for k, v in r["logs"].items():
        assert r["logs2"][k] == v, k
    assert r["loss"] != r["loss32"]
    assert any(bool((r["new"][k] != v).any()) for k, v in r["params"].items())


@pytest.mark.parametrize("step", sorted(PHASES))
def test_p16_step_grads_match(setup, step):
    r = _run(setup, step)
    assert set(r["grads"]) == set(r["jgrads"])
    scale = {}
    for k, jg in r["jgrads"].items():
        m = k.split(".")[0]
        scale[m] = max(scale.get(m, 0.0), float(np.abs(jg).max()))
    spread = SPREAD[step]
    layer_spread = {f"{m}.{name}": s for m, names in LAYERS.items()
                    for name, s in zip(names, spread[m], strict=True)}
    for k, jg in r["jgrads"].items():
        m = k.split(".")[0]
        err = float(np.abs(r["grads"][k].numpy() - jg.numpy()).max())
        if m.startswith("enc_"):
            limit = 2 * spread["modules"][m] + MODULE_FLOOR * scale[m]
        else:
            limit = 2 * layer_spread[k.rsplit(".", 1)[0]] + MODULE_FLOOR * scale[m]
        assert err <= limit, (k, err, limit)
    for k in ("nerf_static.pts_bias.weight", "nerf_dynamic.sf_linear.weight",
              "enc_static.feature.conv0.0.conv.weight",
              "enc_dy.cost_reg_2.conv0.conv.weight"):
        assert float(r["grads"][k].abs().max()) > 0.0, k
