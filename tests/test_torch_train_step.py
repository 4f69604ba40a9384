"""The whole training step of zest_tpu_torch against zest_tpu's on the CPU, at
``presets.SMALL_TRAIN`` (the flagship topology at test size: 3 keyframes,
32x64 images, depth-8 fields of width 64, 16 samples, 24 + 8 rays, density
noise 1.0, the chain loss), in both phases of a step:

- step 0: the motion-mask extra rays, the t-2 chain points, no chain pass;
- step 2001: no extra rays, the t+2 chain points and the chain pass, the
  late photometric loss and the priors decayed a hundredfold.

Both packages start from the same weights (``convert.from_jax_params``, both
fields' alpha bias raised by 1 so the renders carry signal) and the same
random numbers: the draws are made from a JAX key as ``forward_train`` and
``render_rays`` split it, and handed to the port as ``sampling.Draws``. The
JAX step runs its Pallas kernels in interpret mode.

Tolerances:
- the loss and every log: rtol 1e-4 (float32 sums over 32 x 16 points in
  another order on each side);
- every field gradient leaf: 1e-4 of the leaf's own largest gradient (and
  of its field's largest), with one stated exception. At step 0 the
  dynamic field's trunk (layers 0-6, which read the positional encoding
  directly or through the skip layer 5) is held to twice zest_tpu's own
  spread on each layer (``JIT_EAGER_STEP0``), at most 2e-3 of the leaf's
  own largest: zest_tpu's jitted and its eager evaluation of the
  same step differ there by 1.1e-4 to 1.5e-3 of each leaf's largest
  gradient, because sin(2^9 x) of the encoding turns NDC rounding into
  input differences of 1e-4. The reference here is the jitted step; against
  the eager one the port matches every one of these leaves to 7.2e-6. At
  step 2001 every field leaf is within 3.3e-5 of the jitted step;
- every encoder gradient leaf: 2e-3 of its module's largest gradient and
  1e-2 of its own. They differ by up to 9e-3 of gradients of 1e-6:
  zest_tpu's BatchNorm takes the variance in one pass as E[x^2] - E[x]^2,
  which cancels in float32 (the port in float32 agrees with itself in
  float64 to 7e-6 there);
- the parameters after the step: Adam moves each one by about the learning
  rate whatever its gradient, so a gradient near zero whose sign differs
  between the packages moves it the other way. They are compared to 1e-6
  (a fiftieth of the first step's move) where |g| is above 1e-5, a thousand
  times Adam's epsilon (the first move is lr * g / (|g| + 1e-8), whose
  slope lr * 1e-8 / g^2 turns g's differences into move differences near
  it), and above ten times the leaf's largest gradient difference between
  the packages, so that g has one sign in both.

The dynamic field's flow head is scaled by 0.1 in both packages: the flow
then warps points by at most about 0.1 in NDC, away from the depth clamp at
0.99 of the least-kinetic-energy term, whose Euclidean depth 2 / (z - 1)
has a curvature of up to 4e6 there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zest_tpu import sampling as jsampling
from zest_tpu.config import ZestConfig as JZestConfig
from zest_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from zest_tpu.system import Phase as JPhase
from zest_tpu.system import ZestSystem as JZestSystem

from zest_tpu_torch import ZestConfig, presets, sampling
from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.system import Phase, TrainState, ZestSystem, to_batch

CFG = presets.SMALL_TRAIN
KEY = jax.random.PRNGKey(1)
PHASES = {0: Phase(extra_samples=True, chain_5frames=False),
          2001: Phase(extra_samples=False, chain_5frames=True)}
LOG_RTOL = 1e-4
FIELD_RTOL = 1e-4
FIELD_STEP0_CAP = 2e-3
# zest_tpu's spread between its jitted and its eager evaluation of step 0,
# of each leaf's own largest gradient (the larger of a layer's weight and
# bias), on the dynamic trunk
JIT_EAGER_STEP0 = {f"nerf_dynamic.pts_linears.{i}": s for i, s in enumerate(
    (1.5e-4, 2.8e-4, 3.3e-4, 1.9e-4, 5.0e-4, 1.5e-3, 1.1e-4))}


def jax_draws(cfg, key, step, phase, H, W, motion_count):
    """The draws of zest_tpu's training step ``step`` from ``key``, split as
    ``train_step`` (fold_in), ``forward_train`` and ``render_rays`` split it,
    as a ``sampling.Draws``."""
    rng = jax.random.fold_in(key, step)
    k_pix, k_extra, k_depth, k_render = jax.random.split(rng, 4)
    xs, ys = jsampling.sample_pixels_random(k_pix, H, W, cfg.batch_size)
    motion_idx, n = None, cfg.batch_size
    if phase.extra_samples:
        motion_idx = jax.random.randint(k_extra, (cfg.num_extra_samples,), 0,
                                        max(motion_count, 1))
        n += cfg.num_extra_samples
    shape = (n, cfg.N_samples)
    jitter = jax.random.uniform(k_depth, shape)
    noise = [jax.random.normal(k, shape) for k in jax.random.split(k_render, 5)]
    return sampling.Draws(*(None if a is None else torch.from_numpy(np.asarray(a))
                            for a in (xs, ys, motion_idx, jitter, *noise)))


def make_setup():
    """Both packages' inputs: the scene's sample and zest_tpu's weights."""
    sample = JSyntheticDataset(**presets.SMALL_SCENE)[presets.TARGET_FRAME]
    jbatch = {k: jnp.asarray(v) for k, v in sample.items()}
    jcfg = JZestConfig(**CFG)
    jsys = JZestSystem(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(jsys.init_params)(
        jax.random.PRNGKey(0), jbatch))
    for field in ("nerf_static", "nerf_dynamic"):
        alpha = params[field]["params"]["alpha_linear"]
        alpha["bias"] = alpha["bias"] + 1.0
    sf = params["nerf_dynamic"]["params"]["sf_linear"]
    sf["kernel"], sf["bias"] = sf["kernel"] * 0.1, sf["bias"] * 0.1
    return dict(sample=sample, jbatch=jbatch, jsys=jsys, params=params,
                cache={})


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def _run(setup, step):
    """Both packages' loss, logs, gradients and updated parameters at
    ``step`` (port layout), computed once per module."""
    if step in setup["cache"]:
        return setup["cache"][step]
    jsys, params, jbatch = setup["jsys"], setup["params"], setup["jbatch"]
    phase = PHASES[step]
    jphase = JPhase(*phase)
    rng = jax.random.fold_in(KEY, step)

    def loss_fn(p):
        ret, rays, aux = jsys.forward_train(p, jbatch, rng, jphase,
                                            jnp.asarray(step))
        return jsys.compute_losses(ret, rays, jbatch, jnp.asarray(step),
                                   jphase, aux["chain_bwd"])

    (jloss, jlogs), jgrads = jax.jit(jax.value_and_grad(loss_fn,
                                                        has_aux=True))(params)
    jopt = jsys.make_optimizer(presets.STEPS_PER_EPOCH)
    updates, _ = jopt.update(jgrads, jopt.init(params), params)
    jnew = optax.apply_updates(params, updates)

    system = ZestSystem(ZestConfig(**CFG))
    batch = to_batch(setup["sample"], "cpu")
    H, W = batch["images"].shape[1:3]
    draws = jax_draws(JZestConfig(**CFG), KEY, step, phase, H, W,
                      int(setup["sample"]["motion_count"]))
    tparams = from_jax_params(params)
    loss, logs, grads = system.loss_and_grads(tparams, batch, draws, phase,
                                              step)
    opt = system.make_optimizer(presets.STEPS_PER_EPOCH)
    state, logs2 = system.make_train_step(opt)(
        TrainState(tparams, opt.init(tparams), step), batch, draws, phase)
    out = dict(jloss=float(jloss), jlogs={k: float(v) for k, v in jlogs.items()},
               jgrads=from_jax_params(jax.tree.map(np.asarray, jgrads)),
               jnew=from_jax_params(jax.tree.map(np.asarray, jnew)),
               loss=float(loss), logs={k: float(v) for k, v in logs.items()},
               logs2={k: float(v) for k, v in logs2.items()}, grads=grads,
               new=state.params, params=tparams)
    setup["cache"][step] = out
    return out


@pytest.mark.parametrize("step", sorted(PHASES))
def test_train_step_loss_and_logs_match(setup, step):
    r = _run(setup, step)
    assert set(r["logs"]) == set(r["jlogs"])
    np.testing.assert_allclose(r["loss"], r["jloss"], rtol=LOG_RTOL)
    for k, v in r["jlogs"].items():
        np.testing.assert_allclose(r["logs"][k], v, rtol=LOG_RTOL, err_msg=k)
        assert r["logs2"][k] == r["logs"][k], k
    assert np.isfinite(r["loss"])


@pytest.mark.parametrize("step", sorted(PHASES))
def test_train_step_grads_match(setup, step):
    r = _run(setup, step)
    assert set(r["grads"]) == set(r["jgrads"])
    module_scale = {}
    for k, jg in r["jgrads"].items():
        m = k.split(".")[0]
        module_scale[m] = max(module_scale.get(m, 0.0), float(np.abs(jg).max()))
    for k, jg in r["jgrads"].items():
        g, jg = r["grads"][k].numpy(), jg.numpy()
        m = k.split(".")[0]
        err = float(np.abs(g - jg).max())
        own = float(np.abs(jg).max())
        if m.startswith("enc_"):
            assert err <= 2e-3 * module_scale[m], (k, err, module_scale[m])
            assert err <= 1e-2 * own, (k, err, own)
        else:
            spread = JIT_EAGER_STEP0.get(k.rsplit(".", 1)[0], 0.0) if step == 0 else 0.0
            assert err <= FIELD_RTOL * module_scale[m], (k, err, module_scale[m])
            assert err <= min(FIELD_STEP0_CAP, max(FIELD_RTOL, 2 * spread)) * own, \
                (k, err, own)
    # every field layer and the encoders' first convolutions learn something
    for k in ("nerf_static.pts_bias.weight", "nerf_dynamic.sf_linear.weight",
              "enc_static.feature.conv0.0.conv.weight",
              "enc_dy.cost_reg_2.conv0.conv.weight"):
        assert float(r["grads"][k].abs().max()) > 0.0, k


@pytest.mark.parametrize("step", sorted(PHASES))
def test_train_step_updated_params_match(setup, step):
    r = _run(setup, step)
    moved = 0
    for k, jnew in r["jnew"].items():
        g = r["jgrads"][k].numpy()
        g_err = float(np.abs(r["grads"][k].numpy() - g).max())
        big = (np.abs(g) > 10 * g_err) & (np.abs(g) > 1e-5)
        new = r["new"][k].numpy()
        np.testing.assert_allclose(new[big], jnew.numpy()[big], rtol=0,
                                   atol=1e-6, err_msg=k)
        moved += int(np.sum(new != r["params"][k].numpy()))
    assert moved > 0
