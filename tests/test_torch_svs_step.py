"""One whole adversarial (SVS) training step of zest_tpu_torch against
zest_tpu's on the CPU, at ``presets.SMALL_SVS``: MVSNeRF's generator at
test size (3 source views, 32x64, width 64, 16 samples), GRAF's patch of
32x32 rays and its discriminator at imsize 32, the least-squares GAN loss,
depth smoothness, distortion and the LPIPS perceptual loss (a seeded
random ``.npz``), at step 0. ``test_torch_svs_step_nlayers.py`` holds
the PatchGAN variant with this file's helpers.

Both packages start from the same weights: the port's seeded generator
(``presets.seeded_params``) carried into zest_tpu's tree
(``test_torch_ablation_mvsnerf.jax_params_of``), and zest_tpu's
discriminators (``init`` of its Flax modules) carried into the port by
``convert.from_jax_disc_params``, the spectral ``u``s with them. The draws
are zest_tpu's: its step folds the step into the key and splits off the
forward's key, which splits into the pixel, depth and noise keys; GRAF's
five numbers go through the port's ``sampling.sample_pixels_graf``.

Each package's step runs with optimizers that hand back the gradients as
their state (``_jcapture``, ``Capture``), so the step's gradients are read
whole; the parameters after the step are each package's own Adam (the
generator's with its clip, the discriminators' without) applied to them.

Tolerances:
- every log: rtol 1e-4;
- generator gradients: every field leaf within 1e-4 of its own largest and
  of its field's, encoder leaves within 2e-3 of their module's largest and
  1e-2 of their own (zest_tpu's one-pass BatchNorm variance), as
  ``test_torch_ablation_mvsnerf.check_grads`` holds them, with one stated
  exception: the field leaves in ``JIT_EAGER`` are held to twice
  zest_tpu's own spread between its jitted and its eager evaluation of
  the same step (``jit_eager_spread``, rounded up; at most 2e-3 of the
  leaf's largest). There the trunk reads the positional encoding, whose
  sin(2^9 x) turns NDC rounding into input differences, and a patch's
  1,024 adjacent rays (32 in the MVSNeRF step of
  ``test_torch_ablation_mvsnerf.py``) meet more of them: the jitted step
  is 3.5e-4 of pts_bias's largest gradient from its own eager evaluation,
  and the port 4.8e-6 (measured leaf by leaf: within 1.1e-5 of the eager
  step on every leaf, encoders included). The parameters after the step
  as ``check_updated`` holds them;
- discriminator gradients within 1e-4 of each leaf's largest (they read
  the generator's outputs, which agree to ~1e-6), plus, with the naive GAN
  loss, its conditioning: the loss's gradient with respect to an output p
  is 1/p (or 1/(1 - p)), so a difference of 1e-6 in an output near the
  clip at 1e-7 moves the whole gradient by 1e-6 / min(p, 1 - p) of itself
  (``system_gan.adversarial_conditioning``; the PatchGAN case has one real
  output at ~2.6e-4, and both packages' gradients on the same inputs
  differ by 3.8e-4 of every leaf's largest); the discriminators'
  parameters after the step within 1e-6 where the gradient is clearly
  signed (``check_updated``'s rule), and the spectral ``u``s after the
  step at rtol 1e-5, atol 1e-6: ``u`` reads only the kernels, and it
  advances twice per step (the fake patch's call, then the real one's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zest_tpu.config import ZestConfig as JZestConfig
from zest_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from zest_tpu.system import Phase as JPhase
from zest_tpu.system import ZestSystem as JZestSystem
from zest_tpu.system_gan import GanSystem as JGanSystem
from zest_tpu.system_gan import GanTrainState as JGanTrainState
from test_torch_ablation_mvsnerf import (_few_threads,  # noqa: F401
                                         check_updated, jax_params_of)
from test_torch_train_step import KEY

from zest_tpu_torch import ZestConfig, presets, sampling
from zest_tpu_torch.convert import from_jax_disc_params, from_jax_params
from zest_tpu_torch.models.lpips import make_random_lpips_npz
from zest_tpu_torch.system import ZestSystem, phase_for_step, to_batch
from zest_tpu_torch.system_gan import (GanSystem, GanTrainState,
                                      adversarial_conditioning, apply_disc)

LOG_RTOL = 1e-4
DISC_GRAD_RTOL = 1e-4
FIELD_RTOL = 1e-4
FIELD_CAP = 2e-3
# jit_eager_spread(GanCase(presets.SMALL_SVS, ...)) at step 0, of each
# leaf's own largest gradient, rounded up; the field leaves above half
# FIELD_RTOL
JIT_EAGER = {"nerf_static.pts_bias.bias": 3.8e-4,
             "nerf_static.pts_bias.weight": 3.5e-4,
             "nerf_static.pts_linears.5.bias": 1.6e-4,
             "nerf_static.pts_linears.5.weight": 1.5e-4,
             "nerf_static.pts_linears.0.bias": 7.7e-5,
             "nerf_static.pts_linears.1.bias": 5.1e-5,
             "nerf_static.pts_linears.1.weight": 5.1e-5}


def _jcapture():
    """An optax transformation whose state after an update is the
    gradient it was given, and whose updates are zero."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


class Capture:
    """The port's counterpart: parameters unchanged, the gradient as the
    new state."""

    def init(self, params):
        return {}

    def update(self, grads, opt_state, params):
        return params, grads


def jax_draws(cfg, step, H, W):
    """zest_tpu's draws of GAN step ``step`` from KEY, as ``sampling.Draws``:
    the pixels (GRAF's through the port's sampler on zest_tpu's five
    numbers, or square patches), the depth jitter, the static noise."""
    k_fwd = jax.random.split(jax.random.fold_in(KEY, step), 3)[0]
    k_pix, _, k_depth, k_render = jax.random.split(k_fwd, 4)
    P = cfg["patch_size"]
    if cfg["gan_type"] == "graf":
        k = jax.random.split(k_pix, 5)
        nums = [jax.random.uniform(k[0], ()), jax.random.uniform(k[1], ()),
                jax.random.uniform(k[2], ()), jax.random.randint(k[3], (), 0, 2),
                jax.random.randint(k[4], (), 0, 2)]
        xs, ys = sampling.sample_pixels_graf(
            torch.tensor([float(v) for v in nums]), H, W, P, step,
            cfg.get("scale_anneal", 0.0025))
    else:
        n = cfg["batch_size"] // (P * P)
        kx, ky = jax.random.split(k_pix)
        xs, ys = sampling.sample_pixels_patches(
            torch.tensor(np.asarray(jax.random.randint(kx, (n,), 0, W - P))),
            torch.tensor(np.asarray(jax.random.randint(ky, (n,), 0, H - P))), P)
    shape = (xs.shape[0], cfg["N_samples"])
    jitter = torch.tensor(np.asarray(jax.random.uniform(k_depth, shape)))
    noise = torch.tensor(np.asarray(jax.random.normal(
        jax.random.split(k_render, 5)[0], shape)))
    return sampling.Draws(xs, ys, None, jitter, noise)


class GanCase:
    """One GAN preset in both packages: the sample, the weights, the
    systems and zest_tpu's jitted step (one compile for every step)."""

    def __init__(self, config, scene, lpips_path):
        config = dict(config, lpips_weights=str(lpips_path))
        self.config, self.scene = config, scene
        self.jcfg = JZestConfig(**config)
        sample = JSyntheticDataset(**scene, use_mvs=True, use_mvs_dy=False)[
            presets.TARGET_FRAME]
        self.jbatch = {k: jnp.asarray(v) for k, v in sample.items()}
        self.batch = to_batch(presets.scene_of(config, scene)[
            presets.TARGET_FRAME], "cpu")
        self.jgan = JGanSystem(JZestSystem(self.jcfg))
        self.gan = GanSystem(ZestSystem(ZestConfig(**config)))
        tparams = presets.seeded_params(self.gan.system)
        self.jparams = jax_params_of(self.jgan.system, self.jbatch, tparams)
        self.tparams = from_jax_params(self.jparams)
        P = self.jcfg.patch_size
        variables = jax.jit(self.jgan.disc.init)(
            jax.random.PRNGKey(2), jnp.zeros((1, P * P, 3)))
        self.jdisc = variables["params"]
        self.jvars = {k: v for k, v in variables.items() if k != "params"}
        self.jdepth = {}
        if self.jgan.depth_disc is not None:
            self.jdepth = jax.jit(self.jgan.depth_disc.init)(
                jax.random.PRNGKey(3), jnp.zeros((1, P * P, 1)))["params"]
        self.tdisc, self.tvars = from_jax_disc_params(self.jdisc, self.jvars)
        self.tdepth = from_jax_disc_params(self.jdepth)[0]
        cap = _jcapture()
        self.jstep = self.jgan.make_train_step(cap, cap)
        self.cache = {}

    def step(self, step):
        """Both packages' logs, gradients, new spectral state and updated
        parameters at ``step`` (port layout)."""
        if step in self.cache:
            return self.cache[step]
        cap = _jcapture()
        jstate = JGanTrainState(
            params=self.jparams, disc_params=self.jdisc,
            depth_disc_params=self.jdepth, opt_state=cap.init(self.jparams),
            disc_opt_state=cap.init(self.jdisc),
            depth_disc_opt_state=cap.init(self.jdepth) if self.jdepth else {},
            disc_vars=self.jvars, step=jnp.asarray(step))
        phase = phase_for_step(self.gan.cfg, step)
        jnew, jlogs = self.jstep(jstate, self.jbatch, KEY, JPhase(*phase))
        H, W = self.batch["images"].shape[1:3]
        draws = jax_draws(self.config, step, H, W)
        state = GanTrainState(self.tparams, self.tdisc, self.tdepth, {}, {},
                              {}, self.tvars, step)
        new, logs = self.gan.make_train_step(Capture(), Capture())(
            state, self.batch, draws, phase)

        def np_tree(t):
            return jax.tree.map(np.asarray, t)
        jgrads = from_jax_params(np_tree(jnew.opt_state))
        out = dict(jlogs={k: float(v) for k, v in jlogs.items()},
                   logs={k: float(v) for k, v in logs.items()},
                   jgrads=jgrads, grads=new.opt_state, params=self.tparams,
                   jdisc_grads=from_jax_disc_params(
                       np_tree(jnew.disc_opt_state))[0],
                   disc_grads=new.disc_opt_state,
                   jvars=from_jax_disc_params(self.jdisc,
                                              np_tree(jnew.disc_vars))[1],
                   vars=new.disc_vars, draws=draws)
        if self.jdepth:
            out["jdepth_grads"] = from_jax_disc_params(
                np_tree(jnew.depth_disc_opt_state))[0]
            out["depth_grads"] = new.depth_disc_opt_state
        # each package's own optimizers on its own gradients
        jopt = self.jgan.system.make_optimizer(presets.STEPS_PER_EPOCH)
        jd_opt = self.jgan.make_disc_optimizer(presets.STEPS_PER_EPOCH)
        upd = jax.jit(lambda opt, g, p: optax.apply_updates(
            p, opt.update(g, opt.init(p), p)[0]), static_argnums=0)
        out["jnew"] = from_jax_params(np_tree(upd(jopt, jnew.opt_state,
                                                  self.jparams)))
        out["jnew_disc"] = from_jax_disc_params(np_tree(upd(
            jd_opt, jnew.disc_opt_state, self.jdisc)))[0]
        opt = self.gan.system.make_optimizer(presets.STEPS_PER_EPOCH)
        d_opt = self.gan.make_disc_optimizer(presets.STEPS_PER_EPOCH)
        with torch.no_grad():
            out["new"] = opt.update(out["grads"], opt.init(self.tparams),
                                    self.tparams)[0]
            out["new_disc"] = d_opt.update(out["disc_grads"],
                                           d_opt.init(self.tdisc),
                                           self.tdisc)[0]
        out["cond"] = {"disc": 0.0, "depth": 0.0}
        if self.jcfg.gan_loss == "naive":
            outs = self.gan.generator_update(state, self.batch, draws, phase,
                                             Capture())[3]
            ppx = self.jcfg.patch_size ** 2
            cfg = self.gan.cfg
            out["cond"] = {
                "disc": _naive_conditioning(
                    cfg, self.gan.disc, self.tdisc, self.tvars, outs[0],
                    outs[1], ppx, cfg.getIntermFeat),
                "depth": _naive_conditioning(
                    cfg, self.gan.depth_disc, self.tdepth, {}, outs[2],
                    outs[3], ppx) if self.jdepth else 0.0}
        self.cache[step] = out
        return out


def _naive_conditioning(cfg, disc, params, spectral, fake, real, ppx,
                        interm=False):
    """``adversarial_conditioning`` of the discriminator's outputs on the
    fake and the real patches (``ppx`` rays each)."""
    preds = []
    for x in (fake, real):
        with torch.no_grad():
            out, _ = apply_disc(disc, params, spectral,
                                x.reshape(-1, ppx, fake.shape[-1]))
        preds.append(out[-1] if interm else out)
    return adversarial_conditioning(cfg, preds)


def check_logs(r, keys):
    # a jitted step's dict comes back sorted by key
    assert list(r["logs"]) == keys and set(r["jlogs"]) == set(keys)
    for k, v in r["jlogs"].items():
        assert np.isfinite(r["logs"][k]), k
        np.testing.assert_allclose(r["logs"][k], v, rtol=LOG_RTOL, err_msg=k)


def check_gen_grads(r, spread: dict):
    """The generator's gradients against zest_tpu's jitted step: field
    leaves within FIELD_RTOL of their own and their field's largest, or
    the leaves in ``spread`` within twice zest_tpu's own jit-vs-eager
    spread there (at most FIELD_CAP); encoder leaves as ``check_grads``
    holds them. Every module learns something."""
    assert set(r["grads"]) == set(r["jgrads"])
    module_scale = {}
    for k, g in r["jgrads"].items():
        m = k.split(".")[0]
        module_scale[m] = max(module_scale.get(m, 0.0), float(g.abs().max()))
    for k, jg in r["jgrads"].items():
        m = k.split(".")[0]
        err = float((r["grads"][k] - jg).abs().max())
        own = float(jg.abs().max())
        if m.startswith("enc_"):
            assert err <= 2e-3 * module_scale[m], (k, err, module_scale[m])
            assert err <= 1e-2 * own, (k, err, own)
            continue
        rtol = min(max(FIELD_RTOL, 2 * spread.get(k, 0.0)), FIELD_CAP)
        assert err <= rtol * own, (k, err, own, rtol)
        assert err <= rtol * module_scale[m], (k, err)
    scale = {}
    for k, g in r["grads"].items():
        m = k.split(".")[0]
        scale[m] = max(scale.get(m, 0.0), float(g.abs().max()))
    assert all(v > 0.0 for v in scale.values()), scale


def check_disc(r, params):
    """The discriminators' gradients, parameters after the step and
    spectral state against zest_tpu's."""
    pairs = [(r["disc_grads"], r["jdisc_grads"], r["cond"]["disc"])]
    if "jdepth_grads" in r:
        pairs.append((r["depth_grads"], r["jdepth_grads"], r["cond"]["depth"]))
    for got, ref, cond in pairs:
        assert set(got) == set(ref)
        for k, g in ref.items():
            err = float((got[k] - g).abs().max())
            assert err <= (DISC_GRAD_RTOL + cond) * float(g.abs().max()), \
                (k, err, cond)
    check_updated(dict(jnew=r["jnew_disc"], jgrads=r["jdisc_grads"],
                       grads=r["disc_grads"], new=r["new_disc"],
                       params=params))
    assert set(r["vars"]) == set(r["jvars"])
    for k, v in r["jvars"].items():
        np.testing.assert_allclose(r["vars"][k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def svs(tmp_path_factory):
    path = tmp_path_factory.mktemp("lpips") / "lpips.npz"
    make_random_lpips_npz(path, seed=0)
    return GanCase(presets.SMALL_SVS, presets.SMALL_SCENE, path)


GRAF_LOGS = ["G_fake_loss", "G_rec_loss", "G_loss", "D_loss", "D_fake_loss",
             "D_real_loss", "train_loss", "train_PSNR"]


def test_graf_gan_step_matches_zest_tpu(svs):
    r = svs.step(0)
    assert r["draws"].xs.shape == (32 * 32,)
    check_logs(r, GRAF_LOGS)
    check_gen_grads(r, JIT_EAGER)
    check_updated(r)
    check_disc(r, svs.tdisc)


def test_spectral_u_advances_twice_per_step(svs):
    """The step's u is two power iterations from the state's (the fake
    patch's call, then the real patch's), and not one."""
    r = svs.step(0)
    for k, u0 in svs.tvars.items():
        w = svs.tdisc[k.rsplit(".", 1)[0] + ".weight"]
        u1 = _power(w, u0)
        torch.testing.assert_close(r["vars"][k], _power(w, u1), rtol=1e-5,
                                   atol=1e-6)
        if k != "convs.3.u":         # one output: the first iteration is exact
            assert float((r["vars"][k] - u1).abs().max()) > 1e-4, k


def _power(w, u):
    """One power iteration of SpectralConv's on the kernel w (OIHW)."""
    w_mat = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])
    v = w_mat @ u
    v = v / (torch.linalg.vector_norm(v) + 1e-12)
    u = w_mat.T @ v
    return u / (torch.linalg.vector_norm(u) + 1e-12)


def test_perceptual_loss_refuses_without_weights():
    cfg = ZestConfig(**presets.SMALL_SVS)
    with pytest.raises(RuntimeError, match="lpips_weights"):
        GanSystem(ZestSystem(cfg))


def jit_eager_spread(case: GanCase, step: int = 0) -> dict:
    """zest_tpu's own spread at ``step``: each generator gradient leaf's
    largest difference between its jitted step and the same step run
    eagerly (``jax.disable_jit``), over the leaf's largest gradient. Takes
    minutes (the eager step runs the Pallas kernels in interpret mode op by
    op), so the tables above hold its output, rounded up:
    ``python tests/test_torch_svs_step.py [nlayers]``."""
    jit = case.step(step)["jgrads"]
    case.cache.pop(step)
    with jax.disable_jit():
        eager = case.step(step)["jgrads"]
    case.cache.pop(step)
    return {k: float((eager[k] - g).abs().max() / g.abs().max())
            for k, g in jit.items()}


if __name__ == "__main__":
    import sys
    import tempfile
    jax.config.update("jax_default_matmul_precision", "float32")
    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as tmp:
        make_random_lpips_npz(f"{tmp}/lpips.npz", seed=0)
        if sys.argv[1:] == ["nlayers"]:
            from test_torch_svs_step_nlayers import NLAYERS, NLAYERS_SCENE
            case = GanCase(NLAYERS, NLAYERS_SCENE, f"{tmp}/lpips.npz")
        else:
            case = GanCase(presets.SMALL_SVS, presets.SMALL_SCENE,
                           f"{tmp}/lpips.npz")
        spread = jit_eager_spread(case)
        r = case.step(0)
        for k, v in sorted(spread.items(), key=lambda kv: -kv[1]):
            g = r["jgrads"][k]
            port = float((r["grads"][k] - g).abs().max() / g.abs().max())
            print(f"{k}: jit-eager {v:.2e}, port-jit {port:.2e}")
