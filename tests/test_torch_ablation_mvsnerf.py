"""MVSNeRF's static field (``presets.SMALL_MVSNERF``: no scene flow, one
4-output field on the static volume of 3 source views, 32x64, width 64, 16
samples, 32 rays, density noise 1.0) in zest_tpu_torch against zest_tpu's
on the CPU; and the helpers the other ``test_torch_ablation_*`` files hold
their presets with.

Both packages start from the same weights (``convert.from_jax_params``,
every field's alpha bias raised by 1 so the renders carry signal, the
dynamic field's flow head scaled by 0.1 as ``test_torch_train_step.py``
does) and the same numpy sample of the synthetic scene with the views the
preset's volumes read; the training step's draws are made from a JAX key
as zest_tpu splits it (``test_torch_train_step.jax_draws``). zest_tpu runs
its Pallas kernels in interpret mode.

Tolerances (those of ``test_torch_eval_slice.py``,
``test_torch_train_step.py``, ``test_torch_paths.py`` and
``test_torch_train_loop.py``):
- eval maps and the wander path's maps: rtol 1e-4, atol 1e-5;
- ``validate``: the same metric keys, val_loss rtol 1e-4, val_PSNR 1e-3 dB,
  val_SSIM 1e-4;
- the loss and every log: rtol 1e-4;
- every field gradient leaf within 1e-4 of its own largest (and of its
  field's); every encoder leaf within 2e-3 of its module's largest and 1e-2
  of its own (zest_tpu's one-pass BatchNorm variance). zest_tpu's jitted
  step can differ from its own eager evaluation by more than that on a
  trunk fed the positional encoding (sin(2^9 x) turns NDC rounding into
  input differences; MVSNeRF's at step 2001's draws: 1.0e-3 of
  pts_linears.1's largest, where the port is 2.0e-6 from the eager one);
  at the steps held here, with these weights, no field leaf is;
- the parameters after the step: 1e-6 where the gradient is clearly
  signed;
- at precision 16 (``SMALL_MVSNERF_16``) within twice zest_tpu's own
  difference between its 16- and 32-bit result, computed here, plus a
  floor: eval maps 1e-5; the loss and each log one bf16 rounding of its
  value (2^-9 of it: the two packages round at other places, and a log's
  own 16-vs-32 difference in zest_tpu can be a tenth of the port's, e.g.
  sf_sp_loss of the dynamic-volume ablation, 8.5e-7 against 5.2e-6, where
  the port is 6.1e-6 from zest_tpu); gradient leaves twice the spread of
  the leaf's layer, or of its encoder's largest leaf, plus 1e-3 of its
  module's largest gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zest_tpu import train_loop as jloop
from zest_tpu.config import ZestConfig as JZestConfig
from zest_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from zest_tpu.system import Phase as JPhase
from zest_tpu.system import ZestSystem as JZestSystem
from test_torch_train_step import KEY, jax_draws

from zest_tpu_torch import ZestConfig, presets, train_loop
from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.system import TrainState, ZestSystem, phase_for_step, to_batch

RTOL, ATOL = 1e-4, 1e-5
FIELD_RTOL = 1e-4
MODULE_FLOOR = 1e-3
# a 16-bit log's floor: one bf16 rounding of its value (2^-9)
LOG16_FLOOR = 2.0 ** -9
POSES = (15, 45)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def jax_params_of(jsys, jbatch, tparams):
    """zest_tpu's parameter tree holding the port's state dict ``tparams``:
    ``convert.from_jax_params`` run on a tree of element numbers (its
    shapes from ``jax.eval_shape(init_params)``, which compiles nothing)
    says where each of the port's elements sits in zest_tpu's tree; the
    elements the port has no counterpart of (the first cost-volume conv's
    inert padding channels) are 0."""
    shapes = jax.eval_shape(jsys.init_params, jax.random.PRNGKey(0), jbatch)
    leaves, treedef = jax.tree.flatten(shapes)
    sizes = [int(np.prod(leaf.shape)) for leaf in leaves]
    starts = np.cumsum([0] + sizes)
    ids = treedef.unflatten([np.arange(a + 1, a + 1 + n).reshape(leaf.shape)
                             for a, n, leaf in zip(starts, sizes, leaves)])
    flat = np.zeros(starts[-1], np.float32)
    for k, where in from_jax_params(ids).items():
        flat[where.numpy().astype(np.int64) - 1] = tparams[k].numpy()
    return treedef.unflatten([flat[a:a + n].reshape(leaf.shape)
                              for a, n, leaf in zip(starts, sizes, leaves)])


def zest_tpu_shapes(config, sample) -> dict:
    """zest_tpu's ``init_params`` for ``config`` on a numpy sample, as the
    port's state-dict names and shapes (``convert.from_jax_params`` on the
    tree of ``jax.eval_shape``, which compiles nothing)."""
    jsys = JZestSystem(JZestConfig(**config))
    shapes = jax.eval_shape(jsys.init_params, jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in sample.items()})
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return {k: tuple(v.shape) for k, v in from_jax_params(tree).items()}


class Family:
    """One small preset in both packages: the sample, the weights (the
    port's ``presets.seeded_params``, the dynamic flow head scaled by 0.1),
    the systems; each result computed once (``cache``). ``samples`` is
    (zest_tpu's sample, the port's), the small synthetic scene's target
    frame by default."""

    def __init__(self, config, params=None, samples=None):
        self.config = config
        self.jcfg = JZestConfig(**config)
        if samples is None:
            samples = (JSyntheticDataset(
                **presets.SMALL_SCENE, use_mvs=self.jcfg.use_mvs,
                use_mvs_dy=self.jcfg.use_mvs_dy)[presets.TARGET_FRAME],
                presets.scene_of(config, presets.SMALL_SCENE)[
                    presets.TARGET_FRAME])
        self.sample, self.psample = samples
        self.jbatch = {k: jnp.asarray(v) for k, v in self.sample.items()}
        self.jsys = JZestSystem(self.jcfg)
        self.system = ZestSystem(ZestConfig(**config))
        if params is None:
            tparams = presets.seeded_params(self.system)
            for k in ("weight", "bias"):
                key = f"nerf_dynamic.sf_linear.{k}"
                if key in tparams:
                    tparams[key] = tparams[key] * 0.1
            params = jax_params_of(self.jsys, self.jbatch, tparams)
        self.params = params
        self.tparams = from_jax_params(params)
        self.batch = to_batch(self.psample, "cpu")
        self.jeval = self.jsys.make_eval_step()
        jopt = self.jsys.make_optimizer(presets.STEPS_PER_EPOCH)
        # one compile for every step, not one per leaf and op
        self.jupdate = jax.jit(lambda g, p: optax.apply_updates(
            p, jopt.update(g, jopt.init(p), p)[0]))
        self.cache = {}

    def eval(self):
        """(zest_tpu's eval maps, the port's), numpy."""
        if "eval" not in self.cache:
            ref = self.jeval(self.params, self.jbatch)
            out = self.system.make_eval_step()(self.tparams, self.batch)
            self.cache["eval"] = ({k: np.asarray(v) for k, v in ref.items()},
                                  {k: v.numpy() for k, v in out.items()})
        return self.cache["eval"]

    def path(self):
        """(zest_tpu's maps, the port's path maps) at the target's camera and
        the orbit poses POSES. zest_tpu's path step renders each pose as
        its eval step does with the pose in the target's slot
        (``_eval_image`` on ``c2ws.at[-1].set(c2w)``), so its maps here are
        the jitted eval step's at each pose: no second compile."""
        s = self.sample
        c2ws = np.stack([s["c2ws"][-1]] + [s["wander_path_c2w"][i]
                                            for i in POSES])
        w2cs = np.stack([s["w2cs"][-1]] + [s["wander_path_w2c"][i]
                                            for i in POSES])
        maps = [self.eval()[0]] + [
            self.jeval(self.params, dict(
                self.jbatch, c2ws=self.jbatch["c2ws"].at[-1].set(c2w),
                w2cs=self.jbatch["w2cs"].at[-1].set(w2c)))
            for c2w, w2c in zip(c2ws[1:], w2cs[1:])]
        out = self.system.make_eval_path_step()(
            self.tparams, self.batch, torch.from_numpy(c2ws),
            torch.from_numpy(w2cs))
        return ({k: np.stack([np.asarray(m[k]) for m in maps])
                 for k in maps[0]},
                {k: v.numpy() for k, v in out.items()})

    def validate(self, tmp_path):
        """(zest_tpu's validation metrics, the port's) on the sample."""
        ref = jloop.validate(self.jcfg, self.jsys, self.jeval, self.params,
                             [self.sample], tmp_path / "ref", 0)
        out = train_loop.validate(self.system.cfg, self.system,
                                  self.system.make_eval_step(), self.tparams,
                                  [self.psample], tmp_path / "port", 0)
        return ref, out

    def step(self, step):
        """Both packages' loss, logs, gradients and updated parameters at
        ``step`` (port layout)."""
        if step in self.cache:
            return self.cache[step]
        cfg = self.system.cfg
        phase = phase_for_step(cfg, step)
        jphase = JPhase(*phase)
        jsys, jbatch = self.jsys, self.jbatch
        rng = jax.random.fold_in(KEY, step)

        def loss_fn(p):
            ret, rays, aux = jsys.forward_train(p, jbatch, rng, jphase,
                                                jnp.asarray(step))
            return jsys.compute_losses(ret, rays, jbatch, jnp.asarray(step),
                                       jphase, aux["chain_bwd"])

        (jloss, jlogs), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(self.params)
        jnew = self.jupdate(jgrads, self.params)
        H, W = self.batch["images"].shape[1:3]
        draws = jax_draws(self.jcfg, KEY, step, phase, H, W,
                          int(self.sample.get("motion_count", 1)))
        tparams = self.tparams
        loss, logs, grads = self.system.loss_and_grads(tparams, self.batch,
                                                       draws, phase, step)
        opt = self.system.make_optimizer(presets.STEPS_PER_EPOCH)
        state, logs2 = self.system.make_train_step(opt)(
            TrainState(tparams, opt.init(tparams), step), self.batch, draws,
            phase)
        out = dict(jloss=float(jloss),
                   jlogs={k: float(v) for k, v in jlogs.items()},
                   jgrads=from_jax_params(jax.tree.map(np.asarray, jgrads)),
                   jnew=from_jax_params(jax.tree.map(np.asarray, jnew)),
                   loss=float(loss),
                   logs={k: float(v) for k, v in logs.items()},
                   logs2={k: float(v) for k, v in logs2.items()},
                   grads=grads, new=state.params, params=tparams)
        self.cache[step] = out
        return out


def check_eval(ref, out, keys, n_poses=None):
    shape = (32, 64) if n_poses is None else (n_poses, 32, 64)
    assert set(out) == set(ref) == set(keys)
    for k in keys:
        assert out[k].shape == ref[k].shape and ref[k].shape[:len(shape)] \
            == shape, k
        np.testing.assert_allclose(out[k], ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert float(np.std(ref["rgb_map"])) > 1e-3


def check_path(ref, out, keys, moves=True):
    """The path's maps as the eval's; when ``moves``, each orbit pose
    renders another image than the target's camera in some map, apart by
    over 10x the tolerance. (A sample without keyframes takes the target's
    own camera as the NDC and static view-direction reference, which moves
    with it: its static maps are the same from every pose in both packages,
    and without neighbours its dynamic ones too.)"""
    check_eval(ref, out, keys, n_poses=1 + len(POSES))
    for p in range(1, 1 + len(POSES) if moves else 1):
        apart = [float(np.abs(ref[k][p] - ref[k][0]).max())
                 / (RTOL * float(np.abs(ref[k]).max()) + ATOL) for k in keys]
        assert max(apart) > 10, (p, apart)


def check_validate(ref, out):
    assert list(out) == list(ref) == ["val_loss", "val_PSNR", "val_SSIM"]
    np.testing.assert_allclose(out["val_loss"], ref["val_loss"], rtol=1e-4)
    assert abs(out["val_PSNR"] - ref["val_PSNR"]) < 1e-3
    assert abs(out["val_SSIM"] - ref["val_SSIM"]) <= 1e-4


def check_logs(r):
    assert set(r["logs"]) == set(r["jlogs"])
    np.testing.assert_allclose(r["loss"], r["jloss"], rtol=RTOL)
    for k, v in r["jlogs"].items():
        np.testing.assert_allclose(r["logs"][k], v, rtol=RTOL, err_msg=k)
        assert r["logs2"][k] == r["logs"][k], k
    assert np.isfinite(r["loss"])


def _scales(grads):
    scale = {}
    for k, g in grads.items():
        m = k.split(".")[0]
        scale[m] = max(scale.get(m, 0.0), float(g.abs().max()))
    return scale


def check_grads(r):
    """Every field leaf within FIELD_RTOL of its field's and of its own
    largest gradient, every encoder leaf within 2e-3 of its module's and
    1e-2 of its own; every module learns something."""
    assert set(r["grads"]) == set(r["jgrads"])
    module_scale = _scales(r["jgrads"])
    for k, jg in r["jgrads"].items():
        m = k.split(".")[0]
        err = float((r["grads"][k] - jg).abs().max())
        own = float(jg.abs().max())
        if m.startswith("enc_"):
            assert err <= 2e-3 * module_scale[m], (k, err, module_scale[m])
            assert err <= 1e-2 * own, (k, err, own)
        else:
            assert err <= FIELD_RTOL * module_scale[m], (k, err)
            assert err <= FIELD_RTOL * own, (k, err, own)
    for m, s in _scales(r["grads"]).items():
        assert s > 0.0, m


def check_updated(r):
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


def check_p16_eval(ref16, out16, ref32, keys):
    for k in keys:
        spread = float(np.abs(ref16[k] - ref32[k]).max())
        err = float(np.abs(out16[k] - ref16[k]).max())
        assert err <= 2 * spread + ATOL, (k, err, spread)


def check_p16_step(r16, r32):
    """r16: the 16-bit Family's step, r32: the 32-bit one's at the same
    weights and draws."""
    assert set(r16["logs"]) == set(r16["jlogs"])
    for k, a, b, b32 in [("loss", r16["loss"], r16["jloss"], r32["jloss"])] + [
            (k, r16["logs"][k], v, r32["jlogs"][k])
            for k, v in r16["jlogs"].items()]:
        assert np.isfinite(a)
        limit = 2 * abs(b - b32) + LOG16_FLOOR * abs(b)
        assert abs(a - b) <= limit, (k, a, b, b32)
    assert r16["loss"] != r32["loss"]        # the 16-bit path is taken
    spread = {k: float((g - r32["jgrads"][k]).abs().max())
              for k, g in r16["jgrads"].items()}
    layer = {}
    for k, s in spread.items():
        key = k.split(".")[0] if k.startswith("enc_") else k.rsplit(".", 1)[0]
        layer[key] = max(layer.get(key, 0.0), s)
    scale = _scales(r16["jgrads"])
    for k, jg in r16["jgrads"].items():
        m = k.split(".")[0]
        key = m if m.startswith("enc_") else k.rsplit(".", 1)[0]
        err = float((r16["grads"][k] - jg).abs().max())
        limit = 2 * layer[key] + MODULE_FLOOR * scale[m]
        assert err <= limit, (k, err, limit)


@pytest.fixture(scope="module")
def mvsnerf():
    return Family(presets.SMALL_MVSNERF)


@pytest.fixture(scope="module")
def mvsnerf16(mvsnerf):
    return Family(presets.SMALL_MVSNERF_16, mvsnerf.params)


def test_mvsnerf_system_is_one_four_output_field(mvsnerf):
    system = mvsnerf.system
    assert [n for n, _ in system.named_children()] == ["nerf_static",
                                                       "enc_static"]
    assert system.nerf_static.out_ch == 4 and system.nerf_static.n_extra == 0
    assert system.nerf_static.in_ch_feat == 8 + 4 * 3
    assert set(mvsnerf.tparams) == set(system.state_dict())
    assert "nb_imgs" not in mvsnerf.psample
    assert mvsnerf.batch["images"].shape[0] == 3 + 1


def test_mvsnerf_eval_matches_zest_tpu(mvsnerf):
    check_eval(*mvsnerf.eval(), ("rgb_map", "depth_map"))


def test_mvsnerf_validate_matches_zest_tpu(mvsnerf, tmp_path):
    check_validate(*mvsnerf.validate(tmp_path))


def test_mvsnerf_wander_path_matches_zest_tpu(mvsnerf):
    check_path(*mvsnerf.path(), ("rgb_map", "depth_map"))


def test_mvsnerf_train_step_matches_zest_tpu(mvsnerf):
    r = mvsnerf.step(0)
    assert set(r["logs"]) == {"render_loss", "train_loss", "train_PSNR"}
    check_logs(r)
    check_grads(r)
    check_updated(r)


def test_mvsnerf_p16_eval_matches_zest_tpu(mvsnerf, mvsnerf16):
    ref16, out16 = mvsnerf16.eval()
    ref32, out32 = mvsnerf.eval()
    check_p16_eval(ref16, out16, ref32, ("rgb_map", "depth_map"))
    assert float(np.abs(out16["rgb_map"] - out32["rgb_map"]).max()) > 0.0


def test_mvsnerf_p16_train_step_matches_zest_tpu(mvsnerf, mvsnerf16):
    check_p16_step(mvsnerf16.step(0), mvsnerf.step(0))
