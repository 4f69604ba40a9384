"""The SVS slice's modules in zest_tpu_torch against zest_tpu's on the CPU,
on inputs made from a numpy seed:

- the patch regularizers (disparity smoothness, total variation, the O(S)
  interval distortion): values and input gradients at rtol 1e-5; the
  non-GAN ``compute_losses`` with them switched on (each term times its
  lambda twice, as the reference double-scales them): the loss and every
  log at rtol 1e-5;
- the pixel samplers: square patches and GRAF's patch exactly equal to
  zest_tpu's, on zest_tpu's own draws, at steps 0, 3,000 and 20,000 (the
  least scale is 0.9 up to step 14,999, then the anneal lowers it), at the
  small and the flagship image sizes;
- each discriminator (basic, n_layers with its intermediate features,
  pixel, GRAF at imsize 32, 64 and 128, the depth discriminator), its
  weights carried over by ``convert.from_jax_disc_params``: the output at
  rtol 1e-5 / atol 1e-6 (n_layers' intermediate features, which leave a
  batch normalization, within 1e-5 of each one's largest: up to 1e-5 of
  3.8 apart near zero), the gradient of a random projection of the
  outputs with respect to every parameter within 1e-5 of that leaf's
  largest, and GRAF's next spectral ``u`` likewise;
- spectral norm: one ``SpectralConv`` layer's gradient, which flows through
  the power iteration, within 1e-5 of zest_tpu's, a check that the same
  layer normalized by ``torch.nn.utils.spectral_norm`` (its iteration
  detached) fails. Inside GRAF's discriminator the two agree: every
  normalized layer but the last feeds an InstanceNorm (through a leaky
  ReLU at most), which removes the 1/sigma scale, and the last has one
  output, where one iteration finds sigma = |W| exactly (measured: 1.4e-6
  to 3.0e-6 of each leaf's largest either way);
- LPIPS (AlexNet, a seeded random ``.npz``, the same file both packages
  write): the distance at rtol 1e-5 and its gradient with respect to an
  image within 1e-5 of its largest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu import losses as jlosses
from zest_tpu import sampling as jsampling
from zest_tpu.config import ZestConfig as JZestConfig
from zest_tpu.models import discriminators as jdisc
from zest_tpu.models import lpips as jlpips
from zest_tpu.sampling import RayBatch as JRayBatch
from zest_tpu.system import Phase as JPhase
from zest_tpu.system import ZestSystem as JZestSystem
# _few_threads: its module-scoped autouse fixture applies here too
from test_torch_ablation_mvsnerf import _few_threads  # noqa: F401

from zest_tpu_torch import ZestConfig, losses, presets, sampling
from zest_tpu_torch.convert import from_jax_disc_params
from zest_tpu_torch.models import discriminators as tdisc
from zest_tpu_torch.models import lpips as tlpips
from zest_tpu_torch.system import Phase, ZestSystem

RTOL = 1e-5


def _grad_close(got: dict, ref: dict, rtol=RTOL):
    """Every leaf within rtol of its own largest (ref's)."""
    assert set(got) == set(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        err = float(np.abs(got[k] - r).max())
        assert err <= rtol * float(np.abs(r).max()), (k, err)


# --------------------------------------------------------------------------
# regularizers


def test_regularizers_match_zest_tpu():
    rng = np.random.default_rng(0)
    disp = rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)
    img = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    w = rng.uniform(0, 0.2, (64, 16)).astype(np.float32)
    t = np.linspace(0, 1, 16, dtype=np.float32)
    cases = [
        (jlosses.get_disparity_smoothness, losses.get_disparity_smoothness,
         (disp, img)),
        (jlosses.total_variation_loss, losses.total_variation_loss,
         (disp[..., 0],)),
        (jlosses.distortion_loss, losses.distortion_loss, (w, t)),
    ]
    for jfn, tfn, args in cases:
        ref, jgrad = jax.value_and_grad(jfn)(*map(jnp.asarray, args))
        x = torch.from_numpy(args[0]).requires_grad_(True)
        out = tfn(x, *map(torch.from_numpy, args[1:]))
        (grad,) = torch.autograd.grad(out, x)
        np.testing.assert_allclose(out.item(), float(ref), rtol=RTOL,
                                   err_msg=tfn.__name__)
        _grad_close({"x": grad.numpy()}, {"x": jgrad})


def test_distortion_loss_is_the_pairwise_sum():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.uniform(0, 0.2, (3, 12)).astype(np.float64))
    t = torch.linspace(0, 1, 12, dtype=torch.float64)
    m = 0.5 * (t[:-1] + t[1:])
    ww = w[:, :-1]
    pair = 0.5 * torch.sum(ww[:, :, None] * ww[:, None, :]
                           * (m[:, None] - m[None, :]).abs(), (1, 2))
    single = torch.sum(ww ** 2 * (t[1:] - t[:-1]), -1) / 3.0
    torch.testing.assert_close(losses.distortion_loss(w, t),
                               torch.sum(pair + single))


def test_compute_losses_double_scales_the_regularizers():
    kw = dict(presets.SMALL_MVSNERF, patch_size=8, with_depth_loss_reg=True,
              with_depth_smoothness=True, with_distortion_loss=True,
              lambda_depth_reg=0.3, lambda_depth_smooth=0.4,
              lambda_distortion=0.5)
    rng = np.random.default_rng(2)
    R, S = 128, 16
    arrays = dict(rgb_map=rng.uniform(0, 1, (R, 3)),
                  depth_map=rng.uniform(1, 2, (R,)),
                  weights=rng.uniform(0, 0.1, (R, S)),
                  color_gt=rng.uniform(0, 1, (R, 3)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    t_vals = np.linspace(0, 1, S, dtype=np.float32)
    jsys = JZestSystem(JZestConfig(**kw))
    zeros = np.zeros((R, S, 3), np.float32)
    jrays = JRayBatch(pts=zeros, ndc=zeros, z_vals=zeros[..., 0],
                      rays_d=zeros[:, 0], color_gt=jnp.asarray(arrays["color_gt"]),
                      depth_gt=zeros[:, 0, 0], t_vals=jnp.asarray(t_vals))
    jres = {k: jnp.asarray(arrays[k]) for k in
            ("rgb_map", "depth_map", "weights")}
    ref_total, ref_logs = jsys.compute_losses(jres, jrays, {}, jnp.asarray(0),
                                              JPhase(), True)
    system = ZestSystem(ZestConfig(**kw))
    rays = sampling.RayBatch(*(None if a is None else torch.tensor(np.asarray(a))
                               for a in jrays))
    total, logs = system.compute_losses(
        {k: torch.from_numpy(arrays[k]) for k in jres}, rays, {}, 0, Phase())
    assert list(logs) == list(ref_logs)
    for k, v in ref_logs.items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=RTOL)
    # the double scaling: train_loss - render_loss = sum of lambda * term
    lam = {"tv_depth_loss": 0.3, "depth_smooth_loss": 0.4,
           "distortion_loss": 0.5}
    extra = sum(lam[k] * float(logs[k]) for k in lam)
    np.testing.assert_allclose(float(total) - float(logs["render_loss"]),
                               extra, rtol=1e-4)


# --------------------------------------------------------------------------
# samplers


def _jax_graf_draws(key):
    """zest_tpu's five GRAF draws from its key, as the port takes them."""
    k_scale, k_sh, k_sw, k_fh, k_fw = jax.random.split(key, 5)
    vals = [jax.random.uniform(k_scale, ()), jax.random.uniform(k_sh, ()),
            jax.random.uniform(k_sw, ()), jax.random.randint(k_fh, (), 0, 2),
            jax.random.randint(k_fw, (), 0, 2)]
    return torch.tensor([float(v) for v in vals], dtype=torch.float32)


@pytest.mark.parametrize("H,W,P", [(32, 64, 32), (288, 544, 64)])
@pytest.mark.parametrize("step", [0, 3000, 20000])
def test_graf_pixels_equal_zest_tpus_on_its_draws(H, W, P, step):
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        xs, ys = jsampling.sample_pixels_graf(key, H, W, P, jnp.asarray(step),
                                              0.0025)
        txs, tys = sampling.sample_pixels_graf(_jax_graf_draws(key), H, W, P,
                                               step, 0.0025)
        np.testing.assert_array_equal(txs.numpy(), np.asarray(xs))
        np.testing.assert_array_equal(tys.numpy(), np.asarray(ys))
        assert txs.shape == (P * P,)
        assert 0 <= float(txs.min()) and float(txs.max()) <= W - 1
        assert 0 <= float(tys.min()) and float(tys.max()) <= H - 1
    min_s = float(sampling.graf_min_scale(step, 0.0025))
    assert min_s == (np.float32(0.9) if step < 15000 else pytest.approx(
        float(np.exp(np.float32(-60 * 0.0025))), rel=1e-6))


@pytest.mark.parametrize("H,W,P,n", [(48, 64, 32, 2), (288, 544, 64, 1)])
def test_patch_pixels_equal_zest_tpus_on_its_draws(H, W, P, n):
    key = jax.random.PRNGKey(7)
    xs, ys = jsampling.sample_pixels_patches(key, H, W, n, P)
    kx, ky = jax.random.split(key)
    xb = torch.tensor(np.asarray(jax.random.randint(kx, (n,), 0, W - P)))
    yb = torch.tensor(np.asarray(jax.random.randint(ky, (n,), 0, H - P)))
    txs, tys = sampling.sample_pixels_patches(xb, yb, P)
    np.testing.assert_array_equal(txs.numpy(), np.asarray(xs))
    np.testing.assert_array_equal(tys.numpy(), np.asarray(ys))


def test_draws_of_each_pixel_mode():
    """GRAF gives patch_size^2 rays whatever batch_size is; square patches
    batch_size // patch_size^2 of them; each with its depth jitter."""
    base = dict(presets.SMALL_MVSNERF, batch_size=4096)
    for kw, n in [(dict(gan_type="graf", patch_size=32), 1024),
                  (dict(gan_type="n_layers", patch_size=16), 4096),
                  (dict(patch_size=16, batch_size=512), 512),
                  ({}, 4096)]:
        cfg = ZestConfig(**dict(base, **kw))
        d = sampling.sample_draws(torch.Generator().manual_seed(0), cfg, 48,
                                  64, 0, False, 3000)
        assert d.xs.shape == d.ys.shape == (n,)
        assert d.jitter.shape == (n, cfg.N_samples)
        assert d.xs.dtype == torch.float32
        assert float(d.ys.max()) <= 47 and float(d.xs.max()) <= 63
    # square patches: contiguous rows of P pixels
    cfg = ZestConfig(**dict(base, patch_size=16, batch_size=512))
    d = sampling.sample_draws(torch.Generator().manual_seed(1), cfg, 48, 64,
                              0, False)
    xs = d.xs.reshape(2, 16, 16)
    assert torch.equal(xs[:, :, 1:] - xs[:, :, :-1], torch.ones(2, 16, 15))


# --------------------------------------------------------------------------
# discriminators


def _jax_vars(module, x, seed):
    variables = jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    params = variables["params"]
    other = {k: v for k, v in variables.items() if k != "params"}
    return params, other


def _nhwc(t):
    return t.permute(0, 2, 3, 1) if t.dim() == 4 else t


DISCS = {
    "basic": (lambda: jdisc.BasicDiscriminator(in_dim=8 * 8 * 3,
                                               use_sigmoid=True),
              lambda: tdisc.BasicDiscriminator(8 * 8 * 3, True), 8, 3),
    "n_layers": (lambda: jdisc.NLayerDiscriminator(32, 3, 64, 3,
                                                   get_interm_feat=True),
                 lambda: tdisc.NLayerDiscriminator(32, 3, 64, 3, True), 32, 3),
    "pixel": (lambda: jdisc.PixelDiscriminator(16, 3, 64),
              lambda: tdisc.PixelDiscriminator(16, 3, 64), 16, 3),
    "depth": (lambda: jdisc.NLayerDiscriminator(32, 1, 64, 3),
              lambda: tdisc.NLayerDiscriminator(32, 1, 64, 3), 32, 1),
    "graf32": (lambda: jdisc.GRAFDiscriminator(imsize=32),
               lambda: tdisc.GRAFDiscriminator(imsize=32), 32, 3),
    "graf64": (lambda: jdisc.GRAFDiscriminator(imsize=64),
               lambda: tdisc.GRAFDiscriminator(imsize=64), 64, 3),
    "graf128": (lambda: jdisc.GRAFDiscriminator(imsize=128),
                lambda: tdisc.GRAFDiscriminator(imsize=128), 128, 3),
}


def _disc_case(name, seed=0):
    """(zest_tpu's output list, gradients, next spectral u; the port's)."""
    jfn, tfn, P, ch = DISCS[name]
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (1 if P > 64 else 2, P * P, ch)).astype(np.float32)
    jmod = jfn()
    params, other = _jax_vars(jmod, x, seed)
    graf = "spectral" in other

    def run(p):
        if graf:
            out, new = jmod.apply({"params": p, **other}, jnp.asarray(x), None,
                                  mutable=["spectral"])
        else:
            out, new = jmod.apply({"params": p}, jnp.asarray(x)), {}
        return out if isinstance(out, list) else [out], new

    outs, new_vars = jax.jit(run)(params)
    cots = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in outs]

    def proj(p):
        return sum(jnp.sum(o * c) for o, c in zip(run(p)[0], cots))
    jgrads = jax.jit(jax.grad(proj))(params)

    tparams, tvars = from_jax_disc_params(params, other)
    jgrads_t, _ = from_jax_disc_params(jgrads)
    jnew = from_jax_disc_params(params, new_vars)[1]
    module = tfn()
    assert set(tparams) == {k for k, _ in module.named_parameters()}
    assert set(tvars) == {k for k, _ in module.named_buffers()}
    leaves = {k: v.requires_grad_(True) for k, v in tparams.items()}
    out = torch.func.functional_call(module, {**leaves, **tvars},
                                     (torch.from_numpy(x),))
    out = out if isinstance(out, list) else [out]
    total = sum(torch.sum(_nhwc(o) * torch.from_numpy(c))
                for o, c in zip(out, cots))
    grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
    return ([np.asarray(o) for o in outs], jgrads_t, jnew,
            [_nhwc(o).detach().numpy() for o in out], grads,
            tdisc.spectral_state(module), (module, tparams, tvars, x, cots))


@pytest.mark.parametrize("name", sorted(DISCS))
def test_discriminator_matches_zest_tpu(name):
    ref, jgrads, jnew, out, grads, new, _ = _disc_case(name)
    assert len(out) == len(ref) == (5 if name == "n_layers" else 1)
    for o, r in zip(out[:-1], ref[:-1]):
        assert o.shape == r.shape
        assert float(np.abs(o - r).max()) <= RTOL * float(np.abs(r).max())
    assert out[-1].shape == ref[-1].shape
    np.testing.assert_allclose(out[-1], ref[-1], rtol=RTOL, atol=1e-6)
    _grad_close({k: g.numpy() for k, g in grads.items()},
                {k: g.numpy() for k, g in jgrads.items()})
    assert set(new) == set(jnew) and bool(new) == name.startswith("graf")
    _grad_close({k: v.numpy() for k, v in new.items()},
                {k: v.numpy() for k, v in jnew.items()})


def test_spectral_conv_gradient_flows_through_the_power_iteration():
    """A lone SpectralConv, whose output scale reaches the loss: the port's
    gradient is zest_tpu's; torch.nn.utils.spectral_norm's (one detached
    power iteration, the same forward) fails the same check."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, 16, 16, 8)).astype(np.float32)
    jmod = jdisc.SpectralConv(24)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    out, new_vars = jmod.apply(variables, jnp.asarray(x), mutable=["spectral"])
    cot = rng.standard_normal(out.shape).astype(np.float32)

    def proj(p):
        o, _ = jmod.apply({**variables, "params": p}, jnp.asarray(x),
                          mutable=["spectral"])
        return jnp.sum(o * cot)
    jgrad = np.asarray(jax.grad(proj)(variables["params"])["kernel"])
    jgrad = jgrad.transpose(3, 2, 0, 1)
    kernel = np.asarray(variables["params"]["kernel"]).transpose(3, 2, 0, 1)
    u = torch.from_numpy(np.asarray(variables["spectral"]["u"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    conv = tdisc.SpectralConv(8, 24)
    w = torch.from_numpy(kernel.copy()).requires_grad_(True)
    y = torch.func.functional_call(conv, {"weight": w, "u": u}, (xt,))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(), out,
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(conv.u_next.numpy(),
                               np.asarray(new_vars["spectral"]["u"]),
                               rtol=RTOL, atol=1e-6)
    (grad,) = torch.autograd.grad(
        torch.sum(y.permute(0, 2, 3, 1) * torch.from_numpy(cot)), w)
    _grad_close({"w": grad.numpy()}, {"w": jgrad})

    sn = torch.nn.utils.spectral_norm(
        torch.nn.Conv2d(8, 24, 4, 2, 1, bias=False), eps=1e-12)
    with torch.no_grad():
        sn.weight_orig.copy_(torch.from_numpy(kernel))
        sn.weight_u.copy_(u)
    y_sn = sn(xt)
    np.testing.assert_allclose(y_sn.permute(0, 2, 3, 1).detach().numpy(), out,
                               rtol=1e-4, atol=1e-5)
    (grad_sn,) = torch.autograd.grad(
        torch.sum(y_sn.permute(0, 2, 3, 1) * torch.from_numpy(cot)),
        sn.weight_orig)
    with pytest.raises(AssertionError):
        _grad_close({"w": grad_sn.numpy()}, {"w": jgrad})


def test_build_discriminator_by_gan_type():
    for gan_type, cls in [("basic", tdisc.BasicDiscriminator),
                          ("n_layers", tdisc.NLayerDiscriminator),
                          ("pixel", tdisc.PixelDiscriminator),
                          ("graf", tdisc.GRAFDiscriminator)]:
        cfg = ZestConfig(gan_type=gan_type, patch_size=32)
        assert isinstance(tdisc.build_discriminator(cfg), cls)
    with pytest.raises(ValueError):
        tdisc.build_discriminator(ZestConfig(gan_type="bogus"))
    with pytest.raises(ValueError, match="imsize"):
        tdisc.GRAFDiscriminator(imsize=48)


# --------------------------------------------------------------------------
# LPIPS


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("lpips") / "lpips.npz"
    tlpips.make_random_lpips_npz(path, seed=0)
    return path


def test_random_lpips_npz_equals_zest_tpus(lpips_npz, tmp_path):
    jlpips.make_random_lpips_npz(tmp_path / "ref.npz", seed=0)
    with np.load(lpips_npz) as a, np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("shape", [(32, 48), (64, 64)])
def test_lpips_distance_and_gradient_match_zest_tpu(lpips_npz, shape):
    rng = np.random.default_rng(4)
    a, b = (rng.uniform(0, 1, shape + (3,)).astype(np.float32)
            for _ in range(2))
    with np.load(lpips_npz) as data:
        jparams = {k: jnp.asarray(data[k]) for k in data.files}
    ref, jgrad = jax.jit(jax.value_and_grad(
        lambda x: jlpips.lpips_distance(jparams, x, jnp.asarray(b))))(
            jnp.asarray(a))
    fn = tlpips.load_lpips(lpips_npz)
    x = torch.from_numpy(a).requires_grad_(True)
    out = fn(x, torch.from_numpy(b))
    (grad,) = torch.autograd.grad(out, x)
    np.testing.assert_allclose(float(out), float(ref), rtol=RTOL)
    _grad_close({"img": grad.numpy()}, {"img": jgrad})
    assert float(ref) > 0
    assert abs(float(fn(x, x))) < 1e-6
    assert not list(fn.state_dict())      # the weights are not state


def test_lpips_refuses_too_small_images_and_bad_files(lpips_npz, tmp_path):
    fn = tlpips.load_lpips(lpips_npz)
    with pytest.raises(ValueError, match="too small"):
        fn(torch.zeros(16, 16, 3), torch.zeros(16, 16, 3))
    with np.load(lpips_npz) as data:
        np.savez(tmp_path / "short.npz",
                 **{k: data[k] for k in data.files if k != "lin4_w"})
    with pytest.raises(KeyError, match="lin4_w"):
        tlpips.load_lpips(tmp_path / "short.npz")
