"""The adversarial (SVS) step with its rays split over two spawned gloo
ranks (``parallel.dryrun.split_gan_step``, ``GanSystem`` with
``system.mesh``) on the CPU:

- against the port's one-process step (``dryrun.gan_step``) on the same
  weights, batch and draws, at ``presets.SMALL_SVS`` (GRAF, one 32x32
  patch, least squares, LPIPS) and ``presets.SMALL_PATCHGAN`` (two 32x32
  patches, one a rank; the naive loss, the feature-matching term, the depth
  discriminator, the depth reconstruction and total variation): every log
  within 1e-5 relative, every generator and discriminator gradient leaf
  within 1e-4 of its own largest (each rank renders half the rays, the
  loss reads all of them through the gather, and the generator's shares
  are summed over the ranks, so only sums over rays run in another order);
  the ranks' states after the step (the discriminators' parameters,
  spectral ``u``s and optimizer states, and the generator's) equal bit for
  bit;
- ``SMALL_PATCHGAN``'s split step against ``zest_tpu``'s GAN step with
  ``system.mesh = make_mesh(2)`` (GSPMD over two of the 8 CPU devices that
  ``tests/conftest.py`` gives JAX), on ``test_torch_svs_step.GanCase``'s
  weights and draws, at that file's tolerances and
  ``test_torch_svs_step_nlayers.JIT_EAGER``'s table;
- the refusals: ranks that hold different draws raise ``RanksDisagree``
  on every rank, and 1,089 rays (one 33x33 patch) do not split over two
  ranks, so the step warns and runs whole on every rank: the one-process
  step's numbers.
"""
import threading

import numpy as np
import pytest
import torch

from zest_tpu.parallel import make_mesh as jax_make_mesh

from test_torch_ablation_mvsnerf import _few_threads  # noqa: F401
from test_torch_svs_step import (GanCase, check_disc, check_gen_grads,
                                 check_logs, check_updated, jax_draws)
from test_torch_svs_step_nlayers import JIT_EAGER

from zest_tpu_torch import ZestConfig, presets, sampling
from zest_tpu_torch.models.lpips import make_random_lpips_npz
from zest_tpu_torch.parallel import dryrun
from zest_tpu_torch.system import phase_for_step
from zest_tpu_torch.system_gan import GanTrainState

N_RANKS = 2
LOG_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's largest gradient
GRAD_TREES = ("gen_grads", "disc_grads", "depth_grads")
# one 33x33 patch: 1,089 rays do not divide two ranks
ODD = dict(presets.SMALL_PATCHGAN, patch_size=33, batch_size=33 * 33)


def _inputs(tmp, name, cfg, gan, batch, state, draws, run=True):
    """``save_inputs``' file of the case and (with ``run``) its
    one-process step."""
    phase = phase_for_step(cfg, 0)
    path = tmp / f"{name}.pt"
    dryrun.save_inputs(path, cfg, batch, state, draws, phase, 0)
    return str(path), (dryrun.gan_step(gan, state, batch, draws, phase)
                       if run else None)


def _draws(cfg, seed):
    return sampling.sample_draws(torch.Generator().manual_seed(seed), cfg,
                                 cfg.img_h, cfg.img_w, 0, False, 0)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Every case's one-process step, the two ranks' split steps (one
    spawn, beside zest_tpu's compile), and the PatchGAN case's
    ``GanCase`` step with zest_tpu's step meshed over two devices."""
    tmp = tmp_path_factory.mktemp("split_gan")
    lpips = tmp / "lpips.npz"
    make_random_lpips_npz(lpips, seed=0)
    paths, refs = {}, {}

    cfg, gan, batch, state = presets.build_gan(
        dict(presets.SMALL_SVS, lpips_weights=str(lpips)),
        presets.SMALL_SCENE, "cpu", 0)
    paths["svs"], refs["svs"] = _inputs(tmp, "svs", cfg, gan, batch, state,
                                        _draws(cfg, 5))
    # the same step, rank 1 holding another draw of the patch
    other, _ = _inputs(tmp, "svs_other", cfg, gan, batch, state,
                       _draws(cfg, 6), run=False)
    paths["differ"] = [paths["svs"], other]

    # zest_tpu's weights and draws (GanCase), in the port's GanTrainState
    case = GanCase(presets.SMALL_PATCHGAN, presets.PATCHGAN_SCENE, lpips)
    gan = case.gan
    cfg = gan.cfg
    H, W = case.batch["images"].shape[1:3]
    opt = gan.system.make_optimizer(presets.STEPS_PER_EPOCH)
    d_opt = gan.make_disc_optimizer(presets.STEPS_PER_EPOCH)
    state = GanTrainState(case.tparams, case.tdisc, case.tdepth,
                          opt.init(case.tparams), d_opt.init(case.tdisc),
                          d_opt.init(case.tdepth), case.tvars, 0)
    paths["patchgan"], refs["patchgan"] = _inputs(
        tmp, "patchgan", cfg, gan, case.batch, state,
        jax_draws(case.config, 0, H, W))

    cfg, gan, batch, state = presets.build_gan(ODD, presets.PATCHGAN_SCENE,
                                               "cpu", 0)
    draws = _draws(cfg, 7)
    assert draws.xs.shape == (33 * 33,)
    paths["odd"], refs["odd"] = _inputs(tmp, "odd", cfg, gan, batch, state,
                                        draws)

    ranks, threads = {}, torch.get_num_threads()

    def spawn():
        try:
            # the ranks sum at the one-process step's thread count: at
            # another count the CPU's convolutions sum in another order,
            # which alone moves the PatchGAN case's CostRegNet leaves by up
            # to 4.4e-3 of their own largest (the naive loss's
            # conditioning, the last test)
            out = dryrun.run_ranks(N_RANKS, dryrun.split_gan_step,
                                   list(paths.values()), threads=threads)
            ranks.update({name: [r[i] for r in out]
                          for i, name in enumerate(paths)})
        except BaseException as e:          # raised again below
            ranks["error"] = e

    worker = threading.Thread(target=spawn)
    worker.start()
    mesh = jax_make_mesh(N_RANKS)
    case.jgan.system.mesh = mesh
    with mesh:
        jax_run = case.step(0)
    worker.join()
    if "error" in ranks:
        raise ranks["error"]
    return refs, ranks, case, jax_run


def check_split(ref, ranks):
    for got in ranks:
        assert got["refused"] is None and not got["warnings"]
        assert list(got["logs"]) == list(ref["logs"])
        for k, v in ref["logs"].items():
            torch.testing.assert_close(got["logs"][k], v, rtol=LOG_RTOL,
                                       atol=0.0, msg=k)
        for tree in GRAD_TREES:
            assert set(got[tree]) == set(ref[tree]), tree
            for k, g in ref[tree].items():
                scale = max(float(g.abs().max()), 1e-30)
                err = float((got[tree][k] - g).abs().max())
                assert err <= GRAD_TOL * scale, (tree, k, err, scale)
    a, b = ranks
    for tree in GRAD_TREES:
        assert all(torch.equal(a[tree][k], b[tree][k]) for k in a[tree]), tree
    assert _equal(a["state"], b["state"])
    assert all(torch.equal(a["logs"][k], b["logs"][k]) for k in a["logs"])


def _equal(x, y) -> bool:
    if isinstance(x, dict):
        return set(x) == set(y) and all(_equal(x[k], y[k]) for k in x)
    if isinstance(x, torch.Tensor):
        return torch.equal(x, y)
    return x == y


@pytest.mark.parametrize("name", ["svs", "patchgan"])
def test_split_gan_step_matches_one_process(split, name):
    refs, ranks, _, _ = split
    check_split(refs[name], ranks[name])
    assert ranks[name][0]["state"]["step"] == 1


def test_split_patchgan_step_matches_meshed_zest_tpu(split):
    refs, ranks, case, r = split
    got = ranks["patchgan"][0]
    opt = case.gan.system.make_optimizer(presets.STEPS_PER_EPOCH)
    d_opt = case.gan.make_disc_optimizer(presets.STEPS_PER_EPOCH)
    with torch.no_grad():
        new = opt.update(got["gen_grads"], opt.init(case.tparams),
                         case.tparams)[0]
        new_disc = d_opt.update(got["disc_grads"], d_opt.init(case.tdisc),
                                case.tdisc)[0]
    r = dict(r, logs={k: float(v) for k, v in got["logs"].items()},
             grads=got["gen_grads"], new=new, disc_grads=got["disc_grads"],
             new_disc=new_disc, depth_grads=got["depth_grads"],
             vars=got["state"]["disc_vars"])
    check_logs(r, list(got["logs"]))
    check_gen_grads(r, JIT_EAGER)
    check_updated(r)
    check_disc(r, case.tdisc)


def test_ranks_with_different_draws_are_refused(split):
    _, ranks, _, _ = split
    for got in ranks["differ"]:
        assert "gen_grads" not in got
        assert "different draws" in got["refused"], got["refused"]
        assert "xs" in got["refused"] and "jitter" in got["refused"]


def test_ray_count_not_dividing_warns_and_runs_whole(split):
    refs, ranks, _, _ = split
    for got in ranks["odd"]:
        assert any("REPLICATED" in w for w in got["warnings"]), got["warnings"]
        got = dict(got, warnings=[])
        check_split(refs["odd"], [got, got])
    assert _equal(ranks["odd"][0]["state"], ranks["odd"][1]["state"])
    assert np.isfinite(float(ranks["odd"][0]["logs"]["G_loss"]))


def _phase15_step(monkeypatch, preset, ulp_sign=None):
    """Phase 15's small PatchGAN step on the CPU (``chip_smoke.gan_step``'s
    weights and draws); with ``ulp_sign`` the rendered RGB that the
    generator's loss reads is moved by one float32 unit in the last place
    (relative 2^-23, that sign). Returns (generator gradients, the judged
    discriminator outputs in call order, the feature-matching |.|'s
    inputs)."""
    import zest_tpu_torch.system_gan as system_gan
    cfg, gan, batch, state = presets.build_gan(preset, presets.PATCHGAN_SCENE,
                                               "cpu", 0)
    preds, feats = [], []
    apply_disc, abs_, loss = (system_gan.apply_disc, system_gan.abs_,
                              system_gan.GanSystem.generator_loss)

    def judged(disc, params, spectral, x):
        out, new = apply_disc(disc, params, spectral, x)
        preds.append((out[-1] if isinstance(out, (list, tuple)) else out)
                     .detach())
        return out, new

    def recorded_abs(x):
        feats.append(x.detach())
        return abs_(x)

    def moved(self, results, rays, st):
        if ulp_sign is not None:
            results = dict(results, rgb_map=results["rgb_map"]
                           * (1.0 + 2.0 ** -23 * ulp_sign))
        return loss(self, results, rays, st)
    monkeypatch.setattr(system_gan, "apply_disc", judged)
    monkeypatch.setattr(system_gan, "abs_", recorded_abs)
    monkeypatch.setattr(system_gan.GanSystem, "generator_loss", moved)
    draws = _draws(cfg, 5)
    out = dryrun.gan_step(gan, state, batch, draws, phase_for_step(cfg, 0))
    monkeypatch.undo()
    return out["gen_grads"], preds, feats


def _module_spread(a, b, leaf):
    m = leaf.split(".")[0]
    scale = max(float(g.abs().max()) for k, g in a.items()
                if k.split(".")[0] == m)
    return float((a[leaf] - b[leaf]).abs().max()) / scale


def test_patchgan_gate_spread_is_the_naive_losss_conditioning(monkeypatch):
    """What sets chip_smoke phase 15's small PatchGAN gate at ~1.8e-4 of the
    encoder's largest gradient (``enc_static.cost_reg_2.conv0.conv.weight``,
    held to 1e-4 plus twice the naive loss's conditioning): not the
    feature-matching L1's kinks, but the naive loss's 1/p at the fake
    patch's output nearest its clip. Moving the rendered RGB by one float32
    ulp (a rounding such as the card's and the CPU's sums make) flips no
    |ff - fr| entry and leaves no entry within its own change of zero; it
    moves that leaf by over 2e-5 of the module's largest with the naive
    loss, at least 5x what it moves with least squares, and by no more
    than twice ``adversarial_conditioning`` of the moved outputs plus 1e-5
    (the phase-15 gate's conditioning term)."""
    from zest_tpu_torch.system_gan import adversarial_conditioning
    leaf = "enc_static.cost_reg_2.conv0.conv.weight"
    sign = (torch.randint(0, 2, (2048, 3), generator=torch.Generator()
                          .manual_seed(0)) * 2 - 1).float()
    moves = {}
    for loss in ("naive", "lsgan"):
        preset = dict(presets.SMALL_PATCHGAN, gan_loss=loss)
        grads, preds, feats = _phase15_step(monkeypatch, preset)
        grads_u, preds_u, feats_u = _phase15_step(monkeypatch, preset, sign)
        moves[loss] = _module_spread(grads, grads_u, leaf)
        if loss == "naive":
            assert len(feats) == len(feats_u) == 4    # the features' terms
            for a, b in zip(feats, feats_u):
                near = (a.abs() <= (a - b).abs()) | (a.sign() != b.sign())
                assert int(near.sum()) == 0
            cond = adversarial_conditioning(
                ZestConfig(**preset), preds,
                [(a - b).abs() for a, b in zip(preds, preds_u)])
            assert moves[loss] <= 2 * cond + 1e-5, (moves, cond)
    assert moves["naive"] > 2e-5 and moves["naive"] >= 5 * moves["lsgan"], \
        moves
