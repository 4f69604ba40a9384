"""The SVS (GAN) path through the port's training loop, checkpoints, test
and command line on the CPU, and gradient accumulation against zest_tpu's:

- ``run_training`` on ``presets.SMALL_SVS`` (a seeded random LPIPS
  ``.npz``): two GAN steps, a validation with ``val_LPIPS``, the whole
  ``GanTrainState`` in ``ckpts/last`` equal to the loop's final state, and
  a resume from it that carries on the generator's and both
  discriminators' optimizer counts;
- ``run_test``: its ``LPIPS:`` line is the mean LPIPS of the clipped
  renders against the targets; ``_maybe_lpips`` refuses a file that does
  not load;
- ``python -m zest_tpu_torch.train`` / ``test`` with ``--device cpu`` on
  ``config_svs_nsff_cross1.txt`` at test size;
- ``acc_grad = 2``: the probe weight of zest_tpu's loop (optax's
  ``MultiSteps`` around its clip, Adam and cosine) and of the port's
  (``system.MultiSteps``), each loop's step replaced by one that feeds the
  same gradients, agree to rtol 1e-5 at every step over two and a half
  passes; the real step under it moves the parameters every second step.
"""
import csv
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zest_tpu import train_loop as jloop
from zest_tpu.config import ZestConfig as JZestConfig
from zest_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from zest_tpu.system import TrainState as JTrainState
from zest_tpu.system import ZestSystem as JZestSystem
from test_torch_ablation_mvsnerf import _few_threads  # noqa: F401

from zest_tpu_torch import ZestConfig, presets, train, train_loop
from zest_tpu_torch import test as test_cli
from zest_tpu_torch.checkpoint import CheckpointManager, restore_path
from zest_tpu_torch.data.synthetic import SyntheticDataset
from zest_tpu_torch.models.lpips import load_lpips, make_random_lpips_npz
from zest_tpu_torch.system import TrainState, ZestSystem, to_batch, unpreprocess
from zest_tpu_torch.system_gan import GanTrainState

REPO = Path(__file__).resolve().parents[1]
SVS_FILE = REPO / "configs" / "config_files" / "config_svs_nsff_cross1.txt"


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("lpips") / "lpips.npz"
    make_random_lpips_npz(path, seed=0)
    return str(path)


def _equal_trees(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal_trees(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_gan_training_checkpoints_validates_and_resumes(tmp_path, lpips_npz):
    ds = presets.scene_of(presets.SMALL_SVS, presets.SMALL_SCENE)
    cfg = ZestConfig(**presets.SMALL_SVS, lpips_weights=lpips_npz,
                     save_dir=str(tmp_path), expname="svs", log_every=1,
                     N_vis=1, seed_everything=0)
    state, system = train_loop.run_training(
        cfg, {"train": ds, "val": [ds[3]]}, max_steps=2, quiet=True,
        device="cpu")
    assert isinstance(state, GanTrainState) and state.step == 2
    assert isinstance(system, ZestSystem)
    assert state.opt_state["count"] == state.disc_opt_state["count"] == 2
    assert state.depth_disc_params == {} and state.depth_disc_opt_state == {}
    assert set(state.disc_vars) == {f"convs.{i}.u" for i in range(4)}
    last = restore_path(tmp_path / "svs" / "ckpts" / "last")
    assert isinstance(last, GanTrainState)
    for field in GanTrainState._fields:
        _equal_trees(getattr(last, field), getattr(state, field), field)
    with open(tmp_path / "svs" / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["step"] for r in rows] == ["1", "2", "2"]
    for r in rows[:2]:
        for k in ("G_loss", "D_loss", "D_fake_loss", "D_real_loss",
                  "G_fake_loss", "G_rec_loss", "train_PSNR"):
            assert np.isfinite(float(r[k])), k
    assert np.isfinite(float(rows[2]["val_LPIPS"]))
    assert float(rows[2]["val_LPIPS"]) > 0

    resumed, _ = train_loop.run_training(
        cfg, {"train": ds}, max_steps=3, quiet=True, device="cpu")
    assert resumed.step == 3
    assert resumed.opt_state["count"] == resumed.disc_opt_state["count"] == 3
    moved = [k for k in state.disc_params
             if not torch.equal(resumed.disc_params[k], state.disc_params[k])]
    assert moved == list(state.disc_params)
    # a GAN checkpoint does not fit a system without the GAN
    plain = ZestSystem(ZestConfig(**presets.SMALL_MVSNERF))
    params = plain.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="GanTrainState"):
        train_loop._check_like(last, TrainState(params, {}, 0), "last")


def test_run_test_reports_lpips(tmp_path, lpips_npz):
    cfg, system, batch, params = presets.build(presets.SMALL_MVSNERF,
                                               presets.SMALL_SCENE, "cpu")
    ds = presets.scene_of(presets.SMALL_MVSNERF, presets.SMALL_SCENE)
    opt = system.make_optimizer(presets.STEPS_PER_EPOCH)
    CheckpointManager(tmp_path / "ck").save_last(
        TrainState(params, opt.init(params), 4))
    cfg = ZestConfig(**presets.SMALL_MVSNERF, lpips_weights=lpips_npz,
                     ckpt=str(tmp_path / "ck" / "last"),
                     save_dir=str(tmp_path), expname="lp")
    frames = [ds[3], ds[5]]
    out = train_loop.run_test(cfg, {"test": frames}, quiet=True, device="cpu")
    assert list(out) == ["val_loss", "val_PSNR", "val_SSIM", "val_LPIPS"]
    lines = (tmp_path / "lp" / "test_metrics.txt").read_text().splitlines()
    assert [ln.split(": ")[0] for ln in lines] == ["PSNR", "SSIM", "LPIPS"]
    assert float(lines[2].split(": ")[1]) == out["val_LPIPS"]
    fn = load_lpips(lpips_npz)
    eval_fn = system.make_eval_step()
    want = []
    for frame in frames:
        b = to_batch(frame, "cpu")
        pred = torch.clamp(eval_fn(params, b)["rgb_map"], 0.0, 1.0)
        want.append(float(fn(pred, unpreprocess(b["images"][-1]))))
    np.testing.assert_allclose(out["val_LPIPS"], np.mean(want), rtol=1e-6)


def test_maybe_lpips_refuses_a_bad_file(tmp_path):
    bad = tmp_path / "corrupt.npz"
    bad.write_bytes(b"not an npz")
    with pytest.raises(RuntimeError, match="lpips_weights"):
        train_loop._maybe_lpips(ZestConfig(lpips_weights=str(bad)))
    assert train_loop._maybe_lpips(ZestConfig()) is None


def test_svs_file_trains_and_tests_from_the_command_line(tmp_path, lpips_npz):
    base = ["--config", str(SVS_FILE), "--dataset_name", "synthetic",
            "--lpips_weights", lpips_npz, "--device", "cpu",
            "--save_dir", str(tmp_path), "--img_h", "32", "--img_w", "64",
            "--netwidth", "64", "--N_samples", "16", "--num_keyframes", "3",
            "--num_input", "3", "--pad", "4", "--patch_size", "32",
            "--log_every", "1"]
    with pytest.warns(UserWarning, match="acc_grad"):
        assert train.main([*base, "--max_train_steps", "2"]) == 0
    last = tmp_path / "svs_nsff_cross1" / "ckpts" / "last"
    state = restore_path(last)
    assert isinstance(state, GanTrainState) and state.step == 2
    assert test_cli.main([*base, "--ckpt", str(last)]) == 0
    lines = (tmp_path / "svs_nsff_cross1" / "test_metrics.txt").read_text()
    assert [ln.split(": ")[0] for ln in lines.splitlines()] == [
        "PSNR", "SSIM", "LPIPS"]


def _grad(frame: int, step: int) -> np.ndarray:
    """The probe's gradient at a step: its norm crosses the clip's 1.0."""
    return np.array([0.3 * (frame + 1), -0.2, 0.05 * step], np.float32)


def test_acc_grad_matches_zest_tpus_multisteps(monkeypatch, tmp_path):
    kw = dict(presets.SMALL_TRAIN, acc_grad=2, steps_per_epoch=4,
              num_epochs=5, log_every=5, expname="acc", seed_everything=3)
    n_frames = len(JSyntheticDataset(**presets.SMALL_SCENE))
    n_steps = n_frames * 5 // 2
    ref, got = [], []

    def jmake(self, optimizer):
        def step(state, batch, rng, phase):
            g = {"w": jnp.asarray(_grad(int(batch["time"]), int(state.step)))}
            upd, opt_state = optimizer.update(g, state.opt_state, state.params)
            params = optax.apply_updates(state.params, upd)
            ref.append(np.asarray(params["w"]))
            zero = jnp.zeros(())
            return (JTrainState(params, opt_state, state.step + 1),
                    {"train_loss": zero, "train_PSNR": zero})
        return step

    def tmake(self, optimizer):
        def step(state, batch, draws, phase):
            g = {"w": torch.from_numpy(_grad(int(batch["time"]), state.step))}
            params, opt_state = optimizer.update(g, state.opt_state,
                                                 state.params)
            got.append(params["w"].numpy().copy())
            zero = torch.zeros(())
            return (TrainState(params, opt_state, state.step + 1),
                    {"train_loss": zero, "train_PSNR": zero})
        return step

    monkeypatch.setattr(JZestSystem, "init_params",
                        lambda self, key, batch: {"w": jnp.zeros(3)})
    monkeypatch.setattr(JZestSystem, "make_train_step", jmake)
    monkeypatch.setattr(ZestSystem, "init_params",
                        lambda self, gen: {"w": torch.zeros(3)})
    monkeypatch.setattr(ZestSystem, "make_train_step", tmake)
    jloop.run_training(JZestConfig(**kw, save_dir=str(tmp_path / "ref")),
                       max_steps=n_steps, quiet=True, datasets={
                           "train": JSyntheticDataset(**presets.SMALL_SCENE)})
    state, _ = train_loop.run_training(
        ZestConfig(**kw, save_dir=str(tmp_path / "port")),
        {"train": SyntheticDataset(**presets.SMALL_SCENE)},
        max_steps=n_steps, quiet=True, device="cpu")
    assert len(got) == len(ref) == n_steps
    np.testing.assert_allclose(np.stack(got), np.stack(ref), rtol=1e-5,
                               atol=1e-9)
    moves = [not np.array_equal(a, b) for a, b in zip(got, [np.zeros(3)] + got)]
    assert moves == [i % 2 == 1 for i in range(n_steps)]
    assert state.opt_state["inner"]["count"] == n_steps // 2
    assert state.opt_state["mini_step"] == n_steps % 2


def test_acc_grad_real_step_updates_every_second_step(tmp_path):
    ds = presets.scene_of(presets.SMALL_MVSNERF, presets.SMALL_SCENE)
    cfg = ZestConfig(**presets.SMALL_MVSNERF, acc_grad=2,
                     save_dir=str(tmp_path), expname="acc2")
    train_loop.run_training(cfg, {"train": ds}, max_steps=1, quiet=True,
                            device="cpu")
    first = restore_path(tmp_path / "acc2" / "ckpts" / "last")
    s2, _ = train_loop.run_training(cfg, {"train": ds}, max_steps=2,
                                    quiet=True, device="cpu")
    init = ZestSystem(cfg).init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(first.params[k], v) for k, v in init.items())
    assert first.opt_state["mini_step"] == 1
    assert first.opt_state["inner"]["count"] == 0
    assert s2.opt_state["mini_step"] == 0 and s2.opt_state["inner"]["count"] == 1
    assert sum(not torch.equal(s2.params[k], v) for k, v in init.items()) > \
        len(init) // 2
    assert all(float(a.abs().max()) == 0 for a in s2.opt_state["acc"].values())
