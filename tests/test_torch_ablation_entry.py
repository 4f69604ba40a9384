"""The entry points of the configurations without scene flow or without a
volume, on the CPU.

- The synthetic scene without keyframes (``use_mvs=False``: the target
  alone in ``images``) and without neighbours (``use_mvs_dy=False``: no
  ``nb_*`` keys) equals zest_tpu's key for key, bit for bit.
- ``train`` / ``test`` / ``render_spiral`` (``python -m zest_tpu_torch.*``'s
  ``main``) with ``--device cpu`` on ``configs/toy_synthetic.txt``, the
  repo's configuration without volumes, and on the same file made
  MVSNeRF's static field (``--train_sceneflow False --use_mvs True``): the
  checkpoint, ``test_metrics.txt`` and the wander path's PNGs; the static
  field's ``validate`` reads ``rgb_map`` / ``depth_map`` and writes its
  PNGs, and its training logs ``render_loss``.
- A checkpoint of each preset's parameters and Adam state restores whole,
  and one preset's does not fit another's system.
- In each family, another precision raises ``NotImplementedError``
  naming it; each of the three model options (``net_type="v2"``,
  ``train_video``, ``use_color_volume``) builds zest_tpu's parameters
  (names and shapes through ``convert``), or where zest_tpu cannot run it
  (a v2 field without its volume: NSFF's) raises by name; and every
  configuration file (89) builds its system, the SVS files' GAN system
  with a seeded random LPIPS ``.npz``.
"""
import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from zest_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
# _few_threads: its module-scoped autouse fixture applies here too
from test_torch_ablation_mvsnerf import _few_threads, zest_tpu_shapes

from zest_tpu_torch import (ZestConfig, presets, render_spiral, train,
                            train_loop)
from zest_tpu_torch import test as test_cli
from zest_tpu_torch.checkpoint import CheckpointManager, restore_path
from zest_tpu_torch.data.synthetic import SyntheticDataset
from zest_tpu_torch.system import TrainState, ZestSystem

REPO = Path(__file__).resolve().parents[1]
TOY = REPO / "configs" / "toy_synthetic.txt"
# the toy file made MVSNeRF's: the static field alone on 3 source views
STATIC_ONLY = ["--train_sceneflow", "False", "--use_mvs", "True",
               "--num_input", "3", "--pad", "4",
               "--img_h", "32", "--img_w", "64", "--raw_noise_std", "1.0"]


@pytest.mark.parametrize("use_mvs,use_mvs_dy", [(False, False), (True, False),
                                                (False, True)])
@pytest.mark.parametrize("frame", [presets.TARGET_FRAME, 0])
def test_synthetic_scene_without_volumes_matches_zest_tpu(use_mvs, use_mvs_dy,
                                                          frame):
    kw = dict(presets.SMALL_SCENE, use_mvs=use_mvs, use_mvs_dy=use_mvs_dy)
    out = SyntheticDataset(**kw)[frame]
    ref = JSyntheticDataset(**kw)[frame]
    assert ("nb_imgs" in out) == use_mvs_dy == ("nb_imgs" in ref)
    assert len(out["images"]) == (4 if use_mvs else 1)
    for k, v in out.items():
        assert v.dtype == ref[k].dtype and v.shape == ref[k].shape, k
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def _pngs(d: Path):
    return sorted(p.name for p in d.iterdir())


@pytest.mark.parametrize("static_only", [False, True])
def test_cli_workflow_without_volumes_or_scene_flow(tmp_path, static_only):
    run = tmp_path / "toy"
    # 7 frames (3 keyframes' worth), no validation in these 2 steps
    base = ["--config", str(TOY), "--save_dir", str(tmp_path), "--expname",
            "toy", "--max_train_steps", "2", "--log_every", "1",
            "--num_keyframes", "3", "--num_epochs", "4", "--N_vis", "2",
            "--device", "cpu",
            *(STATIC_ONLY if static_only else [])]
    assert train.main(base) == 0
    last = run / "ckpts" / "last"
    state = restore_path(last)
    assert state.step == 2
    assert ("nerf_dynamic.alpha_linear.bias" in state.params) != static_only
    assert ("enc_static.feature.conv0.0.conv.weight" in state.params) == \
        static_only
    with open(run / "metrics.csv", newline="") as f:
        rows = [r for r in csv.DictReader(f) if r.get("train_loss")]
    assert rows and all(np.isfinite(float(r["train_loss"])) for r in rows)
    assert bool(rows[0].get("render_loss")) == static_only
    assert bool(rows[0].get("sceneflow_loss")) != static_only

    assert test_cli.main([*base, "--ckpt", str(last)]) == 0
    metrics = (run / "test_metrics.txt").read_text().splitlines()
    assert [m.split(": ")[0] for m in metrics] == ["PSNR", "SSIM"]
    assert np.isfinite(float(metrics[0].split(": ")[1]))

    assert render_spiral.main([*base, "--ckpt", str(last), "--render_path",
                               "wander", "--frame_range", "3", "3",
                               "--n_poses", "2"]) == 0
    assert _pngs(run / "render_wanderpath_frame3") == [
        "depth_map_blend_00.png", "depth_map_blend_01.png",
        "rgb_map_blend_00.png", "rgb_map_blend_01.png"]


def test_static_only_validate_reads_the_static_maps(tmp_path):
    cfg, system, batch, params = presets.build(presets.SMALL_MVSNERF,
                                               presets.SMALL_SCENE, "cpu")
    ds = presets.scene_of(presets.SMALL_MVSNERF, presets.SMALL_SCENE)
    eval_fn = system.make_eval_step()
    assert set(eval_fn(params, batch)) == {"rgb_map", "depth_map"}
    out = train_loop.validate(cfg, system, eval_fn, params, [ds[3], ds[2]],
                              tmp_path, 7)
    assert list(out) == ["val_loss", "val_PSNR", "val_SSIM"]
    assert all(np.isfinite(v) for v in out.values())
    assert _pngs(tmp_path / "val_images") == [
        f"00000007_{i:02d}_{kind}.png" for i in range(2)
        for kind in ("depth", "err", "rgb")]


@pytest.mark.parametrize("family", sorted(presets.FAMILIES))
def test_checkpoint_round_trip_of_each_preset(tmp_path, family):
    config = presets.FAMILIES[family][0]
    cfg, system, _, params = presets.build(config, presets.SMALL_SCENE, "cpu")
    opt = system.make_optimizer(presets.STEPS_PER_EPOCH)
    opt_state = opt.init(params)
    opt_state["mu"] = {k: v + 0.5 for k, v in opt_state["mu"].items()}
    state = TrainState(params, opt_state, 5)
    CheckpointManager(tmp_path, cfg).save_last(state)
    got = restore_path(tmp_path / "last")
    assert got.step == 5 and got.opt_state["count"] == 0
    assert set(got.params) == set(system.state_dict()) == set(params)
    for k, v in params.items():
        assert torch.equal(got.params[k], v), k
        assert torch.equal(got.opt_state["mu"][k], opt_state["mu"][k]), k
    train_loop._check_like(got, state, tmp_path)
    # SVS's generator is MVSNeRF's: hold it against NSFF's
    other = "nsff" if family in ("mvsnerf", "svs") else "mvsnerf"
    other_system = ZestSystem(ZestConfig(**presets.FAMILIES[other][0]))
    other_params = other_system.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="does not fit"):
        train_loop._check_like(got, TrainState(other_params, {}, 0),
                               tmp_path)


@pytest.mark.parametrize("change,name", [
    (dict(net_type="v2"), "net_type='v2'"),
    (dict(train_video=True), "train_video"),
    (dict(use_color_volume=True), "use_color_volume"),
    (dict(precision=8), "precision=8"),
])
@pytest.mark.parametrize("family", ["mvsnerf", "nsff", "svs"])
def test_each_option_still_refused_raises_by_name(change, name, family):
    """Another precision is still refused by name. The three model
    options, refused before they were ported, now build the parameters of
    zest_tpu's system in the family, names and shapes; a v2 field without
    its volume (NSFF's fields), which zest_tpu cannot run, raises by
    name."""
    config = dict(presets.FAMILIES[family][0], **change)
    if "precision" in change:
        with pytest.raises(NotImplementedError, match=name):
            ZestSystem(ZestConfig(**config))
        return
    if family == "nsff" and "net_type" in change:
        with pytest.raises(ValueError, match="net_type='v2'.*use_mvs=False"):
            ZestSystem(ZestConfig(**config))
        return
    system = ZestSystem(ZestConfig(**config))
    sample = JSyntheticDataset(**presets.SMALL_SCENE,
                               use_mvs=config["use_mvs"],
                               use_mvs_dy=config.get("use_mvs_dy", False))[
        presets.TARGET_FRAME]
    assert {k: tuple(v.shape) for k, v in system.state_dict().items()} == \
        zest_tpu_shapes(config, sample)
    assert ("time_codes" in system.state_dict()) == ("train_video" in change)


def test_the_port_runs_all_89_configuration_files(tmp_path):
    """All 89 configuration files build the system the training loop
    builds for them (at width 64: the checks do not read the width), the
    20 SVS files their GAN system, given a seeded random LPIPS ``.npz``."""
    from zest_tpu_torch.config import config_parser
    from zest_tpu_torch.models.lpips import make_random_lpips_npz
    from zest_tpu_torch.system_gan import GanSystem
    make_random_lpips_npz(tmp_path / "lpips.npz", seed=0)
    files = sorted((REPO / "configs" / "config_files").glob("*.txt"))
    gan = []
    for path in files:
        cfg = config_parser(["--config", str(path), "--dataset_name",
                             "synthetic", "--netwidth", "64",
                             "--lpips_weights", str(tmp_path / "lpips.npz")])
        system = ZestSystem(cfg)
        if cfg.gan_type:
            GanSystem(system)
            gan.append(path.name)
    assert len(files) == 89 and len(gan) == 20
    assert all(name.startswith("config_svs_") for name in gan)
