"""The LLFF render paths and the entry points on real-data scenes, on the
CPU.

``create_spiral_poses`` / ``create_spheric_poses`` equal zest_tpu's;
``render_paths.run_llff_spiral`` renders an LLFF scene written by
``tools.scene_fixtures`` at tests/test_round2.py's toy configuration
(static field only, width 32), and its first image equals the port's own
``make_eval_path_step`` at that pose (zest_tpu's jitted path step is held
to the port's by tests/test_torch_paths.py). The command-line modules train
and render through the port's ``build_datasets``.
"""
import json

import numpy as np
import pytest
import torch
from PIL import Image

from zest_tpu.data import llff as jllff

from zest_tpu_torch import ZestConfig, render_paths, render_spiral, train
from zest_tpu_torch import train_loop
from zest_tpu_torch.checkpoint import CheckpointManager
from zest_tpu_torch.data import llff
from zest_tpu_torch.system import ZestSystem, to_batch
from zest_tpu_torch.tools import scene_fixtures as sf
from zest_tpu_torch.utils.visualize import visualize_depth

TOY = dict(expname="spiral", dataset_name="llff", finetune_scene="fern",
           train_sceneflow=False, use_mvs=False, use_mvs_dy=False, pad=0,
           netdepth=4, netwidth=32, multires=4, multires_views=2, N_samples=4,
           batch_size=16, chunk=512, eval_chunk=1024, imgScale_train=0.1,
           imgScale_test=0.1, pts_embedder=True, dir_embedder=True,
           use_viewdirs=True, num_epochs=1)


@pytest.fixture(scope="module")
def llff_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("llff")
    sf.write_llff_scene(root, "fern", n_views=8, size=(96, 64))
    return root


@pytest.mark.parametrize("n_poses", [1, 5, 120])
def test_llff_pose_generators_equal_zest_tpu(n_poses):
    radii = np.array([0.3, 0.2, 0.1])
    np.testing.assert_array_equal(
        llff.create_spiral_poses(radii, 3.5, n_poses),
        jllff.create_spiral_poses(radii, 3.5, n_poses))
    np.testing.assert_array_equal(llff.create_spheric_poses(1.7, n_poses),
                                  jllff.create_spheric_poses(1.7, n_poses))


def _png(path):
    return np.asarray(Image.open(path).convert("RGB"))


def _u8(img):
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


@pytest.mark.parametrize("spheric", [False, True])
def test_run_llff_spiral_renders_the_path_step(llff_root, tmp_path, spheric,
                                                capsys):
    cfg = ZestConfig(**TOY, datadir=str(llff_root), save_dir=str(tmp_path))
    out = render_paths.run_llff_spiral(cfg, n_poses=2, spheric=spheric,
                                       device="cpu")
    assert out == tmp_path / "spiral" / ("render_spheric" if spheric
                                         else "render_spiral")
    assert sorted(p.name for p in out.iterdir()) == [
        "depth_000.png", "depth_001.png", "rgb_000.png", "rgb_001.png"]
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["poses"] == 2 and printed["out"] == str(out)

    # the first pose, rendered by the path step itself
    ds = train_loop.build_datasets(cfg, ("test",))["test"]
    c2ws_all = ds.cam2worlds["fern"]
    if spheric:
        radius = 1.1 * float(np.min(np.linalg.norm(c2ws_all[:, :3, 3],
                                                    axis=-1)))
        pose = llff.create_spheric_poses(radius, 2)[0]
    else:
        radii = np.percentile(np.abs(c2ws_all[:, :3, 3]), 90, axis=0)
        pose = llff.create_spiral_poses(radii, 3.5, 2)[0]
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3] = pose
    w2c = np.linalg.inv(c2w).astype(np.float32)
    system = ZestSystem(cfg)
    params = system.init_params(torch.Generator().manual_seed(0))
    maps = system.make_eval_path_step()(params, to_batch(ds[0], "cpu"),
                                        torch.as_tensor(c2w)[None],
                                        torch.as_tensor(w2c)[None])
    rgb, depth = maps["rgb_map"][0].numpy(), maps["depth_map"][0].numpy()
    assert rgb.shape == (64, 96, 3) and float(rgb.std()) > 0
    np.testing.assert_array_equal(_png(out / "rgb_000.png"), _u8(rgb))
    np.testing.assert_array_equal(_png(out / "depth_000.png"),
                                  _u8(visualize_depth(depth)))


def _spy(monkeypatch, *modules):
    """Record the dataset_name of every build_datasets call."""
    seen = []
    real = train_loop.build_datasets

    def spy(cfg, *a, **k):
        seen.append(cfg.dataset_name)
        return real(cfg, *a, **k)

    for m in modules:
        monkeypatch.setattr(m, "build_datasets", spy)
    return seen


def test_render_spiral_cli_on_an_llff_scene(llff_root, tmp_path, monkeypatch):
    """``--render_path spiral`` (and ``auto`` on LLFF) render through the
    port's build_datasets; ``spheric`` on a scene without LLFF cameras is
    refused; without a card the module exits with 2."""
    seen = _spy(monkeypatch, render_paths)
    base = ["--datadir", str(llff_root), "--save_dir", str(tmp_path),
            "--n_poses", "2", "--device", "cpu"]
    base += [f"--{k}={v}" for k, v in TOY.items()]
    assert render_spiral.main([*base, "--render_path", "spiral"]) == 0
    assert render_spiral.main([*base, "--expname", "auto"]) == 0
    assert seen == ["llff", "llff"]
    for name in ("spiral", "auto"):
        assert len(list((tmp_path / name / "render_spiral").iterdir())) == 4
    with pytest.raises(ValueError, match="LLFF-format"):
        render_spiral.main([*base, "--dataset_name", "synthetic",
                            "--render_path", "spheric"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert render_spiral.main([a for a in base if a not in ("--device", "cpu")]
                              + ["--render_path", "spiral"]) == 2


@pytest.mark.parametrize("kind", ["nsff", "llff"])
def test_train_cli_on_a_real_scene(tmp_path, monkeypatch, llff_root, kind):
    """Two training steps through the port's build_datasets: the toy
    scene-flow configuration on a 4-frame NSFF scene of 64x32, and
    MVSNeRF's static field (3 source views) on the LLFF scene, whose
    samples carry no time, flow or motion keys."""
    if kind == "nsff":
        sf.write_nsff_scene(tmp_path / "data", "toy", n_frames=4,
                            size=(64, 32))
        args = ["--config", "configs/toy_synthetic_mvs.txt", "--datadir",
                str(tmp_path / "data"), "--finetune_scene", "toy",
                "--num_keyframes", "4"]
    else:
        args = [f"--{k}={v}" for k, v in TOY.items()] + [
            "--datadir", str(llff_root), "--use_mvs", "True", "--pad", "4",
            "--log_every", "1", "--max_train_steps", "2"]
    seen = _spy(monkeypatch, train_loop)
    # 4 epochs, a validation every 2: these two steps validate nothing
    assert train.main(args + ["--dataset_name", kind, "--save_dir",
                              str(tmp_path), "--expname", kind,
                              "--num_epochs", "4", "--N_vis", "2",
                              "--device", "cpu"]) == 0
    assert seen == [kind]
    state = CheckpointManager(tmp_path / kind / "ckpts").restore("last")
    assert state.step == 2
    assert all(bool(torch.isfinite(v).all()) for v in state.params.values())
    rows = (tmp_path / kind / "metrics.csv").read_text().splitlines()
    assert rows[0].startswith("step,") and len(rows) >= 2
