"""Path rendering and ``run_test`` of zest_tpu_torch against zest_tpu's on
the CPU, at ``presets.SMALL`` (3 keyframes, 32x64, depth-8 fields of width
64, 16 samples).

Both packages get the same weights (``convert.from_jax_params``, the alpha
bias of both fields raised by 1 so that the maps carry signal) and the same
numpy samples of the synthetic scene. The frame is 3 (``presets.
TARGET_FRAME``): frames 0, 1, 4, 5 and 8 put the top and bottom pixel rows
on a view's in-bounds edge, a tie that each package breaks its own way.

- ``wanderpath_poses`` and the scene's ``wander_path_*`` keys: bit for bit.
- ``make_eval_path_step`` on 3 poses (the target's own camera and orbit
  poses 15 and 45, the path's widest in x): rtol 1e-4, atol 1e-5, the eval
  slice's tolerance (``test_torch_eval_slice.py``); at the target's own
  pose the port's path step equals its ``make_eval_step`` bit for bit.
- ``run_wanderpath(frame_range=(3, 3), n_poses=4)`` and ``run_test``, each
  package from its own checkpoint of the same weights: the same PNG names,
  pixels within 1 LSB, test metrics within the validation tolerances of
  ``test_torch_train_loop.py`` (PSNR 1e-3 dB, SSIM 1e-4).

zest_tpu's entry points draw fresh weights (``init_params``, ~80 s eagerly
on the CPU) before restoring the checkpoint over them; here they get zeros
of the same tree, so the restore alone puts the weights in.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from zest_tpu import render_paths as jpaths
from zest_tpu import train_loop as jloop
from zest_tpu.checkpoint import CheckpointManager as JCheckpointManager
from zest_tpu.config import ZestConfig as JZestConfig
from zest_tpu.data.nsff import wanderpath_poses as jwanderpath_poses
from zest_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from zest_tpu.system import ZestSystem as JZestSystem

from zest_tpu_torch import ZestConfig, presets, render_paths, train_loop
from zest_tpu_torch.checkpoint import CheckpointManager
from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.data.nsff import wanderpath_poses
from zest_tpu_torch.data.synthetic import SyntheticDataset
from zest_tpu_torch.system import EVAL_KEYS, TrainState, ZestSystem, to_batch

POSES = (15, 45)          # orbit poses beside the target's own camera
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests: the suite runs in
    several processes at once, and torch's small ops on oversubscribed
    thread pools run tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Frames:
    """The frames ``idx`` of a dataset, in that order."""

    def __init__(self, ds, idx):
        self.ds, self.idx = ds, list(idx)

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return self.ds[self.idx[i]]


@pytest.fixture(scope="module")
def jparams():
    sample = JSyntheticDataset(**presets.SMALL_SCENE)[presets.TARGET_FRAME]
    jbatch = {k: jnp.asarray(v) for k, v in sample.items()}
    params = jax.tree.map(np.asarray, jax.jit(
        JZestSystem(JZestConfig(**presets.SMALL)).init_params)(
            jax.random.PRNGKey(0), jbatch))
    for field in ("nerf_static", "nerf_dynamic"):
        alpha = params[field]["params"]["alpha_linear"]
        alpha["bias"] = alpha["bias"] + 1.0
    return params


@pytest.fixture(scope="module")
def path_maps(jparams):
    """(zest_tpu's maps, the port's maps, the port's eval-step maps, the
    poses) at frame 3 on the target's camera and the POSES."""
    sample = JSyntheticDataset(**presets.SMALL_SCENE)[presets.TARGET_FRAME]
    c2ws = np.stack([sample["c2ws"][-1]]
                    + [sample["wander_path_c2w"][i] for i in POSES])
    w2cs = np.stack([sample["w2cs"][-1]]
                    + [sample["wander_path_w2c"][i] for i in POSES])
    jbatch = {k: jnp.asarray(v) for k, v in sample.items()}
    ref = JZestSystem(JZestConfig(**presets.SMALL)).make_eval_path_step()(
        jparams, jbatch, jnp.asarray(c2ws), jnp.asarray(w2cs))
    system = ZestSystem(ZestConfig(**presets.SMALL))
    params = from_jax_params(jparams)
    batch = to_batch(sample, "cpu")
    out = system.make_eval_path_step()(params, batch, torch.from_numpy(c2ws),
                                       torch.from_numpy(w2cs))
    own = system.make_eval_step()(params, batch)
    return ({k: np.asarray(v) for k, v in ref.items()}, out, own)


@pytest.mark.parametrize("frame,focal,n", [(0, 76.8, 60), (3, 614.4, 60),
                                           (7, 100.0, 12)])
def test_wanderpath_poses_match_zest_tpu(frame, focal, n):
    c2w = SyntheticDataset(**presets.SMALL_SCENE)._pose(frame)
    got = wanderpath_poses(c2w, np.float32(focal), num_frames=n)
    want = jwanderpath_poses(c2w, np.float32(focal), num_frames=n)
    assert got.dtype == want.dtype == np.float32 and got.shape == (n, 4, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scene,frame", [
    (presets.SMALL_SCENE, presets.TARGET_FRAME),
    (presets.FLAGSHIP_SCENE, 20),
])
def test_synthetic_wander_path_keys_match_zest_tpu(scene, frame):
    got = SyntheticDataset(**scene)[frame]
    want = JSyntheticDataset(**scene)[frame]
    for k in ("wander_path_c2w", "wander_path_w2c"):
        assert got[k].dtype == want[k].dtype == np.float32, k
        assert got[k].shape == (60, 4, 4), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_eval_path_step_matches_zest_tpu(path_maps):
    ref, out, _ = path_maps
    assert set(out) == set(EVAL_KEYS) == set(ref)
    for k in EVAL_KEYS:
        assert out[k].shape == ref[k].shape and ref[k].shape[:3] == (3, 32, 64), k
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    # the orbit moves the camera: each pose renders another image, apart
    # from the target's by over 10x the tolerance, so a pose put in the
    # wrong slot fails
    for k in ("rgb_map_ref", "depth_map_ref"):
        bound = 10 * (RTOL * float(np.abs(ref[k]).max()) + ATOL)
        for p in (1, 2):
            assert float(np.abs(ref[k][p] - ref[k][0]).max()) > bound, (k, p)
    assert float(np.std(ref["rgb_map_ref"])) > 1e-3


def test_eval_path_step_at_the_target_pose_is_the_eval_step(path_maps):
    _, out, own = path_maps
    for k in EVAL_KEYS:
        assert torch.equal(out[k][0], own[k]), k


def _cfg(tmp_path, tag, **kw):
    return dict(presets.SMALL, dataset_name="synthetic",
                save_dir=str(tmp_path / tag), expname="run", **kw)


def _save_both(tmp_path, jparams):
    """zest_tpu's and the port's checkpoints of jparams: (ckpt paths)."""
    jcfg = JZestConfig(**_cfg(tmp_path, "ref"))
    jopt = JZestSystem(jcfg).make_optimizer(1)
    jstate = (jax.tree.map(jnp.asarray, jparams),
              jopt.init(jax.tree.map(jnp.asarray, jparams)), jnp.asarray(0))
    jmgr = JCheckpointManager(tmp_path / "ref_ckpts", jcfg)
    jmgr.save_last(jstate)

    cfg = ZestConfig(**_cfg(tmp_path, "port"))
    params = from_jax_params(jparams)
    opt = ZestSystem(cfg).make_optimizer(1)
    CheckpointManager(tmp_path / "port_ckpts", cfg).save_last(
        TrainState(params, opt.init(params), 0))
    return str(tmp_path / "ref_ckpts" / "last"), str(tmp_path / "port_ckpts"
                                                       / "last")


def _zero_init(monkeypatch, jparams):
    zeros = jax.tree.map(jnp.zeros_like, jparams)
    monkeypatch.setattr(JZestSystem, "init_params",
                        lambda self, key, batch: zeros)


def _assert_pngs_close(got_dir: Path, want_dir: Path, n: int):
    names = sorted(p.name for p in want_dir.iterdir())
    assert names == sorted(p.name for p in got_dir.iterdir())
    assert len(names) == n
    for name in names:
        got = np.asarray(Image.open(got_dir / name), np.int16)
        want = np.asarray(Image.open(want_dir / name), np.int16)
        assert got.shape == want.shape == (32, 64, 3), name
        assert int(np.abs(got - want).max()) <= 1, name


def test_run_wanderpath_matches_zest_tpu(monkeypatch, tmp_path, jparams):
    jckpt, ckpt = _save_both(tmp_path, jparams)
    _zero_init(monkeypatch, jparams)
    jpaths.run_wanderpath(JZestConfig(**_cfg(tmp_path, "ref", ckpt=jckpt)),
                          frame_range=(3, 3), n_poses=4, quiet=True)
    render_paths.run_wanderpath(ZestConfig(**_cfg(tmp_path, "port", ckpt=ckpt)),
                                frame_range=(3, 3), n_poses=4, quiet=True,
                                device="cpu")
    sub = Path("run") / "render_wanderpath_frame3"
    got_dir, want_dir = tmp_path / "port" / sub, tmp_path / "ref" / sub
    _assert_pngs_close(got_dir, want_dir, 8)
    assert (got_dir / "rgb_map_blend_03.png").exists()
    assert (got_dir / "depth_map_blend_00.png").exists()
    rgb = [np.asarray(Image.open(got_dir / f"rgb_map_blend_{i:02d}.png"))
           for i in range(4)]
    assert np.std(rgb[0]) > 1 and not np.array_equal(rgb[0], rgb[3])


def test_run_test_matches_zest_tpu(monkeypatch, tmp_path, jparams):
    jckpt, ckpt = _save_both(tmp_path, jparams)
    _zero_init(monkeypatch, jparams)
    frames = (3, 2)
    ref = jloop.run_test(
        JZestConfig(**_cfg(tmp_path, "ref", ckpt=jckpt)), quiet=True,
        datasets={"test": Frames(JSyntheticDataset(**presets.SMALL_SCENE),
                                 frames)})
    out = train_loop.run_test(
        ZestConfig(**_cfg(tmp_path, "port", ckpt=ckpt)), quiet=True,
        device="cpu", datasets={"test": Frames(
            SyntheticDataset(**presets.SMALL_SCENE), frames)})
    assert list(out) == list(ref)
    np.testing.assert_allclose(out["val_loss"], ref["val_loss"], rtol=1e-4)

    def read(tag):
        text = (tmp_path / tag / "run" / "test_metrics.txt").read_text()
        return {k: float(v) for k, v in
                (line.split(": ") for line in text.splitlines())}
    got, want = read("port"), read("ref")
    assert list(got) == list(want) == ["PSNR", "SSIM"]
    assert abs(got["PSNR"] - want["PSNR"]) < 1e-3
    assert abs(got["SSIM"] - want["SSIM"]) <= 1e-4 * max(1.0, abs(want["SSIM"]))
    assert got["PSNR"] == out["val_PSNR"] and 5.0 < got["PSNR"] < 60.0
    _assert_pngs_close(tmp_path / "port" / "run" / "test_images",
                       tmp_path / "ref" / "run" / "test_images", 6)


def test_run_test_warns_without_ckpt_and_refuses_vis_cnn(tmp_path):
    ds = {"test": Frames(SyntheticDataset(**presets.SMALL_SCENE), [3])}
    with pytest.warns(UserWarning, match="without --ckpt"):
        out = train_loop.run_test(ZestConfig(**_cfg(tmp_path, "port")),
                                  datasets=ds, quiet=True, device="cpu")
    assert np.isfinite(out["val_PSNR"])
    assert (tmp_path / "port" / "run" / "test_metrics.txt").exists()
    # vis_cnn is no longer refused: it dumps the static encoder first and
    # leaves the metrics as they were
    vis = tmp_path / "vis"
    with pytest.warns(UserWarning, match="without --ckpt"):
        again = train_loop.run_test(
            ZestConfig(**_cfg(tmp_path, "port", vis_cnn=True,
                              save_test=str(vis))),
            datasets=ds, quiet=True, device="cpu")
    assert again == out
    assert (vis / "cost_vol" / "tensors" / "volume_feat.npy").exists()
    assert (vis / "2cnn_vis" / "tensors" / "feature.conv0_0.bn.npy").exists()
    assert (vis / "3cnn_vis" / "feat2viz" / "cost_reg_2.conv7.png").exists()
