"""Novel-view path rendering (counterpart of ``zest_tpu.render_paths``):
the bullet-time wander path and the LLFF spiral and spheric paths.

``run_wanderpath``: for each test frame in ``frame_range``, the target
camera moves over the frame's 60 orbit poses (``wander_path_c2w`` /
``wander_path_w2c``, ``data.nsff.wanderpath_poses``) and each full image is
saved as an RGB and a depth PNG. ``run_llff_spiral``: the first test
sample's target camera moves along a spiral (forward-facing) or a circle
(360 degrees) around the scene's cameras (``data.llff.create_spiral_poses``
/ ``create_spheric_poses``). Either way the sample's encoding volumes are
built once for all its poses (``ZestSystem.make_eval_path_step``).
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from .checkpoint import restore_path
from .system import ZestSystem, to_batch
from .train_loop import build_datasets
from .utils.visualize import save_image, visualize_depth


def _weights(cfg, system, device) -> dict:
    """The weights of ``cfg.ckpt`` on ``device``, or fresh weights of seed 0
    without it."""
    if cfg.ckpt:
        return restore_path(cfg.ckpt, device).params
    return {k: v.to(device) for k, v in
            system.init_params(torch.Generator().manual_seed(0)).items()}


def run_wanderpath(cfg, frame_range=(20, 51), n_poses=None, quiet=False,
                   device="cuda"):
    """Render the wander path of every test frame with index in
    ``frame_range`` (both ends included), its first ``n_poses`` poses (all
    60 by default), with the weights of ``cfg.ckpt`` (fresh weights of seed
    0 without it), into ``<save_dir>/<expname>/render_wanderpath_frame{t}/``
    as ``rgb_map_blend_{i:02d}.png`` and ``depth_map_blend_{i:02d}.png``
    (depth over [2, 6])."""
    device = torch.device(device)
    test_ds = build_datasets(cfg, splits=("test",))["test"]
    save_root = Path(cfg.save_dir) / cfg.expname

    system = ZestSystem(cfg).to(device)
    params = _weights(cfg, system, device)
    eval_fn = system.make_eval_path_step()
    key = "rgb_map_ref" if cfg.train_sceneflow else "rgb_map"
    dkey = "depth_map_ref" if cfg.train_sceneflow else "depth_map"
    lo, hi = frame_range
    for idx in range(max(lo, 0), min(hi + 1, len(test_ds))):
        batch = to_batch(test_ds[idx], device)
        frame_t = int(batch["time"])
        out_dir = save_root / f"render_wanderpath_frame{frame_t}"
        out_dir.mkdir(parents=True, exist_ok=True)
        poses_c2w, poses_w2c = batch["wander_path_c2w"], batch["wander_path_w2c"]
        n = len(poses_c2w) if n_poses is None else min(n_poses, len(poses_c2w))
        maps = eval_fn(params, batch, poses_c2w[:n], poses_w2c[:n])
        rgbs = np.clip(maps[key].cpu().numpy(), 0, 1)
        depths = maps[dkey].cpu().numpy()
        for i in range(n):
            save_image(out_dir / f"rgb_map_blend_{i:02d}.png", rgbs[i])
            save_image(out_dir / f"depth_map_blend_{i:02d}.png",
                       visualize_depth(depths[i], [2.0, 6.0]))
        if not quiet:
            print(json.dumps({"frame": frame_t, "poses": n,
                              "out": str(out_dir)}), flush=True)


def run_llff_spiral(cfg, n_poses: int = 60, spheric: bool = False,
                    quiet=False, device="cuda"):
    """Render ``n_poses`` poses of an LLFF-format scene's spiral (or, with
    ``spheric``, its circle) with the first test sample's source views and
    the weights of ``cfg.ckpt`` (fresh weights of seed 0 without it), into
    ``<save_dir>/<expname>/render_spiral/`` (``render_spheric/``) as
    ``rgb_{i:03d}.png`` and ``depth_{i:03d}.png``: the blended maps with
    ``train_sceneflow``, else the static field's. Returns the directory.

    The spiral's radii are the 90th percentile of the scene's |camera
    translation| per axis and its focus depth 3.5 (the scaled scene's); the
    circle's radius is 1.1 x the smallest camera distance from the center.
    The printed JSON line gives the poses, the directory and the seconds of
    the render (the volumes' build, every pose and the maps' copy to the
    host)."""
    from .data.llff import create_spheric_poses, create_spiral_poses
    device = torch.device(device)
    test_ds = build_datasets(cfg, splits=("test",))["test"]
    if not isinstance(getattr(test_ds, "cam2worlds", None), dict):
        raise ValueError(f"--render_path {'spheric' if spheric else 'spiral'}"
                         f" needs an LLFF-format scene's cameras; "
                         f"dataset_name={cfg.dataset_name!r} has none")
    save_root = Path(cfg.save_dir) / cfg.expname

    system = ZestSystem(cfg).to(device)
    params = _weights(cfg, system, device)
    batch = to_batch(test_ds[0], device)
    c2ws_all = np.asarray(test_ds.cam2worlds[test_ds.metas[0][0]])
    if spheric:
        radius = 1.1 * float(np.min(np.linalg.norm(c2ws_all[:, :3, 3], axis=-1)))
        path = create_spheric_poses(radius, n_poses)
    else:
        radii = np.percentile(np.abs(c2ws_all[:, :3, 3]), 90, axis=0)
        path = create_spiral_poses(radii, focus_depth=3.5, n_poses=n_poses)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (len(path), 1, 1))
    c2ws[:, :3] = path
    w2cs = np.linalg.inv(c2ws).astype(np.float32)

    out_dir = save_root / ("render_spheric" if spheric else "render_spiral")
    out_dir.mkdir(parents=True, exist_ok=True)
    key = "rgb_map_ref" if cfg.train_sceneflow else "rgb_map"
    dkey = "depth_map_ref" if cfg.train_sceneflow else "depth_map"
    t0 = time.perf_counter()
    maps = system.make_eval_path_step()(
        params, batch, torch.as_tensor(c2ws, device=device),
        torch.as_tensor(w2cs, device=device))
    rgbs = np.clip(maps[key].cpu().numpy(), 0, 1)
    depths = maps[dkey].cpu().numpy()
    render_s = time.perf_counter() - t0
    for i in range(len(path)):
        save_image(out_dir / f"rgb_{i:03d}.png", rgbs[i])
        save_image(out_dir / f"depth_{i:03d}.png", visualize_depth(depths[i]))
    if not quiet:
        print(json.dumps({"poses": len(path), "out": str(out_dir),
                          "render_s": render_s}), flush=True)
    return out_dir
