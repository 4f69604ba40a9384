"""Novel-view path rendering: the bullet-time wander path (counterpart of
``zest_tpu.render_paths.run_wanderpath``).

For each test frame in ``frame_range``, the target camera moves over the
frame's 60 orbit poses (``wander_path_c2w`` / ``wander_path_w2c``,
``data.nsff.wanderpath_poses``) and each full image is saved as an RGB and a
depth PNG. The frame's encoding volumes are built once for all its poses
(``ZestSystem.make_eval_path_step``). The LLFF spiral and spheric paths are
not ported yet.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .checkpoint import restore_path
from .system import ZestSystem, to_batch
from .train_loop import build_datasets
from .utils.visualize import save_image, visualize_depth


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
    if cfg.ckpt:
        params = restore_path(cfg.ckpt, device).params
    else:
        params = {k: v.to(device) for k, v in
                  system.init_params(torch.Generator().manual_seed(0)).items()}
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
