"""The NSFF dynamic-scene loader and its bullet-time orbit (counterpart of
``zest_tpu.data.nsff``). Host-side NumPy and PIL: a sample is a dict of
NumPy arrays with ``zest_tpu``'s keys, shapes and dtypes, which
``system.to_batch`` moves to the device.

A scene directory holds ``images/``, ``disp/*.npy`` (monocular disparity),
``motion_masks/``, ``flow_i1/*_{fwd,bwd}.npz`` (optical flow and its mask)
and ``dense/poses_bounds.npy`` (LLFF format). As ``zest_tpu`` builds it:

- the keyframes: every ``n // (num_keyframes - 1)``-th of the n frames;
- the scale: the 5th percentile of the near bounds times 0.9;
- a sample's near / far: [min x 0.8, max x 1.2] of its views' bounds;
- proj_mats of intrinsic/4 @ w2c relative to the first view; the temporal
  neighbours' proj_mats are the identity (the reference's quirk: the
  dynamic volume is built from unwarped neighbour features);
- the flow stored relative and returned in absolute pixels; the first
  frame has zero backward flow, the last zero forward flow;
- the motion mask through ``load_image``, thresholded at 1e-3, its first
  ``MOTION_COORDS_PAD`` coordinates (row-major) kept;
- a 60-pose wander path per frame.

``zest_tpu``'s ``warp_band_bound`` is not ported: the port's warp has no
band.
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np

from .common import (imagenet_normalize, load_image, pad_motion_coords,
                     resize_image, uv_grid)
from .pose_utils import center_poses


def wanderpath_poses(c2w, focal_y, num_frames: int = 60, max_disp: float = 48.0):
    """``num_frames`` c2w poses [P, 4, 4] (float32) on an orbit around the
    camera ``c2w``: pose i is c2w @ inv(T_i), T_i a translation by
    (sin, cos / 3, cos / 3) of 2 pi i / num_frames, times max_disp / focal_y."""
    max_trans = max_disp / focal_y
    out = []
    c2w = np.asarray(c2w)
    ref_pose = np.concatenate([c2w[:3, :4],
                               np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)
    for i in range(num_frames):
        x_t = max_trans * np.sin(2.0 * np.pi * i / num_frames)
        y_t = max_trans * np.cos(2.0 * np.pi * i / num_frames) / 3.0
        z_t = max_trans * np.cos(2.0 * np.pi * i / num_frames) / 3.0
        i_pose = np.eye(4)
        i_pose[:3, 3] = [x_t, y_t, z_t]
        out.append(ref_pose @ np.linalg.inv(i_pose))
    return np.stack(out).astype(np.float32)


class Cameras(NamedTuple):
    """An LLFF-format scene's cameras at a loader's image size."""
    c2ws: np.ndarray          # [N, 4, 4] float32
    w2cs: np.ndarray          # [N, 4, 4]
    intrinsics: np.ndarray    # [N, 3, 3] float32
    proj_mats: np.ndarray     # [N, 4, 4]: intrinsic/4 @ w2c
    bounds: np.ndarray        # [N, 2] near / far, divided by scale
    scale: float
    focal: list               # [fx, fy] at img_wh (float64)


def llff_cameras(pb, img_wh, scale) -> Cameras:
    """The cameras of an LLFF ``poses_bounds.npy`` array [N, 17] at
    ``img_wh``: poses centered, translations and bounds divided by
    ``scale`` (a number, or a function of the bounds [N, 2]). Every
    LLFF-format loader builds its cameras so."""
    poses = pb[:, :15].reshape(-1, 3, 5)
    bounds = pb[:, -2:]
    H, W, focal = poses[0, :, -1]
    focal = [focal * img_wh[0] / W, focal * img_wh[1] / H]
    poses = np.concatenate([poses[..., 1:2], -poses[..., :1],
                            poses[..., 2:4]], -1)
    poses, _ = center_poses(poses)
    scale = scale(bounds) if callable(scale) else scale
    bounds = bounds / scale
    poses = poses.copy()
    poses[..., 3] /= scale

    w, h = img_wh
    pms, intrs, w2cs, c2ws = [], [], [], []
    for idx in range(len(poses)):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3] = poses[idx]
        w2c = np.linalg.inv(c2w)
        c2ws.append(c2w)
        w2cs.append(w2c)
        intr = np.array([[focal[0], 0, w / 2], [0, focal[1], h / 2],
                         [0, 0, 1]], np.float32)
        intrs.append(intr)
        intr_feat = intr.copy()
        intr_feat[:2] /= 4.0          # the features' 4x downscale
        pm = np.eye(4, dtype=np.float32)
        pm[:3, :4] = intr_feat @ w2c[:3, :4]
        pms.append(pm)
    return Cameras(np.stack(c2ws), np.stack(w2cs), np.stack(intrs),
                   np.stack(pms), bounds, scale, focal)


def source_views(view_ids, intrinsics, w2cs, c2ws, proj_mats, near_far,
                 image_of):
    """The per-view arrays of a sample: images (``image_of(view)``,
    normalized), intrinsics, w2cs, c2ws, ``near_far`` for each view, and
    proj_mats relative to the first view (the identity for it)."""
    imgs, intrs, w2c, c2w, near_fars, pms = [], [], [], [], [], []
    ref_proj_inv = None
    for i, vid in enumerate(view_ids):
        intrs.append(intrinsics[vid])
        w2c.append(w2cs[vid])
        c2w.append(c2ws[vid])
        near_fars.append(near_far)
        pm = proj_mats[vid]
        if i == 0:
            ref_proj_inv = np.linalg.inv(pm)
            pms.append(np.eye(4, dtype=np.float32))
        else:
            pms.append(pm @ ref_proj_inv)
        imgs.append(imagenet_normalize(image_of(vid)))
    return {"images": np.stack(imgs).astype(np.float32),
            "w2cs": np.stack(w2c).astype(np.float32),
            "c2ws": np.stack(c2w).astype(np.float32),
            "near_fars": np.stack(near_fars),
            "proj_mats": np.stack(pms)[:, :3].astype(np.float32),
            "intrinsics": np.stack(intrs).astype(np.float32)}


class NSFFDataset:
    """Samples of the NSFF scenes under ``root_dir``: ``scene``, or the
    scenes of ``<config_dir>/lists/<crossval>_<split>.txt``. A sample is the
    keyframes (with ``use_mvs``) and the target in ``images``, the target's
    flow, masks, disparity and motion coordinates, its two flow neighbours'
    w2cs (``fnb_w2cs``), its wander path, and with ``use_mvs_dy`` the four
    temporal neighbours t-2j..t+2j (``nb_*``, j = ``frame_jump``)."""

    def __init__(self, root_dir, config_dir=None, split="train", crossval="NSFF",
                 downSample=1.0, max_len=-1, scene=None, closest_views=False,
                 use_mvs=False, use_mvs_dy=False, num_keyframes=10, frame_jump=1,
                 img_h=288, img_w=544, **_):
        self.root_dir = Path(root_dir)
        self.config_dir = Path(config_dir) if config_dir else None
        self.split = split
        self.use_mvs = use_mvs
        self.use_mvs_dy = use_mvs_dy
        self.num_keyframes = num_keyframes
        self.frame_jump = frame_jump
        self.img_wh = (int(img_w * downSample), int(img_h * downSample))
        assert self.img_wh[0] % 32 == 0 or self.img_wh[1] % 32 == 0, \
            "image size must be divisible by 32"
        self.max_len = max_len
        self._build_metas(scene, crossval)
        self._build_proj_mats()

    def _build_metas(self, scene, crossval):
        if scene is None:
            scene_list = self.config_dir / f"lists/{crossval}_{self.split}.txt"
            self.scenes = [l.strip() for l in scene_list.read_text().splitlines()
                           if l.strip()]
        else:
            self.scenes = [scene]
        self.image_paths, self.disp_paths, self.mask_paths = {}, {}, {}
        self.flow_fwd_paths, self.flow_bwd_paths = {}, {}
        self.metas, self.key_frames = [], {}
        for sc in self.scenes:
            sp = self.root_dir / sc
            self.image_paths[sc] = sorted(sp.glob("**/images/*"))
            self.disp_paths[sc] = sorted(sp.glob("**/disp/*"))
            self.mask_paths[sc] = sorted(sp.glob("**/motion_masks/*"))
            self.flow_fwd_paths[sc] = sorted(sp.glob("**/flow_i1/*_fwd.npz"))
            self.flow_bwd_paths[sc] = sorted(sp.glob("**/flow_i1/*_bwd.npz"))
            n = len(self.image_paths[sc])
            self.metas += [(sc, t, n) for t in range(n)]
            interval = n // (self.num_keyframes - 1)
            self.key_frames[sc] = list(range(0, n, interval))

    def _build_proj_mats(self):
        self.proj_mats, self.intrinsics = {}, {}
        self.world2cams, self.cam2worlds = {}, {}
        self.wander_c2w, self.wander_w2c = {}, {}
        self.bounds = {}
        for sc in self.scenes:
            pb = np.load(self.root_dir / sc / "dense" / "poses_bounds.npy")
            if self.split in ("train", "val"):
                assert len(pb) == len(self.image_paths[sc]), \
                    f"poses/images mismatch in {sc}"
            cams = llff_cameras(pb, self.img_wh,
                                lambda b: np.percentile(b[:, 0], 5) * 0.9)
            self.bounds[sc] = cams.bounds
            wander = [wanderpath_poses(c2w, cams.focal[1])
                      for c2w in cams.c2ws]
            self.proj_mats[sc] = cams.proj_mats
            self.intrinsics[sc] = cams.intrinsics
            self.world2cams[sc] = cams.w2cs
            self.cam2worlds[sc] = cams.c2ws
            self.wander_c2w[sc] = np.stack(wander)
            self.wander_w2c[sc] = np.stack([np.linalg.inv(p) for p in wander])

    def _read_flow(self, path):
        data = np.load(path)
        flow, mask = data["flow"], np.float32(data["mask"])
        flow = resize_image(flow, self.img_wh, "bilinear")
        mask = resize_image(mask, self.img_wh, "nearest")
        return flow, mask

    def __len__(self):
        return len(self.metas) if self.max_len <= 0 else self.max_len

    def _image(self, sc, vid):
        return load_image(self.image_paths[sc][vid], self.img_wh)

    def __getitem__(self, idx):
        sc, target, n_frames = self.metas[idx]
        jump = self.frame_jump
        view_ids = (self.key_frames[sc] if self.use_mvs else []) + [target]
        near_far = np.array([self.bounds[sc][view_ids].min() * 0.8,
                             self.bounds[sc][view_ids].max() * 1.2], np.float32)
        views = source_views(view_ids, self.intrinsics[sc],
                             self.world2cams[sc], self.cam2worlds[sc],
                             self.proj_mats[sc], near_far,
                             lambda vid: self._image(sc, vid))

        W, H = self.img_wh
        grid = uv_grid(H, W)
        if target == 0:
            flow_fwd, mask_fwd = self._read_flow(self.flow_fwd_paths[sc][target])
            flow_bwd = np.zeros_like(flow_fwd)
            mask_bwd = np.zeros_like(mask_fwd)
        elif target == n_frames - 1:
            flow_bwd, mask_bwd = self._read_flow(self.flow_bwd_paths[sc][target - 1])
            flow_fwd = np.zeros_like(flow_bwd)
            mask_fwd = np.zeros_like(mask_bwd)
        else:
            flow_fwd, mask_fwd = self._read_flow(self.flow_fwd_paths[sc][target])
            flow_bwd, mask_bwd = self._read_flow(self.flow_bwd_paths[sc][target - 1])
        flow_fwd = flow_fwd + grid
        flow_bwd = flow_bwd + grid

        disp = np.load(self.disp_paths[sc][target])
        disp = resize_image(disp, self.img_wh, "nearest")

        mask_img = load_image(self.mask_paths[sc][target], self.img_wh)[..., 0]
        mask_bin = (mask_img > 1e-3).astype(np.float32)
        coords = np.argwhere(mask_bin > 0.1).astype(np.float32)
        motion_coords, motion_count = pad_motion_coords(coords)

        sample = {
            **views,
            "depths": disp.astype(np.float32),
            "flow_fwd": flow_fwd.astype(np.float32),
            "flow_bwd": flow_bwd.astype(np.float32),
            "mask_fwd": mask_fwd.astype(np.float32),
            "mask_bwd": mask_bwd.astype(np.float32),
            "motion_coords": motion_coords,
            "motion_count": motion_count,
            "time": np.asarray(target, np.float32),
            "total_frames": np.asarray(n_frames, np.float32),
            "wander_path_c2w": self.wander_c2w[sc][target],
            "wander_path_w2c": self.wander_w2c[sc][target],
        }
        fnb = [max(target - jump, 0), min(target + jump, n_frames - 1)]
        sample["fnb_w2cs"] = np.stack([self.world2cams[sc][v] for v in fnb])

        if self.use_mvs_dy:
            nbs = [max(target - 2 * jump, 0), max(target - jump, 0),
                   min(target + jump, n_frames - 1),
                   min(target + 2 * jump, n_frames - 1)]
            sample["nb_imgs"] = np.stack([imagenet_normalize(
                self._image(sc, v)) for v in nbs]).astype(np.float32)
            sample["nb_w2cs"] = np.stack([self.world2cams[sc][v]
                                          for v in nbs]).astype(np.float32)
            sample["nb_intr"] = np.stack([self.intrinsics[sc][v] for v in nbs])
            # the reference's quirk: P @ P^-1, the identity
            sample["nb_proj_mats"] = np.stack(
                [np.eye(4, dtype=np.float32)[:3] for _ in nbs])
        return sample
