"""Synthetic dynamic scene: the eval and training steps' inputs without any
data on disk.

The same scene as ``zest_tpu.data.synthetic`` (smooth procedural images, a
small camera arc, proj_mats of intrinsic/4 @ w2c relative to the first
keyframe, identity neighbour proj_mats, the pixel grid as optical flow), cut
to the keys the eval and training steps and the wander path read. NumPy
only; deterministic per (frame, seed). Each dataset builds each normalized
frame once and keeps it (read-only), since every sample stacks 13 of them at
the flagship size.
"""
from __future__ import annotations

import numpy as np

from .common import IMAGENET_MEAN, IMAGENET_STD, MOTION_COORDS_PAD
from .nsff import wanderpath_poses


def _procedural_image(H, W, t, seed=0):
    """Smooth time-varying pattern in [0, 1]: sums of shifted sinusoids."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.zeros((H, W, 3), np.float32)
    for c in range(3):
        f1, f2 = rng.uniform(1, 4, 2)
        p1, p2 = rng.uniform(0, 2 * np.pi, 2)
        img[..., c] = 0.5 + 0.25 * np.sin(2 * np.pi * f1 * xx / W + p1 + 0.3 * t) \
            + 0.25 * np.cos(2 * np.pi * f2 * yy / H + p2 + 0.2 * t)
    return np.clip(img, 0.0, 1.0)


def _normalized_image(H, W, t, seed):
    return (_procedural_image(H, W, t, seed) - IMAGENET_MEAN) / IMAGENET_STD


class SyntheticDataset:
    """Samples of a tiny synthetic dynamic scene: the keyframes plus the
    target in ``images``, the four temporal neighbours t-2..t+2 of the
    dynamic volume in ``nb_*``, the training keys and the target's 60-pose
    wander path.

    The constructor takes ``zest_tpu``'s arguments, so that
    ``train_loop.build_datasets`` builds it as ``zest_tpu`` does: the
    directories, the split and the loader options of real scenes are not
    read, and ``max_len`` > 0 cuts the length. Without ``use_mvs`` a sample
    has no keyframes (``images`` holds the target alone), and without
    ``use_mvs_dy`` no ``nb_*`` keys, as ``zest_tpu``'s builds it."""

    def __init__(self, root_dir=None, config_dir=None, split="train", *,
                 img_h=48, img_w=64, num_frames=None, num_keyframes=4,
                 use_mvs=True, use_mvs_dy=True, seed=0, max_len=-1, **_):
        if num_frames is None:
            num_frames = 3 * (num_keyframes - 1) + 1
        self.H, self.W = img_h, img_w
        self.num_frames = num_frames
        self.use_mvs, self.use_mvs_dy = use_mvs, use_mvs_dy
        self.seed = seed
        self.max_len = max_len
        f = 1.2 * img_w
        self.intrinsic = np.array([[f, 0, img_w / 2],
                                   [0, f, img_h / 2],
                                   [0, 0, 1]], np.float32)
        interval = max(num_frames // max(num_keyframes - 1, 1), 1)
        self.key_frames = list(range(0, num_frames, interval))[:num_keyframes]
        self._frames: dict = {}

    def __len__(self):
        return self.num_frames if self.max_len <= 0 else self.max_len

    def _pose(self, frame):
        """Camera on a small x-axis arc; c2w [4, 4]."""
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3] = 0.05 * np.sin(2 * np.pi * frame / self.num_frames)
        c2w[1, 3] = 0.03 * np.cos(2 * np.pi * frame / self.num_frames)
        return c2w

    def _image(self, frame):
        """The normalized frame, built on first use."""
        img = self._frames.get(frame)
        if img is None:
            img = _normalized_image(self.H, self.W, frame, self.seed)
            img.setflags(write=False)
            self._frames[frame] = img
        return img

    def _proj_mat(self, w2c):
        intr = self.intrinsic.copy()
        intr[:2] /= 4.0
        pm = np.eye(4, dtype=np.float32)
        pm[:3, :4] = intr @ w2c[:3, :4]
        return pm

    def __getitem__(self, idx):
        target = idx % self.num_frames
        nf = self.num_frames
        H, W = self.H, self.W
        imgs, w2cs, c2ws, proj_mats = [], [], [], []
        ref_proj_inv = None
        views = (self.key_frames if self.use_mvs else []) + [target]
        for i, vid in enumerate(views):
            c2w = self._pose(vid)
            w2c = np.linalg.inv(c2w)
            pm = self._proj_mat(w2c)
            if i == 0:
                ref_proj_inv = np.linalg.inv(pm)
                proj_mats.append(np.eye(4, dtype=np.float32))
            else:
                proj_mats.append(pm @ ref_proj_inv)
            imgs.append(self._image(vid))
            w2cs.append(w2c)
            c2ws.append(c2w)
        n_views = len(imgs)
        wander_c2w = wanderpath_poses(self._pose(target), self.intrinsic[1, 1])
        sample = {
            "images": np.stack(imgs).astype(np.float32),
            "depths": 0.5 + np.linspace(0, 1, H * W, dtype=np.float32)
                      .reshape(H, W),
            "w2cs": np.stack(w2cs).astype(np.float32),
            "c2ws": np.stack(c2ws).astype(np.float32),
            "near_fars": np.tile(np.array([2.0, 6.0], np.float32),
                                 (n_views, 1)),
            "proj_mats": np.stack(proj_mats)[:, :3].astype(np.float32),
            "intrinsics": np.stack([self.intrinsic] * n_views),
            "time": np.asarray(target, np.float32),
            "total_frames": np.asarray(nf, np.float32),
            "wander_path_c2w": wander_c2w,
            "wander_path_w2c": np.linalg.inv(wander_c2w).astype(np.float32),
            **self._training_keys(target),
        }
        if self.use_mvs_dy:
            # neighbour proj_mats are identity: the dynamic cost volume is
            # built from unwarped neighbour features, as the reference
            # builds it
            nbs = [max(target - 2, 0), max(target - 1, 0),
                   min(target + 1, nf - 1), min(target + 2, nf - 1)]
            sample.update({
                "nb_imgs": np.stack([self._image(v) for v in nbs]),
                "nb_w2cs": np.stack([np.linalg.inv(self._pose(v))
                                     for v in nbs]).astype(np.float32),
                "nb_intr": np.stack([self.intrinsic] * len(nbs)),
                "nb_proj_mats": np.tile(np.eye(4, dtype=np.float32)[:3],
                                        (len(nbs), 1, 1))})
        return sample

    def _training_keys(self, target):
        """What the training step reads beyond the eval keys: optical flow
        (the pixel grid itself) and its masks, the motion-mask coordinates
        (every pixel, row-major, padded to ``MOTION_COORDS_PAD``) and the
        w2c of the first temporal neighbours t-1 and t+1."""
        H, W, nf = self.H, self.W, self.num_frames
        flow = np.stack(np.mgrid[0:H, 0:W][::-1], -1).astype(np.float32)
        coords = np.argwhere(np.ones((H, W)))[:MOTION_COORDS_PAD]
        motion_coords = np.zeros((MOTION_COORDS_PAD, 2), np.float32)
        motion_coords[:len(coords)] = coords
        fnb = [max(target - 1, 0), min(target + 1, nf - 1)]
        return {
            "flow_fwd": flow,
            "flow_bwd": flow.copy(),
            "mask_fwd": np.ones((H, W), np.float32),
            "mask_bwd": np.ones((H, W), np.float32),
            "motion_coords": motion_coords,
            "motion_count": np.asarray(len(coords), np.int32),
            "fnb_w2cs": np.stack([np.linalg.inv(self._pose(v)) for v in fnb]),
        }
