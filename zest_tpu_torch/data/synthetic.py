"""Synthetic dynamic scene: the eval step's inputs without any data on disk.

The same scene as ``zest_tpu.data.synthetic`` (smooth procedural images, a
small camera arc, proj_mats of intrinsic/4 @ w2c relative to the first
keyframe, identity neighbour proj_mats), cut to the keys the eval step reads.
NumPy only; deterministic per (frame, seed).
"""
from __future__ import annotations

import numpy as np

# ImageNet statistics every loader normalizes with
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


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
    """Eval samples of a tiny synthetic dynamic scene: the keyframes plus the
    target in ``images``, and the four temporal neighbours t-2..t+2 of the
    dynamic volume in ``nb_*``."""

    def __init__(self, *, img_h=48, img_w=64, num_frames=None,
                 num_keyframes=4, seed=0):
        if num_frames is None:
            num_frames = 3 * (num_keyframes - 1) + 1
        self.H, self.W = img_h, img_w
        self.num_frames = num_frames
        self.seed = seed
        f = 1.2 * img_w
        self.intrinsic = np.array([[f, 0, img_w / 2],
                                   [0, f, img_h / 2],
                                   [0, 0, 1]], np.float32)
        interval = max(num_frames // max(num_keyframes - 1, 1), 1)
        self.key_frames = list(range(0, num_frames, interval))[:num_keyframes]

    def __len__(self):
        return self.num_frames

    def _pose(self, frame):
        """Camera on a small x-axis arc; c2w [4, 4]."""
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3] = 0.05 * np.sin(2 * np.pi * frame / self.num_frames)
        c2w[1, 3] = 0.03 * np.cos(2 * np.pi * frame / self.num_frames)
        return c2w

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
        for i, vid in enumerate(self.key_frames + [target]):
            c2w = self._pose(vid)
            w2c = np.linalg.inv(c2w)
            pm = self._proj_mat(w2c)
            if i == 0:
                ref_proj_inv = np.linalg.inv(pm)
                proj_mats.append(np.eye(4, dtype=np.float32))
            else:
                proj_mats.append(pm @ ref_proj_inv)
            imgs.append(_normalized_image(H, W, vid, self.seed))
            w2cs.append(w2c)
            c2ws.append(c2w)
        n_views = len(imgs)
        # neighbour proj_mats are identity: the dynamic cost volume is built
        # from unwarped neighbour features, as the reference builds it
        nbs = [max(target - 2, 0), max(target - 1, 0),
               min(target + 1, nf - 1), min(target + 2, nf - 1)]
        return {
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
            "nb_imgs": np.stack([_normalized_image(H, W, v, self.seed)
                                 for v in nbs]).astype(np.float32),
            "nb_w2cs": np.stack([np.linalg.inv(self._pose(v))
                                 for v in nbs]).astype(np.float32),
            "nb_intr": np.stack([self.intrinsic] * len(nbs)),
            "nb_proj_mats": np.tile(np.eye(4, dtype=np.float32)[:3],
                                    (len(nbs), 1, 1)),
        }
