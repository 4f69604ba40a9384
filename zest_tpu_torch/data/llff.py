"""The LLFF forward-facing loader of the static (MVSNeRF) path and its
render paths (counterpart of ``zest_tpu.data.llff``). Host-side NumPy and
PIL.

A scene directory holds ``images_4/`` and ``poses_bounds.npy``. As
``zest_tpu`` builds it: poses centered, scaled so that the nearest bound
is 1 / 0.75, images at 960x640 times ``downSample``; the source views are
the 5 nearest (``closest_views``) or the 10 farthest cameras, of which a
training sample takes 3 at random and an eval sample the first 3. With
``depth_path`` a training sample's ``depths`` is a random PFM depth map of
another dataset (the depth discriminator's "real" samples), else zeros.

The loader's ``np.random.default_rng(seed)`` is drawn in ``__getitem__``,
first the view permutation, then the depth file, as ``zest_tpu`` draws it:
both packages give the same sample for the same seed.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .common import load_image
from .nsff import llff_cameras, source_views
from .pose_utils import get_nearest_pose_ids


def create_spiral_poses(radii, focus_depth, n_poses=120):
    """``n_poses`` c2w [P, 3, 4] (float32) on a spiral of ``radii`` (x, y,
    z), two turns, each looking at the point ``focus_depth`` ahead."""
    poses = []
    for t in np.linspace(0, 4 * np.pi, n_poses + 1)[:-1]:
        center = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * radii
        z = center - np.array([0, 0, -focus_depth])
        z = z / np.linalg.norm(z)
        y_ = np.array([0, 1, 0])
        x = np.cross(y_, z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        poses.append(np.stack([x, y, z, center], 1))
    return np.stack(poses).astype(np.float32)


def create_spheric_poses(radius, n_poses=120):
    """``n_poses`` c2w [P, 3, 4] (float32) on a circle of ``radius`` around
    the z axis, 36 degrees above it, each looking at the center."""
    def spheric_pose(theta, phi, r):
        trans_t = np.array([[1, 0, 0, 0], [0, 1, 0, -0.9 * r],
                            [0, 0, 1, r], [0, 0, 0, 1.0]])
        rot_phi = np.array([[1, 0, 0, 0],
                            [0, np.cos(phi), -np.sin(phi), 0],
                            [0, np.sin(phi), np.cos(phi), 0],
                            [0, 0, 0, 1.0]])
        rot_theta = np.array([[np.cos(theta), 0, -np.sin(theta), 0],
                              [0, 1, 0, 0],
                              [np.sin(theta), 0, np.cos(theta), 0],
                              [0, 0, 0, 1.0]])
        c2w = rot_theta @ rot_phi @ trans_t
        flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0],
                         [0, 1, 0, 0], [0, 0, 0, 1.0]])
        return (flip @ c2w)[:3]

    return np.stack([spheric_pose(th, -np.pi / 5, radius)
                     for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]]) \
        .astype(np.float32)


def nearest(a, oh, ow):
    """Nearest-neighbour resize of a 2D array to (oh, ow)."""
    yi = np.minimum((np.arange(oh) * a.shape[0] / oh).astype(np.int64),
                    a.shape[0] - 1)
    xi = np.minimum((np.arange(ow) * a.shape[1] / ow).astype(np.int64),
                    a.shape[1] - 1)
    return a[yi][:, xi]


class LLFFDataset:
    """Samples of the LLFF scenes under ``root_dir``: ``scene``, or the
    scenes of ``<config_dir>/lists/llff_<split>_all.txt``; one sample per
    view, the 3 source views and the target in ``images``."""

    def __init__(self, root_dir, config_dir=None, split="train", downSample=1.0,
                 max_len=-1, scene=None, depth_path=None, closest_views=False,
                 seed=None, **_):
        self.root_dir = Path(root_dir)
        self.config_dir = Path(config_dir) if config_dir else None
        self.split = split
        self.img_wh = (int(960 * downSample), int(640 * downSample))
        assert self.img_wh[0] % 32 == 0 or self.img_wh[1] % 32 == 0
        self.max_len = max_len
        self.closest_views = closest_views
        self.rng = np.random.default_rng(seed)
        self.depth_files = (sorted(Path(depth_path).glob("**/*.pfm"))
                            if depth_path else [])
        self._build_metas(scene)
        self._build_proj_mats()

    def _build_metas(self, scene):
        if scene is None:
            lst = self.config_dir / f"lists/llff_{self.split}_all.txt"
            self.scenes = [l.strip() for l in lst.read_text().splitlines()
                           if l.strip()]
        else:
            self.scenes = [scene]
        self.image_paths, self.metas = {}, []
        for sc in self.scenes:
            self.image_paths[sc] = sorted((self.root_dir / sc).glob("**/images_4/*"))
            for vid in range(len(self.image_paths[sc])):
                self.metas.append((sc, vid))

    def _build_proj_mats(self):
        self.proj_mats, self.intrinsics = {}, {}
        self.world2cams, self.cam2worlds, self.bounds = {}, {}, {}
        self.scale_factor = {}
        for sc in self.scenes:
            pb = np.load(self.root_dir / sc / "poses_bounds.npy")
            if self.split in ("train", "val"):
                assert len(pb) == len(self.image_paths[sc])
            cams = llff_cameras(pb, self.img_wh, lambda b: b.min() * 0.75)
            self.bounds[sc] = cams.bounds
            self.scale_factor[sc] = cams.scale
            self.proj_mats[sc] = cams.proj_mats
            self.intrinsics[sc] = cams.intrinsics
            self.world2cams[sc] = cams.w2cs
            self.cam2worlds[sc] = cams.c2ws

    def read_depth(self, filename):
        """A DTU depth map at ``img_wh``: the PFM nearest-halved, cropped to
        [44:556, 80:720], nearest-resized by ``downSample``, then to
        ``img_wh`` (NumPy nearest resizes, as ``zest_tpu`` takes them)."""
        from .pfm import read_pfm
        depth = np.asarray(read_pfm(filename)[0], dtype=np.float32)
        depth = nearest(depth, depth.shape[0] // 2, depth.shape[1] // 2)
        depth = depth[44:556, 80:720]
        down = self.img_wh[0] / 960.0
        depth = nearest(depth, max(int(depth.shape[0] * down), 1),
                        max(int(depth.shape[1] * down), 1))
        return nearest(depth, self.img_wh[1], self.img_wh[0])

    def __len__(self):
        return len(self.metas) if self.max_len <= 0 else self.max_len

    def __getitem__(self, idx):
        sc, target = self.metas[idx]
        near_ids = get_nearest_pose_ids(self.cam2worlds[sc][target],
                                        self.cam2worlds[sc],
                                        len(self.cam2worlds[sc]), tar_id=target,
                                        angular_dist_method="dist")
        pool = near_ids[:5] if self.closest_views else near_ids[-10:]
        if self.split == "train":
            sel = self.rng.permutation(5)[:3]
            view_ids = [int(pool[i]) for i in sel] + [target]
        else:
            view_ids = [int(pool[i]) for i in range(3)] + [target]
        near_far = np.array([self.bounds[sc][view_ids].min() * 0.8,
                             self.bounds[sc][view_ids].max() * 1.2], np.float32)
        views = source_views(
            view_ids, self.intrinsics[sc], self.world2cams[sc],
            self.cam2worlds[sc], self.proj_mats[sc], near_far,
            lambda vid: load_image(self.image_paths[sc][vid], self.img_wh))

        W, H = self.img_wh
        if self.depth_files:
            fname = self.depth_files[int(self.rng.integers(len(self.depth_files)))]
            depths = self.read_depth(fname) * self.scale_factor[sc]
        else:
            depths = np.zeros((H, W), np.float32)
        return {**views, "depths": depths.astype(np.float32)}
