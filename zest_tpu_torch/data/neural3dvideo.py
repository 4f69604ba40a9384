"""The Neural 3D Video multi-camera loader (counterpart of
``zest_tpu.data.neural3dvideo``). Host-side NumPy and PIL.

A scene directory holds one directory of frames per camera (``cam00/``,
...) and one ``poses_bounds.npy`` (LLFF format, a row per camera). A
sample is a (camera, frame): the 3 source cameras (3 of the 5 nearest with
``closest_views``, else of the 8 farthest; at random with the loader's
``np.random.default_rng(seed)`` when training, else the first 3) and the
target in ``images`` at 960x640 times ``downSample``, with ``time``,
``total_frames`` and the ``keyframe_id`` that indexes the time codes. With
``train_key_frames`` only every ``keyframe_interval``-th frame is a sample.
As ``zest_tpu`` does, the keyframe table is reset for each camera, so the
last camera's frames are the table.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .common import load_image
from .nsff import llff_cameras, source_views
from .pose_utils import get_nearest_pose_ids


class Neural3DVideoDataset:
    def __init__(self, root_dir, config_dir=None, split="train", downSample=1.0,
                 max_len=-1, scene=None, closest_views=False,
                 train_key_frames=False, keyframe_interval=30, seed=None, **_):
        self.root_dir = Path(root_dir)
        self.config_dir = Path(config_dir) if config_dir else None
        self.split = split
        self.train_key_frames = train_key_frames
        self.keyframe_interval = keyframe_interval
        self.img_wh = (int(960 * downSample), int(640 * downSample))
        assert self.img_wh[0] % 32 == 0 or self.img_wh[1] % 32 == 0
        self.max_len = max_len
        self.closest_views = closest_views
        self.rng = np.random.default_rng(seed)
        self._build_metas(scene)
        self._build_proj_mats()

    def _build_metas(self, scene):
        if scene is None:
            lst = self.config_dir / f"lists/neural3Dvideo_{self.split}_all.txt"
            self.scenes = [l.strip() for l in lst.read_text().splitlines()
                           if l.strip()]
        else:
            self.scenes = [scene]
        self.image_paths, self.cameras, self.key_frames = {}, {}, {}
        self.metas = []
        for sc in self.scenes:
            sp = self.root_dir / sc
            self.cameras[sc] = sorted(c.stem for c in sp.glob("*")
                                      if c.stem != "poses_bounds")
            self.image_paths[sc] = {}
            for cam_id, cam in enumerate(self.cameras[sc]):
                self.image_paths[sc][cam] = sorted((sp / cam).glob("*"))
                n = len(self.image_paths[sc][cam])
                self.key_frames[sc] = {}
                interval = self.keyframe_interval if self.train_key_frames else 1
                for frame_id, frame_t in enumerate(range(0, n, interval)):
                    self.metas.append((sc, cam_id, frame_t, n))
                    self.key_frames[sc][frame_t] = frame_id

    def _build_proj_mats(self):
        self.proj_mats, self.intrinsics = {}, {}
        self.world2cams, self.cam2worlds, self.bounds = {}, {}, {}
        for sc in self.scenes:
            pb = np.load(self.root_dir / sc / "poses_bounds.npy")
            cams = llff_cameras(pb, self.img_wh, lambda b: b.min() * 0.75)
            self.bounds[sc] = cams.bounds
            self.proj_mats[sc] = cams.proj_mats
            self.intrinsics[sc] = cams.intrinsics
            self.world2cams[sc] = cams.w2cs
            self.cam2worlds[sc] = cams.c2ws

    def __len__(self):
        return len(self.metas) if self.max_len <= 0 else self.max_len

    def __getitem__(self, idx):
        sc, target_cam, frame_t, n_frames = self.metas[idx]
        near_ids = get_nearest_pose_ids(self.cam2worlds[sc][target_cam],
                                        self.cam2worlds[sc],
                                        len(self.cam2worlds[sc]),
                                        tar_id=target_cam,
                                        angular_dist_method="dist")
        pool = near_ids[:5] if self.closest_views else near_ids[-8:]
        if self.split == "train":
            sel = self.rng.permutation(5)[:3]
            view_ids = [int(pool[i]) for i in sel] + [target_cam]
        else:
            view_ids = [int(pool[i]) for i in range(3)] + [target_cam]
        near_far = np.array([self.bounds[sc][view_ids].min() * 0.8,
                             self.bounds[sc][view_ids].max() * 1.2], np.float32)
        views = source_views(
            view_ids, self.intrinsics[sc], self.world2cams[sc],
            self.cam2worlds[sc], self.proj_mats[sc], near_far,
            lambda vid: load_image(
                self.image_paths[sc][self.cameras[sc][vid]][frame_t],
                self.img_wh))

        W, H = self.img_wh
        return {
            **views,
            "depths": np.zeros((H, W), np.float32),
            "time": np.asarray(frame_t, np.float32),
            "total_frames": np.asarray(n_frames, np.float32),
            "keyframe_id": np.asarray(self.key_frames[sc][frame_t], np.int32),
        }
