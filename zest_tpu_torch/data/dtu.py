"""The DTU MVS loader of the static generalizable path (counterpart of
``zest_tpu.data.dtu``). Host-side NumPy and PIL.

MVSNet's DTU layout: ``Cameras/train/<vid:08d>_cam.txt`` (extrinsics,
intrinsics at 1/4 resolution, depth min and interval),
``Rectified/<scan>_train/rect_<vid+1:03d>_<light>_r5000.png`` (lights 0-6
at train, light 3 otherwise) and ``Depths/<scan>/depth_map_<vid:04d>.pfm``
(halved, cropped to [44:556, 80:720]; zeros where the file is missing);
depths and translations times 1/200. The scans come from
``<config_dir>/lists/dtu_<split>_all.txt``, the view pairs from
``<config_dir>/dtu_pairs.txt``; the source views are the 5 nearest
(``closest_views``) or the 10 farthest cameras by the angle of their
translations, of which a training sample takes 3 at random (the loader's
``np.random.default_rng(seed)``) and an eval sample the first 3.

``closest_views`` is a constructor argument, as ``zest_tpu`` has it: the
reference reads it without ever setting it.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .common import imagenet_normalize, resize_image
from .pfm import read_pfm
from .pose_utils import get_nearest_pose_ids


class DTUDataset:
    """Samples of the DTU scans: one per (scan, light, reference view), the
    3 source views and the target in ``images``, each view's depth in
    ``depths_h`` and the target's in ``depths``. Images keep their file's
    size times ``downSample`` unless ``img_wh`` is given."""

    def __init__(self, root_dir, config_dir, split="train", n_views=3,
                 downSample=1.0, max_len=-1, closest_views=False, img_wh=None,
                 seed=None, **_):
        self.root_dir = Path(root_dir)
        self.config_dir = Path(config_dir)
        self.split = split
        self.img_wh = img_wh
        self.downSample = downSample
        self.scale_factor = 1.0 / 200
        self.max_len = max_len
        self.closest_views = closest_views
        self.rng = np.random.default_rng(seed)
        if img_wh is not None:
            assert img_wh[0] % 32 == 0 and img_wh[1] % 32 == 0
        self._build_metas()
        self._build_proj_mats()

    def _build_metas(self):
        self.metas = []
        scans_file = self.config_dir / f"lists/dtu_{self.split}_all.txt"
        self.scans = [l.strip() for l in scans_file.read_text().splitlines()
                      if l.strip()]
        light_idxs = [3] if self.split != "train" else range(7)
        id_list = []
        pairs = (self.config_dir / "dtu_pairs.txt").read_text().splitlines()
        for scan in self.scans:
            n_viewpoints = int(pairs[0])
            for v in range(n_viewpoints):
                ref_view = int(pairs[1 + 2 * v])
                src_views = [int(x) for x in pairs[2 + 2 * v].split()[1::2]]
                for light in light_idxs:
                    self.metas.append((scan, light, ref_view, src_views))
                    id_list.append([ref_view] + src_views)
        self.id_list = np.unique(id_list)
        self.remap = np.zeros(self.id_list.max() + 1, int)
        for i, item in enumerate(self.id_list):
            self.remap[item] = i

    def _read_cam_file(self, path):
        lines = Path(path).read_text().splitlines()
        extr = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ") \
            .reshape(4, 4)
        intr = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ") \
            .reshape(3, 3)
        depth_min = float(lines[11].split()[0]) * self.scale_factor
        depth_max = depth_min + float(lines[11].split()[1]) * 192 * self.scale_factor
        return intr, extr, [depth_min, depth_max]

    def _build_proj_mats(self):
        pms, intrs, w2cs, c2ws, nfs = [], [], [], [], []
        for vid in self.id_list:
            intr, extr, near_far = self._read_cam_file(
                self.root_dir / "Cameras/train" / f"{vid:08d}_cam.txt")
            intr[:2] *= 4                 # the files are at 1/4 resolution
            extr[:3, 3] *= self.scale_factor
            intr[:2] *= self.downSample
            intrs.append(intr.copy())
            intr[:2] /= 4
            pm = np.eye(4, dtype=np.float32)
            pm[:3, :4] = intr @ extr[:3, :4]
            pms.append(pm)
            nfs.append(near_far)
            w2cs.append(extr)
            c2ws.append(np.linalg.inv(extr))
        self.proj_mats = np.stack(pms)
        self.near_fars_all = np.array(nfs, np.float32)
        self.intrinsics = np.stack(intrs)
        self.world2cams = np.stack(w2cs)
        self.cam2worlds = np.stack(c2ws)

    def _read_depth(self, path):
        depth_h = read_pfm(path)[0].astype(np.float32)
        H, W = depth_h.shape
        depth_h = resize_image(depth_h, (W // 2, H // 2), "nearest")
        depth_h = depth_h[44:556, 80:720]
        if self.downSample != 1.0:
            h, w = depth_h.shape
            depth_h = resize_image(depth_h, (int(w * self.downSample),
                                             int(h * self.downSample)), "nearest")
        return depth_h

    def __len__(self):
        return len(self.metas) if self.max_len <= 0 else self.max_len

    def __getitem__(self, idx):
        from PIL import Image
        scan, light, target_view, src_views = self.metas[idx]
        near_ids = get_nearest_pose_ids(self.cam2worlds[self.remap[target_view]],
                                        self.cam2worlds, len(self.cam2worlds),
                                        tar_id=int(self.remap[target_view]),
                                        angular_dist_method="vector")
        pool = near_ids[:5] if self.closest_views else near_ids[-10:]
        if self.split == "train":
            sel = self.rng.permutation(5)[:3]
            view_idx = [int(pool[i]) for i in sel]
        else:
            view_idx = [int(pool[i]) for i in range(3)]
        view_idx = view_idx + [int(self.remap[target_view])]

        imgs, depths_h, pms, intrs, w2cs, c2ws, nfs = [], [], [], [], [], [], []
        ref_proj_inv = None
        for i, ridx in enumerate(view_idx):
            vid = int(self.id_list[ridx])
            img_path = self.root_dir / f"Rectified/{scan}_train" / \
                f"rect_{vid + 1:03d}_{light}_r5000.png"
            img = Image.open(img_path)
            wh = self.img_wh or tuple(np.round(np.array(img.size)
                                               * self.downSample).astype(int))
            img = np.asarray(img.resize(wh, Image.BILINEAR), np.float32) / 255.0
            imgs.append(imagenet_normalize(img))

            pm = self.proj_mats[ridx]
            if i == 0:
                ref_proj_inv = np.linalg.inv(pm)
                pms.append(np.eye(4, dtype=np.float32))
            else:
                pms.append(pm @ ref_proj_inv)
            intrs.append(self.intrinsics[ridx])
            w2cs.append(self.world2cams[ridx])
            c2ws.append(self.cam2worlds[ridx])
            nfs.append(self.near_fars_all[ridx])

            depth_path = self.root_dir / f"Depths/{scan}" / f"depth_map_{vid:04d}.pfm"
            if depth_path.exists():
                depths_h.append(self._read_depth(depth_path) * self.scale_factor)
            else:
                depths_h.append(np.zeros(imgs[-1].shape[:2], np.float32))

        return {
            "images": np.stack(imgs).astype(np.float32),
            "depths": depths_h[-1].astype(np.float32),
            "depths_h": np.stack(depths_h).astype(np.float32),
            "w2cs": np.stack(w2cs).astype(np.float32),
            "c2ws": np.stack(c2ws).astype(np.float32),
            "near_fars": np.stack(nfs).astype(np.float32),
            "proj_mats": np.stack(pms)[:, :3].astype(np.float32),
            "intrinsics": np.stack(intrs).astype(np.float32),
        }
