"""The bullet-time orbit of the NSFF loader (counterpart of
``zest_tpu.data.nsff``'s ``wanderpath_poses``); the loader itself is not
ported yet. NumPy only."""
from __future__ import annotations

import numpy as np


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
