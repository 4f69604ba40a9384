"""Pose math of the host-side loaders (counterpart of
``zest_tpu.data.pose_utils``): the NeRF pose centering of every LLFF-format
loader and IBRNet's nearest-view selection. NumPy only.
"""
from __future__ import annotations

import numpy as np

TINY = 1e-6

BLENDER2OPENCV = np.array([[1, 0, 0, 0],
                           [0, -1, 0, 0],
                           [0, 0, -1, 0],
                           [0, 0, 0, 1]], np.float64)


def normalize(v):
    return v / np.linalg.norm(v)


def average_poses(poses):
    """The average pose of poses [N, 3, 4] -> [3, 4]."""
    center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses, blender2opencv=BLENDER2OPENCV):
    """Center the poses on their average, so that NDC applies.

    Args: poses [N, 3, 4].
    Returns: (poses_centered [N, 3, 4], inverse transform [4, 4])
    """
    pose_avg = average_poses(poses)
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = pose_avg
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    poses_centered = np.linalg.inv(pose_avg_homo) @ poses_homo
    poses_centered = poses_centered @ blender2opencv
    return poses_centered[:, :3], np.linalg.inv(pose_avg_homo) @ blender2opencv


def angular_dist_between_2_vectors(vec1, vec2):
    v1 = vec1 / (np.linalg.norm(vec1, axis=1, keepdims=True) + TINY)
    v2 = vec2 / (np.linalg.norm(vec2, axis=1, keepdims=True) + TINY)
    return np.arccos(np.clip(np.sum(v1 * v2, axis=-1), -1.0, 1.0))


def batched_angular_dist_rot_matrix(R1, R2):
    tr = np.trace(np.matmul(R2.transpose(0, 2, 1), R1), axis1=1, axis2=2)
    return np.arccos(np.clip((tr - 1) / 2.0, -1 + TINY, 1 - TINY))


def get_nearest_pose_ids(tar_pose, ref_poses, num_select, tar_id=-1,
                         angular_dist_method="vector", scene_center=(0, 0, 0)):
    """The first ``num_select`` of ``ref_poses`` from the nearest to the
    farthest from ``tar_pose`` (``tar_id`` itself last), by the angle of
    their translations seen from ``scene_center`` ("vector"), of their
    rotations ("matrix") or the distance of their centers ("dist")."""
    tar_pose = np.asarray(tar_pose)
    ref_poses = np.asarray(ref_poses)
    num_cams = len(ref_poses)
    num_select = min(num_select, num_cams - 1)
    batched = np.broadcast_to(tar_pose[None], (num_cams,) + tar_pose.shape)

    if angular_dist_method == "matrix":
        dists = batched_angular_dist_rot_matrix(batched[:, :3, :3],
                                                ref_poses[:, :3, :3])
    elif angular_dist_method == "vector":
        tar_vec = batched[:, :3, 3] - np.asarray(scene_center)[None]
        ref_vec = ref_poses[:, :3, 3] - np.asarray(scene_center)[None]
        dists = angular_dist_between_2_vectors(tar_vec, ref_vec)
    elif angular_dist_method == "dist":
        dists = np.linalg.norm(batched[:, :3, 3] - ref_poses[:, :3, 3], axis=1)
    else:
        raise ValueError(angular_dist_method)

    if tar_id >= 0:
        dists[tar_id] = 1e3
    return np.argsort(dists)[:num_select]
