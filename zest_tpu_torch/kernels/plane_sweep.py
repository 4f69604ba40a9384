"""Plane-sweep homography warp: CUDA kernel and its plain PyTorch twin.

Replaces ``zest_tpu/kernels/plane_sweep.py:_pallas_warp_fwd`` (the forward
``pallas_call`` behind ``homo_warp_fast_cm``); the kernel is
``csrc/plane_sweep.cu``. It takes the grid that ``ops.homography.
homography_grid`` computed, so kernel and twin sample the same coordinates.
"""
from __future__ import annotations

import torch

from ..ops.grid_sample import grid_sample_2d
from . import _build


def homo_warp_cm_plain(src, grid):
    """Twin: ``grid_sample_2d`` (``F.grid_sample``, zeros padding,
    align_corners=True), viewed channel-major.

    src [h, w, C]; grid [D, Hp, Wp, 2] normalized (x, y). Returns [D, C, Hp*Wp].
    """
    D, Hp, Wp, _ = grid.shape
    return grid_sample_2d(src, grid).reshape(D, Hp * Wp, -1).transpose(1, 2)


def homo_warp_cm(src, grid):
    """Warp src [h, w, C] at grid [D, Hp, Wp, 2] → [D, C, Hp*Wp].

    CPU tensors take the twin; CUDA tensors launch the kernel or raise.
    """
    if src.device.type == "cpu":
        return homo_warp_cm_plain(src, grid)
    h, w, C = src.shape
    if grid.dim() != 4 or grid.shape[-1] != 2:
        raise ValueError(f"homo_warp_cm: grid must be [D, Hp, Wp, 2], "
                         f"got {tuple(grid.shape)}")
    _build.require_cuda_f32("homo_warp_cm", src, grid)
    D, Hp, Wp, _ = grid.shape
    # channel planes: a warp's neighbouring pixels read neighbouring addresses
    src_cm = src.permute(2, 0, 1).contiguous()
    out = torch.empty((D, C, Hp * Wp), device=src.device, dtype=torch.float32)
    err = _build.library().zt_plane_sweep_warp(
        src_cm.data_ptr(), grid.data_ptr(), out.data_ptr(), D, h, w, C,
        Hp * Wp, _build.stream_ptr(src))
    _build.check(err, "homo_warp_cm")
    homo_warp_cm.launches += 1
    return out


homo_warp_cm.launches = 0
