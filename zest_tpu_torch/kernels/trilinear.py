"""Trilinear encoding-volume lookup: CUDA kernel and its plain PyTorch twin.

Replaces ``zest_tpu/kernels/trilinear.py:_fwd_pallas`` (the forward
``pallas_call`` behind ``sample_volume_zbanded``) for unwarped ray points;
the kernel is ``csrc/trilinear.cu``. Forward only: the coordinate-
differentiable variant and the backward come with the training slice.
"""
from __future__ import annotations

import torch

from ..ops.grid_sample import grid_sample_3d
from . import _build

CHANNELS = 8     # encoding-volume width: two float4 loads per corner


def sample_volume_plain(vol, ndc):
    """Twin: ``grid_sample_3d`` (``F.grid_sample``, zeros padding,
    align_corners=True) at ndc*2-1. vol [D, Hv, Wv, C]; ndc [R, S, 3].
    Returns [R, S, C]."""
    return grid_sample_3d(vol, ndc * 2.0 - 1.0)


def sample_volume(vol, ndc):
    """Trilinear sample of vol [D, Hv, Wv, 8] at ndc [R, S, 3] in [0, 1].

    CPU tensors take the twin; CUDA tensors launch the kernel or raise.
    """
    if vol.device.type == "cpu":
        return sample_volume_plain(vol, ndc)
    if vol.dim() != 4 or vol.shape[-1] != CHANNELS:
        raise ValueError(f"sample_volume: vol must be [D, Hv, Wv, {CHANNELS}], "
                         f"got {tuple(vol.shape)}")
    if ndc.shape[-1] != 3:
        raise ValueError(f"sample_volume: ndc must end in 3, got "
                         f"{tuple(ndc.shape)}")
    _build.require_cuda_f32("sample_volume", vol, ndc)
    if vol.data_ptr() % 16:
        raise ValueError("sample_volume: vol must be 16-byte aligned")
    D, Hv, Wv, C = vol.shape
    n = ndc.numel() // 3
    out = torch.empty((*ndc.shape[:-1], C), device=vol.device,
                      dtype=torch.float32)
    err = _build.library().zt_trilinear_sample(
        vol.data_ptr(), ndc.data_ptr(), out.data_ptr(), n, D, Hv, Wv,
        _build.stream_ptr(vol))
    _build.check(err, "sample_volume")
    sample_volume.launches += 1
    return out


sample_volume.launches = 0
