"""Fused NeRF field: CUDA kernel and its plain PyTorch twin.

Replaces ``zest_tpu/kernels/fused_mlp.py:_fwd_pallas`` (the forward
``pallas_call`` behind ``fused_nerf_apply``); the kernel is
``csrc/fused_mlp.cu``. Every product of the field runs inside the kernel.
The twin is the port's ``models.nerf.NeRFField`` itself.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

WIDTHS = (64, 128, 256)          # kernel instantiations
MAX_LAYERS = 16                  # kMaxLayers in csrc/fused_mlp.cu
SMEM_LIMIT = 232448              # bytes of shared memory a block may opt into
# offsets-table slots, as the Slot enum in csrc/fused_mlp.cu numbers them
_WB, _LAYER0 = 0, 2
_WA = _LAYER0 + 2 * MAX_LAYERS
_WF, _WV, _WR, _WX1, _WX2 = _WA + 2, _WA + 4, _WA + 6, _WA + 8, _WA + 10
_N_SLOTS = _WA + 12
_TILE = 32


def pack_weights(field):
    """All of a field's Linear layers as one [in][out]-major float buffer and
    the offsets table the kernel reads. Every matrix and bias starts on a
    multiple of 4 floats: the kernel reads them with float4 loads.
    Returns (pack, offsets)."""
    slots = [(_WB, field.pts_bias)]
    slots += [(_LAYER0 + 2 * i, lin) for i, lin in enumerate(field.pts_linears)]
    slots += [(_WA, field.alpha_linear), (_WF, field.feature_linear),
              (_WV, field.views_linears[0]), (_WR, field.rgb_linear)]
    if field.static:
        slots.append((_WX1, field.w_linear))
    else:
        slots += [(_WX1, field.sf_linear), (_WX2, field.prob_linear)]
    offsets = [0] * _N_SLOTS
    parts, cur = [], 0
    for slot, lin in slots:
        for k, t in enumerate((lin.weight.T, lin.bias)):
            offsets[slot + k] = cur
            t = t.reshape(-1)
            parts += [t, t.new_zeros(-t.numel() % 4)]
            cur += t.numel() + (-t.numel() % 4)
    return torch.cat(parts).float().contiguous(), offsets


def fused_nerf_forward(field, pts, feats, views):
    """Evaluate a v0 ``NeRFField`` on pts/feats/views [..., ch] → [..., out_ch].

    CPU tensors take the twin (the module itself); CUDA tensors launch the
    kernel or raise.
    """
    if pts.device.type == "cpu":
        return field(pts, feats, views)
    name = "fused_nerf_forward"
    P, F, V = field.in_ch_pts, field.in_ch_feat, field.in_ch_views
    if field.width not in WIDTHS:
        raise ValueError(f"{name}: width {field.width} not in {WIDTHS}")
    if len(field.pts_linears) > MAX_LAYERS or len(field.skips) > 1:
        raise ValueError(f"{name}: at most {MAX_LAYERS} layers and one skip")
    smem = 4 * _TILE * (2 * field.width + P + F + V)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {smem} bytes of shared memory per block "
                         f"exceed {SMEM_LIMIT}")
    lead = pts.shape[:-1]
    if (pts.shape[-1], feats.shape[-1], views.shape[-1]) != (P, F, V) or \
            feats.shape[:-1] != lead or views.shape[:-1] != lead:
        raise ValueError(f"{name}: expected [..., {P}], [..., {F}], [..., {V}]"
                         f" with one leading shape, got {tuple(pts.shape)}, "
                         f"{tuple(feats.shape)}, {tuple(views.shape)}")
    n = pts.numel() // P
    pts2, feats2, views2 = (t.reshape(n, t.shape[-1]).contiguous()
                            for t in (pts, feats, views))
    pack, offsets = pack_weights(field)
    _build.require_cuda_f32(name, pts2, feats2, views2, pack)
    out = torch.empty((n, field.out_ch), device=pts.device, dtype=torch.float32)
    n_extra = 1 if field.static else 2
    skip = field.skips[0] if field.skips else -2
    err = _build.library().zt_fused_nerf_forward(
        pts2.data_ptr(), feats2.data_ptr(), views2.data_ptr(), pack.data_ptr(),
        (ctypes.c_int * _N_SLOTS)(*offsets), out.data_ptr(), n, P, F, V,
        field.width, len(field.pts_linears), skip, n_extra,
        _build.stream_ptr(pts))
    _build.check(err, name)
    fused_nerf_forward.launches += 1
    return out.reshape(*lead, field.out_ch)


fused_nerf_forward.launches = 0
