"""Trilinear encoding-volume lookup: CUDA kernels and their plain PyTorch
twins.

Replaces three TPU kernels of ``zest_tpu/kernels/trilinear.py``, all in
``csrc/trilinear.cu``:

- K3 ``_fwd_pallas``, the lookup (``sample_volume_zbanded``);
- K4 ``_bwd_pallas``, its adjoint in the volume;
- K5 ``_coords_pallas``, its gradient in the coordinates, which
  ``sample_volume_zbanded_diff`` takes at flow-warped points.

``sample_volume`` is one autograd Function: d_vol comes from K4 whenever the
volume needs a gradient, d_ndc from K5 only when the coordinates need one
(the t±1 and chain points; the rays' own points carry none). The twins are
``F.grid_sample`` (through ``ops.grid_sample``) and its autograd.

The encoding volume has 8 channels. K3 also reads the colour volume of
``use_color_volume`` (``render.append_color_volume``: the 8 channels, then
RGB and an in-bounds mask per source view, C = 8 + 4V, a multiple of 4 up
to ``MAX_CHANNELS``); only its first 8 channels have a gradient, which K4
takes (``sample_volume``'s ``lead``).
"""
from __future__ import annotations

import torch

from ..ops.grid_sample import grid_sample_3d
from . import _build

CHANNELS = 8     # encoding-volume width: two float4 loads per corner
MAX_CHANNELS = 48    # K3's widest volume: 8 + 4 * 10 source views


def sample_volume_plain(vol, ndc):
    """Twin: ``grid_sample_3d`` (``F.grid_sample``, zeros padding,
    align_corners=True) at ndc*2-1. vol [D, Hv, Wv, C]; ndc [R, S, 3].
    Returns [R, S, C]."""
    return grid_sample_3d(vol, ndc * 2.0 - 1.0)


def sample_volume_grads_plain(vol, ndc, g):
    """Twin of K4 and K5: (d_vol, d_ndc) by autograd through the lookup."""
    vol, ndc = (t.detach().requires_grad_(True) for t in (vol, ndc))
    with torch.enable_grad():
        out = sample_volume_plain(vol, ndc)
    return torch.autograd.grad(out, (vol, ndc), g)


def _check(name, vol, ndc, *others, wide=False):
    C = vol.shape[-1]
    ok = C % 4 == 0 and CHANNELS <= C <= MAX_CHANNELS if wide else \
        C == CHANNELS
    if vol.dim() != 4 or not ok:
        want = f"C, C a multiple of 4 up to {MAX_CHANNELS}" if wide else \
            CHANNELS
        raise ValueError(f"{name}: vol must be [D, Hv, Wv, {want}], "
                         f"got {tuple(vol.shape)}")
    if ndc.shape[-1] != 3:
        raise ValueError(f"{name}: ndc must end in 3, got {tuple(ndc.shape)}")
    _build.require_cuda_f32(name, vol, ndc, *others)
    if vol.data_ptr() % 16 or any(t.data_ptr() % 16 for t in others):
        raise ValueError(f"{name}: vol and g must be 16-byte aligned")


def rays_and_samples(ndc) -> tuple:
    """(R, S) of ndc [..., S, 3] as K3 tiles it: R rays of S samples, the
    samples contiguous; ndc [n, 3] is n rays of one sample."""
    n = ndc.numel() // 3
    S = ndc.shape[-2] if ndc.dim() >= 3 else 1
    return (n // S if S else 0), S


def _launch_sample(vol, ndc):
    """K3 → [..., C]."""
    D, Hv, Wv, C = vol.shape
    out = torch.empty((*ndc.shape[:-1], C), device=vol.device,
                      dtype=torch.float32)
    R, S = rays_and_samples(ndc)
    err = _build.library().zt_trilinear_sample(
        vol.data_ptr(), ndc.data_ptr(), out.data_ptr(), R, S, D, Hv, Wv, C,
        _build.stream_ptr(vol))
    _build.check(err, "sample_volume")
    sample_volume.launches += 1
    return out


def volume_grad(vol_shape, ndc, g):
    """K4: d_vol [D, Hv, Wv, 8] of the lookup at ndc [..., 3] for the output
    gradient g [..., 8], or of the first 8 channels of a colour volume's
    lookup for its g [..., C]. CUDA tensors only (the twin is
    ``sample_volume_grads_plain``)."""
    name = "volume_grad"
    D, Hv, Wv, C = vol_shape
    gC = g.shape[-1]
    if g.shape[:-1] != ndc.shape[:-1] or gC % 4 or not C <= gC <= MAX_CHANNELS:
        raise ValueError(f"{name}: g must be {(*ndc.shape[:-1], C)} or wider "
                         f"by a multiple of 4, got {tuple(g.shape)}")
    d_vol = torch.zeros(vol_shape, device=g.device, dtype=torch.float32)
    _check(name, d_vol, ndc, g)
    err = _build.library().zt_trilinear_grad_volume(
        g.data_ptr(), ndc.data_ptr(), d_vol.data_ptr(), ndc.numel() // 3, gC,
        D, Hv, Wv, _build.stream_ptr(g))
    _build.check(err, name)
    volume_grad.launches += 1
    return d_vol


volume_grad.launches = 0


def coords_grad(vol, ndc, g):
    """K5: d_ndc [..., 3] of the lookup of vol at ndc for the output gradient
    g [..., 8]. CUDA tensors only (the twin is ``sample_volume_grads_plain``)."""
    name = "coords_grad"
    if g.shape != (*ndc.shape[:-1], vol.shape[-1]):
        raise ValueError(f"{name}: g must be {(*ndc.shape[:-1], vol.shape[-1])}"
                         f", got {tuple(g.shape)}")
    _check(name, vol, ndc, g)
    D, Hv, Wv, _ = vol.shape
    d_ndc = torch.empty_like(ndc)
    err = _build.library().zt_trilinear_grad_coords(
        vol.data_ptr(), ndc.data_ptr(), g.data_ptr(), d_ndc.data_ptr(),
        ndc.numel() // 3, D, Hv, Wv, _build.stream_ptr(vol))
    _build.check(err, name)
    coords_grad.launches += 1
    return d_ndc


coords_grad.launches = 0


class _SampleVolume(torch.autograd.Function):
    """K3 forward; K4 for d_vol (or for d_lead, the gradient of the colour
    volume's first 8 channels), K5 for d_ndc, each only where needed."""

    @staticmethod
    def forward(ctx, vol, ndc, lead):
        ctx.save_for_backward(vol, ndc)
        return _launch_sample(vol, ndc)

    @staticmethod
    def backward(ctx, g):
        vol, ndc = ctx.saved_tensors
        g = g.contiguous()
        d_vol = volume_grad(vol.shape, ndc, g) if ctx.needs_input_grad[0] else None
        d_ndc = coords_grad(vol, ndc, g) if ctx.needs_input_grad[1] else None
        d_lead = volume_grad((*vol.shape[:3], CHANNELS), ndc, g) \
            if ctx.needs_input_grad[2] else None
        return d_vol, d_ndc, d_lead


def sample_volume(vol, ndc, lead=None):
    """Trilinear sample of vol [D, Hv, Wv, C] at ndc [..., 3] in [0, 1] →
    [..., C], differentiable in both; C is 8, or for the colour volume of
    ``use_color_volume`` 8 + 4V. Given ``lead`` [D, Hv, Wv, 8], equal to
    vol's first 8 channels, the gradient of those channels goes to lead
    (K4) and vol takes none: the colour channels, made from the input
    images, have no parameter behind them.

    CPU tensors take the twin; CUDA tensors launch the kernels or raise.
    """
    if vol.device.type == "cpu":
        if lead is not None:
            vol = torch.cat([lead, vol[..., CHANNELS:].detach()], -1)
        return sample_volume_plain(vol, ndc)
    ndc = ndc.contiguous()
    _check("sample_volume", vol, ndc, wide=True)
    if lead is not None:
        _check("sample_volume", lead, ndc)
        vol = vol.detach()
    elif vol.shape[-1] != CHANNELS and vol.requires_grad:
        raise ValueError("sample_volume: a colour volume's gradient goes to "
                         "its first 8 channels, given as lead")
    return _SampleVolume.apply(vol, ndc, lead)


sample_volume.launches = 0
