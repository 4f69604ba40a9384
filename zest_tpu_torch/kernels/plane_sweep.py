"""Plane-sweep homography warp: CUDA kernels and their plain PyTorch twins.

Replaces ``zest_tpu/kernels/plane_sweep.py:_pallas_warp_fwd`` (K1, the forward
``pallas_call`` behind ``homo_warp_fast_cm``) and ``_pallas_warp_bwd`` (K2, its
adjoint in the source features); both kernels are in ``csrc/plane_sweep.cu``.
They take the grid that ``ops.homography.homography_grid`` computed, so
kernel and twin sample the same coordinates. ``homo_warp_cm`` is an autograd
Function: d_src comes from K2, and the grid carries no gradient, as in the
TPU kernel's custom VJP. ``inside_items`` names the (plane, pixel) items
whose g K2 reads: those with a tap inside the source.
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


def homo_warp_cm_grad_plain(src, grid, g):
    """Twin of K2: d_src [h, w, C] by autograd through the twin."""
    src = src.detach().requires_grad_(True)
    with torch.enable_grad():
        out = homo_warp_cm_plain(src, grid.detach())
    return torch.autograd.grad(out, src, g)[0]


def inside_items(grid, src_hw):
    """[D, Hp, Wp] bool: the items of grid [D, Hp, Wp, 2] with at least one
    bilinear tap inside an (h, w) source (align_corners=True). Every other
    item's output gradient has weight 0 on every source pixel, so K2 does
    not read it (its ``any_inside`` in ``csrc/plane_sweep.cu``). The bytes
    K2 must read, the count behind its bound in ``chip_smoke.py``; a card
    test puts noise in g at every other item."""
    h, w = src_hw
    x0 = torch.floor((grid[..., 0] + 1.0) / 2.0 * (w - 1))
    y0 = torch.floor((grid[..., 1] + 1.0) / 2.0 * (h - 1))
    return (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)


def _launch_warp(src, grid):
    """K1 → [D, C, Hp*Wp]."""
    h, w, C = src.shape
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


def homo_warp_cm_grad(g, grid, src_hw):
    """K2: d_src [h, w, C] of the warp for the output gradient g [D, C,
    Hp*Wp] at grid [D, Hp, Wp, 2]; src_hw = (h, w). CUDA tensors only (the
    twin is ``homo_warp_cm_grad_plain``)."""
    name = "homo_warp_cm_grad"
    h, w = src_hw
    D, Hp, Wp, _ = grid.shape
    if g.dim() != 3 or g.shape[0] != D or g.shape[2] != Hp * Wp:
        raise ValueError(f"{name}: g must be [{D}, C, {Hp * Wp}], got "
                         f"{tuple(g.shape)}")
    _build.require_cuda_f32(name, g, grid)
    if grid.data_ptr() % 8:
        raise ValueError(f"{name}: grid must be 8-byte aligned")
    C = g.shape[1]
    d_src = torch.zeros((C, h, w), device=g.device, dtype=torch.float32)
    err = _build.library().zt_plane_sweep_warp_backward(
        g.data_ptr(), grid.data_ptr(), d_src.data_ptr(), D, h, w, C, Hp, Wp,
        _build.stream_ptr(g))
    _build.check(err, name)
    homo_warp_cm_grad.launches += 1
    return d_src.permute(1, 2, 0)


homo_warp_cm_grad.launches = 0


class _Warp(torch.autograd.Function):
    """K1 forward, K2 backward; no gradient for the grid."""

    @staticmethod
    def forward(ctx, src, grid):
        ctx.save_for_backward(grid)
        ctx.src_hw = src.shape[:2]
        return _launch_warp(src, grid)

    @staticmethod
    def backward(ctx, g):
        grid, = ctx.saved_tensors
        return homo_warp_cm_grad(g.contiguous(), grid, ctx.src_hw), None


def homo_warp_cm(src, grid):
    """Warp src [h, w, C] at grid [D, Hp, Wp, 2] → [D, C, Hp*Wp],
    differentiable in src.

    CPU tensors take the twin; CUDA tensors launch the kernels or raise.
    """
    if src.device.type == "cpu":
        return homo_warp_cm_plain(src, grid)
    if grid.dim() != 4 or grid.shape[-1] != 2:
        raise ValueError(f"homo_warp_cm: grid must be [D, Hp, Wp, 2], "
                         f"got {tuple(grid.shape)}")
    _build.require_cuda_f32("homo_warp_cm", src, grid)
    return _Warp.apply(src, grid.detach())


homo_warp_cm.launches = 0
