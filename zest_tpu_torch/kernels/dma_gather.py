"""Row gather: CUDA kernels and their plain PyTorch twins.

Replaces ``zest_tpu/kernels/dma_gather.py:_dma_gather_rows`` (K9, the
``pallas_call`` behind ``take_rows``); the kernel and its adjoint are in
``csrc/row_gather.cu``. ``take_rows(tab, idx)`` is ``tab[idx]`` as an
autograd Function: the forward copies rows (one launch of the gather), the
backward adds the output gradient's rows into a float32 table at the same
indices (one launch of the scatter-add) and rounds it to the table's type
once. ``zest_tpu`` scatters into the table's own type, so at bf16 it rounds
after every add (``ops/grid_sample.py:361``, ``kernels/trilinear.py:517``);
here a row that many points share is summed in float32 first. The twins are
``tab[idx]`` and ``Tensor.index_add_`` into the same float32 table.
"""
from __future__ import annotations

import torch

from . import _build

DTYPES = (torch.bfloat16, torch.float32)


def take_rows_plain(tab, idx):
    """Twin of the gather: ``tab[idx]`` → [*idx.shape, CW]."""
    return tab[idx.long()]


def scatter_rows_plain(g, idx, m: int):
    """Twin of the adjoint: the rows of g [*idx.shape, CW] added at idx into
    a zero float32 [m, CW] table with ``index_add_``, then rounded to g's
    type."""
    cw = g.shape[-1]
    acc = torch.zeros((m, cw), dtype=torch.float32, device=g.device)
    acc.index_add_(0, idx.reshape(-1).long(), g.reshape(-1, cw).float())
    return acc.to(g.dtype)


def _check(name, rows, idx):
    """rows: the table or a gradient [..., CW]."""
    if rows.dtype not in DTYPES:
        raise TypeError(f"{name}: expected one of {DTYPES}, got {rows.dtype}")
    if (rows.shape[-1] * rows.element_size()) % 16:
        raise ValueError(f"{name}: a row must be a multiple of 16 bytes, got "
                         f"{rows.shape[-1]} x {rows.element_size()}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32, got {idx.dtype}")
    if rows.device.type != "cuda" or idx.device != rows.device:
        raise ValueError(f"{name}: tensors must share one CUDA device, got "
                         f"{rows.device} and {idx.device}")
    if not (rows.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: expected contiguous tensors")
    if rows.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte aligned")


def gather_rows(tab, idx):
    """K9: tab [M, CW] at idx [...] → [..., CW], bitwise ``tab[idx]``. CUDA
    tensors only (the twin is ``take_rows_plain``)."""
    name = "gather_rows"
    if tab.dim() != 2:
        raise ValueError(f"{name}: tab must be [M, CW], got {tuple(tab.shape)}")
    _check(name, tab, idx)
    out = torch.empty((*idx.shape, tab.shape[1]), dtype=tab.dtype,
                      device=tab.device)
    err = _build.library().zt_row_gather(
        tab.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
        tab.shape[0], tab.shape[1] * tab.element_size(), _build.stream_ptr(tab))
    _build.check(err, name)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def scatter_rows(g, idx, m: int):
    """K9's adjoint: the rows of g [..., CW] added at idx [...] into a zero
    [m, CW] table in float32, returned in g's type. CUDA tensors only (the
    twin is ``scatter_rows_plain``)."""
    acc = torch.zeros((m, g.shape[-1]), dtype=torch.float32, device=g.device)
    scatter_add_rows(acc, g, idx)
    return acc.to(g.dtype)


scatter_rows.launches = 0


def scatter_add_rows(acc, g, idx):
    """The scatter-add kernel alone: acc [m, CW] float32 += the rows of g
    [..., CW] at idx [...], in place; counted in ``scatter_rows.launches``."""
    name = "scatter_rows"
    if g.shape[:-1] != idx.shape:
        raise ValueError(f"{name}: g must be [*idx.shape, CW], got "
                         f"{tuple(g.shape)} for idx {tuple(idx.shape)}")
    _check(name, g, idx)
    cw = g.shape[-1]
    if (acc.dtype != torch.float32 or acc.dim() != 2 or acc.shape[1] != cw
            or acc.device != g.device or not acc.is_contiguous()
            or acc.data_ptr() % 16):
        raise ValueError(f"{name}: acc must be a contiguous, 16-byte aligned "
                         f"float32 [m, {cw}] table on {g.device}")
    err = _build.library().zt_row_scatter_add(
        g.data_ptr(), idx.data_ptr(), acc.data_ptr(), idx.numel(),
        acc.shape[0], cw, g.element_size(), _build.stream_ptr(g))
    _build.check(err, name)
    scatter_rows.launches += 1
    return acc


class _TakeRows(torch.autograd.Function):
    """The gather forward, the scatter-add backward; no gradient for idx."""

    @staticmethod
    def forward(ctx, tab, idx):
        ctx.save_for_backward(idx)
        ctx.m = tab.shape[0]
        if tab.device.type == "cpu":
            return take_rows_plain(tab, idx)
        return gather_rows(tab, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        if g.device.type == "cpu":
            return scatter_rows_plain(g, idx, ctx.m), None
        return scatter_rows(g.contiguous(), idx, ctx.m), None


def take_rows(tab, idx):
    """``tab[idx]`` for tab [M, CW] (bf16 or float32, a row a multiple of 16
    bytes) and idx [...] int32 in [0, M), differentiable in tab.

    CPU tensors take the twins; CUDA tensors launch the kernels or raise.
    """
    if tab.dim() != 2:
        raise ValueError(f"take_rows: tab must be [M, CW], got {tuple(tab.shape)}")
    return _TakeRows.apply(tab, idx)
