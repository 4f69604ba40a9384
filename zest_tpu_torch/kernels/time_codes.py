"""The time code folded into the static field's biases (``train_video``):
CUDA kernels (``csrc/time_codes.cu``) and their plain PyTorch twins.

``zest_tpu`` concatenates sigmoid(time_codes[keyframe_id]), the same
[time_code_dim] vector for every point of a call, after the embedded points
and runs the static field's fused kernel (``zest_tpu/kernels/
fused_mlp.py:_fwd_pallas``, K6, and ``_bwd_pallas``, K7) on all 63 + 1,024
channels. The layers that read the code (the first and the one after the
skip) split as [pts, s] @ W^T + b = pts @ W_pts^T + (b + s @ W_code^T), so
the port runs K6 and K7 on the 63 point channels with the folded biases c =
b + s @ W_code^T, which ``fold_codes`` forms once per call. In the
backward, K7's bias gradient of those layers is d_c, and d_s = d_c @ W_code,
d_W_code = d_c (x) s, d_b = d_c. In the field's bf16-operand mode s and
W_code are rounded to bf16 and summed in float32, as ``zest_tpu``'s
``approx=True`` kernel rounds them; at float32 the sums are float32.
"""
from __future__ import annotations

import torch

from . import _build
from ..models.nerf import round_bf16


def _operands(code, wc, bf16):
    return (round_bf16(code), round_bf16(wc)) if bf16 else (code, wc)


def fold_codes_plain(code, wc, b, bf16: bool = False):
    """Twin of the fold kernel: b + s @ W_code^T for code s [T], wc [L, W,
    T] (each folding layer's code columns) and b [L, W] → [L, W]."""
    s, w = _operands(code, wc, bf16)
    return b + torch.einsum("lot,t->lo", w, s)


def fold_codes_grad_plain(code, wc, d_c, bf16: bool = False):
    """Twin of the fold's backward kernel: (d_code [T], d_wc [L, W, T]) for
    the folded biases' gradient d_c [L, W]; d_b is d_c itself."""
    s, w = _operands(code, wc, bf16)
    return torch.einsum("lo,lot->t", d_c, w), d_c[..., None] * s


def _check(name, code, wc, rows):
    """code [T], wc [L, W, T] and rows ([L, W]: b or d_c), float32 on one
    card."""
    if code.dim() != 1 or wc.dim() != 3 or wc.shape[-1] != code.shape[0] \
            or rows.shape != wc.shape[:2]:
        raise ValueError(f"{name}: code [T], wc [L, W, T] and [L, W], got "
                         f"{tuple(code.shape)}, {tuple(wc.shape)}, "
                         f"{tuple(rows.shape)}")
    _build.require_cuda_f32(name, code, wc, rows)


def _launch_fold(code, wc, b, bf16):
    _check("fold_codes", code, wc, b)
    c = torch.empty_like(b)
    err = _build.library().zt_fold_codes(
        code.data_ptr(), wc.data_ptr(), b.data_ptr(), c.data_ptr(),
        b.numel(), code.numel(), int(bf16), _build.stream_ptr(code))
    _build.check(err, "fold_codes")
    fold_codes.launches += 1
    return c


def fold_codes_grad(code, wc, d_c, bf16: bool = False):
    """The fold's backward kernel: (d_code, d_wc) as
    ``fold_codes_grad_plain`` gives them. CUDA tensors only."""
    _check("fold_codes_grad", code, wc, d_c)
    d_code = torch.zeros_like(code)
    d_wc = torch.empty_like(wc)
    err = _build.library().zt_fold_codes_grad(
        code.data_ptr(), wc.data_ptr(), d_c.data_ptr(), d_code.data_ptr(),
        d_wc.data_ptr(), d_c.numel(), code.numel(), int(bf16),
        _build.stream_ptr(code))
    _build.check(err, "fold_codes_grad")
    fold_codes_grad.launches += 1
    return d_code, d_wc


fold_codes_grad.launches = 0


class _Fold(torch.autograd.Function):
    """The fold and its backward, each the kernel on CUDA tensors and the
    twin on CPU ones."""

    @staticmethod
    def forward(ctx, code, wc, b, bf16):
        ctx.save_for_backward(code, wc)
        ctx.bf16 = bf16
        if code.device.type == "cpu":
            return fold_codes_plain(code, wc, b, bf16)
        return _launch_fold(code, wc, b, bf16)

    @staticmethod
    def backward(ctx, d_c):
        code, wc = ctx.saved_tensors
        d_c = d_c.contiguous()
        grad = fold_codes_grad_plain if code.device.type == "cpu" \
            else fold_codes_grad
        d_code, d_wc = grad(code, wc, d_c, ctx.bf16)
        return d_code, d_wc, d_c, None


def fold_codes(code, wc, b, bf16: bool = False):
    """The folded biases b + s @ W_code^T [L, W] of code s [T], wc [L, W, T]
    and b [L, W], differentiable in all three (the backward is
    ``fold_codes_grad``). CPU tensors take the twins; CUDA tensors launch
    the kernels or raise."""
    return _Fold.apply(code.contiguous(), wc.contiguous(), b.contiguous(),
                       bf16)


fold_codes.launches = 0
