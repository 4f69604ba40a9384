"""2D feature CNN of the MVS encoder (counterpart of
``zest_tpu.models.feature_net``).

BatchNorm always normalizes with the statistics of the current batch, at eval
too: the reference forces the encoder into train mode everywhere, so batch
statistics are its only behaviour. There are no running statistics; the
variance is the biased one, over every view jointly. Activation: leaky ReLU
with slope 0.01, eps 1e-5 (InPlaceABN's defaults).

``dtype=torch.bfloat16`` is the encoder at 16-bit precision, as
``zest_tpu.models.feature_net`` computes it with ``dtype=bfloat16``: bf16
convolutions (weights rounded from the float32 parameters), BatchNorm
statistics in float32 over the bf16 activations, its scale and shift rounded
to bf16 and applied in bf16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
LEAKY_SLOPE = 0.01


class BatchNormAct(nn.Module):
    """Batch-statistics BatchNorm + leaky ReLU over channel axis 1."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        if x.dtype == torch.float32:
            y = F.batch_norm(x, None, None, self.weight, self.bias,
                             training=True, eps=BN_EPS)
        else:
            # statistics in float32, scale and shift applied in x's type
            dims = [d for d in range(x.dim()) if d != 1]
            var, mean = torch.var_mean(x.float(), dims, unbiased=False)
            inv = torch.rsqrt(var + BN_EPS) * self.weight
            shape = (1, -1) + (1,) * (x.dim() - 2)
            y = x * inv.to(x.dtype).view(shape) \
                + (self.bias - mean * inv).to(x.dtype).view(shape)
        return F.leaky_relu(y, LEAKY_SLOPE)


def conv(module, x):
    """``module(x)`` (a Conv2d or Conv3d) in x's type: the float32 weights
    rounded to it where x is not float32."""
    if x.dtype == module.weight.dtype:
        return module(x)
    bias = None if module.bias is None else module.bias.to(x.dtype)
    return module._conv_forward(x, module.weight.to(x.dtype), bias)


class ConvBnReLU(nn.Module):
    """Conv2d(bias=False) + BatchNormAct."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, kernel // 2,
                              bias=False)
        self.bn = BatchNormAct(out_ch)

    def forward(self, x):
        return self.bn(conv(self.conv, x))


class FeatureNet(nn.Module):
    """3 → 8 (H, W) → 16 (H/2) → 32 (H/4), then a 1x1 top layer.

    Input [V, 3, H, W]; output [V, 32, H/4, W/4] in ``dtype``."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = nn.Sequential(ConvBnReLU(3, 8), ConvBnReLU(8, 8))
        self.conv1 = nn.Sequential(ConvBnReLU(8, 16, 5, 2), ConvBnReLU(16, 16),
                                   ConvBnReLU(16, 16))
        self.conv2 = nn.Sequential(ConvBnReLU(16, 32, 5, 2),
                                   ConvBnReLU(32, 32), ConvBnReLU(32, 32))
        self.toplayer = nn.Conv2d(32, 32, 1)

    def forward(self, x):
        x = self.conv2(self.conv1(self.conv0(x.to(self.dtype))))
        return conv(self.toplayer, x)
