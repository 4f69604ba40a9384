"""2D feature CNN of the MVS encoder (counterpart of
``zest_tpu.models.feature_net``).

BatchNorm always normalizes with the statistics of the current batch, at eval
too: the reference forces the encoder into train mode everywhere, so batch
statistics are its only behaviour. There are no running statistics; the
variance is the biased one, over every view jointly. Activation: leaky ReLU
with slope 0.01, eps 1e-5 (InPlaceABN's defaults).
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
        y = F.batch_norm(x, None, None, self.weight, self.bias, training=True,
                         eps=BN_EPS)
        return F.leaky_relu(y, LEAKY_SLOPE)


class ConvBnReLU(nn.Module):
    """Conv2d(bias=False) + BatchNormAct."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, kernel // 2,
                              bias=False)
        self.bn = BatchNormAct(out_ch)

    def forward(self, x):
        return self.bn(self.conv(x))


class FeatureNet(nn.Module):
    """3 → 8 (H, W) → 16 (H/2) → 32 (H/4), then a 1x1 top layer.

    Input [V, 3, H, W]; output [V, 32, H/4, W/4]."""

    def __init__(self):
        super().__init__()
        self.conv0 = nn.Sequential(ConvBnReLU(3, 8), ConvBnReLU(8, 8))
        self.conv1 = nn.Sequential(ConvBnReLU(8, 16, 5, 2), ConvBnReLU(16, 16),
                                   ConvBnReLU(16, 16))
        self.conv2 = nn.Sequential(ConvBnReLU(16, 32, 5, 2),
                                   ConvBnReLU(32, 32), ConvBnReLU(32, 32))
        self.toplayer = nn.Conv2d(32, 32, 1)

    def forward(self, x):
        return self.toplayer(self.conv2(self.conv1(self.conv0(x))))
