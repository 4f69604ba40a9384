"""3D cost-volume U-Net (counterpart of ``zest_tpu.models.cost_reg``).

Encoder 41 → 8 → 16 → 32 → 64 with three stride-2 convs, decoder of
transposed convs (k3, s2, p1, output_padding=1: exactly 2x) with skip
additions, 8 output channels. Plain ``nn.Conv3d`` / ``nn.ConvTranspose3d``;
spatial sizes must divide by 8.
"""
from __future__ import annotations

from torch import nn

from .feature_net import BatchNormAct


class ConvBnReLU3D(nn.Module):
    """Conv3d(k3, p1, bias=False) + BatchNormAct."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv3d(in_ch, out_ch, 3, stride, 1, bias=False)
        self.bn = BatchNormAct(out_ch)

    def forward(self, x):
        return self.bn(self.conv(x))


def _up(in_ch: int, out_ch: int) -> nn.Sequential:
    return nn.Sequential(
        nn.ConvTranspose3d(in_ch, out_ch, 3, stride=2, padding=1,
                           output_padding=1, bias=False),
        BatchNormAct(out_ch))


class CostRegNet(nn.Module):
    """Cost volume [1, C_in, D, h, w] → encoding volume [1, 8, D, h, w]."""

    def __init__(self, in_ch: int = 41):
        super().__init__()
        self.conv0 = ConvBnReLU3D(in_ch, 8)
        self.conv1 = ConvBnReLU3D(8, 16, stride=2)
        self.conv2 = ConvBnReLU3D(16, 16)
        self.conv3 = ConvBnReLU3D(16, 32, stride=2)
        self.conv4 = ConvBnReLU3D(32, 32)
        self.conv5 = ConvBnReLU3D(32, 64, stride=2)
        self.conv6 = ConvBnReLU3D(64, 64)
        self.conv7 = _up(64, 32)
        self.conv9 = _up(32, 16)
        self.conv11 = _up(16, 8)

    def forward(self, x):
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        return conv0 + self.conv11(x)
