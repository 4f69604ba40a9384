"""NeRF radiance field, v0 with view directions (counterpart of
``zest_tpu.models.nerf.NeRFField``).

Per-layer multiplicative conditioning on the volume features:
h = relu(W_i h * (W_b feats + b_b)). The layer after each index in ``skips``
reads [pts, h]. Output layout (last axis):
  [rgb(3), alpha(1)] ++ static  → [blend(1)]
                     ++ dynamic → [sf_bwd(3), sf_fwd(3), prob(2)]
Submodule names follow the reference state-dict layout (``pts_linears.0``,
``views_linears.0``, ...). This module is also the plain twin of the fused
field kernel (``kernels.fused_mlp``).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def trunk_layer_dims(depth: int, width: int, in_ch: int, skips: Sequence[int]):
    """(fan_in, fan_out) of each trunk layer, in the reference's order."""
    dims = []
    for i in range(depth - 1):
        if i == 0:
            dims.append((in_ch, width))
        dims.append((width + in_ch, width) if i in skips else (width, width))
    return dims


class NeRFField(nn.Module):
    """v0 field with view directions, volume-feature conditioning and the
    scene-flow heads (``sceneflow=True`` in the reference)."""

    def __init__(self, depth: int = 8, width: int = 256, in_ch_pts: int = 63,
                 in_ch_views: int = 27, in_ch_feat: int = 8,
                 skips: Sequence[int] = (4,), static: bool = True):
        super().__init__()
        self.depth, self.width = depth, width
        self.in_ch_pts, self.in_ch_views, self.in_ch_feat = \
            in_ch_pts, in_ch_views, in_ch_feat
        self.skips = tuple(skips)
        self.static = static
        self.pts_bias = nn.Linear(in_ch_feat, width)
        self.pts_linears = nn.ModuleList(
            nn.Linear(i, o) for i, o in trunk_layer_dims(depth, width,
                                                         in_ch_pts, skips))
        if static:
            self.w_linear = nn.Linear(width, 1)
        else:
            self.sf_linear = nn.Linear(width, 6)
            self.prob_linear = nn.Linear(width, 2)
        self.alpha_linear = nn.Linear(width, 1)
        self.feature_linear = nn.Linear(width, width)
        self.views_linears = nn.ModuleList(
            [nn.Linear(width + in_ch_views, width // 2)])
        self.rgb_linear = nn.Linear(width // 2, 3)

    @property
    def out_ch(self) -> int:
        return 5 if self.static else 12

    def forward(self, pts, feats, views):
        """pts [..., in_ch_pts], feats [..., in_ch_feat], views [...,
        in_ch_views] → raw outputs [..., out_ch]."""
        bias = self.pts_bias(feats)
        h = pts
        for i, layer in enumerate(self.pts_linears):
            h = torch.relu(layer(h) * bias)
            if i in self.skips:
                h = torch.cat([pts, h], -1)
        if self.static:
            extras = [torch.sigmoid(self.w_linear(h))]
        else:
            extras = [torch.tanh(self.sf_linear(h)),
                      torch.sigmoid(self.prob_linear(h))]
        alpha = self.alpha_linear(h)
        feature = self.feature_linear(h)
        hv = torch.relu(self.views_linears[0](torch.cat([feature, views], -1)))
        rgb = self.rgb_linear(hv)
        return torch.cat([rgb, alpha] + extras, -1)
