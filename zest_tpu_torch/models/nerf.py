"""NeRF radiance field with view directions (counterpart of
``zest_tpu.models.nerf.NeRFField``).

``net_type="v0"`` (the reference's ``Renderer``): per-layer multiplicative
conditioning on the volume features, h = relu(W_i h * (W_b feats + b_b)); a
field without a volume (``use_mvs=False``) has no ``pts_bias`` and takes
h = relu(W_i h). ``net_type="v2"`` (``Renderer_linear``): additive
conditioning, h = relu(W_i h + (W_b feats + b_b)), alpha through a ReLU and
rgb through a sigmoid in the field (``render.raw2outputs`` then applies its
own sigmoid and ReLU again, as the reference does); a v2 field needs its
volume, as ``zest_tpu``'s does. The layer after each index in ``skips``
reads [pts, h]. With ``code_dim`` > 0 (``train_video``) the points input is
[pts (in_ch_pts), time code (code_dim)] and the layers that read it (the
first and the one after each skip) are that much wider. Output layout (last
axis):
  [rgb(3), alpha(1)] ++ the extra heads (``EXTRA_HEADS``, by ``n_extra``):
    0, no scene flow        → nothing
    1, the static field     → [blend(1)]
    2, the dynamic field    → [sf_bwd(3), sf_fwd(3), prob(2)]
Submodule names follow the reference state-dict layout (``pts_linears.0``,
``views_linears.0``, ...). The conditioned field is also the plain twin of
the fused field kernel (``kernels.fused_mlp``; ``fused``); the
unconditioned and the v2 field are ``zest_tpu``'s Flax module, which it
never fuses, and run as they are.

``bf16=True`` is the field at 16-bit precision, as ``zest_tpu``'s fused
kernel computes it with ``approx=True`` (``kernels/fused_mlp.py:115-215``,
``264-346``): the conditioning ``pts_bias``, the trunk, ``feature_linear``
and ``views_linears`` take bf16-rounded operands (inputs and weights; in the
backward the output gradient too) with float32 sums and a float32 bias; the
alpha, rgb, blend, flow and probability heads keep float32 operands. The
parameters stay float32. Only a fused field has that mode: ``zest_tpu``
keeps the unconditioned and the v2 field in float32 at 16-bit precision.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def round_bf16(t):
    """t rounded to the nearest bf16 value (ties to even), in t's type."""
    return t.to(torch.bfloat16).to(t.dtype)


class _BF16Linear(torch.autograd.Function):
    """x @ W^T + b with x and W rounded to bf16, the sums in float32; the
    backward rounds the output gradient and reuses the rounded operands."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        xr, wr = round_bf16(x), round_bf16(weight)
        ctx.save_for_backward(xr, wr)
        return xr @ wr.T + bias

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = round_bf16(g)
        d_w = gr.reshape(-1, gr.shape[-1]).T @ xr.reshape(-1, xr.shape[-1])
        return gr @ wr, d_w, g.reshape(-1, g.shape[-1]).sum(0)


def append_code(pts, code):
    """pts [..., P] with the time code [T] after its channels → [..., P +
    T], the input of a field with ``code_dim`` T."""
    return torch.cat([pts, code.expand(*pts.shape[:-1], code.shape[-1])], -1)


def trunk_layer_dims(depth: int, width: int, in_ch: int, skips: Sequence[int]):
    """(fan_in, fan_out) of each trunk layer, in the reference's order."""
    dims = []
    for i in range(depth - 1):
        if i == 0:
            dims.append((in_ch, width))
        dims.append((width + in_ch, width) if i in skips else (width, width))
    return dims


# the heads after rgb and alpha, by n_extra: (name, outputs, activation)
EXTRA_HEADS = {
    0: (),
    1: (("w_linear", 1, torch.sigmoid),),
    2: (("sf_linear", 6, torch.tanh), ("prob_linear", 2, torch.sigmoid)),
}


class NeRFField(nn.Module):
    """Field with view directions: volume-feature conditioning when
    ``use_mvs`` (multiplicative for v0, additive for v2), the scene-flow
    system's extra heads when ``sceneflow`` (the blend when ``static``, else
    the flow and the probabilities), and a time code of ``code_dim``
    channels after the embedded points when that is > 0."""

    def __init__(self, depth: int = 8, width: int = 256, in_ch_pts: int = 63,
                 in_ch_views: int = 27, in_ch_feat: int = 8,
                 skips: Sequence[int] = (4,), static: bool = True,
                 bf16: bool = False, sceneflow: bool = True,
                 use_mvs: bool = True, net_type: str = "v0",
                 code_dim: int = 0):
        super().__init__()
        if net_type not in ("v0", "v2"):
            raise ValueError(f"net_type {net_type!r}: v0 or v2")
        if net_type == "v2" and not use_mvs:
            which, key = (("static", "use_mvs") if static else
                          ("dynamic", "use_mvs_dy"))
            raise ValueError(
                f"net_type='v2' adds the volume features to every layer of "
                f"the {which} field, which has no volume ({key}=False): "
                f"zest_tpu's field fails there on features that are None")
        self.net_type, self.static, self.use_mvs = net_type, static, use_mvs
        if bf16 and not self.fused:
            raise ValueError("the bf16-operand mode is the fused field's; a "
                             "field without a volume or of net_type v2 "
                             "stays float32")
        self.bf16 = bf16
        self.depth, self.width = depth, width
        self.in_ch_pts, self.in_ch_views, self.in_ch_feat = \
            in_ch_pts, in_ch_views, in_ch_feat
        self.code_dim = code_dim
        self.skips = tuple(skips)
        self.n_extra = (1 if static else 2) if sceneflow else 0
        if use_mvs:
            self.pts_bias = nn.Linear(in_ch_feat, width)
        self.pts_linears = nn.ModuleList(
            nn.Linear(i, o) for i, o in trunk_layer_dims(
                depth, width, in_ch_pts + code_dim, skips))
        for name, n_out, _ in EXTRA_HEADS[self.n_extra]:
            setattr(self, name, nn.Linear(width, n_out))
        self.alpha_linear = nn.Linear(width, 1)
        self.feature_linear = nn.Linear(width, width)
        self.views_linears = nn.ModuleList(
            [nn.Linear(width + in_ch_views, width // 2)])
        self.rgb_linear = nn.Linear(width // 2, 3)

    @property
    def fused(self) -> bool:
        """The fused kernels take this field: v0, conditioned on a volume."""
        return self.use_mvs and self.net_type == "v0"

    @property
    def out_ch(self) -> int:
        return 4 + sum(n for _, n, _ in EXTRA_HEADS[self.n_extra])

    def extra_heads(self):
        """[(Linear, activation)] of the extra heads, in output order."""
        return [(getattr(self, name), act)
                for name, _, act in EXTRA_HEADS[self.n_extra]]

    def forward(self, pts, feats, views):
        """pts [..., in_ch_pts + code_dim], feats [..., in_ch_feat] (None
        without a volume), views [..., in_ch_views] → raw outputs [...,
        out_ch]."""
        mm = self._bf16_product if self.bf16 else (lambda lin, x: lin(x))
        bias = mm(self.pts_bias, feats) if self.use_mvs else None
        v2 = self.net_type == "v2"
        h = pts
        for i, layer in enumerate(self.pts_linears):
            z = mm(layer, h)
            if bias is not None:
                z = z + bias if v2 else z * bias
            h = torch.relu(z)
            if i in self.skips:
                h = torch.cat([pts, h], -1)
        extras = [act(lin(h)) for lin, act in self.extra_heads()]
        alpha = self.alpha_linear(h)
        feature = mm(self.feature_linear, h)
        hv = torch.relu(mm(self.views_linears[0], torch.cat([feature, views], -1)))
        rgb = self.rgb_linear(hv)
        if v2:
            alpha, rgb = torch.relu(alpha), torch.sigmoid(rgb)
        return torch.cat([rgb, alpha] + extras, -1)

    @staticmethod
    def _bf16_product(lin, x):
        return _BF16Linear.apply(x, lin.weight, lin.bias)
