"""The GAN discriminators (counterpart of ``zest_tpu.models.discriminators``):

- ``BasicDiscriminator``  — an MLP 512 -> 256 -> 1 (a sigmoid for the naive
  GAN loss);
- ``NLayerDiscriminator`` — pix2pix's PatchGAN, its intermediate features
  on request (``get_interm_feat``);
- ``PixelDiscriminator``  — the 1x1 PatchGAN;
- ``GRAFDiscriminator``   — GRAF's stack of spectrally normalized
  convolutions (imsize 32, 64 or 128).

A discriminator takes the rays of its patches, [N, P * P, ch] row-major,
and reshapes them to images (NCHW here, NHWC in ``zest_tpu``, so every
output is the transpose of ``zest_tpu``'s). The layers sit in
``linears``, ``convs`` and ``norms``, numbered as ``zest_tpu``'s Flax
modules number theirs (``Conv_3`` is ``convs.3``: ``convert.
from_jax_disc_params``). The norms take batch statistics in training and
evaluation alike, as ``zest_tpu``'s do.

``SpectralConv`` normalizes its kernel by one power iteration per call
with ``u`` as a buffer, and its gradient flows through the iteration
(``torch.nn.utils.spectral_norm`` detaches it): the call leaves the next
``u`` in ``u_next``; ``spectral_state`` collects it for the caller to keep.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _leaky(x):
    return F.leaky_relu(x, 0.2)


class BasicDiscriminator(nn.Module):
    def __init__(self, in_dim: int, use_sigmoid: bool = True):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        self.linears = nn.ModuleList([nn.Linear(in_dim, 512),
                                      nn.Linear(512, 256), nn.Linear(256, 1)])

    def forward(self, img):
        x = img.reshape(img.shape[0], -1)
        x = _leaky(self.linears[0](x))
        x = _leaky(self.linears[1](x))
        x = self.linears[2](x)
        return torch.sigmoid(x) if self.use_sigmoid else x


def instance_norm(x, eps: float = 1e-5):
    """InstanceNorm2d without affine: each sample's channel over its
    positions, the variance biased."""
    mean = torch.mean(x, (2, 3), keepdim=True)
    var = torch.mean((x - mean) ** 2, (2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class BatchNorm(nn.Module):
    """BatchNorm2d with the batch's statistics always (no running ones)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean = torch.mean(x, (0, 2, 3), keepdim=True)
        var = torch.mean((x - mean) ** 2, (0, 2, 3), keepdim=True)
        return ((x - mean) * torch.rsqrt(var + self.eps)
                * self.weight[:, None, None] + self.bias[:, None, None])


def _to_nchw(img, size: int, ch: int):
    return img.reshape(-1, size, size, ch).permute(0, 3, 1, 2)


class NLayerDiscriminator(nn.Module):
    """pix2pix's PatchGAN: 4x4 convolutions, stride 2 n_layers times, then
    two of stride 1, BatchNorm after all but the first and the last."""

    def __init__(self, patch_size: int, input_nc: int = 3, ndf: int = 64,
                 n_layers: int = 3, get_interm_feat: bool = False):
        super().__init__()
        self.patch_size, self.input_nc = patch_size, input_nc
        self.get_interm_feat = get_interm_feat
        chans = [ndf * min(2 ** n, 8) for n in range(n_layers + 1)]
        convs = [nn.Conv2d(input_nc, ndf, 4, 2, 1)]
        for n in range(1, n_layers):
            convs.append(nn.Conv2d(chans[n - 1], chans[n], 4, 2, 1, bias=False))
        convs.append(nn.Conv2d(chans[n_layers - 1], chans[n_layers], 4, 1, 1,
                               bias=False))
        convs.append(nn.Conv2d(chans[n_layers], 1, 4, 1, 1))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList([BatchNorm(c) for c in chans[1:]])

    def forward(self, img):
        x = _to_nchw(img, self.patch_size, self.input_nc)
        x = _leaky(self.convs[0](x))
        feats = [x]
        for conv, norm in zip(self.convs[1:-1], self.norms):
            x = _leaky(norm(conv(x)))
            feats.append(x)
        feats.append(self.convs[-1](x))
        return feats if self.get_interm_feat else feats[-1]


class PixelDiscriminator(nn.Module):
    def __init__(self, patch_size: int, input_nc: int = 3, ndf: int = 64):
        super().__init__()
        self.patch_size, self.input_nc = patch_size, input_nc
        self.convs = nn.ModuleList([nn.Conv2d(input_nc, ndf, 1),
                                    nn.Conv2d(ndf, ndf * 2, 1, bias=False),
                                    nn.Conv2d(ndf * 2, 1, 1, bias=False)])
        self.norms = nn.ModuleList([BatchNorm(ndf * 2)])

    def forward(self, img):
        x = _to_nchw(img, self.patch_size, self.input_nc)
        x = _leaky(self.convs[0](x))
        x = _leaky(self.norms[0](self.convs[1](x)))
        return self.convs[2](x)


class SpectralConv(nn.Module):
    """A bias-free convolution whose kernel is divided by its largest
    singular value, estimated by one power iteration per call on the kernel
    as a [k * k * in, out] matrix (rows in HWIO order, as ``zest_tpu``
    flattens it). Nothing in the iteration is detached: the gradient flows
    through v and the new u. The new u is ``u_next`` after the call."""

    def __init__(self, in_ch: int, features: int, kernel: int = 4,
                 stride: int = 2, padding: int = 1):
        super().__init__()
        self.stride, self.padding = stride, padding
        bound = 1.0 / (in_ch * kernel * kernel) ** 0.5
        self.weight = nn.Parameter(
            torch.empty(features, in_ch, kernel, kernel).uniform_(-bound, bound))
        self.register_buffer("u", torch.randn(features))
        self.u_next = None

    def forward(self, x):
        w_mat = self.weight.permute(2, 3, 1, 0).reshape(-1, self.weight.shape[0])
        v = w_mat @ self.u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u_new = w_mat.T @ v
        u_new = u_new / (torch.linalg.vector_norm(u_new) + 1e-12)
        sigma = v @ (w_mat @ u_new)
        self.u_next = u_new.detach()
        w = self.weight / torch.clamp(sigma, min=1e-12)
        return F.conv2d(x, w, stride=self.stride, padding=self.padding)


class GRAFDiscriminator(nn.Module):
    """GRAF's patch discriminator: spectrally normalized 4x4 convolutions of
    stride 2 (ndf/2, ndf, 2 ndf at imsize 128; ndf, 2 ndf at 64; 2 ndf at
    32), then 4 ndf and 8 ndf, InstanceNorm after all but the first at
    128 and 64, and a final 4x4 convolution to one output. (``zest_tpu``'s
    random horizontal flip, ``hflip``, which ``build_discriminator`` never
    sets, is not ported.)"""

    def __init__(self, nc: int = 3, ndf: int = 64, imsize: int = 64):
        super().__init__()
        if imsize not in (32, 64, 128):
            raise ValueError(f"GRAF's discriminator takes imsize 32, 64 or "
                             f"128, not {imsize}")
        self.nc, self.imsize = nc, imsize
        widths = {128: [ndf // 2, ndf, ndf * 2], 64: [ndf, ndf * 2],
                  32: [ndf * 2]}[imsize] + [ndf * 4, ndf * 8]
        self.normed = [i > 0 or imsize == 32 for i in range(len(widths))]
        ins = [nc] + widths[:-1]
        self.convs = nn.ModuleList(
            [SpectralConv(i, o) for i, o in zip(ins, widths)]
            + [SpectralConv(widths[-1], 1, 4, 1, 0)])

    def forward(self, img):
        x = _to_nchw(img[..., :self.nc], self.imsize, self.nc)
        for conv, normed in zip(self.convs[:-1], self.normed):
            x = conv(x)
            x = _leaky(instance_norm(x) if normed else x)
        return self.convs[-1](x)


def spectral_state(disc: nn.Module) -> dict:
    """The ``u`` each ``SpectralConv`` of ``disc`` left after its last call,
    by buffer name (empty without spectral norm)."""
    return {f"{name}.u": m.u_next for name, m in disc.named_modules()
            if isinstance(m, SpectralConv)}


def build_discriminator(cfg) -> nn.Module:
    """The discriminator of ``cfg.gan_type``, as ``zest_tpu`` builds it."""
    if cfg.gan_type == "basic":
        return BasicDiscriminator(cfg.patch_size * cfg.patch_size * 3,
                                  use_sigmoid=cfg.gan_loss in (None, "naive"))
    if cfg.gan_type == "n_layers":
        return NLayerDiscriminator(cfg.patch_size, 3, 64, 3,
                                   get_interm_feat=cfg.getIntermFeat)
    if cfg.gan_type == "pixel":
        return PixelDiscriminator(cfg.patch_size, 3, 64)
    if cfg.gan_type == "graf":
        return GRAFDiscriminator(imsize=cfg.patch_size, nc=3, ndf=64)
    raise ValueError(cfg.gan_type)
