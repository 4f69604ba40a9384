"""Image quality metrics: PSNR and SSIM with window 5 (counterpart of
``zest_tpu.metrics``).

kornia's ``psnr(max_val=1)`` and ``ssim(window_size=5)`` semantics. Inputs
are [H, W, C] tensors on any device; each result is a 0-d tensor on that
device, in the inputs' dtype, which the caller reads when it needs it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(pred, gt, max_val: float = 1.0):
    """PSNR over the whole tensor."""
    mse = torch.mean((pred - gt) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / mse)


def _ssim_window(window_size: int, sigma: float = 1.5, dtype=torch.float32,
                 device=None):
    """The normalized 2D Gaussian window kornia's ssim filters with."""
    coords = (torch.arange(window_size, dtype=dtype, device=device)
              - window_size // 2)
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred, gt, window_size: int = 5, max_val: float = 1.0):
    """The mean of the full-size SSIM map of an image pair: each moment is a
    depthwise Gaussian filter over the reflect-padded image (kornia's
    ``padding='same'``, ``filter2d(border_type='reflect')``), so border
    pixels see reflected context. pred / gt [H, W, C] in [0, max_val]."""
    C1 = (0.01 * max_val) ** 2
    C2 = (0.03 * max_val) ** 2
    half = window_size // 2
    C = pred.shape[-1]
    win = _ssim_window(window_size, dtype=pred.dtype, device=pred.device)
    win = win.expand(C, 1, window_size, window_size)

    def conv(x):
        x = x.permute(2, 0, 1)[None]                          # [1, C, H, W]
        x = F.pad(x, (half, half, half, half), mode="reflect")
        return F.conv2d(x, win, groups=C)[0].permute(1, 2, 0)

    mu_p = conv(pred)
    mu_g = conv(gt)
    mu_pp = mu_p * mu_p
    mu_gg = mu_g * mu_g
    mu_pg = mu_p * mu_g
    sigma_pp = conv(pred * pred) - mu_pp
    sigma_gg = conv(gt * gt) - mu_gg
    sigma_pg = conv(pred * gt) - mu_pg

    num = (2 * mu_pg + C1) * (2 * sigma_pg + C2)
    den = (mu_pp + mu_gg + C1) * (sigma_pp + sigma_gg + C2)
    return torch.mean(num / den)
