"""LPIPS with an AlexNet backbone (counterpart of ``zest_tpu.models.lpips``):
the perceptual training loss (``--with_perceptual_loss``) and the
``val_LPIPS`` metric.

The weights are a local ``.npz`` (``--lpips_weights``) in ``zest_tpu``'s
layout: ``conv{i}_w`` HWIO [k, k, in, out], ``conv{i}_b`` [out] and
``lin{i}_w`` [C] (non-negative), i = 0..4. ``load_lpips`` turns the kernels
to OIHW. ``make_random_lpips_npz`` writes such a file with seeded random
weights, which exercises the machinery, not perceptual parity.

AlexNet's features: conv1 3->64 k11 s4 p2, conv2 64->192 k5 p2, conv3
192->384 k3 p1, conv4 384->256 k3 p1, conv5 256->256 k3 p1, a ReLU after
each, a 3/2 max-pool after the first two; the five taps are the ReLU
outputs. LPIPS: each tap normalized per position over its channels as
x rsqrt(sum x^2 + 1e-10) (``zest_tpu``'s form), the squared difference,
a non-negative 1x1 linear, the spatial mean, summed over the taps. NCHW
here, NHWC in ``zest_tpu``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (out_ch, kernel, stride, pad) per conv; the tap is after its ReLU
_ALEX_CFG = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
             (256, 3, 1, 1), (256, 3, 1, 1)]
_POOL_AFTER = {0, 1}

# the lpips package's input scaling (its ScalingLayer)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def alexnet_features(params: dict, x):
    """x: [N, 3, H, W] in [-1, 1]. Returns the 5 taps, NCHW."""
    shift = torch.as_tensor(_SHIFT, device=x.device)[:, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[:, None, None]
    x = (x - shift) / scale
    taps = []
    for i, (_, _, s, p) in enumerate(_ALEX_CFG):
        x = torch.relu(F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"],
                                stride=s, padding=p))
        taps.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 3, 2)
    return taps


def _tap_sizes(n: int) -> list:
    """The taps' sizes along an image side of n pixels."""
    sizes = []
    for i, (_, k, s, p) in enumerate(_ALEX_CFG):
        n = (n + 2 * p - k) // s + 1
        sizes.append(n)
        if i in _POOL_AFTER:
            n = (n - 3) // 2 + 1
    return sizes


def lpips_distance(params: dict, img0, img1):
    """The LPIPS distance between two [H, W, 3] images in [0, 1] (scaled to
    [-1, 1] as the reference does). A 0-d tensor."""
    if min(_tap_sizes(img0.shape[0]) + _tap_sizes(img0.shape[1])) <= 0:
        raise ValueError(
            f"image {tuple(img0.shape[:2])} too small for AlexNet-LPIPS (a "
            f"feature tap has zero spatial size; need >= ~32 px)")
    x0 = (img0 * 2.0 - 1.0).permute(2, 0, 1)[None]
    x1 = (img1 * 2.0 - 1.0).permute(2, 0, 1)[None]
    taps0 = alexnet_features(params, x0)
    taps1 = alexnet_features(params, x1)
    total = 0.0
    for i, (t0, t1) in enumerate(zip(taps0, taps1)):
        n0 = t0 * torch.rsqrt(torch.sum(t0 ** 2, 1, keepdim=True) + 1e-10)
        n1 = t1 * torch.rsqrt(torch.sum(t1 ** 2, 1, keepdim=True) + 1e-10)
        d = (n0 - n1) ** 2
        lin = params[f"lin{i}_w"][:, None, None]
        total = total + torch.mean(torch.sum(d * lin, 1))
    return total


class LPIPS(nn.Module):
    """``lpips_distance`` with its weights as buffers (not trained, not in
    the state dict): ``LPIPS(params)(img0, img1)``, gradients flowing to
    the images."""

    def __init__(self, params: dict):
        super().__init__()
        for k, v in params.items():
            self.register_buffer(k, v, persistent=False)

    def forward(self, img0, img1):
        return lpips_distance(dict(self.named_buffers()), img0, img1)


def load_lpips(path, device="cpu") -> LPIPS:
    """An ``.npz`` of ``zest_tpu``'s layout -> ``LPIPS`` on ``device``: the
    HWIO kernels as OIHW."""
    with np.load(path) as data:
        params = {}
        for k in data.files:
            v = np.asarray(data[k], np.float32)
            if k.endswith("_w") and v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)
            params[k] = torch.from_numpy(np.ascontiguousarray(v))
    missing = [f"{kind}{i}_{p}" for i in range(len(_ALEX_CFG))
               for kind, p in (("conv", "w"), ("conv", "b"), ("lin", "w"))
               if f"{kind}{i}_{p}" not in params]
    if missing:
        raise KeyError(f"{path}: no {missing} in the LPIPS weights")
    return LPIPS(params).to(device)


def make_random_lpips_npz(out_path, seed: int = 0):
    """Write an LPIPS ``.npz`` with random weights from ``seed`` (the same
    numbers as ``zest_tpu.models.lpips.make_random_lpips_npz``): for
    exercising the loss and the metric, not a perceptual-parity metric."""
    rng = np.random.default_rng(seed)
    out = {}
    in_ch = 3
    for i, (out_ch, k, _, _) in enumerate(_ALEX_CFG):
        out[f"conv{i}_w"] = rng.normal(
            0, (2.0 / (k * k * in_ch)) ** 0.5,
            (k, k, in_ch, out_ch)).astype(np.float32)
        out[f"conv{i}_b"] = np.zeros(out_ch, np.float32)
        out[f"lin{i}_w"] = rng.uniform(0, 1, out_ch).astype(np.float32)
        in_ch = out_ch
    np.savez(out_path, **out)
