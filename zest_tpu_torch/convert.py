"""``zest_tpu`` param tree → this port's state dict.

Inverts the layouts that ``zest_tpu/convert.py`` documents:
- Dense kernel [in, out]                  → Linear weight [out, in]
- nn.Conv kernel HWIO [kh, kw, in, out]   → Conv2d weight OIHW
- Conv3dZ2D kernel [kd, kh, kw, in, out]  → Conv3d weight [out, in, kd, kh, kw];
  the first cost-volume conv drops the inert input channels 41..47 that the
  TPU package pads in
- deconv_kernel, stored pre-flipped as [kd, kh, kw, in, out]
                                          → ConvTranspose3d [in, out, kd, kh, kw],
  spatial flip undone
- BatchNorm scale / bias                  → weight / bias
"""
from __future__ import annotations

import re

import numpy as np
import torch

COST_CHANNELS = 9 + 32


def _field(tree, prefix, out):
    for name, leaf in tree["params"].items():
        mod = re.sub(r"_(\d+)$", r".\1", name)   # pts_linears_3 -> pts_linears.3
        out[f"{prefix}.{mod}.weight"] = np.asarray(leaf["kernel"]).T
        out[f"{prefix}.{mod}.bias"] = np.asarray(leaf["bias"])


def _bn(tree, prefix, out):
    out[prefix + ".weight"] = np.asarray(tree["scale"])
    out[prefix + ".bias"] = np.asarray(tree["bias"])


def _encoder(tree, prefix, out):
    feat = tree["params"]["feature"]
    for name, blk in feat.items():
        if name == "toplayer":
            out[f"{prefix}.feature.toplayer.weight"] = \
                np.transpose(np.asarray(blk["kernel"]), (3, 2, 0, 1))
            out[f"{prefix}.feature.toplayer.bias"] = np.asarray(blk["bias"])
            continue
        level, j = name.split("_")                # conv1_2 -> conv1.2
        p = f"{prefix}.feature.{level}.{j}"
        out[p + ".conv.weight"] = np.transpose(np.asarray(blk["conv"]["kernel"]),
                                               (3, 2, 0, 1))
        _bn(blk["bn"], p + ".bn", out)
    for name, blk in tree["params"]["cost_reg_2"].items():
        p = f"{prefix}.cost_reg_2.{name}"
        if "deconv_kernel" in blk:
            k = np.transpose(np.asarray(blk["deconv_kernel"]), (3, 4, 0, 1, 2))
            out[p + ".0.weight"] = k[:, :, ::-1, ::-1, ::-1]
            _bn(blk["bn"], p + ".1", out)
        else:
            k = np.transpose(np.asarray(blk["conv"]["kernel"]), (4, 3, 0, 1, 2))
            if name == "conv0":
                k = k[:, :COST_CHANNELS]
            out[p + ".conv.weight"] = k
            _bn(blk["bn"], p + ".bn", out)


def from_jax_params(params) -> dict:
    """``zest_tpu.system.ZestSystem.init_params`` tree (arrays of any kind that
    numpy reads) → state dict of ``zest_tpu_torch.system.ZestSystem``.

    Converts whichever of the four top-level entries the tree holds, so a
    single field or encoder converts on its own."""
    out = {}
    for field in ("nerf_static", "nerf_dynamic"):
        if field in params:
            _field(params[field], field, out)
    for enc in ("enc_static", "enc_dy"):
        if enc in params:
            _encoder(params[enc], enc, out)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in out.items()}
