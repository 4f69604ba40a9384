"""``zest_tpu`` param tree → this port's state dict (``from_jax_params``
for the system, ``from_jax_disc_params`` for a discriminator), and the
reference's PyTorch-Lightning ``.ckpt`` → the same state dict
(``convert_checkpoint``).

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
- a discriminator's Flax modules ``Dense_i``, ``Conv_i``, ``SpectralConv_i``,
  ``_BatchNorm_i``                        → ``linears.i``, ``convs.i``,
  ``convs.i``, ``norms.i``; the spectral ``u`` as it is
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


def _tensors(out: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in out.items()}


def from_jax_params(params) -> dict:
    """``zest_tpu.system.ZestSystem.init_params`` tree (arrays of any kind that
    numpy reads) → state dict of ``zest_tpu_torch.system.ZestSystem``.

    Converts whichever of the top-level entries the tree holds (the two
    fields, the two encoders, ``train_video``'s ``time_codes``, which keep
    their [40, time_code_dim] layout), so a single field or encoder
    converts on its own."""
    out = {}
    for field in ("nerf_static", "nerf_dynamic"):
        if field in params:
            _field(params[field], field, out)
    for enc in ("enc_static", "enc_dy"):
        if enc in params:
            _encoder(params[enc], enc, out)
    if "time_codes" in params:
        out["time_codes"] = np.asarray(params["time_codes"])
    return _tensors(out)


_DISC_LISTS = {"Dense": "linears", "Conv": "convs", "SpectralConv": "convs",
               "_BatchNorm": "norms"}


def from_jax_disc_params(disc_params, disc_vars=None) -> tuple:
    """A ``zest_tpu`` discriminator's ``params`` and its other variables
    (``{"spectral": {"SpectralConv_i": {"u": ...}}}`` for GRAF's, empty for
    the others) → (parameters, buffers) of the port's module of the same
    kind (``models.discriminators``)."""
    params, buffers = {}, {}
    for name, leaf in disc_params.items():
        kind, i = name.rsplit("_", 1)
        p = f"{_DISC_LISTS[kind]}.{i}"
        if kind == "_BatchNorm":
            _bn(leaf, p, params)
            continue
        kernel = np.asarray(leaf["kernel"])
        params[p + ".weight"] = kernel.T if kind == "Dense" else \
            np.transpose(kernel, (3, 2, 0, 1))
        if "bias" in leaf:
            params[p + ".bias"] = np.asarray(leaf["bias"])
    for name, leaf in (disc_vars or {}).get("spectral", {}).items():
        buffers[f"convs.{name.rsplit('_', 1)[1]}.u"] = np.asarray(leaf["u"])
    return _tensors(params), _tensors(buffers)


# --------------------------------------------------------------------------
# the reference's Lightning checkpoint
# --------------------------------------------------------------------------

_FIELD_LAYERS = ("pts_bias", "alpha_linear", "feature_linear", "rgb_linear",
                 "w_linear", "sf_linear", "prob_linear", "output_linear",
                 "views_linears.0")
_FEATURE_LAYERS = ("conv0.0", "conv0.1", "conv1.0", "conv1.1", "conv1.2",
                   "conv2.0", "conv2.1", "conv2.2")
_COST_CONVS = ("conv0", "conv1", "conv2", "conv3", "conv4", "conv5", "conv6")
_COST_DECONVS = ("conv7", "conv9", "conv11")


def load_torch_state_dict(ckpt_path) -> dict:
    """The tensors of a reference checkpoint's ``state_dict`` (or of the
    file itself when it is a bare state dict), on the CPU.

    A Lightning ``.ckpt`` pickles its ``hyper_parameters`` (an
    ``argparse.Namespace``, or Lightning's ``AttributeDict``) beside the
    state dict, which ``torch.load(weights_only=True)`` refuses; so this
    loads with the full unpickler (``weights_only=False``), as
    ``zest_tpu.convert`` does. Unpickling runs code the file names: load
    only checkpoints you trust."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v.detach() for k, v in sd.items() if torch.is_tensor(v)}


def convert_nerf(sd: dict, prefix: str, name: str) -> dict:
    """One reference ``MVSNeRF`` field (``prefix`` e.g.
    ``nerf_static.nerf``) → the port's field ``name``'s entries: the
    trunk's ``pts_linears.i`` and the layers ``zest_tpu``'s converter
    takes, each weight and bias as it is (both are ``nn.Linear``)."""
    layers = []
    while f"{prefix}.pts_linears.{len(layers)}.weight" in sd:
        layers.append(f"pts_linears.{len(layers)}")
    layers += [layer for layer in _FIELD_LAYERS
               if f"{prefix}.{layer}.weight" in sd]
    return {f"{name}.{layer}.{leaf}": sd[f"{prefix}.{layer}.{leaf}"]
            for layer in layers for leaf in ("weight", "bias")}


def convert_mvsnet(sd: dict, prefix: str, name: str) -> dict:
    """One reference ``MVSNet`` encoder (``prefix`` e.g. ``encoding_net``)
    → the port's encoder ``name``'s entries; every one must be in ``sd``.
    The layouts are the port's already: InPlaceABN's weight and bias become
    the BatchNorm's (its running statistics are dropped: the encoder always
    normalizes with the batch's), ``ConvTranspose3d`` keeps [in, out, kd,
    kh, kw], and the first cost-volume conv keeps its 41 input channels."""
    conv_bn = ("conv.weight", "bn.weight", "bn.bias")
    leaves = ([f"feature.{layer}.{leaf}" for layer in _FEATURE_LAYERS
               for leaf in conv_bn]
              + ["feature.toplayer.weight", "feature.toplayer.bias"]
              + [f"cost_reg_2.{layer}.{leaf}" for layer in _COST_CONVS
                 for leaf in conv_bn]
              + [f"cost_reg_2.{layer}.{leaf}" for layer in _COST_DECONVS
                 for leaf in ("0.weight", "1.weight", "1.bias")])
    return {f"{name}.{leaf}": sd[f"{prefix}.{leaf}"] for leaf in leaves}


def convert_checkpoint(ckpt_path, cfg) -> dict:
    """A reference checkpoint → the state dict of ``system.ZestSystem(cfg)``
    (``load_state_dict(strict=True)`` takes it), with the entries
    ``zest_tpu.convert.convert_checkpoint`` takes: the fields
    ``nerf_static.nerf`` and ``nerf_dynamic.nerf`` with scene flow, else
    ``nerf_coarse.nerf`` as the static field; the encoders
    ``encoding_net`` and ``encoding_net_dy`` where the file has them; and
    ``time_codes``. Float32, contiguous tensors, as ``from_jax_params``
    gives them."""
    sd = load_torch_state_dict(ckpt_path)
    out = {}
    if cfg.train_sceneflow:
        out.update(convert_nerf(sd, "nerf_static.nerf", "nerf_static"))
        out.update(convert_nerf(sd, "nerf_dynamic.nerf", "nerf_dynamic"))
    else:
        out.update(convert_nerf(sd, "nerf_coarse.nerf", "nerf_static"))
    for src, dst in (("encoding_net", "enc_static"),
                     ("encoding_net_dy", "enc_dy")):
        if any(k.startswith(src + ".") for k in sd):
            out.update(convert_mvsnet(sd, src, dst))
    if "time_codes" in sd:
        out["time_codes"] = sd["time_codes"]
    return {k: v.to(torch.float32).contiguous() for k, v in out.items()}
