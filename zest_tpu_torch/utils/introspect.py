"""CNN introspection (``vis_cnn``): the MVS encoder's activations as tensors
and PCA images (counterpart of ``zest_tpu.utils.introspect``).

``dump_encoder_activations`` runs one encoder forward with forward hooks on
its FeatureNet and CostRegNet layers and writes ``zest_tpu``'s tree under
``out_dir``:

- ``2cnn_vis/{tensors,feat2viz}/<name>.{npy,png}``: FeatureNet's layers,
  channels-last [B, H, W, C];
- ``3cnn_vis/{tensors,feat2viz}/<name>.{npy,png}``: CostRegNet's layers,
  channels-last [B, D, H, W, C] (the PNG of the middle depth plane);
- ``cost_vol/tensors/volume_feat.npy``: the encoding volume [D, h, w, 8].

The names are ``zest_tpu``'s Flax paths: ``feature.conv1_2`` (a conv, its
BatchNorm and leaky ReLU), ``feature.conv1_2.conv``, ``feature.conv1_2.bn``,
``feature.toplayer``, ``feature``; ``cost_reg_2.conv0`` .. ``conv6`` with
their ``.conv`` and ``.bn``; ``cost_reg_2.conv7`` / ``conv9`` /
``conv11`` (transposed conv, BatchNorm) with their ``.bn``; ``cost_reg_2``.
This port's modules carry other names (``feature.conv1.2``, the transposed
conv's ``cost_reg_2.conv7.0`` / ``.1``); ``dump_names`` maps them. The
hooks sit on FeatureNet, CostRegNet and each BatchNorm: a block's output
is its BatchNorm's, and its ``.conv`` output its BatchNorm's input, so
16-bit encoders, whose convolutions bypass the conv modules' hooks, dump
them too, and each tensor is copied and reduced to its PCA image once;
bf16 activations are saved as float32.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..models.cost_reg import ConvBnReLU3D, _Up
from ..models.feature_net import ConvBnReLU
from .visualize import save_image


def feat2viz(feat: np.ndarray) -> np.ndarray:
    """[B, H, W, C] feature map → [B, H, W, 3] normalized PCA visualization
    (networks.py:1240-1253 semantics, channels-last, sklearn-free)."""
    b, h, w, c = feat.shape
    flat = feat.reshape(-1, c).astype(np.float64)
    flat = flat - flat.mean(0)
    # PCA via SVD of the (n, c) matrix
    _, _, vt = np.linalg.svd(flat, full_matrices=False)
    proj = flat @ vt[:3].T
    proj -= proj.min(0)
    proj /= proj.max(0) + 1e-12
    return proj.reshape(b, h, w, 3).astype(np.float32)


def _flax_name(name: str) -> str:
    """This port's module path → ``zest_tpu``'s: ``feature.conv1.2`` →
    ``feature.conv1_2``."""
    return re.sub(r"^feature\.conv(\d)\.(\d)", r"feature.conv\1_\2", name)


def dump_names(encoder: nn.Module) -> dict:
    """{this port's module path: (the ``zest_tpu`` names of its output, the
    ``zest_tpu`` name of its input or None)} for the modules whose hooks
    ``dump_encoder_activations`` reads: FeatureNet (its output is also the
    top layer's), CostRegNet, and each block's BatchNorm (whose output is
    also the block's, and whose input is the block's conv output)."""
    out = {"feature": (("feature", "feature.toplayer"), None),
           "cost_reg_2": (("cost_reg_2",), None)}
    for name, mod in encoder.named_modules():
        if isinstance(mod, (ConvBnReLU, ConvBnReLU3D)):
            flax = _flax_name(name)
            out[name + ".bn"] = ((flax + ".bn", flax), flax + ".conv")
        elif isinstance(mod, _Up):
            out[name + ".1"] = ((name + ".bn", name), None)
    return out


def _channels_last(t: torch.Tensor) -> np.ndarray:
    """[B, C, ...] → [B, ..., C] float32 numpy, C-contiguous."""
    return t.detach().float().movedim(1, -1).contiguous().cpu().numpy()


def _pca_image(arr: np.ndarray):
    """The PCA image of a dumped activation, or None for a map of one
    row or column: the first view's, of the middle depth plane of a
    volume."""
    if arr.ndim == 4 and min(arr.shape[1:3]) > 1:       # [B,H,W,C]
        return feat2viz(arr)[0]
    if arr.ndim == 5:                                    # [B,D,H,W,C]
        return feat2viz(arr[:, arr.shape[1] // 2])[0]
    return None


def dump_encoder_activations(encoder, imgs, proj_mats, near_far, pad,
                             out_dir) -> dict:
    """Run one forward of ``encoder`` (a ``models.MVSEncoder`` holding its
    weights) on imgs [V, H, W, 3], proj_mats [V, 3, 4], near_far [2] with
    ``pad``, capturing every FeatureNet / CostRegNet activation, and save
    each as ``<name>.npy`` plus a PCA PNG, and the encoding volume, under
    ``out_dir`` (``--save_test``). Returns {name: shape} of the captured
    activations, in ``zest_tpu``'s names and layouts."""
    out_dir = Path(out_dir)
    for sub in ("2cnn_vis", "3cnn_vis"):
        for kind in ("tensors", "feat2viz"):
            (out_dir / sub / kind).mkdir(parents=True, exist_ok=True)
    (out_dir / "cost_vol" / "tensors").mkdir(parents=True, exist_ok=True)

    names = dump_names(encoder)
    captured_arrays = {}

    def hook(path):
        out_names, in_name = names[path]

        def record(module, inputs, output):
            arr = _channels_last(output)
            for name in out_names:
                captured_arrays[name] = arr
            if in_name is not None:
                captured_arrays[in_name] = _channels_last(inputs[0])
        return record

    handles = [mod.register_forward_hook(hook(path))
               for path, mod in encoder.named_modules() if path in names]
    try:
        with torch.no_grad():
            vol, _, _ = encoder(imgs, proj_mats, near_far, pad=pad)
    finally:
        for h in handles:
            h.remove()
    captured, images = {}, {}
    for name, arr in captured_arrays.items():
        captured[name] = arr.shape
        sub = "2cnn_vis" if name.startswith("feature") else "3cnn_vis"
        np.save(out_dir / sub / "tensors" / f"{name}.npy", arr)
        if id(arr) not in images:       # a tensor dumped under two names
            images[id(arr)] = _pca_image(arr)
        if images[id(arr)] is not None:
            save_image(out_dir / sub / "feat2viz" / f"{name}.png",
                       images[id(arr)])
    np.save(out_dir / "cost_vol" / "tensors" / "volume_feat.npy",
            vol.detach().float().cpu().numpy())
    return captured
