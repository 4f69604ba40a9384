"""Named configurations of the port's checks and measurements, each with the
synthetic scene it renders, and seeded weights.

``SMALL`` has the flagship's topology (both fields and both volumes, depth 8
with the skip after layer 4, multires 10 / 4) at test size: 3 keyframes,
32x64 images, width 64, 16 samples, and an eval chunk that does not divide
the image, so the last chunk is padded. ``FLAGSHIP`` is the eval
configuration of ``tools/bench_eval.py`` at float32: 8 keyframes plus the
target, 4 temporal neighbours, 288x512, 128 samples, width 256.
"""
from __future__ import annotations

import torch

from .config import ZestConfig
from .data.synthetic import SyntheticDataset
from .system import ZestSystem, to_batch

SMALL = dict(train_sceneflow=True, use_mvs=True, use_mvs_dy=True, pad=4,
             num_keyframes=3, netdepth=8, netwidth=64, multires=10,
             multires_views=4, N_samples=16, eval_chunk=1500, img_h=32,
             img_w=64)
SMALL_SCENE = dict(img_h=32, img_w=64, num_frames=9, num_keyframes=3)
FLAGSHIP = dict(train_sceneflow=True, use_mvs=True, use_mvs_dy=True, pad=24,
                num_keyframes=8, netdepth=8, netwidth=256, multires=10,
                multires_views=4, N_samples=128, eval_chunk=16384, img_h=288,
                img_w=512, precision=32)
FLAGSHIP_SCENE = dict(img_h=288, img_w=512, num_frames=24, num_keyframes=8)
TARGET_FRAME = 3


def seeded_params(system, seed: int = 0) -> dict:
    """``system.init_params`` from a CPU generator (the same numbers on every
    device), with both fields' alpha bias raised by 1: at random init σ ≤ 0
    everywhere is common, and renders exactly 0."""
    params = system.init_params(torch.Generator().manual_seed(seed))
    for field in ("nerf_static", "nerf_dynamic"):
        params[f"{field}.alpha_linear.bias"] += 1.0
    return params


def build(config: dict, scene: dict, device, seed: int = 0):
    """(cfg, system, batch, params) for a preset: the system on ``device``
    with the seeded weights loaded, the same weights as a state dict on
    ``device``, and the scene's target frame as a batch on ``device``."""
    cfg = ZestConfig(**config)
    system = ZestSystem(cfg).to(device)
    params = {k: v.to(device) for k, v in seeded_params(system, seed).items()}
    system.load_state_dict(params)
    batch = to_batch(SyntheticDataset(**scene)[TARGET_FRAME], device)
    return cfg, system, batch, params
