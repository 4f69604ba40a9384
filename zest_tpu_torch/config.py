"""The port's configuration: the fields of ``zest_tpu.config.ZestConfig`` that
the eval path reads, with the same names and defaults.

Standard library only. Fields the port does not support yet (``net_type``
other than v0, ``train_video``, ``use_color_volume``, 16-bit precision) are
kept so that ``system.ZestSystem`` can refuse them by name.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ZestConfig:
    # images and the cost-volume frustum pad
    img_h: int = 288
    img_w: int = 544
    pad: int = 24

    # inputs and model switches
    pts_dim: int = 3
    dir_dim: int = 3
    num_input: int = 3
    net_type: str = "v0"
    use_color_volume: bool = False
    use_mvs: bool = False
    use_mvs_dy: bool = False
    train_video: bool = False
    num_keyframes: int = 10
    train_sceneflow: bool = False

    # fields
    netdepth: int = 6
    netwidth: int = 128
    pts_embedder: bool = True
    dir_embedder: bool = True
    multires: int = 10
    multires_views: int = 4

    # rendering
    N_samples: int = 128
    white_bkgd: bool = False
    chunk: int = 1024
    eval_chunk: int = 16384      # rays per eval chunk; 0 = use ``chunk``
    precision: int = 32
    bf16: bool = False

    @property
    def feat_dim(self) -> int:
        """Conditioning width of the static field: the volume's 8 channels
        plus RGB and an in-bounds mask per source view."""
        if self.train_sceneflow:
            return 8 + self.num_keyframes * 4
        return 8 + self.num_input * 4

    @property
    def feat_dim_dy(self) -> int:
        """Conditioning width of the dynamic field: 4 temporal neighbours."""
        return 8 + 4 * 4
