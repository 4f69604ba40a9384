"""The port's configuration: the fields of ``zest_tpu.config.ZestConfig`` that
the eval step, the training step and the training loop read, with the same
names and defaults.

Standard library only. ``precision`` 16 (or ``bf16``) selects the 16-bit
path of ``system.ZestSystem``. Fields the port does not support yet
(``net_type`` other than v0, ``train_video``, ``use_color_volume``, patches,
GAN, the depth and distortion regularizers; a checkpoint to resume from,
gradient accumulation, LPIPS weights) are kept so that
``system.ZestSystem`` and ``train_loop.run_training`` can refuse them by
name.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class ZestConfig:
    # the run: its name, where it writes, its seed (-1: seed 0)
    expname: str = "exp"
    save_dir: str = "runs"
    seed_everything: int = -1

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
    raw_noise_std: float = 0.0

    # training: rays, schedule and phases
    batch_size: int = 1024
    num_extra_samples: int = 512
    use_motion_mask: bool = False
    decay_iteration: int = 50
    with_chain_loss: bool = False
    lrate: float = 5e-4
    num_epochs: int = 8
    steps_per_epoch: int = 0     # 0 = the training set's length
    max_train_steps: int = -1    # -1 = num_epochs * steps_per_epoch

    # the loop: logs every log_every steps, validation every
    # min(N_vis, ceil(num_epochs / N_vis)) epochs
    log_every: int = 50
    N_vis: int = 20

    # loss weights of the scene-flow bundle
    lambda_cyc: float = 0.1
    lambda_prob_reg: float = 0.1
    lambda_sf_reg: float = 0.1
    lambda_sf_smooth: float = 0.1
    lambda_sf_depth: float = 0.04
    lambda_optical_flow: float = 0.02
    lambda_blending_reg: float = 1e-3

    # training switches the port does not support yet
    ckpt: Optional[str] = None
    acc_grad: int = 1
    lpips_weights: Optional[str] = None
    patch_size: int = -1
    gan_type: Optional[str] = None
    with_depth_loss_reg: bool = False
    with_depth_smoothness: bool = False
    with_distortion_loss: bool = False

    @property
    def decay_iteration_clamped(self) -> int:
        """Decay of the data-driven priors: min(decay_iteration, 250)."""
        return min(self.decay_iteration, 250)

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
