"""The port's configuration and its parser (counterpart of
``zest_tpu.config``): every field of ``zest_tpu.config.ZestConfig``, with the
same names, types and defaults, the reference's config-file format (``key =
value  # comment`` lines) and its CLI, where flags override the file and the
file overrides the defaults.

Standard library only. ``precision`` 16 (or ``bf16``) selects the 16-bit
path of ``system.ZestSystem``. ``train_sceneflow``, ``use_mvs`` and
``use_mvs_dy`` select the fields and volumes in any combination the
reference's config files use, and ``gan_type`` the adversarial (SVS)
step. ``dataset_name`` selects the loader (``data.dataset_dict``: the NSFF,
LLFF, DTU and Neural 3D Video scenes under ``datadir``, or the synthetic
scene). ``net_type`` (v0 or v2), ``use_color_volume`` and ``train_video``
(with ``time_code_dim``) select the model options. What the port does not
run is refused by name where it is read: another ``precision`` by
``system.ZestSystem``. The TPU package's kernel choices and bands
(``mesh_shape``, ``use_pallas_*``, ``warp_band``, ``warp_group``,
``z_band*``, ``use_fused_mlp``, ``color_band_train``) select among
``zest_tpu``'s implementations of the same values; the port has one CUDA
kernel for each, which needs no band, and reads none of them.
"""
from __future__ import annotations

import argparse
import dataclasses
import shlex
from dataclasses import dataclass
from pathlib import Path
from typing import Optional


@dataclass
class ZestConfig:
    # --- experiment / data ---
    config: Optional[str] = None
    expname: str = "exp"
    datadir: str = "./data/llff/fern"
    configdir: str = "./configs/"
    imgScale_train: float = 1.0
    imgScale_test: float = 1.0
    img_downscale: float = 1.0
    img_h: int = 288
    img_w: int = 544
    pad: int = 24

    # --- loader options ---
    batch_size: int = 1024
    patch_size: int = -1
    num_extra_samples: int = 512
    num_epochs: int = 8
    pts_dim: int = 3
    dir_dim: int = 3
    num_input: int = 3
    net_type: str = "v0"
    dataset_name: str = "blender"
    crossval: str = "NSFF"
    use_color_volume: bool = False

    # --- training options ---
    netdepth: int = 6
    netwidth: int = 128
    netdepth_fine: int = 6
    netwidth_fine: int = 128
    chunk: int = 1024
    netchunk: int = 1024
    ckpt: Optional[str] = None
    precision: int = 32
    acc_grad: int = 1
    use_mvs: bool = False
    use_mvs_dy: bool = False
    train_video: bool = False
    use_keyframes: bool = False
    num_keyframes: int = 10
    key_frames: bool = False       # neural3Dvideo keyframe-only training
    frame_jump: int = 1
    train_sceneflow: bool = False
    finetune_scene: Optional[str] = None
    seed_everything: int = -1      # -1: seed 0
    use_closest_views: bool = False
    use_motion_mask: bool = False

    # --- hyperparameters ---
    lrate: float = 5e-4
    lrate_disc: float = 1e-4
    lambda_rec: float = 200
    lambda_depth_reg: float = 0.1
    lambda_depth_smooth: float = 0.1
    lambda_distortion: float = 0.1
    lambda_perc: float = 0.1
    lambda_adv: float = 0.5
    lambda_cyc: float = 0.1
    lambda_prob_reg: float = 0.1
    lambda_sf_reg: float = 0.1
    lambda_sf_smooth: float = 0.1
    lambda_sf_depth: float = 0.04
    lambda_optical_flow: float = 0.02
    lambda_blending_reg: float = 1e-3
    time_code_dim: int = 1024
    decay_iteration: int = 50

    # --- losses ---
    gan_loss: Optional[str] = None  # naive | lsgan
    gan_type: Optional[str] = None  # basic | n_layers | pixel | graf
    getIntermFeat: bool = False
    with_depth_loss: bool = False
    with_depth_loss_rec: bool = False
    with_depth_loss_reg: bool = False
    with_depth_smoothness: bool = False
    with_distortion_loss: bool = False
    with_perceptual_loss: bool = False
    with_chain_loss: bool = False
    depth_path: Optional[str] = None

    # --- rendering options ---
    N_samples: int = 128
    N_importance: int = 0          # a fine network nothing renders: a no-op
    scale_anneal: float = 0.0025
    use_viewdirs: bool = False     # read by neither package
    pts_embedder: bool = True
    dir_embedder: bool = True
    multires: int = 10
    multires_views: int = 4
    raw_noise_std: float = 0.0
    target_idx: int = 10
    white_bkgd: bool = False

    # --- logging / saving ---
    N_vis: int = 20
    save_dir: str = "runs"
    vis_cnn: bool = False
    save_test: str = "test_suite"
    render_wanderpath: bool = False

    # --- beyond the reference's flags ---
    mesh_shape: Optional[str] = None
    bf16: bool = False             # the 16-bit path, as precision=16
    use_pallas_warp: bool = True
    warp_band: int = 16
    warp_group: int = 4
    use_pallas_trilinear: bool = True
    z_band: int = 3
    z_band_warped: int = 6
    use_fused_mlp: bool = True
    color_band_train: int = 24
    render_path: str = "auto"      # auto | wander | spiral | spheric
    eval_chunk: int = 16384        # rays per eval chunk; 0 = use ``chunk``
    lpips_weights: Optional[str] = None
    log_every: int = 50
    steps_per_epoch: int = 0       # 0 = the training set's length
    max_train_steps: int = -1      # -1 = num_epochs * steps_per_epoch

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

    def replace(self, **kw) -> "ZestConfig":
        return dataclasses.replace(self, **kw)


_FIELDS = {f.name: f for f in dataclasses.fields(ZestConfig)}
_BOOL_FLAGS = {name for name, f in _FIELDS.items()
               if f.type == "bool" or isinstance(f.default, bool)}


def _truthy(raw: str) -> bool:
    return raw.strip().lower() in ("true", "1", "yes")


def _coerce(name: str, raw: str):
    """A config-file string as the field's type."""
    if name not in _FIELDS:
        raise KeyError(f"Unknown config key: {name!r}")
    default = _FIELDS[name].default
    if name in _BOOL_FLAGS:
        return _truthy(raw)
    if isinstance(default, int):
        return int(float(raw))
    if isinstance(default, float):
        return float(raw)
    return raw


def parse_config_file(path) -> dict:
    """The keys of a config file, ``key = value  # comment`` per line."""
    out = {}
    for line in Path(path).read_text().splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or "=" not in line:
            continue
        key, _, val = line.partition("=")
        key, val = key.strip(), val.strip()
        if key:
            out[key] = _coerce(key, val)
    return out


def _build_argparser() -> argparse.ArgumentParser:
    """One ``--<field>`` flag per field; a bool flag alone means True and
    also takes an explicit value (``--use_mvs False``)."""
    p = argparse.ArgumentParser(description="zest-tpu-torch", allow_abbrev=False)
    for name, f in _FIELDS.items():
        if name in _BOOL_FLAGS:
            p.add_argument("--" + name, nargs="?", const=True, default=None,
                           type=_truthy)
        elif isinstance(f.default, int):
            p.add_argument("--" + name, type=int, default=None)
        elif isinstance(f.default, float):
            p.add_argument("--" + name, type=float, default=None)
        else:
            p.add_argument("--" + name, type=str, default=None)
    return p


def config_parser(cmd=None) -> ZestConfig:
    """A ZestConfig from the command line (``sys.argv`` by default, or a
    list or string of arguments) and the ``--config`` file it names: the
    flags given override the file, the file overrides the defaults.
    Arguments that are no field's flag are ignored."""
    if isinstance(cmd, str):
        cmd = shlex.split(cmd)
    ns, _ = _build_argparser().parse_known_args(cmd)
    values = {}
    if ns.config:
        values.update(parse_config_file(ns.config))
        values["config"] = ns.config
    for k, v in vars(ns).items():
        if v is not None and k != "config":
            values[k] = v
    return ZestConfig(**values)
