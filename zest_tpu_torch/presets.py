"""Named configurations of the port's checks and measurements, each with the
synthetic scene it renders, and seeded weights.

``SMALL`` has the flagship's topology (both fields and both volumes, depth 8
with the skip after layer 4, multires 10 / 4) at test size: 3 keyframes,
32x64 images, width 64, 16 samples, and an eval chunk that does not divide
the image, so the last chunk is padded. ``FLAGSHIP`` is the eval
configuration of ``tools/bench_eval.py`` at float32: 8 keyframes plus the
target, 4 temporal neighbours, 288x512, 128 samples, width 256.

``FLAGSHIP_TRAIN`` is the training configuration of ``bench.py`` at float32:
the flagship's topology, 600 random rays plus 512 motion-mask rays (R =
1,112), density noise 1.0, the chain loss, decay_iteration 30, 6000 epochs of
``STEPS_PER_EPOCH`` steps. ``SMALL_TRAIN`` is ``SMALL`` with 24 + 8 rays and
decay_iteration 1, so that both phases of a step are reachable at small
step numbers (the chain pass runs after step 2000).

``FLAGSHIP_16`` and ``FLAGSHIP_TRAIN_16`` are the same configurations at
``precision=16``, exactly as ``tools/bench_eval.py`` and ``bench.py`` run
them; ``SMALL_16`` and ``SMALL_TRAIN_16`` are the small ones at 16 bits.

The paper's baselines and ablations, each its file's fields over the config
defaults (``configs/config_files/``), full width (depth 8, width 256,
multires 10 / 4, 128 samples), eval and training in one preset, with a
``_16`` twin and a ``SMALL_*`` twin at ``SMALL_TRAIN``'s sizes
(``FAMILIES`` lists them with their scenes):

- ``FLAGSHIP_MVSNERF`` (``config_mvsnerf_nsff_cross1.txt``): MVSNeRF's
  static field alone, no scene flow, 4 outputs, conditioned on the static
  volume of 8 source views (F = 8 + 4 * 8), 4096 rays, no motion-mask rays,
  density noise 1.0, pad 24, at the 288x544 the file leaves to the
  defaults;
- ``FLAGSHIP_NSFF`` (``config_nsff_general.txt``): both fields, no volume
  (plain MLPs), 2048 + 512 rays, pad 0, the chain loss, decay 30, 288x512;
- ``FLAGSHIP_STATIC_VOL`` (``config_kid-running_mvs_static_general.txt``):
  the static field on its volume, the dynamic one plain, 1024 + 512 rays;
- ``FLAGSHIP_DY_VOL`` (``config_kid-running_mvs_dyonly_general.txt``): the
  static field plain, the dynamic one on its volume, 1024 + 512 rays.

The SVS (adversarial) configuration, ``FLAGSHIP_SVS``
(``config_svs_nsff_cross1.txt``; the other 19 ``svs_*`` files differ in
their splits, scene, epochs or dataset): ``FLAGSHIP_MVSNERF``'s generator with
the files' GAN block, GRAF's discriminator at imsize 64 (ndf 64) on one
64x64 patch of 4,096 rays a step, the least-squares GAN loss, the depth
smoothness, distortion and LPIPS-AlexNet perceptual losses with the files'
lambdas, ``acc_grad`` 32 (which the GAN path ignores, as ``zest_tpu``
does) and ``lpips_weights`` at ``RANDOM_LPIPS``, a seeded random ``.npz``
that the caller writes (``write_random_lpips``: no real LPIPS weights are
on disk). ``SMALL_SVS`` is ``SMALL_MVSNERF`` with the same block at a
32x32 patch (GRAF at imsize 32); the caller points its ``lpips_weights``
at a file. ``SMALL_PATCHGAN`` (on ``PATCHGAN_SCENE``, 64x64) holds the GAN
options no configuration file sets. ``build_gan`` builds any of them with
its discriminators.

The three model options no configuration file sets, each over the
configuration it belongs to, with ``_16`` and ``SMALL_*`` twins:

- ``FLAGSHIP_V2``: ``FLAGSHIP_TRAIN`` with the additive ``net_type="v2"``
  fields (plain PyTorch, float32 at either precision);
- ``FLAGSHIP_COLORVOL``: ``FLAGSHIP_TRAIN`` with ``use_color_volume`` (the
  static field's features one lookup of a volume of 8 + 4 * 8 = 40
  channels);
- ``FLAGSHIP_VIDEO``: ``FLAGSHIP_MVSNERF``'s field and encoder with
  ``train_video`` (40 learnable time codes of 1,024 channels, the
  reference's default) on the Neural 3D Video loader's own 960x640 and its
  3 source views; its scene is one that ``tools.scene_fixtures.
  write_n3dv_scene`` writes (``VIDEO_SCENE``, its keyword arguments), not
  the synthetic one. ``SMALL_VIDEO`` takes the loader at ``downSample``
  0.1 (96x64) and 32 code channels.
"""
from __future__ import annotations

from pathlib import Path

import torch

from .config import ZestConfig
from .data.synthetic import SyntheticDataset
from .models.lpips import make_random_lpips_npz
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
_TRAIN = dict(use_motion_mask=True, with_chain_loss=True, raw_noise_std=1.0)
SMALL_TRAIN = dict(SMALL, **_TRAIN, batch_size=24, num_extra_samples=8,
                   decay_iteration=1, num_epochs=2)
FLAGSHIP_TRAIN = dict(FLAGSHIP, **_TRAIN, batch_size=600,
                      num_extra_samples=512, decay_iteration=30,
                      num_epochs=6000)
SMALL_16 = dict(SMALL, precision=16)
SMALL_TRAIN_16 = dict(SMALL_TRAIN, precision=16)
FLAGSHIP_16 = dict(FLAGSHIP, precision=16)
FLAGSHIP_TRAIN_16 = dict(FLAGSHIP_TRAIN, precision=16)
FLAGSHIP_MVSNERF = dict(FLAGSHIP, train_sceneflow=False, use_mvs_dy=False,
                        num_input=8, batch_size=4096, raw_noise_std=1.0,
                        num_epochs=6000, img_w=544)
MVSNERF_SCENE = dict(FLAGSHIP_SCENE, img_w=544)
FLAGSHIP_NSFF = dict(FLAGSHIP_TRAIN, use_mvs=False, use_mvs_dy=False,
                     batch_size=2048, pad=0)
FLAGSHIP_STATIC_VOL = dict(FLAGSHIP_TRAIN, use_mvs_dy=False, batch_size=1024)
FLAGSHIP_DY_VOL = dict(FLAGSHIP_TRAIN, use_mvs=False, batch_size=1024)
SMALL_MVSNERF = dict(SMALL, train_sceneflow=False, use_mvs_dy=False,
                     num_input=3, batch_size=32, raw_noise_std=1.0,
                     num_epochs=2)
SMALL_NSFF = dict(SMALL_TRAIN, use_mvs=False, use_mvs_dy=False, pad=0)
SMALL_STATIC_VOL = dict(SMALL_TRAIN, use_mvs_dy=False)
SMALL_DY_VOL = dict(SMALL_TRAIN, use_mvs=False)
FLAGSHIP_MVSNERF_16 = dict(FLAGSHIP_MVSNERF, precision=16)
FLAGSHIP_NSFF_16 = dict(FLAGSHIP_NSFF, precision=16)
FLAGSHIP_STATIC_VOL_16 = dict(FLAGSHIP_STATIC_VOL, precision=16)
FLAGSHIP_DY_VOL_16 = dict(FLAGSHIP_DY_VOL, precision=16)
SMALL_MVSNERF_16 = dict(SMALL_MVSNERF, precision=16)
SMALL_NSFF_16 = dict(SMALL_NSFF, precision=16)
SMALL_STATIC_VOL_16 = dict(SMALL_STATIC_VOL, precision=16)
SMALL_DY_VOL_16 = dict(SMALL_DY_VOL, precision=16)
# config_svs_*.txt's block over MVSNeRF's fields
_SVS = dict(gan_type="graf", gan_loss="lsgan", patch_size=64, acc_grad=32,
            lrate=5e-4, lrate_disc=1e-4, with_depth_smoothness=True,
            with_distortion_loss=True, with_perceptual_loss=True,
            lambda_rec=20.0, lambda_distortion=0.001, lambda_depth_smooth=0.4,
            lambda_adv=1.0, lambda_perc=1.0)
RANDOM_LPIPS = "build/lpips_random_seed0.npz"
FLAGSHIP_SVS = dict(FLAGSHIP_MVSNERF, **_SVS, lpips_weights=RANDOM_LPIPS)
FLAGSHIP_SVS_16 = dict(FLAGSHIP_SVS, precision=16)
SMALL_SVS = dict(SMALL_MVSNERF, **dict(_SVS, patch_size=32))
SMALL_SVS_16 = dict(SMALL_SVS, precision=16)
# the other GAN options at test size: pix2pix's PatchGAN with its features'
# matching term, the depth discriminator, the depth reconstruction and total
# variation, the naive GAN loss, two 32x32 square patches of a 64x64 image
SMALL_PATCHGAN = dict(SMALL_MVSNERF, img_h=64, gan_type="n_layers",
                      gan_loss="naive", getIntermFeat=True,
                      with_depth_loss=True, with_depth_loss_rec=True,
                      with_depth_loss_reg=True, patch_size=32,
                      batch_size=2048, lambda_rec=20.0, lambda_adv=1.0)
PATCHGAN_SCENE = dict(SMALL_SCENE, img_h=64)
# the three model options that no configuration file sets
FLAGSHIP_V2 = dict(FLAGSHIP_TRAIN, net_type="v2")
FLAGSHIP_V2_16 = dict(FLAGSHIP_V2, precision=16)
SMALL_V2 = dict(SMALL_TRAIN, net_type="v2")
SMALL_V2_16 = dict(SMALL_V2, precision=16)
FLAGSHIP_COLORVOL = dict(FLAGSHIP_TRAIN, use_color_volume=True)
FLAGSHIP_COLORVOL_16 = dict(FLAGSHIP_COLORVOL, precision=16)
SMALL_COLORVOL = dict(SMALL_TRAIN, use_color_volume=True)
SMALL_COLORVOL_16 = dict(SMALL_COLORVOL, precision=16)
_VIDEO = dict(train_video=True, dataset_name="neural3Dvideo", num_input=3)
FLAGSHIP_VIDEO = dict(FLAGSHIP_MVSNERF, **_VIDEO, time_code_dim=1024,
                      img_h=640, img_w=960)
FLAGSHIP_VIDEO_16 = dict(FLAGSHIP_VIDEO, precision=16)
SMALL_VIDEO = dict(SMALL_MVSNERF, **_VIDEO, time_code_dim=32, img_h=64,
                   img_w=96, imgScale_train=0.1, imgScale_test=0.1)
SMALL_VIDEO_16 = dict(SMALL_VIDEO, precision=16)
# write_n3dv_scene's keyword arguments: 6 cameras (3 source views of the 5
# others), 4 frames (keyframe ids 0-3), frames at the videos' 1352x1014
VIDEO_SCENE = dict(n_cams=6, n_frames=4, size=(1352, 1014))
# family -> (small preset, flagship preset, flagship scene, source file)
FAMILIES = {
    "mvsnerf": (SMALL_MVSNERF, FLAGSHIP_MVSNERF, MVSNERF_SCENE,
                "config_mvsnerf_nsff_cross1.txt"),
    "nsff": (SMALL_NSFF, FLAGSHIP_NSFF, FLAGSHIP_SCENE,
             "config_nsff_general.txt"),
    "static_vol": (SMALL_STATIC_VOL, FLAGSHIP_STATIC_VOL, FLAGSHIP_SCENE,
                   "config_kid-running_mvs_static_general.txt"),
    "dy_vol": (SMALL_DY_VOL, FLAGSHIP_DY_VOL, FLAGSHIP_SCENE,
               "config_kid-running_mvs_dyonly_general.txt"),
    "svs": (SMALL_SVS, FLAGSHIP_SVS, MVSNERF_SCENE,
            "config_svs_nsff_cross1.txt"),
    # the options over the files they belong to (none sets them)
    "v2": (SMALL_V2, FLAGSHIP_V2, FLAGSHIP_SCENE,
           "config_zest_fine_nsff_cross1.txt"),
    "colorvol": (SMALL_COLORVOL, FLAGSHIP_COLORVOL, FLAGSHIP_SCENE,
                 "config_zest_fine_nsff_cross1.txt"),
    "video": (SMALL_VIDEO, FLAGSHIP_VIDEO, VIDEO_SCENE,
              "config_mvsnerf_nsff_cross1.txt"),
}
STEPS_PER_EPOCH = 24
TARGET_FRAME = 3


def seeded_params(system, seed: int = 0) -> dict:
    """``system.init_params`` from a CPU generator (the same numbers on every
    device), with every field's alpha bias raised by 1: at random init σ ≤ 0
    everywhere is common, and renders exactly 0."""
    params = system.init_params(torch.Generator().manual_seed(seed))
    for field in ("nerf_static", "nerf_dynamic"):
        key = f"{field}.alpha_linear.bias"
        if key in params:
            params[key] += 1.0
    return params


def scene_of(config: dict, scene: dict) -> SyntheticDataset:
    """The synthetic scene with the views the config's volumes read."""
    return SyntheticDataset(**scene, use_mvs=config.get("use_mvs", False),
                            use_mvs_dy=config.get("use_mvs_dy", False))


def build(config: dict, scene: dict, device, seed: int = 0):
    """(cfg, system, batch, params) for a preset: the system on ``device``
    with the seeded weights loaded, the same weights as a state dict on
    ``device``, and the scene's target frame as a batch on ``device``."""
    cfg = ZestConfig(**config)
    system = ZestSystem(cfg).to(device)
    params = {k: v.to(device) for k, v in seeded_params(system, seed).items()}
    system.load_state_dict(params)
    batch = to_batch(scene_of(config, scene)[TARGET_FRAME], device)
    return cfg, system, batch, params


def write_random_lpips(path=RANDOM_LPIPS, seed: int = 0) -> str:
    """Write the seeded random LPIPS ``.npz`` that ``FLAGSHIP_SVS`` reads
    (its directory made first); returns the path."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    make_random_lpips_npz(path, seed)
    return str(path)


def build_gan(config: dict, scene: dict, device, seed: int = 0):
    """(cfg, gan, batch, state) for a GAN preset: ``build``'s system and
    weights inside a ``system_gan.GanSystem`` on ``device``, its
    discriminators from ``GanSystem.init`` on a CPU generator seeded
    ``seed + 1``, and the whole ``GanTrainState`` at step 0 on
    ``device``."""
    from .system_gan import GanSystem
    cfg, system, batch, params = build(config, scene, device, seed)
    gan = GanSystem(system).to(device)
    state = gan.init(torch.Generator().manual_seed(seed + 1), STEPS_PER_EPOCH)
    state = state.to(device)._replace(
        params=params, opt_state=system.make_optimizer(
            STEPS_PER_EPOCH).init(params))
    return cfg, gan, batch, state
