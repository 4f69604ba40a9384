"""zest-tpu-torch: the PyTorch / CUDA port of ``zest_tpu`` for one NVIDIA H100.

The port mirrors ``zest_tpu``'s module names so each counterpart is easy to
find:

- ``geometry``, ``sampling``  — rays, NDC, flow reprojection, pixel grids and
                                 samplers, depth candidates, a step's draws
- ``ops``                      — grid sampling and the plane-sweep homography
- ``models``                   — positional encoding, FeatureNet, CostRegNet,
                                 the MVS encoder, the NeRF field, the GAN
                                 discriminators and LPIPS
- ``render``                   — two-field volume rendering (eval and training)
- ``losses``                   — the scene-flow loss bundle of a training
                                 step and the patch regularizers
- ``system``                   — ``ZestSystem``: its full-image eval step and
                                 its training step (clip, Adam, cosine LR)
- ``system_gan``               — ``GanSystem``: the adversarial (SVS) step,
                                 generator and discriminator updates
- ``train_loop``, ``metrics``  — the training loop, full-image validation
                                 and test, the CSV and W&B metric logs; PSNR
                                 and SSIM
- ``checkpoint``               — top-5 and ``last`` checkpoints, resume
- ``render_paths``             — the bullet-time wander path
- ``train``, ``test``,         — the command-line entry points
  ``fine_tune``,                 (``python -m zest_tpu_torch.train ...``),
  ``render_spiral``, ``cli``     twins of the root scripts
- ``convert``                  — ``zest_tpu`` param trees → this port's state
                                 dicts (the system's, a discriminator's);
                                 the reference's Lightning ``.ckpt`` → the
                                 system's
- ``parallel``                 — rays split over a ``torch.distributed``
                                 group (``ZestSystem.mesh``), spawned gloo
                                 ranks and the multi-rank dry run
- ``config``, ``data``         — the config dataclass and its parser, the
                                 synthetic scene and the wander path's poses
                                 (standard library and NumPy only), and the
                                 loop's prefetch thread (``data.pipeline``)
- ``utils.visualize``          — depth colormaps and a PNG writer
- ``utils.introspect``,        — ``vis_cnn``'s encoder dumps; the profiler,
  ``utils.observability``        anomaly mode, shape tracing, a step timer
                                 and device memory
- ``presets``                  — the small and the flagship eval and training
                                 configurations with seeded weights, for
                                 checks and measurements
- ``kernels``                  — hand-written CUDA kernels, forward and
                                 backward (sources in ``csrc/``), with their
                                 plain PyTorch twins
- ``tools``                    — profiling scripts and the quality gate

Nothing here imports JAX or ``zest_tpu``.
"""
from .config import ZestConfig
from .data.synthetic import SyntheticDataset

__all__ = ["ZestConfig", "SyntheticDataset"]
__version__ = "0.1.0"
