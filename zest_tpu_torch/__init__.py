"""zest-tpu-torch: the PyTorch / CUDA port of ``zest_tpu`` for one NVIDIA H100.

The port mirrors ``zest_tpu``'s module names so each counterpart is easy to
find:

- ``geometry``, ``sampling``  — rays, NDC, pixel grids, depth candidates
- ``ops``                      — grid sampling and the plane-sweep homography
- ``models``                   — positional encoding, FeatureNet, CostRegNet,
                                 the MVS encoder and the NeRF field
- ``render``                   — two-field volume rendering (eval path)
- ``system``                   — ``ZestSystem`` and its full-image eval step
- ``convert``                  — ``zest_tpu`` param tree → this port's state dict
- ``config``, ``data``         — the config dataclass and the synthetic scene
                                 (standard library and NumPy only)
- ``presets``                  — the small and the flagship configuration with
                                 seeded weights, for checks and measurements
- ``kernels``                  — hand-written CUDA kernels (sources in
                                 ``csrc/``) with their plain PyTorch twins

Nothing here imports JAX or ``zest_tpu``.
"""
from .config import ZestConfig
from .data.synthetic import SyntheticDataset

__all__ = ["ZestConfig", "SyntheticDataset"]
__version__ = "0.1.0"
