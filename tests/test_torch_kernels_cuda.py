"""zest_tpu_torch's CUDA kernels against their plain PyTorch twins, on the
card. Every test here needs a CUDA device and skips without one; the suite
imports no JAX, so on the GPU machine it runs without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py -q

Tolerances: the gathers (warp, volume lookup, color gather) form the same
coordinates as F.grid_sample and blend the same taps, atol 1e-5. The fused
field chains ten float32 products in another summation order than cuBLAS:
1e-4 of the output scale. The small eval slice: rtol = atol = 1e-4, since
cuDNN and the CPU order the convolution sums differently.
"""
import numpy as np
import pytest
import torch

from zest_tpu_torch.kernels.color_gather import gather_colors, gather_colors_plain
from zest_tpu_torch.kernels.fused_mlp import fused_nerf_forward
from zest_tpu_torch.kernels.plane_sweep import homo_warp_cm, homo_warp_cm_plain
from zest_tpu_torch.kernels.trilinear import sample_volume, sample_volume_plain
from zest_tpu_torch.models.nerf import NeRFField
from zest_tpu_torch.ops.homography import homography_grid

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def _max_err(a, b):
    torch.cuda.synchronize()
    return float((a - b).abs().max())


def test_plane_sweep_kernel_matches_twin(dev):
    g = _gen(dev)
    src = torch.randn((12, 40, 35), generator=g, device=dev)
    proj = torch.tensor([[1, 0.01, 0.5, 0.3], [0.02, 1, -0.3, 0.2],
                         [1e-4, 0, 1, 0.01]], device=dev)
    depths = torch.linspace(2.0, 6.0, 9, device=dev)
    grid = homography_grid(proj, depths, (12, 40), pad=4).contiguous()
    grid[0, 0, 0] = torch.tensor([1e7, -1e7], device=dev)   # far out of bounds
    before = homo_warp_cm.launches
    out = homo_warp_cm(src, grid)
    assert homo_warp_cm.launches == before + 1
    assert out.shape == (9, 35, 20 * 48)
    assert _max_err(out, homo_warp_cm_plain(src, grid)) <= 1e-5


def test_trilinear_kernel_matches_twin(dev):
    g = _gen(dev, 1)
    vol = torch.randn((16, 12, 20, 8), generator=g, device=dev)
    ndc = torch.rand((300, 7, 3), generator=g, device=dev) * 1.4 - 0.2
    before = sample_volume.launches
    out = sample_volume(vol, ndc)
    assert sample_volume.launches == before + 1
    assert out.shape == (300, 7, 8)
    assert _max_err(out, sample_volume_plain(vol, ndc)) <= 1e-5


def test_color_gather_kernel_matches_twin(dev):
    g = _gen(dev, 2)
    imgs = torch.rand((3, 20, 30, 3), generator=g, device=dev)
    xy = torch.rand((3, 500, 2), generator=g, device=dev) * \
        torch.tensor([36.0, 26.0], device=dev) - 3.0
    before = gather_colors.launches
    out = gather_colors(imgs, xy)
    assert gather_colors.launches == before + 1
    assert out.shape == (3, 500, 3)
    assert _max_err(out, gather_colors_plain(imgs, xy)) <= 1e-5


@pytest.mark.parametrize("width", [64, 128, 256])
@pytest.mark.parametrize("static", [True, False])
def test_fused_kernel_matches_twin(dev, width, static):
    P, F = (63, 40) if static else (84, 24)
    torch.manual_seed(3)
    field = NeRFField(8, width, P, 27, F, static=static).to(dev)
    g = _gen(dev, 4)
    n = 1000                                    # not a multiple of the tile
    pts, feats, views = (torch.randn((n, c), generator=g, device=dev)
                         for c in (P, F, 27))
    before = fused_nerf_forward.launches
    with torch.no_grad():
        out = fused_nerf_forward(field, pts, feats, views)
        ref = field(pts, feats, views)
    assert fused_nerf_forward.launches == before + 1
    assert out.shape == (n, 5 if static else 12)
    assert _max_err(out, ref) <= 1e-4 * max(1.0, float(ref.abs().max()))


def test_wrappers_reject_what_the_kernels_cannot_take(dev):
    vol = torch.zeros((4, 4, 4, 8), device=dev)
    ndc = torch.zeros((5, 3), device=dev)
    with pytest.raises(TypeError):
        sample_volume(vol.double(), ndc.double())
    with pytest.raises(ValueError):
        sample_volume(torch.zeros((4, 4, 4, 6), device=dev), ndc)
    with pytest.raises(ValueError):
        gather_colors(torch.zeros((2, 4, 4, 3), device=dev).transpose(1, 2),
                      torch.zeros((2, 5, 2), device=dev))
    with pytest.raises(ValueError):
        homo_warp_cm(torch.zeros((4, 4, 3), device=dev), ndc.cpu())


def test_eval_slice_on_cuda_matches_cpu(dev):
    from zest_tpu_torch import presets
    from zest_tpu_torch.system import EVAL_KEYS
    _, system, batch, params = presets.build(presets.SMALL, presets.SMALL_SCENE,
                                             "cpu")
    step = system.make_eval_step()
    ref = step(params, batch)
    launches = fused_nerf_forward.launches
    out = step({k: v.to(dev) for k, v in params.items()},
               {k: v.to(dev) for k, v in batch.items()})
    assert fused_nerf_forward.launches == launches + 4   # 2 chunks x 2 fields
    for k in EVAL_KEYS:
        np.testing.assert_allclose(out[k].cpu().numpy(), ref[k].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert float(ref["rgb_map_ref"].std()) > 1e-3
