"""Which output gradients the warp backward K2 reads, on the CPU.

K2 reads g only at the (plane, pixel) items that have a bilinear tap inside
the source (``plane_sweep.inside_items``). These tests hold that set to the
plain twin: an item is inside exactly where the warp of a source of ones
is nonzero (random grids put no tap on an exact pixel boundary), and
replacing g at every other item by noise leaves the twin's d_src bit for
bit the same.
"""
import numpy as np
import pytest
import torch

from zest_tpu_torch.kernels import plane_sweep
from zest_tpu_torch.ops.homography import homography_grid

H, W = 12, 40


def _grid(kind):
    if kind == "homography":            # a plane sweep, padded by 4
        proj = torch.tensor([[1, 0.01, 0.5, 0.3], [0.02, 1, -0.3, 0.2],
                             [1e-4, 0, 1, 0.01]])
        return homography_grid(proj, torch.linspace(2.0, 6.0, 9), (H, W),
                               pad=4)
    rng = np.random.default_rng(0)      # taps in, out and across every edge
    return torch.from_numpy(rng.uniform(-1.3, 1.3, size=(9, 20, 48, 2))
                            .astype(np.float32))


@pytest.mark.parametrize("kind", ["homography", "random"])
def test_inside_items_are_where_the_warp_reads(kind):
    grid = _grid(kind)
    mask = plane_sweep.inside_items(grid, (H, W))
    ones = torch.ones((H, W, 1))
    reach = plane_sweep.homo_warp_cm_plain(ones, grid)[:, 0]
    assert mask.shape == grid.shape[:3]
    assert torch.equal(mask, (reach > 0).reshape(mask.shape))
    assert 0 < int(mask.sum()) < mask.numel()


@pytest.mark.parametrize("kind", ["homography", "random"])
def test_warp_grad_ignores_g_outside(kind):
    grid = _grid(kind)
    rng = np.random.default_rng(1)
    D, Hp, Wp, _ = grid.shape
    src = torch.from_numpy(rng.normal(size=(H, W, 5)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(D, 5, Hp * Wp)).astype(np.float32))
    noise = torch.from_numpy(rng.normal(size=g.shape).astype(np.float32))
    inside = plane_sweep.inside_items(grid, (H, W)).reshape(D, 1, Hp * Wp)
    d_src = plane_sweep.homo_warp_cm_grad_plain(src, grid, g)
    assert torch.equal(
        plane_sweep.homo_warp_cm_grad_plain(src, grid,
                                            torch.where(inside, g, noise)),
        d_src)
    # and g inside does reach d_src
    assert not torch.equal(
        plane_sweep.homo_warp_cm_grad_plain(src, grid,
                                            torch.where(inside, noise, g)),
        d_src)
