"""zest_tpu_torch's CUDA kernels (forward and backward) against their plain
PyTorch twins and their autograd, on the card. Every test here needs a CUDA device and skips without one; the suite
imports no JAX, so on the GPU machine it runs without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py -q

Tolerances: the gathers (warp, volume lookup, color gather) form the same
coordinates as F.grid_sample and blend the same taps, atol 1e-5. The fused
field's float32 mode runs on the tensor cores as 3xTF32
(``csrc/fused_mlp_tc32.cu``): every operand split into two TF32 values,
~22 bits kept, ten products chained in another summation order than
cuBLAS: 1e-4 of the output scale, at every width, both field layouts, with
and without the skip layer and at ragged point counts around its 64-point
tile. That tolerance alone would pass one TF32 product at width 256, so on
a thousand points the output is also held to a float64 twin at 2^-20
norm-wise, which one TF32 product misses by two orders of magnitude. Its
float32 operand pack, made on the card, equals its twin bit for bit. The
small eval slice: rtol = atol = 1e-4, since cuDNN and the CPU order the
convolution sums differently.

The backward kernels: K2 (warp) and K4 (volume) add with atomics in an order
that changes from run to run, K5 (coordinates) sums 8 corners in another
order than F.grid_sample, and K7 (field) sums the weight gradients over the
points in tiles and chunks: each is held to 1e-5 (the gathers) or 1e-4 (the
field) of its output's scale, never bit for bit; K7's weight gradient leaf
by leaf, each weight and each bias to 1e-4 of its own largest element.
K7's float32 mode runs pass 1 on the CUDA cores and pass 2, the weight
gradients, on the tensor cores as 3xTF32 (``csrc/fused_mlp_tc32_bwd.cu``),
once per chunk each (a spy on the C entries; the old SIMT weight-gradient
kernel is not in the built library), at
every width, both field layouts, with and without the skip layer, at
ragged point counts and across two chunks. Each pass-2 launch is held to
its twin on the same scratch buffers, and the whole backward, heads
included, to the twin's autograd, each leaf to 1e-4 of its largest. That
tolerance alone would pass one TF32 product, so on a thousand points each
weight gradient of the conditioning, trunk, feature and views layers is
also held to a float64 twin at max(8 x the float32 twin's own norm-wise
distance, 2^-20), which one TF32 product (~3e-4) misses.

The row gather K9 copies rows: bitwise equal to ``tab[idx]``. Its
scatter-add adds in float32 with atomics, in another order than
``index_add_``, and both round the sum to the table's type once: a float32
table to 1e-6 of the largest sum, a bf16 one to one bf16 rounding step
(2^-8) of it; on integer-valued gradients, whose float32 sums are exact in
any order, bit for bit. The bf16-operand field kernels round the same operands as
their twin, but a float32 sum in another order can flip one bf16 rounding
of an activation (2^-8 of that operand): K6 to 1e-3 of the output scale.
Both bf16 modes run on the tensor cores (K6 ``csrc/fused_mlp_tc.cu``, K7
``csrc/fused_mlp_tc_bwd.cu``), at every width, both field layouts (P / F =
63 / 40 and 84 / 24, K dims that are no multiple of 16), with and without
the skip layer, and ragged point counts around their 64-point tile and
across K7's chunks. K7's bf16 mode takes its gradient at K6's own forward
(its recompute equals K6's output bit for bit: the same device code on the
same bf16 pack), whose float32 sums are the tensor cores' and not
cuBLAS's. Where a ReLU input lies within that rounding noise of zero, the
twin's forward and K6's take different branches, and that point's gradient
jumps by far more than a rounding step; on a few hundred points one such
point moves a weight gradient by more than 2^-8 of its largest, and the
float32 twin differs from a float64 twin by as much at some of these
seeds (PERF.md §6). So K7's bf16 mode is held two ways. (1) To the twin's
backward at the forward values K7 ran at (``fused_nerf_backward_at_plain``,
which the CPU tests hold to the twin's autograd), from one chunk, at 2^-8
of each input's and each leaf's largest gradient; those forward values
(cond, every z_i, hv, the feature layer's output) are held to the twin's
own forward (``forward_values_plain``), within 2^-8 norm-wise and 2^-6 of
their largest. A run in other chunks gives the same input gradients bit
for bit (each point's sums are its own) and the same weight gradients to
1e-5 (split-K sums). (2) On a thousand points, to the twin's autograd
with a criterion that the kink noise passes, as chip_smoke.py holds it on
the flagship passes: each input and leaf within 2^-8 norm-wise, the rows
beyond 2^-8 of their input's largest at most 2^-9 of the rows, each leaf's
largest error within 2^-6 of its largest. Both bf16 weight packs, made on
the card, equal their twins bit for bit.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from zest_tpu_torch.kernels.color_gather import gather_colors, gather_colors_plain
from zest_tpu_torch.kernels import dma_gather, fused_mlp, plane_sweep, trilinear
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


def _spy_forward_entries(monkeypatch):
    """Count the calls of K6's two C entry points (float32 as 3xTF32, bf16;
    both on the tensor cores)."""
    from zest_tpu_torch.kernels import _build
    lib, calls = _build.library(), {}
    for name in ("zt_fused_nerf_forward_tc32", "zt_fused_nerf_forward_tc"):
        def spy(*args, _fn=getattr(lib, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(lib, name, spy)
    return calls


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000])
@pytest.mark.parametrize("width", [64, 128, 256])
@pytest.mark.parametrize("static", [True, False])
def test_bf16_field_forward_on_tensor_cores(dev, width, static, n,
                                            monkeypatch):
    """K6's bf16 mode takes the tensor-core kernel at every width and holds
    the bf16 twin to 1e-3 of max(1, |out|) at ragged point counts."""
    calls = _spy_forward_entries(monkeypatch)
    P, F = (63, 40) if static else (84, 24)
    torch.manual_seed(21)
    field = NeRFField(8, width, P, 27, F, static=static, bf16=True).to(dev)
    g = _gen(dev, 22)
    pts, feats, views = (torch.randn((n, c), generator=g, device=dev)
                         for c in (P, F, 27))
    before = fused_nerf_forward.launches
    with torch.no_grad():
        out = fused_nerf_forward(field, pts, feats, views)
        ref = field(pts, feats, views)
    assert fused_nerf_forward.launches == before + 1
    assert calls == {"zt_fused_nerf_forward_tc": 1}
    assert out.shape == (n, field.out_ch)
    assert bool(torch.isfinite(out).all())
    assert _max_err(out, ref) <= 1e-3 * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("skips", [(4,), ()])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000])
@pytest.mark.parametrize("width", [64, 128, 256])
@pytest.mark.parametrize("static", [True, False])
def test_float32_field_forward_on_tensor_cores(dev, width, static, n, skips,
                                               monkeypatch):
    """K6's float32 mode takes the 3xTF32 tensor-core kernel at every width
    and holds the float32 twin to 1e-4 of max(1, |out|) at ragged point
    counts, with and without the skip layer."""
    calls = _spy_forward_entries(monkeypatch)
    P, F = (63, 40) if static else (84, 24)
    torch.manual_seed(23)
    field = NeRFField(8, width, P, 27, F, skips=skips, static=static).to(dev)
    g = _gen(dev, 24)
    pts, feats, views = (torch.randn((n, c), generator=g, device=dev)
                         for c in (P, F, 27))
    before = fused_nerf_forward.launches
    with torch.no_grad():
        out = fused_nerf_forward(field, pts, feats, views)
        ref = field(pts, feats, views)
    assert fused_nerf_forward.launches == before + 1
    assert calls == {"zt_fused_nerf_forward_tc32": 1}
    assert out.shape == (n, field.out_ch)
    assert bool(torch.isfinite(out).all())
    assert _max_err(out, ref) <= 1e-4 * max(1.0, float(ref.abs().max()))


def _norm_dist(a, b):
    torch.cuda.synchronize()
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("width", [64, 128, 256])
@pytest.mark.parametrize("static", [True, False])
def test_float32_field_forward_is_float32_class(dev, width, static):
    """Three TF32 products keep ~22 bits of each operand: on a thousand
    points K6's float32 mode is within 2^-20 norm-wise of a float64 twin,
    which one TF32 product (~11 bits) misses by far; the float32 twin's
    own distance is the yardstick."""
    import copy
    P, F = (63, 40) if static else (84, 24)
    torch.manual_seed(3)
    field = NeRFField(8, width, P, 27, F, static=static).to(dev)
    wide = copy.deepcopy(field).double()
    g = _gen(dev, 26)
    pts, feats, views = (torch.randn((1000, c), generator=g, device=dev)
                         for c in (P, F, 27))
    with torch.no_grad():
        out = fused_nerf_forward(field, pts, feats, views)
        ref = wide(pts.double(), feats.double(), views.double())
        twin = field(pts, feats, views)
    got = _norm_dist(out, ref)
    assert got <= 2.0 ** -20, (got, _norm_dist(twin, ref))


@pytest.mark.parametrize("skips", [(4,), ()])
@pytest.mark.parametrize("width", [64, 128, 256])
@pytest.mark.parametrize("static", [True, False])
def test_tc32_pack_kernel_matches_twin(dev, width, static, skips):
    """K6's float32 operand pack, made on the card from the float32 pack,
    equals its twin bit for bit (the same values, moved)."""
    P, F = (63, 40) if static else (84, 24)
    torch.manual_seed(27)
    field = NeRFField(8, width, P, 27, F, skips=skips, static=static).to(dev)
    with torch.no_grad():
        pack, offsets = fused_mlp.pack_weights(field)
    out = fused_mlp.pack_tc32(field, pack, offsets)
    ref = fused_mlp.pack_tc32_plain(field, pack, offsets)[0]
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert torch.equal(out, ref)


@pytest.mark.parametrize("skips", [(4,), ()])
@pytest.mark.parametrize("width", [64, 128, 256])
@pytest.mark.parametrize("static", [True, False])
def test_bf16_pack_kernel_matches_twin(dev, width, static, skips):
    """K6's bf16 pack, made on the card from the float32 pack, equals its
    twin bit for bit (the same rounding of the same values)."""
    P, F = (63, 40) if static else (84, 24)
    torch.manual_seed(25)
    field = NeRFField(8, width, P, 27, F, skips=skips, static=static,
                      bf16=True).to(dev)
    with torch.no_grad():
        pack, offsets = fused_mlp.pack_weights(field)
    out = fused_mlp.pack_bf16(field, pack, offsets)
    ref = fused_mlp.pack_bf16_plain(field, pack, offsets)[0]
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert torch.equal(out, ref)


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


def _rel_err(a, b):
    torch.cuda.synchronize()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("shape", [(12, 40, 35, 9, 4), (7, 33, 5, 3, 0)])
def test_warp_backward_kernel_matches_autograd(dev, shape):
    """K2 against autograd through the twin; the second shape has a pixel
    count (7 x 33 padded by 0) that fills no block evenly."""
    h, w, C, D, pad = shape
    g = _gen(dev, 5)
    src = torch.randn((h, w, C), generator=g, device=dev)
    proj = torch.tensor([[1, 0.01, 0.5, 0.3], [0.02, 1, -0.3, 0.2],
                         [1e-4, 0, 1, 0.01]], device=dev)
    grid = homography_grid(proj, torch.linspace(2.0, 6.0, D, device=dev),
                           (h, w), pad=pad).contiguous()
    cot = torch.randn((D, C, grid.shape[1] * grid.shape[2]), generator=g,
                      device=dev)
    before = plane_sweep.homo_warp_cm_grad.launches
    s_ = src.clone().requires_grad_(True)
    (homo_warp_cm(s_, grid) * cot).sum().backward()
    assert plane_sweep.homo_warp_cm_grad.launches == before + 1
    ref = plane_sweep.homo_warp_cm_grad_plain(src, grid, cot)
    assert _rel_err(s_.grad, ref) <= 1e-5


def test_warp_backward_kernel_wide_footprint(dev):
    """A homography that spreads a row's taps over the whole source: the
    kernel's direct-atomics path."""
    g = _gen(dev, 6)
    src = torch.randn((64, 128, 8), generator=g, device=dev)
    proj = torch.tensor([[0.2, 1.0, 0.0, 3.0], [1.0, 0.1, 0.0, 2.0],
                         [0.0, 0.0, 1.0, 0.0]], device=dev)
    grid = homography_grid(proj, torch.linspace(2.0, 6.0, 16, device=dev),
                           (64, 128)).contiguous()
    cot = torch.randn((16, 8, 64 * 128), generator=g, device=dev)
    out = plane_sweep.homo_warp_cm_grad(cot, grid, (64, 128))
    ref = plane_sweep.homo_warp_cm_grad_plain(src, grid, cot)
    assert _rel_err(out, ref) <= 1e-5


def _flagship_warp_grid(dev):
    """The flagship's K2 grid: 128 planes, pad 24, a 72x128 source, the
    synthetic scene's source view 1."""
    from zest_tpu_torch import presets
    from zest_tpu_torch.data.synthetic import SyntheticDataset
    from zest_tpu_torch.models.mvsnet import depth_plane_values
    from zest_tpu_torch.system import to_batch
    batch = to_batch(SyntheticDataset(**presets.FLAGSHIP_SCENE)
                     [presets.TARGET_FRAME], dev)
    near, far = batch["near_fars"][0]
    grid = homography_grid(batch["proj_mats"][1], depth_plane_values(near, far),
                           (72, 128), pad=24).contiguous()
    assert grid.shape == (128, 120, 176, 2)
    return grid


def test_warp_backward_kernel_flagship_shape(dev):
    """K2 at the flagship's shape: a 72x128 source of 35 channels, 128
    planes, pad 24, the grid of the synthetic scene's source view 1."""
    grid = _flagship_warp_grid(dev)
    g = _gen(dev, 14)
    src = torch.randn((72, 128, 35), generator=g, device=dev)
    cot = torch.randn((128, 35, 120 * 176), generator=g, device=dev)
    out = plane_sweep.homo_warp_cm_grad(cot, grid, (72, 128))
    ref = plane_sweep.homo_warp_cm_grad_plain(src, grid, cot)
    assert _rel_err(out, ref) <= 1e-5


def test_warp_backward_kernel_reads_only_inside_items(dev):
    """K2 at the flagship's shape reads g only at ``inside_items``, the
    items chip_smoke counts in K2's bound: with noise in g at every other
    item, the kernel still agrees with the twin on the clean g (1e-5
    relative: its float32 atomics add in a varying order)."""
    grid = _flagship_warp_grid(dev)
    inside = plane_sweep.inside_items(grid, (72, 128)).reshape(128, 1, -1)
    assert 0 < int(inside.sum()) < inside.numel()
    g = _gen(dev, 20)
    src = torch.randn((72, 128, 35), generator=g, device=dev)
    cot = torch.randn((128, 35, 120 * 176), generator=g, device=dev)
    noise = 1e3 * torch.randn(cot.shape, generator=g, device=dev)
    out = plane_sweep.homo_warp_cm_grad(torch.where(inside, cot, noise), grid,
                                        (72, 128))
    ref = plane_sweep.homo_warp_cm_grad_plain(src, grid, cot)
    assert _rel_err(out, ref) <= 1e-5


def _warp_backward_case(dev, seed, grid):
    g = _gen(dev, seed)
    src = torch.randn((12, 40, 35), generator=g, device=dev)
    cot = torch.randn((grid.shape[0], 35, grid.shape[1] * grid.shape[2]),
                      generator=g, device=dev)
    return (plane_sweep.homo_warp_cm_grad(cot, grid, (12, 40)),
            plane_sweep.homo_warp_cm_grad_plain(src, grid, cot))


def test_warp_backward_kernel_one_patch(dev):
    """Every tap of every plane and pixel falls in one 2x2 source patch (x
    in (5, 6), y in (3, 4)): the most contended atomics."""
    g = _gen(dev, 15)
    xy = torch.rand((9, 20, 48, 2), generator=g, device=dev) * 0.98 + 0.01
    xy += torch.tensor([5.0, 3.0], device=dev)
    grid = (xy / torch.tensor([39 / 2, 11 / 2], device=dev) - 1.0).contiguous()
    out, ref = _warp_backward_case(dev, 16, grid)
    assert int((out.abs().sum(-1) > 0).sum()) == 4
    assert _rel_err(out, ref) <= 1e-5


def test_warp_backward_kernel_all_outside(dev):
    """Every tap falls outside the source: d_src is exactly zero."""
    g = _gen(dev, 17)
    grid = torch.rand((9, 20, 48, 2), generator=g, device=dev) * 2.0 - 1.0
    grid[..., 0] = grid[..., 0].abs() + 1.1        # right of the last column
    out, ref = _warp_backward_case(dev, 18, grid.contiguous())
    assert torch.equal(out, torch.zeros_like(out)) and torch.equal(out, ref)


@pytest.mark.parametrize("n_points", [300 * 7, 1, 12345])
def test_volume_backward_kernels_match_autograd(dev, n_points):
    """K4 (d_vol) and K5 (d_ndc) against F.grid_sample's autograd, with
    points outside the volume and a count that fills no block evenly."""
    g = _gen(dev, 7)
    vol = torch.randn((16, 12, 20, 8), generator=g, device=dev)
    ndc = torch.rand((n_points, 3), generator=g, device=dev) * 1.4 - 0.2
    cot = torch.randn((n_points, 8), generator=g, device=dev)
    v_, n_ = (t.clone().requires_grad_(True) for t in (vol, ndc))
    launches = (trilinear.volume_grad.launches, trilinear.coords_grad.launches)
    (sample_volume(v_, n_) * cot).sum().backward()
    assert (trilinear.volume_grad.launches, trilinear.coords_grad.launches) \
        == (launches[0] + 1, launches[1] + 1)
    d_vol, d_ndc = trilinear.sample_volume_grads_plain(vol, ndc, cot)
    assert _rel_err(v_.grad, d_vol) <= 1e-5
    assert _rel_err(n_.grad, d_ndc) <= 1e-5


def test_volume_backward_skips_coords_without_grad(dev):
    g = _gen(dev, 8)
    vol = torch.randn((8, 8, 8, 8), generator=g, device=dev, requires_grad=True)
    ndc = torch.rand((100, 3), generator=g, device=dev)
    launches = trilinear.coords_grad.launches
    sample_volume(vol, ndc).sum().backward()
    assert trilinear.coords_grad.launches == launches
    with torch.no_grad():
        assert sample_volume(vol, ndc).grad_fn is None


@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("static", [True, False])
def test_field_backward_kernel_matches_autograd(dev, width, static, monkeypatch):
    """K7 against autograd through the field module: d_pts, d_feats,
    d_views and every weight's gradient; 1000 points (a ragged last tile),
    in chunks of 384 so the weight gradients add over three chunks."""
    monkeypatch.setattr(fused_mlp, "CHUNK_ROWS", 384)
    P, F = (63, 40) if static else (84, 24)
    torch.manual_seed(9)
    field = NeRFField(8, width, P, 27, F, static=static).to(dev)
    g = _gen(dev, 10)
    n = 1000
    pts, feats, views = (torch.randn((n, c), generator=g, device=dev)
                         for c in (P, F, 27))
    cot = torch.randn((n, field.out_ch), generator=g, device=dev)
    ins = [t.clone().requires_grad_(True) for t in (pts, feats, views)]
    before = fused_mlp.fused_nerf_backward.launches
    field.zero_grad()
    (fused_nerf_forward(field, *ins) * cot).sum().backward()
    assert fused_mlp.fused_nerf_backward.launches == before + 1
    _, offsets = fused_mlp.pack_weights(field)
    got = [t.grad for t in ins] + [fused_mlp.pack_grads(field)]
    ref = fused_mlp.fused_nerf_backward_plain(field, pts, feats, views, cot)
    for name, a, b in zip(("d_pts", "d_feats", "d_views"), got, ref):
        assert _rel_err(a, b) <= 1e-4, name
    # every weight and bias to 1e-4 of its own largest gradient
    for (name, a), (_, b) in zip(fused_mlp.pack_leaves(field, got[3], offsets),
                                 fused_mlp.pack_leaves(field, ref[3], offsets)):
        assert _rel_err(a, b) <= 1e-4, name


def test_train_step_on_cuda_matches_cpu(dev):
    """One SMALL_TRAIN step on the card and on the CPU from the same weights
    and draws: the loss and logs to rtol 1e-4, the gradients to 1e-4 of
    each module's largest (cuDNN and the CPU sum the convolutions in
    another order)."""
    from zest_tpu_torch import presets, sampling
    from zest_tpu_torch.system import phase_for_step
    cfg, system, batch, params = presets.build(presets.SMALL_TRAIN,
                                               presets.SMALL_SCENE, "cpu")
    phase = phase_for_step(cfg, 0)
    draws = sampling.sample_draws(torch.Generator().manual_seed(1), cfg, 32,
                                  64, int(batch["motion_count"]),
                                  phase.extra_samples)
    _, logs, grads = system.loss_and_grads(params, batch, draws, phase, 0)
    system.to(dev)
    _, logs_c, grads_c = system.loss_and_grads(
        {k: v.to(dev) for k, v in params.items()},
        {k: v.to(dev) for k, v in batch.items()}, draws.to(dev), phase, 0)
    for k, v in logs.items():
        np.testing.assert_allclose(float(logs_c[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    scale = {}
    for k, v in grads.items():
        m = k.split(".")[0]
        scale[m] = max(scale.get(m, 0.0), float(v.abs().max()))
    for k, v in grads.items():
        err = float((grads_c[k].cpu() - v).abs().max())
        assert err <= 1e-4 * scale[k.split(".")[0]], (k, err)


@pytest.mark.parametrize("dtype,cw", [(torch.float32, 8), (torch.bfloat16, 8),
                                      (torch.float32, 4), (torch.bfloat16, 16)])
def test_row_gather_kernels_match_twins(dev, dtype, cw):
    """K9 and its scatter-add on a table with duplicate indices (100 rows,
    3,000 indices) and a count that fills no block evenly."""
    g = _gen(dev, 11)
    tab = torch.randn((100, cw), generator=g, device=dev).to(dtype)
    idx = torch.randint(0, 100, (3, 1001), generator=g, device=dev,
                        dtype=torch.int32)
    cot = torch.randn((3, 1001, cw), generator=g, device=dev).to(dtype)
    launches = (dma_gather.gather_rows.launches, dma_gather.scatter_rows.launches)
    t_ = tab.clone().requires_grad_(True)
    out = dma_gather.take_rows(t_, idx)
    out.backward(cot)
    assert (dma_gather.gather_rows.launches, dma_gather.scatter_rows.launches) \
        == (launches[0] + 1, launches[1] + 1)
    torch.cuda.synchronize()
    assert out.dtype == dtype and torch.equal(out, tab[idx.long()])
    ref = dma_gather.scatter_rows_plain(cot, idx, 100)
    assert t_.grad.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    assert _rel_err(t_.grad.float(), ref.float()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["one_index", "zero_rows", "single_row",
                                  "ragged"])
def test_row_scatter_add_edge_cases(dev, dtype, case):
    """K9's scatter-add against its twin: every index equal, a gradient
    with all-zero rows (which the kernel skips), one row, and a count that
    fills no block evenly. The gradients are small integers, so every
    float32 sum is exact in any order of the atomics and kernel and twin
    agree bit for bit."""
    g = _gen(dev, 19)
    m, shape = {"one_index": (10, (5, 999)), "zero_rows": (100, (3, 1001)),
                "single_row": (1, (1,)), "ragged": (5000, (7, 513))}[case]
    idx = torch.randint(0, m, shape, generator=g, device=dev, dtype=torch.int32)
    if case == "one_index":
        idx.fill_(3)
    cot = torch.randint(-4, 5, (*shape, 8), generator=g, device=dev).to(dtype)
    if case == "zero_rows":
        cot[:, ::2] = 0
    before = dma_gather.scatter_rows.launches
    out = dma_gather.scatter_rows(cot, idx, m)
    assert dma_gather.scatter_rows.launches == before + 1
    ref = dma_gather.scatter_rows_plain(cot, idx, m)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (m, 8)
    assert torch.equal(out, ref)
    assert float(ref.float().abs().max()) > 0.0


def test_row_gather_rejects_what_the_kernel_cannot_take(dev):
    idx = torch.zeros((5,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):          # a row of 12 bytes
        dma_gather.gather_rows(torch.zeros((4, 3), device=dev), idx)
    with pytest.raises(TypeError):
        dma_gather.gather_rows(torch.zeros((4, 4), device=dev), idx.long())
    with pytest.raises(TypeError):
        dma_gather.gather_rows(torch.zeros((4, 4), device=dev).half(), idx)


def _norm_err(a, b):
    torch.cuda.synchronize()
    a, b = a.double(), b.double()
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _forward_values_match_twin(field, saved, pts, feats, views):
    """The forward values K7's bf16 mode kept (K6's) against the twin's own
    forward: cond, every z_i, hv and the feature layer's output within
    2^-8 norm-wise and 2^-6 of their largest."""
    ref = fused_mlp.forward_values_plain(field, pts, feats, views)
    assert len(saved["z"]) == len(ref["z"]) == len(field.pts_linears)
    pairs = [("cond", saved["cond"], ref["cond"]), ("hv", saved["hv"], ref["hv"]),
             ("feature", saved["feature"].float(), ref["feature"].float())]
    pairs += [(f"z{i}", a, b) for i, (a, b) in enumerate(zip(saved["z"],
                                                               ref["z"]))]
    for name, a, b in pairs:
        assert a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        assert _norm_err(a, b) <= 2.0 ** -8, name
        assert _rel_err(a, b) <= 2.0 ** -6, name


def _held_to_autograd(field, got, pts, feats, views, cot):
    """K7's gradients (d_pts, d_feats, d_views, d_pack) against the twin's
    autograd, with the criterion that the ReLU-kink noise passes: each input
    and leaf within 2^-8 norm-wise, the rows beyond 2^-8 of their input's
    largest at most 2^-9 of the rows, each leaf's largest error within 2^-6
    of its largest."""
    ref = fused_mlp.fused_nerf_backward_plain(field, pts, feats, views, cot)
    beyond = torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)
    for name, a, b in zip(("d_pts", "d_feats", "d_views"), got, ref):
        assert bool(torch.isfinite(a).all()), name
        assert _norm_err(a, b) <= 2.0 ** -8, name
        beyond |= (a - b).abs().amax(1) > 2.0 ** -8 * b.abs().max()
    assert int(beyond.sum()) <= 2.0 ** -9 * pts.shape[0]
    _, offsets = fused_mlp.pack_weights(field)
    for (name, a), (_, b) in zip(fused_mlp.pack_leaves(field, got[3], offsets),
                                 fused_mlp.pack_leaves(field, ref[3], offsets)):
        assert bool(torch.isfinite(a).all()), name
        assert _norm_err(a, b) <= 2.0 ** -8, name
        assert _rel_err(a, b) <= 2.0 ** -6, name


def _k7_at_its_forward(field, pts, feats, views, cot, monkeypatch):
    """K7's bf16 mode in one chunk, keeping its forward values, against the
    twin's backward at those values: d_pts, d_feats, d_views and every
    weight and bias to 2^-8 of its own largest; the values themselves
    against the twin's forward. Returns K7's gradients."""
    monkeypatch.setattr(fused_mlp, "BF16_CHUNK_ROWS", max(pts.shape[0], 1))
    with torch.no_grad():
        pack, offsets = fused_mlp.pack_weights(field)
    saved = {}
    got = fused_mlp.fused_nerf_backward(field, pts, feats, views, cot, pack,
                                        offsets, saved=saved)
    ref = fused_mlp.fused_nerf_backward_at_plain(field, saved, pts, feats,
                                                 views, cot)
    _forward_values_match_twin(field, saved, pts, feats, views)
    for name, a, b in zip(("d_pts", "d_feats", "d_views"), got, ref):
        assert bool(torch.isfinite(a).all()), name
        assert _rel_err(a, b) <= 2.0 ** -8, name
    for (name, a), (_, b) in zip(fused_mlp.pack_leaves(field, got[3], offsets),
                                 fused_mlp.pack_leaves(field, ref[3], offsets)):
        assert bool(torch.isfinite(a).all()), name
        assert _rel_err(a, b) <= 2.0 ** -8, name
    return got


def _same_as_one_chunk(got, one, field):
    """K7 in chunks against K7 in one: the input gradients bit for bit, the
    weight gradients to 1e-5 of each leaf's largest (split-K sums)."""
    torch.cuda.synchronize()
    for name, a, b in zip(("d_pts", "d_feats", "d_views"), got, one):
        assert torch.equal(a, b), name
    _, offsets = fused_mlp.pack_weights(field)
    for (name, a), (_, b) in zip(fused_mlp.pack_leaves(field, got[3], offsets),
                                 fused_mlp.pack_leaves(field, one[3], offsets)):
        assert _rel_err(a, b) <= 1e-5, name


@pytest.mark.parametrize("width", [64, 128, 256])
@pytest.mark.parametrize("static", [True, False])
def test_bf16_field_kernels_match_twin(dev, width, static, monkeypatch):
    """The bf16-operand modes of K6 and K7: the forward against the bf16
    twin; K7 through autograd (chunks of 384 points, so the weight
    gradients add over three chunks) against the twin's autograd, and
    against K7 in one chunk, held to the twin's backward at its forward
    values."""
    monkeypatch.setattr(fused_mlp, "BF16_CHUNK_ROWS", 384)
    P, F = (63, 40) if static else (84, 24)
    torch.manual_seed(12)
    field = NeRFField(8, width, P, 27, F, static=static, bf16=True).to(dev)
    g = _gen(dev, 13)
    n = 1000
    pts, feats, views = (torch.randn((n, c), generator=g, device=dev)
                         for c in (P, F, 27))
    cot = torch.randn((n, field.out_ch), generator=g, device=dev)
    with torch.no_grad():
        out = fused_nerf_forward(field, pts, feats, views)
        ref = field(pts, feats, views)
    assert _max_err(out, ref) <= 1e-3 * max(1.0, float(ref.abs().max()))
    ins = [t.clone().requires_grad_(True) for t in (pts, feats, views)]
    before = fused_mlp.fused_nerf_backward.launches
    field.zero_grad()
    (fused_nerf_forward(field, *ins) * cot).sum().backward()
    assert fused_mlp.fused_nerf_backward.launches == before + 1
    got = [t.grad for t in ins] + [fused_mlp.pack_grads(field)]
    _held_to_autograd(field, got, pts, feats, views, cot)
    one = _k7_at_its_forward(field, pts, feats, views, cot, monkeypatch)
    _same_as_one_chunk(got, one, field)
    # the mode really rounds: the float32 kernel gives another output
    field.bf16 = False
    with torch.no_grad():
        assert _max_err(fused_nerf_forward(field, pts, feats, views), out) > 0.0


def _spy_backward_entries(monkeypatch):
    """Count the calls of K7's two C entry points (SIMT float32, bf16 on the
    tensor cores)."""
    from zest_tpu_torch.kernels import _build
    lib, calls = _build.library(), {}
    for name in ("zt_fused_nerf_backward", "zt_fused_nerf_backward_tc"):
        def spy(*args, _fn=getattr(lib, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(lib, name, spy)
    return calls


@pytest.mark.parametrize("n,chunk", [(1, 384), (63, 384), (65, 64),
                                     (385, 384), (1000, 100), (1000, 65536)])
@pytest.mark.parametrize("skips", [(4,), ()])
@pytest.mark.parametrize("width", [64, 128, 256])
@pytest.mark.parametrize("static", [True, False])
def test_bf16_field_backward_on_tensor_cores(dev, width, static, skips, n,
                                             chunk, monkeypatch):
    """K7's bf16 mode takes the tensor-core entry at every width, at point
    counts ragged around the 64-point tile and across chunks (of 64, 100 and
    384 points, and one chunk): against K7 in one chunk, held to the twin's
    backward at its forward values, which are held to the twin's forward."""
    monkeypatch.setattr(fused_mlp, "BF16_CHUNK_ROWS", chunk)
    calls = _spy_backward_entries(monkeypatch)
    P, F = (63, 40) if static else (84, 24)
    torch.manual_seed(31)
    field = NeRFField(8, width, P, 27, F, skips=skips, static=static,
                      bf16=True).to(dev)
    g = _gen(dev, 32)
    pts, feats, views = (torch.randn((n, c), generator=g, device=dev)
                         for c in (P, F, 27))
    cot = torch.randn((n, field.out_ch), generator=g, device=dev)
    with torch.no_grad():
        pack, offsets = fused_mlp.pack_weights(field)
    got = fused_mlp.fused_nerf_backward(field, pts, feats, views, cot, pack,
                                        offsets)
    assert calls == {"zt_fused_nerf_backward_tc": 1}
    one = _k7_at_its_forward(field, pts, feats, views, cot, monkeypatch)
    _same_as_one_chunk(got, one, field)


@pytest.mark.parametrize("skips", [(4,), ()])
@pytest.mark.parametrize("width", [64, 128, 256])
@pytest.mark.parametrize("static", [True, False])
def test_bf16_backward_recomputes_the_forward_bit_for_bit(dev, width, static,
                                                          skips, monkeypatch):
    """Pass 1 of K7's bf16 mode recomputes K6's output rows bit for bit (the
    same device code on the same bf16 pack), over chunks of 384 points."""
    monkeypatch.setattr(fused_mlp, "BF16_CHUNK_ROWS", 384)
    P, F = (63, 40) if static else (84, 24)
    torch.manual_seed(33)
    field = NeRFField(8, width, P, 27, F, skips=skips, static=static,
                      bf16=True).to(dev)
    g = _gen(dev, 34)
    n = 1000
    pts, feats, views = (torch.randn((n, c), generator=g, device=dev)
                         for c in (P, F, 27))
    cot = torch.randn((n, field.out_ch), generator=g, device=dev)
    with torch.no_grad():
        out = fused_nerf_forward(field, pts, feats, views)
        pack, offsets = fused_mlp.pack_weights(field)
    rows = torch.full_like(out, float("nan"))
    fused_mlp.fused_nerf_backward(field, pts, feats, views, cot, pack,
                                  offsets, recomputed=rows)
    torch.cuda.synchronize()
    assert torch.equal(rows, out)


@pytest.mark.parametrize("skips", [(4,), ()])
@pytest.mark.parametrize("width", [64, 128, 256])
@pytest.mark.parametrize("static", [True, False])
def test_bf16_backward_pack_kernel_matches_twin(dev, width, static, skips):
    """K7's backward pack, made on the card from the float32 pack, equals
    its twin bit for bit."""
    P, F = (63, 40) if static else (84, 24)
    torch.manual_seed(35)
    field = NeRFField(8, width, P, 27, F, skips=skips, static=static,
                      bf16=True).to(dev)
    with torch.no_grad():
        pack, offsets = fused_mlp.pack_weights(field)
    out = fused_mlp.pack_bf16_bwd(field, pack, offsets)
    ref = fused_mlp.pack_bf16_bwd_plain(field, pack, offsets)[0]
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert torch.equal(out, ref)


def _spy_float32_backward(monkeypatch):
    """Count the calls of K7 float32's two C entry points (pass 1, pass 2),
    and hold the weight gradients that each pass-2 launch adds to its twin
    on the same buffers, each leaf to 1e-4 of its largest."""
    from zest_tpu_torch.kernels import _build
    lib, calls = _build.library(), {}
    for name in ("zt_fused_nerf_backward", "zt_fused_nerf_weight_grads_tc32",
                 "zt_fused_nerf_backward_tc"):
        def spy(*args, _fn=getattr(lib, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(lib, name, spy)
    real = fused_mlp.weight_grads

    def held(field, pts, feats, views, bufs, offsets, d_pack):
        before = d_pack.clone()
        real(field, pts, feats, views, bufs, offsets, d_pack)
        ref = fused_mlp.weight_grads_plain(field, pts, feats, views, bufs)
        for (name, a), (_, b) in zip(
                fused_mlp.pack_leaves(field, d_pack - before, offsets),
                fused_mlp.pack_leaves(field, ref, offsets)):
            assert _rel_err(a, b) <= 1e-4, name
    held.launches = 0                  # the wrapper counts on its module name
    monkeypatch.setattr(fused_mlp, "weight_grads", held)
    return calls


@pytest.mark.parametrize("width,n", [(w, n) for w in (64, 128, 256)
                                     for n in (1, 63, 64, 65, 1000)]
                         + [(64, fused_mlp.CHUNK_ROWS + 1000)])
@pytest.mark.parametrize("skips", [(4,), ()])
@pytest.mark.parametrize("static", [True, False])
def test_float32_field_backward_on_tensor_cores(dev, width, static, skips, n,
                                                monkeypatch):
    """K7's float32 mode: pass 1 (SIMT) and pass 2 (3xTF32 on the tensor
    cores) once per chunk, the old SIMT weight-gradient kernel nowhere; each
    pass-2 launch held to its twin on the same buffers; d_pts, d_feats,
    d_views and every leaf of d_pack, the heads included, within 1e-4 of its
    largest against the twin's autograd, at ragged point counts and across
    two chunks."""
    from zest_tpu_torch.kernels import _build
    calls = _spy_float32_backward(monkeypatch)
    P, F = (63, 40) if static else (84, 24)
    torch.manual_seed(37)
    field = NeRFField(8, width, P, 27, F, skips=skips, static=static).to(dev)
    g = _gen(dev, 38)
    pts, feats, views = (torch.randn((n, c), generator=g, device=dev)
                         for c in (P, F, 27))
    cot = torch.randn((n, field.out_ch), generator=g, device=dev)
    with torch.no_grad():
        pack, offsets = fused_mlp.pack_weights(field)
    got = fused_mlp.fused_nerf_backward(field, pts, feats, views, cot, pack,
                                        offsets)
    chunks = -(-n // fused_mlp.CHUNK_ROWS)
    assert calls == {"zt_fused_nerf_backward": chunks,
                     "zt_fused_nerf_weight_grads_tc32": chunks}
    # the SIMT weight-gradient kernel is not in the library at all
    library = Path(_build.build_info["path"]).read_bytes()
    assert b"wgrad_tc32_kernel" in library and b"wgrad_kernel" not in library
    ref = fused_mlp.fused_nerf_backward_plain(field, pts, feats, views, cot)
    for name, a, b in zip(("d_pts", "d_feats", "d_views"), got, ref):
        assert bool(torch.isfinite(a).all()), name
        assert _rel_err(a, b) <= 1e-4, name
    for (name, a), (_, b) in zip(fused_mlp.pack_leaves(field, got[3], offsets),
                                 fused_mlp.pack_leaves(field, ref[3], offsets)):
        assert bool(torch.isfinite(a).all()), name
        assert _rel_err(a, b) <= 1e-4, name


@pytest.mark.parametrize("width", [64, 128, 256])
@pytest.mark.parametrize("static", [True, False])
def test_float32_weight_grads_are_float32_class(dev, width, static):
    """Three TF32 products keep ~22 bits of each operand: on a thousand
    points every weight gradient of the conditioning, trunk, feature and
    views layers is within max(8 x the float32 twin's own norm-wise
    distance, 2^-20) of a float64 twin's autograd, which one TF32 product
    (~11 bits, ~3e-4 away) misses by far."""
    import copy
    P, F = (63, 40) if static else (84, 24)
    torch.manual_seed(39)
    field = NeRFField(8, width, P, 27, F, static=static).to(dev)
    wide = copy.deepcopy(field).double()
    g = _gen(dev, 40)
    pts, feats, views, cot = (torch.randn((1000, c), generator=g, device=dev)
                              for c in (P, F, 27, field.out_ch))
    with torch.no_grad():
        pack, offsets = fused_mlp.pack_weights(field)
    got = fused_mlp.fused_nerf_backward(field, pts, feats, views, cot, pack,
                                        offsets)[3]
    twin = fused_mlp.fused_nerf_backward_plain(field, pts, feats, views,
                                               cot)[3]
    exact = fused_mlp.fused_nerf_backward_plain(
        wide, *(t.double() for t in (pts, feats, views, cot)))[3]
    names = {m: f"{n}.weight" for n, m in field.named_modules()}
    big = {names[m] for m in (field.pts_bias, *field.pts_linears,
                              field.feature_linear, field.views_linears[0])}
    leaves = zip(fused_mlp.pack_leaves(field, got, offsets),
                 fused_mlp.pack_leaves(field, twin, offsets),
                 fused_mlp.pack_leaves(wide, exact, offsets))
    checked = 0
    for (name, a), (_, b), (_, c) in leaves:
        if name in big:
            own = _norm_err(b, c)
            assert _norm_err(a, c) <= max(8 * own, 2.0 ** -20), (name, own)
            checked += 1
    assert checked == len(big)
