"""zest_tpu_torch NeRFField against zest_tpu on the CPU, static and dynamic
layouts, with weights carried over by ``convert.from_jax_params``; the fused
kernel's twin against ``fused_nerf_apply`` (Pallas, interpret mode); and the
packed-weight layout that the CUDA kernel reads.

Tolerance: rtol 1e-4, atol 1e-5 — eight chained float32 products of width
64-256 summed in another order on each side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu.kernels.fused_mlp import fused_nerf_apply
from zest_tpu.models.nerf import NeRFField as JNeRFField

from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.kernels import fused_mlp
from zest_tpu_torch.kernels.fused_mlp import fused_nerf_forward, pack_weights
from zest_tpu_torch.models.nerf import NeRFField

TOL = dict(rtol=1e-4, atol=1e-5)
# (P, F, V) of the static (xyz) and dynamic (xyzt) fields at multires 10 / 4
LAYOUTS = {True: (63, 40, 27), False: (84, 24, 27)}


def _fields(static, width=64):
    P, F, V = LAYOUTS[static]
    jfield = JNeRFField(depth=8, width=width, in_ch_pts=P, in_ch_views=V,
                        in_ch_feat=F, sceneflow=True, static=static,
                        use_mvs=True)
    variables = jfield.init(jax.random.PRNGKey(1), jnp.zeros((1, P)),
                            jnp.zeros((1, F)), jnp.zeros((1, V)))
    variables = jax.tree.map(np.asarray, variables)
    field = NeRFField(8, width, P, V, F, static=static)
    sd = from_jax_params({"nerf_static": variables})
    field.load_state_dict({k.removeprefix("nerf_static."): v
                           for k, v in sd.items()})
    rng = np.random.default_rng(0 if static else 1)
    R, S = 37, 16          # 592 points: not a multiple of any tile
    inputs = [rng.normal(size=(R, S, c)).astype(np.float32) for c in (P, F, V)]
    return jfield, variables, field, inputs


@pytest.mark.parametrize("static", [True, False])
def test_nerf_field_matches_flax(static):
    jfield, variables, field, inputs = _fields(static)
    ref = jfield.apply(variables, *map(jnp.asarray, inputs))
    with torch.no_grad():
        out = field(*map(torch.from_numpy, inputs))
    assert out.shape == (37, 16, 5 if static else 12)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("static", [True, False])
def test_fused_twin_matches_pallas_kernel(static):
    jfield, variables, field, inputs = _fields(static)
    ref = fused_nerf_apply(jfield, variables, *map(jnp.asarray, inputs),
                           approx=False)
    before = fused_nerf_forward.launches
    with torch.no_grad():
        out = fused_nerf_forward(field, *map(torch.from_numpy, inputs))
    assert fused_nerf_forward.launches == before   # CPU: the twin, no launch
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _emulate_kernel(pack, off, field, pts, feats, views):
    """What csrc/fused_mlp.cu computes, reading weights through the packed
    buffer and offsets table only."""
    def mat(slot, rows, cols):
        return pack[off[slot]:off[slot] + rows * cols].reshape(rows, cols)

    def vec(slot, n):
        return pack[off[slot]:off[slot] + n]

    W, P = field.width, field.in_ch_pts
    cond = feats @ mat(fused_mlp._WB, field.in_ch_feat, W) + vec(1, W)
    h = pts
    for i, lin in enumerate(field.pts_linears):
        Wi = mat(fused_mlp._LAYER0 + 2 * i, lin.in_features, W)
        bi = vec(fused_mlp._LAYER0 + 2 * i + 1, W)
        x = np.concatenate([pts, h], -1) if i - 1 in field.skips else h
        h = np.maximum((x @ Wi + bi) * cond, 0.0)
    alpha = h @ mat(fused_mlp._WA, W, 1) + vec(fused_mlp._WA + 1, 1)
    if field.static:
        extras = [1 / (1 + np.exp(-(h @ mat(fused_mlp._WX1, W, 1)
                                    + vec(fused_mlp._WX1 + 1, 1))))]
    else:
        extras = [np.tanh(h @ mat(fused_mlp._WX1, W, 6)
                          + vec(fused_mlp._WX1 + 1, 6)),
                  1 / (1 + np.exp(-(h @ mat(fused_mlp._WX2, W, 2)
                                    + vec(fused_mlp._WX2 + 1, 2))))]
    feature = h @ mat(fused_mlp._WF, W, W) + vec(fused_mlp._WF + 1, W)
    hv = np.maximum(np.concatenate([feature, views], -1)
                    @ mat(fused_mlp._WV, W + field.in_ch_views, W // 2)
                    + vec(fused_mlp._WV + 1, W // 2), 0.0)
    rgb = hv @ mat(fused_mlp._WR, W // 2, 3) + vec(fused_mlp._WR + 1, 3)
    return np.concatenate([rgb, alpha] + extras, -1)


@pytest.mark.parametrize("static", [True, False])
def test_packed_weights_layout(static):
    _, _, field, inputs = _fields(static)
    pack, offsets = pack_weights(field)
    assert len(offsets) == fused_mlp._N_SLOTS
    n_params = sum(p.numel() for p in field.parameters())
    assert n_params <= pack.numel() < n_params + 4 * len(offsets)
    assert all(o % 4 == 0 for o in offsets)     # float4-aligned matrices
    pts, feats, views = (a.reshape(-1, a.shape[-1]).astype(np.float64)
                         for a in inputs)
    emu = _emulate_kernel(pack.detach().double().numpy(), offsets, field, pts,
                          feats, views)
    with torch.no_grad():
        ref = field(*map(torch.from_numpy, inputs)).reshape(emu.shape)
    np.testing.assert_allclose(emu, ref.numpy(), **TOL)


def test_fused_wrapper_rejects_what_the_kernel_cannot_take():
    field = NeRFField(8, 48, 63, 27, 40, static=True)
    meta = torch.empty((4, 63), device="meta")
    with pytest.raises(ValueError, match="width 48"):
        fused_nerf_forward(field, meta, meta[:, :40], meta[:, :27])
