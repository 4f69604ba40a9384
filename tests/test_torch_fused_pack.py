"""The bf16 weight pack of K6's tensor-core kernel (``csrc/fused_mlp_tc.cu``),
on the CPU: ``pack_bf16_plain``, the twin of the pack kernel, lays every
bf16-operand matrix of the float32 pack out as ``nn.Linear`` stores it,
[out][in], rounded to bf16, each K part zero padded to a multiple of 16, the
matrices back to back in ``bf16_layout``'s order.

- Every matrix read back from the pack equals ``round_bf16(lin.weight)``
  part by part, bit for bit, and every padding column is zero.
- The pack is made from the float32 pack it is given, not from the module
  (as the kernel is), and ``pack_bf16`` on CPU tensors is the twin.
- The field computed from the pack as the kernel reads it (inputs rounded to
  bf16 and zero padded per part, float32 sums, float32 biases, cond and
  heads) agrees with ``zest_tpu``'s ``fused_nerf_apply(..., approx=True)``
  (Pallas, interpret mode) on the same weights as the twin does: rtol 1e-4,
  atol 1e-5 (both round the same operands; the sums differ only in order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from zest_tpu.kernels.fused_mlp import fused_nerf_apply
from zest_tpu.models.nerf import NeRFField as JNeRFField

from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.kernels.fused_mlp import (bf16_layout, pack_bf16,
                                              pack_bf16_plain, pack_weights)
from zest_tpu_torch.models.nerf import NeRFField, round_bf16

# (P, F, V) of the static (xyz) and dynamic (xyzt) fields at multires 10 / 4
LAYOUTS = {True: (63, 40, 27), False: (84, 24, 27)}


def _pad16(k):
    return -(-k // 16) * 16


def _matrices(field, scale=1.0):
    """[(Linear, K parts, the matrix read back from the pack [out][K_pad])],
    the pack made from the float32 pack times scale"""
    with torch.no_grad():
        f32, f32_offsets = pack_weights(field)
    pack, offsets = pack_bf16_plain(field, f32 * scale, f32_offsets)
    assert pack.dtype == torch.bfloat16 and pack.dim() == 1
    layout = bf16_layout(field)
    assert len(offsets) == len(layout) == len(field.pts_linears) + 3
    mats, end = [], 0
    for (lin, widths), off in zip(layout, offsets):
        assert off == end                     # back to back, stream order
        k_pad = sum(_pad16(w) for w in widths)
        end = off + lin.out_features * k_pad
        mats.append((lin, widths,
                     pack[off:end].view(lin.out_features, k_pad)))
    assert end == pack.numel()
    return mats


@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("static", [True, False])
@pytest.mark.parametrize("skips", [(4,), ()])
def test_pack_reads_back_rounded_weights(width, static, skips):
    P, F_, V = LAYOUTS[static]
    torch.manual_seed(5)
    field = NeRFField(8, width, P, V, F_, skips=skips, static=static,
                      bf16=True)
    mats = _matrices(field)
    assert [m[0] for m in mats] == ([field.pts_bias, *field.pts_linears,
                                     field.feature_linear,
                                     field.views_linears[0]])
    for i, (lin, widths, mat) in enumerate(mats):
        assert sum(widths) == lin.in_features
        if 1 <= i <= len(field.pts_linears):
            layer = i - 1
            assert widths == ([P] if layer == 0 else [P, width]
                              if layer - 1 in skips else [width])
        src = dst = 0
        for w in widths:
            part = mat[:, dst:dst + _pad16(w)]
            want = round_bf16(lin.weight[:, src:src + w]).detach()
            assert torch.equal(part[:, :w].float(), want), (i, src)
            assert not part[:, w:].any(), (i, src)
            src += w
            dst += _pad16(w)
        assert dst == mat.shape[1]


@pytest.mark.parametrize("static", [True, False])
def test_pack_is_made_from_the_float32_pack(static):
    P, F_, V = LAYOUTS[static]
    torch.manual_seed(6)
    field = NeRFField(8, 64, P, V, F_, static=static, bf16=True)
    for lin, widths, mat in _matrices(field, scale=2.0):
        cols = torch.cat([torch.arange(w) + sum(_pad16(x) for x in widths[:j])
                          for j, w in enumerate(widths)])
        want = round_bf16(2.0 * lin.weight).detach()
        assert torch.equal(mat[:, cols].float(), want)
    with torch.no_grad():
        f32, offsets = pack_weights(field)
    assert torch.equal(pack_bf16(field, f32, offsets),
                       pack_bf16_plain(field, f32, offsets)[0])


def _field_from_pack(field, pts, feats, views):
    """The field as the tensor-core kernel computes it from the bf16 pack."""
    mats = [m.float() for _, _, m in _matrices(field)]

    def mm(i, lin, *xs):
        x = torch.cat([F.pad(round_bf16(x), (0, _pad16(x.shape[-1])
                                             - x.shape[-1])) for x in xs], -1)
        return x @ mats[i].T + lin.bias

    cond = mm(0, field.pts_bias, feats)
    h = pts
    for i, lin in enumerate(field.pts_linears):
        xs = (pts,) if i == 0 else (pts, h) if i - 1 in field.skips else (h,)
        h = torch.relu(mm(1 + i, lin, *xs) * cond)
    if field.static:
        extras = [torch.sigmoid(field.w_linear(h))]
    else:
        extras = [torch.tanh(field.sf_linear(h)),
                  torch.sigmoid(field.prob_linear(h))]
    depth = len(field.pts_linears)
    feature = mm(depth + 1, field.feature_linear, h)
    hv = torch.relu(mm(depth + 2, field.views_linears[0], feature, views))
    return torch.cat([field.rgb_linear(hv), field.alpha_linear(h)] + extras, -1)


@pytest.mark.parametrize("static", [True, False])
def test_pack_field_matches_approx_kernel(static):
    P, F_, V = LAYOUTS[static]
    jfield = JNeRFField(depth=8, width=64, in_ch_pts=P, in_ch_views=V,
                        in_ch_feat=F_, sceneflow=True, static=static,
                        use_mvs=True)
    variables = jax.tree.map(np.asarray, jfield.init(
        jax.random.PRNGKey(2), jnp.zeros((1, P)), jnp.zeros((1, F_)),
        jnp.zeros((1, V))))
    field = NeRFField(8, 64, P, V, F_, static=static, bf16=True)
    sd = from_jax_params({"nerf_static": variables})
    field.load_state_dict({k[len("nerf_static."):]: v for k, v in sd.items()
                           if k.startswith("nerf_static.")})
    rng = np.random.default_rng(3 if static else 4)
    inputs = [rng.normal(size=(300, c)).astype(np.float32) for c in (P, F_, V)]
    ref = np.asarray(fused_nerf_apply(jfield, variables,
                                      *map(jnp.asarray, inputs), approx=True))
    with torch.no_grad():
        out = _field_from_pack(field, *map(torch.from_numpy, inputs))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)
