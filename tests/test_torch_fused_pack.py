"""The operand packs of K6's tensor-core kernels, on the CPU.

``pack_bf16_plain``, the twin of the bf16 mode's pack kernel
(``csrc/fused_mlp_tc.cu``), lays every bf16-operand matrix of the float32
pack out as ``nn.Linear`` stores it, [out][in], rounded to bf16, each K part
zero padded to a multiple of 16, the matrices back to back in
``tc_layout``'s order.

- Every matrix read back from the pack equals ``round_bf16(lin.weight)``
  part by part, bit for bit, and every padding column is zero.
- The pack is made from the float32 pack it is given, not from the module
  (as the kernel is), and ``pack_bf16`` on CPU tensors is the twin.
- The field computed from the pack as the kernel reads it (inputs rounded to
  bf16 and zero padded per part, float32 sums, float32 biases, cond and
  heads) agrees with ``zest_tpu``'s ``fused_nerf_apply(..., approx=True)``
  (Pallas, interpret mode) on the same weights as the twin does: rtol 1e-4,
  atol 1e-5 (both round the same operands; the sums differ only in order).

``pack_tc32_plain``, the twin of the float32 mode's pack kernel
(``csrc/fused_mlp_tc32.cu``), lays the same matrices out in float32, each K
part zero padded to a multiple of 8 (the depth of mma m16n8k8 TF32).

- Every matrix read back from it equals ``lin.weight`` part by part, bit for
  bit, every padding column is zero, and it is made from the float32 pack it
  is given.
- The field computed from it as the kernel computes it, 3xTF32: every
  operand split into big = tf32(x) and small = tf32(x - big), rounded to
  TF32 by bits as ``cvt.rna.tf32.f32`` does (to nearest, ties away from
  zero), and per k8 step small x big, then big x small, then big x big added
  into one float32 sum. It agrees with ``zest_tpu``'s ``fused_nerf_apply(...,
  approx=False)`` (Pallas, interpret mode) at 1e-4 of max(1, |out|). That
  tolerance alone would pass one TF32 product at width 256, so the same
  field is also held to a float64 twin at 2^-20 norm-wise (three TF32
  products keep ~22 bits of each operand), which one TF32 product (big x
  big alone, ~11 bits) misses.
- The forward wrapper routes each mode to its pack and tensor-core entry
  (a stand-in for the kernel library, as below).

K7's backward pack (``csrc/fused_mlp_tc_bwd.cu``), the B operand of its
input-gradient products d_x = d_z @ W: ``pack_bf16_bwd_plain``, the twin of
its pack kernel, lays out the rows of each Linear's ``weight.T`` ([in][out],
the float32 pack's own layout) that one product reads, rounded to bf16, in
``bf16_bwd_layout``'s order.

- Every matrix read back from it equals the rounded rows of ``weight.T``,
  bit for bit, and it is made from the float32 pack it is given.
- The bf16 twin's backward evaluated at given forward values
  (``fused_nerf_backward_at_plain``, the plain version the card holds K7's
  bf16 mode to, at the values K7 ran at), at the twin's own forward values
  (``forward_values_plain``): every product with bf16 operands and float32
  sums, d_z rounded as an operand, the bias gradients summed from the
  float32 d_z, cond, z, the masks and the heads in float32. It agrees with
  the VJP of ``zest_tpu``'s ``fused_nerf_apply(..., approx=True)`` (Pallas,
  interpret mode) on the same weights, every input gradient and every
  weight and bias gradient to 1e-3 of its own largest, as the twin is held
  (a float32 sum in another order can flip the bf16 rounding of one
  activation); and it equals the twin's autograd, both in float64, to 1e-9
  of each input's and each leaf's largest gradient (the same products;
  autograd adds some sums, cond's eight gradients among them, in another
  order).
- The wrapper routes the bf16 mode to the tensor-core entry
  (``zt_fused_nerf_backward_tc``), with the forward's bf16 pack when it is
  given, and the float32 mode to the SIMT entry (checked with meta tensors
  and a stand-in for the kernel library, which does not exist on the CPU).
"""
import copy
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from zest_tpu.kernels.fused_mlp import fused_nerf_apply
from zest_tpu.models.nerf import NeRFField as JNeRFField

from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.kernels import _build, fused_mlp
from zest_tpu_torch.kernels.fused_mlp import (
    bf16_bwd_layout, forward_values_plain, fused_nerf_backward_at_plain,
    fused_nerf_backward_plain, pack_bf16, pack_bf16_bwd, pack_bf16_bwd_plain,
    pack_bf16_plain, pack_leaves, pack_tc32, pack_tc32_plain, pack_weights,
    tc_layout)
from zest_tpu_torch.models.nerf import NeRFField, round_bf16

# (P, F, V) of the static (xyz) and dynamic (xyzt) fields at multires 10 / 4
LAYOUTS = {True: (63, 40, 27), False: (84, 24, 27)}


def _pad16(k):
    return -(-k // 16) * 16


def _pad8(k):
    return -(-k // 8) * 8


class Mode(NamedTuple):
    """One mode's operand pack: its twin, its wrapper, the operand type, the
    K padding and the rounding of a weight to the operand."""
    plain: Callable
    wrapper: Callable
    dtype: torch.dtype
    pad: Callable
    rounded: Callable


BF16_PACK = Mode(pack_bf16_plain, pack_bf16, torch.bfloat16, _pad16,
                 round_bf16)
TC32_PACK = Mode(pack_tc32_plain, pack_tc32, torch.float32, _pad8,
                 lambda w: w)
MODES = pytest.mark.parametrize("mode", [BF16_PACK, TC32_PACK],
                                ids=["bf16", "float32"])


def _matrices(field, scale=1.0, mode=BF16_PACK):
    """[(Linear, K parts, the matrix read back from the pack [out][K_pad])],
    the pack of mode made from the float32 pack times scale"""
    plain, _, dtype, pad, _ = mode
    with torch.no_grad():
        f32, f32_offsets = pack_weights(field)
    pack, offsets = plain(field, f32 * scale, f32_offsets)
    assert pack.dtype == dtype and pack.dim() == 1
    layout = tc_layout(field)
    assert len(offsets) == len(layout) == len(field.pts_linears) + 3
    mats, end = [], 0
    for (lin, widths), off in zip(layout, offsets):
        assert off == end                     # back to back, stream order
        k_pad = sum(pad(w) for w in widths)
        end = off + lin.out_features * k_pad
        mats.append((lin, widths,
                     pack[off:end].view(lin.out_features, k_pad)))
    assert end == pack.numel()
    return mats


@MODES
@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("static", [True, False])
@pytest.mark.parametrize("skips", [(4,), ()])
def test_pack_reads_back_rounded_weights(width, static, skips, mode):
    P, F_, V = LAYOUTS[static]
    torch.manual_seed(5)
    field = NeRFField(8, width, P, V, F_, skips=skips, static=static,
                      bf16=mode is BF16_PACK)
    mats = _matrices(field, mode=mode)
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
            part = mat[:, dst:dst + mode.pad(w)]
            want = mode.rounded(lin.weight[:, src:src + w]).detach()
            assert torch.equal(part[:, :w].float(), want), (i, src)
            assert not part[:, w:].any(), (i, src)
            src += w
            dst += mode.pad(w)
        assert dst == mat.shape[1]


@MODES
@pytest.mark.parametrize("static", [True, False])
def test_pack_is_made_from_the_float32_pack(static, mode):
    P, F_, V = LAYOUTS[static]
    torch.manual_seed(6)
    field = NeRFField(8, 64, P, V, F_, static=static,
                      bf16=mode is BF16_PACK)
    for lin, widths, mat in _matrices(field, scale=2.0, mode=mode):
        cols = torch.cat([torch.arange(w) + sum(mode.pad(x)
                                                for x in widths[:j])
                          for j, w in enumerate(widths)])
        want = mode.rounded(2.0 * lin.weight).detach()
        assert torch.equal(mat[:, cols].float(), want)
    with torch.no_grad():
        f32, offsets = pack_weights(field)
    assert torch.equal(mode.wrapper(field, f32, offsets),
                       mode.plain(field, f32, offsets)[0])


def _field_from_pack(field, pts, feats, views, mode=BF16_PACK,
                     product=lambda x, w: round_bf16(x) @ w.T):
    """The field as the tensor-core kernel computes it from mode's operand
    pack: every input part zero padded as the pack's K parts are, each of
    the conditioning, trunk, feature and views products product(x, w) with
    w [out][K_pad] from the pack, float32 biases, cond and heads."""
    pad = mode.pad
    mats = [m.float() for _, _, m in _matrices(field, mode=mode)]

    def mm(i, lin, *xs):
        x = torch.cat([F.pad(x, (0, pad(x.shape[-1]) - x.shape[-1]))
                       for x in xs], -1)
        return product(x, mats[i]) + lin.bias

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


def _jax_field(static, width, seed):
    """A ``zest_tpu`` field and its variables (numpy), and the port's field
    (float32) with the same weights."""
    P, F_, V = LAYOUTS[static]
    jfield = JNeRFField(depth=8, width=width, in_ch_pts=P, in_ch_views=V,
                        in_ch_feat=F_, sceneflow=True, static=static,
                        use_mvs=True)
    variables = jax.tree.map(np.asarray, jfield.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, P)), jnp.zeros((1, F_)),
        jnp.zeros((1, V))))
    field = NeRFField(8, width, P, V, F_, static=static)
    sd = from_jax_params({"nerf_static": variables})
    field.load_state_dict({k[len("nerf_static."):]: v for k, v in sd.items()
                           if k.startswith("nerf_static.")})
    return jfield, variables, field


def _tf32(x):
    """x rounded to TF32 by its bits, to nearest with ties away from zero,
    as cvt.rna.tf32.f32 does: add half of the 13 dropped bits' place to
    the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(x, w, terms=3):
    """x [n, K] @ w [out, K]^T as K6's float32 mode takes it, K a multiple
    of 8: every operand split into big = tf32(v) and small = tf32(v - big),
    and per k8 step small x big, then big x small, then big x big added into
    one float32 sum (each product of two TF32 values is exact in float32).
    terms=1 takes big x big alone: one TF32 product."""
    xb, wb = _tf32(x), _tf32(w)
    xs, ws = _tf32(x - xb), _tf32(w - wb)
    acc = torch.zeros((x.shape[0], w.shape[0]))
    for k in range(0, x.shape[1], 8):
        ks = slice(k, k + 8)
        if terms == 3:
            acc = acc + xs[:, ks] @ wb[:, ks].T
            acc = acc + xb[:, ks] @ ws[:, ks].T
        acc = acc + xb[:, ks] @ wb[:, ks].T
    return acc


def _norm_dist(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _tf32_case(static, width, seed, terms):
    """(the field from the float32 operand pack with ``terms`` TF32
    products, its float64 twin's output, the inputs, the JAX field)"""
    jfield, variables, field = _jax_field(static, width, seed)
    rng = np.random.default_rng(seed + 1)
    inputs = [rng.normal(size=(300, c)).astype(np.float32)
              for c in LAYOUTS[static]]
    ins = list(map(torch.from_numpy, inputs))
    with torch.no_grad():
        out = _field_from_pack(field, *ins, mode=TC32_PACK,
                               product=lambda x, w: _mm_tf32(x, w, terms))
        exact = copy.deepcopy(field).double()(*(t.double() for t in ins))
    return out.numpy(), exact.numpy(), inputs, (jfield, variables)


@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("static", [True, False])
def test_3xtf32_field_matches_exact_kernel(static, width):
    out, exact, inputs, (jfield, variables) = _tf32_case(static, width, 14, 3)
    ref = np.asarray(fused_nerf_apply(jfield, variables,
                                      *map(jnp.asarray, inputs), approx=False))
    assert np.abs(out - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())
    assert _norm_dist(out, exact) <= 2.0 ** -20


@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("static", [True, False])
def test_one_tf32_product_is_not_float32_class(static, width):
    out, exact, _, _ = _tf32_case(static, width, 14, 1)
    assert _norm_dist(out, exact) > 2.0 ** -20


def _pass1_buffers(field, pts, feats, views, g):
    """What K7 float32's pass 1 leaves for pass 2 (``weight_grads_plain``'s
    ``bufs``), from the twin's own forward and autograd: each Linear's
    output (cond, z, the feature layer's), hv, each Linear's output gradient
    and the heads' pre-activation gradients in the output's column order."""
    outs, grads = {}, {}

    def keep(lin, inputs, out):
        outs[lin] = out.detach()
        out.register_hook(lambda gr: grads.__setitem__(lin, gr))

    linears = [m for m in field.modules() if isinstance(m, torch.nn.Linear)]
    hooks = [lin.register_forward_hook(keep) for lin in linears]
    try:
        field(pts, feats, views).backward(g)
    finally:
        for hook in hooks:
            hook.remove()
    trunk, views_lin = field.pts_linears, field.views_linears[0]
    heads = [field.rgb_linear, field.alpha_linear]
    heads += ([field.w_linear] if field.static
              else [field.sf_linear, field.prob_linear])
    return dict(cond=outs[field.pts_bias],
                z=torch.stack([outs[lin] for lin in trunk]),
                feature=outs[field.feature_linear],
                hv=torch.relu(outs[views_lin]),
                dz=torch.stack([grads[lin] for lin in trunk]),
                d_cond=grads[field.pts_bias],
                d_feature=grads[field.feature_linear], d_hv=grads[views_lin],
                g_heads=torch.cat([grads[lin] for lin in heads], -1))


def _tf32_weight_grads(field, inputs, g, terms):
    """K7 float32's pass 2 as its kernel computes it, on the twin's pass-1
    values: ``weight_grads_plain`` with every product of the conditioning,
    trunk, feature and views layers as ``_mm_tf32`` over k8 steps of points
    (the points zero padded to a multiple of 8). Returns (d_pack, {weight
    leaf of those layers: norm-wise distance from a float64 twin's
    autograd})."""
    ins = [torch.from_numpy(x) for x in inputs]
    gt = torch.from_numpy(g)
    bufs = _pass1_buffers(field, *ins, gt)

    def product(x, d):
        pad = -x.shape[0] % 8
        return _mm_tf32(F.pad(x.T, (0, pad)), F.pad(d.T, (0, pad)), terms)

    with torch.no_grad():
        d_pack = fused_mlp.weight_grads_plain(field, *ins, bufs, product)
    wide = copy.deepcopy(field).double()
    exact = fused_nerf_backward_plain(wide, *(t.double() for t in ins),
                                      gt.double())[3]
    names = {m: n for n, m in field.named_modules()}
    big = {f"{names[m]}.weight" for m in (field.pts_bias, *field.pts_linears,
                                          field.feature_linear,
                                          field.views_linears[0])}
    _, offsets = pack_weights(field)
    dist = {name: _norm_dist(a.numpy(), b.numpy())
            for (name, a), (_, b) in zip(pack_leaves(field, d_pack, offsets),
                                         pack_leaves(wide, exact, offsets))
            if name in big}
    assert len(dist) == len(big)
    return d_pack, dist


def _tf32_wgrad_case(static, width, terms):
    jfield, variables, field = _jax_field(static, width, 15)
    rng = np.random.default_rng(16)
    inputs = [rng.normal(size=(300, c)).astype(np.float32)
              for c in LAYOUTS[static]]
    g = rng.normal(size=(300, field.out_ch)).astype(np.float32)
    return (*_tf32_weight_grads(field, inputs, g, terms), field, inputs, g,
            (jfield, variables))


@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("static", [True, False])
def test_3xtf32_weight_grads_match_exact_kernel(static, width):
    """K7 float32's pass 2 with its products as 3xTF32 holds the VJP of
    ``zest_tpu``'s ``approx=False`` kernel (interpret mode) at 1e-4 of each
    leaf's largest, and a float64 twin at 2^-20 norm-wise."""
    d_pack, dist, field, inputs, g, (jfield, variables) = _tf32_wgrad_case(
        static, width, 3)
    _, vjp = jax.vjp(lambda v: fused_nerf_apply(
        jfield, v, *map(jnp.asarray, inputs), approx=False), variables)
    ref = from_jax_params({"nerf_static": jax.tree.map(
        np.asarray, vjp(jnp.asarray(g))[0])})
    _, offsets = pack_weights(field)
    leaves = dict(pack_leaves(field, d_pack, offsets))
    assert set(leaves) == {n for n, _ in field.named_parameters()}
    for name, a in leaves.items():
        b = ref[f"nerf_static.{name}"].numpy()
        if name.endswith(".weight"):
            b = b.T                           # the pack holds weight.T
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max(), name
    assert max(dist.values()) <= 2.0 ** -20, dist


@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("static", [True, False])
def test_one_tf32_weight_grad_product_is_not_float32_class(static, width):
    dist = _tf32_wgrad_case(static, width, 1)[1]
    assert min(dist.values()) > 2.0 ** -20, dist


def _bwd_matrices(field, scale=1.0):
    """[(Linear, first input row, the matrix read back [rows][out])] of the
    backward pack made from the float32 pack times scale"""
    with torch.no_grad():
        f32, f32_offsets = pack_weights(field)
    pack, offsets = pack_bf16_bwd_plain(field, f32 * scale, f32_offsets)
    assert pack.dtype == torch.bfloat16 and pack.dim() == 1
    mats, end = [], 0
    for (lin, r0, rows), off in zip(bf16_bwd_layout(field), offsets):
        assert off == end                     # back to back, stream order
        end = off + rows * lin.out_features
        mats.append((lin, r0, pack[off:end].view(rows, lin.out_features)))
    assert end == pack.numel()
    return mats


@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("static", [True, False])
@pytest.mark.parametrize("skips", [(4,), ()])
def test_bwd_pack_reads_back_rounded_weights(width, static, skips):
    P, F_, V = LAYOUTS[static]
    torch.manual_seed(7)
    field = NeRFField(8, width, P, V, F_, skips=skips, static=static,
                      bf16=True)
    mats = _bwd_matrices(field)
    views = field.views_linears[0]
    trunk = []
    for i in reversed(range(8)):
        lin = field.pts_linears[i]
        trunk += ([(lin, 0, P), (lin, P, width)] if i and i - 1 in skips
                  else [(lin, 0, P if i == 0 else width)])
    want = [(views, width, V), (views, 0, width),
            (field.feature_linear, 0, width), *trunk, (field.pts_bias, 0, F_)]
    assert [(lin, r0, m.shape[0]) for lin, r0, m in mats] == want
    for lin, r0, mat in mats:
        ref = round_bf16(lin.weight.T[r0:r0 + mat.shape[0]]).detach()
        assert torch.equal(mat.float(), ref)


@pytest.mark.parametrize("static", [True, False])
def test_bwd_pack_is_made_from_the_float32_pack(static):
    P, F_, V = LAYOUTS[static]
    torch.manual_seed(8)
    field = NeRFField(8, 64, P, V, F_, static=static, bf16=True)
    for lin, r0, mat in _bwd_matrices(field, scale=2.0):
        ref = round_bf16(2.0 * lin.weight.T[r0:r0 + mat.shape[0]]).detach()
        assert torch.equal(mat.float(), ref)
    with torch.no_grad():
        f32, offsets = pack_weights(field)
    assert torch.equal(pack_bf16_bwd(field, f32, offsets),
                       pack_bf16_bwd_plain(field, f32, offsets)[0])


@pytest.mark.parametrize("static", [True, False])
def test_pack_gradients_match_approx_kernel(static):
    P, F_, V = LAYOUTS[static]
    jfield = JNeRFField(depth=8, width=64, in_ch_pts=P, in_ch_views=V,
                        in_ch_feat=F_, sceneflow=True, static=static,
                        use_mvs=True)
    variables = jax.tree.map(np.asarray, jfield.init(
        jax.random.PRNGKey(9), jnp.zeros((1, P)), jnp.zeros((1, F_)),
        jnp.zeros((1, V))))
    field = NeRFField(8, 64, P, V, F_, static=static, bf16=True)
    sd = from_jax_params({"nerf_static": variables})
    field.load_state_dict({k[len("nerf_static."):]: v for k, v in sd.items()
                           if k.startswith("nerf_static.")})
    rng = np.random.default_rng(10 if static else 11)
    inputs = [rng.normal(size=(300, c)).astype(np.float32) for c in (P, F_, V)]
    g = rng.normal(size=(300, field.out_ch)).astype(np.float32)
    _, vjp = jax.vjp(lambda v, *x: fused_nerf_apply(jfield, v, *x, approx=True),
                     variables, *map(jnp.asarray, inputs))
    d_vars, *d_ins = vjp(jnp.asarray(g))
    pts, feats, views = map(torch.from_numpy, inputs)
    saved = forward_values_plain(field, pts, feats, views)
    *got, d_pack = fused_nerf_backward_at_plain(field, saved, pts, feats,
                                                views, torch.from_numpy(g))
    for name, a, b in zip(("pts", "feats", "views"), got, d_ins):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-3 * np.abs(b).max(), name
    ref = from_jax_params({"nerf_static": jax.tree.map(np.asarray, d_vars)})
    _, offsets = pack_weights(field)
    leaves = dict(pack_leaves(field, d_pack, offsets))
    assert set(leaves) == {n for n, _ in field.named_parameters()}
    for name, a in leaves.items():
        b = ref[f"nerf_static.{name}"].numpy()
        if name.endswith(".weight"):
            b = b.T                           # the pack holds weight.T
        assert np.abs(a.numpy() - b).max() <= 1e-3 * np.abs(b).max(), name


@pytest.mark.parametrize("width", [64, 128, 256])
@pytest.mark.parametrize("static", [True, False])
@pytest.mark.parametrize("skips", [(4,), ()])
def test_backward_at_forward_values_matches_autograd(width, static, skips):
    P, F_, V = LAYOUTS[static]
    torch.manual_seed(12)
    field = NeRFField(8, width, P, V, F_, skips=skips, static=static,
                      bf16=True).double()
    rng = np.random.default_rng(13)
    pts, feats, views, g = (torch.from_numpy(rng.normal(size=(200, c)))
                            for c in (P, F_, V, field.out_ch))
    saved = forward_values_plain(field, pts, feats, views)
    assert len(saved["z"]) == 8 and saved["feature"].dtype == torch.bfloat16
    got = fused_nerf_backward_at_plain(field, saved, pts, feats, views, g)
    ref = fused_nerf_backward_plain(field, pts, feats, views, g)
    for name, a, b in zip(("d_pts", "d_feats", "d_views"), got, ref):
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max()), name
    _, offsets = pack_weights(field)
    for (name, a), (_, b) in zip(pack_leaves(field, got[3], offsets),
                                 pack_leaves(field, ref[3], offsets)):
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max()), name


class _Library:
    """Stands in for the kernel library: records each C entry called and
    returns 0 (success, and a zero length or size)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return 0
        return entry


@pytest.mark.parametrize("bf16,give_wb", [(True, False), (True, True),
                                          (False, False)])
def test_backward_routes_by_mode(bf16, give_wb, monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "require_cuda_f32", lambda *args: None)
    P, F_, V = LAYOUTS[False]
    field = NeRFField(8, 64, P, V, F_, static=False, bf16=bf16)
    with torch.no_grad():
        pack, offsets = pack_weights(field)
    n = 100
    pts, feats, views, g = (torch.empty((n, c), device="meta")
                            for c in (P, F_, V, field.out_ch))
    wb = torch.empty(3, device="meta", dtype=torch.bfloat16) if give_wb else None
    grads = fused_mlp.fused_nerf_backward(field, pts, feats, views, g,
                                          pack.to("meta"), offsets, wb)
    assert [t.shape for t in grads] == [pts.shape, feats.shape, views.shape,
                                        pack.shape]
    if bf16:
        want = ([] if give_wb else ["zt_fused_nerf_pack_tc_len",
                                    "zt_fused_nerf_pack_tc"])
        want += ["zt_fused_nerf_pack_bwd_tc_len", "zt_fused_nerf_pack_bwd_tc",
                 "zt_fused_nerf_backward_tc_scratch", "zt_fused_nerf_backward_tc"]
    else:
        want = ["zt_fused_nerf_backward_scratch", "zt_fused_nerf_backward_tpack",
                "zt_fused_nerf_backward", "zt_fused_nerf_backward_layout",
                "zt_fused_nerf_weight_grads_tc32"]
    assert lib.calls == want


@pytest.mark.parametrize("bf16", [False, True])
def test_forward_routes_by_mode(bf16, monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    P, F_, V = LAYOUTS[True]
    field = NeRFField(8, 64, P, V, F_, static=True, bf16=bf16)
    with torch.no_grad():
        pack, offsets = pack_weights(field)
    n = 100
    pts, feats, views = (torch.empty((n, c), device="meta")
                         for c in (P, F_, V))
    out, wb = fused_mlp._launch_forward(field, pts, feats, views,
                                        pack.to("meta"), offsets)
    assert out.shape == (n, field.out_ch)
    assert (wb is not None) == bf16
    entry = "zt_fused_nerf_forward_tc" if bf16 else "zt_fused_nerf_forward_tc32"
    pack_entry = "zt_fused_nerf_pack_tc" if bf16 else "zt_fused_nerf_pack_tc32"
    assert lib.calls == [pack_entry + "_len", pack_entry, entry]
