"""Fused NeRF field: CUDA kernels (forward and backward) and their plain
PyTorch twins.

Replaces ``zest_tpu/kernels/fused_mlp.py:_fwd_pallas`` (K6, the forward
``pallas_call`` behind ``fused_nerf_apply``) and ``_bwd_pallas`` (K7, its
custom VJP). K6 runs on the tensor cores in both modes, on one tile
(``csrc/fused_mlp_tc.cuh``): at float32 as 3xTF32 (``csrc/fused_mlp_tc32.cu``),
in the bf16-operand mode with bf16 operands (``csrc/fused_mlp_tc.cu``). K7
at float32 is two passes per chunk of points: pass 1 on the CUDA cores
(``csrc/fused_mlp.cu``, SIMT) recomputes the forward and takes the input
gradients, leaving every weight gradient's operands in a scratch buffer;
pass 2 (``weight_grads``, ``csrc/fused_mlp_tc32_bwd.cu``) takes the weight
gradients from it on the tensor cores as 3xTF32. K7's bf16-operand mode
runs on the tensor cores (``csrc/fused_mlp_tc_bwd.cu``) and recomputes the
forward with K6's own device code. Every product of the field runs inside
them. ``fused_nerf_forward`` is an
autograd Function over (pts, feats, views, pack): ``pack_weights`` is a
differentiable ``torch.cat``
of every Linear's ``weight.T`` and bias, so the packed weight gradient of K7
reaches each Linear. The twin is the port's ``models.nerf.NeRFField`` itself
and its autograd.

At float32 K6 splits every operand of the conditioning, trunk, feature and
views products into two TF32 values (``zest_tpu``'s ``approx=False``, exact
float32 on the TPU: three TF32 products keep ~22 bits of each operand), from
a float32 operand pack made from the float32 pack on the card by one launch
on every call (``pack_tc32``). The float32 K7's pass 1 recomputes the
forward with FMA sums, in another order than K6's; its pass 2 splits the
operands of the same products' weight gradients as K6 splits its own.

A field built with ``bf16=True`` runs the kernels' bf16-operand mode
(``zest_tpu``'s ``approx=True``): the kernels round the conditioning, trunk,
feature and views products' operands to bf16 and keep float32 sums, float32
biases and float32 heads, as the twin's ``bf16`` mode does. The forward's
bf16 weights are made from the float32 pack on the card by one launch on
every call (``pack_bf16``); the autograd Function saves the float32 pack
and that bf16 pack for K7, which makes one more, the backward's matrices
read [in][out] (``pack_bf16_bwd``), by one launch per call.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ..models.nerf import round_bf16

WIDTHS = (64, 128, 256)          # kernel instantiations
MAX_LAYERS = 16                  # kMaxLayers in csrc/fused_mlp.cuh
MAX_NARROW = 96                  # widest pts / feats / views (kNarrow)
SMEM_LIMIT = 232448              # bytes of shared memory a block may opt into
# offsets-table slots, as the Slot enum in csrc/fused_mlp.cuh numbers them
_WB, _LAYER0 = 0, 2
_WA = _LAYER0 + 2 * MAX_LAYERS
_WF, _WV, _WR, _WX1, _WX2 = _WA + 2, _WA + 4, _WA + 6, _WA + 8, _WA + 10
_N_SLOTS = _WA + 12
_TILE = 32
_SMEM_EXTRA = 16 + 8             # kGS + kES floats per point in the backward
CHUNK_ROWS = 65536               # points per float32 backward chunk
# points per bf16-mode backward chunk: ~21 KB of scratch per point at width
# 256, and a 16-bit training step's largest call (284,672 points) in one
BF16_CHUNK_ROWS = 1 << 19


def _slots(field):
    """(slot, Linear) of every layer, in the packed order."""
    slots = [(_WB, field.pts_bias)]
    slots += [(_LAYER0 + 2 * i, lin) for i, lin in enumerate(field.pts_linears)]
    slots += [(_WA, field.alpha_linear), (_WF, field.feature_linear),
              (_WV, field.views_linears[0]), (_WR, field.rgb_linear)]
    if field.static:
        slots.append((_WX1, field.w_linear))
    else:
        slots += [(_WX1, field.sf_linear), (_WX2, field.prob_linear)]
    return slots


def _pack(parts_by_slot):
    """[(slot, tensors...)] → one float buffer with every tensor starting on
    a multiple of 4 floats (the kernels read float4), and the offsets table
    (slot + k for the k-th tensor of a slot)."""
    offsets = [0] * _N_SLOTS
    parts, cur = [], 0
    for slot, tensors in parts_by_slot:
        for k, t in enumerate(tensors):
            offsets[slot + k] = cur
            t = t.reshape(-1)
            parts += [t, t.new_zeros(-t.numel() % 4)]
            cur += t.numel() + (-t.numel() % 4)
    return torch.cat(parts).contiguous(), offsets


def pack_weights(field):
    """All of a field's Linear layers as one [in][out]-major float buffer and
    the offsets table the kernels read. Differentiable in the weights.
    Returns (pack, offsets)."""
    return _pack([(slot, (lin.weight.T, lin.bias)) for slot, lin in _slots(field)])


def pack_grads(field):
    """The ``.grad`` of every Linear in ``pack_weights``' layout."""
    return _pack([(slot, (lin.weight.grad.T, lin.bias.grad))
                  for slot, lin in _slots(field)])[0]


def pack_leaves(field, pack, offsets):
    """The weight ([in, out]) and the bias of every Linear of the field as
    views of ``pack`` (or of a gradient in its layout), in the packed order:
    [(name, tensor)]."""
    names = {id(m): name for name, m in field.named_modules()}
    leaves = []
    for slot, lin in _slots(field):
        n_out, n_in = lin.weight.shape
        w0, b0 = offsets[slot], offsets[slot + 1]
        leaves += [(f"{names[id(lin)]}.weight", pack[w0:w0 + n_in * n_out]
                    .view(n_in, n_out)),
                   (f"{names[id(lin)]}.bias", pack[b0:b0 + n_out])]
    return leaves


def tc_layout(field):
    """The tensor-core matrices in the order K6's kernels run them: [(Linear,
    K parts)], each part a width of the Linear's input whose columns the
    operand packs zero pad to a multiple of the mma depth (16 bf16, 8
    float32): the conditioning, the trunk (the layer after a skip reads
    [pts, h]), the feature layer and the views layer ([feature, views])."""
    P, V, W = field.in_ch_pts, field.in_ch_views, field.width
    mats = [(field.pts_bias, [field.in_ch_feat])]
    mats += [(lin, [P] if i == 0 else [P, W] if i - 1 in field.skips else [W])
             for i, lin in enumerate(field.pts_linears)]
    return mats + [(field.feature_linear, [W]),
                   (field.views_linears[0], [W, V])]


@torch.no_grad()
def _operand_pack_plain(field, pack, offsets, dtype, depth):
    """Every matrix of ``tc_layout``, read from the float32 ``pack``
    (``pack_weights``' layout), as ``nn.Linear`` stores it, [out][in]
    (K-contiguous, the B operand of ``mma .row.col``), converted to dtype,
    each K part zero padded to a multiple of depth, the matrices back to
    back. Returns (pack, offsets): a flat tensor on the pack's device and
    each matrix's first element."""
    weights = {id(lin): pack[offsets[slot]:offsets[slot] + lin.weight.numel()]
               .view(lin.in_features, lin.out_features).T
               for slot, lin in _slots(field)}
    parts, moff, cur = [], [], 0
    for lin, widths in tc_layout(field):
        w = weights[id(lin)].to(dtype)
        mat = torch.cat([torch.nn.functional.pad(c, (0, -c.shape[1] % depth))
                         for c in torch.split(w, widths, dim=1)], 1)
        moff.append(cur)
        parts.append(mat.reshape(-1))
        cur += mat.numel()
    return torch.cat(parts), moff


def pack_bf16_plain(field, pack, offsets):
    """Twin of the bf16 pack kernel (``round_pack_tc_kernel``): the matrices
    of ``tc_layout`` rounded to bf16, each K part padded to a multiple of 16
    (``_operand_pack_plain``). Returns (pack, offsets)."""
    return _operand_pack_plain(field, pack, offsets, torch.bfloat16, 16)


def pack_tc32_plain(field, pack, offsets):
    """Twin of the float32 operand pack kernel (``pack_tc32_kernel``): the
    matrices of ``tc_layout`` in float32, each K part padded to a multiple
    of 8 (``_operand_pack_plain``). Returns (pack, offsets)."""
    return _operand_pack_plain(field, pack, offsets, torch.float32, 8)


def bf16_bwd_layout(field):
    """The backward's bf16-operand matrices in the order K7's tensor-core
    kernel runs them (``bwd_mats`` in ``csrc/fused_mlp_tc_bwd.cu``): [(Linear,
    first input row, rows)], each the rows of the Linear's ``weight.T``
    ([in][out], ``pack_weights``' layout) that one input-gradient product
    d_x = d_z @ W reads: the views layer's views part and its feature part,
    the feature layer, the trunk from the last layer down (the layer after
    a skip as its pts part, then its h part), the conditioning."""
    P, F, W = field.in_ch_pts, field.in_ch_feat, field.width
    views = field.views_linears[0]
    mats = [(views, W, field.in_ch_views), (views, 0, W),
            (field.feature_linear, 0, W)]
    for i in reversed(range(len(field.pts_linears))):
        lin = field.pts_linears[i]
        if i == 0:
            mats.append((lin, 0, P))
        elif i - 1 in field.skips:
            mats += [(lin, 0, P), (lin, P, W)]
        else:
            mats.append((lin, 0, W))
    return mats + [(field.pts_bias, 0, F)]


@torch.no_grad()
def pack_bf16_bwd_plain(field, pack, offsets):
    """Twin of the backward pack kernel (``round_pack_bwd_tc_kernel``):
    every matrix of ``bf16_bwd_layout``, read from the float32 ``pack`` as it
    stores it, [in rows][out], rounded to bf16, the matrices back to back.
    Returns (pack, offsets) as ``pack_bf16_plain`` does."""
    slot_of = {id(lin): slot for slot, lin in _slots(field)}
    parts, moff, cur = [], [], 0
    for lin, r0, rows in bf16_bwd_layout(field):
        start = offsets[slot_of[id(lin)]] + r0 * lin.out_features
        parts.append(pack[start:start + rows * lin.out_features]
                     .to(torch.bfloat16))
        moff.append(cur)
        cur += rows * lin.out_features
    return torch.cat(parts), moff


def _geometry(field):
    return (field.in_ch_pts, field.in_ch_feat, field.in_ch_views, field.width,
            len(field.pts_linears), field.skips[0] if field.skips else -2)


def _operand_pack(name, entry, dtype, field, pack, offsets):
    """One launch of the operand pack kernel behind C entry ``entry`` (its
    length from ``entry + "_len"``) on the float32 ``pack``."""
    lib = _build.library()
    length = getattr(lib, entry + "_len")(*_geometry(field))
    if length < 0:
        raise ValueError(f"{name}: no operand pack for {_geometry(field)}")
    out = torch.empty(length, device=pack.device, dtype=dtype)
    _build.check(getattr(lib, entry)(
        pack.data_ptr(), (ctypes.c_int * _N_SLOTS)(*offsets), out.data_ptr(),
        *_geometry(field), _build.stream_ptr(pack)), name)
    return out


def pack_bf16(field, pack, offsets):
    """K6's bf16 pack from the float32 ``pack`` (``pack_weights``): a flat
    bf16 tensor in ``pack_bf16_plain``'s layout. CPU tensors take the twin;
    CUDA tensors launch ``round_pack_tc_kernel`` (one launch) or raise."""
    if pack.device.type == "cpu":
        return pack_bf16_plain(field, pack, offsets)[0]
    return _operand_pack("pack_bf16", "zt_fused_nerf_pack_tc", torch.bfloat16,
                         field, pack, offsets)


def pack_tc32(field, pack, offsets):
    """K6's float32 operand pack from the float32 ``pack``: a flat float32
    tensor in ``pack_tc32_plain``'s layout. CPU tensors take the twin; CUDA
    tensors launch ``pack_tc32_kernel`` (one launch) or raise."""
    if pack.device.type == "cpu":
        return pack_tc32_plain(field, pack, offsets)[0]
    return _operand_pack("pack_tc32", "zt_fused_nerf_pack_tc32", torch.float32,
                         field, pack, offsets)


def pack_bf16_bwd(field, pack, offsets):
    """K7's backward pack from the float32 ``pack``: a flat bf16 tensor in
    ``pack_bf16_bwd_plain``'s layout. CPU tensors take the twin; CUDA
    tensors launch ``round_pack_bwd_tc_kernel`` (one launch) or raise."""
    if pack.device.type == "cpu":
        return pack_bf16_bwd_plain(field, pack, offsets)[0]
    lib = _build.library()
    length = lib.zt_fused_nerf_pack_bwd_tc_len(*_geometry(field))
    if length < 0:
        raise ValueError(f"pack_bf16_bwd: no pack for {_geometry(field)}")
    wbt = torch.empty(length, device=pack.device, dtype=torch.bfloat16)
    _build.check(lib.zt_fused_nerf_pack_bwd_tc(
        pack.data_ptr(), (ctypes.c_int * _N_SLOTS)(*offsets), wbt.data_ptr(),
        *_geometry(field), _build.stream_ptr(pack)), "pack_bf16_bwd")
    return wbt


def _check(name, field, pts, feats, views, extra_smem=0):
    P, F, V = field.in_ch_pts, field.in_ch_feat, field.in_ch_views
    if field.width not in WIDTHS:
        raise ValueError(f"{name}: width {field.width} not in {WIDTHS}")
    if len(field.pts_linears) > MAX_LAYERS or len(field.skips) > 1:
        raise ValueError(f"{name}: at most {MAX_LAYERS} layers and one skip")
    smem = 4 * _TILE * (2 * field.width + P + F + V + extra_smem)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {smem} bytes of shared memory per block "
                         f"exceed {SMEM_LIMIT}")
    lead = pts.shape[:-1]
    if (pts.shape[-1], feats.shape[-1], views.shape[-1]) != (P, F, V) or \
            feats.shape[:-1] != lead or views.shape[:-1] != lead:
        raise ValueError(f"{name}: expected [..., {P}], [..., {F}], [..., {V}]"
                         f" with one leading shape, got {tuple(pts.shape)}, "
                         f"{tuple(feats.shape)}, {tuple(views.shape)}")


def _launch_forward(field, pts, feats, views, pack, offsets):
    """K6 on [n, ch] contiguous inputs → ([n, out_ch], the bf16 pack or
    None): the tensor-core kernel of the field's mode, 3xTF32 on a float32
    operand pack (``pack_tc32``) or bf16 on the bf16 pack (``pack_bf16``),
    each made from ``pack`` by one launch."""
    n = pts.shape[0]
    out = torch.empty((n, field.out_ch), device=pts.device, dtype=torch.float32)
    lib = _build.library()
    inputs = (pts.data_ptr(), feats.data_ptr(), views.data_ptr(),
              pack.data_ptr(), (ctypes.c_int * _N_SLOTS)(*offsets))
    shape = (n, *_geometry(field), 1 if field.static else 2,
             _build.stream_ptr(pts))
    wb = None
    if field.bf16:
        wb = pack_bf16(field, pack, offsets)
        err = lib.zt_fused_nerf_forward_tc(*inputs, wb.data_ptr(),
                                           out.data_ptr(), *shape)
    else:
        wt = pack_tc32(field, pack, offsets)
        err = lib.zt_fused_nerf_forward_tc32(*inputs, wt.data_ptr(),
                                             out.data_ptr(), *shape)
    _build.check(err, "fused_nerf_forward")
    fused_nerf_forward.launches += 1
    return out, wb


class _FusedField(torch.autograd.Function):
    """K6 forward, K7 backward, over the packed weights."""

    @staticmethod
    def forward(ctx, pts, feats, views, pack, field, offsets):
        out, wb = _launch_forward(field, pts, feats, views, pack, offsets)
        ctx.save_for_backward(pts, feats, views, pack)
        ctx.field, ctx.offsets, ctx.wb = field, offsets, wb
        return out

    @staticmethod
    def backward(ctx, g):
        pts, feats, views, pack = ctx.saved_tensors
        grads = fused_nerf_backward(ctx.field, pts, feats, views,
                                    g.contiguous(), pack, ctx.offsets, ctx.wb)
        return (*grads, None, None)


def fused_nerf_forward(field, pts, feats, views):
    """Evaluate a v0 ``NeRFField`` on pts/feats/views [..., ch] → [..., out_ch],
    differentiable in the inputs and the field's weights.

    CPU tensors take the twin (the module itself); CUDA tensors launch the
    kernels or raise.
    """
    if pts.device.type == "cpu":
        return field(pts, feats, views)
    _check("fused_nerf_forward", field, pts, feats, views)
    lead = pts.shape[:-1]
    n = pts.numel() // field.in_ch_pts
    pts2, feats2, views2 = (t.reshape(n, t.shape[-1]).contiguous()
                            for t in (pts, feats, views))
    pack, offsets = pack_weights(field)
    _build.require_cuda_f32("fused_nerf_forward", pts2, feats2, views2, pack)
    out = _FusedField.apply(pts2, feats2, views2, pack, field, offsets)
    return out.reshape(*lead, field.out_ch)


fused_nerf_forward.launches = 0


def forward_values_plain(field, pts, feats, views):
    """The forward values that K7's bf16 mode keeps (``fused_nerf_backward``'s
    ``saved``), from the bf16 twin's own arithmetic: cond, every trunk
    layer's z_i (before the product with cond), the feature layer's output
    rounded to bf16, hv, and the output rows."""
    with torch.no_grad():
        mm = field._bf16_product
        cond = mm(field.pts_bias, feats)
        h, z = pts, []
        for i, lin in enumerate(field.pts_linears):
            z.append(mm(lin, h))
            h = torch.relu(z[-1] * cond)
            if i in field.skips:
                h = torch.cat([pts, h], -1)
        feature = mm(field.feature_linear, h)
        hv = torch.relu(mm(field.views_linears[0], torch.cat([feature, views],
                                                             -1)))
        return dict(cond=cond, z=z, feature=feature.to(torch.bfloat16), hv=hv,
                    out=field(pts, feats, views))


@torch.no_grad()
def fused_nerf_backward_at_plain(field, saved, pts, feats, views, g):
    """The bf16 twin's backward evaluated at given forward values (``saved``,
    as ``forward_values_plain`` or K7's bf16 mode gives them), so that every
    ReLU mask, every bf16-rounded activation and every head activation is
    the one those values imply: the plain version of K7's bf16 mode at K6's
    own forward. Each product as ``_BF16Linear``'s backward computes it
    (output gradient and input rounded to bf16, float32 sums, the bias
    gradient the float32 sum); the heads in float32. Returns (d_pts,
    d_feats, d_views, d_pack) with d_pack in ``pack_weights``' layout."""
    cond, zs, hv, out = saved["cond"], saved["z"], saved["hv"], saved["out"]
    feature = saved["feature"].to(cond.dtype)
    grads = {}

    def back(lin, d, *xs):
        """d_x of lin's bf16 product for its output gradient d; records
        lin's weight and bias gradients"""
        gr = round_bf16(d)
        grads[id(lin)] = (gr.T @ round_bf16(torch.cat(xs, -1)), d.sum(0))
        return gr @ round_bf16(lin.weight)

    def head(lin, d, x):
        grads[id(lin)] = (d.T @ x, d.sum(0))
        return d @ lin.weight

    h, ins = pts, []
    for i, z in enumerate(zs):
        ins.append((pts,) if i == 0 else (pts, h) if i - 1 in field.skips
                   else (h,))
        h = torch.relu(z * cond)
    g_rgb, g_alpha = g[:, :3], g[:, 3:4]
    d_h = head(field.alpha_linear, g_alpha, h)
    heads = ([(field.w_linear, False)] if field.static
             else [(field.sf_linear, True), (field.prob_linear, False)])
    col = 4
    for lin, is_tanh in heads:
        e = out[:, col:col + lin.out_features]
        ge = g[:, col:col + lin.out_features]
        ge = ge * (1 - e * e if is_tanh else e * (1 - e))
        d_h = d_h + head(lin, ge, h)
        col += lin.out_features
    d_hv = head(field.rgb_linear, g_rgb, hv) * (hv > 0)
    W = field.width
    d_x = back(field.views_linears[0], d_hv, feature, views)
    d_feature, d_views = d_x[:, :W], d_x[:, W:]
    d_h = d_h + back(field.feature_linear, d_feature, h)
    d_cond = torch.zeros_like(cond)
    d_pts = torch.zeros_like(pts)
    for i in reversed(range(len(zs))):
        d_a = d_h * (zs[i] * cond > 0)
        d_cond = d_cond + d_a * zs[i]
        d_x = back(field.pts_linears[i], d_a * cond, *ins[i])
        if i == 0:
            d_pts = d_pts + d_x
        elif i - 1 in field.skips:
            d_pts, d_h = d_pts + d_x[:, :field.in_ch_pts], d_x[:, field.in_ch_pts:]
        else:
            d_h = d_x
    d_feats = back(field.pts_bias, d_cond, feats)
    return d_pts, d_feats, d_views, _pack(
        [(slot, (grads[id(lin)][0].T, grads[id(lin)][1]))
         for slot, lin in _slots(field)])[0]


def fused_nerf_backward_plain(field, pts, feats, views, g):
    """Twin of K7: autograd through the field module. Returns (d_pts,
    d_feats, d_views, d_pack) with d_pack in ``pack_weights``' layout; the
    field's ``.grad`` are overwritten."""
    inputs = [t.detach().requires_grad_(True) for t in (pts, feats, views)]
    field.zero_grad(set_to_none=False)
    with torch.enable_grad():
        out = field(*inputs)
        out.backward(g)
    return (*(t.grad for t in inputs), pack_grads(field))


# the buffers K7 float32's pass 1 leaves per chunk, in the order of its
# scratch (Scratch in csrc/fused_mlp.cu) and of the pass-2 entry's pointers
_BUFS = ("cond", "z", "feature", "hv", "dz", "d_cond", "d_feature", "d_hv",
         "g_heads")


def _scratch_views(lib, field, scratch, rows):
    """The buffers K7 float32's pass 1 left in ``scratch`` for a chunk of
    ``rows`` points, as views by name (``_BUFS``): z and dz [depth, rows, W],
    hv and d_hv [rows, W / 2], g_heads [rows, out_ch], the others [rows, W]
    (their places: ``zt_fused_nerf_backward_layout``)."""
    at = (ctypes.c_longlong * len(_BUFS))()
    _build.check(lib.zt_fused_nerf_backward_layout(
        rows, *_geometry(field), 1 if field.static else 2, at), "weight_grads")
    W, depth = field.width, len(field.pts_linears)
    dims = {"z": (depth, rows, W), "dz": (depth, rows, W),
            "hv": (rows, W // 2), "d_hv": (rows, W // 2),
            "g_heads": (rows, field.out_ch)}
    views = {}
    for name, offset in zip(_BUFS, at):
        size = dims.get(name, (rows, W))
        stride = [math.prod(size[i + 1:]) for i in range(len(size))]
        views[name] = scratch.as_strided(size, stride, offset)
    return views


def weight_grads_plain(field, pts, feats, views, bufs, product=None):
    """Twin of ``weight_grads``: the field's weight and bias gradients in
    ``pack_weights``' layout from one chunk's inputs [n, ch] and the buffers
    pass 1 left (``bufs``: the forward values cond, z [depth, n, W], feature
    and hv, the output gradients dz [depth, n, W], d_cond, d_feature, d_hv,
    and g_heads [n, out_ch], the heads' pre-activation gradients). The
    trunk's inputs are rebuilt as relu(z * cond). ``product(x, d)`` takes
    x^T d for the conditioning, trunk, feature and views layers (a float32
    product by default); the heads' products are float32; each bias
    gradient is the column sum of its d."""
    product = product or (lambda x, d: x.T @ d)
    cond, g = bufs["cond"], bufs["g_heads"]
    h, ins = pts, []
    for i, z in enumerate(bufs["z"]):
        ins.append((pts,) if i == 0 else (pts, h) if i - 1 in field.skips
                   else (h,))
        h = torch.relu(z * cond)
    grads = {}
    for lin, xs, d in [(field.pts_bias, (feats,), bufs["d_cond"]),
                       *zip(field.pts_linears, ins, bufs["dz"]),
                       (field.feature_linear, (h,), bufs["d_feature"]),
                       (field.views_linears[0], (bufs["feature"], views),
                        bufs["d_hv"])]:
        grads[id(lin)] = (product(torch.cat(xs, -1), d), d.sum(0))
    heads = [(field.rgb_linear, bufs["hv"], g[:, :3]),
             (field.alpha_linear, h, g[:, 3:4])]
    heads += ([(field.w_linear, h, g[:, 4:])] if field.static else
              [(field.sf_linear, h, g[:, 4:10]),
               (field.prob_linear, h, g[:, 10:])])
    for lin, x, d in heads:
        grads[id(lin)] = (x.T @ d, d.sum(0))
    return _pack([(slot, grads[id(lin)]) for slot, lin in _slots(field)])[0]


def weight_grads(field, pts, feats, views, bufs, offsets, d_pack):
    """K7 float32's pass 2 on one chunk: every weight and bias gradient of
    the field from the chunk's inputs [n, ch] and the buffers its pass 1
    left (``bufs``, as ``_scratch_views`` gives them), added into d_pack
    (``pack_weights``' layout; ``offsets`` its table).

    CPU tensors take the twin (``weight_grads_plain``); CUDA tensors launch
    ``wgrad_tc32_kernel`` (the conditioning, trunk, feature and views
    layers' products as 3xTF32 on the tensor cores, one launch) and
    ``head_grads_kernel`` (the heads, float32), or raise.
    """
    if d_pack.device.type == "cpu":
        d_pack += weight_grads_plain(field, pts, feats, views, bufs)
        return
    name = "weight_grads"
    n = pts.shape[0]
    tensors = (pts, feats, views, *(bufs[k] for k in _BUFS))
    if any(t.shape[-2] != n for t in tensors):
        raise ValueError(f"{name}: every buffer needs the chunk's {n} rows")
    _build.require_cuda_f32(name, *tensors, d_pack)
    _build.check(_build.library().zt_fused_nerf_weight_grads_tc32(
        *(t.data_ptr() for t in tensors), (ctypes.c_int * _N_SLOTS)(*offsets),
        d_pack.data_ptr(), n, *_geometry(field), 1 if field.static else 2,
        _build.stream_ptr(pts)), name)
    weight_grads.launches += 1


weight_grads.launches = 0


def _kept_values(lib, field, scratch, n, shape):
    """The forward values K7's bf16 mode left in its scratch (one chunk of
    n points), as float32 / bf16 views: cond, z (a list), hv, feature."""
    at = (ctypes.c_longlong * 5)()
    _build.check(lib.zt_fused_nerf_backward_tc_layout(n, BF16_CHUNK_ROWS,
                                                      *shape, at), "saved")
    R, W = at[0], field.width

    def view(offset, dtype, count, cols):
        size = torch.finfo(dtype).bits // 8
        return (scratch[offset:offset + size * count * R * cols].view(dtype)
                .view(count, R, cols)[:, :n])

    return dict(z=list(view(at[1], torch.float32, len(field.pts_linears), W)),
                cond=view(at[2], torch.float32, 1, W)[0],
                hv=view(at[3], torch.float32, 1, W // 2)[0],
                feature=view(at[4], torch.bfloat16, 1, W)[0])


def fused_nerf_backward(field, pts, feats, views, g, pack, offsets, wb=None,
                        recomputed=None, saved=None):
    """K7: the field's gradients at [n, ch] inputs for the output gradient g
    [n, out_ch] → (d_pts, d_feats, d_views, d_pack), d_pack in the layout of
    ``pack`` (``pack_weights``).

    In the bf16-operand mode, wb is K6's bf16 pack of ``pack`` (the forward
    made it; made here when None), and ``recomputed`` ([n, out_ch] float32,
    optional) receives the output rows that the backward recomputed, which
    equal K6's bit for bit. A dict given as ``saved`` (with n at most
    ``BF16_CHUNK_ROWS``) receives the forward values the backward ran at, as
    ``forward_values_plain`` gives them, for ``fused_nerf_backward_at_plain``.

    CPU tensors take the twin (the module's own weights); CUDA tensors
    launch the kernels or raise.
    """
    if pts.device.type == "cpu":
        return fused_nerf_backward_plain(field, pts, feats, views, g)
    name = "fused_nerf_backward"
    _check(name, field, pts, feats, views, _SMEM_EXTRA)
    P, F, V = field.in_ch_pts, field.in_ch_feat, field.in_ch_views
    if max(P, F, V) > MAX_NARROW:
        raise ValueError(f"{name}: inputs wider than {MAX_NARROW} channels")
    n = pts.shape[0]
    if pts.dim() != 2 or g.shape != (n, field.out_ch):
        raise ValueError(f"{name}: expected [n, ch] inputs and g of "
                         f"[{n}, {field.out_ch}], got {tuple(pts.shape)}, "
                         f"{tuple(g.shape)}")
    if recomputed is not None and (not field.bf16 or
                                   recomputed.shape != (n, field.out_ch)):
        raise ValueError(f"{name}: recomputed rows are the bf16 mode's, "
                         f"[{n}, {field.out_ch}]")
    if saved is not None and (not field.bf16 or n > BF16_CHUNK_ROWS):
        raise ValueError(f"{name}: the forward values are kept in the bf16 "
                         f"mode and for one chunk ({BF16_CHUNK_ROWS} points)")
    if saved is not None and recomputed is None:
        recomputed = torch.empty((n, field.out_ch), device=pts.device)
    _build.require_cuda_f32(name, pts, feats, views, g, pack,
                            *([] if recomputed is None else [recomputed]))
    lib = _build.library()
    d_pts, d_feats, d_views = (torch.empty_like(t) for t in (pts, feats, views))
    d_pack = torch.zeros_like(pack)
    inputs = (pts.data_ptr(), feats.data_ptr(), views.data_ptr(), g.data_ptr(),
              pack.data_ptr(), (ctypes.c_int * _N_SLOTS)(*offsets))
    shape = (*_geometry(field), 1 if field.static else 2)
    size = ctypes.c_longlong()
    if field.bf16:
        if wb is None:
            wb = pack_bf16(field, pack, offsets)
        wbt = pack_bf16_bwd(field, pack, offsets)
        _build.check(lib.zt_fused_nerf_backward_tc_scratch(
            n, BF16_CHUNK_ROWS, *shape, ctypes.byref(size)), name)
        scratch = torch.empty(size.value, device=pts.device, dtype=torch.uint8)
        err = lib.zt_fused_nerf_backward_tc(
            *inputs, wb.data_ptr(), wbt.data_ptr(), scratch.data_ptr(),
            scratch.numel(), BF16_CHUNK_ROWS,
            *(t.data_ptr() for t in (d_pts, d_feats, d_views, d_pack)),
            None if recomputed is None else recomputed.data_ptr(),
            int(saved is not None), n, *shape, _build.stream_ptr(pts))
        if saved is not None:
            saved.update(_kept_values(lib, field, scratch, n, shape),
                         out=recomputed)
        _build.check(err, name)
    else:
        _build.check(lib.zt_fused_nerf_backward_scratch(
            n, CHUNK_ROWS, *shape, ctypes.byref(size)), name)
        scratch = torch.empty(size.value, device=pts.device,
                              dtype=torch.float32)
        stream = _build.stream_ptr(pts)
        _build.check(lib.zt_fused_nerf_backward_tpack(
            *inputs[4:], scratch.data_ptr(), scratch.numel(), *shape, stream),
            name)
        for c0 in range(0, n, CHUNK_ROWS):
            rows = min(CHUNK_ROWS, n - c0)
            part = [t[c0:c0 + rows] for t in (pts, feats, views, g, d_pts,
                                             d_feats, d_views)]
            _build.check(lib.zt_fused_nerf_backward(
                *(t.data_ptr() for t in part[:4]), *inputs[4:],
                scratch.data_ptr(), scratch.numel(),
                *(t.data_ptr() for t in part[4:]), rows, *shape, stream), name)
            weight_grads(field, *part[:3],
                         _scratch_views(lib, field, scratch, rows), offsets,
                         d_pack)
    fused_nerf_backward.launches += 1
    return d_pts, d_feats, d_views, d_pack


fused_nerf_backward.launches = 0
