"""Fused NeRF field: CUDA kernels (forward and backward) and their plain
PyTorch twins.

Replaces ``zest_tpu/kernels/fused_mlp.py:_fwd_pallas`` (K6, the forward
``pallas_call`` behind ``fused_nerf_apply``) and ``_bwd_pallas`` (K7, its
custom VJP). K6 runs on the tensor cores in both modes, on one tile
(``csrc/fused_mlp_tc.cuh``): at float32 as 3xTF32 (``csrc/fused_mlp_tc32.cu``),
in the bf16-operand mode with bf16 operands (``csrc/fused_mlp_tc.cu``). K7
at float32 is three launches per chunk of points, all on the tensor cores
as 3xTF32, each behind a wrapper with its own launch counter and plain
twin: ``recompute`` (launch A) is K6's own float32 tile with a hook that
leaves the forward's values in a scratch buffer (``csrc/fused_mlp_tc32.cu``),
so the gradient is taken at K6's forward bit for bit; ``input_grads``
(launch B, ``csrc/fused_mlp_tc32_dx.cu``) takes the input gradients from
them and leaves every layer's output gradient beside them; ``weight_grads``
(pass 2, ``csrc/fused_mlp_tc32_bwd.cu``) takes the weight gradients from the
scratch. K7's bf16-operand mode runs on the tensor cores
(``csrc/fused_mlp_tc_bwd.cu``) and recomputes the forward with K6's own
device code. Every product of the field runs inside them. ``fused_nerf_forward`` is an
autograd Function over (pts, feats, views, pack): ``pack_weights`` is a
differentiable ``torch.cat``
of every Linear's ``weight.T`` and bias, so the packed weight gradient of K7
reaches each Linear. The twin is the port's ``models.nerf.NeRFField`` itself
and its autograd. The kernels take a field conditioned on a volume
(``use_mvs``) with any of its head geometries, ``NeRFField.n_extra``: no
extra head (4 outputs, MVSNeRF's static field), the blend (5) or the flow
and probabilities (12); every entry gets ``n_extra``. A field with a
time code (``train_video``: ``NeRFField.code_dim``, its first and skip
layers that much wider) runs them on ``in_ch_pts`` point channels: the
pack drops the code's columns and carries the code folded into those
layers' biases (``pack_weights(field, code)``, ``kernels.time_codes``), so
K7's bias gradient of those layers is the fold's input gradient.

At float32 K6 splits every operand of the conditioning, trunk, feature and
views products into two TF32 values (``zest_tpu``'s ``approx=False``, exact
float32 on the TPU: three TF32 products keep ~22 bits of each operand), from
a float32 operand pack made from the float32 pack on the card by one launch
on every call (``pack_tc32``). The float32 K7 splits the operands of the
same products' input and weight gradients as K6 splits its own; its input
gradients read the float32 pack itself, whose [in][out] layout is their B
operand.

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
from .time_codes import fold_codes
from ..models.nerf import append_code, round_bf16

WIDTHS = (64, 128, 256)          # kernel instantiations
MAX_LAYERS = 16                  # kMaxLayers in csrc/fused_mlp.cuh
MAX_NARROW = 96                  # widest pts / feats / views (kNarrow)
# offsets-table slots, as the Slot enum in csrc/fused_mlp.cuh numbers them
_WB, _LAYER0 = 0, 2
_WA = _LAYER0 + 2 * MAX_LAYERS
_WF, _WV, _WR, _WX1, _WX2 = _WA + 2, _WA + 4, _WA + 6, _WA + 8, _WA + 10
_N_SLOTS = _WA + 12
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
    slots += [(slot, lin) for slot, (lin, _) in zip((_WX1, _WX2),
                                                    field.extra_heads())]
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


def code_layers(field):
    """The trunk layers that read the points input, and so the time code:
    the first and the one after each skip."""
    return [i for i in range(len(field.pts_linears))
            if i == 0 or i - 1 in field.skips]


def _narrow(field, lin):
    """lin's weight without the time code's columns [P, P + code_dim)."""
    P, T = field.in_ch_pts, field.code_dim
    return torch.cat([lin.weight[:, :P], lin.weight[:, P + T:]], 1)


def folded_biases(field, code):
    """The biases of ``code_layers`` with the time code s [code_dim] folded
    in, b + s @ W_code^T ([len(code_layers), W], ``time_codes.fold_codes``:
    the fold kernel on CUDA tensors), differentiable in s and the
    weights."""
    P, T = field.in_ch_pts, field.code_dim
    lins = [field.pts_linears[i] for i in code_layers(field)]
    return fold_codes(code, torch.stack([lin.weight[:, P:P + T]
                                         for lin in lins]),
                      torch.stack([lin.bias for lin in lins]), field.bf16)


def pack_weights(field, code=None):
    """All of a field's Linear layers as one [in][out]-major float buffer and
    the offsets table the kernels read. Differentiable in the weights. A
    field with a time code (``code_dim``) takes its code s: the layers that
    read it are packed without its columns and with the folded biases
    (``folded_biases``), so the kernels see ``in_ch_pts`` point channels.
    Returns (pack, offsets)."""
    parts = [(slot, (lin.weight.T, lin.bias)) for slot, lin in _slots(field)]
    if field.code_dim:
        if code is None:
            raise ValueError(f"a field with a time code of {field.code_dim} "
                             f"channels needs its code")
        for c, i in zip(folded_biases(field, code), code_layers(field)):
            parts[1 + i] = (_LAYER0 + 2 * i,
                            (_narrow(field, field.pts_linears[i]).T, c))
    return _pack(parts)


@torch.no_grad()
def folded_field(field, code):
    """``field`` at the time code s [code_dim] as a field without a code:
    the same module with the code's columns dropped and their share in the
    biases (``folded_biases``). Its forward on pts equals field's on
    [pts, s]; K6 and K7 run on it as ``pack_weights(field, s)`` runs them."""
    from ..models.nerf import NeRFField
    out = NeRFField(field.depth, field.width, field.in_ch_pts,
                    field.in_ch_views, field.in_ch_feat, field.skips,
                    field.static, bf16=field.bf16,
                    sceneflow=field.n_extra > 0, use_mvs=field.use_mvs,
                    net_type=field.net_type).to(field.pts_bias.weight)
    state = dict(field.state_dict())
    for c, i in zip(folded_biases(field, code), code_layers(field)):
        state[f"pts_linears.{i}.weight"] = _narrow(field, field.pts_linears[i])
        state[f"pts_linears.{i}.bias"] = c
    out.load_state_dict(state)
    return out


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


def _check(name, field, pts, feats, views):
    P, F, V = field.in_ch_pts, field.in_ch_feat, field.in_ch_views
    if not field.fused:
        raise ValueError(f"{name}: the kernels take a v0 field conditioned "
                         f"on a volume (use_mvs)")
    if field.width not in WIDTHS:
        raise ValueError(f"{name}: width {field.width} not in {WIDTHS}")
    if len(field.pts_linears) > MAX_LAYERS or len(field.skips) > 1:
        raise ValueError(f"{name}: at most {MAX_LAYERS} layers and one skip")
    lead = pts.shape[:-1]
    if (pts.shape[-1], feats.shape[-1], views.shape[-1]) != (P, F, V) or \
            feats.shape[:-1] != lead or views.shape[:-1] != lead:
        raise ValueError(f"{name}: expected [..., {P}], [..., {F}], [..., {V}]"
                         f" with one leading shape, got {tuple(pts.shape)}, "
                         f"{tuple(feats.shape)}, {tuple(views.shape)}")


def _launch_forward(field, pts, feats, views, pack, offsets):
    """K6 on [n, ch] contiguous inputs → ([n, out_ch], its operand pack):
    the tensor-core kernel of the field's mode, 3xTF32 on a float32 operand
    pack (``pack_tc32``) or bf16 on the bf16 pack (``pack_bf16``), each made
    from ``pack`` by one launch."""
    n = pts.shape[0]
    out = torch.empty((n, field.out_ch), device=pts.device, dtype=torch.float32)
    lib = _build.library()
    inputs = (pts.data_ptr(), feats.data_ptr(), views.data_ptr(),
              pack.data_ptr(), (ctypes.c_int * _N_SLOTS)(*offsets))
    shape = (n, *_geometry(field), field.n_extra,
             _build.stream_ptr(pts))
    if field.bf16:
        wb = pack_bf16(field, pack, offsets)
        err = lib.zt_fused_nerf_forward_tc(*inputs, wb.data_ptr(),
                                           out.data_ptr(), *shape)
    else:
        wb = pack_tc32(field, pack, offsets)
        err = lib.zt_fused_nerf_forward_tc32(*inputs, wb.data_ptr(),
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


def fused_nerf_forward(field, pts, feats, views, code=None):
    """Evaluate a v0 ``NeRFField`` on pts/feats/views [..., ch] → [..., out_ch],
    differentiable in the inputs and the field's weights; a field with a
    time code (``code_dim``) takes its code [code_dim], the same for every
    point, and pts without it.

    CPU tensors take the twin (the module itself, on pts with the code
    after its channels); CUDA tensors launch the kernels (with a code, the
    fold into the biases and K6 / K7 on ``in_ch_pts`` point channels) or
    raise.
    """
    if pts.device.type == "cpu":
        if field.code_dim:
            pts = append_code(pts, code)
        return field(pts, feats, views)
    _check("fused_nerf_forward", field, pts, feats, views)
    lead = pts.shape[:-1]
    n = pts.numel() // field.in_ch_pts
    pts2, feats2, views2 = (t.reshape(n, t.shape[-1]).contiguous()
                            for t in (pts, feats, views))
    pack, offsets = pack_weights(field, code)
    _build.require_cuda_f32("fused_nerf_forward", pts2, feats2, views2, pack)
    out = _FusedField.apply(pts2, feats2, views2, pack, field, offsets)
    return out.reshape(*lead, field.out_ch)


fused_nerf_forward.launches = 0


def forward_values_plain(field, pts, feats, views):
    """The forward values that K7 keeps, from the twin's own arithmetic in
    the field's mode: cond, every trunk layer's z_i (before the product with
    cond), the feature layer's output (rounded to bf16 in the bf16 mode, as
    its ``saved`` holds it), hv, and the output rows."""
    with torch.no_grad():
        mm = field._bf16_product if field.bf16 else (lambda lin, x: lin(x))
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
        if field.bf16:
            feature = feature.to(torch.bfloat16)
        return dict(cond=cond, z=z, feature=feature, hv=hv,
                    out=field(pts, feats, views))



def branch_rows(a, b):
    """The points at which two sets of forward values (as
    ``forward_values_plain`` gives them) take another ReLU branch anywhere:
    a trunk unit's z * cond > 0, or hv > 0. Where they do, a gradient taken
    at one differs from one taken at the other by far more than rounding.
    Returns a bool tensor [n]."""
    rows = ((a["hv"] > 0) != (b["hv"] > 0)).any(-1)
    for za, zb in zip(a["z"], b["z"]):
        rows |= ((za * a["cond"] > 0) != (zb * b["cond"] > 0)).any(-1)
    return rows


def kept_rows(values, rows):
    """Forward values (as ``forward_values_plain`` gives them) at the points
    selected by ``rows``."""
    return {k: [t[rows] for t in v] if k == "z" else v[rows]
            for k, v in values.items()}


@torch.no_grad()
def fused_nerf_backward_at_plain(field, saved, pts, feats, views, g):
    """The twin's backward in the field's mode evaluated at given forward
    values (``saved``, as ``forward_values_plain`` or K7 gives them), so
    that every ReLU mask, every bf16-rounded activation and every head
    activation is the one those values imply: the plain version of K7 at
    K6's own forward. In the bf16 mode each product as ``_BF16Linear``'s
    backward computes it (output gradient and input rounded to bf16, float32
    sums, the bias gradient the float32 sum), in the float32 mode in the
    field's dtype; the heads unrounded: ``input_grads_plain``, then
    ``weight_grads_plain``. Returns (d_pts, d_feats, d_views, d_pack) with
    d_pack in ``pack_weights``' layout."""
    rnd = round_bf16 if field.bf16 else (lambda t: t)
    cond = saved["cond"]
    bufs = dict(cond=cond, z=torch.stack(list(saved["z"])), hv=saved["hv"],
                feature=saved["feature"].to(cond.dtype),
                g_heads=head_grads_plain(field, saved["out"], g))
    bufs.update(input_grads_plain(field, bufs,
                                  lambda d, w: rnd(d) @ rnd(w).T))
    return (bufs["d_pts"], bufs["d_feats"], bufs["d_views"],
            weight_grads_plain(field, pts, feats, views, bufs,
                               lambda x, d: rnd(x).T @ rnd(d)))


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
# scratch (zt_fused_nerf_backward_layout, csrc/fused_mlp_tc32_dx.cu) and of
# the pass-2 entry's pointers: recompute writes the forward's (_KEPT),
# input_grads the output gradients (_DZ)
_BUFS = ("cond", "z", "feature", "hv", "dz", "d_cond", "d_feature", "d_hv",
         "g_heads")
_KEPT = ("cond", "z", "feature", "hv", "g_heads")
_DZ = ("dz", "d_cond", "d_feature", "d_hv")
_INPUTS = ("d_pts", "d_feats", "d_views")


def _scratch_views(lib, field, scratch, rows):
    """The buffers K7 float32's pass 1 left in ``scratch`` for a chunk of
    ``rows`` points, as views by name (``_BUFS``): z and dz [depth, rows, W],
    hv and d_hv [rows, W / 2], g_heads [rows, out_ch], the others [rows, W]
    (their places: ``zt_fused_nerf_backward_layout``)."""
    at = (ctypes.c_longlong * len(_BUFS))()
    _build.check(lib.zt_fused_nerf_backward_layout(
        rows, *_geometry(field), field.n_extra, at), "weight_grads")
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


def head_grads_plain(field, out, g):
    """The heads' pre-activation gradients g' [n, out_ch] from the output
    rows ``out`` and the output gradient g: rgb and alpha as given, the
    blend and the probability through their sigmoid, the flow through its
    tanh."""
    parts, c = [g[:, :4]], 4
    for lin, act in field.extra_heads():
        e = out[:, c:c + lin.out_features]
        slope = 1 - e * e if act is torch.tanh else e * (1 - e)
        parts.append(g[:, c:c + lin.out_features] * slope)
        c += lin.out_features
    return torch.cat(parts, -1)


@torch.no_grad()
def recompute_plain(field, pts, feats, views, g):
    """Twin of ``recompute``: the float32 twin's forward values that K7
    float32 keeps for a chunk's inputs [n, ch], by ``_KEPT``'s names (cond,
    z [depth, n, W], the feature layer's output, hv, and g_heads from the
    output gradient g, ``head_grads_plain``), and the output rows as
    ``out``."""
    values = forward_values_plain(field, pts, feats, views)
    return dict(cond=values["cond"], z=torch.stack(values["z"]),
                feature=values["feature"], hv=values["hv"],
                g_heads=head_grads_plain(field, values["out"], g),
                out=values["out"])


def recompute(field, pts, feats, views, g, pack, offsets, wt, bufs,
              out=None):
    """K7 float32's pass 1, launch A, on one chunk: K6's float32 forward of
    the chunk's inputs [n, ch] on K6's operand pack ``wt`` (``pack_tc32`` of
    ``pack``, the float32 pack, and ``offsets``, its table), leaving in
    ``bufs`` (``_scratch_views``) cond, z, the feature layer's output, hv,
    and g_heads from the output gradient g [n, out_ch]; ``out`` [n,
    out_ch], if given, receives the output rows, K6's bit for bit.

    CPU tensors take the twin (``recompute_plain``); CUDA tensors launch
    ``recompute_tc32_kernel`` (K6's tile with its scratch hook), or raise.
    """
    if pts.device.type == "cpu":
        values = recompute_plain(field, pts, feats, views, g)
        for name in _KEPT:
            bufs[name].copy_(values[name])
        if out is not None:
            out.copy_(values["out"])
        return
    name = "recompute"
    n = pts.shape[0]
    tensors = (pts, feats, views, g, *(bufs[k] for k in _KEPT),
               *([] if out is None else [out]))
    if any(t.shape[-2] != n for t in tensors):
        raise ValueError(f"{name}: every buffer needs the chunk's {n} rows")
    _build.require_cuda_f32(name, *tensors, pack, wt)
    _build.check(_build.library().zt_fused_nerf_recompute_tc32(
        *(t.data_ptr() for t in tensors[:4]), pack.data_ptr(),
        (ctypes.c_int * _N_SLOTS)(*offsets), wt.data_ptr(),
        *(bufs[k].data_ptr() for k in _KEPT),
        None if out is None else out.data_ptr(), n, *_geometry(field),
        field.n_extra, _build.stream_ptr(pts)), name)
    recompute.launches += 1


recompute.launches = 0


@torch.no_grad()
def input_grads_plain(field, bufs, product=None):
    """Twin of ``input_grads``: the backward of one chunk in reverse order,
    from the forward values in ``bufs`` (cond, z [depth, n, W], hv,
    g_heads). Each input-gradient product d_x = d_z @ W is ``product(d,
    w)`` = d @ w^T, w the Linear's ``weight.T`` ([in][out], the float32
    pack's layout; a float32 product by default); the masks, the products
    with cond and the heads are float32. Returns a dict: d_pts, d_feats,
    d_views and the buffers it leaves for pass 2 (``_DZ``: dz [depth, n, W],
    d_cond, d_feature, d_hv)."""
    product = product or (lambda d, w: d @ w.T)
    cond, zs, g = bufs["cond"], bufs["z"], bufs["g_heads"]
    P, W = field.in_ch_pts, field.width

    def back(lin, d):
        return product(d, lin.weight.T)

    heads = [field.alpha_linear] + [lin for lin, _ in field.extra_heads()]
    d_hv = (g[:, :3] @ field.rgb_linear.weight) * (bufs["hv"] > 0)
    d_x = back(field.views_linears[0], d_hv)
    d_feature, d_views = d_x[:, :W], d_x[:, W:]
    d_h = back(field.feature_linear, d_feature) + g[:, 3:] @ torch.cat(
        [lin.weight for lin in heads])
    d_cond = torch.zeros_like(cond)
    d_pts = cond.new_zeros((cond.shape[0], P))
    dz = [None] * len(zs)
    for i in reversed(range(len(zs))):
        d_a = d_h * (zs[i] * cond > 0)
        d_cond = d_cond + d_a * zs[i]
        dz[i] = d_a * cond
        d_x = back(field.pts_linears[i], dz[i])
        if i == 0:
            d_pts = d_pts + d_x
        elif i - 1 in field.skips:
            d_pts, d_h = d_pts + d_x[:, :P], d_x[:, P:]
        else:
            d_h = d_x
    return dict(d_pts=d_pts, d_feats=back(field.pts_bias, d_cond),
                d_views=d_views, dz=torch.stack(dz), d_cond=d_cond,
                d_feature=d_feature, d_hv=d_hv)


def input_grads(field, bufs, pack, offsets, d_pts, d_feats, d_views):
    """K7 float32's pass 1, launch B, on one chunk after ``recompute``:
    d_pts, d_feats and d_views [n, ch] are written, and dz, d_cond,
    d_feature and d_hv into ``bufs`` for pass 2. ``pack`` is the float32
    pack (``offsets`` its table), whose [in][out] weights are the products'
    B operands.

    CPU tensors take the twin (``input_grads_plain``); CUDA tensors launch
    ``input_grads_tc32_kernel`` (every product as 3xTF32 on the tensor
    cores), or raise.
    """
    if d_pts.device.type == "cpu":
        got = input_grads_plain(field, bufs)
        for name, t in zip(_INPUTS, (d_pts, d_feats, d_views)):
            t.copy_(got[name])
        for name in _DZ:
            bufs[name].copy_(got[name])
        return
    name = "input_grads"
    n = d_pts.shape[0]
    tensors = (*(bufs[k] for k in ("cond", "z", "hv", "g_heads", *_DZ)),
               d_pts, d_feats, d_views)
    if any(t.shape[-2] != n for t in tensors):
        raise ValueError(f"{name}: every buffer needs the chunk's {n} rows")
    _build.require_cuda_f32(name, *tensors, pack)
    _build.check(_build.library().zt_fused_nerf_input_grads_tc32(
        pack.data_ptr(), (ctypes.c_int * _N_SLOTS)(*offsets),
        *(t.data_ptr() for t in tensors), n, *_geometry(field),
        field.n_extra, _build.stream_ptr(d_pts)), name)
    input_grads.launches += 1


input_grads.launches = 0


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
    c = 4
    for lin, _ in field.extra_heads():
        heads.append((lin, h, g[:, c:c + lin.out_features]))
        c += lin.out_features
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
        d_pack.data_ptr(), n, *_geometry(field), field.n_extra,
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

    wb is K6's operand pack of ``pack`` in the field's mode (bf16 or
    float32, the one the forward ran on; made here when None), and ``recomputed`` ([n,
    out_ch] float32, optional) receives the output rows that the backward
    recomputed, which equal K6's bit for bit in both modes. A dict given as
    ``saved`` (in the bf16-operand mode with n at most ``BF16_CHUNK_ROWS``)
    receives the forward values the backward ran at, as
    ``forward_values_plain`` gives them, for ``fused_nerf_backward_at_plain``.
    At float32 each chunk of ``CHUNK_ROWS`` points runs ``recompute``,
    ``input_grads`` and ``weight_grads``.

    CPU tensors take the twin (the module's own weights); CUDA tensors
    launch the kernels or raise.
    """
    if pts.device.type == "cpu":
        return fused_nerf_backward_plain(field, pts, feats, views, g)
    name = "fused_nerf_backward"
    _check(name, field, pts, feats, views)
    P, F, V = field.in_ch_pts, field.in_ch_feat, field.in_ch_views
    if max(P, F, V) > MAX_NARROW:
        raise ValueError(f"{name}: inputs wider than {MAX_NARROW} channels")
    n = pts.shape[0]
    if pts.dim() != 2 or g.shape != (n, field.out_ch):
        raise ValueError(f"{name}: expected [n, ch] inputs and g of "
                         f"[{n}, {field.out_ch}], got {tuple(pts.shape)}, "
                         f"{tuple(g.shape)}")
    if recomputed is not None and recomputed.shape != (n, field.out_ch):
        raise ValueError(f"{name}: recomputed rows are [{n}, {field.out_ch}]")
    if saved is not None and field.bf16 and n > BF16_CHUNK_ROWS:
        raise ValueError(f"{name}: the bf16 mode keeps the forward values of "
                         f"one chunk ({BF16_CHUNK_ROWS} points)")
    if saved is not None and recomputed is None:
        recomputed = torch.empty((n, field.out_ch), device=pts.device)
    _build.require_cuda_f32(name, pts, feats, views, g, pack,
                            *([] if recomputed is None else [recomputed]))
    lib = _build.library()
    d_pts, d_feats, d_views = (torch.empty_like(t) for t in (pts, feats, views))
    d_pack = torch.zeros_like(pack)
    shape = (*_geometry(field), field.n_extra)
    size = ctypes.c_longlong()
    if field.bf16:
        inputs = (pts.data_ptr(), feats.data_ptr(), views.data_ptr(),
                  g.data_ptr(), pack.data_ptr(),
                  (ctypes.c_int * _N_SLOTS)(*offsets))
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
        if wb is None:
            wb = pack_tc32(field, pack, offsets)
        _build.check(lib.zt_fused_nerf_backward_scratch(
            n, CHUNK_ROWS, *shape, ctypes.byref(size)), name)
        scratch = torch.empty(size.value, device=pts.device,
                              dtype=torch.float32)
        kept = []
        for c0 in range(0, n, CHUNK_ROWS):
            rows = min(CHUNK_ROWS, n - c0)
            pts_c, feats_c, views_c, g_c, *d_c = (
                t[c0:c0 + rows] for t in (pts, feats, views, g, d_pts,
                                          d_feats, d_views))
            bufs = _scratch_views(lib, field, scratch, rows)
            recompute(field, pts_c, feats_c, views_c, g_c, pack, offsets, wb,
                      bufs, None if recomputed is None
                      else recomputed[c0:c0 + rows])
            input_grads(field, bufs, pack, offsets, *d_c)
            weight_grads(field, pts_c, feats_c, views_c, bufs, offsets,
                         d_pack)
            if saved is not None:
                kept.append({k: bufs[k].clone() for k in _KEPT[:4]})
        if saved is not None:
            saved.update({k: torch.cat([c[k] for c in kept], -2)
                          for k in _KEPT[:4]}, out=recomputed)
            saved["z"] = list(saved["z"])
    fused_nerf_backward.launches += 1
    return d_pts, d_feats, d_views, d_pack


fused_nerf_backward.launches = 0
