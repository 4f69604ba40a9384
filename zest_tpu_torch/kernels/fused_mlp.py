"""Fused NeRF field: CUDA kernels (forward and backward) and their plain
PyTorch twins.

Replaces ``zest_tpu/kernels/fused_mlp.py:_fwd_pallas`` (K6, the forward
``pallas_call`` behind ``fused_nerf_apply``) and ``_bwd_pallas`` (K7, its
custom VJP): both in ``csrc/fused_mlp.cu``, except K6's bf16-operand mode,
which runs on the tensor cores in ``csrc/fused_mlp_tc.cu``. Every product of
the field runs inside them. ``fused_nerf_forward`` is an autograd Function over
(pts, feats, views, pack): ``pack_weights`` is a differentiable ``torch.cat``
of every Linear's ``weight.T`` and bias, so the packed weight gradient of K7
reaches each Linear. The twin is the port's ``models.nerf.NeRFField`` itself
and its autograd.

A field built with ``bf16=True`` runs the kernels' bf16-operand mode
(``zest_tpu``'s ``approx=True``): the kernels round the conditioning, trunk,
feature and views products' operands to bf16 and keep float32 sums, float32
biases and float32 heads, as the twin's ``bf16`` mode does. The forward's
bf16 weights are made from the float32 pack on the card by one launch on
every call (``pack_bf16``); the autograd Function saves the float32 pack for
K7.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

WIDTHS = (64, 128, 256)          # kernel instantiations
MAX_LAYERS = 16                  # kMaxLayers in csrc/fused_mlp.cuh
MAX_NARROW = 96                  # 32 * kNarrow: widest pts / feats / views
SMEM_LIMIT = 232448              # bytes of shared memory a block may opt into
# offsets-table slots, as the Slot enum in csrc/fused_mlp.cuh numbers them
_WB, _LAYER0 = 0, 2
_WA = _LAYER0 + 2 * MAX_LAYERS
_WF, _WV, _WR, _WX1, _WX2 = _WA + 2, _WA + 4, _WA + 6, _WA + 8, _WA + 10
_N_SLOTS = _WA + 12
_TILE = 32
_SMEM_EXTRA = 16 + 8             # kGS + kES floats per point in the backward
CHUNK_ROWS = 65536               # points per backward chunk (bounds scratch)


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
    return torch.cat(parts).float().contiguous(), offsets


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


def bf16_layout(field):
    """The bf16-operand matrices in the order K6's tensor-core kernel runs
    them: [(Linear, K parts)], each part a width of the Linear's input whose
    columns are zero padded to a multiple of 16 (the mma depth): the
    conditioning, the trunk (the layer after a skip reads [pts, h]), the
    feature layer and the views layer ([feature, views])."""
    P, V, W = field.in_ch_pts, field.in_ch_views, field.width
    mats = [(field.pts_bias, [field.in_ch_feat])]
    mats += [(lin, [P] if i == 0 else [P, W] if i - 1 in field.skips else [W])
             for i, lin in enumerate(field.pts_linears)]
    return mats + [(field.feature_linear, [W]),
                   (field.views_linears[0], [W, V])]


def _pad16(k):
    return -(-k // 16) * 16


@torch.no_grad()
def pack_bf16_plain(field, pack, offsets):
    """Twin of the bf16 pack kernel (``round_pack_tc_kernel``): every matrix
    of ``bf16_layout``, read from the float32 ``pack`` (``pack_weights``'
    layout), as ``nn.Linear`` stores it, [out][in] (K-contiguous, the B
    operand of ``mma .row.col``), rounded to bf16, each K part zero padded
    to a multiple of 16, the matrices back to back. Returns (pack, offsets):
    a flat bf16 tensor on the pack's device and each matrix's first
    element."""
    weights = {id(lin): pack[offsets[slot]:offsets[slot] + lin.weight.numel()]
               .view(lin.in_features, lin.out_features).T
               for slot, lin in _slots(field)}
    parts, moff, cur = [], [], 0
    for lin, widths in bf16_layout(field):
        w = weights[id(lin)].to(torch.bfloat16)
        mat = torch.cat([torch.nn.functional.pad(c, (0, _pad16(c.shape[1])
                                                     - c.shape[1]))
                         for c in torch.split(w, widths, dim=1)], 1)
        moff.append(cur)
        parts.append(mat.reshape(-1))
        cur += mat.numel()
    return torch.cat(parts), moff


def _geometry(field):
    return (field.in_ch_pts, field.in_ch_feat, field.in_ch_views, field.width,
            len(field.pts_linears), field.skips[0] if field.skips else -2)


def pack_bf16(field, pack, offsets):
    """K6's bf16 pack from the float32 ``pack`` (``pack_weights``): a flat
    bf16 tensor in ``pack_bf16_plain``'s layout. CPU tensors take the twin;
    CUDA tensors launch ``round_pack_tc_kernel`` (one launch) or raise."""
    if pack.device.type == "cpu":
        return pack_bf16_plain(field, pack, offsets)[0]
    lib = _build.library()
    length = lib.zt_fused_nerf_pack_tc_len(*_geometry(field))
    if length < 0:
        raise ValueError(f"pack_bf16: no bf16 pack for {_geometry(field)}")
    wb = torch.empty(length, device=pack.device, dtype=torch.bfloat16)
    _build.check(lib.zt_fused_nerf_pack_tc(
        pack.data_ptr(), (ctypes.c_int * _N_SLOTS)(*offsets), wb.data_ptr(),
        *_geometry(field), _build.stream_ptr(pack)), "pack_bf16")
    return wb


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
    """K6 on [n, ch] contiguous inputs → [n, out_ch]: the SIMT kernel at
    float32, the tensor-core kernel in the bf16-operand mode."""
    n = pts.shape[0]
    out = torch.empty((n, field.out_ch), device=pts.device, dtype=torch.float32)
    lib = _build.library()
    inputs = (pts.data_ptr(), feats.data_ptr(), views.data_ptr(),
              pack.data_ptr(), (ctypes.c_int * _N_SLOTS)(*offsets))
    shape = (n, *_geometry(field), 1 if field.static else 2,
             _build.stream_ptr(pts))
    if field.bf16:
        wb = pack_bf16(field, pack, offsets)
        err = lib.zt_fused_nerf_forward_tc(*inputs, wb.data_ptr(),
                                           out.data_ptr(), *shape)
    else:
        err = lib.zt_fused_nerf_forward(*inputs, out.data_ptr(), *shape)
    _build.check(err, "fused_nerf_forward")
    fused_nerf_forward.launches += 1
    return out


class _FusedField(torch.autograd.Function):
    """K6 forward, K7 backward, over the packed weights."""

    @staticmethod
    def forward(ctx, pts, feats, views, pack, field, offsets):
        ctx.save_for_backward(pts, feats, views, pack)
        ctx.field, ctx.offsets = field, offsets
        return _launch_forward(field, pts, feats, views, pack, offsets)

    @staticmethod
    def backward(ctx, g):
        pts, feats, views, pack = ctx.saved_tensors
        grads = fused_nerf_backward(ctx.field, pts, feats, views,
                                    g.contiguous(), pack, ctx.offsets)
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


def fused_nerf_backward(field, pts, feats, views, g, pack, offsets):
    """K7: the field's gradients at [n, ch] inputs for the output gradient g
    [n, out_ch] → (d_pts, d_feats, d_views, d_pack), d_pack in the layout of
    ``pack`` (``pack_weights``).

    CPU tensors take the twin (the module's own weights); CUDA tensors
    launch the kernel or raise.
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
    _build.require_cuda_f32(name, pts, feats, views, g, pack)
    lib = _build.library()
    shape = (P, F, V, field.width, len(field.pts_linears),
             field.skips[0] if field.skips else -2, 1 if field.static else 2,
             int(field.bf16), pack.numel())
    floats = ctypes.c_longlong()
    _build.check(lib.zt_fused_nerf_backward_scratch(
        n, CHUNK_ROWS, *shape, ctypes.byref(floats)), name)
    scratch = torch.empty(floats.value, device=pts.device, dtype=torch.float32)
    d_pts, d_feats, d_views = (torch.empty_like(t) for t in (pts, feats, views))
    d_pack = torch.zeros_like(pack)
    err = lib.zt_fused_nerf_backward(
        pts.data_ptr(), feats.data_ptr(), views.data_ptr(), g.data_ptr(),
        pack.data_ptr(), (ctypes.c_int * _N_SLOTS)(*offsets),
        scratch.data_ptr(), scratch.numel(), CHUNK_ROWS, d_pts.data_ptr(),
        d_feats.data_ptr(), d_views.data_ptr(), d_pack.data_ptr(), n, *shape,
        _build.stream_ptr(pts))
    _build.check(err, name)
    fused_nerf_backward.launches += 1
    return d_pts, d_feats, d_views, d_pack


fused_nerf_backward.launches = 0
