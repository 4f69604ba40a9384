"""The twins of the training slice's backward kernels against the VJPs of
zest_tpu's Pallas kernels on the CPU (interpret mode, as the JAX package's
own tests run them):

- K7, the field backward: ``jax.grad`` through ``fused_nerf_apply`` against
  autograd through the port's ``NeRFField`` (``fused_nerf_backward``'s twin);
- K4 + K5, d/d volume and d/d coordinates of the lookup: ``jax.grad``
  through ``sample_volume_zbanded_diff`` against autograd through
  ``sample_volume_plain``;
- K2, the warp backward: ``jax.grad`` through ``homo_warp_fast_cm`` (feature
  width 128, so the Pallas kernel engages) against autograd through
  ``homo_warp_cm_plain``.

Also the layout the CUDA kernels read: K7's weight pack, and
``pack_grads``' packing of the weight gradients.

Tolerances: the gathers' gradients rtol 1e-5 with atol 1e-5 (K2, K4) and
2e-4 (K5, whose coordinate gradients reach ~100: they scale by size - 1):
the same taps summed in another order. The field: 1e-4 of each gradient's largest element — eight
chained float32 products and their transposes, summed over 296 points in
another order on each side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu.kernels.fused_mlp import fused_nerf_apply
from zest_tpu.kernels.plane_sweep import homo_warp_fast_cm
from zest_tpu.kernels.trilinear import sample_volume_zbanded_diff
from zest_tpu.models.nerf import NeRFField as JNeRFField

from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.kernels import fused_mlp, plane_sweep, trilinear
from zest_tpu_torch.models.nerf import NeRFField
from zest_tpu_torch.ops.homography import homography_grid

LAYOUTS = {True: (63, 40, 27), False: (84, 24, 27)}


def _field_setup(static, width=64):
    P, F, V = LAYOUTS[static]
    jfield = JNeRFField(depth=8, width=width, in_ch_pts=P, in_ch_views=V,
                        in_ch_feat=F, sceneflow=True, static=static,
                        use_mvs=True)
    variables = jax.tree.map(np.asarray, jfield.init(
        jax.random.PRNGKey(2), jnp.zeros((1, P)), jnp.zeros((1, F)),
        jnp.zeros((1, V))))
    field = NeRFField(8, width, P, V, F, static=static)
    field.load_state_dict({k.removeprefix("nerf_static."): v for k, v in
                           from_jax_params({"nerf_static": variables}).items()})
    rng = np.random.default_rng(3 if static else 4)
    R, S = 37, 8                         # 296 points: no tile multiple
    inputs = [rng.normal(size=(R, S, c)).astype(np.float32) for c in (P, F, V)]
    g = rng.normal(size=(R, S, field.out_ch)).astype(np.float32)
    return jfield, variables, field, inputs, g


def _close(a, b, rel, name):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(a - b).max())
    assert err <= rel * scale, (name, err, scale)


@pytest.mark.parametrize("static", [True, False])
def test_field_vjp_matches_pallas_kernel(static):
    jfield, variables, field, inputs, g = _field_setup(static)
    jin = [jnp.asarray(a) for a in inputs]

    def loss(v, p, f, w):
        return jnp.vdot(fused_nerf_apply(jfield, v, p, f, w, approx=False), g)

    jg = jax.grad(loss, argnums=(0, 1, 2, 3))(variables, *jin)
    flat = [torch.from_numpy(a.reshape(-1, a.shape[-1])) for a in inputs]
    d_pts, d_feats, d_views, d_pack = fused_mlp.fused_nerf_backward(
        field, *flat, torch.from_numpy(g.reshape(-1, field.out_ch)),
        None, None)
    for name, a, b in (("d_pts", d_pts, jg[1]), ("d_feats", d_feats, jg[2]),
                       ("d_views", d_views, jg[3])):
        _close(a.numpy(), np.asarray(b).reshape(a.shape), 1e-4, name)
    ref = from_jax_params({"nerf_static": jax.tree.map(np.asarray, jg[0])})
    for name, p in field.named_parameters():
        _close(p.grad.numpy(), ref["nerf_static." + name].numpy(), 1e-4, name)
    # the packed gradient is the parameters' gradients in the pack's layout
    assert torch.equal(d_pack, fused_mlp.pack_grads(field))


@pytest.mark.parametrize("static", [True, False])
def test_field_backward_pack_layout(static):
    """The pack holds every Linear's weight as [in][out] and its bias at the
    slots the kernels read, each on a 4-float boundary (``pack_leaves``); the
    packed gradient (``pack_grads``) holds each Linear's gradients in the
    same layout; and the pack is differentiable in every weight, so K7's
    packed gradient reaches each Linear. (The untransposed copy that K7's
    input-gradient products read is built on the card from this pack.)"""
    _, _, field, inputs, g = _field_setup(static)
    pack, offsets = fused_mlp.pack_weights(field)
    assert all(o % 4 == 0 for o in offsets)
    params = dict(field.named_parameters())

    def same(leaves, tensors):
        assert [n for n, _ in leaves] and {n for n, _ in leaves} == set(params)
        for name, t in leaves:
            want = tensors[name]
            assert torch.equal(t, want.T if name.endswith(".weight") else want), name

    same(fused_mlp.pack_leaves(field, pack.detach(), offsets),
         {k: p.detach() for k, p in params.items()})
    flat = [torch.from_numpy(a.reshape(-1, a.shape[-1])) for a in inputs]
    field.zero_grad()
    field(*flat).mul(torch.from_numpy(g.reshape(-1, field.out_ch))).sum().backward()
    d_pack = fused_mlp.pack_grads(field)
    assert d_pack.shape == pack.shape
    same(fused_mlp.pack_leaves(field, d_pack, offsets),
         {k: p.grad for k, p in params.items()})
    # a gradient in the pack's layout flows back to every Linear
    r = torch.randn(pack.shape, generator=torch.Generator().manual_seed(0))
    field.zero_grad()
    (pack * r).sum().backward()
    same(fused_mlp.pack_leaves(field, r, offsets),
         {k: p.grad for k, p in params.items()})


def _volume_inputs(seed=5, R=70, S=16, D=16):
    rng = np.random.default_rng(seed)
    vol = rng.normal(size=(D, 10, 16, 8)).astype(np.float32)
    xy = rng.uniform(-0.05, 1.05, size=(R, S, 2))
    z = np.broadcast_to(np.linspace(0.0, 1.0, S), (R, S)) + \
        rng.uniform(-0.5 / (S - 1), 0.5 / (S - 1), size=(R, S))
    ndc = np.concatenate([xy, np.clip(z, 0.0, 1.0)[..., None]], -1)
    ndc = (ndc + rng.normal(scale=0.01, size=ndc.shape)).astype(np.float32)
    g = rng.normal(size=(R, S, 8)).astype(np.float32)
    return vol, ndc, g


def test_volume_vjp_matches_pallas_kernels():
    """K4 (d_vol) and K5 (d_ndc) against the coordinate-differentiable
    Pallas lookup at flow-warped points, some outside the volume."""
    vol, ndc, g = _volume_inputs()
    jv, jn = jax.grad(lambda v, n: jnp.vdot(
        sample_volume_zbanded_diff(v, n, band=6), g), argnums=(0, 1))(
        jnp.asarray(vol), jnp.asarray(ndc))
    d_vol, d_ndc = trilinear.sample_volume_grads_plain(
        torch.from_numpy(vol), torch.from_numpy(ndc), torch.from_numpy(g))
    np.testing.assert_allclose(d_vol.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(d_ndc.numpy(), np.asarray(jn), rtol=1e-5,
                               atol=2e-4)
    # the wrapper's autograd on CPU tensors is the same twin
    v_, n_ = (torch.from_numpy(a).requires_grad_(True) for a in (vol, ndc))
    (trilinear.sample_volume(v_, n_) * torch.from_numpy(g)).sum().backward()
    assert torch.equal(v_.grad, d_vol) and torch.equal(n_.grad, d_ndc)


def test_warp_vjp_matches_pallas_kernel():
    """K2 against the Pallas warp's VJP at feature width 128 (the width at
    which the JAX kernel engages)."""
    rng = np.random.default_rng(7)
    h, w, C, pad = 8, 128, 5, 2
    src = rng.normal(size=(h, w, C)).astype(np.float32)
    proj = np.array([[1, 0.01, 0.5, 0.3], [0.02, 1, -0.3, 0.2],
                     [1e-4, 0, 1, 0.01]], np.float32)
    dv = np.linspace(2.0, 6.0, 3).astype(np.float32)
    P = (h + 2 * pad) * (w + 2 * pad)
    g = rng.normal(size=(3, C, P)).astype(np.float32)
    jg = jax.grad(lambda s: jnp.vdot(homo_warp_fast_cm(
        s, jnp.asarray(proj), jnp.asarray(dv), pad=pad, band=8)[0], g))(
        jnp.asarray(src))
    grid = homography_grid(torch.from_numpy(proj), torch.from_numpy(dv),
                           (h, w), pad=pad)
    d_src = plane_sweep.homo_warp_cm_grad_plain(torch.from_numpy(src), grid,
                                                torch.from_numpy(g))
    np.testing.assert_allclose(d_src.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    s_ = torch.from_numpy(src).requires_grad_(True)
    (plane_sweep.homo_warp_cm(s_, grid) * torch.from_numpy(g)).sum().backward()
    assert torch.equal(s_.grad, d_src)


def test_backward_wrappers_refuse_cpu_tensors():
    """The kernel-only wrappers have no CPU path: the autograd Functions
    call them only for CUDA tensors."""
    vol, ndc, g = (torch.from_numpy(a) for a in _volume_inputs(R=4, S=4))
    with pytest.raises(ValueError):
        trilinear.volume_grad(vol.shape, ndc, g)
    with pytest.raises(ValueError):
        trilinear.coords_grad(vol, ndc, g)
    grid = torch.zeros((2, 3, 4, 2))
    with pytest.raises(ValueError):
        plane_sweep.homo_warp_cm_grad(torch.zeros((2, 5, 12)), grid, (3, 4))
