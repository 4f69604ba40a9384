"""The fields of the configurations without scene flow or without a volume,
on the CPU, against ``zest_tpu``'s on the same weights
(``convert.from_jax_params``) and the same numpy-seeded inputs.

- ``NeRFField`` with ``sceneflow=False`` (MVSNeRF's static field: rgb and
  alpha, 4 outputs) and with ``use_mvs=False`` (a field without a volume:
  no ``pts_bias``, h = relu(W h); the static and the dynamic kind) against
  zest_tpu's Flax field: the outputs at rtol 1e-4, atol 1e-5, and every
  input and weight gradient (zest_tpu's VJP) to 1e-4 of its own largest.
- The 4-output field's fused twin (the module the kernels are held to)
  against zest_tpu's ``fused_nerf_apply`` (Pallas, interpret mode): at
  float32 (``approx=False``) the outputs as above and every gradient to
  1e-4 of its own largest; in the bf16-operand mode (``approx=True``) the
  outputs at rtol 1e-4, atol 1e-5 and the gradients of the twin's backward
  at its own forward values (``fused_nerf_backward_at_plain``) to 1e-3 of
  their largest, as ``tests/test_torch_fused_pack.py`` holds the 5- and
  12-output geometries.
- K7's twins for the 4-output geometry: the float32 chunk twins
  (``recompute``, ``input_grads``, ``weight_grads`` on CPU tensors) and the
  backward at given forward values in both modes equal the twin's autograd
  in float64 to 1e-9 of each input's and leaf's largest gradient.
- The kernels' wrappers hand the library ``n_extra`` 0 for it (a stand-in
  for the kernel library), and refuse a field without a volume.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu.kernels.fused_mlp import fused_nerf_apply
from zest_tpu.models.nerf import NeRFField as JNeRFField
from zest_tpu.models.nerf import output_dim

from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.kernels import _build, fused_mlp
from zest_tpu_torch.kernels.fused_mlp import (fused_nerf_backward_at_plain,
                                              fused_nerf_backward_plain,
                                              fused_nerf_forward,
                                              forward_values_plain,
                                              pack_leaves, pack_weights)
from zest_tpu_torch.models.nerf import NeRFField

TOL = dict(rtol=1e-4, atol=1e-5)
# (P, F, V) of the static (xyz) and dynamic (xyzt) fields at multires 10 / 4
# and 8 source views
STATIC, DYNAMIC = (63, 40, 27), (84, 24, 27)
# kind -> (sceneflow, static, use_mvs, (P, F, V))
KINDS = {"rgba": (False, True, True, STATIC),
         "plain_static": (True, True, False, STATIC),
         "plain_dynamic": (True, False, False, DYNAMIC),
         "plain_rgba": (False, True, False, STATIC)}


def _fields(kind, width=64, seed=1, bf16=False):
    """zest_tpu's field, its variables (numpy) and the port's field with
    the same weights."""
    sceneflow, static, use_mvs, (P, F_, V) = KINDS[kind]
    jfield = JNeRFField(depth=8, width=width, in_ch_pts=P, in_ch_views=V,
                        in_ch_feat=F_, sceneflow=sceneflow, static=static,
                        use_mvs=use_mvs)
    variables = jax.tree.map(np.asarray, jfield.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, P)),
        jnp.zeros((1, F_)) if use_mvs else None, jnp.zeros((1, V))))
    field = NeRFField(8, width, P, V, F_, static=static, sceneflow=sceneflow,
                      use_mvs=use_mvs, bf16=bf16)
    sd = from_jax_params({"nerf_static": variables})
    field.load_state_dict({k.removeprefix("nerf_static."): v
                           for k, v in sd.items()})
    return jfield, variables, field


def _inputs(kind, n, seed):
    _, _, use_mvs, (P, F_, V) = KINDS[kind]
    rng = np.random.default_rng(seed)
    pts, feats, views = (rng.normal(size=(n, c)).astype(np.float32)
                         for c in (P, F_, V))
    return pts, feats if use_mvs else None, views


def _leaves_close(field, got, ref, rel):
    """Each weight and bias gradient of ``got`` (name -> tensor, nn.Linear
    layout) within rel of its own largest in ``ref`` (zest_tpu's VJP)."""
    ref = from_jax_params({"nerf_static": jax.tree.map(np.asarray, ref)})
    assert set(got) == {n for n, _ in field.named_parameters()}
    for name, a in got.items():
        b = ref[f"nerf_static.{name}"].numpy()
        assert np.abs(a - b).max() <= rel * np.abs(b).max(), name


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_field_matches_flax_with_gradients(kind):
    jfield, variables, field = _fields(kind)
    sceneflow, static, use_mvs, _ = KINDS[kind]
    assert field.out_ch == output_dim(sceneflow, static)
    assert hasattr(field, "pts_bias") == use_mvs
    pts, feats, views = _inputs(kind, 300, 2)
    rng = np.random.default_rng(3)
    g = rng.normal(size=(300, field.out_ch)).astype(np.float32)
    jins = [None if a is None else jnp.asarray(a) for a in (pts, feats, views)]

    @jax.jit       # one compile, not one per eager op
    def forward_and_vjp(v, p, vw, cot):
        out, vjp = jax.vjp(lambda v, p, vw: jfield.apply(v, p, jins[1], vw),
                           v, p, vw)
        return out, vjp(cot)

    ref, (d_vars, d_pts, d_views) = forward_and_vjp(variables, jins[0],
                                                    jins[2], jnp.asarray(g))
    tins = [None if a is None else torch.from_numpy(a).requires_grad_(True)
            for a in (pts, feats, views)]
    out = field(*tins)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    for a, b in ((tins[0].grad, d_pts), (tins[2].grad, d_views)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max()
    _leaves_close(field, {n: p.grad.numpy() for n, p in
                          field.named_parameters()}, d_vars, 1e-4)


@pytest.mark.parametrize("approx", [False, True])
def test_four_output_twin_matches_pallas_kernel(approx):
    jfield, variables, field = _fields("rgba", seed=4, bf16=approx)
    pts, feats, views = _inputs("rgba", 300, 5)
    g = np.random.default_rng(6).normal(size=(300, 4)).astype(np.float32)
    ref, vjp = jax.vjp(
        lambda v, *x: fused_nerf_apply(jfield, v, *x, approx=approx),
        variables, *map(jnp.asarray, (pts, feats, views)))
    d_vars, *d_ins = vjp(jnp.asarray(g))
    x = [torch.from_numpy(a) for a in (pts, feats, views)]
    with torch.no_grad():
        out = fused_nerf_forward(field, *x)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    if approx:
        saved = forward_values_plain(field, *x)
        *got, d_pack = fused_nerf_backward_at_plain(field, saved, *x,
                                                    torch.from_numpy(g))
        rel = 1e-3
    else:
        *got, d_pack = fused_nerf_backward_plain(field, *x,
                                                 torch.from_numpy(g))
        rel = 1e-4
    for a, b in zip(got, d_ins):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= rel * np.abs(b).max()
    _, offsets = pack_weights(field)
    leaves = {n: (t.T if n.endswith(".weight") else t).numpy()
              for n, t in pack_leaves(field, d_pack, offsets)}
    _leaves_close(field, leaves, d_vars, rel)


def _chunk_buffers(field, n):
    W, depth = field.width, len(field.pts_linears)
    dims = {"z": (depth, n, W), "dz": (depth, n, W), "hv": (n, W // 2),
            "d_hv": (n, W // 2), "g_heads": (n, field.out_ch)}
    return {k: torch.zeros(dims.get(k, (n, W)), dtype=torch.float64)
            for k in fused_mlp._BUFS}


def _assert_matches_autograd(field, got, ref):
    for name, a, b in zip(fused_mlp._INPUTS, got[:3], ref[:3]):
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max()), name
    _, offsets = pack_weights(field)
    for (name, a), (_, b) in zip(pack_leaves(field, got[3], offsets),
                                 pack_leaves(field, ref[3], offsets)):
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max()), name


@pytest.mark.parametrize("width", [64, 256])
def test_four_output_float32_chunk_twins_match_autograd(width):
    P, F_, V = STATIC
    torch.manual_seed(7)
    field = NeRFField(8, width, P, V, F_, sceneflow=False).double()
    assert field.n_extra == 0 and field.out_ch == 4
    rng = np.random.default_rng(8)
    pts, feats, views, g = (torch.from_numpy(rng.normal(size=(200, c)))
                            for c in (P, F_, V, 4))
    with torch.no_grad():
        pack, offsets = pack_weights(field)
    bufs = _chunk_buffers(field, 200)
    rows = torch.empty_like(g)
    got = [torch.empty_like(t) for t in (pts, feats, views)]
    d_pack = torch.zeros_like(pack)
    fused_mlp.recompute(field, pts, feats, views, g, pack, offsets, None, bufs,
                        rows)
    fused_mlp.input_grads(field, bufs, pack, offsets, *got)
    fused_mlp.weight_grads(field, pts, feats, views, bufs, offsets, d_pack)
    with torch.no_grad():
        assert torch.equal(rows, field(pts, feats, views))
    _assert_matches_autograd(field, [*got, d_pack],
                             fused_nerf_backward_plain(field, pts, feats,
                                                       views, g))


@pytest.mark.parametrize("bf16", [False, True])
def test_four_output_backward_at_forward_values_matches_autograd(bf16):
    P, F_, V = STATIC
    torch.manual_seed(9)
    field = NeRFField(8, 64, P, V, F_, sceneflow=False, bf16=bf16).double()
    rng = np.random.default_rng(10)
    pts, feats, views, g = (torch.from_numpy(rng.normal(size=(200, c)))
                            for c in (P, F_, V, 4))
    saved = forward_values_plain(field, pts, feats, views)
    got = fused_nerf_backward_at_plain(field, saved, pts, feats, views, g)
    _assert_matches_autograd(field, got, fused_nerf_backward_plain(
        field, pts, feats, views, g))


class _Library:
    """Stands in for the kernel library: records each C entry called with
    its arguments and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("bf16", [False, True])
def test_four_output_wrappers_pass_no_extra_heads(bf16, monkeypatch):
    """The packed layout has no extra-head slot, and every field entry of
    the library (forward, backward, scratch, layout) gets n_extra 0, as
    the argument just before the stream."""
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "require_cuda_f32", lambda *args: None)
    P, F_, V = STATIC
    field = NeRFField(8, 64, P, V, F_, sceneflow=False, bf16=bf16)
    with torch.no_grad():
        pack, offsets = pack_weights(field)
    assert [s for s, _ in fused_mlp._slots(field)][-1] == fused_mlp._WR
    assert pack.numel() == sum(p.numel() for p in field.parameters()) + sum(
        -p.numel() % 4 for p in field.parameters())
    n = 100
    pts, feats, views, g = (torch.empty((n, c), device="meta")
                            for c in (P, F_, V, 4))
    out, wb = fused_mlp._launch_forward(field, pts, feats, views,
                                        pack.to("meta"), offsets)
    assert out.shape == (n, 4)
    fused_mlp.fused_nerf_backward(field, pts, feats, views, g,
                                  pack.to("meta"), offsets, wb)
    heads = [args for name, args in lib.calls
             if "pack" not in name and name != "zt_fused_nerf_backward_layout"]
    assert heads and all(args[-2] == 0 for args in heads), lib.calls
    layout = [args for name, args in lib.calls
              if name == "zt_fused_nerf_backward_layout"]
    assert all(args[-2] == 0 for args in layout)


def test_kernels_refuse_a_field_without_a_volume():
    field = NeRFField(8, 64, *STATIC[:1], STATIC[2], STATIC[1],
                      use_mvs=False)
    meta = torch.empty((4, 63), device="meta")
    with pytest.raises(ValueError, match="use_mvs"):
        fused_nerf_forward(field, meta, meta[:, :40], meta[:, :27])
    with pytest.raises(ValueError, match="float32"):
        NeRFField(8, 64, 63, 27, 40, use_mvs=False, bf16=True)
