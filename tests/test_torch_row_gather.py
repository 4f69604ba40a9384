"""The row gather K9's twin against ``zest_tpu.kernels.dma_gather.take_rows``
(Pallas, interpret mode) and the warped-point lookup ``grid_sample_3d_rows``
against ``zest_tpu.ops.grid_sample.grid_sample_3d_paired``, on the CPU with
seeded numpy inputs.

Tolerances:
- the gather copies rows: equal, for float32 and bf16 tables;
- its backward at float32 is a sum of the same float32 values in another
  order: 1e-6 of the largest sum. At bf16 zest_tpu adds into the bf16
  table, rounding after every add, where the port adds in float32 and
  rounds once; the port is held to zest_tpu's backward on the float32
  upcast of the same gradient, rounded to bf16 once (one bf16 rounding step,
  2^-8, of the largest sum for a float32 sum in another order), and to
  zest_tpu's own bf16 backward within 2^-5 of the largest sum (the many
  roundings of a bf16 accumulation);
- the lookup forms the same taps and weights and sums 8 float32 products:
  1e-6 of the output scale. d_grid to 1e-5 of its largest; d_vol to 2^-7
  of its largest: zest_tpu rounds each row's gradient and every add of its
  scatter to bf16, the port each row's gradient only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu.kernels.dma_gather import take_rows as jtake_rows
from zest_tpu.ops.grid_sample import grid_sample_3d_paired

from zest_tpu_torch.kernels import dma_gather
from zest_tpu_torch.kernels.dma_gather import take_rows
from zest_tpu_torch.ops.grid_sample import grid_sample_3d_rows, trilinear_row_taps

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rows_case(seed, cw=8):
    """A 50-row table, indices with duplicates (7 x 33 of 50) and a
    gradient of the output."""
    rng = np.random.default_rng(seed)
    tab = rng.normal(size=(50, cw)).astype(np.float32)
    idx = rng.integers(0, 50, size=(7, 33)).astype(np.int32)
    g = rng.normal(size=(7, 33, cw)).astype(np.float32)
    return tab, idx, g


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_take_rows_matches_zest_tpu(dtype):
    jdt, tdt = DTYPES[dtype]
    tab, idx, g = _rows_case(0)
    jout, vjp = jax.vjp(lambda t: jtake_rows(t, jnp.asarray(idx)),
                        jnp.asarray(tab).astype(jdt))
    t = torch.from_numpy(tab).to(tdt).requires_grad_(True)
    before = (dma_gather.gather_rows.launches, dma_gather.scatter_rows.launches)
    out = take_rows(t, torch.from_numpy(idx))
    out.backward(torch.from_numpy(g).to(tdt))
    # the CPU takes the twins: no kernel launched
    assert (dma_gather.gather_rows.launches,
            dma_gather.scatter_rows.launches) == before
    assert out.dtype == tdt and out.shape == (7, 33, 8)
    np.testing.assert_array_equal(out.detach().float().numpy(), _np(jout))
    grad = t.grad.float().numpy()
    if dtype == "float32":
        ref = _np(vjp(jnp.asarray(g))[0])
        tol = 1e-6
    else:
        # zest_tpu's own bf16 scatter, rounding every add
        own = _np(vjp(jnp.asarray(g).astype(jdt))[0])
        assert np.abs(grad - own).max() <= 2.0 ** -5 * np.abs(own).max()
        # its float32 scatter of the same bf16 gradient, rounded once
        _, vjp32 = jax.vjp(lambda t: jtake_rows(t, jnp.asarray(idx)),
                           jnp.asarray(tab))
        ref = _np(vjp32(jnp.asarray(g).astype(jdt).astype(jnp.float32))[0]
                  .astype(jdt))
        tol = 2.0 ** -8
    assert np.abs(grad - ref).max() <= tol * np.abs(ref).max()


def test_take_rows_wider_rows_and_unused_rows():
    """16 bf16 channels (two 16-byte chunks a row); rows no index reads get
    a zero gradient."""
    tab, idx, g = _rows_case(1, cw=16)
    idx = idx % 40                                  # rows 40..49 unread
    t = torch.from_numpy(tab).to(torch.bfloat16).requires_grad_(True)
    out = take_rows(t, torch.from_numpy(idx))
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert torch.equal(out, t.detach()[torch.from_numpy(idx).long()])
    assert torch.equal(t.grad[40:], torch.zeros((10, 16), dtype=torch.bfloat16))
    assert float(t.grad[:40].float().abs().max()) > 0.0


def _lookup_case():
    rng = np.random.default_rng(2)
    vol = rng.normal(size=(16, 12, 20, 8)).astype(np.float32)
    # points outside the volume on every side, as flow-warped points are
    grid = rng.uniform(-1.2, 1.2, size=(300, 7, 3)).astype(np.float32)
    g = rng.normal(size=(300, 7, 8)).astype(np.float32)
    return vol, grid, g


def test_grid_sample_3d_rows_matches_paired_lookup():
    vol, grid, g = _lookup_case()
    jv = jnp.asarray(vol).astype(jnp.bfloat16)
    jout, vjp = jax.vjp(
        lambda v, gr: grid_sample_3d_paired(v, gr).astype(jnp.float32), jv,
        jnp.asarray(grid))
    d_vol_ref, d_grid_ref = (_np(a) for a in vjp(jnp.asarray(g)))
    v = torch.from_numpy(vol).to(torch.bfloat16).requires_grad_(True)
    gr = torch.from_numpy(grid).requires_grad_(True)
    out = grid_sample_3d_rows(v, gr)
    out.backward(torch.from_numpy(g))
    ref = np.asarray(jout)
    assert out.dtype == torch.float32 and out.shape == (300, 7, 8)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    assert np.abs(gr.grad.numpy() - d_grid_ref).max() \
        <= 1e-5 * np.abs(d_grid_ref).max()
    assert np.abs(v.grad.float().numpy() - d_vol_ref).max() \
        <= 2.0 ** -7 * np.abs(d_vol_ref).max()


def test_row_taps_weights_and_indices():
    """Inside the volume the 8 weights sum to 1; a corner outside it has
    weight 0 and an index clipped into the table."""
    vol, grid, _ = _lookup_case()
    idx, w = trilinear_row_taps(torch.from_numpy(grid), 16, 12, 20)
    assert idx.dtype == torch.int32 and idx.shape == w.shape == (300, 7, 8)
    assert int(idx.min()) >= 0 and int(idx.max()) < 16 * 12 * 20
    inside = (torch.from_numpy(grid).abs() <= 1.0).all(-1)
    np.testing.assert_allclose(w.sum(-1)[inside].numpy(), 1.0, atol=1e-6)
    assert bool((w[~inside].sum(-1) < 1.0 - 1e-6).any())
