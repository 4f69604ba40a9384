#!/usr/bin/env python3
"""Chip smoke test: the PyTorch / CUDA port's full-image eval step and its
training step on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``zest_tpu_torch/csrc/`` (nvcc,
sm_90a), then:

1. prints the card (nvidia-smi name and power limit);
2. builds the kernels and prints the build time and ptxas report;
3. holds each forward kernel against its plain PyTorch twin on the card, on
   the first chunk's inputs of the flagship eval (both fields' inputs as
   ``render_rays`` builds them, [16384, 128, ch]), and times kernel, twin and
   the one library call that computes the same function, with CUDA events.
   The field K6 runs on the tensor cores at float32 as 3xTF32: its SASS must
   hold HMMA at every width, its float32 operand pack must equal its twin
   bit for bit, and on the chunk it must be within max(8 x the float32
   twin's own norm-wise distance from a float64 twin, 2^-20) of that
   float64 twin (float32-class, not one TF32 product); its TFLOP/s is
   printed beside a float32 ``torch.matmul`` of a trunk layer's shape;
4. runs the eval step at a small configuration on CUDA (the kernels) and on
   the CPU (the twins) with the same seeded weights, and compares every map;
5. runs the flagship eval step (288x512, 8 keyframes + target, 4 neighbours,
   128 samples, width-256 fields, float32) with every launch counter reset
   first, checks the maps and that every forward kernel of the path launched
   and no backward kernel did, and times s/image with the input changed
   between runs;
6. holds each backward kernel (warp K2, volume K4, coordinates K5, field K7)
   against its twin's autograd at the flagship training step's own inputs
   (the step's rays, encoding volumes and field inputs, a random output
   gradient), and times kernel, twin and library call; holds K6 on the
   step's three float32 field passes, each beside a float64 twin. K7's
   float32 mode takes its weight gradients (pass 2) on the tensor cores as
   3xTF32: its SASS must hold HMMA; every pass-2 launch of the three passes
   is held to its twin on the same scratch buffers and timed beside it and
   beside float32 ``torch.matmul`` of the same X^T dZ shapes (its row's
   library time, timed only); and K7's weight gradients of the
   conditioning, trunk, feature and views layers must be within max(8 x
   the float32 twin's own norm-wise distance from a float64 twin, 2^-20) of
   that float64 twin;
7. runs the training step at a small configuration on CUDA and on the CPU
   from the same weights and draws, in both phases (motion-mask rays; the
   chain pass), and compares the loss, every log, every gradient and the
   parameters after the step;
8. runs the flagship training step (``presets.FLAGSHIP_TRAIN``: R = 1,112
   rays) with every launch counter reset first, asserts the exact launches
   of every kernel per step in both phases, checks the logs and that the
   parameters moved, and times a window of steps: train_rays_per_sec;
9. at 16-bit precision (``presets.FLAGSHIP_TRAIN_16``, ``bench.py``'s own
   configuration): holds the row gather K9 (forward bitwise, its
   scatter-add backward to one bf16 rounding step, on a random cotangent
   and on the main path's own, whose out-of-volume corners carry zero
   rows) at the flagship step's own t±1 points, and the bf16-operand modes
   of the field kernels K6 (the tensor-core kernel: its SASS must hold
   HMMA; its TFLOP/s beside one bf16 ``torch.matmul`` of a trunk layer's
   shape, timed only; its bf16 weight pack bit for bit) at the flagship's
   eval chunk and training passes, and K7 (the tensor-core passes 1 and 2,
   whose SASS must hold HMMA; its TFLOP/s; its backward weight pack bit for
   bit; pass 1's recomputed output rows bit for bit equal to K6's; held to
   the twin's autograd with a criterion that the ReLU-kink noise passes,
   and to the twin's backward at the forward values it ran at, which are
   held to the twin's forward; each leaf's distance to a float64 twin
   logged beside the float32 twin's) at the training passes;
   K9's backward is timed against the same
   work by the library (zeros, ``index_add_``, one rounding) and, on a line
   of its own, its bare launch against bare ``index_add_``;
10. runs the small eval and training step at 16 bits on CUDA and on the CPU
    (each quantity within twice the CPU's own 16-vs-32 difference);
11. runs the flagship eval and training step at 16 bits, as phases 5 and 8
    do, asserting the launches (K9 forward and backward once per step-0
    step and twice per chain step, K5 never) and timing s/image and
    train_rays_per_sec beside the float32 ones.

The second-to-last line of stdout is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``. Any failure raises, so the
script exits non-zero and prints no result; so does a machine without CUDA.
Nothing here imports JAX or the JAX package ``zest_tpu``: the configurations,
the synthetic scene and the seeded weights are the port's own
(``zest_tpu_torch.presets``).
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
# one H100 SXM: HBM rate and float32 peak outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12     # bf16 operands, float32 sums (tensor cores)
TF32_FLOP_PER_S = 494.7e12   # TF32 operands, dense (tensor cores); 3xTF32
#                              takes three of them per float32 product
# K6's float32 mode against a float64 twin, norm-wise: within this many
# times the float32 twin's own distance, or F32_CLASS_FLOOR (one TF32
# product, ~11 bits of each operand, is ~1e-4 away)
F32_CLASS_FACTOR = 8
F32_CLASS_FLOOR = 2.0 ** -20
TRAIN_STEPS = 5              # timed flagship training steps, after warm-up
# bf16-operand field kernels against their twins: both round the same
# operands, but a float32 sum taken in another order can flip one bf16
# rounding of an activation, a change of 2^-8 of that operand
BF16_FIELD_TOL = 1e-3        # K6: of max(1, |output|)
BF16_FIELD_GRAD_TOL = 2.0 ** -8   # K7: of each input's and each leaf's largest
# K7's bf16 mode against the twin's autograd: where a ReLU input lies within
# rounding noise of zero, the two forwards take different branches and that
# point's gradient jumps (hold_bf16_backward)
BF16_KINK_ROWS = 2.0 ** -9   # rows beyond BF16_FIELD_GRAD_TOL, share of the rows
BF16_LEAF_PEAK = 2.0 ** -6   # a leaf's largest error, of its largest gradient


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"[card] nvidia-smi: {smi.splitlines()[0]}")
    log(f"[card] torch: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return smi.splitlines()[0]


def build() -> None:
    from zest_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {_build.build_info['path']} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {_build.build_info['seconds']:.1f} s)")
    for line in _build.build_info.get("ptxas", "").splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log("[build] " + line.strip())
    lib = _build.library()
    for kernel, smem in (("fused_nerf_tc32_kernel",
                          lib.zt_fused_nerf_forward_tc32_smem),
                         ("fused_nerf_tc_kernel", lib.zt_fused_nerf_forward_tc_smem),
                         ("fused_nerf_bwd_tc_kernel",
                          lib.zt_fused_nerf_backward_tc_smem)):
        log(f"[build] {kernel}<256> dynamic shared memory per block: static "
            f"field {smem(256, 63, 40, 27)} bytes, dynamic field "
            f"{smem(256, 84, 24, 27)} bytes (one block per SM)")


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def volume_cells(ndc, dims) -> int:
    """Distinct in-range corner cells that the trilinear taps at ndc [..., 3]
    ((x, y, z) in [0, 1], align_corners=True, zeros padding) read from a
    [D, Hv, Wv, ...] table: what a lookup must read of it, counted on the
    card from this run's points."""
    D, Hv, Wv = dims
    p = ndc.reshape(-1, 3) * torch.tensor([Wv - 1, Hv - 1, D - 1],
                                          dtype=ndc.dtype, device=ndc.device)
    x0, y0, z0 = p.floor().long().unbind(-1)
    cells = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                x, y, z = x0 + dx, y0 + dy, z0 + dz
                ok = (x >= 0) & (x < Wv) & (y >= 0) & (y < Hv) & (z >= 0) & (z < D)
                cells.append(((z * Hv + y) * Wv + x)[ok])
    return int(torch.unique(torch.cat(cells)).numel())


def image_pixels(xy, H, W) -> int:
    """Distinct pixels that the border-padded bilinear taps at xy [V, N, 2]
    (pixel coordinates) read from V images of H x W, counted on the card."""
    V = xy.shape[0]
    x = xy[..., 0].clamp(0, W - 1)
    y = xy[..., 1].clamp(0, H - 1)
    x0, y0 = x.floor().long(), y.floor().long()
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    base = torch.arange(V, device=xy.device)[:, None] * (H * W)
    taps = [base + yy * W + xx for yy in (y0, y1) for xx in (x0, x1)]
    return int(torch.unique(torch.cat([t.reshape(-1) for t in taps])).numel())


def counters():
    """Every kernel wrapper of the port, by the name its count is read as."""
    from zest_tpu_torch.kernels import (color_gather, dma_gather, fused_mlp,
                                        plane_sweep, trilinear)
    return {"homo_warp_cm": plane_sweep.homo_warp_cm,
            "homo_warp_cm_grad": plane_sweep.homo_warp_cm_grad,
            "sample_volume": trilinear.sample_volume,
            "volume_grad": trilinear.volume_grad,
            "coords_grad": trilinear.coords_grad,
            "gather_colors": color_gather.gather_colors,
            "fused_nerf_forward": fused_mlp.fused_nerf_forward,
            "fused_nerf_backward": fused_mlp.fused_nerf_backward,
            "weight_grads": fused_mlp.weight_grads,
            "gather_rows": dma_gather.gather_rows,
            "scatter_rows": dma_gather.scatter_rows}


def reset_counters() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counters() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


def ops_seconds(f32: float, bf16: float, tf32: float) -> float:
    """The least time of these operations at the card's peak rate for each
    operand type."""
    return f32 / F32_FLOP_PER_S + bf16 / BF16_FLOP_PER_S + tf32 / TF32_FLOP_PER_S


class Rows:
    """One JSON row per kernel; a kernel checked on several inputs (both
    field layouts, the passes of a step) sums its times and its bound."""

    def __init__(self):
        self.rows = {}

    def verify(self, name, kern, plain, tol, relative=False) -> tuple:
        """Hold kern() to plain() (each a tensor or a tuple of them):
        forward outputs to tol x max(1, |plain|), gradients (relative=True)
        to tol x the largest |plain| of each output. Raises on a
        disagreement or a non-finite value; returns (the largest error, the
        output shapes)."""
        with torch.no_grad():
            out, ref = kern(), plain()
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        err, ok = 0.0, True
        for a, b in zip(outs, refs):
            e = float((a - b).abs().max())
            scale = float(b.abs().max())
            limit = tol * (max(scale, 1e-30) if relative else max(1.0, scale))
            ok = ok and bool(torch.isfinite(a).all()) and e <= limit
            err = max(err, e)
        if not ok:
            log(f"[kernel] {name}: max_abs_err {err:.3e} (tol {tol:g}) -> FAIL")
            raise AssertionError(f"{name} disagrees with its twin: {err}")
        if name in self.rows:
            self.rows[name]["max_abs_err"] = max(self.rows[name]["max_abs_err"],
                                                 err)
        return err, [tuple(a.shape) for a in outs]

    def check(self, name, source, replaces, counter, kern, plain, library,
              tol, iters, moved_bytes, flops, relative=False, flops_bf16=0,
              paths=("eval", "train"), verified=None, flops_tf32=0):
        """``verify``, then time kern, plain and library; flops count
        float32 operations, flops_bf16 those on bf16 operands, flops_tf32
        those on TF32 operands; paths names the runs whose launches the row
        reports (eval first); verified, if given, is the (error, shapes) of
        a check the caller made instead of ``verify``."""
        err, shapes = verified or self.verify(name, kern, plain, tol,
                                              relative)
        with torch.no_grad():
            ms = cuda_ms(kern, iters)
            plain_ms = cuda_ms(plain, iters)
            lib_ms = cuda_ms(library, iters) if library is not None else None
        bound_ms = 1e3 * max(moved_bytes / HBM_BYTES_PER_S,
                             ops_seconds(flops, flops_bf16, flops_tf32))
        log(f"[kernel] {name}: shapes {shapes} max_abs_err {err:.3e} "
            f"(tol {tol:g}) kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"library {'-' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
            f"{bound_ms:.3f} ms -> ok")
        row = self.rows.setdefault(name, dict(
            name=name, route="cuda", source=source, replaces=replaces,
            counter=counter, max_abs_err=0.0, ms=0.0, plain_ms=0.0,
            bytes=0, flops=0, flops_bf16=0, flops_tf32=0, paths=paths,
            library_ms=0.0 if library is not None else None))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bytes"] += moved_bytes
        row["flops"] += flops
        row["flops_bf16"] += flops_bf16
        row["flops_tf32"] += flops_tf32
        if lib_ms is not None:
            row["library_ms"] += lib_ms

    def finish(self, launches: dict) -> list:
        """The rows with their launches: per eval image for the kernels the
        eval path runs (the forward ones), per training step (step-0 phase)
        for the others; ``train_launches`` is every kernel's count per
        training step. ``launches`` maps each path name to its counts."""
        rows = []
        for r in self.rows.values():
            b_ms = 1e3 * r["bytes"] / HBM_BYTES_PER_S
            o_ms = 1e3 * ops_seconds(r["flops"], r["flops_bf16"],
                                     r["flops_tf32"])
            c = r["counter"]
            eval_path, train_path = r["paths"]
            path = eval_path if launches[eval_path][c] else train_path
            rows.append(dict(
                name=r["name"], route=r["route"], source=r["source"],
                replaces=r["replaces"], launches=launches[path][c],
                path=path, train_launches=launches[train_path][c],
                max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=max(b_ms, o_ms),
                bound_by="bytes" if b_ms >= o_ms else "operations",
                library_ms=r["library_ms"]))
        return rows


def field_ops(field, n: int, passes: int, tf32: bool) -> tuple:
    """(float32, bf16-operand, TF32-operand) operations of `passes` products
    per weight on n points: one multiply-add per weight and point in each
    product. Where the products run on the tensor cores only the heads keep
    float32 operands: the bf16-operand mode's products take bf16 operands,
    the float32 mode's, with tf32 set (K6, K7's pass 2; K7's float32 pass 1
    runs on the CUDA cores), three TF32 products each (3xTF32)."""
    macs = sum(m.weight.numel() for m in field.modules()
               if isinstance(m, torch.nn.Linear))
    if not (field.bf16 or tf32):
        return 2 * passes * n * macs, 0, 0
    heads = [field.alpha_linear, field.rgb_linear]
    heads += [field.w_linear] if field.static else [field.sf_linear,
                                                    field.prob_linear]
    head = sum(m.weight.numel() for m in heads)
    products = 2 * passes * n * (macs - head)
    if field.bf16:
        return 2 * passes * n * head, products, 0
    return 2 * passes * n * head, 0, 3 * products


def chunk_inputs(system, batch):
    """The first chunk's rays of the flagship eval and both fields' inputs on
    them, as ``render_rays`` builds them ([16384, 128, ch])."""
    from zest_tpu_torch import render
    with torch.no_grad():
        models = system.render_models(batch)
        rays = system.chunk_rays(batch, 0)
        kw = system.render_kwargs(batch)
        return rays, {
            "static": render.static_field_inputs(models, rays, kw["im_w2c_ref"]),
            "dynamic": render.dynamic_field_inputs(models, rays, kw["nb_w2c_ref"],
                                                   kw["ref_frame_idx"])}


def check_field_forward(rows, name, system, field_inputs, tol, paths,
                        source="zest_tpu_torch/csrc/fused_mlp_tc32.cu"):
    """K6 on both fields' chunk inputs; the twin is the field module itself;
    no single library call computes a field."""
    from zest_tpu_torch.kernels.fused_mlp import fused_nerf_forward
    for kind, inputs in field_inputs.items():
        field = getattr(system, f"nerf_{kind}")
        n = inputs[0].numel() // inputs[0].shape[-1]
        f32_ops, bf16_ops, tf32_ops = field_ops(field, n, 1, True)
        rows.check(name, source,
                   "zest_tpu/kernels/fused_mlp.py:376", "fused_nerf_forward",
                   functools.partial(fused_nerf_forward, field, *inputs),
                   functools.partial(field, *inputs), None, tol, 3,
                   nbytes(*inputs) + 4 * n * field.out_ch
                   + 4 * sum(p.numel() for p in field.parameters()),
                   f32_ops, flops_bf16=bf16_ops, paths=paths,
                   flops_tf32=tf32_ops)


def float64_distances(field, inputs, outs, rows=1 << 18) -> list:
    """Norm-wise distance of each of outs (the field's outputs on inputs)
    from ``float64_twin(field)``'s output, computed in slices of `rows`
    points."""
    wide = float64_twin(field)
    flat = [t.reshape(-1, t.shape[-1]) for t in inputs]
    n = flat[0].shape[0]
    num, den = [0.0] * len(outs), 0.0
    with torch.no_grad():
        for s in range(0, n, rows):
            ref = wide(*(t[s:s + rows].double() for t in flat))
            den += float((ref * ref).sum())
            for i, out in enumerate(outs):
                d = out.reshape(n, -1)[s:s + rows].double() - ref
                num[i] += float((d * d).sum())
            del ref
    return [(x / den) ** 0.5 for x in num]


def float32_class(label, field, inputs, gate) -> tuple:
    """K6's float32 mode (3xTF32) and the float32 twin on one field's
    inputs, each against a float64 twin, norm-wise; with gate, fails unless
    K6 is within max(F32_CLASS_FACTOR x the twin's, F32_CLASS_FLOOR).
    Returns (K6's distance, the twin's)."""
    from zest_tpu_torch.kernels.fused_mlp import fused_nerf_forward
    with torch.no_grad():
        out = fused_nerf_forward(field, *inputs)
        twin = field(*inputs)
    got, own = float64_distances(field, inputs, (out, twin))
    limit = max(F32_CLASS_FACTOR * own, F32_CLASS_FLOOR)
    log(f"[kernel] fused_nerf {label}: norm-wise from a float64 twin {got:.3e}"
        f", the float32 twin's {own:.3e}"
        + (f" (limit {limit:.3e}) -> ok" if gate else ""))
    if gate and not got <= limit:
        raise AssertionError(f"K6 float32 on {label}: {got} from float64, "
                             f"limit {limit}")
    return got, own


def step_inputs(system, batch, cfg, gen):
    """The flagship training step's step-0 rays (drawn from gen), the
    stacked t±1 points and the three field passes' inputs (field, inputs)
    by label, as ``render_rays_train`` builds them."""
    from zest_tpu_torch import render, sampling
    from zest_tpu_torch.kernels import fused_mlp
    from zest_tpu_torch.system import phase_for_step
    phase = phase_for_step(cfg, 0)
    draws = sampling.sample_draws(gen, cfg, cfg.img_h, cfg.img_w,
                                  int(batch["motion_count"]), phase.extra_samples)
    with torch.no_grad():
        models = system.render_models(batch)
        rays = system.train_rays(batch, draws, phase)
        kw = system.render_kwargs(batch)
        st_in = render.static_field_inputs(models, rays, kw["im_w2c_ref"])
        dy_in = render.dynamic_field_inputs(models, rays, kw["nb_w2c_ref"],
                                            kw["ref_frame_idx"])
        raw_dy = fused_mlp.fused_nerf_forward(system.nerf_dynamic, *dy_in)
        warped = torch.cat([rays.ndc + raw_dy[..., 4:7],
                            rays.ndc + raw_dy[..., 7:10]]).contiguous()
        dt = 2.0 / batch["total_frames"]
        ones = torch.ones_like(rays.ndc[..., :1])
        t_pp = torch.cat([ones * (kw["ref_frame_idx"] - dt),
                          ones * (kw["ref_frame_idx"] + dt)])
        col = dy_in[1][..., 8:]
        pp_in = render._dynamic_inputs(models, warped, t_pp,
                                       torch.cat([col, col]),
                                       torch.cat([dy_in[2], dy_in[2]]),
                                       warped=True)
    return rays, warped, {"static": (system.nerf_static, st_in),
                          "dynamic": (system.nerf_dynamic, dy_in),
                          "t-1 / t+1": (system.nerf_dynamic, pp_in)}


def float64_twin(field):
    """The twin of field in float64, the witness of the float32 evaluations:
    float64 sums, and in the bf16-operand mode the same bf16 rounding of
    every operand."""
    from zest_tpu_torch.models.nerf import NeRFField
    twin = NeRFField(field.depth, field.width, field.in_ch_pts,
                     field.in_ch_views, field.in_ch_feat, field.skips,
                     field.static,
                     bf16=field.bf16).to(next(field.parameters()).device)
    twin.load_state_dict({k: v.double() for k, v in field.state_dict().items()})
    return twin.double()


def grad_distance(got, ref, leaves) -> tuple:
    """Distances of got to ref, each (d_pts, d_feats, d_views, d_pack):
    ({name: (norm-wise relative error, largest error / largest |ref|)} for
    the three inputs and every leaf of d_pack (``leaves(d_pack)`` gives
    [(name, tensor)]), the count of points whose input-gradient row
    differs by more than BF16_FIELD_GRAD_TOL of that input's largest)."""
    out, beyond = {}, None
    pairs = list(zip(("d_pts", "d_feats", "d_views"), got[:3], ref[:3]))
    pairs += [(name, a, b) for (name, a), (_, b) in zip(leaves(got[3]),
                                                        leaves(ref[3]))]
    for name, a, b in pairs:
        a, b = a.double(), b.double()
        peak = max(float(b.abs().max()), 1e-300)
        out[name] = (float((a - b).norm()) / max(float(b.norm()), 1e-300),
                     float((a - b).abs().max()) / peak)
        if name.startswith("d_"):
            far = (a - b).abs().amax(1) > BF16_FIELD_GRAD_TOL * peak
            beyond = far if beyond is None else beyond | far
    return out, int(beyond.sum())


def hold_bf16_backward(name, label, field, flat, g, pack, offsets):
    """K7's bf16 mode on one pass, held three ways (the gates of phase 9):

    1. to the twin's autograd, with a criterion that the ReLU-kink noise
       passes: every input and every leaf within BF16_FIELD_GRAD_TOL
       norm-wise; the rows beyond BF16_FIELD_GRAD_TOL of their input's
       largest at most BF16_KINK_ROWS of the rows; every leaf's largest
       error within BF16_LEAF_PEAK of its largest gradient;
    2. to the twin's backward at the forward values K7 ran at, every input
       and leaf to BF16_FIELD_GRAD_TOL of its largest; those values (cond,
       every z_i, hv, the feature layer's output) are held to the twin's
       own forward within BF16_FIELD_GRAD_TOL norm-wise and BF16_LEAF_PEAK
       of their largest;
    3. a float64 twin is the witness: each leaf's distance from K7 and from
       the float32 twin to it is logged, and so are the ReLU masks and bf16
       activations of K7's forward (K6's) and of the twin's that differ
       from float64's.

    Returns the largest norm-wise distance to the twin's autograd."""
    from zest_tpu_torch.kernels import fused_mlp

    def leaves(d_pack):
        return fused_mlp.pack_leaves(field, d_pack, offsets)

    n = flat[0].shape[0]
    saved = {}
    got = fused_mlp.fused_nerf_backward(field, *flat, g, pack, offsets,
                                        saved=saved)
    twin = fused_mlp.fused_nerf_backward_plain(field, *flat, g)
    wide = float64_twin(field)
    flat64 = [t.double() for t in flat]
    exact = fused_mlp.fused_nerf_backward_plain(wide, *flat64, g.double())
    with torch.no_grad():
        at = fused_mlp.fused_nerf_backward_at_plain(field, saved, *flat, g)
        fwd = fused_mlp.forward_values_plain(field, *flat)
        fwd64 = fused_mlp.forward_values_plain(wide, *flat64)
    torch.cuda.synchronize()
    to_twin, beyond = grad_distance(got, twin, leaves)
    to_exact, _ = grad_distance(got, exact, leaves)
    twin_exact, twin_beyond = grad_distance(twin, exact, leaves)
    at_own, _ = grad_distance(got, at, leaves)
    del got, twin, exact, at

    failures = []
    for leaf, (norm, peak) in to_twin.items():
        if not norm <= BF16_FIELD_GRAD_TOL:
            failures.append(f"{leaf} {norm:.3e} norm-wise from the twin")
        if not (leaf.startswith("d_") or peak <= BF16_LEAF_PEAK):
            failures.append(f"{leaf} {peak:.3e} of its largest from the twin")
        if not at_own[leaf][1] <= BF16_FIELD_GRAD_TOL:
            failures.append(f"{leaf} {at_own[leaf][1]:.3e} from the twin's "
                            f"backward at K7's forward values")
    rows_cap = BF16_KINK_ROWS * n
    if not beyond <= rows_cap:
        failures.append(f"{beyond} rows beyond "
                        f"{BF16_FIELD_GRAD_TOL:g} (cap {rows_cap:.0f})")
    values = [("cond", saved["cond"], fwd["cond"]),
              ("hv", saved["hv"], fwd["hv"]),
              ("feature", saved["feature"].float(), fwd["feature"].float())]
    values += [(f"z{i}", a, b) for i, (a, b) in enumerate(zip(saved["z"],
                                                                fwd["z"]))]
    worst_value = 0.0
    for what, a, b in values:
        norm = float((a - b).norm()) / max(float(b.norm()), 1e-30)
        peak = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        worst_value = max(worst_value, norm)
        if not (norm <= BF16_FIELD_GRAD_TOL and peak <= BF16_LEAF_PEAK):
            failures.append(f"forward value {what}: {norm:.3e} norm-wise, "
                            f"{peak:.3e} of its largest from the twin's")
    # the forward's decisions against float64's: ReLU masks and the bf16
    # activations the next products read
    flips = {"K7": [0, 0], "twin": [0, 0]}
    for i, z64 in enumerate(fwd64["z"]):
        a64 = z64 * fwd64["cond"]
        h64 = torch.relu(a64).to(torch.bfloat16)
        for who, vals in (("K7", saved), ("twin", fwd)):
            a = vals["z"][i] * vals["cond"]
            flips[who][0] += int(((a > 0) != (a64 > 0)).sum())
            flips[who][1] += int((torch.relu(a).to(torch.bfloat16) != h64).sum())
    units = n * field.width * len(fwd64["z"])
    del saved, fwd, fwd64, wide, flat64

    worst = max(norm for norm, _ in to_twin.values())
    log(f"[backward] {name} {label}: to the twin's autograd, largest "
        f"norm-wise error {worst:.3e}"
        f" (tol {BF16_FIELD_GRAD_TOL:g}), rows beyond {BF16_FIELD_GRAD_TOL:g}"
        f" of their input's largest {beyond} of {n} (cap {rows_cap:.0f}; "
        f"the float32 twin to float64: {twin_beyond}); to the twin's "
        f"backward at K7's own forward values, largest error "
        f"{max(peak for _, peak in at_own.values()):.3e} of "
        f"the largest (tol {BF16_FIELD_GRAD_TOL:g}); those values to the "
        f"twin's forward {worst_value:.3e} norm-wise")
    log(f"[backward] {name} {label}: of {units} trunk units, ReLU masks that "
        f"differ from float64's: K7 (K6's forward) {flips['K7'][0]}, twin "
        f"{flips['twin'][0]}; bf16 activations that differ: K7 "
        f"{flips['K7'][1]}, twin {flips['twin'][1]}")
    log(f"[backward] {name} {label}: per input and leaf, norm-wise / largest "
        f"error of the largest: K7 to twin | K7 to float64 | twin to float64")
    for leaf, (norm, peak) in to_twin.items():
        log(f"[backward]   {leaf}: {norm:.2e} / {peak:.2e} | "
            f"{to_exact[leaf][0]:.2e} / {to_exact[leaf][1]:.2e} | "
            f"{twin_exact[leaf][0]:.2e} / {twin_exact[leaf][1]:.2e}")
    if failures:
        raise AssertionError(f"{name} {label}: " + "; ".join(failures))
    return worst


def hold_float32_backward(rows, name, label, field, flat, g, pack, offsets):
    """K7's float32 mode on one pass, with a spy on its pass 2
    (``fused_mlp.weight_grads``): each chunk's pass-2 launch is held to its
    twin (``weight_grads_plain``) on the same scratch buffers, each leaf to
    1e-4 of its largest, and timed beside it and beside float32
    ``torch.matmul`` of the same X^T dZ shapes (row
    ``fused_nerf_weight_grads``). Then K7's weight gradients of the
    conditioning, trunk, feature and views layers against a float64 twin's
    autograd: each within max(F32_CLASS_FACTOR x the float32 twin's own
    norm-wise distance, F32_CLASS_FLOOR)."""
    from zest_tpu_torch.kernels import fused_mlp
    real = fused_mlp.weight_grads

    def held(field, pts, feats, views, bufs, offsets, d_pack):
        real(field, pts, feats, views, bufs, offsets, d_pack)
        out = torch.zeros_like(d_pack)

        def leaves(d):
            return tuple(t for _, t in fused_mlp.pack_leaves(field, d, offsets))

        def kern():
            out.zero_()
            real(field, pts, feats, views, bufs, offsets, out)
            return leaves(out)

        cond, z, dz = bufs["cond"], bufs["z"], bufs["dz"]
        h = [torch.relu(zi * cond) for zi in z]
        xs = [feats, pts] + [torch.cat([pts, h[i - 1]], -1)
                             if i - 1 in field.skips else h[i - 1]
                             for i in range(1, len(z))]
        xs += [h[-1], torch.cat([bufs["feature"], views], -1)]
        ds = [bufs["d_cond"], *dz, bufs["d_feature"], bufs["d_hv"]]
        n = pts.shape[0]
        f32_ops, _, tf32_ops = field_ops(field, n, 1, True)
        rows.check("fused_nerf_weight_grads",
                   "zest_tpu_torch/csrc/fused_mlp_tc32_bwd.cu",
                   "zest_tpu/kernels/fused_mlp.py:398", "weight_grads", kern,
                   lambda: leaves(fused_mlp.weight_grads_plain(
                       field, pts, feats, views, bufs)),
                   lambda: [torch.matmul(x.T, d) for x, d in zip(xs, ds)],
                   1e-4, 3, nbytes(pts, feats, views, *bufs.values())
                   + nbytes(d_pack), f32_ops, relative=True,
                   flops_tf32=tf32_ops)

    held.launches = 0                  # the wrapper counts on its module name
    fused_mlp.weight_grads = held
    try:
        got = fused_mlp.fused_nerf_backward(field, *flat, g, pack, offsets)[3]
    finally:
        fused_mlp.weight_grads = real
    twin = fused_mlp.fused_nerf_backward_plain(field, *flat, g)[3]
    wide = float64_twin(field)
    exact = fused_mlp.fused_nerf_backward_plain(
        wide, *(t.double() for t in flat), g.double())[3]
    torch.cuda.synchronize()
    names = {m: f"{n}.weight" for n, m in field.named_modules()}
    big = {names[m] for m in (field.pts_bias, *field.pts_linears,
                              field.feature_linear, field.views_linears[0])}

    def dist(a, b):
        return float((a.double() - b).norm()) / max(float(b.norm()), 1e-300)

    log(f"[backward] {name} {label}: weight gradients, norm-wise from a "
        f"float64 twin: K7 (pass 2 as 3xTF32) | the float32 twin")
    failures = []
    for (leaf, a), (_, b), (_, c) in zip(
            fused_mlp.pack_leaves(field, got, offsets),
            fused_mlp.pack_leaves(field, twin, offsets),
            fused_mlp.pack_leaves(wide, exact, offsets)):
        if leaf not in big:
            continue
        k7, own = dist(a, c), dist(b, c)
        limit = max(F32_CLASS_FACTOR * own, F32_CLASS_FLOOR)
        log(f"[backward]   {leaf}: {k7:.3e} | {own:.3e} (limit {limit:.3e})")
        if not k7 <= limit:
            failures.append(f"{leaf} {k7:.3e} from float64, limit {limit:.3e}")
    del got, twin, exact, wide
    field.zero_grad(set_to_none=True)
    if failures:
        raise AssertionError(f"{name} {label}: " + "; ".join(failures))


def check_field_backward(rows, name, passes, gen, tol, paths,
                         source="zest_tpu_torch/csrc/fused_mlp.cu"):
    """K7 on the step's field passes against autograd through the twin, with
    a random output gradient: at float32 d_pack is held leaf by leaf, each
    weight and bias to tol of its own largest element; the bf16 mode as
    ``hold_bf16_backward`` holds it. The time is the default chunks'
    against the twin's autograd."""
    from zest_tpu_torch.kernels import fused_mlp

    def leafwise(field, offsets, grads):
        d_pts, d_feats, d_views, d_pack = grads
        return (d_pts, d_feats, d_views,
                *(t for _, t in fused_mlp.pack_leaves(field, d_pack, offsets)))

    for label, (field, inputs) in passes.items():
        flat = [t.reshape(-1, t.shape[-1]).contiguous() for t in inputs]
        n = flat[0].shape[0]
        g = torch.randn((n, field.out_ch), generator=gen, device=flat[0].device)
        with torch.no_grad():
            pack, offsets = fused_mlp.pack_weights(field)
        if field.bf16:
            f32_ops, bf16_ops, tf32_ops = field_ops(field, n, 3, False)
        else:                          # pass 1 SIMT, pass 2 3xTF32
            pass1, pass2 = field_ops(field, n, 2, False), field_ops(field, n, 1,
                                                                    True)
            f32_ops, bf16_ops, tf32_ops = pass1[0] + pass2[0], 0, pass2[2]
        log(f"[backward] {name} {label}: {n} points")
        kern = lambda: leafwise(field, offsets, fused_mlp.fused_nerf_backward(
            field, *flat, g, pack, offsets))
        plain = lambda: leafwise(field, offsets,
                                 fused_mlp.fused_nerf_backward_plain(
                                     field, *flat, g))
        verified = None
        if field.bf16:
            err = hold_bf16_backward(name, label, field, flat, g, pack,
                                     offsets)
            verified = (err, [tuple(t.shape) for t in flat])
        else:
            hold_float32_backward(rows, name, label, field, flat, g, pack,
                                  offsets)
        rows.check(name, source,
                   "zest_tpu/kernels/fused_mlp.py:398", "fused_nerf_backward",
                   kern, plain, None, tol, 2,
                   2 * nbytes(*flat) + nbytes(g) + 2 * nbytes(pack), f32_ops,
                   relative=True, flops_bf16=bf16_ops, paths=paths,
                   verified=verified, flops_tf32=tf32_ops)
        field.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()


def forward_kernels(rows, dev, cfg, system, batch):
    """Phase 3: each forward kernel against its twin on the first chunk's
    inputs of the flagship eval, at the shapes the main path gives it."""
    import torch.nn.functional as F

    from zest_tpu_torch import geometry
    from zest_tpu_torch.kernels import fused_mlp
    from zest_tpu_torch.kernels.color_gather import (gather_colors,
                                                     gather_colors_plain)
    from zest_tpu_torch.kernels.plane_sweep import homo_warp_cm, homo_warp_cm_plain
    from zest_tpu_torch.kernels.trilinear import sample_volume, sample_volume_plain
    from zest_tpu_torch.models.mvsnet import depth_plane_values
    from zest_tpu_torch.ops.homography import homography_grid
    from zest_tpu_torch.system import unpreprocess

    gen = torch.Generator(device=dev).manual_seed(SEED)
    H, W = cfg.img_h, cfg.img_w
    h, w = H // 4, W // 4
    imgs_un = unpreprocess(batch["images"])
    depths = depth_plane_values(batch["near_fars"][0, 0], batch["near_fars"][0, 1])
    rays, field_inputs = chunk_inputs(system, batch)

    # K1: source view 1 (32 features + 3 RGB) over the padded frustum
    src = torch.randn((h, w, 35), generator=gen, device=dev)
    grid = homography_grid(batch["proj_mats"][1], depths, (h, w), pad=cfg.pad)
    src_nchw = src.permute(2, 0, 1)[None].contiguous()
    grid_flat = grid.reshape(1, -1, 1, 2)
    D, Hp, Wp, _ = grid.shape
    rows.check("plane_sweep_warp", "zest_tpu_torch/csrc/plane_sweep.cu",
               "zest_tpu/kernels/plane_sweep.py:239", "homo_warp_cm",
               lambda: homo_warp_cm(src, grid),
               lambda: homo_warp_cm_plain(src, grid),
               lambda: F.grid_sample(src_nchw, grid_flat, align_corners=True),
               1e-5, 20, nbytes(src, grid) + 4 * D * 35 * Hp * Wp,
               8 * D * 35 * Hp * Wp)

    # K3: an encoding volume at the chunk's ray points
    vol = torch.randn((128, h + 2 * cfg.pad, w + 2 * cfg.pad, 8), generator=gen,
                      device=dev)
    ndc = rays.ndc.contiguous()
    vol_ncdhw = vol.permute(3, 0, 1, 2)[None].contiguous()
    grid3 = (ndc * 2.0 - 1.0).reshape(1, -1, 1, 1, 3)
    n = ndc.numel() // 3
    # bytes: the volume cells the chunk's taps touch, the points, the output
    rows.check("trilinear_sample", "zest_tpu_torch/csrc/trilinear.cu",
               "zest_tpu/kernels/trilinear.py:279", "sample_volume",
               lambda: sample_volume(vol, ndc),
               lambda: sample_volume_plain(vol, ndc),
               lambda: F.grid_sample(vol_ncdhw, grid3, align_corners=True),
               1e-5, 20, 32 * volume_cells(ndc, vol.shape[:3]) + nbytes(ndc)
               + 32 * n, 128 * n)

    # K8: the 8 source views at the chunk's projected points
    V = imgs_un.shape[0] - 1
    inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32, device=dev)
    xy = torch.stack([
        geometry.world_to_ndc(rays.pts, batch["w2cs"][v],
                              batch["intrinsics"][v], inv_scale, 2.0,
                              6.0)[..., :2] * inv_scale
        for v in range(V)]).reshape(V, -1, 2).contiguous()
    src_imgs = imgs_un[:-1].contiguous()
    imgs_nchw = src_imgs.permute(0, 3, 1, 2).contiguous()
    grid8 = (xy / torch.tensor([(W - 1) * 0.5, (H - 1) * 0.5], device=dev)
             - 1.0)[:, :, None, :]
    rows.check("color_gather", "zest_tpu_torch/csrc/color_gather.cu",
               "zest_tpu/kernels/color_gather.py:138", "gather_colors",
               lambda: gather_colors(src_imgs, xy),
               lambda: gather_colors_plain(src_imgs, xy),
               lambda: F.grid_sample(imgs_nchw, grid8, padding_mode="border",
                                     align_corners=True),
               1e-5, 20, 12 * image_pixels(xy, H, W) + nbytes(xy)
               + 12 * xy.shape[0] * xy.shape[1], 24 * xy.shape[0] * xy.shape[1])

    # K6: both fields on the chunk's inputs, on the tensor cores as 3xTF32
    mma = sass_has_mma("fused_nerf_tc32_kernel")
    log(f"[kernel] tensor-core instructions (HMMA / HGMMA) per instantiation "
        f"of fused_nerf_tc32_kernel: {sorted(mma.values())}")
    if len(mma) != 3 or min(mma.values()) == 0:
        raise AssertionError(f"fused_nerf_tc32_kernel without HMMA: {mma}")
    check_field_forward(rows, "fused_nerf", system, field_inputs, 1e-4,
                        ("eval", "train"))
    for kind, inputs in field_inputs.items():
        field = getattr(system, f"nerf_{kind}")
        float32_class(f"{kind} field, eval chunk", field, inputs, True)
        with torch.no_grad():
            pack, offsets = fused_mlp.pack_weights(field)
            same = torch.equal(fused_mlp.pack_tc32(field, pack, offsets),
                               fused_mlp.pack_tc32_plain(field, pack,
                                                         offsets)[0])
        if not same:
            raise AssertionError(f"K6's float32 operand pack of the {kind} "
                                 f"field differs from its twin")
    row = rows.rows["fused_nerf"]
    useful = row["flops_tf32"] / 3
    n = field_inputs["static"][0].numel() // field_inputs["static"][0].shape[-1]
    a = torch.randn((n, 256), generator=gen, device=dev)
    b = torch.randn((256, 256), generator=gen, device=dev)
    mm_ms = cuda_ms(lambda: torch.matmul(a, b), 5)
    log(f"[kernel] K6 float32 on the chunk: {row['ms']:.3f} ms, "
        f"{useful / row['ms'] / 1e9:.1f} TFLOP/s of float32 products "
        f"({3 * useful / row['ms'] / 1e9:.1f} TFLOP/s of TF32 products, "
        f"3xTF32); its float32 operand packs equal their twins; yardstick "
        f"torch.matmul float32 [{n}, 256] @ [256, 256] (a trunk layer, TF32 "
        f"off): {mm_ms:.3f} ms, {2 * n * 256 * 256 / mm_ms / 1e9:.1f} TFLOP/s "
        f"(timed only)")
    del a, b


def small_slice(dev):
    """Phase 4: the eval step at the small preset on CUDA against the same
    step on the CPU."""
    from zest_tpu_torch import presets
    from zest_tpu_torch.system import EVAL_KEYS
    _, system, batch, params = presets.build(presets.SMALL,
                                             presets.SMALL_SCENE, "cpu", SEED)
    step = system.make_eval_step()
    ref = step(params, batch)
    out = step({k: v.to(dev) for k, v in params.items()},
               {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    # cuDNN and the CPU sum the convolutions in different orders; the maps
    # are O(1) composites of 16 samples
    rtol, atol = 1e-4, 1e-4
    for k in EVAL_KEYS:
        a, b = out[k].cpu(), ref[k]
        err = float((a - b).abs().max())
        ok = torch.allclose(a, b, rtol=rtol, atol=atol)
        log(f"[small] {k}: max_abs_err {err:.3e} spread {float(b.std()):.3e} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"small slice {k}: CUDA and CPU differ by {err}")
    if float(ref["rgb_map_ref"].std()) <= 1e-3:
        raise AssertionError("small slice renders a constant image")


def flagship(cfg, system, batch, params, tag="flagship"):
    """Phases 5 and 11: the flagship eval step with every launch counter
    reset first. Returns (launches, median s/image)."""
    from zest_tpu_torch.system import EVAL_KEYS
    step = system.make_eval_step()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    maps = step(params, batch)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = read_counters()
    H, W = cfg.img_h, cfg.img_w
    n_chunks = -(-(H * W) // cfg.eval_chunk)
    n_src = batch["images"].shape[0] - 2
    expected = dict.fromkeys(launches, 0)
    expected.update(homo_warp_cm=n_src, sample_volume=2 * n_chunks,
                    gather_colors=2 * n_chunks, fused_nerf_forward=2 * n_chunks)
    log(f"[{tag}] first run {first:.2f} s, launches {launches}")
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    for k in EVAL_KEYS:
        v = maps[k]
        if v.shape[:2] != (H, W) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"flagship {k}: shape {tuple(v.shape)} or "
                                 f"non-finite values")
        log(f"[{tag}] {k}: shape {tuple(v.shape)} mean {float(v.mean()):.4f}"
            f" std {float(v.std()):.4f}")
    if float(maps["rgb_map_ref"].std()) <= 0.0:
        raise AssertionError("flagship rgb_map_ref is constant")

    times = []
    prev = float(maps["rgb_map_ref"][0, 0, 0])
    for _ in range(3):
        b2 = dict(batch, images=batch["images"] + (prev % 1.0) * 1e-6)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps = step(params, b2)
        prev = float(maps["rgb_map_ref"][0, 0, 0])    # waits for the device
        times.append(time.perf_counter() - t0)
    log(f"[{tag}] s/image over {len(times)} runs: "
        + ", ".join(f"{t:.3f}" for t in times)
        + f" (median {float(np.median(times)):.3f}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, float(np.median(times))


def backward_kernels(rows, dev, cfg, system, batch):
    """Phase 6: each backward kernel against its twin's autograd at the
    flagship training step's inputs: the step-0 rays, both encoding volumes,
    the three field passes' inputs and a random output gradient."""
    import torch.nn.functional as F

    from zest_tpu_torch.kernels import plane_sweep, trilinear
    from zest_tpu_torch.models.mvsnet import depth_plane_values
    from zest_tpu_torch.ops.homography import homography_grid

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    near_far = batch["near_fars"][0]
    rays, warped, passes = step_inputs(system, batch, cfg, gen)
    with torch.no_grad():
        static_vol, _, _ = system.enc_static(batch["images"][:-1],
                                             batch["proj_mats"][:-1], near_far,
                                             pad=cfg.pad)
        dyn_vol, _, _ = system.enc_dy(batch["nb_imgs"], batch["nb_proj_mats"],
                                      near_far, pad=cfg.pad)
    R, S = rays.ndc.shape[:2]
    log(f"[backward] R = {R} rays of {S} samples; volumes "
        f"{tuple(static_vol.shape)}, {tuple(dyn_vol.shape)}")

    # K6 on the step's three float32 field passes (held, not timed: the
    # row's time is the eval chunk's), each beside a float64 twin
    from zest_tpu_torch.kernels.fused_mlp import fused_nerf_forward
    for label, (field, inputs) in passes.items():
        err, shapes = rows.verify(
            "fused_nerf", functools.partial(fused_nerf_forward, field, *inputs),
            functools.partial(field, *inputs), 1e-4)
        log(f"[kernel] fused_nerf on the training pass {label}: shapes "
            f"{shapes} max_abs_err {err:.3e} (tol 1e-4) -> ok")
        float32_class(f"training pass {label}", field, inputs, False)

    # K7: the field backward on the three passes of a step; its float32
    # pass 2 runs on the tensor cores
    mma = sass_has_mma("wgrad_tc32_kernel")
    log(f"[backward] tensor-core instructions (HMMA / HGMMA) in "
        f"wgrad_tc32_kernel: {sorted(mma.values())}")
    if len(mma) != 1 or min(mma.values()) == 0:
        raise AssertionError(f"wgrad_tc32_kernel without HMMA: {mma}")
    check_field_backward(rows, "fused_nerf_backward", passes, gen, 1e-4,
                         ("eval", "train"))
    row = rows.rows["fused_nerf_weight_grads"]
    useful = row["flops_tf32"] / 3
    log(f"[backward] K7 float32 pass 2 on the step's three passes: "
        f"{row['ms']:.3f} ms, {useful / row['ms'] / 1e9:.1f} TFLOP/s of float32"
        f" products ({3 * useful / row['ms'] / 1e9:.1f} TFLOP/s of TF32 "
        f"products, 3xTF32); its twin {row['plain_ms']:.3f} ms; yardstick "
        f"torch.matmul float32 of the same X^T dZ shapes (TF32 off): "
        f"{row['library_ms']:.3f} ms, {useful / row['library_ms'] / 1e9:.1f} "
        f"TFLOP/s (timed only); K7 float32 in all "
        f"{rows.rows['fused_nerf_backward']['ms']:.3f} ms")

    # K4 (d_vol) on the three lookups of a step, K5 (d_ndc) on the warped one;
    # the library call is F.grid_sample's backward on the same layout. Bytes:
    # K4 reads the points and g and writes d_vol once; K5 reads the volume
    # cells its taps touch, the points and g, and writes d_ndc
    def lookups():
        yield "static", static_vol, rays.ndc.contiguous()
        yield "dynamic", dyn_vol, rays.ndc.contiguous()
        yield "t-1 / t+1", dyn_vol, warped
    for label, vol, ndc in lookups():
        n = ndc.numel() // 3
        g = torch.randn((*ndc.shape[:-1], 8), generator=gen, device=dev)
        vol5 = vol.permute(3, 0, 1, 2)[None].contiguous()
        grid5 = (ndc * 2.0 - 1.0).reshape(1, -1, 1, 1, 3).contiguous()
        g5 = g.reshape(1, -1, 8).permute(0, 2, 1).reshape(1, 8, -1, 1, 1).contiguous()
        lib = functools.partial(torch.ops.aten.grid_sampler_3d_backward, g5,
                                vol5, grid5, 0, 0, True)
        rows.check("trilinear_grad_volume", "zest_tpu_torch/csrc/trilinear.cu",
                   "zest_tpu/kernels/trilinear.py:303", "volume_grad",
                   lambda: trilinear.volume_grad(vol.shape, ndc, g),
                   lambda: trilinear.sample_volume_grads_plain(vol, ndc, g)[0],
                   lambda: lib([True, False]), 1e-5, 5,
                   nbytes(ndc, g, vol), 128 * n, relative=True)
        if label == "t-1 / t+1":
            rows.check("trilinear_grad_coords", "zest_tpu_torch/csrc/trilinear.cu",
                       "zest_tpu/kernels/trilinear.py:353", "coords_grad",
                       lambda: trilinear.coords_grad(vol, ndc, g),
                       lambda: trilinear.sample_volume_grads_plain(vol, ndc, g)[1],
                       lambda: lib([False, True]), 1e-5, 5,
                       32 * volume_cells(ndc, vol.shape[:3]) + nbytes(ndc, g)
                       + 12 * n, 8 * 40 * n, relative=True)

    # K2: d_src of source view 1 over the 128 planes. Bytes: g at the items
    # with a tap inside the source (no other g reaches d_src), the grid, and
    # d_src written once
    h, w = cfg.img_h // 4, cfg.img_w // 4
    depths = depth_plane_values(near_far[0], near_far[1])
    grid = homography_grid(batch["proj_mats"][1], depths, (h, w), pad=cfg.pad)
    D, Hp, Wp, _ = grid.shape
    C = 35
    items = int(plane_sweep.inside_items(grid, (h, w)).sum())
    log(f"[backward] warp: {items} of {D * Hp * Wp} (plane, pixel) items have "
        f"a tap inside the source")
    src = torch.randn((h, w, C), generator=gen, device=dev)
    g = torch.randn((D, C, Hp * Wp), generator=gen, device=dev)
    src_nchw = src.permute(2, 0, 1)[None].contiguous()
    grid_flat = grid.reshape(1, -1, 1, 2).contiguous()
    g_lib = g.permute(1, 0, 2).reshape(1, C, -1, 1).contiguous()
    rows.check("plane_sweep_warp_backward", "zest_tpu_torch/csrc/plane_sweep.cu",
               "zest_tpu/kernels/plane_sweep.py:261", "homo_warp_cm_grad",
               lambda: plane_sweep.homo_warp_cm_grad(g, grid, (h, w)),
               lambda: plane_sweep.homo_warp_cm_grad_plain(src, grid, g),
               lambda: torch.ops.aten.grid_sampler_2d_backward(
                   g_lib, src_nchw, grid_flat, 0, 0, True, [True, False]),
               1e-5, 5, 4 * C * items + nbytes(grid, src), 8 * C * items,
               relative=True)
    del static_vol, dyn_vol, rays, passes, warped, g
    torch.cuda.empty_cache()


def _compare_train(tag, ref, out, rtol=1e-4, grad_tol=1e-4):
    """Logs to rtol; gradients to grad_tol of their module's largest (each
    field, each encoder); parameters after the step where the gradient is
    clear of Adam's epsilon and of the packages' difference."""
    logs, grads, params, new = ref
    logs_c, grads_c, _, new_c = out
    for k, v in logs.items():
        a, b = float(logs_c[k]), float(v)
        if not (np.isfinite(a) and abs(a - b) <= rtol * abs(b) + 1e-12):
            raise AssertionError(f"{tag} log {k}: CUDA {a} CPU {b}")
    scale = {}
    for k, v in grads.items():
        m = k.split(".")[0]
        scale[m] = max(scale.get(m, 0.0), float(v.abs().max()))
    worst = 0.0
    for k, v in grads.items():
        err = float((grads_c[k].cpu() - v).abs().max())
        worst = max(worst, err / scale[k.split(".")[0]])
        if err > grad_tol * scale[k.split(".")[0]]:
            raise AssertionError(f"{tag} grad {k}: differs by {err}")
        big = (v.abs() > 10 * err) & (v.abs() > 1e-5)
        d = float((new_c[k].cpu() - new[k])[big].abs().max()) if big.any() else 0.0
        if d > 1e-6:
            raise AssertionError(f"{tag} updated {k}: differs by {d}")
    moved = sum(int((new[k] != params[k]).sum()) for k in params)
    if moved == 0:
        raise AssertionError(f"{tag}: no parameter moved")
    log(f"[small-train] {tag}: loss {float(logs['train_loss']):.6f} (CUDA "
        f"{float(logs_c['train_loss']):.6f}); worst gradient difference "
        f"{worst:.2e} of its module's largest; {moved} parameters moved")


def small_train(dev):
    """Phase 7: the small training step on CUDA and on the CPU, from the
    same weights and draws, in both phases."""
    from zest_tpu_torch import presets, sampling
    from zest_tpu_torch.system import TrainState, phase_for_step
    cfg, system, batch, params = presets.build(presets.SMALL_TRAIN,
                                               presets.SMALL_SCENE, "cpu", SEED)
    _, system_c, batch_c, params_c = presets.build(
        presets.SMALL_TRAIN, presets.SMALL_SCENE, dev, SEED)
    H, W = cfg.img_h, cfg.img_w
    chain_step = cfg.decay_iteration_clamped * 2000 + 1
    for step in (0, chain_step):
        phase = phase_for_step(cfg, step)
        draws = sampling.sample_draws(torch.Generator().manual_seed(SEED + step),
                                      cfg, H, W, int(batch["motion_count"]),
                                      phase.extra_samples)
        runs = []
        for sys_, b, p, d in ((system, batch, params, draws),
                              (system_c, batch_c, params_c, draws.to(dev))):
            opt = sys_.make_optimizer(presets.STEPS_PER_EPOCH)
            _, logs, grads = sys_.loss_and_grads(p, b, d, phase, step)
            state, _ = sys_.make_train_step(opt)(
                TrainState(p, opt.init(p), step), b, d, phase)
            runs.append((logs, grads, p, state.params))
        torch.cuda.synchronize()
        _compare_train(f"step {step} {tuple(phase)}", *runs)


def flagship_train(cfg, system, batch, params, tag="train"):
    """Phases 8 and 11: the flagship training step: exact launches per step
    in both phases, finite logs, moved parameters, then a timed window of
    steps. Returns (the step-0 phase's launches, train rays/s)."""
    from zest_tpu_torch import presets, sampling
    from zest_tpu_torch.kernels import fused_mlp
    from zest_tpu_torch.system import TrainState, phase_for_step
    dev = batch["images"].device
    H, W = cfg.img_h, cfg.img_w
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    motion_count = int(batch["motion_count"])
    opt = system.make_optimizer(presets.STEPS_PER_EPOCH)
    step_fn = system.make_train_step(opt)
    n_rays = cfg.batch_size + cfg.num_extra_samples

    def run(state, phase):
        draws = sampling.sample_draws(gen, cfg, H, W, motion_count,
                                      phase.extra_samples)
        return step_fn(state, batch, draws, phase)

    n_src = batch["images"].shape[0] - 2

    def chunks(n):
        return -(-n // fused_mlp.CHUNK_ROWS)

    state0 = TrainState(params, opt.init(params), 0)
    phase0 = phase_for_step(cfg, 0)
    chain_step = cfg.decay_iteration_clamped * 2000 + 1
    phase_c = phase_for_step(cfg, chain_step)
    launches = {}
    for step_tag, state, phase, extra in (("step 0", state0, phase0, 0),
                                          (f"step {chain_step}",
                                           state0._replace(step=chain_step),
                                           phase_c, 1)):
        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new, logs = run(state, phase)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        got = read_counters()
        # the field passes' points: static and dynamic R x S, t±1 2 R x S,
        # the chain R x S; K7 float32 runs pass 2 once per chunk of each
        points = (cfg.batch_size + cfg.num_extra_samples * phase.extra_samples
                  ) * cfg.N_samples
        expected = dict(homo_warp_cm=n_src, homo_warp_cm_grad=n_src,
                        sample_volume=3 + extra, volume_grad=3 + extra,
                        coords_grad=1 + extra, gather_colors=2,
                        fused_nerf_forward=3 + extra,
                        fused_nerf_backward=3 + extra,
                        weight_grads=(2 + extra) * chunks(points)
                        + chunks(2 * points), gather_rows=0, scatter_rows=0)
        if system.bf16:
            # the warped lookups (t±1, the chain) are row gathers; K7's
            # bf16 mode takes its weight gradients inside its own entry
            expected.update(sample_volume=2, volume_grad=2, coords_grad=0,
                            gather_rows=1 + extra, scatter_rows=1 + extra,
                            weight_grads=0)
        log(f"[{tag}] {step_tag} {tuple(phase)}: first run {first:.2f} s, "
            f"launches {got}")
        if got != expected:
            raise AssertionError(f"{tag} {step_tag}: launches {got}, "
                                 f"expected {expected}")
        bad = [k for k, v in logs.items() if not bool(torch.isfinite(v))]
        if bad:
            raise AssertionError(f"{tag} {step_tag}: non-finite logs {bad}")
        log(f"[{tag}] {step_tag} logs: " + ", ".join(
            f"{k} {float(v):.5g}" for k, v in logs.items()))
        moved = sum(int(bool((new.params[k] != state.params[k]).any()))
                    for k in params)
        log(f"[{tag}] {step_tag}: {moved} of {len(params)} parameter tensors "
            f"moved")
        if moved < len(params) // 2:
            raise AssertionError(f"{tag} {step_tag}: only {moved} parameter "
                                 f"tensors moved")
        launches[step_tag] = got
        if step_tag == "step 0":
            state1 = new

    torch.cuda.reset_peak_memory_stats()
    state, logs = run(state1, phase0)                 # warm-up
    float(logs["train_loss"])
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, logs = run(state, phase0)
    loss = float(logs["train_loss"])                  # waits for the device
    dt = time.perf_counter() - t0
    log(f"[{tag}] {TRAIN_STEPS} steps in {dt:.3f} s ({1e3 * dt / TRAIN_STEPS:.1f}"
        f" ms/step), loss {loss:.5g}; train_rays_per_sec "
        f"{n_rays * TRAIN_STEPS / dt:.1f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches["step 0"], n_rays * TRAIN_STEPS / dt


def sass_has_mma(symbol: str) -> dict:
    """Disassemble the built kernel library (``cuobjdump -sass``) and count
    the tensor-core instructions (HMMA / HGMMA) of every function whose name
    holds ``symbol``: {mangled name: count}."""
    import shutil
    from pathlib import Path

    from zest_tpu_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise AssertionError("cuobjdump not found: cannot check for HMMA")
    sass = subprocess.run([tool, "-sass", _build.build_info["path"]],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        fn = part.split(None, 1)[0]
        if symbol in fn:
            counts[fn] = sum(1 for line in part.splitlines()
                             if "HMMA" in line or "HGMMA" in line)
    return counts


def bf16_kernels(rows, dev, cfg, system, batch):
    """Phase 9: the bf16-operand modes of K6 (both fields on the first chunk
    of the 16-bit flagship eval and the three field passes of its step-0
    training step; its bf16 weight pack) and K7 (those three passes), and K9
    forward and backward at that step's t±1 points in its bf16 dynamic
    volume, each against its twin."""
    from zest_tpu_torch.kernels import dma_gather, fused_mlp
    from zest_tpu_torch.ops.grid_sample import trilinear_row_taps

    paths = ("eval16", "train16")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    # the bf16 modes of K6 and K7 (pass 1 per width, pass 2) are the
    # tensor-core kernels: their SASS must hold mma
    for symbol, count in (("fused_nerf_tc_kernel", 3),
                          ("fused_nerf_bwd_tc_kernel", 3),
                          ("wgrad_tc_kernel", 1)):
        mma = sass_has_mma(symbol)
        log(f"[bf16] tensor-core instructions (HMMA / HGMMA) per "
            f"instantiation of {symbol}: {sorted(mma.values())}")
        if len(mma) != count or min(mma.values()) == 0:
            raise AssertionError(f"{symbol} without HMMA: {mma}")
    field_inputs = chunk_inputs(system, batch)[1]
    check_field_forward(rows, "fused_nerf_bf16", system, field_inputs,
                        BF16_FIELD_TOL, paths,
                        "zest_tpu_torch/csrc/fused_mlp_tc.cu")
    row = rows.rows["fused_nerf_bf16"]
    n = field_inputs["static"][0].numel() // field_inputs["static"][0].shape[-1]
    a = torch.randn((n, 256), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((256, 256), generator=gen, device=dev).to(torch.bfloat16)
    mm_ms = cuda_ms(lambda: torch.matmul(a, b), 5)
    log(f"[bf16] K6 bf16 on the chunk: {row['ms']:.3f} ms, "
        f"{row['flops_bf16'] / row['ms'] / 1e9:.1f} TFLOP/s of bf16 products;"
        f" yardstick torch.matmul bf16 [{n}, 256] @ [256, 256] (a trunk "
        f"layer): {mm_ms:.3f} ms, {2 * n * 256 * 256 / mm_ms / 1e9:.1f} "
        f"TFLOP/s (timed only)")
    del a, b, field_inputs

    _, warped, passes = step_inputs(system, batch, cfg, gen)
    # K6 bf16 on the step's three field passes too (held, not timed: the
    # row's time is the eval chunk's), and the bf16 weight packs of K6 and
    # K7, made on the card, against their twins bit for bit
    for label, (field, inputs) in passes.items():
        err, shapes = rows.verify(
            "fused_nerf_bf16",
            functools.partial(fused_mlp.fused_nerf_forward, field, *inputs),
            functools.partial(field, *inputs), BF16_FIELD_TOL)
        log(f"[bf16] K6 bf16 on the training pass {label}: shapes {shapes} "
            f"max_abs_err {err:.3e} (tol {BF16_FIELD_TOL:g}) -> ok")
    for kind in ("static", "dynamic"):
        field = getattr(system, f"nerf_{kind}")
        for kernel, make, plain in (
                ("K6", fused_mlp.pack_bf16, fused_mlp.pack_bf16_plain),
                ("K7", fused_mlp.pack_bf16_bwd, fused_mlp.pack_bf16_bwd_plain)):
            with torch.no_grad():
                pack, offsets = fused_mlp.pack_weights(field)
                wb = make(field, pack, offsets)
                same = torch.equal(wb, plain(field, pack, offsets)[0])
            if not same:
                raise AssertionError(f"{kernel}'s bf16 pack of the {kind} "
                                     f"field differs from its twin")
            log(f"[bf16] {kernel}'s bf16 weight pack, {kind} field: "
                f"{wb.numel()} elements, equal to its twin")
    with torch.no_grad():
        dyn_vol, _, _ = system.enc_dy(batch["nb_imgs"], batch["nb_proj_mats"],
                                      batch["near_fars"][0], pad=cfg.pad)
    check_field_backward(rows, "fused_nerf_backward_bf16", passes, gen,
                         BF16_FIELD_GRAD_TOL, paths,
                         "zest_tpu_torch/csrc/fused_mlp_tc_bwd.cu")
    row = rows.rows["fused_nerf_backward_bf16"]
    log(f"[bf16] K7 bf16 on the step's three passes: {row['ms']:.3f} ms, "
        f"{row['flops_bf16'] / row['ms'] / 1e9:.1f} TFLOP/s of bf16 products;"
        f" its twin (autograd through cuBLAS) {row['plain_ms']:.3f} ms")
    # K7's pass 1 recomputes K6's output rows bit for bit (the same device
    # code on the same bf16 pack)
    for label, (field, inputs) in passes.items():
        flat = [t.reshape(-1, t.shape[-1]).contiguous() for t in inputs]
        g = torch.randn((flat[0].shape[0], field.out_ch), generator=gen,
                        device=dev)
        with torch.no_grad():
            pack, offsets = fused_mlp.pack_weights(field)
            out = fused_mlp.fused_nerf_forward(field, *flat)
        again = torch.full_like(out, float("nan"))
        fused_mlp.fused_nerf_backward(field, *flat, g, pack, offsets,
                                      recomputed=again)
        if not torch.equal(again, out):
            raise AssertionError(f"K7's recomputed rows on {label} differ "
                                 f"from K6's output")
        log(f"[bf16] K7's recompute on the training pass {label}: "
            f"{out.shape[0]} rows equal to K6's output bit for bit")
        del g, out, again

    # K9 at the t±1 points: 8 corner rows each of the bf16 dynamic volume.
    # Bytes: the distinct rows the indices touch (16 each), the indices, the
    # output; the backward reads g and the indices and writes the table
    D, Hv, Wv, C = dyn_vol.shape
    tab = dyn_vol.to(torch.bfloat16).reshape(-1, C)
    idx, wts = trilinear_row_taps(warped * 2.0 - 1.0, D, Hv, Wv)
    idx = idx.contiguous()
    idx_flat = idx.reshape(-1)
    touched = int(torch.unique(idx_flat).numel())
    g = torch.randn((*idx.shape, C), generator=gen, device=dev).to(torch.bfloat16)
    log(f"[bf16] row gather: {idx.numel()} rows of {tab.shape[0]} "
        f"({touched} distinct), {tab.element_size() * C} bytes each")
    rows.check("row_gather", "zest_tpu_torch/csrc/row_gather.cu",
               "zest_tpu/kernels/dma_gather.py:69", "gather_rows",
               lambda: dma_gather.gather_rows(tab, idx),
               lambda: dma_gather.take_rows_plain(tab, idx),
               lambda: torch.index_select(tab, 0, idx_flat), 0.0, 20,
               16 * touched + nbytes(idx, g), 0, paths=paths)
    # the library side does the same work: a zero float32 table, the
    # scatter, one rounding to bf16 (g32 is made outside the timed call).
    # Atomics add in another order than index_add_, and both round the
    # float32 sum once: one bf16 rounding step of the largest
    m = tab.shape[0]
    g32 = g.reshape(-1, C).float()
    rows.check("row_gather_backward", "zest_tpu_torch/csrc/row_gather.cu",
               "zest_tpu/kernels/dma_gather.py:107", "scatter_rows",
               lambda: dma_gather.scatter_rows(g, idx, m),
               lambda: dma_gather.scatter_rows_plain(g, idx, m),
               lambda: torch.zeros((m, C), device=dev).index_add_(
                   0, idx_flat, g32).to(torch.bfloat16), 2.0 ** -8, 5,
               nbytes(g, idx, tab), g.numel(), relative=True, paths=paths)
    acc = torch.zeros((m, C), device=dev)
    bare_ms = cuda_ms(lambda: dma_gather.scatter_add_rows(acc, g, idx), 5)
    lib_ms = cuda_ms(lambda: acc.index_add_(0, idx_flat, g32), 5)
    log(f"[bf16] row scatter-add launch alone: kernel {bare_ms:.3f} ms, "
        f"index_add_ {lib_ms:.3f} ms (into a zeroed float32 table)")

    # the main path's own row cotangent: w * grad of the combine, so a corner
    # outside the volume carries a zero row onto a clamped edge row
    grad = torch.randn((*wts.shape[:-1], C), generator=gen, device=dev)
    g_path = (wts[..., None] * grad[..., None, :]).to(torch.bfloat16)
    zero = float((g_path == 0).all(-1).float().mean())
    err, _ = rows.verify("row_gather_backward",
                         lambda: dma_gather.scatter_rows(g_path, idx, m),
                         lambda: dma_gather.scatter_rows_plain(g_path, idx, m),
                         2.0 ** -8, relative=True)
    g_path32 = g_path.reshape(-1, C).float()
    path_ms = cuda_ms(lambda: dma_gather.scatter_rows(g_path, idx, m), 5)
    lib_path_ms = cuda_ms(lambda: torch.zeros((m, C), device=dev).index_add_(
        0, idx_flat, g_path32).to(torch.bfloat16), 5)
    log(f"[bf16] row scatter-add on the main path's cotangent ({zero:.1%} zero "
        f"rows): max_abs_err {err:.3e} (tol 2^-8 of the largest), kernel "
        f"{path_ms:.3f} ms, zeros + index_add_ + round {lib_path_ms:.3f} ms")
    del dyn_vol, passes, warped, tab, idx, g, g32, acc, wts, grad, g_path
    del g_path32
    torch.cuda.empty_cache()


def small_16(dev):
    """Phase 10: the small eval and training step at 16 bits on CUDA
    against the CPU. bf16 rounds in other places in cuDNN than on the CPU,
    so each quantity is held to twice the CPU's own difference between its
    16- and 32-bit runs (the eval maps and the logs; the gradients leaf by
    leaf for the fields, module by module for the encoders, whose leaves
    are bf16 noise), plus one bf16 rounding step (2^-8) of the value (maps
    and logs) or 1e-3 of the module's largest gradient."""
    from zest_tpu_torch import presets, sampling
    from zest_tpu_torch.system import EVAL_KEYS, phase_for_step

    def build(preset, on):
        return presets.build(preset, presets.SMALL_SCENE, on, SEED)

    maps = {}
    for key, preset, on in (("cuda", presets.SMALL_16, dev),
                            ("cpu", presets.SMALL_16, "cpu"),
                            ("cpu32", presets.SMALL, "cpu")):
        _, system, batch, params = build(preset, on)
        maps[key] = {k: v.cpu() for k, v in
                     system.make_eval_step()(params, batch).items()}
    for k in EVAL_KEYS:
        err = float((maps["cuda"][k] - maps["cpu"][k]).abs().max())
        spread = float((maps["cpu"][k] - maps["cpu32"][k]).abs().max())
        ok = err <= 2 * spread + 2.0 ** -8 * float(maps["cpu"][k].abs().max())
        log(f"[small-16] {k}: max_abs_err {err:.3e}, CPU 16-vs-32 {spread:.3e}"
            f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"small 16-bit eval {k}: CUDA and CPU differ "
                                 f"by {err}")

    cfg = build(presets.SMALL_TRAIN_16, "cpu")[0]
    chain_step = cfg.decay_iteration_clamped * 2000 + 1
    for step in (0, chain_step):
        phase = phase_for_step(cfg, step)
        runs = {}
        for key, preset, on in (("cuda", presets.SMALL_TRAIN_16, dev),
                                ("cpu", presets.SMALL_TRAIN_16, "cpu"),
                                ("cpu32", presets.SMALL_TRAIN, "cpu")):
            _, system, batch, params = build(preset, on)
            draws = sampling.sample_draws(
                torch.Generator().manual_seed(SEED + step), cfg, cfg.img_h,
                cfg.img_w, int(batch["motion_count"]), phase.extra_samples)
            _, logs, grads = system.loss_and_grads(
                params, batch, draws.to(on) if key == "cuda" else draws, phase,
                step)
            runs[key] = ({k: float(v) for k, v in logs.items()},
                         {k: v.cpu() for k, v in grads.items()})
        (logs_c, grads_c), (logs, grads), (logs32, grads32) = (
            runs["cuda"], runs["cpu"], runs["cpu32"])
        for k, v in logs.items():
            if not abs(logs_c[k] - v) <= 2 * abs(v - logs32[k]) + 2.0 ** -8 * abs(v):
                raise AssertionError(f"small 16-bit step {step} log {k}: CUDA "
                                     f"{logs_c[k]} CPU {v} (32-bit {logs32[k]})")
        if logs["train_loss"] == logs32["train_loss"]:
            raise AssertionError("the 16-bit step's loss equals the 32-bit one")
        scale, spread_m = {}, {}
        for k, v in grads.items():
            m = k.split(".")[0]
            scale[m] = max(scale.get(m, 0.0), float(v.abs().max()))
            spread_m[m] = max(spread_m.get(m, 0.0),
                              float((v - grads32[k]).abs().max()))
        worst = 0.0
        for k, v in grads.items():
            m = k.split(".")[0]
            err = float((grads_c[k] - v).abs().max())
            spread = (spread_m[m] if m.startswith("enc_")
                      else float((v - grads32[k]).abs().max()))
            limit = 2 * spread + 1e-3 * scale[m]
            worst = max(worst, err / limit)
            if err > limit:
                raise AssertionError(f"small 16-bit step {step} grad {k}: "
                                     f"differs by {err}, limit {limit}")
        log(f"[small-16] step {step}: loss {logs['train_loss']:.6f} (CUDA "
            f"{logs_c['train_loss']:.6f}, 32-bit {logs32['train_loss']:.6f}); "
            f"worst gradient difference {worst:.2f} of its limit")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = card()
    build()
    from zest_tpu_torch import presets
    cfg, system, batch, params = presets.build(presets.FLAGSHIP_TRAIN,
                                               presets.FLAGSHIP_SCENE, dev, SEED)
    rows = Rows()
    forward_kernels(rows, dev, cfg, system, batch)
    small_slice(dev)
    eval_launches, s_image = flagship(cfg, system, batch, params)
    backward_kernels(rows, dev, cfg, system, batch)
    small_train(dev)
    train_launches, rays_s = flagship_train(cfg, system, batch, params)
    del system, params
    torch.cuda.empty_cache()

    cfg16, system16, batch16, params16 = presets.build(
        presets.FLAGSHIP_TRAIN_16, presets.FLAGSHIP_SCENE, dev, SEED)
    bf16_kernels(rows, dev, cfg16, system16, batch16)
    small_16(dev)
    eval16, s_image16 = flagship(cfg16, system16, batch16, params16,
                                 "flagship-16")
    train16, rays_s16 = flagship_train(cfg16, system16, batch16, params16,
                                       "train-16")
    log(f"[summary] flagship eval s/image: float32 {s_image:.3f}, precision "
        f"16 {s_image16:.3f}; train_rays_per_sec: float32 {rays_s:.1f}, "
        f"precision 16 {rays_s16:.1f}")
    results = rows.finish({"eval": eval_launches, "train": train_launches,
                           "eval16": eval16, "train16": train16})
    for r in results:
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} never launched on the main path")
    banned = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "zest_tpu")]
    if banned:
        raise AssertionError(f"JAX or its package was imported: {banned[:5]}")
    log(smi)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
