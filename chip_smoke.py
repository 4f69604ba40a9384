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
   the one library call that computes the same function: by device time
   (the profiler's kernel durations) for K1, K3 and K8, whose kernels run
   under 1 ms, with CUDA events for K6; K3 must equal its twin bit for bit
   on the chunk.
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
   gradient), and times kernel, twin and library call (device time for K2,
   K4 and K5); K5 at the t±1 points, whose 4 lanes per point load its
   corner rows; holds K3 on the
   step's three lookups and times them there (device time), beside the
   same points taken as [n, 3]; holds K6 on the
   step's three float32 field passes, each beside a float64 twin. K7's
   float32 mode runs three launches per chunk on the tensor cores as
   3xTF32: the recompute (K6's float32 tile keeping the forward's values
   in a scratch), the input gradients and the weight gradients (pass 2).
   The three kernels' SASS must hold HMMA; every launch of the three
   passes is held to its twin (the recompute on the same inputs, the other
   two on the same scratch buffers) and timed beside it, the input
   gradients beside float32 ``torch.matmul`` of the same d_z W^T shapes
   and pass 2 beside that of the same X^T dZ shapes (their rows' library
   times, timed only). K7 takes its gradient at K6's forward: the
   recompute's output rows must equal K6's bit for bit and its forward
   values the twin's; every input and leaf must be within 1e-4 of its
   largest of the twin's backward at those values, and of the twin's own
   gradient on the points where both forwards take the same ReLU branches
   (the others, at most 0.5 % of the points or 5, are counted); and K7's input gradients and its weight
   gradients of the conditioning, trunk, feature and views layers must be
   within max(8 x the float32 twin's own norm-wise distance from a float64
   twin, 2^-20) of that float64 twin, all at K7's forward values;
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
   K9 and its backward are timed by device time, the backward against the
   same work by the library (zeros, ``index_add_``, one rounding) and, on a
   line of its own, its bare launch against bare ``index_add_``;
10. runs the small eval and training step at 16 bits on CUDA and on the CPU
    (each quantity within twice the CPU's own 16-vs-32 difference);
11. runs the flagship eval and training step at 16 bits, as phases 5 and 8
    do, asserting the launches (K9 forward and backward once per step-0
    step and twice per chain step, K5 never) and timing s/image and
    train_rays_per_sec beside the float32 ones;
12. quality: holds ``metrics.psnr`` and ``metrics.ssim`` on the card, on
    the flagship 16-bit eval image against its target, to the same
    functions in float64 on the CPU; then, with every launch counter reset,
    runs ``train_loop.run_training`` for ``LOOP_STEPS`` steps of the
    quality gate's configuration (``zest_tpu_torch.tools.quality_gate``,
    precision 16, logs every 10 steps) into a temporary directory, asserts
    that the loop launched every kernel of the 16-bit step exactly as many
    times as that many step-0 steps of phase 11 do (K1, K2, K3, K4, K6
    bf16, K7 bf16, K8, K9 and K9's backward), that ``metrics.csv`` holds
    one row per log step with a finite ``train_loss``, and runs
    ``validate`` on one image (finite val_PSNR and val_SSIM), printing the
    loop's seconds per step and the peak memory. PSNR after so few steps
    is not gated;
13. paths: restores the ``last`` checkpoint that phase 12's loop wrote, on
    the card and on the CPU (equal to the loop's final state), runs
    ``train_loop.run_test`` on 2 frames (test_metrics.txt) and
    ``render_paths.run_wanderpath`` on frame 3, 4 poses, at the gate's
    configuration (288x512, width 256, precision 16), asserting its 8 PNGs;
    then ``make_eval_path_step`` at float32 and at precision 16 on 4 poses
    (the target's own camera and orbit poses 15, 30, 45) with every launch
    counter reset: K1 launches as often as for one eval image, K3, K6 and
    K8 4 times as often, no backward kernel; the maps at the target's pose
    within rtol = atol = 1e-4 of ``make_eval_step``'s. It prints s/pose
    (the path's wall less one volume build, over the poses) beside the
    one-off cost of building the frame's volumes;
14. the paper's baselines and ablations (``presets.FAMILIES``: MVSNeRF's
    static field, NSFF without volumes, the static- and the
    dynamic-volume ablation): each small preset's eval and training step
    on CUDA against the CPU as phases 4, 7 and 10 hold them (16 bits where
    the preset has a volume); at MVSNeRF's flagship (288x544, 8 source
    views, one 4-output field, 4096 rays) K1, K2, K3, K4 and K8 held to
    their twins at its widths, K6 and K7 in the 4-output geometry in both
    modes under the gates of phases 3, 6 and 9 (its own rows in the JSON,
    ``*_mvsnerf``), and its eval and training step at float32 and precision
    16 with their launches, s/image and train_rays_per_sec; one flagship
    eval image and one training step of each other preset at float32, with
    their launches and peak memory;
15. SVS, the adversarial training of the ``svs_*`` files
    (``system_gan.GanSystem``, LPIPS on a seeded random ``.npz`` that the
    phase writes, ``presets.RANDOM_LPIPS``): the small GAN steps on CUDA
    against the CPU (GRAF at imsize 32 at float32 and at precision 16, the
    PatchGAN variant with the depth discriminator at float32), held as
    phases 7 and 10 hold theirs, the discriminators' gradients, their
    parameters after the step and the spectral ``u``s included; at the SVS
    flagship (``presets.FLAGSHIP_SVS``: MVSNeRF's generator, one 64x64 GRAF
    patch, the discriminator at imsize 64, LPIPS-AlexNet on the patch) at
    float32 and precision 16, with every launch counter reset, one step's
    launches equal to MVSNeRF's step-0 step's in phase 14 (the
    discriminators and LPIPS are cuDNN and cuBLAS), finite G_loss, D_loss
    and train_PSNR, the generator's and the discriminator's parameters and
    the ``u``s moved, train_rays_per_sec over TRAIN_STEPS steps after a
    warm-up, the peak memory, and the seconds of the generator's update,
    the discriminator's update and LPIPS's forward and backward on lines of
    their own; then ``run_training`` for SVS_LOOP_STEPS steps of
    ``config_svs_nsff_cross1.txt`` on the synthetic scene at precision 16
    (its launches SVS_LOOP_STEPS x one 16-bit SVS step's, the warning that
    the GAN ignores acc_grad), ``ckpts/last`` restored on the card equal to
    the loop's final state in all eight fields, and ``validate`` on one
    image with a finite val_LPIPS;
16. real data (``REAL_SCENES``: scenes written from a seed by
    ``tools.scene_fixtures`` in each loader's layout, since no real scene
    ships with the repository): the NSFF flagship file as written
    (``config_zest_fine_nsff_cross1.txt``, a 24-frame kid-running scene of
    1024x576 PNGs) trains REAL_STEPS steps of ``python -m
    zest_tpu_torch.train``'s ``main`` at precision 16 and at float32, each
    with its launches equal to REAL_STEPS step-0 steps of phase 11's / 8's
    kind, a finite train_loss and moved parameters in ``ckpts/last``; then
    ``test`` (every frame, its launches) and ``render_spiral --render_path
    wander`` (frames 3 and 4, REAL_POSES poses: K1 once per frame, K3, K6
    and K8 once per pose) from the 16-bit checkpoint, and the test split's
    load (TEST_LOADS samples); the loader's seconds per sample on each
    route (``ZEST_NATIVE_IO`` 1 and 0, the route it took and why) beside
    the flagship step of phases 8 and 11 and the loop's steps/s beside
    phase 12's. The LLFF file
    (``config_mvsnerf_llff.txt``, 20 views) trains LLFF_STEPS steps at
    precision 16 and renders its spiral and spheric paths (s/pose). DTU and
    Neural 3D Video: one test sample through ``build_datasets`` at the
    loader's own size and one MVSNeRF eval image at precision 16, launches
    checked. Every kernel of these paths is held to its twin at their own
    shapes, as phase 14 holds MVSNeRF's: on the LLFF training sample
    (640x960, pad 24, 1,024 rays, precision 16) K6 and K7 in the 4-output
    bf16 mode (rows ``*_llff``) and K1, K2, K3, K4 and K8 at the step's
    rays, K7 bf16 again on LLFF_HOLDS - 1 other training samples (other
    source views); on the DTU test sample (512x640) K1, K2, K3, K4 and K8
    at its first eval chunk's points and K6 on that chunk; Neural 3D Video's
    sample has LLFF's shapes (checked);
17. the three model options no configuration file sets (``options``):
    the v2 flagship (``presets.FLAGSHIP_V2``: the flagship's fields
    additive and plain) and the colour-volume flagship
    (``presets.FLAGSHIP_COLORVOL``) at float32 and precision 16, each
    eval image and its step-0 and chain steps with their launches (v2: no
    K6 or K7), s/image, train rays/s and peak memory; K3 on the 40-channel
    colour volume bit for bit equal to its twin on the first eval chunk
    and K3 at 8 channels timed on the same points, K4 on the step's static
    lookup (the gradient of its first 8 channels), K8 on the 2,703,360
    voxel centres (device time); the video mode on a Neural 3D Video scene
    written from a seed: VIDEO_STEPS steps of ``python -m
    zest_tpu_torch.train --train_video True`` at both precisions (launches,
    the trained time codes' rows moved in ``ckpts/last`` and no other, no
    [n, 1087] input on the card), ``run_test`` on one frame, the fold and
    its backward against their twins, K6 and K7 in the video geometry
    under the gates of phases 3, 6 and 9 (``video_kernels``);
18. the last modules (``aux_modules``), at the flagship's width and
    float32 (``presets.FLAGSHIP_TRAIN`` on ``FLAGSHIP_SCENE``): (a)
    ``utils.observability.profile_trace`` around one training step, whose
    Chrome trace must name K1's, K6's and K7's kernels, its launches
    checked and its peak memory from ``device_memory_stats``; (b)
    ``train_loop.run_test`` with ``vis_cnn`` on the target frame (K1 once
    more for the dump), every dumped tensor within 1e-4 x max(1, its
    largest |value|) of the same dump on the CPU and the same files; (c) a
    Lightning-layout ``.ckpt`` of the seeded weights in the reference's
    names through ``convert.convert_checkpoint`` (equal to the weights) and
    ``load_state_dict(strict=True)`` to an eval image, with phase 5's
    launches and its s/image; (d) the training step and an eval image
    split over two gloo ranks on the one card (``parallel.dryrun.
    run_ranks``; NCCL refuses two ranks on one device): the loss within
    rtol 1e-5 of the one-process step's, every gradient leaf within 1e-4
    of its largest, the image within 1e-4, each rank's launches (the step's
    at half the rays) and peak memory, and which leaves differ; (e) the
    SVS flagship step (``FLAGSHIP_SVS``) at float32 and at precision 16
    over the same two ranks (``_split_gan``): every log, every generator
    and discriminator gradient leaf and the ranks' states after the step
    against the one-process step, each rank's launches at 2,048 rays, its
    seconds and peak memory; (f) ``python -m
    zest_tpu_torch.parallel.dryrun 2``, which runs on the card.

The second-to-last line of stdout is a JSON object with one entry per kernel
(``timing``: "device" for the rows timed by the profiler's kernel durations,
K1-K5, K8, K9 and K9's backward; "events" for CUDA events; ``path_launches``:
its launches on every path run, one eval image or one step-0 step each);
the last line is
``{"ok": true, "device": {...}}``. Any failure raises, so the script exits
non-zero and prints no result; so does a machine without CUDA.
Nothing here imports JAX or the JAX package ``zest_tpu``: the configurations,
the synthetic scene and the seeded weights are the port's own
(``zest_tpu_torch.presets``).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
# K7 float32's forward values (K6's) against the float32 twin's, norm-wise
F32_VALUE_NORM = 1e-5
# points at which K6's forward takes another ReLU branch than the twin's:
# at most this share of a pass (~1 in 1,400 seen on flagship passes), or
# F32_FLIPPED_FLOOR points
F32_FLIPPED_SHARE = 0.005
F32_FLIPPED_FLOOR = 5
# K7 float32's pass 2 against its twin, each output sum_i x_i d_i of a chunk:
# 1e-4 of its leaf's largest plus this share of its terms' magnitude
# sum_i |x_i d_i|, one float32 rounding of that (a chunk's alpha-head bias
# sums cancel to ~1 from ~1e4 and read up to 2.1e-4 of their largest;
# leaving out one point's term moves an output by ~256x as much)
F32_SUM_ROUNDING = 2.0 ** -24
TRAIN_STEPS = 5              # timed flagship training steps, after warm-up
LOOP_STEPS = 40              # training loop steps of the quality phase
SVS_LOOP_STEPS = 10          # training loop steps of the SVS phase
# metrics on the card (float32) against float64 on the CPU: PSNR relative;
# SSIM of its range's bound (float32's E[x^2] - mu^2 cancels: 2e-5 relative,
# 8e-6 absolute, from float64 on a noisy flagship-size image on the CPU)
METRIC_PSNR_RTOL = 1e-5
METRIC_SSIM_ATOL = 5e-5
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
    log("[build] input_grads_tc32_kernel dynamic shared memory per block: "
        + ", ".join(f"width {w} {lib.zt_fused_nerf_input_grads_tc32_smem(w)} "
                    f"bytes" for w in (64, 128, 256)))


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


def device_ms(fn) -> float:
    """Device time of fn() per call: the profiler's kernel durations
    (``probe_trilinear.device_ms``), with the events it missed logged. Rows
    whose kernel runs under 1 ms take
    it: there a wrapper's host side takes about as long as the kernel, and
    CUDA events around a loop of calls time the host. Where the profiler
    records no usable events for fn, the time is ``queued_ms``'s (CUDA
    events around calls queued behind a spin kernel), logged, and
    ``device_ms.stand_in`` is True until the next call."""
    from zest_tpu_torch.tools.probe_trilinear import LAUNCHES, queued_ms
    from zest_tpu_torch.tools.probe_trilinear import device_ms as profiled
    device_ms.stand_in = False
    try:
        ms = profiled(fn)
    except RuntimeError as err:
        ms = queued_ms(fn)
        device_ms.stand_in = True
        device_ms.stand_ins += 1
        log(f"[device_ms] {err}; timed instead by CUDA events around "
            f"{LAUNCHES} calls queued behind a spin kernel: {ms:.4f} ms "
            + ("(queued whole)" if queued_ms.queued
               else "(NOT queued whole: the host's time is in it)"))
        return ms
    if profiled.lost:
        log(f"[device_ms] device events the profiler missed over {LAUNCHES} "
            f"calls, by kernel: {profiled.lost}")
    return ms


device_ms.stand_in = False
device_ms.stand_ins = 0


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
                                        plane_sweep, time_codes, trilinear)
    return {"homo_warp_cm": plane_sweep.homo_warp_cm,
            "homo_warp_cm_grad": plane_sweep.homo_warp_cm_grad,
            "sample_volume": trilinear.sample_volume,
            "volume_grad": trilinear.volume_grad,
            "coords_grad": trilinear.coords_grad,
            "gather_colors": color_gather.gather_colors,
            "fused_nerf_forward": fused_mlp.fused_nerf_forward,
            "fused_nerf_backward": fused_mlp.fused_nerf_backward,
            "recompute": fused_mlp.recompute,
            "input_grads": fused_mlp.input_grads,
            "weight_grads": fused_mlp.weight_grads,
            "gather_rows": dma_gather.gather_rows,
            "scatter_rows": dma_gather.scatter_rows,
            "fold_codes": time_codes.fold_codes,
            "fold_codes_grad": time_codes.fold_codes_grad}


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
              paths=("eval", "train"), verified=None, flops_tf32=0,
              timing="events"):
        """``verify``, then time kern, plain and library; flops count
        float32 operations, flops_bf16 those on bf16 operands, flops_tf32
        those on TF32 operands; paths names the runs whose launches the row
        reports (eval first); verified, if given, is the (error, shapes) of
        a check the caller made instead of ``verify``; timing "events" times
        the three with ``cuda_ms`` over iters calls, "device" (kernels under
        1 ms) with ``device_ms``."""
        err, shapes = verified or self.verify(name, kern, plain, tol,
                                              relative)
        timer = {"events": functools.partial(cuda_ms, iters=iters),
                 "device": device_ms}[timing]
        stand_ins = []

        def timed(key, fn):
            t = timer(fn)
            if timing == "device" and device_ms.stand_in:
                stand_ins.append(key)
            return t

        with torch.no_grad():
            ms = timed("ms", kern)
            plain_ms = timed("plain_ms", plain)
            lib_ms = (timed("library_ms", library) if library is not None
                      else None)
        bound_ms = 1e3 * max(moved_bytes / HBM_BYTES_PER_S,
                             ops_seconds(flops, flops_bf16, flops_tf32))
        log(f"[kernel] {name}: shapes {shapes} max_abs_err {err:.3e} "
            f"(tol {tol:g}) kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"library {'-' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
            f"{bound_ms:.3f} ms ({timing} time) -> ok")
        row = self.rows.setdefault(name, dict(
            name=name, route="cuda", source=source, replaces=replaces,
            counter=counter, timing=timing, max_abs_err=0.0, ms=0.0,
            plain_ms=0.0, bytes=0, flops=0, flops_bf16=0, flops_tf32=0,
            paths=paths, library_ms=0.0 if library is not None else None))
        for key in stand_ins:
            if key not in row.setdefault("queued_ms_for", []):
                row["queued_ms_for"].append(key)
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
        training step, ``path_launches`` its count on every path run (one
        eval image or one step-0 step each). ``launches`` maps each path
        name to its counts."""
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
                path_launches={p: n[c] for p, n in launches.items()},
                max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=max(b_ms, o_ms),
                bound_by="bytes" if b_ms >= o_ms else "operations",
                library_ms=r["library_ms"], timing=r["timing"],
                **({"queued_ms_for": r["queued_ms_for"]}
                   if "queued_ms_for" in r else {})))
        return rows


def field_ops(field, n: int, passes: int, tf32: bool) -> tuple:
    """(float32, bf16-operand, TF32-operand) operations of `passes` products
    per weight on n points: one multiply-add per weight and point in each
    product. Where the products run on the tensor cores only the heads keep
    float32 operands: the bf16-operand mode's products take bf16 operands,
    the float32 mode's, with tf32 set (K6 and every launch of K7), three
    TF32 products each (3xTF32)."""
    macs = sum(m.weight.numel() for m in field.modules()
               if isinstance(m, torch.nn.Linear))
    if not (field.bf16 or tf32):
        return 2 * passes * n * macs, 0, 0
    heads = [field.alpha_linear, field.rgb_linear]
    heads += [lin for lin, _ in field.extra_heads()]
    head = sum(m.weight.numel() for m in heads)
    products = 2 * passes * n * (macs - head)
    if field.bf16:
        return 2 * passes * n * head, products, 0
    return 2 * passes * n * head, 0, 3 * products


def chunk_inputs(system, batch):
    """The first chunk's rays of the flagship eval and the fields' inputs on
    them, as ``render_rays`` builds them ([16384, 128, ch]); the dynamic
    field's where the system has one."""
    from zest_tpu_torch import render
    with torch.no_grad():
        models = system.render_models(batch)
        rays = system.chunk_rays(batch, 0)
        kw = system.render_kwargs(batch)
        inputs = {"static": render.static_field_inputs(models, rays,
                                                       kw["im_w2c_ref"])}
        if system.nerf_dynamic is not None:
            inputs["dynamic"] = render.dynamic_field_inputs(
                models, rays, kw["nb_w2c_ref"], kw["ref_frame_idx"])
        return rays, inputs


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
    by label, as ``render_rays_train`` builds them; without a dynamic field
    (no t±1 points: None) the static pass alone."""
    from zest_tpu_torch import render, sampling
    from zest_tpu_torch.kernels import fused_mlp
    from zest_tpu_torch.system import phase_for_step
    phase = phase_for_step(cfg, 0)
    draws = sampling.sample_draws(gen, cfg, cfg.img_h, cfg.img_w,
                                  int(batch.get("motion_count", 1)),
                                  phase.extra_samples)
    with torch.no_grad():
        models = system.render_models(batch)
        rays = system.train_rays(batch, draws, phase)
        kw = system.render_kwargs(batch)
        st_in = render.static_field_inputs(models, rays, kw["im_w2c_ref"])
        if system.nerf_dynamic is None:
            return rays, None, {"static": (system.nerf_static, st_in)}
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
                     field.static, bf16=field.bf16,
                     sceneflow=field.n_extra > 0, use_mvs=field.use_mvs,
                     net_type=field.net_type, code_dim=field.code_dim).to(
                         next(field.parameters()).device)
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


def hold_bf16_backward(name, label, field, flat, g, pack, offsets,
                       float64_gate=False):
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

    With ``float64_gate`` the first gate's norm-wise and leaf-peak bounds
    hold K7 to the float64 twin instead of the twin, each within its bound
    plus the twin's own distance from float64 (what the bound against the
    twin implies, by the triangle inequality): where the twin's bf16 sums
    are themselves 2^-8 from float64 (the 4-output field at MVSNeRF's
    inputs: 1e-2 on the first trunk layers), a K7 nearer float64 than the
    twin could fail the bound against the twin. The rows beyond
    BF16_FIELD_GRAD_TOL and the second gate are unchanged.

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
        norm_tol, peak_tol, ref = BF16_FIELD_GRAD_TOL, BF16_LEAF_PEAK, "twin"
        if float64_gate:
            (norm, peak), ref = to_exact[leaf], "float64 twin"
            norm_tol += twin_exact[leaf][0]
            peak_tol += twin_exact[leaf][1]
        if not norm <= norm_tol:
            failures.append(f"{leaf} {norm:.3e} norm-wise from the {ref} "
                            f"(tol {norm_tol:.3e})")
        if not (leaf.startswith("d_") or peak <= peak_tol):
            failures.append(f"{leaf} {peak:.3e} of its largest from the "
                            f"{ref} (tol {peak_tol:.3e})")
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


def hold_float32_backward(rows, name, label, field, flat, g, pack, offsets,
                          paths=("eval", "train"), suffix=""):
    """K7's float32 mode on one pass, with a spy on each of its three
    launches per chunk (``fused_mlp.recompute``, ``input_grads``,
    ``weight_grads``): each is held to its twin, every output to 1e-4 of its
    largest (the recompute on the chunk's inputs: ``recompute_plain``; the
    other two on the same scratch buffers: ``input_grads_plain``,
    ``weight_grads_plain``), and timed beside it (rows
    ``fused_nerf_recompute``, ``fused_nerf_input_grads``,
    ``fused_nerf_weight_grads``); the input gradients beside float32
    ``torch.matmul`` of the same d_z W^T shapes, pass 2 beside that of the
    same X^T dZ shapes. Then the whole backward is held as
    ``hold_at_own_forward`` says. ``suffix`` follows the rows' names, whose
    launches are read on ``paths``. Returns its largest error."""
    from zest_tpu_torch.kernels import fused_mlp
    real = (fused_mlp.recompute, fused_mlp.input_grads, fused_mlp.weight_grads)
    src = "zest_tpu_torch/csrc/"
    replaces = "zest_tpu/kernels/fused_mlp.py:398"
    depth = len(field.pts_linears)

    def recompute(field, pts, feats, views, g, pack, offsets, wt, bufs,
                  out=None):
        real[0](field, pts, feats, views, g, pack, offsets, wt, bufs, out)
        kept = [bufs[k] for k in fused_mlp._KEPT]

        def kern():
            real[0](field, pts, feats, views, g, pack, offsets, wt, bufs)
            return tuple(kept)

        def plain():
            ref = fused_mlp.recompute_plain(field, pts, feats, views, g)
            return tuple(ref[k] for k in fused_mlp._KEPT)

        n = pts.shape[0]
        f32_ops, _, tf32_ops = field_ops(field, n, 1, True)
        rows.check("fused_nerf_recompute" + suffix, src + "fused_mlp_tc32.cu",
                   replaces, "recompute", kern, plain, None, 1e-4, 3,
                   nbytes(pts, feats, views, g, *kept) + nbytes(pack, wt),
                   f32_ops, relative=True, flops_tf32=tf32_ops, paths=paths)

    def input_grads(field, bufs, pack, offsets, *d_in):
        real[1](field, bufs, pack, offsets, *d_in)
        outs = [*d_in, *(bufs[k] for k in fused_mlp._DZ)]

        def kern():
            real[1](field, bufs, pack, offsets, *d_in)
            return tuple(outs)

        def plain():
            ref = fused_mlp.input_grads_plain(field, bufs)
            return tuple(ref[k] for k in (*fused_mlp._INPUTS, *fused_mlp._DZ))

        # the products d_x = d_z @ W of the views, feature, trunk and
        # conditioning layers, each with its output gradient
        ds = [bufs["d_hv"], bufs["d_feature"], *bufs["dz"], bufs["d_cond"]]
        ws = [field.views_linears[0].weight, field.feature_linear.weight,
              *(lin.weight for lin in field.pts_linears),
              field.pts_bias.weight]
        ws = [w.detach() for w in ws]
        n = d_in[0].shape[0]
        f32_ops, _, tf32_ops = field_ops(field, n, 1, True)
        reads = [bufs[k] for k in ("cond", "z", "hv", "g_heads")]
        rows.check("fused_nerf_input_grads" + suffix,
                   src + "fused_mlp_tc32_dx.cu", replaces, "input_grads", kern,
                   plain, lambda: [torch.matmul(d, w) for d, w in zip(ds, ws)],
                   1e-4, 3, nbytes(*reads, *outs) + nbytes(pack), f32_ops,
                   relative=True, flops_tf32=tf32_ops, paths=paths)

    def weight_grads(field, pts, feats, views, bufs, offsets, d_pack):
        real[2](field, pts, feats, views, bufs, offsets, d_pack)
        out = torch.zeros_like(d_pack)

        def leaves(d):
            return tuple(t for _, t in fused_mlp.pack_leaves(field, d, offsets))

        def kern():
            out.zero_()
            real[2](field, pts, feats, views, bufs, offsets, out)
            return leaves(out)

        with torch.no_grad():
            verified = hold_weight_grads(
                suffix, [k for k, _ in fused_mlp.pack_leaves(field, d_pack,
                                                             offsets)],
                kern(),
                leaves(fused_mlp.weight_grads_plain(field, pts, feats, views,
                                                    bufs)),
                leaves(fused_mlp.weight_grads_plain(
                    field, pts.abs(), feats.abs(), views.abs(),
                    {k: v if k in ("cond", "z") else v.abs()
                     for k, v in bufs.items()})))
        cond, z, dz = bufs["cond"], bufs["z"], bufs["dz"]
        h = [torch.relu(zi * cond) for zi in z]
        xs = [feats, pts] + [torch.cat([pts, h[i - 1]], -1)
                             if i - 1 in field.skips else h[i - 1]
                             for i in range(1, len(z))]
        xs += [h[-1], torch.cat([bufs["feature"], views], -1)]
        ds = [bufs["d_cond"], *dz, bufs["d_feature"], bufs["d_hv"]]
        n = pts.shape[0]
        f32_ops, _, tf32_ops = field_ops(field, n, 1, True)
        rows.check("fused_nerf_weight_grads" + suffix,
                   src + "fused_mlp_tc32_bwd.cu", replaces, "weight_grads", kern,
                   lambda: leaves(fused_mlp.weight_grads_plain(
                       field, pts, feats, views, bufs)),
                   lambda: [torch.matmul(x.T, d) for x, d in zip(xs, ds)],
                   1e-4, 3, nbytes(pts, feats, views, *bufs.values())
                   + nbytes(d_pack), f32_ops, relative=True,
                   flops_tf32=tf32_ops, paths=paths, verified=verified)

    held = (recompute, input_grads, weight_grads)
    for fn in held:
        fn.launches = 0                # the wrappers count on their own names
        setattr(fused_mlp, fn.__name__, fn)
    saved = {}
    try:
        got = fused_mlp.fused_nerf_backward(field, *flat, g, pack, offsets,
                                            saved=saved)
    finally:
        for fn, orig in zip(held, real):
            setattr(fused_mlp, fn.__name__, orig)
    return hold_at_own_forward(name, label, field, flat, g, pack, offsets,
                               got, saved)


def hold_weight_grads(suffix, names, got, twin, magnitude) -> tuple:
    """K7 float32's pass 2 on one chunk (``got``, its leaves by ``names``)
    against the twin's: each output within 1e-4 of its leaf's largest plus
    F32_SUM_ROUNDING of its terms' magnitude (``magnitude``: the twin's sums
    of |x_i d_i|, leaf by leaf). Logs the leaf nearest its limit and the
    one nearest 1e-4 of its largest alone; raises naming each leaf over
    its limit. Returns (the largest error, the leaves' shapes), as
    ``Rows.verify`` does."""
    err, near, near_plain, failures = 0.0, (0.0, ""), (0.0, ""), []
    for name, a, b, m in zip(names, got, twin, magnitude):
        e = (a - b).abs()
        top = float(b.abs().max())
        share = float((e / (1e-4 * top + F32_SUM_ROUNDING * m)).max())
        plain = float(e.max()) / max(top, 1e-30)
        err = max(err, float(e.max()))
        near = max(near, (share, name))
        near_plain = max(near_plain, (plain, name))
        if not (bool(torch.isfinite(a).all()) and share <= 1.0):
            failures.append(f"{name} at {share:.3f} of its limit "
                            f"({plain:.3e} of its largest)")
    log(f"[backward] fused_nerf_weight_grads{suffix} chunk: nearest its "
        f"limit {near[1]} {near[0]:.3f}; nearest 1e-4 of its largest alone "
        f"{near_plain[1]} {near_plain[0]:.3e}")
    if failures:
        raise AssertionError(f"fused_nerf_weight_grads{suffix} disagrees "
                             f"with its twin: " + "; ".join(failures))
    return err, [tuple(t.shape) for t in twin]


def hold_at_own_forward(name, label, field, flat, g, pack, offsets, got,
                        saved):
    """K7 float32's gradients ``got`` on one pass, taken at K6's forward
    (the values in ``saved``), held four ways:

    1. the recomputed output rows equal K6's bit for bit, and every forward
       value K7 ran at (cond, each z_i, the feature layer's output, hv) is
       within F32_VALUE_NORM norm-wise and 1e-4 of its largest of the
       twin's forward (each one's distance from a float64 twin's forward is
       logged beside the twin's own);
    2. d_pts, d_feats, d_views and every leaf of d_pack within 1e-4 of its
       largest against the twin's backward at those forward values
       (``fused_nerf_backward_at_plain``);
    3. the float64 gate at those values: d_pts, d_feats, d_views and each
       weight gradient of the conditioning, trunk, feature and views layers
       within max(F32_CLASS_FACTOR x the float32 twin's distance,
       F32_CLASS_FLOOR) of the float64 twin's backward at the same values;
    4. against the twin's gradient at its own forward (cuBLAS's), 1e-4 of
       each input's and leaf's largest, on the points where K6's forward and
       the twin's take the same ReLU branches everywhere (``branch_rows``):
       K7 runs on those points alone, the twin's backward at its forward
       values of the whole pass, restricted to them. At the other points a
       gradient taken at one forward is not the gradient at the other; they
       are counted, and may be at most max(F32_FLIPPED_FLOOR,
       F32_FLIPPED_SHARE of the points).

    Returns the largest error of check 4, of its reference's largest."""
    from zest_tpu_torch.kernels import fused_mlp

    def leafwise(fld, grads):
        return list(grads[:3]) + [t for _, t in fused_mlp.pack_leaves(
            fld, grads[3], offsets)]

    def dist(a, b):
        return float((a.double() - b).norm()) / max(float(b.norm()), 1e-300)

    def peak(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    names = [*fused_mlp._INPUTS] + [k for k, _ in fused_mlp.pack_leaves(
        field, got[3], offsets)]
    layers = {f"{n}.weight" for n, m in field.named_modules()
              if m in (field.pts_bias, *field.pts_linears,
                       field.feature_linear, field.views_linears[0])}
    failures = []
    wide = float64_twin(field)
    flat64 = [t.double() for t in flat]
    with torch.no_grad():
        same = torch.equal(saved["out"],
                           fused_mlp.fused_nerf_forward(field, *flat))
        fwd = fused_mlp.forward_values_plain(field, *flat)
        fwd64 = fused_mlp.forward_values_plain(wide, *flat64)
    if not same:
        failures.append("the recomputed rows differ from K6's")
    values = [("cond", saved["cond"], fwd["cond"], fwd64["cond"]),
              ("feature", saved["feature"], fwd["feature"], fwd64["feature"]),
              ("hv", saved["hv"], fwd["hv"], fwd64["hv"])]
    values += [(f"z{i}", a, b, c) for i, (a, b, c) in enumerate(zip(
        saved["z"], fwd["z"], fwd64["z"]))]
    log(f"[backward] {name} {label}: the forward values K7 ran at, "
        f"norm-wise / largest error of the largest from the twin's | "
        f"norm-wise from float64: K7 (K6's forward) | the twin")
    for what, a, b, c in values:
        to_twin, top = dist(a, b), peak(a, b)
        log(f"[backward]   {what}: {to_twin:.2e} / {top:.2e} | "
            f"{dist(a, c):.3e} | {dist(b, c):.3e}")
        if not (to_twin <= F32_VALUE_NORM and top <= 1e-4):
            failures.append(f"forward value {what} {to_twin:.3e} norm-wise, "
                            f"{top:.3e} of its largest from the twin's")
    flipped = fused_mlp.branch_rows(saved, fwd)
    n = flat[0].shape[0]
    limit = max(F32_FLIPPED_FLOOR, F32_FLIPPED_SHARE * n)
    if not int(flipped.sum()) <= limit:
        failures.append(f"{int(flipped.sum())} of {n} points take another "
                        f"ReLU branch than the twin's forward, limit {limit}")
    del fwd64, values

    # 2 and 3: at K7's own forward values
    with torch.no_grad():
        at = leafwise(field, fused_mlp.fused_nerf_backward_at_plain(
            field, saved, *flat, g))
        saved64 = {k: ([t.double() for t in v] if k == "z" else v.double())
                   for k, v in saved.items()}
        at64 = leafwise(wide, fused_mlp.fused_nerf_backward_at_plain(
            wide, saved64, *flat64, g.double()))
    del saved64
    k7 = leafwise(field, got)
    at_err = 0.0
    log(f"[backward] {name} {label}: at K7's own forward values, per input "
        f"and leaf: largest error of the largest against the twin's "
        f"backward there | norm-wise from float64 there: K7 | the twin")
    for leaf, a, b, c in zip(names, k7, at, at64):
        e = peak(a, b)
        at_err = max(at_err, e)
        if not e <= 1e-4:
            failures.append(f"{leaf} {e:.3e} of its largest from the twin's "
                            f"backward at K7's forward values")
        if leaf.startswith("d_") or leaf in layers:
            mine, own = dist(a, c), dist(b, c)
            limit = max(F32_CLASS_FACTOR * own, F32_CLASS_FLOOR)
            log(f"[backward]   {leaf}: {e:.2e} | {mine:.3e} | {own:.3e} "
                f"(limit {limit:.3e})")
            if not mine <= limit:
                failures.append(f"{leaf} {mine:.3e} from float64 at K7's "
                                f"forward values, limit {limit:.3e}")
    del at, at64, k7

    # 4: the twin's gradient where both forwards take the same branches
    keep = ~flipped
    sub = [t[keep].contiguous() for t in (*flat, g)]
    mine = leafwise(field, fused_mlp.fused_nerf_backward(field, *sub, pack,
                                                         offsets))
    with torch.no_grad():
        twin = leafwise(field, fused_mlp.fused_nerf_backward_at_plain(
            field, fused_mlp.kept_rows(fwd, keep), *sub))
    del fwd
    err = 0.0
    for leaf, a, b in zip(names, mine, twin):
        e = peak(a, b)
        err = max(err, e)
        if not (bool(torch.isfinite(a).all()) and e <= 1e-4):
            failures.append(f"{leaf} {e:.3e} of its largest from the twin's "
                            f"gradient where the branches agree")
    log(f"[backward] {name} {label}: recomputed rows equal K6's: {same}; "
        f"against the twin's backward at K7's forward "
        f"values, largest error {at_err:.3e} of the largest (tol 1e-4); "
        f"points where K6's forward and the twin's take another ReLU branch "
        f"{int(flipped.sum())} of {n}; on the other {int(keep.sum())} against "
        f"the twin's gradient at its own forward, largest error {err:.3e} of "
        f"the largest (tol 1e-4)")
    del mine, twin, sub, wide
    field.zero_grad(set_to_none=True)
    if failures:
        raise AssertionError(f"{name} {label}: " + "; ".join(failures))
    return err


def check_field_backward(rows, name, passes, gen, tol, paths,
                         source="zest_tpu_torch/csrc/fused_mlp_tc32_dx.cu",
                         suffix="", float64_gate=False):
    """K7 on the step's field passes, with a random output gradient, held as
    ``hold_float32_backward`` and ``hold_bf16_backward`` hold each mode
    (every input and leaf of d_pack at float32 to 1e-4 of its largest). The
    time is the default chunks' against the twin's autograd. ``suffix``
    names the float32 mode's rows of its three launches; ``float64_gate``
    goes to ``hold_bf16_backward``."""
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
        # three passes of products: the recompute, the input and the weight
        # gradients (bf16 operands, or 3xTF32)
        f32_ops, bf16_ops, tf32_ops = field_ops(field, n, 3, not field.bf16)
        log(f"[backward] {name} {label}: {n} points")
        kern = lambda: leafwise(field, offsets, fused_mlp.fused_nerf_backward(
            field, *flat, g, pack, offsets))
        plain = lambda: leafwise(field, offsets,
                                 fused_mlp.fused_nerf_backward_plain(
                                     field, *flat, g))
        hold = functools.partial(
            hold_bf16_backward, float64_gate=float64_gate) if field.bf16 \
            else functools.partial(hold_float32_backward, rows, paths=paths,
                                   suffix=suffix)
        err = hold(name, label, field, flat, g, pack, offsets)
        verified = (err, [tuple(t.shape) for t in flat])
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
               8 * D * 35 * Hp * Wp, timing="device")

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
               + 32 * n, 128 * n, timing="device")
    # each point's arithmetic is F.grid_sample's: bit for bit
    with torch.no_grad():
        same = torch.equal(sample_volume(vol, ndc), sample_volume_plain(vol, ndc))
    log(f"[kernel] trilinear_sample on the eval chunk bitwise equal to its "
        f"twin: {same}")
    if not same:
        raise AssertionError("K3 differs from its twin on the eval chunk")

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
               + 12 * xy.shape[0] * xy.shape[1], 24 * xy.shape[0] * xy.shape[1],
               timing="device")

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


def small_slice(dev, preset=None, tag="small"):
    """Phase 4: the eval step at the small preset (``presets.SMALL`` by
    default) on CUDA against the same step on the CPU."""
    from zest_tpu_torch import presets
    preset = presets.SMALL if preset is None else preset
    _, system, batch, params = presets.build(preset, presets.SMALL_SCENE,
                                             "cpu", SEED)
    step = system.make_eval_step()
    ref = step(params, batch)
    out = step({k: v.to(dev) for k, v in params.items()},
               {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    # cuDNN and the CPU sum the convolutions in different orders; the maps
    # are O(1) composites of 16 samples
    rtol, atol = 1e-4, 1e-4
    for k in system.eval_keys:
        a, b = out[k].cpu(), ref[k]
        err = float((a - b).abs().max())
        ok = torch.allclose(a, b, rtol=rtol, atol=atol)
        log(f"[{tag}] {k}: max_abs_err {err:.3e} spread {float(b.std()):.3e} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} slice {k}: CUDA and CPU differ by "
                                 f"{err}")
    if float(ref[blended(system)].std()) <= 1e-3:
        raise AssertionError(f"{tag} slice renders a constant image")


def blended(system) -> str:
    """The eval map a user sees: the blend of both fields, or the static
    field's alone without scene flow."""
    return "rgb_map_ref" if system.nerf_dynamic is not None else "rgb_map"


def _video_fused(system) -> bool:
    """The static field takes a time code and runs the fused kernels: the
    fold runs once per field call."""
    return system.cfg.train_video and system.nerf_static.fused


def expected_eval_launches(system, batch) -> dict:
    """The launches of one eval image: K1 once per source view of the static
    volume, K3 and K8 once per chunk for each volume, K6 once per chunk for
    each v0 field conditioned on a volume, no backward kernel (at the
    batch's image size). With the colour volume K8 runs once per image on
    the voxel centres instead of per chunk for the static field; with time
    codes the fold runs once per chunk."""
    _, H, W, _ = batch["images"].shape
    n_chunks = -(-(H * W) // system._chunk(H, W))
    vols = (system.enc_static is not None) + (system.enc_dy is not None)
    fused = sum(f is not None and f.fused
                for f in (system.nerf_static, system.nerf_dynamic))
    colors = vols * n_chunks
    if system.enc_static is not None and system.cfg.use_color_volume:
        colors += 1 - n_chunks
    expected = dict.fromkeys(counters(), 0)
    expected.update(
        homo_warp_cm=(batch["images"].shape[0] - 2
                      if system.enc_static is not None else 0),
        sample_volume=vols * n_chunks, gather_colors=colors,
        fused_nerf_forward=fused * n_chunks,
        fold_codes=n_chunks if _video_fused(system) else 0)
    return expected


def flagship(cfg, system, batch, params, tag="flagship", runs=3):
    """Phases 5 and 11 (and 14's presets): the flagship eval step with every
    launch counter reset first, then ``runs`` timed runs with the input
    changed. Returns (launches, median s/image; the first run's without
    timed runs)."""
    step = system.make_eval_step()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    maps = step(params, batch)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = read_counters()
    H, W = cfg.img_h, cfg.img_w
    expected = expected_eval_launches(system, batch)
    log(f"[{tag}] first run {first:.2f} s, launches {launches}")
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    for k in system.eval_keys:
        v = maps[k]
        if v.shape[:2] != (H, W) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"flagship {k}: shape {tuple(v.shape)} or "
                                 f"non-finite values")
        log(f"[{tag}] {k}: shape {tuple(v.shape)} mean {float(v.mean()):.4f}"
            f" std {float(v.std()):.4f}")
    key = blended(system)
    if float(maps[key].std()) <= 0.0:
        raise AssertionError(f"flagship {key} is constant")

    times = []
    prev = float(maps[key][0, 0, 0])
    for _ in range(runs):
        b2 = dict(batch, images=batch["images"] + (prev % 1.0) * 1e-6)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps = step(params, b2)
        prev = float(maps[key][0, 0, 0])              # waits for the device
        times.append(time.perf_counter() - t0)
    log(f"[{tag}] s/image over {len(times)} runs: "
        + ", ".join(f"{t:.3f}" for t in times)
        + f" (median {float(np.median(times or [first])):.3f}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, float(np.median(times or [first]))


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

    # K7: the field backward on the three passes of a step; at float32 its
    # three launches per chunk run on the tensor cores
    for kernel, count in (("recompute_tc32_kernel", 3),
                          ("input_grads_tc32_kernel", 3),
                          ("wgrad_tc32_kernel", 1)):
        mma = sass_has_mma(kernel)
        log(f"[backward] tensor-core instructions (HMMA / HGMMA) per "
            f"instantiation of {kernel}: {sorted(mma.values())}")
        if len(mma) != count or min(mma.values()) == 0:
            raise AssertionError(f"{kernel} without HMMA: {mma}")
    check_field_backward(rows, "fused_nerf_backward", passes, gen, 1e-4,
                         ("eval", "train"))
    for what, kernel, yardstick in (
            ("pass 1, the recompute", "fused_nerf_recompute", None),
            ("pass 1, the input gradients", "fused_nerf_input_grads",
             "d_z W^T"),
            ("pass 2", "fused_nerf_weight_grads", "X^T dZ")):
        row = rows.rows[kernel]
        useful = row["flops_tf32"] / 3
        lib = ("" if yardstick is None else
               f"; yardstick torch.matmul float32 of the same {yardstick} "
               f"shapes (TF32 off): {row['library_ms']:.3f} ms, "
               f"{useful / row['library_ms'] / 1e9:.1f} TFLOP/s (timed only)")
        log(f"[backward] K7 float32 {what} on the step's three passes: "
            f"{row['ms']:.3f} ms, {useful / row['ms'] / 1e9:.1f} TFLOP/s of "
            f"float32 products ({3 * useful / row['ms'] / 1e9:.1f} TFLOP/s of "
            f"TF32 products, 3xTF32); its twin {row['plain_ms']:.3f} ms{lib}")
    log(f"[backward] K7 float32 in all "
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
                   nbytes(ndc, g, vol), 128 * n, relative=True, timing="device")
        if label == "t-1 / t+1":
            rows.check("trilinear_grad_coords", "zest_tpu_torch/csrc/trilinear.cu",
                       "zest_tpu/kernels/trilinear.py:353", "coords_grad",
                       lambda: trilinear.coords_grad(vol, ndc, g),
                       lambda: trilinear.sample_volume_grads_plain(vol, ndc, g)[1],
                       lambda: lib([False, True]), 1e-5, 5,
                       32 * volume_cells(ndc, vol.shape[:3]) + nbytes(ndc, g)
                       + 12 * n, 8 * 40 * n, relative=True, timing="device")

    # K3 on the step's three lookups, whose rays are random pixels: their
    # neighbouring lanes buy no locality there. Device time (the profiler's
    # kernel durations: CUDA events around such short launches time the
    # host), beside the same points taken as [n, 3], which gives a warp 32
    # consecutive samples of a ray as the one-point-per-thread kernel did
    looks = list(lookups())
    for label, vol, ndc in looks:
        err, _ = rows.verify(
            "trilinear_sample", lambda: trilinear.sample_volume(vol, ndc),
            lambda: trilinear.sample_volume_plain(vol, ndc), 1e-5)
        log(f"[backward] K3 on the {label} lookup {tuple(ndc.shape)}: "
            f"max_abs_err {err:.3e} -> ok")
    with torch.no_grad():
        ms_rays = device_ms(lambda: [trilinear.sample_volume(vol, ndc)
                                     for _, vol, ndc in looks])
        ms_flat = device_ms(lambda: [trilinear.sample_volume(vol, ndc.view(-1, 3))
                                     for _, vol, ndc in looks])
    log(f"[backward] K3 on the step's three lookups: {ms_rays:.4f} ms of "
        f"device time; as [n, 3] (lanes along samples): {ms_flat:.4f} ms")

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
               relative=True, timing="device")
    del static_vol, dyn_vol, rays, passes, warped, g
    torch.cuda.empty_cache()


def _compare_train(tag, ref, out, rtol=1e-4, grad_tol=1e-4, clipped=False):
    """Logs to rtol; gradients to grad_tol of their module's largest (each
    field, each encoder); parameters after the step where the gradient is
    clear of Adam's epsilon and of the packages' difference. With
    ``clipped``, the gradient held clear of epsilon is the one Adam sees,
    after the global-norm clip (a large loss at random weights clips it
    down to where epsilon turns Adam's first step from a sign into a slope
    that float32 sum orders move)."""
    logs, grads, params, new = ref
    logs_c, grads_c, _, new_c = out
    g_norm = float(torch.sqrt(sum(torch.sum(g * g) for g in grads.values())))
    clip = max(1.0, g_norm) if clipped else 1.0
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
        big = (v.abs() > 10 * err) & (v.abs() / clip > 1e-5)
        d = float((new_c[k].cpu() - new[k])[big].abs().max()) if big.any() else 0.0
        if d > 1e-6:
            raise AssertionError(f"{tag} updated {k}: differs by {d}")
    moved = sum(int((new[k] != params[k]).sum()) for k in params)
    if moved == 0:
        raise AssertionError(f"{tag}: no parameter moved")
    log(f"[small-train] {tag}: loss {float(logs['train_loss']):.6f} (CUDA "
        f"{float(logs_c['train_loss']):.6f}); worst gradient difference "
        f"{worst:.2e} of its module's largest; {moved} parameters moved; "
        f"gradient norm {g_norm:.4g}")


def small_train(dev, preset=None, tag="small-train", clipped=False):
    """Phase 7: the small training step (``presets.SMALL_TRAIN`` by
    default) on CUDA and on the CPU, from the same weights and draws, in
    both phases (``_compare_train``; ``clipped`` there)."""
    from zest_tpu_torch import presets, sampling
    from zest_tpu_torch.system import TrainState, phase_for_step
    preset = presets.SMALL_TRAIN if preset is None else preset
    cfg, system, batch, params = presets.build(preset, presets.SMALL_SCENE,
                                               "cpu", SEED)
    _, system_c, batch_c, params_c = presets.build(
        preset, presets.SMALL_SCENE, dev, SEED)
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
        _compare_train(f"{tag} step {step} {tuple(phase)}", *runs,
                       clipped=clipped)


def expected_step_launches(system, cfg, batch, phase) -> dict:
    """The launches of one training step in ``phase``: K1 and K2 once per
    source view of the static volume; K3 and K4 once per unwarped lookup
    (one per volume) and per warped one (t±1 and the chain, dynamic volume),
    K5 once per warped lookup (at 16 bits K9 and its backward take the
    warped lookups, and K5 none); K8 once per volume; K6 and K7 once per
    pass of a v0 field conditioned on a volume (the static field; the
    dynamic one at t, at t±1 stacked and on the chain), and K7 float32's
    three launches once per chunk of each such pass; with time codes the
    fold and its backward once."""
    from zest_tpu_torch.kernels import fused_mlp
    chain = int(phase.chain_5frames)
    rays = cfg.batch_size + (cfg.num_extra_samples if phase.extra_samples
                             and cfg.train_sceneflow else 0)
    points = rays * cfg.N_samples
    passes = [points] if system.nerf_static.fused else []
    if system.nerf_dynamic is not None and system.nerf_dynamic.fused:
        passes += [points, 2 * points] + [points] * chain
    chunks = sum(-(-n // fused_mlp.CHUNK_ROWS) for n in passes)
    folds = int(_video_fused(system))
    n_src = (batch["images"].shape[0] - 2 if system.enc_static is not None
             else 0)
    unwarped = (system.enc_static is not None) + (system.enc_dy is not None)
    warped = 1 + chain if system.enc_dy is not None else 0
    expected = dict(homo_warp_cm=n_src, homo_warp_cm_grad=n_src,
                    sample_volume=unwarped + warped,
                    volume_grad=unwarped + warped, coords_grad=warped,
                    gather_colors=unwarped, fused_nerf_forward=len(passes),
                    fused_nerf_backward=len(passes), recompute=chunks,
                    input_grads=chunks, weight_grads=chunks, gather_rows=0,
                    scatter_rows=0, fold_codes=folds, fold_codes_grad=folds)
    if system.bf16:
        # the warped lookups are row gathers; K7's bf16 mode runs inside
        # its own entry
        expected.update(sample_volume=unwarped, volume_grad=unwarped,
                        coords_grad=0, gather_rows=warped,
                        scatter_rows=warped, recompute=0, input_grads=0,
                        weight_grads=0)
    return expected


def flagship_train(cfg, system, batch, params, tag="train",
                   window=TRAIN_STEPS, chain=True):
    """Phases 8 and 11 (and 14's presets): the flagship training step:
    exact launches per step (step 0, and with ``chain`` the chain step),
    finite logs, moved parameters and the peak memory, then a timed window
    of ``window`` steps. Returns (the step-0 phase's launches, train rays/s,
    None without a window)."""
    from zest_tpu_torch import presets, sampling
    from zest_tpu_torch.system import TrainState, phase_for_step
    dev = batch["images"].device
    H, W = cfg.img_h, cfg.img_w
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    motion_count = int(batch["motion_count"])
    opt = system.make_optimizer(presets.STEPS_PER_EPOCH)
    step_fn = system.make_train_step(opt)

    def run(state, phase):
        draws = sampling.sample_draws(gen, cfg, H, W, motion_count,
                                      phase.extra_samples)
        return step_fn(state, batch, draws, phase)

    state0 = TrainState(params, opt.init(params), 0)
    phase0 = phase_for_step(cfg, 0)
    n_rays = cfg.batch_size + (cfg.num_extra_samples if phase0.extra_samples
                               and cfg.train_sceneflow else 0)
    chain_step = cfg.decay_iteration_clamped * 2000 + 1
    phase_c = phase_for_step(cfg, chain_step)
    launches = {}
    runs = [("step 0", state0, phase0)]
    if chain:
        runs.append((f"step {chain_step}", state0._replace(step=chain_step),
                     phase_c))
    for step_tag, state, phase in runs:
        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new, logs = run(state, phase)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        got = read_counters()
        expected = expected_step_launches(system, cfg, batch, phase)
        log(f"[{tag}] {step_tag} {tuple(phase)}: first run {first:.2f} s, "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB, launches {got}")
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
    if not window:
        return launches["step 0"], None

    torch.cuda.reset_peak_memory_stats()
    state, logs = run(state1, phase0)                 # warm-up
    float(logs["train_loss"])
    t0 = time.perf_counter()
    for _ in range(window):
        state, logs = run(state, phase0)
    loss = float(logs["train_loss"])                  # waits for the device
    dt = time.perf_counter() - t0
    log(f"[{tag}] {window} steps in {dt:.3f} s ({1e3 * dt / window:.1f}"
        f" ms/step), loss {loss:.5g}; train_rays_per_sec "
        f"{n_rays * window / dt:.1f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches["step 0"], n_rays * window / dt


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
               16 * touched + nbytes(idx, g), 0, paths=paths, timing="device")
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
               nbytes(g, idx, tab), g.numel(), relative=True, paths=paths,
               timing="device")
    acc = torch.zeros((m, C), device=dev)
    bare_ms = device_ms(lambda: dma_gather.scatter_add_rows(acc, g, idx))
    lib_ms = device_ms(lambda: acc.index_add_(0, idx_flat, g32))
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
    path_ms = device_ms(lambda: dma_gather.scatter_rows(g_path, idx, m))
    lib_path_ms = device_ms(lambda: torch.zeros((m, C), device=dev).index_add_(
        0, idx_flat, g_path32).to(torch.bfloat16))
    log(f"[bf16] row scatter-add on the main path's cotangent ({zero:.1%} zero "
        f"rows): max_abs_err {err:.3e} (tol 2^-8 of the largest), kernel "
        f"{path_ms:.3f} ms, zeros + index_add_ + round {lib_path_ms:.3f} ms")
    del dyn_vol, passes, warped, tab, idx, g, g32, acc, wts, grad, g_path
    del g_path32
    torch.cuda.empty_cache()


def small_16(dev, presets16=None, tag="small-16", witness=("train_loss",)):
    """Phase 10: the small eval and training step at 16 bits on CUDA
    against the CPU (``presets16``: the 16-bit eval and training presets
    and their 32-bit twins; ``SMALL_16``'s by default). One of the logs
    ``witness`` (all when None) must differ from its 32-bit value: the
    16-bit path is taken. bf16 rounds in other places in cuDNN than on the CPU,
    so each quantity is held to twice the CPU's own difference between its
    16- and 32-bit runs (the eval maps and the logs; the gradients leaf by
    leaf for the fields, module by module for the encoders, whose leaves
    are bf16 noise), plus one bf16 rounding step (2^-8) of the value (maps
    and logs) or 1e-3 of the module's largest gradient."""
    from zest_tpu_torch import presets, sampling
    from zest_tpu_torch.system import phase_for_step

    def build(preset, on):
        return presets.build(preset, presets.SMALL_SCENE, on, SEED)

    eval16, eval32, train16, train32 = presets16 or (
        presets.SMALL_16, presets.SMALL, presets.SMALL_TRAIN_16,
        presets.SMALL_TRAIN)
    maps = {}
    for key, preset, on in (("cuda", eval16, dev), ("cpu", eval16, "cpu"),
                            ("cpu32", eval32, "cpu")):
        _, system, batch, params = build(preset, on)
        maps[key] = {k: v.cpu() for k, v in
                     system.make_eval_step()(params, batch).items()}
    for k in maps["cpu"]:
        err = float((maps["cuda"][k] - maps["cpu"][k]).abs().max())
        spread = float((maps["cpu"][k] - maps["cpu32"][k]).abs().max())
        ok = err <= 2 * spread + 2.0 ** -8 * float(maps["cpu"][k].abs().max())
        log(f"[{tag}] {k}: max_abs_err {err:.3e}, CPU 16-vs-32 {spread:.3e}"
            f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} eval {k}: CUDA and CPU differ by "
                                 f"{err}")

    cfg = build(train16, "cpu")[0]
    chain_step = cfg.decay_iteration_clamped * 2000 + 1
    for step in (0, chain_step):
        phase = phase_for_step(cfg, step)
        runs = {}
        for key, preset, on in (("cuda", train16, dev), ("cpu", train16, "cpu"),
                                ("cpu32", train32, "cpu")):
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
                raise AssertionError(f"{tag} step {step} log {k}: CUDA "
                                     f"{logs_c[k]} CPU {v} (32-bit {logs32[k]})")
        if all(logs[k] == logs32[k] for k in witness or logs):
            raise AssertionError(f"the 16-bit step's {witness or 'logs'} "
                                 f"equal the 32-bit ones")
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
                raise AssertionError(f"{tag} step {step} grad {k}: "
                                     f"differs by {err}, limit {limit}")
        log(f"[{tag}] step {step}: loss {logs['train_loss']:.6f} (CUDA "
            f"{logs_c['train_loss']:.6f}, 32-bit {logs32['train_loss']:.6f}); "
            f"worst gradient difference {worst:.2f} of its limit")


def quality(dev, system, batch, params, step_launches, tmp):
    """Phase 12: the metrics on the card, the training loop of the quality
    gate's configuration with its launches, its CSV log and a validation.
    ``step_launches`` are one 16-bit step-0 step's launches (phase 11); the
    loop writes its run under the directory ``tmp``. Returns (the loop's
    config, its final state, the steps/s of its log rows)."""
    import csv
    import math
    from pathlib import Path
    from zest_tpu_torch import metrics
    from zest_tpu_torch.config import ZestConfig
    from zest_tpu_torch.data.synthetic import SyntheticDataset
    from zest_tpu_torch.system import unpreprocess
    from zest_tpu_torch.tools import quality_gate
    from zest_tpu_torch.train_loop import run_training, validate

    maps = system.make_eval_step()(params, batch)
    pred = torch.clamp(maps["rgb_map_ref"], 0.0, 1.0)
    tgt = unpreprocess(batch["images"][-1])
    for name, fn, limit in (("psnr", metrics.psnr, None),
                            ("ssim", metrics.ssim, METRIC_SSIM_ATOL)):
        got = float(fn(pred, tgt))
        ref = float(fn(pred.cpu().double(), tgt.cpu().double()))
        err = abs(got - ref)
        if limit is None:
            limit = METRIC_PSNR_RTOL * abs(ref)
        else:
            limit *= max(1.0, abs(ref))
        ok = math.isfinite(got) and err <= limit
        log(f"[quality] {name}: card {got:.8g}, CPU float64 {ref:.10g}, "
            f"error {err:.3e} (limit {limit:.3e}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"metrics.{name} on the card: {got} against "
                                 f"float64 {ref}")

    cfg = ZestConfig(**dict(quality_gate.CONFIG, precision=16,
                            log_every=10, save_dir=tmp))
    ds = SyntheticDataset(**quality_gate.SCENE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    state, loop_system = run_training(cfg, {"train": ds},
                                      max_steps=LOOP_STEPS, quiet=True,
                                      device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counters()
    expected = {k: LOOP_STEPS * v for k, v in step_launches.items()}
    log(f"[quality] run_training: {LOOP_STEPS} steps in {wall:.2f} s "
        f"({wall / LOOP_STEPS:.4f} s/step, the first step and the frames' "
        f"first build included), launches {got}")
    if not loop_system.bf16 or got != expected:
        raise AssertionError(f"the loop's launches {got}, expected "
                             f"{expected} (precision 16)")
    run_dir = Path(tmp) / cfg.expname
    with open(run_dir / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    steps = [int(r["step"]) for r in rows]
    want = list(range(cfg.log_every, LOOP_STEPS + 1, cfg.log_every))
    losses = [float(r["train_loss"]) for r in rows]
    if steps != want or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"metrics.csv: steps {steps}, train_loss "
                             f"{losses}")
    log("[quality] metrics.csv: " + "; ".join(
        f"step {r['step']} train_loss {float(r['train_loss']):.5g} "
        f"train_PSNR {float(r['train_PSNR']):.4g} steps_per_sec "
        f"{float(r['steps_per_sec']):.3f}" for r in rows))
    t0 = time.perf_counter()
    out = validate(cfg, loop_system, loop_system.make_eval_step(),
                   state.params, ds, run_dir, LOOP_STEPS, max_images=1)
    val_s = time.perf_counter() - t0
    if not all(math.isfinite(v) for v in out.values()):
        raise AssertionError(f"validate: {out}")
    log(f"[quality] validate, 1 image in {val_s:.2f} s: val_PSNR "
        f"{out['val_PSNR']:.4f}, val_SSIM {out['val_SSIM']:.4f}, val_loss "
        f"{out['val_loss']:.5g}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (not gated "
        f"after {LOOP_STEPS} steps)")
    return cfg, state, [float(r["steps_per_sec"]) for r in rows]


def png_size(path) -> tuple:
    """(width, height) from a PNG's IHDR chunk; raises unless it is one."""
    head = Path(path).read_bytes()[:24]
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")


def paths(dev, tmp, loop_cfg, loop_state) -> dict:
    """Phase 13: the workflow after training, from phase 12's checkpoint,
    then the path step's launches and time at float32 and precision 16.
    Returns {precision: (s/pose, the volumes' build in s)}."""
    import math
    from zest_tpu_torch import presets
    from zest_tpu_torch.checkpoint import CheckpointManager
    from zest_tpu_torch.data.synthetic import SyntheticDataset
    from zest_tpu_torch.render_paths import run_wanderpath
    from zest_tpu_torch.system import EVAL_KEYS
    from zest_tpu_torch.tools import quality_gate
    from zest_tpu_torch.train_loop import run_test

    ckpts = Path(tmp) / loop_cfg.expname / "ckpts"
    t0 = time.perf_counter()
    state = CheckpointManager(ckpts).restore("last", map_location=dev)
    on_cpu = CheckpointManager(ckpts).restore("last", map_location="cpu")
    restore_s = time.perf_counter() - t0
    for k, v in loop_state.params.items():
        if not (torch.equal(state.params[k], v)
                and torch.equal(on_cpu.params[k], v.cpu())):
            raise AssertionError(f"checkpoint 'last': {k} differs from the "
                                 f"loop's final weights")
    if state.step != LOOP_STEPS or state.opt_state["count"] != LOOP_STEPS:
        raise AssertionError(f"checkpoint 'last' at step {state.step}")
    log(f"[paths] restored {ckpts / 'last'} on the card and on the CPU in "
        f"{restore_s:.2f} s: step {state.step}, {len(state.params)} tensors, "
        f"equal to the loop's final state")

    cfg = loop_cfg.replace(ckpt=str(ckpts / "last"), dataset_name="synthetic")
    t0 = time.perf_counter()
    out = run_test(cfg, datasets={"test": SyntheticDataset(
        **quality_gate.SCENE, max_len=2)}, quiet=True, device=dev)
    test_s = time.perf_counter() - t0
    text = (Path(tmp) / cfg.expname / "test_metrics.txt").read_text()
    if not (all(math.isfinite(v) for v in out.values())
            and text.startswith(f"PSNR: {out['val_PSNR']}\n")):
        raise AssertionError(f"run_test: {out}, test_metrics.txt {text!r}")
    log(f"[paths] run_test, 2 frames in {test_s:.2f} s: "
        + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))

    n_poses = 4
    t0 = time.perf_counter()
    run_wanderpath(cfg, frame_range=(3, 3), n_poses=n_poses, quiet=True,
                   device=dev)
    wander_s = time.perf_counter() - t0
    frame_dir = Path(tmp) / cfg.expname / "render_wanderpath_frame3"
    names = sorted(p.name for p in frame_dir.iterdir())
    want = sorted(f"{kind}_map_blend_{i:02d}.png" for kind in ("rgb", "depth")
                  for i in range(n_poses))
    sizes = {png_size(frame_dir / n) for n in names}
    if names != want or sizes != {(cfg.img_w, cfg.img_h)}:
        raise AssertionError(f"run_wanderpath wrote {names} of sizes {sizes}")
    log(f"[paths] run_wanderpath, frame 3, {n_poses} poses at precision "
        f"{cfg.precision} ({cfg.img_h}x{cfg.img_w}, width {cfg.netwidth}) "
        f"in {wander_s:.2f} s (the checkpoint, the frame and its volumes "
        f"included): {len(names)} PNGs of {cfg.img_w}x{cfg.img_h}")

    results = {}
    for precision, preset in ((32, presets.FLAGSHIP), (16, presets.FLAGSHIP_16)):
        pcfg, system, batch, params = presets.build(
            preset, presets.FLAGSHIP_SCENE, dev, SEED)
        # the target's own camera, then three orbit poses
        c2ws = torch.stack([batch["c2ws"][-1]] + [
            batch["wander_path_c2w"][i] for i in (15, 30, 45)])
        w2cs = torch.stack([batch["w2cs"][-1]] + [
            batch["wander_path_w2c"][i] for i in (15, 30, 45)])
        P = len(c2ws)
        reset_counters()
        ref = system.make_eval_step()(params, batch)
        torch.cuda.synchronize()
        eval_launches = read_counters()
        reset_counters()
        t0 = time.perf_counter()
        maps = system.make_eval_path_step()(params, batch, c2ws, w2cs)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        launches = read_counters()
        expected = dict(eval_launches)
        for k in ("sample_volume", "gather_colors", "fused_nerf_forward"):
            expected[k] = P * eval_launches[k]
        log(f"[paths] precision {precision}: eval image launches "
            f"{eval_launches}; path of {P} poses {launches}")
        if launches != expected or expected["homo_warp_cm"] <= 0:
            raise AssertionError(f"path launches {launches}, expected "
                                 f"{expected}: K1 once per frame, K3, K6 and "
                                 f"K8 once per pose, no backward kernel")
        for k in EVAL_KEYS:
            v = maps[k]
            if (v.shape != (P, *ref[k].shape)
                    or not bool(torch.isfinite(v).all())):
                raise AssertionError(f"path {k}: {tuple(v.shape)} or "
                                     f"non-finite values")
            err = float((v[0] - ref[k]).abs().max())
            if not torch.allclose(v[0], ref[k], rtol=1e-4, atol=1e-4):
                raise AssertionError(f"path {k} at the target's pose: "
                                     f"{err} from the eval step")
        moved = float((maps["rgb_map_ref"][1:] - maps["rgb_map_ref"][:1])
                      .abs().max())
        with torch.no_grad():
            builds = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                system.render_models(batch)
                torch.cuda.synchronize()
                builds.append(time.perf_counter() - t0)
        build_s = builds[-1]
        per_pose = (path_s - build_s) / P
        results[precision] = (per_pose, build_s)
        log(f"[paths] precision {precision}: {P} poses in {path_s:.3f} s, "
            f"{per_pose:.3f} s/pose beside a one-off volume build of "
            f"{build_s:.3f} s (first {builds[0]:.3f}); the target's pose "
            f"within rtol = atol = 1e-4 of make_eval_step, the orbit poses "
            f"up to {moved:.3f} from it in rgb_map_ref")
        del system, params, batch, maps, ref
        torch.cuda.empty_cache()
    return results


def row_rates(rows, name) -> str:
    """A row's time, bound and rate so far, for the log."""
    r = rows.rows[name]
    bound = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S,
                      ops_seconds(r["flops"], r["flops_bf16"], r["flops_tf32"]))
    useful = r["flops"] + r["flops_bf16"] + r["flops_tf32"] / 3
    return (f"{r['ms']:.3f} ms (bound {bound:.3f} ms), "
            f"{useful / r['ms'] / 1e9:.1f} TFLOP/s of its products; the "
            f"twin {r['plain_ms']:.3f} ms")


def new_widths(rows, dev, cfg, system, batch, rays, tag="mvsnerf"):
    """Phase 14: K1, K2, K3, K4 and K8 at the MVSNeRF flagship's shapes
    (288x544 images, the first run of those widths on the card), each held
    to its twin as phases 3 and 6 hold it: K1 on a source view's features
    over the padded frustum, K2 its adjoint, K3 and K4 on the static volume
    at the points of ``rays``, K8 on the source views at those points.
    Phase 16 holds them so at the real scenes' shapes (``tag``)."""
    from zest_tpu_torch import geometry
    from zest_tpu_torch.kernels import color_gather, plane_sweep, trilinear
    from zest_tpu_torch.models.mvsnet import depth_plane_values
    from zest_tpu_torch.ops.homography import homography_grid
    from zest_tpu_torch.system import unpreprocess
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    H, W = cfg.img_h, cfg.img_w
    h, w = H // 4, W // 4
    near_far = batch["near_fars"][0]
    depths = depth_plane_values(near_far[0], near_far[1])
    grid = homography_grid(batch["proj_mats"][1], depths, (h, w), pad=cfg.pad)
    src = torch.randn((h, w, 35), generator=gen, device=dev)
    g = torch.randn((grid.shape[0], 35, grid.shape[1] * grid.shape[2]),
                    generator=gen, device=dev)
    checks = [
        ("plane_sweep_warp", 1e-5, False,
         lambda: plane_sweep.homo_warp_cm(src, grid),
         lambda: plane_sweep.homo_warp_cm_plain(src, grid)),
        ("plane_sweep_warp_backward", 1e-5, True,
         lambda: plane_sweep.homo_warp_cm_grad(g, grid, (h, w)),
         lambda: plane_sweep.homo_warp_cm_grad_plain(src, grid, g))]
    with torch.no_grad():
        vol, _, _ = system.enc_static(batch["images"][:-1],
                                      batch["proj_mats"][:-1], near_far,
                                      pad=cfg.pad)
    ndc = rays.ndc.contiguous()
    gv = torch.randn((*ndc.shape[:-1], 8), generator=gen, device=dev)
    checks += [
        ("trilinear_sample", 1e-5, False,
         lambda: trilinear.sample_volume(vol, ndc),
         lambda: trilinear.sample_volume_plain(vol, ndc)),
        ("trilinear_grad_volume", 1e-5, True,
         lambda: trilinear.volume_grad(vol.shape, ndc, gv),
         lambda: trilinear.sample_volume_grads_plain(vol, ndc, gv)[0])]
    imgs = unpreprocess(batch["images"][:-1]).contiguous()
    V = imgs.shape[0]
    inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32, device=dev)
    xy = torch.stack([
        geometry.world_to_ndc(rays.pts, batch["w2cs"][v],
                              batch["intrinsics"][v], inv_scale, 2.0,
                              6.0)[..., :2] * inv_scale
        for v in range(V)]).reshape(V, -1, 2).contiguous()
    checks.append(("color_gather", 1e-5, False,
                   lambda: color_gather.gather_colors(imgs, xy),
                   lambda: color_gather.gather_colors_plain(imgs, xy)))
    for name, tol, relative, kern, plain in checks:
        err, shapes = rows.verify(name, kern, plain, tol, relative)
        log(f"[{tag}] {name} at {H}x{W}, pad {cfg.pad}: shapes {shapes} "
            f"max_abs_err {err:.3e} (tol {tol:g}) -> ok")
    del vol, src, g, gv, xy, imgs
    torch.cuda.empty_cache()


def four_output_kernels(rows, dev, cfg, system, batch, suffix="_mvsnerf",
                        paths=None):
    """Phase 14: K6 and K7 in the 4-output geometry (MVSNeRF's static field:
    rgb and alpha, no extra head) in the system's mode, at the MVSNeRF
    flagship's own inputs (the first eval chunk, the step-0 training pass),
    under the gates of phases 3 and 6 (float32: K6 to its twin and to a
    float64 twin, its operand pack bit for bit, HMMA already checked; K7's
    three launches each to its twin, at K6's forward, on the branch-agreeing
    points) or 9 (bf16: K6 and both bf16 packs, K7 with the kink-tolerant
    check, its recomputed rows equal to K6's; its first gate against the
    float64 twin, ``hold_bf16_backward``'s ``float64_gate``). The rows are
    K6's and K7's names with ``suffix``, their launches read on ``paths``
    (eval, train; by default phase 14's). Returns the step's rays."""
    from zest_tpu_torch.kernels import fused_mlp
    field = system.nerf_static
    if (field.out_ch, field.n_extra, system.nerf_dynamic) != (4, 0, None):
        raise AssertionError("the MVSNeRF system is not one 4-output field")
    bf16 = system.bf16
    tag = suffix[1:] + ("16" if bf16 else "")
    paths = paths or (f"eval_{tag}", f"train_{tag}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    fwd = ("fused_nerf_bf16" if bf16 else "fused_nerf") + suffix
    bwd = ("fused_nerf_backward_bf16" if bf16 else
           "fused_nerf_backward") + suffix
    src = "zest_tpu_torch/csrc/"
    field_inputs = chunk_inputs(system, batch)[1]
    inputs = field_inputs["static"]
    tol = BF16_FIELD_TOL if bf16 else 1e-4
    check_field_forward(rows, fwd, system, field_inputs, tol, paths,
                        src + ("fused_mlp_tc.cu" if bf16 else
                               "fused_mlp_tc32.cu"))
    if not bf16:
        float32_class("MVSNeRF field, eval chunk", field, inputs, True)
    makes = ([(fused_mlp.pack_bf16, fused_mlp.pack_bf16_plain),
              (fused_mlp.pack_bf16_bwd, fused_mlp.pack_bf16_bwd_plain)]
             if bf16 else [(fused_mlp.pack_tc32, fused_mlp.pack_tc32_plain)])
    with torch.no_grad():
        pack, offsets = fused_mlp.pack_weights(field)
        for make, plain in makes:
            if not torch.equal(make(field, pack, offsets),
                               plain(field, pack, offsets)[0]):
                raise AssertionError(f"{make.__name__} of the 4-output field "
                                     f"differs from its twin")
    log(f"[{tag}] K6 on the eval chunk ({inputs[0].shape[0]} rays x "
        f"{inputs[0].shape[1]}): {row_rates(rows, fwd)}; its operand packs "
        f"equal their twins")

    rays, _, passes = step_inputs(system, batch, cfg, gen)
    for label, (fld, pass_in) in passes.items():
        err, shapes = rows.verify(
            fwd, functools.partial(fused_mlp.fused_nerf_forward, fld, *pass_in),
            functools.partial(fld, *pass_in), tol)
        log(f"[{tag}] K6 on the training pass {label}: shapes {shapes} "
            f"max_abs_err {err:.3e} (tol {tol:g}) -> ok")
        if not bf16:
            float32_class(f"MVSNeRF training pass {label}", fld, pass_in,
                          False)
    check_field_backward(rows, bwd, passes, gen,
                         BF16_FIELD_GRAD_TOL if bf16 else 1e-4, paths,
                         src + ("fused_mlp_tc_bwd.cu" if bf16 else
                                "fused_mlp_tc32_dx.cu"), suffix=suffix,
                         float64_gate=True)
    log(f"[{tag}] K7 on the training pass: {row_rates(rows, bwd)}")
    if bf16:
        flat = [t.reshape(-1, t.shape[-1]).contiguous() for t in inputs]
        flat = [t[:1 << 18] for t in flat]
        g = torch.randn((flat[0].shape[0], 4), generator=gen, device=dev)
        with torch.no_grad():
            out = fused_mlp.fused_nerf_forward(field, *flat)
        again = torch.full_like(out, float("nan"))
        fused_mlp.fused_nerf_backward(field, *flat, g, pack, offsets,
                                      recomputed=again)
        if not torch.equal(again, out):
            raise AssertionError("K7's recomputed rows of the 4-output field "
                                 "differ from K6's output")
        log(f"[{tag}] K7's recompute: {out.shape[0]} rows equal to K6's "
            f"output bit for bit")
    else:
        for what in ("recompute", "input_grads", "weight_grads"):
            log(f"[{tag}] K7 float32 {what} on the training pass: "
                f"{row_rates(rows, f'fused_nerf_{what}{suffix}')}")
    del field_inputs, inputs, passes
    torch.cuda.empty_cache()
    return rays


ABLATIONS = ("mvsnerf", "nsff", "static_vol", "dy_vol")


def ablations(rows, dev):
    """Phase 14: the paper's baselines and ablations (``presets.FAMILIES``).
    Each small preset's eval and training step (both phases) on CUDA
    against the CPU at float32 and, where the 16-bit path differs from the
    32-bit one (a volume), at precision 16, as phases 4, 7 and 10 hold
    them; MVSNeRF's flagship at float32 and precision 16: K1, K2, K3, K4
    and K8 at its widths, K6 and K7 in the 4-output geometry
    (``four_output_kernels``), its eval (s/image, median of 3 with the
    input changed) and training step (exact launches; rays/s over
    TRAIN_STEPS steps after a warm-up); one flagship eval image and one
    training step of each other preset at float32, with its launches and
    peak memory. Returns (launches by path, {tag: (s/image, rays/s)})."""
    from zest_tpu_torch import presets
    launches, summary = {}, {}
    for fam in ABLATIONS:
        small = presets.FAMILIES[fam][0]
        small_slice(dev, small, f"small-{fam}")
        small_train(dev, small, f"small-train-{fam}", clipped=True)
        if small["use_mvs"] or small["use_mvs_dy"]:
            p16 = dict(small, precision=16)
            # a loss term of the plain field can hide the rest of the
            # 16-bit difference in train_loss's float32 rounding
            small_16(dev, (p16, small, p16, small), f"small-16-{fam}", None)
    for tag, preset in (("mvsnerf", presets.FLAGSHIP_MVSNERF),
                        ("mvsnerf16", presets.FLAGSHIP_MVSNERF_16)):
        cfg, system, batch, params = presets.build(
            preset, presets.MVSNERF_SCENE, dev, SEED)
        rays = four_output_kernels(rows, dev, cfg, system, batch)
        if tag == "mvsnerf":
            new_widths(rows, dev, cfg, system, batch, rays)
        del rays
        launches[f"eval_{tag}"], s_image = flagship(cfg, system, batch, params,
                                                    f"flagship-{tag}")
        launches[f"train_{tag}"], rays_s = flagship_train(
            cfg, system, batch, params, f"train-{tag}", chain=False)
        summary[tag] = (s_image, rays_s)
        del system, params, batch
        torch.cuda.empty_cache()
    for fam in ("nsff", "static_vol", "dy_vol"):
        _, preset, scene, _ = presets.FAMILIES[fam]
        cfg, system, batch, params = presets.build(preset, scene, dev, SEED)
        launches[f"eval_{fam}"], s_image = flagship(cfg, system, batch, params,
                                                    f"flagship-{fam}", runs=0)
        launches[f"train_{fam}"], _ = flagship_train(
            cfg, system, batch, params, f"train-{fam}", window=0, chain=False)
        summary[fam] = (s_image, None)
        del system, params, batch
        torch.cuda.empty_cache()
    return launches, summary


class _Capture:
    """An optimizer that keeps the parameters and returns the gradient it
    was given as its state: a step run with it hands back its gradients."""

    def init(self, params):
        return {}

    def update(self, grads, opt_state, params):
        return params, grads


def gan_step(preset, scene, on, step=0):
    """One GAN step of ``preset`` on device ``on`` from the seeded weights
    and a CPU generator's draws, its optimizers capturing the gradients.
    Returns (logs, generator gradients, discriminator gradients, the new
    spectral state, the state it started from, the GanSystem, the
    discriminators' outputs in that step, on the CPU: the judged output
    of every call, in the step's order, which the adversarial terms
    read)."""
    from zest_tpu_torch import presets, sampling, system_gan
    from zest_tpu_torch.system import phase_for_step
    cfg, gan, batch, state = presets.build_gan(preset, scene, on, SEED)
    phase = phase_for_step(cfg, step)
    draws = sampling.sample_draws(torch.Generator().manual_seed(SEED + 5),
                                  cfg, cfg.img_h, cfg.img_w, 0, False, step)
    preds, apply_disc = [], system_gan.apply_disc

    def judged(disc, params, spectral, x):
        out, new_spectral = apply_disc(disc, params, spectral, x)
        last = out[-1] if isinstance(out, (list, tuple)) else out
        preds.append(last.detach().cpu())
        return out, new_spectral

    system_gan.apply_disc = judged
    try:
        new, logs = gan.make_train_step(_Capture(), _Capture())(
            state, batch, draws.to(on), phase)
    finally:
        system_gan.apply_disc = apply_disc

    def cpu(tree):
        return {k: v.detach().cpu() for k, v in tree.items()}
    disc_grads = cpu(new.disc_opt_state)
    disc_grads.update({f"depth.{k}": v for k, v in
                       cpu(new.depth_disc_opt_state).items()})
    start = dict(cpu(state.disc_params), **{
        f"depth.{k}": v for k, v in cpu(state.depth_disc_params).items()})
    return ({k: float(v) for k, v in logs.items()}, cpu(new.opt_state),
            disc_grads, cpu(new.disc_vars),
            (cpu(state.params), start, cpu(state.disc_vars)), gan, preds)


def _adam_moves(gan, grads, params, disc_grads, disc_params):
    """Each optimizer's first update on the given gradients (the
    generator's with its clip, the discriminators' without), on the CPU."""
    from zest_tpu_torch import presets
    opt = gan.system.make_optimizer(presets.STEPS_PER_EPOCH)
    d_opt = gan.make_disc_optimizer(presets.STEPS_PER_EPOCH)
    with torch.no_grad():
        return (opt.update(grads, opt.init(params), params)[0],
                d_opt.update(disc_grads, d_opt.init(disc_params),
                             disc_params)[0])


def small_gan(dev, preset, scene, tag, preset32=None):
    """Phase 15's small GAN steps: ``preset`` on CUDA against the CPU from
    the same weights and draws. At float32 (``preset32`` None) as phase 7
    holds its step (``_compare_train``: the logs, the generator's gradients
    and its parameters after the step), and the discriminators' gradients
    to 1e-4 of each leaf's largest (with the naive GAN loss both gradient
    limits grow by twice its conditioning, ``adversarial_conditioning`` of
    the discriminators' outputs at their card-vs-CPU difference), their
    parameters after the step to 1e-6 where the gradient is clear of the
    packages' difference, the spectral ``u``s to 1e-5 (they read the
    kernels alone). At 16 bits as phase 10
    holds its step: each log and gradient within twice the CPU's own
    difference between ``preset`` and ``preset32`` plus a floor (one bf16
    rounding of a log, 1e-3 of the module's largest gradient); the
    discriminators and LPIPS run in float32 there too, so their gradients
    take the same limit and the ``u``s the float32 one."""
    from zest_tpu_torch.system_gan import adversarial_conditioning
    runs = {"cuda": gan_step(preset, scene, dev),
            "cpu": gan_step(preset, scene, "cpu")}
    if preset32 is not None:
        runs["cpu32"] = gan_step(preset32, scene, "cpu")
    logs_c, grads_c, dgrads_c, vars_c, _, _, preds_c = runs["cuda"]
    logs, grads, dgrads, vars_, (params, dparams, _), gan, preds = runs["cpu"]
    # the naive loss's gradient is 1/p between its clips: a card-vs-CPU
    # difference in an output near a clip moves it by that much more; held
    # to twice that, as the 16-bit limits take twice the CPU's own spread
    cond = 2 * adversarial_conditioning(
        gan.cfg, preds, [(a - b).abs() for a, b in zip(preds_c, preds)])
    if preset32 is None:
        new, dnew = _adam_moves(gan, grads, params, dgrads, dparams)
        new_c, dnew_c = _adam_moves(gan, grads_c, params, dgrads_c, dparams)
        _compare_train(tag, (logs, grads, params, new),
                       (logs_c, grads_c, params, new_c), clipped=True,
                       grad_tol=1e-4 + cond)
        for k, g in dgrads.items():
            err = float((dgrads_c[k] - g).abs().max())
            if err > (1e-4 + cond) * float(g.abs().max()):
                raise AssertionError(f"{tag} discriminator grad {k}: differs "
                                     f"by {err}")
            big = (g.abs() > 10 * err) & (g.abs() > 1e-5)
            d = float((dnew_c[k] - dnew[k])[big].abs().max()) if big.any() \
                else 0.0
            if d > 1e-6:
                raise AssertionError(f"{tag} discriminator {k} after the "
                                     f"step: differs by {d}")
    else:
        logs32, grads32, dgrads32 = runs["cpu32"][:3]
        for k, v in logs.items():
            if not abs(logs_c[k] - v) <= 2 * abs(v - logs32[k]) + \
                    2.0 ** -8 * abs(v):
                raise AssertionError(f"{tag} log {k}: CUDA {logs_c[k]} CPU "
                                     f"{v} (32-bit {logs32[k]})")
        if logs["G_rec_loss"] == logs32["G_rec_loss"]:
            raise AssertionError(f"{tag}: the 16-bit step equals the 32-bit")
        for got, ref, ref32 in ((grads_c, grads, grads32),
                                (dgrads_c, dgrads, dgrads32)):
            scale, spread_m = {}, {}
            for k, v in ref.items():
                m = k.split(".")[0]
                scale[m] = max(scale.get(m, 0.0), float(v.abs().max()))
                spread_m[m] = max(spread_m.get(m, 0.0),
                                  float((v - ref32[k]).abs().max()))
            for k, v in ref.items():
                m = k.split(".")[0]
                err = float((got[k] - v).abs().max())
                spread = (spread_m[m] if m.startswith("enc_")
                          else float((v - ref32[k]).abs().max()))
                if err > 2 * spread + (1e-3 + cond) * scale[m]:
                    raise AssertionError(f"{tag} grad {k}: differs by {err}")
    for k, v in vars_.items():
        if not torch.allclose(vars_c[k], v, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"{tag} spectral {k}: differs by "
                                 f"{float((vars_c[k] - v).abs().max())}")
    log(f"[{tag}] G_loss {logs['G_loss']:.6f} (CUDA {logs_c['G_loss']:.6f}),"
        f" D_loss {logs['D_loss']:.6f} (CUDA {logs_c['D_loss']:.6f}); "
        f"{len(dgrads)} discriminator leaves and {len(vars_)} spectral u held"
        f" (twice the naive loss's conditioning adds {cond:.2e}) -> ok")


def _timed(fn, n: int = 5) -> float:
    """Median wall seconds of fn() over n runs after one, each ended by a
    synchronise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def flagship_gan(cfg, gan, batch, state, tag, expected):
    """Phase 15 at the SVS flagship: one GAN step with every launch counter
    reset (its launches must be ``expected``, MVSNeRF's step-0 step's: the
    discriminators and LPIPS launch none of the port's kernels), finite
    G_loss, D_loss and train_PSNR, the generator's and the discriminator's
    parameters and the spectral u moved; then train_rays_per_sec over
    TRAIN_STEPS steps after a warm-up, ended by reading the loss, the peak
    memory, and the seconds of the step's parts: the generator's update,
    the discriminator's update and LPIPS's forward and backward on the
    step's patch. Returns (launches, rays/s, {part: s})."""
    from zest_tpu_torch import presets, sampling
    from zest_tpu_torch.system import phase_for_step
    dev = batch["images"].device
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    opt = gan.system.make_optimizer(presets.STEPS_PER_EPOCH)
    d_opt = gan.make_disc_optimizer(presets.STEPS_PER_EPOCH)
    step_fn = gan.make_train_step(opt, d_opt)
    phase = phase_for_step(cfg, 0)

    def draws_at(step):
        return sampling.sample_draws(gen, cfg, cfg.img_h, cfg.img_w, 0, False,
                                     step)

    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    new, logs = step_fn(state, batch, draws_at(0), phase)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    got = read_counters()
    log(f"[{tag}] step 0: first run {first:.2f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {got}")
    if got != expected:
        raise AssertionError(f"{tag}: launches {got}, expected {expected} "
                             f"(MVSNeRF's step)")
    for k in ("G_loss", "D_loss", "train_PSNR"):
        if not bool(torch.isfinite(logs[k])):
            raise AssertionError(f"{tag}: {k} is {float(logs[k])}")
    log(f"[{tag}] step 0 logs: " + ", ".join(f"{k} {float(v):.5g}"
                                            for k, v in logs.items()))
    for what, old, now in (("generator", state.params, new.params),
                           ("discriminator", state.disc_params,
                            new.disc_params),
                           ("spectral u", state.disc_vars, new.disc_vars)):
        moved = sum(int(bool((now[k] != v).any())) for k, v in old.items())
        log(f"[{tag}] {what}: {moved} of {len(old)} tensors moved")
        if moved < max(len(old) // 2, 1):
            raise AssertionError(f"{tag}: only {moved} {what} tensors moved")
    if new.depth_disc_params:
        raise AssertionError(f"{tag}: the SVS files train no depth "
                             f"discriminator")

    n_rays = cfg.patch_size ** 2
    torch.cuda.reset_peak_memory_stats()
    st, logs = step_fn(new, batch, draws_at(1), phase)     # warm-up
    float(logs["G_loss"])
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        st, logs = step_fn(st, batch, draws_at(2 + i), phase)
    loss = float(logs["G_loss"])                            # waits
    dt = time.perf_counter() - t0
    rays_s = n_rays * TRAIN_STEPS / dt
    log(f"[{tag}] {TRAIN_STEPS} steps in {dt:.3f} s ({1e3 * dt / TRAIN_STEPS:.1f}"
        f" ms/step), G_loss {loss:.5g}; train_rays_per_sec {rays_s:.1f}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    draws = draws_at(0)
    parts = {}
    parts["generator update"] = _timed(lambda: gan.generator_update(
        st, batch, draws, phase, opt))
    outs = gan.generator_update(st, batch, draws, phase, opt)[3]
    parts["discriminator update"] = _timed(lambda: gan.discriminator_update(
        st, outs, d_opt))
    P = cfg.patch_size
    fake = outs[0].reshape(P, P, 3).clone().requires_grad_(True)
    real = outs[1].reshape(P, P, 3)

    def lpips_fwd_bwd():
        with torch.enable_grad():
            torch.autograd.grad(gan.lpips(fake, real), fake)
    parts["LPIPS forward and backward"] = _timed(lpips_fwd_bwd)
    parts["whole step"] = dt / TRAIN_STEPS
    for part, sec in parts.items():
        log(f"[{tag}] seconds of the {part}: {sec:.5f} (median of 5 after a "
            f"warm-up, synchronised)" if part != "whole step" else
            f"[{tag}] seconds of the {part}: {sec:.5f} (the window's mean)")
    return got, rays_s, parts


def svs_loop(dev, tmp, step_launches):
    """Phase 15's loop: ``run_training`` for SVS_LOOP_STEPS steps of
    ``config_svs_nsff_cross1.txt`` on the synthetic scene at precision 16
    (every launch counter reset: SVS_LOOP_STEPS x one 16-bit SVS step's
    ``step_launches``), ``ckpts/last`` restored on the card equal to the
    loop's final state field by field, and ``validate`` on one image with
    a finite val_LPIPS. Returns the loop's launches."""
    import math
    import warnings
    from zest_tpu_torch import presets
    from zest_tpu_torch.checkpoint import restore_path
    from zest_tpu_torch.config import config_parser
    from zest_tpu_torch.system_gan import GanTrainState
    from zest_tpu_torch.train_loop import build_datasets, run_training, validate
    cfg = config_parser([
        "--config", "configs/config_files/config_svs_nsff_cross1.txt",
        "--dataset_name", "synthetic", "--precision", "16",
        "--lpips_weights", presets.RANDOM_LPIPS, "--save_dir", tmp,
        "--log_every", "5"])
    ds = build_datasets(cfg)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, system = run_training(cfg, {"train": ds["train"]},
                                     max_steps=SVS_LOOP_STEPS, quiet=True,
                                     device=dev)
    with_warnings = [str(w.message) for w in caught]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counters()
    expected = {k: SVS_LOOP_STEPS * v for k, v in step_launches.items()}
    log(f"[svs-loop] run_training of config_svs_nsff_cross1.txt at precision "
        f"16: {SVS_LOOP_STEPS} steps in {wall:.2f} s ({wall / SVS_LOOP_STEPS:.4f}"
        f" s/step, the frames' build included), launches {got}; warnings "
        f"{with_warnings}")
    if not isinstance(state, GanTrainState) or not system.bf16 or \
            got != expected:
        raise AssertionError(f"the SVS loop's launches {got}, expected "
                             f"{expected}")
    if not any("acc_grad" in w for w in with_warnings):
        raise AssertionError("the GAN loop did not warn that it ignores "
                             "acc_grad")
    run_dir = Path(tmp) / cfg.expname
    restored = restore_path(run_dir / "ckpts" / "last", dev)
    for field in GanTrainState._fields:
        a, b = getattr(restored, field), getattr(state, field)
        same = a == b if not isinstance(a, dict) else _tree_equal(a, b)
        if not same:
            raise AssertionError(f"restored {field} differs from the loop's")
    log(f"[svs-loop] ckpts/last restored on the card: all "
        f"{len(GanTrainState._fields)} fields equal the loop's final state "
        f"(step {restored.step}, {len(restored.disc_vars)} spectral u)")
    t0 = time.perf_counter()
    out = validate(cfg, system, system.make_eval_step(), state.params,
                   ds["val"], run_dir, SVS_LOOP_STEPS, max_images=1)
    val_s = time.perf_counter() - t0
    if "val_LPIPS" not in out or not all(math.isfinite(v)
                                         for v in out.values()):
        raise AssertionError(f"validate: {out}")
    log(f"[svs-loop] validate, 1 image in {val_s:.2f} s: " + ", ".join(
        f"{k} {v:.5g}" for k, v in out.items()))
    return got


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def svs(dev, tmp, mvsnerf_launches):
    """Phase 15, the SVS (GAN) path: the small GAN steps on CUDA against
    the CPU (GRAF at float32 and at 16 bits, the PatchGAN variant at
    float32); the SVS flagship at float32 and at precision 16
    (``flagship_gan``), each step's launches equal to MVSNeRF's step-0
    step's at its precision (phase 14's ``mvsnerf_launches``); then the
    loop of ``svs_loop``. Returns (launches by path, {tag: (rays/s,
    parts)})."""
    from zest_tpu_torch import presets
    presets.write_random_lpips()
    lp = dict(lpips_weights=presets.RANDOM_LPIPS)
    small_gan(dev, dict(presets.SMALL_SVS, **lp), presets.SMALL_SCENE,
              "small-svs")
    small_gan(dev, dict(presets.SMALL_SVS_16, **lp), presets.SMALL_SCENE,
              "small-svs-16", dict(presets.SMALL_SVS, **lp))
    small_gan(dev, presets.SMALL_PATCHGAN, presets.PATCHGAN_SCENE,
              "small-patchgan")
    launches, summary = {}, {}
    for tag, preset, ref in (("svs", presets.FLAGSHIP_SVS, "train_mvsnerf"),
                             ("svs16", presets.FLAGSHIP_SVS_16,
                              "train_mvsnerf16")):
        cfg, gan, batch, state = presets.build_gan(
            preset, presets.MVSNERF_SCENE, dev, SEED)
        launches[f"train_{tag}"], rays_s, parts = flagship_gan(
            cfg, gan, batch, state, f"flagship-{tag}", mvsnerf_launches[ref])
        summary[tag] = (rays_s, parts)
        del gan, batch, state
        torch.cuda.empty_cache()
    launches["loop_svs16"] = svs_loop(dev, tmp, launches["train_svs16"])
    return launches, summary


NSFF_FILE = "configs/config_files/config_zest_fine_nsff_cross1.txt"
LLFF_FILE = "configs/config_files/config_mvsnerf_llff.txt"
# phase 16's scenes (width x height of the files on disk): NSFF frames at
# twice the file's 512x288 (its flow and disparity at 512x288, as NSFF's
# preprocessing writes them), LLFF's images_4 of a 4032x3024 capture,
# DTU's rectified images, Neural 3D Video frames at half its 2704x2028
REAL_SCENES = dict(
    nsff=dict(scene="kid-running", n_frames=24, size=(1024, 576),
              flow_size=(512, 288)),
    llff=dict(scene="fern", n_views=20, size=(1008, 756)),
    dtu=dict(n_views=49, size=(640, 512), lights=(3,), depth_views=(0,)),
    n3dv=dict(n_cams=6, n_frames=1, size=(1352, 1014)))
REAL_STEPS = 20              # loop steps of the NSFF flagship file
LLFF_STEPS = 10              # loop steps of the LLFF file
LLFF_HOLDS = 6               # LLFF training samples K7 bf16 is held on
LOADER_RUNS = 8              # samples timed per loader route
TEST_LOADS = 3               # test-split samples timed after ``test``
REAL_POSES = 4               # poses of each path


def _cli(module, args) -> tuple:
    """Run a command-line module's ``main`` with every launch counter reset
    first -> (its stdout's last line, seconds, launches); raises unless it
    exits with 0."""
    import contextlib
    import io
    out = io.StringIO()
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = module.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{module.__name__} {args} exited with {rc}")
    lines = out.getvalue().strip().splitlines()
    return (lines[-1] if lines else ""), wall, read_counters()


def _times(counts: dict, n: int) -> dict:
    return {k: n * v for k, v in counts.items()}


def _path_launches(eval_launches: dict, frames: int, poses: int) -> dict:
    """A path's launches: K1 as for one eval image per frame, K3, K6 and
    K8 once per pose of each frame."""
    out = _times(eval_launches, frames)
    for k in ("sample_volume", "gather_colors", "fused_nerf_forward",
              "fold_codes"):
        out[k] = frames * poses * eval_launches[k]
    return out


def _check(tag, got, expected):
    if got != expected:
        raise AssertionError(f"{tag}: launches {got}, expected {expected}")


def _train_real(tag, args, steps, sample):
    """``zest_tpu_torch.train`` for ``steps`` steps: its launches against
    ``steps`` x one step's (every step in the step-0 phase), finite
    ``train_loss`` in metrics.csv, ``ckpts/last`` at ``steps`` with most
    parameters moved from the seed's weights; ``sample`` is one of the
    training split's, for its shapes. Returns (one step's launches, the
    loop's wall, its log rows' steps/s)."""
    import csv
    import math
    from zest_tpu_torch import train
    from zest_tpu_torch.checkpoint import restore_path
    from zest_tpu_torch.config import config_parser
    from zest_tpu_torch.system import ZestSystem, phase_for_step, to_batch
    cfg = config_parser(args)
    system = ZestSystem(cfg)
    phase = phase_for_step(cfg, 0)
    if any(phase_for_step(cfg, s) != phase for s in range(steps)):
        raise AssertionError(f"{tag}: the phase changes within {steps} steps")
    step = expected_step_launches(system, cfg, to_batch(sample, "cpu"), phase)
    _, wall, got = _cli(train, args)
    _check(f"{tag} {steps} steps", got, _times(step, steps))
    run_dir = Path(cfg.save_dir) / cfg.expname
    with open(run_dir / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["train_loss"]) for r in rows]
    if not rows or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: train_loss {losses}")
    state = restore_path(run_dir / "ckpts" / "last", "cpu")
    init = system.init_params(torch.Generator().manual_seed(
        max(cfg.seed_everything, 0)))
    moved = sum(int(not torch.equal(state.params[k], v))
                for k, v in init.items())
    if state.step != steps or moved < len(init) // 2:
        raise AssertionError(f"{tag}: ckpts/last at step {state.step}, "
                             f"{moved} of {len(init)} tensors moved")
    sps = [float(r["steps_per_sec"]) for r in rows]
    log(f"[real-data] {tag}: {steps} steps of python -m zest_tpu_torch.train "
        f"in {wall:.2f} s ({wall / steps:.4f} s/step, the datasets, the "
        f"system and the first step included), launches {got}; train_loss "
        + ", ".join(f"{v:.5g}" for v in losses) + "; steps_per_sec "
        + ", ".join(f"{v:.3f}" for v in sps)
        + f"; {moved} of {len(init)} parameter tensors moved")
    return step, wall, sps


def _eval_real(tag, dev, cfg, ds):
    """One eval image of ``ds[0]`` with the seed's weights: its launches,
    finite maps of the sample's size. Returns (the launches, the sample)."""
    from zest_tpu_torch.system import ZestSystem, to_batch
    t0 = time.perf_counter()
    sample = ds[0]
    load_s = time.perf_counter() - t0
    system = ZestSystem(cfg).to(dev)
    params = {k: v.to(dev) for k, v in system.init_params(
        torch.Generator().manual_seed(SEED)).items()}
    batch = to_batch(sample, dev)
    reset_counters()
    t0 = time.perf_counter()
    maps = system.make_eval_step()(params, batch)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    got = read_counters()
    _check(tag, got, expected_eval_launches(system, batch))
    _, H, W, _ = batch["images"].shape
    for k, v in maps.items():
        if v.shape[:2] != (H, W) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{tag} {k}: {tuple(v.shape)} or non-finite")
    key = blended(system)
    mean = float(maps[key].mean())
    del system, params, batch, maps
    log(f"[real-data] {tag}: {type(ds).__name__}, {len(ds)} samples, sample "
        f"0 in {load_s:.3f} s ({tuple(sample['images'].shape)} images, keys "
        f"{sorted(sample)}); one eval image at precision {cfg.precision} "
        f"({H}x{W}, first run) in {eval_s:.3f} s, launches {got}; "
        f"{key} mean {mean:.4f}")
    return got, sample


def llff_holds(dev, cfg, system, samples) -> None:
    """K7's bf16 mode on the step-0 static pass of each LLFF training
    sample in ``samples`` (source views drawn apart from the first's),
    under ``hold_bf16_backward``'s gates with its float64 gate, as
    ``four_output_kernels`` holds it on the first: one pass's reading is
    one draw of the bf16 roundings that land the other way."""
    from zest_tpu_torch.kernels import fused_mlp
    from zest_tpu_torch.system import to_batch
    field = system.nerf_static
    with torch.no_grad():
        pack, offsets = fused_mlp.pack_weights(field)
    for i, sample in enumerate(samples, 1):
        gen = torch.Generator(device=dev).manual_seed(SEED + 4)
        batch = to_batch(sample, dev)
        _, _, passes = step_inputs(system, batch, cfg, gen)
        flat = [t.reshape(-1, t.shape[-1]).contiguous()
                for t in passes["static"][1]]
        g = torch.randn((flat[0].shape[0], field.out_ch), generator=gen,
                        device=dev)
        hold_bf16_backward("fused_nerf_backward_bf16_llff",
                           f"static, training sample {i}", field, flat, g,
                           pack, offsets, float64_gate=True)
        del batch, passes, flat, g
        field.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
    log(f"[llff16] K7 bf16 held on {len(samples) + 1} LLFF training "
        f"samples' step-0 passes")


def real_widths(rows, dev, llff_cfg, llff_samples, dtu_cfg, dtu_sample,
                n3dv_sample):
    """Phase 16's kernels at the real scenes' own shapes, each held to its
    twin as phase 14 holds them at MVSNeRF's, with the seed's weights: on
    the LLFF file's first training sample at its precision (16), K6 and K7
    in the 4-output bf16 mode (``four_output_kernels``, rows ``*_llff``,
    launches of the LLFF paths) and K1, K2, K3, K4 and K8 at that step's
    rays (``new_widths``); K7 again, under the same gates, on the step-0
    pass of each other sample (other source views: ``llff_holds``); on the
    DTU test sample, K1, K2, K3, K4 and K8 at its
    first eval chunk's points and K6 on that chunk (into the LLFF row: the
    eval chunk has one shape, 16384 rays x 128). Neural 3D Video's eval
    image has LLFF's images, views and pad, which this checks."""
    import dataclasses
    from zest_tpu_torch import presets
    from zest_tpu_torch.kernels import fused_mlp
    from zest_tpu_torch.system import ZestSystem, to_batch

    def build(cfg, sample):
        system = ZestSystem(cfg).to(dev)
        system.load_state_dict({k: v.to(dev) for k, v in
                                presets.seeded_params(system, SEED).items()})
        batch = to_batch(sample, dev)
        _, H, W, _ = batch["images"].shape
        return dataclasses.replace(cfg, img_h=H, img_w=W), system, batch

    t0 = time.perf_counter()
    shape = tuple(llff_samples[0]["images"].shape)
    if tuple(n3dv_sample["images"].shape) != shape:
        raise AssertionError(f"Neural 3D Video's images "
                             f"{n3dv_sample['images'].shape}, LLFF's {shape}")
    cfg, system, batch = build(llff_cfg, llff_samples[0])
    rays = four_output_kernels(rows, dev, cfg, system, batch, "_llff",
                               ("eval_llff16", "train_llff16"))
    new_widths(rows, dev, cfg, system, batch, rays, "llff16")
    del batch, rays
    llff_holds(dev, cfg, system, llff_samples[1:])
    del system
    cfg, system, batch = build(dtu_cfg, dtu_sample)
    rays, field_inputs = chunk_inputs(system, batch)
    new_widths(rows, dev, cfg, system, batch, rays, "dtu16")
    field, inputs = system.nerf_static, field_inputs["static"]
    err, shapes = rows.verify(
        "fused_nerf_bf16_llff",
        functools.partial(fused_mlp.fused_nerf_forward, field, *inputs),
        functools.partial(field, *inputs), BF16_FIELD_TOL)
    log(f"[dtu16] K6 bf16 on the eval chunk at {cfg.img_h}x{cfg.img_w}: "
        f"shapes {shapes} max_abs_err {err:.3e} (tol {BF16_FIELD_TOL:g}) "
        f"-> ok")
    del system, batch, rays, field_inputs, inputs
    torch.cuda.empty_cache()
    log(f"[real-data] the kernels held at LLFF's {shape} and DTU's "
        f"{tuple(dtu_sample['images'].shape)} images (Neural 3D Video's "
        f"equal LLFF's) in {time.perf_counter() - t0:.1f} s")


def real_data(rows, dev, tmp, step_ms, loop_sps):
    """Phase 16: real scenes on disk through the entry points, written by
    ``tools.scene_fixtures`` (``REAL_SCENES``). The NSFF flagship file as
    written (``config_zest_fine_nsff_cross1.txt``: kid-running, 288x512,
    both volumes, 600 + 512 rays) trains ``REAL_STEPS`` steps at precision
    16 and at float32 (``_train_real``), then ``test`` and ``render_spiral
    --render_path wander`` (frames 3 and 4, ``REAL_POSES`` poses) from the
    16-bit ``ckpts/last``, their launches checked, and the test split's
    load (``TEST_LOADS`` samples); the loader's s/sample
    (median of ``LOADER_RUNS``) on each route beside the flagship step
    (``step_ms``: {precision: ms} of phases 8 and 11) and the loop's
    steps/s beside phase 12's (``loop_sps``). The LLFF file trains
    ``LLFF_STEPS`` steps at precision 16, then renders its spiral and its
    spheric path. DTU and Neural 3D Video: one sample through
    ``build_datasets`` and one MVSNeRF eval image at precision 16. Then
    ``real_widths`` holds the kernels at those scenes' shapes. Returns the
    launches by path (one step or one eval image each)."""
    import math
    import os
    from zest_tpu_torch import render_spiral
    from zest_tpu_torch import test as test_cli
    from zest_tpu_torch.config import config_parser
    from zest_tpu_torch.data import native_io
    from zest_tpu_torch.system import ZestSystem, to_batch
    from zest_tpu_torch.tools import scene_fixtures as sf
    from zest_tpu_torch.train_loop import build_datasets
    t_phase = time.perf_counter()
    root = Path(tmp)
    t0 = time.perf_counter()
    sf.write_nsff_scene(root / "nsff", **REAL_SCENES["nsff"])
    sf.write_llff_scene(root / "llff", **REAL_SCENES["llff"])
    scan = Path("configs/lists/dtu_test_all.txt").read_text().split()[0]
    sf.write_dtu_scene(root / "dtu", scan, **REAL_SCENES["dtu"])
    n3dv = Path("configs/lists/neural3Dvideo_test_all.txt").read_text().split()[0]
    sf.write_n3dv_scene(root / "n3dv", n3dv, **REAL_SCENES["n3dv"])
    log(f"[real-data] scenes written in {time.perf_counter() - t0:.2f} s: "
        + "; ".join(f"{k} {v}" for k, v in REAL_SCENES.items())
        + f"; DTU {scan}, Neural 3D Video {n3dv}")

    runs = str(root / "runs")
    nsff = ["--config", NSFF_FILE, "--datadir", str(root / "nsff"),
            "--save_dir", runs, "--log_every", "5"]
    train_ds = build_datasets(config_parser(nsff),
                              ("train",))["train"]
    saved = os.environ.get("ZEST_NATIVE_IO")
    loader = []
    for flag in ("1", "0"):
        os.environ["ZEST_NATIVE_IO"] = flag
        sample = train_ds[2]
        route, why = native_io.last_route()
        if flag == "1" and route != "native":
            log(f"[real-data] NSFF loader, ZEST_NATIVE_IO=1: the native "
                f"route is not taken here ({why}); PIL's is timed below")
            continue
        times = []
        for i in range(LOADER_RUNS):
            t0 = time.perf_counter()
            sample = train_ds[3 + i]
            times.append(time.perf_counter() - t0)
        loader.append((route, float(np.median(times))))
        log(f"[real-data] NSFF loader, ZEST_NATIVE_IO={flag}: route {route}"
            + (f" ({why})" if why else "") + ", s/sample "
            + ", ".join(f"{t:.4f}" for t in times)
            + f" (median {np.median(times):.4f})")
    if saved is None:
        del os.environ["ZEST_NATIVE_IO"]
    else:
        os.environ["ZEST_NATIVE_IO"] = saved
    native_why = native_io.unused_reason()

    launches, real = {}, {}
    for precision in (16, 32):
        args = nsff + ["--expname", f"real_p{precision}", "--precision",
                       str(precision), "--max_train_steps", str(REAL_STEPS)]
        launches[f"train_real{precision}"], wall, sps = _train_real(
            f"NSFF flagship, precision {precision}", args, REAL_STEPS,
            sample)
        real[precision] = (wall / REAL_STEPS, sps)
        torch.cuda.empty_cache()

    ckpt = ["--expname", "real_p16", "--precision", "16", "--ckpt",
            str(root / "runs" / "real_p16" / "ckpts" / "last")]
    cfg16 = config_parser(nsff + ckpt)
    test_ds = build_datasets(cfg16, ("test",))["test"]
    system16 = ZestSystem(cfg16)
    one = expected_eval_launches(system16, to_batch(sample, "cpu"))
    line, test_s, got = _cli(test_cli, nsff + ckpt)
    _check("test", got, _times(one, len(test_ds)))
    text = (root / "runs" / "real_p16" / "test_metrics.txt").read_text()
    psnr = float(text.splitlines()[0].split(": ")[1])
    if not math.isfinite(psnr):
        raise AssertionError(f"test_metrics.txt {text!r}")
    loads = []
    for i in range(TEST_LOADS):
        t0 = time.perf_counter()
        test_ds[i]
        loads.append(time.perf_counter() - t0)
    log(f"[real-data] python -m zest_tpu_torch.test from ckpts/last: "
        f"{len(test_ds)} frames in {test_s:.2f} s ({test_s / len(test_ds):.3f}"
        f" s/frame with its sample's load), launches {got}; {line}; the test "
        f"split's load, route {native_io.last_route()[0]}: "
        + ", ".join(f"{t:.4f}" for t in loads)
        + f" s/sample (median {np.median(loads):.4f})")
    launches["test_real16"] = one
    _, wander_s, got = _cli(render_spiral, nsff + ckpt + [
        "--render_path", "wander", "--frame_range", "3", "4", "--n_poses",
        str(REAL_POSES)])
    _check("wander", got, _path_launches(one, 2, REAL_POSES))
    pngs = [p for t in (3, 4) for p in (root / "runs" / "real_p16" /
                                         f"render_wanderpath_frame{t}").iterdir()]
    if len(pngs) != 2 * 2 * REAL_POSES:
        raise AssertionError(f"wander path wrote {len(pngs)} PNGs")
    log(f"[real-data] render_spiral --render_path wander, frames 3 and 4, "
        f"{REAL_POSES} poses each: {wander_s:.2f} s "
        f"({wander_s / (2 * REAL_POSES):.3f} s/pose with the frames' loads, "
        f"the checkpoint and the volumes), launches {got}, {len(pngs)} PNGs")

    llff = ["--config", LLFF_FILE, "--datadir", str(root / "llff"),
            "--finetune_scene", REAL_SCENES["llff"]["scene"], "--save_dir",
            runs, "--precision", "16", "--log_every", "5"]
    llff_train = build_datasets(config_parser(llff),
                                ("train", "test"))
    launches["train_llff16"], _, _ = _train_real(
        "LLFF MVSNeRF, precision 16", llff + ["--max_train_steps",
                                              str(LLFF_STEPS)],
        LLFF_STEPS, llff_train["train"][0])
    ckpt = ["--ckpt", str(root / "runs" / "mvsnerf_llff" / "ckpts" / "last"),
            "--n_poses", str(REAL_POSES)]
    cfg_l = config_parser(llff)
    one = expected_eval_launches(ZestSystem(cfg_l),
                                 to_batch(llff_train["test"][0], "cpu"))
    per_pose = {}
    for kind in ("spiral", "spheric"):
        line, wall, got = _cli(render_spiral, llff + ckpt + [
            "--render_path", kind])
        _check(kind, got, _path_launches(one, 1, REAL_POSES))
        printed = json.loads(line)
        per_pose[kind] = printed["render_s"] / REAL_POSES
        n_png = len(list(Path(printed["out"]).glob("*.png")))
        if n_png != 2 * REAL_POSES:
            raise AssertionError(f"{kind} path wrote {n_png} PNGs")
        w, h = llff_train["test"].img_wh
        log(f"[real-data] render_spiral --render_path {kind}, "
            f"{REAL_POSES} poses at {h}x{w}: {per_pose[kind]:.3f} s/pose "
            f"(the render: volumes once, then each pose; "
            f"{printed['render_s']:.3f} s of the command's {wall:.2f} s), "
            f"launches {got}, {n_png} PNGs")
    launches["eval_llff16"] = one

    evals = {}
    for name, data_root in (("dtu", "dtu"), ("neural3Dvideo", "n3dv")):
        cfg = config_parser(["--config", LLFF_FILE, "--dataset_name", name,
                             "--datadir", str(root / data_root),
                             "--precision", "16"])
        ds = build_datasets(cfg, ("test",))["test"]
        launches[f"eval_{data_root}16"], one_sample = _eval_real(
            f"{name} (MVSNeRF)", dev, cfg, ds)
        evals[data_root] = (cfg, one_sample)
        torch.cuda.empty_cache()
    # the holds' training samples, LLFF_HOLDS draws of the source views
    # (the loader picks them at random) from the script's seed on
    llff_samples = []
    for i in range(LLFF_HOLDS):
        llff_train["train"].rng = np.random.default_rng(SEED + i)
        llff_samples.append(llff_train["train"][0])
    real_widths(rows, dev, cfg_l, llff_samples, *evals["dtu"],
                evals["n3dv"][1])

    cpus = os.cpu_count()
    n_images = len(sample["images"]) + len(sample["nb_imgs"])
    (w0, h0), (w1, h1) = REAL_SCENES["nsff"]["size"], train_ds.img_wh
    log(f"[real-data] the loader against the card, NSFF flagship sample "
        f"({n_images} images of {w0}x{h0} decoded and Lanczos-resized to "
        f"{w1}x{h1}, 2 flows, a disparity, a mask; files in the page "
        f"cache), host CPUs {cpus}: "
        + "; ".join(f"route {route} {t:.4f} s/sample" for route, t in loader)
        + ("" if any(r == "native" for r, _ in loader)
           else f" (no native route: {native_why})")
        + f"; flagship step (phases 11 and 8) {step_ms[16]:.1f} ms at "
        f"precision 16, {step_ms[32]:.1f} ms at float32; the loop (its log "
        f"rows after the first) {np.mean(real[16][1][1:]):.3f} steps/s at "
        f"precision 16, {np.mean(real[32][1][1:]):.3f} at float32 on the "
        f"loaded scene against {np.mean(loop_sps[1:]):.3f} on the synthetic "
        f"scene (phase 12, precision 16)")
    log(f"[real-data] phase 16 in {time.perf_counter() - t_phase:.1f} s")
    return launches


MVSNERF_FILE = "configs/config_files/config_mvsnerf_nsff_cross1.txt"
OPTION_RUNS = 1              # timed eval images of each option's flagship
OPTION_WINDOW = 3            # timed training steps of each option's flagship
VIDEO_STEPS = 3              # loop steps of each precision's video run
VIDEO_SLICE = 1 << 16        # points of the video field's kernel holds


def option_flagships(tag, preset, scene, dev) -> tuple:
    """An option's flagship preset at float32 and at precision 16: the eval
    image (``flagship``: its launches, OPTION_RUNS timed runs with the
    input changed) and the step-0 and chain training steps
    (``flagship_train``: their launches, train rays/s over OPTION_WINDOW
    steps, the peak memory). Returns ({path: launches}, {tag: (s/image,
    rays/s)})."""
    from zest_tpu_torch import presets
    launches, summary = {}, {}
    for suffix, config in (("", preset), ("16", dict(preset, precision=16))):
        name = tag + suffix
        cfg, system, batch, params = presets.build(config, scene, dev, SEED)
        launches[f"eval_{name}"], s_image = flagship(
            cfg, system, batch, params, f"flagship-{name}", runs=OPTION_RUNS)
        launches[f"train_{name}"], rays_s = flagship_train(
            cfg, system, batch, params, f"train-{name}", window=OPTION_WINDOW)
        summary[name] = (s_image, rays_s)
        del system, params, batch
        torch.cuda.empty_cache()
    return launches, summary


def colour_volume_kernels(rows, dev):
    """Phase 17, the colour volume (``presets.FLAGSHIP_COLORVOL``: the
    static volume with 8 source views' RGB and masks, 40 channels): K3 at
    C = 40 on the flagship's first eval chunk, bit for bit equal to its
    twin, and K3 at C = 8 on the same points timed beside it; K4 on the
    step's static lookup (the gradient of the first 8 channels of a C = 40
    lookup); K8 on the 2,703,360 voxel centres of the colour volume's
    build, 8 views in one launch. Device time for all three."""
    import torch.nn.functional as F
    from zest_tpu_torch import geometry, presets, render
    from zest_tpu_torch.kernels import trilinear
    from zest_tpu_torch.kernels.color_gather import (gather_colors,
                                                     gather_colors_plain)
    from zest_tpu_torch.kernels.trilinear import (sample_volume,
                                                  sample_volume_plain)
    from zest_tpu_torch.system import unpreprocess
    cfg, system, batch, _ = presets.build(presets.FLAGSHIP_COLORVOL,
                                          presets.FLAGSHIP_SCENE, dev, SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    paths = ("eval_colorvol", "train_colorvol")
    near_far = batch["near_fars"][0]
    with torch.no_grad():
        vol8, _, _ = system.enc_static(batch["images"][:-1],
                                       batch["proj_mats"][:-1], near_far,
                                       pad=cfg.pad)
        imgs = unpreprocess(batch["images"][:-1]).contiguous()
        vol = render.append_color_volume(vol8, imgs, batch["w2cs"],
                                         batch["intrinsics"], near_far,
                                         cfg.pad)
        ndc = system.chunk_rays(batch, 0).ndc.contiguous()
    D, Hv, Wv, C = vol.shape
    n = ndc.numel() // 3
    log(f"[colorvol] volume {tuple(vol.shape)}, eval chunk {tuple(ndc.shape)}")
    vol5 = vol.permute(3, 0, 1, 2)[None].contiguous()
    grid5 = (ndc * 2.0 - 1.0).reshape(1, -1, 1, 1, 3)
    rows.check("trilinear_sample_colorvol", "zest_tpu_torch/csrc/trilinear.cu",
               "zest_tpu/kernels/trilinear.py:279", "sample_volume",
               lambda: sample_volume(vol, ndc),
               lambda: sample_volume_plain(vol, ndc),
               lambda: F.grid_sample(vol5, grid5, align_corners=True),
               1e-5, 20, 4 * C * volume_cells(ndc, (D, Hv, Wv)) + nbytes(ndc)
               + 4 * C * n, 16 * C * n, timing="device", paths=paths)
    with torch.no_grad():
        same = torch.equal(sample_volume(vol, ndc), sample_volume_plain(vol, ndc))
        ms40 = device_ms(lambda: sample_volume(vol, ndc))
        ms8 = device_ms(lambda: sample_volume(vol8, ndc))
    if not same:
        raise AssertionError("K3 at C = 40 differs from its twin")
    log(f"[colorvol] K3 at C = {C} on the eval chunk bitwise equal to its "
        f"twin: {same}; device time {ms40:.4f} ms against {ms8:.4f} ms at "
        f"C = 8 on the same points (PERF.md §6's row: 0.0645 ms on a random "
        f"volume)")
    del vol5

    rays, _, _ = step_inputs(system, batch, cfg, gen)
    ndc_t = rays.ndc.contiguous()
    n_t = ndc_t.numel() // 3
    g = torch.randn((*ndc_t.shape[:-1], C), generator=gen, device=dev)
    v5 = vol8.permute(3, 0, 1, 2)[None].contiguous()
    t5 = (ndc_t * 2.0 - 1.0).reshape(1, -1, 1, 1, 3).contiguous()
    g5 = g[..., :8].reshape(1, -1, 8).permute(0, 2, 1).reshape(
        1, 8, -1, 1, 1).contiguous()
    rows.check("trilinear_grad_volume_colorvol",
               "zest_tpu_torch/csrc/trilinear.cu",
               "zest_tpu/kernels/trilinear.py:303", "volume_grad",
               lambda: trilinear.volume_grad(vol8.shape, ndc_t, g),
               lambda: trilinear.sample_volume_grads_plain(vol, ndc_t, g)[0][
                   ..., :8],
               lambda: torch.ops.aten.grid_sampler_3d_backward(
                   g5, v5, t5, 0, 0, True, [True, False]),
               1e-5, 5, nbytes(ndc_t) + 32 * n_t + nbytes(vol8), 128 * n_t,
               relative=True, timing="device", paths=paths)
    del g, g5, v5, t5

    V, H, W, _ = imgs.shape
    inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32, device=dev)
    with torch.no_grad():
        grid = torch.stack(torch.meshgrid(
            *(torch.linspace(0.0, 1.0, k, device=dev) for k in (D, Hv, Wv)),
            indexing="ij")[::-1], -1)
        pts = geometry.ndc_to_world(grid, batch["w2cs"][0],
                                    batch["intrinsics"][0], inv_scale,
                                    near_far[0], near_far[1], cfg.pad)
        xy = torch.stack([
            geometry.world_to_ndc(pts.reshape(-1, 3), batch["w2cs"][v],
                                  batch["intrinsics"][v], inv_scale, 2.0,
                                  6.0)[..., :2] * inv_scale
            for v in range(V)]).contiguous()
    N = xy.shape[1]
    if N != D * Hv * Wv:
        raise AssertionError(f"{N} voxel centres, the volume has {D * Hv * Wv}")
    imgs_nchw = imgs.permute(0, 3, 1, 2).contiguous()
    grid8 = (xy / torch.tensor([(W - 1) * 0.5, (H - 1) * 0.5], device=dev)
             - 1.0)[:, :, None, :]
    rows.check("color_gather_voxels", "zest_tpu_torch/csrc/color_gather.cu",
               "zest_tpu/kernels/color_gather.py:138", "gather_colors",
               lambda: gather_colors(imgs, xy),
               lambda: gather_colors_plain(imgs, xy),
               lambda: F.grid_sample(imgs_nchw, grid8, padding_mode="border",
                                     align_corners=True),
               1e-5, 5, 12 * image_pixels(xy, H, W) + nbytes(xy)
               + 12 * V * N, 24 * V * N, timing="device", paths=paths)
    log(f"[colorvol] K8 on the {N} voxel centres x {V} views: "
        f"{row_rates(rows, 'color_gather_voxels')}")
    del system, batch, vol, vol8, xy, grid8, imgs_nchw, pts, grid
    torch.cuda.empty_cache()


def _video_end_to_end(tag, field, narrow, flat, code, g) -> None:
    """The video field's whole backward through autograd (the fold, K7 on
    the folded operands, the fold's backward), every input, the code and
    every leaf of the field. At float32 against the twin field's autograd
    on [n, 1087] inputs, within 1e-4 of each one's largest, on the points
    where K7's forward takes the same ReLU branches as the twin's and as
    the folded field's twin (``branch_rows``; the others at most phase 6's
    share). In the bf16-operand mode, whose K7 the gates of phase 9 hold on
    the folded field, the fold's two kernels against their twins inside the
    same backward (1e-5 of each one's largest: K7's pass 2 adds with
    atomics), since on such a slice the twin's bf16 roundings alone exceed
    phase 9's norm-wise bound."""
    from zest_tpu_torch.kernels import fused_mlp, time_codes
    from zest_tpu_torch.models.nerf import append_code
    keep = torch.ones(flat[0].shape[0], dtype=torch.bool, device=g.device)
    if not field.bf16:
        with torch.no_grad():
            pack, offsets = fused_mlp.pack_weights(narrow)
        saved = {}
        fused_mlp.fused_nerf_backward(narrow, *flat, g, pack, offsets,
                                      saved=saved)
        wide = fused_mlp.forward_values_plain(
            field, append_code(flat[0], code), *flat[1:])
        keep = ~(fused_mlp.branch_rows(saved, wide) | fused_mlp.branch_rows(
            saved, fused_mlp.forward_values_plain(narrow, *flat)))
        del wide
    sub = [t[keep].contiguous() for t in (*flat, g)]

    def kernels(p, f, v, c):
        return fused_mlp.fused_nerf_forward(field, p, f, v, c)

    def wide(p, f, v, c):
        return field(append_code(p, c), f, v)

    grads = []
    for fn, ctx in ((kernels, contextlib.nullcontext),
                    (kernels, plain_fold) if field.bf16 else
                    (wide, contextlib.nullcontext)):
        ins = [t.clone().requires_grad_(True) for t in (*sub[:3], code)]
        field.zero_grad(set_to_none=True)
        with torch.enable_grad(), ctx():
            (fn(*ins) * sub[3]).sum().backward()
        grads.append([t.grad for t in ins]
                     + [p.grad.clone() for p in field.parameters()])
    field.zero_grad(set_to_none=True)
    names = ["d_pts", "d_feats", "d_views", "d_code"] + [
        k for k, _ in field.named_parameters()]
    limit = 1e-5 if field.bf16 else 1e-4
    worst = 0.0
    for name, a, b in zip(names, *grads):
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        worst = max(worst, err)
        if not err <= limit:
            raise AssertionError(f"{tag} {name}: {err} of its largest, limit "
                                 f"{limit}")
    dropped = int((~keep).sum())
    against = ("the same backward with the fold's twins" if field.bf16 else
               f"the twin's autograd on [n, {field.in_ch_pts + field.code_dim}]"
               f" inputs")
    log(f"[{tag}] the whole backward (fold, K7, the fold's backward) against "
        f"{against}: worst {worst:.3e} of the largest over every input, the "
        f"code and {len(names) - 4} leaves, on {int(keep.sum())} points"
        + (f" ({dropped} with other ReLU branches left out)"
           if not field.bf16 else ""))
    if dropped > max(F32_FLIPPED_FLOOR, F32_FLIPPED_SHARE * len(keep)):
        raise AssertionError(f"{tag}: {dropped} points on other branches")


@contextlib.contextmanager
def plain_fold():
    """The fold's two kernels replaced by their twins while a forward and
    its backward run."""
    from zest_tpu_torch.kernels import time_codes
    saved = time_codes._launch_fold, time_codes.fold_codes_grad
    time_codes._launch_fold = time_codes.fold_codes_plain
    time_codes.fold_codes_grad = time_codes.fold_codes_grad_plain
    try:
        yield
    finally:
        time_codes._launch_fold, time_codes.fold_codes_grad = saved


def video_kernels(rows, dev, cfg, system, batch, tag):
    """Phase 17, the video geometry (``presets.FLAGSHIP_VIDEO``: MVSNeRF's
    4-output static field with 1,024 time-code channels, 3 source views) in
    the system's mode: the fold and its backward against their twins; K6
    on a VIDEO_SLICE-point slice of the first eval chunk and of the step-0
    pass against the twin field with 1,087 inputs (on [n, 1087] inputs),
    at float32 also within max(8 x the twin's, 2^-20) of a float64 twin
    (phase 3's gate), its operand packs equal to their twins' and the
    folded pack equal to ``folded_field``'s bit for bit; K7 on the whole
    step-0 pass under phase 6's or 9's gates on the folded field (the same
    operands; no [n, 1087] input is needed there), in the bf16 mode also on
    the pass's slice, then the whole backward on the step's slice
    (``_video_end_to_end``). Rows ``*_video``, launches of ``tag``'s
    paths."""
    from zest_tpu_torch.kernels import fused_mlp, time_codes
    from zest_tpu_torch.models.nerf import append_code
    field = system.nerf_static
    bf16 = field.bf16
    sfx = "_bf16" if bf16 else ""
    paths = (f"eval_{tag}", f"train_{tag}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    src = "zest_tpu_torch/csrc/"
    with torch.no_grad():
        code = system.time_code(batch)
        P, T = field.in_ch_pts, field.code_dim
        lins = [field.pts_linears[i] for i in fused_mlp.code_layers(field)]
        wc = torch.stack([lin.weight[:, P:P + T] for lin in lins]).contiguous()
        b = torch.stack([lin.bias for lin in lins]).contiguous()
    L, Wd = b.shape
    d_c = torch.randn(b.shape, generator=gen, device=dev)
    rows.check("fold_codes" + sfx, src + "time_codes.cu",
               "zest_tpu/kernels/fused_mlp.py:376", "fold_codes",
               lambda: time_codes.fold_codes(code, wc, b, bf16),
               lambda: time_codes.fold_codes_plain(code, wc, b, bf16),
               lambda: torch.matmul(wc.view(L * Wd, T), code), 1e-5, 20,
               nbytes(code, wc, b) + 4 * L * Wd, 2 * L * Wd * T,
               timing="device", paths=paths)
    rows.check("fold_codes_grad" + sfx, src + "time_codes.cu",
               "zest_tpu/kernels/fused_mlp.py:398", "fold_codes_grad",
               lambda: time_codes.fold_codes_grad(code, wc, d_c, bf16),
               lambda: time_codes.fold_codes_grad_plain(code, wc, d_c, bf16),
               lambda: torch.matmul(d_c.view(1, -1), wc.view(-1, T)), 1e-5,
               20, 2 * nbytes(code, wc) + nbytes(d_c), 3 * L * Wd * T,
               relative=True, timing="device", paths=paths)

    narrow = fused_mlp.folded_field(field, code)
    with torch.no_grad():
        pack, offsets = fused_mlp.pack_weights(field, code)
        if not torch.equal(pack, fused_mlp.pack_weights(narrow)[0]):
            raise AssertionError("the folded pack differs from folded_field's")
        makes = ([(fused_mlp.pack_bf16, fused_mlp.pack_bf16_plain),
                  (fused_mlp.pack_bf16_bwd, fused_mlp.pack_bf16_bwd_plain)]
                 if bf16 else [(fused_mlp.pack_tc32,
                                fused_mlp.pack_tc32_plain)])
        for make, plain in makes:
            if not torch.equal(make(narrow, pack, offsets),
                               plain(narrow, pack, offsets)[0]):
                raise AssertionError(f"{make.__name__} of the video field "
                                     f"differs from its twin")
    fwd = ("fused_nerf_bf16" if bf16 else "fused_nerf") + "_video"
    tol = BF16_FIELD_TOL if bf16 else 1e-4
    _, field_inputs = chunk_inputs(system, batch)
    eval_flat = [t.reshape(-1, t.shape[-1])[:VIDEO_SLICE].contiguous()
                 for t in field_inputs["static"]]
    del field_inputs
    _, _, passes = step_inputs(system, batch, cfg, gen)
    step_pass = [t.reshape(-1, t.shape[-1]).contiguous()
                 for t in passes["static"][1]]
    step_flat = [t[:VIDEO_SLICE] for t in step_pass]
    del passes
    n = VIDEO_SLICE
    f32_ops, bf16_ops, tf32_ops = field_ops(narrow, n, 1, True)
    for label, flat in (("eval chunk", eval_flat), ("step-0 pass", step_flat)):
        wide = (append_code(flat[0], code), *flat[1:])
        kern = functools.partial(fused_mlp.fused_nerf_forward, field, *flat,
                                 code)
        twin = functools.partial(field, *wide)
        if label == "eval chunk":
            rows.check(fwd, src + ("fused_mlp_tc.cu" if bf16 else
                                   "fused_mlp_tc32.cu"),
                       "zest_tpu/kernels/fused_mlp.py:376",
                       "fused_nerf_forward", kern, twin, None, tol, 3,
                       nbytes(*flat) + 4 * n * field.out_ch
                       + 4 * sum(p.numel() for p in narrow.parameters()),
                       f32_ops, flops_bf16=bf16_ops, paths=paths,
                       flops_tf32=tf32_ops)
        err, shapes = rows.verify(fwd, kern, twin, tol)
        log(f"[{tag}] K6 with the time code folded, on a {n}-point slice of "
            f"the {label}: shapes {shapes}, max_abs_err {err:.3e} against the "
            f"twin on {tuple(wide[0].shape)} (tol {tol:g}) -> ok")
        if not bf16:
            with torch.no_grad():
                out, ref = kern(), twin()
            got, own = float64_distances(field, wide, (out, ref))
            limit = max(F32_CLASS_FACTOR * own, F32_CLASS_FLOOR)
            log(f"[{tag}] K6 on the {label} slice, norm-wise from a float64 "
                f"twin of the 1,087-input field {got:.3e}, the float32 "
                f"twin's {own:.3e} (limit {limit:.3e})")
            if not got <= limit:
                raise AssertionError(f"K6 video float32 on the {label}: {got}")
        del wide

    bwd = ("fused_nerf_backward_bf16" if bf16 else "fused_nerf_backward") \
        + "_video"
    check_field_backward(rows, bwd, {"step-0 pass": (narrow, step_pass)},
                         gen, BF16_FIELD_GRAD_TOL if bf16 else 1e-4, paths,
                         src + ("fused_mlp_tc_bwd.cu" if bf16 else
                                "fused_mlp_tc32_dx.cu"), suffix="_video",
                         float64_gate=True)
    del step_pass
    g = torch.randn((step_flat[0].shape[0], field.out_ch), generator=gen,
                    device=dev)
    if bf16:
        with torch.no_grad():
            slice_pack, slice_offsets = fused_mlp.pack_weights(narrow)
        hold_bf16_backward(bwd, f"step-0 pass, its first {VIDEO_SLICE} "
                           f"points", narrow, step_flat, g, slice_pack,
                           slice_offsets, float64_gate=True)
        del slice_pack
    _video_end_to_end(tag, field, narrow, step_flat, code, g)
    log(f"[{tag}] K6: {row_rates(rows, fwd)}; K7: {row_rates(rows, bwd)}")
    del narrow, eval_flat, step_flat, g
    torch.cuda.empty_cache()


def video(rows, dev, tmp) -> tuple:
    """Phase 17, the video mode: a Neural 3D Video scene written by
    ``tools.scene_fixtures.write_n3dv_scene`` (``presets.VIDEO_SCENE``: 6
    cameras, 4 frames, so keyframe ids 0-3) through MVSNeRF's file with
    ``--train_video True --num_input 3`` at the loader's 960x640:
    VIDEO_STEPS steps of ``python -m zest_tpu_torch.train``'s ``main`` at
    precision 16 and at float32 (``_train_real``: VIDEO_STEPS x one
    step-0 step's launches, the fold's included), the time codes' rows of
    the frames trained moved in ``ckpts/last`` and no other, and no [n,
    1087] input built on the card; ``train_loop.run_test`` on one test
    frame from each checkpoint (one eval image's launches); then
    ``video_kernels`` at both precisions. Returns ({path: launches},
    {tag: seconds per step})."""
    import dataclasses
    import zest_tpu_torch.system as zsystem
    from zest_tpu_torch import presets, train_loop
    from zest_tpu_torch.checkpoint import restore_path
    from zest_tpu_torch.config import config_parser
    from zest_tpu_torch.kernels import fused_mlp
    from zest_tpu_torch.system import ZestSystem, to_batch
    from zest_tpu_torch.tools import scene_fixtures as sf
    root = Path(tmp)
    scene = Path("configs/lists/neural3Dvideo_test_all.txt").read_text().split()[0]
    t0 = time.perf_counter()
    sf.write_n3dv_scene(root / "n3dv", scene, **presets.VIDEO_SCENE)
    log(f"[video] scene {scene} {presets.VIDEO_SCENE} written in "
        f"{time.perf_counter() - t0:.2f} s")
    args = ["--config", MVSNERF_FILE, "--dataset_name", "neural3Dvideo",
            "--datadir", str(root / "n3dv"), "--finetune_scene", scene,
            "--train_video", "True", "--num_input", "3", "--save_dir",
            str(root / "runs"), "--log_every", "1"]
    train_ds = train_loop.build_datasets(config_parser(args), ("train",))[
        "train"]
    sample = train_ds[0]
    wide = []

    def spy(pts, code, _append=zsystem.append_code):
        if pts.is_cuda:
            wide.append(tuple(pts.shape))
        return _append(pts, code)

    launches, per_step = {}, {}
    for precision in (16, 32):
        tag = "video16" if precision == 16 else "video"
        run = args + ["--expname", f"video_p{precision}", "--precision",
                      str(precision), "--max_train_steps", str(VIDEO_STEPS)]
        saved = zsystem.append_code, fused_mlp.append_code
        zsystem.append_code = fused_mlp.append_code = spy
        try:
            torch.cuda.reset_peak_memory_stats()
            launches[f"train_{tag}"], wall, _ = _train_real(
                f"video, precision {precision}", run, VIDEO_STEPS, sample)
        finally:
            zsystem.append_code, fused_mlp.append_code = saved
        per_step[tag] = wall / VIDEO_STEPS
        if wide:
            raise AssertionError(f"[n, 1087] inputs built on the card: {wide}")
        cfg = config_parser(run)
        seed = max(cfg.seed_everything, 0)
        order = np.random.default_rng(seed).permutation(len(train_ds))
        trained = sorted({int(train_ds.key_frames[scene][train_ds.metas[i][2]])
                          for i in order[:VIDEO_STEPS]})
        last = root / "runs" / f"video_p{precision}" / "ckpts" / "last"
        codes = restore_path(last, "cpu").params["time_codes"]
        init = ZestSystem(cfg).init_params(
            torch.Generator().manual_seed(seed))["time_codes"]
        moved = [int(i) for i in torch.nonzero((codes != init).any(-1))]
        log(f"[video] precision {precision}: peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; time code "
            f"rows trained {trained}, moved in ckpts/last {moved} of "
            f"{codes.shape[0]}; no [n, {cfg.time_code_dim + 63}] tensor on the "
            f"card")
        if moved != trained:
            raise AssertionError(f"time codes moved {moved}, trained {trained}")

        cfg = config_parser(run + ["--ckpt", str(last)])
        test_ds = train_loop.build_datasets(cfg, ("test",))["test"]
        one = test_ds[0]
        expected = expected_eval_launches(ZestSystem(cfg), to_batch(one, "cpu"))
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        out = train_loop.run_test(cfg, {"test": [one]}, quiet=True,
                                  device=dev)
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        got = read_counters()
        _check(f"video test, precision {precision}", got, expected)
        if not all(np.isfinite(v) for v in out.values()):
            raise AssertionError(f"video test metrics {out}")
        launches[f"eval_{tag}"] = got
        log(f"[video] run_test on one frame (keyframe_id "
            f"{int(one['keyframe_id'])}) from ckpts/last at precision "
            f"{precision}: {test_s:.2f} s, {out}, launches {got}")

        system = ZestSystem(cfg).to(dev)
        system.load_state_dict({k: v.to(dev) for k, v in
                                presets.seeded_params(system, SEED).items()})
        batch = to_batch(one, dev)
        _, H, W, _ = batch["images"].shape
        video_kernels(rows, dev, dataclasses.replace(cfg, img_h=H, img_w=W),
                      system, batch, tag)
        del system, batch
        torch.cuda.empty_cache()
    return launches, per_step


def options(rows, dev, tmp) -> tuple:
    """Phase 17: the three model options no configuration file sets. v2
    (``presets.FLAGSHIP_V2``: the flagship's fields additive and plain)
    and the colour volume (``presets.FLAGSHIP_COLORVOL``) through
    ``option_flagships``, the v2 paths without a K6 or K7 launch; the
    colour volume's kernels (``colour_volume_kernels``); the video mode
    (``video``). Returns ({path: launches}, {tag: (s/image, rays/s)},
    {tag: seconds per video step})."""
    from zest_tpu_torch import presets
    t0 = time.perf_counter()
    launches, summary = option_flagships("v2", presets.FLAGSHIP_V2,
                                         presets.FLAGSHIP_SCENE, dev)
    fused = [p for p, c in launches.items() if c["fused_nerf_forward"]
             or c["fused_nerf_backward"] or c["recompute"]]
    if fused:
        raise AssertionError(f"a v2 path launched K6 or K7: {fused}")
    colour_volume_kernels(rows, dev)
    more, colour = option_flagships("colorvol", presets.FLAGSHIP_COLORVOL,
                                    presets.FLAGSHIP_SCENE, dev)
    launches.update(more)
    summary.update(colour)
    video_paths, per_step = video(rows, dev, tmp)
    launches.update(video_paths)
    log(f"[options] phase 17 in {time.perf_counter() - t0:.1f} s")
    return launches, summary, per_step


# --------------------------------------------------------------------------
# phase 18: the last modules (profiling, vis_cnn, the .ckpt loader, sharding,
# the SVS step over a process group)
# --------------------------------------------------------------------------

# each kernel of the training step the trace must name: K1, K6 and K7's
# float32 launches (any one of K7's three)
TRACE_KERNELS = {"K1": ("plane_sweep_warp_kernel",),
                 "K6": ("fused_nerf_tc32_kernel",),
                 "K7": ("recompute_tc32_kernel", "input_grads_tc32_kernel",
                        "wgrad_tc32_kernel")}
# vis_cnn's dumps, card against CPU: phase 4's 1e-4, of max(1, the CPU
# tensor's largest |value|) as ``Rows.verify`` scales a forward output
# (cuDNN's and oneDNN's convolutions differ by up to 1.1e-4 at activations
# up to 5 after eight layers of BatchNorm on the flagship's 8 views)
DUMP_TOL = 1e-4
SPLIT_RANKS = 2              # gloo ranks sharing the one card
SPLIT_LOSS_RTOL = 1e-5
SPLIT_GRAD_TOL = 1e-4        # of each leaf's largest gradient
SPLIT_IMAGE_ATOL = 1e-4
# the split SVS step at precision 16, held as phase 15 holds its 16-bit
# steps: every gradient leaf within twice the one-process step's own
# 16-vs-32 difference plus 1e-3 of its module's largest, every log within
# one bf16 rounding
SPLIT_GRAD_TOL16 = 1e-3
SPLIT_LOG_RTOL16 = 2.0 ** -8


def reference_state_dict(params: dict) -> dict:
    """The port's state dict in the reference's Lightning names (the
    inverse of ``convert.convert_checkpoint``'s renames; the layouts are
    the same)."""
    prefixes = {"nerf_static.": "nerf_static.nerf.",
                "nerf_dynamic.": "nerf_dynamic.nerf.",
                "enc_static.": "encoding_net.", "enc_dy.": "encoding_net_dy."}
    out = {}
    for k, v in params.items():
        head = next(p for p in prefixes if k.startswith(p))
        out[prefixes[head] + k[len(head):]] = v.detach().cpu()
    return out


def _split_rank(mesh, inputs_path, device) -> dict:
    """One rank of phase 18's split step on ``device`` (cuda:0 on the
    card): the training step's loss, logs and gradients, then the eval
    image, each with every launch counter reset first
    (``parallel.dryrun.load_inputs``' inputs)."""
    from zest_tpu_torch.parallel.dryrun import load_inputs
    from zest_tpu_torch.system import ZestSystem
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    card = dev.type == "cuda"
    cfg, batch, params, draws, phase, step = load_inputs(inputs_path, dev)
    system = ZestSystem(cfg).to(dev)
    system.mesh = mesh
    if card:
        torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    loss, logs, grads = system.loss_and_grads(params, batch, draws, phase, step)
    if card:
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step_launches = read_counters()
    reset_counters()
    t0 = time.perf_counter()
    maps = system.make_eval_step()(params, batch)
    if card:
        torch.cuda.synchronize()
    return dict(loss=loss.cpu(), logs={k: v.cpu() for k, v in logs.items()},
                grads={k: v.cpu() for k, v in grads.items()},
                maps={k: v.cpu() for k, v in maps.items()},
                step_launches=step_launches, eval_launches=read_counters(),
                step_s=step_s, eval_s=time.perf_counter() - t0,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30 if card
                else 0.0)


def _profiled_step(cfg, system, batch, params, draws, phase, tmp) -> dict:
    """18(a): ``profile_trace`` around one flagship training step: the
    trace must name K1, K6 and K7's kernels; the step's peak memory from
    ``device_memory_stats``. Returns the step's launches."""
    from zest_tpu_torch.system import TrainState
    from zest_tpu_torch.utils.observability import (device_memory_stats,
                                                    profile_trace)
    opt = system.make_optimizer(8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    with profile_trace(str(tmp / "trace")):
        _, logs = system.make_train_step(opt)(
            TrainState(params, opt.init(params), 0), batch, draws, phase)
    wall = time.perf_counter() - t0
    launches = read_counters()
    _check("profiled step", launches,
           expected_step_launches(system, cfg, batch, phase))
    trace = tmp / "trace" / "trace.json"
    text = trace.read_text()
    named = {k: [n for n in names if n in text]
             for k, names in TRACE_KERNELS.items()}
    peak = device_memory_stats()["cuda:0"]["allocated_bytes.all.peak"]
    log(f"[aux] (a) profile_trace around one flagship step: {wall:.2f} s "
        f"with the profiler, trace {trace.stat().st_size / 2**20:.1f} MiB, "
        f"names {named}; step peak {peak / 2**30:.2f} GiB "
        f"(device_memory_stats), loss {float(logs['train_loss']):.5g}")
    missing = [k for k, v in named.items() if not v]
    if missing:
        raise AssertionError(f"the trace names no kernel of {missing}")
    return launches


def _vis_cnn(cfg, system, sample, dev, tmp) -> tuple:
    """18(b), on the card: ``run_test`` with ``vis_cnn`` on one frame,
    the dumps under ``tmp/vis_cuda``. Returns (its launches, seconds)."""
    import dataclasses
    import warnings
    from zest_tpu_torch import train_loop
    from zest_tpu_torch.system import to_batch
    vcfg = dataclasses.replace(cfg, vis_cnn=True, save_dir=str(tmp / "runs"),
                               expname="vis", save_test=str(tmp / "vis_cuda"))
    expected = expected_eval_launches(system, to_batch(sample, dev))
    expected["homo_warp_cm"] *= 2           # the dump's encoder pass
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "run_test called without --ckpt")
        out = train_loop.run_test(vcfg, {"test": [sample]}, quiet=True,
                                  device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    _check("vis_cnn run_test", launches, expected)
    if not all(np.isfinite(v) for v in out.values()):
        raise AssertionError(f"vis_cnn test metrics {out}")
    return launches, wall


def _cpu_dump(cfg, sample, out_dir) -> float:
    """18(b), on the CPU: the same dump from ``run_test``'s weights (seed
    0, no ckpt). Returns its seconds."""
    from zest_tpu_torch.models import MVSEncoder
    from zest_tpu_torch.system import ZestSystem
    from zest_tpu_torch.utils.introspect import dump_encoder_activations
    t0 = time.perf_counter()
    weights = ZestSystem(cfg).init_params(torch.Generator().manual_seed(0))
    encoder = MVSEncoder()
    encoder.load_state_dict({k[len("enc_static."):]: v for k, v in
                             weights.items() if k.startswith("enc_static.")})
    cpu = {k: torch.as_tensor(np.asarray(sample[k])) for k in
           ("images", "proj_mats", "near_fars")}
    dump_encoder_activations(encoder, cpu["images"][:-1],
                             cpu["proj_mats"][:-1], cpu["near_fars"][0],
                             cfg.pad, out_dir)
    return time.perf_counter() - t0


def _compare_dumps(card_dir, cpu_dir) -> str:
    """18(b): the card's dumps against the CPU's: the same files, every
    tensor within DUMP_TOL x max(1, its largest |value|). Returns a
    summary."""
    def tree(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                      if p.is_file())
    files = tree(card_dir)
    if files != tree(cpu_dir):
        raise AssertionError("vis_cnn's files differ between the card and "
                             "the CPU")
    worst, n_bytes = (0.0, 0.0, ""), 0
    for f in files:
        if not f.endswith(".npy"):
            continue
        a, b = np.load(card_dir / f), np.load(cpu_dir / f)
        n_bytes += a.nbytes
        if a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError(f"{f}: shape {a.shape} against {b.shape} "
                                 f"or non-finite values")
        d = float(np.abs(a - b).max())
        limit = DUMP_TOL * max(1.0, float(np.abs(b).max()))
        worst = max(worst, (d / limit, d, f))
        if d > limit:
            raise AssertionError(f"{f}: card against CPU {d:.3e}, limit "
                                 f"{limit:.3e}")
    return (f"{len(files)} files, {n_bytes / 2**30:.2f} GiB of .npy; every "
            f"tensor within {DUMP_TOL:g} x max(1, its largest |value|) of the "
            f"CPU's (closest: {worst[2]}, |d| {worst[1]:.3e}, {worst[0]:.3f} "
            f"of its limit)")


def _ckpt_eval(cfg, params, batch, dev, tmp) -> dict:
    """18(c): a Lightning-layout ``.ckpt`` in the reference's names, from
    the seeded flagship weights, through ``convert_checkpoint`` and
    ``load_state_dict(strict=True)`` to one eval image, logging its
    s/image. Returns its launches."""
    import argparse
    from zest_tpu_torch.convert import convert_checkpoint
    from zest_tpu_torch.system import ZestSystem
    path = tmp / "reference.ckpt"
    torch.save({"epoch": 0, "global_step": 0,
                "state_dict": reference_state_dict(params),
                "hyper_parameters": argparse.Namespace(expname="flagship")},
               path)
    t0 = time.perf_counter()
    converted = convert_checkpoint(path, cfg)
    convert_s = time.perf_counter() - t0
    moved = [k for k in params if not torch.equal(converted[k],
                                                  params[k].cpu())]
    if moved:
        raise AssertionError(f"converted leaves differ: {moved[:5]}")
    system = ZestSystem(cfg).to(dev)
    system.load_state_dict({k: v.to(dev) for k, v in converted.items()},
                           strict=True)
    weights = dict(system.state_dict())
    step = system.make_eval_step()
    expected = expected_eval_launches(system, batch)
    times = []
    for run in range(2):
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        maps = step(weights, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if run == 0:
            launches = read_counters()
    _check("converted checkpoint's eval image", launches, expected)
    key = blended(system)
    if not all(bool(torch.isfinite(v).all()) for v in maps.values()) or \
            float(maps[key].std()) <= 0.0:
        raise AssertionError("the converted checkpoint's image is not finite "
                             "or constant")
    log(f"[aux] (c) reference .ckpt ({path.stat().st_size / 2**20:.1f} MiB, "
        f"{len(converted)} tensors) converted in {convert_s:.2f} s, equal to "
        f"the seeded weights; eval image {times[0]:.3f} s first run, "
        f"{times[1]:.3f} s/image; launches {launches}")
    return launches


def _split(cfg, system, batch, params, draws, phase, tmp) -> dict:
    """18(d): the flagship step and an eval image split over SPLIT_RANKS
    gloo ranks on the one card, against the one-process step and image.
    Returns ({path: rank 0's launches}, the ranks' results)."""
    import dataclasses
    from zest_tpu_torch.parallel import dryrun
    t0 = time.perf_counter()
    loss, logs, grads = system.loss_and_grads(params, batch, draws, phase, 0)
    maps = system.make_eval_step()(params, batch)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    inputs = tmp / "split_inputs.pt"
    dryrun.save_inputs(inputs, cfg, batch, params, draws, phase, 0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = dryrun.run_ranks(SPLIT_RANKS, _split_rank, str(inputs),
                             str(batch["images"].device))
    spawn_s = time.perf_counter() - t0
    rays = cfg.batch_size + cfg.num_extra_samples
    half = dataclasses.replace(cfg, batch_size=cfg.batch_size // SPLIT_RANKS,
                               num_extra_samples=cfg.num_extra_samples
                               // SPLIT_RANKS)
    expected_step = expected_step_launches(system, half, batch, phase)
    expected_eval = expected_eval_launches(system, batch)
    diffs = {}
    for r, got in enumerate(ranks):
        _check(f"split step, rank {r}", got["step_launches"], expected_step)
        _check(f"split eval, rank {r}", got["eval_launches"], expected_eval)
        rel = abs(float(got["loss"]) - float(loss)) / abs(float(loss))
        if rel > SPLIT_LOSS_RTOL:
            raise AssertionError(f"rank {r}'s loss {float(got['loss'])} "
                                 f"against {float(loss)}: {rel:.2e}")
        for k, g in grads.items():
            g = g.cpu()
            err = float((got["grads"][k] - g).abs().max())
            scale = max(float(g.abs().max()), 1e-30)
            diffs[k] = max(diffs.get(k, 0.0), err / scale)
            if err > SPLIT_GRAD_TOL * scale:
                raise AssertionError(f"rank {r}'s gradient {k}: {err:.3e} "
                                     f"of {scale:.3e}")
        worst_map = max(float((got["maps"][k] - maps[k].cpu()).abs().max())
                        for k in maps)
        if worst_map > SPLIT_IMAGE_ATOL:
            raise AssertionError(f"rank {r}'s split image: {worst_map:.3e}")
        log(f"[aux] (d) rank {r}: loss {float(got['loss']):.7g} (one process "
            f"{float(loss):.7g}, rel {rel:.2e}), image max |d| "
            f"{worst_map:.3e}, step {got['step_s']:.2f} s, eval image "
            f"{got['eval_s']:.2f} s, peak memory {got['peak_gib']:.2f} GiB")
    groups = {}
    for k, v in diffs.items():
        n, differ, worst = groups.get(k.split(".")[0], (0, 0, 0.0))
        groups[k.split(".")[0]] = (n + 1, differ + (v > 0), max(worst, v))
    top = sorted(((v, k) for k, v in diffs.items() if v > 0), reverse=True)
    log(f"[aux] (d) {SPLIT_RANKS} gloo ranks on one card, {rays} rays "
        f"({rays // SPLIT_RANKS} a rank): {spawn_s:.1f} s for the ranks "
        f"(start included), the one-process step and image {ref_s:.2f} s; "
        f"gradient leaves that differ from the one-process step, by module "
        f"(differing / leaves, largest of a leaf's largest): " + "; ".join(
            f"{g} {d} / {n}, {w:.2e}" for g, (n, d, w) in groups.items())
        + "; the largest: " + ", ".join(f"{k} {v:.2e}" for v, k in top[:6]))
    return {"split_train": ranks[0]["step_launches"],
            "split_eval": ranks[0]["eval_launches"]}


def _split_gan_rank(mesh, inputs_paths, device) -> list:
    """One rank of phase 18's split SVS steps on ``device``: for each of
    ``parallel.dryrun.save_inputs``' files, ``dryrun.gan_step`` with the
    rays split over ``mesh`` and every launch counter reset first, then
    the same step again for its warm seconds, and at float32 a third time
    for its share of the encoders' weight gradients summed in float64
    (``_conv_rounding``). Returns one dict per file (``gan_step``'s, on
    the CPU, with the first run's launches, the first two runs' seconds,
    the peak memory and ``wide``, that float64 share)."""
    from zest_tpu_torch import system_gan
    from zest_tpu_torch.parallel import dryrun
    from zest_tpu_torch.system import ZestSystem
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    card = dev.type == "cuda"

    def synced():
        if card:
            torch.cuda.synchronize()
        return time.perf_counter()
    results = []
    for path in inputs_paths:
        cfg, batch, state, draws, phase, _ = dryrun.load_inputs(path, dev)
        gan = system_gan.GanSystem(ZestSystem(cfg)).to(dev)
        gan.system.mesh = mesh
        if card:
            torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = synced()
        out = dryrun.gan_step(gan, state, batch, draws, phase)
        first_s = synced() - t0
        launches = read_counters()
        t0 = synced()
        dryrun.gan_step(gan, state, batch, draws, phase)
        warm_s = synced() - t0
        out["wide"] = {} if cfg.precision == 16 else _conv_rounding(
            gan.system, lambda: dryrun.gan_step(gan, state, batch, draws,
                                                phase))[2]
        out["state"] = out["state"]._asdict()
        results.append(dict(
            dryrun.map_tensors(out, lambda t: t.detach().cpu()),
            launches=launches, first_s=first_s, warm_s=warm_s,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30 if card
            else 0.0))
        del gan, state, batch
    return results


def _conv_rounding(system, step) -> tuple:
    """``step()`` (a GAN step -> ``dryrun.gan_step``'s dict) with every
    convolution of the encoders' input and output cotangent captured:
    (its result, {weight leaf: the largest |difference| of the step's
    float32 gradient from the same convolution's weight gradient summed
    in float64 from the captured tensors}: the float32 rounding of each
    convolution's weight-gradient sum, {weight leaf: that float64 weight
    gradient, on the CPU})."""
    kinds = (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.ConvTranspose3d)
    seen, hooks = {}, []
    for name, mod in system.named_modules():
        if name.startswith("enc_") and isinstance(mod, kinds):
            def keep(m, inp, out, name=name):
                seen[name] = [inp[0].detach()]
                out.register_hook(lambda g: seen[name].append(g.detach()))
            hooks.append(mod.register_forward_hook(keep))
    try:
        out = step()
    finally:
        for h in hooks:
            h.remove()
    rounding, wide = {}, {}
    for name, (x, g) in seen.items():
        mod = system.get_submodule(name)
        kw = dict(stride=mod.stride, padding=mod.padding,
                  dilation=mod.dilation, groups=mod.groups)
        weight_grad = (torch.nn.grad.conv2d_weight if x.dim() == 4
                       else torch.nn.grad.conv3d_weight)
        # a transposed convolution's weight gradient is the convolution's
        # with its input and its output cotangent swapped
        a, b = ((g, x) if isinstance(mod, torch.nn.ConvTranspose3d)
                else (x, g))
        leaf = f"{name}.weight"
        wide[leaf] = weight_grad(a.double(), mod.weight.shape, b.double(),
                                 **kw)
        rounding[leaf] = float((out["gen_grads"][leaf].double()
                                - wide[leaf]).abs().max())
        wide[leaf] = wide[leaf].cpu()
    return out, rounding, wide


def _grad_margins(got, ref, tol: float, again=None, ref32=None,
                  rounding=None) -> list:
    """[(err / limit, leaf, err / the leaf's largest)] of each gradient
    leaf of ``got`` against ``ref`` (trees of gen_grads, disc_grads,
    depth_grads), largest first. At float32 (``again``: the same
    one-process step run a second time) the limit is tol times the leaf's
    own largest plus twice the leaf's own run-to-run difference (K4's
    float atomics sum a volume's gradient in another order in every run)
    and, for an encoder's convolution, twice its float32 rounding
    (``_conv_rounding``: cuDNN's weight-gradient sums are up to 1.6e-4 of
    a leaf's largest from float64 on the flagship). With ``ref32``, phase
    15's 16-bit rule: twice the 16-vs-32 difference of ``ref`` from
    ``ref32`` (the leaf's, or its module's largest for an encoder) plus tol
    times the module's largest."""
    out = []
    for tree in ("gen_grads", "disc_grads", "depth_grads"):
        if set(got[tree]) != set(ref[tree]):
            raise AssertionError(f"{tree}: the leaves differ")
        scale, spread_m = {}, {}
        for k, g in ref[tree].items():
            m = k.split(".")[0]
            scale[m] = max(scale.get(m, 0.0), float(g.abs().max()))
            if ref32 is not None:
                spread_m[m] = max(spread_m.get(m, 0.0), float(
                    (g.cpu() - ref32[tree][k].cpu()).abs().max()))
        for k, g in ref[tree].items():
            m = k.split(".")[0]
            err = float((got[tree][k].cpu() - g.cpu()).abs().max())
            if ref32 is None:
                limit = tol * float(g.abs().max()) + 2 * float(
                    (g - again[tree][k]).abs().max())
                if tree == "gen_grads":
                    limit += 2 * (rounding or {}).get(k, 0.0)
            else:
                spread = (spread_m[m] if m.startswith("enc_") else float(
                    (g.cpu() - ref32[tree][k].cpu()).abs().max()))
                limit = 2 * spread + tol * scale[m]
            out.append((err / max(limit, 1e-30), f"{tree[:-6]} {k}",
                        err / max(float(g.abs().max()), 1e-30)))
    return sorted(out, reverse=True)


def _split_gan(dev, tmp) -> dict:
    """18(e): the SVS step (``FLAGSHIP_SVS``, one 64x64 GRAF patch of 4,096
    rays) at float32 and at precision 16 split over SPLIT_RANKS gloo ranks
    on the one card, against the one-process ``GanSystem`` step on the same
    seeded weights and draws: at float32 every log within SPLIT_LOSS_RTOL
    and every gradient leaf (generator and discriminator) within
    SPLIT_GRAD_TOL of its own largest plus twice the one-process step's own
    difference from itself run again and, for the encoders' convolutions,
    twice their float32 rounding (``_conv_rounding``); at precision 16 each
    log within
    SPLIT_LOG_RTOL16 and each leaf within twice the one-process steps'
    16-vs-32 difference plus SPLIT_GRAD_TOL16 of its module's largest
    (``_grad_margins``); the ranks' states after the step (the discriminator's
    parameters, spectral ``u``s and optimizer state, and the generator's)
    equal bit for bit; each rank's launches a step's at 2,048 rays.
    Returns {path: rank 0's launches}."""
    import dataclasses
    from zest_tpu_torch import presets, sampling
    from zest_tpu_torch.parallel import dryrun
    from zest_tpu_torch.system import phase_for_step
    presets.write_random_lpips()
    paths, refs, expected, tags = [], [], [], []
    for tag, preset in (("svs", presets.FLAGSHIP_SVS),
                        ("svs16", presets.FLAGSHIP_SVS_16)):
        cfg, gan, batch, state = presets.build_gan(
            preset, presets.MVSNERF_SCENE, dev, SEED)
        phase = phase_for_step(cfg, 0)
        draws = sampling.sample_draws(
            torch.Generator(device=dev).manual_seed(SEED + 22), cfg,
            cfg.img_h, cfg.img_w, 0, False, 0)
        rays = draws.xs.shape[0]
        half = dataclasses.replace(cfg, batch_size=rays // SPLIT_RANKS,
                                   num_extra_samples=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.perf_counter()
        ref = dryrun.gan_step(gan, state, batch, draws, phase)
        torch.cuda.synchronize()
        ref["s"] = time.perf_counter() - t0
        ref["launches"] = read_counters()
        ref["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        dryrun.gan_step(gan, state, batch, draws, phase)
        torch.cuda.synchronize()
        ref["warm_s"] = time.perf_counter() - t0
        ref["again"], ref["rounding"], ref["wide"] = _conv_rounding(
            gan.system, lambda: dryrun.gan_step(gan, state, batch, draws,
                                                phase)) \
            if cfg.precision != 16 else (
                dryrun.gan_step(gan, state, batch, draws, phase), {}, {})
        _check(f"one-process {tag} step", ref["launches"],
               expected_step_launches(gan.system, cfg, batch, phase))
        expected.append(expected_step_launches(gan.system, half, batch, phase))
        paths.append(str(tmp / f"split_{tag}.pt"))
        dryrun.save_inputs(paths[-1], cfg, batch, state, draws, phase, 0)
        refs.append(ref)
        tags.append((tag, rays))
        del gan, state, batch
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = dryrun.run_ranks(SPLIT_RANKS, _split_gan_rank, paths,
                             str(dev))
    spawn_s = time.perf_counter() - t0
    launches, failed = {}, []
    for i, ((tag, rays), ref) in enumerate(zip(tags, refs)):
        got = [r[i] for r in ranks]
        p16 = tag.endswith("16")
        rounding = {k: v / float(ref["gen_grads"][k].abs().max())
                    for k, v in ref["rounding"].items()}
        for r, g in enumerate(got):
            _check(f"split {tag} step, rank {r}", g["launches"], expected[i])
            for k, v in ref["logs"].items():
                a, b = float(g["logs"][k]), float(v)
                rtol = SPLIT_LOG_RTOL16 if p16 else SPLIT_LOSS_RTOL
                if not (np.isfinite(a) and abs(a - b) <= rtol * abs(b)):
                    failed.append(f"split {tag} rank {r} log {k}: {a} "
                                  f"against {b}")
            margins = (_grad_margins(g, ref, SPLIT_GRAD_TOL16,
                                     ref32=refs[0]) if p16 else
                       _grad_margins(g, ref, SPLIT_GRAD_TOL, ref["again"],
                                     rounding=ref["rounding"]))
            if margins[0][0] > 1.0:
                failed.append(f"split {tag} rank {r}: {margins[0][1]} at "
                              f"{margins[0][0]:.3f} of its limit")
            log(f"[aux] (e) split {tag}, rank {r}: step {g['first_s']:.2f} s "
                f"first, {g['warm_s']:.3f} s warm (one process "
                f"{ref['s']:.3f} / {ref['warm_s']:.3f} s), peak memory "
                f"{g['peak_gib']:.2f} GiB "
                f"(one process {ref['peak_gib']:.2f}); G_loss "
                f"{float(g['logs']['G_loss']):.7g} (one process "
                f"{float(ref['logs']['G_loss']):.7g}); the nearest leaves, "
                f"of their limit (of their own largest): " + ", ".join(
                    f"{k} {v:.3f} ({e:.2e})" for v, k, e in margins[:4])
                + "; the largest of a leaf's own largest: " + ", ".join(
                    f"{k} {e:.2e}" for _, k, e in sorted(
                        margins, key=lambda x: -x[2])[:3])
                + ("" if p16 else "; their float32 rounding (of the leaf's "
                   "largest, from float64): " + ", ".join(
                       f"{k} {rounding[k[4:]]:.2e}" for _, k, _ in margins[:3]
                       if k[4:] in rounding)))
        if not _tree_equal(got[0]["state"], got[1]["state"]):
            failed.append(f"split {tag}: the ranks' states differ")
        if ref["wide"]:
            # the same sums in float64 from each step's own inputs and
            # cotangents: the split hands the encoders the same cotangent
            wide = sorted(((float((sum(g["wide"][k] for g in got) - w).abs()
                                  .max()) / float(w.abs().max()), k)
                           for k, w in ref["wide"].items()), reverse=True)
            log(f"[aux] (e) split {tag}: the encoders' {len(wide)} "
                f"convolutions' weight gradients summed in float64, the "
                f"ranks' shares against the one-process step's, of the "
                f"leaf's largest: " + ", ".join(f"{k} {v:.2e}"
                                                for v, k in wide[:3]))
            if wide[0][0] > SPLIT_GRAD_TOL:
                failed.append(f"split {tag}: float64 {wide[0][1]} at "
                              f"{wide[0][0]:.2e}")
        again = _grad_margins(ref["again"], ref, 0.0, ref["again"])
        log(f"[aux] (e) {tag}: the one-process step run again differs most "
            f"in " + ", ".join(f"{k} {e:.2e}" for _, k, e in sorted(
                again, key=lambda x: -x[2])[:3]) + " of the leaf's largest")
        worst_log = max(abs(float(got[0]["logs"][k]) - float(v))
                        / abs(float(v)) for k, v in ref["logs"].items())
        worst_disc = max(float((got[0]["disc_grads"][k] - g.cpu()).abs()
                               .max() / g.abs().max())
                         for k, g in ref["disc_grads"].items())
        log(f"[aux] (e) split {tag}: {SPLIT_RANKS} gloo ranks on one card, "
            f"{rays} rays ({rays // SPLIT_RANKS} a rank); largest log "
            f"difference {worst_log:.2e} relative, discriminator leaf "
            f"{worst_disc:.2e} of its largest; the ranks' states after "
            f"the step equal bit for bit ({len(got[0]['state']['disc_vars'])}"
            f" spectral u); launches {got[0]['launches']}")
        launches[f"split_{tag}"] = got[0]["launches"]
    log(f"[aux] (e) the split SVS steps: {spawn_s:.1f} s for the ranks "
        f"(start included)")
    if failed:
        raise AssertionError("; ".join(failed))
    return launches


def _dryrun_cli() -> None:
    """18(f): ``python -m zest_tpu_torch.parallel.dryrun 2``, which runs
    its ranks on the card by default."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          "zest_tpu_torch.parallel.dryrun", "2"],
                         capture_output=True, text=True, timeout=300)
    line = out.stdout.strip().splitlines()[-1:] or [""]
    log(f"[aux] (f) python -m zest_tpu_torch.parallel.dryrun 2: exit "
        f"{out.returncode} in {time.perf_counter() - t0:.1f} s: {line[0]}")
    if out.returncode != 0 or "on cuda:0 OK" not in line[0]:
        raise AssertionError(f"dryrun 2 on the card: {out.stderr[-2000:]}")


def aux_modules(dev, tmp) -> tuple:
    """Phase 18: the modules of the last slices at flagship width, float32
    (``presets.FLAGSHIP_TRAIN`` on ``FLAGSHIP_SCENE``): (a) a profiled
    training step, (b) ``vis_cnn``, (c) the reference ``.ckpt`` loader,
    (d) the step and an eval image split over two gloo ranks on the card;
    then (e) the SVS step split over two ranks at both precisions
    (``_split_gan``) and (f) ``python -m zest_tpu_torch.parallel.dryrun
    2`` on the card.
    Returns ({path: launches}, the phase's seconds)."""
    from zest_tpu_torch import presets, sampling
    from zest_tpu_torch.system import phase_for_step
    t0 = time.perf_counter()
    cfg, system, batch, params = presets.build(presets.FLAGSHIP_TRAIN,
                                               presets.FLAGSHIP_SCENE, dev, SEED)
    sample = presets.scene_of(presets.FLAGSHIP_TRAIN, presets.FLAGSHIP_SCENE)[
        presets.TARGET_FRAME]
    phase = phase_for_step(cfg, 0)
    draws = sampling.sample_draws(
        torch.Generator(device=dev).manual_seed(SEED + 18), cfg, cfg.img_h,
        cfg.img_w, int(batch["motion_count"]), phase.extra_samples)
    launches = {"profiled_train": _profiled_step(cfg, system, batch, params,
                                                 draws, phase, tmp)}
    launches["vis_cnn"], vis_s = _vis_cnn(cfg, system, sample, dev, tmp)
    # the CPU's dump is host work: it runs beside (c) and (d), whose ranks
    # mostly wait for their own start and for the card
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cpu_dump = pool.submit(_cpu_dump, cfg, sample, tmp / "vis_cpu")
        launches["ckpt_eval"] = _ckpt_eval(cfg, params, batch, dev, tmp)
        launches.update(_split(cfg, system, batch, params, draws, phase, tmp))
        cpu_s = cpu_dump.result()
    del system, params, batch
    torch.cuda.empty_cache()
    launches.update(_split_gan(dev, tmp))
    _dryrun_cli()
    t1 = time.perf_counter()
    summary = _compare_dumps(tmp / "vis_cuda", tmp / "vis_cpu")
    log(f"[aux] (b) run_test with vis_cnn on one flagship frame: {vis_s:.2f} "
        f"s (eval and dump); the CPU's dump {cpu_s:.2f} s (beside (c) and "
        f"(d)); compared in {time.perf_counter() - t1:.2f} s: {summary}; "
        f"launches {launches['vis_cnn']}")
    seconds = time.perf_counter() - t0
    log(f"[aux] phase 18 in {seconds:.1f} s")
    return launches, seconds


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
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
    with tempfile.TemporaryDirectory() as tmp:
        loop_cfg, loop_state, loop_sps = quality(dev, system16, batch16,
                                                 params16, train16, tmp)
        del system16, params16, batch16
        torch.cuda.empty_cache()
        per_pose = paths(dev, tmp, loop_cfg, loop_state)
    new_paths, summary = ablations(rows, dev)
    with tempfile.TemporaryDirectory() as tmp:
        svs_paths, svs_summary = svs(dev, tmp, new_paths)
    n_rays = cfg.batch_size + cfg.num_extra_samples
    step_ms = {32: 1e3 * n_rays / rays_s, 16: 1e3 * n_rays / rays_s16}
    with tempfile.TemporaryDirectory() as tmp:
        real_paths = real_data(rows, dev, tmp, step_ms, loop_sps)
    with tempfile.TemporaryDirectory() as tmp:
        option_paths, option_summary, video_step = options(rows, dev, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        aux_paths, aux_s = aux_modules(dev, Path(tmp))
    log(f"[summary] flagship eval s/image: float32 {s_image:.3f}, precision "
        f"16 {s_image16:.3f}; train_rays_per_sec: float32 {rays_s:.1f}, "
        f"precision 16 {rays_s16:.1f}; path s/pose: float32 "
        f"{per_pose[32][0]:.3f}, precision 16 {per_pose[16][0]:.3f} (volumes "
        f"{per_pose[32][1]:.3f} and {per_pose[16][1]:.3f} s once per frame)")
    log(f"[summary] MVSNeRF flagship s/image: float32 "
        f"{summary['mvsnerf'][0]:.3f}, precision 16 "
        f"{summary['mvsnerf16'][0]:.3f}; train_rays_per_sec: float32 "
        f"{summary['mvsnerf'][1]:.1f}, precision 16 "
        f"{summary['mvsnerf16'][1]:.1f}; one eval image (first run, s): "
        + ", ".join(f"{fam} {summary[fam][0]:.3f}"
                    for fam in ("nsff", "static_vol", "dy_vol")))
    log("[summary] SVS flagship train_rays_per_sec: float32 "
        f"{svs_summary['svs'][0]:.1f}, precision 16 "
        f"{svs_summary['svs16'][0]:.1f}; seconds of a step's parts: " + "; ".join(
            f"{tag} " + ", ".join(f"{k} {v:.5f}" for k, v in parts.items())
            for tag, (_, parts) in svs_summary.items()))
    log("[summary] the options' flagships (s/image, train_rays_per_sec): "
        + "; ".join(f"{tag} {v[0]:.3f}, {v[1]:.1f}"
                    for tag, v in option_summary.items())
        + "; the video loop's s/step (first step included): "
        + ", ".join(f"{tag} {v:.3f}" for tag, v in video_step.items()))
    log(f"[summary] phase 18 (profiling, vis_cnn, the .ckpt loader, two "
        f"ranks, the SVS step over two ranks, dryrun 2) {aux_s:.1f} s; the "
        f"whole command {time.perf_counter() - t_start:.1f} s")
    log(f"[summary] device timings the profiler could not take "
        f"(queued_ms instead): {device_ms.stand_ins}")
    for path, counts in {**new_paths, **svs_paths, **real_paths,
                         **option_paths, **aux_paths}.items():
        log(f"[summary] launches, {path}: "
            + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    results = rows.finish({"eval": eval_launches, "train": train_launches,
                           "eval16": eval16, "train16": train16, **new_paths,
                           **svs_paths, **real_paths, **option_paths,
                           **aux_paths})
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
