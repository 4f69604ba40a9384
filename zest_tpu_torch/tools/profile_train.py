"""Where the flagship training step's time goes on one CUDA card.

    python -m zest_tpu_torch.tools.profile_train [--precision {32,16}] [--svs]

Runs ``zest_tpu_torch.presets.FLAGSHIP_TRAIN`` (``FLAGSHIP_TRAIN_16`` with
``--precision 16``; seeded weights, the step-0 phase: 600 random plus 512
motion-mask rays, no chain pass), or with ``--svs`` the adversarial step of
``FLAGSHIP_SVS`` (``_16``: MVSNeRF's generator on one 64x64 GRAF patch,
GRAF's discriminator, LPIPS on a seeded random ``.npz`` written to
``presets.RANDOM_LPIPS``), and prints:

1. the wall time of ``REPS`` unprofiled steps after one warm-up (host clock
   around each step, ended by reading its loss), their range, and train
   rays/s at their median (single steps spread by about 5 %, hence 15 of
   them; to compare two trees, run them in turns on one card);
2. one step under ``torch.profiler``: the kernel launches, their summed
   device time, the union of their intervals (busy time) and the idle share
   ``1 - busy / unprofiled wall``, where the wall is the median step;
3. device time by group (each ported kernel forward and backward, then the
   library kernels) and the top kernels by self device time;
4. with ``--svs``, the step's parts run alone: the generator's update, the
   discriminator's update and LPIPS's forward and backward on the step's
   patch, each its median wall over 5 runs (ended by a synchronise) beside
   its kernel launches and kernel time under the profiler.

TF32 is off, as in ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from zest_tpu_torch import presets, sampling
from zest_tpu_torch.system import TrainState, phase_for_step
from zest_tpu_torch.tools.profile_eval import busy_union_us, group_of

REPS = 15
_LIB = "cuDNN conv / deconv + batch norm"
# (substring of the kernel symbol, group label), first match wins
GROUPS = (("round_pack", "K6 / K7 bf16 weight rounding"),
          ("pack_tc32", "K6 float32 weight pack"),
          ("row_gather", "K9 row gather"),
          ("row_scatter", "K9 row gather backward (scatter-add)"),
          ("fused_nerf_bwd", "K7 field backward, pass 1"),
          ("recompute_tc32", "K7 field backward, pass 1 (recompute)"),
          ("input_grads_tc32", "K7 field backward, pass 1 (input gradients)"),
          ("wgrad_tc", "K7 field backward, pass 2 (weights)"),
          ("head_grads", "K7 field backward, pass 2 (weights)"),
          ("fused_nerf", "K6 fused field"),
          ("trilinear_grad_volume", "K4 volume lookup d/d volume"),
          ("trilinear_grad_coords", "K5 volume lookup d/d coordinates"),
          ("trilinear_sample", "K3 volume lookup"),
          ("color_gather", "K8 color gather"),
          ("plane_sweep_warp_bwd", "K2 warp backward"),
          ("plane_sweep", "K1 warp"),
          ("cudnn", _LIB), ("conv", _LIB), ("fprop", _LIB), ("dgrad", _LIB),
          ("wgrad", _LIB), ("bn_", _LIB), ("batch_norm", _LIB),
          ("welford", _LIB),
          ("gemm", "cuBLAS gemm"), ("gemv", "cuBLAS gemm"),
          ("catarray", "torch.cat copies"),
          ("reduce", "reductions (losses, norms, optimizer)"))


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(prog="profile_train")
    parser.add_argument("--precision", type=int, choices=(32, 16), default=32)
    parser.add_argument("--svs", action="store_true")
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"precision {args.precision}{', SVS' if args.svs else ''}")
    gen = torch.Generator(device=dev).manual_seed(1)
    if args.svs:
        presets.write_random_lpips()
        preset = (presets.FLAGSHIP_SVS_16 if args.precision == 16
                  else presets.FLAGSHIP_SVS)
        cfg, gan, batch, state = presets.build_gan(
            preset, presets.MVSNERF_SCENE, dev)
        opt = gan.system.make_optimizer(presets.STEPS_PER_EPOCH)
        d_opt = gan.make_disc_optimizer(presets.STEPS_PER_EPOCH)
        step_fn = gan.make_train_step(opt, d_opt)
        n_rays = cfg.patch_size ** 2
    else:
        preset = (presets.FLAGSHIP_TRAIN_16 if args.precision == 16
                  else presets.FLAGSHIP_TRAIN)
        cfg, system, batch, params = presets.build(
            preset, presets.FLAGSHIP_SCENE, dev)
        opt = system.make_optimizer(presets.STEPS_PER_EPOCH)
        step_fn = system.make_train_step(opt)
        state = TrainState(params, opt.init(params), 0)
        n_rays = cfg.batch_size + cfg.num_extra_samples
    phase = phase_for_step(cfg, 0)

    def draw():
        return sampling.sample_draws(gen, cfg, cfg.img_h, cfg.img_w,
                                     int(batch["motion_count"]),
                                     phase.extra_samples)

    def run(state):
        return step_fn(state, batch, draw(), phase)

    walls = []
    for rep in range(REPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, logs = run(state)
        loss = float(logs["train_loss"])          # waits for the device
        ms = 1e3 * (time.perf_counter() - t0)
        print(f"{'warm-up' if rep == 0 else f'step {rep}'}: {ms:.1f} ms, "
              f"loss {loss:.5g}")
        if rep:
            walls.append(ms)
    wall = statistics.median(walls)
    print(f"unprofiled wall per step (median of {REPS}): {wall:.1f} ms, "
          f"train rays/s {n_rays / wall * 1e3:.1f} (steps {min(walls):.1f} to "
          f"{max(walls):.1f} ms)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, logs = run(state)
        float(logs["train_loss"])
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    groups: dict = {}
    counts: dict = {}
    for e in kernels:
        g = group_of(e.name, GROUPS)
        groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us()
        counts[g] = counts.get(g, 0) + 1
    total_us = sum(groups.values())
    busy = busy_union_us((e.time_range.start, e.time_range.end)
                         for e in kernels) / 1e3
    print(f"profiled step: {len(kernels)} kernel launches, kernel time "
          f"{total_us / 1e3:.1f} ms, busy union {busy:.1f} ms")
    print(f"idle share against the unprofiled wall: {1 - busy / wall:.4f}")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:40s} {counts[g]:6d} {us / 1e3:9.2f} ms "
              f"{100 * us / total_us:6.2f} %")
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=25, max_name_column_width=60))
    if args.svs:
        svs_parts(gan, state, batch, draw(), phase, opt, d_opt)
    return 0


def kernel_ms(fn) -> tuple:
    """(kernel launches, their summed device ms) of one fn() under the
    profiler."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def svs_parts(gan, state, batch, draws, phase, opt, d_opt) -> None:
    """The GAN step's parts alone: wall (median of 5 after one, each ended
    by a synchronise) beside launches and kernel time."""
    outs = gan.generator_update(state, batch, draws, phase, opt)[3]
    P = gan.cfg.patch_size
    fake = outs[0].reshape(P, P, 3).clone().requires_grad_(True)
    real = outs[1].reshape(P, P, 3)

    def lpips():
        with torch.enable_grad():
            torch.autograd.grad(gan.lpips(fake, real), fake)
    for name, fn in (
            ("generator update", lambda: gan.generator_update(
                state, batch, draws, phase, opt)),
            ("discriminator update", lambda: gan.discriminator_update(
                state, outs, d_opt)),
            ("LPIPS forward and backward", lpips)):
        fn()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        n, ms = kernel_ms(fn)
        print(f"part {name}: wall {statistics.median(walls):.2f} ms (median "
              f"of 5), {n} kernel launches, kernel time {ms:.2f} ms")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
