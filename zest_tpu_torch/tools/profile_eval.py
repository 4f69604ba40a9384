"""Where the flagship eval step's time goes on one CUDA card.

    python -m zest_tpu_torch.tools.profile_eval

Runs the flagship preset (``zest_tpu_torch.presets.FLAGSHIP``, seeded
weights) and prints:

1. the encoder / render split over ``REPS`` unprofiled images after one
   warm-up: ``encode`` is ``ZestSystem.render_models`` (both encoders) alone,
   ``total`` the whole eval step, ``render`` their difference;
2. one image under ``torch.profiler``: the kernel launches, their summed
   device time, the union of their intervals (busy time) and the idle share
   ``1 - busy / unprofiled wall``, where the wall is the median ``total``;
3. device time by group (each ported kernel, then the library kernels) and
   the top kernels by self device time.

TF32 is off, as in ``chip_smoke.py``.
"""
from __future__ import annotations

import statistics
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from zest_tpu_torch import presets

REPS = 3
# (substring of the kernel symbol, group label), first match wins
GROUPS = (("fused_nerf", "K6 fused field"),
          ("trilinear_sample", "K3 volume lookup"),
          ("color_gather", "K8 color gather"),
          ("plane_sweep", "K1 warp"),
          ("cudnn", "cuDNN conv / deconv + batch norm"),
          ("conv", "cuDNN conv / deconv + batch norm"),
          ("fprop", "cuDNN conv / deconv + batch norm"),
          ("dgrad", "cuDNN conv / deconv + batch norm"),
          ("bn_", "cuDNN conv / deconv + batch norm"),
          ("batch_norm", "cuDNN conv / deconv + batch norm"),
          ("welford", "cuDNN conv / deconv + batch norm"),
          ("gemm", "cuBLAS gemm"),
          ("gemv", "cuBLAS gemm"),
          ("catarray", "torch.cat copies"))
OTHER = "other elementwise / copies"


def group_of(kernel_name: str) -> str:
    name = kernel_name.lower()
    return next((label for key, label in GROUPS if key in name), OTHER)


def busy_union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_eval: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _, system, batch, params = presets.build(presets.FLAGSHIP,
                                             presets.FLAGSHIP_SCENE, dev)
    step = system.make_eval_step()
    totals = []
    with torch.no_grad():
        for rep in range(REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            system.render_models(batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step(params, batch)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            enc, total = 1e3 * (t1 - t0), 1e3 * (t2 - t1)
            print(f"{'warm-up' if rep == 0 else f'image {rep}'}: encode "
                  f"{enc:.1f} ms, render {total - enc:.1f} ms, total "
                  f"{total:.1f} ms")
            if rep:
                totals.append(total)
    wall = statistics.median(totals)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    groups: dict = {}
    for e in kernels:
        g = group_of(e.name)
        groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us()
    total_us = sum(groups.values())
    busy = busy_union_us((e.time_range.start, e.time_range.end)
                         for e in kernels) / 1e3
    print(f"unprofiled wall per image (median of {REPS}): {wall:.1f} ms")
    print(f"profiled image: {len(kernels)} kernel launches, kernel time "
          f"{total_us / 1e3:.1f} ms, busy union {busy:.1f} ms")
    print(f"idle share against the unprofiled wall: {1 - busy / wall:.4f}")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:34s} {us / 1e3:9.2f} ms  {100 * us / total_us:6.2f} %")
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=20, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
