#!/usr/bin/env python3
"""Chip smoke test: the PyTorch / CUDA port's full-image eval step on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``zest_tpu_torch/csrc/`` (nvcc,
sm_90a), then:

1. prints the card (nvidia-smi name and power limit);
2. builds the kernels and prints the build time and ptxas report;
3. holds each kernel against its plain PyTorch twin on the card, on the first
   chunk's inputs of the flagship eval (both fields' inputs as
   ``render_rays`` builds them, [16384, 128, ch]), and times both with CUDA
   events;
4. runs the eval step at a small configuration on CUDA (the kernels) and on
   the CPU (the twins) with the same seeded weights, and compares every map;
5. runs the flagship eval step (288x512, 8 keyframes + target, 4 neighbours,
   128 samples, width-256 fields, float32) with every launch counter reset
   first, checks the maps and that every kernel of the path launched, and
   times s/image with the input changed between runs.

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


def kernels_vs_twins(dev, cfg, system, batch):
    """Each kernel against its twin on the first chunk's inputs of the
    flagship eval, at the shapes the main path gives it."""
    from zest_tpu_torch import geometry, render
    from zest_tpu_torch.kernels.color_gather import (gather_colors,
                                                     gather_colors_plain)
    from zest_tpu_torch.kernels.fused_mlp import fused_nerf_forward
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
    with torch.no_grad():
        models = system.render_models(batch)
        rays = system.chunk_rays(batch, 0)
        kw = system.render_kwargs(batch)
        field_inputs = {
            "static": render.static_field_inputs(models, rays, kw["im_w2c_ref"]),
            "dynamic": render.dynamic_field_inputs(models, rays, kw["nb_w2c_ref"],
                                                   kw["ref_frame_idx"])}
    cases = []

    # K1: source view 1 (32 features + 3 RGB) over the padded frustum
    src = torch.randn((h, w, 35), generator=gen, device=dev)
    grid = homography_grid(batch["proj_mats"][1], depths, (h, w), pad=cfg.pad)
    cases.append(("plane_sweep_warp", "zest_tpu_torch/csrc/plane_sweep.cu",
                  "zest_tpu/kernels/plane_sweep.py:239", homo_warp_cm,
                  lambda: homo_warp_cm(src, grid),
                  lambda: homo_warp_cm_plain(src, grid), 1e-5, 20))

    # K3: an encoding volume at the chunk's ray points
    vol = torch.randn((128, h + 2 * cfg.pad, w + 2 * cfg.pad, 8), generator=gen,
                      device=dev)
    ndc = rays.ndc.contiguous()
    cases.append(("trilinear_sample", "zest_tpu_torch/csrc/trilinear.cu",
                  "zest_tpu/kernels/trilinear.py:279", sample_volume,
                  lambda: sample_volume(vol, ndc),
                  lambda: sample_volume_plain(vol, ndc), 1e-5, 20))

    # K8: the 8 source views at the chunk's projected points
    V = imgs_un.shape[0] - 1
    inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32, device=dev)
    xy = torch.stack([
        geometry.world_to_ndc(rays.pts, batch["w2cs"][v],
                              batch["intrinsics"][v], inv_scale, 2.0,
                              6.0)[..., :2] * inv_scale
        for v in range(V)]).reshape(V, -1, 2).contiguous()
    src_imgs = imgs_un[:-1].contiguous()
    cases.append(("color_gather", "zest_tpu_torch/csrc/color_gather.cu",
                  "zest_tpu/kernels/color_gather.py:138", gather_colors,
                  lambda: gather_colors(src_imgs, xy),
                  lambda: gather_colors_plain(src_imgs, xy), 1e-5, 20))

    # K6: both fields on the chunk's inputs as render_rays builds them
    # ([16384, 128, ch]); the twin is the field module itself
    for kind, inputs in field_inputs.items():
        field = getattr(system, f"nerf_{kind}")
        cases.append((f"fused_nerf/{kind}", "zest_tpu_torch/csrc/fused_mlp.cu",
                      "zest_tpu/kernels/fused_mlp.py:376", fused_nerf_forward,
                      functools.partial(fused_nerf_forward, field, *inputs),
                      functools.partial(field, *inputs), 1e-4, 3))

    rows = {}
    for label, source, replaces, wrapper, kern, plain, tol, iters in cases:
        with torch.no_grad():
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            scale = max(1.0, float(ref.abs().max()))
            ok = bool(torch.isfinite(out).all()) and err <= tol * scale
            ms = cuda_ms(kern, iters)
            plain_ms = cuda_ms(plain, iters)
        rel = err / max(float(ref.abs().max()), 1e-30)
        log(f"[kernel] {label}: shape {tuple(out.shape)} max_abs_err {err:.3e}"
            f" max_rel_err {rel:.3e} (tol {tol:g} x {scale:.3g}) kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} disagrees with its twin: {err}")
        # one row per kernel: K6's times are one static plus one dynamic
        # call, as every chunk makes one of each
        name = label.split("/")[0]
        row = rows.setdefault(name, dict(
            name=name, route="cuda", source=source, replaces=replaces,
            wrapper=wrapper, max_abs_err=0.0, ms=0.0, plain_ms=0.0))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += ms
        row["plain_ms"] += plain_ms
    return list(rows.values())


def small_slice(dev):
    """The eval step at the small preset on CUDA against the same step on the
    CPU."""
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


def counters():
    from zest_tpu_torch.kernels.color_gather import gather_colors
    from zest_tpu_torch.kernels.fused_mlp import fused_nerf_forward
    from zest_tpu_torch.kernels.plane_sweep import homo_warp_cm
    from zest_tpu_torch.kernels.trilinear import sample_volume
    return (homo_warp_cm, sample_volume, gather_colors, fused_nerf_forward)


def flagship(cfg, system, batch, params):
    """The flagship eval step with every launch counter reset first."""
    from zest_tpu_torch.system import EVAL_KEYS
    step = system.make_eval_step()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters():
        fn.launches = 0
    t0 = time.perf_counter()
    maps = step(params, batch)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters()}
    H, W = cfg.img_h, cfg.img_w
    n_chunks = -(-(H * W) // cfg.eval_chunk)
    n_src = batch["images"].shape[0] - 2
    expected = {"homo_warp_cm": n_src, "sample_volume": 2 * n_chunks,
                "gather_colors": 2 * n_chunks, "fused_nerf_forward": 2 * n_chunks}
    log(f"[flagship] first run {first:.2f} s, launches {launches}")
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    for k in EVAL_KEYS:
        v = maps[k]
        if v.shape[:2] != (H, W) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"flagship {k}: shape {tuple(v.shape)} or "
                                 f"non-finite values")
        log(f"[flagship] {k}: shape {tuple(v.shape)} mean {float(v.mean()):.4f}"
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
    log(f"[flagship] s/image over {len(times)} runs: "
        + ", ".join(f"{t:.3f}" for t in times)
        + f" (median {float(np.median(times)):.3f}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


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
    cfg, system, batch, params = presets.build(presets.FLAGSHIP,
                                               presets.FLAGSHIP_SCENE, dev, SEED)
    results = kernels_vs_twins(dev, cfg, system, batch)
    small_slice(dev)
    launches = flagship(cfg, system, batch, params)
    for r in results:
        r["launches"] = launches[r.pop("wrapper").__name__]
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
