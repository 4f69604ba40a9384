"""K3, K4 and K5, the volume lookup and its two gradients, at the flagship's
own points on one CUDA card.

    python -m zest_tpu_torch.tools.probe_trilinear

Builds the flagship eval's first chunk of rays (``presets.FLAGSHIP``,
ndc [16384, 128, 3]) and the flagship training step's three lookups
(``presets.FLAGSHIP_TRAIN``, seeded weights and draws: the step-0 rays
twice, [1112, 128, 3], and the stacked t±1 points, [2224, 128, 3]) into
seeded random volumes of the flagship's shape, and prints for each kernel
its device time (the profiler's kernel durations, mean of ``LAUNCHES``
calls after a warm-up; K4 with the zero fill of d_vol its wrapper makes)
and its distance to its twin: K3 on the eval chunk and on the three
training lookups (each, and the three together), K4 on the three, K5 on
the t±1 points. K3 is also timed on the eval chunk's points moved outside
the volume (the points read and the output written, no corner loaded) and
on the same points as [n, 3]. Beside them, counted from the same points:
the distinct 128-byte lines of the volume one warp-wide corner load
touches for several shapes of a warp's lanes over rays and samples
(``lines_per_load``), K4's corner taps, vector atomics and distinct cells
per warp (``k4_atomics``), and K5's line requests per point with 1, 2, 4
or 8 lanes per point (``k5_lines``; 1 is the one-point form, 4 the
kernel's), printed beside K5's and K4's time on the t±1 lookup and K5's
time with those points moved outside the volume. The last line is one
JSON object of the times and K5's line requests.

It calls only the kernels' public wrappers, so to compare two trees run it
from each in turns in one chip call: each builds its own library. TF32 is
off.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from zest_tpu_torch import presets, render, sampling
from zest_tpu_torch.kernels import fused_mlp, trilinear
from zest_tpu_torch.system import phase_for_step

LAUNCHES = 50
SETTLE = 16      # uncounted kernels that open each profiled session,
SETTLE_S = 0.01  # and the least host time they take
MAX_SPIN_S = 1.0  # longest spin that queued_ms puts before its calls
LOST_SHARE = 0.1  # of a kernel's launches whose events a session may miss
WARP = 32


def corner_cells(ndc, dims) -> tuple:
    """Each point's 8 corner cells of a [D, Hv, Wv, ...] volume in (z, y, x)
    order, as K3-K5 form them (ndc*2-1 unnormalized with align_corners=True,
    clamped to [-2, size + 1]), and whether each lies inside: two [..., 8]
    tensors (int64, bool); then the floor (x0, y0, z0) and the fractions
    (fx, fy, fz), each [..., 3]."""
    D, Hv, Wv = dims
    size = torch.tensor([Wv, Hv, D], device=ndc.device)
    p = ((ndc * 2.0 - 1.0 + 1.0) / 2.0 * (size - 1)).clamp(min=-2.0)
    p = torch.minimum(p, (size + 1).to(p.dtype))
    p0 = p.floor()
    x0, y0, z0 = p0.long().unbind(-1)
    cells, ok = [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                x, y, z = x0 + dx, y0 + dy, z0 + dz
                ok.append((x >= 0) & (x < Wv) & (y >= 0) & (y < Hv)
                          & (z >= 0) & (z < D))
                cells.append((z * Hv + y) * Wv + x)
    return (torch.stack(cells, -1), torch.stack(ok, -1), p0.long(),
            p - p0)


def _distinct(keys) -> torch.Tensor:
    """Distinct non-negative values in each row of keys [m, k] (-1: none)."""
    s = keys.sort(-1).values
    return (s[:, 1:] != s[:, :-1]).sum(-1) + 1 - (s[:, 0] < 0).long()


def lines_per_load(ndc, dims, lanes=(1, WARP)) -> float:
    """Mean distinct 128-byte lines of the volume that one warp-wide 16-byte
    corner load touches at ndc [R, S, 3] (a cell's 32 bytes lie in one
    line), when a warp's lanes are ``lanes`` = (rays, samples): (1, 32) 32
    consecutive samples of a ray, (32, 1) 32 neighbouring rays at one sample
    index. A load none of whose lanes is in range is not issued and not
    counted."""
    wr, ws = lanes
    cells, ok, _, _ = corner_cells(ndc, dims)
    line = torch.where(ok, cells // 4, -1)
    R, S = line.shape[:2]
    line = torch.cat([line, line.new_full(((-R) % wr, S, 8), -1)])
    line = torch.cat([line, line.new_full((line.shape[0], (-S) % ws, 8), -1)], 1)
    R, S = line.shape[:2]
    warps = line.reshape(R // wr, wr, S // ws, ws, 8).permute(0, 2, 4, 1, 3)
    n = _distinct(warps.reshape(-1, wr * ws))
    return float(n[n > 0].double().mean())


def k5_lines(ndc, dims, lanes: int) -> float:
    """Mean L1 line requests per point of K5's corner loads at ndc [..., 3]:
    the distinct 128-byte lines of the volume that each warp-wide 16-byte
    load touches, summed over the warp's loads and divided by the points.
    A point's 16 float4 are q = (dz, dy, dx, half) in binary; ``lanes``
    lanes share a point (consecutive points in a warp of 32) and lane j
    loads q = u * lanes + j in its load u. lanes = 1 is one thread per
    point with 16 loads (the one-point form), 4 a 64-byte row per load. A
    lane whose corner is out of range loads nothing."""
    cells, ok, _, _ = corner_cells(ndc.reshape(-1, 3), dims)
    n = cells.shape[0]
    line = torch.where(ok, cells, -1).repeat_interleave(2, -1)     # [n, 16]
    half = torch.arange(16, device=ndc.device) % 2
    line = torch.where(line >= 0, (2 * line + half) // 8, -1)
    per_warp = WARP // lanes
    line = torch.cat([line, line.new_full(((-n) % per_warp, 16), -1)])
    loads = line.reshape(-1, per_warp, 16 // lanes, lanes).transpose(1, 2)
    return float(_distinct(loads.reshape(-1, per_warp * lanes)).sum()) / n


def k4_atomics(ndc, dims, g=None) -> dict:
    """K4's work at ndc [..., 3], lanes being consecutive points in warps of
    32, as the kernel does it: a point hands its upper corners (dz = 1) to
    the next lane where that lane's point is one z plane up and within one
    voxel in y and x; the next lane adds them to the same cells among its
    lower corners and issues one atomic for both. Returns the in-range
    corner taps, the corner atomics issued (each two float4 atomics) and
    the distinct cells summed over warps; with g [..., 8] also ``d_vol``
    [D, Hv, Wv, 8] summed that way, in float64."""
    D, Hv, Wv = dims
    cells, ok, p0, frac = corner_cells(ndc.reshape(-1, 3), dims)
    n = cells.shape[0]
    x0, y0, z0 = p0.unbind(-1)
    lane = torch.arange(n, device=ndc.device) % WARP
    from_prev = torch.zeros(n, dtype=torch.bool, device=ndc.device)
    from_prev[1:] = ((lane[1:] > 0) & (z0[:-1] + 1 == z0[1:])
                     & ((y0[1:] - y0[:-1]).abs() <= 1)
                     & ((x0[1:] - x0[:-1]).abs() <= 1))
    to_next = torch.zeros_like(from_prev)
    to_next[:-1] = from_prev[1:]
    dy_next = torch.zeros_like(y0)
    dx_next = torch.zeros_like(x0)
    dy_next[:-1], dx_next[:-1] = y0[1:] - y0[:-1], x0[1:] - x0[:-1]
    issued = ok.clone()
    for k in range(4, 8):                    # upper corners handed on
        dy, dx = (k >> 1) & 1, k & 1
        ly, lx = dy - dy_next, dx - dx_next
        issued[:, k] &= ~(to_next & (ly >= 0) & (ly <= 1) & (lx >= 0) & (lx <= 1))
    keys = torch.where(ok, cells, -1)
    keys = torch.cat([keys, keys.new_full(((-n) % WARP, 8), -1)])
    out = {"points": n, "taps": int(ok.sum()), "atomics": int(issued.sum()),
           "cells_per_warp": int(_distinct(keys.reshape(-1, WARP * 8)).sum())}
    if g is None:
        return out
    g = g.reshape(-1, 8).double()
    fx, fy, fz = frac.double().unbind(-1)

    def weight(dz, dy, dx, fx, fy, fz):
        def pick(d, f):
            return torch.where(torch.as_tensor(d, device=f.device) == 1, f,
                               1 - f)
        return pick(dx, fx) * pick(dy, fy) * pick(dz, fz)

    prev = torch.roll(torch.arange(n, device=ndc.device), 1)
    d_vol = torch.zeros((D * Hv * Wv, 8), dtype=torch.float64,
                        device=ndc.device)
    for k in range(8):
        dz, dy, dx = k >> 2, (k >> 1) & 1, k & 1
        u = g * weight(dz, dy, dx, fx, fy, fz)[:, None]
        if dz == 0:                          # the previous point's upper corner
            uy, ux = (y0 - y0[prev] + dy), (x0 - x0[prev] + dx)
            take = from_prev & (uy >= 0) & (uy <= 1) & (ux >= 0) & (ux <= 1)
            pw = weight(1, uy.clamp(0, 1), ux.clamp(0, 1), fx[prev], fy[prev],
                        fz[prev])
            u = u + torch.where(take, pw, 0.0)[:, None] * g[prev]
        m = issued[:, k]
        d_vol.index_add_(0, cells[m, k], u[m])
    out["d_vol"] = d_vol.reshape(D, Hv, Wv, 8)
    return out


def device_ms(fn, iters: int = LAUNCHES, tries: int = 3) -> float:
    """Device time of fn()'s kernels per call, after a warm-up: for each
    kernel (by name), its median duration as the profiler records it over
    iters calls, times its launches per call (its events over iters,
    rounded). The gaps between launches are left out (a wrapper's host side
    takes about as long as a 30 us kernel, so CUDA events around a loop of
    them time the host). The profiler misses device events of a session:
    the first few (4 of 50 launches, seen on an H100), so each session
    opens with SETTLE short spin kernels that are not counted, and a few
    later ones (8 of 500 for 50 calls of a twin of ten kernels, seen on an
    H100), which ``device_ms.lost`` names ({kernel: events missing}) after
    each call. What is missed at the start is taken to be a stretch of
    time rather than a count of launches: sessions of 50 calls of a 2-us
    cuBLAS gemv, the shortest here, once held none of its events in three
    tries on an H100. So the spin kernels go on, each waited for, until
    SETTLE_S of host time has passed. A session
    counts if each kernel's events are within LOST_SHARE of its launches;
    otherwise it is taken again, at most tries times, and then raises,
    naming the events it saw (``queued_ms`` is the stand-in). Copies and
    memsets are not kernels and are left out: a twin's small host-to-device
    copy or zero fill shows as a device event in only some of its calls
    (189 events for 50 calls of three kernels and a copy, seen on an
    H100)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            settle = 0
            while settle < SETTLE or time.perf_counter() - t0 < SETTLE_S:
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                settle += 1
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us, spins = {}, 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            if "spin_kernel" in e.name:
                spins += 1
            elif not e.name.startswith(("Memcpy", "Memset")):
                us.setdefault(e.name, []).append(e.time_range.elapsed_us())
        per_call = {k: max(1, round(len(v) / iters)) for k, v in us.items()}
        lost = {k: per_call[k] * iters - len(v) for k, v in us.items()}
        if us and all(abs(n) <= LOST_SHARE * per_call[k] * iters
                      for k, n in lost.items()):
            device_ms.lost = {k: n for k, n in lost.items() if n}
            return sum(per_call[k] * statistics.median(v)
                       for k, v in us.items()) / 1e3
    raise RuntimeError(f"device_ms: the profiler's device events for {iters} "
                       f"calls, by kernel, in the last of {tries} tries: "
                       + ", ".join(f"{k} {len(v)}" for k, v in us.items())
                       + f" (and {spins} of its {settle} spin kernels)")


device_ms.lost = {}


def queued_ms(fn, iters: int = LAUNCHES, tries: int = 3) -> float:
    """Device time of fn() per call without the profiler, where it records
    no usable events: CUDA events around iters calls that the host queues
    while a spin kernel holds the stream, so that they time the calls run
    back to back on the card and not the host's launches (the gaps between
    kernels are counted, unlike in ``device_ms``). The spin lasts twice the
    host's time for the iters calls, read first. If the stream reached the
    first event before the host had queued the last call (fn waits for
    the card, or the spin was short), the spin is doubled, at most
    MAX_SPIN_S, and the reading taken again, at most tries times;
    ``queued_ms.queued`` says whether the last one was queued whole (if
    not, it times the host too)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    spin_s = 2 * (time.perf_counter() - t0) + 1e-3
    torch.cuda.synchronize()
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(min(spin_s, MAX_SPIN_S) * _cycles_per_s()))
        start.record()
        for _ in range(iters):
            fn()
        queued = not start.query()
        end.record()
        end.synchronize()
        if queued:
            break
        spin_s *= 2
    queued_ms.queued = queued
    return start.elapsed_time(end) / iters


queued_ms.queued = False


def _cycles_per_s() -> float:
    """The card's clock as ``torch.cuda._sleep`` counts it, timed once."""
    if not _cycles_per_s.rate:
        cycles = 10_000_000
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _cycles_per_s.rate = cycles / (start.elapsed_time(end) / 1e3)
    return _cycles_per_s.rate


_cycles_per_s.rate = 0.0


def train_points(system, batch, cfg, gen) -> tuple:
    """The flagship step-0 rays' ndc [R, S, 3] and the stacked t±1 points
    [2R, S, 3], as ``render_rays_train`` forms them (the dynamic field's
    scene flow from K6)."""
    phase = phase_for_step(cfg, 0)
    draws = sampling.sample_draws(gen, cfg, cfg.img_h, cfg.img_w,
                                  int(batch["motion_count"]), phase.extra_samples)
    with torch.no_grad():
        models = system.render_models(batch)
        rays = system.train_rays(batch, draws, phase)
        kw = system.render_kwargs(batch)
        dy_in = render.dynamic_field_inputs(models, rays, kw["nb_w2c_ref"],
                                            kw["ref_frame_idx"])
        raw_dy = fused_mlp.fused_nerf_forward(system.nerf_dynamic, *dy_in)
    ndc = rays.ndc.contiguous()
    return ndc, torch.cat([ndc + raw_dy[..., 4:7],
                           ndc + raw_dy[..., 7:10]]).contiguous()


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("probe_trilinear: no CUDA device", file=sys.stderr)
        return 2
    argparse.ArgumentParser(prog="probe_trilinear").parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(f"card: {smi.splitlines()[0] if smi else torch.cuda.get_device_name(0)}")
    gen = torch.Generator(device=dev).manual_seed(0)

    _, system, batch, _ = presets.build(presets.FLAGSHIP,
                                        presets.FLAGSHIP_SCENE, dev)
    with torch.no_grad():
        ndc_eval = system.chunk_rays(batch, 0).ndc.contiguous()
    cfg = system.cfg
    shape = (128, cfg.img_h // 4 + 2 * cfg.pad, cfg.img_w // 4 + 2 * cfg.pad, 8)
    vols = [torch.randn(shape, generator=gen, device=dev) for _ in range(2)]
    del system, batch
    cfg_t, system_t, batch_t, _ = presets.build(presets.FLAGSHIP_TRAIN,
                                                presets.FLAGSHIP_SCENE, dev)
    ndc_rays, warped = train_points(system_t, batch_t, cfg_t, gen)
    del system_t, batch_t
    lookups = (("static", vols[0], ndc_rays), ("dynamic", vols[1], ndc_rays),
               ("t-1 / t+1", vols[1], warped))
    res = {"card": smi}

    def k3(label, vol, ndc):
        out = trilinear.sample_volume(vol, ndc)
        ref = trilinear.sample_volume_plain(vol, ndc)
        torch.cuda.synchronize()
        ms = device_ms(lambda: trilinear.sample_volume(vol, ndc))
        print(f"K3 {label} {tuple(ndc.shape)}: {ms:.4f} ms, max abs err "
              f"{float((out - ref).abs().max()):.3e}, bitwise equal to the "
              f"twin: {torch.equal(out, ref)}; lines per corner load, lanes "
              f"over (rays, samples) " + ", ".join(
                  f"{w}: {lines_per_load(ndc, vol.shape[:3], w):.2f}"
                  for w in ((1, 32), (32, 1), (16, 2), (8, 4), (4, 8))))
        return ms

    with torch.no_grad():
        res["k3_eval_ms"] = k3("eval chunk", vols[0], ndc_eval)
        far, flat = ndc_eval + 2.0, ndc_eval.reshape(-1, 3)
        res["k3_eval_outside_ms"] = device_ms(lambda: trilinear.sample_volume(
            vols[0], far))
        res["k3_eval_flat_ms"] = device_ms(lambda: trilinear.sample_volume(
            vols[0], flat))
        print(f"K3 eval chunk with every point outside the volume (no corner "
              f"loads): {res['k3_eval_outside_ms']:.4f} ms; the chunk's "
              f"points as [n, 3]: {res['k3_eval_flat_ms']:.4f} ms")
        for label, vol, ndc in lookups:
            k3(label, vol, ndc)
        res["k3_train_ms"] = device_ms(lambda: [trilinear.sample_volume(vol, ndc)
                                          for _, vol, ndc in lookups])
        print(f"K3 on the training step's three lookups: "
              f"{res['k3_train_ms']:.4f} ms")
        res["k4_ms"] = 0.0
        for label, vol, ndc in lookups:
            g = torch.randn((*ndc.shape[:-1], 8), generator=gen, device=dev)
            d_vol = trilinear.volume_grad(vol.shape, ndc, g)
            ref = trilinear.sample_volume_grads_plain(vol, ndc, g)[0]
            ms = device_ms(lambda: trilinear.volume_grad(vol.shape, ndc, g))
            res["k4_ms"] += ms
            work = k4_atomics(ndc, vol.shape[:3])
            warps = -(-work["points"] // WARP)
            print(f"K4 {label} {tuple(ndc.shape)}: {ms:.4f} ms, relative err "
                  f"{_rel(d_vol, ref):.3e}; per point {work['taps'] / work['points']:.2f} "
                  f"corner taps, {work['atomics'] / work['points']:.2f} corner "
                  f"atomics after the merge; per warp {work['taps'] / warps:.1f} "
                  f"taps, {work['cells_per_warp'] / warps:.1f} distinct cells")
            if label == "t-1 / t+1":
                d_ndc = trilinear.coords_grad(vol, ndc, g)
                ref = trilinear.sample_volume_grads_plain(vol, ndc, g)[1]
                res["k5_ms"] = device_ms(lambda: trilinear.coords_grad(vol, ndc, g))
                far = ndc + 2.0
                res["k5_outside_ms"] = device_ms(
                    lambda: trilinear.coords_grad(vol, far, g))
                res["k5_lines"] = {lanes: k5_lines(ndc, vol.shape[:3], lanes)
                                   for lanes in (1, 2, 4, 8)}
                print(f"K5 {label}: {res['k5_ms']:.4f} ms (K4 on the same "
                      f"lookup {ms:.4f} ms), relative err "
                      f"{_rel(d_ndc, ref):.3e}; with every point outside the "
                      f"volume (no corner loads) {res['k5_outside_ms']:.4f} "
                      f"ms; line requests per point, by lanes per point: "
                      + ", ".join(f"{lanes}: {v:.2f}"
                                  for lanes, v in res["k5_lines"].items()))
        print(f"K4 on the training step's three lookups: {res['k4_ms']:.4f} ms")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
