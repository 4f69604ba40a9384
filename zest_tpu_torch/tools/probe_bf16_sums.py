"""K6 and K7 in the bf16-operand mode on the LLFF file's training samples,
on one CUDA card: each against the bf16 twin and a float64 twin.

    python -m zest_tpu_torch.tools.probe_bf16_sums [--samples N]

Writes an LLFF scene from a seed (``tools.scene_fixtures.write_llff_scene``
at ``chip_smoke.py``'s phase-16 size), builds MVSNeRF's LLFF file
(``config_mvsnerf_llff.txt``) at precision 16 with seeded weights and, for
each of N training samples (the loader's source views drawn with its rng
seeded 0, 1, ...), takes the step-0 static pass and a random output gradient
and prints one JSON line:

- ``views``: the ordered draw of the 3 source views (of the 5 the loader
  picks from);
- ``leaves``: for the three inputs and every leaf of d_pack, the norm-wise
  distance from the float64 twin of K7 and of the twin, [K7, twin];
- ``gate``: the leaves that fail ``chip_smoke.py``'s float64 gate (K7 within
  2^-8 plus the twin's distance), and the smallest margin;
- ``flips``: the bf16 activations and the ReLU masks of K6's forward (K7's
  recompute) and of the twin's that differ from the float64 twin's;
- ``sums``: for every trunk layer that reads h alone, the error of its z
  from the same bf16 input (K7's own h) against float64, mean |error| over
  mean |z|, for K7 and for the twin's float32 product, and the share of K7's
  errors that point toward zero.

A last line gives K6's time on the first eval chunk and K7's on the pass
(CUDA events, mean of 3 after a warm-up) and the build's ptxas lines for
the bf16 kernels. To compare two versions of the kernels, run it from each
tree in turns in one chip call: each builds its own library. TF32 is off.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from zest_tpu_torch.kernels import _build, fused_mlp
from zest_tpu_torch.models.nerf import NeRFField, round_bf16

LLFF_FILE = "configs/config_files/config_mvsnerf_llff.txt"
SCENE = dict(scene="fern", n_views=20, size=(1008, 756))
SEED = 0
GATE = 2.0 ** -8


def float64_twin(field):
    """The field in float64: float64 sums, the same bf16 operands."""
    twin = NeRFField(field.depth, field.width, field.in_ch_pts,
                     field.in_ch_views, field.in_ch_feat, field.skips,
                     field.static, bf16=field.bf16,
                     sceneflow=field.n_extra > 0, use_mvs=field.use_mvs)
    twin.load_state_dict({k: v.double() for k, v in field.state_dict().items()})
    return twin.double().to(next(field.parameters()).device)


def static_pass(system, batch, cfg, gen):
    """The step-0 static field's inputs, flat [n, ch], as the step forms
    them."""
    from zest_tpu_torch import render, sampling
    from zest_tpu_torch.system import phase_for_step
    phase = phase_for_step(cfg, 0)
    draws = sampling.sample_draws(gen, cfg, cfg.img_h, cfg.img_w,
                                  int(batch.get("motion_count", 1)),
                                  phase.extra_samples)
    with torch.no_grad():
        models = system.render_models(batch)
        rays = system.train_rays(batch, draws, phase)
        kw = system.render_kwargs(batch)
        st = render.static_field_inputs(models, rays, kw["im_w2c_ref"])
    return [t.reshape(-1, t.shape[-1]).contiguous() for t in st]


def distances(field, offsets, got, ref):
    """{name: norm-wise distance} of got to ref, each (d_pts, d_feats,
    d_views, d_pack)."""
    pairs = list(zip(("d_pts", "d_feats", "d_views"), got[:3], ref[:3]))
    pairs += [(n, a, b) for (n, a), (_, b) in zip(
        fused_mlp.pack_leaves(field, got[3], offsets),
        fused_mlp.pack_leaves(field, ref[3], offsets))]
    return {n: float((a.double() - b.double()).norm())
            / max(float(b.double().norm()), 1e-300) for n, a, b in pairs}


def flips(field, saved, fwd, fwd64):
    """bf16 activations and ReLU masks that differ from float64's, for K7's
    forward values and the twin's."""
    out = {"K7": [0, 0], "twin": [0, 0]}
    for i, z64 in enumerate(fwd64["z"]):
        a64 = z64 * fwd64["cond"]
        h64 = torch.relu(a64).to(torch.bfloat16)
        for who, vals in (("K7", saved), ("twin", fwd)):
            a = vals["z"][i] * vals["cond"]
            out[who][0] += int((torch.relu(a).to(torch.bfloat16) != h64).sum())
            out[who][1] += int(((a > 0) != (a64 > 0)).sum())
    return {k: dict(bf16=v[0], relu=v[1]) for k, v in out.items()}


@torch.no_grad()
def sums(field, saved):
    """Per trunk layer that reads h alone: z from K7's own bf16 h against
    float64, for K7's sums and the twin's float32 product."""
    out = {}
    cond = saved["cond"]
    for i in range(1, len(field.pts_linears)):
        if i - 1 in field.skips:
            continue
        lin = field.pts_linears[i]
        h = round_bf16(torch.relu(saved["z"][i - 1] * cond))
        w = round_bf16(lin.weight)
        z64 = h.double() @ w.double().T + lin.bias.double()
        z32 = h @ w.T + lin.bias
        scale = float(z64.abs().mean())
        e7 = saved["z"][i].double() - z64
        e32 = z32.double() - z64
        nz = e7 != 0
        toward = float(((e7 * z64) < 0)[nz].float().mean()) if nz.any() else 0.0
        out[f"z{i}"] = dict(K7=float(e7.abs().mean()) / scale,
                            twin=float(e32.abs().mean()) / scale,
                            K7_toward_zero=toward)
    return out


def events_ms(fn, n=3) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("probe_bf16_sums: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(prog="probe_bf16_sums")
    parser.add_argument("--samples", type=int, default=8)
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    from zest_tpu_torch import presets
    from zest_tpu_torch.config import config_parser
    from zest_tpu_torch.system import ZestSystem, to_batch
    from zest_tpu_torch.tools import scene_fixtures as sf
    from zest_tpu_torch.train_loop import build_datasets
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        sf.write_llff_scene(Path(tmp) / "llff", **SCENE)
        cfg = config_parser(["--config", LLFF_FILE, "--datadir",
                             str(Path(tmp) / "llff"), "--finetune_scene",
                             SCENE["scene"], "--precision", "16"])
        ds = build_datasets(cfg, ("train",))["train"]
        draws = []
        for s in range(args.samples):
            ds.rng = np.random.default_rng(s)
            draws.append(ds[0])
    system = ZestSystem(cfg).to(dev)
    system.load_state_dict({k: v.to(dev) for k, v in
                            presets.seeded_params(system, SEED).items()})
    field = system.nerf_static
    wide = float64_twin(field)
    with torch.no_grad():
        pack, offsets = fused_mlp.pack_weights(field)
    fails = 0
    for s, sample in enumerate(draws):
        batch = to_batch(sample, dev)
        _, H, W, _ = batch["images"].shape
        cfg_s = dataclasses.replace(cfg, img_h=H, img_w=W)
        gen = torch.Generator(device=dev).manual_seed(SEED + 4)
        flat = static_pass(system, batch, cfg_s, gen)
        g = torch.randn((flat[0].shape[0], field.out_ch), generator=gen,
                        device=dev)
        saved = {}
        got = fused_mlp.fused_nerf_backward(field, *flat, g, pack, offsets,
                                            saved=saved)
        twin = fused_mlp.fused_nerf_backward_plain(field, *flat, g)
        flat64 = [t.double() for t in flat]
        exact = fused_mlp.fused_nerf_backward_plain(wide, *flat64, g.double())
        with torch.no_grad():
            fwd = fused_mlp.forward_values_plain(field, *flat)
            fwd64 = fused_mlp.forward_values_plain(wide, *flat64)
        k7 = distances(field, offsets, got, exact)
        tw = distances(field, offsets, twin, exact)
        margin = {n: GATE + tw[n] - k7[n] for n in k7}
        failed = sorted(n for n, m in margin.items() if m < 0)
        fails += bool(failed)
        print(json.dumps(dict(
            sample=s, views=[int(v) for v in
                             np.random.default_rng(s).permutation(5)[:3]],
            points=flat[0].shape[0],
            leaves={n: [k7[n], tw[n]] for n in k7},
            gate=dict(failed=failed, least_margin=min(margin.values())),
            flips=flips(field, saved, fwd, fwd64), sums=sums(field, saved))),
            flush=True)
        del got, twin, exact, fwd, fwd64, saved, flat64
        torch.cuda.empty_cache()

    # times: K6 on the first eval chunk of the last sample, K7 on its pass
    from zest_tpu_torch import render
    with torch.no_grad():
        models = system.render_models(batch)
        rays = system.chunk_rays(batch, 0)
        kw = system.render_kwargs(batch)
        chunk = render.static_field_inputs(models, rays, kw["im_w2c_ref"])
        k6 = events_ms(lambda: fused_mlp.fused_nerf_forward(field, *chunk))
        k7_ms = events_ms(lambda: fused_mlp.fused_nerf_backward(
            field, *flat, g, pack, offsets))
    ptxas, entry = [], None
    for line in _build.build_info.get("ptxas", "").splitlines():
        if "Compiling entry" in line:
            entry = next((k for k in ("fused_nerf_tc_kernel",
                                      "fused_nerf_bwd_tc_kernel",
                                      "wgrad_tc_kernel") if k in line), None)
        elif entry and ("Used" in line or "spill" in line):
            ptxas.append(f"{entry}: {line.strip()}")
    print(json.dumps(dict(samples=args.samples, failing_samples=fails,
                          k6_eval_chunk_ms=k6, k7_pass_ms=k7_ms,
                          eval_chunk=list(chunk[0].shape),
                          card=torch.cuda.get_device_name(0),
                          time=time.strftime("%H:%M:%S"),
                          ptxas=ptxas)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
