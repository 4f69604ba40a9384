"""K6 and K7 in each head geometry of the fused field, on one CUDA card:
their outputs saved for a bitwise comparison between two trees, and their
times.

    python zest_tpu_torch/tools/probe_heads.py --out FILE [--compare FILE]

Run by path, the script imports ``zest_tpu_torch`` from ``PYTHONPATH``, so
the same script probes another tree's package (``PYTHONPATH=<tree>``):
each tree builds its own kernel library. For each geometry the tree's
``NeRFField`` has — the static field (5 outputs, the blend), the dynamic
field (12 outputs, flow and probabilities) and, where the tree has it, the
field without extra heads (4 outputs: ``sceneflow=False``) — it builds a
seeded width-256 field (multires 10 / 4, 8 source views), runs K6
(``fused_nerf_forward``) and K7 (``fused_nerf_backward``) at float32 and in
the bf16-operand mode on N seeded points (131,072 by default: two float32
backward chunks) with a seeded output gradient, saves every output to
``--out`` (``torch.save``), and prints the mean time of each over 5
launches (CUDA events, after one warm-up). K7's weight gradients (d_pack)
add with float32 atomics in a varying order, so they differ between two
launches of one tree: the script prints that difference (two launches
here) beside the one between trees, and compares the rest bit for bit.
With ``--compare`` it loads another tree's file and prints, for each
output both files hold, whether the two are equal bit for bit (K6's rows,
K7's input gradients) or the largest difference of d_pack, and exits 1 if
an output to be bitwise differs, or d_pack by more than twice the larger
of the two trees' own launch-to-launch differences. TF32 is off.
"""
from __future__ import annotations

import argparse
import inspect
import sys

import torch

from zest_tpu_torch.kernels import fused_mlp
from zest_tpu_torch.models.nerf import NeRFField

LAUNCHES = 5
# geometry -> (NeRFField keywords, P, F)
GEOMETRIES = {"static5": (dict(static=True), 63, 40),
              "dynamic12": (dict(static=False), 84, 24),
              "rgba4": (dict(static=True, sceneflow=False), 63, 40)}


def cuda_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("probe_heads: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(prog="probe_heads")
    parser.add_argument("--out", required=True)
    parser.add_argument("--compare")
    parser.add_argument("--points", type=int, default=2 * fused_mlp.CHUNK_ROWS)
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    known = inspect.signature(NeRFField).parameters
    results = {}
    for geo, (kw, P, F) in GEOMETRIES.items():
        if not set(kw) <= set(known):
            print(f"[heads] {geo}: this tree's NeRFField has no "
                  f"{sorted(set(kw) - set(known))}")
            continue
        torch.manual_seed(0)
        field = NeRFField(8, 256, P, 27, F, **kw).to(dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        pts, feats, views, g = (torch.randn((args.points, c), generator=gen,
                                            device=dev)
                                for c in (P, F, 27, field.out_ch))
        for mode in ("float32", "bf16"):
            field.bf16 = mode == "bf16"
            with torch.no_grad():
                pack, offsets = fused_mlp.pack_weights(field)

            def forward():
                with torch.no_grad():
                    return fused_mlp.fused_nerf_forward(field, pts, feats, views)

            def backward():
                return fused_mlp.fused_nerf_backward(field, pts, feats, views,
                                                     g, pack, offsets)

            results[f"{geo} {mode} K6"] = forward().cpu()
            *d_in, d_pack = backward()
            results[f"{geo} {mode} K7 inputs"] = [t.cpu() for t in d_in]
            results[f"{geo} {mode} K7 d_pack"] = d_pack.cpu()
            again = float((backward()[3] - d_pack).abs().max())
            results[f"{geo} {mode} K7 d_pack own"] = torch.tensor(again)
            print(f"[heads] {geo} ({field.out_ch} outputs) {mode}: K6 "
                  f"{cuda_ms(forward):.3f} ms, K7 {cuda_ms(backward):.3f} ms "
                  f"on {args.points} points; K7's d_pack between two "
                  f"launches: {again:.3e}", flush=True)
    torch.save(results, args.out)
    if not args.compare:
        return 0
    other = torch.load(args.compare, weights_only=True)
    differ = 0
    for key in sorted(set(results) & set(other)):
        if key.endswith(" own"):
            continue
        a, b = results[key], other[key]
        pairs = list(zip(a, b)) if isinstance(a, list) else [(a, b)]
        worst = max(float((x - y).abs().max()) for x, y in pairs)
        if key.endswith("d_pack"):
            own = max(float(results[key + " own"]), float(other[key + " own"]))
            differ += not worst <= 2 * own
            print(f"[heads] {key}: largest difference from {args.compare} "
                  f"{worst:.3e}; the trees' own launch-to-launch {own:.3e}")
            continue
        same = all(torch.equal(x, y) for x, y in pairs)
        differ += not same
        print(f"[heads] {key}: bit for bit equal to {args.compare}: {same}"
              + ("" if same else f" (largest difference {worst:.3e})"))
    only = sorted(set(results) ^ set(other))
    if only:
        print(f"[heads] in one file only: {only}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
