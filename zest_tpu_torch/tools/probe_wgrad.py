"""K7 float32's pass 2 (the weight gradients) alone, on one CUDA card.

    python -m zest_tpu_torch.tools.probe_wgrad [--points N]

Builds a seeded width-256 static field (``NeRFField(8, 256, 63, 27, 40)``)
and N random points (65,536 by default: one chunk of ``CHUNK_ROWS``), runs
K7 float32 once, and on the buffers its pass 1 left in the scratch prints,
for every weight of the conditioning, trunk, feature and views layers, the
norm-wise distance of pass 2 (``weight_grads``) and of its float32 twin
(``weight_grads_plain``) from the twin evaluated in float64 on the same
buffers. That holds the kernel's own sums to float64 apart from pass 1's
forward. Then pass 2's time per chunk (CUDA events, mean of 5 launches).
To compare variants of the kernel, run it from each tree in turns in one
chip call: each builds its own library. TF32 is off.
"""
from __future__ import annotations

import argparse
import copy
import sys

import torch

from zest_tpu_torch.kernels import fused_mlp
from zest_tpu_torch.models.nerf import NeRFField

LAUNCHES = 5


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("probe_wgrad: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(prog="probe_wgrad")
    parser.add_argument("--points", type=int, default=fused_mlp.CHUNK_ROWS)
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    field = NeRFField(8, 256, 63, 27, 40, static=True).to(dev)
    wide = copy.deepcopy(field).double()
    gen = torch.Generator(device=dev).manual_seed(1)
    pts, feats, views, g = (torch.randn((args.points, c), generator=gen,
                                        device=dev) for c in (63, 40, 27, 5))
    with torch.no_grad():
        pack, offsets = fused_mlp.pack_weights(field)
    names = {m: f"{n}.weight" for n, m in field.named_modules()}
    big = {names[m] for m in (field.pts_bias, *field.pts_linears,
                              field.feature_linear, field.views_linears[0])}
    real = fused_mlp.weight_grads

    def dist(a, b):
        return float((a.double() - b).norm() / b.norm())

    def probe(field_, p, f, v, bufs, offs, d_pack):
        real(field_, p, f, v, bufs, offs, d_pack)
        out = torch.zeros_like(d_pack)
        real(field_, p, f, v, bufs, offs, out)
        twin = fused_mlp.weight_grads_plain(field_, p, f, v, bufs)
        exact = fused_mlp.weight_grads_plain(
            wide, p.double(), f.double(), v.double(),
            {k: t.double() for k, t in bufs.items()})
        print(f"chunk of {p.shape[0]} points, norm-wise from float64 on the "
              f"same buffers: pass 2 | its float32 twin")
        for (name, a), (_, b), (_, c) in zip(
                fused_mlp.pack_leaves(field_, out, offs),
                fused_mlp.pack_leaves(field_, twin, offs),
                fused_mlp.pack_leaves(wide, exact, offs)):
            if name in big:
                print(f"  {name}: {dist(a, c):.3e} | {dist(b, c):.3e}")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LAUNCHES):
            real(field_, p, f, v, bufs, offs, out)
        end.record()
        end.synchronize()
        print(f"pass 2: {start.elapsed_time(end) / LAUNCHES:.3f} ms per chunk "
              f"({torch.cuda.get_device_name(0)})")

    probe.launches = 0                 # the wrapper counts on its module name
    fused_mlp.weight_grads = probe
    try:
        fused_mlp.fused_nerf_backward(field, pts, feats, views, g, pack,
                                      offsets)
    finally:
        fused_mlp.weight_grads = real
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
