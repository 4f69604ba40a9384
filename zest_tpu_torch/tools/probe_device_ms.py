"""The two device timings of ``probe_trilinear``, side by side, on the
shortest calls ``chip_smoke.py`` times, on one CUDA card.

    python -m zest_tpu_torch.tools.probe_device_ms [--repeats N]

For each call, N times in turn: ``probe_trilinear.device_ms`` (the
profiler's kernel durations; whether it refused the session and whether it
missed events) and ``probe_trilinear.queued_ms`` (CUDA events around calls
queued behind a spin kernel; whether they were queued whole). The calls:
the time-code fold and its backward at the Neural 3D Video flagship's
shapes (code [1024], W_code [2, 256, 1024]) and the ``torch.matmul`` each
is timed beside (a cuBLAS gemv of ~2 us: the profiler's shortest sessions),
a 4096 x 4096 float32 matmul (~2.6 ms), and a call that waits for the card
(a host-to-device copy of one float), which cannot be queued. Prints the
card's name and power limit, a line per call (medians, ranges, refusals,
sessions with missed events, readings queued whole) and a last line of
JSON with every reading.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

from zest_tpu_torch.tools import probe_trilinear as pt


def calls(dev) -> dict:
    from zest_tpu_torch.kernels import time_codes
    gen = torch.Generator(device=dev).manual_seed(0)
    code = torch.rand(1024, generator=gen, device=dev)
    wc = torch.randn((2, 256, 1024), generator=gen, device=dev)
    b = torch.randn((2, 256), generator=gen, device=dev)
    d_c = torch.randn((2, 256), generator=gen, device=dev)
    a = torch.randn((4096, 4096), generator=gen, device=dev)
    return {
        "fold": lambda: time_codes.fold_codes(code, wc, b, False),
        "fold_library": lambda: torch.matmul(wc.view(512, 1024), code),
        "fold_grad": lambda: time_codes.fold_codes_grad(code, wc, d_c, False),
        "fold_grad_library": lambda: torch.matmul(d_c.view(1, -1),
                                                  wc.view(-1, 1024)),
        "matmul_4096": lambda: a @ a,
        "waits_for_the_card": lambda: torch.tensor([1.0], device=dev) + 1,
    }


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("probe_device_ms: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(prog="probe_device_ms")
    parser.add_argument("--repeats", type=int, default=20)
    args = parser.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    fns = calls(dev)
    out = {k: {"device_ms": [], "refused": 0, "missed": 0, "queued_ms": [],
               "queued_whole": 0} for k in fns}
    with torch.no_grad():
        for _ in range(args.repeats):
            for name, fn in fns.items():
                r = out[name]
                try:
                    r["device_ms"].append(pt.device_ms(fn))
                    r["missed"] += bool(pt.device_ms.lost)
                except RuntimeError as err:
                    r["refused"] += 1
                    print(f"{name}: {err}", flush=True)
                r["queued_ms"].append(pt.queued_ms(fn))
                r["queued_whole"] += pt.queued_ms.queued
    for name, r in out.items():
        d, q = r["device_ms"], r["queued_ms"]
        print(f"{name}: device_ms median "
              + (f"{statistics.median(d):.5f} ({min(d):.5f}-{max(d):.5f})"
                 if d else "-")
              + f", refused {r['refused']}, sessions missing events "
              f"{r['missed']} | queued_ms median {statistics.median(q):.5f} "
              f"({min(q):.5f}-{max(q):.5f}), queued whole "
              f"{r['queued_whole']} of {len(q)}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
