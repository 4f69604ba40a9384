"""K6's float32 mode (3xTF32) on two eval chunks, on one CUDA card: its
distance from a float64 twin and its time.

    python -m zest_tpu_torch.tools.probe_tc32_sums

The chunks are the flagship's first eval chunk (``presets.FLAGSHIP`` on
``FLAGSHIP_SCENE``, the static and the dynamic field, 16,384 rays of 128
samples) and the LLFF MVSNeRF file's (``config_mvsnerf_llff.txt`` at
float32 on a scene from ``tools.scene_fixtures.write_llff_scene`` at
``chip_smoke.py``'s phase-16 size), each with seeded weights. For each
field it prints one JSON line: K6's norm-wise distance from the float64
twin (``probe_bf16_sums.float64_twin``) beside the float32 twin's, and
K6's ms per chunk (CUDA events, the mean of 3 after a warm-up). A last
line gives the build's ptxas lines for the float32 kernels. To compare
two versions of K6's sums (``kStepSum`` of ``csrc/fused_mlp_tc.cuh``'s
``product``), run it from each tree in turns in one chip call: each builds
its own library. TF32 is off.
"""
from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import torch

from zest_tpu_torch.kernels import _build, fused_mlp
from zest_tpu_torch.tools.probe_bf16_sums import (LLFF_FILE, SCENE, SEED,
                                                  events_ms, float64_twin)


def distance(field, inputs, out, rows=1 << 18) -> float:
    """Norm-wise distance of ``out`` (the field's output on ``inputs``)
    from the float64 twin's, in slices of ``rows`` points."""
    wide = float64_twin(field)
    flat = [t.reshape(-1, t.shape[-1]) for t in inputs]
    num = den = 0.0
    with torch.no_grad():
        for s in range(0, flat[0].shape[0], rows):
            ref = wide(*(t[s:s + rows].double() for t in flat))
            d = out.reshape(-1, ref.shape[-1])[s:s + rows].double() - ref
            num += float((d * d).sum())
            den += float((ref * ref).sum())
    return (num / den) ** 0.5


def chunk_of(system, batch) -> dict:
    """{field kind: its inputs} on the batch's first eval chunk."""
    from zest_tpu_torch import render
    with torch.no_grad():
        models = system.render_models(batch)
        rays = system.chunk_rays(batch, 0)
        kw = system.render_kwargs(batch)
        out = {"static": render.static_field_inputs(models, rays,
                                                    kw["im_w2c_ref"])}
        if system.nerf_dynamic is not None:
            out["dynamic"] = render.dynamic_field_inputs(
                models, rays, kw["nb_w2c_ref"], kw["ref_frame_idx"])
    return out


def probe(label, system, batch) -> None:
    for kind, inputs in chunk_of(system, batch).items():
        field = getattr(system, f"nerf_{kind}")
        with torch.no_grad():
            k6 = fused_mlp.fused_nerf_forward(field, *inputs)
            twin = field(*inputs)
            ms = events_ms(lambda: fused_mlp.fused_nerf_forward(field,
                                                                 *inputs))
        print(json.dumps(dict(
            chunk=label, field=kind, points=inputs[0].numel()
            // inputs[0].shape[-1], k6_float64_distance=distance(
                field, inputs, k6), twin_float64_distance=distance(
                field, inputs, twin), k6_ms=ms)), flush=True)
        del k6, twin
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_tc32_sums: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from zest_tpu_torch import presets
    from zest_tpu_torch.config import config_parser
    from zest_tpu_torch.system import ZestSystem, to_batch
    from zest_tpu_torch.tools import scene_fixtures as sf
    from zest_tpu_torch.train_loop import build_datasets
    dev = torch.device("cuda", 0)
    _, system, batch, _ = presets.build(presets.FLAGSHIP,
                                        presets.FLAGSHIP_SCENE, dev, SEED)
    probe("flagship", system, batch)
    del system, batch
    with tempfile.TemporaryDirectory() as tmp:
        sf.write_llff_scene(Path(tmp) / "llff", **SCENE)
        cfg = config_parser(["--config", LLFF_FILE, "--datadir",
                             str(Path(tmp) / "llff"), "--finetune_scene",
                             SCENE["scene"], "--precision", "32"])
        sample = build_datasets(cfg, ("val",))["val"][0]
    system = ZestSystem(cfg).to(dev)
    system.load_state_dict({k: v.to(dev) for k, v in
                            presets.seeded_params(system, SEED).items()})
    probe("llff", system, to_batch(sample, dev))
    ptxas, entry = [], None
    for line in _build.build_info.get("ptxas", "").splitlines():
        if "Compiling entry" in line:
            entry = next((k for k in ("fused_nerf_tc32_kernel",
                                      "recompute_tc32_kernel")
                          if k in line), None)
        elif entry and ("Used" in line or "spill" in line):
            ptxas.append(f"{entry}: {line.strip()}")
    print(json.dumps(dict(card=torch.cuda.get_device_name(0),
                          time=time.strftime("%H:%M:%S"), ptxas=ptxas)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
