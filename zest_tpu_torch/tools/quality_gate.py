"""The trained-quality gate on one CUDA card (counterpart of
``tools/quality_gate.py``).

    python -m zest_tpu_torch.tools.quality_gate [N_STEPS] [--precision {16,32}]
        [--seed S] [--device {cuda,cpu}]

Trains ``bench.py``'s flagship configuration (both volumes, scene flow,
every loss; 600 random plus 512 motion-mask rays of 128 samples, width 256)
from fresh weights on the synthetic dynamic scene (288x512, 24 frames, 8
keyframes) for N_STEPS (default 2000) with ``train_loop.run_training``,
then validates the first 2 frames of the same scene (an overfit gate:
~1k random rays per step of the 147k-pixel images, so full-image PSNR
measures reconstruction) and prints one JSON line: ``steps``, ``val_PSNR``,
``val_SSIM``, ``threshold``, ``train_s``, ``passed``. Exits 1 when
val_PSNR is below the floor for N_STEPS (``PSNR_THRESHOLDS``; other step
counts report without gating) and 2 without a CUDA card unless ``--device
cpu`` is given. Precision 16 is how the reference gate runs; the floor is
set for it. The run writes ``metrics.csv``, its checkpoints (``ckpts/``)
and the validation PNGs under
``runs/quality_gate/qgate_p<precision>_seed<seed>/``, cleared first. TF32
is off.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import torch

# val PSNR floors by step count, the reference gate's
PSNR_THRESHOLDS = {2000: 28.0}
VAL_IMAGES = 2
# the reference gate's configuration (its use_viewdirs=True is read by
# neither package: the fields always take the view directions); the run
# directory lies in the working tree, one per precision and seed
CONFIG = dict(train_sceneflow=True, use_mvs=True, use_mvs_dy=True, pad=24,
              num_keyframes=8, netdepth=8, netwidth=256, multires=10,
              multires_views=4, N_samples=128, batch_size=600,
              num_extra_samples=512, use_motion_mask=True,
              decay_iteration=30, with_chain_loss=True, pts_embedder=True,
              dir_embedder=True, use_viewdirs=True, num_epochs=6000,
              raw_noise_std=1.0, img_h=288, img_w=512, precision=16,
              seed_everything=0, steps_per_epoch=1000,
              save_dir="runs/quality_gate", expname="qgate", log_every=200)
SCENE = dict(img_h=288, img_w=512, num_frames=24, num_keyframes=8)


def main(argv=()) -> int:
    parser = argparse.ArgumentParser(prog="quality_gate")
    parser.add_argument("steps", type=int, nargs="?", default=2000)
    parser.add_argument("--precision", type=int, choices=(16, 32), default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("quality_gate: no CUDA device", file=sys.stderr)
        return 2
    from zest_tpu_torch.config import ZestConfig
    from zest_tpu_torch.data.synthetic import SyntheticDataset
    from zest_tpu_torch.train_loop import run_training, validate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ZestConfig(**dict(
        CONFIG, precision=args.precision, seed_everything=args.seed,
        expname=f"{CONFIG['expname']}_p{args.precision}_seed{args.seed}"))
    run_dir = Path(cfg.save_dir) / cfg.expname
    # a gate run starts at step 0 from fresh weights with an empty log: the
    # loop would resume from the directory's ckpts/last
    shutil.rmtree(run_dir, ignore_errors=True)
    if args.device == "cuda":
        print(f"device: {torch.cuda.get_device_name(0)}, precision "
              f"{args.precision}, seed {args.seed}", flush=True)
    train_ds = SyntheticDataset(**SCENE)
    val_ds = SyntheticDataset(**SCENE)       # the same scene: overfit gate

    t0 = time.perf_counter()
    state, system = run_training(cfg, {"train": train_ds},
                                 max_steps=args.steps, device=args.device)
    if args.device == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    print(f"trained {args.steps} steps in {train_s:.1f} s "
          f"({train_s / max(args.steps, 1):.4f} s/step, warm-up included)",
          flush=True)

    out = validate(cfg, system, system.make_eval_step(), state.params, val_ds,
                   run_dir, args.steps, max_images=VAL_IMAGES, tag="qgate")
    psnr = out["val_PSNR"]
    thresh = PSNR_THRESHOLDS.get(args.steps)
    passed = thresh is None or psnr >= thresh
    print(json.dumps({"steps": args.steps, "val_PSNR": round(psnr, 3),
                      "val_SSIM": round(out["val_SSIM"], 4),
                      "threshold": thresh, "train_s": round(train_s, 1),
                      "passed": passed}), flush=True)
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
