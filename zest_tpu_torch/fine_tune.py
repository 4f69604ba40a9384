"""Fine-tuning entry point (counterpart of the root ``fine_tune.py``):

    python -m zest_tpu_torch.fine_tune --config <file> --finetune_scene <scene>
        [--ckpt <dir>/last] [--<field> <value> ...] [--device {cuda,cpu}]

``train``'s run with the motion-mask extra rays off (``num_extra_samples``
0): it resumes ``last`` or starts from ``--ckpt``. Exits with 2 when
``--device cuda`` (the default) finds no CUDA device.
"""
import sys

from .cli import parse
from .train_loop import run_training


def main(argv=None) -> int:
    parsed = parse("zest_tpu_torch.fine_tune", argv)
    if parsed is None:
        return 2
    cfg, opts = parsed
    run_training(cfg.replace(num_extra_samples=0), device=opts.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
