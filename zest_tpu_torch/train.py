"""Training entry point (counterpart of the root ``train.py``):

    python -m zest_tpu_torch.train --config <file> [--<field> <value> ...]
        [--device {cuda,cpu}]

Trains with ``train_loop.run_training``: from ``--ckpt``, or resumed from
``<save_dir>/<expname>/ckpts/last``, or from fresh weights. Exits with 2
when ``--device cuda`` (the default) finds no CUDA device.
"""
import sys

from .cli import parse
from .train_loop import run_training


def main(argv=None) -> int:
    parsed = parse("zest_tpu_torch.train", argv)
    if parsed is None:
        return 2
    cfg, opts = parsed
    run_training(cfg, device=opts.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
