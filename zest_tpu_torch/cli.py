"""What the port's command-line modules share: ``--device``, the wander
path's extent, and the config from the remaining arguments
(``config.config_parser``)."""
from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from .config import config_parser


def parse(prog: str, argv=None, path_args: bool = False) -> Optional[tuple]:
    """(config, options) from ``argv`` (``sys.argv[1:]`` by default), or None
    after a message when ``--device cuda`` (the default) finds no CUDA
    device. ``options.device`` is "cuda" or "cpu"; with ``path_args``,
    ``options.frame_range`` (LO HI, default 20 51) and ``options.n_poses``
    (default all 60) bound the path. On the card TF32 is turned off,
    so float32 products are float32's."""
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(prog=prog, add_help=False, allow_abbrev=False)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    if path_args:
        p.add_argument("--frame_range", type=int, nargs=2, default=(20, 51),
                       metavar=("LO", "HI"))
        p.add_argument("--n_poses", type=int, default=None)
    opts, rest = p.parse_known_args(argv)
    if opts.device == "cuda":
        if not torch.cuda.is_available():
            print(f"{prog}: no CUDA device (--device cpu runs on the CPU)",
                  file=sys.stderr)
            return None
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return config_parser(rest), opts
