"""Evaluation entry point (counterpart of the root ``test.py``):

    python -m zest_tpu_torch.test --config <file> --ckpt <dir>/last
        [--render_wanderpath [--frame_range LO HI] [--n_poses N]]
        [--<field> <value> ...] [--device {cuda,cpu}]

Renders the test split with the weights of ``--ckpt`` and writes
``<save_dir>/<expname>/test_metrics.txt`` (``train_loop.run_test``); with
``--render_wanderpath``, renders the bullet-time wander path instead
(``render_paths.run_wanderpath``). Exits with 2 when ``--device cuda`` (the
default) finds no CUDA device.
"""
import sys

from .cli import parse


def main(argv=None) -> int:
    parsed = parse("zest_tpu_torch.test", argv, path_args=True)
    if parsed is None:
        return 2
    cfg, opts = parsed
    if cfg.render_wanderpath:
        from .render_paths import run_wanderpath
        run_wanderpath(cfg, frame_range=tuple(opts.frame_range),
                       n_poses=opts.n_poses, device=opts.device)
    else:
        from .train_loop import run_test
        run_test(cfg, device=opts.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
