"""Path rendering entry point (counterpart of the root ``render_spiral.py``):

    python -m zest_tpu_torch.render_spiral --config <file> --ckpt <dir>/last
        [--render_path {auto,wander,spiral,spheric}] [--frame_range LO HI]
        [--n_poses N] [--<field> <value> ...] [--device {cuda,cpu}]

``--render_path wander`` renders the 60-pose bullet-time orbit of each test
frame in ``--frame_range`` (default 20 to 51) with
``render_paths.run_wanderpath``; ``spiral`` and ``spheric`` render an
LLFF-format scene's spiral or circle, 60 poses by default, with
``render_paths.run_llff_spiral``. ``auto`` (the default) is ``spiral`` on
``dataset_name llff`` and ``wander`` elsewhere. ``--n_poses`` cuts either
path. Exits with 2 when ``--device cuda`` (the default) finds no CUDA
device.
"""
import sys

from .cli import parse


def main(argv=None) -> int:
    parsed = parse("zest_tpu_torch.render_spiral", argv, path_args=True)
    if parsed is None:
        return 2
    cfg, opts = parsed
    kind = cfg.render_path
    if kind == "auto":
        kind = "spiral" if cfg.dataset_name == "llff" else "wander"
    if kind == "wander":
        from .render_paths import run_wanderpath
        run_wanderpath(cfg, frame_range=tuple(opts.frame_range),
                       n_poses=opts.n_poses, device=opts.device)
    elif kind in ("spiral", "spheric"):
        from .render_paths import run_llff_spiral
        run_llff_spiral(cfg, n_poses=60 if opts.n_poses is None
                        else opts.n_poses, spheric=kind == "spheric",
                        device=opts.device)
    else:
        raise SystemExit(f"unknown --render_path {kind!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
