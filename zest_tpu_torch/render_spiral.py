"""Path rendering entry point (counterpart of the root ``render_spiral.py``):

    python -m zest_tpu_torch.render_spiral --config <file> --ckpt <dir>/last
        [--render_path {auto,wander}] [--frame_range LO HI] [--n_poses N]
        [--<field> <value> ...] [--device {cuda,cpu}]

``--render_path wander`` (and ``auto``, except on LLFF scenes) renders the
60-pose bullet-time orbit of each test frame in ``--frame_range`` (default
20 to 51) with ``render_paths.run_wanderpath``. The LLFF ``spiral`` and
``spheric`` paths are not ported yet and are refused by name. Exits with 2
when ``--device cuda`` (the default) finds no CUDA device.
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
    if kind in ("spiral", "spheric"):
        raise NotImplementedError(
            f"zest_tpu_torch does not port --render_path {kind} (the LLFF "
            f"paths) yet")
    if kind != "wander":
        raise SystemExit(f"unknown --render_path {kind!r}")
    from .render_paths import run_wanderpath
    run_wanderpath(cfg, frame_range=tuple(opts.frame_range),
                   n_poses=opts.n_poses, device=opts.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
