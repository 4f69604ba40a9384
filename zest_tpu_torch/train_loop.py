"""The training loop, full-image validation and CSV metric logging
(counterpart of ``zest_tpu.train_loop``).

``run_training(cfg, {"train": ds, "val": ds}, max_steps)`` trains from fresh
weights: passes over a seeded permutation of the training frames, each step
with its phase and its draws, logs every ``log_every`` steps and a
validation every ``min(N_vis, ceil(num_epochs / N_vis))`` epochs.
``validate`` renders full images and returns their loss, PSNR and SSIM,
with PNG dumps of the first four.

Not ported yet, and refused by name: resuming from a checkpoint (``ckpt``,
or the auto-resume from ``<save_dir>/<expname>/ckpts/last``), gradient
accumulation (``acc_grad`` > 1), the GAN branch and LPIPS. The loop saves
no checkpoints and has no W&B sink; ``run_test`` and the real-data loaders
are not ported.
"""
from __future__ import annotations

import contextlib
import csv
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import metrics, sampling
from .data.pipeline import prefetch_to_device
from .system import TrainState, ZestSystem, phase_for_step, to_batch, unpreprocess
from .utils.visualize import save_image, visualize_depth


class MetricLogger:
    """``<save_dir>/metrics.csv``, one row per ``log`` call.

    Train and validation rows carry different keys; a row that brings new
    keys rewrites the file with the wider header, so no column is dropped.
    An existing file's rows are kept."""

    def __init__(self, save_dir: Path):
        save_dir.mkdir(parents=True, exist_ok=True)
        self.path = save_dir / "metrics.csv"
        self._keys: list = []
        self._rows: list = []
        self._fh = None
        self._writer = None
        if self.path.exists():
            with open(self.path, newline="") as f:
                reader = csv.DictReader(f)
                self._keys = list(reader.fieldnames or [])
                self._rows = list(reader)

    def _reopen(self):
        if self._fh:
            self._fh.close()
        self._fh = open(self.path, "w", newline="")
        self._writer = csv.DictWriter(self._fh, fieldnames=self._keys,
                                      restval="")
        self._writer.writeheader()
        for row in self._rows:
            self._writer.writerow(row)

    def log(self, step: int, scalars: dict):
        """Write one row; reads each value (a device tensor waits here)."""
        row = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        new = [k for k in row if k not in self._keys]
        self._rows.append(row)
        if new or self._fh is None:
            self._keys += new
            self._reopen()
        else:
            self._writer.writerow(row)
        self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()


def _refuse_lpips(cfg) -> None:
    if cfg.lpips_weights:
        raise NotImplementedError(
            f"zest_tpu_torch does not port LPIPS yet (lpips_weights="
            f"{cfg.lpips_weights!r})")


def validate(cfg, system, eval_fn, params, val_ds, save_dir: Path, step: int,
             max_images: Optional[int] = None, tag="val") -> dict:
    """Full-image validation on the device ``params`` lie on: the mean
    val_loss (MSE), val_PSNR and val_SSIM of the first ``max_images`` images
    (all by default), the rendered RGB clipped to [0, 1], and rgb / depth /
    error PNGs of the first 4 under ``<save_dir>/<tag>_images``."""
    _refuse_lpips(cfg)
    img_dir = save_dir / f"{tag}_images"
    img_dir.mkdir(parents=True, exist_ok=True)
    device = next(iter(params.values())).device
    n = len(val_ds) if max_images is None else min(len(val_ds), max_images)
    key = "rgb_map_ref" if cfg.train_sceneflow else "rgb_map"
    dkey = "depth_map_ref" if cfg.train_sceneflow else "depth_map"
    psnrs, ssims, losses = [], [], []
    with torch.no_grad():
        for i in range(n):
            batch = to_batch(val_ds[i], device)
            maps = eval_fn(params, batch)
            tgt = unpreprocess(batch["images"][-1])
            pred = torch.clamp(maps[key], 0.0, 1.0)
            losses.append(float(torch.mean((pred - tgt) ** 2)))
            psnrs.append(float(metrics.psnr(pred, tgt)))
            ssims.append(float(metrics.ssim(pred, tgt, 5)))
            if i < 4:
                save_image(img_dir / f"{step:08d}_{i:02d}_rgb.png",
                           pred.cpu().numpy())
                save_image(img_dir / f"{step:08d}_{i:02d}_depth.png",
                           visualize_depth(maps[dkey].cpu().numpy()))
                save_image(img_dir / f"{step:08d}_{i:02d}_err.png",
                           (pred - tgt).abs().cpu().numpy() * 5)
    return {"val_loss": float(np.mean(losses)),
            "val_PSNR": float(np.mean(psnrs)),
            "val_SSIM": float(np.mean(ssims))}


def _check_supported(cfg, run_dir: Path) -> None:
    ckpts = run_dir / "ckpts"
    unsupported = {
        f"ckpt={cfg.ckpt!r}": bool(cfg.ckpt),
        f"auto-resume from {ckpts / 'last'}": (
            (ckpts / "last").exists() or (ckpts / "last.npz").exists()),
        f"gan_type={cfg.gan_type!r}": cfg.gan_type is not None,
        f"acc_grad={cfg.acc_grad}": cfg.acc_grad > 1,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"zest_tpu_torch's training loop does not port {bad} yet")
    _refuse_lpips(cfg)


def run_training(cfg, datasets: dict, max_steps: Optional[int] = None,
                 quiet: bool = False, device="cuda"):
    """Train from fresh weights on ``datasets["train"]`` (validating on
    ``datasets["val"]`` when given) for ``max_steps`` steps (default:
    ``max_train_steps``, else ``num_epochs * steps_per_epoch``). Returns
    (the final TrainState, the system).

    The seed is ``seed_everything`` (0 when negative): it seeds the weights
    (``init_params`` on a CPU generator, so every device starts from the
    same numbers), the frame order (``np.random.default_rng``, one
    permutation per pass over the frames) and the step's draws (one
    generator on ``device``). The epoch of a pass is taken at its start.
    Metrics are read from the device only at log steps and validations."""
    device = torch.device(device)
    run_dir = Path(cfg.save_dir) / cfg.expname
    _check_supported(cfg, run_dir)
    seed = cfg.seed_everything if cfg.seed_everything >= 0 else 0
    train_ds, val_ds = datasets["train"], datasets.get("val")
    steps_per_epoch = cfg.steps_per_epoch or len(train_ds)

    logger = MetricLogger(run_dir)
    system = ZestSystem(cfg).to(device)
    params = {k: v.to(device) for k, v in
              system.init_params(torch.Generator().manual_seed(seed)).items()}
    optimizer = system.make_optimizer(steps_per_epoch)
    state = TrainState(params, optimizer.init(params), 0)
    step_fn = system.make_train_step(optimizer)
    eval_fn = system.make_eval_step()
    gen = torch.Generator(device=device).manual_seed(seed)

    total_steps = max_steps if max_steps is not None else \
        (cfg.max_train_steps if cfg.max_train_steps > 0
         else cfg.num_epochs * steps_per_epoch)
    check_val_every = max(min(cfg.N_vis, -(-cfg.num_epochs // cfg.N_vis)), 1)

    host_step = 0
    perm_rng = np.random.default_rng(seed)
    t_last = time.perf_counter()
    try:
        while host_step < total_steps:
            epoch = host_step // steps_per_epoch
            order = perm_rng.permutation(len(train_ds))
            with contextlib.closing(
                    prefetch_to_device(train_ds, iter(order), device)) as frames:
                for batch in frames:
                    if host_step >= total_steps:
                        break
                    phase = phase_for_step(cfg, host_step)
                    _, H, W, _ = batch["images"].shape
                    draws = sampling.sample_draws(
                        gen, cfg, H, W, int(batch["motion_count"]),
                        phase.extra_samples)
                    state, logs = step_fn(state, batch, draws, phase)
                    host_step += 1
                    if host_step % cfg.log_every == 0:
                        dt = time.perf_counter() - t_last
                        t_last = time.perf_counter()
                        sps = cfg.log_every / dt
                        logger.log(host_step, {**logs, "steps_per_sec": sps})
                        if not quiet:
                            print(f"step {host_step} loss="
                                  f"{float(logs['train_loss']):.4f} PSNR="
                                  f"{float(logs['train_PSNR']):.2f} "
                                  f"({sps:.2f} it/s)", flush=True)

            if val_ds is not None and (epoch + 1) % check_val_every == 0:
                val_logs = validate(cfg, system, eval_fn, state.params, val_ds,
                                    run_dir, host_step, max_images=4)
                logger.log(host_step, val_logs)
                if not quiet:
                    print(f"epoch {epoch}: " + " ".join(
                        f"{k}={v:.4f}" for k, v in val_logs.items()),
                        flush=True)
    finally:
        logger.close()
    return state, system
