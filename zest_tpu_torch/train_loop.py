"""The training loop, its checkpoints, full-image validation and test, and
CSV metric logging (counterpart of ``zest_tpu.train_loop``).

``run_training(cfg[, datasets], max_steps)`` trains from fresh weights, or
resumes from ``--ckpt`` or ``<save_dir>/<expname>/ckpts/last``: passes over
a seeded permutation of the training frames, each step with its phase and
its draws, logs every ``log_every`` steps and a validation every
``min(N_vis, ceil(num_epochs / N_vis))`` epochs, checkpoints the top 5 by
validation loss and ``last`` (``checkpoint.CheckpointManager``).
``validate`` renders full images and returns their loss, PSNR and SSIM,
with PNG dumps of the first four; ``run_test`` runs it on the test split
from ``--ckpt`` and writes ``test_metrics.txt``. ``build_datasets`` builds
the config's dataset: a real scene on disk (NSFF, LLFF, DTU, Neural 3D
Video) or the synthetic scene.

Every system ``system.ZestSystem`` builds trains here: with or without
scene flow (``validate`` and the test read ``rgb_map_ref`` /
``depth_map_ref``, or ``rgb_map`` / ``depth_map`` without it) and with
either, both or neither volume (the synthetic scene then has no keyframes
or no neighbours), and with ``gan_type`` the adversarial (SVS) step of
``system_gan.GanSystem`` (generator and discriminators, its whole state
checkpointed), where ``acc_grad`` > 1 is warned about and ignored, as
``zest_tpu`` does. Elsewhere ``acc_grad`` > 1 accumulates the mean
gradient over that many steps (``system.MultiSteps``). With
``lpips_weights`` validation and the test report ``val_LPIPS``; a file that
does not load is an error. With ``train_video`` each sample's
``keyframe_id`` (the Neural 3D Video loader's) picks the step's time code;
a dataset without it is refused before the first step. ``MetricLogger``
writes metrics.csv and, when ``wandb`` imports, a W&B run whose id is kept
in ``wandb_id.txt`` (``WandbAdapter``). With ``vis_cnn`` ``run_test`` first
dumps the static encoder's activations (``utils.introspect``).
"""
from __future__ import annotations

import contextlib
import csv
import json
import time
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import metrics, sampling
from .checkpoint import CheckpointManager, restore_path
from .data.pipeline import prefetch_to_device
from .data import dataset_dict
from .system import (MultiSteps, TrainState, ZestSystem, phase_for_step,
                     to_batch, unpreprocess)
from .utils.visualize import save_image, visualize_depth


def build_datasets(cfg, splits=("train", "val")) -> dict:
    """One dataset per split, the ``dataset_name`` loader of
    ``data.dataset_dict`` built with ``zest_tpu``'s keyword arguments: the
    scene of ``finetune_scene`` (else the split lists under ``configdir``),
    DTU's validation cut to 10 samples, LLFF's ``depth_path`` for training,
    Neural 3D Video's ``key_frames`` and the NSFF / synthetic scene
    options.

    One deliberate difference from ``zest_tpu``: it compares
    ``dataset_name`` with "neural3dvideo" for the Neural 3D Video option,
    which its registry names "neural3Dvideo", so ``key_frames`` never
    reaches its loader; the port passes it. With ``--key_frames True`` on
    Neural 3D Video the two packages therefore build other samples (the
    keyframes only here, every frame in ``zest_tpu``); with the default
    (False) they build the same."""
    ds_fn = dataset_dict[cfg.dataset_name]
    out = {}
    for split in splits:
        kwargs = {}
        if cfg.finetune_scene is not None:
            kwargs["scene"] = cfg.finetune_scene
        if cfg.dataset_name == "dtu":
            kwargs["max_len"] = -1 if split != "val" else 10
        if cfg.dataset_name == "llff":
            kwargs["depth_path"] = cfg.depth_path if split == "train" else None
        if cfg.dataset_name == "neural3Dvideo":
            kwargs["train_key_frames"] = cfg.key_frames
        if cfg.dataset_name in ("nsff", "synthetic"):
            kwargs.update(num_keyframes=cfg.num_keyframes, use_mvs=cfg.use_mvs,
                          use_mvs_dy=cfg.use_mvs_dy, img_h=cfg.img_h,
                          img_w=cfg.img_w, crossval=cfg.crossval,
                          frame_jump=cfg.frame_jump)
        down = cfg.imgScale_train if split == "train" else cfg.imgScale_test
        out[split] = ds_fn(cfg.datadir, config_dir=cfg.configdir, split=split,
                           downSample=down,
                           closest_views=cfg.use_closest_views, **kwargs)
    return out


class WandbAdapter:
    """The W&B sink, with the reference's resumable run id: the id is kept
    in ``<save_dir>/wandb_id.txt``, so a resumed training continues the same
    run (project "SVS", ``resume="allow"``). Raises when ``wandb`` does not
    import; ``_maybe_wandb`` gates it."""

    def __init__(self, save_dir: Path, expname: str):
        import wandb
        id_file = save_dir / "wandb_id.txt"
        if id_file.exists():
            run_id = id_file.read_text().strip()
        else:
            run_id = wandb.util.generate_id()
            save_dir.mkdir(parents=True, exist_ok=True)
            id_file.write_text(run_id)
        self.run = wandb.init(project="SVS", name=expname, id=run_id,
                              resume="allow")

    def log(self, step: int, scalars: dict):
        self.run.log({k: float(v) for k, v in scalars.items()}, step=step)

    def close(self):
        self.run.finish()


def _maybe_wandb(save_dir: Path, expname: str):
    """A ``WandbAdapter``, or None when ``wandb`` does not import or its
    init raises (no package, no network): the CSV log goes on alone."""
    try:
        return WandbAdapter(save_dir, expname)
    except Exception:
        return None


class MetricLogger:
    """``<save_dir>/metrics.csv``, one row per ``log`` call, and with
    ``expname`` set the W&B run of ``_maybe_wandb`` (dormant without
    ``wandb``).

    Train and validation rows carry different keys; a row that brings new
    keys rewrites the file with the wider header, so no column is dropped.
    An existing file's rows are kept."""

    def __init__(self, save_dir: Path, expname: str = ""):
        save_dir.mkdir(parents=True, exist_ok=True)
        self.path = save_dir / "metrics.csv"
        self._wandb = _maybe_wandb(save_dir, expname) if expname else None
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
        if self._wandb is not None:
            self._wandb.log(step, {k: v for k, v in row.items() if k != "step"})

    def close(self):
        if self._fh:
            self._fh.close()
        if self._wandb is not None:
            self._wandb.close()


def _maybe_lpips(cfg, device="cpu"):
    """The LPIPS metric (``models.lpips.LPIPS``) when ``lpips_weights`` is
    set, else None. A file that does not load is an error, not a metric
    quietly dropped."""
    if not cfg.lpips_weights:
        return None
    from .models.lpips import load_lpips
    try:
        return load_lpips(cfg.lpips_weights, device)
    except Exception as e:
        raise RuntimeError(
            f"--lpips_weights {cfg.lpips_weights!r} was set but loading "
            f"failed; refusing to silently disable the LPIPS metric") from e


def validate(cfg, system, eval_fn, params, val_ds, save_dir: Path, step: int,
             max_images: Optional[int] = None, tag="val") -> dict:
    """Full-image validation on the device ``params`` lie on: the mean
    val_loss (MSE), val_PSNR and val_SSIM (and val_LPIPS with
    ``lpips_weights``) of the first ``max_images`` images (all by default),
    the rendered RGB clipped to [0, 1], and rgb / depth / error PNGs of the
    first 4 under ``<save_dir>/<tag>_images``."""
    device = next(iter(params.values())).device
    lpips_fn = _maybe_lpips(cfg, device)
    img_dir = save_dir / f"{tag}_images"
    img_dir.mkdir(parents=True, exist_ok=True)
    n = len(val_ds) if max_images is None else min(len(val_ds), max_images)
    key = "rgb_map_ref" if cfg.train_sceneflow else "rgb_map"
    dkey = "depth_map_ref" if cfg.train_sceneflow else "depth_map"
    psnrs, ssims, losses, lpips_vals = [], [], [], []
    with torch.no_grad():
        for i in range(n):
            batch = to_batch(val_ds[i], device)
            maps = eval_fn(params, batch)
            tgt = unpreprocess(batch["images"][-1])
            pred = torch.clamp(maps[key], 0.0, 1.0)
            losses.append(float(torch.mean((pred - tgt) ** 2)))
            psnrs.append(float(metrics.psnr(pred, tgt)))
            ssims.append(float(metrics.ssim(pred, tgt, 5)))
            if lpips_fn is not None:
                lpips_vals.append(float(lpips_fn(pred, tgt)))
            if i < 4:
                save_image(img_dir / f"{step:08d}_{i:02d}_rgb.png",
                           pred.cpu().numpy())
                save_image(img_dir / f"{step:08d}_{i:02d}_depth.png",
                           visualize_depth(maps[dkey].cpu().numpy()))
                save_image(img_dir / f"{step:08d}_{i:02d}_err.png",
                           (pred - tgt).abs().cpu().numpy() * 5)
    out = {"val_loss": float(np.mean(losses)),
           "val_PSNR": float(np.mean(psnrs)),
           "val_SSIM": float(np.mean(ssims))}
    if lpips_vals:
        out["val_LPIPS"] = float(np.mean(lpips_vals))
    return out


def _check_like(restored, state, path) -> None:
    """A restored state must be of the state's kind (with or without the
    GAN) and hold its parameter, discriminator and spectral names and
    shapes."""
    if type(restored) is not type(state):
        raise ValueError(f"checkpoint {path} holds a {type(restored).__name__}"
                         f", this config trains a {type(state).__name__}")
    fields = ("params", "disc_params", "depth_disc_params", "disc_vars") \
        if hasattr(state, "disc_params") else ("params",)
    for field in fields:
        want = {k: tuple(v.shape) for k, v in getattr(state, field).items()}
        got = {k: tuple(v.shape) for k, v in getattr(restored, field).items()}
        if got != want:
            diff = sorted(set(got) ^ set(want)) or sorted(
                k for k in want if got[k] != want[k])
            raise ValueError(f"checkpoint {path} does not fit this config's "
                             f"parameters: {diff[:5]}")


def run_training(cfg, datasets: Optional[dict] = None,
                 max_steps: Optional[int] = None, quiet: bool = False,
                 device="cuda"):
    """Train on ``datasets["train"]`` (validating on ``datasets["val"]``
    when given; ``build_datasets(cfg)`` when None) up to ``max_steps``
    steps (default: ``max_train_steps``, else ``num_epochs *
    steps_per_epoch``). Returns (the final state, the ``ZestSystem``):
    a ``TrainState``, or with ``gan_type`` a ``GanTrainState``.

    The state starts from fresh weights, or from ``cfg.ckpt``, or else from
    ``<save_dir>/<expname>/ckpts/last`` when that exists, at the saved step
    with the saved Adam states (and spectral state). After each pass over the frames the loop
    validates when the epoch is due (then writes a top-k checkpoint) and
    writes ``last``; it writes ``last`` again at the end.

    The seed is ``seed_everything`` (0 when negative): it seeds the weights
    (``init_params`` on a CPU generator, so every device starts from the
    same numbers), the frame order (``np.random.default_rng``, one
    permutation per pass over the frames) and the step's draws (one
    generator on ``device``). A resumed run takes the order and the draws
    from the seed's start again, as ``zest_tpu`` does. The epoch of a pass
    is taken at its start. Metrics are read from the device only at log
    steps and validations."""
    device = torch.device(device)
    if cfg.N_importance > 0:
        warnings.warn("N_importance > 0 builds an unused fine network in the "
                      "reference and is a no-op here", stacklevel=2)
    run_dir = Path(cfg.save_dir) / cfg.expname
    seed = cfg.seed_everything if cfg.seed_everything >= 0 else 0
    datasets = datasets or build_datasets(cfg)
    train_ds, val_ds = datasets["train"], datasets.get("val")
    if cfg.train_video and "keyframe_id" not in train_ds[0]:
        raise ValueError("train_video reads each sample's keyframe_id, which "
                         "only the Neural 3D Video loader (dataset_name "
                         "neural3Dvideo) gives; these samples have none")
    steps_per_epoch = cfg.steps_per_epoch or len(train_ds)

    ckpt = CheckpointManager(run_dir / "ckpts", cfg)
    logger = MetricLogger(run_dir, cfg.expname)
    system = ZestSystem(cfg).to(device)
    init_gen = torch.Generator().manual_seed(seed)
    if cfg.gan_type:
        from .system_gan import GanSystem
        if cfg.acc_grad > 1:
            warnings.warn("acc_grad > 1 is not supported on the GAN path; "
                          "ignoring it", stacklevel=2)
        gan = GanSystem(system).to(device)
        state = gan.init(init_gen, steps_per_epoch).to(device)
        step_fn = gan.make_train_step(
            system.make_optimizer(steps_per_epoch),
            gan.make_disc_optimizer(steps_per_epoch))
    else:
        params = {k: v.to(device) for k, v in
                  system.init_params(init_gen).items()}
        # the cosine counts optimizer steps: one per acc_grad steps
        optimizer = system.make_optimizer(
            max(steps_per_epoch // max(cfg.acc_grad, 1), 1))
        if cfg.acc_grad > 1:
            optimizer = MultiSteps(optimizer, cfg.acc_grad)
        state = TrainState(params, optimizer.init(params), 0)
        step_fn = system.make_train_step(optimizer)
    resume = cfg.ckpt or (ckpt.dir / "last" if ckpt.has_last() else None)
    if resume:
        restored = restore_path(resume, device)
        _check_like(restored, state, resume)
        state = restored
        if not quiet and not cfg.ckpt:
            print(f"resumed from {resume} at step {state.step}", flush=True)
    eval_fn = system.make_eval_step()
    gen = torch.Generator(device=device).manual_seed(seed)

    total_steps = max_steps if max_steps is not None else \
        (cfg.max_train_steps if cfg.max_train_steps > 0
         else cfg.num_epochs * steps_per_epoch)
    check_val_every = max(min(cfg.N_vis, -(-cfg.num_epochs // cfg.N_vis)), 1)

    host_step = state.step
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
                        gen, cfg, H, W, int(batch.get("motion_count", 1)),
                        phase.extra_samples, host_step)
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
                ckpt.save_topk(state, val_logs["val_loss"], host_step)
            ckpt.save_last(state)
        ckpt.save_last(state)
    finally:
        logger.close()
    return state, system


def run_test(cfg, datasets: Optional[dict] = None, quiet: bool = False,
             device="cuda") -> dict:
    """Full-image metrics over the test split (``build_datasets(cfg,
    ("test",))`` when ``datasets`` is None) with the weights of
    ``cfg.ckpt``: ``validate`` (tag "test", PNGs of the first four) and
    ``<save_dir>/<expname>/test_metrics.txt`` (PSNR, SSIM, and LPIPS with
    ``lpips_weights``). Without ``cfg.ckpt`` it warns and evaluates fresh
    weights of seed 0. With ``vis_cnn`` and a static volume it first dumps
    the static encoder's activations on the first test sample's source
    views under ``cfg.save_test`` (``utils.introspect``), on ``device``."""
    device = torch.device(device)
    datasets = datasets or build_datasets(cfg, splits=("test",))
    test_ds = datasets["test"]
    save_dir = Path(cfg.save_dir) / cfg.expname
    save_dir.mkdir(parents=True, exist_ok=True)

    system = ZestSystem(cfg).to(device)
    if cfg.ckpt:
        params = restore_path(cfg.ckpt, device).params
    else:
        # a legitimate-looking test_metrics.txt of random weights: be loud
        warnings.warn("run_test called without --ckpt: evaluating randomly "
                      "initialised weights, not a trained model", stacklevel=2)
        params = {k: v.to(device) for k, v in
                  system.init_params(torch.Generator().manual_seed(0)).items()}
    if cfg.vis_cnn and system.enc_static is not None:
        from .utils.introspect import dump_encoder_activations
        system.enc_static.load_state_dict(
            {k[len("enc_static."):]: v for k, v in params.items()
             if k.startswith("enc_static.")})
        b0 = to_batch(test_ds[0], device)
        dump_encoder_activations(system.enc_static, b0["images"][:-1],
                                 b0["proj_mats"][:-1], b0["near_fars"][0],
                                 cfg.pad, cfg.save_test)
    out = validate(cfg, system, system.make_eval_step(), params, test_ds,
                   save_dir, 0, tag="test")
    with open(save_dir / "test_metrics.txt", "w") as f:
        f.write(f"PSNR: {out['val_PSNR']}\n")
        f.write(f"SSIM: {out['val_SSIM']}\n")
        if "val_LPIPS" in out:
            f.write(f"LPIPS: {out['val_LPIPS']}\n")
    if not quiet:
        print(json.dumps(out), flush=True)
    return out
