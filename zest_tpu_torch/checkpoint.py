"""Checkpoints with ``zest_tpu.checkpoint``'s retention (counterpart of
``zest_tpu.checkpoint``): the best ``top_k`` by validation loss plus ``last``.

A checkpoint is one ``torch.save`` file of a training state's fields
({params, opt_state, step}, or the eight of the GAN's ``GanTrainState``,
the discriminators' spectral ``u``s among them) named as ``zest_tpu``
names its checkpoint directories: ``<dir>/last`` and
``<dir>/step{step:08d}-val{val_loss:.3f}``, so ``--ckpt <dir>/last`` reads
the same in both packages (each its own format). ``scores.json`` maps the
kept top-k names to their losses; ``config.json`` holds the run's config.
Loading takes ``weights_only=True`` and a ``map_location``, so a checkpoint
written on the card restores on the CPU and the other way round.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional

import torch

from .config import ZestConfig
from .system import TrainState
from .system_gan import GanTrainState


class CheckpointManager:
    """top-k-by-val-loss + last retention of a ``TrainState`` or a
    ``GanTrainState``."""

    def __init__(self, ckpt_dir, cfg: Optional[ZestConfig] = None, top_k: int = 5):
        self.dir = Path(ckpt_dir).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.top_k = top_k
        if cfg is not None:
            (self.dir / "config.json").write_text(
                json.dumps(dataclasses.asdict(cfg), indent=1))
        self._scores_path = self.dir / "scores.json"

    def _write(self, name: str, state):
        """Write to a temporary name, then rename: a run killed while saving
        leaves the previous checkpoint whole."""
        path = self.dir / name
        tmp = path.with_name(path.name + ".tmp")
        torch.save(dict(state._asdict(), step=int(state.step)), tmp)
        os.replace(tmp, path)

    def save_last(self, state):
        self._write("last", state)

    def save_topk(self, state, val_loss: float, step: int):
        """Save a monitored checkpoint; prune beyond top_k by val_loss (min)."""
        scores = {}
        if self._scores_path.exists():
            scores = json.loads(self._scores_path.read_text())
        name = f"step{step:08d}-val{val_loss:.3f}"
        self._write(name, state)
        scores[name] = val_loss
        ranked = sorted(scores.items(), key=lambda kv: kv[1])
        for victim, _ in ranked[self.top_k:]:
            scores.pop(victim, None)
            (self.dir / victim).unlink(missing_ok=True)
        self._scores_path.write_text(json.dumps(scores, indent=1))

    def restore(self, name: str, map_location="cpu"):
        """The checkpoint ``name`` with every tensor on ``map_location``: a
        ``GanTrainState`` where it holds the discriminators, else a
        ``TrainState``."""
        path = self.dir / name
        if not path.is_file():
            raise FileNotFoundError(path)
        ckpt = torch.load(path, map_location=map_location, weights_only=True)
        cls = GanTrainState if "disc_params" in ckpt else TrainState
        return cls(**dict(ckpt, step=int(ckpt["step"])))

    def has_last(self) -> bool:
        return (self.dir / "last").is_file()

    @staticmethod
    def load_config(ckpt_dir) -> Optional[ZestConfig]:
        p = Path(ckpt_dir) / "config.json"
        if not p.exists():
            return None
        return ZestConfig(**json.loads(p.read_text()))


def restore_path(path, map_location="cpu"):
    """The checkpoint at ``path`` (``--ckpt``: ``<dir>/<name>``)."""
    path = Path(path)
    return CheckpointManager(path.parent).restore(path.name, map_location)
