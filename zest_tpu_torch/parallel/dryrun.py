"""Steps with their rays split over several processes, and the multi-rank
dry run (counterpart of ``__graft_entry__.dryrun_multichip``).

``run_ranks(n, fn, *args)`` starts n processes joined by a process group
(gloo over ``tcp://127.0.0.1:<a free port>``), runs ``fn(mesh, *args)`` in
each and returns their results in rank order. ``split_step`` is one such
``fn``: training steps' losses, logs and gradients, and an eval image
each, with the rays split over the ranks, on inputs that ``save_inputs``
wrote. ``dryrun_multichip(n)`` runs one full training step
at ``__graft_entry__._tiny_cfg``'s shapes on n CPU ranks:

    python -m zest_tpu_torch.parallel.dryrun 2
"""
from __future__ import annotations

import dataclasses
import math
import socket
import sys
import tempfile
import warnings
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from .. import sampling
from ..config import ZestConfig
from ..data.synthetic import SyntheticDataset
from ..system import Phase, TrainState, ZestSystem, phase_for_step, to_batch
from .mesh import make_mesh, replicate

RANK_TIMEOUT = timedelta(seconds=300)   # a collective's wait for a lost rank


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, n, port, fn, args, out_dir):
    if not torch.cuda.is_available():
        # n ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    # gloo: NCCL refuses two ranks on one card
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n, timeout=RANK_TIMEOUT)
    try:
        torch.save(fn(make_mesh(), *args), Path(out_dir) / f"{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(n: int, fn, *args) -> list:
    """``fn(mesh, *args)`` on n spawned processes joined by one gloo
    process group -> each rank's result (tensors, numbers, strings and containers
    of them), in rank order. ``fn`` is a module-level function (the
    processes import it by name). A rank that raises fails the call, and
    the other ranks are stopped."""
    with tempfile.TemporaryDirectory() as out:
        torch.multiprocessing.spawn(
            _entry, args=(n, _free_port(), fn, args, out), nprocs=n, join=True)
        return [torch.load(Path(out) / f"{r}.pt", weights_only=True)
                for r in range(n)]


def save_inputs(path, cfg, batch, params, draws, phase, step: int) -> None:
    """The inputs of ``split_step``, as CPU tensors and plain values."""
    cpu = {k: v.detach().cpu() for k, v in batch.items()}
    torch.save(dict(config=dataclasses.asdict(cfg), batch=cpu,
                    params={k: v.detach().cpu() for k, v in params.items()},
                    draws=[None if t is None else t.cpu() for t in draws],
                    phase=list(phase), step=step), path)


def load_inputs(path, device) -> tuple:
    """``save_inputs``' file -> (cfg, batch, params, draws, phase, step) on
    ``device``."""
    inp = torch.load(path, weights_only=True)
    return (ZestConfig(**inp["config"]),
            {k: v.to(device) for k, v in inp["batch"].items()},
            {k: v.to(device) for k, v in inp["params"].items()},
            sampling.Draws(*(None if t is None else t.to(device)
                             for t in inp["draws"])),
            Phase(*inp["phase"]), inp["step"])


def split_step(mesh, inputs_paths) -> list:
    """For each of ``save_inputs``' files, on the CPU: one training step's
    ``loss_and_grads`` with the rays split over ``mesh``, then the eval
    maps of the batch's target view with each chunk split. Returns one dict
    per file: loss, logs, grads, maps, and the messages of the warnings
    raised."""
    results = []
    for path in inputs_paths:
        cfg, batch, params, draws, phase, step = load_inputs(path, "cpu")
        system = ZestSystem(cfg)
        system.mesh = mesh
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            loss, logs, grads = system.loss_and_grads(params, batch, draws,
                                                      phase, step)
            maps = system.make_eval_step()(params, batch)
        results.append(dict(loss=loss, logs=logs, grads=grads, maps=maps,
                            warnings=[str(w.message) for w in caught]))
    return results


def _tiny_cfg(batch_size: int = 64) -> ZestConfig:
    # feature space is H/4 x W/4; CostRegNet needs (h+2p, w+2p) divisible by 8
    return ZestConfig(train_sceneflow=True, use_mvs=True, use_mvs_dy=True, pad=4,
                      num_keyframes=3, netdepth=8, netwidth=64, multires=10,
                      multires_views=4, N_samples=32, batch_size=batch_size,
                      num_extra_samples=0, use_motion_mask=False,
                      decay_iteration=30, with_chain_loss=True,
                      pts_embedder=True, dir_embedder=True, use_viewdirs=True,
                      num_epochs=10, raw_noise_std=1.0)


def _dryrun_rank(mesh) -> float:
    """One full training step at ``_tiny_cfg``'s shapes, 8 rays a rank,
    from weights of seed 0 that rank 0 broadcasts; returns the loss."""
    cfg = _tiny_cfg(batch_size=8 * mesh.size)
    # num_frames=9: the keyframe interval rule yields exactly 3 keyframes
    batch = to_batch(SyntheticDataset(img_h=32, img_w=64, num_frames=9,
                                      num_keyframes=cfg.num_keyframes)[3],
                     "cpu")
    system = ZestSystem(cfg)
    system.mesh = mesh
    params = {k: replicate(v, mesh) for k, v in
              system.init_params(torch.Generator().manual_seed(0)).items()}
    opt = system.make_optimizer(8)
    phase = phase_for_step(cfg, 0)
    draws = sampling.sample_draws(torch.Generator().manual_seed(1), cfg, 32,
                                  64, int(batch["motion_count"]),
                                  phase.extra_samples)
    state, logs = system.make_train_step(opt)(
        TrainState(params, opt.init(params), 0), batch, draws, phase)
    loss = float(logs["train_loss"])
    if state.step != 1 or not math.isfinite(loss):
        raise AssertionError(f"step {state.step}, loss {loss}")
    return loss


def dryrun_multichip(n_ranks: int) -> float:
    """ONE full training step (``_tiny_cfg``: both fields and volumes, the
    chain loss) with its rays split over n CPU ranks joined by gloo; every
    rank must reach the same finite loss. Prints and returns it."""
    from . import dryrun   # by its package name, so the ranks import it
    losses = run_ranks(n_ranks, dryrun._dryrun_rank)
    if len(set(losses)) != 1:
        raise AssertionError(f"the ranks' losses differ: {losses}")
    print(f"dryrun_multichip({n_ranks}) OK: loss={losses[0]:.4f}")
    return losses[0]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
