"""Steps with their rays split over several processes, and the multi-rank
dry run (counterpart of ``__graft_entry__.dryrun_multichip``).

``run_ranks(n, fn, *args)`` starts n processes joined by a process group
(gloo over ``tcp://127.0.0.1:<a free port>``), runs ``fn(mesh, *args)`` in
each and returns their results in rank order. ``split_step`` and
``split_gan_step`` are such ``fn``s: training steps' losses, logs and
gradients (and an eval image each, or the GAN step's discriminator state
after the step), with the rays split over the ranks, on inputs that
``save_inputs`` wrote. ``dryrun_multichip(n)`` runs one full training step
at ``__graft_entry__._tiny_cfg``'s shapes on n ranks, each on the card
(``cuda:0``, shared) unless the caller asks for the CPU:

    python -m zest_tpu_torch.parallel.dryrun 2 [--device cpu]
"""
from __future__ import annotations

import argparse
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
from ..system_gan import GanSystem, GanTrainState
from .mesh import RanksDisagree, make_mesh, replicate

RANK_TIMEOUT = timedelta(seconds=300)   # a collective's wait for a lost rank


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, n, port, fn, args, out_dir, threads):
    if threads:
        torch.set_num_threads(threads)
    elif not torch.cuda.is_available():
        # n ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    # gloo: NCCL refuses two ranks on one card
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n, timeout=RANK_TIMEOUT)
    try:
        torch.save(fn(make_mesh(), *args), Path(out_dir) / f"{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(n: int, fn, *args, threads: int = 0) -> list:
    """``fn(mesh, *args)`` on n spawned processes joined by one gloo
    process group -> each rank's result (tensors, numbers, strings and containers
    of them), in rank order. ``fn`` is a module-level function (the
    processes import it by name). A rank that raises fails the call, and
    the other ranks are stopped. ``threads`` sets each rank's intra-op
    threads (by default, without a card, the host's cores over n): the
    CPU's float32 sums, oneDNN's convolutions among them, take another
    order at another thread count."""
    with tempfile.TemporaryDirectory() as out:
        torch.multiprocessing.spawn(
            _entry, args=(n, _free_port(), fn, args, out, threads), nprocs=n,
            join=True)
        return [torch.load(Path(out) / f"{r}.pt", weights_only=True)
                for r in range(n)]


def map_tensors(x, fn):
    """fn on every tensor of a tree of dicts (other leaves kept)."""
    if isinstance(x, dict):
        return {k: map_tensors(v, fn) for k, v in x.items()}
    return fn(x) if isinstance(x, torch.Tensor) else x


def save_inputs(path, cfg, batch, params, draws, phase, step: int) -> None:
    """The inputs of ``split_step`` (``params`` a state dict) or of
    ``split_gan_step`` (``params`` a ``GanTrainState``), as CPU tensors and
    plain values."""
    def cpu(t):
        return t.detach().cpu()
    weights = (dict(gan_state={f: map_tensors(v, cpu) for f, v in
                               params._asdict().items()})
               if isinstance(params, GanTrainState)
               else dict(params=map_tensors(params, cpu)))
    torch.save(dict(config=dataclasses.asdict(cfg),
                    batch=map_tensors(batch, cpu),
                    draws=[None if t is None else t.cpu() for t in draws],
                    phase=list(phase), step=step, **weights), path)


def load_inputs(path, device) -> tuple:
    """``save_inputs``' file -> (cfg, batch, params or the GanTrainState,
    draws, phase, step) on ``device``."""
    inp = torch.load(path, weights_only=True)

    def move(t):
        return t.to(device)
    weights = (GanTrainState(**map_tensors(inp["gan_state"], move))
               if "gan_state" in inp else map_tensors(inp["params"], move))
    return (ZestConfig(**inp["config"]), map_tensors(inp["batch"], move),
            weights,
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


class _Recorded:
    """An optimizer that keeps each gradient tree it is handed."""

    def __init__(self, optimizer):
        self.optimizer, self.seen = optimizer, []

    def init(self, params):
        return self.optimizer.init(params)

    def update(self, grads, opt_state, params):
        self.seen.append({k: v.detach().clone() for k, v in grads.items()})
        return self.optimizer.update(grads, opt_state, params)


def gan_step(gan: GanSystem, state: GanTrainState, batch, draws,
             phase: Phase, steps_per_epoch: int = 8) -> dict:
    """One GAN step (``make_train_step`` with the system's optimizers)
    -> dict(logs, state: the GanTrainState after the step, and the
    gradients its optimizers were handed: gen_grads, disc_grads and
    depth_grads, the last empty without a depth discriminator)."""
    opt = _Recorded(gan.system.make_optimizer(steps_per_epoch))
    d_opt = _Recorded(gan.make_disc_optimizer(steps_per_epoch))
    new, logs = gan.make_train_step(opt, d_opt)(state, batch, draws, phase)
    return dict(logs={k: v.detach() for k, v in logs.items()}, state=new,
                gen_grads=opt.seen[0], disc_grads=d_opt.seen[0],
                depth_grads=d_opt.seen[1] if len(d_opt.seen) > 1 else {})


def split_gan_step(mesh, inputs_paths) -> list:
    """For each entry of ``inputs_paths`` (a ``save_inputs`` file of a GAN
    step, or one such file per rank, in rank order), on the CPU: one GAN
    step (``gan_step``) with the rays split over ``mesh``. Returns one dict
    per entry: ``gan_step``'s (its state as a dict), the messages of the
    warnings raised, and ``refused``, the message of a ``RanksDisagree``
    (None where the step ran)."""
    results = []
    for entry in inputs_paths:
        path = entry if isinstance(entry, (str, Path)) else entry[mesh.rank]
        cfg, batch, state, draws, phase, _ = load_inputs(path, "cpu")
        gan = GanSystem(ZestSystem(cfg))
        gan.system.mesh = mesh
        out = dict(refused=None)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                out.update(gan_step(gan, state, batch, draws, phase))
            except RanksDisagree as e:
                out["refused"] = str(e)
        out["warnings"] = [str(w.message) for w in caught]
        if "state" in out:
            out["state"] = out["state"]._asdict()
        results.append(out)
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


def _dryrun_rank(mesh, device) -> float:
    """One full training step at ``_tiny_cfg``'s shapes on ``device``, 8
    rays a rank, from weights of seed 0 that rank 0 broadcasts; returns
    the loss."""
    cfg = _tiny_cfg(batch_size=8 * mesh.size)
    # num_frames=9: the keyframe interval rule yields exactly 3 keyframes
    batch = to_batch(SyntheticDataset(img_h=32, img_w=64, num_frames=9,
                                      num_keyframes=cfg.num_keyframes)[3],
                     device)
    system = ZestSystem(cfg).to(device)
    system.mesh = mesh
    params = {k: replicate(v.to(device), mesh) for k, v in
              system.init_params(torch.Generator().manual_seed(0)).items()}
    opt = system.make_optimizer(8)
    phase = phase_for_step(cfg, 0)
    draws = sampling.sample_draws(torch.Generator().manual_seed(1), cfg, 32,
                                  64, int(batch["motion_count"]),
                                  phase.extra_samples).to(device)
    state, logs = system.make_train_step(opt)(
        TrainState(params, opt.init(params), 0), batch, draws, phase)
    loss = float(logs["train_loss"])
    if state.step != 1 or not math.isfinite(loss):
        raise AssertionError(f"step {state.step}, loss {loss}")
    return loss


def dryrun_multichip(n_ranks: int, device: str = "cuda") -> float:
    """ONE full training step (``_tiny_cfg``: both fields and volumes, the
    chain loss) with its rays split over n ranks joined by gloo, each on
    ``device`` (``cuda``: all on ``cuda:0``, which they share; NCCL
    refuses two ranks on one card); every rank must reach the same finite
    loss. Prints and returns it."""
    from . import dryrun   # by its package name, so the ranks import it
    if device == "cuda":
        device = "cuda:0"
    losses = run_ranks(n_ranks, dryrun._dryrun_rank, device)
    if len(set(losses)) != 1:
        raise AssertionError(f"the ranks' losses differ: {losses}")
    print(f"dryrun_multichip({n_ranks}) on {device} OK: loss={losses[0]:.4f}")
    return losses[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m zest_tpu_torch.parallel.dryrun",
        description="one training step split over N gloo ranks")
    p.add_argument("n_ranks", type=int, nargs="?", default=2)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print(f"{p.prog}: no CUDA device (--device cpu runs on the CPU)",
                  file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dryrun_multichip(args.n_ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
