"""Ray sharding over a ``torch.distributed`` process group (counterpart of
``zest_tpu.parallel.mesh``).

Design: the ranks of a group are a 1-D ``data`` mesh. Every rank holds the
same parameters and the same batch and draws; a step's rays (and each eval
chunk's) are split into contiguous shards, one per rank. Each rank builds
the encoding volumes (replicated: one per image, light beside the ray loop)
and renders its shard; ``gather_rays`` then hands every rank all ranks'
per-ray outputs, so the loss is computed over all rays, identically on
every rank: the masked means, the median of the depth loss, the
distortion sums and the patch regularizers need whole batches, and a mean
of per-rank losses would be wrong. The gather's backward returns a rank its
own slice of the gradient, so each rank's parameter gradient is its rays'
share, and ``sum_over_ranks`` adds the shares. A ray count that does not
divide the group warns and runs replicated (``shard_rays``). A step whose
ranks hold different draws is refused (``check_replicated``): their shards
would be of different rays. Where every rank computes the same update
(the GAN step's discriminators), rank 0's numbers stand for all
(``replicate_all``), so that sums taken in another order on another card
cannot drift the ranks apart.

Every collective here is an ``all_reduce`` (or a ``broadcast``): gloo takes
only those two on CUDA tensors, and two ranks can share one card only over
gloo (NCCL refuses them).
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class RanksDisagree(ValueError):
    """The ranks of a split step hold inputs that should be, and are not,
    the same on every rank."""


class Mesh(NamedTuple):
    """An initialised process group as a 1-D ``data`` mesh."""
    group: object
    rank: int
    size: int

    def splits(self, n: int) -> bool:
        """Whether n rays split evenly over the ranks."""
        return n % self.size == 0


def make_mesh(group=None) -> Mesh:
    """The mesh of ``group`` (the default group when None), which
    ``torch.distributed.init_process_group`` has initialised."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "call torch.distributed.init_process_group first")
    group = group or dist.group.WORLD
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group))


def shard_rays(x, mesh: Optional[Mesh]):
    """This rank's contiguous shard of x's leading (ray) axis.

    No-op without a mesh; warns when the ray count does not divide the
    mesh size, and returns x whole: every rank then computes every ray."""
    if mesh is None:
        return x
    n = x.shape[0]
    if not mesh.splits(n):
        warnings.warn(
            f"shard_rays: ray count {n} does not divide mesh size "
            f"{mesh.size}; rays will be REPLICATED on every rank. Pick a "
            f"batch_size divisible by the rank count.", stacklevel=2)
        return x
    k = n // mesh.size
    return x[mesh.rank * k:(mesh.rank + 1) * k]


class _GatherRays(torch.autograd.Function):
    """Every rank's shard, in rank order: an all_reduce of a zero tensor
    holding this rank's shard in its slot (exact: the other slots add
    zeros). The backward returns this rank's slot of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        k = x.shape[0]
        out = x.new_zeros((k * mesh.size,) + tuple(x.shape[1:]))
        out[mesh.rank * k:(mesh.rank + 1) * k] = x
        dist.all_reduce(out, group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        k = g.shape[0] // mesh.size
        return g[mesh.rank * k:(mesh.rank + 1) * k], None


def gather_rays(x, mesh: Optional[Mesh]):
    """The inverse of ``shard_rays`` on a split ray axis: the ranks' shards
    of x, concatenated in rank order, on every rank. Its gradient is this
    rank's slice of the gathered tensor's."""
    if mesh is None:
        return x
    return _GatherRays.apply(x, mesh)


def _flat(tensors: dict, collective) -> dict:
    """``collective`` (in place) on one buffer of all of ``tensors``,
    flattened, then the buffer as the tensors again."""
    flat = torch.cat([t.reshape(-1) for t in tensors.values()])
    collective(flat)
    out, at = {}, 0
    for k, t in tensors.items():
        out[k] = flat[at:at + t.numel()].view_as(t)
        at += t.numel()
    return out


def sum_over_ranks(tensors: dict, mesh: Optional[Mesh]) -> dict:
    """Each tensor summed over the ranks (one all_reduce of them all,
    flattened into one buffer)."""
    if mesh is None or not tensors:
        return tensors
    return _flat(tensors, lambda t: dist.all_reduce(t, group=mesh.group))


def replicate_all(tensors: dict, mesh: Optional[Mesh]) -> dict:
    """Each tensor as rank 0 holds it, on every rank (one broadcast of
    them all, flattened into one buffer)."""
    if mesh is None or not tensors:
        return tensors
    return _flat(tensors, lambda t: dist.broadcast(
        t, src=dist.get_global_rank(mesh.group, 0), group=mesh.group))


def check_replicated(tensors: dict, mesh: Optional[Mesh], what: str) -> None:
    """Raise ``RanksDisagree``, on every rank, unless every rank holds the
    same ``tensors`` (None entries skipped; all on one device): one
    ``all_reduce`` (MAX) of two float64 fingerprints of each, the sum and
    the index-weighted sum, beside their negatives."""
    names = [k for k, t in tensors.items() if t is not None]
    if mesh is None or not names:
        return
    prints = []
    for k in names:
        t = tensors[k].detach().reshape(-1).double()
        weights = torch.arange(1, t.numel() + 1, device=t.device,
                               dtype=torch.float64)
        prints += [t.sum(), (t * weights).sum()]
    prints = torch.stack(prints)
    both = torch.cat([prints, -prints])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=mesh.group)
    spread = (both[:len(prints)] + both[len(prints):]).cpu()   # max - min
    differ = sorted({names[i // 2] for i in range(len(prints))
                     if not spread[i] == 0.0})
    if differ:
        raise RanksDisagree(
            f"the ranks hold different {what} ({', '.join(differ)}): a split "
            f"step needs the same {what} on every rank (one seed for all)")


def replicate(x, mesh: Optional[Mesh]):
    """x as rank 0 holds it, on every rank (a broadcast, in place)."""
    if mesh is None:
        return x
    dist.broadcast(x, src=dist.get_global_rank(mesh.group, 0),
                   group=mesh.group)
    return x
