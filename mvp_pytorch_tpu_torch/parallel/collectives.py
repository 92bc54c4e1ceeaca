"""Eval sharding, gathers and the autograd-aware collectives.

The JAX package's `parallel/collectives.py` (the reference's
`oscar/sequential_eval_utils.py:11-80`: SequentialDistributedSampler +
distributed_concat):
- `sequential_shards` / `unpad_concat`: pad-to-divisible sequential shards
  that wrap around, and their rank-ordered concatenation without the pad;
- `process_shard_indices`: this rank's eval shard, over the data ranks of
  the driver's mesh (every model and pipe rank of one data coordinate takes
  the same shard, since they run one model together);
- `gather_eval_arrays`: an all-gather in rank order, then the truncation;
- `all_reduce_metrics`: the mean of scalar metrics over a group;
- `GlobalBatch`: how a data-parallel step's loss reads its global batch.

The JAX package needs no more: GSPMD inserts the collectives its shardings
imply. Here the parallel model paths call them by hand, as autograd
functions whose backward is the collective the forward's use implies:

| function              | forward                 | backward              |
|-----------------------|-------------------------|-----------------------|
| `gather_rows`         | all-gather along dim    | reduce-scatter (sum)  |
| `gather_replicated`   | all-gather along dim    | this rank's slice     |
| `split_replicated`    | this rank's slice       | all-gather            |
| `reduce_scatter`      | reduce-scatter (sum)    | all-gather            |
| `reduce_from_region`  | all-reduce (sum)        | identity              |
| `copy_to_region`      | identity                | all-reduce (sum)      |
| `all_to_all`          | all_to_all_single       | all_to_all_single     |

"replicated" means that every rank of the group computes the same thing
downstream, so each rank's gradient is already the whole gradient.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


# ---------------------------------------------------------------------------
# eval sharding (host side)
# ---------------------------------------------------------------------------

def sequential_shards(total: int, world: int) -> Tuple[np.ndarray, int]:
    """Pad-to-divisible sequential shard indices: ([world, per_rank] indices
    that wrap around, like the reference's padded
    SequentialDistributedSampler, total)."""
    per_rank = math.ceil(total / world)
    padded = np.arange(world * per_rank) % total
    return padded.reshape(world, per_rank), total


def unpad_concat(shards, total: int) -> np.ndarray:
    """Rank-ordered shards concatenated, the wrap padding dropped."""
    return np.concatenate(list(shards), axis=0)[:total]


def _eval_coords():
    """(rank, world, group) of the eval shards: the data ranks of the
    driver's mesh, else every rank."""
    from .mesh import default_mesh
    mesh = default_mesh()
    if mesh is not None:
        return mesh.data_rank, mesh.data_size, mesh.data_group
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), None
    return 0, 1, None


def process_shard_indices(total: int) -> np.ndarray:
    """This rank's sequential eval-shard indices (wrap-padded so that every
    rank runs as many batches). Identity on one rank."""
    r, world, _ = _eval_coords()
    if world == 1:
        return np.arange(total)
    return sequential_shards(total, world)[0][r]


def gather_eval_arrays(total: int, *arrays):
    """Each rank's outputs for its `process_shard_indices`, concatenated in
    rank order and truncated to `total`; every rank gets the whole. One
    rank: truncation only."""
    _, world, group = _eval_coords()
    arrays = [np.asarray(a) for a in arrays]
    if world == 1:
        return tuple(a[:total] for a in arrays)
    got = [None] * world
    dist.all_gather_object(got, arrays, group=group)
    return tuple(unpad_concat([g[i] for g in got], total)
                 for i in range(len(arrays)))


def all_reduce_metrics(metrics: Dict[str, torch.Tensor], group=None,
                       world: Optional[int] = None
                       ) -> Dict[str, torch.Tensor]:
    """The mean of each scalar metric over `group` (the reference's
    all_reduce at run_pretrain_ml.py:688-689), in one collective."""
    if not metrics:
        return metrics
    world = world or dist.get_world_size(group)
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    if world > 1:
        dist.all_reduce(flat, group=group)
        flat = flat / world
    return dict(zip(keys, flat.unbind(0)))


# ---------------------------------------------------------------------------
# autograd-aware collectives (model side)
# ---------------------------------------------------------------------------

def _size(group) -> int:
    return dist.get_world_size(group)


def _rank(group) -> int:
    return dist.get_rank(group)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = _size(group), _rank(group)
    part = x.shape[dim] // n
    return x.narrow(dim, r * part, part).contiguous()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group), None, None


class _SplitReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def gather_rows(x, group, dim: int = 0):
    """All-gather along `dim`; backward reduce-scatters (sums) the gradient,
    since each rank's loss reads every rank's rows."""
    return _GatherRows.apply(x, dim, group)


def gather_replicated(x, group, dim: int = 0):
    """All-gather along `dim` into a region every rank computes alike;
    backward keeps this rank's slice."""
    return _GatherReplicated.apply(x, dim, group)


def split_replicated(x, group, dim: int = 0):
    """This rank's equal slice of a replicated tensor; backward all-gathers."""
    return _SplitReplicated.apply(x, dim, group)


def reduce_scatter(x, group, dim: int = 0):
    """Sum partial tensors over the group and keep this rank's slice along
    `dim`; backward all-gathers."""
    return _ReduceScatter.apply(x, dim, group)


def reduce_from_region(x, group):
    """Megatron's g: all-reduce (sum) forward, identity backward."""
    return _ReduceFromRegion.apply(x, group)


def copy_to_region(x, group):
    """Megatron's f: identity forward, all-reduce (sum) backward."""
    return _CopyToRegion.apply(x, group)


def all_to_all(x, group):
    """`all_to_all_single` over equal splits of dim 0; its own transpose."""
    return _AllToAll.apply(x, group)


def gather_nograd(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """All-gather along `dim` of a tensor that carries no gradient (indices,
    masks)."""
    return _all_gather(x.detach(), dim, group)


# ---------------------------------------------------------------------------
# the global batch of a data-parallel training step
# ---------------------------------------------------------------------------

class GlobalBatch:
    """How a loss reads the global batch of a data-parallel step: the one
    owner of that rule. The Trainer makes one for its mesh and passes it to
    a loss_fn that has a `global_batch` parameter; the loss_fn passes it to
    the model, which hands it to each term that spans the batch (the
    contrastive matrix and hard negatives in `models/bi_encoder.py`, WRA's
    negative spans and the masked means in `models/pretrain.py`, the masked
    means in `models/img_bert.py`).

    Over more than one data rank every method but `rank` / `ranks` is a
    collective of the data group, which every data rank calls in the same
    order: a loss term that one rank skips hangs the step. `LOCAL` (one
    rank, the default everywhere) computes each locally."""

    def __init__(self, mesh=None):
        self.mesh = mesh if mesh is not None and mesh.data_size > 1 else None

    @property
    def ranks(self) -> int:
        return 1 if self.mesh is None else self.mesh.data_size

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.data_rank

    def rows(self, x: torch.Tensor, grad: bool = False) -> torch.Tensor:
        """Every data rank's rows of `x` in rank order: the global batch's.
        With `grad` the backward sums each rank's gradient of them back to
        the rank that owns the rows (`gather_rows`)."""
        if self.mesh is None:
            return x
        group = self.mesh.data_group
        return gather_rows(x, group) if grad else gather_nograd(x, group)

    def from_first(self, x: torch.Tensor) -> torch.Tensor:
        """Data rank 0's `x` on every data rank (a sampled choice made
        once for the global batch)."""
        if self.mesh is None:
            return x
        x = x.contiguous()
        dist.broadcast(x, src=self.mesh.group_rank_to_global("data", 0),
                       group=self.mesh.data_group)
        return x

    def own_rows(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's `n` rows of a global-batch tensor `x`."""
        return x if self.mesh is None else x[self.rank * n:
                                             (self.rank + 1) * n]

    def mean(self, total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
        """A masked mean over the global batch from this rank's `total` and
        `count`: total * ranks / (the count summed over the data ranks), so
        that the ranks' average is the global mean; 0 where nothing
        counts."""
        ranks = self.ranks
        if ranks > 1:
            count = count.detach().clone()
            dist.all_reduce(count, group=self.mesh.data_group)
        return torch.where(count > 0, total * ranks / count.clamp(min=1.0),
                           torch.zeros_like(total))


LOCAL = GlobalBatch()


__all__ = [
    "GlobalBatch", "LOCAL",
    "sequential_shards", "unpad_concat", "process_shard_indices",
    "gather_eval_arrays", "all_reduce_metrics", "gather_rows",
    "gather_replicated", "split_replicated", "reduce_scatter",
    "reduce_from_region", "copy_to_region", "all_to_all", "gather_nograd",
]
