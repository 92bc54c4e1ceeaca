"""The trainer: the JAX package's `training/trainer.py` step on one device,
or as one rank of a (data, model, pipe) mesh.

The loss_fn contract: loss_fn(model, batch, generator) -> (loss, metrics),
where `batch` maps names to tensors with the batch first and `generator` is a
`torch.Generator` on the model's device, derived from (seed, step, micro
batch), from which every random draw of the step comes. A loss_fn with a
`step` parameter is called loss_fn(model, batch, generator, step), `step`
being the number of optimizer steps taken before this one (the JAX package's
extended contract, for schedules such as VQA's kl -> bce switch); one with a
`global_batch` parameter also gets the step's
`parallel.collectives.GlobalBatch`, which it passes to the model's loss
terms that span the batch. Gradients
land on the model's fp32 master parameters; the model computes in its
config's dtype.

With a `mesh` (`parallel.mesh.make_mesh`) each rank steps on its own rows of
the global batch (`parallel.mesh.shard_batch`, or the loader's sharded
`BatchSampler`):
- the loss_fn's `global_batch` spans the data ranks: the model gathers
  across them, with gradients, what its loss reads of the whole batch (the
  contrastive matrix, the hard negatives and their permutation; see
  `models/bi_encoder.py`), and the masked means divide by the global count,
  so the loss of each rank's share averages to the one-process loss;
- gradients are averaged over the data ranks. AdamW's moments are sharded
  over `data` (ZeRO-2, the JAX default; `zero_sharding=False` keeps them
  whole): each rank reduce-scatters a parameter's gradient along the
  dimension `zero_state_spec` (or `compose_data_spec` on a TP layout)
  picks, updates its slice and all-gathers the parameter. `fsdp` also keeps
  the parameters sharded between steps (all-gathered for the step). The
  collectives go by bucket (`_Bucket`: the parameters of one dtype sharded
  over `data`, or replicated over it): one flat buffer, and so one
  reduce-scatter and one all-gather (or one all-reduce), per bucket and
  step, not per parameter. A rank's slices live in one flat buffer of its
  own, which AdamW updates and the all-gather reads;
- clipping reads the global norm: each rank's sum of squares over the
  tensors it holds, weighted by 1 / their replicas, all-reduced;
- TP / SP / EP parameters are this model rank's shards
  (`apply_tensor_parallel`, done before the optimizer is built); under SP
  the grads of the parameters used in the sequence-cut regions are summed
  over the model ranks;
- a `pipeline_stages > 0` model pipelines its encoders over the pipe ranks
  (`pipeline_microbatches` microbatches); each rank updates only its own
  stage's layers.
The dropout generator of a data rank folds that rank into its seed, so two
data ranks draw different masks; the model and pipe ranks of one data
coordinate share it, so replicated regions agree.
"""

from __future__ import annotations

import contextlib
import inspect
import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .optim import AdamW, global_norm

LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def takes(loss_fn: LossFn, name: str) -> bool:
    """Whether `loss_fn` has a parameter `name`."""
    try:
        return name in inspect.signature(loss_fn).parameters
    except (TypeError, ValueError):
        return False


class _Layout:
    """Where one parameter lives on this rank."""

    def __init__(self, name, spec, global_shape, dim, active, sp_partial,
                 replicas, staged):
        self.name = name
        self.staged = staged            # a pipe stage's layer
        self.spec = spec                # axis per dim of the global shape
        self.global_shape = global_shape
        self.dim = dim                  # the dim sharded over `data`, or None
        self.active = active            # this rank updates it
        self.sp_partial = sp_partial    # grads summed over the model ranks
        self.replicas = replicas        # ranks holding the same tensor


class _Bucket:
    """Parameters whose collectives go in one flat buffer: those of one dtype
    sharded over `data` along their `dims`, or replicated over it (`dims`
    all None: the tensors side by side, for one all-reduce). Sharded, the
    buffer is rank-major: rank r's slices of every tensor side by side, each
    slice contiguous in its tensor's own layout, so one reduce-scatter
    leaves each rank its slices, which AdamW updates in place through
    contiguous views (its multi-tensor fast path), and one all-gather of
    them rebuilds the tensors."""

    def __init__(self, idx, shapes, dims, ranks):
        self.idx, self.shapes, self.dims = list(idx), list(shapes), list(dims)
        self.sharded = self.dims[0] is not None
        self.ranks = ranks if self.sharded else 1
        self.slices = [sh if d is None else
                       sh[:d] + (sh[d] // self.ranks,) + sh[d + 1:]
                       for sh, d in zip(self.shapes, self.dims)]
        self.sizes = [math.prod(sl) for sl in self.slices]

    def _by_rank(self, t: torch.Tensor, d: int) -> torch.Tensor:
        """A view of whole `t` as [ranks, *slice]."""
        return t.unflatten(d, (self.ranks, t.shape[d] // self.ranks)
                           ).movedim(d, 0)

    def pack(self, tensors) -> torch.Tensor:
        """Whole tensors -> the flat buffer."""
        if not self.sharded:
            return torch.cat([t.reshape(-1) for t in tensors])
        return torch.cat([self._by_rank(t, d).reshape(self.ranks, -1)
                          for t, d in zip(tensors, self.dims)], 1).view(-1)

    def views(self, part: torch.Tensor) -> list:
        """One rank's part of the buffer (the whole buffer when replicated)
        -> a contiguous view of each tensor's slice."""
        return [piece.view(sl)
                for piece, sl in zip(part.split(self.sizes), self.slices)]

    def copy_whole(self, gathered: torch.Tensor, tensors) -> None:
        """Every rank's part, all-gathered ([ranks * part]) -> copied into
        the whole `tensors`."""
        full = gathered.view(self.ranks, -1)
        dst, src, off = [], [], 0
        for t, sl, d, k in zip(tensors, self.slices, self.dims, self.sizes):
            dst.append(self._by_rank(t, d))
            src.append(full[:, off:off + k].view((self.ranks,) + sl))
            off += k
        torch._foreach_copy_(dst, src)


def _buckets(layouts, params, key, dims, ranks) -> List[_Bucket]:
    """One `_Bucket` per (sharded or not, dtype) over the parameters whose
    layout passes `key`."""
    groups: Dict[tuple, list] = {}
    for i, lay in enumerate(layouts):
        if key(lay):
            d = dims(lay)
            groups.setdefault((d is None, params[i].dtype), []).append(i)
    return [_Bucket(idx, [tuple(params[i].shape) for i in idx],
                    [dims(layouts[i]) for i in idx], ranks)
            for idx in groups.values()]


class Trainer:
    def __init__(self, model: torch.nn.Module, loss_fn: LossFn,
                 optimizer: AdamW, *, grad_accum: int = 1, seed: int = 0,
                 mesh=None, zero_sharding: bool = True, fsdp: bool = False,
                 pipeline_microbatches: int = 4):
        self.model = model
        self.loss_fn = loss_fn
        self.loss_kw = [k for k in ("step", "global_batch")
                        if takes(loss_fn, k)]
        self.optimizer = optimizer
        self.grad_accum = max(1, grad_accum)
        self.seed = seed
        self.step_count = 0
        self.mesh = mesh
        from ..parallel.collectives import GlobalBatch
        self.global_batch = GlobalBatch(mesh)
        self.zero_sharding = zero_sharding
        self.fsdp = fsdp
        self.pipeline_microbatches = max(1, pipeline_microbatches)
        self.device = next(model.parameters()).device
        self.layouts: List[_Layout] = []
        self._grad_buckets: List[_Bucket] = []      # over `data`
        self._sp_buckets: List[_Bucket] = []        # over `model` (SP)
        # each sharded bucket and this rank's updated slices of it
        self._shards: List[Tuple[_Bucket, torch.Tensor]] = []
        if mesh is not None:
            self._partition()

    # ------------------------------------------------------------ layouts
    def _partition(self) -> None:
        from ..models.layers import StreamEncoder
        from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS,
                                     compose_data_spec, zero_state_spec)
        from ..parallel.pipeline import stage_owners
        mesh, model = self.mesh, self.model
        sizes = dict(mesh.shape)
        tp_specs = getattr(model, "tp_specs", {})
        full_shapes = getattr(model, "tp_full_shapes", {})
        owners = stage_owners(model, mesh.pipe_size)
        if owners and any(isinstance(m, StreamEncoder) and m.sequence_parallel
                          for m in model.modules()):
            raise ValueError("sequence parallelism does not compose with "
                             "the pipe mesh dimension")
        sp_prefixes = [f"{n}.layer." for n, m in model.named_modules()
                       if isinstance(m, StreamEncoder) and m.sequence_parallel
                       and m.tp_mesh is not None]
        targets, weights = [], []
        for name, p in zip(self.optimizer.names, self.optimizer.params):
            tp = tp_specs.get(name, (None,) * p.dim())
            gshape = full_shapes.get(name, tuple(p.shape))
            if self.fsdp or (self.zero_sharding and MODEL_AXIS in tp):
                spec = compose_data_spec(tp, gshape, sizes)
            elif self.zero_sharding:
                spec = zero_state_spec(gshape, mesh.data_size)
            else:
                spec = tp
            dim = spec.index(DATA_AXIS) if DATA_AXIS in spec else None
            owner = owners.get(name)
            active = owner is None or owner == mesh.pipe_rank
            replicas = mesh.world
            for ax in (DATA_AXIS, MODEL_AXIS):
                if ax in spec:
                    replicas //= sizes[ax]
            if owner is not None:
                replicas //= mesh.pipe_size
            sp_partial = (MODEL_AXIS not in tp and ".moe." not in name
                          and any(name.startswith(pre) for pre in sp_prefixes))
            lay = _Layout(name, spec, gshape, dim, active, sp_partial,
                          replicas, owner is not None)
            self.layouts.append(lay)
            targets.append(p.data if active and dim is None else None)
            weights.append(1.0 / replicas)
        params = self.optimizer.params
        self._grad_buckets = _buckets(self.layouts, params,
                                      lambda lay: lay.active,
                                      lambda lay: lay.dim, mesh.data_size)
        self._sp_buckets = _buckets(
            self.layouts, params, lambda lay: lay.active and lay.sp_partial,
            lambda lay: None, 1)
        for b in self._grad_buckets:
            if b.sharded:
                mine = b.pack([params[i].data for i in b.idx]).view(
                    b.ranks, -1)[mesh.data_rank].clone()
                for i, v in zip(b.idx, b.views(mine)):
                    targets[i] = v
                self._shards.append((b, mine))
        self.optimizer.partition(targets, weights, dist.group.WORLD)
        if self.fsdp:
            self.reshard()

    # --------------------------------------------------------------- fsdp
    def unshard(self) -> None:
        """FSDP: all-gather every sharded parameter for the step (no-op
        otherwise, or when they are whole)."""
        if self.fsdp:
            self._gather_whole()

    def reshard(self) -> None:
        """FSDP: free the whole parameters; the shards stay."""
        params = self.optimizer.params
        for b, _ in self._shards:
            for i in b.idx:
                params[i].data = params[i].data.new_empty(0)

    def _gather_whole(self) -> None:
        """Every rank's updated slices into the whole parameters, one
        all-gather a bucket (into fresh storage where FSDP freed them)."""
        params = self.optimizer.params
        for b, mine in self._shards:
            if self.fsdp and params[b.idx[0]].data.numel():
                continue
            gathered = mine.new_empty(b.ranks * mine.numel())
            dist.all_gather_into_tensor(gathered, mine,
                                        group=self.mesh.data_group)
            if self.fsdp:
                sizes = [math.prod(sh) for sh in b.shapes]
                for i, piece, sh in zip(b.idx, mine.new_empty(
                        sum(sizes)).split(sizes), b.shapes):
                    params[i].data = piece.view(sh)
            b.copy_whole(gathered, [params[i].data for i in b.idx])

    # --------------------------------------------------------------- step
    def generator(self, step: int, micro: int = 0) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.seed_of(step, micro))

    def seed_of(self, step: int, micro: int = 0) -> int:
        words = [self.seed, step, micro]
        if self.mesh is not None and self.mesh.data_rank:
            words.append(self.mesh.data_rank)
        seed = np.random.SeedSequence(words)
        return int(seed.generate_state(1, np.uint64)[0] >> np.uint64(1))

    def _scope(self, step: int, micro: int):
        if self.mesh is None:
            return contextlib.nullcontext()
        from ..parallel.pipeline import pipeline_scope
        return pipeline_scope(self.mesh, self.pipeline_microbatches,
                              self.seed_of(step, micro))

    def _reduce_grads(self) -> list:
        """Each parameter's gradient as this rank's target takes it: summed
        over the model ranks where SP left it partial, averaged over the
        data ranks (reduce-scattered along the ZeRO dimension). One
        collective per bucket."""
        mesh = self.mesh
        params = self.optimizer.params
        grads = {i: params[i].grad if params[i].grad is not None
                 else torch.zeros_like(params[i])
                 for b in self._grad_buckets for i in b.idx}
        for b in self._sp_buckets:
            flat = b.pack([grads[i] for i in b.idx])
            dist.all_reduce(flat, group=mesh.model_group)
            grads.update(zip(b.idx, b.views(flat)))
        out = [None] * len(params)
        for b in self._grad_buckets:
            flat = b.pack([grads[i] for i in b.idx])
            if b.sharded:
                mine = flat.new_empty(flat.numel() // b.ranks)
                dist.reduce_scatter_tensor(mine, flat,
                                           group=mesh.data_group)
                flat = mine
            else:
                dist.all_reduce(flat, group=mesh.data_group)
            flat.div_(mesh.data_size)
            for i, v in zip(b.idx, b.views(flat)):
                out[i] = v
        return out

    def step(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, float]:
        """One optimizer step over `batch` (this rank's rows under a mesh),
        split into `grad_accum` micro batches (each array into equal shares
        of its rows) whose gradients, loss and metrics are averaged. Returns
        the metrics, the loss and the global norm of the unclipped
        gradients (averaged over the data ranks)."""
        self.model.train()
        self.unshard()
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        n = self.grad_accum
        sizes = {v.shape[0] for v in batch.values()}
        if any(size % n for size in sizes):
            raise ValueError(f"batch sizes {sorted(sizes)} are not divisible "
                             f"by grad_accum {n}")
        loss_sum, metric_sums = 0.0, {}
        for i in range(n):
            # each array gives its own i-th share of rows: a batch may hold
            # sub-batches of different sizes (the pretraining extra stream)
            mb = batch if n == 1 else {
                k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                for k, v in batch.items()}
            gen = self.generator(self.step_count, i)
            kw = {"step": self.step_count, "global_batch": self.global_batch}
            with self._scope(self.step_count, i):
                loss, metrics = self.loss_fn(
                    self.model, mb, gen, **{k: kw[k] for k in self.loss_kw})
                loss.backward()
            loss_sum = loss_sum + loss.detach()
            for k, v in metrics.items():
                metric_sums[k] = metric_sums.get(k, 0.0) + v.detach()
        if n > 1:
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(1.0 / n)
            loss_sum = loss_sum * (1.0 / n)
            metric_sums = {k: v * (1.0 / n) for k, v in metric_sums.items()}
        if self.mesh is None:
            gnorm = global_norm(p.grad for p in params if p.grad is not None)
            self.optimizer.step()
        else:
            grads = self._reduce_grads()
            opt = self.optimizer
            live = [g for g in grads if g is not None]
            gnorm = opt.clip_norm(live, opt.active)
            opt.step(grads)
            for p in params:
                p.grad = None
            if self.fsdp:
                self.reshard()
            else:
                self._gather_whole()
            from ..parallel.collectives import all_reduce_metrics
            metric_sums = all_reduce_metrics(
                {**{k: torch.as_tensor(v) for k, v in metric_sums.items()},
                 "__loss": torch.as_tensor(loss_sum)},
                group=self.mesh.data_group, world=self.mesh.data_size)
            loss_sum = metric_sums.pop("__loss")
        self.step_count += 1
        out = {k: float(v) for k, v in metric_sums.items()}
        out.update(loss=float(loss_sum), grad_norm=float(gnorm))
        return out

    # -------------------------------------------------------- checkpoints
    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole model's state dict on every rank (collective under a
        mesh): FSDP shards gathered, TP shards gathered, each pipe stage's
        layers from their owner. Leaves the parameters as the step left
        them."""
        if self.mesh is None:
            return dict(self.model.state_dict())
        self.sync_stages()
        self.unshard()
        from ..parallel.mesh import tp_gather_state_dict
        sd = {k: v.detach().clone()
              for k, v in tp_gather_state_dict(self.model, self.mesh).items()}
        if self.fsdp:
            self.reshard()
        return sd

    def sync_stages(self) -> None:
        """Every pipe rank gets each stage's layers from their owner (for
        eval and checkpoints; a step updates only the owner's copy)."""
        if self.mesh is None:
            return
        from ..parallel.pipeline import stage_owners
        owners = stage_owners(self.model, self.mesh.pipe_size)
        if not owners:
            return
        named = dict(self.model.named_parameters())
        for name, owner in owners.items():
            dist.broadcast(named[name].data,
                           src=self.mesh.group_rank_to_global("pipe", owner),
                           group=self.mesh.pipe_group)

    def finish(self) -> None:
        """Leave the model whole on every rank (after training)."""
        if self.mesh is not None:
            self.sync_stages()
            self.unshard()

    def optimizer_state_tree(self) -> dict:
        """The optimizer's state as `training/sharded_checkpoint.py` writes
        it: the count, and each moment as this rank's piece of the global
        tensor (`ShardedLeaf`), written by one holder of each piece."""
        from ..parallel.mesh import AXES, PIPE_AXIS
        from .sharded_checkpoint import ShardedLeaf
        opt = self.optimizer
        if self.mesh is None:
            return opt.state_dict()
        coords = {ax: getattr(self.mesh, f"{ax}_rank") for ax in AXES}
        sizes = dict(self.mesh.shape)
        tree = {"count": np.asarray(opt.count, np.int64), "mu": {}, "nu": {}}
        for i in opt.active:
            lay = self.layouts[i]
            index = []
            for d, ax in zip(lay.global_shape, lay.spec):
                if ax:
                    part = d // sizes[ax]
                    index.append(slice(coords[ax] * part,
                                       (coords[ax] + 1) * part))
                else:
                    index.append(slice(0, d))
            # one holder writes each piece: coordinate 0 on every axis the
            # piece is replicated over (a stage's layer lives on its owner)
            writer = all(coords[ax] == 0 for ax in AXES
                         if ax not in lay.spec
                         and not (ax == PIPE_AXIS and lay.staged))
            for key, moments in (("mu", opt.mu), ("nu", opt.nu)):
                tree[key][lay.name] = ShardedLeaf(
                    moments[i], lay.global_shape, tuple(index), writer)
        return tree

    def load_optimizer_state(self, tree: dict) -> None:
        """Restore from a whole (consolidated) optimizer state, whatever
        topology wrote it: each target takes its piece."""
        from ..parallel.mesh import AXES, take_shard
        opt = self.optimizer
        if self.mesh is None:
            opt.load_state_dict(tree)
            return
        coords = {ax: getattr(self.mesh, f"{ax}_rank") for ax in AXES}
        sizes = dict(self.mesh.shape)
        local = {"count": int(np.asarray(tree["count"])), "mu": {}, "nu": {}}
        for i in opt.active:
            lay = self.layouts[i]
            for key in ("mu", "nu"):
                full = torch.as_tensor(np.asarray(tree[key][lay.name]))
                local[key][lay.name] = take_shard(full, lay.spec, coords,
                                                  sizes)
        opt.load_state_dict(local)
