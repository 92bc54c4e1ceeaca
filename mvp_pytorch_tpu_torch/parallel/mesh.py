"""The (data, model, pipe) mesh, batch sharding and the placement rules:
the JAX package's `parallel/mesh.py` on `torch.distributed`.

- `make_mesh` builds a `DeviceMesh` with `data`, `model` and `pipe`
  dimensions over the process group (`pipe` last, as in the JAX mesh, so
  that neighbouring stages are neighbouring ranks), and registers it as the
  driver's mesh (`default_mesh`), which eval sharding reads.
- `data_shard_info` / `shard_batch`: each data rank takes its own rows of
  the global batch, so the global batch is the one-process batch row for
  row; the model and pipe ranks of one data coordinate take the same rows.
  The loader's `BatchSampler(rank=, world_size=)` shards the same way.
- `EvalSharder`: an eval batch's rows over the data ranks, and the rank
  order gather of the outputs.
- `tp_param_pspec`: the Megatron placement over the port's state-dict
  names (column-parallel `query`, `key`, `value` and `intermediate.dense`;
  row-parallel `attention.output.dense` and `output.dense`; MoE `wi` / `wo`
  over their expert dimension; everything else replicated), as a tuple of
  axis names or None per dimension of the torch tensor.
  `apply_tensor_parallel` cuts a model's parameters to this rank's shards.
- `zero_state_spec` / `compose_data_spec` / `fit_spec`: the ZeRO-2 and FSDP
  partition rule (`data` on one dimension of a state or parameter).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
AXES = (DATA_AXIS, MODEL_AXIS, PIPE_AXIS)

Spec = Tuple[Optional[str], ...]


class Mesh:
    """A (data, model, pipe) `DeviceMesh` with each dimension's group, size
    and this process's coordinate on it."""

    def __init__(self, data: int, model: int, pipe: int, device):
        from torch.distributed.device_mesh import init_device_mesh
        self.device = torch.device(device)
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model, PIPE_AXIS: pipe}
        self.device_mesh = init_device_mesh(
            self.device.type, (data, model, pipe), mesh_dim_names=AXES)
        for ax in AXES:
            setattr(self, f"{ax}_group", self.device_mesh.get_group(ax))
            setattr(self, f"{ax}_rank", self.device_mesh.get_local_rank(ax))
            setattr(self, f"{ax}_size", self.shape[ax])
        self.world = data * model * pipe

    def group_rank_to_global(self, axis: str, group_rank: int) -> int:
        """The global rank of `group_rank` on `axis`'s group of this rank."""
        return dist.get_global_rank(getattr(self, f"{axis}_group"),
                                    group_rank)

    def __repr__(self):
        return (f"Mesh(data={self.data_size}, model={self.model_size}, "
                f"pipe={self.pipe_size}, device={self.device})")


_DEFAULT: Dict[str, Optional[Mesh]] = {"mesh": None}


def make_mesh(data: Optional[int] = None, model: int = 1, pipe: int = 1,
              device=None, register: bool = True) -> Mesh:
    """A (data, model, pipe) mesh over every rank of the process group
    (`data` defaults to what is left); joins no group itself
    (`distributed.initialize` does). `register` makes it the driver's
    mesh."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize(need_group=True)")
    n = dist.get_world_size()
    if data is None:
        if n % (model * pipe):
            raise ValueError(f"{n} ranks not divisible by model={model} x "
                             f"pipe={pipe}")
        data = n // (model * pipe)
    if data * model * pipe != n:
        raise ValueError(f"mesh {data}x{model}x{pipe} != world {n}")
    if device is None:
        device = (f"cuda:{torch.cuda.current_device()}"
                  if dist.get_backend() == "nccl" else "cpu")
    mesh = Mesh(data, model, pipe, device)
    if register:
        _DEFAULT["mesh"] = mesh
    return mesh


def default_mesh() -> Optional[Mesh]:
    return _DEFAULT["mesh"]


def data_shard_info(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(data_rank, data_world): how training-batch rows shard over the
    ranks. Model and pipe ranks of one data coordinate load the same
    rows."""
    if mesh is None:
        return 0, 1
    return mesh.data_rank, mesh.data_size


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_batch(mesh: Optional[Mesh], batch):
    """This rank's rows of a global batch (a dict of arrays or tensors,
    nested dicts allowed): rows [r * b, (r + 1) * b) with b = B / data."""
    r, n = data_shard_info(mesh)
    if n == 1:
        return batch

    def rows(x):
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows over {n} data "
                             f"ranks")
        b = x.shape[0] // n
        return x[r * b:(r + 1) * b]
    return _map(rows, batch)


class EvalSharder:
    """Row-shard eval batches over the data ranks (the JAX `EvalSharder`'s
    role: the reference's eval DataParallel). `put_batch` gives this rank
    its rows of a batch whose size divides the data ranks (else the whole
    batch), `gather` concatenates the outputs in rank order. Inactive on one
    data rank, and under model or pipe ranks (they run one model together,
    so they must see the same rows)."""

    def __init__(self, batch_size: int, mesh: Optional[Mesh] = None):
        mesh = mesh if mesh is not None else default_mesh()
        self.mesh = mesh
        self.active = (mesh is not None and mesh.data_size > 1
                       and batch_size % mesh.data_size == 0)

    def put_batch(self, tree, device=None):
        def put(x):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.asarray(x))
            return x if device is None else x.to(device)
        tree = _map(put, tree)
        return shard_batch(self.mesh, tree) if self.active else tree

    def gather(self, out: torch.Tensor) -> torch.Tensor:
        if not self.active:
            return out
        from .collectives import gather_nograd
        return gather_nograd(out, self.mesh.data_group)


# ---------------------------------------------------------------------------
# placement rules
# ---------------------------------------------------------------------------

_COLUMN = ("query", "key", "value")


def tp_param_pspec(name: str, shape: Sequence[int], ntp: int) -> Spec:
    """Megatron placement of the port parameter `name` (a state-dict key)
    of torch shape `shape` over `ntp` model ranks. Torch weights are
    [out, in]: a column-parallel weight splits dim 0 (and its bias), a
    row-parallel one dim 1 (its bias stays whole, added after the sum)."""
    shape = tuple(shape)
    rep = (None,) * len(shape)
    if ntp <= 1 or not shape:
        return rep
    parts = name.split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    grand = parts[-3] if len(parts) > 2 else ""
    if parent == "moe" and leaf in ("wi", "wo") and len(shape) == 3 \
            and shape[0] % ntp == 0:
        return (MODEL_AXIS, None, None)
    col = parent in _COLUMN or (parent == "dense" and grand == "intermediate")
    row = parent == "dense" and grand == "output"
    if leaf == "weight" and len(shape) == 2:
        if col and shape[0] % ntp == 0:
            return (MODEL_AXIS, None)
        if row and shape[1] % ntp == 0:
            return (None, MODEL_AXIS)
    if leaf == "bias" and len(shape) == 1 and col and shape[0] % ntp == 0:
        return (MODEL_AXIS,)
    return rep


def fit_spec(spec: Spec, shape: Sequence[int], sizes: Dict[str, int]) -> Spec:
    """`spec` cut or padded to the rank of `shape`, with any axis whose size
    does not divide its dimension dropped."""
    lst = (list(spec) + [None] * len(shape))[:len(shape)]
    for i, ax in enumerate(lst):
        if isinstance(ax, str) and shape[i] % sizes[ax]:
            lst[i] = None
    return tuple(lst)


def compose_data_spec(spec: Spec, shape: Sequence[int],
                      sizes: Dict[str, int]) -> Spec:
    """`data` on the first dimension still whole whose extent per existing
    shard divides the data ranks (ZeRO on a TP layout, and FSDP); `spec`
    unchanged when none does. `shape` is the global shape."""
    ndata = sizes[DATA_AXIS]
    lst = list(fit_spec(spec, shape, sizes))
    if DATA_AXIS in lst:
        return tuple(lst)
    for i, dim in enumerate(shape):
        if lst[i] is None and dim % ndata == 0 and dim >= ndata:
            lst[i] = DATA_AXIS
            break
    return tuple(lst)


def zero_state_spec(shape: Sequence[int], ndata: int) -> Spec:
    """ZeRO-2 partition of a replicated parameter's optimizer state: `data`
    on the largest dimension that divides the data ranks, else
    replicated."""
    shape = tuple(shape)
    if not shape:
        return ()
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % ndata == 0 and shape[i] >= ndata:
            spec = [None] * len(shape)
            spec[i] = DATA_AXIS
            return tuple(spec)
    return (None,) * len(shape)


def take_shard(t: torch.Tensor, spec: Spec, coords: Dict[str, int],
               sizes: Dict[str, int]) -> torch.Tensor:
    """This rank's block of the whole tensor `t` under `spec`."""
    for dim, ax in enumerate(spec):
        if ax:
            part = t.shape[dim] // sizes[ax]
            t = t.narrow(dim, coords[ax] * part, part)
    return t


# ---------------------------------------------------------------------------
# tensor parallelism over the model ranks
# ---------------------------------------------------------------------------

def tp_specs(model: nn.Module, ntp: int) -> Dict[str, Spec]:
    """Each parameter's `tp_param_pspec`, by state-dict name (of a whole,
    unsliced model)."""
    return {n: tp_param_pspec(n, p.shape, ntp)
            for n, p in model.named_parameters()}


def apply_tensor_parallel(model: nn.Module, mesh: Mesh,
                          sequence_parallel: bool = False) -> nn.Module:
    """Cut `model`'s parameters to this model rank's shards (in place) and
    mark the layers that run over the model ranks: every column- or
    row-parallel `Dense`, `SelfAttention` (H / tp heads a rank), `MoEMLP`
    (E / tp experts a rank) and `StreamEncoder` (the sequence-parallel
    regions, with `sequence_parallel`). Builds nothing on one model rank
    unless `sequence_parallel` asks for it (it is a pure layout there)."""
    from ..models.layers import Dense, SelfAttention, StreamEncoder
    from ..ops.moe import MoEMLP
    ntp = mesh.model_size
    coords = {MODEL_AXIS: mesh.model_rank}
    sizes = {MODEL_AXIS: ntp}
    specs = tp_specs(model, ntp)
    model.tp_full_shapes = {n: tuple(p.shape)
                            for n, p in model.named_parameters()}
    model.tp_specs = specs
    for name, spec in specs.items():
        if MODEL_AXIS not in spec:
            continue
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        old = getattr(mod, leaf)
        new = nn.Parameter(take_shard(old.detach(), spec, coords,
                                      sizes).clone(),
                           requires_grad=old.requires_grad)
        setattr(mod, leaf, new)
    for name, mod in model.named_modules():
        if isinstance(mod, Dense):
            spec = specs.get(f"{name}.weight", ())
            mod.tp_mode = ("col" if spec[:1] == (MODEL_AXIS,) else
                           "row" if spec[1:2] == (MODEL_AXIS,) else None)
            mod.tp_mesh = mesh if mod.tp_mode else None
        elif isinstance(mod, (SelfAttention, MoEMLP)):
            mod.tp_mesh = mesh
        elif isinstance(mod, StreamEncoder):
            mod.tp_mesh = mesh
            mod.sequence_parallel = sequence_parallel
    for name, mod in model.named_modules():
        if isinstance(mod, SelfAttention):
            h = mod.config.num_attention_heads
            if h % ntp:
                raise ValueError(f"{h} heads over {ntp} model ranks")
    return model


def tp_gather_state_dict(model: nn.Module, mesh: Mesh
                         ) -> Dict[str, torch.Tensor]:
    """The whole state dict of a model cut by `apply_tensor_parallel`
    (collective over the model ranks)."""
    from .collectives import gather_nograd
    sd = dict(model.state_dict())
    specs = getattr(model, "tp_specs", {})
    for name, spec in specs.items():
        if MODEL_AXIS in spec and name in sd:
            sd[name] = gather_nograd(sd[name], mesh.model_group,
                                     dim=spec.index(MODEL_AXIS))
    return sd


def tp_load_state_dict(model: nn.Module, state_dict, mesh: Mesh) -> None:
    """Load a whole state dict into a model cut by `apply_tensor_parallel`:
    each cut parameter takes its shard."""
    specs = getattr(model, "tp_specs", {})
    coords = {MODEL_AXIS: mesh.model_rank}
    sizes = {MODEL_AXIS: mesh.model_size}
    local = {}
    for k, v in state_dict.items():
        spec = specs.get(k)
        local[k] = (take_shard(v, spec, coords, sizes)
                    if spec is not None and MODEL_AXIS in spec else v)
    model.load_state_dict(local, strict=True)


__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "PIPE_AXIS", "Mesh", "make_mesh",
    "default_mesh", "data_shard_info", "shard_batch", "EvalSharder", "tp_param_pspec",
    "fit_spec", "compose_data_spec", "zero_state_spec", "take_shard",
    "apply_tensor_parallel", "tp_gather_state_dict", "tp_load_state_dict",
]
