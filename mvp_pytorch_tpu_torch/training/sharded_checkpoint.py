"""Sharded checkpoints that any topology restores: the JAX package's
`training/sharded_checkpoint.py` format, written and read with numpy and
torch.distributed (the reference's DeepSpeed per-rank ZeRO shards +
zero_to_fp32, `oscar/run_pretrain_ml.py:35,749-753`).

One directory per tree:
- `shard-{rank:05d}.npz`: this rank's pieces, keyed
  `"{leaf_path}|{o0}:{e0},{o1}:{e1},..."` by the global index ranges of the
  piece (an empty suffix for a whole leaf). A `ShardedLeaf` is written by
  the rank its `write` flag names (one holder of each piece); any other
  leaf is a value every rank holds alike, written whole by rank 0.
- `manifest.json` from rank 0: each leaf's global shape and dtype, the
  writer's world size, and the empty dict nodes.
bf16 is stored as its uint16 bits, its dtype kept in the manifest
(`_npz_safe` / `_from_saved`, JAX `:97-115`); `consolidate` returns a bf16
leaf as a torch tensor (numpy has no bf16), every other leaf as numpy.

Restore reads exactly the manifest's world size of shard files: stale files
from an older save with another world size are ignored (and removed by the
next save's rank 0); a missing file, or a leaf its pieces do not cover, is
a hard error. `consolidate` gives whole leaves whatever wrote them, the
JAX package included; the Trainer cuts them to its own layout
(`Trainer.load_optimizer_state`).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

MANIFEST = "manifest.json"


class ShardedLeaf(NamedTuple):
    data: Any                 # this rank's piece (tensor or numpy)
    shape: Tuple[int, ...]    # the global shape
    index: Tuple[slice, ...]  # the piece's place in it
    write: bool               # this rank writes the piece


def _rank_world() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _flatten(tree: Any):
    """Nested dicts -> ({'/'-joined path: leaf}, [empty dict paths])."""
    out: Dict[str, Any] = {}
    empties: list = []

    def rec(prefix, node):
        if isinstance(node, dict):
            if not node:
                empties.append(prefix)
                return
            for k, v in node.items():
                rec(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            out[prefix] = node

    rec("", tree)
    return out, empties


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


def _slices_key(index, shape) -> str:
    parts = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        parts.append(f"{start}:{stop}")
    return ",".join(parts)


def _parse_slices(key: str):
    if not key:
        return ()
    return tuple(slice(int(a), int(b))
                 for a, b in (p.split(":") for p in key.split(",")))


def _to_numpy(x) -> Tuple[np.ndarray, str]:
    """(npz-safe array, the dtype the manifest names)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.kind == "V":           # an ml_dtypes extension type
        return x.view(f"u{x.dtype.itemsize}"), str(x.dtype)
    return x, str(x.dtype)


def _from_saved(arr: np.ndarray, dtype: str):
    """Undo the npz-safe storage: bf16 bits back to a bf16 tensor; a plain
    dtype mismatch casts."""
    if dtype == "bfloat16":
        if arr.dtype.kind in ("u", "i", "V") and arr.dtype.itemsize == 2:
            return torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.asarray(arr, np.float32)).to(
            torch.bfloat16)
    dt = np.dtype(dtype)
    return arr if arr.dtype == dt else arr.astype(dt, copy=False)


def save_sharded(directory: str, tree: Any) -> None:
    """Collective save: every rank writes its pieces, rank 0 the manifest;
    every rank must call it. Returns once the directory is complete."""
    os.makedirs(directory, exist_ok=True)
    rank, world = _rank_world()
    flat, empties = _flatten(tree)
    arrays: Dict[str, np.ndarray] = {}
    manifest = {"world_size": world, "leaves": {}, "empty_nodes": empties}
    for path, leaf in flat.items():
        if isinstance(leaf, ShardedLeaf):
            arr, dt = _to_numpy(leaf.data)
            manifest["leaves"][path] = {"shape": list(leaf.shape),
                                        "dtype": dt}
            if leaf.write:
                arrays[f"{path}|{_slices_key(leaf.index, leaf.shape)}"] = arr
        else:
            arr, dt = _to_numpy(leaf)
            manifest["leaves"][path] = {"shape": list(arr.shape), "dtype": dt}
            if rank == 0:
                arrays[f"{path}|"] = arr
    tmp = os.path.join(directory, f".shard-{rank:05d}.npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, os.path.join(directory, f"shard-{rank:05d}.npz"))
    if rank == 0:
        for fname in os.listdir(directory):
            if fname.startswith("shard-") and fname.endswith(".npz"):
                try:
                    if int(fname[len("shard-"):-len(".npz")]) >= world:
                        os.remove(os.path.join(directory, fname))
                except ValueError:
                    pass
        mtmp = os.path.join(directory, ".manifest.tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(directory, MANIFEST))
    if world > 1:
        dist.barrier()


def _read_leaves(directory: str) -> Dict[str, Any]:
    with open(os.path.join(directory, MANIFEST)) as f:
        manifest = json.load(f)
    pieces: Dict[str, list] = {}
    world = int(manifest.get("world_size", 1))
    for rank in range(world):
        fpath = os.path.join(directory, f"shard-{rank:05d}.npz")
        if not os.path.exists(fpath):
            raise FileNotFoundError(
                f"sharded checkpoint {directory}: shard file for rank {rank} "
                f"of {world} is missing (partial copy?)")
        with np.load(fpath) as z:
            for key in z.files:
                path, _, idx = key.rpartition("|")
                pieces.setdefault(path, []).append((idx, z[key]))
    leaves: Dict[str, Any] = {}
    for path, info in manifest["leaves"].items():
        shape = tuple(info["shape"])
        got = pieces.get(path)
        if not got:
            raise FileNotFoundError(
                f"sharded checkpoint {directory}: no data for leaf {path}")
        if len(got) == 1 and _parse_slices(got[0][0]) in ((), None) \
                and got[0][1].shape == shape:
            leaves[path] = _from_saved(got[0][1], info["dtype"])
            continue
        full = np.empty(shape, got[0][1].dtype)
        covered = 0
        for idx, arr in got:
            full[_parse_slices(idx)] = arr
            covered += arr.size
        total = int(np.prod(shape, dtype=np.int64))
        if covered != total:
            raise ValueError(
                f"sharded checkpoint {directory}: leaf {path} covered "
                f"{covered}/{total} elements - incomplete or inconsistent "
                "shard set")
        leaves[path] = _from_saved(full, info["dtype"])
    return leaves, manifest


def consolidate(directory: str) -> Dict[str, Any]:
    """Shard directory -> the whole tree as nested dicts (the zero-to-fp32
    role), empty dict nodes kept."""
    leaves, manifest = _read_leaves(directory)
    state = _unflatten(leaves)
    for path in manifest.get("empty_nodes", []):
        node = state
        parts = path.split("/") if path else []
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts:
            node.setdefault(parts[-1], {})
    return state


__all__ = ["MANIFEST", "ShardedLeaf", "save_sharded", "consolidate"]
