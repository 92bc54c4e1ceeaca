"""Checkpoint inspection CLI: the JAX package's `tools/inspect_ckpt.py` over
this package's checkpoint formats.

    python -m mvp_pytorch_tpu_torch.tools.inspect_ckpt <dir> [--tree] [--json]

Prints what a checkpoint directory holds: its format (`pytorch_model.bin`,
`optimizer.pt`, the sharded optimizer state `opt_shards/` of
`training/sharded_checkpoint.py`, `train_meta.json`), the config summary,
the parameter count and dtype histogram of the weights and, with `--tree`,
every tensor with its shape. It reads host files only: the weights are
memory-mapped (`torch.load(..., mmap=True)`), so a large file is not read
whole, and no model is built. A JAX checkpoint's msgpack files are named in
`format` but not decoded (that needs flax).
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter
from typing import Any, Dict

import torch

from ..training.checkpoint import (ARGS_NAME, OPT_NAME, OPT_SHARDS_DIR,
                                   TRAIN_STATE_NAME, WEIGHTS_NAME)

CONFIG_KEYS = ("hidden_size", "num_hidden_layers", "num_attention_heads",
               "vocab_size", "img_feature_dim", "dtype")
# the JAX package's files, named but not decoded
MSGPACK_FILES = (
    ("params.msgpack", "params.msgpack (JAX; not decoded)"),
    ("train_state.msgpack", "train_state.msgpack (JAX params + opt; not "
                            "decoded)"),
    ("opt_state.msgpack", "opt_state.msgpack (JAX; not decoded)"))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def describe_dir(directory: str) -> Dict[str, Any]:
    """The report of `directory` as a dict (the JAX tool's keys; `_leaves`
    holds (name, shape, dtype) of every weight)."""
    out: Dict[str, Any] = {"dir": directory, "files": {}, "format": []}
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        if os.path.isfile(path):
            out["files"][name] = os.path.getsize(path)

    cfg_path = os.path.join(directory, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = json.load(f)
        out["config"] = {k: cfg[k] for k in CONFIG_KEYS if k in cfg}

    weights = None
    weights_path = os.path.join(directory, WEIGHTS_NAME)
    if os.path.exists(weights_path):
        out["format"].append(f"{WEIGHTS_NAME} (torch state dict)")
        weights = torch.load(weights_path, map_location="cpu",
                             weights_only=True, mmap=True)
    for name, label in MSGPACK_FILES:
        if os.path.exists(os.path.join(directory, name)):
            out["format"].append(label)
    if os.path.exists(os.path.join(directory, OPT_NAME)):
        out["format"].append(f"resumable ({OPT_NAME})")
    manifest_path = os.path.join(directory, OPT_SHARDS_DIR, "manifest.json")
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
        out["format"].append(f"sharded ({OPT_SHARDS_DIR}: per-rank npz + "
                             "manifest)")
        out["shards"] = {"world_size": manifest.get("world_size"),
                         "leaves": len(manifest.get("leaves", {}))}
    meta_path = os.path.join(directory, TRAIN_STATE_NAME)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        out["format"].append(f"{TRAIN_STATE_NAME} (step {meta.get('step')})")

    args_path = os.path.join(directory, ARGS_NAME)
    if os.path.exists(args_path):
        with open(args_path) as f:
            out["training_args_keys"] = sorted(json.load(f))

    if weights is not None:
        leaves = sorted(weights.items())
        out["n_params"] = int(sum(v.numel() for _, v in leaves))
        out["n_leaves"] = len(leaves)
        out["dtypes"] = dict(Counter(_dtype_name(v.dtype) for _, v in leaves))
        out["top_level"] = sorted({k.split(".")[0] for k, _ in leaves})
        out["_leaves"] = [(k, list(v.shape), _dtype_name(v.dtype))
                          for k, v in leaves]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("ckpt_dir")
    p.add_argument("--tree", action="store_true",
                   help="print every tensor's name with its shape and dtype")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    a = p.parse_args(argv)
    info = describe_dir(a.ckpt_dir)
    leaves = info.pop("_leaves", [])
    if a.json:
        if a.tree:
            info["leaves"] = leaves
        print(json.dumps(info, indent=2))
        return 0
    print(f"checkpoint: {info['dir']}")
    print(f"format:     {', '.join(info['format']) or 'NO WEIGHTS FOUND'}")
    if "config" in info:
        print(f"config:     {info['config']}")
    if "n_params" in info:
        print(f"params:     {info['n_params']:,} in {info['n_leaves']} "
              f"leaves, dtypes {info['dtypes']}")
        print(f"modules:    {', '.join(info['top_level'])}")
    if "shards" in info:
        print(f"shards:     {info['shards']}")
    if "training_args_keys" in info:
        print(f"args snapshot: {len(info['training_args_keys'])} keys")
    for name, size in info["files"].items():
        print(f"  {name:30s} {size:>12,} bytes")
    if a.tree:
        for path, shape, dtype in leaves:
            print(f"  {path:60s} {str(shape):18s} {dtype}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
