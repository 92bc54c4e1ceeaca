"""Step checkpoints, the JAX package's `training/checkpoint.py`
`CheckpointManager` with torch files in place of msgpack.

A checkpoint is the directory `checkpoint-{step:07d}` under the output
directory, holding
- `pytorch_model.bin`: the model's state dict under the reference's torch
  keys (the JAX package's `convert.load_torch_state_dict` reads it);
- `config.json`: the model config, in the JAX package's format;
- `optimizer.pt`: the optimizer's state (moments and step count, which is
  also the schedule's position);
- `train_meta.json`: the step.

The output directory's `last_checkpoint` file names the newest one; older
ones beyond `keep` are removed. Every file is written to a temporary name and
renamed, with a few retries on OS errors.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Optional, Tuple

import torch

WEIGHTS_NAME = "pytorch_model.bin"
OPT_NAME = "optimizer.pt"
LAST_CHECKPOINT = "last_checkpoint"
TRAIN_STATE_NAME = "train_meta.json"


def _retry(fn, tries: int = 5, delay: float = 1.0):
    for i in range(tries):
        try:
            return fn()
        except OSError:
            if i == tries - 1:
                raise
            time.sleep(delay)


def _atomic_save(obj: Any, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _atomic_write_text(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _on_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _on_cpu(v) for k, v in tree.items()}
    return tree


class CheckpointManager:
    """Step checkpoints + `last_checkpoint` pointer + resume."""

    def __init__(self, output_dir: str, keep: int = 3):
        self.output_dir = output_dir
        self.keep = keep
        os.makedirs(output_dir, exist_ok=True)

    def _ckpt_dir(self, step: int) -> str:
        return os.path.join(self.output_dir, f"checkpoint-{step:07d}")

    def save(self, step: int, model: torch.nn.Module, optimizer=None,
             config=None) -> str:
        d = self._ckpt_dir(step)
        os.makedirs(d, exist_ok=True)
        if config is not None:
            _retry(lambda: config.save_pretrained(d))
        weights = _on_cpu(dict(model.state_dict()))
        _retry(lambda: _atomic_save(weights, os.path.join(d, WEIGHTS_NAME)))
        if optimizer is not None:
            opt = _on_cpu(optimizer.state_dict())
            _retry(lambda: _atomic_save(opt, os.path.join(d, OPT_NAME)))
        _retry(lambda: _atomic_write_text(
            os.path.join(d, TRAIN_STATE_NAME), json.dumps({"step": step})))
        _retry(lambda: _atomic_write_text(
            os.path.join(self.output_dir, LAST_CHECKPOINT),
            os.path.basename(d)))
        self._gc()
        return d

    def _gc(self) -> None:
        if self.keep <= 0:
            return
        ckpts = sorted(d for d in os.listdir(self.output_dir)
                       if d.startswith("checkpoint-"))
        for d in ckpts[:-self.keep]:
            shutil.rmtree(os.path.join(self.output_dir, d),
                          ignore_errors=True)

    def latest(self) -> Optional[Tuple[int, str]]:
        """(step, dir) of the last checkpoint, or None. A missing or corrupt
        pointer falls back to the newest checkpoint directory that holds
        weights."""
        pointer = os.path.join(self.output_dir, LAST_CHECKPOINT)
        if os.path.exists(pointer):
            with open(pointer) as f:
                name = f.read().strip()
            d = os.path.join(self.output_dir, name)
            try:
                step = int(name.split("-")[-1])
            except ValueError:
                step = None
            if (step is not None and name.startswith("checkpoint-")
                    and os.path.isdir(d)):
                return step, d
        best = None
        for name in os.listdir(self.output_dir):
            d = os.path.join(self.output_dir, name)
            if (not name.startswith("checkpoint-")
                    or not os.path.exists(os.path.join(d, WEIGHTS_NAME))):
                continue
            try:
                step = int(name.split("-")[-1])
            except ValueError:
                continue
            if best is None or step > best[0]:
                best = (step, d)
        return best

    def restore(self, directory: str, model: torch.nn.Module,
                optimizer=None) -> dict:
        """Load the weights (strictly) and, if given, the optimizer state;
        returns `train_meta.json`."""
        device = next(model.parameters()).device
        weights = torch.load(os.path.join(directory, WEIGHTS_NAME),
                             map_location=device, weights_only=True)
        model.load_state_dict(weights, strict=True)
        opt_path = os.path.join(directory, OPT_NAME)
        if optimizer is not None and os.path.exists(opt_path):
            optimizer.load_state_dict(torch.load(
                opt_path, map_location=device, weights_only=True))
        meta_path = os.path.join(directory, TRAIN_STATE_NAME)
        if not os.path.exists(meta_path):
            return {}
        with open(meta_path) as f:
            return json.load(f)
