"""Step checkpoints, the JAX package's `training/checkpoint.py`
`CheckpointManager` with torch files in place of msgpack.

A checkpoint is the directory `checkpoint-{step:07d}` under the output
directory, holding
- `pytorch_model.bin`: the model's state dict under the reference's torch
  keys (the JAX package's `convert.load_torch_state_dict` reads it);
- `config.json`: the model config, in the JAX package's format;
- `optimizer.pt`: the optimizer's state (moments and step count, which is
  also the schedule's position);
- `train_meta.json`: the step;
- `training_args.json`, when the caller gives its arguments: the command
  line's settings, which an eval-only run restores
  (`tasks/common.py` `restore_training_settings`).

A checkpoint saved under a mesh holds `opt_shards/` (each rank's pieces of
the optimizer state, `training/sharded_checkpoint.py`) in place of
`optimizer.pt`; `training/consolidate.py` turns it into `optimizer.pt`.

The output directory's `last_checkpoint` file names the newest one; older
ones beyond `keep` are removed. Every file is written to a temporary name and
renamed, with a few retries on OS errors.

A save is a host snapshot (`CheckpointManager.snapshot`: copies of the
weights and of the optimizer's moments on the CPU, taken before the next
step can change them) and its write (`write`: `torch.save` and the
renames). `AsyncSaver` runs the writes on a background thread, one at a
time (`--async_ckpt`); a save under a mesh stays synchronous.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Optional, Tuple

import torch

WEIGHTS_NAME = "pytorch_model.bin"
OPT_NAME = "optimizer.pt"
OPT_SHARDS_DIR = "opt_shards"
LAST_CHECKPOINT = "last_checkpoint"
TRAIN_STATE_NAME = "train_meta.json"
ARGS_NAME = "training_args.json"


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
    """A copy of the tensors of `tree` on the CPU: a true copy also of a
    tensor already there (`.cpu()` would return its storage, which the next
    step changes in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _on_cpu(v) for k, v in tree.items()}
    return tree


class AsyncSaver:
    """Checkpoint writes on a background thread (the JAX package's
    `training/checkpoint.py` `AsyncSaver`).

    The caller takes the host snapshot synchronously
    (`CheckpointManager.snapshot`); `submit(fn)` runs its write `fn()` on
    the writer thread while training goes on. At most one write is in
    flight: `submit` first joins the previous one, so checkpoints land in
    order and memory holds at most one extra snapshot. A write's error is
    re-raised at the next `submit` or `wait`; call `wait` before exiting.
    One process only: a save under a mesh is collective and stays
    synchronous."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, fn: Callable[[], Any]) -> None:
        """Run `fn()` on the writer thread once the previous write ended."""
        self._join()

        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - re-raised on join
                self._err = e

        self._thread = threading.Thread(target=run, name="ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the write in flight (if any) ends; re-raise its
        error."""
        self._join()


class CheckpointManager:
    """Step checkpoints + `last_checkpoint` pointer + resume."""

    def __init__(self, output_dir: str, keep: int = 3):
        self.output_dir = output_dir
        self.keep = keep
        os.makedirs(output_dir, exist_ok=True)

    def _ckpt_dir(self, step: int) -> str:
        return os.path.join(self.output_dir, f"checkpoint-{step:07d}")

    def save(self, step: int, model: torch.nn.Module, optimizer=None,
             config=None, args: Optional[dict] = None, *,
             weights: Optional[dict] = None, sharded_optimizer=None,
             main: bool = True, saver: Optional[AsyncSaver] = None) -> str:
        """Write checkpoint `step` (its write on `saver`'s thread when one
        is given, after the snapshot). Under a mesh every rank calls it with
        the whole `weights` and its `sharded_optimizer` pieces; only `main`
        writes anything but its pieces, and synchronously."""
        if sharded_optimizer is not None:
            d = self._ckpt_dir(step)
            os.makedirs(d, exist_ok=True)
            from .sharded_checkpoint import save_sharded
            save_sharded(os.path.join(d, OPT_SHARDS_DIR), sharded_optimizer)
            if not main:
                return d
            return self.write(self.snapshot(step, model, None, config, args,
                                            weights=weights))
        snap = self.snapshot(step, model, optimizer, config, args,
                             weights=weights)
        if saver is None:
            return self.write(snap)
        saver.submit(lambda: self.write(snap))
        return self._ckpt_dir(step)

    def snapshot(self, step: int, model: torch.nn.Module, optimizer=None,
                 config=None, args: Optional[dict] = None, *,
                 weights: Optional[dict] = None) -> dict:
        """What `write` writes, on the host: copies of the weights (the
        model's, or `weights`) and of the optimizer's state (from its
        `state_dict`, so the moments as the last step left them)."""
        return {"step": step, "config": config,
                "weights": _on_cpu(dict(model.state_dict() if weights is None
                                        else weights)),
                "optimizer": (None if optimizer is None
                              else _on_cpu(optimizer.state_dict())),
                "args": (None if args is None else json.dumps(
                    args, indent=2, sort_keys=True, default=str))}

    def write(self, snap: dict) -> str:
        """Write a `snapshot` as checkpoint `snap["step"]`, point
        `last_checkpoint` at it and drop the oldest beyond `keep`."""
        d = self._ckpt_dir(snap["step"])
        os.makedirs(d, exist_ok=True)
        if snap["config"] is not None:
            _retry(lambda: snap["config"].save_pretrained(d))
        _retry(lambda: _atomic_save(snap["weights"],
                                    os.path.join(d, WEIGHTS_NAME)))
        if snap["optimizer"] is not None:
            _retry(lambda: _atomic_save(snap["optimizer"],
                                        os.path.join(d, OPT_NAME)))
        _retry(lambda: _atomic_write_text(
            os.path.join(d, TRAIN_STATE_NAME),
            json.dumps({"step": snap["step"]})))
        if snap["args"] is not None:
            _retry(lambda: _atomic_write_text(os.path.join(d, ARGS_NAME),
                                              snap["args"]))
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

    def read_optimizer(self, directory: str):
        """The whole optimizer state of a checkpoint (`optimizer.pt`, or its
        consolidated `opt_shards/`), or None."""
        opt_path = os.path.join(directory, OPT_NAME)
        if os.path.exists(opt_path):
            return torch.load(opt_path, map_location="cpu",
                              weights_only=True)
        shards = os.path.join(directory, OPT_SHARDS_DIR)
        if os.path.isdir(shards):
            from .sharded_checkpoint import consolidate
            return consolidate(shards)
        return None

    def restore(self, directory: str, model: torch.nn.Module,
                optimizer=None, mesh=None) -> dict:
        """Load the weights (strictly; each tensor-parallel parameter takes
        its shard under `mesh`) and, if given, the optimizer state; returns
        `train_meta.json`."""
        device = next(model.parameters()).device
        weights = torch.load(os.path.join(directory, WEIGHTS_NAME),
                             map_location=device, weights_only=True)
        if mesh is not None and getattr(model, "tp_specs", None):
            from ..parallel.mesh import tp_load_state_dict
            tp_load_state_dict(model, weights, mesh)
        else:
            model.load_state_dict(weights, strict=True)
        if optimizer is not None:
            state = self.read_optimizer(directory)
            if state is not None:
                optimizer.load_state_dict(state)
        meta_path = os.path.join(directory, TRAIN_STATE_NAME)
        if not os.path.exists(meta_path):
            return {}
        with open(meta_path) as f:
            return json.load(f)
