"""Checkpoint consolidation: the reference's `zero_to_fp32.py` role
(DeepSpeed per-rank ZeRO shards -> one file; reference
`oscar/run_pretrain_ml.py:35`), the JAX package's
`training/consolidate.py`.

A checkpoint saved under a mesh holds its whole weights in
`pytorch_model.bin` and its optimizer state as a sharded directory,
`opt_shards/` (`training/sharded_checkpoint.py`). This writes that state as
the one-file `optimizer.pt` a one-process resume reads, after which the
checkpoint carries no trace of its writer's topology. It also reads a
directory the JAX package wrote (its moments come out as numpy leaves under
their flax paths).

    python -m mvp_pytorch_tpu_torch.training.consolidate <checkpoint_dir> [--rm]
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
import torch



def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return int(tree) if tree.ndim == 0 and tree.dtype.kind == "i" \
            else torch.from_numpy(np.array(tree, copy=True))
    return tree


def consolidate_checkpoint(ckpt_dir: str, remove_shards: bool = False) -> str:
    from . import sharded_checkpoint as sc
    from .checkpoint import OPT_NAME, OPT_SHARDS_DIR, _atomic_save
    shards = os.path.join(ckpt_dir, OPT_SHARDS_DIR)
    if not os.path.isdir(shards):
        raise FileNotFoundError(f"{shards}: no sharded optimizer state "
                                "(already consolidated?)")
    state = _as_torch(sc.consolidate(shards))
    out = os.path.join(ckpt_dir, OPT_NAME)
    _atomic_save(state, out)
    if remove_shards:
        shutil.rmtree(shards)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        description="consolidate a sharded checkpoint (zero_to_fp32 role)")
    p.add_argument("checkpoint_dir")
    p.add_argument("--rm", action="store_true",
                   help="remove opt_shards/ after writing optimizer.pt")
    args = p.parse_args(argv)
    print(consolidate_checkpoint(args.checkpoint_dir,
                                 remove_shards=args.rm))


if __name__ == "__main__":
    main()
