"""Megatron sequence parallelism: the JAX package's
`parallel/activation_sharding.py` by hand.

Plain TP leaves the LayerNorm, dropout and residual regions of each layer
whole on every model rank, and each row-parallel matmul ends in an
all-reduce. Sequence parallelism cuts those regions along the sequence over
the model ranks instead: a row-parallel output reduce-scatters along L
(`exit_region`), a column-parallel input all-gathers along L
(`enter_region`); the bytes are those of the all-reduce, the elementwise
work and activations drop by the TP degree.

L need not divide the model ranks: the real stream lengths 75 and 145 are
odd. A region pads L up to a multiple (`padded_len`) and each rank holds
`padded_len / tp` positions; the padding never reaches the attention, which
`enter_region` trims back to L. `StreamEncoder` opens the region
(`sequence_region`) around its layers, with the length, and leaves it with
the whole sequence.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from .collectives import (copy_to_region, gather_replicated, gather_rows,
                          reduce_from_region, reduce_scatter,
                          split_replicated)

_ctx = threading.local()


class SequenceRegion:
    def __init__(self, group, size: int, length: int):
        self.group = group
        self.size = size
        self.length = length
        self.padded = -(-length // size) * size

    @property
    def chunk(self) -> int:
        return self.padded // self.size


def current_region() -> Optional[SequenceRegion]:
    return getattr(_ctx, "region", None)


@contextlib.contextmanager
def sequence_region(group, size: int, length: int):
    prev = current_region()
    _ctx.region = SequenceRegion(group, size, length)
    try:
        yield _ctx.region
    finally:
        _ctx.region = prev


def _pad_seq(x: torch.Tensor, padded: int) -> torch.Tensor:
    extra = padded - x.shape[1]
    if extra == 0:
        return x
    return F.pad(x, (0, 0, 0, extra))


def shard_seq(x: torch.Tensor, region: SequenceRegion) -> torch.Tensor:
    """A whole [B, L, H] activation -> this rank's [B, L'/tp, H] positions
    (entering the region from replicated code)."""
    return split_replicated(_pad_seq(x, region.padded), region.group, dim=1)


def unshard_seq(x: torch.Tensor, region: SequenceRegion) -> torch.Tensor:
    """This rank's positions -> the whole [B, L, H] (leaving the region for
    replicated code)."""
    return gather_replicated(x, region.group, dim=1)[:, :region.length]


def enter_region(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel matmul: the whole sequence (all-gather
    along L under SP; Megatron's f otherwise)."""
    region = current_region()
    if region is None:
        return copy_to_region(x, group)
    return gather_rows(x, region.group, dim=1)[:, :region.length]


def exit_region(y: torch.Tensor, group) -> torch.Tensor:
    """The partial output of a row-parallel matmul: summed over the model
    ranks (reduce-scatter along L under SP; all-reduce otherwise)."""
    region = current_region()
    if region is None:
        return reduce_from_region(y, group)
    return reduce_scatter(_pad_seq(y, region.padded), region.group, dim=1)


def chunk_of(full: torch.Tensor, region: SequenceRegion) -> torch.Tensor:
    """This rank's positions of a whole-sequence tensor that carries no
    gradient (a dropout mask drawn for the whole sequence)."""
    full = _pad_seq(full, region.padded)
    rank = torch.distributed.get_rank(region.group)
    return full[:, rank * region.chunk:(rank + 1) * region.chunk]


__all__ = ["SequenceRegion", "sequence_region", "current_region",
           "shard_seq", "unshard_seq", "enter_region", "exit_region",
           "chunk_of"]
