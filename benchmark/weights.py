"""Seeded weights on the device, in a few large calls.

Every parameter named by a reference `param_spec` is drawn from one
`torch.Generator` on the device: all "normal" kernels and tables from one
flat normal(0, initializer_range) buffer, the two global projections from
normal(0, hidden^-1/2), LayerNorm scales 1, biases 0 and the contrastive
logit scale log(1 / 0.07). Both the program and the reference are given
these tensors; the program copies them into its own parameters."""

from __future__ import annotations

import math
from typing import Dict

import torch


def make(spec, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for kind, std in (("normal", cfg["initializer_range"]),
                      ("proj", cfg["hidden_size"] ** -0.5)):
        items = [(n, s) for n, s, k in spec if k == kind]
        flat = torch.empty(sum(math.prod(s) for _, s in items),
                           device=device).normal_(0.0, std, generator=g)
        for (name, shape), piece in zip(
                items, flat.split([math.prod(s) for _, s in items])):
            out[name] = piece.view(shape)
    for name, shape, kind in spec:
        if kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "logit_scale":
            out[name] = torch.full(shape, math.log(1.0 / 0.07),
                                   device=device)
        elif kind not in ("normal", "proj"):
            raise ValueError(f"{name}: init {kind!r}")
    return {name: out[name] for name, _, _ in spec}
