"""Mixture-of-Experts FFN with expert parallelism: the JAX package's
`ops/moe.py` as an `nn.Module`, with the same semantics:

- tokens go in GShard groups of `moe_group_size` (the last group padded),
  each with a static capacity C = ceil(top_k * S / E * capacity_factor);
- the router is an fp32 [H -> E] matmul and softmax; the top-k gates are
  renormalised to sum to 1 (so identical experts reduce to the dense FFN);
- choices take capacity in priority order, all first choices before any
  second choice; a choice over capacity, and a padding token, gets a combine
  weight of 0 (the residual path carries it);
- the load-balance aux is E * sum_e(frac_dispatched_e * mean_prob_e) over
  the real tokens, 1 at perfect balance. The JAX package sows it into
  `intermediates`, which keep it only where the caller made them mutable;
  here `collect_aux(model)` is that caller's scope: inside it each training
  forward records its aux into the list the scope yields, and
  `moe_aux_loss(values)` takes sum(aux - 1) over them. Outside it a layer
  keeps nothing, so a fine-tuning step and a remat recompute (which runs in
  the backward, after the scope has closed) record nothing.

Expert weights are stacked `wi` [E, H, F] and `wo` [E, F, H] (the flax
layout, not transposed), the router `router.weight` [E, H].

Expert parallelism (`tp_mesh` set by `parallel.mesh.apply_tensor_parallel`,
E / tp experts a model rank): the routing and the dispatch / combine
tensors are computed whole on every model rank (they are small); each rank
takes an equal share of the token groups, sends each expert's slice of its
dispatched tokens to that expert's rank with `all_to_all_single`, runs its
own experts on what it receives from every rank, sends the outputs back the
same way and all-gathers the groups. The einsums, the matmuls and the
collectives are PyTorch and torch.distributed (the JAX package's ran in
XLA, outside any Pallas kernel).
"""

from __future__ import annotations

import contextlib
import math
from typing import List

import torch
import torch.nn.functional as F
from torch import nn


class MoEMLP(nn.Module):
    """Drop-in for a layer's dense FFN: [B, L, H] -> [B, L, H]."""

    def __init__(self, config):
        super().__init__()
        e, h, f = (config.moe_experts, config.hidden_size,
                   config.intermediate_size)
        self.config = config
        self.wi = nn.Parameter(torch.empty(e, h, f))
        self.wo = nn.Parameter(torch.empty(e, f, h))
        self.router = nn.Linear(h, e, bias=False)
        self.tp_mesh = None
        self.aux_sink = None        # the open `collect_aux` list, if any
        self.stats = {}

    @torch.no_grad()
    def init_weights(self, std: float, generator: torch.Generator) -> None:
        self.wi.normal_(0.0, std, generator=generator)
        self.wo.normal_(0.0, std, generator=generator)

    def _ep(self):
        mesh = self.tp_mesh
        return mesh if mesh is not None and mesh.model_size > 1 else None

    def experts(self, xe: torch.Tensor) -> torch.Tensor:
        """[G, E, C, H] dispatched tokens -> [G, E, C, H] expert outputs."""
        from ..models.layers import ACT2FN
        act = ACT2FN[self.config.hidden_act]
        dt = xe.dtype
        mesh = self._ep()
        if mesh is None:
            he = act(torch.einsum("gech,ehf->gecf", xe, self.wi.to(dt)))
            return torch.einsum("gecf,efh->gech", he, self.wo.to(dt))
        from ..parallel.collectives import (all_to_all, gather_replicated,
                                            split_replicated)
        n, grp = mesh.model_size, mesh.model_group
        g, e, c, h = xe.shape
        el = e // n
        pad = (-g) % n
        if pad:
            xe = torch.cat([xe, xe.new_zeros(pad, e, c, h)])
        mine = split_replicated(xe, grp, dim=0)            # [Gc, E, C, H]
        gc = mine.shape[0]
        # dim 0 = destination rank (the owner of each expert slice)
        send = mine.reshape(gc, n, el, c, h).transpose(0, 1)
        recv = all_to_all(send.reshape(n * gc, el, c, h), grp)
        he = act(torch.einsum("gech,ehf->gecf", recv, self.wi.to(dt)))
        ye = torch.einsum("gecf,efh->gech", he, self.wo.to(dt))
        back = all_to_all(ye, grp).reshape(n, gc, el, c, h)
        mine_out = back.transpose(0, 1).reshape(gc, e, c, h)
        return gather_replicated(mine_out, grp, dim=0)[:g]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..models.layers import compute_dtype
        cfg = self.config
        e = cfg.moe_experts
        k = min(cfg.moe_top_k, e)
        dt = compute_dtype(cfg)
        b, l, h = x.shape
        t = b * l
        s = min(getattr(cfg, "moe_group_size", 1024), t)
        pad = (-t) % s
        g = (t + pad) // s
        cap = max(int(math.ceil(k * s / e * cfg.moe_capacity_factor)), 1)

        xt = x.reshape(t, h)
        valid = torch.ones(t, dtype=torch.float32, device=x.device)
        if pad:
            xt = torch.cat([xt, xt.new_zeros(pad, h)])
            valid = torch.cat([valid, valid.new_zeros(pad)])
        xg = xt.reshape(g, s, h)
        valid = valid.reshape(g, s)

        probs = torch.softmax(xg.float() @ self.router.weight.float().T, -1)
        gate_vals, expert_idx = torch.topk(probs, k, dim=-1)      # [G, S, k]
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

        # choices in priority order: every first choice, then every second
        flat_idx = expert_idx.transpose(1, 2).reshape(g, k * s)
        flat_gate = gate_vals.transpose(1, 2).reshape(g, k * s)
        flat_valid = valid.repeat(1, k)
        onehot = F.one_hot(flat_idx, e).float() * flat_valid[..., None]
        pos = (torch.cumsum(onehot, dim=1) - 1.0) * onehot
        pos_in_expert = pos.sum(-1).long()                        # [G, kS]
        keep = pos_in_expert < cap
        flat_gate = torch.where(keep, flat_gate,
                                torch.zeros_like(flat_gate)) * flat_valid

        oh_k = onehot.reshape(g, k, s, e)
        poh_k = (F.one_hot(pos_in_expert.clamp(0, cap - 1), cap).float()
                 * keep[..., None].float()).reshape(g, k, s, cap)
        gate_k = flat_gate.reshape(g, k, s)
        disp = torch.einsum("gkse,gksc->gsec", oh_k, poh_k)
        comb = torch.einsum("gkse,gksc->gsec", oh_k,
                            poh_k * gate_k[..., None])

        xe = torch.einsum("gsec,gsh->gech", disp.to(dt), xg.to(dt))
        ye = self.experts(xe)
        out = torch.einsum("gsec,gech->gsh", comb.to(dt), ye)
        out = out.reshape(g * s, h)[:t]

        nvalid = valid.sum().clamp(min=1.0)
        top1 = F.one_hot(expert_idx[..., 0], e).float() * valid[..., None]
        frac = top1.sum((0, 1)) / nvalid
        mean_prob = (probs * valid[..., None]).sum((0, 1)) / nvalid
        aux = e * torch.sum(frac * mean_prob)
        if self.training and self.aux_sink is not None:
            self.aux_sink.append(aux)
        with torch.no_grad():
            self.stats = {
                "aux": aux.detach(),
                "dropped": ((~keep).float() * flat_valid).sum()
                / flat_valid.sum().clamp(min=1.0)}
        return out.reshape(b, l, h)


def moe_layers(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, MoEMLP)]


@contextlib.contextmanager
def collect_aux(model: nn.Module):
    """Inside, every training forward of `model`'s MoE layers appends its
    load-balance aux to the list this yields. Close it before the
    backward."""
    layers = moe_layers(model)
    values: List[torch.Tensor] = []
    for m in layers:
        m.aux_sink = values
    try:
        yield values
    finally:
        for m in layers:
            m.aux_sink = None


def moe_aux_loss(values, device=None) -> torch.Tensor:
    """sum(aux - 1) over the recorded `values` (0 at perfect balance; a
    zero on `device` when there are none)."""
    if not values:
        return torch.zeros((), device=device)
    return torch.stack([aux - 1.0 for aux in values]).sum()


def moe_dropped_share(model: nn.Module) -> torch.Tensor:
    """The mean over MoE layers of the share of (token, choice) assignments
    over capacity in each layer's last call."""
    vals = [m.stats["dropped"] for m in moe_layers(model) if m.stats]
    return torch.stack(vals).mean()


__all__ = ["MoEMLP", "collect_aux", "moe_aux_loss", "moe_layers",
           "moe_dropped_share"]
