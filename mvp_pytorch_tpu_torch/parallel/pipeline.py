"""GPipe pipeline parallelism over the `pipe` ranks, and the stacked
layer layout: the JAX package's `parallel/pipeline.py` on
torch.distributed.

A `StreamEncoder` of a `pipeline_stages > 0` config splits its layers into
`pipe` contiguous stages, one a pipe rank. Inside the Trainer's step
(`pipeline_scope`), `gpipe_apply` runs M microbatches through the stages:
stage s takes microbatch m from stage s - 1 by `recv` (stage 0 takes it from
the encoder's input), runs its layers, and `send`s it on; the last stage's
outputs are broadcast to every pipe rank, so the code after the encoder runs
alike everywhere. The backward is the reverse schedule: the last stage
starts from the output's gradient, each stage differentiates its
microbatches and sends the input gradients back, and stage 0's input
gradient is broadcast to every pipe rank. A stage's layer parameters get
their gradients on their own rank only; every other parameter is computed
alike on every pipe rank and needs no reduction over `pipe`.

`return_at_layer` (the WRA / phrase mid-layer readout): the stage that owns
the layer records its output per microbatch and broadcasts it too. Under
`config.remat` each layer runs under `torch.utils.checkpoint`
(`models.layers.remat`). Dropout inside the stages draws from a generator
per (encoder call, layer, microbatch), seeded from the scope's seed, so the
masks do not depend on which rank runs a layer and the model's own
generator advances alike on every pipe rank.

`stack_model_params` / `unstack_model_params` turn a params tree (nested
dicts of numpy arrays, the flax layout) between per-layer `layer_{i}`
subtrees and the stacked `layers/layer` leaves with a leading layer
dimension, bit for bit: a JAX checkpoint with `pipeline_stages > 0` loads
into the port through `convert.jax_params_to_state_dict`, which unstacks.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

_TLS = threading.local()


class PipelineScope:
    """What the stages read during one micro-step: the mesh, the number of
    microbatches and the dropout seed of the micro-step."""

    def __init__(self, mesh, n_microbatches: int, seed: int = 0):
        self.mesh = mesh
        self.n_microbatches = max(1, n_microbatches)
        self.seed = seed
        self.calls = 0


@contextlib.contextmanager
def pipeline_scope(mesh, n_microbatches: int, seed: int = 0):
    prev = getattr(_TLS, "scope", None)
    _TLS.scope = PipelineScope(mesh, n_microbatches, seed)
    try:
        yield _TLS.scope
    finally:
        _TLS.scope = prev


def current_pipeline() -> Optional[PipelineScope]:
    return getattr(_TLS, "scope", None)


def stage_range(num_layers: int, n_stages: int, stage: int) -> range:
    if num_layers % n_stages:
        raise ValueError(f"{num_layers} layers not divisible by {n_stages} "
                         f"pipeline stages")
    per = num_layers // n_stages
    return range(stage * per, (stage + 1) * per)


def stage_owners(model: torch.nn.Module, n_stages: int) -> Dict[str, int]:
    """Parameter name -> the pipe rank that owns it, for the layers of
    every pipelined `StreamEncoder` (`pipeline_stages > 0`) of `model`."""
    from ..models.layers import StreamEncoder
    owners = {}
    for name, mod in model.named_modules():
        if not isinstance(mod, StreamEncoder) \
                or mod.config.pipeline_stages <= 0:
            continue
        per = len(mod.layer) // n_stages
        for i, layer in enumerate(mod.layer):
            for pn, _ in layer.named_parameters():
                owners[f"{name}.layer.{i}.{pn}" if name
                       else f"layer.{i}.{pn}"] = i // per
    return owners


def _seeded(device, *words: int) -> torch.Generator:
    seq = np.random.SeedSequence([int(w) % (2 ** 63) for w in words])
    return torch.Generator(device=device).manual_seed(
        int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1)))


class _Schedule:
    def __init__(self, encoder, scope: PipelineScope, return_at_layer,
                 params):
        mesh = scope.mesh
        self.encoder = encoder
        self.m = scope.n_microbatches
        self.n_stages, self.stage = mesh.pipe_size, mesh.pipe_rank
        self.group = mesh.pipe_group
        self.mesh = mesh
        self.layers = stage_range(len(encoder.layer), self.n_stages,
                                  self.stage)
        self.mid_layer = return_at_layer
        per = len(encoder.layer) // self.n_stages
        self.mid_stage = (None if return_at_layer is None
                          else return_at_layer // per)
        self.params = params
        self.call = scope.calls
        scope.calls += 1
        self.seed = scope.seed
        cfg = encoder.config
        self.dropout = encoder.training and (
            cfg.hidden_dropout_prob > 0
            or cfg.attention_probs_dropout_prob > 0)
        self.remat = cfg.remat
        self.saved = []

    def _global(self, stage: int) -> int:
        return self.mesh.group_rank_to_global("pipe", stage)

    def run_stage(self, h, bias, m):
        from ..models.layers import dropout_generator, remat
        mid = None
        for i in self.layers:
            layer = self.encoder.layer[i]
            gen = (_seeded(h.device, self.seed, self.call, i, m)
                   if self.dropout else None)
            with (dropout_generator(layer, gen) if gen is not None
                  else contextlib.nullcontext()):
                h = remat(layer, h, bias, None) if self.remat \
                    else layer(h, bias, None)
            if i == self.mid_layer:
                mid = h
        return h, mid

    def forward(self, x, bias):
        b = x.shape[0]
        if b % self.m:
            raise ValueError(f"batch {b} not divisible by {self.m} "
                             f"microbatches")
        xs = x.chunk(self.m)
        biases = bias.expand((b,) + tuple(bias.shape[1:])).chunk(self.m)
        mb_shape = xs[0].shape
        first, last = self.stage == 0, self.stage == self.n_stages - 1
        outs, mids, sends = [], [], []
        for m in range(self.m):
            if first:
                h = xs[m]
            else:
                h = x.new_empty(mb_shape)
                dist.recv(h, src=self._global(self.stage - 1),
                          group=self.group)
            leaf = h.detach().requires_grad_(True)
            with torch.enable_grad():
                y, mid = self.run_stage(leaf, biases[m], m)
            self.saved.append((leaf, y, mid))
            if last:
                outs.append(y.detach())
            else:
                sends.append(dist.isend(y.detach().contiguous(),
                                        dst=self._global(self.stage + 1),
                                        group=self.group))
            if mid is not None:
                mids.append(mid.detach())
        for w in sends:
            w.wait()
        out = torch.cat(outs) if last else x.new_empty(x.shape)
        dist.broadcast(out, src=self._global(self.n_stages - 1),
                       group=self.group)
        mid = None
        if self.mid_stage is not None:
            mid = (torch.cat(mids) if self.stage == self.mid_stage
                   else x.new_empty(x.shape))
            dist.broadcast(mid, src=self._global(self.mid_stage),
                           group=self.group)
        return out, mid

    def backward(self, g_out, g_mid):
        first, last = self.stage == 0, self.stage == self.n_stages - 1
        g_outs = g_out.chunk(self.m)
        g_mids = g_mid.chunk(self.m) if g_mid is not None else None
        grads = [None] * len(self.params)
        gx = [None] * self.m
        sends = []
        for m in reversed(range(self.m)):
            leaf, y, mid = self.saved[m]
            if last:
                g = g_outs[m]
            else:
                g = y.new_empty(y.shape)
                dist.recv(g, src=self._global(self.stage + 1),
                          group=self.group)
            outs, gs = [y], [g]
            if mid is not None and g_mids is not None:
                outs.append(mid)
                gs.append(g_mids[m])
            res = torch.autograd.grad(outs, [leaf] + list(self.params), gs,
                                      allow_unused=True)
            for j, gp in enumerate(res[1:]):
                if gp is not None:
                    grads[j] = gp if grads[j] is None else grads[j] + gp
            if first:
                gx[m] = res[0]
            else:
                sends.append(dist.isend(res[0].contiguous(),
                                        dst=self._global(self.stage - 1),
                                        group=self.group))
        for w in sends:
            w.wait()
        self.saved = []
        full = torch.cat(gx) if first else g_out.new_empty(g_out.shape)
        dist.broadcast(full, src=self._global(0), group=self.group)
        return full, grads


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, x, bias, *params):
        out, mid = sched.forward(x, bias)
        ctx.sched = sched
        if mid is None:
            mid = out.new_empty(0)
            ctx.mark_non_differentiable(mid)
            ctx.has_mid = False
        else:
            ctx.has_mid = True
        return out, mid

    @staticmethod
    def backward(ctx, g_out, g_mid):
        gx, grads = ctx.sched.backward(g_out,
                                       g_mid if ctx.has_mid else None)
        return (None, gx, None, *grads)


def gpipe_apply(encoder, hidden: torch.Tensor, bias: torch.Tensor,
                scope: PipelineScope, return_at_layer: Optional[int] = None):
    """Run `encoder`'s layers over `hidden` as a GPipe schedule over
    `scope.mesh`'s pipe ranks; numerically the sequential stack. Returns
    (hidden, mid) like `StreamEncoder.forward`."""
    sched = _Schedule(encoder, scope, return_at_layer, [])
    params = [p for i in sched.layers
              for p in encoder.layer[i].parameters() if p.requires_grad]
    sched.params = params
    out, mid = _GPipe.apply(sched, hidden, bias.detach(), *params)
    return out, (mid if return_at_layer is not None else None)


@contextlib.contextmanager
def unstacked(model: torch.nn.Module):
    """`model` as a per-layer (`pipeline_stages = 0`) model inside the
    block: the same modules and weights, so incremental decoding (history
    states) runs on it, as the JAX captioning driver decodes a
    pipeline-staged model on an unstacked copy
    (`mvp_pytorch_tpu/tasks/captioning.py:317`)."""
    configs = {id(m.config): m.config for m in model.modules()
               if getattr(m, "config", None) is not None
               and hasattr(m.config, "pipeline_stages")}
    saved = {k: c.pipeline_stages for k, c in configs.items()}
    for c in configs.values():
        c.pipeline_stages = 0
    try:
        yield model
    finally:
        for k, c in configs.items():
            c.pipeline_stages = saved[k]


# ---------------------------------------------------------------------------
# the stacked layout (params trees of numpy arrays)
# ---------------------------------------------------------------------------

def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_layer_params(encoder_params: dict, num_layers: int,
                       prefix: str = "layer_"):
    """Per-layer subtrees {'layer_0': {...}, ...} -> one subtree whose
    leaves carry a leading layer dimension."""
    layers = [encoder_params[f"{prefix}{i}"] for i in range(num_layers)]
    return _tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                     *layers)


def unstack_layer_params(stacked, num_layers: int, prefix: str = "layer_"):
    """The inverse of `stack_layer_params`."""
    return {f"{prefix}{i}": _tree_map(lambda x, i=i: np.asarray(x)[i],
                                      stacked)
            for i in range(num_layers)}


def _is_layer_dict(d) -> bool:
    return (isinstance(d, dict) and "layer_0" in d
            and all(k.startswith("layer_") for k in d))


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def stack_model_params(params):
    """A whole params tree from the per-layer layout to the stacked
    `{'layers': {'layer': leaves[L, ...]}}` layout, bit for bit."""
    if _is_layer_dict(params):
        return {"layers": {"layer": stack_layer_params(params,
                                                       len(params))}}
    if isinstance(params, dict):
        return {k: stack_model_params(v) for k, v in params.items()}
    return params


def unstack_model_params(params):
    """The inverse of `stack_model_params`: any `layers/layer` subtree back
    to `layer_{i}` subtrees."""
    if isinstance(params, dict) and set(params) == {"layers"} \
            and isinstance(params["layers"], dict) \
            and set(params["layers"]) == {"layer"}:
        stacked = params["layers"]["layer"]
        n = int(np.asarray(_first_leaf(stacked)).shape[0])
        return unstack_layer_params(stacked, n)
    if isinstance(params, dict):
        return {k: unstack_model_params(v) for k, v in params.items()}
    return params


__all__ = ["PipelineScope", "pipeline_scope", "current_pipeline",
           "stage_range", "stage_owners", "gpipe_apply", "unstacked",
           "stack_layer_params", "unstack_layer_params",
           "stack_model_params", "unstack_model_params"]
