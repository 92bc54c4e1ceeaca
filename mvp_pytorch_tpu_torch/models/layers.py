"""Transformer building blocks, per-layer layout.

Module and parameter names follow the reference's torch state-dict keys
(`bert.txt_encoder.layer.3.attention.self.query.weight`, ...), which the JAX
package's `convert.export_state_dict` emits, so a converted JAX params tree or
a reference `pytorch_model.bin` loads with `load_state_dict(strict=True)`.

Precision policy (the JAX package's): parameters are fp32 master weights and
compute runs in `config.dtype`. In bf16 a `Dense` casts its input, weight and
bias to bf16 (as flax `nn.Dense(dtype=bf16)` does), embeddings are gathered
from the bf16-cast table and summed in bf16, and LayerNorm takes its
statistics in fp32 and returns the compute type.

Training: `Dropout` draws its masks from a `torch.Generator` the caller
hands over with `dropout_generator`, never from torch's global generator.
Attention always goes through `masked_attention`, at any dropout: in a
training forward `SelfAttention` draws one int64 seed per call from its
`Dropout`'s generator (on the model's device, with no host sync), and the
kernel drops attention probabilities by a hash of that seed and each
element's index (the JAX layer leaves its kernel for einsums there,
`mvp_pytorch_tpu/models/layers.py:143-152`; the function is the same, the
random stream is not).

Parallel paths (`parallel/`): `parallel.mesh.apply_tensor_parallel` marks
the column- and row-parallel `Dense`s, `SelfAttention` (H / tp heads a
model rank, so the kernel runs on those) and `MoEMLP` (E / tp experts);
`StreamEncoder` opens the sequence-parallel region around its layers, runs
every `moe_every`-th layer's FFN as an `MoEMLP` when `config.moe_experts`,
remats each layer under `config.remat`, and under a `pipeline_stages > 0`
config inside the Trainer's GPipe scope runs its stack through
`parallel.pipeline.gpipe_apply`.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import mask_to_bias, masked_attention
from ..parallel.activation_sharding import (chunk_of, current_region,
                                            enter_region, exit_region,
                                            sequence_region, shard_seq,
                                            unshard_seq)
from .config import ModelConfig

__all__ = [
    "ACT2FN", "Dense", "Dropout", "LayerNorm", "Embeddings", "SelfAttention",
    "AttentionBlock", "TransformerLayer", "StreamEncoder", "Pooler",
    "PreLNAttention", "PreLNMLP", "PreLNLayer",
    "mask_to_bias", "compute_dtype", "dropout_generator", "hidden_dropouts",
    "resolve_device",
]


def compute_dtype(config: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[config.dtype]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Asking for CUDA where there is none raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return device


def _gelu(x):
    """Exact erf GELU in fp32 (the reference's, modeling_bert.py:142-148);
    the tanh form in bf16, as the JAX package chose for its compute type."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


ACT2FN = {
    "gelu": _gelu,
    "relu": F.relu,
    "swish": F.silu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": F.gelu,
}


class Dropout(nn.Module):
    """Inverted dropout whose masks come from `self.generator`, which
    `dropout_generator` sets. Training with p > 0 and no generator raises."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def _generator(self) -> torch.Generator:
        if self.generator is None:
            raise RuntimeError("dropout in training needs a generator: wrap "
                               "the forward in dropout_generator(model, gen)")
        return self.generator

    def forward(self, x):
        if not self.training or self.p == 0:
            return x
        region = current_region()
        if region is not None and x.dim() == 3 and x.shape[1] == region.chunk:
            # a sequence-parallel chunk: this rank's positions of the mask
            # drawn for the whole sequence, as every model rank draws it
            shape = (x.shape[0], region.length, x.shape[2])
            keep = chunk_of(x.new_empty(shape).bernoulli_(
                1.0 - self.p, generator=self._generator()), region)
        else:
            keep = torch.empty_like(x).bernoulli_(
                1.0 - self.p, generator=self._generator())
        return x * keep / (1.0 - self.p)

    def seed(self, device) -> torch.Tensor:
        """A one-element int64 tensor on `device`, drawn from the generator:
        the seed of a kernel's dropout mask."""
        return torch.randint(-2 ** 63, 2 ** 63 - 1, (1,), dtype=torch.int64,
                             device=device, generator=self._generator())


@contextlib.contextmanager
def dropout_generator(module: nn.Module, generator: Optional[torch.Generator]):
    """Every `Dropout` under `module` draws from `generator` inside the
    block; each gets its earlier generator back after it."""
    drops = [m for m in module.modules() if isinstance(m, Dropout)]
    prev = [m.generator for m in drops]
    for m in drops:
        m.generator = generator
    try:
        yield
    finally:
        for m, g in zip(drops, prev):
            m.generator = g


def hidden_dropouts(module: nn.Module):
    """Every `Dropout` under `module` but the attention probabilities'
    (`SelfAttention.dropout`, whose rate the kernel reads): the embeddings',
    the region projection's, each layer's attention-output and FFN-output
    dropouts and a task head's."""
    attention = {id(m.dropout) for m in module.modules()
                 if isinstance(m, SelfAttention)}
    return [m for m in module.modules()
            if isinstance(m, Dropout) and id(m) not in attention]


class Dense(nn.Linear):
    """nn.Linear (torch [out, in] weight) computing in a given dtype.

    Under tensor parallelism (`tp_mode`, set by
    `parallel.mesh.apply_tensor_parallel`) the weight is this model rank's
    shard: "col" holds output rows (the caller enters the region), "row"
    input columns, whose partial products are summed over the model ranks
    (or reduce-scattered along L under sequence parallelism) before the
    whole bias is added."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype
        self.tp_mode = None
        self.tp_mesh = None

    def forward(self, x):
        dt = self.compute_dtype
        if self.tp_mode == "row":
            y = exit_region(F.linear(x.to(dt), self.weight.to(dt)),
                            self.tp_mesh.model_group)
            return y + self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """fp32 statistics and affine, output in the compute dtype."""

    def __init__(self, hidden: int, eps: float, dtype: torch.dtype):
        super().__init__(hidden, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


class Embeddings(nn.Module):
    """Word + position + token-type embeddings, LayerNorm, dropout."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.word_embeddings = nn.Embedding(config.vocab_size, h)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h)
        self.LayerNorm = LayerNorm(h, config.layer_norm_eps,
                                   compute_dtype(config))
        self.dropout = Dropout(config.hidden_dropout_prob)

    def word_table(self) -> torch.Tensor:
        """The [vocab_size, H] word embedding table, which the tied LM heads
        read at call time."""
        return self.word_embeddings.weight

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        dt = compute_dtype(self.config)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)[None, :]

        def emb(table, ids):   # gather, then cast: the rows of the cast table
            return F.embedding(ids, table.weight).to(dt)

        x = (emb(self.word_embeddings, input_ids)
             + emb(self.position_embeddings, position_ids)
             + emb(self.token_type_embeddings, token_type_ids))
        return self.dropout(self.LayerNorm(x))


class SelfAttention(nn.Module):
    """Multi-head self-attention. q, k and v stay in the projection's
    [B, L, H, D] layout; the kernel reads them through their strides.

    With `history_state` ([B, Lh, H], the layer's cached input states of
    earlier positions; reference modeling_vlbert.py:63-69) the keys and
    values project `[history_state ; hidden]` and the queries `hidden` only,
    so the kernel runs with Lq < Lk."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        dt = compute_dtype(config)
        h = config.hidden_size
        self.config = config
        self.query = Dense(h, h, dt)
        self.key = Dense(h, h, dt)
        self.value = Dense(h, h, dt)
        self.dropout = Dropout(config.attention_probs_dropout_prob)
        self.tp_mesh = None

    def forward(self, hidden, bias, history_state=None):
        cfg = self.config
        tp = self.tp_mesh
        if tp is not None:
            if history_state is not None and current_region() is not None:
                raise NotImplementedError("a history cache under sequence "
                                          "parallelism")
            hidden = enter_region(hidden, tp.model_group)
        b, l, _ = hidden.shape
        kv_input = (hidden if history_state is None
                    else torch.cat([history_state, hidden], dim=1))

        def split4(x):      # H / tp heads on a model rank
            return x.view(b, x.shape[1], -1, cfg.head_dim)

        q = split4(self.query(hidden))
        k = split4(self.key(kv_input))
        v = split4(self.value(kv_input))
        p = self.dropout.p if self.training else 0.0
        seed = self.dropout.seed(q.device) if p > 0 else None
        if seed is not None and tp is not None:
            # each model rank's heads drop by their own stream
            seed = seed ^ tp.model_rank
        ctx = masked_attention(q, k, v, bias, layout="blhd", dropout_p=p,
                               seed=seed)
        return ctx.reshape(b, l, -1)


class SelfOutput(nn.Module):
    """dense -> dropout -> LayerNorm(out + residual)."""

    def __init__(self, config: ModelConfig, in_features: int):
        super().__init__()
        dt = compute_dtype(config)
        self.dense = Dense(in_features, config.hidden_size, dt)
        self.LayerNorm = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                   dt)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x, residual):
        return self.LayerNorm(self.dropout(self.dense(x)) + residual)


class AttentionBlock(nn.Module):
    """Self-attention + output projection + residual post-LN."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.self = SelfAttention(config)
        self.output = SelfOutput(config, config.hidden_size)

    def forward(self, hidden, bias, history_state=None):
        return self.output(self.self(hidden, bias, history_state), hidden)


class Intermediate(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.dense = Dense(config.hidden_size, config.intermediate_size,
                           compute_dtype(config))
        self.act = ACT2FN[config.hidden_act]

    def forward(self, x):
        if self.dense.tp_mode == "col":
            x = enter_region(x, self.dense.tp_mesh.model_group)
        return self.act(self.dense(x))


class MoEOutput(nn.Module):
    """dropout -> LayerNorm(out + residual), after an `MoEMLP`."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.LayerNorm = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                   compute_dtype(config))
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x, residual):
        return self.LayerNorm(self.dropout(x) + residual)


class TransformerLayer(nn.Module):
    """One post-LN BERT layer: attention block + GELU MLP block; with
    `use_moe`, an `MoEMLP` in place of the MLP (JAX `models/layers.py:
    182-200`)."""

    def __init__(self, config: ModelConfig, use_moe: bool = False):
        super().__init__()
        self.attention = AttentionBlock(config)
        if use_moe:
            from ..ops.moe import MoEMLP
            self.moe = MoEMLP(config)
            self.output = MoEOutput(config)
        else:
            self.intermediate = Intermediate(config)
            self.output = SelfOutput(config, config.intermediate_size)

    def forward(self, hidden, bias, history_state=None):
        attn_out = self.attention(hidden, bias, history_state)
        if not hasattr(self, "moe"):
            return self.output(self.intermediate(attn_out), attn_out)
        region = current_region()
        x = attn_out if region is None else unshard_seq(attn_out, region)
        y = self.moe(x)
        if region is not None:
            y = shard_seq(y, region)
        return self.output(y, attn_out)


class PreLNAttention(nn.Module):
    """Multi-head self-attention of a pre-LN layer under SigLIP's names
    (`q_proj`, `k_proj`, `v_proj`, `out_proj`), without dropout: q, k and v
    stay in the projections' [B, L, H, D] layout for `masked_attention`."""

    def __init__(self, hidden: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.q_proj = Dense(hidden, hidden, dtype)
        self.k_proj = Dense(hidden, hidden, dtype)
        self.v_proj = Dense(hidden, hidden, dtype)
        self.out_proj = Dense(hidden, hidden, dtype)

    def forward(self, x, bias=None):
        b, l, h = x.shape
        q, k, v = (p(x).view(b, l, self.heads, h // self.heads)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        ctx = masked_attention(q, k, v, bias, layout="blhd")
        return self.out_proj(ctx.reshape(b, l, h))


class PreLNMLP(nn.Module):
    """fc1 -> tanh GELU -> fc2 (SigLIP's `gelu_pytorch_tanh` MLP)."""

    def __init__(self, hidden: int, intermediate: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(hidden, intermediate, dtype)
        self.fc2 = Dense(intermediate, hidden, dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class PreLNLayer(nn.Module):
    """One pre-LN layer (ViT, SigLIP): x + attn(LN1(x)), then that plus
    mlp(LN2(that)). The residual stream stays in the compute dtype; the
    LayerNorms take fp32 statistics. A class of its own beside the post-LN
    `TransformerLayer`, which BERT's configurations run unchanged."""

    def __init__(self, hidden: int, heads: int, intermediate: int,
                 eps: float, dtype: torch.dtype):
        super().__init__()
        self.layer_norm1 = LayerNorm(hidden, eps, dtype)
        self.self_attn = PreLNAttention(hidden, heads, dtype)
        self.layer_norm2 = LayerNorm(hidden, eps, dtype)
        self.mlp = PreLNMLP(hidden, intermediate, dtype)

    def forward(self, x, bias=None):
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


def _layer_generator(layer: nn.Module) -> Optional[torch.Generator]:
    for m in layer.modules():
        if isinstance(m, Dropout) and m.generator is not None:
            return m.generator
    return None


def remat(layer: nn.Module, *args):
    """`layer(*args)` under `torch.utils.checkpoint`: the backward recomputes
    the layer, and the recompute draws the same dropout masks (the layer's
    generator is put back to its state before the first forward)."""
    from torch.utils.checkpoint import checkpoint
    gen = _layer_generator(layer)
    state = gen.get_state() if gen is not None else None
    first = [True]

    def run(*a):
        if first[0] or gen is None:
            first[0] = False
            return layer(*a)
        # the recompute runs in the backward, outside the caller's
        # dropout_generator block
        now = gen.get_state()
        gen.set_state(state)
        try:
            with dropout_generator(layer, gen):
                return layer(*a)
        finally:
            gen.set_state(now)
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


class StreamEncoder(nn.Module):
    """Stack of `num_layers` TransformerLayers.

    `bias` is one additive bias or a list of per-layer biases (the
    reference's stage-attention mask lists). Returns (hidden, mid) where mid
    is the output of layer `return_at_layer`, or None.

    Incremental decoding: `history_states` holds one cached [B, Lh, H] input
    state per layer (a list, or a [layers, B, Lh, H] tensor), which each
    layer's keys and values prepend; with `collect_states` the return also
    carries each layer's INPUT hidden state (what a later call's
    `history_states` takes: the reference caches layer inputs, not keys and
    values, modeling_vlbert.py:63-69).

    With `config.moe_experts`, every `moe_every`-th layer's FFN is an
    `MoEMLP`. Under a `pipeline_stages > 0` config (the JAX stacked layout,
    `StreamEncoder._stacked`; the port keeps per-layer modules, and
    `parallel.pipeline.unstack_model_params` carries stacked trees across)
    the Trainer's GPipe scope pipelines the stack over the pipe ranks;
    outside it the stack runs in order. That layout refuses MoE, history
    states and per-layer bias lists, as the JAX one does."""

    def __init__(self, config: ModelConfig, num_layers: int):
        super().__init__()
        self.config = config
        every = max(config.moe_every, 1)
        self.layer = nn.ModuleList(
            TransformerLayer(config, use_moe=config.moe_experts > 0
                             and (i + 1) % every == 0)
            for i in range(num_layers))
        self.tp_mesh = None
        self.sequence_parallel = False

    def _check_stacked(self, bias, history_states, collect_states,
                       return_at_layer):
        cfg = self.config
        if history_states is not None or collect_states:
            raise NotImplementedError(
                "pipeline_stages>0 does not support incremental-decoding "
                "history/collect states; decode on an unstacked copy "
                "(pipeline_stages=0), as tasks/captioning.py does")
        if isinstance(bias, (list, tuple)):
            raise NotImplementedError("pipeline_stages>0 requires a single "
                                      "shared bias, not per-layer mask lists")
        if cfg.moe_experts > 0:
            raise NotImplementedError(
                "pipeline_stages>0 is incompatible with MoE stacks "
                "(heterogeneous per-layer params cannot be stacked)")
        if len(self.layer) % cfg.pipeline_stages:
            raise ValueError(f"{len(self.layer)} layers not divisible by "
                             f"{cfg.pipeline_stages} pipeline stages")
        if return_at_layer is not None and not (
                0 <= return_at_layer < len(self.layer)):
            raise ValueError(f"return_at_layer {return_at_layer} outside "
                             f"[0, {len(self.layer)})")

    def forward(self, hidden, bias, *, return_at_layer: Optional[int] = None,
                history_states=None, collect_states: bool = False):
        per_layer = isinstance(bias, (list, tuple))
        if per_layer and len(bias) != len(self.layer):
            raise ValueError(f"{len(bias)} biases for {len(self.layer)} layers")
        if self.config.pipeline_stages > 0:
            self._check_stacked(bias, history_states, collect_states,
                                return_at_layer)
            from ..parallel.pipeline import current_pipeline, gpipe_apply
            scope = current_pipeline()
            if scope is not None and self.training:
                return gpipe_apply(self, hidden, bias, scope,
                                   return_at_layer=return_at_layer)
        sp = self.sequence_parallel and self.tp_mesh is not None
        if sp and (history_states is not None or collect_states):
            raise NotImplementedError("history states under sequence "
                                      "parallelism")
        with (sequence_region(self.tp_mesh.model_group,
                              self.tp_mesh.model_size, hidden.shape[1])
              if sp else contextlib.nullcontext()) as region:
            if sp:
                hidden = shard_seq(hidden, region)
            mid, states = None, []
            for i, layer in enumerate(self.layer):
                if collect_states:
                    states.append(hidden)
                b = bias[i] if per_layer else bias
                hist = None if history_states is None else history_states[i]
                if self.config.remat and self.training \
                        and torch.is_grad_enabled():
                    hidden = remat(layer, hidden, b, hist)
                else:
                    hidden = layer(hidden, b, hist)
                if return_at_layer is not None and i == return_at_layer:
                    mid = hidden if not sp else unshard_seq(hidden, region)
            if sp:
                hidden = unshard_seq(hidden, region)
        if collect_states:
            return hidden, mid, states
        return hidden, mid


class Pooler(nn.Module):
    """tanh(dense(first token)) (reference modeling_bert.py:462-474)."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.dense = Dense(config.hidden_size, config.hidden_size,
                           compute_dtype(config))

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


@torch.no_grad()
def init_weights(module: nn.Module, std: float,
                 generator: torch.Generator) -> None:
    """The JAX package's init for the Linear, Embedding and LayerNorm
    modules under `module`: normal(std) kernels and embedding tables, zero
    biases, unit LayerNorm scales."""
    from ..ops.moe import MoEMLP
    for m in module.modules():
        if isinstance(m, MoEMLP):
            m.init_weights(std, generator)
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.weight.normal_(0.0, std, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()

