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
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import mask_to_bias, masked_attention
from .config import ModelConfig

__all__ = [
    "ACT2FN", "Dense", "Dropout", "LayerNorm", "Embeddings", "SelfAttention",
    "AttentionBlock", "TransformerLayer", "StreamEncoder", "Pooler",
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
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p,
                                              generator=self._generator())
        return x * keep / (1.0 - self.p)

    def seed(self, device) -> torch.Tensor:
        """A one-element int64 tensor on `device`, drawn from the generator:
        the seed of a kernel's dropout mask."""
        return torch.randint(-2 ** 63, 2 ** 63 - 1, (1,), dtype=torch.int64,
                             device=device, generator=self._generator())


@contextlib.contextmanager
def dropout_generator(module: nn.Module, generator: Optional[torch.Generator]):
    """Every `Dropout` under `module` draws from `generator` inside the
    block."""
    drops = [m for m in module.modules() if isinstance(m, Dropout)]
    for m in drops:
        m.generator = generator
    try:
        yield
    finally:
        for m in drops:
            m.generator = None


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
    """nn.Linear (torch [out, in] weight) computing in a given dtype."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
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

    def forward(self, hidden, bias, history_state=None):
        cfg = self.config
        b, l, _ = hidden.shape
        kv_input = (hidden if history_state is None
                    else torch.cat([history_state, hidden], dim=1))

        def split4(x):
            return x.view(b, x.shape[1], cfg.num_attention_heads, cfg.head_dim)

        q = split4(self.query(hidden))
        k = split4(self.key(kv_input))
        v = split4(self.value(kv_input))
        p = self.dropout.p if self.training else 0.0
        seed = self.dropout.seed(q.device) if p > 0 else None
        ctx = masked_attention(q, k, v, bias, layout="blhd", dropout_p=p,
                               seed=seed)
        return ctx.reshape(b, l, cfg.hidden_size)


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
        return self.act(self.dense(x))


class TransformerLayer(nn.Module):
    """One post-LN BERT layer: attention block + GELU MLP block."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.attention = AttentionBlock(config)
        self.intermediate = Intermediate(config)
        self.output = SelfOutput(config, config.intermediate_size)

    def forward(self, hidden, bias, history_state=None):
        attn_out = self.attention(hidden, bias, history_state)
        return self.output(self.intermediate(attn_out), attn_out)


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
    values, modeling_vlbert.py:63-69)."""

    def __init__(self, config: ModelConfig, num_layers: int):
        super().__init__()
        self.layer = nn.ModuleList(
            TransformerLayer(config) for _ in range(num_layers))

    def forward(self, hidden, bias, *, return_at_layer: Optional[int] = None,
                history_states=None, collect_states: bool = False):
        per_layer = isinstance(bias, (list, tuple))
        if per_layer and len(bias) != len(self.layer):
            raise ValueError(f"{len(bias)} biases for {len(self.layer)} layers")
        mid, states = None, []
        for i, layer in enumerate(self.layer):
            if collect_states:
                states.append(hidden)
            hidden = layer(hidden, bias[i] if per_layer else bias,
                           None if history_states is None
                           else history_states[i])
            if return_at_layer is not None and i == return_at_layer:
                mid = hidden
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
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.weight.normal_(0.0, std, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()

