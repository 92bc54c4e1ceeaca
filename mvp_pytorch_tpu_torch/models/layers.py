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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import mask_to_bias, masked_attention
from .config import ModelConfig

__all__ = [
    "ACT2FN", "Dense", "LayerNorm", "Embeddings", "SelfAttention",
    "AttentionBlock", "TransformerLayer", "StreamEncoder", "Pooler",
    "mask_to_bias", "compute_dtype",
]


def compute_dtype(config: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[config.dtype]


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
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

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
    [B, L, H, D] layout; the kernel reads them through their strides."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        dt = compute_dtype(config)
        h = config.hidden_size
        self.config = config
        self.query = Dense(h, h, dt)
        self.key = Dense(h, h, dt)
        self.value = Dense(h, h, dt)
        self.dropout = nn.Dropout(config.attention_probs_dropout_prob)

    def forward(self, hidden, bias):
        cfg = self.config
        b, l, _ = hidden.shape

        def split4(x):
            return x.view(b, x.shape[1], cfg.num_attention_heads, cfg.head_dim)

        q = split4(self.query(hidden))
        k = split4(self.key(hidden))
        v = split4(self.value(hidden))
        if self.training and cfg.attention_probs_dropout_prob > 0:
            # attention-prob dropout takes the plain path (the kernel has no
            # random numbers), as the JAX layer does (layers.py:143-152)
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
            scores = scores * cfg.head_dim ** -0.5
            if bias is not None:
                scores = scores + bias.float()
            probs = self.dropout(torch.softmax(scores, dim=-1))
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
        else:
            ctx = masked_attention(q, k, v, bias, layout="blhd")
        return ctx.reshape(b, l, cfg.hidden_size)


class SelfOutput(nn.Module):
    """dense -> dropout -> LayerNorm(out + residual)."""

    def __init__(self, config: ModelConfig, in_features: int):
        super().__init__()
        dt = compute_dtype(config)
        self.dense = Dense(in_features, config.hidden_size, dt)
        self.LayerNorm = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                   dt)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, x, residual):
        return self.LayerNorm(self.dropout(self.dense(x)) + residual)


class AttentionBlock(nn.Module):
    """Self-attention + output projection + residual post-LN."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.self = SelfAttention(config)
        self.output = SelfOutput(config, config.hidden_size)

    def forward(self, hidden, bias):
        return self.output(self.self(hidden, bias), hidden)


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

    def forward(self, hidden, bias):
        attn_out = self.attention(hidden, bias)
        return self.output(self.intermediate(attn_out), attn_out)


class StreamEncoder(nn.Module):
    """Stack of `num_layers` TransformerLayers.

    `bias` is one additive bias or a list of per-layer biases (the
    reference's stage-attention mask lists). Returns (hidden, mid) where mid
    is the output of layer `return_at_layer`, or None."""

    def __init__(self, config: ModelConfig, num_layers: int):
        super().__init__()
        self.layer = nn.ModuleList(
            TransformerLayer(config) for _ in range(num_layers))

    def forward(self, hidden, bias, *, return_at_layer: Optional[int] = None):
        per_layer = isinstance(bias, (list, tuple))
        if per_layer and len(bias) != len(self.layer):
            raise ValueError(f"{len(bias)} biases for {len(self.layer)} layers")
        mid = None
        for i, layer in enumerate(self.layer):
            hidden = layer(hidden, bias[i] if per_layer else bias)
            if return_at_layer is not None and i == return_at_layer:
                mid = hidden
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

