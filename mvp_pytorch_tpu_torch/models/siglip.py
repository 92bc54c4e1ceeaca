"""SigLIP: a dual encoder of images and text trained with the sigmoid loss
(Zhai et al., "Sigmoid Loss for Language Image Pre-Training",
arXiv:2303.15343; big_vision's `two_towers` with the `siglip` loss).

The published so400m/14 at 384 px (`google/siglip-so400m-patch14-384`,
the SoViT-400m shape of arXiv:2305.13035) has two towers of 27 pre-LN
layers (`layers.PreLNLayer`), hidden 1,152, 16 heads of 72, MLP 4,304 with
tanh GELU, LayerNorm eps 1e-6, biases on every projection and no dropout:

- vision: 14 x 14 patches of a 384 x 384 x 3 image (729 tokens) projected
  to the hidden width, a learned position table, the layers, a
  post-LayerNorm, and the MAP head (multihead attention pooling: one
  learned probe attends over the 729 tokens, then LayerNorm and an MLP are
  added on its residual);
- text: a 32,000-row token table and 64 learned positions, ids padded to 64
  with no attention mask, the layers, a final LayerNorm, and the last
  position through a 1,152 -> 1,152 linear head;
- both embeddings L2-normalised; logits z_ij = exp(t) x_i . y_j + b with
  learnable t and b (initialised at log 10 and -10); the loss
  -mean_i sum_j log sigmoid(l_ij (2 [i = j] - 1)).

Parameter names are the published checkpoint's (`vision_model.encoder.
layers.0.self_attn.q_proj.weight`, `vision_model.head.attention.
in_proj_weight`, `text_model.head.weight`, `logit_scale`, ...). Mixed
precision as the port's other models: float32 master weights, products in
`config.dtype`, LayerNorm statistics and the loss in float32. Every
attention call, the MAP probe's included, goes through
`layers.masked_attention` (the kernels at head dim 72). The forward's spans
(`training/profiler.py::annotate`): `siglip.vision`, `siglip.text` and
`siglip.loss`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..training.profiler import annotate
from . import layers
from .layers import Dense, LayerNorm, PreLNLayer, PreLNMLP, resolve_device

__all__ = ["SiglipConfig", "SiglipModel", "SiglipOutput", "sigmoid_loss"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class SiglipTextConfig:
    """The published `text_config` (so400m/14-384's values)."""
    vocab_size: int = 32000
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    max_position_embeddings: int = 64
    hidden_act: str = "gelu_pytorch_tanh"
    layer_norm_eps: float = 1e-6
    attention_dropout: float = 0.0
    pad_token_id: int = 1


@dataclass
class SiglipVisionConfig:
    """The published `vision_config` (so400m/14-384's values)."""
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_channels: int = 3
    image_size: int = 384
    patch_size: int = 14
    hidden_act: str = "gelu_pytorch_tanh"
    layer_norm_eps: float = 1e-6
    attention_dropout: float = 0.0

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclass
class SiglipConfig:
    """SigLIP's configuration under the published config.json's keys
    (nested `text_config` and `vision_config`), plus the port's compute
    policy: `dtype` and `initializer_range` (the std of the seeded
    weights)."""
    text_config: SiglipTextConfig = field(default_factory=SiglipTextConfig)
    vision_config: SiglipVisionConfig = field(
        default_factory=SiglipVisionConfig)
    dtype: str = "bfloat16"
    initializer_range: float = 0.02

    def __post_init__(self):
        for part in (self.text_config, self.vision_config):
            if part.hidden_size % part.num_attention_heads:
                raise ValueError(f"hidden_size {part.hidden_size} not "
                                 f"divisible by {part.num_attention_heads} "
                                 f"heads")
            if part.hidden_act != "gelu_pytorch_tanh":
                raise ValueError(f"hidden_act {part.hidden_act!r}: the port "
                                 f"runs SigLIP's tanh GELU only")
            if part.attention_dropout:
                raise ValueError("SigLIP has no attention dropout")
        if self.text_config.hidden_size != self.vision_config.hidden_size:
            raise ValueError("the towers' embeddings must share a width")

    @classmethod
    def from_dict(cls, d: dict, **overrides) -> "SiglipConfig":
        """A config.json's dict (unknown keys ignored), with `overrides`
        of the top-level fields."""
        def part(kind, values):
            known = {f.name for f in dataclasses.fields(kind)}
            return kind(**{k: v for k, v in (values or {}).items()
                           if k in known})
        top = {f.name for f in dataclasses.fields(cls)} - {
            "text_config", "vision_config"}
        kw = {k: v for k, v in {**d, **overrides}.items() if k in top}
        return cls(text_config=part(SiglipTextConfig, d.get("text_config")),
                   vision_config=part(SiglipVisionConfig,
                                      d.get("vision_config")), **kw)

    @classmethod
    def from_json_file(cls, path: str, **overrides) -> "SiglipConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f), **overrides)

    def to_dict(self) -> dict:
        return dict(dataclasses.asdict(self), model_type="siglip")

    def save_pretrained(self, save_directory: str) -> None:
        os.makedirs(save_directory, exist_ok=True)
        with open(os.path.join(save_directory, "config.json"), "w") as f:
            f.write(json.dumps(self.to_dict(), indent=2, sort_keys=True)
                    + "\n")


class PatchEmbedding(nn.Module):
    """The published stride-p p x p convolution over the pixels (padding
    "valid": 384 // 14 = 27 patches a side, the last 6 rows and columns
    unread) as the product it is: each patch's (channel, row, column)
    values times the [hidden, C, p, p] weight, in the compute dtype."""

    def __init__(self, channels: int, patch: int, hidden: int,
                 dtype: torch.dtype):
        super().__init__()
        self.patch = patch
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(hidden, channels, patch,
                                               patch))
        self.bias = nn.Parameter(torch.zeros(hidden))

    def forward(self, pixels):
        b, c, s, _ = pixels.shape
        n, p, dt = s // self.patch, self.patch, self.compute_dtype
        patches = pixels[:, :, :n * p, :n * p].to(dt).reshape(
            b, c, n, p, n, p).permute(
            0, 2, 4, 1, 3, 5).reshape(b, n * n, c * p * p)
        return F.linear(patches, self.weight.reshape(
            self.weight.shape[0], -1).to(dt), self.bias.to(dt))


class VisionEmbeddings(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = dtype
        self.patch_embedding = PatchEmbedding(cfg.num_channels,
                                              cfg.patch_size,
                                              cfg.hidden_size, dtype)
        self.position_embedding = nn.Embedding(cfg.num_patches,
                                               cfg.hidden_size)

    def forward(self, pixels):
        return (self.patch_embedding(pixels)
                + self.position_embedding.weight.to(self.compute_dtype))


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: SiglipTextConfig, dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = dtype
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)

    def forward(self, ids):
        dt = self.compute_dtype
        pos = self.position_embedding.weight[:ids.shape[1]]
        return F.embedding(ids, self.token_embedding.weight).to(dt) \
            + pos.to(dt)


class Encoder(nn.Module):
    """A tower's stack of `PreLNLayer`s."""

    def __init__(self, cfg, dtype: torch.dtype):
        super().__init__()
        self.layers = nn.ModuleList(
            PreLNLayer(cfg.hidden_size, cfg.num_attention_heads,
                       cfg.intermediate_size, cfg.layer_norm_eps, dtype)
            for _ in range(cfg.num_hidden_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class PoolingAttention(nn.Module):
    """The MAP head's attention (`torch.nn.MultiheadAttention`'s parameters:
    packed `in_proj_weight` [3 H, H] and `in_proj_bias`, `out_proj`): the
    probe's queries over the tokens' keys and values, through
    `layers.masked_attention` (Lq 1)."""

    def __init__(self, hidden: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.compute_dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * hidden))
        self.out_proj = Dense(hidden, hidden, dtype)

    def forward(self, probe, x):
        b, l, h = x.shape
        dt, d = self.compute_dtype, h // self.heads
        w, bias = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        q = F.linear(probe.to(dt), w[:h], bias[:h]).view(b, -1, self.heads, d)
        kv = F.linear(x, w[h:], bias[h:])      # [B, L, 2 H]: k, v side by side
        k = kv[..., :h].view(b, l, self.heads, d)
        v = kv[..., h:].view(b, l, self.heads, d)
        ctx = layers.masked_attention(q, k, v, None, layout="blhd")
        return self.out_proj(ctx.reshape(b, -1, h))


class MAPHead(nn.Module):
    """Multihead attention pooling (big_vision's `MAPHead`)."""

    def __init__(self, cfg: SiglipVisionConfig, dtype: torch.dtype):
        super().__init__()
        h = cfg.hidden_size
        self.probe = nn.Parameter(torch.empty(1, 1, h))
        self.attention = PoolingAttention(h, cfg.num_attention_heads, dtype)
        self.layernorm = LayerNorm(h, cfg.layer_norm_eps, dtype)
        self.mlp = PreLNMLP(h, cfg.intermediate_size, dtype)

    def forward(self, x):
        probe = self.probe.expand(x.shape[0], 1, x.shape[2])
        x = self.attention(probe, x)
        return (x + self.mlp(self.layernorm(x)))[:, 0]


class VisionTransformer(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, dtype: torch.dtype):
        super().__init__()
        self.embeddings = VisionEmbeddings(cfg, dtype)
        self.encoder = Encoder(cfg, dtype)
        self.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                        dtype)
        self.head = MAPHead(cfg, dtype)

    def forward(self, pixels):
        x = self.post_layernorm(self.encoder(self.embeddings(pixels)))
        return self.head(x)


class TextTransformer(nn.Module):
    def __init__(self, cfg: SiglipTextConfig, dtype: torch.dtype):
        super().__init__()
        self.embeddings = TextEmbeddings(cfg, dtype)
        self.encoder = Encoder(cfg, dtype)
        self.final_layer_norm = LayerNorm(cfg.hidden_size,
                                          cfg.layer_norm_eps, dtype)
        self.head = Dense(cfg.hidden_size, cfg.hidden_size, dtype)

    def forward(self, ids):
        x = self.final_layer_norm(self.encoder(self.embeddings(ids)))
        return self.head(x[:, -1])


def sigmoid_loss(img: torch.Tensor, txt: torch.Tensor, logit_scale,
                 logit_bias) -> tuple:
    """(loss, logits [B_text, B_image]) of L2-normalised embeddings in
    float32: -mean over texts of sum over images of log sigmoid(z l), with
    l = exp(t) x.y + b and z = 1 on the diagonal, -1 off it."""
    logits = (txt @ img.t()) * logit_scale.exp() + logit_bias
    z = 2.0 * torch.eye(logits.shape[0], device=logits.device) - 1.0
    return -F.logsigmoid(z * logits).sum(dim=1).mean(), logits


class SiglipOutput(NamedTuple):
    loss: torch.Tensor
    logits_per_text: torch.Tensor      # [B_text, B_image], float32
    text_embeds: torch.Tensor          # L2-normalised, float32
    image_embeds: torch.Tensor


class SiglipModel(nn.Module):
    """Both towers, the logit scale and bias (module docstring). Seeded
    weights (normal(initializer_range) kernels, tables and the probe, zero
    biases, unit LayerNorm scales, t = log 10, b = -10), moved to
    `device`, in eval mode."""

    def __init__(self, config: SiglipConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        dt = _DTYPES[config.dtype]
        self.vision_model = VisionTransformer(config.vision_config, dt)
        self.text_model = TextTransformer(config.text_config, dt)
        self.logit_scale = nn.Parameter(torch.empty(1))
        self.logit_bias = nn.Parameter(torch.empty(1))
        self._init_weights(torch.Generator().manual_seed(seed))
        self.to(device)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, generator: torch.Generator) -> None:
        std = self.config.initializer_range
        layers.init_weights(self, std, generator)
        for m in self.modules():
            if isinstance(m, PatchEmbedding):
                m.weight.normal_(0.0, std, generator=generator)
                m.bias.zero_()
            elif isinstance(m, PoolingAttention):
                m.in_proj_weight.normal_(0.0, std, generator=generator)
                m.in_proj_bias.zero_()
            elif isinstance(m, MAPHead):
                m.probe.normal_(0.0, std, generator=generator)
        self.logit_scale.fill_(math.log(10.0))
        self.logit_bias.fill_(-10.0)

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    def forward(self, pixel_values: torch.Tensor,
                input_ids: torch.Tensor) -> SiglipOutput:
        """pixel_values [B, C, S, S] float32, input_ids [B, L] int64 (L at
        most the position table's 64; text i pairs with image i)."""
        with annotate("siglip.vision"):
            img = self.vision_model(pixel_values)
        with annotate("siglip.text"):
            txt = self.text_model(input_ids)
        with annotate("siglip.loss"):
            img = F.normalize(img.float(), dim=-1)
            txt = F.normalize(txt.float(), dim=-1)
            loss, logits = sigmoid_loss(img, txt, self.logit_scale,
                                        self.logit_bias)
        return SiglipOutput(loss, logits, txt, img)
