"""The plain reference of SigLIP (family "siglip"): the sigmoid-loss dual
encoder as published, in float32 with TF32 off, over a weight dict under the
published checkpoint's names.

Sources: Zhai et al., "Sigmoid Loss for Language Image Pre-Training"
(arXiv:2303.15343); the so400m/14-384 config.json
(https://huggingface.co/google/siglip-so400m-patch14-384/blob/main/config.json)
and big_vision's two-towers model. Both towers are pre-LN transformers:
x + attn(LN1(x)), then + fc2(gelu_tanh(fc1(LN2(x)))), LayerNorm eps from the
config, biases on every projection, softmax(q.k^T / sqrt(d)).v over all
positions (no mask: the text is padded to its 64 positions, as SigLIP
pads). Vision: 14 x 14 patches times the [H, C, 14, 14] kernel, plus a
learned position table, the layers, a post-LayerNorm and the MAP head (one
learned probe attends over every token through a multi-head attention with
packed [3 H, H] projections, then LayerNorm and the MLP are added on its
residual). Text: token and position tables, the layers, a final LayerNorm,
the last position through a linear head. Loss: both embeddings
L2-normalised, l_ij = exp(t) x_i.y_j + b, -mean_i sum_j log sigmoid(z_ij
l_ij), z = 1 on the diagonal and -1 off it.

Departures, each of form only:
- the patch convolution (stride = kernel = 14, padding "valid": 27
  patches a side of 384, the last 6 rows and columns unread) is computed
  as the product it is, each patch's (channel, row, column) values against
  the kernel's rows, so that the float8 control rounds its operands too;
- the loss is over this card's B pairs: the other chunks of the published
  32k batch are absent here as in the program;
- on the card each layer of both towers runs under activation
  checkpointing (`checkpoint=True`), so that B 48 fits beside the weights
  and AdamW's state: the same values, recomputed in the backward.
Imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

from .. import weights
from .common import Numerics, l2n, layer_norm, no_tf32


def _layer_spec(pre: str, h: int, inter: int):
    out = []
    for name in ("layer_norm1", "layer_norm2"):
        out += [(f"{pre}.{name}.weight", (h,), "ones"),
                (f"{pre}.{name}.bias", (h,), "zeros")]
    for name, shape in (("self_attn.q_proj", (h, h)),
                        ("self_attn.k_proj", (h, h)),
                        ("self_attn.v_proj", (h, h)),
                        ("self_attn.out_proj", (h, h)),
                        ("mlp.fc1", (inter, h)), ("mlp.fc2", (h, inter))):
        out += [(f"{pre}.{name}.weight", shape, "normal"),
                (f"{pre}.{name}.bias", shape[:1], "zeros")]
    return out


def param_spec(cfg: dict, kind: str = "pretrain"):
    """(name, shape, init) of every parameter, under the published names."""
    v, t = cfg["vision_config"], cfg["text_config"]
    h, p, c = v["hidden_size"], v["patch_size"], v["num_channels"]
    n_patch = (v["image_size"] // p) ** 2
    spec = [("vision_model.embeddings.patch_embedding.weight", (h, c, p, p),
             "normal"),
            ("vision_model.embeddings.patch_embedding.bias", (h,), "zeros"),
            ("vision_model.embeddings.position_embedding.weight",
             (n_patch, h), "normal")]
    for i in range(v["num_hidden_layers"]):
        spec += _layer_spec(f"vision_model.encoder.layers.{i}", h,
                            v["intermediate_size"])
    head = "vision_model.head"
    spec += [("vision_model.post_layernorm.weight", (h,), "ones"),
             ("vision_model.post_layernorm.bias", (h,), "zeros"),
             (f"{head}.probe", (1, 1, h), "normal"),
             (f"{head}.attention.in_proj_weight", (3 * h, h), "normal"),
             (f"{head}.attention.in_proj_bias", (3 * h,), "zeros"),
             (f"{head}.attention.out_proj.weight", (h, h), "normal"),
             (f"{head}.attention.out_proj.bias", (h,), "zeros"),
             (f"{head}.layernorm.weight", (h,), "ones"),
             (f"{head}.layernorm.bias", (h,), "zeros"),
             (f"{head}.mlp.fc1.weight", (v["intermediate_size"], h), "normal"),
             (f"{head}.mlp.fc1.bias", (v["intermediate_size"],), "zeros"),
             (f"{head}.mlp.fc2.weight", (h, v["intermediate_size"]), "normal"),
             (f"{head}.mlp.fc2.bias", (h,), "zeros")]
    ht = t["hidden_size"]
    spec += [("text_model.embeddings.token_embedding.weight",
              (t["vocab_size"], ht), "normal"),
             ("text_model.embeddings.position_embedding.weight",
              (t["max_position_embeddings"], ht), "normal")]
    for i in range(t["num_hidden_layers"]):
        spec += _layer_spec(f"text_model.encoder.layers.{i}", ht,
                            t["intermediate_size"])
    spec += [("text_model.final_layer_norm.weight", (ht,), "ones"),
             ("text_model.final_layer_norm.bias", (ht,), "zeros"),
             ("text_model.head.weight", (ht, ht), "normal"),
             ("text_model.head.bias", (ht,), "zeros"),
             ("logit_scale", (1,), "zeros"),
             ("logit_bias", (1,), "zeros")]
    return spec


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The benchmark's seeded weights (`weights.make`: normal(0,
    initializer_range) kernels, tables and the probe, zero biases, unit
    LayerNorm scales) with the published initial t = log 10 and b = -10."""
    W = weights.make(param_spec(cfg), {
        "initializer_range": cfg["initializer_range"],
        "hidden_size": cfg["vision_config"]["hidden_size"]}, seed, device)
    W["logit_scale"].fill_(math.log(10.0))
    W["logit_bias"].fill_(-10.0)
    return W


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")     # gelu_pytorch_tanh


class Siglip:
    """The towers and the loss over a weight dict `W` (float32 tensors) and
    a config dict in the published layout."""

    def __init__(self, W: Dict[str, torch.Tensor], cfg: dict, num: Numerics,
                 checkpoint: bool = False):
        no_tf32()
        self.W, self.cfg, self.num = W, cfg, num
        self.checkpoint = checkpoint

    def dense(self, x, pre):
        return self.num.linear(x, self.W[pre + ".weight"],
                               self.W[pre + ".bias"])

    def ln(self, x, pre, eps):
        return layer_norm(x, self.W[pre + ".weight"], self.W[pre + ".bias"],
                          eps)

    def attention(self, q, k, v, heads: int):
        """softmax(q.k^T / sqrt(d)).v over [B, L, H] projections."""
        b, lq, h = q.shape
        d = h // heads
        q, k, v = (t.reshape(b, -1, heads, d).transpose(1, 2)
                   for t in (q, k, v))
        probs = torch.softmax(self.num.mm(q, k.transpose(-1, -2))
                              / math.sqrt(d), dim=-1)
        return self.num.mm(probs, v).transpose(1, 2).reshape(b, lq, h)

    def mlp(self, x, pre):
        return self.dense(gelu_tanh(self.dense(x, pre + ".fc1")),
                          pre + ".fc2")

    def layer(self, pre, x, part):
        eps, heads = part["layer_norm_eps"], part["num_attention_heads"]
        a = self.ln(x, pre + ".layer_norm1", eps)
        ctx = self.attention(self.dense(a, pre + ".self_attn.q_proj"),
                             self.dense(a, pre + ".self_attn.k_proj"),
                             self.dense(a, pre + ".self_attn.v_proj"), heads)
        x = x + self.dense(ctx, pre + ".self_attn.out_proj")
        return x + self.mlp(self.ln(x, pre + ".layer_norm2", eps),
                            pre + ".mlp")

    def encoder(self, pre, x, part):
        for i in range(part["num_hidden_layers"]):
            name = f"{pre}.encoder.layers.{i}"
            if self.checkpoint and torch.is_grad_enabled():
                x = _checkpoint(lambda y, n=name: self.layer(n, y, part), x,
                                use_reentrant=False)
            else:
                x = self.layer(name, x, part)
        return x

    def map_head(self, x, part):
        pre, W = "vision_model.head", self.W
        b, _, h = x.shape
        w, bias = (W[f"{pre}.attention.in_proj_{n}"] for n in ("weight",
                                                               "bias"))
        probe = W[f"{pre}.probe"].expand(b, 1, h)
        q = self.num.linear(probe, w[:h], bias[:h])
        k = self.num.linear(x, w[h:2 * h], bias[h:2 * h])
        v = self.num.linear(x, w[2 * h:], bias[2 * h:])
        y = self.dense(self.attention(q, k, v, part["num_attention_heads"]),
                       pre + ".attention.out_proj")
        y = y + self.mlp(self.ln(y, pre + ".layernorm",
                                 part["layer_norm_eps"]), pre + ".mlp")
        return y[:, 0]

    def vision(self, pixels):
        """[B, C, S, S] pixels -> the image embeddings [B, H]."""
        part, W = self.cfg["vision_config"], self.W
        p = part["patch_size"]
        b, c, s, _ = pixels.shape
        n = s // p
        patches = pixels[:, :, :n * p, :n * p].reshape(
            b, c, n, p, n, p).permute(
            0, 2, 4, 1, 3, 5).reshape(b, n * n, c * p * p)
        kernel = W["vision_model.embeddings.patch_embedding.weight"]
        x = (self.num.linear(patches, kernel.reshape(kernel.shape[0], -1),
                             W["vision_model.embeddings.patch_embedding.bias"])
             + W["vision_model.embeddings.position_embedding.weight"])
        x = self.encoder("vision_model", x, part)
        x = self.ln(x, "vision_model.post_layernorm", part["layer_norm_eps"])
        return self.map_head(x, part)

    def text(self, ids):
        """[B, L] ids -> the text embeddings [B, H] (the last position)."""
        part, W = self.cfg["text_config"], self.W
        x = (W["text_model.embeddings.token_embedding.weight"][ids]
             + W["text_model.embeddings.position_embedding.weight"][
                 :ids.shape[1]])
        x = self.encoder("text_model", x, part)
        x = self.ln(x, "text_model.final_layer_norm", part["layer_norm_eps"])
        return self.dense(x[:, -1], "text_model.head")

    def forward(self, batch):
        """(normalised image embeddings, normalised text embeddings,
        logits [B_text, B_image], loss)."""
        img = l2n(self.vision(batch["pixel_values"]))
        txt = l2n(self.text(batch["input_ids"]))
        logits = (self.num.mm(txt, img.t()) * self.W["logit_scale"].exp()
                  + self.W["logit_bias"])
        z = 2.0 * torch.eye(logits.shape[0], device=logits.device) - 1.0
        loss = -F.logsigmoid(z * logits).sum(dim=1).mean()
        return img, txt, logits, loss

    def pretrain_loss(self, batch) -> Dict[str, torch.Tensor]:
        return {"loss": self.forward(batch)[3]}
