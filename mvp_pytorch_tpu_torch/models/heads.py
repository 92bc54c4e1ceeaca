"""Prediction heads, the JAX package's `models/heads.py`: the classifier,
the pretraining heads (`PredictionHeadTransform`, the tied
`LMPredictionHead`, `SeqRelationshipHead`), VQA's untied
`QAPredictionHead` and the single-stream model's masked-region heads
`MRFMRCHeads`."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import ACT2FN, Dense, LayerNorm, compute_dtype, init_weights


class PredictionHeadTransform(nn.Module):
    """dense -> activation -> LayerNorm, in the compute dtype (reference
    modeling_bert.py:477-490)."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        dt = compute_dtype(config)
        self.dense = Dense(config.hidden_size, config.hidden_size, dt)
        self.act = ACT2FN[config.hidden_act]
        self.LayerNorm = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                   dt)

    def forward(self, hidden):
        return self.LayerNorm(self.act(self.dense(hidden)))


class LMPredictionHead(nn.Module):
    """transform -> decoder tied to the first `only_word_size` rows of the
    word embedding table (with `only_vocab=False`, the whole table, as
    captioning predicts), plus a bias; fp32 logits (reference
    BertLMPredictionHead, modeling_bert.py:492-516).

    The decoder is the table itself, passed in at call time, so nothing
    needs re-tying after a load (and with `only_vocab` no phrase row is
    predicted). The reference's state dict stores the tie as
    `decoder.weight`, a copy of those rows; the models' `load_state_dict`
    checks and drops it."""

    def __init__(self, config: ModelConfig, only_vocab: bool = True):
        super().__init__()
        self.n = config.only_word_size if only_vocab else config.vocab_size
        self.transform = PredictionHeadTransform(config)
        self.bias = nn.Parameter(torch.zeros(self.n))

    def forward(self, hidden, word_table):
        h = self.transform(hidden)
        logits = h @ word_table[:self.n].to(h.dtype).T
        return logits.float() + self.bias


class QAPredictionHead(nn.Module):
    """transform -> an untied bias-free `decoder` [num_labels, H] in the
    compute dtype -> fp32 logits plus a separate `bias` (reference
    modeling_bert.py:518-533). Its keys are the reference's under
    `cls.predictions`: `transform.*`, `decoder.weight`, `bias`."""

    def __init__(self, config: ModelConfig, num_labels: Optional[int] = None):
        super().__init__()
        n = num_labels if num_labels is not None else config.num_labels
        self.compute_dtype = compute_dtype(config)
        self.transform = PredictionHeadTransform(config)
        self.decoder = nn.Linear(config.hidden_size, n, bias=False)
        self.bias = nn.Parameter(torch.zeros(n))

    def forward(self, hidden):
        h = self.transform(hidden)
        logits = F.linear(h, self.decoder.weight.to(self.compute_dtype))
        return logits.float() + self.bias


class SeqRelationshipHead(Dense):
    """The ITM (image-text match) head over the pooled output: a dense layer
    to `num_contrast_classes` in the compute dtype, fp32 logits."""

    def __init__(self, config: ModelConfig):
        super().__init__(config.hidden_size, config.num_contrast_classes,
                         compute_dtype(config))

    def forward(self, pooled):
        return super().forward(pooled).float()


class ClassifierHead(nn.Module):
    """Linear or MLP classifier over the pooled output, logits in fp32
    (reference modeling_vlbert.py:1730-1744, `cls_hidden_scale` widening).

    State-dict keys are the reference's: `weight`/`bias` for the linear head
    (an nn.Linear there), `0.*` and `2.*` for the MLP (an nn.Sequential).
    `in_features` is the input's width: the hidden size, or the choices'
    pooled outputs side by side for multiple choice."""

    def __init__(self, config: ModelConfig, num_labels: Optional[int] = None,
                 in_features: Optional[int] = None):
        super().__init__()
        self.compute_dtype = compute_dtype(config)
        n = num_labels if num_labels is not None else config.num_labels
        h = config.hidden_size
        d_in = in_features or h
        self.mlp = config.classifier == "mlp"
        if self.mlp:
            wide = h * config.cls_hidden_scale
            self.add_module("0", Dense(d_in, wide, self.compute_dtype))
            self.add_module("1", nn.ReLU())
            self.add_module("2", Dense(wide, n, self.compute_dtype))
        else:
            self.weight = nn.Parameter(torch.empty(n, d_in))
            self.bias = nn.Parameter(torch.zeros(n))

    @torch.no_grad()
    def init_weights(self, std: float, generator: torch.Generator) -> None:
        if self.mlp:
            init_weights(self, std, generator)
        else:
            self.weight.normal_(0.0, std, generator=generator)
            self.bias.zero_()

    def forward(self, pooled):
        if self.mlp:
            out = self._modules["2"](torch.relu(self._modules["0"](pooled)))
        else:
            dt = self.compute_dtype
            out = F.linear(pooled.to(dt), self.weight.to(dt), self.bias.to(dt))
        return out.float()


class Activation(nn.Module):
    """`ACT2FN[name]` as a module, for a reference `nn.Sequential`'s keys."""

    def __init__(self, name: str):
        super().__init__()
        self.fn = ACT2FN[name]

    def forward(self, x):
        return self.fn(x)


class MRFMRCHeads(nn.Module):
    """Masked-region feature regression, tied to the region projection, and
    masked-region tag classification (reference VLBertPreTrainingHeads,
    modeling_vlbert.py:993-1021; the JAX package's `heads.py:115-135`).

    MRF: `MRF_predictor` (dense -> GELU -> LayerNorm at `img_layer_norm_eps`)
    then the product with the region projection's weight, plus `MRF_bias`.
    flax keeps that projection's kernel as [img_dim, H] and multiplies by its
    transpose; torch's weight is already [H, img_dim], so the product takes
    it as it is, and its gradient gets both uses. MRC: `MRC_predictor`, a
    dense layer to `od_tag_size` classes. Both outputs are fp32. The keys are
    the reference's under `cls` (`MRF_predictor.0.*`, `MRF_predictor.2.*`,
    `MRC_predictor.*`, `MRF_bias`)."""

    def __init__(self, config: ModelConfig, od_tag_size: int = 1601):
        super().__init__()
        dt = compute_dtype(config)
        h = config.hidden_size
        self.MRF_predictor = nn.Sequential(
            Dense(h, h, dt), Activation("gelu"),
            LayerNorm(h, config.img_layer_norm_eps, dt))
        self.MRC_predictor = Dense(h, od_tag_size, dt)
        self.MRF_bias = nn.Parameter(torch.zeros(config.img_feature_dim))

    def mrf_mrc(self, region_hidden, img_embedding_weight):
        """region_hidden [B, R, H], the projection's [H, img_dim] weight ->
        (features [B, R, img_dim], tag scores [B, R, od_tag_size]), fp32."""
        h = self.MRF_predictor(region_hidden)
        mrf = (h @ img_embedding_weight.to(h.dtype)).float() + self.MRF_bias
        return mrf, self.MRC_predictor(region_hidden).float()
