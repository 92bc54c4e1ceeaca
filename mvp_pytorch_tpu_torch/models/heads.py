"""Prediction heads, the JAX package's `models/heads.py`: the classifier,
the pretraining heads (`PredictionHeadTransform`, the tied
`LMPredictionHead`, `SeqRelationshipHead`) and VQA's untied
`QAPredictionHead`. `MRFMRCHeads` comes with the model that uses it."""

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
    word embedding table, plus a bias; fp32 logits (reference
    BertLMPredictionHead(only_vocab=True), modeling_bert.py:492-516).

    The decoder is the table itself, passed in at call time, so phrase rows
    are never predicted and nothing needs re-tying after a load. The
    reference's state dict stores the tie as `decoder.weight`, a copy of
    those rows; `BiPretrainModel.load_state_dict` checks and drops it."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.n = config.only_word_size
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
    (an nn.Linear there), `0.*` and `2.*` for the MLP (an nn.Sequential)."""

    def __init__(self, config: ModelConfig, num_labels: Optional[int] = None):
        super().__init__()
        self.compute_dtype = compute_dtype(config)
        n = num_labels if num_labels is not None else config.num_labels
        h = config.hidden_size
        self.mlp = config.classifier == "mlp"
        if self.mlp:
            wide = h * config.cls_hidden_scale
            self.add_module("0", Dense(h, wide, self.compute_dtype))
            self.add_module("1", nn.ReLU())
            self.add_module("2", Dense(wide, n, self.compute_dtype))
        else:
            self.weight = nn.Parameter(torch.empty(n, h))
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
