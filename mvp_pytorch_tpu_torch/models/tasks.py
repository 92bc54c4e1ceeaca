"""Task models over the BiEncoder backbone, the JAX package's
`models/tasks.py`:
- `RetrievalModel` (:90-265): its training step and its inference methods;
- the loss helpers (:45-83): `soft_cross_entropy`,
  `instance_bce_with_logits`, `kl_div_loss`, `classification_loss`;
- the single-pair task models, each over one image-text pair through
  `BiEncoder.forward`: `ClassificationModel` (:272-294, SNLI-VE),
  `ClassificationPlusModel` (:297-343, the fusion pooled output beside the
  single-stream interaction features), `VQAModel` (:350-374, the QA head
  over the fused CLS token) and `REModel` (:381-434, region scores).

Each task model takes `(config, *, device, seed)` and has
`init_weights(generator)`; its forward returns the logits, or `(loss,
logits)` when given labels. Dropout follows the module's training mode and
draws from the `generator` the caller passes. `WREModel`, `NLVRModel`,
`CaseModel`, `MLMModel` and `RepModel` wait for later slices."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masked import cross_entropy
from .bi_encoder import BiEncoder, l2_normalize
from .config import ModelConfig
from .heads import ClassifierHead, QAPredictionHead
from .layers import (Dense, Dropout, compute_dtype, dropout_generator,
                     init_weights, resolve_device)
from .pretrain import wra_hard_loss


# ---------------------------------------------------------------------------
# loss helpers
# ---------------------------------------------------------------------------

def soft_cross_entropy(target, logits):
    """Binary soft CE (reference soft_cross_entropy): a target in [0, 1]
    becomes the [neg, pos] distribution over 2-class logits."""
    logp = F.log_softmax(logits.float(), dim=1)
    t = target.float()
    dist = torch.stack([1.0 - t, t], dim=1).reshape(t.shape[0], -1)
    return (-(dist * logp).sum(1)).mean()


def instance_bce_with_logits(logits, labels):
    """VQA's bce: the mean BCE scaled by the number of answers."""
    return F.binary_cross_entropy_with_logits(
        logits.float(), labels.float()) * labels.shape[1]


def kl_div_loss(logits, target_probs):
    """KLDivLoss(batchmean) over log_softmax(logits)."""
    return F.kl_div(F.log_softmax(logits.float(), dim=-1),
                    target_probs.float(), reduction="batchmean")


def classification_loss(cfg: ModelConfig, logits, labels, *,
                        soft_label: bool = False,
                        num_labels: Optional[int] = None):
    """MSE for one label, else soft CE, kl, bce or CE by `cfg.loss_type`."""
    n = num_labels or cfg.num_labels
    if n == 1:
        return ((logits.reshape(-1) - labels.float().reshape(-1)) ** 2).mean()
    if soft_label:
        return soft_cross_entropy(labels, logits)
    if cfg.loss_type == "kl":
        return kl_div_loss(logits, labels)
    if cfg.loss_type == "bce":
        return instance_bce_with_logits(logits, labels)
    return cross_entropy(logits.reshape(-1, n), labels.reshape(-1))


class RetrievalTrainOutput(NamedTuple):
    total_loss: torch.Tensor
    itm_logits: torch.Tensor
    retrieval_loss: torch.Tensor
    itm_loss: torch.Tensor
    itm_labels: torch.Tensor
    wra_loss: Optional[torch.Tensor] = None


class RetrievalModel(nn.Module):
    """Image-text retrieval: coarse global embeddings plus a fine ITM rerank
    (reference BiImageBertForRetrieval, modeling_vlbert.py:1598-1712). ITM
    label 1 is the true pair. Calling the model runs `train_step`."""

    def __init__(self, config: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.bert = BiEncoder(config)
        self.classifier = ClassifierHead(config, num_labels=2)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))
        self.init_weights(torch.Generator().manual_seed(seed))
        self.to(device)
        self.eval()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.bert.init_weights(generator)
        self.classifier.init_weights(self.config.initializer_range, generator)

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    def train_step(self, input_ids_a, attention_mask_a, token_type_ids_a,
                   input_ids_b, attention_mask_b, token_type_ids_b, img_feats,
                   phrase_index=None, image_index=None, *,
                   max_tag_length: int = 20, hn_mod: str = "hard",
                   no_itm: bool = False, phrase_layer: Optional[int] = None,
                   wra_phrase_width: int = 10, hn_dice=None,
                   generator: Optional[torch.Generator] = None,
                   wra_pick: Optional[int] = None) -> RetrievalTrainOutput:
        """The symmetric CLIP cross-entropy over the in-batch similarities,
        plus ITM against mined hard negatives (unless `no_itm`), plus the
        hard-mode WRA loss when `phrase_index` is given (read at fusion layer
        `phrase_layer`, or at the output).

        Dropout follows the module's training mode. Every random draw
        (dropout, sampled negatives, the slot permutation, the WRA pick)
        comes from `generator`; `hn_dice` and `wra_pick` pin the last two."""
        # the scale is clamped at 100 (CLIP's guard; the reference has none)
        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        # the WRA loss needs the hard-negative pass even under no_itm
        use_phrase = phrase_index is not None
        with dropout_generator(self, generator):
            out = self.bert(input_ids_a, attention_mask_a, token_type_ids_a,
                            input_ids_b, attention_mask_b, token_type_ids_b,
                            img_feats, max_tag_length=max_tag_length,
                            encode_hn=(not no_itm) or use_phrase,
                            hn_mod=hn_mod, logit=scale,
                            phrase_layer=phrase_layer, hn_dice=hn_dice,
                            generator=generator)
            logits_mat = out.sim_mat * scale
            labels = torch.arange(logits_mat.shape[0],
                                  device=logits_mat.device)
            retrieval_loss = (cross_entropy(logits_mat, labels)
                              + cross_entropy(logits_mat.T, labels)) / 2.0
            wra_loss = None
            if use_phrase:
                mid = phrase_layer is not None
                wra_loss = wra_hard_loss(
                    out.mid_joint if mid else out.sequence_output,
                    out.mid_hard if mid else out.hard_sequence_output,
                    phrase_index, image_index, out.hard_txt_index,
                    out.hard_img_index, generator,
                    phrase_width=wra_phrase_width,
                    img_width=img_feats.shape[1], pick=wra_pick)
            if no_itm:
                b = input_ids_a.shape[0]
                dev = logits_mat.device
                total = retrieval_loss
                if wra_loss is not None:
                    total = total + wra_loss
                return RetrievalTrainOutput(
                    total_loss=total,
                    itm_logits=torch.zeros(2 * b, 2, device=dev),
                    retrieval_loss=retrieval_loss,
                    itm_loss=torch.zeros((), device=dev),
                    itm_labels=torch.zeros(2 * b, dtype=torch.int32,
                                           device=dev),
                    wra_loss=wra_loss)
            pooled_all = self.dropout(
                torch.cat([out.pooled_output, out.hard_pooled_output], 0))
            itm_logits = self.classifier(pooled_all)
        # polarity flipped against pretraining: 1 = true pair, 0 = hard pair
        n = out.pooled_output.shape[0]
        itm_labels = torch.cat([
            torch.ones(n, dtype=torch.int32, device=itm_logits.device),
            torch.zeros(out.hard_pooled_output.shape[0], dtype=torch.int32,
                        device=itm_logits.device)])
        itm_loss = cross_entropy(itm_logits, itm_labels.long())
        total = retrieval_loss + itm_loss
        if wra_loss is not None:
            total = total + wra_loss
        return RetrievalTrainOutput(
            total_loss=total, itm_logits=itm_logits,
            retrieval_loss=retrieval_loss, itm_loss=itm_loss,
            itm_labels=itm_labels, wra_loss=wra_loss)

    def forward(self, *args, **kwargs) -> RetrievalTrainOutput:
        return self.train_step(*args, **kwargs)

    def encode(self, input_ids_a, attention_mask_a, token_type_ids_a,
               input_ids_b, attention_mask_b, token_type_ids_b, img_feats):
        """Coarse stage: global embeddings only."""
        _, global_txt = self.bert.encode_text(
            input_ids_a, attention_mask_a, token_type_ids_a)
        _, global_img = self.bert.encode_image(
            input_ids_b, attention_mask_b, token_type_ids_b, img_feats)
        return global_txt, global_img

    def score(self, input_ids_a, attention_mask_a, token_type_ids_a,
              input_ids_b, attention_mask_b, token_type_ids_b, img_feats, *,
              max_tag_length: int = 20):
        """Fine stage: full three-encoder ITM logits."""
        out = self.bert(input_ids_a, attention_mask_a, token_type_ids_a,
                        input_ids_b, attention_mask_b, token_type_ids_b,
                        img_feats, max_tag_length=max_tag_length)
        return self.classifier(out.pooled_output)

    # The cached rerank: the uni-modal halves depend on one side only, so
    # they are encoded once per caption and per image, and each candidate
    # pair runs only the fusion encoder.

    def encode_text_seq(self, input_ids_a, attention_mask_a,
                        token_type_ids_a):
        seq, _ = self.bert.encode_text(input_ids_a, attention_mask_a,
                                       token_type_ids_a)
        return seq

    def encode_text_full(self, input_ids_a, attention_mask_a,
                         token_type_ids_a):
        """(seq, global) in one encoder pass."""
        return self.bert.encode_text(input_ids_a, attention_mask_a,
                                     token_type_ids_a)

    def encode_image_seq(self, input_ids_b, attention_mask_b,
                         token_type_ids_b, img_feats, *,
                         max_tag_length: int = 20):
        """Tag-stripped vision-stream output [B, R, H] and its mask."""
        seq, _ = self.bert.encode_image(input_ids_b, attention_mask_b,
                                        token_type_ids_b, img_feats)
        return seq[:, max_tag_length:, :], attention_mask_b[:, max_tag_length:]

    def encode_image_full(self, input_ids_b, attention_mask_b,
                          token_type_ids_b, img_feats, *,
                          max_tag_length: int = 20):
        """(vis_part, vis_part_mask, global) in one encoder pass."""
        seq, glob = self.bert.encode_image(input_ids_b, attention_mask_b,
                                           token_type_ids_b, img_feats)
        return (seq[:, max_tag_length:, :],
                attention_mask_b[:, max_tag_length:], glob)

    def score_cached(self, txt_seq, attention_mask_a, vis_part,
                     vis_part_mask):
        """ITM logits from cached stream outputs: fusion encoder only."""
        _, pooled, _ = self.bert.fuse(txt_seq, attention_mask_a, vis_part,
                                      vis_part_mask)
        return self.classifier(pooled)


# ---------------------------------------------------------------------------
# the single-pair task models
# ---------------------------------------------------------------------------

class _PairModel(nn.Module):
    """The backbone, a hidden-size dropout and the head a subclass builds in
    `build_head`; seeded, moved to `device` and left in eval mode."""

    def __init__(self, config: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.bert = BiEncoder(config)
        self.build_head(config)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.init_weights(torch.Generator().manual_seed(seed))
        self.to(device)
        self.eval()

    def build_head(self, config: ModelConfig) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init: the backbone's, then normal(
        initializer_range) head kernels and zero biases."""
        self.bert.init_weights(generator)
        std = self.config.initializer_range
        for name, m in self.named_children():
            if isinstance(m, ClassifierHead):
                m.init_weights(std, generator)
            elif name != "bert":
                init_weights(m, std, generator)

    @property
    def device(self) -> torch.device:
        return self.bert.txt_proj.device


class ClassificationModel(_PairModel):
    """Pooled fusion output -> dropout -> `ClassifierHead` (reference
    BiImageBertForSequenceClassification, modeling_vlbert.py:1715-1798)."""

    def build_head(self, config):
        self.classifier = ClassifierHead(config)

    def forward(self, input_ids_a, attention_mask_a, token_type_ids_a,
                input_ids_b, attention_mask_b, token_type_ids_b, img_feats,
                labels=None, *, max_tag_length: int = 20, use_b: bool = False,
                soft_label: bool = False,
                generator: Optional[torch.Generator] = None):
        with dropout_generator(self, generator):
            out = self.bert(input_ids_a, attention_mask_a, token_type_ids_a,
                            input_ids_b, attention_mask_b, token_type_ids_b,
                            img_feats, max_tag_length=max_tag_length,
                            use_b=use_b)
            logits = self.classifier(self.dropout(out.pooled_output))
        if labels is None:
            return logits
        return classification_loss(self.config, logits, labels,
                                   soft_label=soft_label), logits


class ClassificationPlusModel(_PairModel):
    """The pooled fusion output beside `single_mapping` of the single-stream
    interaction features [u; v; v - u; u * v] of the two CLS tokens'
    global projections (reference ...Plus, modeling_vlbert.py:1975-2070).

    Keys: `single_mapping.0/.2` and `classifier.weight/bias` (linear) or
    `classifier.0/.2` (mlp). `single_mapping` and the mlp's first layer
    compute in the compute dtype; the linear classifier and the mlp's second
    layer in fp32 (flax promotes their bf16 input to the fp32 kernel's
    type)."""

    def build_head(self, config):
        h, dt = config.hidden_size, compute_dtype(config)
        self.single_mapping = nn.Sequential(
            Dense(4 * h, 2 * h, dt), nn.ReLU(), Dense(2 * h, h, dt))
        if config.classifier == "mlp":
            wide = h * config.cls_hidden_scale
            self.classifier = nn.Sequential(
                Dense(2 * h, wide, dt), nn.ReLU(),
                Dense(wide, config.num_labels, torch.float32))
        else:
            self.classifier = Dense(2 * h, config.num_labels, torch.float32)

    def forward(self, input_ids_a, attention_mask_a, token_type_ids_a,
                input_ids_b, attention_mask_b, token_type_ids_b, img_feats,
                labels=None, *, max_tag_length: int = 20,
                soft_label: bool = False,
                generator: Optional[torch.Generator] = None):
        with dropout_generator(self, generator):
            out = self.bert(input_ids_a, attention_mask_a, token_type_ids_a,
                            input_ids_b, attention_mask_b, token_type_ids_b,
                            img_feats, max_tag_length=max_tag_length)
            u = out.txt_output[:, 0].float() @ self.bert.txt_proj
            v = out.vis_output[:, 0].float() @ self.bert.vis_proj
            single = torch.cat([u, v, v - u, v * u], dim=1)
            single_h = self.single_mapping(self.dropout(single))
            pooled = self.dropout(torch.cat(
                [out.pooled_output, single_h.to(out.pooled_output.dtype)], 1))
            logits = self.classifier(pooled).float()
        if labels is None:
            return logits
        return classification_loss(self.config, logits, labels,
                                   soft_label=soft_label), logits


class _QAHeads(nn.Module):
    """The reference's `cls` module of BiImageBertForVQA."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.predictions = QAPredictionHead(config)


class VQAModel(_PairModel):
    """`QAPredictionHead` over the fused CLS token, not the pooler
    (reference BiImageBertForVQA, modeling_vlbert.py:1801-1870)."""

    def build_head(self, config):
        self.cls = _QAHeads(config)

    def forward(self, input_ids_a, attention_mask_a, token_type_ids_a,
                input_ids_b, attention_mask_b, token_type_ids_b, img_feats,
                labels=None, *, max_tag_length: int = 20,
                soft_label: bool = False,
                generator: Optional[torch.Generator] = None):
        with dropout_generator(self, generator):
            out = self.bert(input_ids_a, attention_mask_a, token_type_ids_a,
                            input_ids_b, attention_mask_b, token_type_ids_b,
                            img_feats, max_tag_length=max_tag_length)
            logits = self.cls.predictions(
                self.dropout(out.sequence_output[:, 0]))
        if labels is None:
            return logits
        return classification_loss(self.config, logits, labels,
                                   soft_label=soft_label), logits


def _region_cosine_logits(sequence_output, seq_a_length):
    vis = l2_normalize(sequence_output[:, seq_a_length:].float())
    cls = l2_normalize(sequence_output[:, 0].float())
    return torch.einsum("brh,bh->br", vis, cls)


class REModel(_PairModel):
    """Region scores of a referring expression (reference BiImageBertForRE,
    modeling_vlbert.py:1873-1971), read from the fused output or, with
    `phrase_layer`, from that fusion layer's output: mod 1 the cosine of CLS
    and each region (MSE against the IoU labels), mod 2 their dot product
    and mod 3 a one-label classifier per region (bce against hard or IoU
    labels; sigmoid scores). Labels < 0 mark padded regions. The classifier
    exists at every mod, as the JAX driver's mod-3 init makes it."""

    def build_head(self, config):
        self.classifier = ClassifierHead(config, num_labels=1)

    def forward(self, input_ids_a, attention_mask_a, token_type_ids_a,
                input_ids_b, attention_mask_b, token_type_ids_b, img_feats,
                labels=None, *, max_tag_length: int = 20, mod: int = 1,
                phrase_layer: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        if mod not in (1, 2, 3):
            raise NotImplementedError(mod)
        with dropout_generator(self, generator):
            out = self.bert(input_ids_a, attention_mask_a, token_type_ids_a,
                            input_ids_b, attention_mask_b, token_type_ids_b,
                            img_feats, max_tag_length=max_tag_length,
                            phrase_layer=phrase_layer)
            seq = self.dropout(out.sequence_output if phrase_layer is None
                               else out.mid_joint)
            la = input_ids_a.shape[1]
            if mod == 1:
                logits = _region_cosine_logits(seq, la)
            elif mod == 2:
                logits = torch.einsum("brh,bh->br", seq[:, la:].float(),
                                      seq[:, 0].float())
            else:
                logits = self.classifier(seq[:, la:])[..., 0]
        if labels is None:
            return logits if mod == 1 else torch.sigmoid(logits)
        labels = labels.float()
        w = (labels >= 0).float()
        denom = w.sum().clamp(min=1.0)
        if mod == 1:
            return (w * (logits - labels) ** 2).sum() / denom, logits
        tgt = (labels >= 0.5).float() if mod == 2 else labels
        loss = F.binary_cross_entropy_with_logits(
            logits.float(), tgt, weight=w, reduction="sum") / denom
        return loss, torch.sigmoid(logits)
