"""Task models over the BiEncoder backbone, the JAX package's
`models/tasks.py`:
- `RetrievalModel` (:90-265): its training step and its inference methods;
- the loss helpers (:45-83): `soft_cross_entropy`,
  `instance_bce_with_logits`, `kl_div_loss`, `classification_loss`;
- the single-pair task models, each over one image-text pair through
  `BiEncoder.forward`: `ClassificationModel` (:272-294, SNLI-VE),
  `ClassificationPlusModel` (:297-343, the fusion pooled output beside the
  single-stream interaction features), `VQAModel` (:350-374, the QA head
  over the fused CLS token), `REModel` (:381-434, region scores),
  `WREModel` (:437-484, weakly supervised RE) and `CaseModel` (:517-546,
  phrase-region similarity matrices);
- `NLVRModel` (:487-514): one statement and two images through
  `BiEncoder.forward_joint`;
- the serving pipeline's two modes: `MLMModel` (:549-573, masked-token
  scores) and `RepModel` (:576-593, the backbone's outputs).

Each task model takes `(config, *, device, seed)` and has
`init_weights(generator)`; a classifier's forward returns the logits, or
`(loss, logits)` when given labels. Dropout follows the module's training
mode and draws from the `generator` the caller passes."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masked import cross_entropy, gather_span
from ..parallel.collectives import LOCAL, GlobalBatch
from .bi_encoder import BiEncoder, l2_normalize
from .config import ModelConfig
from .heads import ClassifierHead, LMPredictionHead, QAPredictionHead
from .layers import (Dense, Dropout, compute_dtype, dropout_generator,
                     init_weights, resolve_device)
from .pretrain import drop_tied_decoders, wra_hard_loss, wra_sample_loss


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
                   wra_pick: Optional[int] = None,
                   global_batch: GlobalBatch = LOCAL
                   ) -> RetrievalTrainOutput:
        """The symmetric CLIP cross-entropy over the in-batch similarities,
        plus ITM against mined hard negatives (unless `no_itm`), plus the
        hard-mode WRA loss when `phrase_index` is given (read at fusion layer
        `phrase_layer`, or at the output).

        Dropout follows the module's training mode. Every random draw
        (dropout, sampled negatives, the slot permutation, the WRA pick)
        comes from `generator`; `hn_dice` and `wra_pick` pin the last two.
        A data-parallel step's `global_batch` makes the CLIP matrix, the
        hard negatives and WRA span its global batch."""
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
                            generator=generator, global_batch=global_batch)
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
                    img_width=img_feats.shape[1], pick=wra_pick,
                    global_batch=global_batch)
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

    def encode_text_only(self, input_ids_a, attention_mask_a,
                         token_type_ids_a):
        """The caption's global embedding [B, H] (fp32)."""
        _, glob = self.bert.encode_text(input_ids_a, attention_mask_a,
                                        token_type_ids_a)
        return glob

    def encode_image_only(self, input_ids_b, attention_mask_b,
                          token_type_ids_b, img_feats):
        """The image's global embedding [B, H] (fp32)."""
        _, glob = self.bert.encode_image(input_ids_b, attention_mask_b,
                                         token_type_ids_b, img_feats)
        return glob

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
        """The model's head modules; none for a backbone-only model."""

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


class WREModel(_PairModel):
    """Weakly supervised RE (reference BiImageBertForWRE,
    modeling_vlbert.py:2073-2164): the region cosine scores of REModel mod 1
    and a phrase-region margin loss. Mod 1 takes the margin between the
    hard pair's and the true pair's best region cosine, padded regions
    excluded; mod 2 is the hard-mode WRA loss, mod 3 the sample-mode one.
    Only mods 1 and 2 run the hard-negative fusion pass. Returns (loss,
    logits [B, R]). `hn_dice`, `wra_pick` and `wra_neg_offset` pin the slot
    permutation, the WRA top-3 pick and the sample-mode negative."""

    def forward(self, input_ids_a, attention_mask_a, token_type_ids_a,
                input_ids_b, attention_mask_b, token_type_ids_b, img_feats,
                phrase_index=None, img_index=None, *,
                max_tag_length: int = 20, mod: int = 1,
                wra_phrase_width: int = 10, hn_dice=None,
                wra_pick: Optional[int] = None,
                wra_neg_offset: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        if mod not in (1, 2, 3):
            raise NotImplementedError(mod)
        with dropout_generator(self, generator):
            out = self.bert(input_ids_a, attention_mask_a, token_type_ids_a,
                            input_ids_b, attention_mask_b, token_type_ids_b,
                            img_feats, max_tag_length=max_tag_length,
                            encode_hn=mod in (1, 2), hn_dice=hn_dice,
                            generator=generator)
            la = input_ids_a.shape[1]
            logits = _region_cosine_logits(out.sequence_output, la)
            r = img_feats.shape[1]
            if mod == 1:
                # padded region slots still get cosine scores (they are
                # masked as keys, not as queries): keep them out of the max
                pad_bias = torch.where(attention_mask_b[:, max_tag_length:]
                                       > 0, 0.0, -1e9)
                hard = _region_cosine_logits(out.hard_sequence_output, la)
                loss = torch.clamp(
                    (hard + pad_bias[out.hard_img_index]).max(1).values
                    + 0.2 - (logits + pad_bias).max(1).values, min=0.0
                ).mean()
            elif mod == 2:
                loss = wra_hard_loss(
                    out.sequence_output, out.hard_sequence_output,
                    phrase_index, img_index, out.hard_txt_index,
                    out.hard_img_index, generator,
                    phrase_width=wra_phrase_width, img_width=r,
                    pick=wra_pick)
            else:
                loss = wra_sample_loss(
                    out.sequence_output, phrase_index, img_index, generator,
                    phrase_width=wra_phrase_width, img_width=r,
                    pick=wra_pick, neg_offset=wra_neg_offset)
        return loss, logits


class CaseModel(_PairModel):
    """Phrase-region similarity matrices for case studies (reference
    BiBertImgForCase, modeling_vlbert.py:2247-2388), read from the fused
    output or, with `phrase_layer`, from that fusion layer's output.
    Returns (sims [B, P, R] fp32 cosines, phrase_valid [B, P],
    region_valid [B, R])."""

    def forward(self, input_ids_a, attention_mask_a, token_type_ids_a,
                input_ids_b, attention_mask_b, token_type_ids_b, img_feats,
                phrase_index, image_index, *, max_tag_length: int = 20,
                phrase_width: int = 10, phrase_layer: Optional[int] = None):
        out = self.bert(input_ids_a, attention_mask_a, token_type_ids_a,
                        input_ids_b, attention_mask_b, token_type_ids_b,
                        img_feats, max_tag_length=max_tag_length,
                        phrase_layer=phrase_layer)
        seq = out.sequence_output if phrase_layer is None else out.mid_joint
        ph, ph_valid = gather_span(seq, phrase_index, phrase_width)
        im, im_valid = gather_span(seq, image_index, img_feats.shape[1])
        sims = torch.einsum("bph,brh->bpr", l2_normalize(ph.float()),
                            l2_normalize(im.float()))
        return sims, ph_valid, im_valid


class NLVRModel(_PairModel):
    """NLVR2: one statement and two images through `BiEncoder.forward_joint`
    (reference forward_joint, modeling_vlbert.py:725-869), then dropout and
    a two-label `ClassifierHead` over the pooled output. Returns the logits,
    or (cross entropy, logits) when given labels."""

    def build_head(self, config):
        self.classifier = ClassifierHead(config, num_labels=2)

    def forward(self, input_ids_a, attention_mask_a, token_type_ids_a,
                input_ids_b, attention_mask_b, token_type_ids_b, img_feats,
                input_ids_b2, attention_mask_b2, token_type_ids_b2,
                img_feats2, labels=None, *, max_tag_length: int = 20,
                generator: Optional[torch.Generator] = None):
        with dropout_generator(self, generator):
            _, pooled = self.bert.forward_joint(
                input_ids_a, attention_mask_a, token_type_ids_a,
                input_ids_b, attention_mask_b, token_type_ids_b, img_feats,
                input_ids_b2, attention_mask_b2, token_type_ids_b2,
                img_feats2, max_tag_length=max_tag_length)
            logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        return cross_entropy(logits, labels.long()), logits


# ---------------------------------------------------------------------------
# the serving pipeline's two modes
# ---------------------------------------------------------------------------

class _MLMHeads(nn.Module):
    """The reference's `cls` module of BiBertImgForMLM: the text MLM head."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.predictions = LMPredictionHead(config)


class MLMModel(_PairModel):
    """Masked-token scores over the stream-A positions of the fused output
    (reference BiBertImgForMLM, modeling_vlbert.py:2559-2645): the tied
    `LMPredictionHead` over the first `only_word_size` rows of the table,
    fp32 `[B, La, only_word_size]`. The caller picks the [MASK] positions.
    Keys: `bert.*`, `cls.predictions.*`; a reference state dict's tied
    `cls.predictions.decoder.weight` is checked against the table and
    dropped on load."""

    TIED_DECODERS = ("cls.predictions.decoder.weight",)

    def build_head(self, config):
        self.cls = _MLMHeads(config)

    def forward(self, input_ids_a, attention_mask_a, token_type_ids_a,
                input_ids_b, attention_mask_b, token_type_ids_b, img_feats, *,
                max_tag_length: int = 20):
        out = self.bert(input_ids_a, attention_mask_a, token_type_ids_a,
                        input_ids_b, attention_mask_b, token_type_ids_b,
                        img_feats, max_tag_length=max_tag_length)
        la = input_ids_a.shape[1]
        return self.cls.predictions(out.sequence_output[:, :la],
                                    self.bert.word_table())

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        state_dict = drop_tied_decoders(state_dict, self.TIED_DECODERS,
                                        self.config.only_word_size)
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)


class RepModel(_PairModel):
    """The backbone's outputs for one pair (reference BiImageBertRep,
    modeling_vlbert.py:2509-2557), under the JAX package's names:
    `cross_modal_output` [B, La+R, H], `pooled_output` [B, H],
    `txt_encoder_output` [B, La, H] and `vis_encoder_output` [B, T+R, H]."""

    def forward(self, input_ids_a, attention_mask_a, token_type_ids_a,
                input_ids_b, attention_mask_b, token_type_ids_b, img_feats, *,
                max_tag_length: int = 20):
        out = self.bert(input_ids_a, attention_mask_a, token_type_ids_a,
                        input_ids_b, attention_mask_b, token_type_ids_b,
                        img_feats, max_tag_length=max_tag_length)
        return dict(cross_modal_output=out.sequence_output,
                    pooled_output=out.pooled_output,
                    txt_encoder_output=out.txt_output,
                    vis_encoder_output=out.vis_output)
