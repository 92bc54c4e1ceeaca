"""Task models over the BiEncoder backbone. This slice carries
`RetrievalModel` (the JAX package's `models/tasks.py:90-265`): its training
step and its inference methods. The other task models wait for later
slices."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..ops.masked import cross_entropy
from .bi_encoder import BiEncoder
from .config import ModelConfig
from .heads import ClassifierHead
from .layers import Dropout, dropout_generator, resolve_device
from .pretrain import wra_hard_loss


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
