"""Task models over the BiEncoder backbone. This slice carries the inference
methods of `RetrievalModel` (the JAX package's `models/tasks.py:99-265`);
`train_step` waits for the training slice."""

from __future__ import annotations

import math

import torch
from torch import nn

from .bi_encoder import BiEncoder
from .config import ModelConfig
from .heads import ClassifierHead


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Asking for CUDA where there is none raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return device


class RetrievalModel(nn.Module):
    """Image-text retrieval: coarse global embeddings plus a fine ITM rerank
    (reference BiImageBertForRetrieval, modeling_vlbert.py:1598-1712). ITM
    label 1 is the true pair."""

    def __init__(self, config: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.bert = BiEncoder(config)
        self.classifier = ClassifierHead(config, num_labels=2)
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
