"""The inference-path tensorization contract: this package's copy of the
JAX package's `data/tensorize.py` (`TensorizeConfig`, `tensorize_example`,
`collate`). The pretraining and QA converters come with the pretraining
datasets.

Parity target: `oscar/modeling/modeling_pipeline.py:130-197`
tensorize_example — stream A `[CLS] tokens_a phrases [SEP]` padded to
max_seq_length + max_phrases; stream B `[CLS] tags [SEP]` padded to
max_tag_length with the attention mask extended over (padded) regions;
phrase_index/image_index spans in fused coordinates.

Everything returns fixed-shape numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class TensorizeConfig:
    # frozen: a TensorizeConfig() instance is used as a default argument
    # in several signatures (one shared instance per process) — mutation
    # would silently change tensorization for every default-arg caller.
    # Derive variants with dataclasses.replace().
    max_seq_length: int = 35        # includes [CLS]/[SEP], excludes phrases
    max_tag_length: int = 20        # includes [CLS]/[SEP]
    max_img_seq_length: int = 50
    max_phrases: int = 5
    img_feature_dim: int = 2054
    cls_segment_id: int = 0
    pad_segment_id: int = 0
    seq_a_segment_id: int = 0
    seq_b_segment_id: int = 1

    @property
    def seq_a_total(self) -> int:
        return self.max_seq_length + self.max_phrases

    @property
    def fused_length(self) -> int:
        return self.seq_a_total + self.max_img_seq_length


def tensorize_example(tokenizer, text_a: str, img_feat: np.ndarray,
                      text_b: str = "", phrase_nodes: Optional[List[int]] = None,
                      cfg: TensorizeConfig = TensorizeConfig(),
                      text_a_tags: str = "") -> Dict[str, np.ndarray]:
    """Inference-path tensorization (no masking). Matches
    modeling_pipeline.py:130-197 field for field.

    `text_a_tags` (reference --use_b_text, run_vqa.py:308-319): tag
    wordpieces appended to stream A AFTER its [SEP] with segment id
    seq_b, clamped to the stream-A budget — the published VQA/VE recipes
    use it (reference README.md:225,241)."""
    phrase_nodes = list(phrase_nodes or [])
    tokens_a = tokenizer.tokenize(text_a)
    if len(tokens_a) > cfg.max_seq_length - 2:
        tokens_a = tokens_a[: cfg.max_seq_length - 2]
    if len(phrase_nodes) >= cfg.max_phrases + cfg.max_seq_length - 2 - len(tokens_a):
        phrase_nodes = phrase_nodes[
            : cfg.max_phrases + cfg.max_seq_length - 2 - len(tokens_a)]

    seq_tokens_a = [tokenizer.cls_token] + tokens_a
    phrase_index = [len(seq_tokens_a), len(seq_tokens_a) + len(phrase_nodes)]
    input_ids_a = (tokenizer.convert_tokens_to_ids(seq_tokens_a)
                   + phrase_nodes
                   + [tokenizer.vocab[tokenizer.sep_token]])
    segment_ids_a = ([cfg.cls_segment_id]
                     + [cfg.seq_a_segment_id] * (len(tokens_a) + len(phrase_nodes) + 1))
    input_mask_a = [1] * len(input_ids_a)

    if text_a_tags:
        add_b = tokenizer.tokenize(text_a_tags)
        budget = cfg.seq_a_total - len(input_ids_a)
        add_b = add_b[:max(budget, 0)]
        input_ids_a += tokenizer.convert_tokens_to_ids(add_b)
        input_mask_a += [1] * len(add_b)
        segment_ids_a += [cfg.seq_b_segment_id] * len(add_b)

    tokens_b = tokenizer.tokenize(text_b) if text_b else []
    if len(tokens_b) > cfg.max_tag_length - 2:
        tokens_b = tokens_b[: cfg.max_tag_length - 2]
    seq_tokens_b = [tokenizer.cls_token] + tokens_b + [tokenizer.sep_token]
    input_ids_b = tokenizer.convert_tokens_to_ids(seq_tokens_b)
    segment_ids_b = [cfg.seq_b_segment_id] * len(seq_tokens_b)
    input_mask_b = [1] * len(input_ids_b)

    pad_a = cfg.seq_a_total - len(input_ids_a)
    input_ids_a += [0] * pad_a
    input_mask_a += [0] * pad_a
    segment_ids_a += [cfg.pad_segment_id] * pad_a

    pad_b = cfg.max_tag_length - len(input_ids_b)
    input_ids_b += [0] * pad_b
    input_mask_b += [0] * pad_b
    segment_ids_b += [cfg.pad_segment_id] * pad_b

    img_len = img_feat.shape[0]
    if img_len > cfg.max_img_seq_length:
        img_feat = img_feat[: cfg.max_img_seq_length]
        img_len = cfg.max_img_seq_length
        input_mask_b += [1] * cfg.max_img_seq_length
    else:
        pad_img = cfg.max_img_seq_length - img_len
        img_feat = np.concatenate(
            [img_feat, np.zeros((pad_img, img_feat.shape[1]), img_feat.dtype)], 0)
        input_mask_b += [1] * img_len + [0] * pad_img
    image_index = [cfg.seq_a_total, cfg.seq_a_total + img_len]

    return dict(
        input_ids_a=np.asarray(input_ids_a, np.int32),
        input_mask_a=np.asarray(input_mask_a, np.int32),
        segment_ids_a=np.asarray(segment_ids_a, np.int32),
        input_ids_b=np.asarray(input_ids_b, np.int32),
        input_mask_b=np.asarray(input_mask_b, np.int32),
        segment_ids_b=np.asarray(segment_ids_b, np.int32),
        img_feat=np.asarray(img_feat, np.float32),
        phrase_index=np.asarray(phrase_index, np.int32),
        image_index=np.asarray(image_index, np.int32),
    )


def collate(examples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of tensorized examples into a batch."""
    keys = examples[0].keys()
    return {k: np.stack([e[k] for e in examples]) for k in keys}
