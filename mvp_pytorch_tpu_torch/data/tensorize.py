"""The tensorization contract: this package's copy of the JAX package's
`data/tensorize.py` (`TensorizeConfig`, `tensorize_example`, the pretraining
converters `convert_example_to_features` / `convert_qa_example_to_features`
and `collate`), array for array.

Parity targets:
- inference contract: `oscar/modeling/modeling_pipeline.py:130-197`
  tensorize_example — stream A `[CLS] tokens_a phrases [SEP]` padded to
  max_seq_length + max_phrases; stream B `[CLS] tags [SEP]` padded to
  max_tag_length with the attention mask extended over (padded) regions;
  phrase_index/image_index spans in fused coordinates.
- pretraining contract: `oscar/oscar_datasets_ml/oscar_tsv4.py:896-1092`
  convert_example_to_features — same layout plus masking and LM labels
  (lm_label_ids_b covers tags + max_img_seq_length region slots).

Everything returns fixed-shape numpy arrays.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .masking import random_phrases, random_visual, random_word


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


@dataclass
class PretrainExample:
    """One raw pretraining record (pre-tokenized)."""
    tokens_a: List[str]
    tokens_b: List[str]                 # object tags, wordpiece-tokenized
    img_feat: np.ndarray                # [N, img_feature_dim]
    od_tags: Sequence[str] = ()         # raw per-region tag strings
    phrase_nodes: Optional[List[int]] = None   # absolute phrase vocab ids
    phrase_mask_map: Optional[Dict[int, List[int]]] = None
    qa_ans: int = -1
    is_next: int = 0
    is_img_match: int = 0
    qa_answer_tokens: Optional[List[str]] = None  # QA-pair answer (tokenized)
    qa_is_next: int = -1                # 0 true QA pair, 1 swapped, -1 not QA
    guid: int = -1


def _truncate_seq_pair(tokens_a: List[str], tokens_b: List[str],
                       max_length: int) -> None:
    """Pop from the longer sequence until the pair fits (reference
    oscar_datasets_ml2/oscar_tsv4.py:1370-1383)."""
    while len(tokens_a) + len(tokens_b) > max_length:
        if len(tokens_a) > len(tokens_b):
            tokens_a.pop()
        else:
            tokens_b.pop()


def convert_example_to_features(example: PretrainExample, tokenizer, *,
                                cfg: TensorizeConfig = TensorizeConfig(),
                                tag2id: Optional[Dict[str, int]] = None,
                                phrase_vocab_size: int = 0,
                                rng: Optional[random.Random] = None,
                                mask_prob: float = 0.15,
                                mask_visual: bool = False,
                                visual_learning: bool = False
                                ) -> Dict[str, np.ndarray]:
    """Pretraining tensorization with masking
    (reference oscar_tsv4.py:896-1092). Differences by design:
    - deterministic rng threaded in (resumable pipeline),
    - phrase labels are dropped (-1) exactly like the reference (:961),
    - region masking (random_visual) is optional like the legacy path.

    visual_learning additionally emits the masked-region supervision the
    reference's --visual_learning dataset path produces
    (oscar_tsv4.py:343-356): `target_img_feat` (the pre-mask features,
    zero-padded like img_feat), `visual_labels` (tag class id per masked
    region, -1 elsewhere/padding) and `mask_region_id` (1 at masked
    regions, 0 elsewhere). tag2id must then map tag -> CLASS id (the raw
    tag2id.json), not wordpiece id.
    """
    rng = rng or random.Random()
    tokens_a = list(example.tokens_a)
    tokens_b = list(example.tokens_b)
    phrase_nodes = list(example.phrase_nodes or [])

    if len(tokens_b) > cfg.max_tag_length - 2:
        tokens_b = tokens_b[: cfg.max_tag_length - 2]
    if len(tokens_a) > cfg.max_seq_length - 2:
        tokens_a = tokens_a[: cfg.max_seq_length - 2]

    tokens_a, t1_label = random_word(tokens_a, tokenizer.vocab, rng,
                                     mask_prob=mask_prob)
    tokens_b, t2_label = random_word(tokens_b, tokenizer.vocab, rng,
                                     mask_prob=mask_prob)

    limit = cfg.max_phrases + cfg.max_seq_length - 2 - len(tokens_a)
    if len(phrase_nodes) >= limit:
        phrase_nodes = phrase_nodes[:limit]
    phrase_nodes, _ = random_phrases(
        phrase_nodes, t1_label, example.phrase_mask_map, tokenizer.vocab,
        len(tokenizer.vocab), phrase_vocab_size, rng, mask_prob=mask_prob)
    phrase_label = [-1] * len(phrase_nodes)   # parity: not predicted

    will_mask = mask_visual and tag2id is not None
    # copy only when random_visual will zero rows in place (a ~0.4 MB copy
    # an example); asarray still copies on a dtype mismatch, so the
    # no-mask path stays safe for non-fp32 inputs
    if will_mask:
        img_feat = np.array(example.img_feat, np.float32, copy=True)
    else:
        img_feat = np.asarray(example.img_feat, np.float32)
    target_feat = img_feat.copy() if visual_learning else None
    vis_label: List[int] = []
    vis_flags: List[int] = []
    if will_mask:
        img_feat, vis_label, vis_flags = random_visual(
            img_feat, example.od_tags, tag2id, rng, mask_prob=mask_prob)

    lm_label_ids_a = [-1] + t1_label + phrase_label + [-1]
    lm_label_ids_b = [-1] + t2_label + [-1]

    seq_tokens_a = [tokenizer.cls_token] + tokens_a
    input_ids_a = tokenizer.convert_tokens_to_ids(seq_tokens_a)
    phrase_start = len(input_ids_a)
    input_ids_a += phrase_nodes
    input_ids_a.append(tokenizer.vocab[tokenizer.sep_token])
    phrase_index = [phrase_start, phrase_start + len(phrase_nodes)]
    segment_ids_a = [cfg.seq_a_segment_id] * len(input_ids_a)
    input_mask_a = [1] * len(input_ids_a)

    seq_tokens_b = [tokenizer.cls_token] + tokens_b + [tokenizer.sep_token]
    input_ids_b = tokenizer.convert_tokens_to_ids(seq_tokens_b)
    segment_ids_b = [cfg.seq_b_segment_id] * len(input_ids_b)
    input_mask_b = [1] * len(input_ids_b)

    total_a = cfg.seq_a_total
    pad_a = total_a - len(input_ids_a)
    input_ids_a.extend([0] * pad_a)
    input_mask_a.extend([0] * pad_a)
    segment_ids_a.extend([cfg.seq_a_segment_id] * pad_a)
    lm_label_ids_a.extend([-1] * pad_a)
    pad_b = cfg.max_tag_length - len(input_ids_b)
    input_ids_b.extend([0] * pad_b)
    input_mask_b.extend([0] * pad_b)
    segment_ids_b.extend([cfg.seq_b_segment_id] * pad_b)
    lm_label_ids_b.extend([-1] * pad_b)
    assert len(input_ids_a) == total_a
    assert len(lm_label_ids_a) == total_a

    img_feat_len = min(img_feat.shape[0], cfg.max_img_seq_length)
    image_index = [total_a, total_a + img_feat_len]
    if img_feat.shape[0] > cfg.max_img_seq_length:
        img_feat = img_feat[: cfg.max_img_seq_length]
        input_mask_b += [1] * cfg.max_img_seq_length
    else:
        pad = cfg.max_img_seq_length - img_feat.shape[0]
        input_mask_b += [1] * img_feat.shape[0] + [0] * pad
        if pad:
            img_feat = np.concatenate(
                [img_feat,
                 np.zeros((pad, img_feat.shape[1]), img_feat.dtype)], 0)

    vis_label = vis_label[:cfg.max_img_seq_length]
    lm_label_ids_b += vis_label + [-1] * (cfg.max_img_seq_length - len(vis_label))

    extras = {}
    if visual_learning:
        n_img = cfg.max_img_seq_length
        if target_feat.shape[0] > n_img:
            target_feat = target_feat[:n_img]
        elif target_feat.shape[0] < n_img:
            target_feat = np.concatenate(
                [target_feat, np.zeros((n_img - target_feat.shape[0],
                                        target_feat.shape[1]),
                                       target_feat.dtype)], 0)
        vis_flags = vis_flags[:n_img]
        extras = dict(
            target_img_feat=np.asarray(target_feat, np.float32),
            visual_labels=np.asarray(
                vis_label + [-1] * (n_img - len(vis_label)), np.int32),
            mask_region_id=np.asarray(
                vis_flags + [0] * (n_img - len(vis_flags)), np.int32))

    return dict(
        **extras,
        input_ids_a=np.asarray(input_ids_a, np.int32),
        input_mask_a=np.asarray(input_mask_a, np.int32),
        segment_ids_a=np.asarray(segment_ids_a, np.int32),
        lm_label_ids_a=np.asarray(lm_label_ids_a, np.int32),
        input_ids_b=np.asarray(input_ids_b, np.int32),
        input_mask_b=np.asarray(input_mask_b, np.int32),
        segment_ids_b=np.asarray(segment_ids_b, np.int32),
        lm_label_ids_b=np.asarray(lm_label_ids_b, np.int32),
        img_feat=np.asarray(img_feat, np.float32),
        is_next=np.int32(example.is_next),
        is_img_match=np.int32(example.is_img_match),
        qa_ans=np.int32(example.qa_ans),
        qa_is_next=np.int32(example.qa_is_next),
        phrase_index=np.asarray(phrase_index, np.int32),
        image_index=np.asarray(image_index, np.int32),
    )


def convert_qa_example_to_features(example: PretrainExample, tokenizer, *,
                                   cfg: TensorizeConfig = TensorizeConfig(),
                                   tag2id: Optional[Dict[str, int]] = None,
                                   phrase_vocab_size: int = 0,
                                   rng: Optional[random.Random] = None,
                                   mask_prob: float = 0.15,
                                   mask_visual: bool = False
                                   ) -> Dict[str, np.ndarray]:
    """QA-pair tensorization (reference oscar_datasets_ml2/oscar_tsv4.py
    :1160-1366 convert_qa_example_to_features): stream A carries
    `[CLS] question phrases [SEP] answer [SEP]` with the answer tokens in
    segment 1, MLM masking over question AND answer, and `qa_is_next`
    (0 true pair / 1 swapped answer) feeding the qa_seq_relation head.
    Same fixed-shape output schema as convert_example_to_features."""
    rng = rng or random.Random()
    tokens_a = list(example.tokens_a)
    tokens_ans = list(example.qa_answer_tokens or [])
    tokens_b = list(example.tokens_b)
    phrase_nodes = list(example.phrase_nodes or [])

    if len(tokens_b) > cfg.max_tag_length - 2:
        tokens_b = tokens_b[: cfg.max_tag_length - 2]
    # [CLS], [SEP], [SEP] => budget max_seq_length - 3 for question+answer
    _truncate_seq_pair(tokens_a, tokens_ans, cfg.max_seq_length - 3)

    tokens_a, t1_label = random_word(tokens_a, tokenizer.vocab, rng,
                                     mask_prob=mask_prob)
    tokens_ans, ans_label = random_word(tokens_ans, tokenizer.vocab, rng,
                                        mask_prob=mask_prob)
    tokens_b, t2_label = random_word(tokens_b, tokenizer.vocab, rng,
                                     mask_prob=mask_prob)

    limit = (cfg.max_phrases + cfg.max_seq_length - 3
             - len(tokens_a) - len(tokens_ans))
    if len(phrase_nodes) >= limit:
        phrase_nodes = phrase_nodes[:limit]
    phrase_nodes, _ = random_phrases(
        phrase_nodes, t1_label, example.phrase_mask_map, tokenizer.vocab,
        len(tokenizer.vocab), phrase_vocab_size, rng, mask_prob=mask_prob)
    phrase_label = [-1] * len(phrase_nodes)   # parity: not predicted

    will_mask = mask_visual and tag2id is not None
    if will_mask:   # copy only when random_visual mutates (see above)
        img_feat = np.array(example.img_feat, np.float32, copy=True)
    else:
        img_feat = np.asarray(example.img_feat, np.float32)
    vis_label: List[int] = []
    if will_mask:
        img_feat, vis_label, _ = random_visual(
            img_feat, example.od_tags, tag2id, rng, mask_prob=mask_prob)

    lm_label_ids_a = ([-1] + t1_label + phrase_label + [-1]
                      + ans_label + [-1])
    lm_label_ids_b = [-1] + t2_label + [-1]

    seq_tokens_a = [tokenizer.cls_token] + tokens_a
    input_ids_a = tokenizer.convert_tokens_to_ids(seq_tokens_a)
    phrase_start = len(input_ids_a)
    input_ids_a += phrase_nodes
    phrase_index = [phrase_start, phrase_start + len(phrase_nodes)]
    input_ids_a.append(tokenizer.vocab[tokenizer.sep_token])
    segment_ids_a = [cfg.seq_a_segment_id] * len(input_ids_a)
    # answer tokens ride in segment 1; both SEPs keep segment 0
    # (reference :1275-1282)
    input_ids_a += tokenizer.convert_tokens_to_ids(tokens_ans)
    segment_ids_a += [cfg.seq_b_segment_id] * len(tokens_ans)
    input_ids_a.append(tokenizer.vocab[tokenizer.sep_token])
    segment_ids_a.append(cfg.seq_a_segment_id)
    input_mask_a = [1] * len(input_ids_a)

    seq_tokens_b = [tokenizer.cls_token] + tokens_b + [tokenizer.sep_token]
    input_ids_b = tokenizer.convert_tokens_to_ids(seq_tokens_b)
    segment_ids_b = [cfg.seq_b_segment_id] * len(input_ids_b)
    input_mask_b = [1] * len(input_ids_b)

    total_a = cfg.seq_a_total
    pad_a = total_a - len(input_ids_a)
    input_ids_a.extend([0] * pad_a)
    input_mask_a.extend([0] * pad_a)
    segment_ids_a.extend([cfg.seq_a_segment_id] * pad_a)
    lm_label_ids_a.extend([-1] * pad_a)
    pad_b = cfg.max_tag_length - len(input_ids_b)
    input_ids_b.extend([0] * pad_b)
    input_mask_b.extend([0] * pad_b)
    segment_ids_b.extend([cfg.seq_b_segment_id] * pad_b)
    lm_label_ids_b.extend([-1] * pad_b)
    assert len(input_ids_a) == total_a
    assert len(lm_label_ids_a) == total_a

    img_feat_len = min(img_feat.shape[0], cfg.max_img_seq_length)
    image_index = [total_a, total_a + img_feat_len]
    if img_feat.shape[0] > cfg.max_img_seq_length:
        img_feat = img_feat[: cfg.max_img_seq_length]
        input_mask_b += [1] * cfg.max_img_seq_length
    else:
        pad = cfg.max_img_seq_length - img_feat.shape[0]
        input_mask_b += [1] * img_feat.shape[0] + [0] * pad
        if pad:
            img_feat = np.concatenate(
                [img_feat,
                 np.zeros((pad, img_feat.shape[1]), img_feat.dtype)], 0)

    vis_label = vis_label[:cfg.max_img_seq_length]
    lm_label_ids_b += vis_label + [-1] * (cfg.max_img_seq_length - len(vis_label))

    return dict(
        input_ids_a=np.asarray(input_ids_a, np.int32),
        input_mask_a=np.asarray(input_mask_a, np.int32),
        segment_ids_a=np.asarray(segment_ids_a, np.int32),
        lm_label_ids_a=np.asarray(lm_label_ids_a, np.int32),
        input_ids_b=np.asarray(input_ids_b, np.int32),
        input_mask_b=np.asarray(input_mask_b, np.int32),
        segment_ids_b=np.asarray(segment_ids_b, np.int32),
        lm_label_ids_b=np.asarray(lm_label_ids_b, np.int32),
        img_feat=np.asarray(img_feat, np.float32),
        is_next=np.int32(example.is_next),
        is_img_match=np.int32(example.is_img_match),
        qa_ans=np.int32(example.qa_ans),
        qa_is_next=np.int32(example.qa_is_next),
        phrase_index=np.asarray(phrase_index, np.int32),
        image_index=np.asarray(image_index, np.int32),
    )

def collate(examples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of tensorized examples into a batch."""
    keys = examples[0].keys()
    return {k: np.stack([e[k] for e in examples]) for k in keys}
