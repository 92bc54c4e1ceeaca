"""The datasets over the TSV feature-store contract: this package's copy of
the JAX package's `data/datasets.py` parts that retrieval, pretraining
(with its extra uni-modal streams), VQA, SNLI-VE and referring expressions
read (`load_phrase_vocab`, `tags_for_text_a`, `phrases_to_ids`,
`FeatureStore`, `GeneralDataset`, `RetrievalDataset`, `PretrainDataset`,
`MultiCorpusPretrainDataset`, `ImgOnlyDataset`, `TextOnlyDataset`,
`VE_LABELS`, `VQADataset`, `VEDataset`, `compute_iou`, `REDataset`,
`re_score`, `re_score_det1`, `re_score_det2`). The other datasets come with
their tasks.

Parity targets:
- feature store: `predictions.tsv` rows = [image_id, json{"feature":
  base64(float32 [N, 2054]), "predictions": [tags...]}] + `imageid2idx.json`
  (reference `tools/img_feat_extract.py:15-42,96-115`,
  `oscar/datasets/general_dataset.py:157-166`).
- GeneralDataset <- `oscar/datasets/general_dataset.py:24` (MVPTRDataset):
  custom-data fine-tuning records {image_id, text, phrases}.
- RetrievalDataset <- `oscar/run_retrieval.py:24-296`: per-image caption
  lists, phrase lookup, train positives, eval enumeration.
- PretrainDataset <- `oscar/oscar_datasets_ml/oscar_tsv4.py:22-377`:
  caption+tags+features corpus with masking at fetch time, keyed on
  (seed, epoch, index); MultiCorpusPretrainDataset puts several behind one
  index space (:25-99); ImgOnlyDataset / TextOnlyDataset are the extra
  uni-modal streams (oscar_tsv.py:914-1240).
- VQADataset <- `oscar/run_vqa.py:86-330`: questions + soft answer scores.
- VEDataset  <- `oscar/run_ve.py:46-280`: SNLI-VE jsonl, 3-way labels,
  hypothesis masking in training keyed on (seed, epoch, index).
- REDataset  <- `oscar/run_re.py:46-186`: expressions + per-region IoU
  labels, external detections; `re_score*` score them (:389-421).

The arrays keep the JAX package's names (`input_mask_a`, `segment_ids_a`,
`img_feat`, ...); the tasks map them onto the model's.
"""

from __future__ import annotations

import base64
import json
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import native as _native
from .tensorize import (PretrainExample, TensorizeConfig, collate,
                        convert_example_to_features,
                        convert_qa_example_to_features, tensorize_example)
from .tsv import TSVFile

VE_LABELS = {"contradiction": 0, "neutral": 1, "entailment": 2}


def load_phrase_vocab(id2phrase_path: str) -> Dict[tuple, int]:
    """{tuple(phrase words) -> absolute vocab id} (reference run_retrieval.py:93)."""
    with open(id2phrase_path) as f:
        id2phrase = json.load(f)
    return {tuple(v): int(k) for k, v in id2phrase.items()}


def tags_for_text_a(tags: Sequence[str], use_b_text: bool,
                    b_as_list: bool) -> str:
    """Tag string appended to stream A when use_b_text (reference
    run_vqa.py get_od_labels:443-453 + :308-319): b_as_list keeps
    duplicates, otherwise tags are deduplicated (first occurrence kept —
    the reference's list(set(...)) dedup, made order-deterministic)."""
    if not use_b_text:
        return ""
    if b_as_list:
        return " ".join(tags)
    return " ".join(dict.fromkeys(tags))


def phrases_to_ids(phrases: Sequence[Sequence[str]],
                   sg2id: Optional[Dict[tuple, int]]) -> List[int]:
    if not sg2id:
        return []
    out = []
    for t in phrases:
        t = tuple(t)
        if t in sg2id:
            out.append(sg2id[t])
    return out


class FeatureStore:
    """predictions.tsv + imageid2idx.json random-access region features."""

    def __init__(self, feature_tsv: str, imageid2idx: Optional[str] = None,
                 feature_dim: int = 2054):
        self.tsv = TSVFile(feature_tsv)
        self.feature_dim = feature_dim
        if imageid2idx is None:
            imageid2idx = os.path.join(os.path.dirname(feature_tsv),
                                       "imageid2idx.json")
        with open(imageid2idx) as f:
            self.id2idx = json.load(f)

    def __contains__(self, image_id) -> bool:
        return str(image_id) in self.id2idx

    def keys(self) -> List[str]:
        return list(self.id2idx.keys())

    def get(self, image_id) -> Tuple[np.ndarray, List[str]]:
        # Corpus-scale hot path (r5 ingest rehearsal profile: 5.9 ms/ex on
        # realistic ~0.5 MB rows, 46% binascii decode + 19% readline + 15%
        # bytes.split). Three fixes, each with a permissive fallback:
        #   1. seek_raw: ONE exact-extent pread of the line (the .lineidx
        #      bounds it) — no newline scan, no buffered-chunk reassembly,
        #      and no utf-8 decode (json.loads/b64decode take bytes);
        #   2. the ~0.5 MB base64 "feature" value is located by offset
        #      arithmetic on the line buffer (base64 has no '"' or '\', so
        #      quote-find is exact) and NEVER copied by split()/slicing;
        #      only the small remainder is json-parsed — json.loads spends
        #      ~1 ms/row character-scanning the value otherwise;
        #   3. the native 4-LUT kernel (fastdata.cpp b64_decode_at) decodes
        #      the span straight into the output float buffer at multi-GB/s
        #      vs binascii's ~200 MB/s. (An earlier ctypes b64 wrapper was
        #      retired as slower than binascii; its cost was the string
        #      round-trips this zero-copy call avoids.)
        raw = self.tsv.seek_raw(self.id2idx[str(image_id)])
        rec = span = None
        try:
            t = raw.index(b"\t")
            k = raw.find(b'"feature"', t)
            while k >= 0:
                # must be the KEY: a literal tag string "feature" inside
                # the predictions array would otherwise slice a wrong span
                j = k + 9
                while raw[j:j + 1] in (b" ", b"\t"):
                    j += 1
                if raw[j:j + 1] == b":":
                    break
                k = raw.find(b'"feature"', k + 1)
            if k >= 0:
                q1 = raw.index(b'"', j + 1)     # opening quote of the value
                q2 = raw.index(b'"', q1 + 1)
                if raw.find(b"\\", q1, q2) < 0:
                    rec = json.loads(raw[t + 1:q1 + 1] + raw[q2:])
                    # exact top-level discriminator: excising the TOP-LEVEL
                    # value leaves rec["feature"] == ""; a NESTED "feature"
                    # key found first (whose base64 could even decode to a
                    # plausible shape) leaves the top-level value intact —
                    # fall back to the full parse instead of silently
                    # decoding the wrong span
                    if rec.get("feature") == "":
                        span = (q1 + 1, q2)
                    else:
                        rec = None
        except ValueError:   # sliced a wrong span: remainder is not json
            rec = span = None
        feats = None
        if span is not None:
            try:
                n64 = span[1] - span[0]
                if _native.available():
                    out = np.empty(n64 // 4 * 3 + 4, dtype=np.uint8)
                    n = _native.b64_decode_at(raw, span[0], n64, out)
                    if n > 0 and n % 4 == 0:
                        feats = out[:n].view(np.float32).reshape(
                            -1, self.feature_dim)
                if feats is None:
                    blob = base64.b64decode(raw[span[0]:span[1]])
                    feats = np.frombuffer(blob, dtype=np.float32).reshape(
                        -1, self.feature_dim).copy()
            except ValueError:
                # span verified top-level, so a decode/reshape failure
                # means the value itself is off-contract — let the full
                # parse own the error semantics (it re-raises the same
                # error below, so corruption stays loud)
                rec, feats = None, None
        if rec is None:
            rec = json.loads(raw.split(b"\t", 1)[1])
        if feats is None:
            blob = base64.b64decode(rec["feature"])
            feats = np.frombuffer(blob, dtype=np.float32).reshape(
                -1, self.feature_dim).copy()
        return feats, list(rec.get("predictions", []))


class GeneralDataset:
    """Custom-data records: [{"image_id", "text", "phrases", ("label")}]
    (reference `oscar/datasets/general_dataset.py:24`, MVPTRDataset). No
    command line reads it."""

    def __init__(self, data_json: str, features: FeatureStore, tokenizer,
                 sg2id: Optional[Dict[tuple, int]] = None,
                 cfg: TensorizeConfig = TensorizeConfig()):
        with open(data_json) as f:
            self.data = json.load(f)
        self.features = features
        self.tokenizer = tokenizer
        self.sg2id = sg2id
        self.cfg = cfg

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        item = self.data[index]
        feats, tags = self.features.get(item["image_id"])
        ex = tensorize_example(
            self.tokenizer, item["text"], feats, " ".join(tags),
            phrases_to_ids(item.get("phrases", []), self.sg2id), self.cfg)
        if "label" in item:
            ex["label"] = np.int32(item["label"])
        return ex

    def fetch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        return collate([self[int(i)] for i in indices])


class RetrievalDataset:
    """Image-caption pairs for training + eval enumeration.

    captions_json: {image_id: [{"text": ..., "phrases": [...]}, ...]} with a
    fixed number of captions per image.
    """

    def __init__(self, captions_json: str, features: FeatureStore, tokenizer,
                 sg2id: Optional[Dict[tuple, int]] = None,
                 cfg: TensorizeConfig = TensorizeConfig(),
                 num_captions_per_img: int = 5,
                 img_keys_file: Optional[str] = None):
        with open(captions_json) as f:
            caps = json.load(f)
        self.img_keys = sorted(caps.keys())
        if img_keys_file:
            # restrict eval to a key subset (reference --eval_img_keys_file,
            # run_retrieval.py:107-112 — tsv, one image key per line)
            with open(img_keys_file) as f:
                keep = {ln.strip().split("\t")[0] for ln in f if ln.strip()}
            self.img_keys = [k for k in self.img_keys if k in keep]
            if not self.img_keys:
                raise ValueError(f"no overlap with keys in {img_keys_file}")
        self.captions = caps
        self.features = features
        self.tokenizer = tokenizer
        self.sg2id = sg2id
        self.cfg = cfg
        self.num_captions_per_img = num_captions_per_img
        for k in self.img_keys:
            if len(caps[k]) < num_captions_per_img:
                raise ValueError(f"image {k} has {len(caps[k])} captions, "
                                 f"fewer than {num_captions_per_img}")

    # --- train: one positive pair per index (reference :319-377) ---
    def __len__(self):
        return len(self.img_keys) * self.num_captions_per_img

    def _cap(self, cap_global_idx: int):
        img_i, cap_i = divmod(cap_global_idx, self.num_captions_per_img)
        key = self.img_keys[img_i]
        return key, self.captions[key][cap_i]

    def example(self, cap_global_idx: int,
                img_key: Optional[str] = None) -> Dict[str, np.ndarray]:
        key, cap = self._cap(cap_global_idx)
        if img_key is None:
            img_key = key
        feats, tags = self.features.get(img_key)
        return tensorize_example(
            self.tokenizer, cap["text"], feats, " ".join(tags),
            phrases_to_ids(cap.get("phrases", []), self.sg2id), self.cfg)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.example(index)

    def fetch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        return collate([self[int(i)] for i in indices])

    # --- eval enumeration: captions-only / images-only batches ---
    def caption_arrays(self) -> Dict[str, np.ndarray]:
        # text-stream arrays only: tensorize against a zero-region dummy
        # instead of example(i) — fetching real features here would do one
        # TSV seek + ~0.5 MB base64 decode PER CAPTION only to discard
        # every *_b output (5x image_arrays' total feature I/O for nothing)
        dummy = np.zeros((1, self.cfg.img_feature_dim), np.float32)
        exs = []
        for i in range(len(self)):
            _, cap = self._cap(i)
            exs.append(tensorize_example(
                self.tokenizer, cap["text"], dummy, "",
                phrases_to_ids(cap.get("phrases", []), self.sg2id),
                self.cfg))
        batch = collate(exs)
        return {k: batch[k] for k in
                ("input_ids_a", "input_mask_a", "segment_ids_a")}

    def image_arrays(self) -> Dict[str, np.ndarray]:
        exs = []
        for key in self.img_keys:
            feats, tags = self.features.get(key)
            exs.append(tensorize_example(self.tokenizer, "", feats,
                                         " ".join(tags), [], self.cfg))
        batch = collate(exs)
        return {k: batch[k] for k in
                ("input_ids_b", "input_mask_b", "segment_ids_b", "img_feat")}


class PretrainDataset:
    """Corpus TSV rows: [image_id, caption, json phrases(optional),
    qa_answer_id(optional), qa_answer_text(optional)] + FeatureStore
    regions/tags. Masking happens at fetch time with a per-(seed, index,
    epoch) rng for determinism.

    QA-contrastive support (reference oscar_datasets_ml2/oscar_tsv4.py):
    rows with a non-empty 5th column are QA pairs (caption = question,
    col 5 = answer text). With `qa_pairs=True`, each QA row keeps its true
    answer with prob 0.5 (qa_is_next=0) or swaps in a random answer from
    the QA pool (qa_is_next=1; reference get_random_qa :539-557); non-QA
    rows emit qa_is_next=-1 (ignored by the loss). `only_qa`/`only_cap`
    filter the corpus (:145-147); `exclude_ids` drops rows whose image id
    is in the set (the Flickr test-id exclusion, :154-162)."""

    def __init__(self, corpus_tsv: str, features: FeatureStore, tokenizer,
                 sg2id: Optional[Dict[tuple, int]] = None,
                 cfg: TensorizeConfig = TensorizeConfig(),
                 tag2id: Optional[Dict[str, int]] = None,
                 phrase_vocab_size: int = 0, seed: int = 0,
                 mask_prob: float = 0.15, mask_visual: bool = True,
                 qa_pairs: bool = False, only_qa: bool = False,
                 only_cap: bool = False,
                 exclude_ids: Optional[set] = None,
                 gt_labels_json: Optional[str] = None,
                 visual_learning: bool = False,
                 restrict_to_features: bool = False):
        # use_gtlabels (reference oscar_tsv4.py:201-207): when a
        # ground-truth label map {image_id: [class, ...]} is provided,
        # its (deduplicated) classes replace the predicted tags
        self.gt_labels = None
        if gt_labels_json:
            with open(gt_labels_json) as f:
                self.gt_labels = json.load(f)
        self.tsv = TSVFile(corpus_tsv)
        self.features = features
        self.tokenizer = tokenizer
        self.sg2id = sg2id
        self.cfg = cfg
        self.tag2id = tag2id or {}
        self.phrase_vocab_size = phrase_vocab_size
        self.seed = seed
        self.mask_prob = mask_prob
        self.mask_visual = mask_visual
        # emit masked-region supervision (reference --visual_learning,
        # oscar_tsv4.py:343-356); tag2id must then be the raw class map
        self.visual_learning = visual_learning
        self.epoch = 0
        self.qa_pairs = qa_pairs
        self._index: Optional[List[int]] = None   # row filter (None = all)
        self._qa_answers: List[str] = []          # negative-sampling pool
        if (qa_pairs or only_qa or only_cap or exclude_ids
                or restrict_to_features):
            assert not (only_qa and only_cap)
            keep, n_excluded = [], 0
            for i in range(len(self.tsv)):
                row = self.tsv.seek(i)
                is_qa = len(row) > 4 and bool(row[4])
                if exclude_ids and row[0] in exclude_ids:
                    n_excluded += 1
                    continue
                if (only_qa and not is_qa) or (only_cap and is_qa):
                    continue
                # chunked feature TSVs: each chunk's dataset keeps only
                # the corpus rows whose image lives in that chunk (the
                # reference's datasets_with_splits role, oscar_tsv4.py:
                # 44-45,96-100) — without this, N chunks over one corpus
                # would duplicate every caption N times and KeyError on
                # images from other chunks
                if restrict_to_features and row[0] not in self.features:
                    continue
                keep.append(i)
                if is_qa:
                    self._qa_answers.append(row[4])
            self._index = keep
            self.n_excluded = n_excluded

    def __len__(self):
        return len(self._index) if self._index is not None else len(self.tsv)

    def __getitem__(self, index: int,
                    epoch: Optional[int] = None) -> Dict[str, np.ndarray]:
        ep = self.epoch if epoch is None else epoch
        row_id = self._index[index] if self._index is not None else index
        row = self.tsv.seek(row_id)
        image_id, caption = row[0], row[1]
        phrases = json.loads(row[2]) if len(row) > 2 and row[2] else []
        qa_ans = int(row[3]) if len(row) > 3 and row[3] else -1
        qa_answer_text = row[4] if len(row) > 4 and row[4] else None
        feats, tags = self.features.get(image_id)
        # gt labels feed ONLY the tag text stream (tokens_b); od_tags must
        # stay the predicted PER-REGION list — random_visual labels masked
        # region i with tag2id[od_tags[i]], so substituting a deduped
        # class list would mislabel the masked-region objective
        text_b_tags = tags
        if self.gt_labels is not None and image_id in self.gt_labels:
            text_b_tags = list(dict.fromkeys(self.gt_labels[image_id]))
        tokens_a = self.tokenizer.tokenize(caption)
        tokens_b = self.tokenizer.tokenize(" ".join(text_b_tags))
        rng = random.Random(f"{self.seed}:{ep}:{index}")

        if self.qa_pairs and qa_answer_text is not None:
            # 50/50 true pair vs random-answer swap (reference random_sent
            # QA branch, oscar_tsv4.py:428-440)
            qa_is_next = 0
            if rng.random() > 0.5 and len(self._qa_answers) > 1:
                swapped = self._qa_answers[
                    rng.randrange(len(self._qa_answers))]
                if swapped != qa_answer_text:
                    qa_answer_text = swapped
                    qa_is_next = 1
            ex = PretrainExample(
                tokens_a=tokens_a, tokens_b=tokens_b, img_feat=feats,
                od_tags=[t.lower() for t in tags],
                phrase_nodes=phrases_to_ids(phrases, self.sg2id),
                qa_ans=qa_ans,
                qa_answer_tokens=self.tokenizer.tokenize(qa_answer_text),
                qa_is_next=qa_is_next, guid=row_id)
            return convert_qa_example_to_features(
                ex, self.tokenizer, cfg=self.cfg, tag2id=self.tag2id,
                phrase_vocab_size=self.phrase_vocab_size, rng=rng,
                mask_prob=self.mask_prob, mask_visual=self.mask_visual)

        ex = PretrainExample(
            tokens_a=tokens_a, tokens_b=tokens_b, img_feat=feats,
            od_tags=[t.lower() for t in tags],
            phrase_nodes=phrases_to_ids(phrases, self.sg2id),
            qa_ans=qa_ans, guid=row_id)
        return convert_example_to_features(
            ex, self.tokenizer, cfg=self.cfg, tag2id=self.tag2id,
            phrase_vocab_size=self.phrase_vocab_size, rng=rng,
            mask_prob=self.mask_prob, mask_visual=self.mask_visual,
            visual_learning=self.visual_learning)

    def fetch(self, indices: np.ndarray,
              epoch: Optional[int] = None) -> Dict[str, np.ndarray]:
        return collate([self.__getitem__(int(i), epoch) for i in indices])


class MultiCorpusPretrainDataset:
    """Multiple pretraining corpora behind one index space.

    Parity target: the reference's yaml-driven multi-corpus loading
    (oscar_tsv4.py:25-99 — `corpus` name list, per-corpus feature TSVs,
    chunked `datasets_with_splits`, sg_file, phrase_vocab_size). Our yaml:

        corpora:
          - name: coco
            corpus_tsv: .../coco_corpus.tsv
            feature_tsv: .../coco/predictions.tsv
          - name: cc
            corpus_tsv: .../cc_corpus.tsv
            feature_tsv: .../cc/predictions.tsv   # or a list of chunks
        id2phrase: .../id2phrase.json
        tag2id: .../tag2id.json
        phrase_vocab_size: 55529
    """

    def __init__(self, datasets: Sequence["PretrainDataset"]):
        assert datasets
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    @classmethod
    def from_yaml(cls, yaml_path: str, tokenizer, cfg=None, seed: int = 0,
                  mask_prob: float = 0.15, mask_visual: bool = True,
                  qa_pairs: bool = False, only_qa: bool = False,
                  only_cap: bool = False, exclude_ids: Optional[set] = None,
                  gt_labels_json: Optional[str] = None,
                  feature_dim: int = 2054, visual_learning: bool = False,
                  override_tag2id: Optional[Dict[str, int]] = None):
        from ..utils.misc import load_from_yaml_file
        spec = load_from_yaml_file(yaml_path)
        cfg = cfg or TensorizeConfig()
        sg2id = (load_phrase_vocab(spec["id2phrase"])
                 if spec.get("id2phrase") else None)
        tag2id = {}
        if spec.get("tag2id"):
            with open(spec["tag2id"]) as f:
                raw = json.load(f)
            tag2id = {t: tokenizer.vocab.get(t, 1) for t in raw}
        pvs = int(spec.get("phrase_vocab_size", 0))
        # yaml key fk_test_id: newline-separated image ids excluded from
        # every corpus (reference Flickr30k test exclusion, ml2 :50,154-162)
        # — merged with any caller-supplied exclude set (CLI
        # --exclude_ids_file)
        if spec.get("fk_test_id"):
            with open(spec["fk_test_id"]) as f:
                yaml_excl = {ln.strip() for ln in f if ln.strip()}
            exclude_ids = (yaml_excl | exclude_ids) if exclude_ids \
                else yaml_excl
        if override_tag2id is not None:
            tag2id = override_tag2id
        datasets = []
        for c in spec["corpora"]:
            feats = c["feature_tsv"]
            feat_list = feats if isinstance(feats, list) else [feats]
            for chunk in feat_list:   # chunked feature TSVs
                datasets.append(PretrainDataset(
                    c["corpus_tsv"],
                    FeatureStore(chunk, feature_dim=feature_dim), tokenizer,
                    sg2id=sg2id, cfg=cfg, tag2id=tag2id,
                    phrase_vocab_size=pvs, seed=seed, mask_prob=mask_prob,
                    mask_visual=mask_visual, qa_pairs=qa_pairs,
                    only_qa=only_qa, only_cap=only_cap,
                    exclude_ids=exclude_ids,
                    gt_labels_json=gt_labels_json,
                    visual_learning=visual_learning,
                    # each chunk covers a SUBSET of the corpus images
                    restrict_to_features=len(feat_list) > 1))
        return cls(datasets)

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, index: int,
                    epoch: Optional[int] = None) -> Dict[str, np.ndarray]:
        d = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return self.datasets[d].__getitem__(index - int(self._offsets[d]),
                                            epoch)

    def fetch(self, indices: np.ndarray,
              epoch: Optional[int] = None) -> Dict[str, np.ndarray]:
        return collate([self.__getitem__(int(i), epoch) for i in indices])


class ImgOnlyDataset:
    """Vision-only pretraining stream: MLM over object tags with empty text
    (reference ImgOnlyDataset, oscar_datasets_ml/oscar_tsv.py:1190-1240).
    The same arrays as PretrainDataset with a blank stream A; its masks are
    keyed on (seed, epoch, index) under an "img:" prefix."""

    def __init__(self, features: FeatureStore, tokenizer,
                 cfg: TensorizeConfig = TensorizeConfig(),
                 seed: int = 0, mask_prob: float = 0.15):
        self.keys = features.keys()
        self.features = features
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.seed = seed
        self.mask_prob = mask_prob

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index: int,
                    epoch: Optional[int] = None) -> Dict[str, np.ndarray]:
        feats, tags = self.features.get(self.keys[index])
        ex = PretrainExample(
            tokens_a=[], tokens_b=self.tokenizer.tokenize(" ".join(tags)),
            img_feat=feats, od_tags=[t.lower() for t in tags], guid=index)
        rng = random.Random(f"img:{self.seed}:{epoch or 0}:{index}")
        return convert_example_to_features(ex, self.tokenizer, cfg=self.cfg,
                                           rng=rng, mask_prob=self.mask_prob)

    def fetch(self, indices: np.ndarray,
              epoch: Optional[int] = None) -> Dict[str, np.ndarray]:
        return collate([self.__getitem__(int(i), epoch) for i in indices])


class TextOnlyDataset:
    """Text-only pretraining stream: caption-corpus MLM with a single zero
    dummy region (reference TextOnlyDataset/TextOnlyDataset2,
    oscar_datasets_ml/oscar_tsv.py:914-1075, which fake img_seq_len=1); its
    masks are keyed on (seed, epoch, index) under a "txt:" prefix."""

    def __init__(self, corpus_tsv: str, tokenizer,
                 cfg: TensorizeConfig = TensorizeConfig(),
                 seed: int = 0, mask_prob: float = 0.15,
                 text_column: int = 1):
        self.tsv = TSVFile(corpus_tsv)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.seed = seed
        self.mask_prob = mask_prob
        self.text_column = text_column

    def __len__(self):
        return len(self.tsv)

    def __getitem__(self, index: int,
                    epoch: Optional[int] = None) -> Dict[str, np.ndarray]:
        row = self.tsv.seek(index)
        text = row[min(self.text_column, len(row) - 1)]
        dummy = np.zeros((1, self.cfg.img_feature_dim), np.float32)
        ex = PretrainExample(tokens_a=self.tokenizer.tokenize(text),
                             tokens_b=[], img_feat=dummy, guid=index)
        rng = random.Random(f"txt:{self.seed}:{epoch or 0}:{index}")
        return convert_example_to_features(ex, self.tokenizer, cfg=self.cfg,
                                           rng=rng, mask_prob=self.mask_prob)

    def fetch(self, indices: np.ndarray,
              epoch: Optional[int] = None) -> Dict[str, np.ndarray]:
        return collate([self.__getitem__(int(i), epoch) for i in indices])


class VQADataset:
    """jsonl: {"question_id", "image_id", "question", "labels": [ans ids],
    "scores": [soft scores], "phrases": [...]}; answers via label2ans json.

    label_mode 'soft' emits the [num_answers] soft-score vector (VQA bce);
    'int' emits the argmax answer id (GQA-style CE — reference GQAProcessor
    path in run_vqa)."""

    def __init__(self, jsonl_path: str, features: FeatureStore, tokenizer,
                 num_answers: int, sg2id: Optional[Dict[tuple, int]] = None,
                 cfg: TensorizeConfig = TensorizeConfig(),
                 label_mode: str = "soft", use_b_text: bool = False,
                 b_as_list: bool = False):
        assert label_mode in ("soft", "int")
        self.label_mode = label_mode
        self.items = []
        with open(jsonl_path) as f:
            for line in f:
                if line.strip():
                    self.items.append(json.loads(line))
        self.features = features
        self.tokenizer = tokenizer
        self.num_answers = num_answers
        self.sg2id = sg2id
        self.cfg = cfg
        self.use_b_text = use_b_text
        self.b_as_list = b_as_list

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        item = self.items[index]
        feats, tags = self.features.get(item["image_id"])
        ex = tensorize_example(
            self.tokenizer, item["question"], feats, " ".join(tags),
            phrases_to_ids(item.get("phrases", []), self.sg2id), self.cfg,
            text_a_tags=tags_for_text_a(tags, self.use_b_text,
                                        self.b_as_list))
        target = np.zeros(self.num_answers, np.float32)
        for l, s in zip(item.get("labels", []), item.get("scores", [])):
            target[int(l)] = float(s)
        if self.label_mode == "int":
            ex["label"] = np.int32(target.argmax())
        else:
            ex["label"] = target
        ex["question_id"] = np.int64(item.get("question_id", index))
        return ex

    def fetch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        return collate([self[int(i)] for i in indices])


class VEDataset:
    """SNLI-VE jsonl: {"pairID", "Flickr30K_ID", "sentence2" (hypothesis),
    "gold_label", "phrases"} (reference run_ve.py:46-120)."""

    def __init__(self, jsonl_path: str, features: FeatureStore, tokenizer,
                 sg2id: Optional[Dict[tuple, int]] = None,
                 cfg: TensorizeConfig = TensorizeConfig(),
                 use_b_text: bool = False, b_as_list: bool = False,
                 mask_training: bool = False, seed: int = 0):
        # mask_training (reference run_ve.py:163-168): during fine-tune
        # TRAINING, replace hypothesis/phrase tokens with [MASK] at p=0.15
        # as regularization (never on eval splits)
        self.mask_training = mask_training
        self.seed = seed
        self.epoch = 0
        self.items = []
        with open(jsonl_path) as f:
            for line in f:
                if line.strip():
                    it = json.loads(line)
                    if it.get("gold_label") in VE_LABELS:
                        self.items.append(it)
        self.features = features
        self.tokenizer = tokenizer
        self.sg2id = sg2id
        self.cfg = cfg
        self.use_b_text = use_b_text
        self.b_as_list = b_as_list

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int,
                    epoch: Optional[int] = None) -> Dict[str, np.ndarray]:
        ep = self.epoch if epoch is None else epoch
        item = self.items[index]
        img_id = item.get("Flickr30K_ID") or item["image_id"]
        feats, tags = self.features.get(img_id)
        ex = tensorize_example(
            self.tokenizer, item["sentence2"], feats, " ".join(tags),
            phrases_to_ids(item.get("phrases", []), self.sg2id), self.cfg,
            text_a_tags=tags_for_text_a(tags, self.use_b_text,
                                        self.b_as_list))
        if self.mask_training:
            rng = random.Random(f"{self.seed}:{ep}:{index}")
            mask_id = self.tokenizer.vocab["[MASK]"]
            sep_id = self.tokenizer.vocab[self.tokenizer.sep_token]
            ids = ex["input_ids_a"].copy()
            # positions 1..first-[SEP] — the reference masks over
            # range(1, len(input_ids_a)-1) before the tag append
            for i in range(1, len(ids)):
                if ids[i] == sep_id:
                    break
                if rng.random() < 0.15:
                    ids[i] = mask_id
            ex["input_ids_a"] = ids
        ex["label"] = np.int32(VE_LABELS[item["gold_label"]])
        return ex

    def fetch(self, indices: np.ndarray,
              epoch: Optional[int] = None) -> Dict[str, np.ndarray]:
        return collate([self.__getitem__(int(i), epoch) for i in indices])


def compute_iou(box: Sequence[float], boxes: np.ndarray) -> np.ndarray:
    """IoU of one box vs [N, 4] boxes, xyxy (reference run_re.py:46-74)."""
    boxes = np.asarray(boxes, np.float32)
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    a1 = (box[2] - box[0]) * (box[3] - box[1])
    a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = a1 + a2 - inter
    return np.where(union > 0, inter / union, 0.0)


class REDataset:
    """Referring expressions: records {"image_id", "expression", "gt_box":
    [x1,y1,x2,y2], "phrases"}; region boxes come from the feature geometry
    (last 6 dims are [x1,y1,x2,y2,w,h] normalized) so labels are per-region
    IoUs vs the gt box (reference run_re.py:46-186).

    External detections (reference --det_json, run_re.py:142-186): det_json
    maps {image_id: [[x1,y1,x2,y2], ...]} (same normalized-xyxy convention
    as gt_box). Each example then also carries `det_label` ([max_det] IoU of
    each detection vs the gt box, -1 padded) and `iou_mat`
    ([max_img_seq_length, max_det] IoU of each feature region vs each
    detection) for re_score_det1/2 scoring."""

    def __init__(self, data_json: str, features: FeatureStore, tokenizer,
                 sg2id: Optional[Dict[tuple, int]] = None,
                 cfg: TensorizeConfig = TensorizeConfig(),
                 det_json: Optional[str] = None, max_det: int = 20,
                 use_phrases: bool = False):
        # use_phrases=False matches the reference as released: its RE
        # tensorize_example discards the loaded phrase list by reassigning
        # `phrase_nodes = []` before the phrase2id mapping
        # (run_re.py:201-202), so RE examples never carry phrase nodes.
        # True is the working superset (oracle-checked off by
        # tests/test_re_tensorize_parity.py).
        self.use_phrases = use_phrases
        with open(data_json) as f:
            self.items = json.load(f)
        self.features = features
        self.tokenizer = tokenizer
        self.sg2id = sg2id
        self.cfg = cfg
        self.det_boxes = None
        self.max_det = max_det
        if det_json:
            with open(det_json) as f:
                self.det_boxes = {str(k): np.asarray(v, np.float32)
                                  for k, v in json.load(f).items()}

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        item = self.items[index]
        feats, tags = self.features.get(item["image_id"])
        ex = tensorize_example(
            self.tokenizer, item["expression"], feats, " ".join(tags),
            (phrases_to_ids(item.get("phrases", []), self.sg2id)
             if self.use_phrases else []), self.cfg)
        n = min(feats.shape[0], self.cfg.max_img_seq_length)
        boxes = feats[:n, -6:-2]   # normalized xyxy
        ious = compute_iou(item["gt_box"], boxes)
        labels = np.full(self.cfg.max_img_seq_length, -1.0, np.float32)
        labels[:n] = ious
        ex["label"] = labels
        if self.det_boxes is not None:
            # images without detections score as automatic misses
            # (det_label all -1 is never selected by re_score_det1/2)
            dets = self.det_boxes.get(
                str(item["image_id"]),
                np.zeros((0, 4), np.float32))[: self.max_det]
            nd = dets.shape[0]
            det_label = np.full(self.max_det, -1.0, np.float32)
            det_label[:nd] = compute_iou(item["gt_box"], dets)
            iou_mat = np.zeros((self.cfg.max_img_seq_length, self.max_det),
                               np.float32)
            for j in range(nd):
                iou_mat[:n, j] = compute_iou(dets[j], boxes)
            ex["det_label"] = det_label
            ex["iou_mat"] = iou_mat
        return ex

    def fetch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        return collate([self[int(i)] for i in indices])


def re_score(logits: np.ndarray, labels: np.ndarray,
             iou_threshold: float = 0.5) -> float:
    """argmax-region IoU>=0.5 accuracy (reference run_re.py:389-394)."""
    masked = np.where(labels >= 0, logits, -np.inf)
    pick = masked.argmax(axis=1)
    picked_iou = labels[np.arange(labels.shape[0]), pick]
    return float(np.mean(picked_iou >= iou_threshold))


def re_score_det1(logits: np.ndarray, labels: np.ndarray,
                  det_labels: np.ndarray, iou_mats: np.ndarray,
                  iou_threshold: float = 0.5) -> float:
    """Detection-grounded scoring, variant 1 (reference run_re.py:396-409):
    pick the best-scored feature region, snap it to the detection with max
    IoU overlap, score that detection's IoU vs the gt box.

    logits/labels: [B, R]; det_labels: [B, D] (-1 padded);
    iou_mats: [B, R, D]."""
    masked = np.where(labels >= 0, logits, -np.inf)
    pred_pos = masked.argmax(axis=1)                          # [B]
    b = np.arange(logits.shape[0])
    overlap = np.where(det_labels[:, None, :] >= 0,
                       iou_mats, -np.inf)[b, pred_pos]        # [B, D]
    det_pos = overlap.argmax(axis=1)
    return float(np.mean(det_labels[b, det_pos] >= iou_threshold))


def re_score_det2(logits: np.ndarray, labels: np.ndarray,
                  det_labels: np.ndarray, iou_mats: np.ndarray,
                  iou_threshold: float = 0.5) -> float:
    """Detection-grounded scoring, variant 2 (reference run_re.py:412-421):
    project region scores onto detections through the IoU matrix
    (det_logits = logits @ iou_mat over valid regions), pick the argmax
    detection."""
    valid = (labels >= 0).astype(np.float32)                  # [B, R]
    det_logits = np.einsum("br,brd->bd", logits * valid, iou_mats)
    det_logits = np.where(det_labels >= 0, det_logits, -np.inf)
    det_pos = det_logits.argmax(axis=1)
    b = np.arange(logits.shape[0])
    return float(np.mean(det_labels[b, det_pos] >= iou_threshold))
