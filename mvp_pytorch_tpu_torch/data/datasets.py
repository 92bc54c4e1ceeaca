"""The retrieval dataset over the TSV feature-store contract: this package's
copy of the JAX package's `data/datasets.py` parts that retrieval reads
(`load_phrase_vocab`, `tags_for_text_a`, `phrases_to_ids`, `FeatureStore`,
`RetrievalDataset`). The other datasets come with their tasks.

Parity targets:
- feature store: `predictions.tsv` rows = [image_id, json{"feature":
  base64(float32 [N, 2054]), "predictions": [tags...]}] + `imageid2idx.json`
  (reference `tools/img_feat_extract.py:15-42,96-115`,
  `oscar/datasets/general_dataset.py:157-166`).
- RetrievalDataset <- `oscar/run_retrieval.py:24-296`: per-image caption
  lists, phrase lookup, train positives, eval enumeration.

The arrays keep the JAX package's names (`input_mask_a`, `segment_ids_a`,
`img_feat`, ...); the retrieval task maps them onto the model's.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import native as _native
from .tensorize import TensorizeConfig, collate, tensorize_example
from .tsv import TSVFile


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
