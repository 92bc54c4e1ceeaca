"""GLUE-style task processors: this package's copy of the JAX package's
`data/processors.py`.

Parity target: reference `oscar/utils/task_utils.py` (614 LoC) — DataProcessor
subclasses producing InputExample streams for VQA text (+ scene-graph phrase
sidecars), VQA-textA, GQA, NLVR2, and VCR Q->A / QA->R / Q->AR, plus
convert_examples_to_features (:435-566). The tensorization side lives in
data/tensorize.py; processors here own file parsing and label maps. No
command line calls them (the NLVR2 command line reads its jsonl
itself).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


@dataclass
class InputExample:
    guid: str
    text_a: str
    text_b: Optional[str] = None
    label: Optional[object] = None
    score: Optional[object] = None
    img_key: Optional[str] = None
    q_id: Optional[int] = None
    phrases: List[Sequence[str]] = field(default_factory=list)


class DataProcessor:
    name = "base"

    def get_train_examples(self, data_dir: str) -> List[InputExample]:
        raise NotImplementedError

    def get_dev_examples(self, data_dir: str) -> List[InputExample]:
        raise NotImplementedError

    def get_labels(self, label_file: Optional[str] = None):
        raise NotImplementedError

    @staticmethod
    def _read_json(path: str):
        with open(path) as f:
            return json.load(f)

    @staticmethod
    def _read_jsonl(path: str):
        out = []
        with open(path) as f:
            for line in f:
                if line.strip():
                    out.append(json.loads(line))
        return out


class VQATextProcessor(DataProcessor):
    """VQA v2 with answer soft scores and `{split}_sg_tuples.json` phrase
    sidecars (reference task_utils.py:81-140)."""

    name = "vqa_text"

    def _examples(self, data_dir: str, split: str) -> List[InputExample]:
        records = self._read_jsonl(os.path.join(data_dir, f"{split}.jsonl"))
        sg_path = os.path.join(data_dir, f"{split}_sg_tuples.json")
        sgs = self._read_json(sg_path) if os.path.exists(sg_path) else {}
        out = []
        for i, r in enumerate(records):
            qid = r.get("question_id", i)
            out.append(InputExample(
                guid=f"{split}-{qid}", text_a=r["question"],
                text_b=r.get("od_labels"), label=r.get("labels"),
                score=r.get("scores"), img_key=str(r["image_id"]), q_id=qid,
                phrases=sgs.get(str(qid), r.get("phrases", []))))
        return out

    def get_train_examples(self, data_dir):
        return self._examples(data_dir, "train")

    def get_dev_examples(self, data_dir):
        return self._examples(data_dir, "val")

    def get_test_examples(self, data_dir, split="test2015"):
        return self._examples(data_dir, split)

    def get_labels(self, label_file: Optional[str] = None):
        """ans2label map (reference loads trainval_ans2label.pkl; ours json)."""
        if label_file:
            return self._read_json(label_file)
        return None


class VQATextAProcessor(VQATextProcessor):
    """Question-only variant (reference vqa_textA): drops od labels."""

    name = "vqa_text_a"

    def _examples(self, data_dir, split):
        exs = super()._examples(data_dir, split)
        for e in exs:
            e.text_b = None
        return exs


class GQAProcessor(DataProcessor):
    name = "gqa"

    def _examples(self, data_dir, split):
        records = self._read_jsonl(os.path.join(data_dir, f"{split}.jsonl"))
        out = []
        for i, r in enumerate(records):
            out.append(InputExample(
                guid=f"{split}-{i}", text_a=r["question"],
                text_b=r.get("od_labels"), label=r.get("label"),
                img_key=str(r["image_id"]), q_id=r.get("question_id", i),
                phrases=r.get("phrases", [])))
        return out

    def get_train_examples(self, data_dir):
        return self._examples(data_dir, "train")

    def get_dev_examples(self, data_dir):
        return self._examples(data_dir, "val")

    def get_labels(self, label_file=None):
        return self._read_json(label_file) if label_file else None


class NLVRProcessor(DataProcessor):
    """NLVR2: one statement + two images (feeds BiEncoder.forward_joint)."""

    name = "nlvr"

    def _examples(self, data_dir, split):
        records = self._read_jsonl(os.path.join(data_dir, f"{split}.jsonl"))
        out = []
        for i, r in enumerate(records):
            # unlabeled (test-split) records keep label=None rather than
            # fabricating a "False" negative
            raw_label = r.get("label")
            out.append(InputExample(
                guid=f"{split}-{i}", text_a=r["sentence"],
                text_b=r.get("od_labels"),
                label=(None if raw_label is None
                       else (1 if str(raw_label).lower() == "true" else 0)),
                img_key=json.dumps([r.get("img0"), r.get("img1")]),
                phrases=r.get("phrases", [])))
        return out

    def get_train_examples(self, data_dir):
        return self._examples(data_dir, "train")

    def get_dev_examples(self, data_dir):
        return self._examples(data_dir, "dev")

    def get_labels(self, label_file=None):
        return [0, 1]


class VCRProcessor(DataProcessor):
    """VCR Q->A (mode='qa'), QA->R (mode='qar'), Q->AR (mode='q_ar') as
    4-way multiple choice (reference task_utils.py VCR processors)."""

    name = "vcr"

    def __init__(self, mode: str = "qa"):
        assert mode in ("qa", "qar", "q_ar")
        self.mode = mode

    def _examples(self, data_dir, split):
        records = self._read_jsonl(os.path.join(data_dir, f"{split}.jsonl"))
        out = []
        for i, r in enumerate(records):
            q = r["question"]
            a_label = r.get("answer_label")
            r_label = r.get("rationale_label")
            if self.mode == "qa":
                choices = r["answer_choices"]
                label = a_label
                text_a = q
            elif self.mode == "qar":
                # unlabeled records (test split) have no gold answer to
                # condition on: use answer 0 like unlabeled 'qa' mode
                # tolerates missing labels, and emit label=None
                ans = r["answer_choices"][a_label if a_label is not None
                                          else 0]
                text_a = f"{q} {ans}"
                choices = r["rationale_choices"]
                label = r_label
            else:  # q_ar: joint answer+rationale combos (AxR flattened)
                n_rat = len(r["rationale_choices"])
                choices = [f"{a} {rat}" for a in r["answer_choices"]
                           for rat in r["rationale_choices"]]
                # gold combo index uses the ACTUAL rationale count (not a
                # hardcoded 4); unlabeled -> None, no fabricated gold
                label = (None if a_label is None or r_label is None
                         else a_label * n_rat + r_label)
                text_a = q
            img_key = r.get("img_id", r.get("image_id"))
            if img_key is None:
                raise KeyError(
                    f"VCR record {split}-{i} has neither img_id nor "
                    "image_id")
            for j, choice in enumerate(choices):
                out.append(InputExample(
                    guid=f"{split}-{i}-{j}", text_a=text_a, text_b=choice,
                    label=(0 if label is None else (1 if j == label else 0)),
                    img_key=str(img_key),
                    phrases=r.get("phrases", [])))
        return out

    def get_train_examples(self, data_dir):
        return self._examples(data_dir, "train")

    def get_dev_examples(self, data_dir):
        return self._examples(data_dir, "val")

    def get_labels(self, label_file=None):
        return [0, 1]


PROCESSORS: Dict[str, type] = {
    "vqa_text": VQATextProcessor,
    "vqa_text_a": VQATextAProcessor,
    "gqa": GQAProcessor,
    "nlvr": NLVRProcessor,
    "vcr": VCRProcessor,
}
