"""Synthetic dataset generator: this package's copy of the JAX package's
`data/synthetic.py`, writing byte for byte the same root from the same seed.

Writes a miniature but format-faithful copy of every data artifact the
framework consumes (feature TSVs, caption/task JSONs, vocab, phrase vocab),
for smoke-testing the task drivers end to end without real corpora — the
operational-validation capability the reference lacked (SURVEY.md §4).
"""

from __future__ import annotations

import base64
import json
import os
import random
from typing import Dict, List, Optional

import numpy as np

from .tsv import tsv_writer

WORDS = ["two", "dogs", "are", "playing", "on", "a", "ground", "man",
         "woman", "rides", "horse", "red", "car", "parked", "near", "tree",
         "child", "holds", "ball", "in", "park", "the", "with", "small",
         "large", "green", "blue", "street", "grass", "running"]
TAGS = ["dog", "person", "horse", "car", "tree", "ball", "grass", "road",
        "shirt", "sky"]


def write_vocab(path: str) -> List[str]:
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    for w in WORDS + TAGS:   # dedupe: some tags are also caption words
        if w not in vocab:
            vocab.append(w)
    with open(path, "w") as f:
        f.write("\n".join(vocab) + "\n")
    return vocab


def random_caption(rng: random.Random, n: int = 6) -> str:
    return " ".join(rng.choice(WORDS) for _ in range(n))


def write_features(directory: str, image_ids: List[str],
                   rng: np.random.RandomState, feature_dim: int = 2054,
                   max_regions: int = 10,
                   tags_out: Optional[Dict[str, List[str]]] = None,
                   boxes_out: Optional[Dict[str, np.ndarray]] = None) -> str:
    """predictions.tsv + imageid2idx.json with valid box geometry.
    If tags_out/boxes_out are given, they are filled per image."""
    os.makedirs(directory, exist_ok=True)

    def rows():
        for img in image_ids:
            n = rng.randint(3, max_regions + 1)
            roi = rng.randn(n, feature_dim - 6).astype(np.float32)
            x1 = rng.uniform(0, 0.5, (n, 1))
            y1 = rng.uniform(0, 0.5, (n, 1))
            x2 = x1 + rng.uniform(0.1, 0.5, (n, 1))
            y2 = y1 + rng.uniform(0.1, 0.5, (n, 1))
            geo = np.concatenate([x1, y1, x2, y2, x2 - x1, y2 - y1], 1)
            feats = np.concatenate([roi, geo.astype(np.float32)], 1)
            tags = [TAGS[rng.randint(len(TAGS))] for _ in range(n)]
            if tags_out is not None:
                tags_out[img] = tags
            if boxes_out is not None:
                boxes_out[img] = geo[:, :4].astype(np.float32)
            yield [img, json.dumps({
                "feature": base64.b64encode(feats.tobytes()).decode(),
                "predictions": tags})]

    tsv_path = os.path.join(directory, "predictions.tsv")
    tsv_writer(rows(), tsv_path)
    with open(os.path.join(directory, "imageid2idx.json"), "w") as f:
        json.dump({img: i for i, img in enumerate(image_ids)}, f)
    return tsv_path


def make_synthetic_root(root: str, n_images: int = 12,
                        caps_per_img: int = 5, n_answers: int = 7,
                        feature_dim: int = 2054, seed: int = 0
                        ) -> Dict[str, str]:
    """Create every artifact; returns a path dict.

    Idempotent: a completed root (paths.json marker, written last) is
    returned as-is without regeneration — this makes concurrent callers
    safe when generation is gated to one process (tasks/common.synth_root)
    and repeat smoke runs fast. The marker records the generation
    parameters: reusing the root with DIFFERENT parameters regenerates
    instead of silently returning stale data of the old shape."""
    # gen_code: bump when the GENERATION CODE changes shape/rules so stale
    # cached roots regenerate (2: learnable NLVR rule)
    gen_params = {"n_images": n_images, "caps_per_img": caps_per_img,
                  "n_answers": n_answers, "feature_dim": feature_dim,
                  "seed": seed, "gen_code": 2}
    marker = os.path.join(root, "paths.json")
    if os.path.exists(marker):
        with open(marker) as f:
            saved = json.load(f)
        if saved.get("gen_params") == gen_params:
            return saved
        # parameters changed: wipe and regenerate
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    rng = random.Random(seed)
    nprng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    image_ids = [f"img_{i:04d}" for i in range(n_images)]

    paths = {"root": root}
    paths["vocab"] = os.path.join(root, "vocab.txt")
    vocab_list = write_vocab(paths["vocab"])
    img_tags: Dict[str, List[str]] = {}
    img_boxes: Dict[str, np.ndarray] = {}
    paths["features"] = write_features(os.path.join(root, "features"),
                                       image_ids, nprng, feature_dim,
                                       tags_out=img_tags,
                                       boxes_out=img_boxes)

    # phrase vocab: ids appended after the wordpiece vocab
    vocab_size = len(vocab_list)
    phrases = [(rng.choice(WORDS), rng.choice(WORDS)) for _ in range(20)]
    id2phrase = {str(vocab_size + i): list(p) for i, p in enumerate(phrases)}
    paths["id2phrase"] = os.path.join(root, "id2phrase.json")
    with open(paths["id2phrase"], "w") as f:
        json.dump(id2phrase, f)

    def some_phrases():
        return [list(rng.choice(phrases)) for _ in range(rng.randint(0, 3))]

    # retrieval/captioning captions — LEARNABLE rule: each caption names
    # two detected tags of its image (captioning learns to describe the
    # regions) plus two image-unique words (retrieval needs captions that
    # discriminate between images sharing a tag pair)
    def image_caption(img):
        idx = image_ids.index(img)
        w1 = WORDS[idx % len(WORDS)]
        w2 = WORDS[(idx * 7 + 3) % len(WORDS)]
        t = img_tags[img]
        t0 = t[0]
        t1 = t[1 % len(t)]
        return (f"{w1} {w2} {t0} and {t1} "
                f"{rng.choice(['on', 'in', 'near'])} the "
                f"{rng.choice(WORDS)}")

    caps = {img: [{"text": image_caption(img), "phrases": some_phrases()}
                  for _ in range(caps_per_img)] for img in image_ids}
    paths["captions"] = os.path.join(root, "captions.json")
    with open(paths["captions"], "w") as f:
        json.dump(caps, f)

    # pretrain corpus tsv:
    # [image_id, caption, phrases_json, qa_ans_int, qa_answer_text]
    # every other row is a QA pair (question + true answer = a tag of the
    # image, so the QA-contrastive task is learnable from the visual stream)
    rows = []
    for img in image_ids:
        for j in range(caps_per_img):
            if j % 2 == 1:
                ans = rng.choice(img_tags[img])
                rows.append([img, "the picture shows a",
                             json.dumps(some_phrases()),
                             rng.randrange(n_answers), ans])
            else:
                rows.append([img, random_caption(rng),
                             json.dumps(some_phrases()),
                             rng.randrange(n_answers), ""])
    paths["corpus"] = os.path.join(root, "corpus.tsv")
    tsv_writer(rows, paths["corpus"])

    # fk-test-style exclusion list (a couple of image ids)
    paths["exclude_ids"] = os.path.join(root, "exclude_ids.txt")
    with open(paths["exclude_ids"], "w") as f:
        f.write("\n".join(image_ids[:2]) + "\n")

    # vqa jsonl + label2ans — LEARNABLE rule: the answer is determined by
    # the image's first detected tag (visible to the model via stream B),
    # so accuracy above chance is achievable (train-to-converge smokes)
    paths["vqa"] = os.path.join(root, "vqa.jsonl")
    with open(paths["vqa"], "w") as f:
        for qid, img in enumerate(image_ids * 2):
            ans = TAGS.index(img_tags[img][0]) % n_answers
            f.write(json.dumps({
                "question_id": qid, "image_id": img,
                "question": "what is the first thing here ?",
                "labels": [ans], "scores": [1.0],
                "phrases": some_phrases()}) + "\n")
    paths["label2ans"] = os.path.join(root, "label2ans.json")
    with open(paths["label2ans"], "w") as f:
        json.dump([f"answer_{i}" for i in range(n_answers)], f)

    # SNLI-VE jsonl — LEARNABLE rule: entailment mentions a tag present in
    # the image, contradiction mentions an absent tag, neutral mentions no
    # tag at all (cross-modal string matching through the tag stream)
    paths["ve"] = os.path.join(root, "ve.jsonl")
    labels = ["contradiction", "neutral", "entailment"]
    non_tag_words = [w for w in WORDS if w not in TAGS]
    with open(paths["ve"], "w") as f:
        for i, img in enumerate(image_ids * 3):
            lab = labels[i % 3]
            if lab == "entailment":
                word = rng.choice(img_tags[img])
            elif lab == "contradiction":
                absent = [t for t in TAGS if t not in img_tags[img]]
                word = rng.choice(absent or ["nothing"])
            else:
                word = rng.choice(non_tag_words)
            sent = f"there is a {word} here"
            f.write(json.dumps({
                "pairID": f"p{i}", "Flickr30K_ID": img,
                "sentence2": sent, "gold_label": lab,
                "phrases": some_phrases()}) + "\n")

    # RE json — LEARNABLE rule: the referred region is the LARGEST region
    # of the image (recoverable from the geometry dims of the features)
    re_items = []
    for img in image_ids:
        boxes = img_boxes[img]
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        gt = boxes[int(areas.argmax())]
        re_items.append({"image_id": img,
                         "expression": "the biggest one",
                         "gt_box": [float(v) for v in gt],
                         "phrases": some_phrases()})
    paths["re"] = os.path.join(root, "re.json")
    with open(paths["re"], "w") as f:
        json.dump(re_items, f)

    # external detections for the RE --det_json path: per image, one
    # detection near the gt box (high IoU) + distractors
    re_dets = {}
    for item in re_items:
        gt = item["gt_box"]
        w, h = gt[2] - gt[0], gt[3] - gt[1]
        near = [gt[0] + 0.05 * w, gt[1] + 0.05 * h,
                gt[2] - 0.05 * w, gt[3] - 0.05 * h]
        distract = []
        for _ in range(3):
            x1, y1 = rng.uniform(0, 0.5), rng.uniform(0, 0.5)
            distract.append([x1, y1, x1 + rng.uniform(0.1, 0.4),
                             y1 + rng.uniform(0.1, 0.4)])
        dets = distract[:1] + [near] + distract[1:]
        re_dets[item["image_id"]] = dets
    paths["re_dets"] = os.path.join(root, "re_dets.json")
    with open(paths["re_dets"], "w") as f:
        json.dump(re_dets, f)

    # NLVR2 jsonl — LEARNABLE rule: the statement names a tag detected in
    # exactly one of the two images; label True iff that image is img0.
    # Solvable only by matching the statement against each image's tag
    # stream through the joint fusion (exercises cross-image attention).
    paths["nlvr"] = os.path.join(root, "nlvr.jsonl")
    with open(paths["nlvr"], "w") as f:
        for i in range(n_images * 2):
            img0 = image_ids[i % n_images]
            img1 = image_ids[(i + 1 + i // n_images) % n_images]
            if img1 == img0:
                img1 = image_ids[(i + 1) % n_images]
            in_img0 = rng.random() < 0.5
            src, other = (img0, img1) if in_img0 else (img1, img0)
            cands = [t for t in img_tags[src] if t not in img_tags[other]]
            if not cands:   # tag sets overlap fully: fall back, keep rare
                cands = img_tags[src]
            f.write(json.dumps({
                "sentence": f"the first picture shows a {rng.choice(cands)}",
                "label": "True" if in_img0 else "False",
                "img0": img0,
                "img1": img1}) + "\n")

    # general custom-data json
    paths["general"] = os.path.join(root, "general.json")
    with open(paths["general"], "w") as f:
        json.dump([{"image_id": img, "text": random_caption(rng),
                    "phrases": some_phrases(), "label": rng.randrange(3)}
                   for img in image_ids], f)

    # tag2id for MRC / visual MLM
    paths["tag2id"] = os.path.join(root, "tag2id.json")
    with open(paths["tag2id"], "w") as f:
        json.dump({t: i for i, t in enumerate(TAGS)}, f)

    paths["gen_params"] = gen_params
    with open(marker + ".tmp", "w") as f:
        json.dump(paths, f)
    os.replace(marker + ".tmp", marker)
    return paths
