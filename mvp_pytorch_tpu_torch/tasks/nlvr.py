"""NLVR2 fine-tuning and evaluation: the JAX package's `tasks/nlvr.py` on one
device (one statement, two images, a true/false label; the reference's
NLVRProcessor plus `BiBertImgModel.forward_joint`).

`main` reads an NLVR2 jsonl (`sentence`, `img0`, `img1`, `label`), a feature
TSV and a vocab (or writes a synthetic root with `--synthetic`), trains
`NLVRModel` through the process loader and evaluates its accuracy on the
eval split, on the card unless `--platform cpu`:

    python -m mvp_pytorch_tpu_torch.tasks.nlvr --output_dir /tmp/nlvr \
        --synthetic --tiny --max_steps 10 --do_train --do_eval --platform cpu

Both images' tag-stripped region streams follow the text in one fusion pass:
at the defaults (LA 40 = 35 + 5 phrase slots, R 50) its attention runs over
140 keys.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np

from ..data.datasets import FeatureStore
from ..data.tensorize import TensorizeConfig, collate, tensorize_example
from ..data.tokenization import FastBertTokenizer
from ..models.tasks import NLVRModel
from ..utils.logger import setup_logger
from .common import (NLVR_INPUT_NAMES, NLVR_MODEL_KEYS, TaskFetch, TrainLoop,
                     add_common_args, build_config, check_args,
                     load_params_or_init, predict, restore_training_settings,
                     run_device, synth_root, tensorize_cfg)

_SIDE_KEYS = ("input_ids_b", "input_mask_b", "segment_ids_b", "img_feat")


class NLVRDataset:
    """An NLVR2 jsonl: each statement tensorized against each of its two
    images (`tensorize_example`); the first side's seven arrays, the second
    image's four as `*2`, and `label` (int32 0/1)."""

    def __init__(self, jsonl_path: str, features: FeatureStore, tokenizer,
                 cfg: TensorizeConfig = TensorizeConfig()):
        self.items = []
        with open(jsonl_path) as f:
            for line in f:
                if line.strip():
                    self.items.append(json.loads(line))
        self.features = features
        self.tokenizer = tokenizer
        self.cfg = cfg

    def __len__(self):
        return len(self.items)

    def _side(self, img_key, text):
        feats, tags = self.features.get(img_key)
        return tensorize_example(self.tokenizer, text, feats,
                                 " ".join(tags), [], self.cfg)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        it = self.items[index]
        a = self._side(it["img0"], it["sentence"])
        b = self._side(it["img1"], it["sentence"])
        ex = {k: a[k] for k in ("input_ids_a", "input_mask_a",
                                "segment_ids_a") + _SIDE_KEYS}
        ex.update({f"{k}2": b[k] for k in _SIDE_KEYS})
        ex["label"] = np.int32(_label(it.get("label"), index))
        return ex

    def fetch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        return collate([self[int(i)] for i in indices])


def _label(raw, index: int) -> int:
    """true / false, 1 / 0, as a bool, an int or a string; anything else
    raises (a silent 0 would train a constant-false model)."""
    if isinstance(raw, bool):
        return int(raw)
    if isinstance(raw, int) and raw in (0, 1):
        return raw
    t = str(raw).strip().lower()
    if t in ("true", "1"):
        return 1
    if t in ("false", "0"):
        return 0
    raise ValueError(f"NLVR item {index}: unrecognized label {raw!r}")


def get_args(argv=None):
    p = argparse.ArgumentParser(description="NLVR2 fine-tuning and "
                                "evaluation")
    add_common_args(p)
    p.add_argument("--train_jsonl", type=str, default=None)
    p.add_argument("--eval_jsonl", type=str, default=None)
    p.add_argument("--feature_tsv", type=str, default=None)
    return p.parse_args(argv)


def nlvr_loss_fn(args):
    """The Trainer's loss_fn: 2-class CE, with the batch accuracy as
    `acc`."""
    def loss_fn(model, batch, generator):
        loss, logits = model(*(batch[k] for k in NLVR_MODEL_KEYS),
                             labels=batch["label"],
                             max_tag_length=args.max_tag_length,
                             generator=generator)
        acc = (logits.argmax(1) == batch["label"]).float().mean()
        return loss, {"acc": acc}
    return loss_fn


def evaluate(args, model, dataset) -> Dict:
    """Logits and labels over the dataset, and the accuracy."""
    logits, kept = predict(
        model, dataset, args.eval_batch_size,
        lambda m, *x: m(*x, max_tag_length=args.max_tag_length),
        keep=("label",), input_names=NLVR_INPUT_NAMES)
    correct = int((logits.argmax(1) == kept["label"]).sum())
    return {"nlvr_accuracy": correct / max(len(dataset), 1),
            "logits": logits, "labels": kept["label"]}


def main(argv=None) -> dict:
    """Train and/or evaluate; returns {"train": each step's metrics, "eval":
    the last `evaluate` result} as far as they ran."""
    args = get_args(argv)
    check_args(args)
    device = run_device(args)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = setup_logger("nlvr", args.output_dir)
    restore_training_settings(args, argv, logger=logger)

    if args.synthetic:
        paths = synth_root(args)
        args.train_jsonl = args.eval_jsonl = paths["nlvr"]
        args.feature_tsv = paths["features"]
        vocab = paths["vocab"]
    else:
        vocab = os.path.join(args.model_name_or_path or args.data_dir,
                             "vocab.txt")
    tokenizer = FastBertTokenizer(vocab)
    cfg = build_config(args, tokenizer, num_labels=2)
    tcfg = tensorize_cfg(args)
    features = FeatureStore(args.feature_tsv,
                            feature_dim=args.img_feature_dim)
    dataset = NLVRDataset(args.train_jsonl, features, tokenizer, tcfg)
    # the eval runs on the eval split (the reference's contract)
    eval_dataset = (NLVRDataset(args.eval_jsonl, features, tokenizer, tcfg)
                    if args.eval_jsonl and args.eval_jsonl != args.train_jsonl
                    else dataset)
    model = NLVRModel(cfg, device=device, seed=args.seed)
    load_params_or_init(args, model, logger)

    out = {}

    def eval_hook(step):
        out["eval"] = evaluate(args, model, eval_dataset)
        acc = out["eval"]["nlvr_accuracy"]
        logger.info(f"step {step}: nlvr accuracy = {acc:.4f}")
        return {"nlvr_accuracy": acc}

    if args.do_train:
        loop = TrainLoop(args, model, nlvr_loss_fn(args),
                         TaskFetch(dataset, NLVR_INPUT_NAMES), len(dataset),
                         logger)
        tokenizer.save_pretrained(args.output_dir)
        out["train"] = loop.run(eval_hook if args.do_eval else None)
    elif args.do_eval:
        eval_hook(0)
    logger.info("nlvr done")
    return out


if __name__ == "__main__":
    main()
