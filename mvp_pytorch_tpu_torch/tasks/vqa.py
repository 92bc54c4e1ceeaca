"""VQA fine-tuning and evaluation: the JAX package's `tasks/vqa.py` on one
device (reference `oscar/run_vqa.py`: soft-score bce training, VQA accuracy
as the soft score at the argmax answer, EvalAI-format test output).

`main` reads a question jsonl, a feature TSV, a vocab and `label2ans.json`
(or writes a synthetic root with `--synthetic`), trains `VQAModel` (the QA
head over the fused CLS token; `--use_single` the Plus model, `--use_cls` the
pooled classifier) through the process loader and evaluates it, on the card
unless `--platform cpu`:

    python -m mvp_pytorch_tpu_torch.tasks.vqa --output_dir /tmp/vqa \
        --synthetic --tiny --max_steps 10 --do_train --do_eval --platform cpu

Schedules: `--adjust_loss_step N` trains kl before step N and bce from it
(it needs `--loss_type kl`); `--adjust_dp_step N` raises every hidden dropout
to 0.3 from step N. `--test_jsonl` writes `{split}_results.json`.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np

from ..data.datasets import FeatureStore, VQADataset, load_phrase_vocab
from ..data.tokenization import FastBertTokenizer
from ..models.tasks import (ClassificationModel, ClassificationPlusModel,
                            VQAModel, classification_loss,
                            instance_bce_with_logits, kl_div_loss)
from ..utils.logger import setup_logger
from .common import (MODEL_KEYS, TaskFetch, TrainLoop, add_common_args,
                     adjust_dropout, build_config, check_args,
                     load_params_or_init, predict, restore_training_settings,
                     run_device, synth_root, tensorize_cfg)


def get_args(argv=None):
    p = argparse.ArgumentParser(description="VQA fine-tuning and evaluation")
    add_common_args(p)
    p.add_argument("--train_jsonl", type=str, default=None)
    p.add_argument("--eval_jsonl", type=str, default=None)
    p.add_argument("--feature_tsv", type=str, default=None)
    p.add_argument("--id2phrase", type=str, default=None)
    p.add_argument("--label2ans", type=str, default=None)
    p.add_argument("--loss_type", type=str, default="bce",
                   choices=["bce", "sfmx", "kl"],
                   help="sfmx trains on the argmax answer id (GQA-style)")
    p.add_argument("--test_jsonl", type=str, default=None,
                   help="write EvalAI-format {split}_results.json")
    p.add_argument("--use_b_text", action="store_true",
                   help="append the tags to stream A")
    p.add_argument("--b_as_list", action="store_true",
                   help="with --use_b_text: keep duplicate tags")
    p.add_argument("--adjust_loss_step", type=int, default=None,
                   help="train kl before this step and bce from it on "
                        "(needs --loss_type kl)")
    p.add_argument("--adjust_dp_step", type=int, default=None,
                   help="raise every hidden dropout to 0.3 from this step "
                        "on (the attention-probability dropout keeps its "
                        "rate)")
    p.add_argument("--use_single", action="store_true",
                   help="the fusion + single-stream Plus head")
    p.add_argument("--use_cls", action="store_true",
                   help="the pooled-output classifier instead of the QA "
                        "head")
    return p.parse_args(argv)


def vqa_accuracy(logits: np.ndarray, targets: np.ndarray) -> float:
    """The sum of the soft scores at the argmax answer, over the questions
    (reference compute_score_with_logits)."""
    pick = logits.argmax(axis=1)
    return float(targets[np.arange(len(pick)), pick].sum() / len(pick))


def vqa_loss_fn(args, cfg):
    """The Trainer's loss_fn: `classification_loss` by the config's loss
    type, or kl -> bce at `--adjust_loss_step`; the hidden dropouts follow
    `--adjust_dp_step`."""
    if args.adjust_loss_step is not None and args.loss_type != "kl":
        raise ValueError("--adjust_loss_step switches kl to bce; start with "
                         f"--loss_type kl (got {args.loss_type})")

    def loss_fn(model, batch, generator, step):
        adjust_dropout(model, step, args.adjust_dp_step)
        logits = model(*(batch[k] for k in MODEL_KEYS),
                       max_tag_length=args.max_tag_length,
                       generator=generator)
        if args.adjust_loss_step is None:
            loss = classification_loss(cfg, logits, batch["label"])
        elif step < args.adjust_loss_step:
            loss = kl_div_loss(logits, batch["label"])
        else:
            loss = instance_bce_with_logits(logits, batch["label"])
        return loss, {}
    return loss_fn


def evaluate(args, model, dataset) -> Dict:
    """Logits, targets and question ids over the dataset, and the accuracy:
    VQA accuracy on soft targets, exact match on int labels."""
    logits, kept = predict(
        model, dataset, args.eval_batch_size,
        lambda m, *x: m(*x, max_tag_length=args.max_tag_length),
        keep=("label", "question_id"))
    targets = kept["label"]
    if targets.ndim == 1:
        acc = float((logits.argmax(1) == targets).mean())
    else:
        acc = vqa_accuracy(logits, targets)
    return {"vqa_accuracy": acc, "logits": logits, "targets": targets,
            "question_ids": kept["question_id"]}


def main(argv=None) -> dict:
    """Train and/or evaluate; returns {"train": each step's metrics, "eval":
    the last `evaluate` result, "test": the test split's} as far as they
    ran."""
    args = get_args(argv)
    check_args(args)
    if args.use_single and args.use_cls:
        raise ValueError("--use_single and --use_cls are mutually exclusive")
    device = run_device(args)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = setup_logger("vqa", args.output_dir)
    restore_training_settings(args, argv, logger=logger)

    if args.synthetic:
        paths = synth_root(args)
        args.train_jsonl = args.eval_jsonl = paths["vqa"]
        args.feature_tsv = paths["features"]
        args.id2phrase = paths["id2phrase"]
        args.label2ans = paths["label2ans"]
        vocab = paths["vocab"]
    else:
        vocab = os.path.join(args.model_name_or_path or args.data_dir,
                             "vocab.txt")
    tokenizer = FastBertTokenizer(vocab)
    with open(args.label2ans) as f:
        label2ans = json.load(f)
    n_ans = len(label2ans)
    sg2id = load_phrase_vocab(args.id2phrase) if args.id2phrase else None
    cfg = build_config(args, tokenizer, num_labels=n_ans,
                       loss_type=args.loss_type)
    features = FeatureStore(args.feature_tsv,
                            feature_dim=args.img_feature_dim)
    # sfmx trains on integer labels; bce and kl on the soft scores
    ds_kw = dict(sg2id=sg2id, cfg=tensorize_cfg(args),
                 label_mode="int" if args.loss_type == "sfmx" else "soft",
                 use_b_text=args.use_b_text, b_as_list=args.b_as_list)
    dataset = VQADataset(args.train_jsonl, features, tokenizer, n_ans,
                         **ds_kw)
    eval_dataset = (VQADataset(args.eval_jsonl, features, tokenizer, n_ans,
                               **ds_kw) if args.eval_jsonl else dataset)
    model_cls = (ClassificationPlusModel if args.use_single else
                 ClassificationModel if args.use_cls else VQAModel)
    model = model_cls(cfg, device=device, seed=args.seed)
    load_params_or_init(args, model, logger)
    loss_fn = vqa_loss_fn(args, cfg)

    out = {}

    def eval_hook(step):
        out["eval"] = evaluate(args, model, eval_dataset)
        acc = out["eval"]["vqa_accuracy"]
        logger.info(f"step {step}: vqa accuracy = {acc:.4f}")
        return {"vqa_accuracy": acc}

    if args.do_train:
        loop = TrainLoop(args, model, loss_fn, TaskFetch(dataset),
                         len(dataset), logger)
        tokenizer.save_pretrained(args.output_dir)
        out["train"] = loop.run(eval_hook if args.do_eval else None)
    elif args.do_eval:
        eval_hook(0)

    if args.test_jsonl:
        test_ds = VQADataset(args.test_jsonl, features, tokenizer, n_ans,
                             **ds_kw)
        out["test"] = res = evaluate(args, model, test_ds)
        results = [{"question_id": int(q), "answer": label2ans[int(a)]}
                   for q, a in zip(res["question_ids"],
                                   res["logits"].argmax(1))]
        split = os.path.splitext(os.path.basename(args.test_jsonl))[0]
        path = os.path.join(args.output_dir, f"{split}_results.json")
        with open(path, "w") as f:
            json.dump(results, f)
        logger.info(f"wrote {path}")
    logger.info("vqa done")
    return out


if __name__ == "__main__":
    main()
