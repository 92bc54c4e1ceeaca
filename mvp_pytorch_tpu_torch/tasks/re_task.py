"""Referring-expression fine-tuning and evaluation: the JAX package's
`tasks/re_task.py` on one device (reference `oscar/run_re.py`: per-region IoU
labels, `--loss_mod` 1 / 2 / 3, accuracy as the argmax region's IoU >= 0.5,
detection-grounded scores, `--phrase_layer` mid-layer readout).

`main` reads an expression JSON, a feature TSV and a vocab (or writes a
synthetic root with `--synthetic`), trains `REModel` through the process
loader and evaluates it, on the card unless `--platform cpu`:

    python -m mvp_pytorch_tpu_torch.tasks.re_task --output_dir /tmp/re \
        --synthetic --tiny --max_steps 10 --do_train --do_eval --platform cpu

`--det_json` adds `re_accuracy_det1` / `re_accuracy_det2` over external
detections; `--test_jsons` evaluates more splits beside `--eval_json`;
`--adjust_dp_step N` raises every hidden dropout to 0.3 from step N.
"""

from __future__ import annotations

import argparse
import os

from ..data.datasets import (FeatureStore, REDataset, load_phrase_vocab,
                             re_score, re_score_det1, re_score_det2)
from ..data.tokenization import FastBertTokenizer
from ..models.tasks import REModel
from ..utils.logger import setup_logger
from .common import (MODEL_KEYS, TaskFetch, TrainLoop, add_common_args,
                     adjust_dropout, build_config, check_args,
                     load_params_or_init, predict, restore_training_settings,
                     run_device, synth_root, tensorize_cfg)


def get_args(argv=None):
    p = argparse.ArgumentParser(description="referring-expression "
                                "fine-tuning and evaluation")
    add_common_args(p)
    p.add_argument("--train_json", type=str, default=None)
    p.add_argument("--eval_json", type=str, default=None)
    p.add_argument("--feature_tsv", type=str, default=None)
    p.add_argument("--id2phrase", type=str, default=None)
    p.add_argument("--loss_mod", type=int, default=1, choices=[1, 2, 3])
    p.add_argument("--phrase_layer", type=int, default=None,
                   help="read the regions at this fusion layer")
    p.add_argument("--det_json", type=str, default=None,
                   help="external detections {image_id: [[x1,y1,x2,y2]...]} "
                        "(normalized xyxy); adds re_accuracy_det1/2")
    p.add_argument("--max_det", type=int, default=20)
    p.add_argument("--test_jsons", type=str, default=None,
                   help="comma-separated extra eval splits, evaluated beside "
                        "--eval_json")
    p.add_argument("--adjust_dp_step", type=int, default=None,
                   help="raise every hidden dropout to 0.3 from this step "
                        "on (the attention-probability dropout keeps its "
                        "rate)")
    return p.parse_args(argv)


def re_loss_fn(args):
    """The Trainer's loss_fn: `REModel`'s loss at `--loss_mod`; the hidden
    dropouts follow `--adjust_dp_step`."""
    def loss_fn(model, batch, generator, step):
        adjust_dropout(model, step, args.adjust_dp_step)
        loss, _ = model(*(batch[k] for k in MODEL_KEYS),
                        labels=batch["label"],
                        max_tag_length=args.max_tag_length,
                        mod=args.loss_mod, phrase_layer=args.phrase_layer,
                        generator=generator)
        return loss, {}
    return loss_fn


def evaluate(args, model, dataset) -> dict:
    """Region scores over the dataset and the accuracies (with detections,
    also the two detection-grounded ones)."""
    use_det = dataset.det_boxes is not None
    logits, kept = predict(
        model, dataset, args.eval_batch_size,
        lambda m, *x: m(*x, max_tag_length=args.max_tag_length,
                        mod=args.loss_mod, phrase_layer=args.phrase_layer),
        keep=("label", "det_label", "iou_mat") if use_det else ("label",))
    scores = {"re_accuracy": re_score(logits, kept["label"])}
    if use_det:
        det = (logits, kept["label"], kept["det_label"], kept["iou_mat"])
        scores["re_accuracy_det1"] = re_score_det1(*det)
        scores["re_accuracy_det2"] = re_score_det2(*det)
    return {**scores, "logits": logits}


def main(argv=None) -> dict:
    """Train and/or evaluate; returns {"train": each step's metrics, "eval":
    the last eval split's `evaluate` result, "test": {split: result}} as far
    as they ran."""
    args = get_args(argv)
    check_args(args)
    device = run_device(args)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = setup_logger("re", args.output_dir)
    restore_training_settings(args, argv, logger=logger)

    if args.synthetic:
        paths = synth_root(args)
        args.train_json = args.eval_json = paths["re"]
        args.feature_tsv = paths["features"]
        args.id2phrase = paths["id2phrase"]
        if args.det_json:       # the synthetic root's detections
            args.det_json = paths["re_dets"]
        vocab = paths["vocab"]
    else:
        vocab = os.path.join(args.model_name_or_path or args.data_dir,
                             "vocab.txt")
    tokenizer = FastBertTokenizer(vocab)
    sg2id = load_phrase_vocab(args.id2phrase) if args.id2phrase else None
    cfg = build_config(args, tokenizer, num_labels=1, loss_type="sfmx")
    tcfg = tensorize_cfg(args)
    features = FeatureStore(args.feature_tsv,
                            feature_dim=args.img_feature_dim)
    dataset = REDataset(args.train_json, features, tokenizer, sg2id=sg2id,
                        cfg=tcfg)
    eval_dataset = (REDataset(args.eval_json, features, tokenizer,
                              sg2id=sg2id, cfg=tcfg, det_json=args.det_json,
                              max_det=args.max_det)
                    if args.eval_json else dataset)
    test_datasets = {
        os.path.splitext(os.path.basename(path))[0]: REDataset(
            path, features, tokenizer, sg2id=sg2id, cfg=tcfg,
            det_json=args.det_json, max_det=args.max_det)
        for path in (args.test_jsons.split(",") if args.test_jsons else [])}
    model = REModel(cfg, device=device, seed=args.seed)
    load_params_or_init(args, model, logger)

    out = {}

    def eval_hook(step):
        out["eval"] = evaluate(args, model, eval_dataset)
        scores = {k: v for k, v in out["eval"].items() if k != "logits"}
        out["test"] = {}
        for name, ds in test_datasets.items():
            out["test"][name] = evaluate(args, model, ds)
            for k, v in out["test"][name].items():
                if k != "logits":
                    scores[f"{name}/{k}"] = v
        logger.info(f"step {step}: " + "  ".join(
            f"{k}={v:.4f}" for k, v in scores.items()))
        return scores

    if args.do_train:
        loop = TrainLoop(args, model, re_loss_fn(args), TaskFetch(dataset),
                         len(dataset), logger)
        tokenizer.save_pretrained(args.output_dir)
        out["train"] = loop.run(eval_hook if args.do_eval else None)
    elif args.do_eval:
        eval_hook(0)
    logger.info("re done")
    return out


if __name__ == "__main__":
    main()
