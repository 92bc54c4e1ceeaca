"""SNLI-VE fine-tuning and evaluation: the JAX package's `tasks/ve.py` on
one device (reference `oscar/run_ve.py`: 3-class CE over hypothesis-image
pairs, `--freeze_steps` backbone freezing, `--use_single` the Plus
classifier).

`main` reads an SNLI-VE jsonl, a feature TSV and a vocab (or writes a
synthetic root with `--synthetic`), trains `ClassificationModel` through the
process loader and evaluates its accuracy, on the card unless `--platform
cpu`:

    python -m mvp_pytorch_tpu_torch.tasks.ve --output_dir /tmp/ve \
        --synthetic --tiny --max_steps 10 --do_train --do_eval --platform cpu

`--mask_training` masks 15 % of the hypothesis tokens of the training split,
anew each epoch (the loader's workers call `fetch(indices, epoch)`);
`--freeze_steps N` keeps every `bert.*` parameter for the first N steps;
`--adjust_dp_step N` raises every hidden dropout to 0.3 from step N.
"""

from __future__ import annotations

import argparse
import os

from ..data.datasets import FeatureStore, VEDataset, load_phrase_vocab
from ..data.tokenization import FastBertTokenizer
from ..models.tasks import ClassificationModel, ClassificationPlusModel
from ..utils.logger import setup_logger
from .common import (MODEL_KEYS, TaskFetch, TrainLoop, add_common_args,
                     adjust_dropout, build_config, check_args,
                     load_params_or_init, predict, restore_training_settings,
                     run_device, synth_root, tensorize_cfg)


def get_args(argv=None):
    p = argparse.ArgumentParser(description="SNLI-VE fine-tuning and "
                                "evaluation")
    add_common_args(p)
    p.add_argument("--train_jsonl", type=str, default=None)
    p.add_argument("--eval_jsonl", type=str, default=None)
    p.add_argument("--feature_tsv", type=str, default=None)
    p.add_argument("--id2phrase", type=str, default=None)
    p.add_argument("--use_b_text", action="store_true",
                   help="append the tags to stream A")
    p.add_argument("--b_as_list", action="store_true",
                   help="with --use_b_text: keep duplicate tags")
    p.add_argument("--mask_training", action="store_true",
                   help="[MASK] 15%% of the hypothesis tokens of the "
                        "training split, anew each epoch")
    p.add_argument("--use_single", action="store_true",
                   help="the fusion + single-stream Plus classifier")
    p.add_argument("--freeze_steps", type=int, default=0,
                   help="freeze the backbone (bert.*) for the first N steps")
    p.add_argument("--adjust_dp_step", type=int, default=None,
                   help="raise every hidden dropout to 0.3 from this step "
                        "on (the attention-probability dropout keeps its "
                        "rate)")
    return p.parse_args(argv)


def ve_loss_fn(args):
    """The Trainer's loss_fn: 3-class CE, with the batch accuracy as `acc`;
    the hidden dropouts follow `--adjust_dp_step`."""
    def loss_fn(model, batch, generator, step):
        adjust_dropout(model, step, args.adjust_dp_step)
        loss, logits = model(*(batch[k] for k in MODEL_KEYS),
                             labels=batch["label"],
                             max_tag_length=args.max_tag_length,
                             generator=generator)
        acc = (logits.argmax(1) == batch["label"]).float().mean()
        return loss, {"acc": acc}
    return loss_fn


def evaluate(args, model, dataset) -> dict:
    """Logits and labels over the dataset, and the accuracy."""
    logits, kept = predict(
        model, dataset, args.eval_batch_size,
        lambda m, *x: m(*x, max_tag_length=args.max_tag_length),
        keep=("label",))
    acc = float((logits.argmax(1) == kept["label"]).sum()) / max(
        len(dataset), 1)
    return {"ve_accuracy": acc, "logits": logits, "labels": kept["label"]}


def main(argv=None) -> dict:
    """Train and/or evaluate; returns {"train": each step's metrics, "eval":
    the last `evaluate` result} as far as they ran."""
    args = get_args(argv)
    check_args(args)
    device = run_device(args)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = setup_logger("ve", args.output_dir)
    restore_training_settings(args, argv, logger=logger)

    if args.synthetic:
        paths = synth_root(args)
        args.train_jsonl = args.eval_jsonl = paths["ve"]
        args.feature_tsv = paths["features"]
        args.id2phrase = paths["id2phrase"]
        vocab = paths["vocab"]
    else:
        vocab = os.path.join(args.model_name_or_path or args.data_dir,
                             "vocab.txt")
    tokenizer = FastBertTokenizer(vocab)
    sg2id = load_phrase_vocab(args.id2phrase) if args.id2phrase else None
    cfg = build_config(args, tokenizer, num_labels=3, loss_type="sfmx")
    features = FeatureStore(args.feature_tsv,
                            feature_dim=args.img_feature_dim)
    ds_kw = dict(sg2id=sg2id, cfg=tensorize_cfg(args),
                 use_b_text=args.use_b_text, b_as_list=args.b_as_list)
    # masking applies to the training split only
    dataset = VEDataset(args.train_jsonl, features, tokenizer,
                        mask_training=args.mask_training, seed=args.seed,
                        **ds_kw)
    eval_dataset = (VEDataset(args.eval_jsonl, features, tokenizer, **ds_kw)
                    if args.eval_jsonl else
                    VEDataset(args.train_jsonl, features, tokenizer, **ds_kw)
                    if args.mask_training else dataset)
    model_cls = (ClassificationPlusModel if args.use_single
                 else ClassificationModel)
    model = model_cls(cfg, device=device, seed=args.seed)
    load_params_or_init(args, model, logger)

    out = {}

    def eval_hook(step):
        out["eval"] = evaluate(args, model, eval_dataset)
        acc = out["eval"]["ve_accuracy"]
        logger.info(f"step {step}: ve accuracy = {acc:.4f}")
        return {"ve_accuracy": acc}

    if args.do_train:
        loop = TrainLoop(args, model, ve_loss_fn(args), TaskFetch(dataset),
                         len(dataset), logger,
                         freeze_prefix="bert" if args.freeze_steps else None,
                         freeze_steps=args.freeze_steps)
        tokenizer.save_pretrained(args.output_dir)
        out["train"] = loop.run(eval_hook if args.do_eval else None)
    elif args.do_eval:
        eval_hook(0)
    logger.info("ve done")
    return out


if __name__ == "__main__":
    main()
