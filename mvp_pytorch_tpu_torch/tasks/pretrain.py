"""MVPTR pretraining: the loss, training over in-memory batches, and the
dataset-driven command line.

`pretrain_loss_fn` is the counterpart of the JAX package's pretraining
task's `forward` + `loss_fn` (`mvp_pytorch_tpu/tasks/pretrain.py:303-358`)
without the extra corpus, MoE and `--visual_learning`: the composite loss of
`BiPretrainModel.train_step` at the config's dropouts, with the tag MLM,
CLIP, text MLM, ITM, WRA and (when the batch has them) QA losses as metrics.
`train_pretrain` runs it under AdamW and the single-device `Trainer` over
in-memory batches (`training/loop.py`).

A batch maps the model's argument names (`input_ids_a`, `attention_mask_a`,
`token_type_ids_a`, `lm_label_ids_a`, `input_ids_b`, `attention_mask_b`,
`token_type_ids_b`, `lm_label_ids_b`, `img_feats`, `phrase_index`,
`image_index`, optionally `qa_ans` and `qa_is_next`) to arrays with the batch
first.

`main` is the JAX package's `tasks/pretrain.py` `main` (:128-413): it reads a
corpus TSV and a feature TSV (or a multi-corpus YAML manifest,
`--dataset_yaml`; or writes a synthetic root with `--synthetic`), masks each
example in the loader's worker processes (`PretrainDataset`, keyed on seed,
epoch and index) and trains through `tasks/common.py` `TrainLoop`, on the
card unless `--platform cpu`:

    python -m mvp_pytorch_tpu_torch.tasks.pretrain --output_dir /tmp/pt \
        --synthetic --tiny --max_steps 10 --train_batch_size 8 --platform cpu

The extra uni-modal corpus (`--extra_mode`), MoE (`--moe_experts`,
`--moe_top_k`) and `--visual_learning` raise, naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..data.datasets import (FeatureStore, MultiCorpusPretrainDataset,
                             PretrainDataset, load_phrase_vocab)
from ..data.tokenization import FastBertTokenizer
from ..models.pretrain import BiPretrainModel
from ..training.loop import batch_on, train_on_batches
from ..utils.logger import setup_logger
from . import retrieval
from .common import (TrainLoop, add_common_args, build_config, check_args,
                     load_params_or_init, run_device, synth_root,
                     tensorize_cfg)

PRETRAIN_KEYS = ("input_ids_a", "attention_mask_a", "token_type_ids_a",
                 "lm_label_ids_a", "input_ids_b", "attention_mask_b",
                 "token_type_ids_b", "lm_label_ids_b", "img_feats",
                 "phrase_index", "image_index", "qa_ans", "qa_is_next")


def pretrain_loss_fn(*, max_tag_length: int = 20, hn_mod: str = "hard",
                     phrase_mod: str = "sample", max_pred_a: int = 20,
                     max_pred_b: int = 10, wra_phrase_width: int = 10,
                     phrase_layer: Optional[int] = None, hn_dice=None,
                     wra_pick: Optional[int] = None,
                     wra_neg_offset: Optional[int] = None):
    """The Trainer's loss_fn for `BiPretrainModel.train_step`: the total
    loss, with `vis_mlm`, `clip`, `mlm`, `itm`, `wra` (with phrase spans in
    the batch) and `qa` (with `qa_ans` or `qa_is_next`) as metrics.
    `hn_dice`, `wra_pick` and `wra_neg_offset` pin those draws in every
    step (test hooks, as in the JAX package)."""
    def loss_fn(model, batch, generator):
        out = model.train_step(
            *(batch.get(k) for k in PRETRAIN_KEYS),
            max_tag_length=max_tag_length, max_pred_a=max_pred_a,
            max_pred_b=max_pred_b, hn_mod=hn_mod, phrase_mod=phrase_mod,
            wra_phrase_width=wra_phrase_width, phrase_layer=phrase_layer,
            hn_dice=hn_dice, generator=generator, wra_pick=wra_pick,
            wra_neg_offset=wra_neg_offset)
        metrics = {"vis_mlm": out.vis_mlm_loss, "clip": out.retrieval_loss,
                   "mlm": out.masked_lm_loss, "itm": out.itm_loss}
        if out.wra_loss is not None:
            metrics["wra"] = out.wra_loss
        if out.qa_loss is not None:
            metrics["qa"] = out.qa_loss
        return out.total_loss, metrics
    return loss_fn


def train_pretrain(model, batches: Sequence[Mapping], steps: int, *,
                   learning_rate: float = 1e-4, warmup_steps: int = 0,
                   schedule: str = "linear", weight_decay: float = 0.01,
                   max_grad_norm: Optional[float] = 1.0, grad_accum: int = 1,
                   seed: int = 0, max_tag_length: int = 20,
                   hn_mod: str = "hard", phrase_mod: str = "sample",
                   max_pred_a: int = 20, max_pred_b: int = 10,
                   wra_phrase_width: int = 10,
                   phrase_layer: Optional[int] = None,
                   output_dir: Optional[str] = None, ckpt_period: int = 0,
                   keep: int = 3, log_period: int = 0,
                   logger=print) -> List[Dict[str, float]]:
    """Pretrain `model` (a `BiPretrainModel`) for `steps` steps, cycling
    over `batches`. Returns each step's metrics.

    With `output_dir`, metrics go to `metrics.jsonl` there, a checkpoint is
    saved every `ckpt_period` steps and after the last, and training resumes
    from the newest checkpoint found there. The model is left in eval
    mode."""
    return train_on_batches(
        model, pretrain_loss_fn(
            max_tag_length=max_tag_length, hn_mod=hn_mod,
            phrase_mod=phrase_mod, max_pred_a=max_pred_a,
            max_pred_b=max_pred_b, wra_phrase_width=wra_phrase_width,
            phrase_layer=phrase_layer),
        batches, steps, learning_rate=learning_rate,
        warmup_steps=warmup_steps, schedule=schedule,
        weight_decay=weight_decay, max_grad_norm=max_grad_norm,
        grad_accum=grad_accum, seed=seed, output_dir=output_dir,
        ckpt_period=ckpt_period, keep=keep, log_period=log_period,
        logger=logger)


# ---------------------------------------------------------------------------
# the dataset-driven command line
# ---------------------------------------------------------------------------

# flag -> (value that means "off", the ROADMAP queue 1 item it waits for)
LATER_ITEMS = {
    "extra_mode": (None, "item 3 (TextOnlyDataset / ImgOnlyDataset, "
                         "--extra_mode)"),
    "moe_experts": (0, "item 6 (EP MoE, ops/moe.py)"),
    "moe_top_k": (None, "item 6 (EP MoE, ops/moe.py)"),
    "visual_learning": (False, "item 3 (models/img_bert.py, "
                               "--visual_learning)"),
}
# the data plane's array names -> the model's: the retrieval task's, and the
# labels under their own names
PORT_NAMES = {**retrieval.PORT_NAMES, **{k: k for k in (
    "lm_label_ids_a", "lm_label_ids_b", "qa_ans", "qa_is_next")}}


def get_args(argv=None):
    p = argparse.ArgumentParser(description="MVPTR pretraining from a "
                                "corpus TSV and a feature TSV")
    add_common_args(p)
    p.add_argument("--corpus_tsv", type=str, default=None)
    p.add_argument("--dataset_yaml", type=str, default=None,
                   help="multi-corpus yaml manifest (reference "
                        "--data_dir+yaml contract)")
    p.add_argument("--feature_tsv", type=str, default=None)
    p.add_argument("--id2phrase", type=str, default=None)
    p.add_argument("--tag2id", type=str, default=None)
    p.add_argument("--hn_mod", type=str, default="hard",
                   choices=["hard", "sample"])
    p.add_argument("--phrase_mod", type=str, default="sample",
                   choices=["sample", "hard"])
    p.add_argument("--wra_layer", type=int, default=None,
                   help="mid fusion layer for WRA (reference --wra_layer)")
    p.add_argument("--mask_prob", type=float, default=0.15)
    p.add_argument("--use_qa", action="store_true")
    p.add_argument("--qa_answer_size", type=int, default=0)
    p.add_argument("--use_qa_pairs", action="store_true",
                   help="train the qa_seq_relation head on QA rows "
                        "(corpus col 5 = answer text)")
    p.add_argument("--only_qa", action="store_true",
                   help="keep only QA-pair corpus rows")
    p.add_argument("--only_cap", action="store_true",
                   help="keep only caption (non-QA) corpus rows")
    p.add_argument("--exclude_ids_file", type=str, default=None,
                   help="newline-separated image ids to drop (reference "
                        "--no_fk_test + fk_test_id yaml key)")
    p.add_argument("--gt_labels_json", type=str, default=None,
                   help="{image_id: [class, ...]} ground-truth tag map; "
                        "replaces predicted tags when present (reference "
                        "--use_gtlabels, oscar_tsv4.py:201-207)")
    p.add_argument("--max_pred_a", type=int, default=20)
    p.add_argument("--max_pred_b", type=int, default=10)
    # flags of later port items: accepted so that they can raise by name
    p.add_argument("--moe_experts", type=int, default=None,
                   help="MoE FFN experts (not ported yet)")
    p.add_argument("--moe_top_k", type=int, default=None,
                   help="experts per token (not ported yet)")
    p.add_argument("--moe_aux_weight", type=float, default=0.01)
    p.add_argument("--extra_mode", type=str, default=None,
                   choices=[None, "text_only", "img_only"],
                   help="extra uni-modal corpus (not ported yet)")
    p.add_argument("--extra_corpus_tsv", type=str, default=None)
    p.add_argument("--extra_loss_weight", type=float, default=0.2)
    p.add_argument("--extra_batch_divisor", type=int, default=5)
    p.add_argument("--visual_learning", action="store_true",
                   help="single-stream masked-region pretraining (not "
                        "ported yet)")
    p.add_argument("--mlm_debug", action="store_true",
                   help="after training, dump one batch of MLM inputs + "
                        "top-1 predictions to output_dir/mlm_res.npz and "
                        "log the first tensorized example (the reference's "
                        "--mlm_debug mlm_res.pt dump + guid<1 sample dump)")
    return p.parse_args(argv)


class PretrainFetch:
    """`dataset.fetch(indices, epoch)` under the model's array names, with
    only the arrays the step reads: `qa_ans` with `use_qa`, `qa_is_next`
    with `use_qa_pairs`, never `is_next` / `is_img_match` (picklable, for
    spawned loader workers)."""

    def __init__(self, dataset, use_qa: bool = False,
                 use_qa_pairs: bool = False):
        self.dataset = dataset
        self.keys = [k for k in PORT_NAMES
                     if (k != "qa_ans" or use_qa)
                     and (k != "qa_is_next" or use_qa_pairs)]

    def __call__(self, indices, epoch: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
        batch = self.dataset.fetch(indices, epoch)
        return {PORT_NAMES[k]: batch[k] for k in self.keys}


def build_dataset(args, tokenizer, cfg):
    """`PretrainDataset` over --corpus_tsv / --feature_tsv, or
    `MultiCorpusPretrainDataset` from --dataset_yaml."""
    tcfg = tensorize_cfg(args)
    exclude_ids = None
    if args.exclude_ids_file:
        with open(args.exclude_ids_file) as f:
            exclude_ids = {ln.strip() for ln in f if ln.strip()}
    if args.dataset_yaml:
        return MultiCorpusPretrainDataset.from_yaml(
            args.dataset_yaml, tokenizer, cfg=tcfg, seed=args.seed,
            mask_prob=args.mask_prob, qa_pairs=args.use_qa_pairs,
            only_qa=args.only_qa, only_cap=args.only_cap,
            exclude_ids=exclude_ids, gt_labels_json=args.gt_labels_json,
            feature_dim=args.img_feature_dim)
    sg2id = load_phrase_vocab(args.id2phrase) if args.id2phrase else None
    tag2id = {}
    if args.tag2id:
        with open(args.tag2id) as f:
            tag2id = json.load(f)
    # MVPTR's tag MLM predicts tag wordpieces: tags go through the vocab
    wp_tag2id = {t: tokenizer.vocab.get(t, tokenizer.vocab["[UNK]"])
                 for t in tag2id}
    return PretrainDataset(
        args.corpus_tsv, FeatureStore(args.feature_tsv,
                                      feature_dim=args.img_feature_dim),
        tokenizer, sg2id=sg2id, cfg=tcfg, tag2id=wp_tag2id,
        phrase_vocab_size=cfg.vocab_size - cfg.only_word_size,
        seed=args.seed, mask_prob=args.mask_prob, mask_visual=True,
        qa_pairs=args.use_qa_pairs, only_qa=args.only_qa,
        only_cap=args.only_cap, exclude_ids=exclude_ids,
        gt_labels_json=args.gt_labels_json)


def mlm_debug_dump(args, model, fetch, n, logger) -> str:
    """One forward without dropout over the first `n` examples: their inputs
    and the text MLM's top-1 predictions, labels and weights into
    output_dir/mlm_res.npz (the reference's mlm_res.pt), and the masked
    positions' top-1 accuracy in the log."""
    raw = fetch(np.arange(n))
    batch = batch_on(model.device, raw)
    model.eval()
    with torch.no_grad():
        out = model.train_step(
            *(batch.get(k) for k in PRETRAIN_KEYS),
            max_tag_length=args.max_tag_length, max_pred_a=args.max_pred_a,
            max_pred_b=args.max_pred_b, hn_mod=args.hn_mod,
            phrase_mod=args.phrase_mod, phrase_layer=args.wra_layer,
            generator=torch.Generator(device=model.device).manual_seed(0),
            debug_mlm=True)
    pred, labels, weights = (t.cpu().numpy() for t in out.mlm_debug)
    pred, labels = pred.astype(np.int32), labels.astype(np.int32)
    weights = weights.astype(np.float32)
    path = os.path.join(args.output_dir, "mlm_res.npz")
    np.savez(path, input_ids_a=raw["input_ids_a"],
             lm_label_ids_a=raw["lm_label_ids_a"], mlm_pred=pred,
             mlm_labels=labels, mlm_weights=weights)
    acc = float(((pred == labels) * weights).sum() / max(weights.sum(), 1.0))
    logger.info(f"mlm_debug: dumped {path} (masked-token top-1 "
                f"acc {acc:.4f} over {int(weights.sum())} positions)")
    return path


def main(argv=None) -> dict:
    """Pretrain; returns {"train": each step's metrics} (and with
    --mlm_debug, "mlm_debug": the dump's path)."""
    args = get_args(argv)
    check_args(args, LATER_ITEMS)
    device = run_device(args)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = setup_logger("pretrain", args.output_dir)

    if args.synthetic:
        paths = synth_root(args)
        args.corpus_tsv = paths["corpus"]
        args.feature_tsv = paths["features"]
        args.id2phrase = paths["id2phrase"]
        args.tag2id = paths["tag2id"]
        vocab = paths["vocab"]
        if args.use_qa and args.qa_answer_size == 0:
            args.qa_answer_size = 7
    else:
        vocab = os.path.join(args.model_name_or_path or args.data_dir,
                             "vocab.txt")
    tokenizer = FastBertTokenizer(vocab)
    logger.info(f"device {device}; native tokenizer and feature decode: "
                f"{'on' if tokenizer.native_active else 'off'}")
    cfg = build_config(args, tokenizer, qa_answer_size=args.qa_answer_size)
    dataset = build_dataset(args, tokenizer, cfg)
    logger.info(f"corpus: {len(dataset)} examples")

    model = BiPretrainModel(cfg, qa_pairs=args.use_qa_pairs, device=device,
                            seed=args.seed)
    load_params_or_init(args, model, logger)
    loss_fn = pretrain_loss_fn(
        max_tag_length=args.max_tag_length, hn_mod=args.hn_mod,
        phrase_mod=args.phrase_mod, max_pred_a=args.max_pred_a,
        max_pred_b=args.max_pred_b, phrase_layer=args.wra_layer)
    fetch = PretrainFetch(dataset, args.use_qa, args.use_qa_pairs)
    if args.mlm_debug:
        # the reference's guid < 1 sample dump (oscar_tsv4.py:1063-1077)
        ids = [int(i) for i in dataset.fetch(np.arange(1))["input_ids_a"][0]
               if i != 0]
        logger.info("mlm_debug sample 0 tokens_a: "
                    f"{tokenizer.convert_ids_to_tokens(ids)}")

    loop = TrainLoop(args, model, loss_fn, fetch, len(dataset), logger)
    tokenizer.save_pretrained(args.output_dir)
    out = {"train": loop.run()}
    if args.mlm_debug:
        out["mlm_debug"] = mlm_debug_dump(
            args, model, fetch, min(args.train_batch_size, len(dataset)),
            logger)
    logger.info("pretraining done")
    return out


if __name__ == "__main__":
    main()
