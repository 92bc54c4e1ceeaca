"""MVPTR pretraining: the losses, training over in-memory batches, and the
dataset-driven command line.

`pretrain_loss_fn` is the counterpart of the JAX package's pretraining
task's `forward` + `loss_fn` (`mvp_pytorch_tpu/tasks/pretrain.py:303-358`):
the composite loss of `BiPretrainModel.train_step` at the
config's dropouts, with the tag MLM, CLIP, text MLM, ITM, WRA and (when the
batch has them) QA losses as metrics; with `extra_loss_weight` w, also the
extra uni-modal sub-batch's loss (`--extra_mode`), the total being
(1 - w) main + w extra; with MoE layers (`--moe_experts`), plus
`--moe_aux_weight` times the load-balance penalty sum(aux - 1) over every
MoE call of the step (`ops/moe.py`). `single_stream_loss_fn` is `--visual_learning`'s:
`ImgBertForPreTraining` (MLM, ITM, MRC, MRF) over the two streams fused into
one sequence (`single_stream_batch`). `train_pretrain` runs the first under
AdamW and the single-device `Trainer` over in-memory batches
(`training/loop.py`).

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

With `--visual_learning` it trains the single-stream model over
[text ; tags ; regions] (it needs `--tag2id`: the MRC head classifies the
raw tag class ids); with `--extra_mode text_only | img_only` every batch
carries a sub-batch of 1 / `--extra_batch_divisor` the size from a
text-only or image-only stream (`CombinedDataset`), under keys prefixed
`extra/` (the loader moves one flat dict of arrays). `--moe_experts E`
(and `--moe_top_k`) make every `moe_every`-th encoder layer's FFN an
`MoEMLP` of E experts; given explicitly, they override a checkpoint's
config, else a resumed MoE run keeps its own. `--visual_learning` refuses
them, as the JAX driver does.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import (Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence)

import numpy as np
import torch

from ..data.datasets import (FeatureStore, ImgOnlyDataset,
                             MultiCorpusPretrainDataset, PretrainDataset,
                             TextOnlyDataset, load_phrase_vocab)
from ..data.tokenization import FastBertTokenizer
from ..models.img_bert import ImgBertForPreTraining
from ..models.pretrain import BiPretrainModel
from ..ops.moe import collect_aux, moe_aux_loss
from ..parallel.collectives import LOCAL
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
# `ImgBertForPreTraining`'s inputs, in its order (`--visual_learning`)
SINGLE_STREAM_KEYS = ("input_ids", "attention_mask", "token_type_ids",
                      "img_feats", "masked_lm_labels", "next_sentence_label",
                      "masked_region_labels", "masked_region_targets",
                      "masked_region_flags")
# the extra stream's arrays in a batch (`--extra_mode`)
EXTRA_PREFIX = "extra/"
# what the extra stream's forward goes without (the JAX task's
# `with_phrases=False`)
EXTRA_DROPS = ("phrase_index", "image_index", "qa_ans", "qa_is_next")


def pretrain_loss_fn(*, max_tag_length: int = 20, hn_mod: str = "hard",
                     phrase_mod: str = "sample", max_pred_a: int = 20,
                     max_pred_b: int = 10, wra_phrase_width: int = 10,
                     phrase_layer: Optional[int] = None, hn_dice=None,
                     wra_pick: Optional[int] = None,
                     wra_neg_offset: Optional[int] = None,
                     extra_loss_weight: Optional[float] = None,
                     moe_aux_weight: Optional[float] = None):
    """The Trainer's loss_fn for `BiPretrainModel.train_step`: the total
    loss, with `vis_mlm`, `clip`, `mlm`, `itm`, `wra` (with phrase spans in
    the batch) and `qa` (with `qa_ans` or `qa_is_next`) as metrics.
    With `extra_loss_weight` w the batch also holds the extra stream's
    sub-batch (keys prefixed `EXTRA_PREFIX`), which takes a second
    `train_step` without phrase spans or QA labels; the loss is then
    (1 - w) main + w extra, and `extra` the extra stream's total. With
    `moe_aux_weight` the loss adds that times `ops.moe.moe_aux_loss` over
    both forwards, and `moe_aux` is a metric. `hn_dice`,
    `wra_pick` and `wra_neg_offset` pin those draws in every step and
    forward (test hooks, as in the JAX package). The losses span the
    Trainer's `global_batch`."""
    def forward(model, batch, generator, global_batch):
        return model.train_step(
            *(batch.get(k) for k in PRETRAIN_KEYS),
            max_tag_length=max_tag_length, max_pred_a=max_pred_a,
            max_pred_b=max_pred_b, hn_mod=hn_mod, phrase_mod=phrase_mod,
            wra_phrase_width=wra_phrase_width, phrase_layer=phrase_layer,
            hn_dice=hn_dice, generator=generator, wra_pick=wra_pick,
            wra_neg_offset=wra_neg_offset, global_batch=global_batch)

    def loss_fn(model, batch, generator, global_batch=LOCAL):
        main, extra = split_extra(batch)
        with collect_aux(model) as aux_values:
            out = forward(model, main, generator, global_batch)
            if extra_loss_weight is not None:
                extra_total = forward(model, extra, generator,
                                      global_batch).total_loss
        metrics = {"vis_mlm": out.vis_mlm_loss, "clip": out.retrieval_loss,
                   "mlm": out.masked_lm_loss, "itm": out.itm_loss}
        if out.wra_loss is not None:
            metrics["wra"] = out.wra_loss
        if out.qa_loss is not None:
            metrics["qa"] = out.qa_loss
        total = out.total_loss
        if extra_loss_weight is not None:
            total = ((1.0 - extra_loss_weight) * total
                     + extra_loss_weight * extra_total)
            metrics["extra"] = extra_total
        if moe_aux_weight is not None:
            aux = moe_aux_loss(aux_values, total.device)
            total = total + moe_aux_weight * aux
            metrics["moe_aux"] = aux
        return total, metrics
    return loss_fn


def split_extra(batch: Mapping) -> tuple:
    """A batch -> (the main stream's arrays, the extra stream's under their
    own names)."""
    n = len(EXTRA_PREFIX)
    main = {k: v for k, v in batch.items() if not k.startswith(EXTRA_PREFIX)}
    extra = {k[n:]: v for k, v in batch.items()
             if k.startswith(EXTRA_PREFIX)}
    return main, extra


def single_stream_batch(batch: Mapping[str, np.ndarray],
                        max_tag_length: int) -> Dict[str, np.ndarray]:
    """A `visual_learning` pretraining batch of the data plane -> the
    single-stream model's inputs (the JAX task's `vl_kwargs`,
    `mvp_pytorch_tpu/tasks/pretrain.py:222-242`): the text ids, masks and
    segments of stream A then stream B (whose mask already spans the tags
    and the regions), the regions, the MLM labels of A and of B's tags, ITM
    labels, and the masked regions' tag classes, pre-mask features and
    flags."""
    def cat(a, b):
        return np.concatenate([batch[a], batch[b]], 1)
    return dict(
        input_ids=cat("input_ids_a", "input_ids_b"),
        attention_mask=cat("input_mask_a", "input_mask_b"),
        token_type_ids=cat("segment_ids_a", "segment_ids_b"),
        img_feats=batch["img_feat"],
        masked_lm_labels=np.concatenate(
            [batch["lm_label_ids_a"],
             batch["lm_label_ids_b"][:, :max_tag_length]], 1),
        next_sentence_label=batch["is_next"],
        masked_region_labels=batch["visual_labels"],
        masked_region_targets=batch["target_img_feat"],
        masked_region_flags=batch["mask_region_id"])


def single_stream_loss_fn(*, max_pred: int = 30):
    """The Trainer's loss_fn for `ImgBertForPreTraining` over a
    `single_stream_batch`: the total loss, with `mlm`, `itm`, `mrc` and
    `mrf` as metrics (those the batch has labels for), over the Trainer's
    `global_batch`."""
    names = {"mlm": "mlm_loss", "itm": "itm_loss", "mrc": "mrc_loss",
             "mrf": "mrf_loss"}

    def loss_fn(model, batch, generator, global_batch=LOCAL):
        out = model(*(batch.get(k) for k in SINGLE_STREAM_KEYS),
                    max_pred=max_pred, generator=generator,
                    global_batch=global_batch)
        return out["total_loss"], {k: out[v] for k, v in names.items()
                                   if v in out}
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

# flag -> (value that means "off", the ROADMAP queue 1 item it waits for):
# none of the pretraining driver's own flags waits any more
LATER_ITEMS: Dict[str, tuple] = {}
# what --visual_learning cannot be combined with (the JAX task's asserts,
# mvp_pytorch_tpu/tasks/pretrain.py:157-172)
VISUAL_LEARNING_REFUSES = ("use_qa", "use_qa_pairs", "mlm_debug",
                           "extra_mode", "moe_experts")
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
    p.add_argument("--moe_experts", type=int, default=None,
                   help="replace the FFN of every moe_every-th encoder "
                        "layer with an E-expert MoE (experts split over "
                        "--model_parallel ranks)")
    p.add_argument("--moe_top_k", type=int, default=None,
                   help="experts per token (renormalised gates)")
    p.add_argument("--moe_aux_weight", type=float, default=0.01,
                   help="weight of the load-balance penalty sum(aux - 1)")
    # extra uni-modal stream (reference make_full_data_loader_ds +
    # --extra_dataset_file/--extra_loss_weight, run_pretrain_ml.py:59,149,
    # 618-623)
    p.add_argument("--extra_mode", type=str, default=None,
                   choices=[None, "text_only", "img_only"])
    p.add_argument("--extra_corpus_tsv", type=str, default=None)
    p.add_argument("--extra_loss_weight", type=float, default=0.2)
    p.add_argument("--extra_batch_divisor", type=int, default=5,
                   help="extra batch = train_batch / divisor (reference 1/5)")
    p.add_argument("--visual_learning", action="store_true",
                   help="single-stream masked-region pretraining (MLM + "
                        "seq-rel + MRC tag classification + MRF feature "
                        "regression) over ImgBertForPreTraining, the "
                        "reference's --visual_learning mode "
                        "(run_pretrain_ml.py:161,596-600); requires "
                        "--tag2id (raw tag -> class-id json)")
    p.add_argument("--mlm_debug", action="store_true",
                   help="after training, dump one batch of MLM inputs + "
                        "top-1 predictions to output_dir/mlm_res.npz and "
                        "log the first tensorized example (the reference's "
                        "--mlm_debug mlm_res.pt dump + guid<1 sample dump)")
    return p.parse_args(argv)


class CombinedDataset:
    """The main pretraining stream and an extra uni-modal one: a fetch
    returns {"main": the main batch, "extra": len(indices) // divisor (at
    least 1) examples of the extra stream at (indices * 7919 + 13) mod its
    length}, both masked for the same epoch (the JAX task's
    `CombinedDataset`, mvp_pytorch_tpu/tasks/pretrain.py:105-125)."""

    def __init__(self, main, extra, divisor: int):
        self.main = main
        self.extra = extra
        self.divisor = max(1, divisor)

    def __len__(self):
        return len(self.main)

    def fetch(self, indices, epoch: Optional[int] = None) -> Dict[str, Dict]:
        n_extra = max(1, len(indices) // self.divisor)
        extra_idx = ((np.asarray(indices[:n_extra]) * 7919 + 13)
                     % len(self.extra))
        return {"main": self.main.fetch(indices, epoch),
                "extra": self.extra.fetch(extra_idx, epoch)}


class PretrainFetch:
    """`dataset.fetch(indices, epoch)` under the model's array names, with
    only the arrays the step reads: `qa_ans` with `use_qa`, `qa_is_next`
    with `use_qa_pairs`, never `is_next` / `is_img_match`. With
    `visual_learning`, the single-stream model's inputs instead
    (`single_stream_batch`: `is_next`, the region labels, targets and flags
    among them). Over a `CombinedDataset`, one flat dict: the main batch,
    and the extra one's arrays but `EXTRA_DROPS` under `EXTRA_PREFIX`
    (picklable, for spawned loader workers)."""

    def __init__(self, dataset, use_qa: bool = False,
                 use_qa_pairs: bool = False, visual_learning: bool = False,
                 max_tag_length: int = 20):
        self.dataset = dataset
        self.visual_learning = visual_learning
        self.max_tag_length = max_tag_length
        self.keys = [k for k in PORT_NAMES
                     if (k != "qa_ans" or use_qa)
                     and (k != "qa_is_next" or use_qa_pairs)]
        self.extra_keys = [k for k in PORT_NAMES
                           if PORT_NAMES[k] not in EXTRA_DROPS]

    def __call__(self, indices, epoch: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
        batch = self.dataset.fetch(indices, epoch)
        if self.visual_learning:
            return single_stream_batch(batch, self.max_tag_length)
        if isinstance(self.dataset, CombinedDataset):
            out = {PORT_NAMES[k]: batch["main"][k] for k in self.keys}
            out.update({EXTRA_PREFIX + PORT_NAMES[k]: batch["extra"][k]
                        for k in self.extra_keys})
            return out
        return {PORT_NAMES[k]: batch[k] for k in self.keys}


def read_tag2id(args) -> Dict[str, int]:
    """--tag2id's {tag: class id}, or {} without it."""
    if not args.tag2id:
        return {}
    with open(args.tag2id) as f:
        return json.load(f)


def check_visual_learning(args) -> None:
    """--visual_learning needs --tag2id (or --synthetic, which writes one)
    and refuses VISUAL_LEARNING_REFUSES."""
    if not args.visual_learning:
        return
    if not (args.tag2id or args.synthetic):
        raise ValueError("--visual_learning requires --tag2id")
    for flag in VISUAL_LEARNING_REFUSES:
        if getattr(args, flag) not in (None, False, 0):
            raise ValueError(f"--visual_learning is incompatible with "
                             f"--{flag}")


def build_dataset(args, tokenizer, cfg):
    """`PretrainDataset` over --corpus_tsv / --feature_tsv, or
    `MultiCorpusPretrainDataset` from --dataset_yaml. Its tag MLM labels
    tags by their wordpiece ids; with --visual_learning the masked regions
    are labelled by --tag2id's raw class ids instead, and the examples carry
    the masked-region supervision."""
    tcfg = tensorize_cfg(args)
    vl = args.visual_learning
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
            feature_dim=args.img_feature_dim, visual_learning=vl,
            override_tag2id=read_tag2id(args) if vl else None)
    sg2id = load_phrase_vocab(args.id2phrase) if args.id2phrase else None
    tag2id = read_tag2id(args)
    if not vl:
        # MVPTR's tag MLM predicts tag wordpieces: tags go through the vocab
        tag2id = {t: tokenizer.vocab.get(t, tokenizer.vocab["[UNK]"])
                  for t in tag2id}
    return PretrainDataset(
        args.corpus_tsv, FeatureStore(args.feature_tsv,
                                      feature_dim=args.img_feature_dim),
        tokenizer, sg2id=sg2id, cfg=tcfg, tag2id=tag2id,
        phrase_vocab_size=cfg.vocab_size - cfg.only_word_size,
        seed=args.seed, mask_prob=args.mask_prob, mask_visual=True,
        qa_pairs=args.use_qa_pairs, only_qa=args.only_qa,
        only_cap=args.only_cap, exclude_ids=exclude_ids,
        gt_labels_json=args.gt_labels_json, visual_learning=vl)


def extra_dataset(args, tokenizer):
    """--extra_mode's stream: `TextOnlyDataset` over --extra_corpus_tsv (or
    the corpus), `ImgOnlyDataset` over --feature_tsv, or None."""
    tcfg = tensorize_cfg(args)
    if args.extra_mode == "text_only":
        return TextOnlyDataset(args.extra_corpus_tsv or args.corpus_tsv,
                               tokenizer, cfg=tcfg, seed=args.seed,
                               mask_prob=args.mask_prob)
    if args.extra_mode == "img_only":
        return ImgOnlyDataset(
            FeatureStore(args.feature_tsv, feature_dim=args.img_feature_dim),
            tokenizer, cfg=tcfg, seed=args.seed, mask_prob=args.mask_prob)
    return None


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


class PretrainRun(NamedTuple):
    """What the command line trains: the model, its loss_fn, the loader's
    fetch, the corpus dataset and the dataset the sampler indexes (the
    corpus, or a `CombinedDataset` with the extra stream)."""
    model: torch.nn.Module
    loss_fn: Callable
    fetch: PretrainFetch
    main_dataset: object
    dataset: object


def resolve_data(args) -> str:
    """With --synthetic, write (or reuse) the synthetic root and point the
    data flags at it. Returns the vocabulary's path."""
    if not args.synthetic:
        return os.path.join(args.model_name_or_path or args.data_dir,
                            "vocab.txt")
    paths = synth_root(args)
    args.corpus_tsv = paths["corpus"]
    args.feature_tsv = paths["features"]
    args.id2phrase = paths["id2phrase"]
    args.tag2id = paths["tag2id"]
    if args.use_qa and args.qa_answer_size == 0:
        args.qa_answer_size = 7
    return paths["vocab"]


def prepare(args, tokenizer, device, logger) -> PretrainRun:
    """The datasets, the model (`BiPretrainModel`, or with --visual_learning
    `ImgBertForPreTraining` with an MRC head over --tag2id's classes), its
    weights (--model_name_or_path's, else seeded), its loss_fn and the
    loader's fetch, as `main` trains them."""
    moe = {k: getattr(args, k) for k in ("moe_experts", "moe_top_k")
           if getattr(args, k) is not None}
    cfg = build_config(args, tokenizer, qa_answer_size=args.qa_answer_size,
                       **moe)
    main_dataset = build_dataset(args, tokenizer, cfg)
    logger.info(f"corpus: {len(main_dataset)} examples")
    extra = extra_dataset(args, tokenizer)
    dataset = main_dataset
    if extra is not None:
        logger.info(f"extra stream ({args.extra_mode}): {len(extra)} "
                    f"examples, 1/{args.extra_batch_divisor} of a batch, "
                    f"loss weight {args.extra_loss_weight}")
        dataset = CombinedDataset(main_dataset, extra,
                                  args.extra_batch_divisor)
    if args.visual_learning:
        model = ImgBertForPreTraining(
            cfg, use_mrfr=True, od_tag_size=len(read_tag2id(args)),
            device=device, seed=args.seed)
        loss_fn = single_stream_loss_fn(
            max_pred=args.max_pred_a + args.max_pred_b)
    else:
        model = BiPretrainModel(cfg, qa_pairs=args.use_qa_pairs,
                                device=device, seed=args.seed)
        loss_fn = pretrain_loss_fn(
            max_tag_length=args.max_tag_length, hn_mod=args.hn_mod,
            phrase_mod=args.phrase_mod, max_pred_a=args.max_pred_a,
            max_pred_b=args.max_pred_b, phrase_layer=args.wra_layer,
            extra_loss_weight=(args.extra_loss_weight if extra is not None
                               else None),
            moe_aux_weight=(args.moe_aux_weight if cfg.moe_experts > 0
                            else None))
    load_params_or_init(args, model, logger)
    fetch = PretrainFetch(dataset, args.use_qa, args.use_qa_pairs,
                          args.visual_learning, args.max_tag_length)
    return PretrainRun(model, loss_fn, fetch, main_dataset, dataset)


def main(argv=None) -> dict:
    """Pretrain; returns {"train": each step's metrics} (and with
    --mlm_debug, "mlm_debug": the dump's path). Flags that cannot run raise
    before anything is written."""
    args = get_args(argv)
    check_visual_learning(args)
    check_args(args, LATER_ITEMS)
    device = run_device(args)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = setup_logger("pretrain", args.output_dir)
    tokenizer = FastBertTokenizer(resolve_data(args))
    logger.info(f"device {device}; native tokenizer and feature decode: "
                f"{'on' if tokenizer.native_active else 'off'}")
    run = prepare(args, tokenizer, device, logger)
    if args.mlm_debug:
        # the reference's guid < 1 sample dump (oscar_tsv4.py:1063-1077)
        ids = [int(i) for i in
               run.main_dataset.fetch(np.arange(1))["input_ids_a"][0]
               if i != 0]
        logger.info("mlm_debug sample 0 tokens_a: "
                    f"{tokenizer.convert_ids_to_tokens(ids)}")

    loop = TrainLoop(args, run.model, run.loss_fn, run.fetch,
                     len(run.dataset), logger)
    tokenizer.save_pretrained(args.output_dir)
    out = {"train": loop.run()}
    if args.mlm_debug:
        out["mlm_debug"] = mlm_debug_dump(
            args, run.model, run.fetch,
            min(args.train_batch_size, len(run.dataset)), logger)
    logger.info("pretraining done")
    return out


if __name__ == "__main__":
    main()
