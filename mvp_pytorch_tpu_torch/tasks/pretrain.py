"""MVPTR pretraining on already-tensorized batches.

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
first. The dataset-driven command line waits for the port of `data/`.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

from ..training.loop import train_on_batches

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
