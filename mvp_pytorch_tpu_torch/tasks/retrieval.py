"""Retrieval training and two-stage retrieval scoring on already-tensorized
arrays.

`train_retrieval` is the counterpart of the JAX package's retrieval task
(`tasks/retrieval.py` `main` with `tasks/common.py` `TrainLoop.run`) without
the dataset plumbing: it runs `RetrievalModel.train_step` under AdamW and the
single-device `Trainer` over in-memory batches (`training/loop.py`), logs the
metrics and saves a checkpoint every `ckpt_period` steps, resuming from the
newest one.

`two_stage_scoring` is the default branch of the JAX package's `tasks/retrieval.py` `two_stage_eval`
(:93-290; not streaming, not cross-image, no caption index), on the model's
device:
1. each caption goes through `encode_text_full` once, each image through
   `encode_image_full` once, in batches of `enc_batch`;
2. the coarse similarity matrix `img_glob @ txt_glob.T` and `torch.topk`
   pick `k_i2t` captions per image and `k_t2i` images per caption;
3. `score_cached` reranks the candidate pairs, `pair_batch` at a time, by
   running only the fusion encoder over rows gathered from the caches;
4. R@1/5/10 of the coarse and the fine ranks.

The dataset-driven command line waits for the port of `data/`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Mapping, Optional, Sequence

import torch

from ..training.loop import batch_on, train_on_batches
from .retrieval_eval import (coarse_ranks, evaluate_ranks, fine_ranks_i2t,
                             fine_ranks_t2i, mask_shortlist_misses)

CAPTION_KEYS = ("input_ids_a", "attention_mask_a", "token_type_ids_a")
IMAGE_KEYS = ("input_ids_b", "attention_mask_b", "token_type_ids_b",
              "img_feats")
PHRASE_KEYS = ("phrase_index", "image_index")


class _Stages:
    """Wall time of each stage, closed by a device synchronise."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: Dict[str, float] = {}
        self._t = self._now()

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, name: str) -> None:
        t = self._now()
        self.seconds[name] = t - self._t
        self._t = t


@torch.inference_mode()
def two_stage_scoring(model, caps: Mapping, imgs: Mapping, caps_per_img: int,
                      k_i2t: int, k_t2i: int, enc_batch: int,
                      pair_batch: int, *, max_tag_length: int = 20) -> dict:
    """Coarse sweep -> candidates -> cached fine rerank -> R@K.

    `caps` holds input_ids_a, attention_mask_a, token_type_ids_a [n_cap, La];
    `imgs` holds input_ids_b, token_type_ids_b [n_img, T], attention_mask_b
    [n_img, T+R] and img_feats [n_img, R, F]; numpy arrays or tensors.

    Returns coarse and fine R@K, the candidate lists, the fine scores, the
    number of pairs scored and each stage's seconds."""
    device = model.device
    stages = _Stages(device)
    caps = batch_on(device, caps, CAPTION_KEYS)
    imgs = batch_on(device, imgs, IMAGE_KEYS)
    n_cap = caps["input_ids_a"].shape[0]
    n_img = imgs["input_ids_b"].shape[0]
    k_i2t, k_t2i = min(k_i2t, n_cap), min(k_t2i, n_img)

    txt_seq, txt_glob = [], []
    for i in range(0, n_cap, enc_batch):
        s, g = model.encode_text_full(
            *(caps[k][i:i + enc_batch] for k in CAPTION_KEYS))
        txt_seq.append(s)
        txt_glob.append(g)
    txt_seq, txt_glob = torch.cat(txt_seq), torch.cat(txt_glob)
    stages.mark("encode_text")

    vis, vis_mask, img_glob = [], [], []
    for i in range(0, n_img, enc_batch):
        vp, vm, g = model.encode_image_full(
            *(imgs[k][i:i + enc_batch] for k in IMAGE_KEYS),
            max_tag_length=max_tag_length)
        vis.append(vp)
        vis_mask.append(vm)
        img_glob.append(g)
    vis, vis_mask, img_glob = torch.cat(vis), torch.cat(vis_mask), torch.cat(img_glob)
    stages.mark("encode_image")

    sims = img_glob @ txt_glob.T                          # [n_img, n_cap]
    i2t_cands = torch.topk(sims, k_i2t, dim=1).indices    # caption ids
    t2i_cands = torch.topk(sims.T, k_t2i, dim=1).indices  # image ids
    cap_idx = torch.cat([i2t_cands.reshape(-1),
                         torch.arange(n_cap, device=device)
                         .repeat_interleave(k_t2i)])
    img_idx = torch.cat([torch.arange(n_img, device=device)
                         .repeat_interleave(k_i2t),
                         t2i_cands.reshape(-1)])
    stages.mark("coarse")

    txt_mask = caps["attention_mask_a"]
    scores = []
    for i in range(0, cap_idx.shape[0], pair_batch):
        ci, ii = cap_idx[i:i + pair_batch], img_idx[i:i + pair_batch]
        logits = model.score_cached(txt_seq[ci], txt_mask[ci], vis[ii],
                                    vis_mask[ii])
        scores.append(torch.softmax(logits, dim=-1)[:, 1])
    scores = torch.cat(scores)
    stages.mark("rerank")

    sims_np = sims.float().cpu().numpy()
    scores_np = scores.float().cpu().numpy()
    i2t_np, t2i_np = i2t_cands.cpu().numpy(), t2i_cands.cpu().numpy()
    coarse = evaluate_ranks(*coarse_ranks(sims_np, caps_per_img))
    i2t_scores = scores_np[:n_img * k_i2t].reshape(n_img, k_i2t)
    t2i_scores = scores_np[n_img * k_i2t:].reshape(n_cap, k_t2i)
    fine = evaluate_ranks(
        mask_shortlist_misses(
            fine_ranks_i2t(i2t_scores, i2t_np, caps_per_img), k_i2t),
        mask_shortlist_misses(
            fine_ranks_t2i(t2i_scores, t2i_np, caps_per_img), k_t2i))
    stages.mark("ranks")
    return {"coarse": coarse, "fine": fine, "i2t_cands": i2t_np,
            "t2i_cands": t2i_np, "scores": scores_np,
            "n_pairs": int(cap_idx.shape[0]), "seconds": stages.seconds}


def retrieval_loss_fn(*, max_tag_length: int = 20, hn_mod: str = "hard",
                      no_itm: bool = False,
                      phrase_layer: Optional[int] = None):
    """The Trainer's loss_fn for `RetrievalModel.train_step`: the total loss,
    with the CLIP, ITM and (with phrase spans in the batch) WRA losses as
    metrics."""
    def loss_fn(model, batch, generator):
        out = model.train_step(
            *(batch[k] for k in CAPTION_KEYS + IMAGE_KEYS),
            *(batch.get(k) for k in PHRASE_KEYS),
            max_tag_length=max_tag_length, hn_mod=hn_mod, no_itm=no_itm,
            phrase_layer=phrase_layer, generator=generator)
        metrics = {"clip": out.retrieval_loss, "itm": out.itm_loss}
        if out.wra_loss is not None:
            metrics["wra"] = out.wra_loss
        return out.total_loss, metrics
    return loss_fn


def train_retrieval(model, batches: Sequence[Mapping], steps: int, *,
                    learning_rate: float = 2e-5, warmup_steps: int = 0,
                    schedule: str = "linear", weight_decay: float = 0.01,
                    max_grad_norm: Optional[float] = 1.0,
                    grad_accum: int = 1, seed: int = 0,
                    max_tag_length: int = 20, hn_mod: str = "hard",
                    no_itm: bool = False, phrase_layer: Optional[int] = None,
                    output_dir: Optional[str] = None, ckpt_period: int = 0,
                    keep: int = 3, log_period: int = 0,
                    logger=print) -> List[Dict[str, float]]:
    """Train `model` for `steps` steps, cycling over `batches` (dicts of the
    caption and image arrays, plus `phrase_index` / `image_index` for the
    WRA loss; numpy arrays or tensors). Returns each step's metrics.

    With `output_dir`, metrics go to `metrics.jsonl` there, a checkpoint is
    saved every `ckpt_period` steps and after the last, and training resumes
    from the newest checkpoint found there. The model is left in eval
    mode."""
    return train_on_batches(
        model, retrieval_loss_fn(max_tag_length=max_tag_length,
                                 hn_mod=hn_mod, no_itm=no_itm,
                                 phrase_layer=phrase_layer),
        batches, steps, learning_rate=learning_rate,
        warmup_steps=warmup_steps, schedule=schedule,
        weight_decay=weight_decay, max_grad_norm=max_grad_norm,
        grad_accum=grad_accum, seed=seed, output_dir=output_dir,
        ckpt_period=ckpt_period, keep=keep, log_period=log_period,
        logger=logger)
