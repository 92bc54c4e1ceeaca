"""Image-text retrieval: training, two-stage scoring and the dataset-driven
command line.

`train_retrieval` runs `RetrievalModel.train_step` under AdamW and the
single-device `Trainer` over in-memory batches (`training/loop.py`), logs the
metrics and saves a checkpoint every `ckpt_period` steps, resuming from the
newest one.

`two_stage_scoring` is the JAX package's `tasks/retrieval.py`
`two_stage_eval` (:93-290) on the model's device:
1. each caption goes through `encode_text_full` once, each image through
   `encode_image_full` once, in batches of `enc_batch`;
2. the coarse similarity matrix `img_glob @ txt_glob.T` and `torch.topk`
   pick `k_i2t` captions per image and `k_t2i` images per caption (or every
   pair with `cross_image`, or an external i2t shortlist); with
   `coarse_block` (`--coarse_block`) the corpus-scale path instead streams
   the gallery in blocks with the query rows split over the ranks
   (`parallel/sharded_retrieval.py`), and the matrix never exists;
3. `score_cached` reranks the candidate pairs, `pair_batch` at a time, by
   running only the fusion encoder over rows gathered from the caches; the
   pair batches are split over the data ranks and gathered in order;
4. R@1/5/10 of the coarse and the fine ranks.

`main` is the JAX package's `tasks/retrieval.py` `main` (:293-401): it reads
a caption JSON, a feature TSV and a vocab (or writes a synthetic root with
`--synthetic`), trains through the process loader (`tasks/common.py`
`TrainLoop`) and runs the two-stage eval, on the card unless `--platform
cpu`:

    python -m mvp_pytorch_tpu_torch.tasks.retrieval --output_dir /tmp/ret \
        --synthetic --tiny --max_steps 10 --do_train --do_eval --platform cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..data.datasets import FeatureStore, RetrievalDataset, load_phrase_vocab
from ..data.tokenization import FastBertTokenizer
from ..models.tasks import RetrievalModel
from ..ops.attention import masked_attention, plain_attention
from ..parallel.collectives import (LOCAL, gather_eval_arrays,
                                    process_shard_indices)
from ..training.loop import batch_on, train_on_batches
from ..utils.logger import setup_logger
from .common import (INPUT_NAMES, TrainLoop, add_common_args, build_config,
                     check_args, is_main, load_params_or_init,
                     restore_training_settings, run_device, synth_root,
                     tensorize_cfg)
from .retrieval_eval import (coarse_ranks, evaluate_ranks, fine_ranks_i2t,
                             fine_ranks_t2i, mask_shortlist_misses)

CAPTION_KEYS = ("input_ids_a", "attention_mask_a", "token_type_ids_a")
IMAGE_KEYS = ("input_ids_b", "attention_mask_b", "token_type_ids_b",
              "img_feats")
PHRASE_KEYS = ("phrase_index", "image_index")
# the data plane's array names -> the model's
PORT_NAMES = {**INPUT_NAMES, "phrase_index": "phrase_index",
              "image_index": "image_index"}


def port_names(arrays: Mapping) -> Dict:
    """The data plane's arrays under the model's names."""
    return {PORT_NAMES[k]: v for k, v in arrays.items()}


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
                      pair_batch: int, *, max_tag_length: int = 20,
                      cross_image: bool = False,
                      i2t_shortlist: Optional[np.ndarray] = None,
                      coarse_block: int = 0) -> dict:
    """Coarse sweep -> candidates -> cached fine rerank -> R@K.

    `caps` holds input_ids_a, attention_mask_a, token_type_ids_a [n_cap, La];
    `imgs` holds input_ids_b, token_type_ids_b [n_img, T], attention_mask_b
    [n_img, T+R] and img_feats [n_img, R, F]; numpy arrays or tensors.

    `cross_image` fine-scores every image x caption pair once and reads the
    t2i ranks from the same scores (the reference's --cross_image_eval).
    `i2t_shortlist` ([n_img, K] caption ids) replaces the coarse i2t
    shortlist and skips t2i (the reference's caption-index mode).

    Returns coarse and fine R@K, the candidate lists, the fine scores, the
    number of pairs scored and each stage's seconds."""
    device = model.device
    stages = _Stages(device)
    caps = batch_on(device, caps, CAPTION_KEYS)
    imgs = batch_on(device, imgs, IMAGE_KEYS)
    n_cap = caps["input_ids_a"].shape[0]
    n_img = imgs["input_ids_b"].shape[0]
    k_i2t, k_t2i = min(k_i2t, n_cap), min(k_t2i, n_img)
    if i2t_shortlist is not None:
        i2t_shortlist = np.asarray(i2t_shortlist, np.int64)
        # a stale or mismatched shortlist would otherwise index out of range
        # on the device
        if (i2t_shortlist.ndim != 2 or i2t_shortlist.shape[0] != n_img
                or i2t_shortlist.min() < 0 or i2t_shortlist.max() >= n_cap):
            raise ValueError(
                f"caption shortlist of shape {i2t_shortlist.shape} with ids "
                f"{i2t_shortlist.min()}..{i2t_shortlist.max()} does not fit "
                f"{n_img} images and {n_cap} captions: was it built for this "
                "split and num_captions_per_img?")

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

    streaming = bool(coarse_block) and not cross_image \
        and i2t_shortlist is None
    sims = None if streaming else img_glob @ txt_glob.T   # [n_img, n_cap]
    if streaming:
        from ..parallel.sharded_retrieval import sharded_coarse_eval
        i2t_c, t2i_c, i2t_rank_c, t2i_rank_c = sharded_coarse_eval(
            img_glob, txt_glob, caps_per_img, k_i2t, k_t2i,
            block=coarse_block)
        i2t_cands = torch.from_numpy(i2t_c).to(device)
        t2i_cands = torch.from_numpy(t2i_c).to(device)
    elif i2t_shortlist is not None:
        i2t_cands = torch.from_numpy(i2t_shortlist).to(device)
        k_i2t, k_t2i = i2t_cands.shape[1], 0
    elif cross_image:
        i2t_cands = torch.argsort(sims, dim=1, descending=True)
        k_i2t, k_t2i = n_cap, 0
    else:
        i2t_cands = torch.topk(sims, k_i2t, dim=1).indices    # caption ids
    if not streaming:
        t2i_cands = torch.topk(sims.T, k_t2i, dim=1).indices  # image ids
    cap_idx = torch.cat([i2t_cands.reshape(-1),
                         torch.arange(n_cap, device=device)
                         .repeat_interleave(k_t2i)])
    img_idx = torch.cat([torch.arange(n_img, device=device)
                         .repeat_interleave(k_i2t),
                         t2i_cands.reshape(-1)])
    stages.mark("coarse")

    txt_mask = caps["attention_mask_a"]
    n_pairs = cap_idx.shape[0]
    n_batches = -(-n_pairs // pair_batch)
    scores = []
    # this data rank's pair batches (every batch on one rank)
    for bi in process_shard_indices(n_batches):
        i = int(bi) * pair_batch
        ci, ii = cap_idx[i:i + pair_batch], img_idx[i:i + pair_batch]
        logits = model.score_cached(txt_seq[ci], txt_mask[ci], vis[ii],
                                    vis_mask[ii])
        scores.append(torch.softmax(logits, dim=-1)[:, 1])
    stages.mark("rerank")

    (scores_np,) = gather_eval_arrays(
        n_pairs, torch.cat(scores).float().cpu().numpy())
    i2t_np, t2i_np = i2t_cands.cpu().numpy(), t2i_cands.cpu().numpy()
    if streaming:
        coarse = evaluate_ranks(i2t_rank_c, t2i_rank_c)
    else:
        coarse = evaluate_ranks(*coarse_ranks(sims.float().cpu().numpy(),
                                              caps_per_img))
    i2t_scores = scores_np[:n_img * k_i2t].reshape(n_img, k_i2t)
    i2t_ranks = mask_shortlist_misses(
        fine_ranks_i2t(i2t_scores, i2t_np, caps_per_img), k_i2t)
    if i2t_shortlist is not None:
        t2i_ranks = None
    elif cross_image:
        # scatter the full product back to [n_img, n_cap] order and read the
        # t2i ranks from its transpose
        full = np.empty((n_img, n_cap), np.float32)
        np.put_along_axis(full, i2t_np, i2t_scores, axis=1)
        t2i_full = np.argsort(-full.T, axis=1)            # [n_cap, n_img]
        t2i_ranks = mask_shortlist_misses(
            fine_ranks_t2i(np.take_along_axis(full.T, t2i_full, 1), t2i_full,
                           caps_per_img), n_img)
    else:
        t2i_scores = scores_np[n_img * k_i2t:].reshape(n_cap, k_t2i)
        t2i_ranks = mask_shortlist_misses(
            fine_ranks_t2i(t2i_scores, t2i_np, caps_per_img), k_t2i)
    fine = evaluate_ranks(i2t_ranks, t2i_ranks)
    stages.mark("ranks")
    return {"coarse": coarse, "fine": fine, "i2t_cands": i2t_np,
            "t2i_cands": t2i_np, "scores": scores_np,
            "n_pairs": int(cap_idx.shape[0]), "seconds": stages.seconds}


def retrieval_loss_fn(*, max_tag_length: int = 20, hn_mod: str = "hard",
                      no_itm: bool = False,
                      phrase_layer: Optional[int] = None):
    """The Trainer's loss_fn for `RetrievalModel.train_step`: the total loss,
    with the CLIP, ITM and (with phrase spans in the batch) WRA losses as
    metrics, over the Trainer's `global_batch`."""
    def loss_fn(model, batch, generator, global_batch=LOCAL):
        out = model.train_step(
            *(batch[k] for k in CAPTION_KEYS + IMAGE_KEYS),
            *(batch.get(k) for k in PHRASE_KEYS),
            max_tag_length=max_tag_length, hn_mod=hn_mod, no_itm=no_itm,
            phrase_layer=phrase_layer, generator=generator,
            global_batch=global_batch)
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


# ---------------------------------------------------------------------------
# the dataset-driven command line
# ---------------------------------------------------------------------------

def get_args(argv=None):
    p = argparse.ArgumentParser(description="image-text retrieval: training "
                                "and two-stage evaluation")
    add_common_args(p)
    p.add_argument("--captions_json", type=str, default=None)
    p.add_argument("--feature_tsv", type=str, default=None)
    p.add_argument("--id2phrase", type=str, default=None)
    p.add_argument("--eval_captions_json", type=str, default=None)
    p.add_argument("--num_captions_per_img", type=int, default=5)
    p.add_argument("--num_captions_per_img_train", type=int, default=None,
                   help="train on only the first K captions per image "
                        "(reference --num_captions_per_img_train); eval "
                        "keeps --num_captions_per_img")
    p.add_argument("--num_captions_per_img_val", type=int, default=20,
                   help="i2t rerank shortlist size")
    p.add_argument("--num_images_per_cap_val", type=int, default=10,
                   help="t2i rerank shortlist size")
    p.add_argument("--rerank_batch_size", type=int, default=None,
                   help="pairs per fusion pass of the rerank (default "
                        "--eval_batch_size)")
    p.add_argument("--hn_mod", type=str, default="hard",
                   choices=["hard", "sample"])
    p.add_argument("--use_phrase", action="store_true",
                   help="add the hard-mode WRA phrase-region margin loss "
                        "during training (reference --use_phrase)")
    p.add_argument("--phrase_layer", type=int, default=None,
                   help="read WRA spans from this fusion mid-layer instead "
                        "of the final output; only with --use_phrase")
    p.add_argument("--no_itm", action="store_true",
                   help="train the contrastive (CLIP) loss only (reference "
                        "--no_itm)")
    p.add_argument("--cross_image_eval", action="store_true",
                   help="fine-score EVERY image x caption pair instead of "
                        "the coarse top-K shortlists (reference "
                        "--cross_image_eval)")
    p.add_argument("--eval_img_keys_file", type=str, default=None,
                   help="tsv of image keys; restrict eval to this subset")
    p.add_argument("--coarse_block", type=int, default=0,
                   help="corpus-scale coarse stage: stream the gallery in "
                        "blocks of this many rows, the query rows split over "
                        "the ranks (0: the dense similarity matrix)")
    p.add_argument("--eval_caption_index_json", type=str, default=None,
                   help="external i2t rerank shortlist: {img_key: "
                        "[[img_key1, cap_idx1], ...]} (i2t only)")
    return p.parse_args(argv)


class RetrievalFetch:
    """`dataset.fetch` under the model's array names, without the phrase
    spans unless `use_phrase` (picklable, for spawned loader workers)."""

    def __init__(self, dataset: RetrievalDataset, use_phrase: bool):
        self.dataset = dataset
        self.keys = [k for k in PORT_NAMES
                     if use_phrase or PORT_NAMES[k] not in PHRASE_KEYS]

    def __call__(self, indices) -> Dict[str, np.ndarray]:
        batch = self.dataset.fetch(indices)
        return {PORT_NAMES[k]: batch[k] for k in self.keys}


def two_stage_eval(args, model, dataset: RetrievalDataset, logger,
                   caption_index: Optional[dict] = None) -> dict:
    """`two_stage_scoring` over the dataset's eval arrays, with the CLI's
    shortlist sizes and modes. `caption_index` (parsed
    --eval_caption_index_json) is the external i2t shortlist."""
    model.eval()
    launches0, plain0 = masked_attention.launches, plain_attention.calls
    t0 = time.perf_counter()
    caps = port_names(dataset.caption_arrays())
    imgs = port_names(dataset.image_arrays())
    arrays_s = time.perf_counter() - t0
    cpi = dataset.num_captions_per_img
    shortlist = None
    if caption_index is not None:
        pos = {k: i for i, k in enumerate(dataset.img_keys)}
        shortlist = np.asarray(
            [[pos[str(k1)] * cpi + int(c1) for k1, c1 in caption_index[str(k)]]
             for k in dataset.img_keys], np.int64)
    res = two_stage_scoring(
        model, caps, imgs, cpi, args.num_captions_per_img_val,
        args.num_images_per_cap_val, args.eval_batch_size,
        args.rerank_batch_size or args.eval_batch_size,
        max_tag_length=args.max_tag_length,
        cross_image=args.cross_image_eval, i2t_shortlist=shortlist,
        coarse_block=args.coarse_block)
    res["seconds"]["arrays"] = arrays_s
    logger.info(f"coarse: {json.dumps(res['coarse'])}")
    logger.info(f"fine: {json.dumps(res['fine'])}")
    logger.info("eval seconds: " + "  ".join(
        f"{k}={v:.4f}" for k, v in res["seconds"].items())
        + f"  pairs={res['n_pairs']}")
    logger.info(f"eval attention: kernel launches="
                f"{masked_attention.launches - launches0}  plain calls="
                f"{plain_attention.calls - plain0}")
    return res


def main(argv=None) -> dict:
    """Train and/or evaluate; returns {"train": each step's metrics,
    "eval": the last `two_stage_scoring` result} as far as they ran."""
    args = get_args(argv)
    check_args(args)
    device = run_device(args)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = setup_logger("retrieval", args.output_dir)
    restore_training_settings(args, argv, logger=logger)

    if args.synthetic:
        paths = synth_root(args, caps_per_img=args.num_captions_per_img)
        args.captions_json = paths["captions"]
        args.feature_tsv = paths["features"]
        args.id2phrase = paths["id2phrase"]
        vocab = paths["vocab"]
    else:
        vocab = os.path.join(args.model_name_or_path or args.data_dir,
                             "vocab.txt")
    tokenizer = FastBertTokenizer(vocab)
    logger.info(f"device {device}; native tokenizer and feature decode: "
                f"{'on' if tokenizer.native_active else 'off'}")
    sg2id = load_phrase_vocab(args.id2phrase) if args.id2phrase else None
    cfg = build_config(args, tokenizer, num_labels=2)
    tcfg = tensorize_cfg(args)
    features = FeatureStore(args.feature_tsv,
                            feature_dim=args.img_feature_dim)
    cpi_train = args.num_captions_per_img_train or args.num_captions_per_img
    dataset = RetrievalDataset(args.captions_json, features, tokenizer,
                               sg2id=sg2id, cfg=tcfg,
                               num_captions_per_img=cpi_train)
    eval_dataset = dataset
    if (args.eval_captions_json or args.eval_img_keys_file
            or cpi_train != args.num_captions_per_img):
        eval_dataset = RetrievalDataset(
            args.eval_captions_json or args.captions_json, features,
            tokenizer, sg2id=sg2id, cfg=tcfg,
            num_captions_per_img=args.num_captions_per_img,
            img_keys_file=args.eval_img_keys_file)

    model = RetrievalModel(cfg, device=device, seed=args.seed)
    load_params_or_init(args, model, logger)
    if not args.use_phrase:
        args.phrase_layer = None    # mid-layer readout is WRA-only
    loss_fn = retrieval_loss_fn(max_tag_length=args.max_tag_length,
                                hn_mod=args.hn_mod, no_itm=args.no_itm,
                                phrase_layer=args.phrase_layer)
    caption_index = None
    if args.eval_caption_index_json:
        with open(args.eval_caption_index_json) as f:
            caption_index = json.load(f)

    out = {}

    def evaluate():
        out["eval"] = two_stage_eval(args, model, eval_dataset, logger,
                                     caption_index=caption_index)
        return {k: out["eval"][k] for k in ("coarse", "fine")}

    if args.do_train:
        loop = TrainLoop(args, model, loss_fn,
                         RetrievalFetch(dataset, args.use_phrase),
                         len(dataset), logger)
        tokenizer.save_pretrained(args.output_dir)
        out["train"] = loop.run(
            (lambda step: evaluate()) if args.do_eval else None)
    if args.do_eval and not args.do_train:
        res = evaluate()
        if is_main():
            with open(os.path.join(args.output_dir, "test_eval.json"),
                      "w") as f:
                json.dump(res, f, indent=2)
    logger.info("retrieval done")
    return out


if __name__ == "__main__":
    main()
