"""Image captioning: the JAX package's `tasks/captioning.py` (:37-380) on one
device (reference BertForImageCaptioning and CaptionPreTrainedModel.generate).

`main` reads a captions json ({image: [{"text": ...}]}), a feature TSV and a
vocab (or writes a synthetic root with `--synthetic`), trains
`CaptioningModel` on masked caption positions through the process loader
and evaluates it by decoding every image and scoring the captions
(BLEU-1..4, METEOR, ROUGE_L, CIDEr-D as `cider_d`, and SPICE when its jar is
present), on the card unless `--platform cpu`:

    python -m mvp_pytorch_tpu_torch.tasks.captioning --output_dir /tmp/cap \
        --synthetic --tiny --max_steps 10 --do_train --do_eval --platform cpu

Decoding: `--decode_mode cached` (the history cache, one step over two
positions) or `recompute` (the whole prefix every step), greedy or
`--num_beams` beams, `--max_gen_length` positions, in chunks of
`--eval_batch_size` images (the JAX driver decodes them all in one batch;
rows never mix). A standalone `--do_eval` writes `test_eval.json`.
`--scst` and `--use_cbs` wait for ROADMAP.md queue 1 item 4c.
"""

from __future__ import annotations

import argparse
import json
import os
import random as pyrandom
from typing import Dict, List

import numpy as np
import torch

from ..data.datasets import FeatureStore
from ..data.tokenization import FastBertTokenizer
from ..models.config import ModelConfig
from ..models.generation import (beam_search, beam_search_cached, generate,
                                 generate_cached)
from ..models.img_bert import CaptioningModel
from ..utils.caption_eval import evaluate_captions
from ..utils.logger import setup_logger
from .common import (TrainLoop, add_common_args, build_config, check_args,
                     load_params_or_init, restore_training_settings,
                     run_device, synth_root)

# flag -> (value that means "off", the ROADMAP queue 1 item it waits for)
LATER_ITEMS = {
    "scst": (False, "item 4c (SCST, training/scst.py)"),
    "use_cbs": (False, "item 4c (constrained beam search, models/cbs.py)"),
}


def get_args(argv=None):
    p = argparse.ArgumentParser(description="image captioning")
    add_common_args(p)
    p.add_argument("--captions_json", type=str, default=None)
    p.add_argument("--feature_tsv", type=str, default=None)
    p.add_argument("--max_gen_length", type=int, default=20)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--decode_mode", type=str, default="cached",
                   choices=["cached", "recompute"],
                   help="cached = history-cached incremental decode "
                        "(reference past reuse); recompute = full prefix "
                        "per step")
    p.add_argument("--label_smoothing", type=float, default=0.1)
    p.add_argument("--drop_worst_ratio", type=float, default=0.0)
    p.add_argument("--drop_worst_after", type=int, default=0,
                   help="apply drop-worst only from this step on "
                        "(reference --drop_worst_after curriculum gate)")
    p.add_argument("--mask_caption_prob", type=float, default=0.15)
    # item 4c's flags, accepted so that they can raise by name
    p.add_argument("--scst", action="store_true",
                   help="self-critical fine-tuning after cross-entropy")
    p.add_argument("--use_cbs", action="store_true",
                   help="constrained decoding: captions must mention one "
                        "detected object tag")
    return p.parse_args(argv)


class CaptionDataset:
    """captions_json {img: [{"text": ...}]}; each caption masked for
    training by a `random.Random(f"{seed}:{index}")` of its own, so the
    masks are the JAX package's."""

    def __init__(self, captions_json, features, tokenizer, max_cap, max_tag,
                 max_img=50, mask_prob=0.15, seed=0):
        with open(captions_json) as f:
            caps = json.load(f)
        self.items = [(img, c["text"]) for img, lst in caps.items()
                      for c in lst]
        self.features = features
        self.tok = tokenizer
        self.max_cap = max_cap
        self.max_tag = max_tag
        self.max_img = max_img
        self.mask_prob = mask_prob
        self.seed = seed

    def __len__(self):
        return len(self.items)

    def images(self) -> List[str]:
        return sorted({img for img, _ in self.items})

    def references(self) -> Dict[str, List[List[str]]]:
        refs = {}
        for img, text in self.items:
            refs.setdefault(img, []).append(self.tok.tokenize(text))
        return refs

    def context(self, img):
        """(tag ids [max_tag] with [CLS]/[SEP], context mask over tags and
        regions [max_tag + max_img], region features [max_img, dim])."""
        feats, tags = self.features.get(img)
        ids_b = self.tok.convert_tokens_to_ids(
            self.tok.tokenize(" ".join(tags)))[: self.max_tag - 2]
        ids_b = ([self.tok.vocab["[CLS]"]] + ids_b
                 + [self.tok.vocab["[SEP]"]])
        pad_b = self.max_tag - len(ids_b)
        mask_b = [1] * len(ids_b) + [0] * pad_b
        ids_b += [0] * pad_b
        m = self.max_img
        n_img = min(feats.shape[0], m)
        feats = feats[:m]
        if feats.shape[0] < m:
            feats = np.concatenate(
                [feats, np.zeros((m - feats.shape[0], feats.shape[1]),
                                 np.float32)])
        ctx_mask = mask_b + [1] * n_img + [0] * (m - n_img)
        return (np.asarray(ids_b, np.int32), np.asarray(ctx_mask, np.int32),
                feats.astype(np.float32))

    def __getitem__(self, index):
        img, text = self.items[index]
        rng = pyrandom.Random(f"{self.seed}:{index}")
        toks = self.tok.tokenize(text)[: self.max_cap - 2]
        ids = ([self.tok.vocab["[CLS]"]]
               + self.tok.convert_tokens_to_ids(toks)
               + [self.tok.vocab["[SEP]"]])
        masked_pos = np.zeros(self.max_cap, np.int32)
        masked_ids = np.zeros(self.max_cap, np.int32)
        out_ids = list(ids) + [0] * (self.max_cap - len(ids))

        def mask_at(i):
            masked_pos[i] = 1
            masked_ids[i] = out_ids[i]
            out_ids[i] = self.tok.vocab["[MASK]"]

        # the random pass first; only if it masked nothing, one random
        # position (the reference's rule: never systematically position 1)
        for i in range(1, len(ids) - 1):
            if rng.random() < self.mask_prob:
                mask_at(i)
        if not masked_pos.any() and len(ids) > 2:
            mask_at(rng.randrange(1, len(ids) - 1))
        ids_b, ctx_mask, feats = self.context(img)
        return dict(
            caption_ids=np.asarray(out_ids, np.int32),
            masked_pos=masked_pos, masked_ids=masked_ids,
            ctx_ids=ids_b, ctx_mask=ctx_mask, img_feat=feats,
        )

    def fetch(self, indices):
        exs = [self[int(i)] for i in indices]
        return {k: np.stack([e[k] for e in exs]) for k in exs[0]}


def model_inputs(batch):
    """A `CaptionDataset` batch (tensors) -> the model's first six inputs:
    the caption's segment ids 0, the context's 1."""
    return (batch["caption_ids"], batch["ctx_ids"], batch["ctx_mask"],
            torch.zeros_like(batch["caption_ids"]),
            torch.ones_like(batch["ctx_ids"]), batch["img_feat"])


def caption_loss_fn(model, batch, generator, step):
    """The Trainer's loss_fn; `step` gates drop-worst."""
    loss, _ = model(*model_inputs(batch), batch["masked_pos"],
                    batch["masked_ids"], step, generator=generator)
    return loss, {}


@torch.no_grad()
def decode_batch(model, ids_b, ctx_mask, feats, vocab, *, gen_len: int,
                 num_beams: int, decode_mode: str) -> torch.Tensor:
    """Decode the captions of one batch of images (tensors on the model's
    device) -> token ids [N, gen_len], BOS first."""
    model.eval()
    n, dev = ids_b.shape[0], ids_b.device
    cls, sep, pad, mask = (vocab[t] for t in ("[CLS]", "[SEP]", "[PAD]",
                                              "[MASK]"))
    reps = max(num_beams, 1)
    rb, rm, rf = (x.repeat_interleave(reps, 0)
                  for x in (ids_b, ctx_mask, feats))
    seg = torch.ones_like(rb)
    if decode_mode == "cached":
        def prefill():
            return model.prefill(rb, rm, seg, rf, gen_len)

        def step(cache, t, prev):
            return model.decode_step(cache, t, prev, rm, gen_len, mask)
        if num_beams > 1:
            return beam_search_cached(prefill, step, cls, sep, pad, n,
                                      gen_len, num_beams,
                                      mask_token_id=mask, device=dev)[0]
        return generate_cached(prefill, step, cls, sep, pad, n, gen_len,
                               device=dev).sequences
    cap_seg = torch.zeros(n * reps, gen_len, dtype=rb.dtype, device=dev)

    def logits_fn(tokens, t):
        return model.decode_logits(tokens, rb, rm, cap_seg, seg, rf, t)
    if num_beams > 1:
        return beam_search(logits_fn, cls, sep, pad, mask, n, gen_len,
                           num_beams, device=dev)[0]
    return generate(logits_fn, cls, sep, pad, mask, n, gen_len,
                    device=dev).sequences


def context_batch(dataset, images, device):
    """(tag ids, context masks, region features) of `images`, stacked, as
    tensors on `device`."""
    ctxs = [dataset.context(img) for img in images]
    return tuple(torch.from_numpy(np.stack([c[i] for c in ctxs])).to(device)
                 for i in range(3))


def caption_tokens(row, tokenizer) -> List[str]:
    """The tokens of a decoded row after BOS, up to its [SEP] or [PAD]."""
    stop = (tokenizer.vocab["[SEP]"], tokenizer.vocab["[PAD]"])
    toks = []
    for t in row[1:]:
        if t in stop:
            break
        toks.append(tokenizer.ids_to_tokens.get(int(t), "[UNK]"))
    return toks


def decode_captions(args, model, dataset, tokenizer, images=None
                    ) -> Dict[str, List[str]]:
    """Every image's (or `images`') caption tokens, decoded in chunks of
    `--eval_batch_size` images on this process."""
    images = dataset.images() if images is None else images
    out = {}
    for i in range(0, len(images), args.eval_batch_size):
        chunk = images[i:i + args.eval_batch_size]
        ids_b, ctx_mask, feats = context_batch(dataset, chunk, model.device)
        seqs = decode_batch(model, ids_b, ctx_mask, feats, tokenizer.vocab,
                            gen_len=args.max_gen_length,
                            num_beams=args.num_beams,
                            decode_mode=args.decode_mode).cpu().numpy()
        for img, row in zip(chunk, seqs):
            out[img] = caption_tokens(row, tokenizer)
    return out


def prepare(args, tokenizer, device, logger=None):
    """What `main` trains and evaluates: (the `CaptionDataset` of
    `--captions_json`, the `CaptioningModel` seeded from `--seed` or loaded
    from `--model_name_or_path`). Captioning predicts over the whole
    vocabulary (reference tie_weights without only_vocab,
    modeling_vlbert_pretrain.py:1580-1584)."""
    dataset = CaptionDataset(args.captions_json,
                             FeatureStore(args.feature_tsv,
                                          feature_dim=args.img_feature_dim),
                             tokenizer, args.max_seq_length,
                             args.max_tag_length,
                             max_img=args.max_img_seq_length,
                             mask_prob=args.mask_caption_prob, seed=args.seed)
    model = CaptioningModel(build_config(args, tokenizer),
                            label_smoothing=args.label_smoothing,
                            drop_worst_ratio=args.drop_worst_ratio,
                            drop_worst_after=args.drop_worst_after,
                            device=device, seed=args.seed)
    load_params_or_init(args, model, logger)
    return dataset, model


def check_config(args) -> None:
    """A checkpoint whose config has pipeline stages raises (its GPipe
    layout is ROADMAP.md queue 1 item 6), before anything is written."""
    if args.model_name_or_path and os.path.exists(
            os.path.join(args.model_name_or_path, "config.json")):
        cfg = ModelConfig.from_pretrained(args.model_name_or_path)
        if cfg.pipeline_stages > 0:
            raise NotImplementedError(
                f"pipeline_stages {cfg.pipeline_stages} is not ported yet: "
                f"it waits for ROADMAP.md queue 1 item 6 (GPipe PP)")


def main(argv=None) -> dict:
    """Train and/or evaluate; returns {"train": each step's metrics,
    "eval": the last scores, "captions": the last decoded captions} as far
    as they ran. Flags that cannot run raise before anything is written."""
    args = get_args(argv)
    check_args(args, LATER_ITEMS)
    check_config(args)
    device = run_device(args)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = setup_logger("captioning", args.output_dir)
    restore_training_settings(args, argv, logger=logger,
                              extra_keys=("max_gen_length",
                                          "mask_caption_prob"))
    if args.synthetic:
        paths = synth_root(args)
        args.captions_json = paths["captions"]
        args.feature_tsv = paths["features"]
        vocab = paths["vocab"]
    else:
        vocab = os.path.join(args.model_name_or_path or args.data_dir,
                             "vocab.txt")
    tokenizer = FastBertTokenizer(vocab)
    dataset, model = prepare(args, tokenizer, device, logger)

    out = {}

    def eval_hook(step):
        hyps = decode_captions(args, model, dataset, tokenizer)
        refs = dataset.references()
        # the reference's evaluate_on_coco_caption surface
        # (oscar/utils/caption_evaluate.py:59-92); cider_d is the headline
        scores = evaluate_captions(hyps, {i: refs[i] for i in hyps})
        scores["cider_d"] = scores.pop("CIDEr")
        logger.info(f"step {step}: CIDEr-D = {scores['cider_d']:.3f}  "
                    + "  ".join(f"{k}={v:.3f}" for k, v in scores.items()
                                if k != "cider_d"))
        out.update(eval=scores, captions=hyps)
        return scores

    if args.do_train:
        loop = TrainLoop(args, model, caption_loss_fn, dataset.fetch,
                         len(dataset), logger)
        tokenizer.save_pretrained(args.output_dir)
        out["train"] = loop.run(eval_hook if args.do_eval else None)
    elif args.do_eval:
        # standalone eval of a checkpoint (the reference's test_eval.json,
        # run_retrieval.py:1104)
        scores = eval_hook(0)
        with open(os.path.join(args.output_dir, "test_eval.json"), "w") as f:
            json.dump(scores, f)
    logger.info("captioning done")
    return out


if __name__ == "__main__":
    main()
