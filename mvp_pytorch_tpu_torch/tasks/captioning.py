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
rows never mix), the images split over the data ranks of a multi-rank run.
A model of a pipeline-staged config (`--pipeline_parallel`) trains through
GPipe and decodes as a per-layer model (`parallel.pipeline.unstacked`), as
the JAX driver decodes on an unstacked copy. A standalone `--do_eval`
writes `test_eval.json`.

`--scst` fine-tunes after cross-entropy by self-critical sequence training
(`scst_finetune`: `--scst_steps` steps of `--scst_batch` images, a sampled
and a greedy decode each, the CIDEr-D advantage on the host, exact log-probs
from one forward over the masked copies of each sampled caption, AdamW at
`--scst_lr` as `optax.adamw` sets it). `--use_cbs` with `--do_eval` decodes
the first four images by constrained beam search (`cbs_decode_demo`,
`--cbs_beams` beams a state), each caption forced to mention the image's
first tag, and writes the hits and the captions to `cbs_captions.json`.
"""

from __future__ import annotations

import argparse
import json
import os
import random as pyrandom
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.datasets import FeatureStore
from ..data.tokenization import FastBertTokenizer
from ..models.cbs import (NEG_INF, build_fsm, constrained_beam_search,
                          select_best_beam_with_constraints)
from ..models.generation import (GenerateOutput, beam_search,
                                 beam_search_cached, generate,
                                 generate_cached)
from ..models.img_bert import CaptioningModel
from ..parallel.collectives import gather_eval_arrays, process_shard_indices
from ..parallel.pipeline import unstacked
from ..training.optim import AdamW
from ..training.scst import ScstReward, sample_mask, scst_loss
from ..utils.caption_eval import evaluate_captions
from ..utils.logger import setup_logger
from .common import (TrainLoop, add_common_args, build_config, check_args,
                     load_params_or_init, restore_training_settings,
                     run_device, synth_root)

# optax.adamw's default weight decay: SCST's optimizer decays every
# parameter by it and clips nothing, as the JAX driver's `optax.adamw(lr)`
SCST_WEIGHT_DECAY = 1e-4
CBS_IMAGES = 4


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
    p.add_argument("--scst", action="store_true",
                   help="self-critical fine-tuning after cross-entropy")
    p.add_argument("--scst_steps", type=int, default=20)
    p.add_argument("--scst_batch", type=int, default=8)
    p.add_argument("--scst_lr", type=float, default=1e-6)
    p.add_argument("--use_cbs", action="store_true",
                   help="constrained decoding: captions must mention one "
                        "detected object tag")
    p.add_argument("--cbs_beams", type=int, default=2)
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


def _per_layer(fn):
    """Decode a pipeline-staged model as a per-layer one (the history
    cache needs the per-layer layout; `parallel.pipeline.unstacked`)."""
    import functools

    @functools.wraps(fn)
    def wrapped(model, *args, **kw):
        with unstacked(model):
            return fn(model, *args, **kw)
    return wrapped


@_per_layer
@torch.no_grad()
def decode_output(model, ids_b, ctx_mask, feats, vocab, *, gen_len: int,
                  decode_mode: str, do_sample: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> GenerateOutput:
    """Greedy (or, with `do_sample`, temperature-1 sampling from
    `generator`) decode of one batch of images (tensors on the model's
    device), history-cached or recomputed -> the decoder's `GenerateOutput`
    (sequences [N, gen_len], BOS first; log-probs, lengths, finished)."""
    model.eval()
    n, dev = ids_b.shape[0], ids_b.device
    cls, sep, pad, mask = (vocab[t] for t in ("[CLS]", "[SEP]", "[PAD]",
                                              "[MASK]"))
    seg = torch.ones_like(ids_b)
    kw = dict(do_sample=do_sample, generator=generator, device=dev)
    if decode_mode == "cached":
        def prefill():
            return model.prefill(ids_b, ctx_mask, seg, feats, gen_len)

        def step(cache, t, prev):
            return model.decode_step(cache, t, prev, ctx_mask, gen_len, mask)
        return generate_cached(prefill, step, cls, sep, pad, n, gen_len, **kw)
    cap_seg = torch.zeros(n, gen_len, dtype=ids_b.dtype, device=dev)

    def logits_fn(tokens, t):
        return model.decode_logits(tokens, ids_b, ctx_mask, cap_seg, seg,
                                   feats, t)
    return generate(logits_fn, cls, sep, pad, mask, n, gen_len, **kw)


@_per_layer
@torch.no_grad()
def decode_batch(model, ids_b, ctx_mask, feats, vocab, *, gen_len: int,
                 num_beams: int, decode_mode: str) -> torch.Tensor:
    """Decode the captions of one batch of images (tensors on the model's
    device) -> token ids [N, gen_len], BOS first."""
    if num_beams <= 1:
        return decode_output(model, ids_b, ctx_mask, feats, vocab,
                             gen_len=gen_len,
                             decode_mode=decode_mode).sequences
    model.eval()
    n, dev = ids_b.shape[0], ids_b.device
    cls, sep, pad, mask = (vocab[t] for t in ("[CLS]", "[SEP]", "[PAD]",
                                              "[MASK]"))
    rb, rm, rf = (x.repeat_interleave(num_beams, 0)
                  for x in (ids_b, ctx_mask, feats))
    seg = torch.ones_like(rb)
    if decode_mode == "cached":
        def prefill():
            return model.prefill(rb, rm, seg, rf, gen_len)

        def step(cache, t, prev):
            return model.decode_step(cache, t, prev, rm, gen_len, mask)
        return beam_search_cached(prefill, step, cls, sep, pad, n, gen_len,
                                  num_beams, mask_token_id=mask,
                                  device=dev)[0]
    cap_seg = torch.zeros(n * num_beams, gen_len, dtype=rb.dtype, device=dev)

    def logits_fn(tokens, t):
        return model.decode_logits(tokens, rb, rm, cap_seg, seg, rf, t)
    return beam_search(logits_fn, cls, sep, pad, mask, n, gen_len, num_beams,
                       device=dev)[0]


@_per_layer
@torch.no_grad()
def constrained_decode(model, ids_b, ctx_mask, feats, fsm, vocab, *,
                       gen_len: int, num_beams: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Constrained beam search (`models/cbs.py`) over the recompute forward
    for a batch of images and their FSMs [B, S, S, V] -> (sequences
    [B, S, K, gen_len], logprobs [B, S, K]). Each image's context is
    repeated over its S K state-beam rows."""
    model.eval()
    dev = ids_b.device
    fsm = torch.as_tensor(fsm, device=dev)
    reps = fsm.shape[1] * num_beams
    rb, rm, rf = (x.repeat_interleave(reps, 0)
                  for x in (ids_b, ctx_mask, feats))
    seg = torch.ones_like(rb)
    cap_seg = torch.zeros(rb.shape[0], gen_len, dtype=rb.dtype, device=dev)

    def logits_fn(tokens, t):
        return model.decode_logits(tokens, rb, rm, cap_seg, seg, rf, t)
    return constrained_beam_search(
        logits_fn, fsm, vocab["[CLS]"], vocab["[SEP]"], vocab["[PAD]"],
        vocab["[MASK]"], gen_len, num_beams, device=dev)


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
    `--eval_batch_size` images; the images are split over the data ranks
    (`process_shard_indices`) and the token rows gathered in order."""
    images = dataset.images() if images is None else images
    mine = [images[int(i)] for i in process_shard_indices(len(images))]
    rows = []
    for i in range(0, len(mine), args.eval_batch_size):
        chunk = mine[i:i + args.eval_batch_size]
        ids_b, ctx_mask, feats = context_batch(dataset, chunk, model.device)
        rows.append(decode_batch(model, ids_b, ctx_mask, feats,
                                 tokenizer.vocab, gen_len=args.max_gen_length,
                                 num_beams=args.num_beams,
                                 decode_mode=args.decode_mode).cpu().numpy())
    (seqs,) = gather_eval_arrays(len(images), np.concatenate(rows))
    return {img: caption_tokens(row, tokenizer)
            for img, row in zip(images, seqs)}


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


def scst_optimizer(model, lr: float) -> AdamW:
    """`optax.adamw(lr)` as the JAX driver builds it: a constant rate,
    weight decay 1e-4 on every parameter, no clipping."""
    return AdamW(model.named_parameters(), lambda count: lr,
                 weight_decay=SCST_WEIGHT_DECAY, max_grad_norm=None,
                 decay_mask=False)


def scst_copy_loss(model, sequences, mask, advantages, ids_b, ctx_mask,
                   feats, mask_token_id: int) -> torch.Tensor:
    """SCST's loss with exact, differentiable log-probs: one forward over L
    copies of each sampled caption [N, L], copy t with [MASK] at t (every
    position sees its real prefix and [MASK] at itself, the distribution
    the decoder sampled from), the LM head at each copy's own position t
    ([N L, V] logits, never [N L, L, V]). Dropout stays as the caller set
    it (off for SCST, as the JAX driver's deterministic forward)."""
    n, l = sequences.shape
    dev = sequences.device
    eye = torch.eye(l, dtype=torch.bool, device=dev)
    copies = torch.where(eye[None], mask_token_id,
                         sequences[:, None, :]).reshape(n * l, l)
    rb, rm, rf = (x.repeat_interleave(l, 0) for x in (ids_b, ctx_mask, feats))
    positions = torch.arange(l, device=dev).repeat(n)
    logits = model.decode_logits(copies, rb, rm, torch.zeros_like(copies),
                                 torch.ones_like(rb), rf, positions)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_lp = logp.gather(1, sequences.reshape(-1, 1)).reshape(n, l)
    return scst_loss(tok_lp, mask, advantages)


def scst_finetune(args, model, dataset, tokenizer, logger) -> List[dict]:
    """Self-critical fine-tuning (reference ScstRewardCriterion,
    caption_evaluate.py:115-196). Each step: `min(--scst_batch, images)`
    images drawn without replacement by a generator seeded with `--seed`; a
    sampled and a greedy decode by the `--decode_mode` decoder; the CIDEr-D
    advantage over the greedy baseline on the host; `scst_copy_loss` with
    dropout off; one AdamW step. Returns each step's loss and mean
    advantage."""
    vocab = tokenizer.vocab
    dev = model.device
    reward = ScstReward(baseline_type="greedy")
    refs_all = dataset.references()
    imgs_all = dataset.images()
    n_batch = min(args.scst_batch, len(imgs_all))
    opt = scst_optimizer(model, args.scst_lr)
    pick_gen = torch.Generator().manual_seed(args.seed)
    sample_gen = torch.Generator(device=dev).manual_seed(args.seed)
    gen_len = args.max_gen_length
    history = []
    for step in range(args.scst_steps):
        pick = torch.randperm(len(imgs_all), generator=pick_gen)[:n_batch]
        imgs = [imgs_all[i] for i in pick.tolist()]
        ids_b, ctx_mask, feats = context_batch(dataset, imgs, dev)
        kw = dict(gen_len=gen_len, decode_mode=args.decode_mode)
        samp = decode_output(model, ids_b, ctx_mask, feats, vocab,
                             do_sample=True, generator=sample_gen, **kw)
        greedy = decode_output(model, ids_b, ctx_mask, feats, vocab, **kw)
        s_rows, g_rows = samp.sequences.cpu().numpy(), \
            greedy.sequences.cpu().numpy()
        adv = reward.rewards([caption_tokens(r, tokenizer) for r in s_rows],
                             [caption_tokens(r, tokenizer) for r in g_rows],
                             [refs_all[i] for i in imgs])
        mask = sample_mask(samp.lengths, samp.finished, gen_len)
        model.eval()
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = scst_copy_loss(model, samp.sequences, mask, adv, ids_b,
                                  ctx_mask, feats, vocab["[MASK]"])
            loss.backward()
        opt.step()
        history.append(dict(loss=loss.item(), mean_adv=float(adv.mean())))
        if (step + 1) % max(1, args.scst_steps // 4) == 0:
            logger.info(f"scst step {step + 1}/{args.scst_steps}: "
                        f"loss={history[-1]['loss']:.4f} "
                        f"mean_adv={history[-1]['mean_adv']:.3f}")
    model.zero_grad(set_to_none=True)
    return history


def cbs_decode_demo(args, model, dataset, tokenizer, logger) -> dict:
    """Constrained decoding of the first CBS_IMAGES images (reference
    ConstrainedBeamSearch usage): the constraint is the image's first tag as
    one vocabulary token (an image whose first tag is not one is skipped),
    `build_fsm` with 2 states, `--cbs_beams` beams a state, and the best
    beam of a state that satisfies it (the per-item fallback otherwise).
    Writes {"n_hits", "n_images", "captions": {image: {"constraint",
    "sequence", "tokens", "hit", "satisfied"}}} to
    `output_dir/cbs_captions.json` and returns it."""
    vocab = tokenizer.vocab
    dev = model.device
    v = model.config.vocab_size
    out = {"n_hits": 0, "n_images": 0, "captions": {}}
    for img in dataset.images()[:CBS_IMAGES]:
        out["n_images"] += 1
        _, tags = dataset.features.get(img)
        tag_ids = [vocab[t] for t in tags[:1] if t in vocab]
        if not tag_ids:
            continue
        fsm, nsat = build_fsm([tag_ids], v,
                              max_states=2 + max(0, len(tag_ids) - 1))
        ids_b, ctx_mask, feats = context_batch(dataset, [img], dev)
        seqs, logps = constrained_decode(
            model, ids_b, ctx_mask, feats, fsm[None], vocab,
            gen_len=args.max_gen_length, num_beams=args.cbs_beams)
        seqs, logps = seqs.cpu().numpy(), logps.cpu().numpy()
        best, _ = select_best_beam_with_constraints(
            seqs, logps, nsat, 1, eos_token_ids=(vocab["[SEP]"],),
            pad_token_id=vocab["[PAD]"])
        live = logps[0, :, 0] > NEG_INF / 2
        hit = bool(tag_ids[0] in best[0])
        out["n_hits"] += int(hit)
        out["captions"][img] = dict(
            constraint=tags[0], sequence=best[0].tolist(),
            tokens=caption_tokens(best[0], tokenizer), hit=hit,
            satisfied=bool((live & (nsat >= 1)).any()))
    logger.info(f"cbs: {out['n_hits']}/{out['n_images']} captions contain "
                f"the constraint tag")
    with open(os.path.join(args.output_dir, "cbs_captions.json"), "w") as f:
        json.dump(out, f)
    return out


def main(argv=None) -> dict:
    """Train and/or evaluate, then SCST and constrained decoding when asked;
    returns {"train": each step's metrics, "eval": the last scores,
    "captions": the last decoded captions, "scst": each SCST step's loss and
    mean advantage, "cbs": the constrained captions} as far as they ran.
    Flags that cannot run raise before anything is written."""
    args = get_args(argv)
    check_args(args)
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
    if args.scst:
        out["scst"] = scst_finetune(args, model, dataset, tokenizer, logger)
        if args.do_eval:
            eval_hook(args.max_steps + args.scst_steps)
    if args.use_cbs and args.do_eval:
        out["cbs"] = cbs_decode_demo(args, model, dataset, tokenizer, logger)
    logger.info("captioning done")
    return out


if __name__ == "__main__":
    main()
