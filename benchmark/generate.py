"""The one traffic generator: vision-language examples drawn on the device
from a seeded `torch.Generator`, after the parameters of a traffic file
(`traffic/<name>.json`).

An example is a caption stream, [CLS] caption wordpieces [SEP] phrase ids
(none where the file gives no `phrase_ids`), padded to `text_len`; a tag stream, [CLS] tag wordpieces [SEP], padded to
`tag_len`; and `regions` region features (2048 pooled detector features,
non-negative, then 6 box coordinates in [0, 1]), of which the first
`region_range` ones are real. Lengths are drawn uniformly from the ranges
the file gives, so every seed draws from the same sizes and the padded
shapes, and so the work, never change. Masked-token labels are -1 where a
position is not masked."""

from __future__ import annotations

from typing import Dict

import torch

PAD, CLS, SEP, MASK = 0, 101, 102, 103
FIRST_WORD = 1000          # wordpieces below are special or unused


def _first_word(vocab_w: int) -> int:
    return min(FIRST_WORD, vocab_w // 2)     # small test vocabularies


def _lengths(n, lo_hi, g, dev):
    lo, hi = lo_hi
    return torch.randint(lo, hi + 1, (n,), generator=g, device=dev)


def _mask_tokens(ids, candidates, prob, cap, g):
    """Mask up to `cap` of the candidate positions of each row, each with
    probability `prob`, to [MASK]; -> (ids, labels)."""
    u = torch.rand(ids.shape, generator=g, device=ids.device)
    hit = candidates & (u < prob)
    hit &= torch.cumsum(hit.long(), 1) <= cap
    labels = torch.where(hit, ids, torch.full_like(ids, -1))
    return torch.where(hit, torch.full_like(ids, MASK), ids), labels


def examples(n: int, cfg: dict, tr: dict, g: torch.Generator, device,
             *, mask: bool) -> Dict[str, torch.Tensor]:
    """n examples as the two-stream model takes them (and their phrase and
    region spans in the fused sequence); with `mask`, MLM-masked caption
    and tag tokens and their labels."""
    dev = torch.device(device)
    la, t, r = tr["text_len"], tr["tag_len"], tr["regions"]
    vocab_w, vocab = cfg["only_word_size"], cfg["vocab_size"]
    pos_a = torch.arange(la, device=dev)[None]
    n_cap = _lengths(n, tr["caption_tokens"], g, dev)
    lo = _first_word(vocab_w)
    words = torch.randint(lo, vocab_w, (n, la), generator=g,
                          device=dev)
    cap_end = 1 + n_cap[:, None]                     # the [SEP] position
    if "phrase_ids" in tr:
        n_phr = torch.minimum(_lengths(n, tr["phrase_ids"], g, dev),
                              la - 2 - n_cap)
        phrases = torch.randint(vocab_w, vocab, (n, la), generator=g,
                                device=dev)
        phr_end = cap_end + 1 + n_phr[:, None]
        ids_a = torch.where(pos_a < cap_end, words, phrases)
    else:                                            # no phrase ids
        phr_end = cap_end + 1
        ids_a = words
    ids_a = torch.where(pos_a == cap_end, torch.full_like(ids_a, SEP), ids_a)
    ids_a[:, 0] = CLS
    mask_a = (pos_a < phr_end).long()
    ids_a = ids_a * mask_a
    pos_b = torch.arange(t, device=dev)[None]
    n_tag = _lengths(n, tr["tags"], g, dev)[:, None]
    ids_b = torch.randint(lo, vocab_w, (n, t), generator=g,
                          device=dev)
    ids_b = torch.where(pos_b == n_tag + 1, torch.full_like(ids_b, SEP),
                        ids_b)
    ids_b[:, 0] = CLS
    tag_mask = (pos_b < n_tag + 2).long()
    ids_b = ids_b * tag_mask
    n_reg = _lengths(n, tr["region_range"], g, dev)[:, None]
    reg_mask = (torch.arange(r, device=dev)[None] < n_reg).long()
    feats = torch.randn((n, r, cfg["img_feature_dim"]), generator=g,
                        device=dev).relu_()
    box = torch.rand((n, r, 6), generator=g, device=dev)
    feats[..., -6:] = box
    feats *= reg_mask[..., None]
    out = {
        "input_ids_a": ids_a, "attention_mask_a": mask_a,
        "token_type_ids_a": torch.zeros_like(ids_a),
        "input_ids_b": ids_b,
        "attention_mask_b": torch.cat([tag_mask, reg_mask], 1),
        "token_type_ids_b": torch.ones_like(ids_b),
        "img_feats": feats,
        "phrase_index": torch.cat([cap_end + 1, phr_end], 1),
        "image_index": torch.cat([torch.full_like(n_reg, la), la + n_reg], 1),
    }
    if mask:
        out["input_ids_a"], lab_a = _mask_tokens(
            ids_a, (pos_a >= 1) & (pos_a < cap_end), tr["mask_prob"],
            tr["max_pred_a"], g)
        ids_b, lab_b = _mask_tokens(ids_b, (pos_b >= 1) & (pos_b <= n_tag),
                                    tr["mask_prob"], tr["max_pred_b"], g)
        out["input_ids_b"] = ids_b
        out["lm_label_ids_a"] = lab_a
        out["lm_label_ids_b"] = torch.cat(
            [lab_b, torch.full_like(reg_mask, -1)], 1)
    return out


def single_stream(ex: Dict[str, torch.Tensor], cfg: dict, tr: dict,
                  g: torch.Generator) -> Dict[str, torch.Tensor]:
    """A masked two-stream example batch -> the single-stream model's inputs:
    [caption ; tags] ids and labels, the mask over them and the regions,
    match labels (half of the rows, at random, labelled as a mismatch), and
    `region_mask_prob` of the real regions masked: their features zeroed,
    their pre-mask features the regression targets, a tag class each."""
    feats = ex["img_feats"]
    n, r = feats.shape[:2]
    dev = feats.device
    real = ex["attention_mask_b"][:, -r:] > 0
    hit = real & (torch.rand((n, r), generator=g, device=dev)
                  < tr["region_mask_prob"])
    classes = torch.randint(0, cfg["od_tag_size"], (n, r), generator=g,
                            device=dev)
    t = ex["input_ids_b"].shape[1]
    return {
        "input_ids": torch.cat([ex["input_ids_a"], ex["input_ids_b"]], 1),
        "attention_mask": torch.cat([ex["attention_mask_a"],
                                     ex["attention_mask_b"]], 1),
        "token_type_ids": torch.cat([ex["token_type_ids_a"],
                                     ex["token_type_ids_b"]], 1),
        "img_feats": feats * (~hit)[..., None],
        "masked_lm_labels": torch.cat([ex["lm_label_ids_a"],
                                       ex["lm_label_ids_b"][:, :t]], 1),
        "next_sentence_label": torch.randint(0, 2, (n,), generator=g,
                                             device=dev),
        "masked_region_labels": torch.where(hit, classes,
                                            torch.full_like(classes, -1)),
        "masked_region_targets": feats,
        "masked_region_flags": hit.long(),
    }


def pretrain_batch(family: str, cfg: dict, tr: dict, g, device):
    ex = examples(tr["batch"], cfg, tr, g, device, mask=True)
    if family == "single_stream":
        return single_stream(ex, cfg, tr, g)
    return ex


def gallery(cfg: dict, tr: dict, g, device):
    """A retrieval test split: `images` images and `captions_per_image`
    captions each (caption c belongs to image c // captions_per_image) ->
    (caption arrays, image arrays)."""
    n_img, per = tr["images"], tr["captions_per_image"]
    caps = examples(n_img * per, cfg, tr, g, device, mask=False)
    imgs = examples(n_img, cfg, tr, g, device, mask=False)
    return ({k: caps[k] for k in ("input_ids_a", "attention_mask_a",
                                  "token_type_ids_a")},
            {k: imgs[k] for k in ("input_ids_b", "attention_mask_b",
                                  "token_type_ids_b", "img_feats")})
