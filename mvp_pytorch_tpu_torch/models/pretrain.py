"""The WRA (word-region alignment) pieces of the JAX package's
`models/pretrain.py:46-137`: the weakly supervised phrase-region margin loss
in its 'hard' and 'sample' modes (reference modeling_vlbert.py:1502-1596).

Random choices (the top-3 slot pick, the negative example) draw from a
`torch.Generator` the caller passes; `pick` and `neg_offset` pin them, as the
JAX package's test hooks do. `BiPretrainModel` waits for the pretraining
slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.masked import gather_span
from .bi_encoder import l2_normalize


def t2i_sim(sims: torch.Tensor, phrase_valid: torch.Tensor,
            img_valid: torch.Tensor,
            generator: Optional[torch.Generator] = None,
            pick: Optional[int] = None) -> torch.Tensor:
    """sims [B, P, R] phrase-token x region-token similarities -> [B].

    For each valid phrase token: the top 3 over valid regions, one of the
    valid ones among them drawn uniformly (or slot `pick`), then the mean
    over valid phrase tokens (0 where the phrase span is empty)."""
    neg_inf = torch.finfo(torch.float32).min
    masked = torch.where(img_valid[:, None, :] > 0, sims.float(),
                         torch.full_like(sims, neg_inf, dtype=torch.float32))
    k = min(3, sims.shape[-1])
    topk = torch.topk(masked, k, dim=-1).values                # [B, P, k]
    slot_valid = topk > neg_inf / 2
    if pick is not None:
        choice = torch.full(topk.shape[:-1], pick, dtype=torch.int64,
                            device=sims.device)
    else:
        w = slot_valid.float()
        w = torch.where(slot_valid.any(-1, keepdim=True), w,
                        torch.ones_like(w))
        choice = torch.multinomial(w.reshape(-1, k), 1, generator=generator
                                   ).reshape(topk.shape[:-1])
    picked = topk.gather(-1, choice[..., None])[..., 0]
    picked = torch.where(slot_valid.any(-1), picked, torch.zeros_like(picked))
    denom = phrase_valid.sum(-1).clamp(min=1.0)
    return (picked * phrase_valid).sum(-1) / denom


def span_tokens(seq: torch.Tensor, span: torch.Tensor, width: int):
    toks, valid = gather_span(seq, span, width)
    return l2_normalize(toks.float()), valid


def wra_sample_loss(sequence_output, phrase_index, image_index,
                    generator: Optional[torch.Generator] = None, *,
                    phrase_width: int, img_width: int, margin: float = 0.2,
                    pick: Optional[int] = None,
                    neg_offset: Optional[int] = None) -> torch.Tensor:
    """'sample' mode: the positive is the example's own image span, the
    negative a uniformly drawn other example's (or the one `neg_offset`
    ahead)."""
    b = sequence_output.shape[0]
    ph, ph_valid = span_tokens(sequence_output, phrase_index, phrase_width)
    im, im_valid = span_tokens(sequence_output, image_index, img_width)
    pos = t2i_sim(torch.einsum("bph,brh->bpr", ph, im), ph_valid, im_valid,
                  generator, pick=pick)
    ar = torch.arange(b, device=sequence_output.device)
    if neg_offset is not None:
        neg_idx = (ar + neg_offset) % b
    else:
        neg_idx = (ar + torch.randint(1, b, (b,), generator=generator,
                                      device=ar.device)) % b
    neg = t2i_sim(torch.einsum("bph,brh->bpr", ph, im[neg_idx]), ph_valid,
                  im_valid[neg_idx], generator, pick=pick)
    loss = torch.clamp(neg + margin - pos, min=0.0)
    valid = (phrase_index[:, 1] > phrase_index[:, 0]).float()
    return (loss * valid).sum() / valid.sum().clamp(min=1.0)


def wra_hard_loss(sequence_output, hard_sequence_output, phrase_index,
                  image_index, hard_txt_index, hard_img_index,
                  generator: Optional[torch.Generator] = None, *,
                  phrase_width: int, img_width: int, margin: float = 0.2,
                  pick: Optional[int] = None) -> torch.Tensor:
    """'hard' mode: the negative similarities come from the hard-negative
    fusion pass (reference modeling_vlbert.py:1272-1284)."""
    ph, ph_valid = span_tokens(sequence_output, phrase_index, phrase_width)
    im, im_valid = span_tokens(sequence_output, image_index, img_width)
    pos = t2i_sim(torch.einsum("bph,brh->bpr", ph, im), ph_valid, im_valid,
                  generator, pick=pick)
    hard_phrase_index = phrase_index[hard_txt_index]
    hard_image_index = image_index[hard_img_index]
    hph, hph_valid = span_tokens(hard_sequence_output, hard_phrase_index,
                                 phrase_width)
    him, him_valid = span_tokens(hard_sequence_output, hard_image_index,
                                 img_width)
    neg = t2i_sim(torch.einsum("bph,brh->bpr", hph, him), hph_valid,
                  him_valid, generator, pick=pick)
    loss = torch.clamp(neg + margin - pos, min=0.0)
    valid = ((phrase_index[:, 1] > phrase_index[:, 0])
             & (hard_phrase_index[:, 1] > hard_phrase_index[:, 0])).float()
    return (loss * valid).sum() / valid.sum().clamp(min=1.0)
