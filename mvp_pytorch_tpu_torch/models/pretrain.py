"""The pretraining model, the JAX package's `models/pretrain.py`: the
5-loss composite `BiPretrainModel` (reference BiBertImgForPreTraining,
oscar/modeling/modeling_vlbert.py:1133-1311, and its QA variant) and the WRA
(word-region alignment) pieces it uses, the weakly supervised phrase-region
margin loss in its 'hard' and 'sample' modes (reference :1502-1596).

Random choices (dropout, sampled hard negatives, the slot permutation, the
WRA top-3 slot pick, the WRA negative example) draw from a `torch.Generator`
the caller passes; `hn_dice`, `pick` and `neg_offset` pin the last four, as
the JAX package's test hooks do.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

import torch
from torch import nn

from ..ops.masked import (cross_entropy, gather_masked_positions, gather_span,
                          masked_cross_entropy)
from .bi_encoder import BiEncoder, l2_normalize
from .config import ModelConfig
from .heads import LMPredictionHead, SeqRelationshipHead
from .layers import dropout_generator, init_weights, resolve_device


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


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class PretrainOutput(NamedTuple):
    total_loss: torch.Tensor
    vis_mlm_loss: torch.Tensor
    retrieval_loss: torch.Tensor
    masked_lm_loss: torch.Tensor
    itm_loss: torch.Tensor
    qa_loss: Optional[torch.Tensor]
    wra_loss: Optional[torch.Tensor]
    sim_mat: torch.Tensor
    # with debug_mlm: the text MLM's (top-1 prediction, labels, weights)
    mlm_debug: Optional[tuple] = None


class PretrainingHeads(nn.Module):
    """The reference's `cls` module: the text MLM head (`predictions`) and
    the ITM head (`seq_relationship`)."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.predictions = LMPredictionHead(config)
        self.seq_relationship = SeqRelationshipHead(config)


class BiPretrainModel(nn.Module):
    """BiEncoder + pretraining heads; calling it runs `train_step`, which
    returns the composite loss.

    Parameters, by the reference's state-dict keys: `bert.*`, `cls.predictions.*`
    (text MLM), `half_mlm.*` (tag MLM on the vision stream),
    `cls.seq_relationship.*` (ITM), `qa_head.*` (when
    `config.qa_answer_size > 0`), `qa_seq_relation.*` (with `qa_pairs`: the
    QA-pair relation head, whose params the JAX package creates only when it
    is called) and `logit_scale`. Both LM heads read the word table at call
    time; a reference state dict's tied `decoder.weight` copies are checked
    against the table and dropped on load."""

    TIED_DECODERS = ("cls.predictions.decoder.weight",
                     "half_mlm.decoder.weight")

    def __init__(self, config: ModelConfig, *, qa_pairs: bool = False,
                 device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        h = config.hidden_size
        self.config = config
        self.bert = BiEncoder(config)
        self.cls = PretrainingHeads(config)
        self.half_mlm = LMPredictionHead(config)
        if config.qa_answer_size > 0:
            self.qa_head = nn.Linear(h, config.qa_answer_size)
        if qa_pairs:
            self.qa_seq_relation = nn.Linear(h, 2)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))
        self.init_weights(torch.Generator().manual_seed(seed))
        self.to(device)
        self.eval()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init: the backbone's, normal(initializer_range)
        head kernels, zero biases; the QA heads (flax's default Dense) at
        LeCun normal's scale, fan_in^-1/2."""
        self.bert.init_weights(generator)
        std = self.config.initializer_range
        init_weights(self.cls, std, generator)
        init_weights(self.half_mlm, std, generator)
        for name in ("qa_head", "qa_seq_relation"):
            head = getattr(self, name, None)
            if head is not None:
                head.weight.normal_(0.0, head.in_features ** -0.5,
                                    generator=generator)
                head.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor],
                        strict: bool = True, assign: bool = False):
        """`nn.Module.load_state_dict`, after checking that the reference's
        tied decoder copies equal the first rows of the word table (and
        dropping them: the heads read the table itself)."""
        state_dict = dict(state_dict)
        table = state_dict.get("bert.embeddings.word_embeddings.weight")
        for key in self.TIED_DECODERS:
            dec = state_dict.pop(key, None)
            if dec is None:
                continue
            n = self.config.only_word_size
            if (table is None or tuple(dec.shape) != (n, table.shape[1])
                    or not torch.equal(dec.to(table.dtype), table[:n])):
                raise ValueError(f"{key} is not the first {n} rows of "
                                 f"bert.embeddings.word_embeddings.weight: "
                                 f"the port ties the decoder to the table")
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    def train_step(self, input_ids_a, attention_mask_a, token_type_ids_a,
                   lm_label_ids_a, input_ids_b, attention_mask_b,
                   token_type_ids_b, lm_label_ids_b, img_feats,
                   phrase_index=None, image_index=None, qa_ans=None,
                   qa_is_next=None, *, max_tag_length: int = 20,
                   max_pred_a: int = 20, max_pred_b: int = 10,
                   hn_mod: str = "hard", phrase_mod: str = "sample",
                   wra_phrase_width: int = 10,
                   phrase_layer: Optional[int] = None, hn_dice=None,
                   generator: Optional[torch.Generator] = None,
                   wra_pick: Optional[int] = None,
                   wra_neg_offset: Optional[int] = None,
                   debug_mlm: bool = False) -> PretrainOutput:
        """The JAX `BiPretrainModel.__call__`:
        1. tag MLM over the vision stream's labelled positions
           (`lm_label_ids_b`, -1 = unlabelled, at most `max_pred_b`);
        2. the symmetric CLIP cross-entropy over the in-batch similarities;
        3. text MLM over the fused output's first La positions
           (`lm_label_ids_a`, at most `max_pred_a`);
        4. ITM over [true ; hard] pooled outputs, labels 0 = true pair,
           1 = hard pair, with no dropout on the pooled output;
        5. with `qa_ans`, QA over the pooled output; with `qa_is_next`, the
           QA-pair relation, -1 rows ignored; both add to `qa_loss`;
        6. with `phrase_index`, WRA in `phrase_mod` 'sample' or 'hard',
           read at fusion layer `phrase_layer` or at the output.

        Dropout follows the module's training mode. Every random draw comes
        from `generator`; `hn_dice`, `wra_pick` and `wra_neg_offset` pin
        the slot permutation, the WRA slot pick and the WRA negative. With
        `debug_mlm` the output's `mlm_debug` holds the text MLM's top-1
        prediction, labels and weights at its gathered positions (the JAX
        package's `debug_mlm` intermediates, for `--mlm_debug`)."""
        # clamped at 100 (CLIP's guard; the reference has none)
        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        with dropout_generator(self, generator):
            out = self.bert(input_ids_a, attention_mask_a, token_type_ids_a,
                            input_ids_b, attention_mask_b, token_type_ids_b,
                            img_feats, max_tag_length=max_tag_length,
                            encode_hn=True, hn_mod=hn_mod, logit=scale,
                            phrase_layer=phrase_layer, hn_dice=hn_dice,
                            generator=generator)
        table = self.bert.word_table()

        vis_h, vis_labels, vis_w = gather_masked_positions(
            out.vis_output, lm_label_ids_b, max_pred_b)
        vis_mlm_loss = masked_cross_entropy(self.half_mlm(vis_h, table),
                                            vis_labels, vis_w)

        logits_mat = out.sim_mat * scale
        labels = torch.arange(logits_mat.shape[0], device=logits_mat.device)
        retrieval_loss = (cross_entropy(logits_mat, labels)
                          + cross_entropy(logits_mat.T, labels)) / 2.0

        la = input_ids_a.shape[1]
        mlm_h, mlm_labels, mlm_w = gather_masked_positions(
            out.sequence_output[:, :la], lm_label_ids_a, max_pred_a)
        mlm_logits = self.cls.predictions(mlm_h, table)
        masked_lm_loss = masked_cross_entropy(mlm_logits, mlm_labels, mlm_w)
        mlm_debug = ((mlm_logits.argmax(-1), mlm_labels, mlm_w)
                     if debug_mlm else None)

        # labels 0 = true pair, 1 = hard pair (the retrieval model's are
        # the other way round)
        pooled_all = torch.cat([out.pooled_output, out.hard_pooled_output], 0)
        itm_logits = self.cls.seq_relationship(pooled_all)
        n, dev = out.pooled_output.shape[0], pooled_all.device
        itm_labels = torch.cat([
            torch.zeros(n, dtype=torch.int64, device=dev),
            torch.ones(out.hard_pooled_output.shape[0], dtype=torch.int64,
                       device=dev)])
        itm_loss = cross_entropy(itm_logits, itm_labels)
        total = vis_mlm_loss + retrieval_loss + masked_lm_loss + itm_loss

        qa_loss = None
        pooled32 = out.pooled_output.float()
        if qa_ans is not None:
            if not hasattr(self, "qa_head"):
                raise ValueError("qa_ans needs config.qa_answer_size > 0")
            qa_loss = cross_entropy(self.qa_head(pooled32), qa_ans)
            total = total + qa_loss
        if qa_is_next is not None:
            if not hasattr(self, "qa_seq_relation"):
                raise ValueError("qa_is_next needs BiPretrainModel(..., "
                                 "qa_pairs=True)")
            rel = masked_cross_entropy(self.qa_seq_relation(pooled32),
                                       qa_is_next, (qa_is_next >= 0).float())
            total = total + rel
            qa_loss = rel if qa_loss is None else qa_loss + rel

        wra_loss = None
        if phrase_index is not None:
            mid = phrase_layer is not None
            seq = out.mid_joint if mid else out.sequence_output
            kw = dict(phrase_width=wra_phrase_width,
                      img_width=img_feats.shape[1], pick=wra_pick)
            if phrase_mod == "sample":
                wra_loss = wra_sample_loss(seq, phrase_index, image_index,
                                           generator, neg_offset=wra_neg_offset,
                                           **kw)
            elif phrase_mod == "hard":
                wra_loss = wra_hard_loss(
                    seq, out.mid_hard if mid else out.hard_sequence_output,
                    phrase_index, image_index, out.hard_txt_index,
                    out.hard_img_index, generator, **kw)
            else:
                raise NotImplementedError(phrase_mod)
            total = total + wra_loss

        return PretrainOutput(
            total_loss=total, vis_mlm_loss=vis_mlm_loss,
            retrieval_loss=retrieval_loss, masked_lm_loss=masked_lm_loss,
            itm_loss=itm_loss, qa_loss=qa_loss, wra_loss=wra_loss,
            sim_mat=out.sim_mat, mlm_debug=mlm_debug)

    def forward(self, *args, **kwargs) -> PretrainOutput:
        return self.train_step(*args, **kwargs)
