"""Plain reference of the two-stream MVPTR model (Li et al., "MVPTR:
Multi-Level Semantic Alignment for Vision-Language Pre-Training via
Multi-Stage Learning", 2022): a text encoder, a vision encoder over
[CLS] tags [SEP] ++ projected regions, and a fusion encoder over the text
output and the tag-stripped vision output, each `num_hidden_layers // 2`
post-LN layers under one shared embedding table.

- `pretrain_loss`: the five pretraining losses of one step (tag MLM on the
  vision stream, the symmetric contrastive loss over in-batch similarities,
  text MLM on the fused output, ITM against mined hard negatives, and the
  phrase-region alignment (WRA) margin loss with sampled negatives).
- `encode_text`, `encode_image`, `itm_scores`: the two-stage retrieval
  model's encoders and its fused ITM head.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .common import (Blocks, Numerics, Stream, ce, gather_labelled, l2n,
                     masked_ce, param_spec_dense, param_spec_embeddings,
                     param_spec_encoder_layer, param_spec_lm_head)

STREAMS = ("txt_encoder", "vis_encoder", "mul_encoder")


def param_spec(cfg: dict, task: str):
    """(name, shape, init) of every parameter; `task` "pretrain" or
    "retrieval"."""
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    half = cfg["num_hidden_layers"] // 2
    out = param_spec_embeddings("bert.embeddings", cfg)
    for s in STREAMS:
        for i in range(half):
            out += param_spec_encoder_layer(f"bert.{s}.layer.{i}", h, inter)
    out += param_spec_dense("bert.pooler.dense", h, h)
    out += [("bert.txt_proj", (h, h), "proj"), ("bert.vis_proj", (h, h),
                                                "proj")]
    out += param_spec_dense("bert.img_embedding", h, cfg["img_feature_dim"])
    out += [("logit_scale", (), "logit_scale")]
    if task == "pretrain":
        n = cfg["only_word_size"]
        out += param_spec_lm_head("cls.predictions", h, n)
        out += param_spec_dense("cls.seq_relationship",
                                cfg["num_contrast_classes"], h)
        out += param_spec_lm_head("half_mlm", h, n)
    elif task == "retrieval":
        out += param_spec_dense("classifier", 2, h)
    else:
        raise ValueError(task)
    return out


class TwoStream:
    def __init__(self, W: Dict[str, torch.Tensor], cfg: dict,
                 num: Numerics):
        self.b = Blocks(W, cfg, num)
        self.W, self.cfg = W, cfg
        self.half = cfg["num_hidden_layers"] // 2

    def encode_text(self, ids, mask, types, st: Stream):
        """-> (sequence [B, La, H], l2-normalised global [B, H])."""
        b = self.b
        x = b.embeddings("bert.embeddings", ids, types, st)
        seq = b.encoder("bert.txt_encoder", self.half, x, mask, st)
        return seq, l2n(b.num.mm(seq[:, 0], self.W["bert.txt_proj"]))

    def encode_image(self, ids, mask, types, feats, st: Stream):
        """[CLS] tags [SEP] embeddings ++ projected regions (no position
        embedding on regions) -> (sequence [B, T+R, H], global [B, H])."""
        b = self.b
        tok = b.embeddings("bert.embeddings", ids, types, st)
        img = st.hidden(b.dense(feats.float(), "bert.img_embedding"))
        seq = b.encoder("bert.vis_encoder", self.half,
                        torch.cat([tok, img], 1), mask, st)
        return seq, l2n(b.num.mm(seq[:, 0], self.W["bert.vis_proj"]))

    def fuse(self, txt, txt_mask, vis, vis_mask, st: Stream):
        """Fusion encoder over [text ; tag-stripped vision] -> (sequence,
        pooled)."""
        seq = self.b.encoder("bert.mul_encoder", self.half,
                             torch.cat([txt, vis], 1),
                             torch.cat([txt_mask, vis_mask], 1), st)
        return seq, self.b.pooler("bert.pooler", seq)

    def itm_scores(self, txt, txt_mask, vis, vis_mask):
        """The retrieval head's P(match) of each (text, vision) row pair."""
        _, pooled = self.fuse(txt, txt_mask, vis, vis_mask,
                              Stream(None, 0, 0, torch.float32))
        logits = self.b.dense(pooled, "classifier")
        return torch.softmax(logits.float(), dim=-1)[:, 1]

    # ------------------------------------------------------------ pretrain
    def pretrain_loss(self, batch, st: Stream, *, max_tag_length: int,
                      max_pred_a: int, max_pred_b: int, phrase_width: int,
                      margin: float = 0.2, mined=None
                      ) -> Dict[str, torch.Tensor]:
        """The step's losses. With `mined` ((text, image) example of each
        hard slot, as another computation chose them) the hard pass fuses
        those pairs instead of this model's own choice (the draw of the
        slot permutation is made all the same); `self.mining` keeps this
        model's similarities, permutation and own choice either way."""
        W, cfg, b = self.W, self.cfg, self.b
        dev = batch["input_ids_a"].device
        mask_a = batch["attention_mask_a"]
        mask_b = batch["attention_mask_b"]
        txt, g_txt = self.encode_text(batch["input_ids_a"], mask_a,
                                      batch["token_type_ids_a"], st)
        vis, g_img = self.encode_image(batch["input_ids_b"], mask_b,
                                       batch["token_type_ids_b"],
                                       batch["img_feats"], st)
        only_vis, only_mask = vis[:, max_tag_length:], mask_b[:,
                                                              max_tag_length:]
        sim = g_txt @ g_img.t()
        n = sim.shape[0]
        # hard negatives: the most similar other image per text and other
        # text per image; a random half of the slots pair a text with its
        # hard image, the other half an image with its hard text
        with torch.no_grad():
            masked = sim - 2.0 * torch.eye(n, device=dev)
            hard_img, hard_txt = masked.argmax(1), masked.argmax(0)
            dice = st.randperm(n, dev)
            first = torch.arange(n, device=dev) < n // 2
            t_idx = torch.where(first, dice, hard_txt[dice])
            i_idx = torch.where(first, hard_img[dice], dice)
            self.mining = {"sim": sim.detach(), "dice": dice,
                           "txt": t_idx, "img": i_idx}
            if mined is not None:
                t_idx, i_idx = mined
        _, pooled_hard = self.fuse(txt[t_idx], mask_a[t_idx],
                                   only_vis[i_idx], only_mask[i_idx], st)
        seq, pooled = self.fuse(txt, mask_a, only_vis, only_mask, st)

        table = W["bert.embeddings.word_embeddings.weight"]
        n_words = cfg["only_word_size"]
        vh, vl = gather_labelled(vis, batch["lm_label_ids_b"], max_pred_b)
        vis_mlm = masked_ce(b.lm_head("half_mlm", vh, table, n_words), vl)
        scale = torch.exp(W["logit_scale"])
        logits = sim * scale
        labels = torch.arange(n, device=dev)
        clip = (ce(logits, labels) + ce(logits.t(), labels)) / 2.0
        la = batch["input_ids_a"].shape[1]
        mh, ml = gather_labelled(seq[:, :la], batch["lm_label_ids_a"],
                                 max_pred_a)
        mlm = masked_ce(b.lm_head("cls.predictions", mh, table, n_words), ml)
        itm_logits = b.dense(torch.cat([pooled, pooled_hard], 0),
                             "cls.seq_relationship")
        itm = ce(itm_logits, torch.cat([torch.zeros(n, dtype=torch.long,
                                                    device=dev),
                                        torch.ones(n, dtype=torch.long,
                                                   device=dev)]))
        wra = self.wra_sample(seq, batch["phrase_index"],
                              batch["image_index"], st, phrase_width,
                              batch["img_feats"].shape[1], margin)
        total = vis_mlm + clip + mlm + itm + wra
        return {"loss": total, "vis_mlm": vis_mlm, "clip": clip, "mlm": mlm,
                "itm": itm, "wra": wra}

    @staticmethod
    def _span(seq, span, width):
        l = seq.shape[1]
        idx = span[:, :1] + torch.arange(width, device=seq.device)[None]
        valid = (idx < span[:, 1:2]) & (idx < l)
        idx = torch.where(valid, idx, torch.zeros_like(idx))
        tok = seq.gather(1, idx[..., None].expand(-1, -1, seq.shape[-1]))
        return l2n(tok), valid.float()

    @staticmethod
    def _t2i(sims, ph_valid, im_valid, st: Stream):
        """Per phrase token: one of its 3 most similar valid regions drawn
        uniformly; the mean over valid phrase tokens."""
        neg_inf = torch.finfo(torch.float32).min
        masked = torch.where(im_valid[:, None, :] > 0, sims,
                             torch.full_like(sims, neg_inf))
        k = min(3, sims.shape[-1])
        top = torch.topk(masked, k, dim=-1).values
        ok = top > neg_inf / 2
        w = torch.where(ok.any(-1, keepdim=True), ok.float(),
                        torch.ones_like(top))
        pick = st.multinomial(w.reshape(-1, k)).reshape(top.shape[:-1])
        picked = top.gather(-1, pick[..., None])[..., 0]
        picked = torch.where(ok.any(-1), picked, torch.zeros_like(picked))
        return (picked * ph_valid).sum(-1) / ph_valid.sum(-1).clamp(min=1.0)

    def wra_sample(self, seq, phrase_index, image_index, st: Stream,
                   phrase_width: int, img_width: int, margin: float):
        """max(0, margin + s(phrase, other image) - s(phrase, own image)),
        the other image drawn uniformly among the rest of the batch; mean
        over rows with a phrase span."""
        n = seq.shape[0]
        ph, ph_valid = self._span(seq, phrase_index, phrase_width)
        im, im_valid = self._span(seq, image_index, img_width)
        num = self.b.num
        pos = self._t2i(num.mm(ph, im.transpose(1, 2)), ph_valid, im_valid,
                        st)
        ar = torch.arange(n, device=seq.device)
        neg_idx = (ar + st.randint(1, n, n, seq.device)) % n
        neg = self._t2i(num.mm(ph, im[neg_idx].transpose(1, 2)), ph_valid,
                        im_valid[neg_idx], st)
        loss = torch.clamp(neg + margin - pos, min=0.0)
        valid = (phrase_index[:, 1] > phrase_index[:, 0]).float()
        cnt = valid.sum()
        return torch.where(cnt > 0, (loss * valid).sum() / cnt.clamp(min=1.0),
                           torch.zeros_like(cnt))


def logit_scale_init() -> float:
    return math.log(1.0 / 0.07)
