"""Plain reference of the single-stream Oscar / VinVL pretraining model
(Li et al., "Oscar: Object-Semantics Aligned Pre-training for
Vision-Language Tasks", 2020; Zhang et al., "VinVL", 2021): one BERT
encoder over [text ; tags ; projected regions] with masked-token
prediction over the text and tag positions, image-text match on the pooled
output, and, for the masked regions, tag classification and feature
regression through the region projection's transpose.
"""

from __future__ import annotations

from typing import Dict

import torch

from .common import (Blocks, Numerics, Stream, gather_labelled, gelu,
                     masked_ce, param_spec_dense, param_spec_embeddings,
                     param_spec_encoder_layer, param_spec_lm_head)


def param_spec(cfg: dict, task: str = "pretrain"):
    if task != "pretrain":
        raise ValueError(task)
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    out = param_spec_embeddings("bert.embeddings", cfg)
    for i in range(cfg["num_hidden_layers"]):
        out += param_spec_encoder_layer(f"bert.encoder.layer.{i}", h, inter)
    out += param_spec_dense("bert.pooler.dense", h, h)
    out += param_spec_dense("bert.img_embedding", h, cfg["img_feature_dim"])
    out += param_spec_lm_head("cls.predictions", h, cfg["only_word_size"])
    out += param_spec_dense("cls.seq_relationship",
                            cfg["num_contrast_classes"], h)
    out += param_spec_dense("cls.MRF_predictor.0", h, h)
    out += [("cls.MRF_predictor.2.weight", (h,), "ones"),
            ("cls.MRF_predictor.2.bias", (h,), "zeros")]
    out += param_spec_dense("cls.MRC_predictor", cfg["od_tag_size"], h)
    out += [("cls.MRF_bias", (cfg["img_feature_dim"],), "zeros")]
    return out


class SingleStream:
    def __init__(self, W: Dict[str, torch.Tensor], cfg: dict,
                 num: Numerics):
        self.b = Blocks(W, cfg, num)
        self.W, self.cfg = W, cfg

    def pretrain_loss(self, batch, st: Stream, *, max_pred: int
                      ) -> Dict[str, torch.Tensor]:
        W, cfg, b = self.W, self.cfg, self.b
        ids = batch["input_ids"]
        x = b.embeddings("bert.embeddings", ids, batch["token_type_ids"], st)
        img = st.hidden(b.dense(batch["img_feats"].float(),
                                "bert.img_embedding"))
        seq = b.encoder("bert.encoder", cfg["num_hidden_layers"],
                        torch.cat([x, img], 1), batch["attention_mask"], st)
        pooled = b.pooler("bert.pooler", seq)
        la = ids.shape[1]
        table = W["bert.embeddings.word_embeddings.weight"]
        mh, ml = gather_labelled(seq[:, :la], batch["masked_lm_labels"],
                                 max_pred)
        mlm = masked_ce(b.lm_head("cls.predictions", mh, table,
                                  cfg["only_word_size"]), ml)
        itm = masked_ce(b.dense(pooled, "cls.seq_relationship"),
                        batch["next_sentence_label"])
        regions = seq[:, la:]
        h = b.ln(gelu(b.dense(regions, "cls.MRF_predictor.0")),
                 "cls.MRF_predictor.2", cfg["img_layer_norm_eps"])
        mrf_out = b.num.mm(h, W["bert.img_embedding.weight"]) + \
            W["cls.MRF_bias"]
        mrc = masked_ce(b.dense(regions, "cls.MRC_predictor"),
                        batch["masked_region_labels"])
        flags = batch["masked_region_flags"].float()
        sq = (mrf_out - batch["masked_region_targets"].float()) ** 2
        mrf = (flags[..., None] * sq).sum() / torch.clamp(
            flags.sum() * mrf_out.shape[-1], min=1.0)
        total = mlm + itm + mrc + mrf
        return {"loss": total, "mlm": mlm, "itm": itm, "mrc": mrc,
                "mrf": mrf}
