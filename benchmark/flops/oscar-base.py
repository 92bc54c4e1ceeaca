"""Oscar's model FLOPs: a single-stream pretraining step at the padded
shapes the program runs."""

from benchmark.flops.transformer import TRAIN_FACTOR, dense, layers, lm_head


def train_step(cfg: dict, tr: dict) -> float:
    """Forward and backward of one `ImgBertForPreTraining` step with the
    masked-region heads: the encoder over [text ; tags ; regions], region
    projection, pooler, the MLM head at its gathered positions, ITM, and
    the MRF (transform, then the projection's transpose) and MRC heads over
    every region."""
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    feat = cfg["img_feature_dim"]
    b, la, t, r = tr["batch"], tr["text_len"], tr["tag_len"], tr["regions"]
    fwd = (layers(b, la + t + r, cfg["num_hidden_layers"], h, inter)
           + dense(b * r, feat, h) + dense(b, h, h)
           + lm_head(b * (tr["max_pred_a"] + tr["max_pred_b"]), h,
                     cfg["only_word_size"])
           + dense(b, h, cfg["num_contrast_classes"])
           + dense(b * r, h, h) + dense(b * r, h, feat)
           + dense(b * r, h, cfg["od_tag_size"]))
    return TRAIN_FACTOR * fwd
