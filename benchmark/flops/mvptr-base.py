"""MVPTR's model FLOPs: a two-stream pretraining step and a two-stage
retrieval sweep, counted at the padded shapes the program runs."""

from benchmark.flops.transformer import TRAIN_FACTOR, dense, layers, lm_head


def _dims(cfg):
    return (cfg["hidden_size"], cfg["intermediate_size"],
            cfg["num_hidden_layers"] // 2, cfg["img_feature_dim"])


def train_step(cfg: dict, tr: dict) -> float:
    """Forward and backward of one `BiPretrainModel` step: text and vision
    streams, the fusion encoder over the true and the hard-negative pairs,
    region projection, global projections and similarities, pooler, both
    MLM heads at their gathered positions, ITM and the WRA similarities."""
    h, inter, half, feat = _dims(cfg)
    b, la, t, r = tr["batch"], tr["text_len"], tr["tag_len"], tr["regions"]
    fwd = (layers(b, la, half, h, inter) + layers(b, t + r, half, h, inter)
           + 2 * layers(b, la + r, half, h, inter)
           + dense(b * r, feat, h) + 2 * dense(b, h, h) + 2.0 * b * b * h
           + 2 * dense(b, h, h)
           + lm_head(b * tr["max_pred_a"], h, cfg["only_word_size"])
           + lm_head(b * tr["max_pred_b"], h, cfg["only_word_size"])
           + dense(2 * b, h, cfg["num_contrast_classes"])
           + 2 * 2.0 * b * tr["phrase_width"] * r * h)
    return TRAIN_FACTOR * fwd


def score_sweep(cfg: dict, tr: dict) -> float:
    """Forward of one sweep: every caption and image encoded once, the
    coarse similarities, and the fusion encoder, pooler and ITM head over
    every candidate pair."""
    h, inter, half, feat = _dims(cfg)
    la, t, r = tr["text_len"], tr["tag_len"], tr["regions"]
    n_img = tr["images"]
    n_cap = n_img * tr["captions_per_image"]
    pairs = n_img * tr["k_i2t"] + n_cap * tr["k_t2i"]
    return (layers(n_cap, la, half, h, inter) + dense(n_cap, h, h)
            + layers(n_img, t + r, half, h, inter) + dense(n_img * r, feat, h)
            + dense(n_img, h, h) + 2.0 * n_img * n_cap * h
            + layers(pairs, la + r, half, h, inter) + dense(pairs, h, h)
            + dense(pairs, h, 2))
