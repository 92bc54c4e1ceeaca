"""SigLIP's model FLOPs: a pretraining step at the shapes the program runs,
counted at the head dim of 72 (no padded tile, no recompute)."""

from benchmark.flops.transformer import TRAIN_FACTOR, dense, layers


def forward(cfg: dict, tr: dict) -> float:
    """One forward over `batch` pairs: the patch product, the vision and
    text layers, the MAP head (the probe's query, the tokens' keys and
    values, q.k^T and p.v over one query, the output projection and the
    MLP), the text head and the B x B logits."""
    v, t = cfg["vision_config"], cfg["text_config"]
    h, inter = v["hidden_size"], v["intermediate_size"]
    b = tr["batch"]
    n = (v["image_size"] // v["patch_size"]) ** 2
    patch = v["num_channels"] * v["patch_size"] ** 2
    vision = (dense(b * n, patch, h)
              + layers(b, n, v["num_hidden_layers"], h, inter)
              + dense(b, h, h) + dense(b * n, h, 2 * h) + 4.0 * b * n * h
              + dense(b, h, h) + dense(b, h, inter) + dense(b, inter, h))
    ht = t["hidden_size"]
    text = (layers(b, tr["text_len"], t["num_hidden_layers"], ht,
                   t["intermediate_size"]) + dense(b, ht, ht))
    return vision + text + 2.0 * b * b * h


def train_step(cfg: dict, tr: dict) -> float:
    """Forward and backward (three products a product) of one step."""
    return TRAIN_FACTOR * forward(cfg, tr)
