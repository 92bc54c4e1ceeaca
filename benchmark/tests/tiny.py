"""Tiny copies of the benchmark's cells for CPU tests: the cell's own
pieces (config family, traffic mix, limits, metrics), with the widths,
lengths and batch cut so that the program's plain CPU path runs them in a
second or two."""

from __future__ import annotations

import time

from benchmark import harness

TINY_CONFIG = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=2,
                   intermediate_size=96, vocab_size=300, only_word_size=200,
                   max_position_embeddings=128, img_feature_dim=22,
                   od_tag_size=7)
TINY_TRAFFIC = dict(batch=6, text_len=16, caption_tokens=[3, 8],
                    phrase_ids=[1, 4], tag_len=6, tags=[1, 4], regions=5,
                    region_range=[2, 5], max_pred_a=3, max_pred_b=2,
                    phrase_width=4, pool=4, images=6, k_i2t=4, k_t2i=3,
                    enc_batch=4, pair_batch=16, check_pairs=20, check_rows=5,
                    trace_steps=2)
CELLS = ("mvptr-base.pretrain-b96", "mvptr-base.score-flickr1k",
         "oscar-base.pretrain-b96")


# the widths that set a product's rounding: a test of the lower-precision
# control keeps the cell's own
WIDTHS = ("hidden_size", "num_attention_heads", "intermediate_size",
          "img_feature_dim")


def cell(name: str, dtype: str = "float32", widths: bool = False
         ) -> harness.Cell:
    """The cell cut to a CPU size; with `widths`, at its own widths (only
    the depth, vocabulary, batch and lengths cut)."""
    c = harness.find_cell(name)
    tiny = {k: v for k, v in TINY_CONFIG.items()
            if not (widths and k in WIDTHS)}
    if c.config["vocab_size"] == c.config["only_word_size"]:
        tiny["vocab_size"] = tiny["only_word_size"]     # no phrase rows
    c.config = {**c.config, **tiny, "dtype": dtype}
    c.traffic = {**c.traffic, **{k: v for k, v in TINY_TRAFFIC.items()
                                 if k in c.traffic}}
    return c


def run(c: harness.Cell, trace: bool = False, seed: int = 2 ** 31 + 77,
        seconds: float = 0.3) -> dict:
    return harness.run_cell(c, seed, seconds, trace, "cpu",
                            time.perf_counter(), log=lambda *a, **k: None)
