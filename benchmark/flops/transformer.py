"""Forward FLOPs of the pieces of a BERT-style encoder, counted from shapes
(a multiply-add is two operations; only matrix products are counted)."""

from __future__ import annotations


def layers(n: int, length: int, depth: int, h: int, inter: int) -> float:
    """`depth` post-LN layers over n sequences of `length` tokens: the q, k,
    v and output projections, the two feed-forward products, and q.k^T and
    p.v over every (query, key) pair."""
    tokens = n * length
    return depth * (2.0 * tokens * (4 * h * h + 2 * h * inter)
                    + 4.0 * n * length * length * h)


def dense(rows: int, n_in: int, n_out: int) -> float:
    return 2.0 * rows * n_in * n_out


def lm_head(rows: int, h: int, n_words: int) -> float:
    """The transform (dense) and the tied decoder over `n_words` rows."""
    return dense(rows, h, h) + dense(rows, h, n_words)


# forward, input gradient and weight gradient: three products per product
TRAIN_FACTOR = 3.0
