"""MLM-style masking: this package's copy of the JAX package's
`data/masking.py`, draw for draw (the same `random.Random` stream gives the
same masks).

Parity targets (reference `oscar/oscar_datasets_ml/oscar_tsv4.py`):
- random_word (:782-820): 15% of tokens -> 80% [MASK] / 10% random vocab
  token / 10% unchanged; label = original id, -1 elsewhere.
- random_phrases (:822-848): phrases whose source words were masked (via
  phrase_mask_map) are force-masked; plus 15% random masking with 80/10/10.
  The reference zeroes phrase labels afterwards (oscar_tsv4.py:961):
  phrases are masked but not predicted, so the labels are returned
  separately for callers to drop.
- random_visual (:868-893): 15% of regions -> feature zeroed (geometry
  kept), label = tag id for masked regions, -1 elsewhere.

Every function takes an explicit `random.Random`, so that a pipeline is
deterministic and resumable (the reference uses the global `random`).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MASK_TOKEN = "[MASK]"
UNK_TOKEN = "[UNK]"


def random_word(tokens: List[str], vocab: Dict[str, int],
                rng: random.Random, *, mask_prob: float = 0.15
                ) -> Tuple[List[str], List[int]]:
    """In-place 80/10/10 masking; returns (tokens, labels)."""
    vocab_list = getattr(random_word, "_cache", None)
    # the key list of the 10% random draw, cached per vocab object
    if vocab_list is None or vocab_list[0] is not vocab:
        vocab_list = (vocab, list(vocab.keys()))
        random_word._cache = vocab_list
    keys = vocab_list[1]

    labels = []
    for i, token in enumerate(tokens):
        prob = rng.random()
        if prob < mask_prob:
            prob /= mask_prob
            if prob < 0.8:
                tokens[i] = MASK_TOKEN
            elif prob < 0.9:
                tokens[i] = rng.choice(keys)
            labels.append(vocab.get(token, vocab[UNK_TOKEN]))
        else:
            labels.append(-1)
    return tokens, labels


def random_phrases(phrase_nodes: List[int], word_labels: Sequence[int],
                   phrase_mask_map: Optional[Dict[int, Sequence[int]]],
                   vocab: Dict[str, int], vocab_size: int,
                   phrase_vocab_size: int, rng: random.Random, *,
                   mask_prob: float = 0.15) -> Tuple[List[int], List[int]]:
    """Mask the phrase ids linked to masked words, and 15% at random.
    Returns (phrase_nodes, labels); the labels carry the original phrase id
    of each masked slot (callers may drop them, as the reference does)."""
    already = set()
    if phrase_mask_map:
        for i, lbl in enumerate(word_labels):
            if lbl >= 0 and i in phrase_mask_map:
                already.update(phrase_mask_map[i])
    labels = []
    for i, phrase in enumerate(phrase_nodes):
        if i in already:
            labels.append(phrase)
            phrase_nodes[i] = vocab[MASK_TOKEN]
        else:
            prob = rng.random()
            if prob < mask_prob:
                prob /= mask_prob
                if prob < 0.8:
                    phrase_nodes[i] = vocab[MASK_TOKEN]
                elif prob < 0.9:
                    phrase_nodes[i] = rng.randrange(phrase_vocab_size) + vocab_size
                labels.append(phrase)
            else:
                labels.append(-1)
    return phrase_nodes, labels


def random_visual(regions: np.ndarray, od_tags: Sequence[str],
                  tag2id: Dict[str, int], rng: random.Random, *,
                  mask_prob: float = 0.15, geometry_dims: int = 6
                  ) -> Tuple[np.ndarray, List[int], List[int]]:
    """Zero the masked regions' features in place (the box geometry kept);
    label = the region's tag id. Returns (regions, labels, mask flags)."""
    # one draw per region, in row order, all drawn first, so that the masked
    # rows are zeroed in one vectorised assignment (the stream consumed is
    # the per-row loop's)
    n = regions.shape[0]
    masked = [rng.random() < mask_prob for _ in range(n)]
    if any(masked):
        regions[np.asarray(masked), :-geometry_dims] = 0
    n_tags = len(od_tags)
    labels = [(tag2id.get(od_tags[i], -1) if i < n_tags else -1)
              if m else -1 for i, m in enumerate(masked)]
    flags = [1 if m else 0 for m in masked]
    return regions, labels, flags
