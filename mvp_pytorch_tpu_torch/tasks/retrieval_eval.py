"""Two-stage retrieval evaluation index algebra (pure host logic).

This package's copy of the JAX package's `tasks/retrieval_eval.py`.
Parity target: reference `oscar/run_retrieval.py` compute_ranks_coarse
(:481-522), compute_ranks / compute_ranks_t2i (:725-782), evaluate R@1/5/10
(:828-856).

Conventions (the reference's):
- `sims` is [n_img, n_cap] (img_emb @ txt_emb.T).
- caption j belongs to image j // caps_per_img.
- rank = 0-based position of the first correct item in descending-score
  order; R@K = fraction with rank < K.
- tie order is the reference's `np.argsort(row)[::-1]`, issued as the same
  call (numpy's default sort is not stable, so only the same call breaks
  ties the same way).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def _desc_order(x: np.ndarray) -> np.ndarray:
    """Row-wise descending argsort with the reference's tie order."""
    return np.argsort(x, axis=-1)[..., ::-1]


def recall_at_k(ranks: Sequence[int], ks: Sequence[int] = (1, 5, 10)
                ) -> Dict[str, float]:
    ranks = np.asarray(list(ranks))
    return {f"R@{k}": float(np.mean(ranks < k)) for k in ks}


def coarse_ranks(sims: np.ndarray, caps_per_img: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(i2t_ranks [n_img], t2i_ranks [n_cap]) from the coarse sim matrix."""
    n_img, n_cap = sims.shape
    if n_cap != n_img * caps_per_img:
        raise ValueError(f"{n_cap} captions for {n_img} images x "
                         f"{caps_per_img}")
    order_i2t = _desc_order(sims)
    correct = (order_i2t // caps_per_img) == np.arange(n_img)[:, None]
    i2t_ranks = np.argmax(correct, axis=1)
    order_t2i = _desc_order(sims.T)
    own = np.arange(n_cap) // caps_per_img
    t2i_ranks = np.argmax(order_t2i == own[:, None], axis=1)
    return i2t_ranks, t2i_ranks


def coarse_candidates(sims: np.ndarray, k_i2t: int, k_t2i: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(i2t_cands [n_img, k_i2t] caption ids, t2i_cands [n_cap, k_t2i]
    image ids): the rerank shortlists."""
    return _desc_order(sims)[:, :k_i2t], _desc_order(sims.T)[:, :k_t2i]


def fine_ranks_i2t(scores: np.ndarray, cand_caps: np.ndarray,
                   caps_per_img: int) -> np.ndarray:
    """Ranks after the i2t rerank; rank = K when no correct caption is in
    the shortlist (reference compute_ranks)."""
    n_img, k = scores.shape
    sorted_caps = np.take_along_axis(cand_caps, _desc_order(scores), axis=1)
    correct = (sorted_caps // caps_per_img) == np.arange(n_img)[:, None]
    return np.where(correct.any(axis=1), np.argmax(correct, axis=1), k)


def fine_ranks_t2i(scores: np.ndarray, cand_imgs: np.ndarray,
                   caps_per_img: int) -> np.ndarray:
    """Ranks after the t2i rerank. scores/cand_imgs: [n_cap, K]."""
    n_cap, k = scores.shape
    sorted_imgs = np.take_along_axis(cand_imgs, _desc_order(scores), axis=1)
    correct = sorted_imgs == (np.arange(n_cap) // caps_per_img)[:, None]
    return np.where(correct.any(axis=1), np.argmax(correct, axis=1), k)


def mask_shortlist_misses(ranks: np.ndarray, k: int) -> np.ndarray:
    """Move the not-in-shortlist sentinel (rank == k) past every recall
    cutoff, so that a shortlist shorter than a cutoff does not count a miss
    as a hit."""
    r = np.asarray(ranks)
    return np.where(r >= k, np.iinfo(np.int64).max, r)


def evaluate_ranks(i2t_ranks, t2i_ranks) -> Dict[str, Dict[str, float]]:
    out = {"i2t_retrieval": recall_at_k(i2t_ranks)}
    if t2i_ranks is not None and len(t2i_ranks):
        out["t2i_retrieval"] = recall_at_k(t2i_ranks)
    return out
