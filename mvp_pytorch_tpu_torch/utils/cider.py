"""CIDEr and CIDEr-D scorers (pure numpy): the port's copy of the JAX
package's `utils/cider.py`.

Parity target: reference `oscar/utils/cider/pyciderevalcap/` (cider_scorer.py,
ciderD_scorer.py) — consensus-based n-gram TF-IDF similarity between a
candidate caption and reference captions, n = 1..4, with CIDEr-D's length
gaussian penalty and count clipping. Implemented from the published CIDEr
algorithm (Vedantam et al., CVPR'15).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np


def ngram_counts(tokens: Sequence[str], n_max: int = 4) -> Counter:
    out = Counter()
    for n in range(1, n_max + 1):
        for i in range(len(tokens) - n + 1):
            out[tuple(tokens[i:i + n])] += 1
    return out


class CiderScorer:
    """Corpus-level scorer: document frequencies come from the reference
    sets of the evaluation corpus (standard protocol)."""

    def __init__(self, n: int = 4, sigma: float = 6.0, cider_d: bool = True):
        self.n = n
        self.sigma = sigma
        self.cider_d = cider_d

    def _doc_freq(self, refs_list: List[List[Counter]]) -> Dict[tuple, float]:
        df = defaultdict(float)
        for refs in refs_list:
            seen = set()
            for r in refs:
                seen.update(r.keys())
            for g in seen:
                df[g] += 1.0
        return df

    def _vec(self, cnts: Counter, df, log_ref_len: float):
        vec = [defaultdict(float) for _ in range(self.n)]
        norm = [0.0] * self.n
        length = 0
        for g, c in cnts.items():
            n = len(g) - 1
            idf = math.log(max(1.0, df.get(g, 0.0)))
            w = c * max(log_ref_len - idf, 0.0)
            vec[n][g] = w
            norm[n] += w * w
            if n == 0:
                length += c
        return vec, [math.sqrt(x) for x in norm], length

    def _sim(self, vec_c, norm_c, len_c, vec_r, norm_r, len_r):
        delta = len_c - len_r
        val = np.zeros(self.n)
        for n in range(self.n):
            for g, wc in vec_c[n].items():
                wr = vec_r[n].get(g, 0.0)
                val[n] += (min(wc, wr) if self.cider_d else wc) * wr
            if norm_c[n] and norm_r[n]:
                val[n] /= norm_c[n] * norm_r[n]
            if self.cider_d:
                val[n] *= math.exp(-delta ** 2 / (2 * self.sigma ** 2))
        return val

    def compute(self, candidates: List[List[str]],
                references: List[List[List[str]]]) -> Tuple[float, np.ndarray]:
        """candidates[i]: token list; references[i]: list of token lists.
        Returns (corpus mean * 10, per-candidate scores * 10)."""
        assert len(candidates) == len(references)
        ref_counts = [[ngram_counts(r, self.n) for r in refs]
                      for refs in references]
        df = self._doc_freq(ref_counts)
        log_ref_len = math.log(max(1.0, float(len(references))))
        scores = []
        for cand, refs in zip(candidates, ref_counts):
            vec_c, norm_c, len_c = self._vec(ngram_counts(cand, self.n), df,
                                             log_ref_len)
            agg = np.zeros(self.n)
            for r in refs:
                vec_r, norm_r, len_r = self._vec(r, df, log_ref_len)
                agg += self._sim(vec_c, norm_c, len_c, vec_r, norm_r, len_r)
            score = np.mean(agg) * 10.0 / max(len(refs), 1)
            scores.append(score)
        scores = np.asarray(scores)
        return float(scores.mean()), scores
