"""Caption metrics: corpus BLEU-1..4 and `evaluate_captions`, the port's
copy of the JAX package's `utils/caption_eval.py` (:1-92; reference
`oscar/utils/caption_evaluate.py` evaluate_on_coco_caption, :59-92). The
nocaps evaluator and the TSV-to-COCO conversion of that file are not
ported.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List

from .cider import CiderScorer


def bleu_n(candidates: List[List[str]], references: List[List[List[str]]],
           max_n: int = 4) -> List[float]:
    """Corpus BLEU-1..max_n with brevity penalty (standard algorithm)."""
    matches = [0] * max_n
    totals = [0] * max_n
    cand_len = ref_len = 0
    for cand, refs in zip(candidates, references):
        cand_len += len(cand)
        # closest reference length; pycocoevalcap's 'closest' takes
        # min((abs diff, len)) — ties prefer the SHORTER reference
        # (bleu_scorer.py single_reflen), which sets the brevity penalty
        closest = min((abs(len(r) - len(cand)), len(r)) for r in refs)[1]
        ref_len += closest
        for n in range(1, max_n + 1):
            c_ngrams = Counter(tuple(cand[i:i + n])
                               for i in range(len(cand) - n + 1))
            max_ref = Counter()
            for r in refs:
                r_ngrams = Counter(tuple(r[i:i + n])
                                   for i in range(len(r) - n + 1))
                for g, c in r_ngrams.items():
                    max_ref[g] = max(max_ref[g], c)
            matches[n - 1] += sum(min(c, max_ref[g])
                                  for g, c in c_ngrams.items())
            totals[n - 1] += max(sum(c_ngrams.values()), 0)
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1))
    out = []
    logsum = 0.0
    for n in range(max_n):
        p = matches[n] / totals[n] if totals[n] else 0.0
        logsum += math.log(max(p, 1e-12))
        out.append(bp * math.exp(logsum / (n + 1)))
    return out


def evaluate_captions(predictions: Dict[str, List[str]],
                      references: Dict[str, List[List[str]]],
                      spice=None, synonyms=None) -> Dict[str, float]:
    """{'Bleu_1'..'Bleu_4', 'METEOR', 'ROUGE_L', 'CIDEr'[, 'SPICE']} over
    tokenized captions — the reference's evaluate_on_coco_caption metric
    surface (`oscar/utils/caption_evaluate.py:59-92`). SPICE runs through
    the spice-1.0.jar subprocess contract (utils/spice.py) and auto-enables
    when the jar is discoverable; absent jar = key omitted (the default
    `spice=None` probes discovery; pass a SpiceMetric to pin a jar, or
    False to skip). METEOR runs exact+stem stages, plus the synonym stage
    when a local synonym table is discoverable (the WordNet role in the
    COCO jar; same default-None-probes / table-pins / False-skips
    convention — see utils/meteor_rouge.py)."""
    from .meteor_rouge import (find_synonym_file, load_synonyms, meteor,
                               rouge_l)
    keys = sorted(predictions.keys())
    cands = [predictions[k] for k in keys]
    refs = [references[k] for k in keys]
    bleu = bleu_n(cands, refs)
    cider_mean, _ = CiderScorer().compute(cands, refs)
    out = {f"Bleu_{i+1}": b for i, b in enumerate(bleu)}
    if synonyms is None:
        syn_path = find_synonym_file()
        synonyms = load_synonyms(syn_path) if syn_path else None
    out["METEOR"] = meteor(cands, refs, synonyms=synonyms or None)
    out["ROUGE_L"] = rouge_l(cands, refs)
    out["CIDEr"] = cider_mean
    if spice is not False:
        if spice is None:
            from .spice import SpiceMetric
            spice = SpiceMetric()
        if spice.available:
            res = spice.compute(cands, refs)
            if res is not None:
                out["SPICE"] = res[0]
    return out
