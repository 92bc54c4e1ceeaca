"""Pure-Python METEOR and ROUGE-L caption metrics, the port's copy of the
JAX package's `utils/meteor_rouge.py`.

Parity target: the reference reports BLEU/METEOR/ROUGE-L/CIDEr/SPICE via
the COCO-caption package (`oscar/utils/caption_evaluate.py:59-92`). BLEU
and CIDEr live in caption_eval.py / cider.py; this module adds the two
metrics that are pure algorithm (no jar, no WordNet, no network):

- ROUGE-L: the pycocoevalcap formulation — per-image max-over-references
  LCS precision/recall combined with beta=1.2 F-score, corpus = mean.
- METEOR: the published algorithm (Banerjee & Lavie 2005 constants as in
  NLTK: alpha=0.9, beta=3, gamma=0.5) with exact + Porter-stem matching
  stages, plus an optional SYNONYM stage driven by a local synonym table
  (the role WordNet plays in the COCO jar). Drop a synonym file in place
  (discovery below, mirroring the SPICE jar contract in utils/spice.py)
  and the stage auto-enables everywhere `evaluate_captions` is used;
  without one, scores are a close lower bound of the jar's (documented
  non-parity: synonym stage only).

Synonym file discovery: $METEOR_SYNONYMS, then
tools_tpu/meteor/synonyms.{json,tsv}, then
~/.cache/mvptr/meteor/synonyms.{json,tsv}. Formats: JSON
{"word": ["syn", ...]} or TSV lines "word<TAB>syn1 syn2 ...". Two tokens
match at the synonym stage when either lists the other (the symmetric
closure is applied at load).

The Porter stemmer is implemented from the published algorithm
(Porter 1980), steps 1a-5b.
"""

from __future__ import annotations

import json
import os
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# ---------------------------------------------------------------------------
# Porter stemmer (Porter 1980) — compact implementation of the paper's rules
# ---------------------------------------------------------------------------

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """m = number of VC sequences in the stem's C?(VC){m}V? form."""
    m = 0
    prev_v = False
    for i in range(len(stem)):
        v = not _is_cons(stem, i)
        if prev_v and not v:
            m += 1
        prev_v = v
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_cons(word, len(word) - 1))


def _ends_cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    return (_is_cons(word, len(word) - 3)
            and not _is_cons(word, len(word) - 2)
            and _is_cons(word, len(word) - 1)
            and word[-1] not in "wxy")


def porter_stem(word: str) -> str:
    if len(word) <= 2:
        return word
    w = word

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w, flag = w[:-2], True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w, flag = w[:-3], True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _ends_double_cons(w) and w[-1] not in "lsz":
                w = w[:-1]
            elif _measure(w) == 1 and _ends_cvc(w):
                w += "e"

    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # step 2
    for suf, rep in (("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
                     ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
                     ("alli", "al"), ("entli", "ent"), ("eli", "e"),
                     ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
                     ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
                     ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
                     ("iviti", "ive"), ("biliti", "ble")):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 3
    for suf, rep in (("icate", "ic"), ("ative", ""), ("alize", "al"),
                     ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
                     ("ness", "")):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 4
    for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                "ement", "ment", "ent", "ion", "ou", "ism", "ate", "iti",
                "ous", "ive", "ize"):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1:
                if suf == "ion" and (not stem or stem[-1] not in "st"):
                    pass
                else:
                    w = stem
            break

    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _ends_cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# ---------------------------------------------------------------------------
# ROUGE-L (pycocoevalcap formulation)
# ---------------------------------------------------------------------------

def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y else max(cur[j], prev[j + 1]))
        prev = cur
    return prev[-1]


def rouge_l_sentence(cand: Sequence[str],
                     refs: Sequence[Sequence[str]],
                     beta: float = 1.2) -> float:
    """Max-over-references LCS precision/recall, beta-weighted F."""
    if not cand:
        return 0.0
    prec_max = rec_max = 0.0
    for r in refs:
        if not r:
            continue
        lcs = _lcs_len(r, cand)
        prec_max = max(prec_max, lcs / len(cand))
        rec_max = max(rec_max, lcs / len(r))
    denom = rec_max + beta ** 2 * prec_max
    if denom == 0:
        return 0.0
    return (1 + beta ** 2) * prec_max * rec_max / denom


def rouge_l(candidates: List[List[str]],
            references: List[List[List[str]]]) -> float:
    """Corpus ROUGE-L = mean of per-image scores."""
    if not candidates:
        return 0.0
    return sum(rouge_l_sentence(c, r)
               for c, r in zip(candidates, references)) / len(candidates)


# ---------------------------------------------------------------------------
# METEOR (exact + stem [+ synonym] stages; NLTK-convention constants)
# ---------------------------------------------------------------------------

SynonymTable = Dict[str, FrozenSet[str]]


def find_synonym_file() -> Optional[str]:
    """Local synonym-table discovery (the jar-artifact convention of
    utils/spice.py): None when no table is present."""
    candidates = [os.environ.get("METEOR_SYNONYMS")]
    for root in (os.path.join(_REPO_ROOT, "tools_tpu", "meteor"),
                 os.path.expanduser(os.path.join("~", ".cache", "mvptr",
                                                 "meteor"))):
        candidates += [os.path.join(root, "synonyms.json"),
                       os.path.join(root, "synonyms.tsv")]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


def load_synonyms(path: str) -> SynonymTable:
    """Load a synonym table (JSON dict or TSV) and symmetrize it: if either
    word lists the other, both entries contain the pair afterwards, so the
    match stage can do a single directional lookup."""
    raw: Dict[str, List[str]] = {}
    with open(path) as f:
        if path.endswith(".json"):
            raw = json.load(f)
        else:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) == 2 and parts[0]:
                    raw[parts[0]] = parts[1].split()
    table: Dict[str, set] = {}
    for w, syns in raw.items():
        for s in syns:
            if s == w:
                continue
            table.setdefault(w, set()).add(s)
            table.setdefault(s, set()).add(w)
    return {w: frozenset(s) for w, s in table.items()}


def _stage_match(cand_pool: Dict[int, str], ref_pool: Dict[int, str],
                 key) -> List[Tuple[int, int]]:
    """Greedy bijective matching: each candidate token pairs with the first
    unmatched reference token whose key() agrees; pools shrink in place."""
    pairs = []
    for ci in sorted(cand_pool):
        ck = key(cand_pool[ci])
        for ri in sorted(ref_pool):
            if key(ref_pool[ri]) == ck:
                pairs.append((ci, ri))
                del cand_pool[ci], ref_pool[ri]
                break
    return pairs


def _count_chunks(pairs: List[Tuple[int, int]]) -> int:
    """Chunks = runs of matches contiguous and monotone in both strings."""
    chunks = 0
    prev = None
    for c, r in sorted(pairs):
        if prev is None or c != prev[0] + 1 or r != prev[1] + 1:
            chunks += 1
        prev = (c, r)
    return chunks


def _synonym_match(cand_pool: Dict[int, str], ref_pool: Dict[int, str],
                   synonyms: SynonymTable) -> List[Tuple[int, int]]:
    """Greedy bijective synonym stage: each remaining candidate token pairs
    with the first unmatched reference token the (symmetrized) table links
    it to — the WordNet-synset role in the METEOR jar."""
    pairs = []
    for ci in sorted(cand_pool):
        syns = synonyms.get(cand_pool[ci])
        if not syns:
            continue
        for ri in sorted(ref_pool):
            if ref_pool[ri] in syns:
                pairs.append((ci, ri))
                del cand_pool[ci], ref_pool[ri]
                break
    return pairs


def meteor_sentence(cand: Sequence[str], refs: Sequence[Sequence[str]],
                    alpha: float = 0.9, beta: float = 3.0,
                    gamma: float = 0.5,
                    synonyms: Optional[SynonymTable] = None) -> float:
    """Max over references of the single-reference METEOR score."""
    best = 0.0
    for ref in refs:
        if not cand or not ref:
            continue
        cand_pool = dict(enumerate(cand))
        ref_pool = dict(enumerate(ref))
        pairs = _stage_match(cand_pool, ref_pool, key=lambda t: t)
        pairs += _stage_match(cand_pool, ref_pool, key=porter_stem)
        if synonyms:
            pairs += _synonym_match(cand_pool, ref_pool, synonyms)
        m = len(pairs)
        if m == 0:
            continue
        p = m / len(cand)
        r = m / len(ref)
        fmean = p * r / (alpha * p + (1 - alpha) * r)
        penalty = gamma * (_count_chunks(pairs) / m) ** beta
        best = max(best, fmean * (1.0 - penalty))
    return best


def meteor(candidates: List[List[str]],
           references: List[List[List[str]]],
           synonyms: Optional[SynonymTable] = None) -> float:
    """Corpus METEOR = mean of per-image scores. `synonyms` enables the
    synonym stage; pass None to run exact+stem only (callers that want
    auto-discovery resolve the table via find_synonym_file/load_synonyms
    once — see evaluate_captions)."""
    if not candidates:
        return 0.0
    return sum(meteor_sentence(c, r, synonyms=synonyms)
               for c, r in zip(candidates, references)) / len(candidates)
