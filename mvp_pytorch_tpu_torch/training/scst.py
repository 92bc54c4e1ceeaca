"""Self-critical sequence training (SCST) for captioning: the JAX package's
`training/scst.py` (reference `oscar/utils/caption_evaluate.py:115-196`,
ScstRewardCriterion).

The reward is the CIDEr-D of each sampled caption, the baseline the greedy
caption's (or the other samples' mean), and the loss -logp * (reward -
baseline) over the sampled tokens. Rewards are host work on strings;
`scst_loss` is the device side.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..utils.cider import CiderScorer


def _wrap_sentence(tokens: Sequence[str]) -> List[str]:
    """Reference _wrap_sentence (caption_evaluate.py:188-196) at token
    granularity: drop a trailing '.' and append '<eos>'. The wrap changes
    CIDEr-D (the shared terminal token adds matching n-grams)."""
    toks = list(tokens)
    if toks and toks[-1] == ".":
        toks = toks[:-1]
    elif toks and toks[-1].endswith("."):
        toks = toks[:-1] + [toks[-1][:-1]]
    toks.append("<eos>")
    return toks


class ScstReward:
    def __init__(self, n: int = 4, sigma: float = 6.0,
                 baseline_type: str = "greedy"):
        if baseline_type not in ("greedy", "sample"):
            raise ValueError(f"baseline_type {baseline_type!r}: 'greedy' or "
                             f"'sample'")
        self.scorer = CiderScorer(n=n, sigma=sigma, cider_d=True)
        self.baseline_type = baseline_type

    def rewards(self, sampled: List[List[str]], greedy: List[List[str]],
                references: List[List[List[str]]],
                seq_per_img: int = 1) -> np.ndarray:
        """The advantage of each sampled caption (reward - baseline).

        The 'sample' baseline is the per-image leave-one-out mean over that
        image's own samples (caption_evaluate.py:143-144)."""
        sampled = [_wrap_sentence(c) for c in sampled]
        greedy = [_wrap_sentence(c) for c in greedy]
        references = [[_wrap_sentence(r) for r in refs]
                      for refs in references]
        if self.baseline_type == "greedy":
            # one scorer call over samples and greedy captions, so that both
            # sit on the same TF-IDF corpus (the reference concatenates
            # gen_res before scoring, caption_evaluate.py:130-140)
            greedy_refs = [references[i * seq_per_img]
                           for i in range(len(greedy))]
            _, scores = self.scorer.compute(
                list(sampled) + list(greedy),
                list(references) + greedy_refs)
            r_sample = scores[: len(sampled)]
            r_base = np.repeat(scores[len(sampled):], seq_per_img)
        else:
            _, r_sample = self.scorer.compute(sampled, references)
            sc = r_sample.reshape(-1, seq_per_img)
            if seq_per_img > 1:
                base = (sc.sum(1, keepdims=True) - sc) / (seq_per_img - 1)
            else:
                base = np.zeros_like(sc)
            r_base = base.reshape(-1)
        return r_sample - r_base


def scst_loss(sample_logprobs: torch.Tensor, sample_mask: torch.Tensor,
              advantages) -> torch.Tensor:
    """The mean over sequences of -(r - b) * sum logp (reference :153-155).

    sample_logprobs / sample_mask: [N, L]; advantages: [N] (host rewards).
    Normalised by sequences, not tokens, as the reference: a token-count
    denominator would couple the learning rate to caption lengths."""
    adv = torch.as_tensor(advantages, dtype=torch.float32,
                          device=sample_logprobs.device)
    token_lp = (sample_logprobs * sample_mask).sum(dim=1)
    return -(adv * token_lp).mean()


def sample_mask(lengths: torch.Tensor, finished: torch.Tensor,
                max_len: int) -> torch.Tensor:
    """[N, max_len] fp32 mask of the sampled actions of a `GenerateOutput`:
    positions 1 .. length - 1, without the last slot of a row that never
    finished (a forced EOS, never drawn). Built from the lengths, not from
    `logprobs != 0`: a certain token's fp32 log-prob is exactly 0."""
    steps = torch.arange(max_len, device=lengths.device)[None, :]
    mask = (steps >= 1) & (steps < lengths[:, None])
    mask &= ~((steps == max_len - 1) & ~finished[:, None])
    return mask.float()
