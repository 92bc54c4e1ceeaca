"""Constrained beam search over finite-state machines: the JAX package's
`models/cbs.py` (reference `oscar/utils/cbs.py`: ConstrainedBeamSearch
:30-365, FiniteStateMachineBuilder :444-857, select_best_beam_with_constraints
:366-434).

`build_fsm`, `ConstraintFilter`, `constraints_from_features` and
`select_best_beam_with_constraints` are host numpy, copied. The search runs
on the device: one beam set per FSM state, every (state, beam) slot advancing
in lockstep as a masked dense [B, S, K] score tensor, the tokens, log-probs
and finished flags device tensors, and no host sync inside the loop.

The model contract is the port's recompute one (`models/generation.py`):
`logits_fn(tokens [N, L], t) -> [N, V]`, N = B S K flattened buffers in
(batch, state, beam) order.

The top-k of each destination state orders equal values by the lower flat
index, as `lax.top_k` does (`torch.topk` promises no order among ties). A
dead slot's score is a multiple of NEG_INF: in fp32 -1e9 plus a log-prob
rounds to -1e9, so dead candidates tie by the thousands.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

NEG_INF = -1e9


def build_fsm(constraints: Sequence[Sequence[int]], vocab_size: int,
              max_states: int) -> Tuple[np.ndarray, np.ndarray]:
    """Dense FSM for up to C constraints (token-id sequences).

    Returns (fsm [S, S, V] bool, n_constraints_satisfied [S]).
    States 0..2^C-1 are bitmask main states; chain states for multi-token
    constraints are appended. fsm[s, s', v] = emitting v in state s moves to
    s'. Unconstrained tokens self-loop.
    """
    c = len(constraints)
    n_main = 1 << c
    total = n_main
    chain_index = {}
    for s in range(n_main):
        for i, words in enumerate(constraints):
            if (s >> i) & 1:
                continue
            for step in range(1, len(words)):
                chain_index[(s, i, step)] = total
                total += 1
    if total > max_states:
        raise ValueError(f"FSM needs {total} states > max_states {max_states}")

    fsm = np.zeros((max_states, max_states, vocab_size), bool)
    nsat = np.zeros(max_states, np.int32)
    for s in range(n_main):
        nsat[s] = bin(s).count("1")

    def add_self_loops(s: int, except_tokens: set):
        stay = np.ones(vocab_size, bool)
        for t in except_tokens:
            stay[t] = False
        fsm[s, s] |= stay

    for s in range(n_main):
        starts = set()
        for i, words in enumerate(constraints):
            if (s >> i) & 1:
                continue
            w0 = words[0]
            starts.add(w0)
            target = (s | (1 << i)) if len(words) == 1 else chain_index[(s, i, 1)]
            fsm[s, target, w0] = True
        add_self_loops(s, starts)

    for (s, i, step), cs in chain_index.items():
        words = constraints[i]
        nsat[cs] = bin(s).count("1")
        nxt_tok = words[step]
        if step + 1 < len(words):
            nxt_state = chain_index[(s, i, step + 1)]
        else:
            nxt_state = s | (1 << i)
        fsm[cs, nxt_state, nxt_tok] = True
        # failing the chain: KMP failure arcs. After matching words[:step]
        # and seeing t != words[step], the longest suffix of
        # words[:step] + [t] that is still a prefix of words stays matched
        # ([a, a, b] on a, a, a, b keeps depth 2 at the third `a`;
        # [new, york] on "new new york" re-enters at depth 1). The
        # reference resets sub-states straight to the source
        # (cbs.py:850-854) and loses these matches; the departure is
        # deliberate, the search itself is the reference's.
        handled = {nxt_tok}
        for t in set(words):
            if t in handled:
                continue
            buf = list(words[:step]) + [t]
            k = 0
            for kk in range(min(step, len(words) - 1), 0, -1):
                if list(buf[-kk:]) == list(words[:kk]):
                    k = kk
                    break
            if k > 0:
                fsm[cs, chain_index[(s, i, k)], t] = True
                handled.add(t)
        for j, words_j in enumerate(constraints):
            if (s >> j) & 1:
                continue
            w0 = words_j[0]
            if w0 in handled:
                continue
            target = (s | (1 << j)) if len(words_j) == 1 \
                else chain_index[(s, j, 1)]
            fsm[cs, target, w0] = True
            handled.add(w0)
        back = np.ones(vocab_size, bool)
        for t in handled:
            back[t] = False
        fsm[cs, s] |= back
    return fsm, nsat


def top_k_lower_index(x: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values of each row of x [B, M] (fp32) and their
    indices, in `lax.top_k`'s order: descending, equal values by the lower
    index. One `torch.topk` over int64 keys: the value's bits made
    order-preserving in the high word (+0.0 for -0.0), M - 1 - index in the
    low word. No host sync."""
    m = x.shape[-1]
    bits = (x + 0.0).view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    key = (ordered.to(torch.int64) << 32) | (
        m - 1 - torch.arange(m, device=x.device))
    idx = torch.topk(key, k, dim=-1, sorted=True).indices
    return x.gather(-1, idx), idx


def constrained_beam_search(logits_fn: Callable, fsm, bos_token_id: int,
                            eos_token_id: int, pad_token_id: int,
                            mask_token_id: int, max_len: int,
                            num_beams: int, *, device="cuda"
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fsm: [B, S, S, V] bool (a tensor or a numpy array). Returns
    (sequences [B, S, K, L], logprobs [B, S, K]): each FSM state's beams, as
    the reference keeps them (:300-365). Buffers start as BOS then [MASK];
    only state 0's beam 0 is live at first. A finished beam's one candidate
    is its own state emitting PAD at no cost, so an early EOS neither
    accumulates score nor changes state."""
    fsm = torch.as_tensor(fsm, device=device)
    b, s, _, v = fsm.shape
    k = num_beams
    tokens = torch.full((b, s, k, max_len), mask_token_id, dtype=torch.long,
                        device=device)
    tokens[..., 0] = bos_token_id
    logp = torch.full((b, s, k), NEG_INF, device=device)
    logp[:, 0, 0] = 0.0
    finished = torch.zeros(b, s, k, dtype=torch.bool, device=device)
    trans_bias = torch.where(fsm, 0.0, NEG_INF)       # [B, S_src, S_dst, V]
    pad_vec = torch.arange(v, device=device) == pad_token_id
    states = torch.arange(s, device=device)
    for t in range(1, max_len):
        flat = tokens.reshape(b * s * k, max_len)
        lp_tok = torch.log_softmax(logits_fn(flat, t).float(), dim=-1)
        lp_tok = lp_tok.reshape(b, s, k, v)
        base = logp[..., None]                        # [B, src, K, 1]
        fin_e = finished[..., None]
        top_lp, top_idx = [], []
        # one destination state at a time: the whole [B, src, dst, K, V]
        # product is S times larger
        for dst in range(s):
            alive = base + lp_tok + trans_bias[:, :, dst, None, :]
            is_self = (states == dst)[None, :, None, None]
            fin_cand = base + torch.where(pad_vec & is_self, 0.0, NEG_INF)
            cand = torch.where(fin_e, fin_cand, alive)   # [B, src, K, V]
            vals, idx = top_k_lower_index(cand.reshape(b, s * k * v), k)
            top_lp.append(vals)
            top_idx.append(idx)
        top_lp = torch.stack(top_lp, 1)                   # [B, dst, K]
        top_idx = torch.stack(top_idx, 1)
        src = torch.div(top_idx, k * v, rounding_mode="floor")
        beam = torch.div(top_idx, v, rounding_mode="floor") % k
        tok = top_idx % v
        src_beam = (src * k + beam).reshape(b, s * k)     # [B, S K]
        tokens = tokens.reshape(b, s * k, max_len).gather(
            1, src_beam[..., None].expand(-1, -1, max_len))
        tokens = tokens.reshape(b, s, k, max_len)
        tokens[..., t] = tok
        fin_src = finished.reshape(b, s * k).gather(1, src_beam)
        finished = fin_src.reshape(b, s, k) | (tok == eos_token_id)
        logp = top_lp
    return tokens, logp


class ConstraintFilter:
    """Filter candidate constraint words (reference ConstraintFilter:
    blacklist + 'a'-prefixed wordforms expansion). Keeps non-blacklisted
    object classes and produces token-sequence constraints via a tokenizer."""

    BLACKLIST = {"auto part", "bathroom accessory", "bicycle wheel",
                 "boy", "building", "clothing", "door handle",
                 "fashion accessory", "footwear", "girl", "hiking equipment",
                 "human arm", "human beard", "human body", "human ear",
                 "human eye", "human face", "human foot", "human hair",
                 "human hand", "human head", "human leg", "human mouth",
                 "human nose", "land vehicle", "mammal", "man",
                 "person", "personal care", "plant", "plumbing fixture",
                 "seat belt", "skull", "sports equipment", "tire", "tree",
                 "vehicle registration plate", "wheel", "woman",
                 "__background__"}

    # reference cbs.py:517-524: class-name normalisations applied after the
    # confidence top-k
    REPLACEMENTS = {
        "band-aid": "bandaid",
        "wood-burning stove": "wood burning stove",
        "kitchen & dining room table": "table",
        "salt and pepper shakers": "salt and pepper",
        "power plugs and sockets": "power plugs",
        "luggage and bags": "luggage",
    }

    def __init__(self, tokenizer, max_words_per_constraint: int = 3):
        self.tokenizer = tokenizer
        self.max_words = max_words_per_constraint

    def filter_names(self, object_classes: Sequence[str],
                     max_constraints: int = 3,
                     scores: Optional[Sequence[float]] = None) -> List[str]:
        """Reference __call__ semantics without the Open Images hierarchy
        NMS (its hierarchy JSON is an external file that is not here): drop
        zero-confidence padding boxes and blacklisted classes (:547-556),
        keep the top-k by detection confidence (:565-567; input order when
        no scores are given), then apply REPLACEMENTS (:569-570)."""
        names = [c.lower().strip() for c in object_classes]
        if scores is None:
            kept = [(n, 0.0) for n in names if n not in self.BLACKLIST]
        else:
            kept = [(n, float(s)) for n, s in zip(names, scores)
                    if s > 0 and n not in self.BLACKLIST]
            kept.sort(key=lambda t: -t[1])
        kept = kept[:max_constraints]
        return [self.REPLACEMENTS.get(n, n) for n, _ in kept]

    def __call__(self, object_classes: Sequence[str],
                 max_constraints: int = 3,
                 scores: Optional[Sequence[float]] = None) -> List[List[int]]:
        out = []
        for name in self.filter_names(object_classes,
                                      max_constraints=len(object_classes),
                                      scores=scores):
            ids = self.tokenizer.convert_tokens_to_ids(
                self.tokenizer.tokenize(name))
            # a too-long constraint is truncated to max_words tokens, not
            # dropped (reference FiniteStateMachineBuilder._add_nth_order,
            # cbs.py:780-781)
            ids = ids[: self.max_words]
            if ids and ids not in out:
                out.append(ids)
            if len(out) >= max_constraints:
                break
        return out


def constraints_from_features(feature_store, image_id, tokenizer,
                              cfilter: ConstraintFilter,
                              max_constraints: int = 3) -> List[List[int]]:
    """Candidate constraints for an image from its detected tags (the
    reference's ConstraintBoxesReader role: the detections live in the
    FeatureStore)."""
    _, tags = feature_store.get(image_id)
    return cfilter(tags, max_constraints=max_constraints)


def select_best_beam_with_constraints(sequences: np.ndarray,
                                      logprobs: np.ndarray,
                                      nsat: np.ndarray,
                                      min_constraints: int,
                                      eos_token_ids: Sequence[int] = (),
                                      pad_token_id: Optional[int] = None
                                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Pick the best beam among states with >= min_constraints satisfied
    (reference :366-434). sequences: [B, S, K, L]; logprobs: [B, S, K];
    nsat: [S].

    - Only beam 0 of each state competes (`beams[i, valid_states, 0, :]`,
      :420): beams are likelihood-sorted, slot 0 is each state's best.
    - Scores are length-normalised: cum_logprob / (non-EOS token count + 1)
      (:421-426). The buffer here carries BOS at slot 0 and PAD after a
      finished beam, so the count skips slot 0 and excludes both
      eos_token_ids and pad_token_id.

    A never-populated state (the finite NEG_INF sentinel) never wins, and an
    item with no live constraint-satisfying beam falls back to its best
    unconstrained beam (the reference would argmax over garbage there)."""
    b = sequences.shape[0]
    beams0 = sequences[:, :, 0, :]                       # [B, S, L]
    lp0 = logprobs[:, :, 0]                              # [B, S]
    live = lp0 > NEG_INF / 2
    body = beams0[:, :, 1:]                              # skip BOS slot
    counted = np.ones_like(body, dtype=bool)
    for eid in eos_token_ids:
        counted &= body != eid
    if pad_token_id is not None:
        counted &= body != pad_token_id
    length = counted.sum(-1) + 1                         # [B, S]
    norm = lp0 / length
    ok_state = (nsat >= min_constraints)[None, :]
    cons = np.where(live & ok_state, norm, -np.inf)
    unc = np.where(live, norm, -np.inf)
    # the fallback is per item: only items with no live satisfying beam
    # revert to their best unconstrained beam
    has_cons = np.isfinite(cons.max(axis=1))
    masked = np.where(has_cons[:, None], cons, unc)
    best = masked.argmax(axis=1)
    bi = np.arange(b)
    return beams0[bi, best], masked[bi, best]
