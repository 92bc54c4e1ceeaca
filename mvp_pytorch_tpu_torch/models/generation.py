"""Autoregressive decoding: greedy, sampling and beam search, the JAX
package's `models/generation.py` (reference `oscar/modeling/
modeling_utils.py:21-678`, CaptionPreTrainedModel.generate and
BeamHypotheses).

The JAX decoders are `lax.scan`s over a fixed-length token buffer; here each
is a Python loop over the positions t = 1 .. max_len - 1 on device tensors.
`t` is a host int, and no step reads a device value back, so the loop queues
its work without a host sync.

Two model contracts:
- recompute (`generate`, `beam_search`): `logits_fn(tokens [N, L], t) ->
  [N, V]`, the logits at position t from the whole buffer (the JAX
  contract returns [N, L, V] and the loop reads position t; the model can
  then apply its head at t alone);
- history-cached (`generate_cached`, `beam_search_cached`): `prefill_fn()
  -> cache` and `step_fn(cache, t, prev [N]) -> (logits [N, V] at t,
  cache)`, the reference's past reuse.

Ties break as in JAX: argmax takes the first maximum, and the beams' top-k
is a stable descending sort (the lower index first, as `lax.top_k` orders
equal values; `torch.topk` promises no order). Sampling draws with
`torch.multinomial` from an explicit `torch.Generator`; its stream is not
JAX's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e9


def apply_repetition_penalty(logits, tokens, t: int, penalty: float):
    """HF semantics: the scores of tokens used at positions < t are divided
    by `penalty` where positive and multiplied where negative. tokens:
    [N, L]."""
    if penalty == 1.0:
        return logits
    n, v = logits.shape
    pos_mask = torch.arange(tokens.shape[1], device=tokens.device)[None] < t
    # invalid positions scatter into a sentinel column that is sliced off
    cols = torch.where(pos_mask, tokens.long(), v)
    used = torch.zeros(n, v + 1, dtype=torch.bool,
                       device=logits.device).scatter_(1, cols, True)[:, :v]
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(used, penalized, logits)


def top_k_top_p_filtering(logits, top_k: int = 0, top_p: float = 1.0):
    """Logits outside the top k, or outside the nucleus of mass `top_p`, set
    to NEG_INF (reference modeling_utils.py:600-633: the first token whose
    cumulative probability passes top_p is kept too)."""
    v = logits.shape[-1]
    if top_k > 0:
        kth = torch.topk(logits, min(top_k, v), dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff = ((cum <= top_p).sum(dim=-1, keepdim=True) + 1).clamp(max=v)
        threshold = sorted_logits.gather(-1, cutoff - 1)
        logits = torch.where(logits < threshold, NEG_INF, logits)
    return logits


class GenerateOutput(NamedTuple):
    sequences: torch.Tensor   # [N, max_len] token ids (BOS at 0)
    logprobs: torch.Tensor    # [N, max_len] logprob of the token stored at
    #                           each position (0 at BOS, after EOS and at a
    #                           forced-EOS last slot, which was never drawn)
    lengths: torch.Tensor     # [N] EOS position + 1 (BOS and EOS counted)
    finished: torch.Tensor    # [N] bool: emitted EOS (False: the last-slot
    #                           EOS was forced)


def _top_k(x, k: int):
    """The k largest values along the last axis and their indices, equal
    values in index order (`lax.top_k`'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _block_eos(logits, t: int, min_len: int, eos_token_id: int):
    """EOS at NEG_INF before position `min_len`."""
    if t >= min_len:
        return logits
    return logits.index_fill(-1, torch.full((1,), eos_token_id,
                                            device=logits.device), NEG_INF)


def _next_token(logits, tokens, t, finished, *, do_sample, temperature,
                top_k, top_p, repetition_penalty, min_len, eos_token_id,
                pad_token_id, generator):
    """The processed fp32 logits at t and the token they choose (PAD in a
    finished row)."""
    logits = apply_repetition_penalty(logits.float(), tokens, t,
                                      repetition_penalty)
    logits = _block_eos(logits, t, min_len, eos_token_id)
    if do_sample:
        logits = logits / max(temperature, 1e-6)
        logits = top_k_top_p_filtering(logits, top_k, top_p)
        nxt = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                generator=generator)[:, 0]
    else:
        nxt = logits.argmax(dim=-1)
    return logits, torch.where(finished, pad_token_id, nxt)


def _commit(tokens, logits, nxt, t, finished, eos_token_id, logps, fins):
    """Write `nxt` at t and record its logprob (0 in a finished row)."""
    logp = torch.log_softmax(logits, dim=-1).gather(1, nxt[:, None])[:, 0]
    logps.append(torch.where(finished, 0.0, logp))
    tokens[:, t] = nxt
    finished = finished | (nxt == eos_token_id)
    fins.append(finished)
    return finished


def _finish(tokens, finished, logps, fins, eos_token_id) -> GenerateOutput:
    """A forced EOS in the last slot of a row that never emitted one, with
    logprob 0 (reference modeling_utils.py:359-361), and the lengths."""
    n, max_len = tokens.shape
    tokens[:, -1] = torch.where(finished, tokens[:, -1], eos_token_id)
    logprobs = torch.cat([torch.zeros(n, 1, device=tokens.device),
                          torch.stack(logps, dim=1)], dim=1)
    logprobs[:, -1] = torch.where(finished, logprobs[:, -1], 0.0)
    alive = (~torch.stack(fins, dim=1)).sum(dim=1)
    lengths = (alive + 2).clamp(max=max_len)
    return GenerateOutput(tokens, logprobs, lengths, finished)


def generate(logits_fn: Callable, bos_token_id: int, eos_token_id: int,
             pad_token_id: int, mask_token_id: int, batch_size: int,
             max_len: int, *, do_sample: bool = False,
             temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
             repetition_penalty: float = 1.0, min_len: int = 0,
             generator: Optional[torch.Generator] = None,
             forced_prefix: Optional[torch.Tensor] = None,
             device="cuda") -> GenerateOutput:
    """Greedy or sampling decode over the full prefix: the buffer holds BOS
    at 0 and [MASK] after it, and step t writes position t. A finished row
    emits PAD and adds no logprob. `forced_prefix` [N, P] writes its
    entries >= 0 at positions t < P in place of the chosen token (the
    logprob is the written token's)."""
    n = batch_size
    tokens = torch.full((n, max_len), mask_token_id, dtype=torch.long,
                        device=device)
    tokens[:, 0] = bos_token_id
    finished = torch.zeros(n, dtype=torch.bool, device=device)
    logps, fins = [], []
    for t in range(1, max_len):
        logits, nxt = _next_token(
            logits_fn(tokens, t), tokens, t, finished, do_sample=do_sample,
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty, min_len=min_len,
            eos_token_id=eos_token_id, pad_token_id=pad_token_id,
            generator=generator)
        if forced_prefix is not None and t < forced_prefix.shape[1]:
            forced = forced_prefix[:, t].to(nxt.dtype)
            nxt = torch.where(forced >= 0, forced, nxt)
        finished = _commit(tokens, logits, nxt, t, finished, eos_token_id,
                           logps, fins)
    return _finish(tokens, finished, logps, fins, eos_token_id)


def generate_cached(prefill_fn: Callable, step_fn: Callable,
                    bos_token_id: int, eos_token_id: int, pad_token_id: int,
                    batch_size: int, max_len: int, *, do_sample: bool = False,
                    temperature: float = 1.0, top_k: int = 0,
                    top_p: float = 1.0, repetition_penalty: float = 1.0,
                    min_len: int = 0,
                    generator: Optional[torch.Generator] = None,
                    device="cuda") -> GenerateOutput:
    """History-cached greedy or sampling decode: each step runs the model
    over the committed token and the next [MASK] against the cache
    (`step_fn(cache, t, prev)`) instead of the whole prefix. The buffer
    after BOS starts as PAD. Output contract of `generate`."""
    n = batch_size
    tokens = torch.full((n, max_len), pad_token_id, dtype=torch.long,
                        device=device)
    tokens[:, 0] = bos_token_id
    finished = torch.zeros(n, dtype=torch.bool, device=device)
    cache = prefill_fn()
    prev = tokens[:, 0].clone()
    logps, fins = [], []
    for t in range(1, max_len):
        logits, cache = step_fn(cache, t, prev)
        logits, prev = _next_token(
            logits, tokens, t, finished, do_sample=do_sample,
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty, min_len=min_len,
            eos_token_id=eos_token_id, pad_token_id=pad_token_id,
            generator=generator)
        finished = _commit(tokens, logits, prev, t, finished, eos_token_id,
                           logps, fins)
    return _finish(tokens, finished, logps, fins, eos_token_id)


class _Beams:
    """The alive and finished beams' bookkeeping shared by both beam
    searches: [B, K, L] token buffers, alive cumulative logprobs, finished
    hypotheses and their length-penalised scores."""

    def __init__(self, b, k, max_len, fill, bos_token_id, pad_token_id,
                 length_penalty, device):
        self.b, self.k, self.max_len = b, k, max_len
        self.length_penalty = length_penalty
        self.tokens = torch.full((b, k, max_len), fill, dtype=torch.long,
                                 device=device)
        self.tokens[:, :, 0] = bos_token_id
        self.alive_logp = torch.full((b, k), NEG_INF, device=device)
        self.alive_logp[:, 0] = 0.0
        self.fin_scores = torch.full((b, k), NEG_INF, device=device)
        self.fin_tokens = torch.full((b, k, max_len), pad_token_id,
                                     dtype=torch.long, device=device)

    def _gather(self, buf, idx):
        return buf.gather(1, idx[..., None].expand(-1, -1, self.max_len))

    def step(self, logp, t: int, eos_token_id: int, write):
        """One step over logp [B, K, V]: the top 2K continuations; an EOS
        candidate becomes a hypothesis only while fewer than K non-EOS
        candidates rank before it (reference :510-519), scored cum / t **
        length_penalty; the best K non-EOS candidates stay alive. `write`
        maps the chosen token ids to what the buffer stores. Returns the
        surviving beams' source beam [B, K]."""
        b, k, v = logp.shape
        cand = (self.alive_logp[..., None] + logp).reshape(b, k * v)
        top_lp, top_idx = _top_k(cand, 2 * k)
        beam_idx = torch.div(top_idx, v, rounding_mode="floor")
        tok_idx = top_idx % v
        cand_tokens = self._gather(self.tokens, beam_idx)
        cand_tokens[:, :, t] = write(tok_idx)
        is_eos = tok_idx == eos_token_id
        not_eos = (~is_eos).to(torch.int32)
        valid_eos = is_eos & (torch.cumsum(not_eos, dim=1) - not_eos < k)
        # t ** alpha in fp32, as the JAX loop takes it of its fp32 step
        div = float(np.float32(t) ** np.float32(self.length_penalty))
        new_fin = torch.where(valid_eos, top_lp / div, NEG_INF)
        fin_top, fin_sel = _top_k(torch.cat([self.fin_scores, new_fin], 1), k)
        self.fin_tokens = self._gather(
            torch.cat([self.fin_tokens, cand_tokens], 1), fin_sel)
        self.fin_scores = fin_top
        alive_top, alive_sel = _top_k(torch.where(is_eos, NEG_INF, top_lp), k)
        self.tokens = self._gather(cand_tokens, alive_sel)
        self.alive_logp = alive_top
        return beam_idx.gather(1, alive_sel)

    def finalize(self, final_lp, eos_token_id: int, sanitize=None):
        """The last step: every alive beam ends as its prefix + a forced EOS,
        scored with its best word's logprob over (max_len - 1) **
        length_penalty (reference :510-513, :593-595); `sanitize` maps both
        buffers before the best hypothesis is picked. Returns (sequences
        [B, max_len], scores [B])."""
        t_fin = self.max_len - 1
        final_cum = self.alive_logp + final_lp.max(dim=-1).values
        final_scores = final_cum / (float(t_fin) ** self.length_penalty)
        final_tokens = self.tokens.clone()
        final_tokens[:, :, t_fin] = eos_token_id
        fin_tokens = self.fin_tokens
        if sanitize is not None:
            final_tokens, fin_tokens = sanitize(final_tokens), sanitize(
                fin_tokens)
        best, sel = _top_k(torch.cat([self.fin_scores, final_scores], 1), 1)
        seqs = self._gather(torch.cat([fin_tokens, final_tokens], 1), sel)
        return seqs[:, 0], best[:, 0]


def _beam_logp(logits, flat_tokens, t, b, k, repetition_penalty, min_len,
               eos_token_id):
    logits = apply_repetition_penalty(logits.float(), flat_tokens, t,
                                      repetition_penalty)
    logits = _block_eos(logits, t, min_len, eos_token_id)
    return torch.log_softmax(logits, dim=-1).reshape(b, k, -1)


def beam_search(logits_fn: Callable, bos_token_id: int, eos_token_id: int,
                pad_token_id: int, mask_token_id: int, batch_size: int,
                max_len: int, num_beams: int, *,
                length_penalty: float = 1.0,
                repetition_penalty: float = 1.0, min_len: int = 0,
                device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search over the full prefix; returns (sequences [B, max_len],
    scores [B]). `logits_fn` takes the flattened [B K, L] buffers. A
    hypothesis scores logprob_sum / prefix_len ** length_penalty, the prefix
    counting the tokens before its EOS, BOS included (reference
    BeamHypotheses.add :653-665). Alive beams keep [MASK] at their future
    positions; an emitted [MASK] is stored as PAD, and [MASK] filler is
    PAD in both buffers at the end."""
    b, k = batch_size, num_beams
    beams = _Beams(b, k, max_len, mask_token_id, bos_token_id, pad_token_id,
                   length_penalty, device)
    future_of = torch.arange(max_len, device=device)[None, None]

    def step_logp(t):
        flat = beams.tokens.reshape(b * k, max_len)
        return _beam_logp(logits_fn(flat, t), flat, t, b, k,
                          repetition_penalty, min_len, eos_token_id)

    def clean(ids):
        return torch.where(ids == mask_token_id, pad_token_id, ids)

    for t in range(1, max_len - 1):
        beams.step(step_logp(t), t, eos_token_id, clean)
        beams.tokens = torch.where(future_of > t, mask_token_id, beams.tokens)
    return beams.finalize(step_logp(max_len - 1), eos_token_id, clean)


def beam_search_cached(prefill_fn: Callable, step_fn: Callable,
                       bos_token_id: int, eos_token_id: int,
                       pad_token_id: int, batch_size: int, max_len: int,
                       num_beams: int, *, length_penalty: float = 1.0,
                       repetition_penalty: float = 1.0, min_len: int = 0,
                       mask_token_id: Optional[int] = None,
                       device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """History-cached beam search. `prefill_fn` returns a cache tensor that
    carries the B K beam rows on axis 1 (the context repeated per beam);
    after every step its rows follow the surviving beams (`index_select` on
    axis 1). The buffers start as PAD; with
    `mask_token_id` an emitted [MASK] is stored as PAD, as the recompute
    path stores it. Output contract of `beam_search`."""
    b, k = batch_size, num_beams
    beams = _Beams(b, k, max_len, pad_token_id, bos_token_id, pad_token_id,
                   length_penalty, device)
    cache = prefill_fn()
    rows = torch.arange(b, device=device)[:, None] * k

    def write(ids):
        if mask_token_id is None:
            return ids
        return torch.where(ids == mask_token_id, pad_token_id, ids)

    def step_logp(cache, t):
        flat = beams.tokens.reshape(b * k, max_len)
        logits, cache = step_fn(cache, t, flat[:, t - 1])
        return _beam_logp(logits, flat, t, b, k, repetition_penalty,
                          min_len, eos_token_id), cache

    for t in range(1, max_len - 1):
        logp, cache = step_logp(cache, t)
        src = (rows + beams.step(logp, t, eos_token_id, write)).reshape(-1)
        cache = cache.index_select(1, src)
    return beams.finalize(step_logp(cache, max_len - 1)[0], eos_token_id)
