"""The port's decoders (`models/generation.py`) against the JAX package's, on
toy bigram and trigram tables, on the CPU.

The tables are `tests/test_generation_parity.py`'s (greedy: EOS
suppressed, so the forced-EOS last slot is exercised; beam: a reliable road
to EOS; the finalize cases of `test_beam_finalize_parity`). The JAX
decoders scan the table as their model (`logits_fn` reads position t-1 of
the buffer); the port's take the same table through their own contracts.
The cached decoders' cache holds each row's tokens, and the trigram term
reads it, so a beam whose cache row did not follow it would score wrong.

- `generate` / `generate_cached` (repetition penalty 1.0 and 1.4,
  `min_len`, `forced_prefix`): sequences, lengths and `finished` equal,
  logprobs within 1e-5;
- `beam_search` / `beam_search_cached` (each finalize case, repetition
  penalty, `min_len`): sequences equal, scores within 1e-5;
- `apply_repetition_penalty` and `top_k_top_p_filtering` equal to JAX's on
  the same logits; sampling with `top_k` 1 equal to greedy, repeatable from
  a generator seed, and drawing only inside the filtered set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.models import generation as jgen
from mvp_pytorch_tpu_torch.models import generation as pgen

B, V, L = 3, 12, 9
BOS, EOS, PAD, MASK = 0, 1, 2, 3
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


def tables(case="greedy"):
    """(bigram table W, trigram table W3) for a case."""
    rs = np.random.RandomState(1)
    w = rs.randn(V, V).astype(np.float32) * 1.5
    w[:, EOS] -= 2.0
    w[:, BOS] -= 9.0
    w[:, MASK] -= 9.0
    if case == "beam":
        w[8, 9] += 5.0
        w[9, EOS] += 8.0
    elif case == "never_finished":
        w[:, EOS] -= 50.0
    elif case == "early_eos":
        w[8, 9] += 5.0
        w[9, EOS] += 3.0
    elif case == "mixed":
        w[4, EOS] += 6.0
        w[8, 9] += 5.0
        w[9, EOS] += 8.0
    w3 = (np.random.RandomState(2).randn(V, V) * 0.7).astype(np.float32)
    return w, w3


# ---------------------------------------------------------------------------
# the model contracts of both packages over the same tables
# ---------------------------------------------------------------------------

def jax_logits_fn(w, w3=None):
    """[N, L] -> [N, L, V]: position i reads token i - 1 (and i - 2)."""
    jw = jnp.asarray(w)

    def f(tokens):
        by = jw[tokens]
        out = jnp.concatenate([jnp.zeros_like(by[:, :1]), by[:, :-1]], 1)
        if w3 is not None:
            by3 = jnp.asarray(w3)[tokens]
            out = out + jnp.concatenate(
                [jnp.zeros_like(by3[:, :2]), by3[:, :-2]], 1)
        return out
    return f


def port_logits_fn(w, w3=None):
    """(tokens [N, L], t) -> [N, V]."""
    tw = torch.from_numpy(w)
    tw3 = None if w3 is None else torch.from_numpy(w3)

    def f(tokens, t):
        out = tw[tokens[:, t - 1]]
        if tw3 is not None and t >= 2:
            out = out + tw3[tokens[:, t - 2]]
        return out
    return f


def jax_cached(w, w3, n):
    """prefill / step over a [1, N, L] cache of each row's tokens."""
    jw, jw3 = jnp.asarray(w), jnp.asarray(w3)

    def prefill():
        return jnp.zeros((1, n, L), jnp.int32).at[:, :, 0].set(BOS)

    def step(cache, t, prev):
        cache = cache.at[0, :, t - 1].set(prev)
        out = jw[prev] + jnp.where(t >= 2, jw3[cache[0, :, t - 2]], 0.0)
        return out, cache
    return prefill, step


def port_cached(w, w3, n):
    tw, tw3 = torch.from_numpy(w), torch.from_numpy(w3)

    def prefill():
        cache = torch.zeros(1, n, L, dtype=torch.long)
        cache[:, :, 0] = BOS
        return cache

    def step(cache, t, prev):
        cache[0, :, t - 1] = prev
        out = tw[prev]
        if t >= 2:
            out = out + tw3[cache[0, :, t - 2]]
        return out, cache
    return prefill, step


def same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def near(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# greedy
# ---------------------------------------------------------------------------

GREEDY_CASES = {"rep1": {}, "rep1.4": dict(repetition_penalty=1.4),
                "min_len": dict(min_len=5), "trigram": dict(trigram=True)}


def check_output(got, want):
    same(got.sequences, want.sequences)
    near(got.logprobs, want.logprobs)
    same(got.lengths, want.lengths)
    same(got.finished, want.finished)


@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_generate_matches_jax(case):
    kw = dict(GREEDY_CASES[case])
    w, w3 = tables("mixed" if case == "min_len" else "greedy")
    w3 = w3 if kw.pop("trigram", False) else None
    want = jgen.generate(jax_logits_fn(w, w3), BOS, EOS, PAD, MASK, B, L,
                         **kw)
    got = pgen.generate(port_logits_fn(w, w3), BOS, EOS, PAD, MASK, B, L,
                        device="cpu", **kw)
    check_output(got, want)
    assert got.sequences.dtype == torch.long


def test_generate_forced_prefix_matches_jax():
    """Entries >= 0 of the prefix are written in place of the choice (and
    their logprob taken); -1 leaves the choice."""
    w, _ = tables("mixed")
    prefix = np.array([[-1, 5, 4], [-1, 4, -1], [-1, -1, 6]], np.int32)
    want = jgen.generate(jax_logits_fn(w), BOS, EOS, PAD, MASK, B, L,
                         forced_prefix=jnp.asarray(prefix))
    got = pgen.generate(port_logits_fn(w), BOS, EOS, PAD, MASK, B, L,
                        forced_prefix=torch.from_numpy(prefix), device="cpu")
    check_output(got, want)
    assert got.sequences[0, 1] == 5 and got.sequences[1, 1] == 4


@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_generate_cached_matches_jax(case):
    kw = dict(GREEDY_CASES[case])
    kw.pop("trigram", None)
    w, w3 = tables("mixed" if case == "min_len" else "greedy")
    want = jgen.generate_cached(*jax_cached(w, w3, B), BOS, EOS, PAD, B, L,
                                **kw)
    got = pgen.generate_cached(*port_cached(w, w3, B), BOS, EOS, PAD, B, L,
                               device="cpu", **kw)
    check_output(got, want)
    # the port's recompute decoder over the same trigram model agrees
    full = pgen.generate(port_logits_fn(w, w3), BOS, EOS, PAD, MASK, B, L,
                         device="cpu", **kw)
    same(got.sequences, full.sequences.numpy())


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

BEAM_CASES = {
    "beam": ("beam", 1.0, {}),
    "never_finished": ("never_finished", 1.0, {}),
    "early_eos_lp0.2": ("early_eos", 0.2, {}),
    "early_eos_lp3": ("early_eos", 3.0, {}),
    "mixed_lp1": ("mixed", 1.0, {}),
    "mixed_lp2": ("mixed", 2.0, {}),
    "rep1.4": ("beam", 1.0, dict(repetition_penalty=1.4)),
    "min_len": ("mixed", 1.0, dict(min_len=5)),
}


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_beam_search_matches_jax(case):
    table, lp, kw = BEAM_CASES[case]
    w, _ = tables(table)
    want, want_s = jgen.beam_search(jax_logits_fn(w), BOS, EOS, PAD, MASK, B,
                                    L, 3, length_penalty=lp, **kw)
    got, got_s = pgen.beam_search(port_logits_fn(w), BOS, EOS, PAD, MASK, B,
                                  L, 3, length_penalty=lp, device="cpu", **kw)
    same(got, want)
    near(got_s, want_s)
    assert not (got == MASK).any()


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_beam_search_cached_matches_jax(case):
    """The cache rows follow the surviving beams: the trigram term reads
    them."""
    table, lp, kw = BEAM_CASES[case]
    w, w3 = tables(table)
    k = 3
    want, want_s = jgen.beam_search_cached(
        *jax_cached(w, w3, B * k), BOS, EOS, PAD, B, L, k,
        length_penalty=lp, mask_token_id=MASK, **kw)
    got, got_s = pgen.beam_search_cached(
        *port_cached(w, w3, B * k), BOS, EOS, PAD, B, L, k,
        length_penalty=lp, mask_token_id=MASK, device="cpu", **kw)
    same(got, want)
    near(got_s, want_s)
    full, full_s = pgen.beam_search(port_logits_fn(w, w3), BOS, EOS, PAD,
                                    MASK, B, L, k, length_penalty=lp,
                                    device="cpu", **kw)
    same(got, full.numpy())
    near(got_s, full_s.numpy())


def test_top_k_is_stable_on_ties():
    """Equal values come out in index order, as `lax.top_k` orders them."""
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, -1e9, -1e9]])
    vals, idx = pgen._top_k(x, 5)
    assert idx.tolist() == [[1, 2, 4, 3, 0]]
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    same(idx, want_i)
    same(vals, want_v)


# ---------------------------------------------------------------------------
# the logit processors and sampling
# ---------------------------------------------------------------------------

def test_repetition_penalty_matches_jax():
    r = np.random.RandomState(3)
    logits = r.randn(4, V).astype(np.float32)
    tokens = r.randint(0, V, (4, 6)).astype(np.int32)
    for t in (0, 3, 6):
        want = jgen.apply_repetition_penalty(jnp.asarray(logits),
                                             jnp.asarray(tokens), t, 1.3)
        got = pgen.apply_repetition_penalty(torch.from_numpy(logits),
                                            torch.from_numpy(tokens), t, 1.3)
        same(got, want)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (3, 1.0), (0, 0.6),
                                         (4, 0.8), (1, 0.3), (50, 0.95)])
def test_top_k_top_p_filtering_matches_jax(top_k, top_p):
    logits = np.random.RandomState(4).randn(5, 40).astype(np.float32) * 2
    want = jgen.top_k_top_p_filtering(jnp.asarray(logits), top_k, top_p)
    got = pgen.top_k_top_p_filtering(torch.from_numpy(logits), top_k, top_p)
    same(got, want)


def test_sampling_top_k1_equals_greedy_and_is_seeded():
    w, _ = tables("mixed")
    fn = port_logits_fn(w)
    greedy = pgen.generate(fn, BOS, EOS, PAD, MASK, B, L, device="cpu")

    def sample(seed, **kw):
        return pgen.generate(fn, BOS, EOS, PAD, MASK, B, L, do_sample=True,
                             generator=torch.Generator().manual_seed(seed),
                             device="cpu", **kw)
    top1 = sample(0, top_k=1)
    torch.testing.assert_close(top1.sequences, greedy.sequences, rtol=0,
                               atol=0)
    a, b = sample(5, temperature=1.5), sample(5, temperature=1.5)
    torch.testing.assert_close(a.sequences, b.sequences, rtol=0, atol=0)
    torch.testing.assert_close(a.logprobs, b.logprobs, rtol=0, atol=0)
    # top_k 2: every sampled token (before a row finished) is one of the
    # two best continuations of the token before it
    s = sample(7, top_k=2).sequences
    for n in range(B):
        for t in range(1, L - 1):
            if s[n, t - 1] in (EOS, PAD):
                break
            best2 = np.argsort(-w[int(s[n, t - 1])], kind="stable")[:2]
            assert int(s[n, t]) in best2
