"""The port's fixed-shape masked ops and WRA pieces against the JAX
package's, on the same numpy-seeded inputs.

Losses and gathered values at atol 1e-6 (the same fp32 math); integer
outputs exactly. The WRA losses pin their random choices (`pick`,
`neg_offset`) on both sides; their gradients are held at atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.models import pretrain as jax_pretrain
from mvp_pytorch_tpu.ops import masked as jax_masked
from mvp_pytorch_tpu_torch.models import pretrain
from mvp_pytorch_tpu_torch.ops import masked

TOL = dict(atol=1e-6, rtol=0)


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("labels", [[0, 4, 2, 1, 3, 0],
                                    [0, -1, 2, 5, 3, 7],
                                    [-1, -1, 5, 6, -3, 9]])
def test_cross_entropy_matches_jax(labels):
    """Out-of-range labels (below 0 or at or past V = 5) count 0."""
    logits = np.random.RandomState(0).randn(6, 5).astype(np.float32)
    labels = np.asarray(labels, np.int64)
    got = masked.cross_entropy(t(logits), t(labels))
    want = jax_masked.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", ["some", "out_of_range", "none"])
def test_masked_cross_entropy_matches_jax(case):
    r = np.random.RandomState(1)
    logits = r.randn(2, 4, 7).astype(np.float32)
    labels = r.randint(0, 7, (2, 4))
    weights = (r.rand(2, 4) > 0.4).astype(np.float32)
    if case == "out_of_range":
        labels[0, :2] = [7, 9]
        weights[0, :2] = 1.0
    elif case == "none":
        weights[:] = 0.0
    got = masked.masked_cross_entropy(t(logits), t(labels), t(weights))
    want = jax_masked.masked_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if case == "none":
        assert float(got) == 0.0


def test_gather_masked_positions_matches_jax():
    r = np.random.RandomState(2)
    hidden = r.randn(3, 8, 5).astype(np.float32)
    labels = np.where(r.rand(3, 8) > 0.6, r.randint(0, 9, (3, 8)), -1)
    labels[2] = -1                                  # nothing labelled
    for max_pred in (3, 8, 10):
        got = masked.gather_masked_positions(t(hidden), t(labels), max_pred)
        want = jax_masked.gather_masked_positions(
            jnp.asarray(hidden), jnp.asarray(labels), max_pred)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_gather_span_matches_jax():
    """Spans inside, empty, and running past L = 6."""
    seq = np.random.RandomState(3).randn(4, 6, 3).astype(np.float32)
    span = np.array([[1, 4], [2, 2], [4, 9], [0, 6]])
    for width in (2, 4, 7):
        got = masked.gather_span(t(seq), t(span), width)
        want = jax_masked.gather_span(jnp.asarray(seq), jnp.asarray(span),
                                      width)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def wra_inputs(seed=4, b=5, l=12, h=6):
    r = np.random.RandomState(seed)
    seq = r.randn(b, l, h).astype(np.float32)
    hard = r.randn(b, l, h).astype(np.float32)
    start = r.randint(1, 4, b)
    phrase = np.stack([start, start + r.randint(0, 4, b)], 1)   # some empty
    image = np.stack([np.full(b, 7), np.full(b, 7) + r.randint(1, 6, b)], 1)
    hard_txt = r.permutation(b)
    hard_img = r.permutation(b)
    return seq, hard, phrase, image, hard_txt, hard_img


@pytest.mark.parametrize("pick", [0, 1, 2])
def test_t2i_sim_matches_jax(pick):
    r = np.random.RandomState(5)
    sims = r.randn(3, 4, 5).astype(np.float32)
    pv = (r.rand(3, 4) > 0.3).astype(np.float32)
    iv = (r.rand(3, 5) > 0.3).astype(np.float32)
    iv[0] = 0.0                                     # no valid region
    iv[1, :] = [1, 0, 0, 0, 0]                      # one valid region
    got = pretrain.t2i_sim(t(sims), t(pv), t(iv), pick=pick)
    want = jax_pretrain.t2i_sim(jnp.asarray(sims), jnp.asarray(pv),
                                jnp.asarray(iv), None, pick=pick)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_t2i_sim_draws_only_valid_slots():
    """Unpinned, the draw lands on a valid top-3 slot: with one valid region
    the result is that region's similarity, whatever the generator."""
    sims = torch.randn(2, 3, 5)
    pv = torch.ones(2, 3)
    iv = torch.tensor([[0, 0, 1, 0, 0], [1, 1, 1, 1, 1]], dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    for _ in range(10):
        got = pretrain.t2i_sim(sims, pv, iv, gen)
        torch.testing.assert_close(got[0], sims[0, :, 2].mean())


def loss_and_grads(fn, args, grad_argnums):
    """(loss, grads) of a JAX function by jax.value_and_grad."""
    val, grads = jax.value_and_grad(fn, argnums=grad_argnums)(*args)
    return np.asarray(val), [np.asarray(g) for g in grads]


def test_wra_hard_loss_matches_jax():
    seq, hard, phrase, image, ht, hi = wra_inputs()
    kw = dict(phrase_width=4, img_width=5, pick=1)
    want, (gs, gh) = loss_and_grads(
        lambda s, h: jax_pretrain.wra_hard_loss(
            s, h, jnp.asarray(phrase), jnp.asarray(image), jnp.asarray(ht),
            jnp.asarray(hi), jax.random.PRNGKey(0), **kw),
        (jnp.asarray(seq), jnp.asarray(hard)), (0, 1))
    ts, th = t(seq).requires_grad_(), t(hard).requires_grad_()
    got = pretrain.wra_hard_loss(ts, th, t(phrase), t(image), t(ht), t(hi),
                                 **kw)
    got.backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(ts.grad.numpy(), gs, atol=1e-5, rtol=0)
    np.testing.assert_allclose(th.grad.numpy(), gh, atol=1e-5, rtol=0)


def test_wra_sample_loss_matches_jax():
    seq, _, phrase, image, _, _ = wra_inputs(seed=6)
    kw = dict(phrase_width=4, img_width=5, pick=0, neg_offset=2)
    want, (gs,) = loss_and_grads(
        lambda s: jax_pretrain.wra_sample_loss(
            s, jnp.asarray(phrase), jnp.asarray(image),
            jax.random.PRNGKey(0), **kw),
        (jnp.asarray(seq),), (0,))
    ts = t(seq).requires_grad_()
    got = pretrain.wra_sample_loss(ts, t(phrase), t(image), **kw)
    got.backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(ts.grad.numpy(), gs, atol=1e-5, rtol=0)
    # unpinned, the draws come from the generator and repeat with its seed
    a, b = (pretrain.wra_sample_loss(
        t(seq), t(phrase), t(image), torch.Generator().manual_seed(3),
        phrase_width=4, img_width=5) for _ in range(2))
    assert torch.isfinite(a) and float(a) == float(b)
