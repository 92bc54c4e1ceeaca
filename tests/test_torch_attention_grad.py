"""Gradients of the port's differentiable masked attention against the JAX
package's.

`masked_attention` (on the CPU: the plain forward and `MaskedAttentionFn`'s
recompute backward) is held against `jax.vjp` of `xla_attention` /
`xla_attention_blhd` on the same numpy-seeded inputs and cotangent: dq, dk,
dv and dbias, both layouts, a 2-D key mask, a 3-D per-query mask, a full
[B, H, Lq, Lk] bias, Lk > Lq and fully-masked rows. fp32 at atol 1e-5 (the
same fp32 math in another summation order); bf16 against the fp32 gradients
at atol 0.05, as tests/test_models.py holds bf16 outputs to fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.ops.attention import (mask_to_bias as jax_mask_to_bias,
                                           xla_attention, xla_attention_blhd)
from mvp_pytorch_tpu_torch.ops.attention import (MaskedAttentionFn,
                                                 masked_attention,
                                                 plain_attention_blhd)

B, H, D, LQ = 3, 4, 8, 7


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


def make_case(kind, seed=0):
    """q, k, v [B, H, L, D], an fp32 bias and a cotangent, as numpy."""
    r = np.random.RandomState(seed)
    lk = LQ + 4 if kind == "lk_gt_lq" else LQ
    q = r.randn(B, H, LQ, D).astype(np.float32)
    k = r.randn(B, H, lk, D).astype(np.float32)
    v = r.randn(B, H, lk, D).astype(np.float32)
    g = r.randn(B, H, LQ, D).astype(np.float32)
    if kind == "fully_masked":
        # multiples of 1/8: q.k is exact in every summation order (see
        # tests/test_torch_attention.py)
        q, k = (np.clip(np.round(x * 8) / 8, -4, 4) for x in (q, k))
    if kind == "mask3d":
        mask = (r.rand(B, LQ, lk) > 0.3).astype(np.int32)
        mask[..., 0] = 1
        mask[1, LQ // 2] = 0                 # one fully-masked query row
    elif kind == "bias4d":
        mask = (r.rand(B, lk) > 0.2).astype(np.int32)
        mask[:, 0] = 1
        bias = np.array(jax_mask_to_bias(jnp.asarray(mask)))
        return q, k, v, g, (bias + r.randn(B, H, LQ, lk)).astype(np.float32)
    else:
        mask = np.ones((B, lk), np.int32)
        mask[1, lk - 3:] = 0
        mask[2, lk - 1:] = 0
        if kind == "fully_masked":
            mask[0] = 0
    return q, k, v, g, np.array(jax_mask_to_bias(jnp.asarray(mask)))


def to_blhd(x):
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3))


def jax_grads(q, k, v, g, bias, layout):
    fn = xla_attention_blhd if layout == "blhd" else xla_attention
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v, bias)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def port_grads(q, k, v, g, bias, layout, dtype):
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    tb = torch.from_numpy(bias).requires_grad_()
    out = masked_attention(tq, tk, tv, tb, layout=layout)
    assert type(out.grad_fn).__name__ == "MaskedAttentionFnBackward"
    out.backward(torch.from_numpy(g).to(dtype))
    for t in (tq, tk, tv):
        assert t.grad.dtype == dtype
    assert tb.grad.shape == tb.shape and tb.grad.dtype == torch.float32
    return [t.grad.float().numpy() for t in (tq, tk, tv, tb)]


KINDS = ["mask2d", "mask3d", "bias4d", "lk_gt_lq", "fully_masked"]


def case_arrays(kind, layout, seed):
    q, k, v, g, bias = make_case(kind, seed)
    if layout == "blhd":
        q, k, v, g = map(to_blhd, (q, k, v, g))
    return q, k, v, g, bias


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("kind", KINDS)
def test_fp32_grads_match_jax(kind, layout):
    args = case_arrays(kind, layout, seed=0)
    want = jax_grads(*args, layout)
    got = port_grads(*args, layout, torch.float32)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.shape == b.shape, name
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_grads_track_fp32(kind, layout):
    # the backward recomputes the probabilities in fp32 from the bf16 q, k
    # and the fp32 bias, as the JAX package's `_attn_bwd` did, so even a
    # fully-masked row (uniform in the bf16 forward) follows the fp32 grads
    args = case_arrays(kind, layout, seed=1)
    want = jax_grads(*(a.astype(np.float32) for a in args), layout)
    got = port_grads(*args, layout, torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, atol=0.05, rtol=0, err_msg=name)


def test_fully_masked_rows_give_finite_shift_invariant_grads():
    """A row whose keys are all masked keeps finite grads, and its dbias
    sums to 0 over the keys, as any softmax row's does."""
    q, k, v, g, bias = make_case("fully_masked", seed=3)
    got = port_grads(q, k, v, g, bias, "bhld", torch.float32)
    dbias = got[3]
    np.testing.assert_allclose(dbias[0].sum(-1), 0.0, atol=1e-5)
    assert np.isfinite(got[0]).all()


def test_grad_fn_only_when_a_grad_is_needed():
    q = torch.randn(2, 5, 3, 8)
    out = masked_attention(q, q, q, layout="blhd")
    assert out.grad_fn is None
    qg = q.clone().requires_grad_()
    out = masked_attention(qg, q, q, layout="blhd")
    assert isinstance(out.grad_fn, MaskedAttentionFn._backward_cls)
    with torch.no_grad():
        assert masked_attention(qg, q, q, layout="blhd").grad_fn is None
    with torch.inference_mode():
        assert masked_attention(qg, q, q, layout="blhd").grad_fn is None
    torch.testing.assert_close(out, plain_attention_blhd(q, q, q),
                               rtol=0, atol=0)


def test_no_bias_and_bias_without_grad():
    r = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(r.randn(2, 4, 5, 8).astype(np.float32))
               .requires_grad_() for _ in range(3))
    bias = torch.zeros(2, 1, 1, 5)
    for b in (None, bias):
        for t in (q, k, v):
            t.grad = None
        masked_attention(q, k, v, b).sum().backward()
        ref = [torch.autograd.grad(
            torch.einsum("bhqk,bhkd->bhqd", torch.softmax(
                torch.einsum("bhqd,bhkd->bhqk", q, k) * 8 ** -0.5, -1),
                v).sum(), t)[0] for t in (q, k, v)]
        for t, want in zip((q, k, v), ref):
            torch.testing.assert_close(t.grad, want, atol=1e-5, rtol=0)
    assert bias.grad is None
