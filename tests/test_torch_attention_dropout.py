"""Attention-prob dropout of the port's masked attention, on the CPU.

The mask is a counter-based hash of a 64-bit seed and the flat element index
((b H + h) Lq + i) Lk + j; the kernel computes the same bits on the card
(tests/test_torch_kernels.py holds the kernel to this plain version there).
Here:
- `dropout_hash` against a numpy uint32 reimplementation, exactly, for
  negative and positive seeds and indices past 2^32;
- the keep share at p = 0.1 over 10^6 elements within 0.002 of 0.9 (six
  standard deviations);
- the mask read back through the plain version (q = k = 0, v = I: each output
  row is keep / (Lk (1 - p))), bit for bit, in both layouts and dtypes;
- `p = 0` equal to the output without dropout, bit for bit;
- `MaskedAttentionFn`'s backward with dropout against torch autograd through
  the plain dropout version on the same seed: fp32 atol 1e-5 (the same math
  in another summation order);
- `SelfAttention` in training at p > 0 going through `MaskedAttentionFn`,
  with the seed drawn from its `Dropout`'s generator.

JAX's dropout masks come from another random stream and are never compared.
"""

import numpy as np
import pytest
import torch

from mvp_pytorch_tpu_torch.models import tiny_config
from mvp_pytorch_tpu_torch.models.layers import (SelfAttention,
                                                 dropout_generator)
from mvp_pytorch_tpu_torch.ops.attention import (MaskedAttentionFn,
                                                 dropout_hash, dropout_keep,
                                                 dropout_threshold,
                                                 mask_to_bias,
                                                 masked_attention,
                                                 plain_attention,
                                                 plain_attention_blhd)

B, H, LQ, LK, D = 3, 4, 7, 9, 8
P = 0.1


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


def numpy_hash(seed: int, index: np.ndarray) -> np.ndarray:
    """The kernel's hash in numpy uint32 arithmetic (wrapping mod 2^32)."""
    s = seed % 2 ** 64
    s0, s1 = np.uint32(s & 0xFFFFFFFF), np.uint32(s >> 32)
    index = index.astype(np.uint64)
    lo = (index & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (index >> np.uint64(32)).astype(np.uint32)
    with np.errstate(over="ignore"):
        x = (lo ^ s0) + (hi ^ s1) * np.uint32(0x9E3779B9)
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x846CA68B)
        x ^= x >> np.uint32(16)
    return x


def seed_tensor(value: int) -> torch.Tensor:
    return torch.tensor([value], dtype=torch.int64)


@pytest.mark.parametrize("seed", [0, 1, -1, 2 ** 62 + 12345,
                                  -(2 ** 63), 2 ** 63 - 1,
                                  -3141592653589793238])
def test_hash_matches_numpy_exactly(seed):
    r = np.random.RandomState(abs(seed) % 2 ** 32)
    index = np.concatenate([
        np.arange(5000),
        2 ** 32 - 50 + np.arange(100),           # across the low word's wrap
        r.randint(0, 2 ** 62, 2000, dtype=np.int64),
        [2 ** 63 - 1]]).astype(np.int64)
    got = dropout_hash(seed_tensor(seed), torch.from_numpy(index)).numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2 ** 32
    np.testing.assert_array_equal(got.astype(np.uint32),
                                  numpy_hash(seed, index))


def test_keep_share_over_a_million_elements():
    keep = dropout_keep(seed_tensor(987654321), P, (4, 10, 125, 200))
    assert keep.numel() == 10 ** 6
    assert abs(keep.float().mean().item() - (1 - P)) <= 0.002
    # two seeds give two masks
    other = dropout_keep(seed_tensor(987654322), P, (4, 10, 125, 200))
    assert (keep != other).float().mean().item() > 0.1
    assert dropout_threshold(P) == 429496730
    # the mask's one-term shortcut for the high word is the hash itself
    seed = seed_tensor(-5)
    index = torch.arange(10 ** 6, dtype=torch.int64)
    assert torch.equal(dropout_keep(seed, P, (10 ** 6,)),
                       dropout_hash(seed, index) >= dropout_threshold(P))


def readback(layout, dtype, seed, b=2, lq=5, lk=64):
    """The mask through the plain version: q = k = 0 (uniform probabilities),
    v = the identity per (b, h), so out[b, h, i, :] = keep / (lk (1 - p))."""
    q = torch.zeros(b, H, lq, lk, dtype=dtype)
    k = torch.zeros(b, H, lk, lk, dtype=dtype)
    v = torch.eye(lk, dtype=dtype).expand(b, H, lk, lk)
    if layout == "blhd":
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = masked_attention(q, k, v, layout=layout, dropout_p=P, seed=seed)
    return out.transpose(1, 2) if layout == "blhd" else out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
def test_mask_reads_back_through_the_plain_version(layout, dtype):
    seed = seed_tensor(-77)
    out = readback(layout, dtype, seed).float()
    want = dropout_keep(seed, P, (2, H, 5, 64))
    assert torch.equal(out > 0, want)
    kept = out[want]
    expect = torch.tensor(1 / 64 / (1 - P)).to(dtype).float()
    assert torch.allclose(kept, expect, rtol=1e-6 if dtype == torch.float32
                          else 0, atol=0)


def inputs(seed=0, dtype=torch.float32, layout="bhld"):
    r = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(r.randn(B, H, l, D).astype(np.float32))
               .to(dtype) for l in (LQ, LK, LK))
    mask = np.ones((B, LK), np.int32)
    mask[1, LK - 3:] = 0
    bias = mask_to_bias(torch.from_numpy(mask))
    if layout == "blhd":
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return q, k, v, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
def test_p0_is_the_output_without_dropout(layout, dtype):
    q, k, v, bias = inputs(1, dtype, layout)
    plain = plain_attention_blhd if layout == "blhd" else plain_attention
    want = plain(q, k, v, bias)
    for kw in ({}, {"dropout_p": 0.0}, {"dropout_p": 0.0,
                                        "seed": seed_tensor(5)}):
        got = masked_attention(q, k, v, bias, layout=layout, **kw)
        assert torch.equal(got, want), kw
    assert torch.equal(plain(q, k, v, bias, 0.0, seed_tensor(5)), want)


def test_dropout_is_the_plain_probabilities_times_the_mask():
    """plain version with dropout = softmax * keep / (1 - p), then . v."""
    q, k, v, bias = inputs(2)
    seed = seed_tensor(42)
    got = plain_attention(q, k, v, bias, P, seed)
    probs = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) * D ** -0.5
                          + bias, dim=-1)
    keep = dropout_keep(seed, P, probs.shape)
    want = torch.einsum("bhqk,bhkd->bhqd", probs * keep / (1 - P), v)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    # the blhd layout drops the same [B, H, Lq, Lk] elements
    blhd = plain_attention_blhd(*(t.transpose(1, 2) for t in (q, k, v)),
                                bias, P, seed)
    torch.testing.assert_close(blhd.transpose(1, 2), got, atol=1e-6, rtol=0)


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
def test_dropout_backward_matches_plain_autograd(layout):
    q, k, v, bias = inputs(3, layout=layout)
    g = torch.from_numpy(np.random.RandomState(4).randn(*q.shape)
                         .astype(np.float32))
    seed = seed_tensor(2 ** 40 + 3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    out = masked_attention(*leaves[:3], leaves[3], layout=layout,
                           dropout_p=P, seed=seed)
    assert isinstance(out.grad_fn, MaskedAttentionFn._backward_cls)
    got = torch.autograd.grad(out, leaves, g)
    ref = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    plain = plain_attention_blhd if layout == "blhd" else plain_attention
    want = torch.autograd.grad(plain(*ref, P, seed), ref, g)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0,
                                   msg=lambda m, n=name: f"{n}: {m}")
    # the mask matters: without it the grads differ
    plain_grads = torch.autograd.grad(plain(*ref), ref, g)
    assert (got[2] - plain_grads[2]).abs().max() > 1e-3


def test_dropout_arguments_are_checked():
    q, k, v, bias = inputs()
    with pytest.raises(ValueError, match="seed"):
        masked_attention(q, k, v, bias, dropout_p=P)
    with pytest.raises(ValueError, match="seed"):
        masked_attention(q, k, v, bias, dropout_p=P,
                         seed=torch.tensor([1], dtype=torch.int32))
    with pytest.raises(ValueError, match="seed"):
        masked_attention(q, k, v, bias, dropout_p=P,
                         seed=torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="dropout_p"):
        masked_attention(q, k, v, bias, dropout_p=1.0, seed=seed_tensor(1))


def reaches(fn, cls, depth=4) -> bool:
    """Whether the autograd graph from `fn` has a `cls` node within
    `depth` steps."""
    if fn is None or depth < 0:
        return False
    return isinstance(fn, cls) or any(reaches(f, cls, depth - 1)
                                      for f, _ in fn.next_functions)


def test_self_attention_in_training_runs_masked_attention_with_dropout():
    cfg = tiny_config(attention_probs_dropout_prob=P)
    layer = SelfAttention(cfg)
    torch.manual_seed(0)
    hidden = torch.randn(B, LQ, cfg.hidden_size)
    mask = torch.ones(B, LQ, dtype=torch.int32)
    mask[0, -2:] = 0
    bias = mask_to_bias(mask)
    layer.train()
    with pytest.raises(RuntimeError, match="generator"):
        layer(hidden, bias)
    gen = torch.Generator().manual_seed(11)
    with dropout_generator(layer, gen):
        out = layer(hidden, bias)
    assert reaches(out.grad_fn, MaskedAttentionFn._backward_cls)
    # the same seed, drawn from the same generator state, through the plain
    # version
    seed = torch.randint(-2 ** 63, 2 ** 63 - 1, (1,), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(11))

    def split(x):
        return x.view(B, LQ, cfg.num_attention_heads, cfg.head_dim)
    want = plain_attention_blhd(split(layer.query(hidden)),
                                split(layer.key(hidden)),
                                split(layer.value(hidden)), bias, P, seed)
    torch.testing.assert_close(out, want.reshape(out.shape), atol=0, rtol=0)
    no_drop = plain_attention_blhd(split(layer.query(hidden)),
                                   split(layer.key(hidden)),
                                   split(layer.value(hidden)), bias)
    assert not torch.equal(out, no_drop.reshape(out.shape))
    # eval mode: no dropout, no generator needed
    layer.eval()
    torch.testing.assert_close(layer(hidden, bias),
                               no_drop.reshape(out.shape), atol=0, rtol=0)
