"""The numerical design of the fp32 attention kernel, emulated on the CPU.

The kernel (`csrc/masked_attention.cuh`, namespace `tf32`) runs both products
of fp32 attention on the TF32 tensor cores in three passes: each operand is
split into x = hi + lo, hi = tf32(x), lo = tf32(x - hi), and a product is
summed as lo.hi + hi.lo + hi.hi in fp32. Here TF32 rounding is emulated in
plain torch (round to nearest, ties away from zero, to 10 fraction bits on
the int32 view: the bits of `cvt.rna.tf32.f32`, and the two integer
operations the kernel rounds with) to show that the three passes hold the
kernel's fp32 tolerance against `plain_attention` and one pass does not,
and that the 1/8-quantised fully-masked rows stay exact under the split.
This file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from mvp_pytorch_tpu_torch.ops.attention import mask_to_bias, plain_attention

B, H, L, D = 4, 12, 125, 64
TOL = 2e-5            # the fp32 kernel's tolerance against plain_attention


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 fraction bits), ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_3xtf32(a, b):
    """a @ b from TF32 pieces in fp32: the kernel's three passes."""
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_1xtf32(a, b):
    return tf32(a) @ tf32(b)


def emulated_attention(q, k, v, bias, mm):
    """softmax(q.k^T * D^-1/2 + bias).v with both products through `mm`;
    the scale and the bias as two roundings, exp and the sums in fp32."""
    scores = mm(q, k.transpose(-1, -2)) * D ** -0.5 + bias
    return mm(torch.softmax(scores, dim=-1), v)


def make_case(seed, quantised=False):
    """q, k, v [B, H, L, D] and a padded key-mask bias [B, 1, 1, L]; batch
    row 0 has every key masked when `quantised`."""
    r = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(r.randn(B, H, L, D).astype(np.float32))
               for _ in range(3))
    if quantised:
        # multiples of 1/8 in [-4, 4]: 6 significant bits, so lo = 0
        q, k = (torch.clamp(torch.round(x * 8) / 8, -4, 4) for x in (q, k))
    lens = r.randint(L // 2, L + 1, size=B)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    if quantised:
        mask[0] = 0
    return q, k, v, mask_to_bias(torch.from_numpy(mask))


def test_tf32_rounding_keeps_ten_fraction_bits():
    x = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert (torch.abs(hi - x) <= 2.0 ** -11 * torch.abs(x)).all()
    # hi + lo holds x to about 22 bits
    rel = torch.abs(hi.double() + lo.double() - x.double()) / torch.abs(x)
    assert rel.max() <= 2.0 ** -21
    # ties round away from zero, as cvt.rna does
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert tf32(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_attention_holds_the_fp32_tolerance(seed):
    q, k, v, bias = make_case(seed)
    want = plain_attention(q, k, v, bias)
    got = emulated_attention(q, k, v, bias, mm_3xtf32)
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= TOL, err


@pytest.mark.parametrize("seed", [0, 1])
def test_one_tf32_pass_misses_the_fp32_tolerance(seed):
    q, k, v, bias = make_case(seed)
    want = plain_attention(q, k, v, bias)
    err = (emulated_attention(q, k, v, bias, mm_1xtf32) - want).abs().max()
    assert err.item() > 10 * TOL, err.item()


def test_quantised_fully_masked_rows_stay_exact_under_the_split():
    """q, k in multiples of 1/8 split with lo = 0, so every TF32 product and
    fp32 sum of q.k^T is exact: the scores of a fully-masked row (where fp32
    keeps 10 fraction bits next to the -10000 bias) are the reference's
    bit for bit."""
    q, k, v, bias = make_case(2, quantised=True)
    for x in (q, k):
        hi, lo = split(x)
        assert torch.equal(hi, x) and not lo.any()
    kt = k.transpose(-1, -2)
    exact = (q.double() @ kt.double()).float()
    assert torch.equal(mm_3xtf32(q, kt), exact)
    assert torch.equal(q @ kt, exact)
    got = emulated_attention(q, k, v, bias, mm_3xtf32)
    want = plain_attention(q, k, v, bias)
    assert torch.isfinite(got[0]).all()
    assert (got - want).abs().max().item() <= TOL
