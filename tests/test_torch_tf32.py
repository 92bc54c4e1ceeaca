"""The numerical design of the fp32 attention kernel, emulated on the CPU.

The kernel (`csrc/masked_attention_tf32.cuh`, `hopper::f32`) runs both
products of fp32 attention on the TF32 tensor cores (`wgmma`) in three
passes: each operand is split into x = hi + lo, hi = tf32(x), lo = tf32(x -
hi), and a product is summed as lo.hi + hi.lo + hi.hi in fp32, one 8-wide
k-step after another. Here TF32 rounding is emulated in plain torch (round
to nearest, ties away from zero, to 10 fraction bits on the int32 view: the
bits of `cvt.rna.tf32.f32`, and the two integer operations the kernel
rounds with) to show that the three passes hold the kernel's fp32 tolerance
against `plain_attention` and one pass does not, that the 1/8-quantised
fully-masked rows stay exact under the split, and, for the kernel as built
(`emulated_kernel`): k-steps over the head dim in order for q.k^T, over each
8-key group in the order 0, 2, 4, 6, 1, 3, 5, 7 for P.v (the order in which
the kernel's transpose of v lays the keys out), and the online softmax
across key tiles, whose rescale the tolerance needs. The last tests
rebuild the kernel's shared-memory layouts (TMA's 128-byte swizzle, the
transpose of v, what a K-major `wgmma` operand reads) and check that the
transpose writes every key where P.v reads it.
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


# The key order of P.v within each 8-key group: A column c of a k-step (the
# accumulator of S gives a thread keys 2t and 2t + 1 as its columns t and
# t + 4) is key PERM[c], and the transpose writes key PERM[c] at position c.
PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def mm_ksteps(a, b, passes=3, order=None):
    """a @ b over 8-wide k-steps in fp32, each k-step's products from TF32
    pieces (three passes: lo.hi + hi.lo + hi.hi; one: hi.hi), the k index of
    each step visited in `order`."""
    (ah, al), (bh, bl) = split(a), split(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        idx = [k0 + c for c in (order or range(8)) if k0 + c < a.shape[-1]]
        sl = torch.tensor(idx)
        if passes == 3:
            acc = acc + al[..., sl] @ bh[..., sl, :]
            acc = acc + ah[..., sl] @ bl[..., sl, :]
        acc = acc + ah[..., sl] @ bh[..., sl, :]
    return acc


def emulated_kernel(q, k, v, bias, key_tile, passes=3, rescale=True):
    """The kernel's arithmetic: S by k-steps over the head dim, the scores
    rounded as s * scale, then + bias, keys past Lk padded to the key tile
    at -inf; one key tile: the exact row softmax, normalised before P.v;
    more: the online softmax (running max and sum, the output rescaled by
    exp(m_old - m_new) at each tile unless `rescale` is False), normalised
    after. P.v by k-steps over each 8-key group in PERM's order."""
    lk = k.shape[-2]
    n_kt = -(-lk // key_tile)
    pad = n_kt * key_tile - lk
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    bp = torch.nn.functional.pad(bias.expand(*q.shape[:-2], q.shape[-2], lk),
                                 (0, pad), value=-float("inf"))
    d = q.shape[-1]
    o = torch.zeros(q.shape)
    m = torch.full(q.shape[:-1] + (1,), -float("inf"))
    l = torch.zeros(q.shape[:-1] + (1,))
    for t in range(n_kt):
        ks = slice(t * key_tile, (t + 1) * key_tile)
        s = mm_ksteps(q, kp[..., ks, :].transpose(-1, -2), passes)
        s = s * torch.tensor(d ** -0.5, dtype=torch.float32) + bp[..., ks]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new) if rescale else torch.ones_like(m)
        l = l * corr + p.sum(-1, keepdim=True)
        if n_kt == 1:
            p = p * (1.0 / l)
        o = o * corr + mm_ksteps(p, vp[..., ks, :], passes, PERM)
        m = m_new
    return o if n_kt == 1 else o / l


def shift_case(seed=4, lk=200, shift_from=100):
    """make_case's inputs at Lk 200 under a per-query mask whose keys from
    `shift_from` on carry +4 of bias on every other query row: those rows'
    maxima rise in a later key tile, so the earlier tiles' weight must fall
    by about e^-4."""
    r = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(r.randn(2, 4, n, D).astype(np.float32))
               for n in (75, lk, lk))
    mask = (r.rand(2, 75, lk) > 0.3).astype(np.int32)
    mask[..., 0] = 1
    bias = mask_to_bias(torch.from_numpy(mask))
    bias[:, :, ::2, shift_from:] += 4.0 * torch.from_numpy(
        mask[:, None, ::2, shift_from:]).float()
    return q, k, v, bias


@pytest.mark.parametrize("key_tile", [160, 128, 64, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_emulated_kernel_holds_the_fp32_tolerance(seed, key_tile):
    """L 125: one exact tile at key tiles 160 and 128, the online softmax
    over 2 and 4 tiles at 64 and 32."""
    q, k, v, bias = make_case(seed)
    q, k, v, bias = q[:2], k[:2], v[:2], bias[:2]
    got = emulated_kernel(q, k, v, bias, key_tile)
    err = (got - plain_attention(q, k, v, bias)).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= TOL, err


@pytest.mark.parametrize("key_tile", [128, 32])
def test_emulated_kernel_with_one_pass_misses_the_tolerance(key_tile):
    q, k, v, bias = make_case(1)
    q, k, v, bias = q[:2], k[:2], v[:2], bias[:2]
    got = emulated_kernel(q, k, v, bias, key_tile, passes=1)
    err = (got - plain_attention(q, k, v, bias)).abs().max().item()
    assert err > 10 * TOL, err


@pytest.mark.parametrize("key_tile", [160, 96, 64])
def test_online_rescale_is_what_holds_the_tolerance(key_tile):
    """At Lk 200 over key tiles of 160, 96 and 64 (2-4 tiles), with the
    rows' maxima apart across tiles: the online softmax holds the fp32
    tolerance with its rescale and misses it by far without."""
    q, k, v, bias = shift_case()
    want = plain_attention(q, k, v, bias)
    err = (emulated_kernel(q, k, v, bias, key_tile) - want).abs().max().item()
    assert err <= TOL, err
    bad = (emulated_kernel(q, k, v, bias, key_tile, rescale=False)
           - want).abs().max().item()
    assert bad > 1000 * TOL, bad


def test_fragment_columns_meet_the_transposed_keys():
    """In each 8-key group thread t of a quad holds P at keys 2t, 2t + 1 (the
    accumulator of S) and hands them to P.v as A columns t, t + 4; B row c
    of v^T holds key PERM[c]. Every key meets its own row of v once."""
    pairs = []
    for t in range(4):
        for col, key in ((t, 2 * t), (t + 4, 2 * t + 1)):
            pairs.append((key, PERM[col]))
    assert sorted(pairs) == [(k, k) for k in range(8)]


def swizzle(byte):
    """TMA's 128-byte swizzle of a byte offset from a 1024-byte aligned base:
    its 16-byte unit (bits 4-6) xor its row in the 8-row atom (bits 7-9)."""
    return byte ^ (((byte >> 7) & 7) << 4)


def layout_and_transpose(d, key_tile, heads):
    """v [heads, key_tile, d] laid out as TMA lands it (d / 32 chunks of
    heads x key_tile rows of 128 bytes, swizzled), then moved as the
    kernel's `transpose_v` moves it: returns (v, the v^T buffer as floats)."""
    kv_chunk = heads * key_tile * 128
    v = np.random.RandomState(0).randn(heads, key_tile, d).astype(np.float32)
    src = np.zeros(heads * key_tile * d, np.float32)
    for hh in range(heads):
        for r in range(key_tile):
            for n in range(d):
                b = ((n // 32) * kv_chunk + hh * key_tile * 128 + r * 128
                     + (n % 32) * 4)
                src[swizzle(b) // 4] = v[hh, r, n]
    dst = np.full(src.shape, np.nan, np.float32)
    quads, chunks = d // 4, key_tile // 32
    w = 4 if d <= 64 and key_tile * d <= 128 * 64 else 2   # `Regs::kReadDims`
    for item in range(heads * chunks * quads * 8):
        j8, h = (item & 7) >> 1, item & 1
        nq, rest = (item >> 3) % quads, (item >> 3) // quads
        kc, hh = rest % chunks, rest // chunks
        base = (nq >> 3) * kv_chunk + hh * key_tile * 128
        out = hh * key_tile * d * 4 + kc * d * 128
        for part in range(4 // w):
            x = [src[(base + r * 128 + (((nq & 7) ^ (r & 7)) << 4)
                      + 4 * w * part) // 4:][:w]
                 for r in (32 * kc + 8 * j8 + 2 * i + h for i in range(4))]
            for e in range(w):
                row = 4 * nq + w * part + e
                off = out + row * 128 + (((2 * j8 + h) ^ (row & 7)) << 4)
                assert np.isnan(dst[off // 4:off // 4 + 4]).all()
                dst[off // 4:off // 4 + 4] = [x[i][e] for i in range(4)]
    return v, dst


@pytest.mark.parametrize("d,key_tile,heads", [(64, 160, 1), (64, 96, 2),
                                              (32, 128, 1), (128, 64, 2),
                                              (64, 128, 1)])
def test_transpose_writes_every_key_where_p_v_reads_it(d, key_tile, heads):
    """Each k-step j of P.v reads B (N = D dims by 8 keys) K-major from
    v^T at head + (j // 4) chunks of D rows + (j % 4) 32 bytes, rows 128
    bytes apart in 8-row atoms 1024 apart, swizzled: B[n, c] must be v at
    key 8j + PERM[c], dim n, for every head, k-step, dim and column."""
    v, vt = layout_and_transpose(d, key_tile, heads)
    assert not np.isnan(vt).any()
    for hh in range(heads):
        for j in range(key_tile // 8):
            start = hh * key_tile * d * 4 + (j // 4) * d * 128 + (j % 4) * 32
            for n in range(d):
                for c in range(8):
                    b = start + (n // 8) * 1024 + (n % 8) * 128 + c * 4
                    assert vt[swizzle(b) // 4] == v[hh, 8 * j + PERM[c], n]
