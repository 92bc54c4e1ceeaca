"""The hand-written CUDA kernels against their plain versions.

This file imports neither JAX nor the JAX package, so on a machine with a
card it runs without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Tests marked `cuda` skip without a card; the wrapper's argument checks and
the build's missing-compiler error run everywhere.
"""

import ctypes
import shutil
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mvp_pytorch_tpu_torch.models.img_bert import make_seq2seq_mask
from mvp_pytorch_tpu_torch.ops import _kernels
from mvp_pytorch_tpu_torch.ops import attention as attention_mod
from mvp_pytorch_tpu_torch.ops.attention import (_DTYPE_CODE,
                                                 MaskedAttentionFn,
                                                 _attention_grads,
                                                 _kernel_attention,
                                                 _kernel_attention_grads,
                                                 dropout_keep, kernel_bwd_plan,
                                                 kernel_plan, mask_to_bias,
                                                 masked_attention,
                                                 plain_attention,
                                                 plain_attention_blhd)

B, H = 3, 4
# kind -> (batch, Lq, Lk). The first five fit one key tile of both kernels;
# the next five cross tiles (keys past the fp32 kernel's 160-key tile, its
# online softmax over 128-key tiles; queries over two 128-query tiles; one
# batch row; odd lengths: one key past a tile, a single query and key).
SHAPES = {"mask2d": (B, 75, 75), "mask3d": (B, 75, 75),
          "lk_gt_lq": (B, 75, 125), "fully_masked": (B, 75, 75),
          "no_bias": (B, 75, 75), "lk_gt_128": (B, 75, 200),
          "lq_gt_128": (B, 160, 160), "batch1": (1, 125, 125),
          "odd": (B, 17, 129), "single": (B, 1, 1),
          # the bf16 kernel's boundaries: one exact key tile up to 256 keys
          # and the online softmax past it; 64-query blocks (two heads a tile
          # up to 64); a per-query bias broadcast over heads ("q_*": staged
          # once for all heads) and one given per head ("head"), in fp32 and
          # bf16 ("*_bf16")
          "q_lk256": (B, 64, 256), "q_lk257": (B, 64, 257),
          "q_lq64": (B, 64, 92), "q_lq65": (B, 65, 92),
          "q_lq1": (B, 1, 92), "q_lq2": (B, 2, 92), "q_lq16": (B, 16, 92),
          "q_lq17": (B, 17, 92), "q_lq2_bf16": (B, 2, 92),
          "q_lk512": (B, 65, 512), "lk300": (B, 75, 300),
          "head": (B, 90, 90), "head_lq2": (B, 2, 92), "head_bf16": (B, 90, 90),
          # the online softmax's rescale across key tiles: the keys past 256
          # carry +4 of bias on every other query row, so the second tile's
          # row maxima lie clearly above the first's and the first tile's
          # weight must fall by about e^-4; without that rescale the output
          # is about ten times the bf16 tolerance off
          # (test_shift_case_fails_a_kernel_without_the_rescale)
          "q_lk512_shift": (B, 65, 512)}
KINDS = list(SHAPES)


def make_case(kind, d, seed=3):
    """q, k, v [b, H, L, d] and an fp32 bias (or None), as numpy arrays."""
    r = np.random.RandomState(seed)
    b, lq, lk = SHAPES[kind]
    q = r.randn(b, H, lq, d).astype(np.float32)
    k = r.randn(b, H, lk, d).astype(np.float32)
    v = r.randn(b, H, lk, d).astype(np.float32)
    if kind == "fully_masked":
        # multiples of 1/8: q.k is exact in every summation order. Next to
        # the -10000 bias an fp32 score keeps 10 fraction bits, so otherwise
        # two correct orders can round a score to neighbouring values there
        q, k = (np.clip(np.round(x * 8) / 8, -4, 4) for x in (q, k))
    if kind == "no_bias":
        return q, k, v, None
    if kind.startswith("head"):
        mask = (r.rand(b, H, lq, lk) > 0.3).astype(np.float32)
        mask[..., 0] = 1
        return q, k, v, (1.0 - mask) * -10000.0
    if kind in ("mask3d", "lq_gt_128") or kind.startswith("q_"):
        mask = (r.rand(b, lq, lk) > 0.3).astype(np.int32)
        mask[..., 0] = 1
        mask[1, lq // 2] = 0                 # one fully-masked query row
        if kind == "q_lk512_shift":
            # on kept keys only: a masked key stays at exactly -10000, so the
            # fully-masked row stays uniform (next to -10000 an fp32 score
            # keeps 10 fraction bits, see fully_masked)
            bias = mask_to_bias(torch.from_numpy(mask)).numpy()
            bias[:, :, ::2, 256:] += 4.0 * mask[:, None, ::2, 256:]
            return q, k, v, bias
    else:
        mask = np.ones((b, lk), np.int32)
        if b > 1 and lk > 1:
            mask[1, lk - min(30, lk // 2):] = 0  # padded keys
            mask[2, lk - 1:] = 0
        elif lk > 1:
            mask[0, lk - 30:] = 0
        if kind == "fully_masked":
            mask[0] = 0                      # every key of batch row 0
    return q, k, v, mask_to_bias(torch.from_numpy(mask)).numpy()


def bias_tensor(kind, bias, device):
    """The case's bias on the device, bf16 for the `*_bf16` kinds."""
    if bias is None:
        return None
    tb = torch.from_numpy(bias).to(device)
    return tb.to(torch.bfloat16) if kind.endswith("_bf16") else tb


def _bhld_to(layout, x):
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3)) if layout == "blhd" else x


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 0.05)])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("kind", KINDS)
def test_masked_attention_kernel_matches_plain(cuda, kind, layout, dtype,
                                               atol, d):
    q, k, v, bias = make_case(kind, d)
    args = [torch.from_numpy(_bhld_to(layout, x)).to(cuda, dtype)
            for x in (q, k, v)]
    tb = bias_tensor(kind, bias, cuda)
    plain = plain_attention_blhd if layout == "blhd" else plain_attention
    before = masked_attention.launches
    got = masked_attention(*args, tb, layout=layout)
    torch.cuda.synchronize()
    assert masked_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == args[0].shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), plain(*args, tb).float(),
                               atol=atol, rtol=0)


@pytest.mark.cuda
def test_masked_attention_kernel_reads_strided_views(cuda):
    """q, k, v as head views of one fused [B, L, 3, H, D] projection and a
    bf16 bias broadcast over heads and queries."""
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(2, 70, 3, 12, 64, device=cuda, generator=g)
    q, k, v = qkv.to(torch.bfloat16).unbind(2)
    mask = torch.ones(2, 70, dtype=torch.int32, device=cuda)
    mask[1, 50:] = 0
    bias = mask_to_bias(mask).to(torch.bfloat16)
    got = masked_attention(q, k, v, bias, layout="blhd")
    torch.testing.assert_close(got.float(),
                               plain_attention_blhd(q, k, v, bias).float(),
                               atol=0.05, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 0.05)])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("kind", ["mask2d", "mask3d", "lk_gt_lq",
                                  "fully_masked"])
def test_masked_attention_grads_match_plain_autograd(cuda, kind, layout,
                                                     dtype, atol):
    """A CUDA output has the Function's grad_fn (the kernel's output used to
    come back detached), and its q, k, v and bias grads match torch autograd
    through the plain version in fp32 on the same values. The backward
    launches the backward kernel once, and the forward kernel no more."""
    q, k, v, bias = make_case(kind, 64)
    args = [torch.from_numpy(_bhld_to(layout, x)).to(cuda, dtype)
            .requires_grad_() for x in (q, k, v)]
    tb = torch.from_numpy(bias).to(cuda).requires_grad_()
    before = masked_attention.launches
    before_bwd = masked_attention.backward_launches
    out = masked_attention(*args, tb, layout=layout)
    assert isinstance(out.grad_fn, MaskedAttentionFn._backward_cls)
    g = torch.randn(out.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    grads = torch.autograd.grad(out, (*args, tb), g.to(dtype))
    torch.cuda.synchronize()
    assert masked_attention.launches == before + 1
    assert masked_attention.backward_launches == before_bwd + 1
    ref_in = [a.detach().float().requires_grad_() for a in (*args, tb)]
    plain = plain_attention_blhd if layout == "blhd" else plain_attention
    want = torch.autograd.grad(plain(*ref_in), ref_in, g.to(dtype).float())
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), grads, want):
        assert a.dtype == (torch.float32 if name == "dbias" else dtype)
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a.float(), b, atol=atol, rtol=0,
                                   msg=lambda m, n=name: f"{n}: {m}")


def card_seed(value):
    return torch.tensor([value], dtype=torch.int64, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("lk,d,off", [(64, 64, 0), (128, 128, 0),
                                      (200, 64, 0), (200, 64, 128),
                                      (300, 64, 0), (300, 64, 256)],
                         ids=["lk64", "lk128", "lk200-first", "lk200-second",
                              "lk300-first", "lk300-online"])
def test_dropout_mask_reads_back_equal_to_the_plain_hash(cuda, lk, d, off,
                                                         layout, dtype):
    """q = k = 0 gives every key probability 1/Lk; v holds one-hot rows for
    keys off .. off + d, so out[b, h, i, j] > 0 exactly where key off + j of
    row i is kept. Lk 200 is one 256-key tile of the bf16 kernel (the fp32
    kernel's online path, read in both of its 128-key tiles); Lk 300 the
    bf16 kernel's online softmax, read in its second key tile."""
    b, lq, p = 3, 75, 0.1
    n = min(d, lk - off)
    q = torch.zeros(b, H, lq, d, device=cuda, dtype=dtype)
    k = torch.zeros(b, H, lk, d, device=cuda, dtype=dtype)
    v = torch.zeros(b, H, lk, d, device=cuda, dtype=dtype)
    v[:, :, off + torch.arange(n), torch.arange(n)] = 1
    if layout == "blhd":
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    seed = card_seed(-123456789)
    before = masked_attention.dropout_launches
    out = masked_attention(q, k, v, layout=layout, dropout_p=p, seed=seed)
    torch.cuda.synchronize()
    assert masked_attention.dropout_launches == before + 1
    if layout == "blhd":
        out = out.transpose(1, 2)
    want = dropout_keep(seed, p, (b, H, lq, lk))[..., off:off + n]
    assert torch.equal(out[..., :n] > 0, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,grad_atol",
                         [(torch.float32, 2e-5, 1e-4),
                          (torch.bfloat16, 0.05, 0.05)])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("kind", KINDS)
def test_dropout_kernel_matches_plain(cuda, kind, layout, dtype, atol,
                                      grad_atol):
    """The dropout kernel against the plain dropout version on the same
    seed (the kernel's tolerances), and the backward (which regenerates the
    mask) against fp32 autograd of the plain dropout version."""
    q, k, v, bias = make_case(kind, 64)
    args = [torch.from_numpy(_bhld_to(layout, x)).to(cuda, dtype)
            .requires_grad_() for x in (q, k, v)]
    tb = bias_tensor(kind, bias, cuda)
    seed = card_seed(2 ** 40 + 7)
    plain = plain_attention_blhd if layout == "blhd" else plain_attention
    out = masked_attention(*args, tb, layout=layout, dropout_p=0.1, seed=seed)
    want = plain(*(a.detach() for a in args), tb, 0.1, seed)
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=0)
    g = torch.randn(out.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    grads = torch.autograd.grad(out, args, g.to(dtype))
    ref = [a.detach().float().requires_grad_() for a in args]
    want_g = torch.autograd.grad(plain(*ref, tb, 0.1, seed), ref,
                                 g.to(dtype).float())
    for name, a, b in zip(("dq", "dk", "dv"), grads, want_g):
        torch.testing.assert_close(a.float(), b, atol=grad_atol, rtol=0,
                                   msg=lambda m, n=name: f"{n}: {m}")


# the single-stream model's sequence at the pretraining geometry: text 75 +
# tags 20 + regions 50 = 145 (bf16: one 160-key tile; fp32: past the
# 128-key tile, 17 rows and keys in the second tiles)
SINGLE_STREAM_L = 145


def single_stream_case(mask_kind, seed=5):
    """q, k, v [4, H, 145, 64] and the bias of padded keys (text and regions
    padded to random lengths) or of a [B, L, L] mask with a fully-masked
    row, as numpy arrays."""
    r = np.random.RandomState(seed)
    b, l = 4, SINGLE_STREAM_L
    q, k, v = (r.randn(b, H, l, 64).astype(np.float32) for _ in range(3))
    q, k = (np.clip(np.round(x * 8) / 8, -4, 4) for x in (q, k))
    if mask_kind == "mask2d":
        mask = np.zeros((b, l), np.int32)
        for i in range(b):
            mask[i, :r.randint(20, 96)] = 1                # text and tags
            mask[i, 95:95 + r.randint(30, 51)] = 1         # regions
    else:
        mask = (r.rand(b, l, l) > 0.3).astype(np.int32)
        mask[..., 0] = 1
        mask[1, 130] = 0                     # a fully-masked query row
    return q, k, v, mask_to_bias(torch.from_numpy(mask)).numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("dtype,atol,grad_atol",
                         [(torch.float32, 2e-5, 1e-4),
                          (torch.bfloat16, 0.05, 0.05)])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("mask_kind", ["mask2d", "mask3d"])
def test_single_stream_length_matches_plain(cuda, mask_kind, layout, dtype,
                                            atol, grad_atol, p):
    """Lq = Lk = 145 (both kernels: one 160-key tile for a key mask; the fp32
    kernel's online softmax over 128-key tiles for the 3-D mask, whose
    160-key bias tile would not fit beside a stage), with and without
    dropout: the forward against the plain version on the same seed, the
    grads against fp32 autograd of the plain version."""
    q, k, v, bias = single_stream_case(mask_kind)
    args = [torch.from_numpy(_bhld_to(layout, x)).to(cuda, dtype)
            .requires_grad_() for x in (q, k, v)]
    tb = torch.from_numpy(bias).to(cuda)
    seed = card_seed(2 ** 41 + 3) if p else None
    plain = plain_attention_blhd if layout == "blhd" else plain_attention
    before = (masked_attention.launches, masked_attention.dropout_launches)
    out = masked_attention(*args, tb, layout=layout, dropout_p=p, seed=seed)
    torch.cuda.synchronize()
    assert (masked_attention.launches - before[0],
            masked_attention.dropout_launches - before[1]) == (1, int(p > 0))
    want = plain(*(a.detach() for a in args), tb, p, seed)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=0)
    g = torch.randn(out.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    grads = torch.autograd.grad(out, args, g.to(dtype))
    ref = [a.detach().float().requires_grad_() for a in args]
    want_g = torch.autograd.grad(plain(*ref, tb, p, seed), ref,
                                 g.to(dtype).float())
    for name, a, b in zip(("dq", "dk", "dv"), grads, want_g):
        torch.testing.assert_close(a.float(), b, atol=grad_atol, rtol=0,
                                   msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
def test_dropout_mask_at_the_single_stream_length(cuda, layout, dtype):
    """The dropout mask at Lq = Lk = 145 read back bit for bit over all 145
    keys (v one-hot over three windows of 64 keys, one launch each)."""
    b, l, d, p = 4, SINGLE_STREAM_L, 64, 0.1
    q = torch.zeros(b, H, l, d, device=cuda, dtype=dtype)
    seed = card_seed(987654321)
    got = torch.zeros(b, H, l, l, dtype=torch.bool, device=cuda)
    for off in range(0, l, d):
        n = min(d, l - off)
        v = torch.zeros(b, H, l, d, device=cuda, dtype=dtype)
        v[:, :, off + torch.arange(n), torch.arange(n)] = 1
        qkv = (q, q, v)
        if layout == "blhd":
            qkv = tuple(t.transpose(1, 2).contiguous() for t in qkv)
        out = masked_attention(*qkv, layout=layout, dropout_p=p, seed=seed)
        if layout == "blhd":
            out = out.transpose(1, 2)
        got[..., off:off + n] = out[..., :n] > 0
    assert torch.equal(got, dropout_keep(seed, p, (b, H, l, l)))
    assert abs(got.float().mean().item() - (1 - p)) < 0.01


# the captioning geometry (caption 35, tags 20, regions 50; decoding with
# --max_gen_length 20): training at L 105 under the seq2seq mask; the cached
# decode step, whose queries [committed token, [MASK]] see the 20 caption
# slots, the 70 context keys and the 2 fresh keys (Lq 2 / Lk 92), and its
# one-query form (Lq 1 / Lk 91)
CAP_L, CAP_CTX, GEN_L = 35, 70, 20


def seq2seq_case(seed=7):
    """q, k, v [4, H, 105, 64] and the [B, 1, L, L] bias of the captioning
    model's seq2seq mask over contexts padded to random lengths."""
    r = np.random.RandomState(seed)
    b, l = 4, CAP_L + CAP_CTX
    q, k, v = (r.randn(b, H, l, 64).astype(np.float32) for _ in range(3))
    q, k = (np.clip(np.round(x * 8) / 8, -4, 4) for x in (q, k))
    ctx = np.zeros((b, CAP_CTX), np.int32)
    for i in range(b):
        ctx[i, :r.randint(3, 21)] = 1                      # tags
        ctx[i, 20:20 + r.randint(10, 51)] = 1              # regions
    mask = make_seq2seq_mask(CAP_L, torch.from_numpy(ctx))
    return q, k, v, mask_to_bias(mask).numpy()


def decode_case(lq, seed=9):
    """q [4, H, lq, 64], k, v [4, H, 90 + lq, 64] and a per-query bias
    [4, 1, lq, 90 + lq] of the decode step at a random position t per row:
    caption slots before t - 1, the padded context and, among the lq fresh
    keys, the ones at or before each query."""
    r = np.random.RandomState(seed)
    b, lk = 4, GEN_L + CAP_CTX + lq
    q = r.randn(b, H, lq, 64).astype(np.float32)
    k, v = (r.randn(b, H, lk, 64).astype(np.float32) for _ in range(2))
    mask = np.zeros((b, lq, lk), np.int32)
    for i in range(b):
        mask[i, :, :r.randint(0, GEN_L - 1)] = 1           # committed slots
        mask[i, :, GEN_L:GEN_L + r.randint(3, 21)] = 1     # tags
        mask[i, :, GEN_L + 20:GEN_L + 20 + r.randint(10, 51)] = 1
        mask[i, :, GEN_L + CAP_CTX:] = np.tril(np.ones((lq, lq), np.int32))
    return q, k, v, mask_to_bias(torch.from_numpy(mask)).numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("dtype,atol,grad_atol",
                         [(torch.float32, 2e-5, 1e-4),
                          (torch.bfloat16, 0.05, 0.05)])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
def test_captioning_training_length_matches_plain(cuda, layout, dtype, atol,
                                                  grad_atol, p):
    """L 105 under the seq2seq bias, with and without dropout: the forward
    against the plain version on the same seed, the grads against fp32
    autograd of the plain version."""
    q, k, v, bias = seq2seq_case()
    args = [torch.from_numpy(_bhld_to(layout, x)).to(cuda, dtype)
            .requires_grad_() for x in (q, k, v)]
    tb = torch.from_numpy(bias).to(cuda)
    seed = card_seed(2 ** 42 + 5) if p else None
    plain = plain_attention_blhd if layout == "blhd" else plain_attention
    out = masked_attention(*args, tb, layout=layout, dropout_p=p, seed=seed)
    want = plain(*(a.detach() for a in args), tb, p, seed)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=0)
    g = torch.randn(out.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(2))
    grads = torch.autograd.grad(out, args, g.to(dtype))
    ref = [a.detach().float().requires_grad_() for a in args]
    want_g = torch.autograd.grad(plain(*ref, tb, p, seed), ref,
                                 g.to(dtype).float())
    for name, a, b in zip(("dq", "dk", "dv"), grads, want_g):
        torch.testing.assert_close(a.float(), b, atol=grad_atol, rtol=0,
                                   msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 0.05)])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("lq", [2, 1])
def test_decode_step_shapes_match_plain(cuda, lq, layout, dtype, atol):
    """Lq 2 / Lk 92 and Lq 1 / Lk 91 with a per-query bias: one launch,
    against the plain version."""
    q, k, v, bias = decode_case(lq)
    args = [torch.from_numpy(_bhld_to(layout, x)).to(cuda, dtype)
            for x in (q, k, v)]
    tb = torch.from_numpy(bias).to(cuda)
    plain = plain_attention_blhd if layout == "blhd" else plain_attention
    before = masked_attention.launches
    got = masked_attention(*args, tb, layout=layout)
    torch.cuda.synchronize()
    assert masked_attention.launches == before + 1
    assert got.shape == args[0].shape and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), plain(*args, tb).float(),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "last_dim", "shape",
                                 "bias_len"])
def test_kernel_wrapper_rejects_what_the_kernel_cannot_take(bad):
    """The checks run before anything reaches the card."""
    q = torch.zeros(2, 4, 5, 64)
    k = torch.zeros(2, 4, 5, 64)
    bias = torch.zeros(2, 1, 1, 5)
    if bad == "dtype":
        q = k = q.half()
    elif bad == "head_dim":
        q = k = torch.zeros(2, 4, 5, 48)
    elif bad == "last_dim":
        q = torch.zeros(2, 4, 64, 5).transpose(-1, -2)
    elif bad == "shape":
        k = torch.zeros(2, 3, 5, 64)
    else:
        bias = torch.zeros(2, 1, 1, 6)
    with pytest.raises((TypeError, ValueError)):
        _kernel_attention(q, k, k, bias, "bhld")


@pytest.mark.parametrize(
    "bad,dtype,pitch",
    [("pointer", torch.bfloat16, 68), ("stride", torch.bfloat16, 68),
     ("pointer", torch.float32, 65), ("stride", torch.float32, 65)],
    ids=["pointer", "stride", "pointer-fp32", "stride-fp32"])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
def test_kernel_wrapper_rejects_misaligned_bf16(bad, layout, dtype, pitch):
    """Both kernels copy rows in 16-byte pieces: a start address off 16
    bytes, or rows `pitch` elements apart (a stride not a multiple of 8 bf16
    or 4 fp32 elements), raises before anything reaches the card."""
    shape = (2, 5, 4, 64)
    ok = torch.zeros(shape, dtype=dtype)
    if bad == "pointer":
        q = torch.zeros(ok.numel() + 1, dtype=dtype)[1:].view(shape)
    else:
        q = torch.zeros(2, 5, 4, pitch, dtype=dtype)[..., :64]
    with pytest.raises(ValueError, match="aligned"):
        _kernel_attention(q, ok, ok, None, layout)


def test_masked_attention_has_no_silent_fallback():
    x = torch.zeros(1, 2, 3, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        masked_attention(x, x, x)
    with pytest.raises(ValueError, match="layout"):
        masked_attention(x, x, x, layout="lbhd")


def test_build_without_nvcc_raises():
    if shutil.which("nvcc") or torch.cuda.is_available():
        pytest.skip("a CUDA toolkit is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        _kernels.build()


def _online_without_rescale(q, k, v, bias, key_tile):
    """softmax(q.k^T / sqrt(d) + bias).v as an online softmax over key
    tiles that never rescales what earlier tiles accumulated (the fault the
    `q_lk512_shift` case is there to catch), in float64."""
    s = q @ k.transpose(0, 1, 3, 2) / np.sqrt(q.shape[-1]) + bias
    o, l, m = 0.0, 0.0, np.full(s.shape[:-1] + (1,), -np.inf)
    for t in range(0, s.shape[-1], key_tile):
        m = np.maximum(m, s[..., t:t + key_tile].max(-1, keepdims=True))
        e = np.exp(s[..., t:t + key_tile] - m)
        o = o + e @ v[..., t:t + key_tile, :]
        l = l + e.sum(-1, keepdims=True)
    return o / l


@pytest.mark.parametrize("d,key_tile", [(32, 256), (64, 256), (128, 64),
                                        (64, 128)])
def test_shift_case_fails_a_kernel_without_the_rescale(d, key_tile):
    """At `q_lk512_shift`, an online softmax without the cross-tile rescale
    (bf16 key tiles 256, 64 at D 128; the fp32 kernel's 128) is more than
    five times the bf16 tolerance away from the exact output (0.49-0.63 at
    these four)."""
    q, k, v, bias = (x.astype(np.float64) for x in make_case("q_lk512_shift", d))
    s = q @ k.transpose(0, 1, 3, 2) / np.sqrt(d) + bias
    p = np.exp(s - s.max(-1, keepdims=True))
    exact = p / p.sum(-1, keepdims=True) @ v
    assert np.abs(_online_without_rescale(q, k, v, bias, key_tile)
                  - exact).max() > 5 * 0.05


# The bf16 kernel's plan, which the kernel makes itself from the shape and
# the bias strides, read back through `masked_attention_plan` (host code of
# the built library).

@pytest.mark.cuda
@pytest.mark.parametrize("lk,d,want", [
    (1, 64, 32), (32, 64, 32), (33, 64, 64), (70, 64, 96), (75, 64, 96),
    (90, 64, 96), (92, 64, 96), (105, 64, 128), (125, 64, 128),
    (140, 64, 160), (145, 64, 160), (161, 64, 256), (256, 64, 256),
    (257, 64, 256), (512, 32, 256), (64, 128, 64), (65, 128, 64),
    (125, 128, 64)])
def test_kernel_plan_sizes_the_key_tile_to_lk(cuda, lk, d, want):
    """The smallest instantiated key tile that holds Lk (one exact tile);
    past the largest, the largest (the online softmax walks it)."""
    key_tile = kernel_plan(8, lk, 12, d)["key_tile"]
    assert key_tile == want
    assert (key_tile >= lk) == (lk <= (64 if d == 128 else 256))


@pytest.mark.cuda
@pytest.mark.parametrize("lq,h,want", [(1, 12, 2), (2, 12, 2), (16, 12, 2),
                                       (17, 12, 2), (64, 12, 2), (65, 12, 1),
                                       (125, 12, 1), (2, 1, 1)])
def test_kernel_plan_pairs_heads_when_the_queries_fit_one_block(cuda, lq, h,
                                                                want):
    """Two heads a tile (one per warpgroup) up to 64 queries, else one
    head's 128 rows; a single head never pairs."""
    assert kernel_plan(lq, 92, h, 64)["heads"] == want


@pytest.mark.cuda
@pytest.mark.parametrize("strides,want", [
    (None, 0),                     # no bias
    ((125, 0, 0), 0),              # key mask [B, 1, 1, L]
    ((125 * 12, 125, 0), 0),       # key mask per head
    ((8100, 0, 90), 1),            # seq2seq / decode [B, 1, Lq, Lk]
    ((0, 0, 90), 1),               # one per-query bias for every batch row
    ((8100 * 12, 8100, 90), 0)])   # per query and per head
def test_kernel_plan_orders_heads_innermost_for_a_shared_query_bias(
        cuda, strides, want):
    """Heads innermost exactly when the bias is per query and broadcast over
    heads, so consecutive tiles share one staged bias tile."""
    assert kernel_plan(90, 90, 12, 64, strides)["order"] == want


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,want", [
    (1000, 125, 125, 12000),       # rerank: one head's 128 rows a tile
    (16, 70, 70, 192),             # serving B 16
    (250, 2, 92, 1500),            # cached decode: two heads a tile
    (8, 129, 129, 192)])           # Lq 129: two 128-row query tiles
def test_kernel_plan_counts_tiles(cuda, b, lq, lk, want):
    """Tiles: B x ceil(H / heads) x ceil(Lq / (128 / heads))."""
    plan = kernel_plan(lq, lk, 12, 64, b=b)
    assert plan["tiles"] == want
    assert 1 <= plan["stages"] <= 4 and plan["smem_bytes"] <= 232448


class _FakeLib:
    """Stands in for the built library: records what the wrapper passes."""

    def masked_attention_fwd(self, *args):
        self.dims = list((ctypes.c_int64 * 22).from_address(args[5]))
        self.ptrs = args[:5]
        return 0


@pytest.mark.parametrize("bias_kind", ["none", "key", "query", "head"])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
def test_wrapper_passes_the_bias_strides_to_the_kernel(monkeypatch, layout,
                                                       bias_kind):
    """`_kernel_attention` ends dims with the expanded bias's (b, h, l)
    strides, after the strides of q, k, v and out; the kernel picks its plan
    from them."""
    fake = _FakeLib()
    monkeypatch.setattr(_kernels, "library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    b, h, lq, lk, d = 3, 4, 2, 92, 64
    shape = (b, h, lq, d) if layout == "bhld" else (b, lq, h, d)
    kshape = (b, h, lk, d) if layout == "bhld" else (b, lk, h, d)
    q = torch.zeros(shape, dtype=torch.bfloat16)
    k = torch.zeros(kshape, dtype=torch.bfloat16)
    bias = {"none": None, "key": torch.zeros(b, 1, 1, lk),
            "query": torch.zeros(b, 1, lq, lk),
            "head": torch.zeros(b, h, lq, lk)}[bias_kind]
    _kernel_attention(q, k, k, bias, layout)
    assert fake.dims[:7] == [b, h, lq, lk, d, 1, 0]
    assert fake.dims[19:] == (
        [0, 0, 0] if bias is None
        else list(bias.expand(b, h, lq, lk).stride()[:3]))
    assert (fake.ptrs[3] is None) == (bias is None)


def test_wrapper_materialises_a_broadcast_bf16_operand(monkeypatch):
    """TMA steps every dim of extent > 1 by a nonzero stride: a k expanded
    over heads reaches the bf16 kernel as a dense copy."""
    fake = _FakeLib()
    monkeypatch.setattr(_kernels, "library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    q = torch.zeros(2, 4, 5, 64, dtype=torch.bfloat16)
    k = torch.zeros(2, 1, 5, 64, dtype=torch.bfloat16).expand(2, 4, 5, 64)
    _kernel_attention(q, k, k, None, "bhld")
    assert fake.dims[10:13] == [4 * 5 * 64, 5 * 64, 64]   # k's (b, h, l)
    assert fake.ptrs[1] != k.data_ptr()


def test_wrapper_hands_the_bf16_kernel_an_fp32_bias(monkeypatch):
    """The bf16 kernel stages an fp32 bias: a bf16 one is widened (exactly;
    the kernel rounds it to bf16 where the reference does)."""
    fake = _FakeLib()
    monkeypatch.setattr(_kernels, "library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    q = torch.zeros(2, 4, 5, 64, dtype=torch.bfloat16)
    bias = torch.zeros(2, 1, 5, 5, dtype=torch.bfloat16)
    _kernel_attention(q, q, q, bias, "bhld")
    assert fake.dims[6] == 0 and fake.ptrs[3] != bias.data_ptr()


# The fp32 kernel's key tiles (`hopper::f32::choose`): the smallest of 32,
# 64, 96, 128 and 160 (32, 64 at D 128) that holds Lk and fits shared
# memory, else the online softmax over the largest up to 128 that fits.
# Its cases sit on each side of every boundary, for each bias kind, with
# and without dropout, and with one head (Lq 75) or two (Lq 17) a tile.
FP32_BOUNDARIES = ([(64, lk) for lk in (32, 33, 64, 65, 96, 97, 128, 129, 160,
                                        161)]
                   + [(32, 160), (32, 161), (128, 64), (128, 65)])


def fp32_case(d, lq, lk, kind, seed=11):
    """q, k, v [3, H, lq|lk, d] and an fp32 bias: padded keys ("key"), a
    per-query mask broadcast over heads with a fully-masked row ("query")
    or a per-head per-query bias ("head"), as numpy arrays."""
    r = np.random.RandomState(seed + lk)
    q, k, v = (r.randn(3, H, n, d).astype(np.float32) for n in (lq, lk, lk))
    if kind == "key":
        mask = np.ones((3, lk), np.int32)
        mask[1, lk - min(30, lk // 2):] = 0
        mask[2, lk - 1:] = 0
    elif kind == "query":
        mask = (r.rand(3, lq, lk) > 0.3).astype(np.int32)
        mask[..., 0] = 1
    else:
        mask = (r.rand(3, H, lq, lk) > 0.3).astype(np.float32)
        mask[..., 0] = 1
        return q, k, v, (1.0 - mask) * -10000.0
    return q, k, v, mask_to_bias(torch.from_numpy(mask)).numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("kind", ["key", "query", "head"])
@pytest.mark.parametrize("lq", [75, 17])
@pytest.mark.parametrize("d,lk", FP32_BOUNDARIES)
def test_fp32_kernel_at_every_key_tile_boundary(cuda, d, lk, lq, kind, layout,
                                                p):
    """The fp32 kernel against the plain version (2e-5) on each side of each
    key-tile boundary of its plan, and the plan's key tile: one exact tile
    when it holds Lk, else 128 keys or fewer."""
    q, k, v, bias = fp32_case(d, lq, lk, kind)
    args = [torch.from_numpy(_bhld_to(layout, x)).to(cuda) for x in (q, k, v)]
    tb = torch.from_numpy(bias).to(cuda)
    seed = card_seed(2 ** 43 + lk) if p else None
    plain = plain_attention_blhd if layout == "blhd" else plain_attention
    got = masked_attention(*args, tb, layout=layout, dropout_p=p, seed=seed)
    want = plain(*args, tb, p, seed)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    plan = kernel_plan(lq, lk, H, d, tb.expand(3, H, lq, lk).stride()[:3],
                       b=3, dtype=torch.float32)
    assert plan["key_tile"] >= lk or plan["key_tile"] <= 128
    assert plan["smem_bytes"] <= 232448 and plan["stages"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("lk,d,want", [
    (1, 64, 32), (32, 64, 32), (33, 64, 64), (70, 64, 96), (75, 64, 96),
    (92, 64, 96), (105, 64, 128), (125, 64, 128), (140, 64, 160),
    (145, 64, 160), (160, 64, 160), (161, 64, 128), (512, 64, 128),
    (160, 32, 160), (300, 32, 128), (64, 128, 64), (65, 128, 64),
    (125, 128, 64)])
def test_fp32_kernel_plan_sizes_the_key_tile_to_lk(cuda, lk, d, want):
    """Under a key mask every width fits: the smallest that holds Lk, past
    160 keys the online softmax over 128 (64 at D 128)."""
    assert kernel_plan(75, lk, 12, d, (lk, 0, 0), b=8,
                       dtype=torch.float32)["key_tile"] == want


@pytest.mark.cuda
@pytest.mark.parametrize("strides,lk,want", [
    ((140 * 140, 0, 140), 140, 160),      # NLVR-length seq2seq: fits
    ((145 * 145, 0, 145), 145, 128),      # a 160-key bias tile does not
    ((90 * 90, 0, 90), 90, 96)])          # CBS, SCST
def test_fp32_kernel_plan_fits_a_per_query_bias(cuda, strides, lk, want):
    """A per-query bias broadcast over heads is staged in shared memory
    beside q, a k/v stage and the split buffer: the widest key tile is the
    one whose plan fits 227 KB."""
    plan = kernel_plan(lk, lk, 12, 64, strides, b=8, dtype=torch.float32)
    assert plan["key_tile"] == want and plan["order"] == 1
    assert plan["smem_bytes"] <= 232448


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,want", [
    (1000, 125, 125, 12000),       # rerank: one head's 128 rows a tile
    (32, 140, 140, 768),           # NLVR B 32: two 128-row query tiles
    (250, 2, 92, 1500),            # two heads a tile at Lq <= 64
    (96, 145, 145, 2304)])         # single-stream B 96
def test_fp32_kernel_plan_counts_tiles(cuda, b, lq, lk, want):
    """Tiles: B x ceil(H / heads) x ceil(Lq / (128 / heads)), as the bf16
    kernel's."""
    plan = kernel_plan(lq, lk, 12, 64, b=b, dtype=torch.float32)
    assert plan["tiles"] == want
    assert 1 <= plan["stages"] <= 4 and plan["smem_bytes"] <= 232448


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
def test_wrapper_materialises_a_broadcast_fp32_operand(monkeypatch, layout):
    """The fp32 kernel reads q, k and v by TMA too: a k expanded over heads
    reaches it as a dense copy, and a bf16 bias as an fp32 one."""
    fake = _FakeLib()
    monkeypatch.setattr(_kernels, "library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    q = torch.zeros(2, 4, 5, 64)
    k = torch.zeros(2, 1, 5, 64).expand(2, 4, 5, 64)
    if layout == "blhd":
        q, k = q.transpose(1, 2), k.transpose(1, 2)
    bias = torch.zeros(2, 1, 5, 5, dtype=torch.bfloat16)
    _kernel_attention(q, k, k, bias, layout)
    assert fake.dims[5:7] == [0, 0]                      # fp32 q, fp32 bias
    assert 0 not in fake.dims[10:13]                     # k's (b, h, l)
    assert fake.ptrs[1] != k.data_ptr() and fake.ptrs[3] != bias.data_ptr()


# The backward kernel (`masked_attention_bwd`) against the plain recompute
# (`_attention_grads`) on the same card and inputs. Cases: (bias kind, B,
# Lq, Lk, D). The training lengths (two-stream 125 / 75 / 70, single-stream
# 145, NLVR2 140, captioning 105 under its seq2seq bias, fine-tuning 40),
# the other head dims, keys past one key tile (257, 300: the two-pass
# path), one batch row and odd lengths. Every kind with a mask has a
# fully-masked row ("key": batch row 0; "query", "seq2seq": one query row).
BWD_CASES = {
    "two_stream_fused": ("key", 3, 125, 125, 64),
    "two_stream_text": ("key", 3, 75, 75, 64),
    "two_stream_vision": ("key", 3, 70, 70, 64),
    "single_stream": ("key", 2, 145, 145, 64),
    "single_stream_mask3d": ("query", 2, 145, 145, 64),
    "nlvr_fused": ("key", 2, 140, 140, 64),
    "captioning": ("seq2seq", 2, 105, 105, 64),
    "finetune_text": ("key", 3, 40, 40, 64),
    "per_head": ("head", 3, 90, 90, 64),
    "no_bias": ("none", 3, 75, 75, 64),
    "d32": ("key", 3, 75, 75, 32),
    "d32_mask3d": ("query", 2, 145, 145, 32),
    "d128": ("key", 2, 125, 125, 128),
    "d128_mask3d": ("query", 2, 70, 70, 128),
    "lk257": ("key", 2, 75, 257, 64),
    "lk300_mask3d": ("query", 2, 65, 300, 64),
    "lk300_d128_head": ("head", 2, 40, 300, 128),
    "lk257_d32": ("key", 2, 17, 257, 32),
    "batch1": ("key", 1, 125, 125, 64),
    "odd": ("query", 3, 17, 129, 64),
    "single": ("key", 2, 1, 1, 64),
}


def bwd_case(name, layout, dtype, device, seed=13):
    """q, k, v, the output's grad (in `layout`, `dtype`) and an fp32 bias
    (or None) of BWD_CASES[name], on `device`."""
    kind, b, lq, lk, d = BWD_CASES[name]
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(b, H, n, d).astype(np.float32) for n in (lq, lk, lk))
    g = r.randn(b, H, lq, d).astype(np.float32)
    # multiples of 1/8: q.k is exact in every summation order. Next to the
    # -10000 bias of a fully-masked row an fp32 score keeps 10 fraction bits,
    # so two correct orders could otherwise round it to neighbouring values
    q, k = (np.clip(np.round(x * 8) / 8, -4, 4) for x in (q, k))
    bias = None
    if kind == "key":
        mask = np.ones((b, lk), np.int32)
        if b > 1:
            mask[0] = 0                          # a fully-masked batch row
            mask[1, lk - min(30, lk // 2):] = 0  # padded keys
    elif kind == "query":
        mask = (r.rand(b, lq, lk) > 0.3).astype(np.int32)
        mask[..., 0] = 1
        mask[0, lq // 2] = 0                     # a fully-masked query row
    elif kind == "seq2seq":
        ctx = np.zeros((b, CAP_CTX), np.int32)
        for i in range(b):
            ctx[i, :r.randint(3, 21)] = 1
            ctx[i, 20:20 + r.randint(10, 51)] = 1
        mask = make_seq2seq_mask(CAP_L, torch.from_numpy(ctx)).numpy()
    elif kind == "head":
        bias = r.randn(b, H, lq, lk).astype(np.float32)
    if kind in ("key", "query", "seq2seq"):
        bias = mask_to_bias(torch.from_numpy(mask)).numpy()
    x = [torch.from_numpy(_bhld_to(layout, t)).to(device, dtype)
         for t in (q, k, v, g)]
    return (*x, None if bias is None else torch.from_numpy(bias).to(device))


def rel_err(got, want):
    """Norm of the difference over the norm of `want`, in fp32 (a `want` of
    all zeros, as dq and dk over a single key, asks for zeros)."""
    got, want = got.float(), want.float()
    tiny = torch.finfo(torch.float32).tiny
    return ((got - want).norm() / want.norm().clamp_min(tiny)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 4e-3)])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("name", list(BWD_CASES))
def test_backward_kernel_matches_the_plain_recompute(cuda, name, layout, dtype,
                                                     tol, p):
    """dq, dk, dv and dbias of the kernel against `_attention_grads` on the
    same card, inputs and seed, relative in the norm of each gradient.
    fp32 1e-5: both compute the same fp32 function; the kernel's products
    split each fp32 operand into three bf16 terms (a product's dropped terms
    lie 2^-24 below it) and sum in another order, and its exponential is
    within a few ulps (the card's measured worst, 2.3e-6). bf16 4e-3: about
    one bf16 rounding of the outputs (2^-8), since both round the same fp32
    values to bf16 and may round a value near a tie to neighbours (measured
    worst 2.5e-4)."""
    q, k, v, g, bias = bwd_case(name, layout, dtype, cuda)
    seed = card_seed(2 ** 43 + 11) if p else None
    before = masked_attention.launches
    got = _kernel_attention_grads(q, k, v, bias, g, layout, bias is not None,
                                  p, seed)
    want = _attention_grads(q, k, v, bias, g, layout, bias is not None, p,
                            seed)
    torch.cuda.synchronize()
    assert masked_attention.launches == before
    for gname, a, b, t in zip(("dq", "dk", "dv", "dbias"), got, want,
                              (q, k, v, bias)):
        if t is None:
            assert a is None and b is None
            continue
        assert a.dtype == t.dtype and a.shape == t.shape, gname
        assert torch.isfinite(a.float()).all(), gname
        assert rel_err(a, b) <= tol, (gname, rel_err(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_launches_the_kernel_once_a_call(cuda, monkeypatch, dtype):
    """Through autograd a CUDA call's backward launches `masked_attention_bwd`
    once (`masked_attention.backward_launches`) and never runs the plain
    recompute."""
    def refuse(*a, **kw):
        raise AssertionError("the plain recompute ran on a CUDA tensor")
    monkeypatch.setattr(attention_mod, "_attention_grads", refuse)
    q, k, v, g, bias = bwd_case("two_stream_text", "blhd", dtype, cuda)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    before = (masked_attention.launches, masked_attention.backward_launches)
    out = masked_attention(*leaves, bias, layout="blhd", dropout_p=0.1,
                           seed=card_seed(5))
    torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (masked_attention.launches - before[0],
            masked_attention.backward_launches - before[1]) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("lk,d,dtype,want", [
    (40, 64, torch.bfloat16, (64, 1, 0)), (70, 64, torch.bfloat16, (96, 1, 0)),
    (125, 64, torch.bfloat16, (128, 1, 0)),
    (145, 64, torch.bfloat16, (160, 1, 0)),
    (257, 64, torch.bfloat16, (128, 3, 1)),
    (125, 128, torch.bfloat16, (128, 1, 0)),
    (145, 128, torch.bfloat16, (128, 2, 1)),
    (64, 64, torch.float32, (64, 1, 0)), (125, 64, torch.float32, (64, 2, 1))])
def test_backward_plan_sizes_the_key_tile_to_lk(cuda, lk, d, dtype, want):
    """The smallest instantiated key tile that holds Lk (one pass); past
    it fp32 walks its largest twice and bf16 takes the key-outer launches
    over 128-key tiles. Every plan fits shared memory; dk and dv's sums sit
    there at the two-stream training shapes; the key-outer scratch holds
    the statistics (3 x 64 floats a query block) and dq's slices (one a key
    tile in the D 128 tile, else one a 64 keys)."""
    plan = kernel_bwd_plan(lk, lk, 12, d, 96, dtype)
    assert (plan["key_tile"], plan["key_tiles"], plan["multi"]) == want
    assert plan["smem_bytes"] <= 232448
    assert (plan["scratch_floats"] == 0) == bool(plan["acc_smem"])
    if dtype == torch.bfloat16 and d == 64 and lk <= 160:
        assert plan["acc_smem"] == 1
    outer = int(dtype == torch.bfloat16 and plan["multi"] == 1)
    assert plan["key_outer"] == outer
    if outer:
        slices = plan["key_tiles"] * (1 if plan["head_tile"] == 128 else 2)
        stats = 96 * 12 * -(-lk // 64) * 192
        assert (plan["stats_floats"], plan["dq_slices"]) == (stats, slices)
        assert plan["scratch_floats"] == stats + slices * 96 * 12 * lk * d
    else:
        assert (plan["stats_floats"], plan["dq_slices"]) == (0, 0)


class _FakeBwdLib:
    """Stands in for the built library's backward entry points: records what
    the wrapper passes, and plans `scratch` floats (on the key-outer path
    when `key_outer`)."""

    def __init__(self, scratch=0, key_outer=0):
        self.scratch = scratch
        self.key_outer = key_outer

    def masked_attention_bwd_plan(self, dims, out):
        plan = (ctypes.c_int64 * 8).from_address(out)
        plan[:] = [128, 1, 0, int(self.scratch == 0), 1024, self.scratch, 64,
                   self.key_outer]
        return 0

    def masked_attention_bwd(self, *args):
        self.dims = list((ctypes.c_int64 * 31).from_address(args[10]))
        self.ptrs = args[:10]
        self.seed, self.threshold, self.scale = args[12:]
        return 0


def _fake_bwd(monkeypatch, scratch=0, key_outer=0):
    fake = _FakeBwdLib(scratch, key_outer)
    monkeypatch.setattr(_kernels, "library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    return fake


@pytest.mark.parametrize("key_outer", [0, 1])
def test_backward_wrapper_counts_the_key_outer_calls(monkeypatch, key_outer):
    """A call whose plan takes the key-outer launches adds one to
    `masked_attention.backward_key_outer` and hands the kernel a workspace
    of the plan's scratch floats; any other call leaves the counter."""
    fake = _fake_bwd(monkeypatch, scratch=4096 * key_outer,
                     key_outer=key_outer)
    q = torch.zeros(2, 4, 5, 64, dtype=torch.bfloat16)
    before = masked_attention.backward_key_outer
    _kernel_attention_grads(q, q, q, None, q, "bhld", False)
    assert masked_attention.backward_key_outer - before == key_outer
    assert (fake.ptrs[9] is not None) == bool(key_outer)


@pytest.mark.parametrize("bias_kind", ["none", "key", "query", "head"])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
def test_backward_wrapper_passes_dims_strides_and_pointers(monkeypatch,
                                                           layout, bias_kind):
    """`_kernel_attention_grads` passes B, H, Lq, Lk, D, the dtype, then the
    (b, h, l) strides of q, k, v, the grad, dq, dk, dv and the expanded
    bias; the outputs in the inputs' dtype and layout; a dbias buffer
    [B, H, Lq, Lk] fp32 only when the bias's grad is asked for, summed back
    to the bias's shape."""
    fake = _fake_bwd(monkeypatch)
    b, h, lq, lk, d = 3, 4, 2, 92, 64
    shape = (b, h, lq, d) if layout == "bhld" else (b, lq, h, d)
    kshape = (b, h, lk, d) if layout == "bhld" else (b, lk, h, d)
    q = torch.zeros(shape, dtype=torch.bfloat16)
    k = torch.zeros(kshape, dtype=torch.bfloat16)
    bias = {"none": None, "key": torch.zeros(b, 1, 1, lk),
            "query": torch.zeros(b, 1, lq, lk),
            "head": torch.zeros(b, h, lq, lk)}[bias_kind]
    dq, dk, dv, dbias = _kernel_attention_grads(q, k, k, bias, q, layout,
                                                bias is not None)
    assert fake.dims[:7] == [b, h, lq, lk, d, 1, 0]
    view = (lambda t: t.transpose(1, 2)) if layout == "blhd" else (lambda t: t)
    for i, t in enumerate((q, k, k, q, dq, dk, dv)):
        assert fake.dims[7 + 3 * i:10 + 3 * i] == list(view(t).stride()[:3])
    assert fake.dims[28:] == (
        [0, 0, 0] if bias is None
        else list(bias.expand(b, h, lq, lk).stride()[:3]))
    assert (fake.ptrs[4] is None) == (bias is None)
    assert (fake.ptrs[8] is None) == (bias is None)
    assert fake.ptrs[9] is None                 # no scratch planned
    assert fake.seed is None
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    if bias is not None:
        assert dbias.shape == bias.shape and dbias.dtype == bias.dtype


def test_backward_wrapper_hands_over_the_seed_and_the_scratch(monkeypatch):
    """With dropout the seed's pointer, round(p 2^32) and 1 / (1 - p); a
    scratch buffer of the planned floats when dk and dv's sums do not fit
    shared memory; a bf16 bias widened to fp32."""
    fake = _fake_bwd(monkeypatch, scratch=4096)
    q = torch.zeros(2, 4, 5, 128)
    seed = torch.tensor([7], dtype=torch.int64)
    bias = torch.zeros(2, 1, 1, 5, dtype=torch.bfloat16)
    _kernel_attention_grads(q, q, q, bias, q, "bhld", False, 0.1, seed)
    assert fake.dims[4:7] == [128, 0, 0]
    assert fake.seed == seed.data_ptr()
    assert fake.threshold == round(0.1 * 2 ** 32)
    assert fake.scale == pytest.approx(1 / 0.9)
    assert fake.ptrs[9] is not None and fake.ptrs[8] is None
    assert fake.ptrs[4] != bias.data_ptr()


def test_backward_wrapper_materialises_a_broadcast_grad(monkeypatch):
    """TMA steps every dim of extent > 1 by a nonzero stride: the grad of a
    summed output (ones expanded over every dim) reaches the kernel as a
    dense copy."""
    fake = _fake_bwd(monkeypatch)
    q = torch.zeros(2, 4, 5, 64, dtype=torch.bfloat16)
    g = torch.ones((), dtype=torch.bfloat16).expand(2, 4, 5, 64)
    _kernel_attention_grads(q, q, q, None, g, "bhld", False)
    assert fake.dims[16:19] == [4 * 5 * 64, 5 * 64, 64]   # the grad's strides
    assert fake.ptrs[3] != g.data_ptr()


@pytest.mark.parametrize("bad", ["dtype", "grad_dtype", "head_dim", "shape",
                                 "grad_shape", "bias_len"])
def test_backward_wrapper_rejects_what_the_kernel_cannot_take(monkeypatch,
                                                              bad):
    """The checks run before anything reaches the card."""
    _fake_bwd(monkeypatch)
    q = torch.zeros(2, 4, 5, 64)
    k = torch.zeros(2, 4, 5, 64)
    g = torch.zeros(2, 4, 5, 64)
    bias = torch.zeros(2, 1, 1, 5)
    if bad == "dtype":
        q = k = q.half()
    elif bad == "grad_dtype":
        g = g.bfloat16()
    elif bad == "head_dim":
        q = k = g = torch.zeros(2, 4, 5, 48)
    elif bad == "shape":
        k = torch.zeros(2, 3, 5, 64)
    elif bad == "grad_shape":
        g = torch.zeros(2, 4, 6, 64)
    else:
        bias = torch.zeros(2, 1, 1, 6)
    with pytest.raises((TypeError, ValueError)):
        _kernel_attention_grads(q, k, k, bias, g, "bhld", True)


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_cpu_backward_runs_the_plain_recompute(monkeypatch, p):
    """A CPU tensor's backward takes `_attention_grads` (once a call) and
    never the kernel; `masked_attention.backward_launches` does not move."""
    calls = []
    plain = attention_mod._attention_grads

    def spy(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    def no_kernel(*a, **kw):
        raise AssertionError("the kernel wrapper ran on a CPU tensor")
    monkeypatch.setattr(attention_mod, "_attention_grads", spy)
    monkeypatch.setattr(attention_mod, "_kernel_attention_grads", no_kernel)
    q, k, v, g, bias = bwd_case("two_stream_text", "blhd", torch.float32,
                                "cpu")
    leaves = [t.requires_grad_() for t in (q, k, v)]
    seed = torch.tensor([3], dtype=torch.int64) if p else None
    before = masked_attention.backward_launches
    out = masked_attention(*leaves, bias, layout="blhd", dropout_p=p,
                           seed=seed)
    grads = torch.autograd.grad(out, leaves, g)
    assert calls == [1]
    assert masked_attention.backward_launches == before
    assert all(torch.isfinite(t).all() for t in grads)


@pytest.mark.cuda
def test_backward_kernel_time_falls_inside_a_range_around_the_backward(cuda):
    """A `record_function` range opened around `MaskedAttentionFn.backward`
    (as the benchmark's `bench.attn_bwd` is) holds the backward kernel's
    device time: the launch runs under an operator record inside the range,
    not straight under the autograd node that encloses it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    q, k, v, g, bias = bwd_case("two_stream_text", "blhd", torch.bfloat16,
                                cuda)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = masked_attention(*leaves, bias, layout="blhd")
    backward = MaskedAttentionFn.backward

    def ranged(ctx, grad):
        with record_function("test.attn_bwd"):
            return backward(ctx, grad)
    MaskedAttentionFn.backward = staticmethod(ranged)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(out, leaves, g)
            torch.cuda.synchronize()
    finally:
        MaskedAttentionFn.backward = staticmethod(backward)
    ranges = [e for e in prof.events() if e.name == "test.attn_bwd"
              and e.device_type == torch.autograd.DeviceType.CPU]
    assert ranges and all(e.device_time_total > 0 for e in ranges)


# SigLIP's attention: head dim 72 in the kernels' D 128 tile (columns past 72
# zero-filled on load, skipped on store). The vision tower's Lq = Lk = 729
# (key tiles walked by the online softmax forward and in two passes
# backward), the MAP probe's one query over 729 keys, the text's 64; with no
# bias (SigLIP's) and with a key-mask bias.
D72_SHAPES = {"vision": (2, 729, 729), "map_probe": (2, 1, 729),
              "text": (2, 64, 64)}


def d72_case(shape, bias_kind, layout, dtype, device, seed=21):
    """q, k, v and the output's grad (in `layout`, `dtype`) and an fp32
    key-mask bias (or None) at head dim 72, on `device`."""
    b, lq, lk = D72_SHAPES[shape]
    r = np.random.RandomState(seed + lq)
    q, k, v = (r.randn(b, H, n, 72).astype(np.float32) for n in (lq, lk, lk))
    g = r.randn(b, H, lq, 72).astype(np.float32)
    x = [torch.from_numpy(_bhld_to(layout, t)).to(device, dtype)
         for t in (q, k, v, g)]
    bias = None
    if bias_kind == "key":
        mask = np.ones((b, lk), np.int32)
        mask[1, lk - lk // 3:] = 0
        bias = mask_to_bias(torch.from_numpy(mask)).to(device)
    return (*x, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("bias_kind", ["none", "key"])
@pytest.mark.parametrize("dtype,atol,rel", [(torch.float32, 2e-5, 1e-4),
                                            (torch.bfloat16, 0.05, 1e-2)])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("shape", list(D72_SHAPES))
def test_d72_forward_matches_plain(cuda, shape, layout, dtype, atol, rel,
                                   bias_kind):
    """The forward kernel at head dim 72 against the plain version on the
    same card: within the other head dims' absolute tolerances (fp32 2e-5,
    bf16 0.05), and within `rel` of the plain output's norm. At Lk 729 an
    output element's std is about sqrt(e / 729) = 0.06, as large as bf16's
    0.05, so a kernel that mishandled the 25-key tail tile (729 = 11 x 64 +
    25) could pass the absolute check alone; the relative one allows bf16
    about two roundings (the kernel's output and the plain version's, each
    2^-9 at most) and fp32 the 3xTF32 products."""
    q, k, v, _, bias = d72_case(shape, bias_kind, layout, dtype, cuda)
    plain = plain_attention_blhd if layout == "blhd" else plain_attention
    before = masked_attention.launches
    got = masked_attention(q, k, v, bias, layout=layout)
    torch.cuda.synchronize()
    assert masked_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    want = plain(q, k, v, bias)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert rel_err(got, want) <= rel, rel_err(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bias_kind", ["none", "key"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 4e-3)])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("shape", list(D72_SHAPES))
def test_d72_backward_matches_the_plain_recompute(cuda, shape, layout, dtype,
                                                  tol, bias_kind):
    """dq, dk, dv (and dbias) of the backward kernel at head dim 72 against
    `_attention_grads` on the same card, relative in each gradient's norm,
    with the tolerances of test_backward_kernel_matches_the_plain_recompute
    (fp32 1e-5: the same fp32 function summed in another order; bf16 4e-3:
    about one bf16 rounding of the outputs)."""
    q, k, v, g, bias = d72_case(shape, bias_kind, layout, dtype, cuda)
    has = bias is not None
    got = _kernel_attention_grads(q, k, v, bias, g, layout, has)
    want = _attention_grads(q, k, v, bias, g, layout, has)
    torch.cuda.synchronize()
    for gname, a, b, t in zip(("dq", "dk", "dv", "dbias"), got, want,
                              (q, k, v, bias)):
        if t is None:
            assert a is None and b is None
            continue
        assert a.dtype == t.dtype and a.shape == t.shape, gname
        assert torch.isfinite(a.float()).all(), gname
        assert rel_err(a, b) <= tol, (gname, rel_err(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d72_autograd_launches_each_kernel_once(cuda, dtype):
    """Through autograd a D 72 call launches the forward kernel once and the
    backward kernel once, as SigLIP's training step does at every layer."""
    q, k, v, g, _ = d72_case("text", "none", "blhd", dtype, cuda)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    before = (masked_attention.launches, masked_attention.backward_launches)
    out = masked_attention(*leaves, None, layout="blhd")
    torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (masked_attention.launches - before[0],
            masked_attention.backward_launches - before[1]) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk", [(729, 729), (1, 729), (64, 64)])
def test_d72_plans_report_the_padded_tile(cuda, dtype, lq, lk):
    """Both plans give D 72 the D 128 tile and its key tiles (forward: 64
    keys at most, 32 where fp32's 64 does not fit shared memory, online past
    them; backward: 64, else fp32's 64 walked twice and bf16's key-outer
    launches over 128-key tiles); the D 64 plans keep their own width. The
    backward's fp32 sums take 72 columns, not the tile's 128: dk, dv's
    2 x 64 x 72 floats a 64-key subtile of each key tile (in shared memory
    where they fit, else in a scratch buffer of that size), and the
    key-outer path's dq slices 72 floats a query row."""
    fwd = kernel_plan(lq, lk, 16, 72, dtype=dtype, b=48)
    bwd = kernel_bwd_plan(lq, lk, 16, 72, 48, dtype)
    assert fwd["head_tile"] == bwd["head_tile"] == 128
    assert fwd["key_tile"] <= 64
    assert fwd == dict(kernel_plan(lq, lk, 16, 128, dtype=dtype, b=48))
    wide = kernel_bwd_plan(lq, lk, 16, 128, 48, dtype)
    for key in ("key_tile", "key_tiles", "multi", "head_tile", "key_outer",
                "stats_floats", "dq_slices"):
        assert bwd[key] == wide[key], key
    assert bwd["key_outer"] == int(dtype == torch.bfloat16 and lk > 128)
    if bwd["key_outer"]:
        rows = 48 * 16 * lq * bwd["dq_slices"]
        assert bwd["scratch_floats"] == bwd["stats_floats"] + rows * 72
        assert wide["scratch_floats"] == wide["stats_floats"] + rows * 128
    else:
        subtiles = bwd["key_tiles"] * -(-bwd["key_tile"] // 64)
        sums = 48 * 16 * 2 * subtiles * 64 * 72
        assert bwd["scratch_floats"] == (0 if bwd["acc_smem"] else sums)
        assert wide["scratch_floats"] in (0, sums * 128 // 72)
    assert kernel_plan(lq, lk, 16, 64, dtype=dtype, b=48)["head_tile"] == 64
    assert bwd["multi"] == int(lk > bwd["key_tile"])


# which calls take the key-outer launches: bf16 past one key tile (SigLIP's
# vision tower and MAP probe, D 64 and D 32 over 257 keys), and no call
# that one key tile holds (SigLIP's text, the two-stream and single-stream
# training lengths)
KEY_OUTER_CASES = {"vision": 1, "map_probe": 1, "text": 0, "lk257": 1,
                   "lk257_d32": 1, "two_stream_fused": 0, "two_stream_text": 0,
                   "two_stream_vision": 0, "single_stream": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(KEY_OUTER_CASES))
def test_backward_key_outer_runs_past_one_bf16_key_tile(cuda, name):
    """Through autograd a bf16 call's backward takes the key-outer launches
    (`masked_attention.backward_key_outer` once) exactly when its plan says
    so, which is when Lk passes one key tile; its plan's workspace is the
    statistics of every 64-row query block and dq's slices."""
    if name in D72_SHAPES:
        q, k, v, g, bias = d72_case(name, "none", "blhd", torch.bfloat16,
                                    cuda)
    else:
        q, k, v, g, bias = bwd_case(name, "blhd", torch.bfloat16, cuda)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    plan = kernel_bwd_plan(lq, lk, h, d, b, torch.bfloat16)
    want = KEY_OUTER_CASES[name]
    assert plan["key_outer"] == want == plan["multi"]
    assert plan["stats_floats"] == want * b * h * -(-lq // 64) * 192
    assert plan["dq_slices"] == want * plan["key_tiles"] * (
        1 if plan["head_tile"] == 128 else 2)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    before = (masked_attention.backward_launches,
              masked_attention.backward_key_outer)
    out = masked_attention(*leaves, bias, layout="blhd")
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (masked_attention.backward_launches - before[0],
            masked_attention.backward_key_outer - before[1]) == (1, want)
    assert all(torch.isfinite(t.float()).all() for t in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("name,p", [("vision", 0.0), ("lk257", 0.1)])
def test_backward_key_outer_repeats_bit_for_bit(cuda, name, p):
    """Two calls on the same inputs give the same bits of dq, dk and dv:
    the key-outer path sums dq's slices in a fixed order and uses no
    floating-point atomics."""
    if name in D72_SHAPES:
        q, k, v, g, bias = d72_case(name, "none", "bhld", torch.bfloat16,
                                    cuda)
    else:
        q, k, v, g, bias = bwd_case(name, "bhld", torch.bfloat16, cuda)
    seed = card_seed(2 ** 41 + 3) if p else None
    before = masked_attention.backward_key_outer
    first = _kernel_attention_grads(q, k, v, bias, g, "bhld", False, p, seed)
    second = _kernel_attention_grads(q, k, v, bias, g, "bhld", False, p, seed)
    torch.cuda.synchronize()
    assert masked_attention.backward_key_outer - before == 2
    for gname, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), gname


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", [("two_stream_text", torch.bfloat16),
                                        ("two_stream_text", torch.float32),
                                        ("vision", torch.bfloat16)])
def test_kernels_run_from_a_thread_without_a_context(cuda, name, dtype):
    """The forward and the backward launched from a host thread with no
    current CUDA context (a plain `threading.Thread` that has only taken
    PyTorch's cached memory has none) give the main thread's bits: the
    kernels' tensor-map encoding is a driver call on the thread's current
    context, and the launchers bind the device's primary context first."""
    if name in D72_SHAPES:
        q, k, v, g, bias = d72_case(name, "none", "blhd", dtype, cuda)
    else:
        q, k, v, g, bias = bwd_case(name, "blhd", dtype, cuda)
    def run():
        out = masked_attention(q, k, v, bias, layout="blhd")
        return (out, *_kernel_attention_grads(q, k, v, bias, g, "blhd",
                                              False)[:3])
    want = run()
    torch.cuda.synchronize()
    driver = ctypes.CDLL("libcuda.so.1")
    got = {}

    def work():
        current = ctypes.c_void_p()
        try:
            driver.cuCtxSetCurrent(ctypes.c_void_p(None))
            driver.cuCtxGetCurrent(ctypes.byref(current))
            got["unbound"] = current.value is None
            got["out"] = run()
            torch.cuda.synchronize()
        except Exception as e:   # re-raised below, on the test's thread
            got["error"] = e

    thread = threading.Thread(target=work)
    thread.start()
    thread.join()
    if "error" in got:
        raise got["error"]
    assert got["unbound"]
    for gname, a, b in zip(("out", "dq", "dk", "dv"), got["out"], want):
        assert torch.equal(a, b), gname


def test_head_dim_72_is_dispatched_without_dropout():
    """D 72 is one of the kernels' head dims, and one without a dropout
    instantiation: a call with dropout raises before anything runs, on
    either device."""
    assert 72 in attention_mod.HEAD_DIMS
    assert attention_mod.NO_DROPOUT_DIMS == (72,)
    x = torch.zeros(1, 3, 2, 72)
    with pytest.raises(ValueError, match="head dim 72 has no dropout"):
        masked_attention(x, x, x, dropout_p=0.1,
                         seed=torch.zeros(1, dtype=torch.int64))
    out = masked_attention(x, x, x)          # the plain version, no dropout
    assert out.shape == x.shape


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_hands_d72_rows_to_the_kernels_unpadded(monkeypatch, layout,
                                                        dtype):
    """The wrappers pass D 72 and the tensors' own (b, h, l) strides (rows of
    144 bytes in bf16, 288 in fp32: 16-byte multiples) to both kernels, and
    allocate outputs of 72 columns: no padded copy reaches the card."""
    fake = _FakeLib()
    monkeypatch.setattr(_kernels, "library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    b, h, lq, lk = 2, 16, 1, 729
    shape = (b, h, lq, 72) if layout == "bhld" else (b, lq, h, 72)
    kshape = (b, h, lk, 72) if layout == "bhld" else (b, lk, h, 72)
    q, k = torch.zeros(shape, dtype=dtype), torch.zeros(kshape, dtype=dtype)
    out = _kernel_attention(q, k, k, None, layout)
    view = (lambda t: t.transpose(1, 2)) if layout == "blhd" else (lambda t: t)
    assert fake.dims[:7] == [b, h, lq, lk, 72, _DTYPE_CODE[dtype], 0]
    assert fake.dims[7:10] == list(view(q).stride()[:3])
    assert fake.dims[10:13] == list(view(k).stride()[:3])
    assert fake.ptrs[0] == q.data_ptr() and fake.ptrs[1] == k.data_ptr()
    assert out.shape == q.shape
    bwd = _fake_bwd(monkeypatch)
    dq, dk, dv, _ = _kernel_attention_grads(q, k, k, None, q, layout, False)
    assert bwd.dims[4] == 72
    assert bwd.ptrs[:2] == (q.data_ptr(), k.data_ptr())
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
