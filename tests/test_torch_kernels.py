"""The hand-written CUDA kernels against their plain versions.

This file imports neither JAX nor the JAX package, so on a machine with a
card it runs without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Tests marked `cuda` skip without a card; the wrapper's argument checks and
the build's missing-compiler error run everywhere.
"""

import shutil

import numpy as np
import pytest
import torch

from mvp_pytorch_tpu_torch.models.img_bert import make_seq2seq_mask
from mvp_pytorch_tpu_torch.ops import _kernels
from mvp_pytorch_tpu_torch.ops.attention import (MaskedAttentionFn,
                                                 _kernel_attention,
                                                 dropout_keep, mask_to_bias,
                                                 masked_attention,
                                                 plain_attention,
                                                 plain_attention_blhd)

B, H = 3, 4
# kind -> (batch, Lq, Lk). The first five fit one 128-key tile of the
# kernels (bf16 and fp32 tile alike); the others cross the tiles: keys over
# two 128-key tiles (online softmax), queries over two 128-query tiles, one
# batch row, odd lengths (one key past a tile, a single query and key).
SHAPES = {"mask2d": (B, 75, 75), "mask3d": (B, 75, 75),
          "lk_gt_lq": (B, 75, 125), "fully_masked": (B, 75, 75),
          "no_bias": (B, 75, 75), "lk_gt_128": (B, 75, 200),
          "lq_gt_128": (B, 160, 160), "batch1": (1, 125, 125),
          "odd": (B, 17, 129), "single": (B, 1, 1)}
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
    if kind in ("mask3d", "lq_gt_128"):
        mask = (r.rand(b, lq, lk) > 0.3).astype(np.int32)
        mask[..., 0] = 1
        mask[1, lq // 2] = 0                 # one fully-masked query row
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
    tb = None if bias is None else torch.from_numpy(bias).to(cuda)
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
    launches no kernel."""
    q, k, v, bias = make_case(kind, 64)
    args = [torch.from_numpy(_bhld_to(layout, x)).to(cuda, dtype)
            .requires_grad_() for x in (q, k, v)]
    tb = torch.from_numpy(bias).to(cuda).requires_grad_()
    before = masked_attention.launches
    out = masked_attention(*args, tb, layout=layout)
    assert isinstance(out.grad_fn, MaskedAttentionFn._backward_cls)
    g = torch.randn(out.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    grads = torch.autograd.grad(out, (*args, tb), g.to(dtype))
    torch.cuda.synchronize()
    assert masked_attention.launches == before + 1
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
                                      (200, 64, 0), (200, 64, 128)],
                         ids=["lk64", "lk128", "lk200-first", "lk200-second"])
def test_dropout_mask_reads_back_equal_to_the_plain_hash(cuda, lk, d, off,
                                                         layout, dtype):
    """q = k = 0 gives every key probability 1/Lk; v holds one-hot rows for
    keys off .. off + d, so out[b, h, i, j] > 0 exactly where key off + j of
    row i is kept. Lk 200 runs the online (two key tiles) kernel, read at
    both tiles."""
    b, lq, p = 3, 75, 0.1
    q = torch.zeros(b, H, lq, d, device=cuda, dtype=dtype)
    k = torch.zeros(b, H, lk, d, device=cuda, dtype=dtype)
    v = torch.zeros(b, H, lk, d, device=cuda, dtype=dtype)
    v[:, :, off + torch.arange(d), torch.arange(d)] = 1
    if layout == "blhd":
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    seed = card_seed(-123456789)
    before = masked_attention.dropout_launches
    out = masked_attention(q, k, v, layout=layout, dropout_p=p, seed=seed)
    torch.cuda.synchronize()
    assert masked_attention.dropout_launches == before + 1
    if layout == "blhd":
        out = out.transpose(1, 2)
    want = dropout_keep(seed, p, (b, H, lq, lk))[..., off:off + d]
    assert torch.equal(out > 0, want)


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
    tb = None if bias is None else torch.from_numpy(bias).to(cuda)
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
# tags 20 + regions 50 = 145, past the 128-key tile (17 rows and keys in
# the second tiles)
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
    """Lq = Lk = 145 on the online kernels, with and without dropout: the
    forward against the plain version on the same seed, the grads against
    fp32 autograd of the plain version."""
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
