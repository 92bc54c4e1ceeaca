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

from mvp_pytorch_tpu_torch.ops import _kernels
from mvp_pytorch_tpu_torch.ops.attention import (_kernel_attention,
                                                 mask_to_bias,
                                                 masked_attention,
                                                 plain_attention,
                                                 plain_attention_blhd)

B, H = 3, 4
KINDS = ["mask2d", "mask3d", "lk_gt_lq", "fully_masked", "no_bias"]


def make_case(kind, d, lq=75, seed=3):
    """q, k, v [B, H, L, d] and an fp32 bias (or None), as numpy arrays:
    more queries than one 32-row tile, keys over several 32-key tiles."""
    r = np.random.RandomState(seed)
    lk = lq + 50 if kind == "lk_gt_lq" else lq
    q = r.randn(B, H, lq, d).astype(np.float32)
    k = r.randn(B, H, lk, d).astype(np.float32)
    v = r.randn(B, H, lk, d).astype(np.float32)
    if kind == "fully_masked":
        # multiples of 1/8: q.k is exact in every summation order. Next to
        # the -10000 bias an fp32 score keeps 10 fraction bits, so otherwise
        # two correct orders can round a score to neighbouring values there
        q, k = (np.clip(np.round(x * 8) / 8, -4, 4) for x in (q, k))
    if kind == "no_bias":
        return q, k, v, None
    if kind == "mask3d":
        mask = (r.rand(B, lq, lk) > 0.3).astype(np.int32)
        mask[..., 0] = 1
        mask[1, lq // 2] = 0                 # one fully-masked query row
    else:
        mask = np.ones((B, lk), np.int32)
        mask[1, lk - 30:] = 0                # padded keys
        mask[2, lk - 1:] = 0
        if kind == "fully_masked":
            mask[0] = 0                      # every key of batch row 0
    return q, k, v, mask_to_bias(torch.from_numpy(mask)).numpy()


def _bhld_to(layout, x):
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3)) if layout == "blhd" else x


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
