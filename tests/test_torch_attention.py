"""The port's masked attention against the JAX package's.

`plain_attention` / `plain_attention_blhd` (mvp_pytorch_tpu_torch) are held
against `xla_attention` / `xla_attention_blhd` (mvp_pytorch_tpu) on the same
numpy-seeded inputs: fp32 at atol 1e-5 (the same fp32 math, summed in another
order); bf16 against the fp32 reference at atol 0.05, as
tests/test_models.py::test_bf16_attention_matches_fp32_reference holds the
JAX bf16 path; bf16 against the JAX bf16 path at atol 0.02 (a couple of bf16
ulps at these magnitudes: the two frameworks round their matmuls alike but
accumulate in different orders). The CUDA kernel is held against the plain
version in tests/test_torch_kernels.py, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.ops.attention import (mask_to_bias as jax_mask_to_bias,
                                           xla_attention, xla_attention_blhd)
from mvp_pytorch_tpu_torch.ops.attention import (MASK_VALUE, mask_to_bias,
                                                 masked_attention,
                                                 plain_attention,
                                                 plain_attention_blhd)

B, H, D = 3, 4, 8


def make_case(kind: str, seed: int = 0, d: int = D, lq: int = 7):
    """q, k, v in [B, H, L, d] and an fp32 bias, as numpy arrays."""
    r = np.random.RandomState(seed)
    lk = lq + 4 if kind == "lk_gt_lq" else lq
    q = r.randn(B, H, lq, d).astype(np.float32)
    k = r.randn(B, H, lk, d).astype(np.float32)
    v = r.randn(B, H, lk, d).astype(np.float32)
    if kind == "fully_masked":
        # multiples of 1/8: q.k is exact in every summation order. Next to
        # the -10000 bias an fp32 score keeps 10 fraction bits, so otherwise
        # two correct orders can round a score to neighbouring values there
        q, k = (np.clip(np.round(x * 8) / 8, -4, 4) for x in (q, k))
    if kind == "mask3d":
        mask = (r.rand(B, lq, lk) > 0.3).astype(np.int32)
        mask[..., 0] = 1
        return q, k, v, np.array(jax_mask_to_bias(jnp.asarray(mask)))
    mask = np.ones((B, lk), np.int32)
    mask[1, lk - 3:] = 0                     # padded keys
    mask[2, lk - 1:] = 0
    if kind == "fully_masked":
        mask[0] = 0                          # every key of batch row 0
    return q, k, v, np.array(jax_mask_to_bias(jnp.asarray(mask)))


def to_blhd(x):
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3))


def run_jax(q, k, v, bias, layout, dtype):
    fn = xla_attention_blhd if layout == "blhd" else xla_attention
    if layout == "blhd":
        q, k, v = map(to_blhd, (q, k, v))
    out = fn(*(jnp.asarray(x, dtype) for x in (q, k, v)), jnp.asarray(bias))
    return np.asarray(out.astype(jnp.float32))


def run_port(q, k, v, bias, layout, dtype):
    if layout == "blhd":
        q, k, v = map(to_blhd, (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    fn = plain_attention_blhd if layout == "blhd" else plain_attention
    out = fn(tq, tk, tv, torch.from_numpy(bias))
    assert out.dtype == dtype
    # masked_attention on a CPU tensor is the plain version
    same = masked_attention(tq, tk, tv, torch.from_numpy(bias), layout=layout)
    torch.testing.assert_close(same, out, rtol=0, atol=0)
    return out.float().numpy()


KINDS = ["mask2d", "mask3d", "lk_gt_lq", "fully_masked"]


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_fp32_matches_jax(kind, layout):
    q, k, v, bias = make_case(kind)
    want = run_jax(q, k, v, bias, layout, jnp.float32)
    got = run_port(q, k, v, bias, layout, torch.float32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_bf16_matches_jax(kind, layout):
    q, k, v, bias = make_case(kind, seed=1)
    got = run_port(q, k, v, bias, layout, torch.bfloat16)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, run_jax(q, k, v, bias, layout, jnp.bfloat16), atol=0.02, rtol=0)
    if kind != "fully_masked":
        # a fully-masked row is the unmasked softmax in fp32 but uniform in
        # bf16 (the bf16 bias swallows the scores), so only the others match
        np.testing.assert_allclose(
            got, run_jax(q, k, v, bias, layout, jnp.float32), atol=0.05,
            rtol=0)


def test_fully_masked_rows_are_uniform_in_bf16():
    q, k, v, bias = make_case("fully_masked", seed=2)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = plain_attention(tq, tk, tv, torch.from_numpy(bias)).float()
    mean_v = tv[0].float().mean(dim=1, keepdim=True).expand_as(out[0])
    torch.testing.assert_close(out[0], mean_v, atol=0.02, rtol=0)


@pytest.mark.parametrize("rank", [2, 3])
def test_mask_to_bias_matches_jax(rank):
    r = np.random.RandomState(rank)
    shape = (2, 5) if rank == 2 else (2, 4, 5)
    mask = (r.rand(*shape) > 0.5).astype(np.int32)
    got = mask_to_bias(torch.from_numpy(mask))
    want = np.asarray(jax_mask_to_bias(jnp.asarray(mask)))
    assert tuple(got.shape) == want.shape
    assert got.shape == ((2, 1, 1, 5) if rank == 2 else (2, 1, 4, 5))
    np.testing.assert_array_equal(got.numpy(), want)
    assert MASK_VALUE == -10000.0
    with pytest.raises(ValueError):
        mask_to_bias(torch.ones(5))
