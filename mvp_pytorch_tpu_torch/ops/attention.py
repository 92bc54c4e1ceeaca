"""Masked multi-head attention.

Additive-bias masking with the reference's finite -10000 (reference
`oscar/modeling/modeling_vlbert.py:441-463`), as in the JAX package's
`mvp_pytorch_tpu/ops/attention.py`.

`plain_attention` / `plain_attention_blhd` mirror the JAX `xla_attention` /
`xla_attention_blhd` step by step: in fp32 a full fp32 softmax; in bf16 the
scores, the scale and the bias stay bf16, the max is taken in bf16, and exp
and normalisation run in fp32 before the probabilities are cast to bf16.

`masked_attention` is the entry point the model calls. On a CPU tensor it
runs the plain version; on a CUDA tensor it launches the hand-written kernel
`masked_attention_fwd` (csrc/masked_attention.cu) or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _kernels

MASK_VALUE = -10000.0  # finite, matches the reference numerics; safe in bf16

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, L] 0/1 mask -> [B, 1, 1, L] additive bias; [B, F, L] per-query
    masks -> [B, 1, F, L]."""
    if mask.dim() == 2:
        ext = mask[:, None, None, :]
    elif mask.dim() == 3:
        ext = mask[:, None, :, :]
    else:
        raise ValueError(f"mask must be rank 2 or 3, got {mask.dim()}")
    return (1.0 - ext.to(dtype)) * MASK_VALUE


def _softmax_probs(scores: torch.Tensor, v_dtype) -> torch.Tensor:
    """Softmax of [.., Lq, Lk] scores as the JAX reference takes it."""
    if scores.dtype == torch.bfloat16:
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.exp((scores - m).float())
        return (p / p.sum(dim=-1, keepdim=True)).to(torch.bfloat16)
    return torch.softmax(scores, dim=-1).to(v_dtype)


def _scores(q, k, bias, eq):
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum(eq, q, k)
    if q.dtype == torch.bfloat16:
        scores = scores * torch.tensor(scale, dtype=torch.bfloat16)
        if bias is not None:
            scores = scores + bias.to(torch.bfloat16)
        return scores
    scores = scores.float() * scale
    if bias is not None:
        scores = scores + bias.float()
    return scores


def plain_attention(q, k, v, bias: Optional[torch.Tensor] = None):
    """q: [B, H, Lq, D]; k, v: [B, H, Lk, D]; bias broadcastable to
    [B, H, Lq, Lk]. Returns [B, H, Lq, D] in q's dtype."""
    probs = _softmax_probs(_scores(q, k, bias, "bhqd,bhkd->bhqk"), v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def plain_attention_blhd(q, k, v, bias: Optional[torch.Tensor] = None):
    """The same function with q: [B, Lq, H, D], k, v: [B, Lk, H, D]; returns
    [B, Lq, H, D]."""
    probs = _softmax_probs(_scores(q, k, bias, "bqhd,bkhd->bhqk"), v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _kernel_attention(q, k, v, bias, layout):
    """Launch `masked_attention_fwd` on CUDA tensors (no fallback)."""
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"masked_attention: q, k, v must share a dtype in "
                        f"{list(_DTYPE_CODE)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("masked_attention: q, k, v on different devices")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"masked_attention: {name} must be 4-D with a "
                             f"contiguous last dim, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if layout == "blhd":   # read [B, L, H, D] through a [B, H, L, D] view
        q, k, v, o = (t.transpose(1, 2) for t in (q, k, v, out))
    else:
        o = out
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"masked_attention: head dim {d} not in {HEAD_DIMS}")
    if k.shape != (b, h, lk, d) or v.shape != k.shape or lk == 0:
        raise ValueError(f"masked_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    bias_ptr, bias_code, bias_strides = None, 0, (0, 0, 0)
    if bias is not None:
        if bias.dtype not in _DTYPE_CODE or bias.device != q.device:
            raise TypeError(f"masked_attention: bias must be fp32 or bf16 on "
                            f"{q.device}, got {bias.dtype} on {bias.device}")
        if bias.dim() != 4 or bias.shape[-1] != lk:
            raise ValueError(f"masked_attention: bias {tuple(bias.shape)} is "
                             f"not [B, 1|H, 1|Lq, Lk={lk}]")
        bias = bias.expand(b, h, lq, lk)       # stride 0 on broadcast dims
        if bias.stride(-1) != 1:
            raise ValueError("masked_attention: bias last dim not contiguous")
        bias_ptr, bias_code = bias.data_ptr(), _DTYPE_CODE[bias.dtype]
        bias_strides = bias.stride()[:3]
    dims = [b, h, lq, lk, d, _DTYPE_CODE[q.dtype], bias_code]
    for t in (q, k, v, o):
        dims += t.stride()[:3]
    dims += bias_strides
    arr = (ctypes.c_int64 * len(dims))(*dims)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _kernels.library()
    err = lib.masked_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   bias_ptr, o.data_ptr(),
                                   ctypes.addressof(arr), stream)
    _kernels.check(err, "masked_attention_fwd")
    return out


def masked_attention(q, k, v, bias: Optional[torch.Tensor] = None, *,
                     layout: str = "bhld") -> torch.Tensor:
    """softmax(q.k^T * D^-1/2 + bias).v in the given layout.

    layout "bhld": q [B, H, Lq, D], k and v [B, H, Lk, D], out [B, H, Lq, D].
    layout "blhd": q [B, Lq, H, D], k and v [B, Lk, H, D], out [B, Lq, H, D].
    bias: [B, 1|H, 1|Lq, Lk], fp32 or bf16, or None.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and adds one to `masked_attention.launches`) or raises.
    """
    if layout not in ("bhld", "blhd"):
        raise ValueError(f"unknown layout {layout!r}")
    if q.device.type == "cpu":
        fn = plain_attention_blhd if layout == "blhd" else plain_attention
        return fn(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"masked_attention: no kernel for {q.device}")
    out = _kernel_attention(q, k, v, bias, layout)
    masked_attention.launches += 1
    return out


masked_attention.launches = 0
