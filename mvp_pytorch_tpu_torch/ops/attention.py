"""Masked multi-head attention.

Additive-bias masking with the reference's finite -10000 (reference
`oscar/modeling/modeling_vlbert.py:441-463`), as in the JAX package's
`mvp_pytorch_tpu/ops/attention.py`.

`plain_attention` / `plain_attention_blhd` mirror the JAX `xla_attention` /
`xla_attention_blhd` step by step: in fp32 a full fp32 softmax; in bf16 the
scores, the scale and the bias stay bf16, the max is taken in bf16, and exp
and normalisation run in fp32 before the probabilities are cast to bf16.

`masked_attention` is the entry point the model calls, for inference and
for training. It always goes through `MaskedAttentionFn`, a
`torch.autograd.Function`. Its forward runs the plain version on a CPU tensor;
on a CUDA tensor it launches the hand-written kernel `masked_attention_fwd`
(csrc/, both dtypes on `wgmma` and TMA: bf16 in masked_attention_wgmma.cuh;
fp32 in three TF32 passes (3xTF32), masked_attention_tf32.cuh) or raises.
Each kernel picks its key-tile width, the heads of a tile and the tile
order itself (`kernel_plan` reads them back). Head dims: `HEAD_DIMS`. D 72
(SigLIP's 16 heads of 1,152) runs in the kernels' D 128 tile: TMA fills the
tile's columns past 72 with zeros on load and the stores skip them, so no
padded copy of any tensor goes to device memory (`kernel_plan` and
`kernel_bwd_plan` report the tile's width as `head_tile`); it has no
dropout instantiation, and a D 72 call with dropout raises.
Its backward saves only q, k, v, the bias and the dropout seed and
recomputes the probabilities in fp32. On a CUDA tensor it calls the
hand-written `masked_attention_bwd` once a call
(csrc/masked_attention_bwd.cuh: `wgmma` and TMA, the recompute, the dropout
hash and dq, dk, dv, nothing of size [B, H, Lq, Lk] in device memory) or
raises: one launch where the keys fit one key tile; in bf16 past it three,
with the key tiles as the outer loop (FlashAttention-2's order, counted by
`masked_attention.backward_key_outer`). That kernel replaces no TPU kernel:
the JAX package's backward was XLA einsums (`_attn_bwd`, git 8625894^,
`mvp_pytorch_tpu/ops/attention.py:200-218`). It was added because the
plain recompute of those einsums, about 60 launches over fp32 and int64
[B, H, Lq, Lk] tensors a call, took 70 ms of a training step on the H100;
its bound is the bytes of q, k, v, the output's gradient and the bias read
once and dq, dk, dv written once (0.02-0.05 ms a call at the training
shapes). On a CPU tensor the backward is `_attention_grads`, the JAX
package's `_attn_bwd` in plain PyTorch.

Attention-prob dropout (inverted, as flax `nn.Dropout` does it) runs inside
the kernel and the plain version alike. Its mask is a counter-based hash of a
per-call 64-bit seed (a one-element int64 tensor on the inputs' device, read
by the kernel through a pointer) and the flat element index
((b H + h) Lq + i) Lk + j of the [B, H, Lq, Lk] probabilities: an element is
dropped when `dropout_hash` is below round(p 2^32). The kernel, the plain
version and the backward compute the same bits, so the backward regenerates
the forward's mask. The row max and sum take the undropped probabilities;
the probabilities that meet v are multiplied by keep / (1 - p) in fp32. Its
random stream is not JAX's.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _kernels

MASK_VALUE = -10000.0  # finite, matches the reference numerics; safe in bf16

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 72, 128)
# head dims whose kernels have no dropout instantiation
NO_DROPOUT_DIMS = (72,)
_M32 = 0xFFFFFFFF


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


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), in int64 with no overflow: x is
    split into 16-bit halves, so no product exceeds 2^48."""
    return ((x & 0xFFFF) * c + (((x >> 16) * (c & 0xFFFF)) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The hash's 32-bit multiply-xorshift mixer on int64 values in
    [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _seed_words(seed: torch.Tensor):
    s = seed.reshape(())
    return s & _M32, (s >> 32) & _M32


def dropout_hash(seed: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The dropout hash of flat element indices `index` (int64, >= 0) under a
    one-element int64 `seed`, as int64 values in [0, 2^32): the index's low
    word xor the seed's low word, plus 0x9E3779B9 times its high word xor
    the seed's high word, then a 32-bit multiply-xorshift mixer. The kernel
    (`DropMask` in csrc/masked_attention.cuh) computes the same bits in
    uint32 arithmetic."""
    s0, s1 = _seed_words(seed)
    x = ((index & _M32) ^ s0) + _mul32((index >> 32) ^ s1, 0x9E3779B9)
    return _mix32(x & _M32)


def dropout_threshold(p: float) -> int:
    """Hashes below round(p 2^32) drop their element."""
    return round(p * 2 ** 32)


def dropout_keep(seed: torch.Tensor, p: float, shape) -> torch.Tensor:
    """The bool keep mask of [B, H, Lq, Lk] probabilities under `seed`:
    `dropout_hash` of their flat indices. Below 2^32 elements every high
    word is 0, so the high word's term is one value for the whole mask."""
    n = 1
    for x in shape:
        n *= x
    index = torch.arange(n, dtype=torch.int64, device=seed.device)
    if n <= 2 ** 32:
        s0, s1 = _seed_words(seed)
        h = _mix32(((index ^ s0) + _mul32(s1, 0x9E3779B9)) & _M32)
    else:
        h = dropout_hash(seed, index)
    return (h >= dropout_threshold(p)).view(shape)


def _apply_dropout(probs: torch.Tensor, dropout_p: float, seed):
    """fp32 probabilities [B, H, Lq, Lk] times keep / (1 - p)."""
    if dropout_p == 0:
        return probs
    keep = dropout_keep(seed, dropout_p, probs.shape)
    return probs * keep.to(probs.dtype) * (1.0 / (1.0 - dropout_p))


def _softmax_probs(scores: torch.Tensor, v_dtype, dropout_p: float = 0.0,
                   seed=None) -> torch.Tensor:
    """Softmax of [B, H, Lq, Lk] scores as the JAX reference takes it, then
    the dropout in fp32, then the cast to v's dtype."""
    if scores.dtype == torch.bfloat16:
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.exp((scores - m).float())
        probs = p / p.sum(dim=-1, keepdim=True)
    else:
        probs = torch.softmax(scores, dim=-1)
    probs = _apply_dropout(probs, dropout_p, seed)
    return probs.to(torch.bfloat16 if scores.dtype == torch.bfloat16
                    else v_dtype)


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


def plain_attention(q, k, v, bias: Optional[torch.Tensor] = None,
                    dropout_p: float = 0.0,
                    seed: Optional[torch.Tensor] = None):
    """q: [B, H, Lq, D]; k, v: [B, H, Lk, D]; bias broadcastable to
    [B, H, Lq, Lk]; attention-prob dropout `dropout_p` under `seed`. Returns
    [B, H, Lq, D] in q's dtype."""
    plain_attention.calls += 1
    probs = _softmax_probs(_scores(q, k, bias, "bhqd,bhkd->bhqk"), v.dtype,
                           dropout_p, seed)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def plain_attention_blhd(q, k, v, bias: Optional[torch.Tensor] = None,
                         dropout_p: float = 0.0,
                         seed: Optional[torch.Tensor] = None):
    """The same function with q: [B, Lq, H, D], k, v: [B, Lk, H, D]; returns
    [B, Lq, H, D]. The dropout mask is indexed as in [B, H, Lq, Lk]."""
    plain_attention.calls += 1
    probs = _softmax_probs(_scores(q, k, bias, "bqhd,bkhd->bhqk"), v.dtype,
                           dropout_p, seed)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# calls of the plain version, in either layout (a card run of the kernel
# path leaves it at 0)
plain_attention.calls = 0


def _check_seed(seed, device):
    if (not isinstance(seed, torch.Tensor) or seed.dtype != torch.int64
            or seed.numel() != 1 or seed.device != device):
        got = (seed if not isinstance(seed, torch.Tensor)
               else (seed.dtype, tuple(seed.shape), seed.device))
        raise ValueError(f"masked_attention: dropout needs `seed`, a "
                         f"one-element int64 tensor on {device}, got {got}")


def _kernel_attention(q, k, v, bias, layout, dropout_p: float = 0.0,
                      seed: Optional[torch.Tensor] = None):
    """Launch `masked_attention_fwd` on CUDA tensors (no fallback). With
    `dropout_p` > 0 the kernel's dropout instantiation reads the seed through
    its pointer."""
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
    # TMA steps every dim of extent > 1 by a nonzero stride
    q, k, v = (t.contiguous() if any(s == 0 and n > 1 for s, n in zip(
        t.stride(), t.shape)) else t for t in (q, k, v))
    # the kernels move rows in 16-byte copies: 8 bf16 or 4 fp32 elements
    per16 = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(s % per16 for s in t.stride()[:3]):
            raise ValueError(
                f"masked_attention: {q.dtype} {name} must start 16-byte "
                f"aligned with (b, h, l) strides in multiples of {per16}, "
                f"got address {t.data_ptr():#x} strides {t.stride()}")
    bias_ptr, bias_code, bias_strides = None, 0, (0, 0, 0)
    if bias is not None:
        if bias.dtype not in _DTYPE_CODE or bias.device != q.device:
            raise TypeError(f"masked_attention: bias must be fp32 or bf16 on "
                            f"{q.device}, got {bias.dtype} on {bias.device}")
        if bias.dim() != 4 or bias.shape[-1] != lk:
            raise ValueError(f"masked_attention: bias {tuple(bias.shape)} is "
                             f"not [B, 1|H, 1|Lq, Lk={lk}]")
        if bias.dtype == torch.bfloat16:
            # both kernels stage an fp32 bias; widening is exact (the bf16
            # kernel rounds it to bf16 again, where the reference does)
            bias = bias.float()
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
    seed_ptr, threshold, scale = None, 0, 1.0
    if dropout_p > 0:
        _check_seed(seed, q.device)
        seed_ptr = seed.data_ptr()
        threshold, scale = dropout_threshold(dropout_p), 1.0 / (1.0 - dropout_p)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _kernels.library()
    err = lib.masked_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   bias_ptr, o.data_ptr(),
                                   ctypes.addressof(arr), stream, seed_ptr,
                                   threshold, scale)
    _kernels.check(err, "masked_attention_fwd")
    return out


def kernel_blocks_per_sm(dtype: torch.dtype, d: int) -> int:
    """Resident blocks per SM of the kernel launched for (dtype, D), as the
    CUDA occupancy calculator gives it on the current card (at a 128-key
    tile, 64 at D 128)."""
    n = ctypes.c_int(0)
    err = _kernels.library().masked_attention_blocks_per_sm(
        _DTYPE_CODE[dtype], d, ctypes.byref(n))
    _kernels.check(err, "masked_attention_blocks_per_sm")
    return n.value


def kernel_plan(lq: int, lk: int, h: int, d: int, bias_strides=None,
                b: int = 1, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The plan the kernel of `dtype` makes for a launch of B b, H h, Lq, Lk,
    head dim d and a bias with these (b, h, l) strides (None: no bias), read
    from the built library (`masked_attention_plan`; host only, launches
    nothing): key_tile (the smallest instantiated width that holds Lk, else
    the largest, walked by the online softmax; fp32: of those whose plan
    fits shared memory), heads (of a tile: 2 when Lq <= 64), order (1: head
    tiles innermost, for a per-query bias broadcast over heads), tiles,
    stages (of k and v in shared memory), smem_bytes (a block) and
    head_tile (the width a head takes in the tile: d, or 128 at d 72)."""
    dims = [b, h, lq, lk, d, _DTYPE_CODE[dtype], 0] + [0] * 12
    dims += bias_strides or (0, 0, 0)
    arr = (ctypes.c_int64 * len(dims))(*dims)
    out = (ctypes.c_int64 * 7)()
    err = _kernels.library().masked_attention_plan(
        ctypes.addressof(arr), int(bias_strides is not None),
        ctypes.addressof(out))
    _kernels.check(err, "masked_attention_plan")
    return dict(zip(("key_tile", "heads", "order", "tiles", "stages",
                     "smem_bytes", "head_tile"), out))


def tma_encode_us(layout: str = "blhd", iters: int = 1000) -> float:
    """Host microseconds that one bf16 launch spends encoding its three TMA
    tensor maps (q, k, v of the rerank shape, B 1,000, L 125, H 12, D 64,
    in `layout`), averaged over `iters` launches."""
    buf = torch.empty(1000 * 125 * 12 * 64, dtype=torch.bfloat16,
                      device="cuda")
    us = ctypes.c_float(0.0)
    err = _kernels.library().masked_attention_tma_encode_us(
        iters, int(layout == "blhd"), buf.data_ptr(), ctypes.byref(us))
    if err != 0:
        raise RuntimeError(f"cuTensorMapEncodeTiled: CUresult {err}")
    return us.value


def _attention_grads(q, k, v, bias, g, layout, bias_grad: bool,
                     dropout_p: float = 0.0, seed=None):
    """The JAX package's `_attn_bwd` (git 8625894^, ops/attention.py:200-218),
    with the forward's dropout mask regenerated from `seed` by the plain
    hash: recompute the probabilities p in fp32 from q, k and the bias, then,
    with keep / (1 - p_drop) as m (1 without dropout), dv = (p m)^T.g,
    dp = (g.v^T) m, ds = p * (dp - sum(dp * p)), dq = ds.k * D^-1/2,
    dk = ds^T.q * D^-1/2 and, when `bias_grad`, dbias = ds summed over the
    dims where the bias broadcasts. Grads come back in their inputs'
    dtypes."""
    x, y = ("bqhd", "bkhd") if layout == "blhd" else ("bhqd", "bhkd")
    scale = q.shape[-1] ** -0.5
    q32, k32, v32, g32 = (t.float() for t in (q, k, v, g))
    scores = torch.einsum(f"{x},{y}->bhqk", q32, k32) * scale
    if bias is not None:
        scores = scores + bias.float()
    p = torch.softmax(scores, dim=-1)
    dp = torch.einsum(f"{x},{y}->bhqk", g32, v32)
    pd = p
    if dropout_p > 0:
        m = dropout_keep(seed, dropout_p, p.shape).float() * (
            1.0 / (1.0 - dropout_p))
        pd, dp = p * m, dp * m
    dv = torch.einsum(f"bhqk,{x}->{y}", pd, g32)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum(f"bhqk,{y}->{x}", ds, k32) * scale
    dk = torch.einsum(f"bhqk,{x}->{y}", ds, q32) * scale
    dbias = ds.sum_to_size(bias.shape).to(bias.dtype) if bias_grad else None
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _tma_ready(t):
    """`t` with a contiguous last dim, 16-byte aligned, (b, h, l) strides in
    16-byte multiples and no zero stride on a dim of extent > 1 (what TMA
    and the fp32 loads take), copied only when it is not."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t               # rows of D in HEAD_DIMS: 16-byte strides
    per16 = 16 // t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s % per16 for s in t.stride()[:3])
            or any(s == 0 and n > 1 for s, n in zip(t.stride(), t.shape))):
        return t.contiguous()
    return t


def _kernel_attention_grads(q, k, v, bias, g, layout, bias_grad: bool,
                            dropout_p: float = 0.0, seed=None):
    """Launch `masked_attention_bwd` on CUDA tensors (no fallback): the
    gradients of `_attention_grads` in one kernel (in bf16 past one key
    tile three launches, the key tiles outer, counted by
    `masked_attention.backward_key_outer`), which recomputes the
    probabilities from q, k and the bias and regenerates the dropout mask
    from `seed`. dq, dk, dv come back in the inputs' dtype and layout; with
    `bias_grad` the kernel writes ds in fp32, summed here to the bias's
    shape."""
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype
                                         for t in (k, v, g)):
        raise TypeError(f"masked_attention backward: q, k, v and the grad "
                        f"must share a dtype in {list(_DTYPE_CODE)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}, {g.dtype}")
    if not (q.device == k.device == v.device == g.device):
        raise ValueError("masked_attention backward: q, k, v, grad on "
                         "different devices")
    for name, t in (("q", q), ("k", k), ("v", v), ("grad", g)):
        if t.dim() != 4:
            raise ValueError(f"masked_attention backward: {name} must be "
                             f"4-D, got shape {tuple(t.shape)}")
    if g.shape != q.shape:
        raise ValueError(f"masked_attention backward: grad {tuple(g.shape)} "
                         f"is not q's {tuple(q.shape)}")
    grads = [torch.empty_like(t, memory_format=torch.contiguous_format)
             for t in (q, k, v)]
    q, k, v, g = (_tma_ready(t) for t in (q, k, v, g))
    tensors = (q, k, v, g, *grads)
    # the kernel reads [B, H, L, D]: "blhd" tensors by their strides swapped
    # (no view objects: this wrapper's host time is part of every step's)
    order = (0, 2, 1, 3) if layout == "blhd" else (0, 1, 2, 3)
    shapes = [tuple(t.shape[i] for i in order) for t in (q, k, v)]
    b, h, lq, d = shapes[0]
    lk = shapes[1][2]
    if d not in HEAD_DIMS:
        raise ValueError(f"masked_attention backward: head dim {d} not in "
                         f"{HEAD_DIMS}")
    if shapes[1] != (b, h, lk, d) or shapes[2] != shapes[1] or lk == 0:
        raise ValueError(f"masked_attention backward: shapes q {shapes[0]}, "
                         f"k {shapes[1]}, v {shapes[2]} ([B, H, L, D])")
    bias_ptr, bias_strides, dbias = None, (0, 0, 0), None
    if bias is not None:
        if bias.dtype not in _DTYPE_CODE or bias.device != q.device:
            raise TypeError(f"masked_attention backward: bias must be fp32 "
                            f"or bf16 on {q.device}, got {bias.dtype} on "
                            f"{bias.device}")
        if bias.dim() != 4 or bias.shape[-1] != lk:
            raise ValueError(f"masked_attention backward: bias "
                             f"{tuple(bias.shape)} is not [B, 1|H, 1|Lq, "
                             f"Lk={lk}]")
        wide = bias.float().expand(b, h, lq, lk)   # widening is exact
        if wide.stride(-1) != 1:
            wide = wide.contiguous()
        bias_ptr, bias_strides = wide.data_ptr(), wide.stride()[:3]
        if bias_grad:
            dbias = torch.empty(b, h, lq, lk, dtype=torch.float32,
                                device=q.device)
    dims = [b, h, lq, lk, d, _DTYPE_CODE[q.dtype], 0]
    for t in tensors:
        st = t.stride()
        dims += (st[order[0]], st[order[1]], st[order[2]])
    dims += bias_strides
    arr = (ctypes.c_int64 * len(dims))(*dims)
    lib = _kernels.library()
    plan = (ctypes.c_int64 * len(_BWD_PLAN))()
    _kernels.check(lib.masked_attention_bwd_plan(ctypes.addressof(arr),
                                                 ctypes.addressof(plan)),
                   "masked_attention_bwd_plan")
    # dk and dv's sums, or the key-outer path's statistics and dq slices
    scratch = (torch.empty(plan[5], dtype=torch.float32, device=q.device)
               if plan[5] else None)
    seed_ptr, threshold, scale = None, 0, 1.0
    if dropout_p > 0:
        _check_seed(seed, q.device)
        seed_ptr = seed.data_ptr()
        threshold, scale = dropout_threshold(dropout_p), 1.0 / (1.0 - dropout_p)
    ptrs = [t.data_ptr() for t in tensors]
    err = lib.masked_attention_bwd(
        *ptrs[:4], bias_ptr, *ptrs[4:],
        None if dbias is None else dbias.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        ctypes.addressof(arr), torch.cuda.current_stream(q.device).cuda_stream,
        seed_ptr, threshold, scale)
    _kernels.check(err, "masked_attention_bwd")
    if plan[7]:
        masked_attention.backward_key_outer += 1
    if dbias is not None:
        dbias = dbias.sum_to_size(bias.shape).to(bias.dtype)
    return (*grads, dbias)


_BWD_PLAN = ("key_tile", "key_tiles", "multi", "acc_smem", "smem_bytes",
             "scratch_floats", "head_tile", "key_outer", "stats_floats",
             "dq_slices")


def kernel_bwd_plan(lq: int, lk: int, h: int = 12, d: int = 64, b: int = 1,
                    dtype: torch.dtype = torch.bfloat16) -> dict:
    """The plan `masked_attention_bwd` makes for a launch of these dims,
    read from the built library (host only): key_tile (one kernel: the
    smallest instantiated width that holds Lk, else the largest; key outer:
    the gradient kernel's 128), key_tiles, multi (1: past one key tile),
    acc_smem (1: dk and dv add up in shared memory), smem_bytes (a block of
    the kernel, or of the key-outer gradient kernel), scratch_floats (the
    fp32 buffer the wrapper allocates: dk and dv's sums where they do not
    fit shared memory, or the key-outer path's statistics and dq slices),
    head_tile (the width a head takes in the tile: d, or 128 at d 72),
    key_outer (1: bf16 past one key tile, the key tiles the outer loop in
    three launches), stats_floats (its row statistics, 3 x 64 floats a
    query block) and dq_slices (its fp32 partial sums of dq: one a 128-key
    tile in the D 128 tile, else one a 64 keys)."""
    dims = [b, h, lq, lk, d, _DTYPE_CODE[dtype], 0] + [0] * 24
    arr = (ctypes.c_int64 * len(dims))(*dims)
    out = (ctypes.c_int64 * len(_BWD_PLAN))()
    err = _kernels.library().masked_attention_bwd_plan(ctypes.addressof(arr),
                                                       ctypes.addressof(out))
    _kernels.check(err, "masked_attention_bwd_plan")
    return dict(zip(_BWD_PLAN, out))


class _BackwardKernel(torch.autograd.Function):
    """`_kernel_attention_grads` under an operator record of its own: the
    profiler attributes a kernel to the innermost operator open on its
    thread, and inside a backward that is the autograd node, which encloses
    any range opened around `MaskedAttentionFn.backward`. Applied there,
    the launch is a child of such a range, as the forward's launch is of a
    range around the forward (it runs inside `MaskedAttentionFn`'s own
    record). It defines no backward: the kernel's gradients are not
    differentiated again."""

    @staticmethod
    def forward(ctx, *args):
        return _kernel_attention_grads(*args)


class MaskedAttentionFn(torch.autograd.Function):
    """Differentiable masked attention: forward on the kernel (CUDA) or the
    plain version (CPU); backward on the kernel `masked_attention_bwd`
    (CUDA, once a call, counted by
    `masked_attention.backward_launches`) or by the plain recompute
    (`_attention_grads`, CPU). Saves q, k, v, the bias and the dropout seed
    only, never the [B, H, Lq, Lk] probabilities or the mask."""

    @staticmethod
    def forward(ctx, q, k, v, bias, layout, dropout_p, seed):
        if q.device.type == "cuda":
            out = _kernel_attention(q, k, v, bias, layout, dropout_p, seed)
            masked_attention.launches += 1
            if dropout_p > 0:
                masked_attention.dropout_launches += 1
        else:
            fn = plain_attention_blhd if layout == "blhd" else plain_attention
            out = fn(q, k, v, bias, dropout_p, seed)
        if any(ctx.needs_input_grad[:4]):
            ctx.save_for_backward(q, k, v, bias, seed)
        ctx.layout = layout
        ctx.dropout_p = dropout_p
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, seed = ctx.saved_tensors
        if q.device.type == "cuda":
            grads = _BackwardKernel.apply(q, k, v, bias, g, ctx.layout,
                                          ctx.needs_input_grad[3],
                                          ctx.dropout_p, seed)
            masked_attention.backward_launches += 1
        else:
            grads = _attention_grads(q, k, v, bias, g, ctx.layout,
                                     ctx.needs_input_grad[3], ctx.dropout_p,
                                     seed)
        return (*grads, None, None, None)


def masked_attention(q, k, v, bias: Optional[torch.Tensor] = None, *,
                     layout: str = "bhld", dropout_p: float = 0.0,
                     seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q.k^T * D^-1/2 + bias).v in the given layout, differentiable
    in q, k, v and the bias, with attention-prob dropout `dropout_p` drawn
    from `seed` (a one-element int64 tensor on the inputs' device).

    layout "bhld": q [B, H, Lq, D], k and v [B, H, Lk, D], out [B, H, Lq, D].
    layout "blhd": q [B, Lq, H, D], k and v [B, Lk, H, D], out [B, Lq, H, D].
    bias: [B, 1|H, 1|Lq, Lk], fp32 or bf16, or None.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and adds one to `masked_attention.launches`, and with dropout to
    `masked_attention.dropout_launches`) or raises. Its backward calls
    `masked_attention_bwd` on a CUDA tensor (one more
    `masked_attention.backward_launches`; one more
    `masked_attention.backward_key_outer` when the bf16 keys span more than
    one key tile and the key tiles are the outer loop) and runs the plain
    recompute on a CPU tensor. A head dim in `NO_DROPOUT_DIMS` (72) with
    dropout raises, on either device: its kernels have no dropout
    instantiation.
    """
    if layout not in ("bhld", "blhd"):
        raise ValueError(f"unknown layout {layout!r}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"masked_attention: no kernel for {q.device}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"masked_attention: dropout_p {dropout_p} not in "
                         f"[0, 1)")
    if dropout_p > 0 and q.shape[-1] in NO_DROPOUT_DIMS:
        raise ValueError(f"masked_attention: head dim {q.shape[-1]} has no "
                         f"dropout kernel; call it with dropout_p 0 (got "
                         f"{dropout_p})")
    if dropout_p > 0:
        _check_seed(seed, q.device)
    else:
        seed = None
    return MaskedAttentionFn.apply(q, k, v, bias, layout, float(dropout_p),
                                   seed)


masked_attention.launches = 0
masked_attention.dropout_launches = 0
masked_attention.backward_launches = 0
masked_attention.backward_key_outer = 0
