// masked_attention_fwd: masked multi-head attention forward for Hopper (sm_90a).
//
//   out = softmax(q . k^T * D^-1/2 + bias) . v
//
// Replaces the TPU kernels of the JAX package's history,
// `mvp_pytorch_tpu/ops/attention.py` at git 8625894^:
//   - `_fused_attn_kernel` / `pallas_attention` (:76-130, pallas_call at :114),
//     one program per (batch, head), bias [B, 1|H, 1|Lq, Lk];
//   - `_fused_attn_v2_kernel` / `pallas_attention_v2` (:136-189, pallas_call
//     at :169), batch-tiled, 2-D key-mask bias: here the broadcast-bias case.
// Its live semantics are `xla_attention` / `xla_attention_blhd`
// (mvp_pytorch_tpu/ops/attention.py:53-110), mirrored by `plain_attention*`
// in mvp_pytorch_tpu_torch/ops/attention.py.
//
// The entry point picks the kernel by the input type, both on `wgmma` and
// TMA (no kernel is left on `mma.sync`), both built from the pieces in
// masked_attention_hopper.cuh (persistent blocks of a producer and two
// consumer warpgroups, TMA maps, the bias staged once for all heads that
// share it, key tiles sized to Lk by a host plan):
//   - bf16: `hopper::masked_attention_wgmma_kernel` (masked_attention_wgmma.cuh,
//     whose note gives its bound and design);
//   - fp32: `hopper::f32::masked_attention_tf32_kernel`
//     (masked_attention_tf32.cuh): TF32 `wgmma` in three passes (3xTF32), k
//     and v split into hi and lo once per key tile in shared memory.
// Both are bound by bytes at every shape the port runs: q, k, v and out read
// or written once, plus the bias (rerank, B 1,000, L 125, H 12, D 64:
// 0.229 ms in bf16, 0.459 ms in fp32 at 3.35 TB/s).
//
// Attention-prob dropout (every kernel of both dtypes): the JAX package
// leaves its fused kernel for XLA einsums when it trains with attention
// dropout (mvp_pytorch_tpu/models/layers.py:129-152); here the kernel carries
// it. The mask is a counter-based hash of the launch's 64-bit seed, read from
// the device through a pointer, and the flat element index
// ((b H + h) Lq + i) Lk + j (`DropMask`; `dropout_hash` in
// mvp_pytorch_tpu_torch/ops/attention.py computes the same bits, so the
// backward regenerates the mask). The row max and sum take the undropped
// probabilities; the probabilities that meet v are multiplied by
// keep / (1 - p) in fp32, before the bf16 kernel rounds them to bf16.
// Dropout is a template parameter (kDrop) of every kernel, never a branch in
// the unrolled key loops: the kDrop = false instantiations are the kernels
// without dropout. The hash is about a dozen integer operations a score.

// This header holds what both dtypes share (the launch parameters, the
// dropout hash) and the entry points' declarations. The translation units,
// compiled in parallel (one nvcc each): masked_attention.cu (the C entry
// points), masked_attention_{bf16,fp32}_d{32,64,128}{,_drop}.cu and
// masked_attention_{bf16,fp32}_d72.cu (one kernel for one dtype, head dim and
// dropout setting each; D 72 has no dropout instantiation). Everything here is in
// an unnamed namespace, so each unit keeps its own copy of what it
// instantiates.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;  // may be null
  void* out;
  int64_t q_s[3], k_s[3], v_s[3], o_s[3], b_s[3];  // strides of dims b, h, l
  int B, H, Lq, Lk;
  float scale;
  const void* seed;         // one int64 on the device; null without dropout
  uint32_t drop_threshold;  // a hash below it drops its element: round(p 2^32)
  float drop_scale;         // 1 / (1 - p)
};

// The dropout mask of one launch: factor(e) is keep(e) / (1 - p) for the flat
// element index e. The hash: the index's low word xor the seed's low word,
// plus 0x9E3779B9 times (high word xor the seed's high word), then a 32-bit
// multiply-xorshift mixer, all in uint32 arithmetic (mod 2^32).
struct DropMask {
  uint32_t s0, s1, threshold;
  float scale;
  __device__ __forceinline__ float factor(uint64_t e) const {
    const uint32_t lo = static_cast<uint32_t>(e), hi = static_cast<uint32_t>(e >> 32);
    uint32_t x = (lo ^ s0) + (hi ^ s1) * 0x9E3779B9u;
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
    x ^= x >> 16;
    return x >= threshold ? scale : 0.f;
  }
};

// flat dropout index of (bh, query q, key k0 + 2t) for the rows g, g + 8 of a
// warp: ((b H + h) Lq + q) Lk + k0 + 2t; a thread's keys add 8j and 8j + 1
__device__ __forceinline__ void drop_rows(uint64_t (&rb)[2], const Params& p, int64_t bh,
                                          int q, int k0, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
    rb[r] = static_cast<uint64_t>(bh * p.Lq + q + 8 * r) * static_cast<uint64_t>(p.Lk)
            + static_cast<uint64_t>(k0 + 2 * t);
}

__device__ __forceinline__ DropMask drop_mask(const Params& p) {
  const uint64_t s = *static_cast<const uint64_t*>(p.seed);
  return {static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32), p.drop_threshold,
          p.drop_scale};
}

// masked_attention_fwd's arguments as Params (dims: see masked_attention.cu)
inline Params parse_params(const void* q, const void* k, const void* v, const void* bias,
                           void* out, const int64_t* dims, const void* seed,
                           uint32_t drop_threshold, float drop_scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = bias;
  p.out = out;
  p.B = static_cast<int>(dims[0]);
  p.H = static_cast<int>(dims[1]);
  p.Lq = static_cast<int>(dims[2]);
  p.Lk = static_cast<int>(dims[3]);
  int64_t* strides[5] = {p.q_s, p.k_s, p.v_s, p.o_s, p.b_s};
  for (int t = 0; t < 5; ++t)
    for (int i = 0; i < 3; ++i) strides[t][i] = dims[7 + 3 * t + i];
  p.scale = 1.0f / sqrtf(static_cast<float>(dims[4]));
  p.seed = seed;
  p.drop_threshold = drop_threshold;
  p.drop_scale = drop_scale;
  return p;
}

}  // namespace

// One launch per dtype, head dim and dropout setting, each defined in its
// own translation unit, with masked_attention_fwd's arguments.
#define MASKED_ATTENTION_FWD_ARGS                                              \
  const void *q, const void *k, const void *v, const void *bias, void *out,   \
      const void *dims_ptr, void *stream_ptr, const void *seed,               \
      uint32_t drop_threshold, float drop_scale
int masked_attention_fwd_bf16_d32(MASKED_ATTENTION_FWD_ARGS);
int masked_attention_fwd_bf16_d32_drop(MASKED_ATTENTION_FWD_ARGS);
int masked_attention_fwd_bf16_d64(MASKED_ATTENTION_FWD_ARGS);
int masked_attention_fwd_bf16_d64_drop(MASKED_ATTENTION_FWD_ARGS);
int masked_attention_fwd_bf16_d128(MASKED_ATTENTION_FWD_ARGS);
int masked_attention_fwd_bf16_d128_drop(MASKED_ATTENTION_FWD_ARGS);
int masked_attention_fwd_fp32_d32(MASKED_ATTENTION_FWD_ARGS);
int masked_attention_fwd_fp32_d32_drop(MASKED_ATTENTION_FWD_ARGS);
int masked_attention_fwd_fp32_d64(MASKED_ATTENTION_FWD_ARGS);
int masked_attention_fwd_fp32_d64_drop(MASKED_ATTENTION_FWD_ARGS);
int masked_attention_fwd_fp32_d128(MASKED_ATTENTION_FWD_ARGS);
int masked_attention_fwd_fp32_d128_drop(MASKED_ATTENTION_FWD_ARGS);
// head dim 72 (SigLIP), in the D 128 tile, without dropout only
int masked_attention_fwd_bf16_d72(MASKED_ATTENTION_FWD_ARGS);
int masked_attention_fwd_fp32_d72(MASKED_ATTENTION_FWD_ARGS);
// the occupancy of the kernels without dropout, beside them
int masked_attention_blocks_per_sm_bf16_d32(int* blocks);
int masked_attention_blocks_per_sm_bf16_d64(int* blocks);
int masked_attention_blocks_per_sm_bf16_d128(int* blocks);
int masked_attention_blocks_per_sm_fp32_d32(int* blocks);
int masked_attention_blocks_per_sm_fp32_d64(int* blocks);
int masked_attention_blocks_per_sm_fp32_d128(int* blocks);
int masked_attention_blocks_per_sm_bf16_d72(int* blocks);
int masked_attention_blocks_per_sm_fp32_d72(int* blocks);
