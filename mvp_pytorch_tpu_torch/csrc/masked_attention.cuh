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
// The entry point picks the kernel by the input type:
//   - bf16: `hopper::masked_attention_wgmma_kernel` (masked_attention_wgmma.cuh,
//     whose note gives its bound and design): wgmma and TMA, key tiles sized
//     to Lk, the bias staged in shared memory once for all heads that share it;
//   - fp32: `tf32::masked_attention_3xtf32_kernel` (Lk <= 128) and
//     `masked_attention_3xtf32_online_kernel` (Lk > 128), below.
//
// fp32, on the tensor cores (`mma.sync`; the Hopper redesign is queued).
//   Precision. One TF32 pass keeps 10 of fp32's 23 fraction bits and misses
//   the fp32 tolerance (about 9e-4 against 2e-5), so every operand is split
//   in registers into x = hi + lo, hi = tf32(x), lo = tf32(x - hi), and each
//   product is summed as lo.hi + hi.lo + hi.hi with fp32 accumulation
//   (3xTF32): errors near 1e-6. No raw fp32 register reaches the mma, which
//   would drop its low 13 bits. tf32() rounds to nearest, ties away from zero,
//   with two integer operations: the bits of `cvt.rna.tf32.f32`, which on
//   this card is a slow conversion and, twice in every split, was the
//   kernel's largest cost. Scores round as the reference's: s * scale,
//   then + bias, two roundings and no FMA; exp, max and the row sum are fp32.
//   q and k in multiples of 1/8 (the tests' fully-masked rows) have lo = 0,
//   so their scores are exact, as in the reference.
//   Bound. At the rerank shape q, k, v and out are 4 x 384 MB, about 0.46 ms
//   at 3.35 TB/s, against 3 x 48 GFLOP, about 0.29 ms at the 495 TFLOP/s
//   TF32 peak: memory-bound on paper, so the design follows the Ampere-style
//   bf16 kernel that came before the Hopper one. On the card the three `mma.sync` passes and the operand splits,
//   not the copies, set the pace (PERF.md).
//   - Work: 8 warps per (b, h, tile of 128 queries), each warp owning 16
//     query rows; one tile of 128 keys for Lk <= 128. Split-key variants
//     (16 warps of 16 rows, or 8 warps of 32 rows, over half the keys each,
//     exchanging row maxima, sums and p.v halves) were measured no faster
//     or a few percent faster, and are not kept.
//   - Staging: 16-byte `cp.async` copies, q and k one group and v a second,
//     so the scores are computed while v is in flight. Rows of q and k are
//     padded by 8 floats and rows of v by 4, so that the float2 fragment
//     loads below hit 32 distinct banks in each half warp.
//   - Overlap: the Lk <= 128 kernel is persistent, one block of 8 warps per
//     SM. At D <= 64 it keeps two shared-memory stages (213 KB at D 64) and
//     issues the next tile's copies before it computes this one; at D 128
//     one stage fits, and the next tile's q and k are copied during p.v, its
//     v during the next tile's scores.
//   - Products: `mma.sync.m16n8k8` TF32. The head dim of q.k^T is summed in
//     a permuted order (mma column t is dim 2t of the k-step, column t + 4
//     dim 2t + 1), so each thread's q and k pairs are one float2. The
//     probabilities stay in registers as the A operand of p.v: the
//     accumulator's keys 2t, 2t + 1 of an 8-key step serve as A columns t,
//     t + 4, with v rows 2t, 2t + 1 as b0, b1 (the keys are summed in a
//     permuted order). The output dims are permuted within pairs of n-tiles,
//     so v comes in float2 pieces and each thread writes 4 consecutive dims
//     of a row in one 16-byte store.
//   - Softmax: with one key tile, exact over the row and normalised before
//     p.v, in the reference's order; with more, an online softmax over key
//     tiles of 128, normalised after p.v. Keys past Lk get probability 0.
//   The wrapper checks that q, k, v and out are 16-byte aligned and that their
//   (b, h, l) strides are multiples of 4 elements; the launch checks it again.
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
// dropout hash) and the fp32 kernels with their launches. The translation
// units, compiled in parallel (one nvcc each): masked_attention.cu (the C
// entry points), masked_attention_bf16_d{32,64,128}{,_drop}.cu (the bf16
// kernel for one head dim and dropout setting each), masked_attention_fp32.cu
// and masked_attention_fp32_drop.cu. Everything here is in an unnamed
// namespace, so each unit keeps its own copy of what it instantiates.

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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


// ---------------------------------------------------------------------------
// cp.async helpers of the fp32 kernels
// ---------------------------------------------------------------------------

namespace cpasync {

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16-byte asynchronous copy; with ok false it writes 16 zero bytes instead
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace cpasync

// ---------------------------------------------------------------------------
// fp32: tensor-core kernel, 3xTF32
// ---------------------------------------------------------------------------

namespace tf32 {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = kWarps * 16;  // 128 queries per block, 16 per warp
constexpr int kBlockN = 128;          // keys per tile
constexpr int NN = kBlockN / 8;       // n-tiles of q.k^T, k-steps of p.v

// x rounded to TF32 (10 fraction bits, the low 13 bits zero), to nearest
// with ties away from zero: for finite x the bits of cvt.rna.tf32.f32, in two
// integer operations instead of a conversion
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo as two TF32 values: hi = tf32(x), lo = tf32(x - hi), where
// x - hi is exact
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// c += a . b: a 16x8 TF32 (row), b 8x8 TF32 (col), c 16x8 fp32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in three TF32 passes: the cross terms lo.hi and hi.lo, then hi.hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// Shapes of one tile of work, and one stage of shared memory: the q, k and v
// tiles, then the fp32 bias row of the key tile. Rows of q and k are PQK
// floats apart, rows of v PV: with float2 loads a half warp then touches
// 32 distinct banks (q, k: rows g, dims 2t; v: rows 2t, dims 2g).
template <int D>
struct Tile {
  static constexpr int PQK = D + 8;
  static constexpr int PV = D + 4;
  static constexpr int KD = D / 8;        // k-steps of q.k^T over the head dim
  static constexpr int ND = D / 8;        // n-tiles of p.v over the head dim
  static constexpr int kQ = 0;            // offsets in a stage, floats
  static constexpr int kK = kBlockM * PQK;
  static constexpr int kV = kK + kBlockN * PQK;
  static constexpr int kBias = kV + kBlockN * PV;
  static constexpr int kFloats = kBias + kBlockN;
  static constexpr int kStages = D <= 64 ? 2 : 1;  // of the persistent kernel
};

template <int D>
constexpr int smem_bytes(int stages) {
  return stages * Tile<D>::kFloats * 4;
}

// rows [0, n_fill) of a [rows, D] tile with row stride `ls` (elements) into
// shared memory at pitch P; rows from n_valid on are zero-filled
template <int D, int P>
__device__ __forceinline__ void load_tile(float* s, const float* g, int64_t ls,
                                          int n_valid, int n_fill, int tid) {
  constexpr int kChunks = D / 4;  // 16-byte chunks per row
  for (int i = tid; i < n_fill * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool ok = r < n_valid;
    cpasync::cp_async16(cpasync::smem_u32(s + r * P + c), ok ? g + r * ls + c : g, ok);
  }
}

// The loops over the key tile below run over all 128 keys with no branch;
// keys past Lk are zero rows of k and v and a bias of -inf, so they add
// nothing.

// s = q.k^T for the warp's 16 rows against the key tile, s[j] holding keys
// 8j .. 8j + 7 in the mma accumulator layout: s[j][e] is row g + 8 (e / 2),
// key 8j + 2t + e % 2. The head dim is summed in a permuted order: at k-step
// kk, mma column t is dim 8kk + 2t and column t + 4 dim 8kk + 2t + 1, so a
// thread's two A values of a row, and its two B values, are one float2.
template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[NN][4], const float* qs,
                                        const float* ks, int row0, int lane) {
  constexpr int P = Tile<D>::PQK;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < Tile<D>::KD; ++kk) {
    const float2 qa = *reinterpret_cast<const float2*>(qs + (row0 + g) * P + kk * 8 + 2 * t);
    const float2 qb = *reinterpret_cast<const float2*>(qs + (row0 + g + 8) * P + kk * 8 + 2 * t);
    uint32_t ah[4], al[4];
    split(qa.x, ah[0], al[0]);  // row g, column t
    split(qb.x, ah[1], al[1]);  // row g + 8, column t
    split(qa.y, ah[2], al[2]);  // row g, column t + 4
    split(qb.y, ah[3], al[3]);  // row g + 8, column t + 4
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      const float2 kb = *reinterpret_cast<const float2*>(ks + (j * 8 + g) * P + kk * 8 + 2 * t);
      uint32_t bh0, bl0, bh1, bl1;
      split(kb.x, bh0, bl0);  // row t, column g (key 8j + g)
      split(kb.y, bh1, bl1);  // row t + 4
      mma_3xtf32(s[j], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// The scores as the reference rounds them, in place: s * scale, then + bias,
// two roundings and no FMA; keys past nk -inf. The bias comes from the
// block's row in shared memory (-inf past nk already), or, per query, from
// `bias_rows` (row g; row g + 8 is row_stride further). Returns the maxima
// of rows g, g + 8 over the tile (finite: key 0 is in range).
template <typename TB>
__device__ __forceinline__ void score_tile(float (&s)[NN][4], float (&mx)[2],
                                           const float* bias_s, const TB* bias_rows,
                                           int64_t row_stride, int t, int nk,
                                           float scale) {
  mx[0] = mx[1] = -INFINITY;
  // one branch for the tile, none per score
  auto epilogue = [&](auto bias_of) {
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, col = j * 8 + 2 * t + e % 2;
        const float x = __fadd_rn(__fmul_rn(s[j][e], scale), bias_of(r, col));
        s[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
  };
  if (bias_rows != nullptr)
    epilogue([&](int r, int col) {
      return col < nk ? to_f(bias_rows[r * 8 * row_stride + col]) : -INFINITY;
    });
  else
    epilogue([&](int, int col) { return bias_s[col]; });
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

// s = exp(s - m) in place (0 where s is -inf); returns the row sums
__device__ __forceinline__ void exp_tile(float (&s)[NN][4], const float (&m)[2],
                                         float (&sum)[2]) {
  sum[0] = sum[1] = 0.f;
#pragma unroll
  for (int j = 0; j < NN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - m[e / 2]);
      sum[e / 2] += s[j][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }
}

// o += p . v over the key tile, p in the score accumulator layout. At k-step
// j (keys 8j .. 8j + 7) mma column t is key 8j + 2t and column t + 4 key
// 8j + 2t + 1, so A is p[j][0], p[j][2], p[j][1], p[j][3] as it stands, and
// b0, b1 are v rows 8j + 2t, 8j + 2t + 1. The output dims are permuted
// within each pair of n-tiles: column g of n-tile 2m is dim 16m + 2g, of
// n-tile 2m + 1 dim 16m + 2g + 1, so the B values of both are one float2 of
// each v row, and o[2m][e], o[2m + 1][e] are dims 16m + 4t + 2e, + 1.
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[Tile<D>::ND][4],
                                        const float (&p)[NN][4], const float* vs,
                                        int lane) {
  constexpr int P = Tile<D>::PV;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NN; ++j) {
    uint32_t ah[4], al[4];
    split(p[j][0], ah[0], al[0]);  // row g, key 8j + 2t: column t
    split(p[j][2], ah[1], al[1]);  // row g + 8, key 8j + 2t
    split(p[j][1], ah[2], al[2]);  // row g, key 8j + 2t + 1: column t + 4
    split(p[j][3], ah[3], al[3]);  // row g + 8, key 8j + 2t + 1
    const float* v0 = vs + (j * 8 + 2 * t) * P + 2 * g;
#pragma unroll
    for (int m = 0; m < Tile<D>::ND / 2; ++m) {
      const float2 x0 = *reinterpret_cast<const float2*>(v0 + 16 * m);      // key 8j + 2t
      const float2 x1 = *reinterpret_cast<const float2*>(v0 + P + 16 * m);  // key 8j + 2t + 1
      uint32_t h0, l0, h1, l1;
      split(x0.x, h0, l0);
      split(x1.x, h1, l1);
      mma_3xtf32(o[2 * m], ah, al, h0, h1, l0, l1);
      split(x0.y, h0, l0);
      split(x1.y, h1, l1);
      mma_3xtf32(o[2 * m + 1], ah, al, h0, h1, l0, l1);
    }
  }
}

// The block's share of one (b, h, query tile).
struct Work {
  const float* q;   // first query row of the tile
  const float* k;
  const float* v;
  float* out;       // first query row of the tile
  const void* bias; // bias at (b, h), or null
  int q0, mq;       // first query, queries in the tile
  int64_t bh;       // b H + h, for the dropout's element index
};

template <typename TB>
__device__ __forceinline__ Work work_of(const Params& p, int64_t tile) {
  const int n_qt = (p.Lq + kBlockM - 1) / kBlockM;
  const int qt = static_cast<int>(tile % n_qt);
  const int h = static_cast<int>((tile / n_qt) % p.H);
  const int b = static_cast<int>(tile / (static_cast<int64_t>(n_qt) * p.H));
  Work w;
  w.q0 = qt * kBlockM;
  w.mq = min(kBlockM, p.Lq - w.q0);
  w.bh = static_cast<int64_t>(b) * p.H + h;
  w.q = static_cast<const float*>(p.q) + b * p.q_s[0] + h * p.q_s[1] + w.q0 * p.q_s[2];
  w.k = static_cast<const float*>(p.k) + b * p.k_s[0] + h * p.k_s[1];
  w.v = static_cast<const float*>(p.v) + b * p.v_s[0] + h * p.v_s[1];
  w.out = static_cast<float*>(p.out) + b * p.o_s[0] + h * p.o_s[1] + w.q0 * p.o_s[2];
  w.bias = p.bias == nullptr ? nullptr
           : static_cast<const TB*>(p.bias) + b * p.b_s[0] + h * p.b_s[1];
  return w;
}

// The bias of key k0 + j for every query: 0 without a bias, -inf past the
// tile's nk keys. Only for a bias broadcast over queries.
template <typename TB>
__device__ __forceinline__ float bias_at(const Work& w, int k0, int j, int nk) {
  if (j >= nk) return -INFINITY;
  return w.bias == nullptr ? 0.f : to_f(static_cast<const TB*>(w.bias)[k0 + j]);
}

// q.k^T, the scores and their softmax for the warp's 16 rows of one key
// tile, in place in s: kExact, normalised over the row; else exp(s - m_new),
// with m_r, l_r and o rescaled (the online softmax). With kDrop each
// probability is then multiplied by its dropout factor; m_r and l_r take the
// undropped ones.
template <typename TB, int D, bool kExact, bool kDrop>
__device__ __forceinline__ void softmax_tile(
    float (&s)[NN][4], float (&o)[Tile<D>::ND][4], float (&m_r)[2], float (&l_r)[2],
    const float* st, const Params& prm, const Work& w, int k0, int nk, int row0,
    int lane, const DropMask& dm) {
  const int g = lane / 4, t = lane % 4;
  // a per-query bias is read through its strides; rows past Lq repeat the last
  const bool row_bias = w.bias != nullptr && prm.b_s[2] != 0;
  const TB* rows = nullptr;
  int64_t row_stride = 0;
  if (row_bias) {
    const int qa = min(w.q0 + row0 + g, prm.Lq - 1);
    rows = static_cast<const TB*>(w.bias) + qa * prm.b_s[2] + k0;
    row_stride = w.q0 + row0 + g + 8 < prm.Lq ? prm.b_s[2] : 0;
  }
  float mx[2], sum[2];
  qk_tile<D>(s, st + Tile<D>::kQ, st + Tile<D>::kK, row0, lane);
  score_tile<TB>(s, mx, st + Tile<D>::kBias, rows, row_stride, t, nk, prm.scale);
  if (kExact) {
    exp_tile(s, mx, sum);
    // normalised before p.v, in the reference's order
    const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= inv[e / 2];
  } else {
    float m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) m_new[r] = fmaxf(m_r[r], mx[r]);
    exp_tile(s, m_new, sum);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float corr = expf(m_r[r] - m_new[r]);  // 0 on the first tile
      l_r[r] = l_r[r] * corr + sum[r];
      m_r[r] = m_new[r];
#pragma unroll
      for (int j = 0; j < Tile<D>::ND; ++j) {
        o[j][2 * r] *= corr;
        o[j][2 * r + 1] *= corr;
      }
    }
  }
  if constexpr (kDrop) {
    uint64_t rb[2];
    drop_rows(rb, prm, w.bh, w.q0 + row0 + g, k0, t);
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= dm.factor(rb[e / 2] + 8 * j + e % 2);
  }
}

// the warp's 16 output rows, times f per row, in 16-byte stores (o as
// pv_tile leaves it: 4 consecutive dims of a row per thread and n-tile
// pair); rows from `rows` on are not written
template <int D>
__device__ __forceinline__ void store_out(const float (&o)[Tile<D>::ND][4],
                                          const float (&f)[2], float* og, int64_t ls,
                                          int rows, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (g + 8 * r >= rows) continue;
    float* row = og + (g + 8 * r) * ls + 4 * t;
#pragma unroll
    for (int m = 0; m < Tile<D>::ND / 2; ++m)
      *reinterpret_cast<float4*>(row + 16 * m) = make_float4(
          o[2 * m][2 * r] * f[r], o[2 * m + 1][2 * r] * f[r],
          o[2 * m][2 * r + 1] * f[r], o[2 * m + 1][2 * r + 1] * f[r]);
  }
}

// Lk <= 128: one key tile, the exact row softmax. The block is persistent: it
// takes tiles blockIdx.x, blockIdx.x + gridDim.x, ... With two stages of
// shared memory it issues the next tile's copies before it computes this one;
// with one, the next q and k are copied during p.v and the next v during the
// next scores.
template <typename TB, int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
masked_attention_3xtf32_kernel(Params p) {
  using T = Tile<D>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * 16;
  const int nk = p.Lk;
  const bool bias_row = p.bias == nullptr || p.b_s[2] == 0;  // broadcast over queries
  const int64_t n_tiles = static_cast<int64_t>((p.Lq + kBlockM - 1) / kBlockM) * p.H * p.B;
  DropMask dm{};
  if constexpr (kDrop) dm = drop_mask(p);

  // copies of one tile into a stage: q and k one group, v the next
  auto issue_qk = [&](const Work& w, float* st) {
    load_tile<D, T::PQK>(st + T::kQ, w.q, p.q_s[2], w.mq, (w.mq + 15) / 16 * 16, tid);
    load_tile<D, T::PQK>(st + T::kK, w.k, p.k_s[2], nk, kBlockN, tid);
    cpasync::cp_async_commit();
  };
  auto issue_v = [&](const Work& w, float* st) {
    load_tile<D, T::PV>(st + T::kV, w.v, p.v_s[2], nk, kBlockN, tid);
    cpasync::cp_async_commit();
  };

  int64_t tile = blockIdx.x;
  {
    const Work w = work_of<TB>(p, tile);
    issue_qk(w, smem);
    issue_v(w, smem);
    if (bias_row && tid < kBlockN) smem[T::kBias + tid] = bias_at<TB>(w, 0, tid, nk);
  }

  for (int i = 0; tile < n_tiles; ++i, tile += gridDim.x) {
    float* st = smem + (T::kStages == 2 ? (i & 1) * T::kFloats : 0);
    float* nx = smem + (T::kStages == 2 ? ((i & 1) ^ 1) * T::kFloats : 0);
    const int64_t next = tile + gridDim.x;
    const bool has_next = next < n_tiles;
    float bias_next = 0.f;  // held in a register while this tile computes
    if (has_next && bias_row && tid < kBlockN)
      bias_next = bias_at<TB>(work_of<TB>(p, next), 0, tid, nk);
    if constexpr (T::kStages == 2) {
      __syncthreads();  // the last tile is done: its stage is free
      if (has_next) {
        const Work wn = work_of<TB>(p, next);
        issue_qk(wn, nx);
        issue_v(wn, nx);
      } else {
        cpasync::cp_async_commit();  // empty groups keep the count
        cpasync::cp_async_commit();
      }
      cpasync::cp_async_wait<2>();  // q, k and v of this tile
    } else {
      cpasync::cp_async_wait<1>();  // q and k of this tile; v may be in flight
    }
    __syncthreads();  // this tile's copies and bias row are in

    const Work w = work_of<TB>(p, tile);
    const bool active = row0 < w.mq;  // warp-uniform: the warp has query rows
    float s[NN][4];
    float o[T::ND][4];
    float m_r[2], l_r[2];
    if (active) softmax_tile<TB, D, true, kDrop>(s, o, m_r, l_r, st, p, w, 0, nk, row0, lane, dm);

    if constexpr (T::kStages == 1) {
      __syncthreads();  // every warp is done with q, k and the bias row
      if (has_next) issue_qk(work_of<TB>(p, next), st);
      else cpasync::cp_async_commit();
      if (bias_row && tid < kBlockN && has_next) st[T::kBias + tid] = bias_next;
      cpasync::cp_async_wait<1>();
      __syncthreads();  // v of this tile is in
    }

    if (active) {
#pragma unroll
      for (int j = 0; j < T::ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
      pv_tile<D>(o, s, st + T::kV, lane);
      const float f[2] = {1.f, 1.f};
      store_out<D>(o, f, w.out + row0 * p.o_s[2], p.o_s[2], w.mq - row0, lane);
    }
    if constexpr (T::kStages == 1) {
      __syncthreads();  // every warp is done with v
      if (has_next) issue_v(work_of<TB>(p, next), st);
      else cpasync::cp_async_commit();
    } else {
      if (bias_row && tid < kBlockN && has_next) nx[T::kBias + tid] = bias_next;
    }
  }
}

// Lk > 128: one block per (b, h, query tile) walks the keys in tiles of 128
// with the online softmax.
template <typename TB, int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
masked_attention_3xtf32_online_kernel(Params p) {
  using T = Tile<D>;
  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * 16;
  const Work w = work_of<TB>(p, blockIdx.x);
  const bool active = row0 < w.mq;  // warp-uniform: the warp has query rows
  const bool bias_row = p.bias == nullptr || p.b_s[2] == 0;
  DropMask dm{};
  if constexpr (kDrop) dm = drop_mask(p);

  load_tile<D, T::PQK>(st + T::kQ, w.q, p.q_s[2], w.mq, (w.mq + 15) / 16 * 16, tid);
  float o[T::ND][4];
#pragma unroll
  for (int j = 0; j < T::ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8
  float l_r[2] = {0.f, 0.f};               // running sum

  for (int k0 = 0; k0 < p.Lk; k0 += kBlockN) {
    const int nk = min(kBlockN, p.Lk - k0);
    if (k0 > 0) __syncthreads();  // every warp is done with the last tile
    load_tile<D, T::PQK>(st + T::kK, w.k + k0 * p.k_s[2], p.k_s[2], nk, kBlockN, tid);
    cpasync::cp_async_commit();  // group: (q and) k
    load_tile<D, T::PV>(st + T::kV, w.v + k0 * p.v_s[2], p.v_s[2], nk, kBlockN, tid);
    cpasync::cp_async_commit();  // group: v
    if (bias_row && tid < kBlockN) st[T::kBias + tid] = bias_at<TB>(w, k0, tid, nk);
    cpasync::cp_async_wait<1>();
    __syncthreads();  // q, k and the bias row are in

    float s[NN][4];
    if (active)
      softmax_tile<TB, D, false, kDrop>(s, o, m_r, l_r, st, p, w, k0, nk, row0, lane, dm);

    cpasync::cp_async_wait<0>();
    __syncthreads();  // v is in

    if (active) pv_tile<D>(o, s, st + T::kV, lane);
  }
  if (active) {
    const float f[2] = {1.f / l_r[0], 1.f / l_r[1]};
    store_out<D>(o, f, w.out + row0 * p.o_s[2], p.o_s[2], w.mq - row0, lane);
  }
}

bool aligned16(const void* ptr, const int64_t* strides) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 4 != 0) return false;
  return true;
}

// resident blocks per SM of the persistent kernel, after allowing its shared memory
template <typename TB, int D, bool kDrop = false>
cudaError_t blocks_per_sm(int* n) {
  constexpr int bytes = smem_bytes<D>(Tile<D>::kStages);
  auto kernel = masked_attention_3xtf32_kernel<TB, D, kDrop>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, kThreads, bytes);
}

template <typename TB, int D, bool kDrop>
cudaError_t launch_k(const Params& p, cudaStream_t stream) {
  if (!aligned16(p.q, p.q_s) || !aligned16(p.k, p.k_s) || !aligned16(p.v, p.v_s)
      || !aligned16(p.out, p.o_s))
    return cudaErrorMisalignedAddress;
  const int64_t n_tiles = static_cast<int64_t>((p.Lq + kBlockM - 1) / kBlockM) * p.H * p.B;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (p.Lk > kBlockN) {
    constexpr int bytes = smem_bytes<D>(1);
    auto kernel = masked_attention_3xtf32_online_kernel<TB, D, kDrop>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(n_tiles), kThreads, bytes, stream>>>(p);
    return cudaGetLastError();
  }
  // as many persistent blocks as fit on the card at once, once per device
  static int resident[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = blocks_per_sm<TB, D, kDrop>(&per_sm);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  constexpr int bytes = smem_bytes<D>(Tile<D>::kStages);
  auto kernel = masked_attention_3xtf32_kernel<TB, D, kDrop>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int64_t grid = n_tiles < resident[dev] ? n_tiles : resident[dev];
  kernel<<<static_cast<unsigned>(grid), kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tf32

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

// bias dtype: 0 fp32, 1 bf16
template <typename Op>
cudaError_t dispatch_fp32(const Op& op, int bias_dtype, int d) {
  auto by_d = [&](auto tb) -> cudaError_t {
    using TB = decltype(tb);
    switch (d) {
      case 32: return op.template run<TB, 32>();
      case 64: return op.template run<TB, 64>();
      case 128: return op.template run<TB, 128>();
      default: return cudaErrorInvalidValue;
    }
  };
  if (bias_dtype == 0) return by_d(0.f);
  if (bias_dtype == 1) return by_d(__nv_bfloat16());
  return cudaErrorInvalidValue;
}

template <bool kDrop>
struct LaunchFp32 {
  const Params* p;
  cudaStream_t stream;
  template <typename TB, int D>
  cudaError_t run() const { return tf32::launch_k<TB, D, kDrop>(*p, stream); }
};

struct OccupancyFp32 {
  int* n;
  template <typename TB, int D>
  cudaError_t run() const { return tf32::blocks_per_sm<TB, D>(n); }
};

// masked_attention_fwd (masked_attention.cu) in fp32, for one dropout setting
// (kDrop: the launch has a seed)
template <bool kDrop>
int fwd_fp32(const void* q, const void* k, const void* v, const void* bias, void* out,
             const void* dims_ptr, void* stream_ptr, const void* seed,
             uint32_t drop_threshold, float drop_scale) {
  const int64_t* dims = static_cast<const int64_t*>(dims_ptr);
  const Params p = parse_params(q, k, v, bias, out, dims, seed, drop_threshold, drop_scale);
  if (p.B <= 0 || p.H <= 0 || p.Lq <= 0 || p.Lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bias_dtype = bias == nullptr ? 0 : static_cast<int>(dims[6]);
  const LaunchFp32<kDrop> op{&p, static_cast<cudaStream_t>(stream_ptr)};
  return static_cast<int>(dispatch_fp32(op, bias_dtype, static_cast<int>(dims[4])));
}

}  // namespace

// One launch per dtype, head dim (bf16) and dropout setting, each defined in
// its own translation unit, with masked_attention_fwd's arguments.
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
int masked_attention_fwd_fp32(MASKED_ATTENTION_FWD_ARGS);
int masked_attention_fwd_fp32_drop(MASKED_ATTENTION_FWD_ARGS);
// the occupancy of the kernels without dropout, beside them
int masked_attention_blocks_per_sm_bf16_d32(int* blocks);
int masked_attention_blocks_per_sm_bf16_d64(int* blocks);
int masked_attention_blocks_per_sm_bf16_d128(int* blocks);
int masked_attention_blocks_per_sm_fp32(int bias_dtype, int d, int* blocks);
