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
// The entry point picks the kernel by the input type and, for bf16, by Lk.
//
// bf16: `masked_attention_mma_kernel` (Lk <= 128) and
// `masked_attention_mma_online_kernel` (Lk > 128), on the tensor cores.
//   Bound. At the main path's rerank shape (1,000 pairs, fused L = 125,
//   H = 12, D = 64) q, k, v and out are 4 x 192 MB = 768 MB, about 0.23 ms at
//   3.35 TB/s, against 48 GFLOP, about 0.05 ms at the bf16 tensor-core peak:
//   the function is memory-bound, so the design reads q, k, v once, writes
//   out once, and keeps the next tile's copies in flight while it computes.
//   - Work: 8 warps per (b, h, tile of 128 queries), each warp owning 16
//     query rows. Every main-path length (125, 75, 70) fits one tile of
//     queries and one of keys, so k and v of a (b, h) are read once.
//   - Staging: q, k and v come in as bf16 through 16-byte `cp.async` copies
//     into shared memory, rows padded by 16 bytes so that `ldmatrix` is free
//     of bank conflicts; q and k form one copy group and v a second, so the
//     scores are computed while v is still in flight.
//   - Overlap: for Lk <= 128 the block is persistent (as many as fit on the
//     card, 2 per SM at D 64) and keeps two stages of shared memory: it issues
//     the next tile's copies before it computes this one. Blocks that each
//     took one tile were measured slower: the two blocks of an SM load and
//     compute in step, so copies and arithmetic did not overlap.
//   - Products: q.k^T and p.v run as `mma.sync.m16n8k16` bf16 with fp32
//     accumulation; the probabilities stay in registers as the A operand of
//     p.v, and v is read with `ldmatrix.trans`.
//   - Scores round to bf16 where the reference rounds them: q.k, times the
//     bf16 scale, plus the bf16 bias, each a packed bf16x2 operation. The row
//     max is taken over those, s - m rounds to bf16 as the reference's bf16
//     subtraction does, and exp and the row sum run in fp32. With one key
//     tile the softmax is exact over the whole row: the probabilities are
//     normalised, then rounded to bf16 before p.v, in the reference's order.
//     With more, the block walks the keys in tiles of 128 with an online
//     softmax (running max and sum) and normalises after p.v. Keys past Lk
//     get probability 0; a row whose keys are all masked (bias -10000) comes
//     out uniform, as in the reference.
//   - Output: staged through the warp's own q rows in shared memory and
//     written in 16-byte stores.
//   The wrapper checks that q, k, v and out are 16-byte aligned and that their
//   (b, h, l) strides are multiples of 8 elements; the launch checks it again.
//
// fp32: `masked_attention_kernel`, on the CUDA cores, keeps fp32 scores
//   throughout and rounds as the reference does (multiply, then add; no FMA),
//   which TF32 tensor cores could not match at the fp32 tolerance. One block
//   of 4 warps per (b, h, tile of 32 queries), each warp owning 8 rows; the
//   keys are walked in tiles of 32 with an online softmax, k staged transposed
//   and v as is in shared memory. At the rerank shape its 48 GFLOP of fp32
//   FMAs bound it to 0.72 ms at the 67 TFLOP/s CUDA-core peak.

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
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// fp32: CUDA-core kernel
// ---------------------------------------------------------------------------

namespace fp32 {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 32 queries per block
constexpr int kBlockK = 32;                      // keys per tile, one per lane
constexpr int kThreads = kWarps * 32;

template <int D>
constexpr int smem_floats() {
  // q tile, k tile transposed (row pitch kBlockK + 1), v tile, probabilities
  return kBlockQ * D + D * (kBlockK + 1) + kBlockK * D + kBlockQ * kBlockK;
}

template <typename TB, int D>
__global__ void __launch_bounds__(kThreads)
masked_attention_kernel(Params p) {
  constexpr int C = D / 32;  // output dims per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kt = qs + kBlockQ * D;
  float* vs = kt + D * (kBlockK + 1);
  float* ps = vs + kBlockK * D;

  const int n_qt = (p.Lq + kBlockQ - 1) / kBlockQ;
  const int64_t bid = blockIdx.x;
  const int qt = static_cast<int>(bid % n_qt);
  const int h = static_cast<int>((bid / n_qt) % p.H);
  const int b = static_cast<int>(bid / (static_cast<int64_t>(n_qt) * p.H));
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_s[0] + h * p.q_s[1];
  const float* kg = static_cast<const float*>(p.k) + b * p.k_s[0] + h * p.k_s[1];
  const float* vg = static_cast<const float*>(p.v) + b * p.v_s[0] + h * p.v_s[1];
  const TB* bg = p.bias == nullptr ? nullptr
                 : static_cast<const TB*>(p.bias) + b * p.b_s[0] + h * p.b_s[1];

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    qs[i] = qi < p.Lq ? qg[qi * p.q_s[2] + d] : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][C];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }
  const int row0 = warp * kRowsPerWarp;

  for (int k0 = 0; k0 < p.Lk; k0 += kBlockK) {
    __syncthreads();  // previous tile fully consumed (and q tile written)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const int kj = k0 + j;
      const bool ok = kj < p.Lk;
      kt[d * (kBlockK + 1) + j] = ok ? kg[kj * p.k_s[2] + d] : 0.f;
      vs[j * D + d] = ok ? vg[kj * p.v_s[2] + d] : 0.f;
    }
    __syncthreads();

    // scores of key k0 + lane against the warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float k_0 = kt[(d + 0) * (kBlockK + 1) + lane];
      const float k_1 = kt[(d + 1) * (kBlockK + 1) + lane];
      const float k_2 = kt[(d + 2) * (kBlockK + 1) + lane];
      const float k_3 = kt[(d + 3) * (kBlockK + 1) + lane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 q4 = *reinterpret_cast<const float4*>(&qs[(row0 + r) * D + d]);
        s[r] += q4.x * k_0 + q4.y * k_1 + q4.z * k_2 + q4.w * k_3;
      }
    }

    const int kj = k0 + lane;
    const bool key_ok = kj < p.Lk;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = min(q0 + row0 + r, p.Lq - 1);
      float x;
      if (!key_ok) {
        x = -INFINITY;
      } else {
        const float bias = bg == nullptr ? 0.f : to_f(bg[qi * p.b_s[2] + kj]);
        // two roundings, as the reference's multiply then add (no FMA)
        x = __fadd_rn(__fmul_rn(s[r], p.scale), bias);
      }
      float tmax = x;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[r], tmax);  // finite: key k0 is in range
      const float corr = expf(m[r] - m_new);
      const float e = key_ok ? expf(x - m_new) : 0.f;
      float tsum = e;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
      l[r] = l[r] * corr + tsum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= corr;
      ps[(row0 + r) * kBlockK + lane] = e;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float vv[4][C];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < C; ++c) vv[t][c] = vs[(j + t) * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(&ps[(row0 + r) * kBlockK + j]);
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[r][c] += p4.x * vv[0][c] + p4.y * vv[1][c] + p4.z * vv[2][c] + p4.w * vv[3][c];
      }
    }
    __syncwarp();
  }

  float* og = static_cast<float*>(p.out) + b * p.o_s[0] + h * p.o_s[1];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= p.Lq) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int c = 0; c < C; ++c) og[qi * p.o_s[2] + lane + 32 * c] = acc[r][c] * inv;
  }
}

template <typename TB, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kernel = masked_attention_kernel<TB, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int64_t n_qt = (p.Lq + kBlockQ - 1) / kBlockQ;
  const int64_t blocks = n_qt * p.H * p.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename TB, int D>
cudaError_t blocks_per_sm(int* n) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kernel = masked_attention_kernel<TB, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, kThreads, bytes);
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = kWarps * 16;  // 128 queries per block, 16 per warp
constexpr int kBlockN = 128;          // keys per tile
constexpr int kPad = 8;               // bf16 of row padding: rows 16 bytes apart in the banks


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

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a . b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// rows [0, n_fill) of a [rows, D] tile with row stride `ls` (elements) into
// shared memory at pitch D + kPad; rows from n_valid on are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int64_t ls,
                                          int n_valid, int n_fill, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < n_fill * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r < n_valid;
    cp_async16(smem_u32(s + r * (D + kPad) + c), ok ? g + r * ls + c : g, ok);
  }
}

// Shapes of one tile of work, and one stage of shared memory: the q, k and v
// tiles (row pitch P), then the bf16 bias row of the key tile.
template <int D>
struct Tile {
  static constexpr int P = D + kPad;      // smem row pitch, bf16
  static constexpr int KD = D / 16;       // k-steps of q.k^T over the head dim
  static constexpr int ND = D / 8;        // n-tiles of p.v over the head dim
  static constexpr int NN = kBlockN / 8;  // n-tiles of q.k^T over the key tile
  static constexpr int kQ = 0;            // offsets in a stage, bf16
  static constexpr int kK = kBlockM * P;
  static constexpr int kV = kK + kBlockN * P;
  static constexpr int kBias = kV + kBlockN * P;
  static constexpr int kElems = kBias + kBlockN;
};

template <int D>
constexpr int smem_bytes(int stages) {
  return stages * Tile<D>::kElems * 2;
}

// The loops over the key tile below run over all 128 keys with no branch, so
// that the compiler can schedule the unrolled body as one block; keys past Lk
// are zero rows of k and v and a bias of -inf, so they add nothing.

// s = q.k^T for the warp's 16 rows against the key tile: s[j] holds keys
// 8j .. 8j + 7 in the mma accumulator layout
template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[Tile<D>::NN][4], const bf16* qs,
                                        const bf16* ks, int row0, int lane) {
  constexpr int P = Tile<D>::P;
#pragma unroll
  for (int j = 0; j < Tile<D>::NN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < Tile<D>::KD; ++kk) {
    uint32_t a[4];
    ldsm_x4(smem_u32(qs + (row0 + lane % 8 + 8 * (lane / 8 % 2)) * P
                     + kk * 16 + 8 * (lane / 16)), a);
#pragma unroll
    for (int jj = 0; jj < Tile<D>::NN / 2; ++jj) {  // two 8-key n-tiles at a time
      uint32_t kb[4];
      ldsm_x4(smem_u32(ks + (jj * 16 + lane % 8 + 8 * (lane / 16)) * P
                       + kk * 16 + 8 * (lane / 8 % 2)), kb);
      mma_bf16(s[2 * jj], a, kb[0], kb[1]);
      mma_bf16(s[2 * jj + 1], a, kb[2], kb[3]);
    }
  }
}

// The scores as the reference rounds them, two keys to a bf16x2 register:
// q.k rounded to bf16, times the bf16 scale, plus the bf16 bias; keys past nk
// -inf. Each bf16x2 operation is correctly rounded, which is what the
// reference's fp32 operation followed by a rounding to bf16 gives (fp32 holds
// more than 2 x 8 + 2 bits). sb[j][r] holds keys 8j + 2t, 8j + 2t + 1 of row
// g + 8r. Returns the row maxima over the tile (finite: key 0 is in range).
template <typename TB, int D>
__device__ __forceinline__ void score_tile(const float (&acc)[Tile<D>::NN][4],
                                           __nv_bfloat162 (&sb)[Tile<D>::NN][2],
                                           float (&mx)[2], const bf16* bias_s,
                                           const TB* bias_rows, int64_t row_stride,
                                           int t, int nk, float scale) {
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);
  const __nv_bfloat162 ninf2 = __float2bfloat162_rn(-INFINITY);
  __nv_bfloat162 mx2[2] = {ninf2, ninf2};
#pragma unroll
  for (int j = 0; j < Tile<D>::NN; ++j) {
    const int col = j * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      __nv_bfloat162 b2;
      if (bias_rows != nullptr) {  // per-query bias, read through its strides
        const TB* row = bias_rows + r * 8 * row_stride;
        b2 = __floats2bfloat162_rn(col < nk ? to_f(row[col]) : -INFINITY,
                                   col + 1 < nk ? to_f(row[col + 1]) : -INFINITY);
      } else {                     // the block's bias row, already bf16
        b2 = *reinterpret_cast<const __nv_bfloat162*>(bias_s + col);
      }
      __nv_bfloat162 x = __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
      x = __hmul2(x, scale2);
      x = __hadd2(x, b2);
      sb[j][r] = x;
      mx2[r] = __hmax2(mx2[r], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(__low2float(mx2[r]), __high2float(mx2[r]));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

// p = exp(bf16(s - m)) in fp32 (0 where s is -inf), as the reference
// subtracts in bf16 and exponentiates in fp32; returns the row sums
template <int D>
__device__ __forceinline__ void exp_tile(const __nv_bfloat162 (&sb)[Tile<D>::NN][2],
                                         float (&p)[Tile<D>::NN][4],
                                         const float (&m)[2], float (&sum)[2]) {
  const __nv_bfloat162 m2[2] = {__float2bfloat162_rn(m[0]), __float2bfloat162_rn(m[1])};
  sum[0] = sum[1] = 0.f;
#pragma unroll
  for (int j = 0; j < Tile<D>::NN; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 d = __bfloat1622float2(__hsub2(sb[j][r], m2[r]));
      const float x0 = __expf(d.x);
      const float x1 = __expf(d.y);
      p[j][2 * r] = x0;
      p[j][2 * r + 1] = x1;
      sum[r] += x0 + x1;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }
}

// o += p . v over the key tile. p is bf16 in the score
// accumulator layout (pk[j][r]: keys 8j + 2t, + 1 of row g + 8r), which is the
// A operand of the mma; v comes through ldmatrix.trans.
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[Tile<D>::ND][4],
                                        const uint32_t (&pk)[Tile<D>::NN][2],
                                        const bf16* vs, int lane) {
  constexpr int P = Tile<D>::P;
#pragma unroll
  for (int kk = 0; kk < Tile<D>::NN / 2; ++kk) {  // 16 keys per step
    const uint32_t a[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0],
                           pk[2 * kk + 1][1]};
#pragma unroll
    for (int dj = 0; dj < Tile<D>::ND; dj += 2) {
      uint32_t vb[4];
      ldsm_x4_trans(smem_u32(vs + (kk * 16 + lane % 8 + 8 * (lane / 8 % 2)) * P
                             + dj * 8 + 8 * (lane / 16)), vb);
      mma_bf16(o[dj], a, vb[0], vb[1]);
      mma_bf16(o[dj + 1], a, vb[2], vb[3]);
    }
  }
}

// The block's share of one (b, h, query tile).
struct Work {
  const bf16* q;    // first query row of the tile
  const bf16* k;
  const bf16* v;
  bf16* out;        // first query row of the tile
  const void* bias; // bias at (b, h), or null
  int q0, mq;       // first query, queries in the tile
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
  w.q = static_cast<const bf16*>(p.q) + b * p.q_s[0] + h * p.q_s[1] + w.q0 * p.q_s[2];
  w.k = static_cast<const bf16*>(p.k) + b * p.k_s[0] + h * p.k_s[1];
  w.v = static_cast<const bf16*>(p.v) + b * p.v_s[0] + h * p.v_s[1];
  w.out = static_cast<bf16*>(p.out) + b * p.o_s[0] + h * p.o_s[1] + w.q0 * p.o_s[2];
  w.bias = p.bias == nullptr ? nullptr
           : static_cast<const TB*>(p.bias) + b * p.b_s[0] + h * p.b_s[1];
  return w;
}

// The bias of key k0 + j for every query, before rounding: 0 without a bias,
// -inf past the tile's nk keys. Only for a bias broadcast over queries.
template <typename TB>
__device__ __forceinline__ float bias_at(const Work& w, int k0, int j, int nk) {
  if (j >= nk) return -INFINITY;
  return w.bias == nullptr ? 0.f : to_f(static_cast<const TB*>(w.bias)[k0 + j]);
}

// q.k^T, the scores and their softmax for the warp's 16 rows of one key
// tile: pk holds the probabilities rounded to bf16 (kExact: normalised over
// the row; else exp(s - m_new), with m_r, l_r and o rescaled: the online
// softmax).
template <typename TB, int D, bool kExact>
__device__ __forceinline__ void softmax_tile(
    uint32_t (&pk)[Tile<D>::NN][2], float (&o)[Tile<D>::ND][4], float (&m_r)[2],
    float (&l_r)[2], const bf16* st, const Params& prm, const Work& w, int k0,
    int nk, int row0, int lane) {
  constexpr int NN = Tile<D>::NN;
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
  float p[NN][4], mx[2], sum[2];
  __nv_bfloat162 sb[NN][2];
  qk_tile<D>(p, st + Tile<D>::kQ, st + Tile<D>::kK, row0, lane);
  score_tile<TB, D>(p, sb, mx, st + Tile<D>::kBias, rows, row_stride, t, nk,
                    prm.scale);
  if (kExact) {
    exp_tile<D>(sb, p, mx, sum);
    // normalised before the rounding to bf16, in the reference's order
    const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        pk[j][r] = pack_bf16(p[j][2 * r] * inv[r], p[j][2 * r + 1] * inv[r]);
  } else {
    float m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) m_new[r] = fmaxf(m_r[r], mx[r]);
    exp_tile<D>(sb, p, m_new, sum);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float corr = __expf(m_r[r] - m_new[r]);  // 0 on the first tile
      l_r[r] = l_r[r] * corr + sum[r];
      m_r[r] = m_new[r];
#pragma unroll
      for (int j = 0; j < Tile<D>::ND; ++j) {
        o[j][2 * r] *= corr;
        o[j][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) pk[j][r] = pack_bf16(p[j][2 * r], p[j][2 * r + 1]);
  }
}

// the warp's 16 output rows, times f per row, through its own q rows in
// shared memory, in 16-byte stores; rows from `rows` on are not written
template <int D>
__device__ __forceinline__ void store_out(const float (&o)[Tile<D>::ND][4],
                                          const float (&f)[2], bf16* os, bf16* og,
                                          int64_t ls, int rows, int lane) {
  constexpr int P = Tile<D>::P;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < Tile<D>::ND; ++j) {
    *reinterpret_cast<uint32_t*>(os + g * P + j * 8 + 2 * t) =
        pack_bf16(o[j][0] * f[0], o[j][1] * f[0]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * P + j * 8 + 2 * t) =
        pack_bf16(o[j][2] * f[1], o[j][3] * f[1]);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    if (r < rows)
      *reinterpret_cast<uint4*>(og + r * ls + c) =
          *reinterpret_cast<const uint4*>(os + r * P + c);
  }
}

// Lk <= 128: one key tile, the exact row softmax. The block is persistent: it
// takes tiles blockIdx.x, blockIdx.x + gridDim.x, ... and keeps two stages of
// shared memory, so the copies of the next tile are in flight while it
// computes this one.
template <typename TB, int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
masked_attention_mma_kernel(Params p) {
  constexpr int ND = Tile<D>::ND;
  constexpr int NN = Tile<D>::NN;
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * 16;
  const int nk = p.Lk;
  const bool bias_row = p.bias == nullptr || p.b_s[2] == 0;  // broadcast over queries
  const int64_t n_tiles = static_cast<int64_t>((p.Lq + kBlockM - 1) / kBlockM) * p.H * p.B;

  // copies of one tile into a stage: q and k one group, v the next
  auto issue = [&](const Work& w, bf16* st) {
    load_tile<D>(st + Tile<D>::kQ, w.q, p.q_s[2], w.mq, (w.mq + 15) / 16 * 16, tid);
    load_tile<D>(st + Tile<D>::kK, w.k, p.k_s[2], nk, kBlockN, tid);
    cp_async_commit();
    load_tile<D>(st + Tile<D>::kV, w.v, p.v_s[2], nk, kBlockN, tid);
    cp_async_commit();
  };

  int64_t tile = blockIdx.x;
  {
    const Work w = work_of<TB>(p, tile);
    issue(w, smem);
    if (bias_row && tid < kBlockN)
      smem[Tile<D>::kBias + tid] = __float2bfloat16_rn(bias_at<TB>(w, 0, tid, nk));
  }

  for (int i = 0; tile < n_tiles; ++i, tile += gridDim.x) {
    bf16* st = smem + (i & 1) * Tile<D>::kElems;
    bf16* nx = smem + ((i & 1) ^ 1) * Tile<D>::kElems;
    const int64_t next = tile + gridDim.x;
    __syncthreads();  // the last tile is done: its stage is free
    float bias_next = 0.f;  // held in a register while this tile computes
    if (next < n_tiles) {
      const Work wn = work_of<TB>(p, next);
      issue(wn, nx);
      if (bias_row && tid < kBlockN) bias_next = bias_at<TB>(wn, 0, tid, nk);
    } else {
      cp_async_commit();  // empty groups keep the count
      cp_async_commit();
    }
    cp_async_wait<3>();
    __syncthreads();  // q, k (and the bias row) of this tile are in

    const Work w = work_of<TB>(p, tile);
    const bool active = row0 < w.mq;  // warp-uniform: the warp has query rows
    uint32_t pk[NN][2];
    float o[ND][4];
    float m_r[2], l_r[2];
    if (active) softmax_tile<TB, D, true>(pk, o, m_r, l_r, st, p, w, 0, nk, row0, lane);

    cp_async_wait<2>();
    __syncthreads();  // v of this tile is in

    if (active) {
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
      pv_tile<D>(o, pk, st + Tile<D>::kV, lane);
      const float f[2] = {1.f, 1.f};
      store_out<D>(o, f, st + Tile<D>::kQ + row0 * Tile<D>::P, w.out + row0 * p.o_s[2],
                   p.o_s[2], w.mq - row0, lane);
    }
    if (bias_row && tid < kBlockN && next < n_tiles)
      nx[Tile<D>::kBias + tid] = __float2bfloat16_rn(bias_next);
  }
}

// Lk > 128: one block per (b, h, query tile) walks the keys in tiles of 128
// with the online softmax.
template <typename TB, int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
masked_attention_mma_online_kernel(Params p) {
  constexpr int ND = Tile<D>::ND;
  constexpr int NN = Tile<D>::NN;
  extern __shared__ float4 smem4[];
  bf16* st = reinterpret_cast<bf16*>(smem4);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * 16;
  const Work w = work_of<TB>(p, blockIdx.x);
  const bool active = row0 < w.mq;  // warp-uniform: the warp has query rows
  const bool bias_row = p.bias == nullptr || p.b_s[2] == 0;

  load_tile<D>(st + Tile<D>::kQ, w.q, p.q_s[2], w.mq, (w.mq + 15) / 16 * 16, tid);
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8
  float l_r[2] = {0.f, 0.f};               // running sum

  for (int k0 = 0; k0 < p.Lk; k0 += kBlockN) {
    const int nk = min(kBlockN, p.Lk - k0);
    if (k0 > 0) __syncthreads();  // every warp is done with the last tile
    load_tile<D>(st + Tile<D>::kK, w.k + k0 * p.k_s[2], p.k_s[2], nk, kBlockN, tid);
    cp_async_commit();  // group: (q and) k
    load_tile<D>(st + Tile<D>::kV, w.v + k0 * p.v_s[2], p.v_s[2], nk, kBlockN, tid);
    cp_async_commit();  // group: v
    if (bias_row && tid < kBlockN)
      st[Tile<D>::kBias + tid] = __float2bfloat16_rn(bias_at<TB>(w, k0, tid, nk));
    cp_async_wait<1>();
    __syncthreads();  // q, k and the bias row are in

    uint32_t pk[NN][2];
    if (active) softmax_tile<TB, D, false>(pk, o, m_r, l_r, st, p, w, k0, nk, row0, lane);

    cp_async_wait<0>();
    __syncthreads();  // v is in

    if (active) pv_tile<D>(o, pk, st + Tile<D>::kV, lane);
  }
  if (active) {
    const float f[2] = {1.f / l_r[0], 1.f / l_r[1]};
    store_out<D>(o, f, st + Tile<D>::kQ + row0 * Tile<D>::P, w.out + row0 * p.o_s[2],
                 p.o_s[2], w.mq - row0, lane);
  }
}

bool aligned16(const void* ptr, const int64_t* strides) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

// resident blocks per SM of the persistent kernel, after allowing its shared memory
template <typename TB, int D>
cudaError_t blocks_per_sm(int* n) {
  constexpr int bytes = smem_bytes<D>(2);
  auto kernel = masked_attention_mma_kernel<TB, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, kThreads, bytes);
}

template <typename TB, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (!aligned16(p.q, p.q_s) || !aligned16(p.k, p.k_s) || !aligned16(p.v, p.v_s)
      || !aligned16(p.out, p.o_s))
    return cudaErrorMisalignedAddress;
  const int64_t n_tiles = static_cast<int64_t>((p.Lq + kBlockM - 1) / kBlockM) * p.H * p.B;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (p.Lk > kBlockN) {
    constexpr int bytes = smem_bytes<D>(1);
    auto kernel = masked_attention_mma_online_kernel<TB, D>;
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
    err = blocks_per_sm<TB, D>(&per_sm);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  constexpr int bytes = smem_bytes<D>(2);
  auto kernel = masked_attention_mma_kernel<TB, D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int64_t grid = n_tiles < resident[dev] ? n_tiles : resident[dev];
  kernel<<<static_cast<unsigned>(grid), kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// The launch and the occupancy query share one dispatch on (dtype, bias
// dtype, D), which calls op.run<kBf16, TB, D>().
struct Launch {
  const Params* p;
  cudaStream_t stream;
  template <bool kBf16, typename TB, int D>
  cudaError_t run() const {
    if constexpr (kBf16) return tc::launch<TB, D>(*p, stream);
    else return fp32::launch<TB, D>(*p, stream);
  }
};

struct Occupancy {
  int* n;
  template <bool kBf16, typename TB, int D>
  cudaError_t run() const {
    if constexpr (kBf16) return tc::blocks_per_sm<TB, D>(n);
    else return fp32::blocks_per_sm<TB, D>(n);
  }
};

template <bool kBf16, typename TB, typename Op>
cudaError_t dispatch_d(const Op& op, int d) {
  switch (d) {
    case 32: return op.template run<kBf16, TB, 32>();
    case 64: return op.template run<kBf16, TB, 64>();
    case 128: return op.template run<kBf16, TB, 128>();
    default: return cudaErrorInvalidValue;
  }
}

// dtype and bias dtype: 0 fp32, 1 bf16
template <typename Op>
cudaError_t dispatch(const Op& op, int dtype, int bias_dtype, int d) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (bias_dtype != 0 && bias_dtype != 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return bias_dtype == 0 ? dispatch_d<false, float>(op, d)
                           : dispatch_d<false, __nv_bfloat16>(op, d);
  return bias_dtype == 0 ? dispatch_d<true, float>(op, d)
                         : dispatch_d<true, __nv_bfloat16>(op, d);
}

}  // namespace

// Plain C entry point, loaded with ctypes.
//   dims: B, H, Lq, Lk, D, dtype (0 fp32, 1 bf16), bias dtype (0 fp32, 1 bf16;
//         read only when bias is not null), then the (b, h, l) strides, in
//         elements, of q, k, v, out and bias.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int masked_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* bias, void* out,
                                    const void* dims_ptr, void* stream_ptr) {
  const int64_t* dims = static_cast<const int64_t*>(dims_ptr);
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
  const int d = static_cast<int>(dims[4]);
  const int dtype = static_cast<int>(dims[5]);
  const int bias_dtype = bias == nullptr ? 0 : static_cast<int>(dims[6]);
  int64_t* strides[5] = {p.q_s, p.k_s, p.v_s, p.o_s, p.b_s};
  for (int t = 0; t < 5; ++t)
    for (int i = 0; i < 3; ++i) strides[t][i] = dims[7 + 3 * t + i];
  p.scale = 1.0f / sqrtf(static_cast<float>(d));
  if (p.B <= 0 || p.H <= 0 || p.Lq <= 0 || p.Lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch op{&p, static_cast<cudaStream_t>(stream_ptr)};
  return static_cast<int>(dispatch(op, dtype, bias_dtype, d));
}

// Resident blocks per SM of the kernel that masked_attention_fwd launches for
// (dtype, bias dtype, D), written to *blocks. Returns a CUDA error code.
extern "C" int masked_attention_blocks_per_sm(int dtype, int bias_dtype, int d,
                                              int* blocks) {
  const Occupancy op{blocks};
  return static_cast<int>(dispatch(op, dtype, bias_dtype, d));
}
