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
// Numerics. q.k is accumulated in fp32; max, exp and the row sum are fp32;
// the output is accumulated in fp32 and cast to q's type. For bf16 inputs the
// score is rounded to bf16 at the three points where the reference rounds it
// (q.k, times the bf16 scale, plus the bf16 bias), so a row whose keys are all
// masked (bias -10000) comes out uniform as in the reference instead of as the
// unmasked softmax. fp32 inputs keep fp32 scores throughout. The softmax is
// online (running max and sum over key tiles), so the probabilities are
// normalised after P.V rather than rounded to bf16 before it; that is the
// one place the bf16 kernel departs from the reference, by at most one bf16
// rounding of each probability.
//
// Bound. At the main path's rerank shape (1,000 pairs, fused L = 125, H = 12,
// D = 64, bf16) q, k, v and out are 4 x 192 MB = 768 MB, about 0.23 ms at
// 3.35 TB/s, against 48 GFLOP, about 0.05 ms of bf16 tensor-core work: the
// function is memory-bound. The design therefore reads q, k, v and the bias
// once from device memory and writes out once: scores and probabilities live
// only in registers and shared memory, the bias is read through its strides
// (stride 0 on broadcast dims, never materialised at [B, H, Lq, Lk]), and q, k,
// v, out are addressed through their strides so the [B, L, H, D] projection
// layout is read in place without head transposes. The products run on the
// CUDA cores in fp32 (67 TFLOP/s), which at these shapes puts the arithmetic
// above the memory bound; wgmma and TMA are a later step.
//
// Layout of the work: one block of 4 warps per (b, h, tile of 32 queries);
// each warp owns 8 query rows. The block walks the keys in tiles of 32: k is
// staged transposed and v as is in shared memory (fp32), lane j scores key j
// against the warp's 8 rows, the warp reduces max and sum with shuffles, and
// each lane accumulates output dims lane, lane + 32, ... for its 8 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 32 queries per block
constexpr int kBlockK = 32;                      // keys per tile, one per lane
constexpr int kThreads = kWarps * 32;

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

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int D>
constexpr int smem_floats() {
  // q tile, k tile transposed (row pitch kBlockK + 1), v tile, probabilities
  return kBlockQ * D + D * (kBlockK + 1) + kBlockK * D + kBlockQ * kBlockK;
}

template <typename T, typename TB, int D>
__global__ void __launch_bounds__(kThreads)
masked_attention_kernel(Params p) {
  constexpr int C = D / 32;  // output dims per lane
  constexpr bool kBf16 = sizeof(T) == 2;
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

  const T* qg = static_cast<const T*>(p.q) + b * p.q_s[0] + h * p.q_s[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.k_s[0] + h * p.k_s[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.v_s[0] + h * p.v_s[1];
  const TB* bg = p.bias == nullptr ? nullptr
                 : static_cast<const TB*>(p.bias) + b * p.b_s[0] + h * p.b_s[1];

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    qs[i] = qi < p.Lq ? to_f(qg[qi * p.q_s[2] + d]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][C];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }
  const float scale = kBf16 ? round_bf16(p.scale) : p.scale;
  const int row0 = warp * kRowsPerWarp;

  for (int k0 = 0; k0 < p.Lk; k0 += kBlockK) {
    __syncthreads();  // previous tile fully consumed (and q tile written)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const int kj = k0 + j;
      const bool ok = kj < p.Lk;
      kt[d * (kBlockK + 1) + j] = ok ? to_f(kg[kj * p.k_s[2] + d]) : 0.f;
      vs[j * D + d] = ok ? to_f(vg[kj * p.v_s[2] + d]) : 0.f;
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
        if (kBf16) {
          x = round_bf16(round_bf16(s[r]) * scale);
          if (bg != nullptr) x = round_bf16(x + round_bf16(bias));
        } else {
          // two roundings, as the reference's multiply then add (no FMA)
          x = __fadd_rn(__fmul_rn(s[r], scale), bias);
        }
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

  T* og = static_cast<T*>(p.out) + b * p.o_s[0] + h * p.o_s[1];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= p.Lq) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int c = 0; c < C; ++c)
      og[qi * p.o_s[2] + lane + 32 * c] = from_f<T>(acc[r][c] * inv);
  }
}

template <typename T, typename TB, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kernel = masked_attention_kernel<T, TB, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int64_t n_qt = (p.Lq + kBlockQ - 1) / kBlockQ;
  const int64_t blocks = n_qt * p.H * p.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename TB>
cudaError_t dispatch_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, TB, 32>(p, stream);
    case 64: return launch<T, TB, 64>(p, stream);
    case 128: return launch<T, TB, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_bias(const Params& p, int d, int bias_dtype, cudaStream_t stream) {
  // bias_dtype: 0 fp32, 1 bf16 (ignored when p.bias is null)
  if (p.bias == nullptr || bias_dtype == 0) return dispatch_d<T, float>(p, d, stream);
  if (bias_dtype == 1) return dispatch_d<T, __nv_bfloat16>(p, d, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes.
//   dims: B, H, Lq, Lk, D, dtype (0 fp32, 1 bf16), bias dtype (0 fp32, 1 bf16),
//         then the (b, h, l) strides, in elements, of q, k, v, out and bias.
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
  const int bias_dtype = static_cast<int>(dims[6]);
  int64_t* strides[5] = {p.q_s, p.k_s, p.v_s, p.o_s, p.b_s};
  for (int t = 0; t < 5; ++t)
    for (int i = 0; i < 3; ++i) strides[t][i] = dims[7 + 3 * t + i];
  p.scale = 1.0f / sqrtf(static_cast<float>(d));
  if (p.B <= 0 || p.H <= 0 || p.Lq <= 0 || p.Lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_bias<float>(p, d, bias_dtype, stream);
  else if (dtype == 1)
    err = dispatch_bias<__nv_bfloat16>(p, d, bias_dtype, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
