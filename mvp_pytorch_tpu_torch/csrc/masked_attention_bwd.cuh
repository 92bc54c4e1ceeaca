// masked_attention_bwd: the backward of masked_attention_fwd for Hopper
// (sm_90a), one kernel a call, for both dtypes.
//
//   s = q.k^T * D^-1/2 + bias, p = softmax(s), m = keep / (1 - p_drop) (1
//   without dropout), dP = g.v^T;
//   dv = (p m)^T.g, ds = p (dP m - rowsum(dP m p)), dq = ds.k * D^-1/2,
//   dk = ds^T.q * D^-1/2, and ds itself for the bias's gradient.
//
// It replaces no TPU kernel: the JAX package's backward of its attention
// kernel was XLA einsums (`_pallas_attention_ad`'s `_attn_bwd`,
// `mvp_pytorch_tpu/ops/attention.py:200-218` at git 8625894^), which the
// port carried over in plain PyTorch (`_attention_grads` in
// mvp_pytorch_tpu_torch/ops/attention.py, still the CPU path). On the card
// that recompute ran about 60 launches a call over fp32 and int64
// [B, H, Lq, Lk] tensors (the dropout hash of an int64 index, the
// probabilities, dp, ds, five einsums and their copies): 70 ms of a training
// step's 112-134 busy ms. This kernel computes the same function with
// nothing of that size in device memory.
//
// Bound (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16): q, k, v, g and the bias
// read once, dq, dk, dv written once; bf16 training B 96, H 12, D 64:
// L 145 0.045 ms, L 125 0.0385, L 75 0.023, L 70 0.0215 a call, against
// about 10 B H L^2 D operations (0.01-0.03 ms at the tensor cores' rate).
// So bytes bound it; the hash, the exponentials and the shared-memory
// traffic of the transposed operands are what the kernel spends its time
// on beyond them.
//
// Design:
//   - One block of one warpgroup (128 threads) per (batch row, head). It
//     holds the key tile's k and v in shared memory (TMA, loaded once when
//     the tile holds every key) and walks the query blocks of 64 rows; the
//     next block's q and g (the output's gradient) load by TMA while this
//     one computes. Key tiles sized to Lk: the smallest of 64, 96, 128 and
//     160 keys (64 and 128 at D 128; fp32 64) that holds every key, so every
//     training shape the port runs (Lk 40-145) is one tile.
//   - Per query block, in registers (the wgmma accumulator layout, as the
//     forward): S = q.k^T and dP = g.v^T (`wgmma`, both operands K-major in
//     shared memory), the scores as the plain backward forms them (fp32,
//     q.k times D^-1/2 plus the bias), the row softmax exact over all keys,
//     the dropout mask from `DropMask` at the flat index
//     ((b H + h) Lq + i) Lk + j, Di = rowsum(dP m p), then p m and ds. Nothing
//     is saved by the forward; no row statistic goes to device memory.
//   - The three products with transposed operands take p m and ds from
//     shared memory: written once as bf16 planes of [64 queries, 64 keys]
//     (128-byte swizzled rows, the layout TMA gives q), they are the
//     MN-major A operand of dv = (p m)^T.g and dk = ds^T.q (M = keys) and
//     the K-major A operand of dq = ds.k (M = queries); g, q and k serve as
//     MN-major B operands as they lie. dq is complete for its query block
//     (every key is in the block) and is written once, with no atomics. dv
//     and dk add up over the query blocks in fp32, each thread its own
//     accumulator elements (in shared memory where they fit, else in a
//     scratch buffer of the wrapper's, by the same generic stores), and are
//     written once at the end.
//   - Precision: the same mathematics as the plain backward, not less. bf16
//     inputs go into bf16 `wgmma` as they are: their products are exact in
//     the fp32 accumulators. The computed fp32 operands (p m and ds) go in as
//     two bf16 terms, hi + lo (16 significant bits), two products for one.
//     fp32 inputs go in as three bf16 terms each (24 bits: the value
//     exactly) and every fp32 product as the six term products whose orders
//     add up to at most 2, which leave out terms 2^-24 below the product.
//     (The forward's 3xTF32 takes only K-major operands in shared memory;
//     four of the backward's five products need a transposed one, which bf16
//     `wgmma` reads as it lies.) Gradients return in the inputs' dtypes.
//   - Past one key tile (no training shape; the forward takes any Lk), a
//     first pass over the key tiles gathers the row max, sum and Di with the
//     online rescale, then the gradient pass walks them again; dq adds up in
//     registers over the key tiles (`kMulti`, a template parameter).
//   - The bias's gradient, when asked for, is ds in fp32 written to a
//     [B, H, Lq, Lk] buffer that the wrapper sums to the bias's shape.
//     Without the request nothing of that size is written.
//
//   - Head dim 72 (SigLIP's 16 heads of 1,152) runs in the D 128 tile
//     (`tile_dim`, masked_attention_hopper.cuh): TMA zero-fills the columns
//     past 72 of q, k, v and g (the fp32 path's loads write zeros there), so
//     S and dP are exact, and the stores of dq, dk and dv skip those
//     columns. Its every launch (vision Lk 729, the MAP probe's Lq 1 over
//     729, text Lk 64) takes the D 128 key tiles: 64 keys, or 128 walked
//     twice past one tile.
//
// The C entry points are in masked_attention_bwd.cu, the instantiations in
// masked_attention_bwd_{bf16,fp32}_d{32,64,128}{,_drop}.cu and
// masked_attention_bwd_{bf16,fp32}_d72.cu (one kernel for one dtype, head dim
// and dropout setting each, compiled in parallel).

#pragma once

#include "masked_attention_wgmma.cuh"

namespace {
namespace hopper {
namespace bwd {

constexpr int kThreadsB = 128;  // one warpgroup
constexpr int kPlaneBytes = kRows * 64 * 2;  // a [64 queries, 64 keys] bf16 plane

struct BParams {
  const void* q;
  const void* k;
  const void* v;
  const void* g;        // the output's gradient
  const float* bias;    // may be null
  void* dq;
  void* dk;
  void* dv;
  float* dbias;         // [B, H, Lq, Lk] fp32, or null
  float* scratch;       // dk, dv sums when they do not fit shared memory
  int64_t q_s[3], k_s[3], v_s[3], g_s[3], dq_s[3], dk_s[3], dv_s[3], b_s[3];
  int B, H, Lq, Lk;
  float scale;
  const void* seed;
  uint32_t drop_threshold;
  float drop_scale;
};

// What the host decided for a launch (`make_bplan`).
struct BPlan {
  int n_kt, n_qb;       // key tiles of kN keys, query blocks of 64 rows
  int acc_smem;         // 1: dk, dv sums in shared memory, 0: in scratch
  uint32_t off_k, off_v, off_q, off_g, off_pl, off_acc, off_bar;
  uint32_t qg_slot, smem_bytes;
  int64_t acc_floats;   // floats of one block's dk, dv sums
};

// d (+)= a . b, m64nNk16 bf16 -> fp32, a and b from shared memory;
// kTA / kTB = 1: a / b MN-major (transposed)
template <int kTA, int kTB, int N>
__device__ __forceinline__ void wgmma_t(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc), "n"(kTA), "n"(kTB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc), "n"(kTA), "n"(kTB));
  } else {
    static_assert(N == 128, "wgmma_t: N in {32, 64, 128}");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc), "n"(kTA), "n"(kTB));
  }
}

// (x0, x1) as kTerms packed bf16 pairs whose sum is (x0, x1) to 8 kTerms
// significant bits: the first rounds the values, each next one the rest
template <int kTerms>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t (&w)[kTerms]) {
#pragma unroll
  for (int i = 0; i < kTerms; ++i) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(x0, x1);
    w[i] = *reinterpret_cast<const uint32_t*>(&t);
    const float2 f = __bfloat1622float2(t);
    x0 -= f.x;
    x1 -= f.y;
  }
}

// the 16-byte unit that holds unit u of row r in swizzled rows of kRB bytes
// (TMA's 128- and 64-byte swizzles: the unit xor bits 7-9 / 7-8 of the
// row's offset)
template <int kRB>
__device__ __forceinline__ int swz(int r, int u) {
  return kRB == 128 ? u ^ (r & 7) : u ^ ((r >> 1) & 3);
}

// The fp32 path's load: rows row0 .. row0 + rows - 1 of one (b, h) of a
// [B, H, L, D] fp32 tensor with strides s, as three bf16 planes (plane_bytes
// apart) laid out as TMA lays a bf16 tile out (chunks of kCC columns,
// rows_alloc rows each, swizzled); rows from `valid` on, and the tile's
// columns past D, are zeros.
template <int D>
__device__ __forceinline__ void load_split(uint8_t* dst, uint32_t plane_bytes, int rows_alloc,
                                           const float* src, const int64_t* s, int b, int h,
                                           int row0, int rows, int valid, int tid) {
  using C = Chunk<D, 2>;
  constexpr int kG = C::kD / 8;  // 8-element groups a row of the tile
  const float* at = src + b * s[0] + h * s[1];
  for (int i = tid; i < rows * kG; i += kThreadsB) {
    const int r = i / kG, col = 8 * (i - r * kG);
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (r < valid && (C::kD == D || col < D)) {
      const float4* row = reinterpret_cast<const float4*>(at + (row0 + r) * s[2] + col);
      lo = __ldg(row);
      hi = __ldg(row + 1);
    }
    const float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint32_t w[4][3];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_pair<3>(x[2 * e], x[2 * e + 1], w[e]);
    const int chunk = col / C::kCC, unit = (col - chunk * C::kCC) / 8;
    const uint32_t off = chunk * rows_alloc * C::kRowBytes + r * C::kRowBytes
                         + swz<C::kRowBytes>(r, unit) * 16;
#pragma unroll
    for (int t = 0; t < 3; ++t)
      *reinterpret_cast<uint4*>(dst + t * plane_bytes + off) =
          make_uint4(w[0][t], w[1][t], w[2][t], w[3][t]);
  }
}

// One block: the gradients of one (batch row, head). Thread (warp, lane)
// holds rows warp * 16 + lane / 4 (+ 8) of every accumulator and, of each
// 8-column block j, columns 8j + 2 (lane % 4), + 1.
template <typename T, int D, int kN, bool kMulti, bool kDrop>
__global__ void __launch_bounds__(kThreadsB, 1)
masked_attention_bwd_kernel(const __grid_constant__ BParams p, const __grid_constant__ BPlan pl,
                            const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tg) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kP = kF32 ? 3 : 1;   // bf16 terms of an input
  constexpr int kPc = kF32 ? 3 : 2;  // bf16 terms of p m and ds
  constexpr int kSub = (kN + 63) / 64, kPad = 64 * kSub;  // 64-key subtiles
  using C = Chunk<D, 2>;
  constexpr int kD = C::kD;  // the tile's width (128 at D 72)
  constexpr int NS = kN / 2, NJ = kN / 8, NO = kD / 2;
  constexpr uint32_t kRB = C::kRowBytes;
  constexpr uint32_t kKvPlane = kPad * kD * 2, kQgPlane = kRows * kD * 2;
  constexpr uint32_t kKChunk = kPad * kRB, kQChunk = kRows * kRB;  // column-chunk strides
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t4 = lane % 4;
  const int r0 = warp * 16 + lane / 4;
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const uint32_t bar_kv = base + pl.off_bar, bar_q = bar_kv + 8;  // + 8 slot
  const uint32_t k_s = base + pl.off_k, v_s = base + pl.off_v, pl_s = base + pl.off_pl;
  float* const acc = pl.acc_smem ? reinterpret_cast<float*>(smem + pl.off_acc)
                                 : p.scratch + static_cast<int64_t>(bh) * pl.acc_floats;
  DropMask dm{};
  if constexpr (kDrop) {
    const uint64_t s = *static_cast<const uint64_t*>(p.seed);
    dm = {static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32), p.drop_threshold,
          p.drop_scale};
  }

  if (tid == 0) {
    bar_init(bar_kv, 1);
    bar_init(bar_q, 1);
    bar_init(bar_q + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    // zeros where no copy writes and a product reads: the planes' keys past
    // kN and, on the TMA path, k's and v's rows past kN (0 x finite = 0)
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < kPc * kSub * kPlaneBytes / 16; i += kThreadsB)
      reinterpret_cast<uint4*>(smem + pl.off_pl)[i] = z;
    if constexpr (kPad > kN && !kF32) {
      constexpr int kPadRows = kPad - kN, kUnits = kRB / 16;
      for (int i = tid; i < 2 * C::kChunks * kPadRows * kUnits; i += kThreadsB) {
        const int u = i % kUnits, r = kN + i / kUnits % kPadRows;
        const int cc = i / (kUnits * kPadRows) % C::kChunks, kv = i / (kUnits * kPadRows * C::kChunks);
        *reinterpret_cast<uint4*>(smem + (kv ? pl.off_v : pl.off_k) + cc * kKChunk + r * kRB
                                  + u * 16) = z;
      }
    }
    fence_proxy_async();
  }
  __syncthreads();

  // copies: bf16 by TMA (thread 0 issues, everyone waits on the barrier);
  // fp32 by every thread, split into three planes, then a block barrier
  auto issue_kv = [&](int c) {
    bar_expect_tx(bar_kv, 2 * kN * kD * 2);
#pragma unroll
    for (int cc = 0; cc < C::kChunks; ++cc) {
      tma_load(k_s + cc * kKChunk, &tk, bar_kv, cc * C::kCC, c * kN, h, b);
      tma_load(v_s + cc * kKChunk, &tv, bar_kv, cc * C::kCC, c * kN, h, b);
    }
  };
  auto issue_qg = [&](int qb) {
    const int slot = qb & 1;
    const uint32_t bar = bar_q + 8 * slot;
    bar_expect_tx(bar, 2 * kRows * kD * 2);
#pragma unroll
    for (int cc = 0; cc < C::kChunks; ++cc) {
      tma_load(base + pl.off_q + slot * pl.qg_slot + cc * kQChunk, &tq, bar, cc * C::kCC,
               qb * kRows, h, b);
      tma_load(base + pl.off_g + slot * pl.qg_slot + cc * kQChunk, &tg, bar, cc * C::kCC,
               qb * kRows, h, b);
    }
  };
  auto load_kv_f32 = [&](int c) {
    const int valid = min(kN, p.Lk - c * kN);
    load_split<D>(smem + pl.off_k, kKvPlane, kPad, static_cast<const float*>(p.k), p.k_s, b, h,
                  c * kN, kPad, valid, tid);
    load_split<D>(smem + pl.off_v, kKvPlane, kPad, static_cast<const float*>(p.v), p.v_s, b, h,
                  c * kN, kPad, valid, tid);
    fence_proxy_async();
    __syncthreads();
  };

  int kv_loaded = 0;
  bool kv_pending = !kF32;
  uint32_t kv_phase = 0;
  if constexpr (kF32) {
    load_kv_f32(0);
  } else if (tid == 0) {
    issue_kv(0);
    issue_qg(0);
    if (pl.n_qb > 1) issue_qg(1);
  }
  // k and v of key tile c in shared memory
  auto ensure_kv = [&](int c) {
    if (c != kv_loaded) {
      __syncthreads();  // every product on the resident tile is done
      kv_loaded = c;
      if constexpr (kF32) {
        load_kv_f32(c);
      } else {
        if (tid == 0) issue_kv(c);
        kv_pending = true;
      }
    }
    if (kv_pending) {
      bar_wait(bar_kv, kv_phase);
      kv_phase ^= 1;
      kv_pending = false;
    }
  };

  for (int qb = 0; qb < pl.n_qb; ++qb) {
    const int slot = kF32 ? 0 : qb & 1;
    if constexpr (kF32) {
      const int valid = min(kRows, p.Lq - qb * kRows);
      load_split<D>(smem + pl.off_q, kQgPlane, kRows, static_cast<const float*>(p.q), p.q_s, b, h,
                    qb * kRows, kRows, valid, tid);
      load_split<D>(smem + pl.off_g, kQgPlane, kRows, static_cast<const float*>(p.g), p.g_s, b, h,
                    qb * kRows, kRows, valid, tid);
      fence_proxy_async();
      __syncthreads();
    } else {
      bar_wait(bar_q + 8 * slot, static_cast<uint32_t>((qb >> 1) & 1));
    }
    const uint32_t q_s = base + pl.off_q + slot * pl.qg_slot;
    const uint32_t g_s = base + pl.off_g + slot * pl.qg_slot;
    int qrow[2];
    bool rv[2];
    const float* brow[2] = {nullptr, nullptr};
    uint64_t rb[2];  // flat dropout index of (row, key 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qrow[r] = qb * kRows + r0 + 8 * r;
      rv[r] = qrow[r] < p.Lq;
      if (p.bias != nullptr)
        brow[r] = p.bias + b * p.b_s[0] + h * p.b_s[1] + (rv[r] ? qrow[r] : 0) * p.b_s[2];
      rb[r] = static_cast<uint64_t>(static_cast<int64_t>(bh) * p.Lq + qrow[r])
              * static_cast<uint64_t>(p.Lk);
    }

    // S = q.k^T and dP = g.v^T of key tile c, over the term pairs
    auto products = [&](float (&s)[NS], float (&dp)[NS]) {
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < kP; ++i)
#pragma unroll
        for (int j = 0; j < kP - i; ++j)
#pragma unroll
          for (int kk = 0; kk < kD / 16; ++kk) {
            const uint32_t cc = kk / C::kKSteps, ko = (kk % C::kKSteps) * 32;
            const int add = i + j + kk > 0;
            wgmma_ss<kN>(s, desc(q_s + i * kQgPlane + cc * kQChunk + ko, 16, 8 * kRB, kRB),
                         desc(k_s + j * kKvPlane + cc * kKChunk + ko, 16, 8 * kRB, kRB), add);
            wgmma_ss<kN>(dp, desc(g_s + i * kQgPlane + cc * kQChunk + ko, 16, 8 * kRB, kRB),
                         desc(v_s + j * kKvPlane + cc * kKChunk + ko, 16, 8 * kRB, kRB), add);
          }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
    };
    // the fp32 scores as the plain backward forms them: q.k times D^-1/2,
    // plus the bias (two roundings, not one); keys past Lk -inf
    auto scores = [&](float (&s)[NS], int c) {
      const int k0 = c * kN + 2 * t4;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + e, x = 4 * j + 2 * r + e;
            const float bv = brow[r] != nullptr && key < p.Lk ? __ldg(brow[r] + key) : 0.f;
            s[x] = key < p.Lk ? __fadd_rn(__fmul_rn(s[x], p.scale), bv) : -INFINITY;
          }
    };
    auto row_max = [&](const float (&s)[NS], float (&mx)[2]) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < NJ; ++j) m = fmaxf(m, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        mx[r] = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      }
    };
    auto quad_sum = [&](float (&x)[2]) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        x[r] += __shfl_xor_sync(0xffffffffu, x[r], 1);
        x[r] += __shfl_xor_sync(0xffffffffu, x[r], 2);
      }
    };
    auto ex = [&](float x) {
      if constexpr (kF32) return expf(x);
      else return exp_ftz(x);
    };
    // keep / (1 - p) of element (row r, key k0 + 8j + e) of key tile c
    auto factor = [&](int r, int c, int j, int e) {
      if constexpr (kDrop)
        return dm.factor(rb[r] + static_cast<uint64_t>(c * kN + 8 * j + 2 * t4 + e));
      else
        return 1.f;
    };

    // the row statistics past one key tile: max, sum, and
    // Di = rowsum(dP m p), gathered with the online rescale
    float m_r[2] = {-INFINITY, -INFINITY}, il[2] = {0.f, 0.f}, di[2] = {0.f, 0.f};
    if constexpr (kMulti) {
      float l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
      for (int c = 0; c < pl.n_kt; ++c) {
        ensure_kv(c);
        float s[NS], dp[NS], mx[2];
        products(s, dp);
        scores(s, c);
        row_max(s, mx);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(m_r[r], mx[r]), corr = ex(m_r[r] - mn);
          l[r] *= corr;
          d[r] *= corr;
          m_r[r] = mn;
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * j + 2 * r + e;
              const float w = ex(s[x] - m_r[r]);
              l[r] += w;
              d[r] += dp[x] * factor(r, c, j, e) * w;
            }
      }
      quad_sum(l);
      quad_sum(d);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        il[r] = 1.f / l[r];
        di[r] = d[r] * il[r];
      }
    }

    float dq[NO];
    if constexpr (kMulti) {
#pragma unroll
      for (int i = 0; i < NO; ++i) dq[i] = 0.f;
    }
    for (int c = 0; c < pl.n_kt; ++c) {
      ensure_kv(c);
      float s[NS], dp[NS];  // then p m and ds
      products(s, dp);
      scores(s, c);
      if constexpr (!kMulti) {
        // one key tile: the exact row softmax, then Di; the keep bits kept
        // for p m (p itself is ds's factor even where the mask drops it)
        float mx[2], l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
        row_max(s, mx);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * j + 2 * r + e;
              s[x] = ex(s[x] - mx[r]);
              l[r] += s[x];
            }
        quad_sum(l);
        uint32_t keep[(NS + 31) / 32] = {};
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * j + 2 * r + e;
              s[x] *= 1.f / l[r];
              const float f = factor(r, c, j, e);
              if (kDrop && f != 0.f) keep[x / 32] |= 1u << (x % 32);
              dp[x] *= f;
              d[r] += dp[x] * s[x];
            }
        quad_sum(d);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * j + 2 * r + e;
              const float ds = s[x] * (dp[x] - d[r]);
              float pm = s[x];
              if constexpr (kDrop) pm = (keep[x / 32] >> (x % 32) & 1u) ? pm * p.drop_scale : 0.f;
              s[x] = rv[r] ? pm : 0.f;
              dp[x] = rv[r] ? ds : 0.f;
            }
      } else {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * j + 2 * r + e;
              const float pr = ex(s[x] - m_r[r]) * il[r], f = factor(r, c, j, e);
              const float ds = pr * (dp[x] * f - di[r]);
              s[x] = rv[r] ? pr * f : 0.f;
              dp[x] = rv[r] ? ds : 0.f;
            }
      }
      if (p.dbias != nullptr) {
        const int k0 = c * kN + 2 * t4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!rv[r]) continue;
          float* out = p.dbias + (static_cast<int64_t>(bh) * p.Lq + qrow[r]) * p.Lk;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (k0 + 8 * j + e < p.Lk) out[k0 + 8 * j + e] = dp[4 * j + 2 * r + e];
        }
      }

      // x as kPc bf16 planes of 64-key subtiles, [query][key] with
      // 128-byte swizzled rows
      auto write_planes = [&](const float (&x)[NS]) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r0 + 8 * r;
            uint32_t w[kPc];
            split_pair<kPc>(x[4 * j + 2 * r], x[4 * j + 2 * r + 1], w);
            const uint32_t off = pl.off_pl + (j / 8) * kPlaneBytes + row * 128
                                 + (((j % 8) ^ (row & 7)) * 16) + t4 * 4;
#pragma unroll
            for (int t = 0; t < kPc; ++t)
              *reinterpret_cast<uint32_t*>(smem + off + t * kSub * kPlaneBytes) = w[t];
          }
        fence_proxy_async();
        __syncthreads();
      };
      // part = x^T.y over 64 queries for subtile sub: x the planes (MN-major
      // A, M = keys), y = g or q (MN-major B)
      auto issue_t = [&](float (&part)[NO], int sub, uint32_t y) {
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < kPc; ++i)
#pragma unroll
          for (int j = 0; j < kP; ++j) {
            if (i + j >= (kPc > kP ? kPc : kP)) continue;
#pragma unroll
            for (int kk = 0; kk < kRows / 16; ++kk)
              wgmma_t<1, 1, kD>(part,
                               desc(pl_s + (i * kSub + sub) * kPlaneBytes + kk * 2048,
                                    kPlaneBytes, 1024, 128),
                               desc(y + j * kQgPlane + kk * 16 * kRB, kQChunk, 8 * kRB, kRB),
                               i + j + kk > 0);
          }
        wgmma_commit();
      };
      // the fragment's sum over the query blocks: each thread its own
      // elements, 128 floats apart, 64 D floats a subtile (at D 72 the
      // elements past 4 (D / 8) hold only the tile's zero columns)
      auto rmw = [&](int which, int sub, const float (&part)[NO]) {
        float* a = acc + ((static_cast<int64_t>(which) * pl.n_kt + c) * kSub + sub) * (64 * D) + tid;
        if constexpr (kD != D) {
          // D 72: the elements of columns past 72 (8j + 2 (lane % 4) with
          // j >= 9, so e >= 36) are never stored and are not summed; the
          // rest load in batches of 12 before their stores. At SigLIP's
          // vision shape the sums sit in the scratch buffer, where a load
          // waiting on the previous element's store cost a device-memory
          // round trip each: 46.6 ms a call at B 48, 7.75 ms batched (H100).
          constexpr int kUsed = 4 * (D / 8), kBatch = 12;
          static_assert(kUsed % kBatch == 0, "whole batches");
#pragma unroll
          for (int e0 = 0; e0 < kUsed; e0 += kBatch) {
            float old[kBatch];
#pragma unroll
            for (int e = 0; e < kBatch; ++e) old[e] = qb == 0 ? 0.f : a[(e0 + e) * kThreadsB];
#pragma unroll
            for (int e = 0; e < kBatch; ++e) a[(e0 + e) * kThreadsB] = old[e] + part[e0 + e];
          }
        } else {
#pragma unroll
          for (int e = 0; e < NO; ++e) a[e * kThreadsB] = qb == 0 ? part[e] : a[e * kThreadsB] + part[e];
        }
      };

      write_planes(s);  // p m
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub) {
        float part[NO];
        issue_t(part, sub, g_s);
        wgmma_wait<0>();
        fence_regs(part);
        rmw(0, sub, part);
      }
      __syncthreads();  // the planes' products are done everywhere
      write_planes(dp);  // ds
      // dq (+)= ds.k over the tile's keys: the planes K-major, k MN-major
      if constexpr (kMulti) fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub)
#pragma unroll
        for (int i = 0; i < kPc; ++i)
#pragma unroll
          for (int j = 0; j < kP; ++j) {
            if (i + j >= (kPc > kP ? kPc : kP)) continue;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_t<0, 1, kD>(dq,
                               desc(pl_s + (i * kSub + sub) * kPlaneBytes + kk * 32, 16, 1024, 128),
                               desc(k_s + j * kKvPlane + (sub * 64 + kk * 16) * kRB, kKChunk,
                                    8 * kRB, kRB),
                               kMulti || sub + i + j + kk > 0);
          }
      wgmma_commit();
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub) {
        float part[NO];
        issue_t(part, sub, q_s);
        wgmma_wait<0>();
        fence_regs(part);
        rmw(1, sub, part);
      }
      fence_regs(dq);
      __syncthreads();  // before the planes (and k, v) are written again
    }

    // dq of this query block, complete: rows past Lq and the tile's columns
    // past D skipped
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!rv[r]) continue;
      T* row = static_cast<T*>(p.dq) + b * p.dq_s[0] + h * p.dq_s[1] + qrow[r] * p.dq_s[2] + 2 * t4;
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        if (8 * j >= D) continue;
        const float x0 = dq[4 * j + 2 * r] * p.scale, x1 = dq[4 * j + 2 * r + 1] * p.scale;
        if constexpr (kF32) *reinterpret_cast<float2*>(row + 8 * j) = make_float2(x0, x1);
        else *reinterpret_cast<uint32_t*>(row + 8 * j) = pack_bf16(x0, x1);
      }
    }
    if constexpr (!kF32) {
      // every product on this slot's q and g is done (the barrier above):
      // the block after next loads into it
      if (tid == 0 && qb + 2 < pl.n_qb) issue_qg(qb + 2);
    }
  }

  // dv, and dk times D^-1/2, from the sums: keys past Lk (and a tile's
  // padding rows) and the tile's columns past D skipped
  for (int which = 0; which < 2; ++which) {
    T* out = static_cast<T*>(which ? p.dk : p.dv);
    const int64_t* os = which ? p.dk_s : p.dv_s;
    const float sc = which ? p.scale : 1.f;
    for (int c = 0; c < pl.n_kt; ++c)
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub) {
        const float* a = acc + ((static_cast<int64_t>(which) * pl.n_kt + c) * kSub + sub) * (64 * D)
                         + tid;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int in_tile = sub * 64 + r0 + 8 * r, key = c * kN + in_tile;
          if (in_tile >= kN || key >= p.Lk) continue;
          T* row = out + b * os[0] + h * os[1] + key * os[2] + 2 * t4;
#pragma unroll
          for (int j = 0; j < NO / 4; ++j) {
            if (8 * j >= D) continue;
            const float x0 = a[(4 * j + 2 * r) * kThreadsB] * sc;
            const float x1 = a[(4 * j + 2 * r + 1) * kThreadsB] * sc;
            if constexpr (kF32) *reinterpret_cast<float2*>(row + 8 * j) = make_float2(x0, x1);
            else *reinterpret_cast<uint32_t*>(row + 8 * j) = pack_bf16(x0, x1);
          }
        }
      }
  }
}

// --- host ------------------------------------------------------------------

// The key tile of a launch: the smallest instantiated width that holds Lk,
// else the largest (then `kMulti`). bf16: 64, 96, 128, 160 (64, 128 at
// D 128 and 72: the scores, dP and dq share the registers); fp32: 64 (its
// three planes of q, k, v and g fill shared memory).
template <int D, bool kF32>
int key_tile(int lk) {
  if (kF32) return 64;
  constexpr int kTiles[4] = {64, 96, 128, 160};
  constexpr int kStep = tile_dim(D) < 128 ? 1 : 2;
  int kn = 0;
  for (int i = 0; i < 4; i += kStep) {
    kn = kTiles[i];
    if (kn >= lk) break;
  }
  return kn;
}

// The shared-memory layout and the sums' place, for key tile kN at head
// dim d in a tile kd wide: k, v (kPad rows a plane), q and g (2 slots in
// bf16, 1 in fp32), the planes of p m / ds, then dk and dv's sums (64 d
// floats a 64-key subtile: no column past d) when everything fits.
inline cudaError_t make_bplan(const BParams& p, int kd, int d, int kN, bool f32, BPlan* pl) {
  *pl = BPlan{};
  const int kp = f32 ? 3 : 1, kpc = f32 ? 3 : 2, sub = (kN + 63) / 64;
  pl->n_kt = (p.Lk + kN - 1) / kN;
  pl->n_qb = (p.Lq + kRows - 1) / kRows;
  const int q_slots = f32 ? 1 : 2;  // bf16: the next block's q, g load ahead
  const uint32_t kv = static_cast<uint32_t>(kp * 64 * sub * kd * 2);
  pl->qg_slot = static_cast<uint32_t>(kp * kRows * kd * 2);
  pl->off_k = 0;
  pl->off_v = kv;
  pl->off_q = 2 * kv;
  pl->off_g = pl->off_q + q_slots * pl->qg_slot;
  pl->off_pl = pl->off_g + q_slots * pl->qg_slot;
  uint32_t end = pl->off_pl + kpc * sub * kPlaneBytes;
  pl->acc_floats = 2LL * pl->n_kt * sub * 64 * d;
  constexpr uint32_t kBarBytes = 64;
  const int64_t with_acc = end + pl->acc_floats * 4 + kBarBytes + 1024;
  pl->acc_smem = with_acc <= kSmemLimit;
  if (pl->acc_smem) {
    pl->off_acc = end;
    end += static_cast<uint32_t>(pl->acc_floats * 4);
  }
  pl->off_bar = end;
  pl->smem_bytes = end + kBarBytes + 1024;
  if (pl->smem_bytes > static_cast<uint32_t>(kSmemLimit)) return cudaErrorInvalidConfiguration;
  if (static_cast<int64_t>(p.B) * p.H > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

template <typename T, int D, int kN, bool kMulti, bool kDrop>
cudaError_t launch(const BParams& p, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int elem = kF32 ? 4 : 2;
  if (!aligned16(p.q, p.q_s, elem) || !aligned16(p.k, p.k_s, elem) || !aligned16(p.v, p.v_s, elem)
      || !aligned16(p.g, p.g_s, elem))
    return cudaErrorMisalignedAddress;
  BPlan pl;
  cudaError_t err = make_bplan(p, tile_dim(D), D, kN, kF32, &pl);
  if (err != cudaSuccess) return err;
  if (!pl.acc_smem && p.scratch == nullptr) return cudaErrorInvalidValue;
  alignas(64) CUtensorMap tq{}, tk{}, tv{}, tg{};
  if constexpr (!kF32) {
    if (encode<D, 2>(&tq, p.q, p.B, p.H, p.Lq, p.q_s, kRows, 1) != CUDA_SUCCESS
        || encode<D, 2>(&tg, p.g, p.B, p.H, p.Lq, p.g_s, kRows, 1) != CUDA_SUCCESS
        || encode<D, 2>(&tk, p.k, p.B, p.H, p.Lk, p.k_s, kN, 1) != CUDA_SUCCESS
        || encode<D, 2>(&tv, p.v, p.B, p.H, p.Lk, p.v_s, kN, 1) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  static bool attr[64] = {false};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!attr[dev]) {
    err = cudaFuncSetAttribute(masked_attention_bwd_kernel<T, D, kN, kMulti, kDrop>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    attr[dev] = true;
  }
  masked_attention_bwd_kernel<T, D, kN, kMulti, kDrop>
      <<<static_cast<unsigned>(p.B * p.H), kThreadsB, pl.smem_bytes, stream>>>(p, pl, tq, tk, tv,
                                                                                 tg);
  return cudaGetLastError();
}

// masked_attention_bwd's arguments as BParams (dims: see masked_attention_bwd.cu)
inline BParams parse_bparams(const void* q, const void* k, const void* v, const void* g,
                             const void* bias, void* dq, void* dk, void* dv, void* dbias,
                             void* scratch, const int64_t* dims, const void* seed,
                             uint32_t drop_threshold, float drop_scale) {
  BParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = g;
  p.bias = static_cast<const float*>(bias);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dbias = static_cast<float*>(dbias);
  p.scratch = static_cast<float*>(scratch);
  p.B = static_cast<int>(dims[0]);
  p.H = static_cast<int>(dims[1]);
  p.Lq = static_cast<int>(dims[2]);
  p.Lk = static_cast<int>(dims[3]);
  int64_t* strides[8] = {p.q_s, p.k_s, p.v_s, p.g_s, p.dq_s, p.dk_s, p.dv_s, p.b_s};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) strides[t][i] = dims[7 + 3 * t + i];
  // D^-1/2 rounded once to fp32, as the plain version's Python scalar is
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dims[4])));
  p.seed = seed;
  p.drop_threshold = drop_threshold;
  p.drop_scale = drop_scale;
  return p;
}

// masked_attention_bwd for one dtype, head dim and dropout setting
template <typename T, int D, bool kDrop>
int run(const void* q, const void* k, const void* v, const void* g, const void* bias, void* dq,
        void* dk, void* dv, void* dbias, void* scratch, const void* dims_ptr, void* stream_ptr,
        const void* seed, uint32_t drop_threshold, float drop_scale) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int64_t* dims = static_cast<const int64_t*>(dims_ptr);
  const BParams p = parse_bparams(q, k, v, g, bias, dq, dk, dv, dbias, scratch, dims, seed,
                                  drop_threshold, drop_scale);
  if ((bias != nullptr && dims[6] != 0) || p.B <= 0 || p.H <= 0 || p.Lq <= 0 || p.Lk <= 0
      || dims[4] != D || dims[5] != (kF32 ? 0 : 1) || (kDrop && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int kn = key_tile<D, kF32>(p.Lk);
  if (p.Lk > kn) {
    constexpr int kMax = kF32 ? 64 : tile_dim(D) < 128 ? 160 : 128;
    return static_cast<int>(launch<T, D, kMax, true, kDrop>(p, stream));
  }
  if constexpr (kF32) {
    return static_cast<int>(launch<T, D, 64, false, kDrop>(p, stream));
  } else {
    switch (kn) {
      case 64: return static_cast<int>(launch<T, D, 64, false, kDrop>(p, stream));
      case 128: return static_cast<int>(launch<T, D, 128, false, kDrop>(p, stream));
      default: break;
    }
    if constexpr (tile_dim(D) < 128) {
      switch (kn) {
        case 96: return static_cast<int>(launch<T, D, 96, false, kDrop>(p, stream));
        case 160: return static_cast<int>(launch<T, D, 160, false, kDrop>(p, stream));
        default: break;
      }
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The plan of a launch of these dims (host only): out = {key tile, key
// tiles, multi (past one tile), sums in shared memory, shared-memory bytes,
// scratch floats the wrapper allocates (0 when the sums fit), the head
// dim's tile width}
template <int D, bool kF32>
int plan(const int64_t* dims, int64_t* out) {
  BParams p = parse_bparams(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, nullptr, nullptr, dims, nullptr, 0, 1.0f);
  if (p.B <= 0 || p.H <= 0 || p.Lq <= 0 || p.Lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kn = key_tile<D, kF32>(p.Lk);
  BPlan pl;
  const cudaError_t err = make_bplan(p, tile_dim(D), D, kn, kF32, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t got[7] = {kn, pl.n_kt, p.Lk > kn, pl.acc_smem, pl.smem_bytes,
                          pl.acc_smem ? 0 : static_cast<int64_t>(p.B) * p.H * pl.acc_floats,
                          tile_dim(D)};
  for (int i = 0; i < 7; ++i) out[i] = got[i];
  return 0;
}

}  // namespace bwd
}  // namespace hopper
}  // namespace

// One launch per dtype, head dim and dropout setting, each defined in its
// own translation unit, with masked_attention_bwd's arguments.
#define MASKED_ATTENTION_BWD_ARGS                                                  \
  const void *q, const void *k, const void *v, const void *g, const void *bias,   \
      void *dq, void *dk, void *dv, void *dbias, void *scratch,                   \
      const void *dims_ptr, void *stream_ptr, const void *seed,                   \
      uint32_t drop_threshold, float drop_scale
int masked_attention_bwd_bf16_d32(MASKED_ATTENTION_BWD_ARGS);
int masked_attention_bwd_bf16_d32_drop(MASKED_ATTENTION_BWD_ARGS);
int masked_attention_bwd_bf16_d64(MASKED_ATTENTION_BWD_ARGS);
int masked_attention_bwd_bf16_d64_drop(MASKED_ATTENTION_BWD_ARGS);
int masked_attention_bwd_bf16_d128(MASKED_ATTENTION_BWD_ARGS);
int masked_attention_bwd_bf16_d128_drop(MASKED_ATTENTION_BWD_ARGS);
int masked_attention_bwd_fp32_d32(MASKED_ATTENTION_BWD_ARGS);
int masked_attention_bwd_fp32_d32_drop(MASKED_ATTENTION_BWD_ARGS);
int masked_attention_bwd_fp32_d64(MASKED_ATTENTION_BWD_ARGS);
int masked_attention_bwd_fp32_d64_drop(MASKED_ATTENTION_BWD_ARGS);
int masked_attention_bwd_fp32_d128(MASKED_ATTENTION_BWD_ARGS);
int masked_attention_bwd_fp32_d128_drop(MASKED_ATTENTION_BWD_ARGS);
// head dim 72 (SigLIP), in the D 128 tile, without dropout only
int masked_attention_bwd_bf16_d72(MASKED_ATTENTION_BWD_ARGS);
int masked_attention_bwd_fp32_d72(MASKED_ATTENTION_BWD_ARGS);
