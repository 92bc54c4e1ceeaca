// masked_attention_bwd: the backward of masked_attention_fwd for Hopper
// (sm_90a), for both dtypes: one kernel a call, and three past one key
// tile in bf16.
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
// on beyond them. SigLIP's vision call (B 48, H 16, Lq = Lk 729, D 72) is
// bound by its operations: 0.297 ms.
//
// Design (one key tile, and fp32; the bf16 key-outer launches below):
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
//   - Past one key tile in fp32 (the forward takes any Lk), a first pass
//     over the key tiles gathers the row max, sum and Di with the online
//     rescale, then the gradient pass walks them again; dq adds up in
//     registers over the key tiles (`kMulti`, a template parameter).
//   - Past one key tile in bf16 (SigLIP's 729 keys), the key tiles are the
//     outer loop, in FlashAttention-2's order, in three launches a call:
//     `masked_attention_bwd_stats_kernel` (one warpgroup per (b, h, 64-row
//     query block)) gathers each row's max, 1 / sum and Di as the first
//     pass above does, into a workspace of the wrapper's;
//     `masked_attention_bwd_outer_kernel` (one block per (b, h, 128-key
//     tile): a producer warp and two consumer warpgroups of 64 keys) loads
//     its k and v once, holds dk and dv in registers across every query
//     block while q, g and the statistics stream through a TMA ring, and
//     writes dq's share of its keys as an fp32 slice of the workspace;
//     `masked_attention_bwd_dq_kernel` sums the slices in key order. No
//     atomics: a call's gradients repeat bit for bit. The two-pass design
//     re-read k and v and read-modified-wrote dk, dv in a scratch buffer
//     for every query block (about 8 GB a call at SigLIP's vision shape).
//   - The bias's gradient, when asked for, is ds in fp32 written to a
//     [B, H, Lq, Lk] buffer that the wrapper sums to the bias's shape.
//     Without the request nothing of that size is written.
//
//   - Head dim 72 (SigLIP's 16 heads of 1,152) runs in the D 128 tile
//     (`tile_dim`, masked_attention_hopper.cuh): TMA zero-fills the columns
//     past 72 of q, k, v and g (the fp32 path's loads write zeros there), so
//     S and dP are exact, and the stores of dq, dk and dv skip those
//     columns. The text's Lk 64 takes one 64-key tile; the vision tower's
//     Lk 729 and the MAP probe's Lq 1 over 729 take the key-outer launches
//     (bf16) or 64-key tiles walked twice (fp32).
//
// The C entry points are in masked_attention_bwd.cu, the instantiations in
// masked_attention_bwd_{bf16,fp32}_d{32,64,128}{,_drop}.cu and
// masked_attention_bwd_{bf16,fp32}_d72.cu (the kernels of one dtype, head dim
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

// The row arithmetic of a 64-row query block over one key tile of kN keys.
// Thread (warp, lane) holds rows warp * 16 + lane / 4 (+ 8: index r) and, of
// each 8-key block j, keys 8j + 2 (lane % 4) + e; element 4j + 2r + e of s
// and dP. k0 is the thread's first key, c kN + 2 (lane % 4) of key tile c.

// the fp32 scores as the plain backward forms them: q.k times D^-1/2, plus
// the bias (two roundings, not one); keys past Lk -inf
template <int kN>
__device__ __forceinline__ void tile_scores(float (&s)[kN / 2], int k0, const BParams& p,
                                            const float* const* brow) {
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + e, x = 4 * j + 2 * r + e;
        const float bv = brow[r] != nullptr && key < p.Lk ? __ldg(brow[r] + key) : 0.f;
        s[x] = key < p.Lk ? __fadd_rn(__fmul_rn(s[x], p.scale), bv) : -INFINITY;
      }
}

// each row's max over the quad's keys
template <int kN>
__device__ __forceinline__ void tile_row_max(const float (&s)[kN / 2], float (&mx)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) m = fmaxf(m, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    mx[r] = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  }
}

// each row's sum over the quad
__device__ __forceinline__ void quad_sum(float (&x)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    x[r] += __shfl_xor_sync(0xffffffffu, x[r], 1);
    x[r] += __shfl_xor_sync(0xffffffffu, x[r], 2);
  }
}

// the exponential of the scores: fp32's expf, bf16's ex2.approx.ftz
template <bool kF32>
__device__ __forceinline__ float bwd_exp(float x) {
  if constexpr (kF32) return expf(x);
  else return exp_ftz(x);
}

// The row statistics past one key tile, one key tile at a time, as the
// two-pass kernel's first pass and the key-outer path's statistics kernel
// both gather them (one copy, so the same bits): s (q.k) becomes the scores,
// then the online rescale of the running max m, sum l and d, and this
// tile's terms, exp(s - m) into l and dP times the dropout factor
// (keep / (1 - p) of flat index rb[r] + key) times it into d.
template <int kN, bool kF32, bool kDrop>
__device__ __forceinline__ void stats_add(float (&s)[kN / 2], const float (&dp)[kN / 2], int k0,
                                          const BParams& p, const float* const* brow,
                                          const DropMask& dm, const uint64_t (&rb)[2],
                                          float (&m)[2], float (&l)[2], float (&d)[2]) {
  float mx[2];
  tile_scores<kN>(s, k0, p, brow);
  tile_row_max<kN>(s, mx);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], mx[r]), corr = bwd_exp<kF32>(m[r] - mn);
    l[r] *= corr;
    d[r] *= corr;
    m[r] = mn;
  }
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * r + e;
        const float w = bwd_exp<kF32>(s[x] - m[r]);
        float f = 1.f;
        if constexpr (kDrop) f = dm.factor(rb[r] + static_cast<uint64_t>(k0 + 8 * j + e));
        l[r] += w;
        d[r] += dp[x] * f * w;
      }
}

// after the last key tile: l and d summed over the quad, then 1 / l and
// Di = d / l
__device__ __forceinline__ void stats_finish(float (&l)[2], float (&d)[2], float (&il)[2],
                                             float (&di)[2]) {
  quad_sum(l);
  quad_sum(d);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    il[r] = 1.f / l[r];
    di[r] = d[r] * il[r];
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
    auto scores = [&](float (&s)[NS], int c) { tile_scores<kN>(s, c * kN + 2 * t4, p, brow); };
    auto ex = [&](float x) { return bwd_exp<kF32>(x); };
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
        float s[NS], dp[NS];
        products(s, dp);
        stats_add<kN, kF32, kDrop>(s, dp, c * kN + 2 * t4, p, brow, dm, rb, m_r, l, d);
      }
      stats_finish(l, d, il, di);
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
        tile_row_max<kN>(s, mx);
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
          // rest load in batches of 12 before their stores. Where the sums
          // sit in the scratch buffer, a load waiting on the previous
          // element's store cost a device-memory round trip each: 46.6 ms a
          // bf16 call at SigLIP's vision shape (B 48), 7.75 ms batched
          // (H100), before that shape took the key-outer launches.
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

// --- bf16 past one key tile: key tiles outer --------------------------------

constexpr int kOuterKeys = 128;       // keys of a gradient block: 64 a consumer warpgroup
constexpr int kOuterStages = 2;       // the ring of q, g and the statistics
constexpr int kStatFloats = 3 * kRows;  // m, 1 / l and Di of a 64-row query block
constexpr int kDsBytes = kOuterKeys * 128;  // a bf16 plane of ds^T: [128 keys][64 queries]
constexpr int kOuterProducerRegs = 24, kOuterConsumerRegs = 240;

// the statistics pass's key tile: the two-pass kernel's widest bf16 tile
constexpr int stat_keys(int D) { return tile_dim(D) < 128 ? 160 : 128; }

// What the host decided for a key-outer launch (`make_oplan`).
struct OPlan {
  int n_qb, n_kt, n_st;  // query blocks of 64; 128-key tiles; the statistics pass's key tiles
  int slices;            // dq's partial sums: one a key tile (D 128 tile), else one a 64 keys
  uint32_t st_smem;      // the statistics kernel's shared memory
  uint32_t off_v, off_qg, off_ds, off_bar, stage_bytes, smem_bytes;  // the gradient kernel's
  int64_t stats_floats, dq_floats;  // the workspace: the statistics, then dq's partial sums
};

// pins registers at this point of the program (the A fragments of a wgmma
// in flight: no other value may take them before its wait)
template <int N>
__device__ __forceinline__ void fence_words(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i]) :: "memory");
}

// The row statistics of one 64-row query block over every key, by the
// two-pass kernel's first pass (`stats_add`, `stats_finish`) over key
// tiles of kN. One warpgroup per (b, h, query block), the
// blocks of one (b, h) adjacent (k and v stay in L2); the next key tile's k
// and v load while this one's exponentials run. Writes m, 1 / l and Di of
// all 64 rows to the workspace. (H100, SigLIP's vision call: 0.68 ms; two
// warpgroups a block sharing a two-deep k, v ring took 0.76 ms, dP's
// products in a group of their own under S's exponentials 0.72-0.79.)
template <int D, int kN, bool kDrop>
__global__ void __launch_bounds__(kThreadsB, 2)
masked_attention_bwd_stats_kernel(const __grid_constant__ BParams p,
                                  const __grid_constant__ OPlan pl,
                                  const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap tg) {
  using C = Chunk<D, 2>;
  constexpr int kD = C::kD, NS = kN / 2;
  constexpr uint32_t kRB = C::kRowBytes;
  constexpr uint32_t kKv = kN * kD * 2, kQg = kRows * kD * 2;
  constexpr uint32_t kKChunk = kN * kRB, kQChunk = kRows * kRB;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t k_s = base, v_s = base + kKv, q_s = base + 2 * kKv, g_s = q_s + kQg;
  const uint32_t bar_kv = g_s + kQg, bar_q = bar_kv + 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t4 = lane % 4;
  const int r0 = warp * 16 + lane / 4;
  const int bh = blockIdx.x / pl.n_qb, qb = blockIdx.x - bh * pl.n_qb, b = bh / p.H,
            h = bh - b * p.H;
  DropMask dm{};
  if constexpr (kDrop) {
    const uint64_t s = *static_cast<const uint64_t*>(p.seed);
    dm = {static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32), p.drop_threshold,
          p.drop_scale};
  }
  if (tid == 0) {
    bar_init(bar_kv, 1);
    bar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue_kv = [&](int c) {
    bar_expect_tx(bar_kv, 2 * kKv);
#pragma unroll
    for (int cc = 0; cc < C::kChunks; ++cc) {
      tma_load(k_s + cc * kKChunk, &tk, bar_kv, cc * C::kCC, c * kN, h, b);
      tma_load(v_s + cc * kKChunk, &tv, bar_kv, cc * C::kCC, c * kN, h, b);
    }
  };
  if (tid == 0) {
    bar_expect_tx(bar_q, 2 * kQg);
#pragma unroll
    for (int cc = 0; cc < C::kChunks; ++cc) {
      tma_load(q_s + cc * kQChunk, &tq, bar_q, cc * C::kCC, qb * kRows, h, b);
      tma_load(g_s + cc * kQChunk, &tg, bar_q, cc * C::kCC, qb * kRows, h, b);
    }
    issue_kv(0);
  }
  const float* brow[2] = {nullptr, nullptr};
  uint64_t rb[2];  // flat dropout index of (row, key 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qrow = qb * kRows + r0 + 8 * r;
    if (p.bias != nullptr)
      brow[r] = p.bias + b * p.b_s[0] + h * p.b_s[1] + (qrow < p.Lq ? qrow : 0) * p.b_s[2];
    rb[r] = static_cast<uint64_t>(static_cast<int64_t>(bh) * p.Lq + qrow)
            * static_cast<uint64_t>(p.Lk);
  }
  bar_wait(bar_q, 0);

  float m_r[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
  for (int c = 0; c < pl.n_st; ++c) {
    bar_wait(bar_kv, static_cast<uint32_t>(c & 1));
    float s[NS], dp[NS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t cc = kk / C::kKSteps, ko = (kk % C::kKSteps) * 32;
      wgmma_ss<kN>(s, desc(q_s + cc * kQChunk + ko, 16, 8 * kRB, kRB),
                   desc(k_s + cc * kKChunk + ko, 16, 8 * kRB, kRB), kk > 0);
      wgmma_ss<kN>(dp, desc(g_s + cc * kQChunk + ko, 16, 8 * kRB, kRB),
                   desc(v_s + cc * kKChunk + ko, 16, 8 * kRB, kRB), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    __syncthreads();  // every warp's products on this k and v are done
    if (tid == 0 && c + 1 < pl.n_st) issue_kv(c + 1);
    stats_add<kN, false, kDrop>(s, dp, c * kN + 2 * t4, p, brow, dm, rb, m_r, l, d);
  }
  float il[2], di[2];
  stats_finish(l, d, il, di);
  if (t4 == 0) {
    float* out = p.scratch + static_cast<int64_t>(blockIdx.x) * kStatFloats;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      out[r0 + 8 * r] = m_r[r];
      out[kRows + r0 + 8 * r] = il[r];
      out[2 * kRows + r0 + 8 * r] = di[r];
    }
  }
}

// The gradients of one 128-key tile of one (b, h) over every query block:
// two consumer warpgroups of 64 keys each and a producer warp (registers
// given away, `setmaxnreg`) that loads the tile's k and v once and streams
// q, g and the statistics of each query block by TMA into a ring of
// kOuterStages. The blocks of one (b, h) are adjacent, so q and g stay in
// L2. Per query block, in registers with keys as rows: S^T = k.q^T and
// dP^T = v.g^T, p m and ds from the statistics as the two-pass kernel
// forms them, then dv += (p m)^T.g and dk += ds^T.q with the A operand
// from registers (hi + lo bf16 pairs, two products each); dk and dv stay
// in registers across all query blocks and are written once. dq = ds.k
// takes ds^T from shared memory (both warpgroups' keys: each warpgroup 64
// of the tile's 128 columns; below the D 128 tile each its own 64 keys at
// full width) and goes to the workspace as an fp32 partial sum, one slice
// a key tile (or a 64 keys); `masked_attention_bwd_dq_kernel` sums the
// slices in key order.
// Schedule (H100, SigLIP's vision call, this kernel alone): the two
// warpgroups in step, one block barrier a query block, 2.99 ms; S and dP
// in two commit groups (dP's products under p's exponentials), 2.55 ms;
// the warpgroups taking turns at S and dP (named barriers) with each
// block's dq one block later, behind mbarriers on its ds^T buffer instead
// of a block barrier, 2.33 ms; full tiles (every key and query in range,
// no bias, no dropout) without the elementwise selects, 2.00 ms, and no
// spill. Issuing dv before ds is formed spilled at the D 128 tile and took
// 2.76 ms.
template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
masked_attention_bwd_outer_kernel(const __grid_constant__ BParams p,
                                  const __grid_constant__ OPlan pl,
                                  const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap tg) {
  using C = Chunk<D, 2>;
  constexpr int kD = C::kD, NO = kD / 2;
  constexpr bool kSplit = kD == 128;       // dq's columns split between the warpgroups
  constexpr int kDqN = kSplit ? 64 : kD, NQ = kDqN / 2;
  constexpr uint32_t kRB = C::kRowBytes;
  constexpr uint32_t kQg = kRows * kD * 2;
  constexpr uint32_t kKChunk = kOuterKeys * kRB, kQChunk = kRows * kRB;
  constexpr int S = kOuterStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t k_s = base, v_s = base + pl.off_v, bars = base + pl.off_bar;
  // barriers: k and v; each stage's full, then empty; each ds^T buffer's
  // full (both warpgroups wrote it), then free (both read it)
  const uint32_t bar_kv = bars, bar_full = bars + 8, bar_empty = bars + 8 * (1 + S);
  const uint32_t bar_ds_full = bars + 8 * (1 + 2 * S), bar_ds_free = bar_ds_full + 16;
  const int bh = blockIdx.x / pl.n_kt, kt = blockIdx.x - bh * pl.n_kt, b = bh / p.H,
            h = bh - b * p.H;
  if (threadIdx.x == 0) {
    bar_init(bar_kv, 1);
    for (int s = 0; s < S; ++s) {
      bar_init(bar_full + 8 * s, 1);
      bar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    for (int i = 0; i < 2; ++i) {
      bar_init(bar_ds_full + 8 * i, kConsumerWarps);
      bar_init(bar_ds_free + 8 * i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int w = threadIdx.x / 128;
  if (w == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kOuterProducerRegs));
    if (threadIdx.x % 128 == 0) {
      bar_expect_tx(bar_kv, 2 * kOuterKeys * kD * 2);
#pragma unroll
      for (int cc = 0; cc < C::kChunks; ++cc) {
        tma_load(k_s + cc * kKChunk, &tk, bar_kv, cc * C::kCC, kt * kOuterKeys, h, b);
        tma_load(v_s + cc * kKChunk, &tv, bar_kv, cc * C::kCC, kt * kOuterKeys, h, b);
      }
      const float* stats = p.scratch + static_cast<int64_t>(bh) * pl.n_qb * kStatFloats;
      int slot = 0;
      uint32_t phase = 0;
      for (int qb = 0; qb < pl.n_qb; ++qb) {
        bar_wait(bar_empty + 8 * slot, phase ^ 1);
        const uint32_t full = bar_full + 8 * slot, st = base + pl.off_qg + slot * pl.stage_bytes;
        bar_expect_tx(full, 2 * kQg + kStatFloats * 4);
#pragma unroll
        for (int cc = 0; cc < C::kChunks; ++cc) {
          tma_load(st + cc * kQChunk, &tq, full, cc * C::kCC, qb * kRows, h, b);
          tma_load(st + kQg + cc * kQChunk, &tg, full, cc * C::kCC, qb * kRows, h, b);
        }
        bulk_load(st + 2 * kQg, stats + qb * kStatFloats, kStatFloats * 4, full);
        if (++slot == S) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kOuterConsumerRegs));

  // consumer warpgroup w: keys kt * 128 + 64 w + (0 .. 63); thread (warp,
  // lane) holds keys r0, r0 + 8 of them (the accumulator rows) and, of each
  // 8-column block j, columns 8j + 2 (lane % 4), + 1
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, t4 = lane % 4;
  const int r0 = warp * 16 + lane / 4;
  const int key0 = kt * kOuterKeys + w * 64 + r0;
  const bool key_ok[2] = {key0 < p.Lk, key0 + 8 < p.Lk};
  const float* bias = p.bias == nullptr ? nullptr : p.bias + b * p.b_s[0] + h * p.b_s[1];
  const uint64_t row_base = static_cast<uint64_t>(static_cast<int64_t>(bh) * p.Lq);
  const uint32_t kw_s = k_s + w * 64 * kRB, vw_s = v_s + w * 64 * kRB;
  DropMask dm{};
  if constexpr (kDrop) {
    const uint64_t s = *static_cast<const uint64_t*>(p.seed);
    dm = {static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32), p.drop_threshold,
          p.drop_scale};
  }
  const int slice = kSplit ? kt : 2 * kt + w, col0 = kSplit ? 64 * w : 0;
  float* const part = p.scratch + pl.stats_floats
                      + (static_cast<int64_t>(slice) * p.B * p.H + bh) * p.Lq * D;

  // dq (+)= ds.k of query block i over the tile's keys, once both
  // warpgroups' ds^T of it are in its planes: ds^T MN-major A (M =
  // queries), k MN-major B; then the planes are free again, and dq goes to
  // this warpgroup's slice
  auto dq_step = [&](int i) {
    const uint32_t buf = static_cast<uint32_t>(i & 1);
    bar_wait(bar_ds_full + 8 * buf, static_cast<uint32_t>((i >> 1) & 1));
    const uint32_t ds_s = base + pl.off_ds + buf * 2 * kDsBytes;
    float dq[NQ];
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if constexpr (kSplit) {
#pragma unroll
        for (int kk = 0; kk < kOuterKeys / 16; ++kk)
          wgmma_t<1, 1, kDqN>(dq, desc(ds_s + t * kDsBytes + kk * 2048, kDsBytes, 1024, 128),
                              desc(k_s + w * kKChunk + kk * 16 * kRB, kKChunk, 8 * kRB, kRB),
                              t + kk > 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_t<1, 1, kDqN>(dq,
                              desc(ds_s + t * kDsBytes + (w * 64 + kk * 16) * 128, kDsBytes,
                                   1024, 128),
                              desc(k_s + (w * 64 + kk * 16) * kRB, kKChunk, 8 * kRB, kRB),
                              t + kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    warp_release(bar_ds_free + 8 * buf, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int query = i * kRows + r0 + 8 * r;
      if (query >= p.Lq) continue;
      float* row = part + static_cast<int64_t>(query) * D + col0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < NQ / 4; ++j)
        if (col0 + 8 * j < D)
          *reinterpret_cast<float2*>(row + 8 * j) =
              make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
    }
  };

  float dk[NO], dv[NO];
  bar_wait(bar_kv, 0);
  // the warpgroups take turns at S and dP's products (named barriers 1 and
  // 2): each one's exponentials run under the other's products
  if (w == 1) asm volatile("bar.arrive 1, %0;\n" :: "n"(kConsumers * 128) : "memory");
  int slot = 0;
  uint32_t phase = 0;
  for (int qb = 0; qb < pl.n_qb; ++qb) {
    const uint32_t q_s = base + pl.off_qg + slot * pl.stage_bytes, g_s = q_s + kQg;
    const float* stat =
        reinterpret_cast<const float*>(smem + pl.off_qg + slot * pl.stage_bytes + 2 * kQg);
    bar_wait(bar_full + 8 * slot, phase);

    // S^T = k.q^T and dP^T = v.g^T: this warpgroup's 64 keys x 64 queries,
    // in two groups, so that dP's products run under p's exponentials
    float s[32], dp[32];
    if (w == 0) asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers * 128) : "memory");
    else asm volatile("bar.sync 2, %0;\n" :: "n"(kConsumers * 128) : "memory");
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t cc = kk / C::kKSteps, ko = (kk % C::kKSteps) * 32;
      wgmma_ss<64>(s, desc(kw_s + cc * kKChunk + ko, 16, 8 * kRB, kRB),
                   desc(q_s + cc * kQChunk + ko, 16, 8 * kRB, kRB), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t cc = kk / C::kKSteps, ko = (kk % C::kKSteps) * 32;
      wgmma_ss<64>(dp, desc(vw_s + cc * kKChunk + ko, 16, 8 * kRB, kRB),
                   desc(g_s + cc * kQChunk + ko, 16, 8 * kRB, kRB), kk > 0);
    }
    wgmma_commit();
    if (w == 0)
      asm volatile("bar.arrive 2, %0;\n" :: "n"(kConsumers * 128) : "memory");
    else if (qb + 1 < pl.n_qb)
      asm volatile("bar.arrive 1, %0;\n" :: "n"(kConsumers * 128) : "memory");
    wgmma_wait<1>();
    fence_regs(s);

    // p = e^(s - m) / l from the fp32 scores and the row statistics (keys
    // past Lk score -inf); without a bias and past Lk the scores are q.k
    // times D^-1/2 alone (the bias's + 0 changes no bit of p)
    if (bias == nullptr && kt + 1 < pl.n_kt) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 m2 = *reinterpret_cast<const float2*>(stat + 8 * j + 2 * t4);
        const float2 i2 = *reinterpret_cast<const float2*>(stat + kRows + 8 * j + 2 * t4);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * j + 2 * r;
          s[x] = exp_ftz(__fmul_rn(s[x], p.scale) - m2.x) * i2.x;
          s[x + 1] = exp_ftz(__fmul_rn(s[x + 1], p.scale) - m2.y) * i2.y;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t4;
        const float2 m2 = *reinterpret_cast<const float2*>(stat + c);
        const float2 i2 = *reinterpret_cast<const float2*>(stat + kRows + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int query = qb * kRows + c + e;
          const float m = e ? m2.y : m2.x, il = e ? i2.y : i2.x;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int x = 4 * j + 2 * r + e, key = key0 + 8 * r;
            const float bv = bias != nullptr && key_ok[r]
                                 ? __ldg(bias + (query < p.Lq ? query : 0) * p.b_s[2] + key)
                                 : 0.f;
            const float sc = key_ok[r] ? __fadd_rn(__fmul_rn(s[x], p.scale), bv) : -INFINITY;
            s[x] = exp_ftz(sc - m) * il;
          }
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // p m into s and ds = p (dP m - Di) into dp; queries past Lq take 0
    if (!kDrop && p.dbias == nullptr && (qb + 1) * kRows <= p.Lq) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(stat + 2 * kRows + 8 * j + 2 * t4);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * j + 2 * r;
          dp[x] = s[x] * (dp[x] - d2.x);
          dp[x + 1] = s[x + 1] * (dp[x + 1] - d2.y);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t4;
        const float2 d2 = *reinterpret_cast<const float2*>(stat + 2 * kRows + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int query = qb * kRows + c + e;
          const bool q_ok = query < p.Lq;
          const float di = e ? d2.y : d2.x;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int x = 4 * j + 2 * r + e, key = key0 + 8 * r;
            const float pr = s[x];
            float f = 1.f;
            if constexpr (kDrop)
              f = dm.factor((row_base + static_cast<uint64_t>(query)) * static_cast<uint64_t>(p.Lk)
                            + static_cast<uint64_t>(key));
            const float ds = pr * (dp[x] * f - di);
            if (p.dbias != nullptr && q_ok && key_ok[r])
              p.dbias[(static_cast<int64_t>(bh) * p.Lq + query) * p.Lk + key] = ds;
            s[x] = q_ok ? pr * f : 0.f;
            dp[x] = q_ok ? ds : 0.f;
          }
        }
      }
    }

    // p m and ds as hi + lo bf16 A fragments (the accumulator layout of S^T
    // is the A layout of an m64k16 product over the queries)
    uint32_t ph[16], plo[16], dh[16], dl[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t t[2];
        split_pair<2>(s[4 * j + 2 * r], s[4 * j + 2 * r + 1], t);
        ph[2 * j + r] = t[0];
        plo[2 * j + r] = t[1];
        split_pair<2>(dp[4 * j + 2 * r], dp[4 * j + 2 * r + 1], t);
        dh[2 * j + r] = t[0];
        dl[2 * j + r] = t[1];
      }
    // dv += (p m)^T.g and dk += ds^T.q over the block's 64 queries (g, q
    // MN-major B operands as they lie)
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bg = desc(g_s + kk * 16 * kRB, kQChunk, 8 * kRB, kRB);
      const uint64_t bq = desc(q_s + kk * 16 * kRB, kQChunk, 8 * kRB, kRB);
      const uint32_t a0[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3]};
      const uint32_t a1[4] = {plo[4 * kk], plo[4 * kk + 1], plo[4 * kk + 2], plo[4 * kk + 3]};
      const uint32_t a2[4] = {dh[4 * kk], dh[4 * kk + 1], dh[4 * kk + 2], dh[4 * kk + 3]};
      const uint32_t a3[4] = {dl[4 * kk], dl[4 * kk + 1], dl[4 * kk + 2], dl[4 * kk + 3]};
      wgmma_rs<kD>(dv, a0, bg, qb > 0 || kk > 0);
      wgmma_rs<kD>(dv, a1, bg, 1);
      wgmma_rs<kD>(dk, a2, bq, qb > 0 || kk > 0);
      wgmma_rs<kD>(dk, a3, bq, 1);
    }
    wgmma_commit();

    // ds^T hi and lo into this query block's planes (two buffers: the
    // block's dq runs one block later, once both warpgroups wrote it)
    const uint32_t buf = static_cast<uint32_t>(qb & 1);
    if (qb >= 2) bar_wait(bar_ds_free + 8 * buf, static_cast<uint32_t>(((qb >> 1) - 1) & 1));
    const uint32_t ds_off = pl.off_ds + buf * 2 * kDsBytes;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = w * 64 + r0 + 8 * r;
        const uint32_t off = ds_off + row * 128 + ((j ^ (row & 7)) * 16) + t4 * 4;
        *reinterpret_cast<uint32_t*>(smem + off) = dh[2 * j + r];
        *reinterpret_cast<uint32_t*>(smem + off + kDsBytes) = dl[2 * j + r];
      }
    fence_proxy_async();
    warp_release(bar_ds_full + 8 * buf, lane);
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_words(ph);
    fence_words(plo);
    fence_words(dh);
    fence_words(dl);
    warp_release(bar_empty + 8 * slot, lane);  // q, g and the statistics are read
    if (qb > 0) dq_step(qb - 1);
    if (++slot == S) {
      slot = 0;
      phase ^= 1;
    }
  }
  dq_step(pl.n_qb - 1);

  // dv, and dk times D^-1/2: keys past Lk and the tile's columns past D
  // skipped
  auto store = [&](__nv_bfloat16* out, const int64_t* os, const float (&acc)[NO], float sc) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!key_ok[r]) continue;
      __nv_bfloat16* row = out + b * os[0] + h * os[1] + (key0 + 8 * r) * os[2] + 2 * t4;
#pragma unroll
      for (int j = 0; j < NO / 4; ++j)
        if (8 * j < D)
          *reinterpret_cast<uint32_t*>(row + 8 * j) =
              pack_bf16(acc[4 * j + 2 * r] * sc, acc[4 * j + 2 * r + 1] * sc);
    }
  };
  store(static_cast<__nv_bfloat16*>(p.dv), p.dv_s, dv, 1.f);
  store(static_cast<__nv_bfloat16*>(p.dk), p.dk_s, dk, p.scale);
}

// dq = (the slices' sum, in key order) times D^-1/2, in bf16 at dq's
// strides: four columns a thread
template <int D>
__global__ void __launch_bounds__(256)
masked_attention_bwd_dq_kernel(const __grid_constant__ BParams p,
                               const __grid_constant__ OPlan pl) {
  constexpr int kG = D / 4;
  const int64_t rows = static_cast<int64_t>(p.B) * p.H * p.Lq, plane = rows * D;
  const float* part = p.scratch + pl.stats_floats;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < rows * kG;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = i / kG;
    const int c = 4 * static_cast<int>(i - row * kG);
    const float* at = part + row * D + c;
    float4 acc = __ldg(reinterpret_cast<const float4*>(at));
    for (int s = 1; s < pl.slices; ++s) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(at + s * plane));
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const int64_t bh = row / p.Lq;
    const int q = static_cast<int>(row - bh * p.Lq), b = static_cast<int>(bh / p.H),
              h = static_cast<int>(bh - static_cast<int64_t>(b) * p.H);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_s[0] + h * p.dq_s[1]
                         + q * p.dq_s[2] + c;
    *reinterpret_cast<uint2*>(out) = make_uint2(pack_bf16(acc.x * p.scale, acc.y * p.scale),
                                                pack_bf16(acc.z * p.scale, acc.w * p.scale));
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

// The key-outer plan of a bf16 launch at head dim D: the statistics
// kernel's k, v (stat_keys rows), q and g; the gradient kernel's k, v (128
// rows), kOuterStages of q, g and the statistics, two buffers of ds^T hi and
// lo planes, the barriers; the workspace's statistics and dq slices.
template <int D>
cudaError_t make_oplan(const BParams& p, OPlan* pl) {
  constexpr int kD = tile_dim(D);
  constexpr uint32_t kKv = kOuterKeys * kD * 2, kQg = kRows * kD * 2;
  *pl = OPlan{};
  pl->n_qb = (p.Lq + kRows - 1) / kRows;
  pl->n_kt = (p.Lk + kOuterKeys - 1) / kOuterKeys;
  pl->n_st = (p.Lk + stat_keys(D) - 1) / stat_keys(D);
  pl->slices = kD == 128 ? pl->n_kt : 2 * pl->n_kt;
  pl->st_smem = 2 * stat_keys(D) * kD * 2 + 2 * kQg + 16 + 1024;
  pl->off_v = kKv;
  pl->off_qg = 2 * kKv;
  pl->stage_bytes = round_up(2 * kQg + kStatFloats * 4, 1024);
  pl->off_ds = pl->off_qg + kOuterStages * pl->stage_bytes;
  pl->off_bar = pl->off_ds + 4 * kDsBytes;
  pl->smem_bytes = pl->off_bar + 8 * (5 + 2 * kOuterStages) + 1024;
  const int64_t bh = static_cast<int64_t>(p.B) * p.H;
  pl->stats_floats = bh * pl->n_qb * kStatFloats;
  pl->dq_floats = static_cast<int64_t>(pl->slices) * bh * p.Lq * D;
  if (pl->smem_bytes > static_cast<uint32_t>(kSmemLimit)
      || bh * pl->n_qb > 0x7fffffffLL || bh * pl->n_kt > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// bf16 past one key tile: the statistics pass, the key-outer gradients,
// dq's sum; p.scratch is the workspace (OPlan's stats_floats + dq_floats)
template <int D, bool kDrop>
cudaError_t launch_outer(const BParams& p, cudaStream_t stream) {
  constexpr int kStat = stat_keys(D);
  if (!aligned16(p.q, p.q_s, 2) || !aligned16(p.k, p.k_s, 2) || !aligned16(p.v, p.v_s, 2)
      || !aligned16(p.g, p.g_s, 2))
    return cudaErrorMisalignedAddress;
  OPlan pl;
  cudaError_t err = make_oplan<D>(p, &pl);
  if (err != cudaSuccess) return err;
  if (p.scratch == nullptr) return cudaErrorInvalidValue;
  alignas(64) CUtensorMap tq{}, tg{}, tk{}, tv{}, tks{}, tvs{};
  if (encode<D, 2>(&tq, p.q, p.B, p.H, p.Lq, p.q_s, kRows, 1) != CUDA_SUCCESS
      || encode<D, 2>(&tg, p.g, p.B, p.H, p.Lq, p.g_s, kRows, 1) != CUDA_SUCCESS
      || encode<D, 2>(&tk, p.k, p.B, p.H, p.Lk, p.k_s, kOuterKeys, 1) != CUDA_SUCCESS
      || encode<D, 2>(&tv, p.v, p.B, p.H, p.Lk, p.v_s, kOuterKeys, 1) != CUDA_SUCCESS
      || encode<D, 2>(&tks, p.k, p.B, p.H, p.Lk, p.k_s, kStat, 1) != CUDA_SUCCESS
      || encode<D, 2>(&tvs, p.v, p.B, p.H, p.Lk, p.v_s, kStat, 1) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  static bool attr[64] = {false};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!attr[dev]) {
    err = cudaFuncSetAttribute(masked_attention_bwd_stats_kernel<D, kStat, kDrop>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(masked_attention_bwd_outer_kernel<D, kDrop>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    attr[dev] = true;
  }
  const int64_t bh = static_cast<int64_t>(p.B) * p.H;
  masked_attention_bwd_stats_kernel<D, kStat, kDrop>
      <<<static_cast<unsigned>(bh * pl.n_qb), kThreadsB, pl.st_smem, stream>>>(p, pl, tq, tks,
                                                                                 tvs, tg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  masked_attention_bwd_outer_kernel<D, kDrop>
      <<<static_cast<unsigned>(bh * pl.n_kt), kThreads, pl.smem_bytes, stream>>>(p, pl, tq, tk,
                                                                                  tv, tg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t groups = bh * p.Lq * (D / 4);
  const int64_t blocks = (groups + 255) / 256;
  masked_attention_bwd_dq_kernel<D>
      <<<static_cast<unsigned>(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL), 256, 0, stream>>>(
          p, pl);
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
    if constexpr (kF32) return static_cast<int>(launch<T, D, 64, true, kDrop>(p, stream));
    else return static_cast<int>(launch_outer<D, kDrop>(p, stream));
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
// tiles, multi (past one tile), dk and dv's sums in shared memory,
// shared-memory bytes, scratch floats the wrapper allocates, the head dim's
// tile width, key outer (1: bf16 past one tile), the statistics' floats, dq's
// slices}. The two-pass kernel's scratch holds dk and dv's sums when they do
// not fit shared memory (else 0 floats); the key-outer path's holds the
// statistics and dq's slices, and its key tile and shared memory are the
// gradient kernel's.
template <int D, bool kF32>
int plan(const int64_t* dims, int64_t* out) {
  BParams p = parse_bparams(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, nullptr, nullptr, dims, nullptr, 0, 1.0f);
  if (p.B <= 0 || p.H <= 0 || p.Lq <= 0 || p.Lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kn = key_tile<D, kF32>(p.Lk);
  if (!kF32 && p.Lk > kn) {
    OPlan pl;
    const cudaError_t err = make_oplan<D>(p, &pl);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t got[10] = {kOuterKeys, pl.n_kt, 1, 0, pl.smem_bytes,
                             pl.stats_floats + pl.dq_floats, tile_dim(D), 1, pl.stats_floats,
                             pl.slices};
    for (int i = 0; i < 10; ++i) out[i] = got[i];
    return 0;
  }
  BPlan pl;
  const cudaError_t err = make_bplan(p, tile_dim(D), D, kn, kF32, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t got[10] = {kn, pl.n_kt, p.Lk > kn, pl.acc_smem, pl.smem_bytes,
                           pl.acc_smem ? 0 : static_cast<int64_t>(p.B) * p.H * pl.acc_floats,
                           tile_dim(D), 0, 0, 0};
  for (int i = 0; i < 10; ++i) out[i] = got[i];
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
