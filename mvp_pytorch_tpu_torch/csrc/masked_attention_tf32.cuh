// The fp32 kernel of masked_attention_fwd (masked_attention.cuh): one Hopper
// kernel on `wgmma` (TF32, three passes) and TMA for every fp32 launch.
//
// Replaces the same TPU kernels as the headers it extends
// (`mvp_pytorch_tpu/ops/attention.py` at git 8625894^: `pallas_attention`,
// pallas_call at :114, and `pallas_attention_v2`, :169), and the two
// `mma.sync` + `cp.async` kernels of earlier PRs
// (`tf32::masked_attention_3xtf32_kernel` for Lk <= 128 and
// `tf32::masked_attention_3xtf32_online_kernel` beyond), which were written
// for Ampere: `mma.sync.m16n8k8` products, every operand split once per
// warp, key tiles of 128 (a second, mostly padded tile at Lk 140 and 145),
// copies issued by every thread, the bias read row by row.
//
// Bound (H100 SXM: 3.35 TB/s; 495 TFLOP/s TF32, three passes a product).
// At the rerank shape (B 1,000, L 125, H 12, D 64, key mask) q, k, v and out
// are 4 x 384 MB, 0.459 ms, against 3 x 48 GFLOP, 0.291 ms on the tensor
// cores: bound by bytes on paper, as every shape the port runs. The three
// passes, the operand splits and the transpose of v (below) put the
// arithmetic and the shared-memory traffic close behind, so the kernel
// keeps the copies of the next tile in flight while it computes this one.
//
// Design: the bf16 kernel's (masked_attention_wgmma.cuh), with what fp32
// changes.
//   - One block per SM, persistent, walking a contiguous range of tiles: two
//     consumer warpgroups (64 query rows each; two heads a tile at Lq <= 64,
//     else one head's 128 rows) and one producer warpgroup: one thread
//     issues the TMA copies; three warps stage the bias once for all tiles
//     that share it (`masked_attention_hopper.cuh`) and split every stage's
//     k and v (below), so that the consumers only compute.
//   - Precision. One TF32 pass keeps 10 of fp32's 23 fraction bits and misses
//     the fp32 tolerance (about 9e-4 against 2e-5), so every operand is split
//     into x = hi + lo, hi = tf32(x), lo = tf32(x - hi), and each product is
//     summed as lo.hi + hi.lo + hi.hi with fp32 accumulation (3xTF32):
//     errors near 1e-6. tf32() rounds to nearest, ties away from zero, with
//     two integer operations (the bits of `cvt.rna.tf32.f32`, a slow
//     conversion on this card). Every operand that reaches `wgmma` has its
//     low 13 bits zero, so the result does not depend on how the tensor
//     cores treat those bits. q and k in multiples of 1/8 (the tests'
//     fully-masked rows) have lo = 0, so their scores are exact.
//   - Products: `wgmma.m64nNk8.f32.tf32.tf32`, whose shared-memory operands
//     must be K-major (the transposed forms exist only for 16-bit types).
//     S = q.k^T (N = kN): q split in registers as the A operand (each
//     consumer thread reads its fragments from the swizzled q tile, two
//     k-steps of 8 dims at a time), k hi and lo from shared memory. O = P.v
//     (N = D): P split in registers as A, straight from the score
//     accumulators, two k-steps of 8 keys at a time, v^T hi and lo from
//     shared memory.
//   - The split, once per key tile and block: a stage holds k, v and a third
//     buffer. Once k lands, the split warps write its hi in place and its lo
//     into the third buffer (same layout); once S is done, they transpose v
//     into v^T hi over k's buffer and v^T lo over the third, dims as rows
//     and keys along the 128-byte swizzled rows, and release v's buffer to
//     the next copy. The accumulator of S holds keys 2t and 2t + 1 of each
//     8-key step where a TF32 A fragment wants keys t and t + 4, so the
//     transpose writes each 8-key group in the order 0, 2, 4, 6, 1, 3, 5,
//     7: P goes from the accumulators to `wgmma` with no shuffle (the keys
//     are summed in that order). The consumers wait on mbarriers for each
//     (k split, v^T written) and release k's buffers when S is done and the
//     stage when P.v is done; the next stage's split runs during this
//     stage's softmax and P.v.
//   - D 72 (SigLIP) runs in the D 128 tile (`tile_dim`): TMA zero-fills q,
//     k and v past column 72, the output stores skip those columns.
//   - Key tiles sized to Lk, chosen on the host (`choose`): the smallest of
//     {32, 64, 96, 128, 160} (32, 64 at D 128 and 72) that holds Lk and whose plan
//     fits 227 KB of shared memory (q, a bias slot, one stage of six times
//     the bf16 stage's bytes), one exact tile with an
//     exact row softmax, normalised before P.v; else the largest up to
//     128 that fits, walked with an online softmax normalised after P.v
//     (at 160 keys the online tile's output accumulators would not fit the
//     registers beside its scores; above 160 the exact tile's would not).
//   - Rounding as the reference (`xla_attention`, fp32 branch): s * scale,
//     then + bias, two roundings and no FMA; max, exp (ex2.approx of x
//     log2 e) and the row sum in fp32; keys past Lk get probability 0. Dropout (kDrop, a template
//     parameter) multiplies each probability by the hash's keep / (1 - p)
//     before the split.
//   - Output: each thread stores its two rows, 8 bytes a store (a quad of
//     threads writes 32 contiguous bytes of a row), skipping rows past Lq.
//   The wrapper checks that q, k, v and out are 16-byte aligned with (b, h,
//   l) strides in multiples of 4 elements, makes a broadcast operand dense
//   and widens a bf16 bias to fp32 (exactly).
//
// ptxas (-v), HGMMA counts and occupancy: PERF.md's kernel table
// (chip_smoke.py phase 1 prints registers, spills and HGMMA counts of every
// build).

#pragma once

#include "masked_attention_hopper.cuh"

namespace {
namespace hopper {
namespace f32 {

// Registers a thread after `setmaxnreg`, per instantiation. The block
// launches at 168 a thread, and the consumers' increase must come out of
// the producer's decrease (producer + 2 x consumer = 3 x 168): with the
// producer at 80 and the consumers at 216, setmaxnreg.inc waited forever
// for registers that were never freed. The producer's split warps hold a
// block of v and its halves. Where the consumers' scores and output fit
// 208 registers (D 32; D 64 up to 128 keys), the split warps take 88 and
// read v's rows 16 bytes at a time (the rerank shape ran 8 % faster than
// at 72 registers and 8-byte reads); else 72 and 8-byte reads (at 56 the
// producer spilled; the consumers at 208 spilled at D 64 with 160 keys and
// at D 128).
template <int D, int kN>
struct Regs {
  static constexpr bool kWide = D <= 64 && kN * D <= 128 * 64;
  static constexpr int kProducer = kWide ? 88 : 72, kConsumer = kWide ? 208 : 216;
  static constexpr int kReadDims = kWide ? 4 : 2;  // dims of a v row read at once
};
// k-steps (8 dims of q.k^T, 8 keys of P.v) whose A fragments a consumer
// splits and issues at a time: two hold 16 registers beside the scores and
// the output, where four held 32
constexpr int kStepsAtOnce = 2;
// the widest key tile of the online softmax: a wider one is one exact tile,
// whose output accumulators are not live while its scores are computed
constexpr int kMaxOnlineTile = 128;

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

// e^x as ex2.approx.ftz(x log2 e): within 2^-22 of e^x relative, plus the
// rounding of x log2 e (about 1e-6 relative at the |x| < 20 that carry
// weight in a softmax row); -inf gives 0
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ float4 split4(float4& x) {
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  x = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                  __uint_as_float(h[3]));
  return make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                     __uint_as_float(l[3]));
}

// --- wgmma, TF32 -----------------------------------------------------------

// d (+)= a . b, m64nNk8 tf32 -> fp32: a from registers (a0: row g, column t;
// a1: row g + 8, column t; a2, a3: column t + 4), b from shared memory
// (K-major, 128-byte swizzled rows)
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                           int acc);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<160>(float (&d)[80], const uint32_t (&a)[4], uint64_t b,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// --- the split, by three warps of the producer ------------------------------

// 8- and 16-byte shared-memory accesses at 32-bit addresses (the split
// warps run in the producer's 72 or 88 registers; a generic pointer takes
// two)
template <int W>
__device__ __forceinline__ void lds(uint32_t a, float (&v)[W]) {
  if constexpr (W == 4)
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]) : "r"(a) : "memory");
  else
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v[0]), "=f"(v[1]) : "r"(a) : "memory");
}
__device__ __forceinline__ void sts4(uint32_t a, const float4& v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(a), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

// k of a stage at kb (TMA's layout: D / 32 chunks of hb x kN rows of 128
// bytes) into hi (in place) and lo (the stage's third buffer, same layout)
template <int D, int kN>
__device__ __forceinline__ void split_k(const Plan& pl, uint32_t kb, uint32_t lo, int tid) {
  const uint32_t bytes = pl.hb * kN * D * 4;
#pragma unroll 2
  for (uint32_t off = 16 * tid; off < bytes; off += 16 * kLoaders) {
    float v[4];
    lds<4>(kb + off, v);
    float4 x = make_float4(v[0], v[1], v[2], v[3]);
    const float4 l = split4(x);
    sts4(kb + off, x);
    sts4(lo + off, l);
  }
}

// v of a stage (keys as rows: D / 32 chunks of hb x kN rows of 128 bytes)
// into v^T hi over k's buffer and v^T lo over the third: per head, kN / 32
// chunks of D rows (dims) of 32 keys, each 8-key group in the order 0, 2,
// 4, 6, 1, 3, 5, 7, 128-byte swizzled. A thread moves 4 keys (8j + 2i + h,
// i < 4) by 4 dims, W dims at a time (`Regs`): 4 row reads of 4 W bytes,
// then W hi and W lo writes of 16 bytes; the 8 threads of a quarter warp
// take the 8 (j, h), so that the writes hit distinct banks.
template <int D, int kN>
__device__ __forceinline__ void transpose_v(const Plan& pl, uint32_t vb, uint32_t kb,
                                            uint32_t lo, int tid) {
  constexpr int kQuads = D / 4, kKeyChunks = kN / 32, W = Regs<D, kN>::kReadDims;
  const uint32_t kv_chunk = pl.hb * kN * 128;
  const int n = pl.hb * kKeyChunks * kQuads * 8;
  for (int item = tid; item < n; item += kLoaders) {
    const int jh = item & 7, j8 = jh >> 1, h = jh & 1;
    int rest = item >> 3;
    const int nq = rest % kQuads;
    rest /= kQuads;
    const int kc = rest % kKeyChunks, hh = rest / kKeyChunks;
    const uint32_t src = vb + (nq >> 3) * kv_chunk + hh * kN * 128;
    const uint32_t dst = hh * kN * D * 4 + kc * D * 128;
    const int unit = 2 * j8 + h;
#pragma unroll
    for (int part = 0; part < 4 / W; ++part) {
      float x[4][W];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 32 * kc + 8 * j8 + 2 * i + h;
        lds<W>(src + r * 128 + (((nq & 7) ^ (r & 7)) << 4) + 4 * W * part, x[i]);
      }
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const int row = 4 * nq + W * part + e;
        float4 y = make_float4(x[0][e], x[1][e], x[2][e], x[3][e]);
        const float4 l = split4(y);
        const uint32_t off = dst + row * 128 + ((unit ^ (row & 7)) << 4);
        sts4(kb + off, y);
        sts4(lo + off, l);
      }
    }
  }
}

// A split warp's stores are done and visible to `wgmma` (the async proxy):
// then its lane 0 arrives
__device__ __forceinline__ void split_release(uint32_t bar, int lane) {
  fence_proxy_async();
  __syncwarp();
  if (lane == 0) bar_arrive(bar);
}

// --- the kernel ------------------------------------------------------------

// A consumer warpgroup: its 64 rows of every tile. Thread (warp, lane) holds
// rows warp * 16 + lane / 4 (+ 8) and, of each 8-key (8-dim) block j, keys
// (dims) 8j + 2 (lane % 4), + 1: the wgmma accumulator layout.
template <int D, int kN, bool kDrop>
__device__ __forceinline__ void consume(const Params& p, const Plan& pl, uint8_t* smem,
                                        uint32_t base, int w, int start, int end) {
  static_assert(Chunk<D, 4>::kRowBytes == 128, "fp32 rows are 128-byte swizzled");
  constexpr int kD = tile_dim(D);  // the tile's width (128 at D 72)
  constexpr int NS = kN / 2;       // score accumulators a thread
  constexpr int NO = kD / 2;       // output accumulators a thread
  constexpr int NJ = kN / 8;  // 8-key blocks
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's first row in the warpgroup's 64
  const uint32_t bars = base + pl.off_bar;
  const int wh = pl.hb == 2 ? w : 0;  // the warpgroup's head in the tile
  const int wq = pl.qb == 2 ? w : 0;  // its query block
  const uint32_t q_chunk = 2 * kRows * 128;
  const uint32_t kv_chunk = pl.hb * kN * 128;
  const uint32_t kv_head = wh * kN * 128;
  const uint32_t kv_bytes = pl.hb * kN * kD * 4;
  const uint32_t vt_head = wh * kN * kD * 4;  // v^T of head wh: kN / 32 chunks of kD rows
  const int bias_row = pl.bias_rows > 1 ? r0 * pl.bias_pitch : 0;
  const int bias_row8 = pl.bias_rows > 1 ? 8 * pl.bias_pitch : 0;
  const int bias_blk = pl.bias_blocks == 2 ? w * pl.bias_blk_floats : 0;
  // key tiles a tile walks: 1 (at compile time) above kMaxOnlineTile
  const int n_kt = kN <= kMaxOnlineTile ? pl.n_kt : 1;
  // the dropout seed's words in registers; its threshold and scale stay
  // kernel parameters (the consumers run within 216 registers)
  uint32_t seed0 = 0, seed1 = 0;
  if constexpr (kDrop) {
    const DropMask d = drop_mask(p);
    seed0 = d.s0;
    seed1 = d.s1;
  }

  // rows of tile t that this warpgroup holds (0 when its head is past H or
  // its query block past Lq)
  auto rows_of = [&](const TileIdx& t) {
    return t.h0 + wh < p.H ? max(0, min(kRows, p.Lq - (t.q0 + wq * kRows))) : 0;
  };

  // S = q . k^T, issued and waited for: q from the tile's slot at qb (this
  // warpgroup's rows), split into A fragments kStepsAtOnce k-steps at a
  // time; k hi at k_base, k lo at lo_base
  auto compute_s = [&](float (&acc)[NS], const uint8_t* qb, uint32_t k_base, uint32_t lo_base) {
#pragma unroll
    for (int c = 0; c < kD / 8 / kStepsAtOnce; ++c) {
      uint32_t ah[kStepsAtOnce][4], al[kStepsAtOnce][4];
#pragma unroll
      for (int kk = 0; kk < kStepsAtOnce; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // k-step ks (dims 8 ks ..): a0 row r0, dim 8 ks + t4; a1 row
          // r0 + 8; a2, a3 dim + 4. Dims come in 32-wide swizzled chunks.
          const int ks = c * kStepsAtOnce + kk;
          const int row = r0 + 8 * (e & 1), unit = 2 * (ks % 4) + (e >> 1);
          const float x = *reinterpret_cast<const float*>(
              qb + (ks / 4) * q_chunk + row * 128 + ((unit ^ g) << 4) + 4 * t4);
          split(x, ah[kk][e], al[kk][e]);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStepsAtOnce; ++kk) {
        const int ks = c * kStepsAtOnce + kk;
        const uint32_t off = (ks / 4) * kv_chunk + kv_head + (ks % 4) * 32;
        const uint64_t bh = desc(k_base + off, 16, 1024, 128);
        const uint64_t bl = desc(lo_base + off, 16, 1024, 128);
        wgmma_tf32<kN>(acc, al[kk], bh, ks > 0);
        wgmma_tf32<kN>(acc, ah[kk], bl, 1);
        wgmma_tf32<kN>(acc, ah[kk], bh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();  // its fragments are free for the next ones
    }
    fence_regs(acc);
  };

  // O (+)= P . v, issued and waited for: P in the score accumulators, split
  // kStepsAtOnce k-steps at a time (hi in place); v^T hi at vt_base, lo at
  // lo_base. At k-step j (keys 8j .. 8j + 7) A column t is key 8j + 2t and
  // column t + 4 key 8j + 2t + 1, as the transpose ordered v^T, whose keys
  // come in 32-wide swizzled chunks.
  auto compute_pv = [&](float (&o)[NO], float (&s)[NS], uint32_t vt_base, uint32_t lo_base,
                        bool first) {
    fence_regs(o);  // the online rescale's writes before the products
#pragma unroll
    for (int c = 0; c < NJ / kStepsAtOnce; ++c) {
      uint32_t al[kStepsAtOnce][4];
#pragma unroll
      for (int kk = 0; kk < kStepsAtOnce; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t hi;
          const int j = 4 * (c * kStepsAtOnce + kk) + e;
          split(s[j], hi, al[kk][e]);
          s[j] = __uint_as_float(hi);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStepsAtOnce; ++kk) {
        const int ks = c * kStepsAtOnce + kk, j = 4 * ks;
        const uint32_t ah[4] = {__float_as_uint(s[j]), __float_as_uint(s[j + 2]),
                                __float_as_uint(s[j + 1]), __float_as_uint(s[j + 3])};
        const uint32_t alp[4] = {al[kk][0], al[kk][2], al[kk][1], al[kk][3]};
        const uint32_t off = vt_head + (ks / 4) * kD * 128 + (ks % 4) * 32;
        const uint64_t bh = desc(vt_base + off, 16, 1024, 128);
        const uint64_t bl = desc(lo_base + off, 16, 1024, 128);
        wgmma_tf32<kD>(o, alp, bh, !first || ks > 0);
        wgmma_tf32<kD>(o, ah, bl, 1);
        wgmma_tf32<kD>(o, ah, bh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
    fence_regs(o);
  };

  int slot = 0, bslot = 0;
  uint32_t phase = 0, bphase = 0;
  int prev_key = -1;  // bias keys are below the tile count, < 2^31
  TileWalk walk(pl, start), ahead(pl, start);
  ahead.next(pl);
  for (int i = start; i < end; ++i, walk.next(pl), ahead.next(pl)) {
    const TileIdx t = walk.tile(pl);
    const int key = static_cast<int>(t.key);
    const int n = i - start, qs = n & (pl.q_slots - 1);
    const int head = t.h0 + wh;
    const int q_first = t.q0 + wq * kRows;
    const int rows = rows_of(t);
    const bool active = rows > 0;             // warpgroup-uniform
    const bool warp_rows = warp * 16 < rows;  // warp-uniform
    const bool last_tile = i + 1 == end;
    const int next_key = static_cast<int>(ahead.tile(pl).key);  // unless last_tile
    const uint8_t* q_wg = smem + pl.off_q + qs * pl.q_slot_bytes + w * kRows * 128;
    bar_wait(bars + 8 * (kQFull + qs), static_cast<uint32_t>((n >> (pl.q_slots - 1)) & 1));
    float o[NO];
    float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
    for (int kt = 0; kt < n_kt; ++kt) {
      // past one key tile every key tile has its own bias tile; else tiles
      // with the same key share one
      const bool group_start = n_kt > 1 || i == start || key != prev_key;
      const bool group_end = n_kt > 1 || last_tile || next_key != key;
      if (group_start && !(i == start && kt == 0) && ++bslot == pl.bias_slots) {
        bslot = 0;
        bphase ^= 1;
      }
      const uint32_t k_base = base + pl.off_kv + slot * pl.kv_stage_bytes;
      const uint32_t lo_base = k_base + 2 * kv_bytes;

      // S from k's hi and lo halves
      bar_wait(bars + 8 * (kKReady + slot), phase);
      float s[NS];
      if (active) compute_s(s, q_wg, k_base, lo_base);
      warp_release(bars + 8 * (kSDone + slot), lane);  // k's buffers may take v^T
      if (kt == n_kt - 1) warp_release(bars + 8 * (kQEmpty + qs), lane);

      // the scores as the reference rounds them, and their softmax
      if (group_start) bar_wait(bars + 8 * (kBiasFull + bslot), bphase);
      if (warp_rows) {
        const float* brow =
            reinterpret_cast<const float*>(smem + pl.off_bias + bslot * pl.bias_slot_bytes)
            + bias_blk + bias_row + 2 * t4
            + (pl.bias_flat ? flat_shift(block_first(p, pl, t, pl.bias_blocks == 2 ? w : 0))
                            : 0);
        const int kcol = kt * kN + 2 * t4;  // this thread's first key
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // keys past Lk -inf (a contiguous copy holds the next row there)
              const float b = kcol + 8 * j + e < p.Lk ? brow[r * bias_row8 + 8 * j + e] : -INFINITY;
              float& x = s[4 * j + 2 * r + e];
              x = __fadd_rn(__fmul_rn(x, p.scale), b);
              mx[r] = fmaxf(mx[r], x);
            }
        float m_new[2], corr[2], f[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          m_new[r] = fmaxf(m_r[r], mx[r]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& x = s[4 * j + e];
            x = exp_approx(x - m_new[e / 2]);
            sum[e / 2] += x;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
          corr[r] = exp_approx(m_r[r] - m_new[r]);  // 0 on the first key tile
          l_r[r] = l_r[r] * corr[r] + sum[r];
          m_r[r] = m_new[r];
          // one key tile: normalised before P.v, in the reference's order;
          // more: the online softmax normalises after P.v
          f[r] = n_kt == 1 ? 1.f / sum[r] : 1.f;
        }
        if (kt > 0) {
#pragma unroll
          for (int j = 0; j < NO / 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e / 2];
        }
        if constexpr (kDrop) {
          const DropMask dm{seed0, seed1, p.drop_threshold, p.drop_scale};
          uint64_t rb[2];
          drop_rows(rb, p, static_cast<int64_t>(t.b) * p.H + head, q_first + r0, kt * kN, t4);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[4 * j + e] = s[4 * j + e] * f[e / 2] * dm.factor(rb[e / 2] + 8 * j + e % 2);
        } else {
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[4 * j + e] *= f[e / 2];
        }
      } else {
#pragma unroll
        for (int x = 0; x < NS; ++x) s[x] = 0.f;
      }
      if (group_end) warp_release(bars + 8 * (kBiasEmpty + bslot), lane);

      // O from P and v^T's hi and lo halves
      bar_wait(bars + 8 * (kVtReady + slot), phase);
      if (active) compute_pv(o, s, k_base, lo_base, kt == 0);
      warp_release(bars + 8 * (kKvEmpty + slot), lane);
      if (++slot == pl.stages) {
        slot = 0;
        phase ^= 1;
      }
    }
    prev_key = key;

    // the output: each thread's two rows, 8 bytes a store (a quad of threads
    // writes 32 contiguous bytes of a row), rows past Lq and the tile's
    // columns past D skipped
    if (active) {
      const float f[2] = {n_kt == 1 ? 1.f : 1.f / l_r[0], n_kt == 1 ? 1.f : 1.f / l_r[1]};
      float* og = static_cast<float*>(p.out) + t.b * p.o_s[0] + head * p.o_s[1]
                  + (q_first + r0) * p.o_s[2] + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float* row = og + 8 * r * p.o_s[2];
        if (r0 + 8 * r < rows) {
#pragma unroll
          for (int j = 0; j < NO / 4; ++j)
            if (8 * j < D)
              *reinterpret_cast<float2*>(row + 8 * j) =
                  make_float2(o[4 * j + 2 * r] * f[r], o[4 * j + 2 * r + 1] * f[r]);
        }
      }
    }
  }
}

// One block per SM walks tiles [start, end) of the launch: warpgroups 0 and 1
// consume, warpgroup 2 produces (warp 0: TMA; warps 1-3: the bias and the
// split of every stage's k and v, in the order the consumers take them).
template <int D, int kN, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
masked_attention_tf32_kernel(const __grid_constant__ Params p,
                             const __grid_constant__ Plan pl,
                             const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + pl.off_bar;
  const int start = static_cast<int>(static_cast<int64_t>(blockIdx.x) * pl.n_tiles / gridDim.x);
  const int end = static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) * pl.n_tiles / gridDim.x);
  constexpr int kSplitWarps = kLoaders / 32;
  constexpr int kD = tile_dim(D);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxQSlots; ++s) {
      bar_init(bars + 8 * (kQFull + s), 1);
      bar_init(bars + 8 * (kQEmpty + s), kConsumerWarps);
    }
    for (int s = 0; s < kMaxStages; ++s) {
      bar_init(bars + 8 * (kKFull + s), 1);
      bar_init(bars + 8 * (kVFull + s), 1);
      bar_init(bars + 8 * (kKvEmpty + s), kConsumerWarps);
      bar_init(bars + 8 * (kVEmpty + s), kSplitWarps);
      bar_init(bars + 8 * (kKReady + s), kSplitWarps);
      bar_init(bars + 8 * (kSDone + s), kConsumerWarps);
      bar_init(bars + 8 * (kVtReady + s), kSplitWarps);
    }
    for (int s = 0; s < kMaxBiasSlots; ++s) {
      bar_init(bars + 8 * (kBiasFull + s), kLoaders);
      bar_init(bars + 8 * (kBiasEmpty + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(Regs<kD, kN>::kProducer));
    const int warp = threadIdx.x / 32 % 4;
    if (warp == 0) {
      if (threadIdx.x % 32 == 0) produce<D, kN, 4, true>(pl, base, &tq, &tk, &tv, start, end);
    } else {
      // after each key tile's bias: split its k once it lands, and once S
      // is done (k's buffers free) transpose its v into them
      const int tid = threadIdx.x % 128 - 32, lane = threadIdx.x % 32;
      const uint32_t kv_bytes = pl.hb * kN * kD * 4;
      int slot = 0;
      uint32_t phase = 0;
      stage_bias<kN>(p, pl, smem, base, tid, start, end, [&] {
        const uint32_t kb = base + pl.off_kv + slot * pl.kv_stage_bytes;
        bar_wait(bars + 8 * (kKFull + slot), phase);
        split_k<kD, kN>(pl, kb, kb + 2 * kv_bytes, tid);
        split_release(bars + 8 * (kKReady + slot), lane);
        bar_wait(bars + 8 * (kSDone + slot), phase);
        bar_wait(bars + 8 * (kVFull + slot), phase);
        transpose_v<kD, kN>(pl, kb + kv_bytes, kb, kb + 2 * kv_bytes, tid);
        split_release(bars + 8 * (kVtReady + slot), lane);
        if (lane == 0) bar_arrive(bars + 8 * (kVEmpty + slot));
        if (++slot == pl.stages) {
          slot = 0;
          phase ^= 1;
        }
      });
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(Regs<kD, kN>::kConsumer));
    consume<D, kN, kDrop>(p, pl, smem, base, wg, start, end);
  }
}

// --- host ------------------------------------------------------------------

// SMs of the current device, after the kernel's shared-memory attribute is
// set, once per device and instantiation
template <int D, int kN, bool kDrop>
cudaError_t prepare(int* sms) {
  static int count[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (count[dev] == 0) {
    err = cudaFuncSetAttribute(masked_attention_tf32_kernel<D, kN, kDrop>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = count[dev];
  return cudaSuccess;
}

template <int D, int kN, bool kDrop>
cudaError_t launch(const Params& p, int hb, int order, cudaStream_t stream) {
  if (!aligned16(p.q, p.q_s, 4) || !aligned16(p.k, p.k_s, 4) || !aligned16(p.v, p.v_s, 4)
      || !aligned16(p.out, p.o_s, 4))
    return cudaErrorMisalignedAddress;
  Plan pl;
  cudaError_t err = make_plan(p, tile_dim(D), kN, 4, hb, order, &pl);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (encode<D, 4>(&tq, p.q, p.B, p.H, p.Lq, p.q_s, kRows * pl.qb, hb) != CUDA_SUCCESS
      || encode<D, 4>(&tk, p.k, p.B, p.H, p.Lk, p.k_s, kN, hb) != CUDA_SUCCESS
      || encode<D, 4>(&tv, p.v, p.B, p.H, p.Lk, p.v_s, kN, hb) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  int sms = 0;
  err = prepare<D, kN, kDrop>(&sms);
  if (err != cudaSuccess) return err;
  const int grid = pl.n_tiles < sms ? pl.n_tiles : sms;
  masked_attention_tf32_kernel<D, kN, kDrop>
      <<<static_cast<unsigned>(grid), kThreads, pl.smem_bytes, stream>>>(p, pl, tq, tk, tv);
  return cudaGetLastError();
}

// The launch's choices, from its shape and its bias strides alone: heads a
// tile and tile order as the bf16 kernel's (`hopper::choose`); kn, the
// smallest instantiated key tile that holds Lk and whose plan fits, else
// the largest up to kMaxOnlineTile that fits (the online softmax walks it);
// 0 when none fits.
struct Choice {
  int kn, hb, order;
};
constexpr int kKeyTiles[] = {32, 64, 96, 128, 160};
// key tiles instantiated at head dim D: five, two at D 128 and 72 (q, one k/v
// stage and the split buffer of a wider tile would not fit shared memory)
template <int D>
constexpr int n_key_tiles() { return tile_dim(D) < 128 ? 5 : 2; }

template <int D>
Choice choose(const Params& p) {
  Choice c{0, p.Lq <= kRows && p.H > 1 ? 2 : 1,
           p.bias != nullptr && p.b_s[2] != 0 && p.b_s[1] == 0 ? 1 : 0};
  for (int i = 0; i < n_key_tiles<D>(); ++i) {
    Plan pl;
    if (make_plan(p, tile_dim(D), kKeyTiles[i], 4, c.hb, c.order, &pl) != cudaSuccess) continue;
    if (kKeyTiles[i] >= p.Lk) {
      c.kn = kKeyTiles[i];
      break;
    }
    if (kKeyTiles[i] <= kMaxOnlineTile) c.kn = kKeyTiles[i];
  }
  return c;
}

// f(std::integral_constant<int, kN>{}) for the key tile kn of head dim D
template <int D, typename F>
cudaError_t with_key_tile(int kn, F&& f) {
  switch (kn) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: break;
  }
  if constexpr (n_key_tiles<D>() > 2) {
    switch (kn) {
      case 96: return f(std::integral_constant<int, 96>{});
      case 128: return f(std::integral_constant<int, 128>{});
      case 160: return f(std::integral_constant<int, 160>{});
      default: break;
    }
  }
  return kn == 0 ? cudaErrorInvalidConfiguration : cudaErrorInvalidValue;
}

// masked_attention_fwd in fp32 for one head dim and dropout setting
template <int D, bool kDrop>
int fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
        const void* dims_ptr, void* stream_ptr, const void* seed, uint32_t drop_threshold,
        float drop_scale) {
  const int64_t* dims = static_cast<const int64_t*>(dims_ptr);
  const Params p = parse_params(q, k, v, bias, out, dims, seed, drop_threshold, drop_scale);
  // the bias is fp32 (the wrapper widens a bf16 one, exactly)
  if ((bias != nullptr && dims[6] != 0) || p.B <= 0 || p.H <= 0 || p.Lq <= 0 || p.Lk <= 0
      || dims[4] != D)
    return static_cast<int>(cudaErrorInvalidValue);
  const Choice c = choose<D>(p);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return static_cast<int>(with_key_tile<D>(c.kn, [&](auto kn) {
    return launch<D, decltype(kn)::value, kDrop>(p, c.hb, c.order, stream);
  }));
}

// The plan masked_attention_fwd makes for an fp32 launch of these dims (as
// masked_attention_fwd takes them; `has_bias` stands for the bias pointer):
// out = {key tile, heads a tile, tile order, tiles, k/v stages, shared
// memory bytes, the head dim's tile width}
template <int D>
int plan(const int64_t* dims, int has_bias, int64_t* out) {
  Params p = parse_params(nullptr, nullptr, nullptr, nullptr, nullptr, dims, nullptr, 0, 1.0f);
  p.bias = has_bias ? dims : nullptr;  // only tested against null
  if (p.B <= 0 || p.H <= 0 || p.Lq <= 0 || p.Lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Choice c = choose<D>(p);
  if (c.kn == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  Plan pl;
  const cudaError_t err = make_plan(p, tile_dim(D), c.kn, 4, c.hb, c.order, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t got[7] = {c.kn, c.hb, c.order, pl.n_tiles, pl.stages, pl.smem_bytes,
                          tile_dim(D)};
  for (int i = 0; i < 7; ++i) out[i] = got[i];
  return 0;
}

// resident blocks per SM of the kernel without dropout at its 128-key tile
// (64 at D 128 and 72), with the shared memory of a key-mask launch at Lq > 64
template <int D>
int blocks_per_sm(int* n) {
  constexpr int kN = tile_dim(D) < 128 ? 128 : 64;
  int sms = 0;
  cudaError_t err = prepare<D, kN, false>(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{};
  p.B = p.H = 1;
  p.Lq = 2 * kRows;
  p.Lk = kN;
  Plan pl;
  err = make_plan(p, tile_dim(D), kN, 4, 1, 0, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, masked_attention_tf32_kernel<D, kN, false>,
                                                    kThreads, pl.smem_bytes));
}

}  // namespace f32
}  // namespace hopper
}  // namespace
