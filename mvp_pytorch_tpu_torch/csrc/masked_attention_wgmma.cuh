// The bf16 kernel of masked_attention_fwd (masked_attention.cuh): one Hopper
// kernel on `wgmma` and TMA for every bf16 launch.
//
// Replaces the same TPU kernels as the headers it extends
// (`mvp_pytorch_tpu/ops/attention.py` at git 8625894^: `pallas_attention`,
// pallas_call at :114, and `pallas_attention_v2`, :169), and the two
// `mma.sync` + `cp.async` kernels of earlier PRs (`tc::masked_attention_mma_kernel`
// for Lk <= 128 and `tc::masked_attention_mma_online_kernel` beyond), which
// were written for Ampere: no wgmma, no TMA, 128 x 128 tiles, a per-query
// bias read thread by thread.
//
// Bound (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16). Every shape the port runs
// is bound by bytes: q, k, v and out once each, plus the bias once.
//   - rerank (B 1,000, L 125, H 12, D 64, key mask): 768 MB, 0.229 ms, against
//     48 GFLOP, 0.049 ms on the tensor cores;
//   - per-query bias (CBS: N 384, L 90, seq2seq bias [N, 1, L, L] fp32 shared
//     by the 12 heads): 212 MB of q, k, v, out plus 12 MB of bias, 0.067 ms;
//     read once per head, the bias alone would be 149 MB, 0.044 ms more;
//   - cached decode (N 250, Lq 2, Lk 92): the 70.7 MB of k and v are the
//     cost (0.022 ms); the products are 0.6 % of the tensor-core time.
// So the kernel reads each byte once and keeps copies in flight; the
// arithmetic matters only where it is paid on rows that hold no query.
//
// Design, and what each choice does about that bound:
//   - One block per SM, persistent, each walking a contiguous range of tiles:
//     two consumer warpgroups and one producer warpgroup (384 threads). The
//     producer gives its registers away (`setmaxnreg`: 64 a thread; the
//     consumers take 216).
//   - Tiles: a tile is 128 query rows, 64 for each consumer warpgroup. For
//     Lq > 64 both halves belong to one head and share its k and v (read
//     once per head and 128 queries). For Lq <= 64, decode included, the
//     halves are two heads of the same batch row (warpgroup w takes head
//     2i + w), so neither warpgroup computes on a tile that holds only a
//     couple of queries while the other waits. Within a warpgroup, a warp
//     whose 16 rows hold no query skips its softmax (`wgmma` still runs on
//     all 64 rows: it is the card's cheap resource here). A decode step is
//     thus a 64-row `wgmma` with idle rows, not an `mma.sync` tile: the
//     products cost under 1 % of its time, and k and v stream near the
//     card's bandwidth at N 1,250 (PERF.md's table).
//   - Key tiles sized to Lk: kN is Lk rounded up within {32, 64, 96, 128,
//     160, 256}, one exact tile and an exact row softmax for every length
//     up to 256 (70, 75, 90, 92, 105, 125, 140, 145, ...). Past 256 keys
//     the kernel walks tiles of 256 with an online softmax. At D 128 the
//     key tile stops at 64 (the tile's scores and output would not fit the
//     registers beside each other), online beyond. D 72 (SigLIP) runs in
//     the D 128 tile (`tile_dim`): TMA zero-fills q, k and v past column
//     72, the output stores skip those columns.
//   - Copies by TMA (`cp.async.bulk.tensor`, 4-D maps over (D, L, H, B)
//     with the tensors' own strides, both layouts alike), 128-byte swizzled
//     (64-byte at D 32) as `wgmma` reads them, each completing on an
//     mbarrier. One thread of the producer issues them: q into two buffers
//     (the next tile's loads during this one), k and v into a ring of 1-4
//     stages (as many as fit in 227 KB), k and v on separate barriers so
//     that q.k^T starts while v is in flight. Rows past Lq or Lk and heads
//     past H come in as zeros (TMA's bounds), so no tile edge costs a byte.
//     The three maps are encoded on the host at each launch (0.2-0.4 us,
//     measured in chip_smoke.py phase 1; not cached).
//   - Products: S = q.k^T as `wgmma.m64nNk16` (N = kN) with q and k from
//     shared memory; O = P.v as `wgmma.m64nDk16` with P from registers (the
//     accumulator layout of S is the A-operand layout of P.v) and v read
//     transposed from shared memory. Accumulation in fp32.
//   - The bias is staged once for all heads that share it. Tiles are walked
//     with heads innermost for a fixed (b, query tile) when the bias is per
//     query and broadcast over heads (every seq2seq and decode mask), so one
//     copy of the [128, Lk] fp32 bias tile in shared memory serves the 12
//     heads; a key-mask bias is one row per batch row. When a block's rows
//     lie contiguous (every mask the models make), one bulk copy by the TMA
//     unit brings it in (its rows are seldom 16-byte aligned, which a
//     tensor map needs); other biases come row by row in 4-byte `cp.async`
//     copies, which are many times slower for a per-query tile (a bias fill
//     the first tiles of a block wait for; the per-query rows of PERF.md's
//     table fell by 20-50 % when the bulk copy replaced them). Three
//     producer warps do it, two slots deep, so the next group's bias loads
//     while this one computes. Keys past Lk get -inf.
//   - Output: each thread stores its two rows in 4-byte stores (a quad of
//     threads writes 16 contiguous bytes of a row), skipping rows past Lq;
//     staging through shared memory for TMA stores measured slower (its
//     fences and warpgroup barriers).
//   - Rounding as the reference (`xla_attention`): q.k, times the bf16
//     scale, plus the bf16 bias, each rounded to bf16 (packed bf16x2
//     operations); the row max over those; s - m rounded to bf16; exp
//     (ex2.approx.ftz: results below 2^-126 flush to 0) and the row sum in
//     fp32. With one key tile the probabilities are normalised, then
//     rounded to bf16 before P.v; with more, an online softmax normalises
//     after P.v. A row whose keys are all masked comes out uniform. Dropout
//     (kDrop, a template parameter) multiplies each probability by the
//     hash's keep / (1 - p) in registers, on the accumulator fragment,
//     before the rounding to bf16.
//   - Where the time goes: the two warpgroups of a block work through the
//     same phase of the same tile at once, so per tile the softmax, the
//     output stores and the two products follow one another; the softmax is
//     the largest of them, and the copies run ahead of all of it. Tried and
//     measured slower in PERF.md's table: issuing the next tile's q.k^T
//     behind P.v (register pressure), staged TMA stores of the output.
//   The wrapper checks that q, k, v and out are 16-byte aligned and that their
//   (b, h, l) strides are multiples of 8 elements (TMA needs both), widens a
//   bf16 bias to fp32; `fwd` below picks the key-tile width, the heads of a
//   tile and the tile order from the shape and the bias strides (`choose`).
//
// ptxas (-v), HGMMA counts and occupancy: PERF.md's kernel table
// (chip_smoke.py phase 1 prints registers, spills and HGMMA counts of every
// build).

#pragma once

#include "masked_attention_hopper.cuh"

namespace {
namespace hopper {

using bf16 = __nv_bfloat16;

constexpr int kProducerRegs = 64, kConsumerRegs = 216;

// --- wgmma, bf16 -----------------------------------------------------------

// d (+)= a . b, m64nNk16 bf16 -> fp32: a and b from shared memory (K-major)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);
// d (+)= a . b, m64nNk16: a from registers, b from shared memory, transposed
// (MN-major: v's rows are keys)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int acc);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<96>(float (&d)[48], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<160>(float (&d)[80], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<256>(float (&d)[128], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

// --- the kernel ------------------------------------------------------------

// e^x as ex2.approx.ftz(x log2 e): a result below 2^-126 flushes to zero,
// which no probability of a softmax row (whose largest is 1) can miss
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A consumer warpgroup: its 64 rows of every tile. Thread (warp, lane) holds
// rows warp * 16 + lane / 4 (+ 8) and, of each 8-key (8-dim) block j, keys
// (dims) 8j + 2 (lane % 4), + 1: the wgmma accumulator layout.
template <int D, int kN, bool kDrop>
__device__ __forceinline__ void consume(const Params& p, const Plan& pl, uint8_t* smem,
                                        uint32_t base, int w, int start, int end) {
  using C = Chunk<D, 2>;
  constexpr int NS = kN / 2;      // score accumulators a thread
  constexpr int NO = C::kD / 2;   // output accumulators a thread (the tile's width)
  constexpr int NJ = kN / 8;  // 8-key blocks
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's first row in the warpgroup's 64
  const uint32_t bars = base + pl.off_bar;
  const int wh = pl.hb == 2 ? w : 0;  // the warpgroup's head in the tile
  const int wq = pl.qb == 2 ? w : 0;  // its query block
  const uint32_t q_wg = base + pl.off_q + w * kRows * C::kRowBytes;
  const uint32_t q_chunk = 2 * kRows * C::kRowBytes;
  const uint32_t kv_chunk = pl.hb * kN * C::kRowBytes;
  const uint32_t kv_head = wh * kN * C::kRowBytes;
  const uint32_t kv_bytes = pl.hb * kN * C::kD * 2;
  const int bias_row = pl.bias_rows > 1 ? r0 * pl.bias_pitch : 0;
  const int bias_row8 = pl.bias_rows > 1 ? 8 * pl.bias_pitch : 0;
  const int bias_blk = pl.bias_blocks == 2 ? w * pl.bias_blk_floats : 0;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(p.scale);
  const __nv_bfloat162 ninf2 = __float2bfloat162_rn(-INFINITY);
  DropMask dm{};
  if constexpr (kDrop) dm = drop_mask(p);

  // rows of tile t that this warpgroup holds (0 when its head is past H or
  // its query block past Lq)
  auto rows_of = [&](const TileIdx& t) {
    return t.h0 + wh < p.H ? max(0, min(kRows, p.Lq - (t.q0 + wq * kRows))) : 0;
  };
  // S = q . k^T, issued: q at q_base, k in the stage at st
  auto issue_s = [&](float (&acc)[NS], uint32_t q_base, uint32_t st) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kD / 16; ++kk) {
      const uint32_t c = kk / C::kKSteps, ko = (kk % C::kKSteps) * 32;
      wgmma_ss<kN>(acc, desc(q_base + c * q_chunk + ko, 16, 8 * C::kRowBytes, C::kRowBytes),
                   desc(st + c * kv_chunk + kv_head + ko, 16, 8 * C::kRowBytes, C::kRowBytes),
                   kk > 0);
    }
    wgmma_commit();
  };

  int slot = 0, bslot = 0;
  uint32_t phase = 0, bphase = 0;
  int64_t prev_key = -1;
  TileWalk walk(pl, start), ahead(pl, start);
  ahead.next(pl);
  for (int i = start; i < end; ++i, walk.next(pl), ahead.next(pl)) {
    const TileIdx t = walk.tile(pl);
    const int n = i - start, qs = n & (pl.q_slots - 1);
    const int head = t.h0 + wh;
    const int q_first = t.q0 + wq * kRows;
    const int rows = rows_of(t);
    const bool active = rows > 0;             // warpgroup-uniform
    const bool warp_rows = warp * 16 < rows;  // warp-uniform
    const bool last_tile = i + 1 == end;
    const int64_t next_key = ahead.tile(pl).key;  // the next tile's, unless last_tile
    bar_wait(bars + 8 * (kQFull + qs), static_cast<uint32_t>((n >> (pl.q_slots - 1)) & 1));
    float o[NO];
    float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
    for (int kt = 0; kt < pl.n_kt; ++kt) {
      // past 256 keys every key tile has its own bias tile; else tiles with
      // the same key share one
      const bool group_start = pl.n_kt > 1 || i == start || t.key != prev_key;
      const bool group_end = pl.n_kt > 1 || last_tile || next_key != t.key;
      if (group_start && !(i == start && kt == 0) && ++bslot == pl.bias_slots) {
        bslot = 0;
        bphase ^= 1;
      }
      const uint32_t st = base + pl.off_kv + slot * pl.kv_stage_bytes;
      float s[NS];
      bar_wait(bars + 8 * (kKFull + slot), phase);
      if (active) {
        issue_s(s, q_wg + qs * pl.q_slot_bytes, st);
        wgmma_wait<0>();
        fence_regs(s);
      }
      if (kt == pl.n_kt - 1) warp_release(bars + 8 * (kQEmpty + qs), lane);

      // the scores as the reference rounds them, their softmax, P in bf16
      uint32_t pk[kN / 4];  // pk[2j + r]: keys 8j + 2 t4, + 1 of row r0 + 8r
      if (group_start) bar_wait(bars + 8 * (kBiasFull + bslot), bphase);
      if (warp_rows) {
        const float* brow =
            reinterpret_cast<const float*>(smem + pl.off_bias + bslot * pl.bias_slot_bytes)
            + bias_blk + bias_row + 2 * t4
            + (pl.bias_flat ? flat_shift(block_first(p, pl, t, pl.bias_blocks == 2 ? w : 0))
                            : 0);
        const int kcol = kt * kN + 2 * t4;  // this thread's first key
        __nv_bfloat162 sb[NJ][2];
        __nv_bfloat162 mx2[2] = {ninf2, ninf2};
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            // keys past Lk -inf (a contiguous copy holds the next row there)
            const float* bb = brow + r * bias_row8 + 8 * j;
            const __nv_bfloat162 b2 = __floats2bfloat162_rn(
                kcol + 8 * j < p.Lk ? bb[0] : -INFINITY,
                kcol + 8 * j + 1 < p.Lk ? bb[1] : -INFINITY);
            __nv_bfloat162 x = __floats2bfloat162_rn(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
            x = __hadd2(__hmul2(x, scale2), b2);
            sb[j][r] = x;
            mx2[r] = __hmax2(mx2[r], x);
          }
        float m_new[2], corr[2], f[2];
        __nv_bfloat162 m2[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = fmaxf(__low2float(mx2[r]), __high2float(mx2[r]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          m_new[r] = fmaxf(m_r[r], mx);  // a bf16 value: the max of bf16 scores
          m2[r] = __float2bfloat162_rn(m_new[r]);
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            // s - m rounded to bf16, as the reference subtracts; exp in fp32
            const float2 d = __bfloat1622float2(__hsub2(sb[j][r], m2[r]));
            s[4 * j + 2 * r] = exp_ftz(d.x);
            s[4 * j + 2 * r + 1] = exp_ftz(d.y);
            sum[r] += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
          corr[r] = exp_ftz(m_r[r] - m_new[r]);  // 0 on the first key tile
          l_r[r] = l_r[r] * corr[r] + sum[r];
          m_r[r] = m_new[r];
          // one key tile: normalised before the rounding, in the reference's
          // order; more: the online softmax normalises after P.v
          f[r] = pl.n_kt == 1 ? 1.f / sum[r] : 1.f;
        }
        if (kt > 0) {
#pragma unroll
          for (int j = 0; j < NO / 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e / 2];
        }
        if constexpr (kDrop) {
          uint64_t rb[2];
          drop_rows(rb, p, static_cast<int64_t>(t.b) * p.H + head, q_first + r0, kt * kN, t4);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const uint64_t e = rb[r] + 8 * j;
              pk[2 * j + r] = pack_bf16(s[4 * j + 2 * r] * f[r] * dm.factor(e),
                                        s[4 * j + 2 * r + 1] * f[r] * dm.factor(e + 1));
            }
        } else {
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              pk[2 * j + r] = pack_bf16(s[4 * j + 2 * r] * f[r], s[4 * j + 2 * r + 1] * f[r]);
        }
      } else {
#pragma unroll
        for (int x = 0; x < kN / 4; ++x) pk[x] = 0u;
      }
      if (group_end) warp_release(bars + 8 * (kBiasEmpty + bslot), lane);

      // O (+)= P . v, issued
      bar_wait(bars + 8 * (kVFull + slot), phase);
      if (active) {
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) {
          const uint32_t a[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2], pk[4 * kk + 3]};
          wgmma_rs<C::kD>(o, a,
                      desc(st + kv_bytes + kv_head + kk * 16 * C::kRowBytes, kv_chunk,
                           8 * C::kRowBytes, C::kRowBytes),
                      kt > 0 || kk > 0);
        }
        wgmma_commit();
      }
      if (active) {
        wgmma_wait<0>();
        fence_regs(o);
      }
      warp_release(bars + 8 * (kKvEmpty + slot), lane);
      if (++slot == pl.stages) {
        slot = 0;
        phase ^= 1;
      }
    }
    prev_key = t.key;

    // the output: each thread's two rows, 4 bytes a store (a quad of
    // threads writes 16 contiguous bytes of a row), rows past Lq and the
    // tile's columns past D skipped
    if (active) {
      const float f[2] = {pl.n_kt == 1 ? 1.f : 1.f / l_r[0], pl.n_kt == 1 ? 1.f : 1.f / l_r[1]};
      bf16* og = static_cast<bf16*>(p.out) + t.b * p.o_s[0] + head * p.o_s[1]
                 + (q_first + r0) * p.o_s[2] + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bf16* row = og + 8 * r * p.o_s[2];
        if (r0 + 8 * r < rows) {
#pragma unroll
          for (int j = 0; j < NO / 4; ++j)
            if (8 * j < D)
              *reinterpret_cast<uint32_t*>(row + 8 * j) =
                  pack_bf16(o[4 * j + 2 * r] * f[r], o[4 * j + 2 * r + 1] * f[r]);
        }
      }
    }
  }
}

// One block per SM walks tiles [start, end) of the launch: warpgroups 0 and 1
// consume, warpgroup 2 produces (warp 0: TMA; warps 1-3: the bias).
template <int D, int kN, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
masked_attention_wgmma_kernel(const __grid_constant__ Params p,
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
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxQSlots; ++s) {
      bar_init(bars + 8 * (kQFull + s), 1);
      bar_init(bars + 8 * (kQEmpty + s), kConsumerWarps);
    }
    for (int s = 0; s < kMaxStages; ++s) {
      bar_init(bars + 8 * (kKFull + s), 1);
      bar_init(bars + 8 * (kVFull + s), 1);
      bar_init(bars + 8 * (kKvEmpty + s), kConsumerWarps);
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    const int warp = threadIdx.x / 32 % 4;
    if (warp == 0) {
      if (threadIdx.x % 32 == 0) produce<D, kN, 2, false>(pl, base, &tq, &tk, &tv, start, end);
    } else {
      stage_bias<kN>(p, pl, smem, base, threadIdx.x % 128 - 32, start, end, [] {});
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
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
    err = cudaFuncSetAttribute(masked_attention_wgmma_kernel<D, kN, kDrop>,
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
  if (!aligned16(p.q, p.q_s, 2) || !aligned16(p.k, p.k_s, 2) || !aligned16(p.v, p.v_s, 2)
      || !aligned16(p.out, p.o_s, 2))
    return cudaErrorMisalignedAddress;
  Plan pl;
  cudaError_t err = make_plan(p, tile_dim(D), kN, 2, hb, order, &pl);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (encode<D, 2>(&tq, p.q, p.B, p.H, p.Lq, p.q_s, kRows * pl.qb, hb) != CUDA_SUCCESS
      || encode<D, 2>(&tk, p.k, p.B, p.H, p.Lk, p.k_s, kN, hb) != CUDA_SUCCESS
      || encode<D, 2>(&tv, p.v, p.B, p.H, p.Lk, p.v_s, kN, hb) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  int sms = 0;
  err = prepare<D, kN, kDrop>(&sms);
  if (err != cudaSuccess) return err;
  const int grid = pl.n_tiles < sms ? pl.n_tiles : sms;
  masked_attention_wgmma_kernel<D, kN, kDrop>
      <<<static_cast<unsigned>(grid), kThreads, pl.smem_bytes, stream>>>(p, pl, tq, tk, tv);
  return cudaGetLastError();
}

// The launch's choices, from its shape and its bias strides alone:
//   - kn, the key tile: the smallest instantiated width that holds Lk (one
//     exact tile), else the largest (the online softmax walks tiles of it);
//   - hb, the heads of a tile: a tile is 128 query rows, 64 for each
//     consumer warpgroup: two heads of 64 rows when Lq <= 64 (decode:
//     neither warpgroup works on a tile that holds only a query or two),
//     else one head's 128 rows, which share its k and v;
//   - order 1 (head tiles innermost) when the bias is per query and
//     broadcast over heads (seq2seq and decode masks): consecutive tiles
//     then need the same bias tile, staged once for all heads; else 0
//     (query tiles innermost: consecutive tiles share k and v).
struct Choice {
  int kn, hb, order;
};
constexpr int kKeyTiles[] = {32, 64, 96, 128, 160, 256};
// key tiles instantiated at head dim D: all six, two at D 128 and 72 (the
// tile's scores and output share the registers)
template <int D>
constexpr int n_key_tiles() { return tile_dim(D) < 128 ? 6 : 2; }

template <int D>
Choice choose(const Params& p) {
  Choice c{kKeyTiles[n_key_tiles<D>() - 1], p.Lq <= kRows && p.H > 1 ? 2 : 1, 0};
  for (int i = 0; i < n_key_tiles<D>(); ++i)
    if (kKeyTiles[i] >= p.Lk) {
      c.kn = kKeyTiles[i];
      break;
    }
  c.order = p.bias != nullptr && p.b_s[2] != 0 && p.b_s[1] == 0 ? 1 : 0;
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
      case 256: return f(std::integral_constant<int, 256>{});
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

// masked_attention_fwd in bf16 for one head dim and dropout setting
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

// The plan masked_attention_fwd makes for a bf16 launch of these dims (as
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
  Plan pl;
  const cudaError_t err = with_key_tile<D>(c.kn, [&](auto kn) {
    return make_plan(p, tile_dim(D), decltype(kn)::value, 2, c.hb, c.order, &pl);
  });
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
  err = make_plan(p, tile_dim(D), kN, 2, 1, 0, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, masked_attention_wgmma_kernel<D, kN, false>,
                                                    kThreads, pl.smem_bytes));
}

// host microseconds to encode the three maps of one launch at the rerank
// shape (B 1,000, H 12, L 125, D 64; layout 0: [B, H, L, D] strides, 1:
// [B, L, H, D]) over the device memory at `ptr`, averaged over `iters`
// launches; returns the first failing CUresult
inline int encode_us(int iters, int layout, const void* ptr, float* us) {
  if (iters <= 0 || ptr == nullptr) return CUDA_ERROR_INVALID_VALUE;
  alignas(64) CUtensorMap map;
  const int64_t bhld[3] = {12 * 125 * 64, 125 * 64, 64}, blhd[3] = {125 * 12 * 64, 64, 12 * 64};
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    for (int m = 0; m < 3; ++m) {
      const int err = encode<64, 2>(&map, ptr, 1000, 12, 125, layout ? blhd : bhld, 128, 1);
      if (err != CUDA_SUCCESS) return err;
    }
  const std::chrono::duration<float, std::micro> dt = std::chrono::steady_clock::now() - t0;
  *us = dt.count() / iters;
  return 0;
}

}  // namespace hopper
}  // namespace

