// The pieces that the two Hopper kernels of masked_attention_fwd share: the
// bf16 kernel (masked_attention_wgmma.cuh) and the fp32 one
// (masked_attention_tf32.cuh), whose notes give their bounds and designs.
// Both run one persistent block an SM of two consumer warpgroups and one
// producer warpgroup, which copies q, k and v by TMA (4-D maps over
// (D, L, H, B) with the tensors' own strides, 128-byte swizzled rows) into
// a ring of stages under mbarriers, and stages the bias once for every tile
// that shares it (`stage_bias`). The host plans a launch (`make_plan`):
// tiles, the key tile, and the shared-memory layout.

#pragma once

#include <cuda.h>

#include <chrono>
#include <type_traits>

#include "masked_attention.cuh"

namespace {
namespace hopper {

constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;  // and the producer warpgroup
constexpr int kRows = 64;                         // query rows of a warpgroup
constexpr int kMaxStages = 4;                     // k/v ring
constexpr int kMaxBiasSlots = 2;
constexpr int kMaxQSlots = 2;
constexpr int kLoaders = 96;                      // producer threads that stage the bias
constexpr int kSmemLimit = 232448;                // 227 KB a block
constexpr int kBiasPad = 8;  // floats a bias row: a warp's reads of 8 rows take two wavefronts
// empty barriers: every consumer warp arrives (2 warpgroups x 4)
constexpr int kConsumerWarps = kConsumers * 4;

// The width a head of D dims takes in shared memory and in the products: D
// itself, or 128 at D 72 (SigLIP's 1,152 / 16). A 72-dim row is 144 bytes,
// which no swizzle span divides; its tile is the D 128 tile, whose columns
// 72-127 TMA fills with zeros on load (past the map's extent of 72) and
// whose stores skip them, so no padded copy of q, k, v, the output or a
// gradient exists in device memory. The zero columns add nothing to q.k^T
// or g.v^T; the products that write them (P.v, ds.k, ds^T.q, p^T.g) waste
// 56 of 128 columns.
__host__ __device__ constexpr int tile_dim(int D) { return D == 72 ? 128 : D; }

// Head-dim chunking of a tile of kElem-byte elements in shared memory: rows
// of kCC elements (128 bytes, 64 for bf16 at D 32), the swizzle span; wider
// heads are chunks side by side (bf16 D 128: two; fp32 D 64: two, D 128:
// four; D 72 as D 128).
template <int D, int kElem>
struct Chunk {
  static constexpr int kD = tile_dim(D);
  static constexpr int kCC = kD * kElem < 128 ? kD : 128 / kElem;
  static constexpr int kRowBytes = kCC * kElem;
  static constexpr int kChunks = kD / kCC;
  static constexpr int kKSteps = kRowBytes / 32;  // 32-byte k-steps (bf16 k16, tf32 k8)
};

// What the host decided for a launch (`choose` below, and the
// shared-memory budget).
struct Plan {
  int hb, qb;          // heads and 64-row query blocks a tile: (2, 1) or (1, 2)
  int order;           // 0: query tiles innermost; 1: head tiles innermost
  int n_qt, n_ht;      // tiles along the queries and the heads
  int n_kt;            // key tiles of kN keys
  int q_slots;         // q buffers (2: the next tile's q loads during this one)
  int stages;          // k/v stages in the ring
  int bias_slots;      // staged bias tiles (1 or 2)
  int bias_rows;       // 64 (per-query bias) or 1 (broadcast over queries)
  int bias_blocks;     // 2: each warpgroup has its own rows; 1: one shared
  int bias_flat;       // 1: a block is a contiguous copy of its rows (pitch Lk)
  int bias_pitch;      // floats from a bias row to the next in a slot
  int bias_blk_floats; // floats from a block to the next in a slot
  int key_b, key_q, key_h;  // what the bias of a tile depends on
  uint32_t off_q, off_bias, off_kv, off_bar;  // bytes from the aligned base
  uint32_t q_slot_bytes, bias_slot_bytes, kv_stage_bytes, smem_bytes;
  int n_tiles;         // tiles of the launch (< 2^31)
};

// barriers, 8 bytes each, from off_bar
enum Bar {
  kQFull = 0, kQEmpty = kQFull + kMaxQSlots, kKFull = kQEmpty + kMaxQSlots,
  kVFull = kKFull + kMaxStages,
  kKvEmpty = kVFull + kMaxStages, kBiasFull = kKvEmpty + kMaxStages,
  kBiasEmpty = kBiasFull + kMaxBiasSlots, kBars = kBiasEmpty + kMaxBiasSlots,
  // the fp32 kernel's, after the bf16 kernel's: v's copy read (by the
  // split warps), k split, S done (k's buffer free for v^T), v^T written
  kVEmpty = kBars, kKReady = kVEmpty + kMaxStages, kSDone = kKReady + kMaxStages,
  kVtReady = kSDone + kMaxStages, kBarsTf32 = kVtReady + kMaxStages
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// a consumer warp releases a buffer: its lanes are done with it
__device__ __forceinline__ void warp_release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) bar_arrive(bar);
}

// --- TMA -------------------------------------------------------------------

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}
// orders this thread's shared-memory stores before later async-proxy (TMA)
// writes to the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- wgmma -----------------------------------------------------------------

// shared-memory matrix descriptor: start, leading and stride byte offsets,
// swizzle (128-byte rows: layout 1; 64-byte rows: layout 2)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         int row_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16
         | static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32
         | static_cast<uint64_t>(row_bytes == 128 ? 1 : 2) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N of the warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// pins accumulator registers at this point of the program: no read of them
// moves above a wgmma wait, no write below a wgmma issue
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// --- tiles, the producer, the bias ------------------------------------------

// A tile's place: batch row, first head, first query; and the bias tile it
// needs (consecutive tiles with the same key share one staged copy).
struct TileIdx {
  int b, h0, q0;
  int64_t key;
};

// Walks a block's tiles in launch order without dividing: the division
// chains of a decode cost more than a tile's bookkeeping should.
struct TileWalk {
  int qt, ht, b;
  __device__ __forceinline__ TileWalk(const Plan& pl, int i) {
    const int inner = pl.order == 0 ? pl.n_qt : pl.n_ht;
    const int outer = pl.order == 0 ? pl.n_ht : pl.n_qt;
    const int a = i % inner, c = i / inner;
    (pl.order == 0 ? qt : ht) = a;
    (pl.order == 0 ? ht : qt) = c % outer;
    b = c / outer;
  }
  __device__ __forceinline__ void next(const Plan& pl) {
    int& inner = pl.order == 0 ? qt : ht;
    int& outer = pl.order == 0 ? ht : qt;
    if (++inner == (pl.order == 0 ? pl.n_qt : pl.n_ht)) {
      inner = 0;
      if (++outer == (pl.order == 0 ? pl.n_ht : pl.n_qt)) {
        outer = 0;
        ++b;
      }
    }
  }
  __device__ __forceinline__ TileIdx tile(const Plan& pl) const {
    TileIdx t;
    t.b = b;
    t.h0 = ht * pl.hb;
    t.q0 = qt * kRows * pl.qb;
    t.key = (static_cast<int64_t>(pl.key_b ? b : 0) * pl.n_qt + (pl.key_q ? qt : 0)) * pl.n_ht
            + (pl.key_h ? ht : 0);
    return t;
  }
};

// One thread of the producer: q of each tile into its buffer, then k and v
// of each key tile into the ring, for kElem-byte elements. With kVRelease
// (fp32) a stage's v is released (once transposed) before its k (once P.v
// is done), so v is loaded first.
template <int D, int kN, int kElem, bool kVRelease>
__device__ __forceinline__ void produce(const Plan& pl, uint32_t base, const CUtensorMap* tq,
                                        const CUtensorMap* tk, const CUtensorMap* tv,
                                        int start, int end) {
  using C = Chunk<D, kElem>;
  const uint32_t bars = base + pl.off_bar;
  const uint32_t q_chunk = 2 * kRows * C::kRowBytes;
  const uint32_t kv_chunk = pl.hb * kN * C::kRowBytes;
  const uint32_t kv_bytes = pl.hb * kN * C::kD * kElem;  // k (or v) of a stage
  int slot = 0;
  uint32_t phase = 0;
  TileWalk walk(pl, start);
  for (int i = start; i < end; ++i, walk.next(pl)) {
    const TileIdx t = walk.tile(pl);
    const int n = i - start, qs = n & (pl.q_slots - 1);
    bar_wait(bars + 8 * (kQEmpty + qs), ((n >> (pl.q_slots - 1)) & 1) ^ 1);
    bar_expect_tx(bars + 8 * (kQFull + qs), pl.q_slot_bytes);
    const uint32_t qb = base + pl.off_q + qs * pl.q_slot_bytes;
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      tma_load(qb + c * q_chunk, tq, bars + 8 * (kQFull + qs), c * C::kCC, t.q0, t.h0, t.b);
    for (int kt = 0; kt < pl.n_kt; ++kt) {
      if constexpr (kVRelease) bar_wait(bars + 8 * (kVEmpty + slot), phase ^ 1);
      else bar_wait(bars + 8 * (kKvEmpty + slot), phase ^ 1);
      const uint32_t st = base + pl.off_kv + slot * pl.kv_stage_bytes;
      if constexpr (kVRelease) {
        bar_expect_tx(bars + 8 * (kVFull + slot), kv_bytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          tma_load(st + kv_bytes + c * kv_chunk, tv, bars + 8 * (kVFull + slot), c * C::kCC,
                   kt * kN, t.h0, t.b);
        bar_wait(bars + 8 * (kKvEmpty + slot), phase ^ 1);
      }
      bar_expect_tx(bars + 8 * (kKFull + slot), kv_bytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
        tma_load(st + c * kv_chunk, tk, bars + 8 * (kKFull + slot), c * C::kCC, kt * kN, t.h0,
                 t.b);
      if constexpr (!kVRelease) {
        bar_expect_tx(bars + 8 * (kVFull + slot), kv_bytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          tma_load(st + kv_bytes + c * kv_chunk, tv, bars + 8 * (kVFull + slot), c * C::kCC,
                   kt * kN, t.h0, t.b);
      }
      if (++slot == pl.stages) {
        slot = 0;
        phase ^= 1;
      }
    }
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The bias slots' fixed part, once: 0, and in the row-by-row layout -inf
// at keys past Lk of the only key tile (a copy overwrites the rest; rows
// past Lq and heads past H keep it), four floats a store.
template <int kN>
__device__ __forceinline__ void init_bias(const Params& p, const Plan& pl, float* slots,
                                          int tid) {
  constexpr int kPitch = kN + kBiasPad, kQuads = kPitch / 4;
  const bool rowwise = !pl.bias_flat;
  const int n = rowwise ? pl.bias_blocks * pl.bias_rows * kQuads : pl.bias_slot_bytes / 16;
  // past 256 keys every key of a tile is written by its copy
  const float lk = pl.n_kt == 1 && rowwise ? static_cast<float>(p.Lk) : 1e30f;
  for (int slot = 0; slot < pl.bias_slots; ++slot) {
    float* rows = slots + slot * (pl.bias_slot_bytes / 4);
    for (int e = tid; e < n; e += kLoaders) {
      const int r = e / kQuads, c = 4 * (e - r * kQuads);
      *reinterpret_cast<float4*>(rows + (rowwise ? r * kPitch + c : 4 * e)) =
          make_float4(c >= lk ? -INFINITY : 0.f, c + 1 >= lk ? -INFINITY : 0.f,
                      c + 2 >= lk ? -INFINITY : 0.f, c + 3 >= lk ? -INFINITY : 0.f);
    }
  }
}

// Rows of a tile's bias block `blk` (each warpgroup's 64 queries, or the one
// row of a bias broadcast over queries; 0 past Lq or H), and its first
// element.
__device__ __forceinline__ int block_rows(const Params& p, const Plan& pl, const TileIdx& t,
                                          int blk) {
  const int head = t.h0 + (pl.hb == 2 ? blk : 0);
  const int q_first = t.q0 + (pl.qb == 2 ? blk * kRows : 0);
  return head >= p.H ? 0 : pl.bias_rows == 1 ? 1 : max(0, min(kRows, p.Lq - q_first));
}
__device__ __forceinline__ const float* block_first(const Params& p, const Plan& pl,
                                                    const TileIdx& t, int blk) {
  const int head = t.h0 + (pl.hb == 2 ? blk : 0);
  const int q_first = t.q0 + (pl.qb == 2 ? blk * kRows : 0);
  return static_cast<const float*>(p.bias) + t.b * p.b_s[0] + head * p.b_s[1]
         + q_first * p.b_s[2];
}

// the float shift of a contiguous block's copy: its first element's
// position in a 16-byte granule
__device__ __forceinline__ int flat_shift(const float* first) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(first) >> 2 & 3);
}

// The fp32 bias of key tile kt of tile t into a slot. A contiguous block
// (bias_flat) is one bulk copy by the TMA unit, completing on the slot's
// barrier, with the up to 3 floats before its first and after its last
// 16-byte granule stored by a thread; nothing outside the block is read.
// Otherwise each row comes by 4-byte cp.async copies (the rows are then
// seldom 16-byte aligned, which TMA needs); past 256 keys a slot serves key
// tiles of both kinds, so every key is written: the bias, else 0, and -inf
// past Lk. `tid` is one of kLoaders threads; it waits for its own copies
// and then arrives on `full` (with the bulk bytes when it issued them).
template <int kN>
__device__ __forceinline__ void fill_bias(const Params& p, const Plan& pl, float* dst,
                                          uint32_t full, const TileIdx& t, int kt, int tid) {
  const float* bias = static_cast<const float*>(p.bias);
  if (pl.bias_flat) {
    if (tid == 0) {
      uint32_t tx = 0;
      const float* src[2];
      uint32_t dsts[2], bytes[2];
      for (int blk = 0; blk < pl.bias_blocks; ++blk) {
        src[blk] = block_first(p, pl, t, blk);
        const int n = block_rows(p, pl, t, blk) * p.Lk, shift = flat_shift(src[blk]);
        const int lead = min(n, (4 - shift) & 3);
        const int body = (n - lead) / 4 * 4;
        float* out = dst + blk * pl.bias_blk_floats + shift;
        for (int j = 0; j < lead; ++j) out[j] = __ldg(src[blk] + j);
        for (int j = lead + body; j < n; ++j) out[j] = __ldg(src[blk] + j);
        src[blk] += lead;
        dsts[blk] = smem_u32(out + lead);
        bytes[blk] = body * 4;
        tx += bytes[blk];
      }
      bar_expect_tx(full, tx);
      for (int blk = 0; blk < pl.bias_blocks; ++blk)
        if (bytes[blk] > 0) bulk_load(dsts[blk], src[blk], bytes[blk], full);
    } else {
      bar_arrive(full);
    }
    return;
  }
  constexpr int kPitch = kN + kBiasPad;
  if (bias != nullptr || pl.n_kt > 1 || pl.bias_rows == 1) {
    const int k0 = kt * kN, cols = min(kN, p.Lk - k0);
    // a row bias writes its keys past Lk too (it has no init); so does every
    // key tile past 256 keys
    const int width = pl.n_kt == 1 && pl.bias_rows > 1 ? cols : kN;
    for (int blk = 0; blk < pl.bias_blocks; ++blk) {
      const int rows = block_rows(p, pl, t, blk);
      const float* src = bias == nullptr ? nullptr : block_first(p, pl, t, blk) + k0;
      float* out = dst + blk * pl.bias_blk_floats;
      for (int r = 0; r < rows; ++r)
        for (int c = tid; c < width; c += kLoaders) {
          if (c < cols && src != nullptr)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                         :: "r"(smem_u32(out + r * kPitch + c)), "l"(src + r * p.b_s[2] + c)
                         : "memory");
          else
            out[r * kPitch + c] = c < cols ? 0.f : -INFINITY;
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  bar_arrive(full);
}

// Three warps of the producer: one staged bias tile per group of tiles that
// share it (per key tile past one key tile), bias_slots deep; after each
// key tile's bias, `per_key_tile()` (the fp32 kernel's split of k and v).
template <int kN, typename F>
__device__ __forceinline__ void stage_bias(const Params& p, const Plan& pl, uint8_t* smem,
                                           uint32_t base, int tid, int start, int end,
                                           F&& per_key_tile) {
  const uint32_t bars = base + pl.off_bar;
  if (pl.bias_rows > 1) {  // a per-query bias: rows past Lq stay 0
    init_bias<kN>(p, pl, reinterpret_cast<float*>(smem + pl.off_bias), tid);
    fence_proxy_async();  // the init's stores before bulk copies overwrite them
    asm volatile("bar.sync 1, %0;\n" :: "n"(kLoaders) : "memory");  // the loaders' own
  }
  int slot = 0;
  uint32_t phase = 0;
  int64_t prev = -1;
  TileWalk walk(pl, start);
  for (int i = start; i < end; ++i, walk.next(pl)) {
    const TileIdx t = walk.tile(pl);
    for (int kt = 0; kt < pl.n_kt; ++kt) {
      if (pl.n_kt == 1 && i != start && t.key == prev) {
        per_key_tile();
        continue;
      }
      bar_wait(bars + 8 * (kBiasEmpty + slot), phase ^ 1);
      fill_bias<kN>(p, pl, reinterpret_cast<float*>(smem + pl.off_bias + slot * pl.bias_slot_bytes),
                    bars + 8 * (kBiasFull + slot), t, kt, tid);
      if (++slot == pl.bias_slots) {
        slot = 0;
        phase ^= 1;
      }
      per_key_tile();
    }
    prev = t.key;
  }
}
// --- host ------------------------------------------------------------------

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found)
            != cudaSuccess
        || found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// Binds the current device's primary context to the calling host thread
// when none is bound. cuTensorMapEncodeTiled is a driver call and acts on
// the thread's current context, and a thread may have none: the runtimes
// bind one lazily, at the thread's first call that needs it, and a thread
// that has only taken PyTorch's cached memory has made none. The runtime's
// cudaFree(nullptr) binds it, as PyTorch does before its own driver calls.
inline CUresult bind_context() {
  using CtxGetCurrent = CUresult (*)(CUcontext*);
  static const CtxGetCurrent fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuCtxGetCurrent", &ptr, cudaEnableDefault, &found)
            != cudaSuccess
        || found != cudaDriverEntryPointSuccess)
      return static_cast<CtxGetCurrent>(nullptr);
    return reinterpret_cast<CtxGetCurrent>(ptr);
  }();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  CUcontext ctx = nullptr;
  const CUresult got = fn(&ctx);
  if (got != CUDA_SUCCESS || ctx != nullptr) return got;
  return cudaFree(nullptr) == cudaSuccess ? CUDA_SUCCESS : CUDA_ERROR_INVALID_CONTEXT;
}

// a [B, H, L, D] tensor of kElem-byte elements (2: bf16, 4: fp32) with
// element strides s (b, h, l) as a 4-D map over (D, L, H, B), in boxes of
// (kCC, rows, heads, 1); a dim of extent 1 gets a stride that TMA accepts
// (it is never stepped). At D 72 the boxes span the 128-wide tile: columns
// past 72 lie outside the map and load as zeros. Returns the driver's CUresult
// (CUDA_ERROR_NOT_FOUND without the entry point).
template <int D, int kElem>
int encode(CUtensorMap* map, const void* ptr, int B, int H, int L, const int64_t* s, int rows,
           int heads) {
  using C = Chunk<D, kElem>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const CUresult bound = bind_context();
  if (bound != CUDA_SUCCESS) return bound;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const int64_t ext[3] = {L, H, B}, elem[3] = {s[2], s[1], s[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    if (ext[i] > 1 && elem[i] <= 0) return CUDA_ERROR_INVALID_VALUE;
    strides[i] = static_cast<cuuint64_t>(ext[i] > 1 ? elem[i] * kElem : D * kElem);
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(C::kCC), static_cast<cuuint32_t>(rows),
                             static_cast<cuuint32_t>(heads), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, kElem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            4, const_cast<void*>(ptr), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            C::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

inline uint32_t round_up(uint32_t x, uint32_t to) { return (x + to - 1) / to * to; }

// The launch's plan for head dim D, key tile kN and elem-byte elements
// (2: bf16; 4: fp32, whose stages add a third buffer, for the lo halves of
// k and v^T): tiles, key tiles, the bias staging and the shared-memory
// layout, the first of `layouts` (q buffers, bias slots, at least so many
// k/v stages) that fits, with as many k/v stages as fit, up to 4.
inline cudaError_t make_plan(const Params& p, int D, int kN, int elem, int hb, int order,
                             Plan* pl) {
  *pl = Plan{};
  pl->hb = hb;
  pl->qb = 3 - hb;
  pl->order = order;
  pl->n_qt = (p.Lq + kRows * pl->qb - 1) / (kRows * pl->qb);
  pl->n_ht = (p.H + hb - 1) / hb;
  pl->n_kt = (p.Lk + kN - 1) / kN;
  const int64_t n_tiles = static_cast<int64_t>(p.B) * pl->n_qt * pl->n_ht;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  pl->n_tiles = static_cast<int>(n_tiles);
  const bool has = p.bias != nullptr, per_query = has && p.b_s[2] != 0;
  pl->key_b = has && p.b_s[0] != 0;
  pl->key_q = per_query;
  pl->key_h = has && p.b_s[1] != 0;
  pl->bias_rows = per_query ? kRows : 1;
  pl->bias_blocks = (per_query && pl->qb == 2) || (hb == 2 && pl->key_h) ? 2 : 1;
  pl->q_slot_bytes = 2 * kRows * D * elem;
  // a per-query bias whose rows lie contiguous (every mask a model makes)
  // comes in as one bulk copy a block, rows Lk floats apart (plus up to 3
  // floats of alignment shift); any other bias row by row at pitch kN + pad
  pl->bias_flat = per_query && pl->n_kt == 1 && p.b_s[2] == p.Lk;
  pl->bias_pitch = pl->bias_flat ? p.Lk : kN + kBiasPad;
  pl->bias_blk_floats = pl->bias_flat
      ? static_cast<int>(round_up(kRows * p.Lk + kN + kBiasPad, 4))
      : pl->bias_rows * (kN + kBiasPad);
  pl->bias_slot_bytes = round_up(pl->bias_blocks * pl->bias_blk_floats * 4, 1024);
  pl->kv_stage_bytes = (elem == 4 ? 3 : 2) * hb * kN * D * elem;
  const uint32_t bar_bytes = (elem == 4 ? kBarsTf32 : kBars) * 8;
  const uint32_t fixed = bar_bytes + 1024;  // + the base's alignment
  // bf16: two q buffers and two bias slots beside at least two k/v stages,
  // else one q buffer (the q copy is small), else one bias slot (a fill the
  // consumers wait for), else one of everything. fp32 (whose stages are six
  // times as large) tries two stages beside one q buffer and one bias slot,
  // then keeps two q buffers or bias slots beside one stage, so that the
  // next tile's q and bias land during this one.
  static const int kLayouts16[4][3] = {{2, 2, 2}, {1, 2, 2}, {2, 1, 2}, {1, 1, 1}};
  static const int kLayouts32[8][3] = {{2, 2, 2}, {1, 2, 2}, {2, 1, 2}, {1, 1, 2},
                                       {2, 2, 1}, {1, 2, 1}, {2, 1, 1}, {1, 1, 1}};
  const int(*layouts)[3] = elem == 4 ? kLayouts32 : kLayouts16;
  const int n_layouts = elem == 4 ? 8 : 4;
  int stages = 0;
  for (int i = 0; i < n_layouts; ++i) {
    const int* l = layouts[i];  // q, bias, stages
    const uint32_t used = fixed + l[0] * pl->q_slot_bytes + l[1] * pl->bias_slot_bytes;
    stages = used < kSmemLimit ? (kSmemLimit - used) / pl->kv_stage_bytes : 0;
    pl->q_slots = l[0];
    pl->bias_slots = l[1];
    if (stages >= l[2]) break;
  }
  if (stages < 1) return cudaErrorInvalidConfiguration;
  pl->stages = stages < kMaxStages ? stages : kMaxStages;
  pl->off_q = 0;
  pl->off_bias = pl->q_slots * pl->q_slot_bytes;
  pl->off_kv = pl->off_bias + pl->bias_slots * pl->bias_slot_bytes;
  pl->off_bar = pl->off_kv + pl->stages * pl->kv_stage_bytes;
  pl->smem_bytes = pl->off_bar + bar_bytes + 1024;
  return cudaSuccess;
}

// q, k, v and out start 16-byte aligned with (b, h, l) strides in multiples
// of 16 bytes (elem-byte elements), as TMA needs
inline bool aligned16(const void* ptr, const int64_t* strides, int elem) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] * elem % 16 != 0) return false;
  return true;
}

}  // namespace hopper
}  // namespace
