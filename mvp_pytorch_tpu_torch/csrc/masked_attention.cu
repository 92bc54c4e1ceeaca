// masked_attention_fwd: masked multi-head attention forward for Hopper (sm_90a).
// The kernels, their design and the TPU kernels they replace are in
// masked_attention.cuh, masked_attention_wgmma.cuh (bf16) and
// masked_attention_tf32.cuh (fp32). This unit holds the C entry points,
// which pick the unit by dtype, head dim and whether the launch has a
// dropout seed.
#include "masked_attention_tf32.cuh"
#include "masked_attention_wgmma.cuh"

// Plain C entry point, loaded with ctypes.
//   dims: B, H, Lq, Lk, D, dtype (0 fp32, 1 bf16), bias dtype (0 fp32, 1 bf16;
//         read only when bias is not null), then the (b, h, l) strides, in
//         elements, of q, k, v, out and bias.
//   seed: null (no dropout), or one int64 on the device: attention-prob
//         dropout, dropping an element whose hash is below drop_threshold
//         (round(p 2^32)) and scaling the kept ones by drop_scale (1 / (1 - p)).
//         D 72 has no dropout instantiation: a seed there is refused.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int masked_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* bias, void* out,
                                    const void* dims_ptr, void* stream_ptr,
                                    const void* seed, uint32_t drop_threshold,
                                    float drop_scale) {
  const int64_t* dims = static_cast<const int64_t*>(dims_ptr);
  const int dtype = static_cast<int>(dims[5]);
  const bool drop = seed != nullptr;
  int (*fn)(MASKED_ATTENTION_FWD_ARGS) = nullptr;
  if (dtype == 1) {
    switch (dims[4]) {
      case 32: fn = drop ? masked_attention_fwd_bf16_d32_drop : masked_attention_fwd_bf16_d32; break;
      case 64: fn = drop ? masked_attention_fwd_bf16_d64_drop : masked_attention_fwd_bf16_d64; break;
      case 128:
        fn = drop ? masked_attention_fwd_bf16_d128_drop : masked_attention_fwd_bf16_d128;
        break;
      case 72:  // no dropout instantiation: a seed is refused
        if (!drop) fn = masked_attention_fwd_bf16_d72;
        break;
      default: break;
    }
  } else if (dtype == 0) {
    switch (dims[4]) {
      case 32: fn = drop ? masked_attention_fwd_fp32_d32_drop : masked_attention_fwd_fp32_d32; break;
      case 64: fn = drop ? masked_attention_fwd_fp32_d64_drop : masked_attention_fwd_fp32_d64; break;
      case 128:
        fn = drop ? masked_attention_fwd_fp32_d128_drop : masked_attention_fwd_fp32_d128;
        break;
      case 72:  // no dropout instantiation: a seed is refused
        if (!drop) fn = masked_attention_fwd_fp32_d72;
        break;
      default: break;
    }
  }
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, bias, out, dims_ptr, stream_ptr, seed, drop_threshold, drop_scale);
}

// Resident blocks per SM of the kernel that masked_attention_fwd launches for
// (dtype, D), written to *blocks. Returns a CUDA error code.
extern "C" int masked_attention_blocks_per_sm(int dtype, int d, int* blocks) {
  if (dtype == 1) {
    switch (d) {
      case 32: return masked_attention_blocks_per_sm_bf16_d32(blocks);
      case 64: return masked_attention_blocks_per_sm_bf16_d64(blocks);
      case 128: return masked_attention_blocks_per_sm_bf16_d128(blocks);
      case 72: return masked_attention_blocks_per_sm_bf16_d72(blocks);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 0) {
    switch (d) {
      case 32: return masked_attention_blocks_per_sm_fp32_d32(blocks);
      case 64: return masked_attention_blocks_per_sm_fp32_d64(blocks);
      case 128: return masked_attention_blocks_per_sm_fp32_d128(blocks);
      case 72: return masked_attention_blocks_per_sm_fp32_d72(blocks);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan of the launch that masked_attention_fwd makes for these dims
// (dims[5]: 1 bf16, 0 fp32; the bias pointer stands as has_bias):
// out[0..6] = key-tile width, heads of a tile, tile order (0: query tiles
// innermost, 1: head tiles innermost), tiles, k/v stages, shared-memory
// bytes a block and the head dim's tile width (D, or 128 at D 72). Host
// only: launches nothing. Returns a CUDA error code.
extern "C" int masked_attention_plan(const void* dims_ptr, int has_bias, int64_t* out) {
  const int64_t* dims = static_cast<const int64_t*>(dims_ptr);
  if (dims[5] == 0) {
    switch (dims[4]) {
      case 32: return hopper::f32::plan<32>(dims, has_bias, out);
      case 64: return hopper::f32::plan<64>(dims, has_bias, out);
      case 128: return hopper::f32::plan<128>(dims, has_bias, out);
      case 72: return hopper::f32::plan<72>(dims, has_bias, out);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (dims[4]) {
    case 32: return hopper::plan<32>(dims, has_bias, out);
    case 64: return hopper::plan<64>(dims, has_bias, out);
    case 128: return hopper::plan<128>(dims, has_bias, out);
    case 72: return hopper::plan<72>(dims, has_bias, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Host microseconds that the bf16 launch spends encoding its four TMA tensor
// maps (layout 0: [B, H, L, D], 1: [B, L, H, D]) over `ptr`, a device
// buffer of the rerank shape's q, averaged over `iters` launches, written to
// *us. Returns the driver's CUresult (0 on success).
extern "C" int masked_attention_tma_encode_us(int iters, int layout, const void* ptr,
                                              float* us) {
  return hopper::encode_us(iters, layout, ptr, us);
}
