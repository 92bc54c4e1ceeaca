// masked_attention_fwd: masked multi-head attention forward for Hopper (sm_90a).
// The kernels, their design and the TPU kernels they replace are in
// masked_attention.cuh. This unit instantiates the bf16 kernels without
// dropout and holds the C entry points, which pick the unit by dtype and by
// whether the launch has a dropout seed.
#include "masked_attention.cuh"

int masked_attention_fwd_bf16(MASKED_ATTENTION_FWD_ARGS) {
  return fwd<true, false>(q, k, v, bias, out, dims_ptr, stream_ptr, seed,
                           drop_threshold, drop_scale);
}

int masked_attention_blocks_per_sm_bf16(int bias_dtype, int d, int* blocks) {
  return occupancy<true>(bias_dtype, d, blocks);
}

// Plain C entry point, loaded with ctypes.
//   dims: B, H, Lq, Lk, D, dtype (0 fp32, 1 bf16), bias dtype (0 fp32, 1 bf16;
//         read only when bias is not null), then the (b, h, l) strides, in
//         elements, of q, k, v, out and bias.
//   seed: null (no dropout), or one int64 on the device: attention-prob
//         dropout, dropping an element whose hash is below drop_threshold
//         (round(p 2^32)) and scaling the kept ones by drop_scale (1 / (1 - p)).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int masked_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* bias, void* out,
                                    const void* dims_ptr, void* stream_ptr,
                                    const void* seed, uint32_t drop_threshold,
                                    float drop_scale) {
  const int dtype = static_cast<int>(static_cast<const int64_t*>(dims_ptr)[5]);
  if (dtype == 1)
    return (seed != nullptr ? masked_attention_fwd_bf16_drop : masked_attention_fwd_bf16)(
        q, k, v, bias, out, dims_ptr, stream_ptr, seed, drop_threshold, drop_scale);
  if (dtype == 0)
    return (seed != nullptr ? masked_attention_fwd_fp32_drop : masked_attention_fwd_fp32)(
        q, k, v, bias, out, dims_ptr, stream_ptr, seed, drop_threshold, drop_scale);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks per SM of the kernel that masked_attention_fwd launches for
// (dtype, bias dtype, D), written to *blocks. Returns a CUDA error code.
extern "C" int masked_attention_blocks_per_sm(int dtype, int bias_dtype, int d,
                                              int* blocks) {
  if (dtype == 1) return masked_attention_blocks_per_sm_bf16(bias_dtype, d, blocks);
  if (dtype == 0) return masked_attention_blocks_per_sm_fp32(bias_dtype, d, blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}
