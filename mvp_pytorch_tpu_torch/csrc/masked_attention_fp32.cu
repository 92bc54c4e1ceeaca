// The fp32 (3xTF32) kernels without dropout of masked_attention_fwd
// (masked_attention.cuh, masked_attention.cu).
#include "masked_attention.cuh"

int masked_attention_fwd_fp32(MASKED_ATTENTION_FWD_ARGS) {
  return fwd_fp32<false>(q, k, v, bias, out, dims_ptr, stream_ptr, seed, drop_threshold,
                         drop_scale);
}

int masked_attention_blocks_per_sm_fp32(int bias_dtype, int d, int* blocks) {
  return static_cast<int>(dispatch_fp32(OccupancyFp32{blocks}, bias_dtype, d));
}
