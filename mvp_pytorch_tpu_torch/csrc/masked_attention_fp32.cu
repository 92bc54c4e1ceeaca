// The fp32 (3xTF32) kernels without dropout of masked_attention_fwd
// (masked_attention.cuh, masked_attention.cu).
#include "masked_attention.cuh"

int masked_attention_fwd_fp32(MASKED_ATTENTION_FWD_ARGS) {
  return fwd<false, false>(q, k, v, bias, out, dims_ptr, stream_ptr, seed,
                           drop_threshold, drop_scale);
}

int masked_attention_blocks_per_sm_fp32(int bias_dtype, int d, int* blocks) {
  return occupancy<false>(bias_dtype, d, blocks);
}
