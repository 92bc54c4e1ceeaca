// The fp32 (3xTF32) kernels with attention-prob dropout of masked_attention_fwd
// (masked_attention.cuh, masked_attention.cu).
#include "masked_attention.cuh"

int masked_attention_fwd_fp32_drop(MASKED_ATTENTION_FWD_ARGS) {
  return fwd_fp32<true>(q, k, v, bias, out, dims_ptr, stream_ptr, seed, drop_threshold,
                        drop_scale);
}
