// The bf16 kernels with attention-prob dropout of masked_attention_fwd
// (masked_attention.cuh, masked_attention.cu).
#include "masked_attention.cuh"

int masked_attention_fwd_bf16_drop(MASKED_ATTENTION_FWD_ARGS) {
  return fwd<true, true>(q, k, v, bias, out, dims_ptr, stream_ptr, seed,
                           drop_threshold, drop_scale);
}
