// The fp32 kernels of masked_attention_fwd at D 128, with attention-prob dropout
// (masked_attention_tf32.cuh; the entry points are in masked_attention.cu).
#include "masked_attention_tf32.cuh"

int masked_attention_fwd_fp32_d128_drop(MASKED_ATTENTION_FWD_ARGS) {
  return hopper::f32::fwd<128, true>(q, k, v, bias, out, dims_ptr, stream_ptr, seed,
                                     drop_threshold, drop_scale);
}
