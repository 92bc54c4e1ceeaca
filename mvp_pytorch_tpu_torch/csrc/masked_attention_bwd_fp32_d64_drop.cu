// The fp32 kernels of masked_attention_bwd at D 64, with attention-prob dropout
// (masked_attention_bwd.cuh; the entry points are in masked_attention_bwd.cu).
#include "masked_attention_bwd.cuh"

int masked_attention_bwd_fp32_d64_drop(MASKED_ATTENTION_BWD_ARGS) {
  return hopper::bwd::run<float, 64, true>(q, k, v, g, bias, dq, dk, dv, dbias, scratch,
                                            dims_ptr, stream_ptr, seed, drop_threshold, drop_scale);
}
