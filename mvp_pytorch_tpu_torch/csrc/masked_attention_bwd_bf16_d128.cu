// The bf16 kernels of masked_attention_bwd at D 128, without dropout
// (masked_attention_bwd.cuh; the entry points are in masked_attention_bwd.cu).
#include "masked_attention_bwd.cuh"

int masked_attention_bwd_bf16_d128(MASKED_ATTENTION_BWD_ARGS) {
  return hopper::bwd::run<__nv_bfloat16, 128, false>(q, k, v, g, bias, dq, dk, dv, dbias, scratch,
                                            dims_ptr, stream_ptr, seed, drop_threshold, drop_scale);
}
