// The bf16 kernels of masked_attention_fwd at D 32, with attention-prob dropout
// (masked_attention_wgmma.cuh; the entry points are in masked_attention.cu).
#include "masked_attention_wgmma.cuh"

int masked_attention_fwd_bf16_d32_drop(MASKED_ATTENTION_FWD_ARGS) {
  return hopper::fwd<32, true>(q, k, v, bias, out, dims_ptr, stream_ptr, seed,
                                  drop_threshold, drop_scale);
}
