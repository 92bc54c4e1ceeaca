// The fp32 kernels of masked_attention_bwd at D 72 (SigLIP's heads), without
// dropout, in the D 128 tile (`hopper::tile_dim`; masked_attention_bwd.cuh;
// the entry points are in masked_attention_bwd.cu).
#include "masked_attention_bwd.cuh"

int masked_attention_bwd_fp32_d72(MASKED_ATTENTION_BWD_ARGS) {
  return hopper::bwd::run<float, 72, false>(q, k, v, g, bias, dq, dk, dv, dbias, scratch,
                                            dims_ptr, stream_ptr, seed, drop_threshold,
                                            drop_scale);
}
