// The bf16 kernels of masked_attention_fwd at D 72 (SigLIP's heads), without
// dropout, in the D 128 tile (`hopper::tile_dim`; masked_attention_wgmma.cuh;
// the entry points are in masked_attention.cu).
#include "masked_attention_wgmma.cuh"

int masked_attention_fwd_bf16_d72(MASKED_ATTENTION_FWD_ARGS) {
  return hopper::fwd<72, false>(q, k, v, bias, out, dims_ptr, stream_ptr, seed,
                                drop_threshold, drop_scale);
}

int masked_attention_blocks_per_sm_bf16_d72(int* blocks) {
  return hopper::blocks_per_sm<72>(blocks);
}
