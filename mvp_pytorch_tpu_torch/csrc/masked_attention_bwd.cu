// masked_attention_bwd: the backward of masked_attention_fwd for Hopper
// (sm_90a). The kernel, its design and its bound are in
// masked_attention_bwd.cuh. This unit holds the C entry points, which pick
// the unit by dtype, head dim and whether the launch has a dropout seed.
#include "masked_attention_bwd.cuh"

// Plain C entry point, loaded with ctypes.
//   q, k, v, g (the output's gradient): the inputs, in one dtype;
//   bias: fp32 or null; dq, dk, dv: the gradients, in the inputs' dtype;
//   dbias: null, or an fp32 [B, H, Lq, Lk] buffer (contiguous) for ds;
//   scratch: null, or fp32 of the plan's scratch floats
//   (masked_attention_bwd_plan): dk and dv's sums when they do not fit shared
//   memory, or, past one key tile in bf16, the row statistics and dq's
//   partial sums.
//   dims: B, H, Lq, Lk, D, dtype (0 fp32, 1 bf16), bias dtype (0 fp32), then
//         the (b, h, l) strides, in elements, of q, k, v, g, dq, dk, dv and
//         bias.
//   seed: null (no dropout), or one int64 on the device: the forward's
//         dropout mask, regenerated (a hash below drop_threshold drops its
//         element; the kept ones scale by drop_scale). D 72 has no dropout
//         instantiation: a seed there is refused.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int masked_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                    const void* bias, void* dq, void* dk, void* dv, void* dbias,
                                    void* scratch, const void* dims_ptr, void* stream_ptr,
                                    const void* seed, uint32_t drop_threshold, float drop_scale) {
  const int64_t* dims = static_cast<const int64_t*>(dims_ptr);
  const bool drop = seed != nullptr;
  int (*fn)(MASKED_ATTENTION_BWD_ARGS) = nullptr;
  if (dims[5] == 1) {
    switch (dims[4]) {
      case 32: fn = drop ? masked_attention_bwd_bf16_d32_drop : masked_attention_bwd_bf16_d32; break;
      case 64: fn = drop ? masked_attention_bwd_bf16_d64_drop : masked_attention_bwd_bf16_d64; break;
      case 128:
        fn = drop ? masked_attention_bwd_bf16_d128_drop : masked_attention_bwd_bf16_d128;
        break;
      case 72:  // no dropout instantiation: a seed is refused
        if (!drop) fn = masked_attention_bwd_bf16_d72;
        break;
      default: break;
    }
  } else if (dims[5] == 0) {
    switch (dims[4]) {
      case 32: fn = drop ? masked_attention_bwd_fp32_d32_drop : masked_attention_bwd_fp32_d32; break;
      case 64: fn = drop ? masked_attention_bwd_fp32_d64_drop : masked_attention_bwd_fp32_d64; break;
      case 128:
        fn = drop ? masked_attention_bwd_fp32_d128_drop : masked_attention_bwd_fp32_d128;
        break;
      case 72:  // no dropout instantiation: a seed is refused
        if (!drop) fn = masked_attention_bwd_fp32_d72;
        break;
      default: break;
    }
  }
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, g, bias, dq, dk, dv, dbias, scratch, dims_ptr, stream_ptr, seed,
            drop_threshold, drop_scale);
}

// The plan of the launch masked_attention_bwd makes for these dims (as it
// takes them): out[0..9] = key tile, key tiles, 1 past one key tile, 1 when
// dk and dv's sums sit in shared memory, shared-memory bytes a block, the
// scratch floats the caller allocates (0 when none is needed), the head
// dim's tile width (D, or 128 at D 72), 1 when the key tiles are the outer
// loop (bf16 past one key tile), then that path's statistics floats (the
// scratch's first part) and dq's partial slices. Host only: launches
// nothing. Returns a CUDA error code.
extern "C" int masked_attention_bwd_plan(const void* dims_ptr, int64_t* out) {
  const int64_t* dims = static_cast<const int64_t*>(dims_ptr);
  if (dims[5] == 0) {
    switch (dims[4]) {
      case 32: return hopper::bwd::plan<32, true>(dims, out);
      case 64: return hopper::bwd::plan<64, true>(dims, out);
      case 128: return hopper::bwd::plan<128, true>(dims, out);
      case 72: return hopper::bwd::plan<72, true>(dims, out);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dims[5] != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dims[4]) {
    case 32: return hopper::bwd::plan<32, false>(dims, out);
    case 64: return hopper::bwd::plan<64, false>(dims, out);
    case 128: return hopper::bwd::plan<128, false>(dims, out);
    case 72: return hopper::bwd::plan<72, false>(dims, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
