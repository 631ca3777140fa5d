// One HSTU block forward for serving (K1), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel `fused_hstu_block` in
// rails_tpu/ops/pallas/hstu_block.py (body `_kernel`), internal-bias mode.
// The three kernels, their design and what bounds them are in hstu_block.cuh;
// this file is K1's entry point, which runs them without dropout.
#include "hstu_block.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, uvqk, o_kernel and out share it).
// y (B*n, F) and attn (B*n, H*dv) are f32 scratch the caller allocates.
extern "C" int rails_hstu_block_fwd(int dtype, const void* x, const float* colmask,
                                    const void* uvqk, const void* o_kernel, const float* o_bias,
                                    const float* rel_pos, const int* ext, const float* tsw,
                                    float* y, float* attn, void* out, int B, int n, int D,
                                    int H, int dqk, int dv, float inv_n, float eps,
                                    int max_bucket, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return rails::launch<__nv_bfloat16>(x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw,
                                        y, attn, out, B, n, D, H, dqk, dv, inv_n, eps,
                                        max_bucket, rails::Dropout{}, s);
  }
  if (dtype == 0) {
    return rails::launch<float>(x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, y, attn,
                                out, B, n, D, H, dqk, dv, inv_n, eps, max_bucket,
                                rails::Dropout{}, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" size_t rails_hstu_attn_smem_bytes(int n, int dqk, int dv) {
  return rails::attn_smem_bytes(n, dqk, dv);
}

extern "C" const char* rails_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
