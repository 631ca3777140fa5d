// Entry points of K1's f32 serving block on the tensor cores (3xTF32,
// hstu_serve_tf32.cuh): the projection, the attention (pointwise or
// softmax) and the output GEMM, one call each, so that the stages run and
// are timed alone. Each refuses (cudaErrorInvalidValue, nothing launched)
// the widths outside the route (`tc::tf32_widths_ok`: D <= 272, dqk and dv
// <= 32, h <= 3 or an even h <= 8, n <= 512), which the CUDA-core block of
// hstu_block.cu takes; ops/hstu_block.py `tf32_block` also keeps the softmax
// attention there where its scores do not fit (`attn_smem_bytes`).
#include <cstdint>

#include "hstu_serve_tf32.cuh"

// y (M, F) f32 = SiLU(LN(x) @ uvqk), F = 2*H*dv + 2*H*dqk: [u | v | q | k].
extern "C" int rails_hstu_serve_tf32_project(const float* x, const float* uvqk, float* y, int B,
                                             int n, int D, int H, int dqk, int dv, float eps,
                                             void* stream) {
  if (!rails::tc::tf32_widths_ok(D, H, dqk, dv, n)) return cudaErrorInvalidValue;
  const int F = 2 * H * dv + 2 * H * dqk;
  const rails::k1tf32::GemmArgs p{x, nullptr, uvqk, nullptr, nullptr, y,
                                  static_cast<int64_t>(B) * n, D, F, 0, 0, 0, eps};
  return rails::k1tf32::launch_proj(p, static_cast<cudaStream_t>(stream));
}

// attn (B*n, H*dv) f32 from y: pointwise (v times inv_n) or, with softmax,
// one map over the h*dqk contraction (times inv_sqrt_dqk, v unscaled).
// bias_mode: 0 internal (rel_pos (n, n), ext (B, n+1) int32, tsw (128,)),
// 1 bias (B, n, n) f32, 2 none; the unused pointers may be null. The causal x
// column mask always applies (a mask_in_bias penalty is part of the bias).
extern "C" int rails_hstu_serve_tf32_attention(const float* y, const float* colmask,
                                               const float* rel_pos, const int* ext,
                                               const float* tsw, const float* bias, float* attn,
                                               int B, int n, int H, int dqk, int dv, float inv_n,
                                               float inv_sqrt_dqk, int max_bucket, int bias_mode,
                                               int softmax, void* stream) {
  const bool tables = rel_pos != nullptr && ext != nullptr && tsw != nullptr;
  if (!rails::tc::tf32_widths_ok(1, H, dqk, dv, n) || bias_mode < rails::kBiasInternal ||
      bias_mode > rails::kBiasNone || (bias_mode == rails::kBiasTensor && bias == nullptr) ||
      (bias_mode == rails::kBiasInternal && !tables))
    return cudaErrorInvalidValue;
  const rails::k1tf32::AttnArgs p{y, colmask, rel_pos, ext, tsw, bias, attn, n, H, dqk, dv,
                                  2 * H * dv + 2 * H * dqk, bias_mode, max_bucket, inv_n,
                                  inv_sqrt_dqk};
  return rails::k1tf32::launch_attention(p, B, softmax, static_cast<cudaStream_t>(stream));
}

// out (B*n, D) = o_input @ o_kernel + o_bias + x, o_input = u * LN(attn) or,
// with concat_ua, [u, LN(attn), u * LN(attn)] (o_kernel (3*H*dv, D)), u the
// first H*dv columns of y.
extern "C" int rails_hstu_serve_tf32_out(const float* attn, const float* y, const float* o_kernel,
                                         const float* o_bias, const float* x, float* out, int B,
                                         int n, int D, int H, int dqk, int dv, float eps,
                                         int concat_ua, void* stream) {
  if (!rails::tc::tf32_widths_ok(D, H, dqk, dv, n)) return cudaErrorInvalidValue;
  const int hdv = H * dv;
  const rails::k1tf32::GemmArgs p{attn, y, o_kernel, o_bias, x, out,
                                  static_cast<int64_t>(B) * n, concat_ua ? 3 * hdv : hdv, D, hdv,
                                  2 * hdv + 2 * H * dqk, concat_ua, eps};
  return rails::k1tf32::launch_out(p, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory: kind 0 the pointwise attention, 1 the softmax one at
// length n; 2 the projection at the widest D, 3 the output GEMM.
extern "C" size_t rails_hstu_serve_tf32_smem_bytes(int kind, int n, int H, int dqk, int dv) {
  switch (kind) {
    case 0:
    case 1:
      return rails::k1tf32::attn_smem_bytes(kind, n, H, dqk, dv);
    case 2:
      return rails::k1tf32::proj_smem_bytes(rails::tc::kMaxD);
    default:
      return rails::k1tf32::out_smem_bytes();
  }
}
