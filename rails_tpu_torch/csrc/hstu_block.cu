// One HSTU block forward for serving (K1), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel `fused_hstu_block` in
// rails_tpu/ops/pallas/hstu_block.py (body `_kernel`) with every variant the
// serving path reaches: the bias built in-kernel (int32 timestamps), read
// from a precomputed (B, n, n) tensor (with the -30000 penalty folded in, or
// raw under softmax) or absent; SiLU or no activation on the projection;
// pointwise SiLU or softmax attention; u * LN(attn) or the concat_ua o_input.
// The kernels, their design and what bounds them are in hstu_block.cuh; this
// file is K1's entry point, which picks one instance of each of the three
// launches and runs them without dropout. The bf16 instances at the widths
// of hstu_block_tc.cuh run its tensor-core kernels instead (rails_hstu_tc_*).
#include "hstu_block.cuh"
#include "hstu_block_tc.cuh"

namespace rails {
namespace {

template <typename T>
cudaError_t launch_variant(const void* x, const float* colmask, const void* uvqk,
                           const void* o_kernel, const float* o_bias, const float* rel_pos,
                           const int* ext, const float* tsw, const void* bias, float* y,
                           float* attn, void* out, int B, int n, int D, int H, int dqk, int dv,
                           float inv_n, float inv_sqrt_dqk, float eps, int max_bucket,
                           int act_none, int concat_ua, int bias_mode, int softmax,
                           cudaStream_t s) {
  const int F = 2 * H * dv + 2 * H * dqk;
  const int M = B * n;
  float* scratch = stats_scratch(attn, H * dv);
  cudaError_t err = act_none ? launch_proj<T, kActNone>(x, uvqk, y, M, F, D, eps, scratch, s)
                             : launch_proj<T, kGemmPlain>(x, uvqk, y, M, F, D, eps, scratch, s);
  if (err != cudaSuccess) return err;
  if (softmax) {
    switch (bias_mode) {
      case kBiasInternal:
        err = launch_softmax<T, kBiasInternal>(y, colmask, rel_pos, ext, tsw, bias, attn, B, n,
                                               H, dqk, dv, inv_sqrt_dqk, max_bucket, s);
        break;
      case kBiasTensor:
        err = launch_softmax<T, kBiasTensor>(y, colmask, rel_pos, ext, tsw, bias, attn, B, n, H,
                                             dqk, dv, inv_sqrt_dqk, max_bucket, s);
        break;
      case kBiasNone:
        err = launch_softmax<T, kBiasNone>(y, colmask, rel_pos, ext, tsw, bias, attn, B, n, H,
                                           dqk, dv, inv_sqrt_dqk, max_bucket, s);
        break;
      default:
        return cudaErrorInvalidValue;
    }
  } else {
    switch (bias_mode) {
      case kBiasInternal:
        err = launch_attn<T, kBiasInternal>(y, colmask, rel_pos, ext, tsw, bias, attn, B, n, H,
                                            dqk, dv, inv_n, max_bucket, s);
        break;
      case kBiasTensor:
        err = launch_attn<T, kBiasTensor>(y, colmask, rel_pos, ext, tsw, bias, attn, B, n, H,
                                          dqk, dv, inv_n, max_bucket, s);
        break;
      case kBiasNone:
        err = launch_attn<T, kBiasNone>(y, colmask, rel_pos, ext, tsw, bias, attn, B, n, H, dqk,
                                        dv, inv_n, max_bucket, s);
        break;
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess) return err;
  const int hv = H * dv;
  return concat_ua ? launch_out<T, kConcatUA>(attn, hv, hv, 1.f, y, F, o_kernel, o_bias, x, out,
                                              M, D, eps, Dropout{}, s)
                   : launch_out<T, kGemmPlain>(attn, hv, hv, 1.f, y, F, o_kernel, o_bias, x,
                                               out, M, D, eps, Dropout{}, s);
}

}  // namespace
}  // namespace rails

// dtype: 0 = float32, 1 = bfloat16 (x, uvqk, o_kernel, bias and out share it).
// y (B*n, F) and attn (B*n, H*dv) are f32 scratch the caller allocates.
// bias_mode: 0 = internal (rel_pos (n, n), ext (B, n+1) int32, tsw (128,)),
// 1 = bias (B, n, n), 2 = none; the unused pointers may be null. o_kernel is
// (3*H*dv, D) when concat_ua is set, else (H*dv, D).
extern "C" int rails_hstu_block_fwd(int dtype, const void* x, const float* colmask,
                                    const void* uvqk, const void* o_kernel, const float* o_bias,
                                    const float* rel_pos, const int* ext, const float* tsw,
                                    const void* bias, float* y, float* attn, void* out, int B,
                                    int n, int D, int H, int dqk, int dv, float inv_n,
                                    float inv_sqrt_dqk, float eps, int max_bucket, int act_none,
                                    int concat_ua, int bias_mode, int softmax, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return rails::launch_variant<__nv_bfloat16>(
        x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, bias, y, attn, out, B, n, D, H,
        dqk, dv, inv_n, inv_sqrt_dqk, eps, max_bucket, act_none, concat_ua, bias_mode, softmax,
        s);
  }
  if (dtype == 0) {
    return rails::launch_variant<float>(
        x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, bias, y, attn, out, B, n, D, H,
        dqk, dv, inv_n, inv_sqrt_dqk, eps, max_bucket, act_none, concat_ua, bias_mode, softmax,
        s);
  }
  return cudaErrorInvalidValue;
}

extern "C" size_t rails_hstu_attn_smem_bytes(int n, int dqk, int dv) {
  return rails::attn_smem_bytes(n, dqk, dv);
}

extern "C" size_t rails_hstu_softmax_smem_bytes(int n, int H, int dqk, int dv) {
  return rails::softmax_smem_bytes(n, H, dqk, dv);
}

// The bf16 tensor-core block (hstu_block_tc.cuh), one stage a function: the
// projection writes u (B*n, H*dv) f32 and vqk (B*n, padded H*(dv_p +
// 2*dqk_p)) bf16, the attention reads them and writes oin (B*n, H*dv or
// 3*H*dv) bf16, the output GEMM reads it; the caller allocates each. bias_mode
// as above; vscale multiplies v before its bf16 rounding (1/max_seq_len
// pointwise, 1 under softmax).
extern "C" int rails_hstu_tc_project(const void* x, const void* uvqk, float* u, void* vqk, int M,
                                     int D, int H, int dqk, int dv, float eps, float vscale,
                                     int act_none, void* stream) {
  using rails::tc::bf16;
  return rails::tc::launch_tc_proj(static_cast<const bf16*>(x), static_cast<const bf16*>(uvqk), u,
                                   static_cast<bf16*>(vqk), nullptr, M, D, H, dqk, dv, eps, vscale,
                                   act_none ? 0 : 1, 0, static_cast<cudaStream_t>(stream));
}

extern "C" int rails_hstu_tc_attention(const void* vqk, const float* u, const float* colmask,
                                       const float* rel_pos, const int* ext, const float* tsw,
                                       const void* bias, void* oin, int B, int n, int H, int dqk,
                                       int dv, float inv_sqrt_dqk, float eps, int max_bucket,
                                       int bias_mode, int softmax, int concat_ua, void* stream) {
  using rails::tc::bf16;
  return rails::tc::launch_tc_attn(
      static_cast<const bf16*>(vqk), u, colmask, rel_pos, ext, tsw,
      static_cast<const bf16*>(bias), static_cast<bf16*>(oin), B, n, H, dqk, dv, inv_sqrt_dqk,
      eps, max_bucket, bias_mode, 0, softmax, concat_ua, 0, static_cast<cudaStream_t>(stream));
}

extern "C" int rails_hstu_tc_out(const void* oin, const void* o_kernel, const float* o_bias,
                                 const void* x, void* out, int M, int K, int N, void* stream) {
  using rails::tc::bf16;
  return rails::tc::launch_tc_out(static_cast<const bf16*>(oin), static_cast<const bf16*>(o_kernel),
                                  o_bias, static_cast<const bf16*>(x), static_cast<bf16*>(out), M,
                                  K, N, static_cast<cudaStream_t>(stream));
}

extern "C" size_t rails_hstu_tc_attn_smem_bytes(int n, int H, int dqk, int dv, int softmax) {
  return rails::tc::attn_smem_bytes(n, H, dqk, dv, softmax);
}

extern "C" const char* rails_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
