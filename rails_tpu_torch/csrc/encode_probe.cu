// The encode cost probe (P1), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel of rails_tpu/cli/encode_probe.py (`make_block`,
// body `_variant_kernel`): K1's forward with the internal time bias, SiLU,
// pointwise attention with the mask as a multiply, and the concat_ua output
// projection ([u, LN(attn), u * LN(attn)] against a (3*h*dv, D) o_kernel),
// with a `mode` that drops one cost term:
//   full     everything;
//   noact    no SiLU on the (n, F) projection;
//   linattn  the attention gate is linear, a = qk (mask still multiplied);
//   nottb    the bias is the relative-position slab only (no time buckets);
//   noattn   no attention launch: attn := round_T(v / n), read from Y by the
//            output GEMM's loader;
//   ident    LayerNorm and the whole (D, F) projection GEMM, out = Y[:, :D]
//            + x (the other F - D columns computed and dropped).
// Each mode is the block's own kernels (hstu_block.cuh) instantiated with the
// probe-only template switches, so that the difference between two modes'
// device times is the cost of the term on this card. These instances live in
// this file alone: K1's and K4's builds do not change.
// Bound: as K1 (hstu_block.cuh), the FP32 FMA rate of the CUDA cores.
// The bf16 modes at the widths of hstu_block_tc.cuh run K1's tensor-core
// kernels with the same switches (rails_encode_probe_tc), so that P1 prices
// the tensor-core K1: noact the projection epilogue's SiLU, linattn the
// attention's gate, nottb the bias tile's time buckets, noattn the attention
// launch's epilogue over v, ident the projection with the epilogue
// (LN(x) @ uvqk)[:, :D] + x.
#include "hstu_block.cuh"
#include "hstu_block_tc.cuh"

namespace rails {
namespace {

enum ProbeMode { kFull = 0, kNoAct = 1, kLinAttn = 2, kNoTtb = 3, kNoAttn = 4, kIdent = 5 };

template <typename T>
cudaError_t probe(int mode, const void* x, const float* colmask, const void* uvqk,
                  const void* o_kernel, const float* o_bias, const float* rel_pos,
                  const int* ext, const float* tsw, float* y, float* attn, void* out, int B,
                  int n, int D, int H, int dqk, int dv, float inv_n, float eps, int max_bucket,
                  cudaStream_t s) {
  const int F = 2 * H * dv + 2 * H * dqk;
  const int M = B * n;
  const int hv = H * dv;
  float* scratch = stats_scratch(attn, hv);
  if (mode == kIdent) {
    // The whole (D, F) projection, as the JAX probe's one matmul; columns
    // past D are computed and dropped.
    const float2* stats = launch_ln_stats<T>(x, M, D, eps, scratch, s);
    ln_gemm_kernel<T, kProj, kProbeIdent><<<gemm_grid(F, M), kThreads, 0, s>>>(
        x, D, D, nullptr, 0, static_cast<const T*>(uvqk), F, nullptr, static_cast<const T*>(x),
        out, M, F, D, eps, 1.f, Dropout{}, stats);
    return cudaGetLastError();
  }
  cudaError_t err = mode == kNoAct
                        ? launch_proj<T, kActNone>(x, uvqk, y, M, F, D, eps, scratch, s)
                        : launch_proj<T, kGemmPlain>(x, uvqk, y, M, F, D, eps, scratch, s);
  if (err != cudaSuccess) return err;
  switch (mode) {
    case kFull:
    case kNoAct:
      err = launch_attn<T, kBiasInternal>(y, colmask, rel_pos, ext, tsw, nullptr, attn, B, n, H,
                                          dqk, dv, inv_n, max_bucket, s);
      break;
    case kLinAttn:
      err = launch_attn<T, kBiasInternal, false>(y, colmask, rel_pos, ext, tsw, nullptr, attn, B,
                                                 n, H, dqk, dv, inv_n, max_bucket, s);
      break;
    case kNoTtb:
      err = launch_attn<T, kBiasRelPos>(y, colmask, rel_pos, ext, tsw, nullptr, attn, B, n, H,
                                        dqk, dv, inv_n, max_bucket, s);
      break;
    case kNoAttn:
      // v of Y scaled and rounded by the output GEMM's loader: no attention.
      return launch_out<T, kConcatUA | kProbeFromV>(y + hv, F, hv, inv_n, y, F, o_kernel,
                                                    o_bias, x, out, M, D, eps, Dropout{}, s);
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_out<T, kConcatUA>(attn, hv, hv, 1.f, y, F, o_kernel, o_bias, x, out, M, D, eps,
                                  Dropout{}, s);
}

}  // namespace
}  // namespace rails

// dtype: 0 = float32, 1 = bfloat16 (x, uvqk, o_kernel and out share it).
// o_kernel (3*H*dv, D); rel_pos (n, n), ext (B, n+1) int32, tsw (128,) f32;
// y (B*n, F) and attn (B*n, H*dv) f32 scratch the caller allocates.
extern "C" int rails_encode_probe(int dtype, int mode, const void* x, const float* colmask,
                                  const void* uvqk, const void* o_kernel, const float* o_bias,
                                  const float* rel_pos, const int* ext, const float* tsw,
                                  float* y, float* attn, void* out, int B, int n, int D, int H,
                                  int dqk, int dv, float inv_n, float eps, int max_bucket,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return rails::probe<__nv_bfloat16>(mode, x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext,
                                       tsw, y, attn, out, B, n, D, H, dqk, dv, inv_n, eps,
                                       max_bucket, s);
  }
  if (dtype == 0) {
    return rails::probe<float>(mode, x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, y,
                               attn, out, B, n, D, H, dqk, dv, inv_n, eps, max_bucket, s);
  }
  return cudaErrorInvalidValue;
}

// The bf16 probe on the tensor-core kernels (hstu_block_tc.cuh); u, vqk and
// oin are scratch as for rails_hstu_tc_block, o_kernel (3*H*dv, D).
extern "C" int rails_encode_probe_tc(int mode, const void* x, const float* colmask,
                                     const void* uvqk, const void* o_kernel, const float* o_bias,
                                     const float* rel_pos, const int* ext, const float* tsw,
                                     float* u, void* vqk, void* oin, void* out, int B, int n, int D,
                                     int H, int dqk, int dv, float inv_n, float eps,
                                     int max_bucket, void* stream) {
  using rails::tc::bf16;
  namespace r = rails;
  auto s = static_cast<cudaStream_t>(stream);
  const int M = B * n;
  const auto* xb = static_cast<const bf16*>(x);
  if (mode == r::kIdent) {
    return r::tc::launch_tc_proj(xb, static_cast<const bf16*>(uvqk), u, static_cast<bf16*>(vqk),
                                 static_cast<bf16*>(out), M, D, H, dqk, dv, eps, inv_n, 0, 1, s);
  }
  if (mode < r::kFull || mode > r::kNoAttn) return cudaErrorInvalidValue;
  cudaError_t err = r::tc::launch_tc_proj(xb, static_cast<const bf16*>(uvqk), u,
                                          static_cast<bf16*>(vqk), nullptr, M, D, H, dqk, dv, eps,
                                          inv_n, mode == r::kNoAct ? 0 : 1, 0, s);
  if (err != cudaSuccess) return err;
  err = r::tc::launch_tc_attn(static_cast<const bf16*>(vqk), u, colmask, rel_pos, ext, tsw,
                              nullptr, static_cast<bf16*>(oin), B, n, H, dqk, dv, 1.f, eps,
                              max_bucket, mode == r::kNoTtb ? r::kBiasRelPos : r::kBiasInternal,
                              mode == r::kLinAttn ? 1 : 0, 0, 1, mode == r::kNoAttn ? 1 : 0, s);
  if (err != cudaSuccess) return err;
  return r::tc::launch_tc_out(static_cast<const bf16*>(oin), static_cast<const bf16*>(o_kernel),
                              o_bias, xb, static_cast<bf16*>(out), M, 3 * H * dv, D, s);
}
