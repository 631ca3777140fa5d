// Entry points of K4's f32 train block on the tensor cores (3xTF32,
// hstu_train_tf32.cuh): the forward's three launches and the backward's
// three, one call each, so that the stages run and are timed alone. Each
// refuses (cudaErrorInvalidValue, nothing launched) the widths outside the
// route (`tc::tf32_widths_ok`), where the CUDA-core entry points of
// hstu_block_train.cu take the f32 block; those refuse the route's instances.
#include <cstdint>

#include "hstu_train_tf32.cuh"

namespace {

rails::tf32::AttnArgs attn_args(const float* y, const float* d_attn, float* attn, float* d_y,
                                float* dbias, const float* colmask, const float* rel_pos,
                                const int* ext, const float* tsw, int n, int H, int dqk, int dv,
                                float inv_n, int max_bucket, int has_bias, int seed0, int adrop,
                                unsigned athresh, float ascale) {
  return rails::tf32::AttnArgs{y,     d_attn,  attn,    d_y,   dbias, colmask, rel_pos,
                               ext,   tsw,     n,       H,     dqk,   dv,      2 * H * dv + 2 * H * dqk,
                               has_bias, max_bucket, inv_n, adrop, seed0, athresh, ascale};
}

}  // namespace

// Forward (a): y (B*n, F) f32 = SiLU(LN(x) @ uvqk), x (B*n, D), uvqk (D, F).
extern "C" int rails_hstu_tf32_project(const float* x, const float* uvqk, float* y, int B, int n,
                                       int D, int H, int dqk, int dv, float eps, void* stream) {
  if (!rails::tc::tf32_widths_ok(D, H, dqk, dv, n)) return cudaErrorInvalidValue;
  const int F = 2 * H * dv + 2 * H * dqk;
  const rails::tf32::GemmArgs p{x, nullptr, uvqk, nullptr, nullptr, y, B * n, D, F, D, 0, 0, eps,
                                rails::Dropout{}};
  return rails::tf32::launch_proj(p, static_cast<cudaStream_t>(stream));
}

// Forward (b): attn (B*n, H*dv) f32 from y, with the in-kernel bias (has_bias:
// rel_pos, ext, tsw) or none, and the attention keep mask of seed0 (adrop:
// athresh, ascale).
extern "C" int rails_hstu_tf32_attention(const float* y, const float* colmask,
                                         const float* rel_pos, const int* ext, const float* tsw,
                                         float* attn, int B, int n, int H, int dqk, int dv,
                                         float inv_n, int max_bucket, int has_bias, int seed0,
                                         int adrop, unsigned athresh, float ascale,
                                         void* stream) {
  const auto p = attn_args(y, nullptr, attn, nullptr, nullptr, colmask, rel_pos, ext, tsw, n, H,
                           dqk, dv, inv_n, max_bucket, has_bias, seed0, adrop, athresh, ascale);
  return rails::tf32::launch_attn(rails::tf32::kFwd, p, B, static_cast<cudaStream_t>(stream));
}

// Forward (c): out (B*n, D) = o_input @ o_kernel + o_bias + x, o_input = u *
// LN(attn) or, with concat_ua, [u, LN(attn), u * LN(attn)] (o_kernel (3*H*dv,
// D)), u the first H*dv columns of y, times the o_input keep mask of seed0
// (drop: thresh, scale).
extern "C" int rails_hstu_tf32_out(const float* attn, const float* y, const float* o_kernel,
                                   const float* o_bias, const float* x, float* out, int B, int n,
                                   int D, int H, int dqk, int dv, float eps, int concat_ua,
                                   int drop, int seed0, unsigned thresh, float scale,
                                   void* stream) {
  if (!rails::tc::tf32_widths_ok(D, H, dqk, dv, n)) return cudaErrorInvalidValue;
  const int hdv = H * dv;
  const rails::tf32::GemmArgs p{attn, y, o_kernel, o_bias, x, out, B * n, concat_ua ? 3 * hdv : hdv,
                                D, hdv, 2 * hdv + 2 * H * dqk, concat_ua, eps,
                                rails::Dropout{drop, n, seed0, thresh, scale}};
  return rails::tf32::launch_out(p, static_cast<cudaStream_t>(stream));
}

// Backward, one stage a call. Stage 0 (attn_row_bwd_kernel): from attn, d_o
// (B*n, H*dv or, with concat_ua, 3*H*dv; keep mask applied) and y, d_u into
// d_y's first H*dv columns and d_attn_out (B*n, H*dv) f32. Stage 1: from y
// and d_attn, d_q into d_y and, unless null, dbias (B, n, n). Stage 2: d_v
// and d_k into d_y. The bias and attention keep mask as in the forward.
extern "C" int rails_hstu_tf32_bwd(int stage, const float* y, const float* d_o, const float* attn,
                                   const float* d_attn, float* d_attn_out, float* d_y,
                                   float* dbias, const float* colmask, const float* rel_pos,
                                   const int* ext, const float* tsw, int B, int n, int H, int dqk,
                                   int dv, float inv_n, float eps, int max_bucket, int has_bias,
                                   int concat_ua, int seed0, int adrop, unsigned athresh,
                                   float ascale, void* stream) {
  if (!rails::tc::tf32_widths_ok(1, H, dqk, dv, n) || stage < 0 || stage > 2)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (stage == 0) {
    const int64_t M = static_cast<int64_t>(B) * n;
    if (M == 0) return cudaSuccess;
    return rails::launch_row_bwd<float>(attn, d_o, y, 2 * H * dv + 2 * H * dqk, d_y, d_attn_out, M,
                                        H * dv, eps, concat_ua != 0, s);
  }
  const auto p = attn_args(y, d_attn, nullptr, d_y, dbias, colmask, rel_pos, ext, tsw, n, H, dqk,
                           dv, inv_n, max_bucket, has_bias, seed0, adrop, athresh, ascale);
  return rails::tf32::launch_attn(stage == 1 ? rails::tf32::kDq : rails::tf32::kDkv, p, B, s);
}

// Dynamic shared memory of an attention launch (0 forward, 1 dq, 2 dkv) at
// length n, and of the GEMMs at the widest D (kind 3).
extern "C" size_t rails_hstu_tf32_smem_bytes(int kind, int n, int dqk, int dv) {
  if (kind == 3) {
    const size_t out = rails::tf32::gemm_smem_bytes();
    const size_t proj = rails::tf32::proj_smem_bytes(rails::tc::kMaxD);
    return out > proj ? out : proj;
  }
  return rails::tf32::attn_smem_bytes(kind, n, dqk, dv);
}
