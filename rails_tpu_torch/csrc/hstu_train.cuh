// Device code shared by K4's two backward entry points: the pointwise one
// (hstu_block_train.cu) and the softmax one (hstu_softmax_train.cu).
//
// attn_row_bwd_kernel is the first launch of both: the LayerNorm backward of
// attn per (user, position) row, which `_attn_bwd_kernel`
// (rails_tpu/ops/pallas/hstu_block_train.py:314-322, :384-393) runs before the
// attention products: gln = LN(attn); with o_input = u * gln, d_u = d_o * gln
// and d_gln = d_o * u; with concat_ua (o_input = [u, gln, u * gln], d_o of
// 3*h*dv columns), d_u = d_o[:W] + d_o[2W:] * gln and d_gln = d_o[W:2W] +
// d_o[2W:] * u; then d_attn = LN-backward(attn, d_gln) (`_ln_bwd`). One warp
// per row; the row's three passes over W = h*dv columns read attn, d_o and u
// from device memory (L1 keeps the row), so the kernel moves each byte about
// once: it is bound by the bytes, about 0.1 GB per layer at B = 128, n = 211.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "hstu_block.cuh"

namespace rails {
namespace {

constexpr float kPenalty = -30000.f;

// sigmoid(s) and d silu(s) / d s.
__device__ __forceinline__ void silu_grad(float s, float& sig, float& deriv) {
  sig = 1.f / (1.f + expf(-s));
  deriv = sig * (1.f + s * (1.f - sig));
}

// One warp per row of attn (M = B*n rows of width W = h*dv); d_o (W or, with
// CONCAT, 3W columns) and y are stored as T. d_u goes into the first W columns
// of d_y (row stride F), d_attn (f32, unrounded) to its scratch.
template <typename T, bool CONCAT>
__global__ void __launch_bounds__(kThreads)
attn_row_bwd_kernel(const float* __restrict__ attn, const T* __restrict__ d_o,
                    const T* __restrict__ y, int F, float* __restrict__ d_y,
                    float* __restrict__ d_attn, int64_t M, int W, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const float* a = attn + row * W;
  const T* g = d_o + row * (CONCAT ? 3 * W : W);
  const T* u = y + row * F;
  // d gln at column k.
  auto d_gln = [&](int k) {
    if constexpr (CONCAT) {
      return to_f<T>(g[W + k]) + to_f<T>(g[2 * W + k]) * to_f<T>(u[k]);
    } else {
      return to_f<T>(g[k]) * to_f<T>(u[k]);
    }
  };
  float s = 0.f;
  for (int k = lane; k < W; k += 32) s += a[k];
  const float mean = warp_sum(s) / W;
  float v = 0.f;
  for (int k = lane; k < W; k += 32) {
    const float d = a[k] - mean;
    v = fmaf(d, d, v);
  }
  const float inv = rsqrtf(warp_sum(v) / W + eps);
  float sum_dn = 0.f, sum_dn_nh = 0.f;
  for (int k = lane; k < W; k += 32) {
    const float nh = (a[k] - mean) * inv;
    const float dn = d_gln(k);
    if constexpr (CONCAT) {
      d_y[row * F + k] = to_f<T>(g[k]) + to_f<T>(g[2 * W + k]) * nh;
    } else {
      d_y[row * F + k] = to_f<T>(g[k]) * nh;
    }
    sum_dn += dn;
    sum_dn_nh = fmaf(dn, nh, sum_dn_nh);
  }
  const float mean_dn = warp_sum(sum_dn) / W;
  const float mean_dn_nh = warp_sum(sum_dn_nh) / W;
  for (int k = lane; k < W; k += 32) {
    const float nh = (a[k] - mean) * inv;
    d_attn[row * W + k] = inv * (d_gln(k) - mean_dn - nh * mean_dn_nh);
  }
}

template <typename T>
cudaError_t launch_row_bwd(const float* attn, const T* d_o, const T* y, int F, float* d_y,
                           float* d_attn, int64_t M, int W, float eps, bool concat_ua,
                           cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((M + kWarps - 1) / kWarps);
  if (concat_ua) {
    attn_row_bwd_kernel<T, true><<<blocks, kThreads, 0, s>>>(attn, d_o, y, F, d_y, d_attn, M,
                                                              W, eps);
  } else {
    attn_row_bwd_kernel<T, false><<<blocks, kThreads, 0, s>>>(attn, d_o, y, F, d_y, d_attn, M,
                                                               W, eps);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace rails
