// One-pass AdamW over one large parameter leaf (K7), hand-written for Hopper
// (sm_90a).
//
// Replaces `_fused_leaf_update` (rails_tpu/train/fused_adamw.py), the Pallas
// elementwise kernel that computes optax's adamw update of a leaf in one pass
// (`_adamw_math`). Here the update is applied in place: p, mu and nu are read
// once and written once (p_new = p + u, as `optax.apply_updates` adds the
// update), g is read once.
// Bound: bytes. 28 B per element (4 reads, 3 writes of f32) against ~12 FLOPs
// and a square root: at ml-20m's two fused leaves (8,944,000 elements) that is
// 250 MB, 0.075 ms at 3.35 TB/s. The design is a grid-stride loop with 16-byte
// (float4) loads and stores, a few blocks per SM in flight, and a scalar tail
// for sizes that are not a multiple of 4.
// Rounding: every product and sum is a separately rounded f32 operation
// (__fmul_rn / __fadd_rn, no FMA contraction), the order of `_adamw_math`, so
// the kernel gives the same bits as its plain PyTorch version.
#include <cstdint>

#include "common.cuh"

namespace rails {
namespace {

struct AdamW {
  float b1, omb1, b2, omb2, eps, wd, lr, c1, c2;   // omb = 1 - b
};

__device__ __forceinline__ void adamw_elem(float g, float& p, float& mu, float& nu,
                                           const AdamW& h) {
  const float mu2 = __fadd_rn(__fmul_rn(h.b1, mu), __fmul_rn(h.omb1, g));
  const float nu2 = __fadd_rn(__fmul_rn(h.b2, nu), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  const float mu_hat = __fmul_rn(mu2, h.c1);
  const float nu_hat = __fmul_rn(nu2, h.c2);
  const float step = __fadd_rn(__fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(nu_hat), h.eps)),
                               __fmul_rn(h.wd, p));
  p = __fadd_rn(p, __fmul_rn(-h.lr, step));
  mu = mu2;
  nu = nu2;
}

__global__ void __launch_bounds__(256)
adamw_kernel(float* __restrict__ p, float* __restrict__ mu, float* __restrict__ nu,
             const float* __restrict__ g, int64_t n, AdamW h) {
  const int64_t n4 = n / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t e = first; e < n4; e += stride) {
    float4 pv = reinterpret_cast<float4*>(p)[e];
    float4 mv = reinterpret_cast<float4*>(mu)[e];
    float4 vv = reinterpret_cast<float4*>(nu)[e];
    const float4 gv = reinterpret_cast<const float4*>(g)[e];
    adamw_elem(gv.x, pv.x, mv.x, vv.x, h);
    adamw_elem(gv.y, pv.y, mv.y, vv.y, h);
    adamw_elem(gv.z, pv.z, mv.z, vv.z, h);
    adamw_elem(gv.w, pv.w, mv.w, vv.w, h);
    reinterpret_cast<float4*>(p)[e] = pv;
    reinterpret_cast<float4*>(mu)[e] = mv;
    reinterpret_cast<float4*>(nu)[e] = vv;
  }
  for (int64_t e = 4 * n4 + first; e < n; e += stride) {
    adamw_elem(g[e], p[e], mu[e], nu[e], h);
  }
}

}  // namespace
}  // namespace rails

// p, mu, nu updated in place; every pointer 16-byte aligned, n elements f32.
extern "C" int rails_adamw_update(float* p, float* mu, float* nu, const float* g, long long n,
                                  float b1, float omb1, float b2, float omb2, float eps, float wd,
                                  float lr, float c1, float c2, void* stream) {
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  const long long want = (n / 4 + threads - 1) / threads + 1;
  const int blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  const rails::AdamW h{b1, omb1, b2, omb2, eps, wd, lr, c1, c2};
  rails::adamw_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(p, mu, nu, g, n,
                                                                                 h);
  return cudaGetLastError();
}
