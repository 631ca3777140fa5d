// One-pass AdamW over every fused parameter leaf of a step (K7), hand-written
// for Hopper (sm_90a).
//
// Replaces `_fused_leaf_update` (rails_tpu/train/fused_adamw.py), the Pallas
// elementwise kernel that computes optax's adamw update of a leaf in one pass
// (`_adamw_math`). Here the update is applied in place: p, mu and nu are read
// once and written once (p_new = p + u, as `optax.apply_updates` adds the
// update), g is read once.
// Bound: bytes. 28 B per element (4 reads, 3 writes of f32) against ~12 FLOPs
// and a square root: at ml-20m's two fused leaves (8,944,000 elements) that is
// 250 MB, 0.075 ms at 3.35 TB/s.
// Design: one launch for all the leaves of a step, as PyTorch's multi-tensor
// apply does. The leaves' pointers and sizes travel in a table passed as a
// kernel parameter; the leaves are cut into chunks of kChunk elements, and a
// grid sized from the card's SM count and the kernel's occupancy (read once
// per device) walks the chunks in turn, so the blocks sweep neighbouring
// memory together (equal contiguous ranges per block, tried instead, ran 25%
// slower). Each thread issues kUnroll float4 loads of each of g, p, mu and nu
// before any arithmetic (8 loads in flight), with streaming hints
// (`__ldcs`/`__stcs`: nothing is read again); a leaf's last n % 4 elements
// are handled one by one.
// Rounding: every product and sum is a separately rounded f32 operation
// (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn, no FMA contraction), the
// order of `_adamw_math`, so the kernel gives the same bits as its plain
// PyTorch version.
#include <cstdint>

#include "common.cuh"

namespace rails {
namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;                         // float4 per tensor per thread
constexpr int kChunk = kThreads * kUnroll * 4;     // elements per chunk
constexpr int kMaxLeaves = 48;                     // the table stays < 4 KB
constexpr int kMaxDevices = 64;

struct AdamW {
  float b1, omb1, b2, omb2, eps, wd, lr, c1, c2;   // omb = 1 - b
};

struct LeafTable {
  float* p[kMaxLeaves];
  float* mu[kMaxLeaves];
  float* nu[kMaxLeaves];
  const float* g[kMaxLeaves];
  long long n[kMaxLeaves];
  long long first_chunk[kMaxLeaves + 1];   // prefix sum of the leaves' chunk counts
  int count;
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

__device__ __forceinline__ void adamw_vec(const float4& g, float4& p, float4& mu, float4& nu,
                                          const AdamW& h) {
  adamw_elem(g.x, p.x, mu.x, nu.x, h);
  adamw_elem(g.y, p.y, mu.y, nu.y, h);
  adamw_elem(g.z, p.z, mu.z, nu.z, h);
  adamw_elem(g.w, p.w, mu.w, nu.w, h);
}

__global__ void __launch_bounds__(kThreads)
adamw_leaves_kernel(const __grid_constant__ LeafTable t, AdamW h) {
  const long long chunks = t.first_chunk[t.count];
  int leaf = 0;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    while (c >= t.first_chunk[leaf + 1]) ++leaf;     // chunks only grow
    const long long n = t.n[leaf];
    const long long e0 = (c - t.first_chunk[leaf]) * kChunk;   // first element
    float4* p = reinterpret_cast<float4*>(t.p[leaf] + e0);
    float4* mu = reinterpret_cast<float4*>(t.mu[leaf] + e0);
    float4* nu = reinterpret_cast<float4*>(t.nu[leaf] + e0);
    const float4* g = reinterpret_cast<const float4*>(t.g[leaf] + e0);
    const long long n4 = min(static_cast<long long>(kChunk), n - e0) / 4;   // whole float4s
    if (n4 == kChunk / 4) {
      float4 gv[kUnroll], pv[kUnroll], mv[kUnroll], vv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = u * kThreads + threadIdx.x;
        gv[u] = __ldcs(g + i);
        pv[u] = __ldcs(p + i);
        mv[u] = __ldcs(mu + i);
        vv[u] = __ldcs(nu + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = u * kThreads + threadIdx.x;
        adamw_vec(gv[u], pv[u], mv[u], vv[u], h);
        __stcs(p + i, pv[u]);
        __stcs(mu + i, mv[u]);
        __stcs(nu + i, vv[u]);
      }
    } else {   // the leaf's last chunk: whole float4s, then n % 4 elements
      for (long long i = threadIdx.x; i < n4; i += kThreads) {
        float4 gv = __ldcs(g + i), pv = __ldcs(p + i), mv = __ldcs(mu + i), vv = __ldcs(nu + i);
        adamw_vec(gv, pv, mv, vv, h);
        __stcs(p + i, pv);
        __stcs(mu + i, mv);
        __stcs(nu + i, vv);
      }
      const long long e = e0 + 4 * n4 + threadIdx.x;
      if (e < n) adamw_elem(t.g[leaf][e], t.p[leaf][e], t.mu[leaf][e], t.nu[leaf][e], h);
    }
  }
}

// Blocks the kernel keeps resident on the current device, read once per device.
int grid_limit() {
  static int limit[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (limit[dev] == 0) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adamw_leaves_kernel, kThreads,
                                                      0) != cudaSuccess)
      return 0;
    limit[dev] = sm_count() * (per_sm > 0 ? per_sm : 1);
  }
  return limit[dev];
}

}  // namespace
}  // namespace rails

// count leaves, p, mu, nu updated in place from g: table holds the count p
// pointers, then the mu, nu and g pointers, then the leaves' sizes n (f32
// elements); every pointer 16-byte aligned (the wrapper checks); count <= 48.
extern "C" int rails_adamw_update_leaves(int count, const long long* table, float b1, float omb1,
                                         float b2, float omb2, float eps, float wd, float lr,
                                         float c1, float c2, void* stream) {
  using namespace rails;
  if (count < 0 || count > kMaxLeaves) return cudaErrorInvalidValue;
  LeafTable t;
  t.count = count;
  t.first_chunk[0] = 0;
  for (int i = 0; i < count; ++i) {
    t.p[i] = reinterpret_cast<float*>(table[i]);
    t.mu[i] = reinterpret_cast<float*>(table[count + i]);
    t.nu[i] = reinterpret_cast<float*>(table[2 * count + i]);
    t.g[i] = reinterpret_cast<const float*>(table[3 * count + i]);
    t.n[i] = table[4 * count + i];
    t.first_chunk[i + 1] = t.first_chunk[i] + (t.n[i] + kChunk - 1) / kChunk;
  }
  const long long chunks = t.first_chunk[count];
  if (chunks == 0) return cudaSuccess;
  const int limit = grid_limit();
  if (limit <= 0) return cudaErrorInvalidDevice;
  const unsigned blocks = static_cast<unsigned>(chunks < limit ? chunks : limit);
  const AdamW h{b1, omb1, b2, omb2, eps, wd, lr, c1, c2};
  adamw_leaves_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, h);
  return cudaGetLastError();
}
