// The 3xTF32 pieces that the f32 tensor-core kernels share: K4's train block
// (hstu_train_tf32.cuh) and K1's serving block (hstu_serve_tf32.cuh). An f32
// operand x is split into hi (x with its 13 low mantissa bits cleared: TF32
// by truncation) and lo = x - hi (exact), of which the tensor core reads the
// top 19 bits; a product is lo.hi + hi.lo + hi.hi into an f32 accumulator on
// mma.sync m16n8k8, within about 2^-19 of its f32 value (the dropped lo.lo
// term and the truncations). Fragment layouts: A (16 x 8) rows g, g + 8 and
// columns t, t + 4 of a lane (g = lane / 4, t = lane % 4); B (8 x 8) rows t,
// t + 4 and column g; C rows g, g + 8 and columns 2t, 2t + 1.
#pragma once

#include <cstdint>

#include "mma_sync.cuh"

namespace rails {
namespace {
namespace tf32 {

// A head's dqk or dv padded to the 8-wide steps of its tiles: 16 or 32.
inline int pad_w(int w) { return w <= 16 ? 16 : 32; }

// ---- 3xTF32 fragments ------------------------------------------------------

// {hi, lo}: hi = x with its 13 low mantissa bits cleared, lo = x - hi (exact).
__device__ __forceinline__ float2 split(float x) {
  const float hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  return make_float2(hi, x - hi);
}

struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

__device__ __forceinline__ void set_a(FragA& a, int s, float2 v) {
  a.hi[s] = __float_as_uint(v.x);
  a.lo[s] = __float_as_uint(v.y);
}
__device__ __forceinline__ void set_b(FragB& b, int s, float2 v) {
  b.hi[s] = __float_as_uint(v.x);
  b.lo[s] = __float_as_uint(v.y);
}
// A (16 x 8) at s[row * ld + col].
__device__ __forceinline__ void ld_a(FragA& a, const float2* s, int ld, int g, int t) {
  set_a(a, 0, s[g * ld + t]);
  set_a(a, 1, s[(g + 8) * ld + t]);
  set_a(a, 2, s[g * ld + t + 4]);
  set_a(a, 3, s[(g + 8) * ld + t + 4]);
}
// B (8 k x 8 n) stored n-major: (k, n) at s[n * ld + k].
__device__ __forceinline__ void ld_b_nk(FragB& b, const float2* s, int ld, int g, int t) {
  set_b(b, 0, s[g * ld + t]);
  set_b(b, 1, s[g * ld + t + 4]);
}
// B stored k-major: (k, n) at s[k * ld + n].
__device__ __forceinline__ void ld_b_kn(FragB& b, const float2* s, int ld, int g, int t) {
  set_b(b, 0, s[t * ld + g]);
  set_b(b, 1, s[(t + 4) * ld + g]);
}
// B stored k-major, its k slots in a_from_c's order: slot t <-> row 2t, slot
// t + 4 <-> row 2t + 1.
__device__ __forceinline__ void ld_b_kn_pair(FragB& b, const float2* s, int ld, int g, int t) {
  set_b(b, 0, s[2 * t * ld + g]);
  set_b(b, 1, s[(2 * t + 1) * ld + g]);
}
// The A fragment of one k8 step from the C fragment of a 16 x 8 tile (row g,
// columns 2t and 2t + 1; row g + 8 likewise), split: slot t <-> column 2t.
__device__ __forceinline__ void a_from_c(FragA& a, const float (&c)[4]) {
  set_a(a, 0, split(c[0]));
  set_a(a, 1, split(c[2]));
  set_a(a, 2, split(c[1]));
  set_a(a, 3, split(c[3]));
}
// c[j] += a b[j] for J accumulators as lo.hi + hi.lo + hi.hi, each pass over
// every j before the next: no mma waits on the one issued just before it.
template <int J>
__device__ __forceinline__ void mma3(float (&c)[J][4], const FragA& a, const FragB (&b)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) tc::mma_tf32(c[j], a.lo, b[j].hi);
#pragma unroll
  for (int j = 0; j < J; ++j) tc::mma_tf32(c[j], a.hi, b[j].lo);
#pragma unroll
  for (int j = 0; j < J; ++j) tc::mma_tf32(c[j], a.hi, b[j].hi);
}

// 4 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(tc::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

}  // namespace tf32
}  // namespace
}  // namespace rails
