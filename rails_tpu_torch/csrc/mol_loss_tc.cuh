// K5, the fused shared-negatives MoL loss, on the H100's tensor cores: the
// forward and the backward of mol_loss_train.cu's tensor-core route, at
// P_Q = 8 with P_X = 4 (f32 or bf16 operands) or P_X = 8 (bf16), d_P <= 128
// (a multiple of 16 for bf16, of 8 for f32) and H a multiple of 16 up to 128:
// ML-1M's 8x4x64 and ML-20M's 8x4x128 in f32, Amazon Books' 8x8x32 in bf16,
// H = 128 (`tc_route` in ops/mol_loss_train.py states the same rule).
//
// Replaces, in rails_tpu/ops/pallas/mol_loss_train.py, `_forward_core`
// (:75-140, the forward `_fwd_kernel` :143) and `_bwd_kernel` (:159-290).
// Every product of the loss is a GEMM over a tile of pairs:
//   logits  T = Item (negatives x d_P) . Q^T            per query and component
//   Z = T_in . W1,  QI = H . W2                          the qi MLP
//   dH = D_qi . W2^T,  dT_mlp = D_z . W1^T               its backward
//   dW1 = T_in^T . D_z,  dW2 = H^T . D_qi                over the tile's pairs
//   dq = dT . Item,  d_item = dT^T . Q                   over negatives, queries
// Two MMA policies share one tile design (`Mma<S>` below):
//   - bf16 operands: mma.sync m16n8k16 bf16 with f32 sums, JAX's contract for
//     its bf16 products (`mlp_dtype`, :107-115, :212, :228, :255-257): t_in,
//     W1, W2 and h round to bf16 before their products; d_qi = d_gi, d_z and
//     d_t / T round before theirs; d_gi stays f32 for d_qp, d_ip and db2, and
//     d_z for db1.
//   - f32 operands: 3xTF32. Each operand x splits into hi (x truncated to
//     TF32: two instructions, a mask and a subtraction) and the exact
//     remainder lo = x - hi (which the tensor core truncates to TF32 in
//     turn), and a product is lo.hi + hi.lo + hi.hi on mma.sync m16n8k8 tf32,
//     added in f32: the dropped lo.lo term and the truncations leave each
//     product within about 2^-19 of its f32 value. Rounding both parts by
//     cvt.rna (2^-21) took 25% more time (10.16 against 8.15 ms backward at
//     ML-20M, profile_k5.py --time-only in a patched copy) for errors the
//     tolerances barely see: over seeds 1-8 the forward at 0.028 against
//     0.043 of K2_TOL_F32, the gradients at 0.214 against 0.217 of
//     GRAD_REL_TOL, the latter set by the tensor cores' f32 accumulation of
//     dW1 and dW2 over a block's pairs (PERF.md §6).
// SiLU, the sigmoid and the softmax exp take the fast forms __expf and
// __fdividef, as K2's and K1's tensor-core kernels; over seeds 1-8 every
// error stays within the shares above (profile_k5.py, PERF.md).
//
// Per pair the function needs L d_P + 2 L H multiply-adds forward and 3 L d_P
// + 7 L H backward (the recompute, dH, the z recompute, dT_mlp, dW1, dW2, dq,
// d_item): 12,288 / 40,960 at 8x4x128 and 18,432 / 63,488 at 8x8x32, H = 128.
// Special-function (MUFU) results: one ex2 for each SiLU and exp, H + 2 L
// forward; the backward adds the sigmoids of gi and z, which share the
// recomputed forward's exps, so H + 2 L too (chip_smoke.py's bound counts
// those; this kernel issues a reciprocal per division besides). At 3xTF32 the
// f32 products run at a third of the TF32 rate (165 TFLOP/s dense), above the
// 67 TFLOP/s of the CUDA cores.
//
// Design. A CTA of 8 warps walks groups of 8 queries (one per warp, its
// `query warp`), and for each group the negatives in tiles of 16 (the mma's
// 16 rows): 128 pairs a tile. The weights sit in shared memory once, in the
// operand type, with their logit axis in the order kappa = mx * 8 + n (the
// JAX kernel's m-major row l'), so the logits' C fragments are the A
// fragments of the MLP's first product (bf16: two n8 tiles make one k16 A;
// TF32: one n8 tile makes one k8 A, its k positions 2t, 2t + 1 in the A slots
// t, t + 4, with B read in the same order). Per tile:
//   1. Row pass (each warp, its query x 16 negatives, in registers): the
//      logits (A = the item rows of component mx, B = the query's 8
//      components), the qi mask on t_in, z and h in chunks of 16 hidden
//      units, qi, the gating softmax and the combine across each quad's four
//      lanes. The forward writes out here. The backward forms d_gi and the
//      direct d_t, and stages t_in, d_qi and d_gi in shared memory.
//   2. The f32 reductions over the staged d_gi: d_qp (the group's queries),
//      d_ip and db2 (the tile's negatives).
//   3. Chunk pass (warp c owns hidden units 16c .. 16c + 15 for every pair):
//      z (the same products in the same order as the row pass, so the same
//      bits) and dH, then d_z and h; d_zr into a tile-wide buffer, h into a
//      per-warp scratch; dW1[:, c] += T_in^T d_zr and dW2[c, :] += H^T D_qi
//      over each 16 pairs, in the warp's registers for the whole kernel, and
//      db1[c] from the unrounded d_z.
//   4. Row pass: dT_mlp = D_zr W1^T; d_t = (direct + dT_mlp * qi mask) / T,
//      rounded, into a (query component) x (negative component) tile.
//   5. dq += dT Item and d_item += dT^T Q as block GEMMs.
// Each dropout mask bit is hashed once, by the lane that holds its (pair,
// logit) in the row pass's fragments (K3's hash at the JAX kernel's flat
// index, as the CUDA-core route), kept as one 32-bit word per stream, and
// reused by the recompute and the backward.
// No floating-point atomics: a block owns its queries' dq and d_qp rows
// (read, added to and written by one thread per entry in tile order), and its
// own slot of dW1, dW2, db1, db2, d_ip and d_item, reduced over the slots in
// block order by reduce_slots_kernel; two calls give the same bits.
#pragma once

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "hash_dropout.cuh"
#include "mma_sync.cuh"

namespace rails {
namespace {

// The two dropout streams of K5: use, seed + salt, keep threshold and scale
// of the qi-MLP input mask, then of the softmax-weight mask, and the JAX
// kernel's padded extents of the flat index (M_pad * R_pad, R_pad).
struct Drop {
  int use_qi, use_pi;
  uint32_t seed_qi, thr_qi, seed_pi, thr_pi;
  float scale_qi, scale_pi;
  uint32_t mr;   // M_pad * R_pad
  uint32_t r_pad;
};

inline Drop make_drop(int use_qi, unsigned seed_qi, unsigned thr_qi, float scale_qi, int use_pi,
                      unsigned seed_pi, unsigned thr_pi, float scale_pi, int m_pad, int r_pad) {
  return Drop{use_qi, use_pi, seed_qi, thr_qi, seed_pi, thr_pi, scale_qi, scale_pi,
              static_cast<uint32_t>(m_pad) * static_cast<uint32_t>(r_pad),
              static_cast<uint32_t>(r_pad)};
}

// out[e] = sum over the slots b = 0 .. nb-1 of part[b][e], in that order.
__global__ void reduce_slots_kernel(const float* __restrict__ part, int nb, int64_t stride,
                                    float* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= stride) return;
  float s = 0.f;
  for (int b = 0; b < nb; ++b) s += part[b * stride + e];
  out[e] = s;
}

namespace losstc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kPQ = 8;            // query components: one n8 tile
constexpr int kQT = kWarps;       // queries a group: one per warp
constexpr int kRT = 16;           // negatives a tile: the mma's 16 rows
constexpr int kP = kQT * kRT;     // pairs a tile
constexpr int kMaxH = 16 * kWarps;  // hidden units: one chunk of 16 per warp
constexpr int kMaxDP = 128;

// The geometries this route takes (ops/mol_loss_train.py:tc_route states the
// same): dtype 0 f32, 1 bf16. f32 at P_X = 8 would need at least 243,456 B
// of shared memory at H = 128, over the 232,448 a block may have.
inline bool tc_ok(int dtype, int pq, int px, int dP, int Hd) {
  const bool bf = dtype == 1;
  const int dq = bf ? 16 : 8;
  return (dtype == 0 || bf) && pq == kPQ && (px == 4 || (bf && px == 8)) && dP >= dq &&
         dP % dq == 0 && dP <= kMaxDP && Hd >= 16 && Hd % 16 == 0 && Hd <= kMaxH;
}

// The logit l = n * P_X + mx at the MLP axis position kappa = mx * 8 + n.
template <int PX>
__host__ __device__ __forceinline__ int logit_of(int kappa) {
  return (kappa % kPQ) * PX + kappa / kPQ;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The MMA policy of storage type S: A is a 16 x 16 operand tile, B a 16 x 8
// one, C a 16 x 8 f32 fragment (c0, c1: row g, columns 2t, 2t + 1; c2, c3:
// row g + 8). Loaders take the tile's first element s and its stride:
//   ld_a_k: A(i, k) = s[i * rs + k]     ld_a_m: A(i, k) = s[k * ks + i]
//   ld_b_k: B(k, j) = s[j * ns + k]     ld_b_n: B(k, j) = s[k * ks + j]
// a_from_c makes the A of two C tiles (columns 0-7 and 8-15), rounding to S.
template <typename S> struct Mma;

template <> struct Mma<bf16> {
  static constexpr int kPad = 8;   // row padding in elements: 16 B
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  static __device__ __forceinline__ void ld_a_k(A& a, const bf16* s, int rs) {
    const int lane = threadIdx.x & 31;
    tc::ldsm_x4(s + (lane & 15) * rs + (lane >> 4) * 8, a.r);
  }
  static __device__ __forceinline__ void ld_a_m(A& a, const bf16* s, int ks) {
    const int lane = threadIdx.x & 31;
    tc::ldsm_x4_t(s + ((lane >> 4) * 8 + (lane & 7)) * ks + ((lane >> 3) & 1) * 8, a.r);
  }
  static __device__ __forceinline__ void ld_b_k(B& b, const bf16* s, int ns) {
    const int lane = threadIdx.x & 31;
    tc::ldsm_x2(s + (lane & 7) * ns + ((lane >> 3) & 1) * 8, b.r);
  }
  static __device__ __forceinline__ void ld_b_n(B& b, const bf16* s, int ks) {
    const int lane = threadIdx.x & 31;
    tc::ldsm_x2_t(s + (lane & 15) * ks, b.r);
  }
  static __device__ __forceinline__ void a_from_c(A& a, const float (&c0)[4],
                                                  const float (&c1)[4]) {
    a.r[0] = tc::pack_bf16(c0[0], c0[1]);
    a.r[1] = tc::pack_bf16(c0[2], c0[3]);
    a.r[2] = tc::pack_bf16(c1[0], c1[1]);
    a.r[3] = tc::pack_bf16(c1[2], c1[3]);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    tc::mma_bf16(c, a.r, b.r[0], b.r[1]);
  }
  // Two neighbouring elements, rounded.
  static __device__ __forceinline__ void st2(bf16* p, float x, float y) {
    *reinterpret_cast<uint32_t*>(p) = tc::pack_bf16(x, y);
  }
};

template <> struct Mma<float> {
  static constexpr int kPad = 4;   // rows 4 words apart mod 32: no bank conflicts along m or n
  // Two k8 halves; in each, slot t holds k = 2t and slot t + 4 holds k = 2t + 1.
  struct A { uint32_t hi[2][4], lo[2][4]; };
  struct B { uint32_t hi[2][2], lo[2][2]; };
  // hi: x with its 13 low mantissa bits cleared (TF32 by truncation); lo: the
  // exact remainder x - hi, passed as f32 bits, of which the tensor core reads
  // the top 19 (a truncation again).
  static __device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
  static __device__ __forceinline__ void ld_a_k(A& a, const float* s, int rs) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 u = *reinterpret_cast<const float2*>(s + g * rs + 8 * h + 2 * t);
      const float2 v = *reinterpret_cast<const float2*>(s + (g + 8) * rs + 8 * h + 2 * t);
      split(u.x, a.hi[h][0], a.lo[h][0]);
      split(v.x, a.hi[h][1], a.lo[h][1]);
      split(u.y, a.hi[h][2], a.lo[h][2]);
      split(v.y, a.hi[h][3], a.lo[h][3]);
    }
  }
  static __device__ __forceinline__ void ld_a_m(A& a, const float* s, int ks) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* r0 = s + (8 * h + 2 * t) * ks;
      split(r0[g], a.hi[h][0], a.lo[h][0]);
      split(r0[g + 8], a.hi[h][1], a.lo[h][1]);
      split(r0[ks + g], a.hi[h][2], a.lo[h][2]);
      split(r0[ks + g + 8], a.hi[h][3], a.lo[h][3]);
    }
  }
  static __device__ __forceinline__ void ld_b_k(B& b, const float* s, int ns) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 u = *reinterpret_cast<const float2*>(s + g * ns + 8 * h + 2 * t);
      split(u.x, b.hi[h][0], b.lo[h][0]);
      split(u.y, b.hi[h][1], b.lo[h][1]);
    }
  }
  static __device__ __forceinline__ void ld_b_n(B& b, const float* s, int ks) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* r0 = s + (8 * h + 2 * t) * ks + g;
      split(r0[0], b.hi[h][0], b.lo[h][0]);
      split(r0[ks], b.hi[h][1], b.lo[h][1]);
    }
  }
  static __device__ __forceinline__ void a_from_c(A& a, const float (&c0)[4],
                                                  const float (&c1)[4]) {
    split(c0[0], a.hi[0][0], a.lo[0][0]);
    split(c0[2], a.hi[0][1], a.lo[0][1]);
    split(c0[1], a.hi[0][2], a.lo[0][2]);
    split(c0[3], a.hi[0][3], a.lo[0][3]);
    split(c1[0], a.hi[1][0], a.lo[1][0]);
    split(c1[2], a.hi[1][1], a.lo[1][1]);
    split(c1[1], a.hi[1][2], a.lo[1][2]);
    split(c1[3], a.hi[1][3], a.lo[1][3]);
  }
  // The small terms first, then hi . hi.
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tc::mma_tf32(c, a.lo[h], b.hi[h]);
      tc::mma_tf32(c, a.hi[h], b.lo[h]);
      tc::mma_tf32(c, a.hi[h], b.hi[h]);
    }
  }
  static __device__ __forceinline__ void st2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

__host__ __device__ constexpr size_t align16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// Shared memory, byte offsets (each a multiple of 16) and row strides in
// elements. Rows of an S operand: W1^T and W2 [H][kappa]; the group's query
// components [m * 8 + n][d_P16]; the tile's item components [mx * 16 + r][d_P16]
// (component-major, so a component's 16 rows are one ldmatrix stride apart);
// qp, ip (f32, kappa order). The backward adds t_in [pair][kappa] (reused for
// d_t [m * 8 + n][mx * 16 + r] once the chunk pass is done), d_gi (f32) and
// d_qi [pair][kappa] (the same buffer in f32), d_zr [pair][H], each warp's h
// scratch [16 pairs][16 units] and the db2 partials [r][kappa].
template <typename S, int PX>
struct Layout {
  static constexpr int L = kPQ * PX;
  static constexpr int kPad = Mma<S>::kPad;
  static constexpr bool kF32 = sizeof(S) == 4;
  int dP16, ldw, ldq, ldt, ldg, ldd, ldz, ldh, ldT;
  size_t w1, w2, q, item, qp, ip, b1, b2, tin, dgi, dqi, dzr, hs, db2, bytes;
  __host__ __device__ Layout(int dP, int Hd, bool bwd)
      : dP16((dP + 15) / 16 * 16), ldw(L + kPad), ldq(dP16 + kPad), ldt(L + kPad), ldg(L + 4),
        ldd(kF32 ? L + 4 : L + kPad), ldz(Hd + kPad), ldh(16 + kPad), ldT(kRT * PX + kPad) {
    size_t o = 0;
    w1 = o;    o += align16(sizeof(S) * Hd * ldw);
    w2 = o;    o += align16(sizeof(S) * Hd * ldw);
    q = o;     o += align16(sizeof(S) * kQT * kPQ * ldq);
    item = o;  o += align16(sizeof(S) * kRT * PX * ldq);
    qp = o;    o += align16(sizeof(float) * kQT * L);
    ip = o;    o += align16(sizeof(float) * kRT * L);
    b1 = o;    o += align16(sizeof(float) * Hd);
    b2 = o;    o += align16(sizeof(float) * L);
    tin = dgi = dqi = dzr = hs = db2 = o;
    if (bwd) {
      const size_t tin_n = kP * ldt, dt_n = kQT * kPQ * ldT;
      tin = o;  o += align16(sizeof(S) * (tin_n > dt_n ? tin_n : dt_n));
      dgi = o;  o += align16(sizeof(float) * kP * ldg);
      dqi = dgi;
      if (!kF32) {
        dqi = o;
        o += align16(sizeof(S) * kP * ldd);
      }
      dzr = o;  o += align16(sizeof(S) * kP * ldz);
      hs = o;   o += align16(sizeof(S) * kWarps * 16 * ldh);
      db2 = o;  o += align16(sizeof(float) * kRT * L);
    }
    bytes = o;
  }
};

// SiLU v / (1 + e^-v), the sigmoid and the softmax exp in the fast forms
// __expf (within 2 + 1.2 |x| ulps) and __fdividef (2 ulps), as K2's and K1's
// tensor-core kernels: one MUFU ex2 and one rcp each, without the range
// reduction and the slow-path branch of expf and IEEE division.
__device__ __forceinline__ float silu_fast(float v) { return __fdividef(v, 1.0f + __expf(-v)); }
__device__ __forceinline__ float sigmoid_fast(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}

// The scale of a pair's logit from its stream's keep bits: 1 when the stream
// is off, else `scale` or 0.
__device__ __forceinline__ float keep_mul(uint32_t bits, int bit, int use, float scale) {
  return use ? (((bits >> bit) & 1u) ? scale : 0.f) : 1.f;
}

// Rows of n elements from global memory (zeros past n and for rows whose
// source is null) into shared rows of stride ld padded to n16 elements, by
// cp.async in 16-byte pieces, all in flight together; the caller waits
// (cp_async_wait<0>) and syncs before reading them.
template <typename S, typename RowFn>
__device__ __forceinline__ void stage_rows(S* dst, int rows, int ld, int n, int n16,
                                           const S* any, RowFn src_row) {
  constexpr int kVec = 16 / sizeof(S);
  const int cpr = n16 / kVec;
  for (int e = threadIdx.x; e < rows * cpr; e += kThreads) {
    const int row = e / cpr, c = e % cpr;
    const S* src = src_row(row);
    const bool valid = src != nullptr && c * kVec < n;
    tc::cp_async16(dst + row * ld + c * kVec, valid ? src + c * kVec : any, valid);
  }
  tc::cp_async_commit();
}

// Step 5's unit of work: rows (C rows g and g + 8 at row_ptr(0), row_ptr(1),
// null past the edge) += A . B over NKS k16 steps for the kNG n8 tiles of d_P
// from n0 below nd, one accumulator chain each, A read once a step. The rows'
// old values are read before the products, so the loads overlap them.
constexpr int kNG = 4;
template <typename MM, int NKS, typename S, typename LoadA, typename RowPtr>
__device__ __forceinline__ void gemm_add_rows(LoadA load_a, const S* b, int ldb, int n0, int nd,
                                              RowPtr row_ptr) {
  const int t = threadIdx.x & 3;
  float* rows[2] = {row_ptr(0), row_ptr(1)};
  float2 old[kNG][2];
#pragma unroll
  for (int u = 0; u < kNG; ++u)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      old[u][i] = rows[i] != nullptr && n0 + u < nd
                      ? *reinterpret_cast<const float2*>(rows[i] + (n0 + u) * 8 + 2 * t)
                      : make_float2(0.f, 0.f);
  float acc[kNG][4] = {};
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    typename MM::A a;
    load_a(a, ks);
#pragma unroll
    for (int u = 0; u < kNG; ++u) {
      if (n0 + u < nd) {
        typename MM::B bb;
        MM::ld_b_n(bb, b + ks * 16 * ldb + (n0 + u) * 8, ldb);
        MM::mma(acc[u], a, bb);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kNG; ++u)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] != nullptr && n0 + u < nd)
        *reinterpret_cast<float2*>(rows[i] + (n0 + u) * 8 + 2 * t) =
            make_float2(old[u][i].x + acc[u][2 * i], old[u][i].y + acc[u][2 * i + 1]);
}

// The forward (kBwd false: out[m, r]) or the backward (kBwd true: dq and dqp
// added to in place, the rest into the block's slot of `part`) over groups of
// kQT queries, blockIdx.x, + gridDim.x, ...
template <typename S, int PX, bool kBwd>
__global__ void __launch_bounds__(kThreads, kBwd ? 1 : 2)
mol_loss_tc_kernel(const S* __restrict__ q, const S* __restrict__ qp, const S* __restrict__ item,
                   const S* __restrict__ ip, const float* __restrict__ w1t,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ d_out,
                   float* __restrict__ out, float* __restrict__ dq, float* __restrict__ dqp,
                   float* __restrict__ part, int64_t stride, int M, int R, int dP, int Hd,
                   float inv_t, float eps, Drop d) {
  constexpr int L = kPQ * PX;
  constexpr int kKS = L / 16;   // k16 steps over the logit axis
  using MM = Mma<S>;
  using FA = typename MM::A;
  using FB = typename MM::B;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<S, PX> lay(dP, Hd, kBwd);
  S* w1s = reinterpret_cast<S*>(smem + lay.w1);
  S* w2s = reinterpret_cast<S*>(smem + lay.w2);
  S* qs = reinterpret_cast<S*>(smem + lay.q);
  S* its = reinterpret_cast<S*>(smem + lay.item);
  float* qps = reinterpret_cast<float*>(smem + lay.qp);
  float* ips = reinterpret_cast<float*>(smem + lay.ip);
  float* b1s = reinterpret_cast<float*>(smem + lay.b1);
  float* b2s = reinterpret_cast<float*>(smem + lay.b2);
  S* tins = reinterpret_cast<S*>(smem + lay.tin);
  S* dts = tins;
  float* dgis = reinterpret_cast<float*>(smem + lay.dgi);
  S* dqis = reinterpret_cast<S*>(smem + lay.dqi);
  S* dzrs = reinterpret_cast<S*>(smem + lay.dzr);
  S* hss = reinterpret_cast<S*>(smem + lay.hs);
  float* db2s = reinterpret_cast<float*>(smem + lay.db2);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nch = Hd / 16;
  const int dP16 = lay.dP16;

  for (int e = tid; e < Hd * L; e += kThreads) {
    const int j = e / L, k = e % L, l = logit_of<PX>(k);
    w1s[j * lay.ldw + k] = from_f<S>(w1t[j * L + l]);
    w2s[j * lay.ldw + k] = from_f<S>(w2[j * L + l]);
  }
  for (int e = tid; e < Hd; e += kThreads) b1s[e] = b1[e];
  for (int e = tid; e < L; e += kThreads) b2s[e] = b2[logit_of<PX>(e)];
  if constexpr (kBwd) {
    for (int e = tid; e < kRT * L; e += kThreads) db2s[e] = 0.f;
  }

  // The backward's slot and the chunk pass's accumulators, held for the
  // whole kernel: dW1[:, c] (kappa x 16), dW2[c, :] (16 x kappa), db1[c].
  float* pw1 = part + static_cast<int64_t>(blockIdx.x) * stride;   // [H][L]
  float* pw2 = pw1 + Hd * L;                                       // [H][L]
  float* pb1 = pw2 + Hd * L;                                       // [H]
  float* pb2 = pb1 + Hd;                                           // [L]
  float* pip = pb2 + L;                                            // [R][L]
  float* pit = pip + static_cast<int64_t>(R) * L;                  // [R][PX][dP]
  float aw1[kKS][2][4], aw2[L / 8][4], ab1[2][2];
#pragma unroll
  for (int i = 0; i < kKS; ++i)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) aw1[i][nt][e] = 0.f;
#pragma unroll
  for (int i = 0; i < L / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) aw2[i][e] = 0.f;
  ab1[0][0] = ab1[0][1] = ab1[1][0] = ab1[1][1] = 0.f;

  const int ngroups = (M + kQT - 1) / kQT;
  for (int grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
    const int q0 = grp * kQT;
    __syncthreads();   // the previous group's readers of qs and qps are done
    stage_rows<S>(qs, kQT * kPQ, lay.ldq, dP, dP16, q, [&](int row) -> const S* {
      const int m = q0 + row / kPQ;
      return m < M ? q + (static_cast<int64_t>(m) * kPQ + row % kPQ) * dP : nullptr;
    });
    for (int e = tid; e < kQT * L; e += kThreads) {
      const int m = q0 + e / L;
      qps[e] = m < M ? to_f<S>(qp[static_cast<int64_t>(m) * L + logit_of<PX>(e % L)]) : 0.f;
    }
    const int m = q0 + warp;   // the warp's query
    const bool mv = m < M;

    for (int r0 = 0; r0 < R; r0 += kRT) {
      __syncthreads();   // the previous tile's readers of its, ips and the staged tile are done
      stage_rows<S>(its, kRT * PX, lay.ldq, dP, dP16, item, [&](int row) -> const S* {
        const int r = r0 + row % kRT;
        return r < R ? item + (static_cast<int64_t>(r) * PX + row / kRT) * dP : nullptr;
      });
      for (int e = tid; e < kRT * L; e += kThreads) {
        const int r = r0 + e / L;
        ips[e] = r < R ? to_f<S>(ip[static_cast<int64_t>(r) * L + logit_of<PX>(e % L)]) : 0.f;
      }
      // The backward's cotangents of the lane's pairs, read early.
      float dout[2] = {0.f, 0.f};
      if constexpr (kBwd) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = r0 + g + i * 8;
          if (mv && r < R) dout[i] = d_out[static_cast<int64_t>(m) * R + r];
        }
      }
      tc::cp_async_wait<0>();
      __syncthreads();

      // 1. Row pass: lane (g, t) holds, for negatives r0 + g and r0 + g + 8
      // (element e >> 1), the logits kappa = mx * 8 + 2t + (e & 1).
      float lg[PX][4];
#pragma unroll
      for (int mx = 0; mx < PX; ++mx)
#pragma unroll
        for (int e = 0; e < 4; ++e) lg[mx][e] = 0.f;
      for (int ks = 0; ks < dP16 / 16; ++ks) {
        FB bq;
        MM::ld_b_k(bq, qs + warp * kPQ * lay.ldq + ks * 16, lay.ldq);
#pragma unroll
        for (int mx = 0; mx < PX; ++mx) {
          FA a;
          MM::ld_a_k(a, its + mx * kRT * lay.ldq + ks * 16, lay.ldq);
          MM::mma(lg[mx], a, bq);
        }
      }
      uint32_t bqi = 0u, bpi = 0u;   // keep bits, bit mx * 4 + e
#pragma unroll
      for (int mx = 0; mx < PX; ++mx)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lg[mx][e] *= inv_t;
          const uint32_t kap = mx * kPQ + 2 * t + (e & 1);
          const uint32_t idx = kap * d.mr + static_cast<uint32_t>(m) * d.r_pad +
                               static_cast<uint32_t>(r0 + g + (e >> 1) * 8);
          const int bit = mx * 4 + e;
          if (d.use_qi) bqi |= static_cast<uint32_t>(hash_bits(idx, d.seed_qi) >= d.thr_qi) << bit;
          if (d.use_pi) bpi |= static_cast<uint32_t>(hash_bits(idx, d.seed_pi) >= d.thr_pi) << bit;
        }
      // t_in = t * qi mask, rounded to S: A fragments (the forward) or staged
      // rows that the z product reads back (the backward, where the
      // registers hold the accumulators of the chunk pass).
      FA ta[kKS];
#pragma unroll
      for (int j = 0; j < kKS; ++j) {
        float c0[4], c1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          c0[e] = lg[2 * j][e] * keep_mul(bqi, 2 * j * 4 + e, d.use_qi, d.scale_qi);
          c1[e] = lg[2 * j + 1][e] * keep_mul(bqi, (2 * j + 1) * 4 + e, d.use_qi, d.scale_qi);
        }
        if constexpr (!kBwd) {
          MM::a_from_c(ta[j], c0, c1);
        } else {
          S* row = tins + (warp * kRT + g) * lay.ldt + 2 * j * 8 + 2 * t;
          MM::st2(row, c0[0], c0[1]);
          MM::st2(row + 8 * lay.ldt, c0[2], c0[3]);
          MM::st2(row + 8, c1[0], c1[1]);
          MM::st2(row + 8 * lay.ldt + 8, c1[2], c1[3]);
        }
      }
      if constexpr (kBwd) __syncwarp();
      // qi = silu(t_in W1 + b1) W2, 16 hidden units at a time.
      float gi[PX][4];
#pragma unroll
      for (int mx = 0; mx < PX; ++mx)
#pragma unroll
        for (int e = 0; e < 4; ++e) gi[mx][e] = 0.f;
      for (int c = 0; c < nch; ++c) {
        float z[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float lo = b1s[c * 16 + nt * 8 + 2 * t], hi = b1s[c * 16 + nt * 8 + 2 * t + 1];
          z[nt][0] = lo;
          z[nt][1] = hi;
          z[nt][2] = lo;
          z[nt][3] = hi;
        }
#pragma unroll
        for (int j = 0; j < kKS; ++j) {
          FA at;
          if constexpr (kBwd) MM::ld_a_k(at, tins + warp * kRT * lay.ldt + j * 16, lay.ldt);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            FB bw;
            MM::ld_b_k(bw, w1s + (c * 16 + nt * 8) * lay.ldw + j * 16, lay.ldw);
            MM::mma(z[nt], kBwd ? at : ta[j], bw);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) z[nt][e] = silu_fast(z[nt][e]);
        FA ha;
        MM::a_from_c(ha, z[0], z[1]);
#pragma unroll
        for (int mx = 0; mx < PX; ++mx) {
          FB bw;
          MM::ld_b_n(bw, w2s + c * 16 * lay.ldw + mx * 8, lay.ldw);
          MM::mma(gi[mx], ha, bw);
        }
      }
      // gi = qp ip + qi + b2; p = softmax(silu(gi)) over the quad's 4 lanes.
      const float* qpw = qps + warp * L;
      float p[PX][4];
      float pm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int mx = 0; mx < PX; ++mx)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = mx * kPQ + 2 * t + (e & 1);
          gi[mx][e] = fmaf(qpw[k], ips[(g + (e >> 1) * 8) * L + k], gi[mx][e] + b2s[k]);
          p[mx][e] = silu_fast(gi[mx][e]);
          pm[e >> 1] = fmaxf(pm[e >> 1], p[mx][e]);
        }
      pm[0] = quad_max(pm[0]);
      pm[1] = quad_max(pm[1]);
      float se[2] = {0.f, 0.f};
#pragma unroll
      for (int mx = 0; mx < PX; ++mx)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[mx][e] = __expf(p[mx][e] - pm[e >> 1]);
          se[e >> 1] += p[mx][e];
        }
      se[0] = quad_sum(se[0]);
      se[1] = quad_sum(se[1]);
      float sq[2] = {0.f, 0.f}, st[2] = {0.f, 0.f};
#pragma unroll
      for (int mx = 0; mx < PX; ++mx)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[mx][e] = __fdividef(p[mx][e], se[e >> 1]);
          const float qv = p[mx][e] * keep_mul(bpi, mx * 4 + e, d.use_pi, d.scale_pi);
          sq[e >> 1] += qv;
          st[e >> 1] = fmaf(qv, lg[mx][e], st[e >> 1]);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sq[i] = quad_sum(sq[i]);
        st[i] = quad_sum(st[i]);
      }

      if constexpr (!kBwd) {
        const int r = r0 + g + t * 8;   // lane t = 0 stores row g, t = 1 row g + 8
        if (mv && t < 2 && r < R) {
          out[static_cast<int64_t>(m) * R + r] =
              d.use_pi ? st[t] / fmaxf(sq[t], eps) : st[t];
        }
      } else {
        // d gi, and the direct d t = a p mask (into lg).
        float a[2], corr[2], dot[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float s = d.use_pi ? fmaxf(sq[i], eps) : 1.f;
          const float inv_s = 1.0f / s;
          a[i] = dout[i] * inv_s;
          corr[i] = (d.use_pi && s > eps) ? dout[i] * (st[i] * inv_s) * inv_s : 0.f;
          dot[i] = 0.f;
        }
#pragma unroll
        for (int mx = 0; mx < PX; ++mx)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const float mk = keep_mul(bpi, mx * 4 + e, d.use_pi, d.scale_pi);
            dot[i] = fmaf((a[i] * lg[mx][e] - corr[i]) * mk, p[mx][e], dot[i]);
          }
        dot[0] = quad_sum(dot[0]);
        dot[1] = quad_sum(dot[1]);
#pragma unroll
        for (int mx = 0; mx < PX; ++mx) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const float mk = keep_mul(bpi, mx * 4 + e, d.use_pi, d.scale_pi);
            const float dp = (a[i] * lg[mx][e] - corr[i]) * mk;
            const float sg = sigmoid_fast(gi[mx][e]);
            gi[mx][e] = p[mx][e] * (dp - dot[i]) * (sg * (1.0f + gi[mx][e] * (1.0f - sg)));
            lg[mx][e] = a[i] * p[mx][e] * mk;
          }
          const int k = mx * kPQ + 2 * t;
          float* grow = dgis + (warp * kRT + g) * lay.ldg + k;
          *reinterpret_cast<float2*>(grow) = make_float2(gi[mx][0], gi[mx][1]);
          *reinterpret_cast<float2*>(grow + 8 * lay.ldg) = make_float2(gi[mx][2], gi[mx][3]);
          if constexpr (!Layout<S, PX>::kF32) {
            S* drow = dqis + (warp * kRT + g) * lay.ldd + k;
            MM::st2(drow, gi[mx][0], gi[mx][1]);
            MM::st2(drow + 8 * lay.ldd, gi[mx][2], gi[mx][3]);
          }
        }
        __syncthreads();

        // 2. d_qp of the group's queries, d_ip and db2 of the tile's negatives.
        // (Each global value is read before its sum, so the load's latency
        // overlaps the shared-memory reads.)
        for (int e = tid; e < kQT * L; e += kThreads) {
          const int mq = e / L, k = e % L;
          const bool ok = q0 + mq < M;
          float* dst = dqp + static_cast<int64_t>(ok ? q0 + mq : 0) * L + logit_of<PX>(k);
          const float old = ok ? *dst : 0.f;
          float acc = 0.f;
#pragma unroll
          for (int rr = 0; rr < kRT; ++rr)
            acc = fmaf(dgis[(mq * kRT + rr) * lay.ldg + k], ips[rr * L + k], acc);
          if (ok) *dst = old + acc;
        }
        for (int e = tid; e < kRT * L; e += kThreads) {
          const int rr = e / L, k = e % L, r = r0 + rr;
          const bool ok = r < R;
          float* dst = pip + static_cast<int64_t>(ok ? r : 0) * L + logit_of<PX>(k);
          const float old = ok ? *dst : 0.f;
          float acc = 0.f, sb = 0.f;
#pragma unroll
          for (int mq = 0; mq < kQT; ++mq) {
            const float v = dgis[(mq * kRT + rr) * lay.ldg + k];
            acc = fmaf(v, qps[mq * L + k], acc);
            sb += v;
          }
          db2s[e] += sb;
          if (ok) *dst = old + acc;
        }

        // 3. Chunk pass: warp c, hidden units 16c .. 16c + 15, every pair.
        if (warp < nch) {
          const int c = warp;
          S* hw = hss + warp * 16 * lay.ldh;
          for (int rg = 0; rg < kQT; ++rg) {
            const S* trg = tins + rg * kRT * lay.ldt;
            const S* drg = dqis + rg * kRT * lay.ldd;
            float z[2][4], dh[2][4];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const float lo = b1s[c * 16 + nt * 8 + 2 * t];
              const float hi = b1s[c * 16 + nt * 8 + 2 * t + 1];
              z[nt][0] = lo;
              z[nt][1] = hi;
              z[nt][2] = lo;
              z[nt][3] = hi;
#pragma unroll
              for (int e = 0; e < 4; ++e) dh[nt][e] = 0.f;
            }
#pragma unroll
            for (int j = 0; j < kKS; ++j) {
              FA at, ad;
              MM::ld_a_k(at, trg + j * 16, lay.ldt);
              MM::ld_a_k(ad, drg + j * 16, lay.ldd);
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                FB bw;
                MM::ld_b_k(bw, w1s + (c * 16 + nt * 8) * lay.ldw + j * 16, lay.ldw);
                MM::mma(z[nt], at, bw);
                MM::ld_b_k(bw, w2s + (c * 16 + nt * 8) * lay.ldw + j * 16, lay.ldw);
                MM::mma(dh[nt], ad, bw);
              }
            }
            // h = silu(z) (the row pass's form: the same bits), d_z = dH silu'(z).
            S* zrow = dzrs + (rg * kRT + g) * lay.ldz + c * 16 + 2 * t;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float zz = z[nt][e];
                const float den = 1.0f + __expf(-zz);
                const float sg = __fdividef(1.0f, den);
                z[nt][e] = __fdividef(zz, den);
                dh[nt][e] *= sg * (1.0f + zz * (1.0f - sg));
                ab1[nt][e & 1] += dh[nt][e];
              }
              MM::st2(hw + g * lay.ldh + nt * 8 + 2 * t, z[nt][0], z[nt][1]);
              MM::st2(hw + (g + 8) * lay.ldh + nt * 8 + 2 * t, z[nt][2], z[nt][3]);
              MM::st2(zrow + nt * 8, dh[nt][0], dh[nt][1]);
              MM::st2(zrow + 8 * lay.ldz + nt * 8, dh[nt][2], dh[nt][3]);
            }
            __syncwarp();
            // dW1[:, c] += T_in^T D_zr and dW2[c, :] += H^T D_qi over these 16 pairs.
            const S* zrg = dzrs + rg * kRT * lay.ldz + c * 16;
            FB bz[2];
            MM::ld_b_n(bz[0], zrg, lay.ldz);
            MM::ld_b_n(bz[1], zrg + 8, lay.ldz);
#pragma unroll
            for (int mt = 0; mt < kKS; ++mt) {
              FA at;
              MM::ld_a_m(at, trg + mt * 16, lay.ldt);
              MM::mma(aw1[mt][0], at, bz[0]);
              MM::mma(aw1[mt][1], at, bz[1]);
            }
            FA ah;
            MM::ld_a_m(ah, hw, lay.ldh);
#pragma unroll
            for (int nt = 0; nt < L / 8; ++nt) {
              FB bd;
              MM::ld_b_n(bd, drg + nt * 8, lay.ldd);
              MM::mma(aw2[nt], ah, bd);
            }
            __syncwarp();   // the scratch is rewritten by the next 16 pairs
          }
        }
        __syncthreads();

        // 4. Row pass: dT_mlp = D_zr W1^T, then d_t / T into dts.
        float dtm[PX][4];
#pragma unroll
        for (int mx = 0; mx < PX; ++mx)
#pragma unroll
          for (int e = 0; e < 4; ++e) dtm[mx][e] = 0.f;
        for (int ks = 0; ks < nch; ++ks) {
          FA az;
          MM::ld_a_k(az, dzrs + warp * kRT * lay.ldz + ks * 16, lay.ldz);
#pragma unroll
          for (int mx = 0; mx < PX; ++mx) {
            FB bw;
            MM::ld_b_n(bw, w1s + ks * 16 * lay.ldw + mx * 8, lay.ldw);
            MM::mma(dtm[mx], az, bw);
          }
        }
#pragma unroll
        for (int mx = 0; mx < PX; ++mx)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = (lg[mx][e] + dtm[mx][e] * keep_mul(bqi, mx * 4 + e, d.use_qi,
                                                               d.scale_qi)) * inv_t;
            const int n = 2 * t + (e & 1), rr = g + (e >> 1) * 8;
            dts[(warp * kPQ + n) * lay.ldT + mx * kRT + rr] = from_f<S>(v);
          }
        __syncthreads();

        // 5. dq[(m, n), :] += dT Item over the tile's (mx, r); d_item[(r, mx), :]
        // += dT^T Q over the group's (m, n). n8 tiles of d_P past dP are padding.
        const int nd = dP / 8, ng = (nd + kNG - 1) / kNG;
        for (int w = warp; w < 4 * ng; w += kWarps) {
          const int mt = w % 4;
          gemm_add_rows<MM, PX>(
              [&](FA& a, int ks) { MM::ld_a_k(a, dts + mt * 16 * lay.ldT + ks * 16, lay.ldT); },
              its, lay.ldq, (w / 4) * kNG, nd, [&](int i) -> float* {
                const int row = mt * 16 + g + i * 8, mq = q0 + row / kPQ;
                return mq < M ? dq + (static_cast<int64_t>(mq) * kPQ + row % kPQ) * dP
                              : nullptr;
              });
        }
        for (int w = warp; w < PX * ng; w += kWarps) {
          const int mx = w % PX;
          gemm_add_rows<MM, kQT * kPQ / 16>(
              [&](FA& a, int ks) { MM::ld_a_m(a, dts + ks * 16 * lay.ldT + mx * kRT, lay.ldT); },
              qs, lay.ldq, (w / PX) * kNG, nd, [&](int i) -> float* {
                const int r = r0 + g + i * 8;
                return r < R ? pit + (static_cast<int64_t>(r) * PX + mx) * dP : nullptr;
              });
        }
      }
    }
  }

  if constexpr (kBwd) {
    // The chunk pass's sums and db2 into the slot: one writer per entry.
    if (warp < nch) {
      const int c = warp;
#pragma unroll
      for (int mt = 0; mt < kKS; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kap = mt * 16 + g + (e >> 1) * 8, j = c * 16 + nt * 8 + 2 * t + (e & 1);
            pw1[j * L + logit_of<PX>(kap)] = aw1[mt][nt][e];
          }
#pragma unroll
      for (int nt = 0; nt < L / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = c * 16 + g + (e >> 1) * 8, kap = nt * 8 + 2 * t + (e & 1);
          pw2[j * L + logit_of<PX>(kap)] = aw2[nt][e];
        }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int ci = 0; ci < 2; ++ci) {
          float v = ab1[nt][ci];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
          if (g == 0) pb1[c * 16 + nt * 8 + 2 * t + ci] = v;
        }
    }
    __syncthreads();
    for (int k = tid; k < L; k += kThreads) {
      float s = 0.f;
      for (int rr = 0; rr < kRT; ++rr) s += db2s[rr * L + k];
      pb2[logit_of<PX>(k)] = s;
    }
  }
}

// The forward (d_out == nullptr) or the backward and its slot reduction.
template <typename S, int PX>
cudaError_t launch(const void* q, const void* qp, const void* item, const void* ip,
                   const float* w1t, const float* b1, const float* w2, const float* b2,
                   const float* d_out, float* out, float* dq, float* dqp, float* part,
                   float* red, int nb, int M, int R, int dP, int Hd, float inv_t, float eps,
                   const Drop& d, cudaStream_t stream) {
  const bool bwd = d_out != nullptr;
  const size_t smem = Layout<S, PX>(dP, Hd, bwd).bytes;
  auto kernel = bwd ? mol_loss_tc_kernel<S, PX, true> : mol_loss_tc_kernel<S, PX, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int ngroups = (M + kQT - 1) / kQT;
  if (!bwd) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    nb = per_sm * sm_count();
    if (nb < 1) return cudaErrorInvalidConfiguration;
    if (nb > ngroups) nb = ngroups;
  }
  constexpr int L = kPQ * PX;
  const int64_t stride = 2 * static_cast<int64_t>(Hd) * L + Hd + L +
                         static_cast<int64_t>(R) * L + static_cast<int64_t>(R) * PX * dP;
  kernel<<<nb, kThreads, smem, stream>>>(
      static_cast<const S*>(q), static_cast<const S*>(qp), static_cast<const S*>(item),
      static_cast<const S*>(ip), w1t, b1, w2, b2, d_out, out, dq, dqp, part, stride, M, R, dP,
      Hd, inv_t, eps, d);
  err = cudaGetLastError();
  if (err != cudaSuccess || !bwd) return err;
  reduce_slots_kernel<<<static_cast<unsigned>((stride + 255) / 256), 256, 0, stream>>>(part, nb,
                                                                                      stride, red);
  return cudaGetLastError();
}

inline size_t smem_bytes(bool bwd, int dtype, int px, int dP, int Hd) {
  if (dtype == 0) return Layout<float, 4>(dP, Hd, bwd).bytes;
  return px == 4 ? Layout<bf16, 4>(dP, Hd, bwd).bytes : Layout<bf16, 8>(dP, Hd, bwd).bytes;
}

}  // namespace losstc
}  // namespace
}  // namespace rails
