// K2's bf16 and int8 instances on the H100's tensor cores: the exact MoL
// corpus scorer (mol_scoring.cu: K2, with and without emit_blockmax, and K10
// over a tile list) and the modes of its cost probe P2 (mol_probe.cu, bf16),
// for bf16 and int8 tables at P_Q = 8, P_X in {4, 8}, d_P a multiple of 16
// (P_X * d_P <= 512) and H a multiple of 16 up to 256: ML-20M's 8x4x128,
// ML-1M's 8x4x64 and Amazon Books' 8x8x32, H = 128 (`tc_route` in
// ops/mol_scoring.py states the same rule). The logits are the routine of
// mol_tc_logits.cuh, which K8 and K9 (mol_bounds.cu) share, so their bounds
// are maxima of these logits bit for bit. f32 tables stay on the CUDA-core
// kernel of mol_scoring.cuh (a tensor-core f32 product rounds its operands to
// TF32), and so does synthetic-small's 4x2x16 (P_Q = 4 is half an n8 tile,
// L = 8 half a k16 step).
// int8 tables: the codes convert exactly to bf16 (Int8Rows, loaded into
// registers one item block ahead), each raw logit is multiplied by cs[m, x]
// before 1/T, the gating partial is code * ps[x] in f32, and the MLP rounds
// to bf16 as with bf16 tables (mol_scoring.cuh orders them the same way).
//
// Replaces the body `_kernel` of rails_tpu/ops/pallas/mol_scoring.py
// (:53-182), which computes with three products on the matrix unit, each with
// bf16 operands and f32 sums: the component logits, logits.bf16 @ W1 and
// silu(h).bf16 @ W2. mma.sync m16n8k16 bf16 is that contract, so this kernel
// rounds where JAX rounds; only the order of the f32 sums differs.
//
// Per (query b, item x) pair (pair counts at 8x4x128 / 8x8x32, H = 128):
//   logits[l = n*P_X + m] = <q[b, n], item[m, :, x]> * (1/T)
//   h   = bf16(logits) @ bf16(W1) + b1;   qi = bf16(silu(h)) @ bf16(W2) + b2
//   gi  = qp[b] * ip[x] + qi;  gw = silu(gi);  out = sum e*logits / sum e,
//   e = exp(gw - max gw).
//   Tensor cores: L d_P + 2 L H = 12,288 / 18,432 FMAs.
//   MUFU (special-function unit): this kernel's SiLU v / (1 + e^-v) takes an
//   ex2 and a reciprocal, the softmax one ex2: 2 H + 3 L = 352 / 448 issued.
//   The function needs H + 2 L = 192 / 256 (one ex2 a SiLU and exp, the
//   reciprocals by Newton steps on the FMA units): chip_smoke.py's bound
//   counts those.
//   FP32 on the CUDA cores: L d_P / 16 adds of the logits' k16 partial
//   sums, about 5 H for the hidden SiLU and its bf16 packing and 17 L for
//   the 1/T scale, the gating and the combine, ~1,460 / ~1,860.
// So the floor is the MUFU's 16 results per SM per clock (0.63 ms for the
// serving batch's 13.7M pairs at 1,980 MHz and 192 a pair; 1.16 at the 352
// this kernel issues), above the tensor cores' (0.34) and the bytes' (~0.02
// ms once the table sits in L2). Every SiLU and exp takes the fast forms
// __expf and __fdividef (no range reduction, no slow-path branch), as K1's
// tensor-core SiLU does (hstu_block_tc.cuh). The
// hidden SiLU's output rounds to bf16 before W2. The one-MUFU tanh.approx
// form of JAX's `_sigmoid_tanh` moves so many of those roundings that P2's
// noexp mode leaves P2_TOL (3.7x its bound), so it is not used.
//
// Design. A CTA (8 warps) owns 32 queries, staged once in shared memory with
// their gating partials, and bf16 copies of W1 and W2 (converted from the f32
// arguments, which hold bf16 values, so the conversion is exact), and walks
// item blocks of 32 items (blockIdx.y, + gridDim.y, ...; one CTA per SM, the
// grid sized to the card), each staged by cp.async into one of two buffers
// while the other is scored (int8 tables: the codes through registers one
// block ahead, the scales by cp.async). A warp scores 16 items x 8 queries,
// two queries at a time:
//   1. Logits, the routine of mol_tc_logits.cuh (`tile_logits`, then
//      `scale_logits`: int8 times cs[m, x], then 1/T), which K8 and K9 run
//      too: A = the item tile (16 items x d_P, ldmatrix.trans from the
//      table's (d_P, X) rows), B = a query's (d_P x 8 n) components, one n8
//      tile per item group m. Lane (g, t) of the C fragment holds, for items g
//      and g + 8, the logits of n = 2t, 2t+1 at every m. Each k16 step's
//      product starts from zero and is added in f32: chained through the mma's
//      accumulator, the logits missed the bf16 rounding of their exact value
//      20% more often than a plain f32 GEMM's, added so 16% less often (on an
//      H100, `profile_p2_agreement.py`), for 4% more time.
//   2. The qi MLP in chunks of 16 hidden units, never stored: those C
//      fragments, rounded to bf16, are the A fragments of h = logits @ W1 over
//      K = L, with the MLP's logit axis ordered kappa = m * 8 + n (W1's rows
//      permuted to match while staged); h starts from b1. SiLU and the bf16
//      rounding run in registers, and two n8 tiles of h are the A fragment of
//      one k16 step of qi += h @ W2 (the register reuse FlashAttention makes
//      of P for P @ V). qi's columns follow the same kappa order, so lane
//      (g, t) ends with qi for exactly the logits it holds.
//   3. The combine in those fragments: gi, gw, and the max, sum e and sum
//      e * logit over l across the quad's four lanes by shuffles.
// Every pair's score depends on its own query and item alone, so K10's
// columns equal K2's bit for bit, and emit_blockmax's scores are K2's with
// the valid == 0 columns at -1e30 (its per-tile maxima: a warp max, then the
// exact float atomic max of common.cuh). The logit order of the arguments
// (n-major, l = n*P_X + m) and the entry points' layouts are K2's.
#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "mol_scoring.cuh"
#include "mol_tc_logits.cuh"

namespace rails {
namespace {
namespace moltc {

// The geometries this kernel takes (ops/mol_scoring.py:tc_route states the same).
inline bool tc_ok(int pq, int px, int dP, int Hd) {
  return logits_ok(pq, px, dP) && Hd >= 16 && Hd % 16 == 0 && Hd <= 256;
}

// Shared memory, byte offsets (every one a multiple of 16).
template <int PX>
struct Layout {
  static constexpr int L = kPQ * PX;
  int ldq, ldw1, ldw2;
  size_t items, q, w1, w2, ip, qp, b1, b2, cs, ps, bytes;
  __host__ __device__ Layout(int dP, int Hd, bool quant)
      : ldq(dP + 8), ldw1(L + 8), ldw2(Hd + 8) {
    size_t o = 0;
    items = o; o += 2 * static_cast<size_t>(PX) * dP * kLdX * 2;  // two buffers [PX*dP][kLdX]
    q = o;     o += static_cast<size_t>(kQB) * kPQ * ldq * 2;     // [kQB*8][dP + 8]
    w1 = o;    o += static_cast<size_t>(Hd) * ldw1 * 2;            // [H][kappa]
    w2 = o;    o += static_cast<size_t>(L) * ldw2 * 2;             // [kappa][H]
    ip = o;    o += 2 * static_cast<size_t>(L) * kLdX * 2;         // two buffers [kappa][kLdX]
    qp = o;    o += static_cast<size_t>(kQB) * L * 4;              // [kQB][l] f32
    b1 = o;    o += static_cast<size_t>(Hd) * 4;
    b2 = o;    o += static_cast<size_t>(L) * 4;
    cs = o;    o += quant ? 2 * static_cast<size_t>(PX) * kTX * 4 : 0;  // two [PX][32] f32
    ps = o;    o += quant ? 2 * static_cast<size_t>(kTX) * 4 : 0;       // two [32] f32
    bytes = o;
  }
};

// The logit index l = n*P_X + m of the MLP's axis position kappa = m*8 + n.
template <int PX>
__device__ __forceinline__ int logit_of(int kappa) {
  return (kappa % kPQ) * PX + kappa / kPQ;
}

// SiLU v / (1 + e^-v) and the softmax exp in the fast forms __expf (within
// 2 + 1.2 |x| ulps) and __fdividef (2 ulps), as K1's tensor-core SiLU
// (hstu_block_tc.cuh): two MUFU ops a SiLU, one an exp, and none of the range
// reduction and slow-path branch of expf and IEEE division, which took a
// quarter of the kernel's time. The hidden SiLU's output rounds to bf16
// before W2; the gating SiLU and the exp feed the f32 mixture weights.
// Against the accurate forms, on the H100 (PERF.md §6): every K2, K10 and
// P2 error and agreement the same to the printed digit.
__device__ __forceinline__ float silu_fast(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename S, int PX, int MODE = kMolFull>
__global__ void __launch_bounds__(kThreads, 1)
mol_tc_kernel(const bf16* __restrict__ q, const float* __restrict__ qp,
              const S* __restrict__ items, const S* __restrict__ ip,
              const float* __restrict__ cs, const float* __restrict__ ps,
              const float* __restrict__ w1t, const float* __restrict__ b1,
              const float* __restrict__ w2, const float* __restrict__ b2,
              const float* __restrict__ valid, float* __restrict__ out,
              float* __restrict__ tile_max, const int* __restrict__ tile_ids, int nib, int B,
              int Xp, int Xo, int dP, int Hd, float inv_t) {
  constexpr int L = kPQ * PX;
  constexpr bool kQuant = kInt8<S>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<PX> lay(dP, Hd, kQuant);
  bf16* its = reinterpret_cast<bf16*>(smem + lay.items);
  bf16* qs = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* w1s = reinterpret_cast<bf16*>(smem + lay.w1);
  bf16* w2s = reinterpret_cast<bf16*>(smem + lay.w2);
  bf16* ips = reinterpret_cast<bf16*>(smem + lay.ip);
  float* qps = reinterpret_cast<float*>(smem + lay.qp);
  float* b1s = reinterpret_cast<float*>(smem + lay.b1);
  float* b2s = reinterpret_cast<float*>(smem + lay.b2);
  float* css = reinterpret_cast<float*>(smem + lay.cs);
  float* pss = reinterpret_cast<float*>(smem + lay.ps);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kQB;
  const int rows = PX * dP;

  // Once per CTA: the query block (zeros past B), its gating partials, the
  // MLP's weights in bf16 on the kappa axis, and the biases.
  stage_queries(q, qs, lay.ldq, q0, B, dP);
  tc::cp_async_commit();
  for (int e = tid; e < Hd * L; e += kThreads) {
    const int j = e / L, k = e % L;
    const int l = logit_of<PX>(k);
    w1s[j * lay.ldw1 + k] = __float2bfloat16_rn(w1t[j * L + l]);
    w2s[k * lay.ldw2 + j] = __float2bfloat16_rn(w2[j * L + l]);
  }
  for (int e = tid; e < Hd; e += kThreads) b1s[e] = b1[e];
  for (int e = tid; e < L; e += kThreads) b2s[e] = b2[e];
  for (int e = tid; e < kQB * L; e += kThreads) {
    const int b = q0 + e / L;
    qps[e] = b < B ? qp[static_cast<int64_t>(b) * L + e % L] : 0.f;
  }

  // The corpus column of item block ib: K2 reads block ib; K10 block ib % 8
  // of tile tile_ids[ib / 8], and -1 marks an out-of-range tile id.
  auto corpus_x0 = [&](int ib) -> int {
    if (tile_ids == nullptr) return ib * kTX;
    const int tile = tile_ids[ib / kTileBlocks];
    return (tile < 0 || tile >= Xp / kTileCols) ? -1
                                                : tile * kTileCols + (ib % kTileBlocks) * kTX;
  };
  // What cp.async stages of the 32 items from corpus column x0 into buffer
  // buf: bf16 tables, the item rows (PX * dP of them) and the gating partials
  // (rows in kappa order); int8 tables, their scales (the codes go through
  // `raw`, below).
  auto stage = [&](int x0, int buf) {
    if constexpr (kQuant) {
      stage_scales_async(cs, css + buf * PX * kTX, PX, Xp, x0);
      stage_scales_async(ps, pss + buf * kTX, 1, Xp, x0);
    } else {
      stage_rows_async(items, its + static_cast<size_t>(buf) * rows * kLdX, rows, Xp, x0);
      bf16* dip = ips + buf * L * kLdX;
      for (int e = tid; e < L * 4; e += kThreads) {
        const int k = e >> 2, c = e & 3;
        tc::cp_async16(dip + k * kLdX + c * 8,
                       ip + static_cast<int64_t>(logit_of<PX>(k)) * Xp + x0 + c * 8, true);
      }
    }
  };
  // int8 tables: the codes of the next block in registers, loaded while the
  // current block is scored and stored as bf16 after it.
  Int8Rows raw, raw_ip;
  auto load_codes = [&](int x0) {
    if constexpr (kQuant) {
      raw.load(items, Xp, x0, rows, [](int r) { return r; });
      raw_ip.load(ip, Xp, x0, L, [](int k) { return logit_of<PX>(k); });
    }
  };
  auto store_codes = [&](int buf) {
    if constexpr (kQuant) {
      raw.store(its + static_cast<size_t>(buf) * rows * kLdX, rows);
      raw_ip.store(ips + buf * L * kLdX, L);
    }
  };

  const int ig = warp & 1;        // the warp's 16 items: ig * 16 + [0, 16) of a block
  const int qg = warp >> 1;       // its 8 queries: qg * 8 + [0, 8) of the CTA's
  const int xl = ig * 16 + g;     // block-local items of lane rows g and g + 8: xl, xl + 8
  int ib = blockIdx.y;
  int x0 = ib < nib ? corpus_x0(ib) : -1;
  if (x0 >= 0) {
    stage(x0, 0);
    load_codes(x0);
    store_codes(0);
  }
  tc::cp_async_commit();
  int x0_next = ib + static_cast<int>(gridDim.y) < nib ? corpus_x0(ib + gridDim.y) : -1;
  if (x0_next >= 0) load_codes(x0_next);
  for (int i = 0; ib < nib; ++i, ib += gridDim.y) {
    const int buf = i & 1;
    if (x0_next >= 0) stage(x0_next, buf ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int xo = ib * kTX;  // the block's first output column
    if (x0 < 0) {             // K10, an out-of-range tile id: NaN columns
      for (int e = tid; e < kQB * kTX; e += kThreads) {
        const int b = q0 + e / kTX;
        if (b < B) out[static_cast<int64_t>(b) * Xo + xo + e % kTX] = NAN;
      }
    } else {
      const bf16* it = its + static_cast<size_t>(buf) * rows * kLdX;
      const bf16* ipb = ips + buf * L * kLdX;
      const float* csx = css + buf * PX * kTX + xl;
      const float* psx = pss + buf * kTX + xl;
      for (int pass = 0; pass < 4; ++pass) {
        const int qa = qg * 8 + pass * 2;  // CTA-local queries qa, qa + 1
        if (q0 + qa >= B) break;           // warp-uniform

        // 1. The logits of (items, 2 queries): the shared routine, then
        // (int8) times cs[m, x] and times 1/T.
        float lg[2][PX][4];
        tile_logits<PX>(it + ig * 16, qs + qa * kPQ * lay.ldq, lay.ldq, dP, lane, lg);
        scale_logits<kQuant, PX>(lg, csx, inv_t);

        float v[2][2];  // [query][row g, row g + 8]
        if constexpr (MODE == kMolNoCombine || MODE == kMolWriteOnly) {
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int m = 0; m < PX; ++m) {
              s0 += lg[s][m][0] + lg[s][m][1];
              s1 += lg[s][m][2] + lg[s][m][3];
            }
            s0 = quad_sum(s0);
            s1 = quad_sum(s1);
            if constexpr (MODE == kMolNoCombine) {
              v[s][0] = s0 / L;
              v[s][1] = s1 / L;
            } else {
              // writeonly: logit 0 (n = 0, m = 0: lane t = 0's c0 and c2), the
              // others kept live by a test on their sum that the compiler
              // cannot decide (all-ones bits: a NaN no sum of finite logits gives).
              const float l0 = __shfl_sync(0xffffffffu, lg[s][0][0], lane & ~3);
              const float l1 = __shfl_sync(0xffffffffu, lg[s][0][2], lane & ~3);
              v[s][0] = __float_as_uint(s0) == 0xffffffffu ? s0 : l0;
              v[s][1] = __float_as_uint(s1) == 0xffffffffu ? s1 : l1;
            }
          }
        } else {
          // 2. qi = bf16(silu(bf16(logits) @ W1 + b1)) @ W2, 16 hidden units
          // at a time, on the kappa axis of the logits' fragments.
          float qi[2][PX][4];
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int m = 0; m < PX; ++m)
#pragma unroll
              for (int e = 0; e < 4; ++e) qi[s][m][e] = 0.f;
          if constexpr (MODE != kMolNoMlp) {
            uint32_t la[2][L / 16][4];
#pragma unroll
            for (int s = 0; s < 2; ++s)
#pragma unroll
              for (int j = 0; j < L / 16; ++j) {
                la[s][j][0] = tc::pack_bf16(lg[s][2 * j][0], lg[s][2 * j][1]);
                la[s][j][1] = tc::pack_bf16(lg[s][2 * j][2], lg[s][2 * j][3]);
                la[s][j][2] = tc::pack_bf16(lg[s][2 * j + 1][0], lg[s][2 * j + 1][1]);
                la[s][j][3] = tc::pack_bf16(lg[s][2 * j + 1][2], lg[s][2 * j + 1][3]);
              }
            for (int c = 0; c < Hd / 16; ++c) {
              float h[2][2][4];
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                const float lo = b1s[c * 16 + nt * 8 + 2 * t];
                const float hi = b1s[c * 16 + nt * 8 + 2 * t + 1];
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                  h[s][nt][0] = lo;
                  h[s][nt][1] = hi;
                  h[s][nt][2] = lo;
                  h[s][nt][3] = hi;
                }
              }
#pragma unroll
              for (int j = 0; j < L / 16; ++j) {
                uint32_t bw[4];
                tc::ldsm_x4(w1s + (c * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * lay.ldw1 +
                                j * 16 + ((lane >> 3) & 1) * 8,
                            bw);
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                  tc::mma_bf16(h[s][0], la[s][j], bw[0], bw[1]);
                  tc::mma_bf16(h[s][1], la[s][j], bw[2], bw[3]);
                }
              }
              uint32_t ha[2][4];
#pragma unroll
              for (int s = 0; s < 2; ++s)
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                  ha[s][2 * nt] = tc::pack_bf16(silu_fast(h[s][nt][0]), silu_fast(h[s][nt][1]));
                  ha[s][2 * nt + 1] =
                      tc::pack_bf16(silu_fast(h[s][nt][2]), silu_fast(h[s][nt][3]));
                }
#pragma unroll
              for (int p = 0; p < PX / 2; ++p) {
                uint32_t bw[4];
                tc::ldsm_x4(w2s + (p * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * lay.ldw2 +
                                c * 16 + ((lane >> 3) & 1) * 8,
                            bw);
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                  tc::mma_bf16(qi[s][2 * p], ha[s], bw[0], bw[1]);
                  tc::mma_bf16(qi[s][2 * p + 1], ha[s], bw[2], bw[3]);
                }
              }
            }
          }
          // 3. The gating combine of each pair, across the quad's lanes.
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const float* qpb = qps + (qa + s) * L;
            float gw[PX][4];
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int m = 0; m < PX; ++m)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int k = m * kPQ + 2 * t + (e & 1);
                const int l = logit_of<PX>(k);
                float ipv = __bfloat162float(ipb[k * kLdX + xl + (e >> 1) * 8]);
                if constexpr (kQuant) ipv *= psx[(e >> 1) * 8];   // code * ps[x]
                const float gi = fmaf(qpb[l], ipv, qi[s][m][e] + b2s[l]);
                gw[m][e] = MODE == kMolNoSilu ? gi : silu_fast(gi);
                mx[e >> 1] = fmaxf(mx[e >> 1], gw[m][e]);
              }
            mx[0] = quad_max(mx[0]);
            mx[1] = quad_max(mx[1]);
            float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
#pragma unroll
            for (int m = 0; m < PX; ++m)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float ev = MODE == kMolNoExp ? gw[m][e] : __expf(gw[m][e] - mx[e >> 1]);
                s1[e >> 1] = fmaf(ev, lg[s][m][e], s1[e >> 1]);
                s0[e >> 1] += ev;
              }
#pragma unroll
            for (int r = 0; r < 2; ++r) v[s][r] = quad_sum(s1[r]) / quad_sum(s0[r]);
          }
        }

#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int b = q0 + qa + s;
          if (tile_max != nullptr) {  // emit_blockmax: grid-uniform
            if (valid[x0 + xl] == 0.f) v[s][0] = kMasked;
            if (valid[x0 + xl + 8] == 0.f) v[s][1] = kMasked;
            float bmax = fmaxf(v[s][0], v[s][1]);
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
              bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
            if (lane == 0 && b < B) {
              atomic_max_float(tile_max + static_cast<int64_t>(b) * (Xp / kTileCols) +
                                   x0 / kTileCols,
                               bmax);
            }
          }
          if (b < B && t < 2) {  // lane t = 0 stores row g, t = 1 row g + 8
            out[static_cast<int64_t>(b) * Xo + xo + xl + t * 8] = t == 0 ? v[s][0] : v[s][1];
          }
        }
      }
    }
    // int8: the next block's codes into the free buffer, and the one after
    // into registers while the next is scored.
    const int x0_after = ib + 2 * static_cast<int>(gridDim.y) < nib
                             ? corpus_x0(ib + 2 * gridDim.y) : -1;
    if (x0_next >= 0) store_codes(buf ^ 1);
    if (x0_after >= 0) load_codes(x0_after);
    __syncthreads();
    x0 = x0_next;
    x0_next = x0_after;
  }
  tc::cp_async_wait<0>();
}

// K2 (tile_ids null, nt < 0) over all Xp columns, or K10 over the nt tiles of
// tile_ids; emit_blockmax when tile_max is set. One CTA per (32-query block,
// walker): the walkers split the item blocks, and the grid fills the card.
// cs and ps: an int8 table's scales (null for bf16).
template <typename S, int PX, int MODE = kMolFull>
cudaError_t launch(const void* q, const float* qp, const void* items, const void* ip,
                   const float* cs, const float* ps, const float* w1t, const float* b1,
                   const float* w2, const float* b2, const float* valid, float* out,
                   float* tile_max, const int* tile_ids, int nt, int B, int Xp, int dP, int Hd,
                   float inv_t, cudaStream_t stream) {
  if (!tc_ok(kPQ, PX, dP, Hd) || Xp % kTX != 0) return cudaErrorInvalidValue;
  if (kInt8<S> && (cs == nullptr || ps == nullptr)) return cudaErrorInvalidValue;
  const int xo = nt < 0 ? Xp : nt * kTileCols;
  if (xo == 0 || B == 0) return cudaSuccess;
  const int nib = xo / kTX;
  const size_t smem = Layout<PX>(dP, Hd, kInt8<S>).bytes;
  auto kernel = mol_tc_kernel<S, PX, MODE>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int nqb = (B + kQB - 1) / kQB;
  const int walkers = std::max(1, std::min(nib, std::max(1, per_sm) * sm_count() / nqb));
  kernel<<<dim3(nqb, walkers), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), qp, static_cast<const S*>(items), static_cast<const S*>(ip),
      cs, ps, w1t, b1, w2, b2, valid, out, tile_max, nt < 0 ? nullptr : tile_ids, nib, B, Xp,
      xo, dP, Hd, inv_t);
  return cudaGetLastError();
}

inline size_t smem_bytes(int px, int dP, int Hd, bool quant) {
  return px == 4 ? Layout<4>(dP, Hd, quant).bytes : Layout<8>(dP, Hd, quant).bytes;
}

}  // namespace moltc
}  // namespace
}  // namespace rails
