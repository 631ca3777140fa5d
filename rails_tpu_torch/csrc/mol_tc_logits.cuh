// The MoL component logits on the H100's tensor cores, one routine for every
// kernel that computes them: K2, K10 and the probe P2 (mol_tc_kernel,
// mol_scoring_tc.cuh) and the score bounds K8 and K9 (mol_bounds_tc_kernel,
// mol_bounds.cu), for bf16 and int8 tables at P_Q = 8, P_X in {4, 8}, d_P a
// multiple of 16 with P_X * d_P <= 512 (`bounds_tc_route` in
// ops/mol_scoring.py states the same rule; K2 adds its H rule, `tc_route`).
//
// The routine, `tile_logits`: A = an item tile (16 items x 16 of d_P, by
// ldmatrix.trans from the table's (P_X * d_P, items) rows staged in shared
// memory), B = one query's 8 components (d_P x 8 n); one n8 tile per item
// group m, an even number of queries a call. Lane (g, t) of the C fragment holds, for items
// g and g + 8, the logits of n = 2t, 2t+1 at every m. Each k16 step's product
// starts from zero and is added in f32 in ks order (see mol_scoring_tc.cuh for
// why). Scaling, `scale_logits`: an int8 table's raw dot times its item's
// component scale cs[m, x], then times 1/T, as JAX and the CUDA-core kernels
// order them (mol_scoring.cuh). Every caller runs these two on the same
// operands in the same roles, so the logits of a (query, item, l) are the same
// f32 value in all of them, and rounding is monotone (round(a c) <= round(b c)
// for a <= b, c > 0): K8's max over l, and K9's over a tile's items, are maxima
// of K2's logits bit for bit, whether a kernel scales each logit or only the
// maximum.
//
// int8 tables: cp.async copies bytes and cannot convert, so `Int8Rows` loads
// a block's int8 rows (32 items a row) into registers with 16-byte loads, one
// block ahead of the one being scored, and stores them converted to bf16
// (exact: |code| <= 127) into the bf16 tile layout that ldmatrix reads.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma_sync.cuh"

namespace rails {
namespace {
namespace moltc {

using bf16 = __nv_bfloat16;

constexpr int kPQ = 8;                          // query components: one n8 tile
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kTX = 32;                         // items per item block: two m16 groups
constexpr int kQB = 32;                         // queries a CTA owns
constexpr int kLdX = kTX + 8;                   // row stride of staged item rows (bf16)
constexpr int kTile = 256;                      // the corpus tile of K9, K10 and blockmax
constexpr int kTileBlocks = kTile / kTX;        // item blocks per tile
constexpr int kMaxRows = 512;                   // staged table rows: P_X * d_P <= 512
static_assert(kWarps == 2 * (kQB / 8), "a warp scores 16 items x 8 queries");

template <typename S>
constexpr bool kInt8 = std::is_same_v<S, int8_t>;

// The geometries the routine takes (ops/mol_scoring.py:bounds_tc_route).
inline bool logits_ok(int pq, int px, int dP) {
  return pq == kPQ && (px == 4 || px == 8) && dP >= 16 && dP % 16 == 0 && px * dP <= 512;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The kQB queries from q0 of q (B, 8, dP) into qs [kQB * 8][ldq], zeros past B.
__device__ __forceinline__ void stage_queries(const bf16* __restrict__ q, bf16* qs, int ldq,
                                              int q0, int B, int dP) {
  const int qchunks = dP / 8;
  for (int e = threadIdx.x; e < kQB * kPQ * qchunks; e += kThreads) {
    const int r = e / qchunks, c = e % qchunks;  // r = query * 8 + n
    const int b = q0 + r / kPQ;
    tc::cp_async16(qs + r * ldq + c * 8,
                   q + (static_cast<int64_t>(min(b, B - 1)) * kPQ + r % kPQ) * dP + c * 8,
                   b < B);
  }
}

// Columns [x0, x0 + 32) of `rows` bf16 table rows (row stride ld) into dst
// [rows][kLdX] by cp.async.
__device__ __forceinline__ void stage_rows_async(const bf16* __restrict__ src, bf16* dst,
                                                 int rows, int64_t ld, int x0) {
  for (int e = threadIdx.x; e < rows * 4; e += kThreads) {
    const int r = e >> 2, c = e & 3;
    tc::cp_async16(dst + r * kLdX + c * 8, src + r * ld + x0 + c * 8, true);
  }
}

// Columns [x0, x0 + 32) of `rows` f32 rows (row stride ld) into dst [rows][32]
// by cp.async: an int8 table's scales.
__device__ __forceinline__ void stage_scales_async(const float* __restrict__ src, float* dst,
                                                   int rows, int64_t ld, int x0) {
  for (int e = threadIdx.x; e < rows * 8; e += kThreads) {
    const int r = e >> 3, c = e & 7;
    tc::cp_async16(dst + r * kTX + c * 4, src + r * ld + x0 + c * 4, true);
  }
}

// Columns [x0, x0 + 32) of int8 table rows, two 16-byte chunks a row, held in
// registers between `load` and `store`. Row r of the block reads table row
// row_of(r); `store` writes it converted to bf16 as row r of a [rows][kLdX]
// tile. rows <= kMaxRows.
struct Int8Rows {
  static constexpr int kChunks = 2 * kMaxRows / kThreads;   // 16-byte chunks a thread holds
  int4 v[kChunks];

  template <typename RowOf>
  __device__ __forceinline__ void load(const int8_t* __restrict__ src, int64_t ld, int x0,
                                       int rows, RowOf row_of) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int e = threadIdx.x + j * kThreads;
      if (e < rows * 2) {
        v[j] = __ldg(reinterpret_cast<const int4*>(src + row_of(e >> 1) * ld + x0 +
                                                   (e & 1) * 16));
      }
    }
  }

  __device__ __forceinline__ void store(bf16* dst, int rows) const {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int e = threadIdx.x + j * kThreads;
      if (e < rows * 2) {
        const uint32_t w[4] = {static_cast<uint32_t>(v[j].x), static_cast<uint32_t>(v[j].y),
                               static_cast<uint32_t>(v[j].z), static_cast<uint32_t>(v[j].w)};
        uint32_t o[8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float lo = static_cast<float>(static_cast<int8_t>(w[i] >> (16 * h)));
            const float hi = static_cast<float>(static_cast<int8_t>(w[i] >> (16 * h + 8)));
            o[2 * i + h] = tc::pack_bf16(lo, hi);   // exact: |code| <= 127
          }
        uint4* d = reinterpret_cast<uint4*>(dst + (e >> 1) * kLdX + (e & 1) * 16);
        d[0] = make_uint4(o[0], o[1], o[2], o[3]);
        d[1] = make_uint4(o[4], o[5], o[6], o[7]);
      }
    }
  }
};

// The raw component logits lg[s][m][e] of 16 items x NQ queries (NQ even):
// `it` is the item tile (P_X * dP rows of kLdX, offset to the warp's 16
// items), `qrows` the first of the NQ queries' 8 component rows of stride
// ldq. Each A fragment (an item tile's k16 step of group m) feeds the NQ
// queries' products; every logit's arithmetic is the same for any NQ.
template <int PX, int NQ = 2>
__device__ __forceinline__ void tile_logits(const bf16* it, const bf16* qrows, int ldq, int dP,
                                            int lane, float (&lg)[NQ][PX][4]) {
  static_assert(NQ % 2 == 0, "queries come in pairs: one ldmatrix.x4 holds two");
#pragma unroll
  for (int s = 0; s < NQ; ++s)
#pragma unroll
    for (int m = 0; m < PX; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) lg[s][m][e] = 0.f;
  for (int ks = 0; ks < dP / 16; ++ks) {
    uint32_t bq[NQ / 2][4];
#pragma unroll
    for (int p = 0; p < NQ / 2; ++p) {
      tc::ldsm_x4(qrows + ((2 * p + (lane >> 4)) * kPQ + (lane & 7)) * ldq + ks * 16 +
                      ((lane >> 3) & 1) * 8,
                  bq[p]);
    }
#pragma unroll
    for (int m = 0; m < PX; ++m) {
      uint32_t a[4];
      tc::ldsm_x4_t(it + (m * dP + ks * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * kLdX +
                        ((lane >> 3) & 1) * 8,
                    a);
#pragma unroll
      for (int p = 0; p < NQ / 2; ++p) {
        // Each k16 step's product from zero, added in f32 (round to nearest):
        // the mma's own accumulation of lg is less accurate.
        float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
        tc::mma_bf16(p0, a, bq[p][0], bq[p][1]);
        tc::mma_bf16(p1, a, bq[p][2], bq[p][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lg[2 * p][m][e] += p0[e];
          lg[2 * p + 1][m][e] += p1[e];
        }
      }
    }
  }
}

// The logits as K2 uses them: raw * cs[m, x] (int8 tables; csx points at the
// lane's item g of a [P_X][32] scale tile, row g + 8 at csx + 8), then * 1/T.
template <bool kQuant, int PX>
__device__ __forceinline__ void scale_logits(float (&lg)[2][PX][4], const float* csx,
                                             float inv_t) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int m = 0; m < PX; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kQuant) lg[s][m][e] *= csx[m * kTX + (e >> 1) * 8];
        lg[s][m][e] *= inv_t;
      }
}

}  // namespace moltc
}  // namespace
}  // namespace rails
