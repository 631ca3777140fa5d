// K2's CUDA-core scoring kernel, shared by K2 and K10 (mol_scoring.cu, whose
// note says what it computes, how it is laid out and what bounds it) and by
// the cost probe P2 (mol_probe.cu), for f32 tables and the geometries the
// tensor-core kernel (mol_scoring_tc.cuh) does not take. MODE
// drops one stage of the chain for the probe; its default, kMolFull, is K2's
// and K10's kernel.
#pragma once

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace rails {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileX = 32;            // items per block, one per lane
constexpr int kQueriesPerBlock = 32;  // each warp scores kQueriesPerBlock / kWarps queries
constexpr int kTileCols = 256;        // K10's corpus tile, and emit_blockmax's
constexpr int kBlocksPerTile = kTileCols / kTileX;
constexpr float kMasked = -1.0e30f;   // score of a column with valid[x] == 0

// Stages the kernel runs. K2 and K10 are kMolFull; the cost probe P2
// (mol_probe.cu, the only file that instantiates the others) drops one:
enum MolMode {
  kMolFull = 0,       // logits, qi MLP, gating combine
  kMolNoSilu = 1,     // gw = gi
  kMolNoExp = 2,      // e = gw
  kMolNoMlp = 3,      // qi = b2
  kMolNoCombine = 4,  // out = mean over l of the logits
  kMolWriteOnly = 5,  // out = logit 0, every logit computed
};

template <typename S, int PQ, int PX>
size_t smem_bytes(int dP, int Hd) {
  constexpr int L = PQ * PX;
  constexpr int kScales = TableTraits<S>::kQuant ? PX * kTileX : 0;
  return (2 * static_cast<size_t>(Hd) * L + Hd + L + static_cast<size_t>(kWarps) * PQ * dP +
          L * kTileX + kScales) * sizeof(float) +
         static_cast<size_t>(PX) * dP * kTileX * sizeof(S);
}

template <typename S, int PQ, int PX, int MODE = kMolFull>
__global__ void __launch_bounds__(kThreads)
mol_scores_kernel(const typename TableTraits<S>::Round* __restrict__ q,
                  const float* __restrict__ qp, const S* __restrict__ items,
                  const S* __restrict__ ip, const float* __restrict__ cs,
                  const float* __restrict__ ps, const float* __restrict__ w1t,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ valid,
                  float* __restrict__ out, float* __restrict__ tile_max,
                  const int* __restrict__ tile_ids, int B, int Xp, int Xo, int dP, int Hd,
                  float inv_t) {
  using Q = typename TableTraits<S>::Round;
  constexpr bool kQuant = TableTraits<S>::kQuant;
  constexpr int L = PQ * PX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w1s = reinterpret_cast<float*>(smem_raw);  // [Hd][L]  W1 transposed
  float* w2s = w1s + Hd * L;                        // [Hd][L]
  float* b1s = w2s + Hd * L;                        // [Hd]
  float* b2s = b1s + Hd;                            // [L]
  float* qs = b2s + L;                              // [kWarps][PQ * dP]
  float* ips = qs + kWarps * PQ * dP;               // [L][kTileX] item gating partials
  float* css = ips + L * kTileX;                    // [PX][kTileX] int8 scales
  S* its = reinterpret_cast<S*>(css + (kQuant ? PX * kTileX : 0));  // [PX * dP][kTileX]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // K2 (tile_ids == nullptr): corpus block blockIdx.x, written in place.
  // K10: corpus tile tile_ids[blockIdx.x / 8], written at output block blockIdx.x.
  int x0 = blockIdx.x * kTileX;
  const int xo = blockIdx.x * kTileX + lane;
  if (tile_ids != nullptr) {
    const int t = tile_ids[blockIdx.x / kBlocksPerTile];
    if (t < 0 || t >= Xp / kTileCols) {  // block-uniform
      for (int e = tid; e < kQueriesPerBlock * kTileX; e += kThreads) {
        const int b = blockIdx.y * kQueriesPerBlock + e / kTileX;
        if (b < B) out[static_cast<int64_t>(b) * Xo + blockIdx.x * kTileX + e % kTileX] = NAN;
      }
      return;
    }
    x0 = t * kTileCols + (blockIdx.x % kBlocksPerTile) * kTileX;
  }
  const int x = x0 + lane;
  for (int e = tid; e < Hd * L; e += kThreads) {
    w1s[e] = w1t[e];
    w2s[e] = w2[e];
  }
  for (int e = tid; e < Hd; e += kThreads) b1s[e] = b1[e];
  for (int e = tid; e < L; e += kThreads) b2s[e] = b2[e];
  for (int e = tid; e < PX * dP * kTileX; e += kThreads) {
    const int r = e / kTileX, c = e % kTileX;
    its[e] = items[static_cast<int64_t>(r) * Xp + x0 + c];
  }
  if constexpr (kQuant) {
    for (int e = tid; e < PX * kTileX; e += kThreads) {
      css[e] = cs[static_cast<int64_t>(e / kTileX) * Xp + x0 + e % kTileX];
    }
  }
  for (int e = tid; e < L * kTileX; e += kThreads) {
    const int c = e % kTileX;
    const float v = to_f<S>(ip[static_cast<int64_t>(e / kTileX) * Xp + x0 + c]);
    ips[e] = kQuant ? v * ps[x0 + c] : v;
  }
  __syncthreads();
  float csv[PX];
#pragma unroll
  for (int m = 0; m < PX; ++m) csv[m] = kQuant ? css[m * kTileX + lane] : 1.f;

  float* qw = qs + warp * PQ * dP;
  for (int qi = warp; qi < kQueriesPerBlock; qi += kWarps) {
    const int b = blockIdx.y * kQueriesPerBlock + qi;
    if (b >= B) break;  // warp-uniform
    for (int e = lane; e < PQ * dP; e += 32) qw[e] = to_f<Q>(q[static_cast<int64_t>(b) * PQ * dP + e]);
    __syncwarp();

    float lg[L];
#pragma unroll
    for (int l = 0; l < L; ++l) lg[l] = 0.f;
    for (int k = 0; k < dP; ++k) {
      float iv[PX];
#pragma unroll
      for (int m = 0; m < PX; ++m) iv[m] = to_f<S>(its[(m * dP + k) * kTileX + lane]);
#pragma unroll
      for (int nq = 0; nq < PQ; ++nq) {
        const float qv = qw[nq * dP + k];
#pragma unroll
        for (int m = 0; m < PX; ++m) lg[nq * PX + m] = fmaf(qv, iv[m], lg[nq * PX + m]);
      }
    }
    float v;
    if constexpr (MODE == kMolNoCombine || MODE == kMolWriteOnly) {
      float s = 0.f;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if constexpr (kQuant) lg[l] *= csv[l % PX];
        lg[l] *= inv_t;
        s += lg[l];
      }
      // writeonly: logit 0, the others kept live by a test on their sum that
      // the compiler cannot decide (all-ones bits: a NaN no sum of finite
      // logits gives), as the probe's logits matmul computes them all.
      v = MODE == kMolNoCombine ? s / L : (__float_as_uint(s) == 0xffffffffu ? s : lg[0]);
    } else {
      float mi[L], acc[L];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if constexpr (kQuant) lg[l] *= csv[l % PX];
        lg[l] *= inv_t;
        mi[l] = round_to<Q>(lg[l]);
        acc[l] = 0.f;
      }
      if constexpr (MODE != kMolNoMlp) {
        for (int j = 0; j < Hd; ++j) {
          const float* w1r = w1s + j * L;
          float h = 0.f;
#pragma unroll
          for (int l = 0; l < L; ++l) h = fmaf(w1r[l], mi[l], h);
          h = round_to<Q>(silu(h + b1s[j]));
          const float* w2r = w2s + j * L;
#pragma unroll
          for (int l = 0; l < L; ++l) acc[l] = fmaf(w2r[l], h, acc[l]);
        }
      }
      const float* qpb = qp + static_cast<int64_t>(b) * L;
      float gmax = -INFINITY;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float gi = fmaf(qpb[l], ips[l * kTileX + lane], acc[l] + b2s[l]);
        acc[l] = MODE == kMolNoSilu ? gi : silu(gi);
        gmax = fmaxf(gmax, acc[l]);
      }
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float e = MODE == kMolNoExp ? acc[l] : expf(acc[l] - gmax);
        s1 = fmaf(e, lg[l], s1);
        s0 += e;
      }
      v = s1 / s0;
    }
    if (tile_max != nullptr) {  // emit_blockmax: grid-uniform
      if (valid[x] == 0.f) v = kMasked;
      const float bmax = warp_max(v);
      if (lane == 0) {
        atomic_max_float(tile_max + static_cast<int64_t>(b) * (Xp / kTileCols) + x0 / kTileCols,
                         bmax);
      }
    }
    out[static_cast<int64_t>(b) * Xo + xo] = v;
    __syncwarp();
  }
}

}  // namespace
}  // namespace rails
