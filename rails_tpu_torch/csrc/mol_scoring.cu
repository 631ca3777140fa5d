// Fused Mixture-of-Logits corpus scoring (K2) and tile scoring (K10), hand-written
// for Hopper (sm_90a).
//
// K2 replaces the Pallas kernel `fused_mol_scores_t` in
// rails_tpu/ops/pallas/mol_scoring.py (body `_kernel`), without its
// emit_blockmax and int8 options. K10 replaces `fused_mol_scores_tiles`: the
// same kernel, whose corpus blocks read their 256-item tile from a list of
// tile ids on the device (8 blocks of 32 items per tile), writing output
// column s*256 + j for corpus column tile_ids[s]*256 + j. Sharing the code
// makes K10's columns bit-equal to K2's columns of the same tiles. An
// out-of-range tile id fills its output columns with NaN and reads nothing.
// For every (query b, item x):
//   logits[l = n*P_X + m] = <q[b, n], item[x, m]> / T
//   qi   = W2^T silu(W1^T logits + b1) + b2          (gating qi MLP, L -> H -> L)
//   gi   = qp[b] * ip[x] + qi;  gw = silu(gi)       ("glu_silu" combination)
//   out  = sum_l softmax_l(gw) * logits            (normalised once: sum e*l / sum e)
// With bf16 tables the MLP inputs are rounded to bf16 where the JAX kernel
// casts them (logits, h, W1, W2); everything accumulates in f32.
//
// Layout: one block per (32-item corpus tile x 32-query tile). Lanes own
// items and warps own queries, so table reads, the item gating partial and
// the (B, X) score stores are coalesced. The block stages the item tile, the
// qi-MLP weights (W1^T and W2, H x L each) and one query per warp in shared
// memory. Per (query, item) pair a thread keeps 32 logits and 32 qi
// accumulators in registers and walks the hidden units one at a time,
// h_j = silu(b1_j + sum_l W1[l, j] * logit_l), qi_l += W2[j, l] * h_j, so the
// 128-wide hidden layer is never stored anywhere.
// Bound: ~12k FMAs per pair (4k for the logits, 8k for the MLP) against a few
// bytes of table per pair once a tile is staged, so the kernel is bound by
// FP32 FMA issue on the CUDA cores; the tensor cores are unused (later work).
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace rails {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileX = 32;            // items per block, one per lane
constexpr int kQueriesPerBlock = 32;  // each warp scores kQueriesPerBlock / kWarps queries
constexpr int kTileCols = 256;        // K10's corpus tile
constexpr int kBlocksPerTile = kTileCols / kTileX;

template <typename T, int PQ, int PX>
size_t smem_bytes(int dP, int Hd) {
  constexpr int L = PQ * PX;
  return (2 * static_cast<size_t>(Hd) * L + Hd + L + static_cast<size_t>(kWarps) * PQ * dP) *
             sizeof(float) +
         static_cast<size_t>(PX) * dP * kTileX * sizeof(T);
}

template <typename T, int PQ, int PX>
__global__ void __launch_bounds__(kThreads)
mol_scores_kernel(const T* __restrict__ q, const float* __restrict__ qp,
                  const T* __restrict__ items, const T* __restrict__ ip,
                  const float* __restrict__ w1t, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  float* __restrict__ out, const int* __restrict__ tile_ids, int B, int Xp,
                  int Xo, int dP, int Hd, float inv_t) {
  constexpr int L = PQ * PX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w1s = reinterpret_cast<float*>(smem_raw);  // [Hd][L]  W1 transposed
  float* w2s = w1s + Hd * L;                        // [Hd][L]
  float* b1s = w2s + Hd * L;                        // [Hd]
  float* b2s = b1s + Hd;                            // [L]
  float* qs = b2s + L;                              // [kWarps][PQ * dP]
  T* its = reinterpret_cast<T*>(qs + kWarps * PQ * dP);  // [PX * dP][kTileX]

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
  float ipv[L];
#pragma unroll
  for (int l = 0; l < L; ++l) ipv[l] = to_f<T>(ip[static_cast<int64_t>(l) * Xp + x]);
  __syncthreads();

  float* qw = qs + warp * PQ * dP;
  for (int qi = warp; qi < kQueriesPerBlock; qi += kWarps) {
    const int b = blockIdx.y * kQueriesPerBlock + qi;
    if (b >= B) break;  // warp-uniform
    for (int e = lane; e < PQ * dP; e += 32) qw[e] = to_f<T>(q[static_cast<int64_t>(b) * PQ * dP + e]);
    __syncwarp();

    float lg[L];
#pragma unroll
    for (int l = 0; l < L; ++l) lg[l] = 0.f;
    for (int k = 0; k < dP; ++k) {
      float iv[PX];
#pragma unroll
      for (int m = 0; m < PX; ++m) iv[m] = to_f<T>(its[(m * dP + k) * kTileX + lane]);
#pragma unroll
      for (int nq = 0; nq < PQ; ++nq) {
        const float qv = qw[nq * dP + k];
#pragma unroll
        for (int m = 0; m < PX; ++m) lg[nq * PX + m] = fmaf(qv, iv[m], lg[nq * PX + m]);
      }
    }
    float mi[L], acc[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      lg[l] *= inv_t;
      mi[l] = round_to<T>(lg[l]);
      acc[l] = 0.f;
    }
    for (int j = 0; j < Hd; ++j) {
      const float* w1r = w1s + j * L;
      float h = 0.f;
#pragma unroll
      for (int l = 0; l < L; ++l) h = fmaf(w1r[l], mi[l], h);
      h = round_to<T>(silu(h + b1s[j]));
      const float* w2r = w2s + j * L;
#pragma unroll
      for (int l = 0; l < L; ++l) acc[l] = fmaf(w2r[l], h, acc[l]);
    }
    const float* qpb = qp + static_cast<int64_t>(b) * L;
    float gmax = -INFINITY;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float gi = fmaf(qpb[l], ipv[l], acc[l] + b2s[l]);
      acc[l] = silu(gi);
      gmax = fmaxf(gmax, acc[l]);
    }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float e = expf(acc[l] - gmax);
      s1 = fmaf(e, lg[l], s1);
      s0 += e;
    }
    out[static_cast<int64_t>(b) * Xo + xo] = s1 / s0;
    __syncwarp();
  }
}

// nt < 0: K2 over all Xp columns; nt >= 0: K10 over the nt tiles of tile_ids.
template <typename T, int PQ, int PX>
cudaError_t launch(const void* q, const float* qp, const void* items, const void* ip,
                   const float* w1t, const float* b1, const float* w2, const float* b2,
                   float* out, const int* tile_ids, int nt, int B, int Xp, int dP, int Hd,
                   float inv_t, cudaStream_t stream) {
  if (Xp % kTileX != 0 || (nt >= 0 && Xp % kTileCols != 0)) return cudaErrorInvalidValue;
  const int xo = nt < 0 ? Xp : nt * kTileCols;
  if (xo == 0) return cudaSuccess;
  const size_t smem = smem_bytes<T, PQ, PX>(dP, Hd);
  cudaError_t err = allow_smem(mol_scores_kernel<T, PQ, PX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(xo / kTileX, (B + kQueriesPerBlock - 1) / kQueriesPerBlock);
  mol_scores_kernel<T, PQ, PX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), qp, static_cast<const T*>(items), static_cast<const T*>(ip), w1t,
      b1, w2, b2, out, nt < 0 ? nullptr : tile_ids, B, Xp, xo, dP, Hd, inv_t);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int pq, int px, const void* q, const float* qp, const void* items,
                     const void* ip, const float* w1t, const float* b1, const float* w2,
                     const float* b2, float* out, const int* tile_ids, int nt, int B, int Xp,
                     int dP, int Hd, float inv_t, cudaStream_t s) {
  if (pq == 8 && px == 4)
    return launch<T, 8, 4>(q, qp, items, ip, w1t, b1, w2, b2, out, tile_ids, nt, B, Xp, dP, Hd,
                           inv_t, s);
  if (pq == 4 && px == 2)
    return launch<T, 4, 2>(q, qp, items, ip, w1t, b1, w2, b2, out, tile_ids, nt, B, Xp, dP, Hd,
                           inv_t, s);
  return cudaErrorInvalidValue;
}

int scores(int dtype, int pq, int px, const void* q, const float* qp, const void* items,
           const void* ip, const float* w1t, const float* b1, const float* w2, const float* b2,
           float* out, const int* tile_ids, int nt, int B, int Xp, int dP, int Hd, float inv_t,
           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(pq, px, q, qp, items, ip, w1t, b1, w2, b2, out, tile_ids, nt,
                                   B, Xp, dP, Hd, inv_t, s);
  }
  if (dtype == 0) {
    return dispatch<float>(pq, px, q, qp, items, ip, w1t, b1, w2, b2, out, tile_ids, nt, B, Xp,
                           dP, Hd, inv_t, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace rails

// dtype: 0 = float32, 1 = bfloat16 (q, items and ip share it).
// q (B, PQ, dP); qp (B, L) f32; items (PX, dP, Xp); ip (L, Xp); w1t (H, L);
// b1 (H); w2 (H, L); b2 (L); out (B, Xp) f32. Logit order l = n*PX + m.
extern "C" int rails_mol_scores(int dtype, int pq, int px, const void* q, const float* qp,
                                const void* items, const void* ip, const float* w1t,
                                const float* b1, const float* w2, const float* b2, float* out,
                                int B, int Xp, int dP, int Hd, float inv_t, void* stream) {
  return rails::scores(dtype, pq, px, q, qp, items, ip, w1t, b1, w2, b2, out, nullptr, -1, B, Xp,
                       dP, Hd, inv_t, stream);
}

// K10: as rails_mol_scores over the nt tiles listed in tile_ids (nt,) int32 on
// the device; Xp a multiple of 256; out (B, nt * 256) f32.
extern "C" int rails_mol_scores_tiles(int dtype, int pq, int px, const void* q, const float* qp,
                                      const int* tile_ids, const void* items, const void* ip,
                                      const float* w1t, const float* b1, const float* w2,
                                      const float* b2, float* out, int B, int Xp, int nt, int dP,
                                      int Hd, float inv_t, void* stream) {
  if (nt < 0) return cudaErrorInvalidValue;
  return rails::scores(dtype, pq, px, q, qp, items, ip, w1t, b1, w2, b2, out, tile_ids, nt, B,
                       Xp, dP, Hd, inv_t, stream);
}

extern "C" size_t rails_mol_scores_smem_bytes(int dtype, int pq, int px, int dP, int Hd) {
  if (pq == 8 && px == 4)
    return dtype == 1 ? rails::smem_bytes<__nv_bfloat16, 8, 4>(dP, Hd)
                      : rails::smem_bytes<float, 8, 4>(dP, Hd);
  if (pq == 4 && px == 2)
    return dtype == 1 ? rails::smem_bytes<__nv_bfloat16, 4, 2>(dP, Hd)
                      : rails::smem_bytes<float, 4, 2>(dP, Hd);
  return 0;
}
