// Fused Mixture-of-Logits corpus scoring (K2) and tile scoring (K10), hand-written
// for Hopper (sm_90a).
//
// K2 replaces the Pallas kernel `fused_mol_scores_t` in
// rails_tpu/ops/pallas/mol_scoring.py (body `_kernel`), with its int8 tables
// and its emit_blockmax option. K10 replaces `fused_mol_scores_tiles`: the
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
// int8 tables (TableTraits<int8_t>, common.cuh): the query is bf16, the codes
// convert exactly, and the per-(component, item) scale cs[m, x] multiplies each
// raw dot product before 1/T, raw * cs * (1/T) in that order, as in JAX; the
// gating partial is ip[l, x] * ps[x]; the MLP rounds to bf16.
// emit_blockmax (tile_max != nullptr, K2 only): a column whose valid[x] is 0
// scores -1e30, and tile_max[b, t] is the max of the scores of 256-column tile
// t, reduced in-kernel: a warp-shuffle max over the items a warp scores, then
// a float atomic max (common.cuh) into a buffer the wrapper fills with -1e30.
// Max is order-independent, so the result is exact, and no pass reads the
// (B, X) scores back.
//
// Two routes, chosen by the wrapper (`tc_route` in ops/mol_scoring.py) and
// passed as `tc`; there is no fallback between them:
//   - bf16 and int8 tables at P_Q = 8, P_X in {4, 8} (ML-20M, ML-1M, Amazon
//     Books): the tensor-core kernel of mol_scoring_tc.cuh, whose note gives
//     its design and its per-pair counts (mma.sync for the logits, through
//     the routine K8 and K9 share (mol_tc_logits.cuh), and both MLP products;
//     bound by the MUFU results of its SiLUs and exps);
//   - f32 tables and synthetic-small's 4x2x16: the CUDA-core kernel of
//     mol_scoring.cuh. One block per (32-item corpus tile x 32-query tile);
//     lanes own items and warps own queries, so table reads, the item gating
//     partial and the (B, X) score stores are coalesced. The block stages the
//     item tile (and an int8 tile's P_X x 32 component scales), the tile's
//     L x 32 item gating partials, the qi-MLP weights (W1^T and W2, H x L
//     each) and one query per warp in shared memory. Per (query, item) pair a
//     thread keeps its L logits, their MLP-rounded copies and L qi
//     accumulators in registers and walks the hidden units one at a time,
//     h_j = silu(b1_j + sum_l W1[l, j] * logit_l), qi_l += W2[j, l] * h_j, so
//     the 128-wide hidden layer is never stored. The gating partials wait in
//     shared memory, not registers: at 8x8 (L = 64) the three per-pair arrays
//     already take 192 of the thread's 255 registers. Bound: per pair 2 L d_P
//     FMAs for the logits and 2 L H for the MLP (12k at 8x4x128, 18k at
//     8x8x32, H = 128) against a few bytes of table per pair once a tile is
//     staged, so it is bound by the FP32 FMA rate of the CUDA cores. Its int8
//     instances serve the widths the tensor-core kernel does not take.
#include <type_traits>

#include "mol_scoring.cuh"
#include "mol_scoring_tc.cuh"

namespace rails {
namespace {

// nt < 0: K2 over all Xp columns; nt >= 0: K10 over the nt tiles of tile_ids.
// tc: the tensor-core kernel (mol_scoring_tc.cuh), which bf16 and int8 tables
// at its geometries (moltc::tc_ok) must take and nothing else may; otherwise
// the CUDA-core kernel (mol_scoring.cuh). A tc that disagrees is refused.
template <typename S, int PQ, int PX>
cudaError_t launch(int tc, const void* q, const float* qp, const void* items, const void* ip,
                   const float* cs, const float* ps, const float* w1t, const float* b1,
                   const float* w2, const float* b2, const float* valid, float* out,
                   float* tile_max, const int* tile_ids, int nt, int B, int Xp, int dP, int Hd,
                   float inv_t, cudaStream_t stream) {
  const bool blockmax = tile_max != nullptr;
  if (Xp % kTileX != 0 || ((nt >= 0 || blockmax) && Xp % kTileCols != 0)) {
    return cudaErrorInvalidValue;
  }
  if ((TableTraits<S>::kQuant && (cs == nullptr || ps == nullptr)) ||
      (blockmax && (nt >= 0 || valid == nullptr))) {
    return cudaErrorInvalidValue;
  }
  constexpr bool kTcType = std::is_same_v<S, __nv_bfloat16> || std::is_same_v<S, int8_t>;
  if ((tc != 0) != (kTcType && moltc::tc_ok(PQ, PX, dP, Hd))) return cudaErrorInvalidValue;
  if (tc) {
    if constexpr (kTcType && PQ == moltc::kPQ && PX != 2) {
      return moltc::launch<S, PX>(q, qp, items, ip, cs, ps, w1t, b1, w2, b2, valid, out,
                                  tile_max, tile_ids, nt, B, Xp, dP, Hd, inv_t, stream);
    }
    return cudaErrorInvalidValue;
  }
  const int xo = nt < 0 ? Xp : nt * kTileCols;
  if (xo == 0) return cudaSuccess;
  const size_t smem = smem_bytes<S, PQ, PX>(dP, Hd);
  cudaError_t err = allow_smem(mol_scores_kernel<S, PQ, PX>, smem);
  if (err != cudaSuccess) return err;
  using Q = typename TableTraits<S>::Round;
  const dim3 grid(xo / kTileX, (B + kQueriesPerBlock - 1) / kQueriesPerBlock);
  mol_scores_kernel<S, PQ, PX><<<grid, kThreads, smem, stream>>>(
      static_cast<const Q*>(q), qp, static_cast<const S*>(items), static_cast<const S*>(ip), cs,
      ps, w1t, b1, w2, b2, valid, out, tile_max, nt < 0 ? nullptr : tile_ids, B, Xp, xo, dP, Hd,
      inv_t);
  return cudaGetLastError();
}

template <typename S>
cudaError_t dispatch(int tc, int pq, int px, const void* q, const float* qp, const void* items,
                     const void* ip, const float* cs, const float* ps, const float* w1t,
                     const float* b1, const float* w2, const float* b2, const float* valid,
                     float* out, float* tile_max, const int* tile_ids, int nt, int B, int Xp,
                     int dP, int Hd, float inv_t, cudaStream_t s) {
  if (pq == 8 && px == 4)
    return launch<S, 8, 4>(tc, q, qp, items, ip, cs, ps, w1t, b1, w2, b2, valid, out, tile_max,
                           tile_ids, nt, B, Xp, dP, Hd, inv_t, s);
  if (pq == 4 && px == 2)
    return launch<S, 4, 2>(tc, q, qp, items, ip, cs, ps, w1t, b1, w2, b2, valid, out, tile_max,
                           tile_ids, nt, B, Xp, dP, Hd, inv_t, s);
  if (pq == 8 && px == 8)
    return launch<S, 8, 8>(tc, q, qp, items, ip, cs, ps, w1t, b1, w2, b2, valid, out, tile_max,
                           tile_ids, nt, B, Xp, dP, Hd, inv_t, s);
  return cudaErrorInvalidValue;
}

int scores(int tc, int dtype, int pq, int px, const void* q, const float* qp, const void* items,
           const void* ip, const float* cs, const float* ps, const float* w1t, const float* b1,
           const float* w2, const float* b2, const float* valid, float* out, float* tile_max,
           const int* tile_ids, int nt, int B, int Xp, int dP, int Hd, float inv_t,
           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(tc, pq, px, q, qp, items, ip, cs, ps, w1t, b1, w2, b2, valid, out,
                             tile_max, tile_ids, nt, B, Xp, dP, Hd, inv_t, s);
    case 1:
      return dispatch<__nv_bfloat16>(tc, pq, px, q, qp, items, ip, cs, ps, w1t, b1, w2, b2, valid,
                                     out, tile_max, tile_ids, nt, B, Xp, dP, Hd, inv_t, s);
    case 2:
      return dispatch<int8_t>(tc, pq, px, q, qp, items, ip, cs, ps, w1t, b1, w2, b2, valid, out,
                              tile_max, tile_ids, nt, B, Xp, dP, Hd, inv_t, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int PQ, int PX>
size_t smem_for(int dtype, int dP, int Hd) {
  switch (dtype) {
    case 0: return smem_bytes<float, PQ, PX>(dP, Hd);
    case 1: return smem_bytes<__nv_bfloat16, PQ, PX>(dP, Hd);
    case 2: return smem_bytes<int8_t, PQ, PX>(dP, Hd);
    default: return 0;
  }
}

}  // namespace
}  // namespace rails

// tc: 1 for the tensor-core kernel, 0 for the CUDA-core kernel: 1 exactly for
// bf16 and int8 tables at the tensor-core geometries
// (ops/mol_scoring.py:tc_route), else cudaErrorInvalidValue.
// dtype: 0 = float32 (q, items and ip f32), 1 = bfloat16 (all bf16), 2 = int8
// (items and ip int8 with cs (PX, Xp) and ps (1, Xp) f32 scales; q bf16).
// q (B, PQ, dP); qp (B, L) f32; items (PX, dP, Xp); ip (L, Xp); w1t (H, L);
// b1 (H); w2 (H, L); b2 (L); out (B, Xp) f32. Logit order l = n*PX + m.
// cs and ps may be null for dtypes 0 and 1. emit_blockmax: tile_max (B, Xp / 256)
// f32 filled with -1e30 by the caller, valid (Xp) f32; both null otherwise.
extern "C" int rails_mol_scores(int tc, int dtype, int pq, int px, const void* q,
                                const float* qp, const void* items, const void* ip,
                                const float* cs, const float* ps, const float* w1t,
                                const float* b1, const float* w2, const float* b2,
                                const float* valid, float* out, float* tile_max, int B, int Xp,
                                int dP, int Hd, float inv_t, void* stream) {
  return rails::scores(tc, dtype, pq, px, q, qp, items, ip, cs, ps, w1t, b1, w2, b2, valid, out,
                       tile_max, nullptr, -1, B, Xp, dP, Hd, inv_t, stream);
}

// K10: as rails_mol_scores over the nt tiles listed in tile_ids (nt,) int32 on
// the device; Xp a multiple of 256; out (B, nt * 256) f32.
extern "C" int rails_mol_scores_tiles(int tc, int dtype, int pq, int px, const void* q,
                                      const float* qp, const int* tile_ids, const void* items,
                                      const void* ip, const float* cs, const float* ps,
                                      const float* w1t, const float* b1, const float* w2,
                                      const float* b2, float* out, int B, int Xp, int nt, int dP,
                                      int Hd, float inv_t, void* stream) {
  if (nt < 0) return cudaErrorInvalidValue;
  return rails::scores(tc, dtype, pq, px, q, qp, items, ip, cs, ps, w1t, b1, w2, b2, nullptr,
                       out, nullptr, tile_ids, nt, B, Xp, dP, Hd, inv_t, stream);
}

extern "C" size_t rails_mol_scores_smem_bytes(int tc, int dtype, int pq, int px, int dP,
                                              int Hd) {
  if (tc) {
    return (dtype == 1 || dtype == 2) && rails::moltc::tc_ok(pq, px, dP, Hd)
               ? rails::moltc::smem_bytes(px, dP, Hd, dtype == 2) : 0;
  }
  if (pq == 8 && px == 4) return rails::smem_for<8, 4>(dtype, dP, Hd);
  if (pq == 4 && px == 2) return rails::smem_for<4, 2>(dtype, dP, Hd);
  if (pq == 8 && px == 8) return rails::smem_for<8, 8>(dtype, dP, Hd);
  return 0;
}
