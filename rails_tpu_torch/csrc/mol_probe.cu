// The MoL scoring cost probe (P2), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel of rails_tpu/cli/mol_probe.py (`make_scorer`,
// body `_variant_kernel`): K2's scoring chain at the probe's geometry and
// types -- MoL 8x4x128, H = 128, bf16 queries, item table and item gating
// partial, f32 query gating partial, the qi MLP in bf16 -- with a `mode`
// that drops one stage:
//   full       logits, qi MLP, gating combine, the (B, X) write;
//   nosilu     gw = gi (no SiLU on the gating);
//   noexp      e = gw (no exp, no max);
//   nomlp      qi = b2 (no MLP products, no SiLU of the hidden layer);
//   nocombine  out = mean over l of the logits;
//   writeonly  out = logit 0, every logit still computed.
// Each mode is K2's own kernel (mol_scoring.cuh) instantiated with its MODE
// template argument, so a mode's device time, subtracted from full's, prices
// a stage of K2 itself. These instances live in this file alone: K2's and
// K10's builds do not change. The kernel takes K2's n-major logit order
// (l = n * P_X + m); the wrapper puts the probe's m-major arrays into it
// once at set-up. No valid mask, no blockmax, no tile list.
// Bound: as K2, FP32 FMA issue on the CUDA cores (per pair 2 L d_P FMAs for
// the logits and 2 L H for the MLP); the (B, X) f32 write is 4 B per pair.
#include "mol_scoring.cuh"

namespace rails {
namespace {

using bf16 = __nv_bfloat16;
constexpr int PQ = 8, PX = 4;

template <int MODE>
cudaError_t launch(const void* q, const float* qp, const void* items, const void* ip,
                   const float* w1t, const float* b1, const float* w2, const float* b2,
                   float* out, int B, int Xp, int dP, int Hd, float inv_t, cudaStream_t s) {
  const size_t smem = smem_bytes<bf16, PQ, PX>(dP, Hd);
  cudaError_t err = allow_smem(mol_scores_kernel<bf16, PQ, PX, MODE>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Xp / kTileX, (B + kQueriesPerBlock - 1) / kQueriesPerBlock);
  mol_scores_kernel<bf16, PQ, PX, MODE><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), qp, static_cast<const bf16*>(items),
      static_cast<const bf16*>(ip), nullptr, nullptr, w1t, b1, w2, b2, nullptr, out, nullptr,
      nullptr, B, Xp, Xp, dP, Hd, inv_t);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rails

// mode: 0 full, 1 nosilu, 2 noexp, 3 nomlp, 4 nocombine, 5 writeonly.
// q (B, 8, dP) bf16; qp (B, 32) f32; items (4, dP, Xp) bf16; ip (32, Xp) bf16;
// w1t (H, 32) and w2 (H, 32) f32 holding bf16 values; b1 (H), b2 (32) f32;
// out (B, Xp) f32. Logit order l = n * 4 + m, as K2's. Xp a multiple of 32.
extern "C" int rails_mol_probe(int mode, const void* q, const float* qp, const void* items,
                               const void* ip, const float* w1t, const float* b1,
                               const float* w2, const float* b2, float* out, int B, int Xp,
                               int dP, int Hd, float inv_t, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (Xp % rails::kTileX != 0) return cudaErrorInvalidValue;
  if (Xp == 0 || B == 0) return cudaSuccess;
  switch (mode) {
    case rails::kMolFull:
      return rails::launch<rails::kMolFull>(q, qp, items, ip, w1t, b1, w2, b2, out, B, Xp, dP,
                                            Hd, inv_t, s);
    case rails::kMolNoSilu:
      return rails::launch<rails::kMolNoSilu>(q, qp, items, ip, w1t, b1, w2, b2, out, B, Xp,
                                              dP, Hd, inv_t, s);
    case rails::kMolNoExp:
      return rails::launch<rails::kMolNoExp>(q, qp, items, ip, w1t, b1, w2, b2, out, B, Xp, dP,
                                             Hd, inv_t, s);
    case rails::kMolNoMlp:
      return rails::launch<rails::kMolNoMlp>(q, qp, items, ip, w1t, b1, w2, b2, out, B, Xp, dP,
                                             Hd, inv_t, s);
    case rails::kMolNoCombine:
      return rails::launch<rails::kMolNoCombine>(q, qp, items, ip, w1t, b1, w2, b2, out, B, Xp,
                                                 dP, Hd, inv_t, s);
    case rails::kMolWriteOnly:
      return rails::launch<rails::kMolWriteOnly>(q, qp, items, ip, w1t, b1, w2, b2, out, B, Xp,
                                                 dP, Hd, inv_t, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" size_t rails_mol_probe_smem_bytes(int dP, int Hd) {
  return rails::smem_bytes<rails::bf16, rails::PQ, rails::PX>(dP, Hd);
}
