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
// Each mode is K2's own kernel instantiated with its MODE template argument
// -- the tensor-core kernel (mol_scoring_tc.cuh) at the widths `tc_route`
// takes, the probe's 8x4x128 with H = 128 among them, and the CUDA-core
// kernel (mol_scoring.cuh) at others -- so a mode's device time, subtracted
// from full's, prices a stage of K2 itself. These instances live in this
// file alone: K2's and K10's builds do not change. The kernel takes K2's
// n-major logit order (l = n * P_X + m); the wrapper puts the probe's m-major
// arrays into it once at set-up. No valid mask, no blockmax, no tile list.
// Bound: as K2's (mol_scoring_tc.cuh): the MUFU results of the SiLUs and
// exps a mode keeps; nocombine and writeonly, the logits' products and the
// (B, X) f32 write, 4 B per pair.
#include "mol_scoring.cuh"
#include "mol_scoring_tc.cuh"

namespace rails {
namespace {

using bf16 = __nv_bfloat16;
constexpr int PQ = 8, PX = 4;

// tc: the tensor-core kernel (mol_scoring_tc.cuh), which its widths must take
// and no other may; otherwise the CUDA-core kernel (mol_scoring.cuh). A tc
// that disagrees is refused.
template <int MODE>
cudaError_t launch(int tc, const void* q, const float* qp, const void* items, const void* ip,
                   const float* w1t, const float* b1, const float* w2, const float* b2,
                   float* out, int B, int Xp, int dP, int Hd, float inv_t, cudaStream_t s) {
  if ((tc != 0) != moltc::tc_ok(PQ, PX, dP, Hd)) return cudaErrorInvalidValue;
  if (tc) {
    return moltc::launch<bf16, PX, MODE>(q, qp, items, ip, nullptr, nullptr, w1t, b1, w2, b2,
                                         nullptr, out, nullptr, nullptr, -1, B, Xp, dP, Hd,
                                         inv_t, s);
  }
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

// tc: 1 for the tensor-core kernel, 0 for the CUDA-core one: 1 exactly at the
// tensor-core widths (ops/mol_scoring.py:tc_route), else cudaErrorInvalidValue.
// mode: 0 full, 1 nosilu, 2 noexp, 3 nomlp, 4 nocombine, 5 writeonly.
// q (B, 8, dP) bf16; qp (B, 32) f32; items (4, dP, Xp) bf16; ip (32, Xp) bf16;
// w1t (H, 32) and w2 (H, 32) f32 holding bf16 values; b1 (H), b2 (32) f32;
// out (B, Xp) f32. Logit order l = n * 4 + m, as K2's. Xp a multiple of 32.
extern "C" int rails_mol_probe(int tc, int mode, const void* q, const float* qp,
                               const void* items, const void* ip, const float* w1t, const float* b1,
                               const float* w2, const float* b2, float* out, int B, int Xp,
                               int dP, int Hd, float inv_t, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (Xp % rails::kTileX != 0) return cudaErrorInvalidValue;
  if (Xp == 0 || B == 0) return cudaSuccess;
  switch (mode) {
    case rails::kMolFull:
      return rails::launch<rails::kMolFull>(tc, q, qp, items, ip, w1t, b1, w2, b2, out,
                                            B, Xp, dP, Hd, inv_t, s);
    case rails::kMolNoSilu:
      return rails::launch<rails::kMolNoSilu>(tc, q, qp, items, ip, w1t, b1, w2, b2, out,
                                              B, Xp, dP, Hd, inv_t, s);
    case rails::kMolNoExp:
      return rails::launch<rails::kMolNoExp>(tc, q, qp, items, ip, w1t, b1, w2, b2, out,
                                             B, Xp, dP, Hd, inv_t, s);
    case rails::kMolNoMlp:
      return rails::launch<rails::kMolNoMlp>(tc, q, qp, items, ip, w1t, b1, w2, b2, out,
                                             B, Xp, dP, Hd, inv_t, s);
    case rails::kMolNoCombine:
      return rails::launch<rails::kMolNoCombine>(tc, q, qp, items, ip, w1t, b1, w2, b2, out,
                                                 B, Xp, dP, Hd, inv_t, s);
    case rails::kMolWriteOnly:
      return rails::launch<rails::kMolWriteOnly>(tc, q, qp, items, ip, w1t, b1, w2, b2, out,
                                                 B, Xp, dP, Hd, inv_t, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" size_t rails_mol_probe_smem_bytes(int tc, int dP, int Hd) {
  if (tc) {
    return rails::moltc::tc_ok(rails::PQ, rails::PX, dP, Hd)
               ? rails::moltc::smem_bytes(rails::PX, dP, Hd, false) : 0;
  }
  return rails::smem_bytes<rails::bf16, rails::PQ, rails::PX>(dP, Hd);
}
