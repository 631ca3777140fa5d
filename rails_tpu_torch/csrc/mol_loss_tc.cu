// Entry points of K5's tensor-core route (mol_loss_tc.cuh holds the kernel
// and its design): the forward and the backward of the fused shared-negatives
// MoL loss at the geometries of `losstc::tc_ok`. They refuse every other
// geometry, and mol_loss_train.cu's CUDA-core entry points refuse these.
#include "mol_loss_tc.cuh"

namespace rails {
namespace {
namespace losstc {

// dtype 0: f32 operands, 1: bf16; d_out null for the forward.
cudaError_t run(int dtype, int px, const void* q, const void* qp, const void* item,
                const void* ip, const float* w1t, const float* b1, const float* w2,
                const float* b2, const float* d_out, float* out, float* dq, float* dqp,
                float* part, float* red, int nb, int M, int R, int dP, int Hd, float inv_t,
                float eps, const Drop& d, cudaStream_t s) {
  if (!tc_ok(dtype, kPQ, px, dP, Hd) || M < 1 || R < 1 || nb < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, 4>(q, qp, item, ip, w1t, b1, w2, b2, d_out, out, dq, dqp, part, red, nb,
                            M, R, dP, Hd, inv_t, eps, d, s);
  if (px == 4)
    return launch<bf16, 4>(q, qp, item, ip, w1t, b1, w2, b2, d_out, out, dq, dqp, part, red, nb,
                           M, R, dP, Hd, inv_t, eps, d, s);
  return launch<bf16, 8>(q, qp, item, ip, w1t, b1, w2, b2, d_out, out, dq, dqp, part, red, nb, M,
                         R, dP, Hd, inv_t, eps, d, s);
}

}  // namespace losstc
}  // namespace
}  // namespace rails

// dtype 0: q, qp, item, ip f32; 1: bf16. q (M, 8, dP); qp (M, L); item
// (R, PX, dP); ip (R, L); w1t (H, L), b1 (H), w2 (H, L), b2 (L) f32 (rounded
// to bf16 values by the caller for dtype 1); out (M, R) f32. n-major logits
// l = n * PX + mx.
extern "C" int rails_mol_loss_tc_fwd(int dtype, int px, const void* q, const void* qp,
                                     const void* item, const void* ip, const float* w1t,
                                     const float* b1, const float* w2, const float* b2,
                                     float* out, int M, int R, int dP, int Hd, int m_pad,
                                     int r_pad, float inv_t, float eps, int use_qi,
                                     unsigned seed_qi, unsigned thr_qi, float scale_qi,
                                     int use_pi, unsigned seed_pi, unsigned thr_pi,
                                     float scale_pi, void* stream) {
  const rails::Drop d = rails::make_drop(use_qi, seed_qi, thr_qi, scale_qi, use_pi, seed_pi,
                                         thr_pi, scale_pi, m_pad, r_pad);
  return rails::losstc::run(dtype, px, q, qp, item, ip, w1t, b1, w2, b2, nullptr, out, nullptr,
                            nullptr, nullptr, nullptr, 1, M, R, dP, Hd, inv_t, eps, d,
                            static_cast<cudaStream_t>(stream));
}

// As the forward, plus d_out (M, R) f32; dq (M, 8, dP) and dqp (M, L) f32
// zeroed by the caller and added to; part (nb, stride) f32 zeroed; red
// (stride) = [dW1 (H, L) | dW2 (H, L) | db1 (H) | db2 (L) | dip (R, L) |
// ditem (R, PX, dP)], the sum of the nb slots; nb blocks, each owning every
// nb-th group of 8 queries.
extern "C" int rails_mol_loss_tc_bwd(int dtype, int px, const void* q, const void* qp,
                                     const void* item, const void* ip, const float* w1t,
                                     const float* b1, const float* w2, const float* b2,
                                     const float* d_out, float* dq, float* dqp, float* part,
                                     float* red, int nb, int M, int R, int dP, int Hd, int m_pad,
                                     int r_pad, float inv_t, float eps, int use_qi,
                                     unsigned seed_qi, unsigned thr_qi, float scale_qi,
                                     int use_pi, unsigned seed_pi, unsigned thr_pi,
                                     float scale_pi, void* stream) {
  if (d_out == nullptr) return cudaErrorInvalidValue;
  const rails::Drop d = rails::make_drop(use_qi, seed_qi, thr_qi, scale_qi, use_pi, seed_pi,
                                         thr_pi, scale_pi, m_pad, r_pad);
  return rails::losstc::run(dtype, px, q, qp, item, ip, w1t, b1, w2, b2, d_out, nullptr, dq, dqp,
                            part, red, nb, M, R, dP, Hd, inv_t, eps, d,
                            static_cast<cudaStream_t>(stream));
}

// Shared memory of the forward (backward 0) or the backward; 0 off the route.
extern "C" size_t rails_mol_loss_tc_smem_bytes(int backward, int dtype, int px, int dP, int Hd) {
  if (!rails::losstc::tc_ok(dtype, rails::losstc::kPQ, px, dP, Hd)) return 0;
  return rails::losstc::smem_bytes(backward != 0, dtype, px, dP, Hd);
}
