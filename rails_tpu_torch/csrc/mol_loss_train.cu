// Fused MoL training loss over shared negatives (K5), forward and backward,
// hand-written for Hopper (sm_90a): the CUDA-core route.
//
// Replaces `make_fused_mol_loss` (rails_tpu/ops/pallas/mol_loss_train.py): the
// forward `_fwd_kernel` (:143, body `_forward_core` :75-140) and the backward
// `_bwd_kernel` (:159-290) of its custom VJP. For every (query m, shared
// negative r), with logits in the model's n-major order l = n * PX + mx:
//   t[l]  = <q[m, n], item[r, mx]> / T
//   t_in  = t * qi_mask                              (qi-MLP input dropout only)
//   qi    = W2^T silu(W1^T t_in + b1) + b2;  gi = qp[m] * ip[r] + qi
//   p     = softmax_l(silu(gi));  q_w = p * pi_mask;  s = max(sum q_w, eps)
//   out   = sum_l q_w * t / s                        (s = 1 exactly at rate 0)
// The two masks are K3's counter hash (hash_dropout.cuh) at the JAX kernel's
// flat index l' * (M_pad * R_pad) + m * R_pad + r, with its m-major row
// l' = mx * PQ + n and its padded extents, under seed + salt; so the bits are
// the JAX package's, and the backward regenerates the forward's.
//
// Two routes, chosen by the wrapper (`tc_route` in ops/mol_loss_train.py)
// from the geometry and the operand type; each set of entry points refuses
// the other's geometries, and there is no fallback between them:
//   - P_Q = 8 with P_X = 4 (f32 or bf16) or 8 (bf16), d_P <= 128, H a multiple
//     of 16 up to 128 (ML-1M, ML-20M, Amazon Books): the tensor-core kernel of
//     mol_loss_tc.cuh (entry points in mol_loss_tc.cu), every product a tile
//     GEMM on mma.sync, bf16 or 3xTF32; its note gives its design and bounds;
//   - every other supported geometry ((4, 2): synthetic-small; H not a
//     multiple of 16; f32 at 8x8): this file's kernels, every product a scalar
//     FMA loop on the CUDA cores.
//
// Operand types T: f32, or bf16 (`amzn-books-hstu-mol-fast`, bf16_training),
// where JAX runs the qi MLP in bf16 (`mlp_dtype`): the products of bf16 q and
// item sum in f32; t_in and h round to bf16 before their products; the
// wrapper passes W1 and W2 rounded to bf16 (b1, b2 stay f32); the backward
// rounds d_qi = d_gi, d_z and d_t / T to bf16 before their products and keeps
// d_gi for d_qp, d_ip and db2, and d_z for db1, in f32. round_to<T> is the
// identity for f32, so both types share one code path.
//
// Bound: operations. Per pair the forward does 2 L d_P FMAs of logits and
// 2 L H of the qi MLP (12k at 8x4x128, 18k at 8x8x32, H = 128); the backward
// recomputes them and adds ~2.5x as many (d_h, the z recompute, d_t, dW1,
// dW2, dq, d item). Everything accumulates in f32 on the CUDA cores, where
// each FMA reads a weight from shared memory: the loops are bound by those
// loads, several times above the 67 TFLOP/s FMA bound.
//
// Forward design: K2's layout. One block per (32 negatives x 32 queries): lanes
// own negatives, warps own queries; the item tile, W1^T, W2 and one query per
// warp sit in shared memory, and each thread keeps its pair's L logits, L
// MLP inputs t_in and L qi accumulators in registers, walking the hidden
// units one at a time. At L = 64 t_in goes to a shared-memory row per thread
// instead, as in the backward: the three arrays would take 192 registers.
//
// Backward design: the TPU kernel carries the item-side and weight gradients
// across its sequential grid in VMEM; blocks on the card run in no order. So
// one persistent block per SM walks groups of 8 queries (one per warp) and,
// for each, the negatives in tiles of 32 (one per lane): 256 pairs per tile.
// Each thread recomputes its pair's forward, then d_gi, and stages t_in and
// d_gi in shared memory; the hidden layer is walked in chunks of kJC units
// whose h and d_z are staged too, so the block can form dW1 = sum t_in d_z^T
// and dW2 = sum h d_gi^T over the tile's pairs, each (unit, logit) entry owned
// by one thread. d_q and d_qp belong to the block's own queries and are added
// in place; dW1, dW2, db1, db2, d_ip and d_item are added into the block's own
// slot of a partial buffer. Every entry is always updated by the same thread,
// so there are no atomics and no races. reduce_slots_kernel (mol_loss_tc.cuh,
// shared with the tensor-core route) sums the slots in block order: the result
// repeats bit for bit.
// At 8x8 (L = 64) that layout needs 273,408 B of shared memory at kJC = 32,
// over the 232,448 a block may have; the W1/W2 copies (64 KB) and the staged
// t_in / d_gi rows (130 KB) are the bulk. The chunk drops to kJC = 8 units
// (16 KB instead of 66 KB: 224,064 B in all), and the dW reduction spreads
// over (unit, logit pair) so all 256 threads still work in it. The weights
// stay in shared memory (every pair reads every row once per hidden unit) and
// the tile stays at 32 negatives (the lane layout). At L = 64 the thread also
// reads t_in from its staged row instead of registers: t, t_in, gi and p would
// take all 255 registers, and without t_in the three others take 192.
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "hash_dropout.cuh"
#include "mol_loss_tc.cuh"

namespace rails {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileR = 32;          // negatives per tile, one per lane
constexpr int kFwdQueries = 32;     // queries per forward block
constexpr int kSP = kThreads + 1;   // stride of a staged chunk row (no bank conflicts)
constexpr int kMaxDP = 128;         // d_P held in 4 registers per lane
constexpr int kDPK = kMaxDP / 32;

__device__ __forceinline__ float sigmoid_exact(float v) { return 1.0f / (1.0f + expf(-v)); }

// Keep scale of n-major logit l of pair (m, r): the JAX kernel's row l'.
template <int PQ, int PX>
__device__ __forceinline__ float mask_at(int l, int m, int r, uint32_t seed, uint32_t thr,
                                         float scale, const Drop& d) {
  const uint32_t lp = static_cast<uint32_t>((l % PX) * PQ + l / PX);
  const uint32_t idx = lp * d.mr + static_cast<uint32_t>(m) * d.r_pad + static_cast<uint32_t>(r);
  return keep_scale(idx, seed, thr, scale);
}

// Hidden units per staged chunk of the backward: 8 at L = 64, where 32 do not
// fit in a block's shared memory; 32 otherwise.
template <int L>
__host__ __device__ constexpr int hidden_chunk() { return L > 32 ? 8 : 32; }

// Whether a thread keeps t_in in a shared-memory row (L = 64) or registers.
template <int L>
__host__ __device__ constexpr bool tin_in_smem() { return L > 32; }

template <int PQ, int PX>
size_t fwd_smem_bytes(int dP, int Hd) {
  constexpr int L = PQ * PX;
  return (2 * static_cast<size_t>(Hd) * L + Hd + L + static_cast<size_t>(kWarps) * PQ * dP +
          static_cast<size_t>(PX) * dP * kTileR +
          (tin_in_smem<L>() ? static_cast<size_t>(kThreads) * (L + 1) : 0)) *
         sizeof(float);
}

template <int PQ, int PX>
size_t bwd_smem_bytes(int dP, int Hd) {
  constexpr int L = PQ * PX;
  return (2 * static_cast<size_t>(Hd) * L + Hd + L + static_cast<size_t>(kWarps) * PQ * dP +
          2 * static_cast<size_t>(kThreads) * (L + 1) +
          2 * static_cast<size_t>(hidden_chunk<L>()) * kSP) *
         sizeof(float);
}

template <int L>
__device__ void stage_weights(float* w1s, float* w2s, float* b1s, float* b2s, const float* w1t,
                              const float* w2, const float* b1, const float* b2, int Hd) {
  for (int e = threadIdx.x; e < Hd * L; e += kThreads) {
    w1s[e] = w1t[e];
    w2s[e] = w2[e];
  }
  for (int e = threadIdx.x; e < Hd; e += kThreads) b1s[e] = b1[e];
  for (int e = threadIdx.x; e < L; e += kThreads) b2s[e] = b2[e];
}

// sum_l W1[l, j] t_in[l] over the JAX kernel's m-major rows l' = mx * PQ + n,
// the plain version's order (the sharp softmax shows f32 rounding of another);
// t_in from registers, or with kSmem from the thread's staged row.
template <int PQ, int PX, bool kSmem>
__device__ __forceinline__ float hidden_pre(const float* w1r, const float (&tin)[PQ * PX],
                                            const float* trow) {
  float z = 0.f;
#pragma unroll
  for (int mx = 0; mx < PX; ++mx)
#pragma unroll
    for (int n = 0; n < PQ; ++n) {
      const int l = n * PX + mx;
      if constexpr (kSmem) {
        z = fmaf(w1r[l], trow[l], z);
      } else {
        z = fmaf(w1r[l], tin[l], z);
      }
    }
  return z;
}

// The forward of one pair up to the softmax: t (lg), t_in (in tin, or with
// kSmem in trow), gi and p; t_in and h rounded to T.
template <typename T, int PQ, int PX, bool kSmem>
__device__ __forceinline__ void pair_forward(float (&lg)[PQ * PX], float (&tin)[PQ * PX],
                                             float (&gi)[PQ * PX], float (&p)[PQ * PX],
                                             float* trow, const float* w1s,
                                             const float* w2s, const float* b1s,
                                             const float* b2s, const T* qpm,
                                             const T* ip_t, int m, int r, bool rv, int R,
                                             int Hd, float inv_t, const Drop& d) {
  constexpr int L = PQ * PX;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    lg[l] *= inv_t;
    const float v = round_to<T>(
        d.use_qi ? lg[l] * mask_at<PQ, PX>(l, m, r, d.seed_qi, d.thr_qi, d.scale_qi, d) : lg[l]);
    if constexpr (kSmem) {
      trow[l] = v;
    } else {
      tin[l] = v;
    }
    p[l] = 0.f;
  }
  for (int j = 0; j < Hd; ++j) {
    const float z = hidden_pre<PQ, PX, kSmem>(w1s + j * L, tin, trow);
    const float h = round_to<T>(silu(z + b1s[j]));
    const float* w2r = w2s + j * L;
#pragma unroll
    for (int l = 0; l < L; ++l) p[l] = fmaf(w2r[l], h, p[l]);
  }
  float gmax = -INFINITY;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const float ipv = rv ? to_f<T>(ip_t[static_cast<int64_t>(l) * R + r]) : 0.f;
    gi[l] = fmaf(to_f<T>(qpm[l]), ipv, p[l] + b2s[l]);
    p[l] = silu(gi[l]);
    gmax = fmaxf(gmax, p[l]);
  }
  float se = 0.f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    p[l] = expf(p[l] - gmax);
    se += p[l];
  }
#pragma unroll
  for (int l = 0; l < L; ++l) p[l] = p[l] / se;
}

// Logits of one pair from the warp's staged query row and a strided item
// column (staged f32, or the T table in device memory).
template <int PQ, int PX, typename C>
__device__ __forceinline__ void pair_logits(float (&lg)[PQ * PX], const float* qrow,
                                            const C* col, int64_t col_stride, int dP) {
#pragma unroll
  for (int l = 0; l < PQ * PX; ++l) lg[l] = 0.f;
  for (int k = 0; k < dP; ++k) {
    float iv[PX];
#pragma unroll
    for (int mx = 0; mx < PX; ++mx) iv[mx] = to_f<C>(col[(mx * dP + k) * col_stride]);
#pragma unroll
    for (int n = 0; n < PQ; ++n) {
      const float qv = qrow[n * dP + k];
#pragma unroll
      for (int mx = 0; mx < PX; ++mx) lg[n * PX + mx] = fmaf(qv, iv[mx], lg[n * PX + mx]);
    }
  }
}

template <typename T, int PQ, int PX>
__global__ void __launch_bounds__(kThreads)
mol_loss_fwd_kernel(const T* __restrict__ q, const T* __restrict__ qp,
                    const T* __restrict__ item_t, const T* __restrict__ ip_t,
                    const float* __restrict__ w1t, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    float* __restrict__ out, int M, int R, int dP, int Hd, float inv_t, float eps,
                    Drop d) {
  constexpr int L = PQ * PX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w1s = reinterpret_cast<float*>(smem_raw);  // [Hd][L]
  float* w2s = w1s + Hd * L;                        // [Hd][L]
  float* b1s = w2s + Hd * L;                        // [Hd]
  float* b2s = b1s + Hd;                            // [L]
  float* qs = b2s + L;                              // [kWarps][PQ * dP]
  float* its = qs + kWarps * PQ * dP;               // [PX * dP][kTileR]
  float* tins = its + PX * dP * kTileR;             // [kThreads][L + 1] t_in rows (L = 64)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * kTileR, r = r0 + lane;
  const bool rv = r < R;
  stage_weights<L>(w1s, w2s, b1s, b2s, w1t, w2, b1, b2, Hd);
  for (int e = tid; e < PX * dP * kTileR; e += kThreads) {
    const int row = e / kTileR, c = e % kTileR;
    its[e] = r0 + c < R ? to_f<T>(item_t[static_cast<int64_t>(row) * R + r0 + c]) : 0.f;
  }
  __syncthreads();

  float* qw = qs + warp * PQ * dP;
  for (int qi = warp; qi < kFwdQueries; qi += kWarps) {
    const int m = blockIdx.y * kFwdQueries + qi;
    if (m >= M) break;  // warp-uniform
    for (int e = lane; e < PQ * dP; e += 32) {
      qw[e] = to_f<T>(q[static_cast<int64_t>(m) * PQ * dP + e]);
    }
    __syncwarp();
    float lg[L], tin[L], gi[L], p[L];
    pair_logits<PQ, PX>(lg, qw, its + lane, kTileR, dP);
    pair_forward<T, PQ, PX, tin_in_smem<L>()>(lg, tin, gi, p, tins + tid * (L + 1), w1s, w2s,
                                              b1s, b2s, qp + static_cast<int64_t>(m) * L, ip_t,
                                              m, r, rv, R, Hd, inv_t, d);
    float res;
    if (d.use_pi) {
      float sq = 0.f, st = 0.f;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float qv = p[l] * mask_at<PQ, PX>(l, m, r, d.seed_pi, d.thr_pi, d.scale_pi, d);
        sq += qv;
        st = fmaf(qv, lg[l], st);
      }
      res = st / fmaxf(sq, eps);
    } else {
      float st = 0.f;
#pragma unroll
      for (int l = 0; l < L; ++l) st = fmaf(p[l], lg[l], st);
      res = st;
    }
    if (rv) out[static_cast<int64_t>(m) * R + r] = res;
    __syncwarp();
  }
}

template <typename T, int PQ, int PX>
__global__ void __launch_bounds__(kThreads, 1)
mol_loss_bwd_kernel(const T* __restrict__ q, const T* __restrict__ qp,
                    const T* __restrict__ item, const T* __restrict__ item_t,
                    const T* __restrict__ ip, const T* __restrict__ ip_t,
                    const float* __restrict__ w1t, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ d_out, float* __restrict__ dq,
                    float* __restrict__ dqp, float* __restrict__ part, int64_t stride, int M,
                    int R, int dP, int Hd, float inv_t, float eps, Drop d) {
  constexpr int L = PQ * PX;
  constexpr int LS = L + 1;                       // padded row stride of the staged pair vectors
  constexpr int kJC = hidden_chunk<L>();          // hidden units per staged chunk
  constexpr bool kSmem = tin_in_smem<L>();        // t_in read from the staged row
  constexpr int kGroups = kThreads / kJC;         // threads per hidden unit in the dW reduction
  constexpr int LE = L / kGroups;                 // logits per thread in the dW reduction
  static_assert(L % kGroups == 0, "L must be a multiple of 256 / kJC");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w1s = reinterpret_cast<float*>(smem_raw);  // [Hd][L]
  float* w2s = w1s + Hd * L;                        // [Hd][L]
  float* b1s = w2s + Hd * L;                        // [Hd]
  float* b2s = b1s + Hd;                            // [L]
  float* qs = b2s + L;                              // [kWarps][PQ * dP] the group's queries
  float* bufa = qs + kWarps * PQ * dP;              // [256][LS] t_in, then d_t / T
  float* bufb = bufa + kThreads * LS;               // [256][LS] d_gi
  float* shh = bufb + kThreads * LS;                // [kJC][kSP] h of a hidden chunk
  float* shz = shh + kJC * kSP;                     // [kJC][kSP] d_z of a hidden chunk

  float* slot = part + static_cast<int64_t>(blockIdx.x) * stride;
  float* pw1 = slot;                     // [Hd][L]
  float* pw2 = pw1 + Hd * L;             // [Hd][L]
  float* pb1 = pw2 + Hd * L;             // [Hd]
  float* pb2 = pb1 + Hd;                 // [L]
  float* pip = pb2 + L;                  // [R][L]
  float* pit = pip + static_cast<int64_t>(R) * L;  // [R][PX][dP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pidx = tid;  // pair index in the tile: warp * 32 + lane
  stage_weights<L>(w1s, w2s, b1s, b2s, w1t, w2, b1, b2, Hd);
  const int ngroups = (M + kWarps - 1) / kWarps;

  for (int grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
    const int m = grp * kWarps + warp;
    const bool mv = m < M;
    float* qw = qs + warp * PQ * dP;
    __syncthreads();  // the previous group's readers of qs are done
    for (int e = lane; e < PQ * dP; e += 32)
      qw[e] = mv ? to_f<T>(q[static_cast<int64_t>(m) * PQ * dP + e]) : 0.f;
    __syncthreads();
    const T* qpm = qp + static_cast<int64_t>(mv ? m : 0) * L;

    for (int rc = 0; rc < R; rc += kTileR) {
      const int r = rc + lane;
      const bool rv = r < R;
      const float dout = (mv && rv) ? d_out[static_cast<int64_t>(m) * R + r] : 0.f;

      // Forward recompute.
      float* trow = bufa + pidx * LS;
      float lg[L], tin[L], gi[L], p[L];
      pair_logits<PQ, PX>(lg, qw, item_t + (rv ? r : 0), R, dP);
      pair_forward<T, PQ, PX, kSmem>(lg, tin, gi, p, trow, w1s, w2s, b1s, b2s, qpm, ip_t, m, r,
                                     rv, R, Hd, inv_t, d);
      float s = 1.f, st = 0.f;
      if (d.use_pi) {
        float sq = 0.f;
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const float qv = p[l] * mask_at<PQ, PX>(l, m, r, d.seed_pi, d.thr_pi, d.scale_pi, d);
          sq += qv;
          st = fmaf(qv, lg[l], st);
        }
        s = fmaxf(sq, eps);
      } else {
#pragma unroll
        for (int l = 0; l < L; ++l) st = fmaf(p[l], lg[l], st);
      }
      const float inv_s = 1.0f / s;
      const float a = dout * inv_s;
      // d q_w = a * t - dout * out * inv_s where s > eps; d p = d q_w * mask.
      const float corr = (d.use_pi && s > eps) ? dout * (st * inv_s) * inv_s : 0.f;
      float dot = 0.f;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float mk =
            d.use_pi ? mask_at<PQ, PX>(l, m, r, d.seed_pi, d.thr_pi, d.scale_pi, d) : 1.f;
        dot = fmaf((a * lg[l] - corr) * mk, p[l], dot);
      }
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float mk =
            d.use_pi ? mask_at<PQ, PX>(l, m, r, d.seed_pi, d.thr_pi, d.scale_pi, d) : 1.f;
        const float dp = (a * lg[l] - corr) * mk;
        const float sg = sigmoid_exact(gi[l]);
        const float dg = p[l] * (dp - dot) * (sg * (1.0f + gi[l] * (1.0f - sg)));  // d gi
        lg[l] = a * p[l] * mk;                                          // d t, direct
        p[l] = 0.f;                                                     // d t through the MLP
        if constexpr (!kSmem) trow[l] = tin[l];
        bufb[pidx * LS + l] = dg;
        gi[l] = round_to<T>(dg);                                        // d qi
      }

      // The hidden layer in chunks: d_h, d_z, d t_in, and the dW1 / dW2 / db1 sums.
      for (int jc = 0; jc < Hd; jc += kJC) {
        const int nj = min(kJC, Hd - jc);
        for (int jj = 0; jj < nj; ++jj) {
          const int j = jc + jj;
          const float* w1r = w1s + j * L;
          const float* w2r = w2s + j * L;
          const float z = hidden_pre<PQ, PX, kSmem>(w1r, tin, trow) + b1s[j];
          float dh = 0.f;
#pragma unroll
          for (int l = 0; l < L; ++l) dh = fmaf(w2r[l], gi[l], dh);
          const float sg = sigmoid_exact(z);
          const float dz = dh * (sg * (1.0f + z * (1.0f - sg)));
          const float dzr = round_to<T>(dz);
#pragma unroll
          for (int l = 0; l < L; ++l) p[l] = fmaf(w1r[l], dzr, p[l]);
          shh[jj * kSP + pidx] = round_to<T>(z * sg);
          shz[jj * kSP + pidx] = dz;
        }
        __syncthreads();
        // dW1 = sum t_in round(d_z), dW2 = sum h round(d_gi), db1 = sum d_z:
        // thread tid owns unit jc + tid % kJC and logits l0 .. l0 + LE.
        const int jj = tid % kJC;
        if (jj < nj) {
          const int j = jc + jj;
          const int l0 = (tid / kJC) * LE;
          float s1[LE], s2[LE], sb = 0.f;
#pragma unroll
          for (int e = 0; e < LE; ++e) s1[e] = s2[e] = 0.f;
          for (int pp = 0; pp < kThreads; ++pp) {
            const float zv = shz[jj * kSP + pp], hv = shh[jj * kSP + pp];
            const float zr = round_to<T>(zv);
            sb += zv;
#pragma unroll
            for (int e = 0; e < LE; ++e) {
              s1[e] = fmaf(bufa[pp * LS + l0 + e], zr, s1[e]);
              s2[e] = fmaf(hv, round_to<T>(bufb[pp * LS + l0 + e]), s2[e]);
            }
          }
#pragma unroll
          for (int e = 0; e < LE; ++e) {
            pw1[j * L + l0 + e] += s1[e];
            pw2[j * L + l0 + e] += s2[e];
          }
          if (tid < kJC) pb1[j] += sb;
        }
        __syncthreads();
      }

      // d t = direct + (MLP part) * qi_mask; stage d t / T, rounded to T, for
      // d q and d item.
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float mk =
            d.use_qi ? mask_at<PQ, PX>(l, m, r, d.seed_qi, d.thr_qi, d.scale_qi, d) : 1.f;
        trow[l] = round_to<T>((lg[l] + p[l] * mk) * inv_t);
      }
      __syncthreads();

      // d q of the warp's query: lanes over d_P.
      {
        float acc[PQ][kDPK];
#pragma unroll
        for (int n = 0; n < PQ; ++n)
#pragma unroll
          for (int kk = 0; kk < kDPK; ++kk) acc[n][kk] = 0.f;
        for (int rr = 0; rr < kTileR && rc + rr < R; ++rr) {
          const float* dt = bufa + (warp * kTileR + rr) * LS;
#pragma unroll
          for (int mx = 0; mx < PX; ++mx) {
            const T* irow = item + (static_cast<int64_t>(rc + rr) * PX + mx) * dP;
            float iv[kDPK];
#pragma unroll
            for (int kk = 0; kk < kDPK; ++kk) {
              const int k = lane + 32 * kk;
              iv[kk] = k < dP ? to_f<T>(irow[k]) : 0.f;
            }
#pragma unroll
            for (int n = 0; n < PQ; ++n) {
              const float dv = dt[n * PX + mx];
#pragma unroll
              for (int kk = 0; kk < kDPK; ++kk) acc[n][kk] = fmaf(dv, iv[kk], acc[n][kk]);
            }
          }
        }
        if (mv) {
#pragma unroll
          for (int n = 0; n < PQ; ++n)
#pragma unroll
            for (int kk = 0; kk < kDPK; ++kk) {
              const int k = lane + 32 * kk;
              if (k < dP) dq[(static_cast<int64_t>(m) * PQ + n) * dP + k] += acc[n][kk];
            }
        }
      }

      // d qp of the warp's query: lanes over L.
      if (mv) {
        for (int l = lane; l < L; l += 32) {
          float acc = 0.f;
          for (int rr = 0; rr < kTileR && rc + rr < R; ++rr)
            acc = fmaf(bufb[(warp * kTileR + rr) * LS + l],
                       to_f<T>(ip[static_cast<int64_t>(rc + rr) * L + l]), acc);
          dqp[static_cast<int64_t>(m) * L + l] += acc;
        }
      }

      // d ip of the lane's negative: warps over L.
      if (rv) {
        for (int l = warp; l < L; l += kWarps) {
          float acc = 0.f;
          for (int qq = 0; qq < kWarps; ++qq) {
            const int mq = grp * kWarps + qq;
            if (mq < M) acc = fmaf(bufb[(qq * kTileR + lane) * LS + l],
                                   to_f<T>(qp[static_cast<int64_t>(mq) * L + l]), acc);
          }
          pip[static_cast<int64_t>(r) * L + l] += acc;
        }
      }

      // db2.
      if (tid < L) {
        float acc = 0.f;
        for (int pp = 0; pp < kThreads; ++pp) acc += bufb[pp * LS + tid];
        pb2[tid] += acc;
      }

      // d item: warp w owns negatives w, w + 8, w + 16, w + 24 of the tile; lanes over d_P.
      {
        constexpr int kRI = kTileR / kWarps;
        float acc[kRI][PX][kDPK];
#pragma unroll
        for (int i = 0; i < kRI; ++i)
#pragma unroll
          for (int mx = 0; mx < PX; ++mx)
#pragma unroll
            for (int kk = 0; kk < kDPK; ++kk) acc[i][mx][kk] = 0.f;
        for (int qq = 0; qq < kWarps; ++qq) {
          for (int n = 0; n < PQ; ++n) {
            float qv[kDPK];
#pragma unroll
            for (int kk = 0; kk < kDPK; ++kk) {
              const int k = lane + 32 * kk;
              qv[kk] = k < dP ? qs[qq * PQ * dP + n * dP + k] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < kRI; ++i) {
              const float* dt = bufa + (qq * kTileR + warp + kWarps * i) * LS + n * PX;
#pragma unroll
              for (int mx = 0; mx < PX; ++mx) {
                const float dv = dt[mx];
#pragma unroll
                for (int kk = 0; kk < kDPK; ++kk) acc[i][mx][kk] = fmaf(dv, qv[kk], acc[i][mx][kk]);
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kRI; ++i) {
          const int rg = rc + warp + kWarps * i;
          if (rg < R) {
#pragma unroll
            for (int mx = 0; mx < PX; ++mx)
#pragma unroll
              for (int kk = 0; kk < kDPK; ++kk) {
                const int k = lane + 32 * kk;
                if (k < dP) pit[(static_cast<int64_t>(rg) * PX + mx) * dP + k] += acc[i][mx][kk];
              }
          }
        }
      }
      __syncthreads();  // bufa / bufb are rewritten by the next tile
    }
  }
}

template <typename T, int PQ, int PX>
cudaError_t launch_fwd(const void* q, const void* qp, const void* item_t, const void* ip_t,
                       const float* w1t, const float* b1, const float* w2, const float* b2,
                       float* out, int M, int R, int dP, int Hd, float inv_t, float eps,
                       const Drop& d, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<PQ, PX>(dP, Hd);
  cudaError_t err = allow_smem(mol_loss_fwd_kernel<T, PQ, PX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + kTileR - 1) / kTileR, (M + kFwdQueries - 1) / kFwdQueries);
  mol_loss_fwd_kernel<T, PQ, PX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(qp), static_cast<const T*>(item_t),
      static_cast<const T*>(ip_t), w1t, b1, w2, b2, out, M, R, dP, Hd, inv_t, eps, d);
  return cudaGetLastError();
}

template <typename T, int PQ, int PX>
cudaError_t launch_bwd(const void* q, const void* qp, const void* item, const void* item_t,
                       const void* ip, const void* ip_t, const float* w1t, const float* b1,
                       const float* w2, const float* b2, const float* d_out, float* dq,
                       float* dqp, float* part, float* red, int nb, int M, int R, int dP, int Hd,
                       float inv_t, float eps, const Drop& d, cudaStream_t stream) {
  constexpr int L = PQ * PX;
  const size_t smem = bwd_smem_bytes<PQ, PX>(dP, Hd);
  cudaError_t err = allow_smem(mol_loss_bwd_kernel<T, PQ, PX>, smem);
  if (err != cudaSuccess) return err;
  const int64_t stride = 2 * static_cast<int64_t>(Hd) * L + Hd + L +
                         static_cast<int64_t>(R) * L + static_cast<int64_t>(R) * PX * dP;
  mol_loss_bwd_kernel<T, PQ, PX><<<nb, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(qp), static_cast<const T*>(item),
      static_cast<const T*>(item_t), static_cast<const T*>(ip), static_cast<const T*>(ip_t), w1t,
      b1, w2, b2, d_out, dq, dqp, part, stride, M, R, dP, Hd, inv_t, eps, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_slots_kernel<<<static_cast<unsigned>((stride + 255) / 256), 256, 0, stream>>>(part, nb,
                                                                                      stride, red);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_for(int pq, int px, const void* q, const void* qp, const void* item_t,
                    const void* ip_t, const float* w1t, const float* b1, const float* w2,
                    const float* b2, float* out, int M, int R, int dP, int Hd, float inv_t,
                    float eps, const Drop& d, cudaStream_t s) {
  if (pq == 8 && px == 4)
    return launch_fwd<T, 8, 4>(q, qp, item_t, ip_t, w1t, b1, w2, b2, out, M, R, dP, Hd, inv_t,
                               eps, d, s);
  if (pq == 4 && px == 2)
    return launch_fwd<T, 4, 2>(q, qp, item_t, ip_t, w1t, b1, w2, b2, out, M, R, dP, Hd, inv_t,
                               eps, d, s);
  if (pq == 8 && px == 8)
    return launch_fwd<T, 8, 8>(q, qp, item_t, ip_t, w1t, b1, w2, b2, out, M, R, dP, Hd, inv_t,
                               eps, d, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t bwd_for(int pq, int px, const void* q, const void* qp, const void* item,
                    const void* item_t, const void* ip, const void* ip_t, const float* w1t,
                    const float* b1, const float* w2, const float* b2, const float* d_out,
                    float* dq, float* dqp, float* part, float* red, int nb, int M, int R, int dP,
                    int Hd, float inv_t, float eps, const Drop& d, cudaStream_t s) {
  if (pq == 8 && px == 4)
    return launch_bwd<T, 8, 4>(q, qp, item, item_t, ip, ip_t, w1t, b1, w2, b2, d_out, dq, dqp,
                               part, red, nb, M, R, dP, Hd, inv_t, eps, d, s);
  if (pq == 4 && px == 2)
    return launch_bwd<T, 4, 2>(q, qp, item, item_t, ip, ip_t, w1t, b1, w2, b2, d_out, dq, dqp,
                               part, red, nb, M, R, dP, Hd, inv_t, eps, d, s);
  if (pq == 8 && px == 8)
    return launch_bwd<T, 8, 8>(q, qp, item, item_t, ip, ip_t, w1t, b1, w2, b2, d_out, dq, dqp,
                               part, red, nb, M, R, dP, Hd, inv_t, eps, d, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace rails

// dtype 0: q, qp, item_t, ip_t f32; 1: bf16. q (M, PQ, dP); qp (M, L);
// item_t (PX, dP, R); ip_t (L, R); w1t (H, L), b1 (H), w2 (H, L), b2 (L) f32
// (rounded to bf16 values by the caller for dtype 1); out (M, R) f32. n-major
// logits l = n * PX + mx.
extern "C" int rails_mol_loss_fwd(int dtype, int pq, int px, const void* q, const void* qp,
                                  const void* item_t, const void* ip_t, const float* w1t,
                                  const float* b1, const float* w2, const float* b2, float* out,
                                  int M, int R, int dP, int Hd, int m_pad, int r_pad, float inv_t,
                                  float eps, int use_qi, unsigned seed_qi, unsigned thr_qi,
                                  float scale_qi, int use_pi, unsigned seed_pi, unsigned thr_pi,
                                  float scale_pi, void* stream) {
  if (dP > rails::kMaxDP || rails::losstc::tc_ok(dtype, pq, px, dP, Hd))
    return cudaErrorInvalidValue;
  const rails::Drop d = rails::make_drop(use_qi, seed_qi, thr_qi, scale_qi, use_pi, seed_pi,
                                         thr_pi, scale_pi, m_pad, r_pad);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rails::fwd_for<float>(pq, px, q, qp, item_t, ip_t, w1t, b1, w2, b2, out, M, R, dP, Hd,
                                 inv_t, eps, d, s);
  if (dtype == 1)
    return rails::fwd_for<__nv_bfloat16>(pq, px, q, qp, item_t, ip_t, w1t, b1, w2, b2, out, M, R,
                                         dP, Hd, inv_t, eps, d, s);
  return cudaErrorInvalidValue;
}

// As the forward, plus item (R, PX, dP), ip (R, L) of the same type, d_out
// (M, R) f32; dq (M, PQ, dP) and dqp (M, L) f32 zeroed by the caller and added
// to; part (nb, stride) f32 zeroed; red (stride) = [dW1 (H, L) | dW2 (H, L) |
// db1 (H) | db2 (L) | dip (R, L) | ditem (R, PX, dP)], the sum of the nb slots.
extern "C" int rails_mol_loss_bwd(int dtype, int pq, int px, const void* q, const void* qp,
                                  const void* item, const void* item_t, const void* ip,
                                  const void* ip_t, const float* w1t, const float* b1,
                                  const float* w2, const float* b2, const float* d_out, float* dq,
                                  float* dqp, float* part, float* red, int nb, int M, int R,
                                  int dP, int Hd, int m_pad, int r_pad, float inv_t, float eps,
                                  int use_qi, unsigned seed_qi, unsigned thr_qi, float scale_qi,
                                  int use_pi, unsigned seed_pi, unsigned thr_pi, float scale_pi,
                                  void* stream) {
  if (dP > rails::kMaxDP || nb < 1 || rails::losstc::tc_ok(dtype, pq, px, dP, Hd))
    return cudaErrorInvalidValue;
  const rails::Drop d = rails::make_drop(use_qi, seed_qi, thr_qi, scale_qi, use_pi, seed_pi,
                                         thr_pi, scale_pi, m_pad, r_pad);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rails::bwd_for<float>(pq, px, q, qp, item, item_t, ip, ip_t, w1t, b1, w2, b2, d_out,
                                 dq, dqp, part, red, nb, M, R, dP, Hd, inv_t, eps, d, s);
  if (dtype == 1)
    return rails::bwd_for<__nv_bfloat16>(pq, px, q, qp, item, item_t, ip, ip_t, w1t, b1, w2, b2,
                                         d_out, dq, dqp, part, red, nb, M, R, dP, Hd, inv_t, eps,
                                         d, s);
  return cudaErrorInvalidValue;
}

extern "C" size_t rails_mol_loss_smem_bytes(int backward, int pq, int px, int dP, int Hd) {
  if (pq == 8 && px == 4)
    return backward ? rails::bwd_smem_bytes<8, 4>(dP, Hd) : rails::fwd_smem_bytes<8, 4>(dP, Hd);
  if (pq == 4 && px == 2)
    return backward ? rails::bwd_smem_bytes<4, 2>(dP, Hd) : rails::fwd_smem_bytes<4, 2>(dP, Hd);
  if (pq == 8 && px == 8)
    return backward ? rails::bwd_smem_bytes<8, 8>(dP, Hd) : rails::fwd_smem_bytes<8, 8>(dP, Hd);
  return 0;
}
